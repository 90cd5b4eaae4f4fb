"""Port parity for the top-k merge of a sharded search (CPU):
``repro_torch/distributed/collectives.py`` against
``repro/distributed/collectives.py``, and the static sharded flat helper
(``repro_torch/core/distributed.py``).

The reference's merge runs here under ``jax.vmap(..., axis_name="shard")``
(its collectives batch over a vmapped axis, so no fake devices are
needed): the all-gather oracle at any S, the ``ppermute`` tree at S 2, 4
and 8 (under ``vmap`` its partial permutations, the fold and the
broadcast of a non-power-of-two S, do not batch). The port's tree must
equal its oracle bit for bit at every S, ties included, and both must
equal the reference. Ids and distances are compared exactly: the merge
only selects.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jcoll
from repro_torch.core.distributed import (make_retrieval_step,
                                          sharded_flat_topk)
from repro_torch.distributed import collectives as tcoll
from repro_torch.kernels import ops as tops

INF = np.float32(3e38)


def _parts(s, b=5, k=7, seed=0, ties=True):
    """S shards' (dists [B, k], ids [B, k]): each row ascending by d,
    globally unique ids, many equal distances across and within shards,
    and (INF, -1) pads at the end of some shards."""
    rng = np.random.default_rng(seed + 17 * s)
    d = (rng.integers(0, 6, size=(s, b, k)) / 4 if ties
         else rng.random((s, b, k))).astype(np.float32)
    ids = rng.permutation(s * b * k * 3)[:s * b * k].reshape(s, b, k)
    ids = ids.astype(np.int32)
    order = np.lexsort((ids, d), axis=-1)
    d = np.take_along_axis(d, order, -1)
    ids = np.take_along_axis(ids, order, -1)
    pad = rng.random((s, b, 1)) < 0.3
    cut = rng.integers(1, k, size=(s, b, 1))
    short = pad & (np.arange(k) >= cut)
    d[short] = INF
    ids[short] = -1
    return d, ids


def _torch_parts(d, ids):
    return [(torch.from_numpy(d[j].copy()), torch.from_numpy(ids[j].copy()))
            for j in range(d.shape[0])]


def _reference(d, ids, k, **kw):
    """The reference's merge on every shard of a vmapped axis -> the
    per-shard results [S, B, k]."""
    fn = jax.vmap(lambda dd, ii: jcoll.hierarchical_topk(
        dd, ii, k, ("shard",), **kw), axis_name="shard")
    out_d, out_i = fn(jnp.asarray(d), jnp.asarray(ids))
    return np.asarray(out_d), np.asarray(out_i)


@pytest.mark.parametrize("s", [2, 3, 4, 5, 6, 8])
def test_tree_equals_oracle_bit_for_bit(s):
    d, ids = _parts(s)
    parts = _torch_parts(d, ids)
    od, oi = tcoll.topk_merge_axis(parts, 7, tie_break_ids=True, tree=False)
    rep = tcoll.tree_merge(parts, 7, tie_break_ids=True)
    assert len(rep) == s
    for td, ti in rep:                        # replicated on every shard
        assert td.numpy().tobytes() == od.numpy().tobytes()
        assert ti.numpy().tobytes() == oi.numpy().tobytes()
    # the oracle is the (d, id) order of every candidate
    flat_d = np.transpose(d, (1, 0, 2)).reshape(d.shape[1], -1)
    flat_i = np.transpose(ids, (1, 0, 2)).reshape(d.shape[1], -1)
    o = np.lexsort((flat_i, flat_d), axis=-1)[:, :7]
    np.testing.assert_array_equal(oi.numpy(), np.take_along_axis(flat_i, o,
                                                                 -1))


@pytest.mark.parametrize("s", [2, 3, 4, 8])
@pytest.mark.parametrize("wire_bf16", [False, True])
def test_oracle_equals_reference(s, wire_bf16):
    d, ids = _parts(s, seed=3, ties=not wire_bf16)
    jd, ji = _reference(d, ids, 7, wire_bf16=wire_bf16, tie_break_ids=True)
    td, ti = tcoll.hierarchical_topk(_torch_parts(d, ids), 7,
                                     wire_bf16=wire_bf16, tie_break_ids=True,
                                     tree=False)
    for j in range(s):                        # the reference replicates
        np.testing.assert_array_equal(ti.numpy(), ji[j])
        np.testing.assert_array_equal(td.numpy(), jd[j])


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("tie_break_ids", [True, False])
def test_tree_equals_reference_tree(s, tie_break_ids):
    """Under ``tie_break_ids`` every shard's result; without it the first
    shard's, whose merges the port runs in the reference's order."""
    d, ids = _parts(s, seed=5)
    jd, ji = _reference(d, ids, 7, tie_break_ids=tie_break_ids,
                        axis_sizes=(s,))
    rep = tcoll.tree_merge(_torch_parts(d, ids), 7,
                           tie_break_ids=tie_break_ids)
    for j in range(s if tie_break_ids else 1):
        np.testing.assert_array_equal(rep[j][1].numpy(), ji[j])
        np.testing.assert_array_equal(rep[j][0].numpy(), jd[j])


def test_wire_bf16_converts_once():
    d, ids = _parts(4, seed=9, ties=False)
    parts = _torch_parts(d, ids)
    td, ti = tcoll.hierarchical_topk(parts, 7, wire_bf16=True,
                                     tie_break_ids=True)
    assert td.dtype == torch.float32
    want = tcoll.hierarchical_topk(
        [(x.to(torch.bfloat16), i) for x, i in parts], 7,
        tie_break_ids=True)
    assert torch.equal(ti, want[1])
    assert torch.equal(td, want[0].float())


@pytest.mark.parametrize("n", [97, 128])        # padded and exact blocks
@pytest.mark.parametrize("s", [1, 3, 4])
def test_sharded_flat_topk_is_the_exact_search(n, s):
    rng = np.random.default_rng(n + s)
    db = rng.normal(size=(n, 12)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = torch.from_numpy(db[::11] + 0.01)
    devices = [torch.device("cpu")] * s
    d, i = sharded_flat_topk(devices, torch.from_numpy(db), q, 9)
    wd, wi = tops.flat_topk(torch.from_numpy(db), q, 9)
    assert torch.equal(i, wi)
    torch.testing.assert_close(d, wd, rtol=0, atol=1e-6)
    d2, i2 = make_retrieval_step(devices, 9)(torch.from_numpy(db), q)
    assert torch.equal(i2, i) and torch.equal(d2, d)
    bd, bi = sharded_flat_topk(devices, torch.from_numpy(db), q, 9,
                               wire_bf16=True)
    assert bd.dtype == torch.bfloat16 and (bi >= 0).all()
