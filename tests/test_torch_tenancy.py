"""Port parity for the multi-tenant pool (CPU): ``core/tenancy.py``
(namespacing, the slab scan, the cross-tenant search, ``SlabRows`` and
``IndexPool``) and its serving surface (``RetrievalEngine``,
``RAGPipeline`` and ``generate_rag`` in pool mode, ``launch.serve
--tenants``), each against ``repro`` on the same seeded numpy inputs.

The reference's own contract (``tests/test_tenant.py``) is what the port
is held to, with the reference's ``IndexPool`` as the oracle:

  * keys, epochs, residency and the canonical per-tenant state
    (``tenant_rows``) are equal, bit for bit where they are arrays;
  * distances within the flat tests' tolerance: atol 1e-5 for cosine and
    ip, rtol 1e-5 for l2 (the two frameworks sum fp32 products in another
    order). The l2 form is the expanded |q|² − 2 q·x + |x|², whose
    rounding scales with its terms, not with d: a query next to a row
    cancels to a small d, so l2 also takes 1e-5 of the terms' size
    (``L2_TERMS``) as its absolute floor;
  * a pooled tenant's store holds the reference pool's and a dedicated
    port index's bytes (WAL, ``config.json`` and manifests byte for byte,
    pages as arrays), and either package warm-restores the other's root.

Every shard lies on the CPU here (``shard_devices``), where
``ops.flat_topk`` runs its plain version. Randomized workloads are seeded
parametrisations, not hypothesis.
"""
import io
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexPool as JPool
from repro.core import tenancy as jten
from repro.core.codec import get_codec as jget_codec
from repro.data.corpus import BUILTIN_CORPUS
from repro.data.synthetic import make_corpus
from repro.serve.rag import RAGPipeline as JRAGPipeline
from repro.serve.retrieval import RetrievalEngine as JRetrievalEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import IndexPool
from repro_torch.core import tenancy as tten
from repro_torch.core.codec import device_rows, get_codec
from repro_torch.core.flat import FlatVectorIndex
from repro_torch.core.hnsw_build import normalize_rows
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.rag import RAGPipeline
from repro_torch.serve.retrieval import RetrievalEngine
from repro_torch.store import IndexStore

DIM = 16
CODECS = ["fp32", "bf16", "int8"]
METRICS = ["cosine", "ip", "l2"]
DATA = make_corpus(40, DIM, seed=0)
EXTRA = make_corpus(16, DIM, seed=1)
SECRET = make_corpus(8, DIM, seed=7)
INF = np.float32(3e38)


# |q|² + |x|² of the largest rows and queries these tests use
L2_TERMS = 2.0 * float(np.max(np.sum(np.concatenate(
    [DATA, EXTRA, SECRET]) ** 2, axis=1)))


def _tol(metric):
    if metric == "l2":
        return dict(rtol=1e-5, atol=1e-5 * L2_TERMS)
    return dict(rtol=0, atol=1e-5)


def _pools(codec="fp32", roots=(None, None), **kw):
    """(reference pool, port pool on the CPU) built alike."""
    return (JPool(roots[0], dim=DIM, dtype=codec, **kw),
            IndexPool(roots[1], dim=DIM, dtype=codec, device="cpu", **kw))


def _both(pools, verb, *args, **kw):
    return [getattr(p, verb)(*args, **kw) for p in pools]


def _same_results(want, got, metric="cosine"):
    (wk, wd), (gk, gd) = want, got
    assert gk == wk
    np.testing.assert_allclose(np.asarray(gd), np.asarray(wd),
                               **_tol(metric))


def _same_tenant(jp, tp, tid):
    """Keys, epochs and canonical arrays of one tenant, bit for bit."""
    want, got = jp._arena.tenant_rows(tid), tp._arena.tenant_rows(tid)
    assert got[0] == want[0]
    for w, g in zip(want[1:], got[1:]):
        assert (w is None) == (g is None)
        if w is not None:
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    assert tp.epoch(tid) == jp.epoch(tid)


def _oracle(codec, store=None, metric="cosine"):
    idx = FlatVectorIndex(metric=metric, dim=DIM, dtype=codec, device="cpu")
    if store is not None:
        store.attach(idx)
    return idx


def _same_as_dedicated(tp, tid, orc, metric="cosine"):
    """The pooled tenant IS the dedicated index: its ``state_dict``, its
    epoch and its query keys."""
    tp.admit(tid)
    keys, vecs, alive, enc, scales = tp._arena.tenant_rows(tid)
    oa, om = orc.state_dict()
    assert keys == om["keys"] and tp.epoch(tid) == om["epoch"]
    assert alive.tobytes() == np.asarray(oa["alive"]).tobytes()
    if "vectors" in oa:
        assert vecs.tobytes() == np.asarray(oa["vectors"]).tobytes()
    else:
        assert enc.tobytes() == np.asarray(oa["vectors_enc"]).tobytes()
        if scales is not None:
            assert scales.tobytes() == np.asarray(oa["scales"]).tobytes()
    if orc.size == 0:
        assert tp.size(tid) == 0
        return
    _same_results(orc.query_batch(DATA[:5], k=6),
                  tp.query_batch(tid, DATA[:5], k=6), metric)


def walk_bytes(root):
    for dp, _, fns in os.walk(root):
        for fn in fns:
            p = os.path.join(dp, fn)
            with open(p, "rb") as f:
                yield p, f.read()


def _npz_equal(a_bytes, b_bytes):
    a, b = np.load(io.BytesIO(a_bytes)), np.load(io.BytesIO(b_bytes))
    return a.files == b.files and all(
        a[f].dtype == b[f].dtype and a[f].shape == b[f].shape
        and a[f].tobytes() == b[f].tobytes() for f in a.files)


def _same_store_tree(a_dir, b_dir):
    """The same file set; equal bytes except the ``.npz`` pages (each zip
    member carries its write time), which compare as arrays."""
    pa = {os.path.relpath(p, a_dir): b for p, b in walk_bytes(a_dir)}
    pb = {os.path.relpath(p, b_dir): b for p, b in walk_bytes(b_dir)}
    assert pa and set(pa) == set(pb), set(pa) ^ set(pb)
    for rel in pa:
        if rel.endswith(".npz"):
            assert _npz_equal(pa[rel], pb[rel]), rel
        else:
            assert pa[rel] == pb[rel], rel


def _device_bytes(tp):
    """Every packed device buffer of the port's arena, as bytes."""
    _, blocks, gids, scales = tp._arena.pack_arena()
    out = []
    for t in [*blocks, *gids, *(scales or [])]:
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out.append(t.numpy().tobytes())
    return out


def _needles(vecs, enc=None):
    """Byte patterns that must vanish: raw fp32 rows, the normalized rows
    an fp32 pack publishes, and the codec-encoded rows."""
    out = {}
    for i, v in enumerate(np.asarray(vecs, np.float32)):
        out[f"fp32[{i}]"] = np.ascontiguousarray(v).tobytes()
        out[f"norm[{i}]"] = np.ascontiguousarray(
            normalize_rows(v[None])[0]).tobytes()
        if enc is not None:
            out[f"enc[{i}]"] = np.ascontiguousarray(enc[i]).tobytes()
    return out


def _absent(needles, hay: dict):
    for n, needle in needles.items():
        for h, blob in hay.items():
            assert needle not in blob, f"{n} found in {h}"


# ---------------------------------------------------------------------------
# namespacing and the two scans
# ---------------------------------------------------------------------------
def test_namespacing_matches_reference():
    assert tten.NS_SEP == jten.NS_SEP == "\x1f"
    for tid, key in (("alice", "doc-1"), ("t 7/é", ""), ("a", "b\x1fc")):
        assert tten.tenant_key(tid, key) == jten.tenant_key(tid, key)
        ns = tten.tenant_key(tid, key)
        assert tten.split_tenant_key(ns) == jten.split_tenant_key(ns)


def _arena_blocks(codec, metric, seed):
    """A packed shard block of 6 slabs of R 8 (rows of three owners, free
    slots zero with gid -1), each package's encoding of the same rows."""
    rng = np.random.default_rng(seed)
    r, nsl = 8, 6
    x = rng.normal(size=(nsl * r, DIM)).astype(np.float32)
    if metric == "cosine":
        x = normalize_rows(x)
    gids = np.arange(nsl * r, dtype=np.int32) + 100
    free = rng.random(nsl * r) < 0.2
    x[free] = 0.0
    gids[free] = -1
    jenc, jscl = jget_codec(codec).encode(x)
    tenc, tscl = get_codec(codec).encode(x)
    jb = (jnp.asarray(jenc), jnp.asarray(gids),
          None if jscl is None else jnp.asarray(jscl))
    tb = (device_rows(tenc, "cpu"), torch.from_numpy(gids),
          None if tscl is None else torch.from_numpy(tscl))
    q = rng.normal(size=(5, DIM)).astype(np.float32)
    return jb, tb, q, r


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_slab_scan_matches_reference(codec, metric):
    """``_slab_local_topk`` over a table with padding entries (-1, which
    clip to slab 0): the same gids as the reference, distances within
    tolerance, and no padded position's gid can come back."""
    (jb, jg, js), (tb, tg, ts), q, r = _arena_blocks(codec, metric, 3)
    tbl = np.array([4, 1, 3, -1, -1, -1, -1, -1], np.int32)
    if metric == "cosine":
        q = normalize_rows(q)
    want = jten._slab_local_topk(jb, jg, js, jnp.asarray(tbl),
                                 jnp.asarray(q), k=7, slack=8,
                                 metric=metric, slab_rows=r)
    got = tten._slab_local_topk(tb, tg, ts, torch.from_numpy(tbl),
                                torch.from_numpy(q), k=7, slack=8,
                                metric=metric, slab_rows=r)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **_tol(metric))
    # the gathered padding (slab 0, another owner's live rows) is gid -1
    _, g, _ = tten._slab_gather(tb, tg, ts, torch.from_numpy(tbl), r)
    assert bool((g[3 * r:] == -1).all()) and bool((tg[:r] >= 0).any())
    allowed = set(tg[torch.from_numpy(np.repeat([4, 1, 3], r) * r
                                      + np.tile(np.arange(r), 3))]
                  .tolist()) | {-1}
    assert set(got[1].flatten().tolist()) <= allowed


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_multi_scan_matches_reference(codec, metric):
    """``_multi_local_topk``: every query row its own slab table, padding
    masked before selection; gids equal, distances within tolerance."""
    (jb, jg, js), (tb, tg, ts), q, r = _arena_blocks(codec, metric, 4)
    tbl = np.array([[4, 1, -1, -1], [0, 2, 5, -1], [3, -1, -1, -1],
                    [5, 4, 3, 2], [1, 0, -1, -1]], np.int32)
    want = jten._multi_local_topk(jb, jg, js, jnp.asarray(tbl),
                                  jnp.asarray(q), k=9, metric=metric,
                                  slab_rows=r)
    got = tten._multi_local_topk(tb, tg, ts, torch.from_numpy(tbl),
                                 torch.from_numpy(q), k=9, metric=metric,
                                 slab_rows=r)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **_tol(metric))


# ---------------------------------------------------------------------------
# the pool against the reference and a dedicated index
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_pool_matches_reference_and_dedicated(codec, metric):
    pools = _pools(codec, metric=metric, slab_rows=8)
    jp, tp = pools
    oracles = {t: _oracle(codec, metric=metric) for t in ("a", "b", "c")}
    for j, (tid, orc) in enumerate(oracles.items()):
        ks = [f"{tid}{i}" for i in range(10)]
        _both(pools, "bulk_insert", tid, ks, DATA[j * 10:(j + 1) * 10])
        orc.bulk_insert(ks, DATA[j * 10:(j + 1) * 10])
    # interleaved singles: the tenants' slabs interleave in the arena
    for j, (tid, orc) in enumerate(oracles.items()):
        _both(pools, "insert", tid, "solo", EXTRA[j])
        orc.insert("solo", EXTRA[j])
        _both(pools, "update", tid, f"{tid}3", EXTRA[j + 4])
        orc.update(f"{tid}3", EXTRA[j + 4])
        _both(pools, "delete", tid, f"{tid}7")
        orc.delete(f"{tid}7")
    q = DATA[:5] + 0.03 * EXTRA[:5]
    for tid, orc in oracles.items():
        _same_tenant(jp, tp, tid)
        _same_as_dedicated(tp, tid, orc, metric)
        _same_results(*_both(pools, "query_batch", tid, q, k=6), metric)
        assert tp.size(tid) == jp.size(tid) == orc.size
        assert tp.keys(tid) == jp.keys(tid) == orc.keys()
    assert tp.mutation_epoch == jp.mutation_epoch
    assert tp.pool_stats()["slabs"] == jp.pool_stats()["slabs"]
    # unknown tenants and bad ids are rejected, not created
    with pytest.raises(KeyError):
        tp.epoch("nobody")
    with pytest.raises(ValueError, match="tenant id"):
        tp.insert("with\x1fsep", "k", DATA[0])
    with pytest.raises(ValueError, match="invalid key"):
        tp.insert("a", "", DATA[0])


@pytest.mark.parametrize("codec", CODECS)
def test_cross_tenant_batch_matches_per_tenant_queries(codec):
    pools = _pools(codec, slab_rows=8)
    jp, tp = pools
    _both(pools, "bulk_insert", "a", [f"a{i}" for i in range(12)], DATA[:12])
    _both(pools, "bulk_insert", "b", [f"b{i}" for i in range(6)],
          DATA[12:18])
    _both(pools, "bulk_insert", "c", [f"c{i}" for i in range(3)],
          DATA[18:21])
    q = DATA[:6] + 0.03 * EXTRA[:6]
    tenants = ["a", "b", "a", "c", "b", "a"]
    want, got = _both(pools, "query_batch_multi", q, tenants, k=3)
    _same_results(want, got)
    mk, md = got
    for i, tid in enumerate(tenants):
        sk, sd = tp.query_batch(tid, q[i:i + 1], k=3)
        assert mk[i] == sk[0], (codec, i)
        np.testing.assert_allclose(md[i], sd[0], rtol=0, atol=1e-5)
        assert all(key.startswith(tid) for key in mk[i] if key)


def test_per_tenant_epochs_and_cache_survival():
    """Tenant A's delete bumps only A's epoch and drops only A's cached
    entries: B's identical-bytes query is still a hit, in both packages
    alike (the engines' stats equal)."""
    pools = _pools(slab_rows=8)
    jp, tp = pools
    _both(pools, "bulk_insert", "a", [f"a{i}" for i in range(6)], DATA[:6])
    _both(pools, "bulk_insert", "b", [f"b{i}" for i in range(6)], DATA[6:12])
    ea, eb = tp.epoch("a"), tp.epoch("b")
    engines = (JRetrievalEngine(jp, max_batch=8),
               RetrievalEngine(tp, max_batch=8))
    fa = [e.retrieve_one(DATA[0], k=2, tenant="a") for e in engines]
    fb = [e.retrieve_one(DATA[0], k=2, tenant="b") for e in engines]
    assert fa[1].keys == fa[0].keys and fb[1].keys == fb[0].keys
    assert fa[1].keys[0].startswith("a") and fb[1].keys[0].startswith("b")
    _both(pools, "delete", "a", fa[1].keys[0])
    assert tp.epoch("a") == ea + 1 and tp.epoch("b") == eb
    again_b = [e.retrieve_one(DATA[0], k=2, tenant="b") for e in engines]
    assert again_b[1].from_cache and again_b[1].keys == fb[1].keys
    again_a = [e.retrieve_one(DATA[0], k=2, tenant="a") for e in engines]
    assert not again_a[1].from_cache and again_a[1].keys == again_a[0].keys
    assert fa[1].keys[0] not in again_a[1].keys
    _both(pools, "compact", "a")
    assert tp.epoch("b") == eb and tp.epoch("a") == jp.epoch("a")
    assert engines[1].retrieve_one(DATA[0], k=2, tenant="b").from_cache
    engines[0].retrieve_one(DATA[0], k=2, tenant="b")
    assert engines[1].stats.as_dict() == engines[0].stats.as_dict()
    # a's delete and a's compact each dropped a's entries, and only those
    assert engines[1].stats.invalidations == 2
    for e in engines:
        with pytest.raises(ValueError, match="is required"):
            e.submit(DATA[0], k=2)


@pytest.mark.parametrize("codec", CODECS)
def test_no_cross_tenant_leak_from_slab0_padding(codec):
    """"big" owns slab 0 with rows next to the query; "small" owns 3
    slabs, so its table pads to 4 and the padding entry clips to slab 0.
    Even at k past small's rows, no big key comes back."""
    pools = _pools(codec, slab_rows=8)
    jp, tp = pools
    q = DATA[:2]
    near = q[np.arange(8) % 2] + 1e-3 * EXTRA[:8]
    _both(pools, "bulk_insert", "big", [f"big{i}" for i in range(8)], near)
    _both(pools, "bulk_insert", "small", [f"s{i}" for i in range(17)],
          DATA[20:37])
    tbl, l_pad, slack, live = tp._arena.tenant_table("small")
    assert l_pad == 4 and tbl[0, -1] == -1 and live == 17
    assert tp._arena._slab_owner[0][0] == "big"
    want, got = _both(pools, "query_batch", "small", q, k=32)
    _same_results(want, got)
    assert all(k is None or k.startswith("s") for row in got[0] for k in row)
    assert sum(k is not None for k in got[0][0]) == 17
    mk, _ = tp.query_batch_multi(np.concatenate([q, q]),
                                 ["small", "big", "small", "big"], k=32)
    assert all(k is None or k.startswith("s") for k in mk[0] + mk[2])
    assert all(k is None or k.startswith("big") for k in mk[1] + mk[3])


def test_deleted_rows_never_served_before_compact():
    pools = _pools(slab_rows=8)
    _both(pools, "bulk_insert", "a", [f"a{i}" for i in range(8)], DATA[:8])
    _both(pools, "delete", "a", "a0")
    want, got = _both(pools, "query_batch", "a", DATA[:1], k=8)
    _same_results(want, got)
    # 7 live rows at k 8: the free slot's masked entry is the one None
    assert "a0" not in got[0][0] and got[0][0].count(None) == 1
    want, got = _both(pools, "query_batch_multi", DATA[:1], ["a"], k=8)
    _same_results(want, got)
    assert "a0" not in got[0][0]


@pytest.mark.parametrize("codec", CODECS)
def test_byte_absence_after_compact(codec, tmp_path):
    roots = (str(tmp_path / "ref"), str(tmp_path / "port"))
    pools = _pools(codec, roots, slab_rows=8)
    jp, tp = pools
    _both(pools, "bulk_insert", "bob", [f"b{i}" for i in range(10)],
          DATA[:10])
    _both(pools, "bulk_insert", "alice", [f"s{i}" for i in range(8)], SECRET)
    _both(pools, "bulk_insert", "carol", [f"c{i}" for i in range(10)],
          DATA[10:20])
    enc = tp._arena.tenant_rows("alice")[3]
    needles = _needles(SECRET, enc)
    eb, ec = tp.epoch("bob"), tp.epoch("carol")
    _both(pools, "flush")                     # the secrets hit disk first
    for i in range(8):
        _both(pools, "delete", "alice", f"s{i}")
    _both(pools, "compact", "alice")
    arena = tp._arena
    hay = {"arena._vecs": arena._vecs.tobytes()}
    if arena._enc is not None:
        hay["arena._enc"] = arena._enc.tobytes()
    if arena._scales is not None:
        hay["arena._scales"] = arena._scales.tobytes()
    hay.update({f"device[{i}]": b for i, b in enumerate(_device_bytes(tp))})
    hay.update(dict(walk_bytes(roots[1])))
    _absent(needles, hay)
    assert tp.epoch("bob") == eb and tp.epoch("carol") == ec
    for tid in ("bob", "carol", "alice"):
        _same_tenant(jp, tp, tid)
    _same_results(*_both(pools, "query_batch", "bob", DATA[:3], k=3))
    assert tp.size("alice") == 0
    _both(pools, "insert", "alice", "fresh", EXTRA[0])
    assert tp.query("alice", EXTRA[0], k=1)[0] == ["fresh"]
    _same_store_tree(os.path.join(roots[0], "tenants", "alice"),
                     os.path.join(roots[1], "tenants", "alice"))


@pytest.mark.parametrize("codec", CODECS)
def test_evict_restore_bit_for_bit(codec, tmp_path):
    roots = (str(tmp_path / "ref"), str(tmp_path / "port"))
    pools = _pools(codec, roots, slab_rows=8)
    jp, tp = pools
    orc = _oracle(codec)
    ks = [f"d{i}" for i in range(12)]
    _both(pools, "bulk_insert", "t", ks, DATA[:12])
    orc.bulk_insert(ks, DATA[:12])
    _both(pools, "update", "t", "d3", EXTRA[0])
    orc.update("d3", EXTRA[0])
    _both(pools, "delete", "t", "d9")
    orc.delete("d9")
    _both(pools, "evict", "t")
    assert "t" not in tp.resident_tenants()
    # churn the arena while t is paged out: its slab space is recycled
    _both(pools, "bulk_insert", "noise", [f"n{i}" for i in range(16)], EXTRA)
    _same_as_dedicated(tp, "t", orc)
    jp.admit("t")
    _same_tenant(jp, tp, "t")
    _both(pools, "insert", "t", "post", EXTRA[1])
    orc.insert("post", EXTRA[1])
    _same_as_dedicated(tp, "t", orc)
    _both(pools, "delete", "t", "d0")
    orc.delete("d0")
    _both(pools, "compact", "t")
    orc.compact()
    _both(pools, "evict", "t")
    _same_as_dedicated(tp, "t", orc)
    jp.admit("t")
    _same_tenant(jp, tp, "t")
    assert tp.stats == jp.stats


def test_multi_batch_splits_past_max_resident(tmp_path):
    roots = (str(tmp_path / "ref"), str(tmp_path / "port"))
    pools = _pools(roots=roots, max_resident=2, slab_rows=8)
    jp, tp = pools
    for j, tid in enumerate(("a", "b", "c", "d")):
        _both(pools, "bulk_insert", tid, [f"{tid}{i}" for i in range(4)],
              DATA[j * 4:(j + 1) * 4])
    tenants = ["a", "b", "c", "d", "a", "c"]
    want, got = _both(pools, "query_batch_multi", DATA[:6], tenants, k=2)
    _same_results(want, got)
    assert len(got[0]) == 6 and np.asarray(got[1]).shape == (6, 2)
    assert tp.resident_tenants() == jp.resident_tenants()
    assert tp.stats == jp.stats
    for i, tid in enumerate(tenants):
        sk, _ = tp.query_batch(tid, DATA[i:i + 1], k=2)
        assert got[0][i] == sk[0], (i, tid)


def test_lru_order_matches_reference(tmp_path):
    roots = (str(tmp_path / "ref"), str(tmp_path / "port"))
    pools = _pools(roots=roots, max_resident=2, slab_rows=8)
    jp, tp = pools
    for j, tid in enumerate(("a", "b", "c")):
        _both(pools, "bulk_insert", tid, [f"{tid}{i}" for i in range(4)],
              DATA[j * 4:(j + 1) * 4])
    assert tp.resident_tenants() == jp.resident_tenants() == ["b", "c"]
    assert tp.stats["evictions"] == 1
    _same_results(*_both(pools, "query_batch", "a", DATA[:1], k=2))
    assert tp.resident_tenants() == jp.resident_tenants() == ["c", "a"]
    assert tp.size("b") == 4 and tp.resident_tenants() == ["a", "b"]
    assert _both(pools, "contains", "b", "b1") == [True, True]
    assert _both(pools, "contains", "nobody", "x") == [False, False]
    assert tp.resident_tenants() == jp.resident_tenants()
    assert tp.stats == jp.stats


def test_slab_reuse_never_leaks_previous_owner(tmp_path):
    roots = (str(tmp_path / "ref"), str(tmp_path / "port"))
    pools = _pools(roots=roots, slab_rows=8)
    jp, tp = pools
    _both(pools, "bulk_insert", "alice", [f"s{i}" for i in range(8)], SECRET)
    assert tp._arena._slab_owner[0][0] == "alice"
    _both(pools, "evict", "alice")                # slab returned to the pool
    _both(pools, "bulk_insert", "bob", ["b0", "b1"], EXTRA[:2])
    assert tp._arena._slab_owner[0][0] == "bob"   # the freed slab, reused
    want, got = _both(pools, "query_batch", "bob", SECRET[:4], k=8)
    _same_results(want, got)
    assert all(k is None or k.startswith("b") for row in got[0] for k in row)
    hay = {"arena._vecs": tp._arena._vecs.tobytes()}
    hay.update({f"device[{i}]": b for i, b in enumerate(_device_bytes(tp))})
    _absent(_needles(SECRET), hay)
    assert tp.size("alice") == 8                  # and alice is intact
    jp.size("alice")
    _same_tenant(jp, tp, "alice")


# ---------------------------------------------------------------------------
# stores: byte parity and cross-loading
# ---------------------------------------------------------------------------
def _store_script(pools, orcs=None, stores=None):
    """Mutations with an evict (a snapshot) and WAL records after it, on
    every pool of ``pools`` and, mirrored, on dedicated indexes."""
    def each(verb, tid, *args):
        _both(pools, verb, tid, *args)
        if orcs is not None and verb not in ("evict", "flush"):
            getattr(orcs[tid], verb)(*args)
        if orcs is not None and verb == "evict":
            stores[tid].snapshot(orcs[tid])

    for j, tid in enumerate(("t0", "t1", "t2")):
        each("bulk_insert", tid, [f"k{i}" for i in range(9)],
             DATA[j * 9:(j + 1) * 9])
    each("evict", "t1")
    each("insert", "t0", "x", EXTRA[0])
    each("update", "t1", "k2", EXTRA[1])
    each("delete", "t2", "k4")
    each("bulk_insert", "t1", ["y0", "k5", "y0"], EXTRA[2:5])
    each("delete", "t0", "k0")


@pytest.mark.parametrize("codec", CODECS)
def test_store_bytes_equal_reference_and_dedicated(codec, tmp_path):
    roots = (str(tmp_path / "ref"), str(tmp_path / "port"))
    pools = _pools(codec, roots, slab_rows=8)
    stores = {t: IndexStore(str(tmp_path / "dedicated" / t),
                            page_bytes=4 << 20) for t in ("t0", "t1", "t2")}
    orcs = {t: _oracle(codec, stores[t]) for t in stores}
    _store_script(pools, orcs, stores)
    for tid in stores:
        # a dedicated WAL-only store writes its config at attach, as the
        # pool does at a tenant's creation
        _same_store_tree(os.path.join(roots[0], "tenants", tid),
                         os.path.join(roots[1], "tenants", tid))
        _same_store_tree(os.path.join(roots[1], "tenants", tid),
                         stores[tid].root)
    _both(pools, "flush")
    for tid in stores:
        stores[tid].snapshot(orcs[tid])
        _same_store_tree(os.path.join(roots[0], "tenants", tid),
                         os.path.join(roots[1], "tenants", tid))
        _same_store_tree(os.path.join(roots[1], "tenants", tid),
                         stores[tid].root)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("codec", CODECS)
def test_pool_root_restores_across_packages(codec, writer, tmp_path):
    """A pool root written by one package (snapshots and WAL tails)
    warm-restores in the other with the writer's keys, epochs and state
    arrays."""
    root = str(tmp_path / "pool")
    mk = (lambda: JPool(root, dim=DIM, dtype=codec, slab_rows=8)) \
        if writer == "reference" else \
        (lambda: IndexPool(root, dim=DIM, dtype=codec, slab_rows=8,
                           device="cpu"))
    live = mk()
    _store_script([live])
    if writer == "reference":
        back = IndexPool(root, dim=DIM, dtype=codec, slab_rows=8,
                         device="cpu")
        pools = (live, back)
    else:
        back = JPool(root, dim=DIM, dtype=codec, slab_rows=8)
        pools = (back, live)
    for tid in ("t0", "t1", "t2"):
        assert back.size(tid) == live.size(tid)      # pages the tenant in
        _same_tenant(*pools, tid)
        _same_results(*_both(pools, "query_batch", tid, DATA[:4], k=5))


# ---------------------------------------------------------------------------
# sharded pools: the port at S against the reference at one shard
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_pool_matches_reference(shards, codec, tmp_path):
    rng = np.random.default_rng(5)
    data = rng.normal(size=(24, DIM)).astype(np.float32)
    sec = rng.normal(size=(8, DIM)).astype(np.float32)
    extra = rng.normal(size=(8, DIM)).astype(np.float32)
    jp = JPool(str(tmp_path / "ref"), dim=DIM, dtype=codec, slab_rows=4)
    tp = IndexPool(str(tmp_path / "port"), dim=DIM, dtype=codec,
                   slab_rows=4, n_shards=shards, device="cpu")
    pools = (jp, tp)
    _both(pools, "bulk_insert", "alice", [f"a{i}" for i in range(24)], data)
    _both(pools, "bulk_insert", "bob", [f"s{i}" for i in range(8)], sec)
    _both(pools, "update", "alice", "a3", extra[0])
    _both(pools, "delete", "alice", "a9")
    q = data[:5] + 0.02 * extra[:5]
    _same_results(*_both(pools, "query_batch", "alice", q, k=6))
    _same_results(*_both(pools, "query_batch_multi", np.concatenate([q, q]),
                         ["alice", "bob"] * 5, k=6))
    _same_tenant(jp, tp, "alice")
    assert len(tp._arena.pack_arena()[1]) == shards
    # evict -> restore under churn, bit for bit
    before = tp._arena.tenant_rows("alice")
    _both(pools, "evict", "alice")
    _both(pools, "bulk_insert", "noise", [f"n{i}" for i in range(8)], extra)
    _both(pools, "admit", "alice")
    after = tp._arena.tenant_rows("alice")
    assert before[0] == after[0]
    for x, y in zip(before[1:], after[1:]):
        assert (x is None and y is None) or x.tobytes() == y.tobytes()
    _same_tenant(jp, tp, "alice")
    _same_results(*_both(pools, "query_batch", "alice", q, k=6))
    # bob's retract + compact leaves no byte in any shard's block
    needles = _needles(sec, tp._arena.tenant_rows("bob")[3])
    _both(pools, "flush")
    for i in range(8):
        _both(pools, "delete", "bob", f"s{i}")
    _both(pools, "compact", "bob")
    hay = {"arena._vecs": tp._arena._vecs.tobytes()}
    hay.update({f"device[{i}]": b for i, b in enumerate(_device_bytes(tp))})
    hay.update(dict(walk_bytes(str(tmp_path / "port"))))
    _absent(needles, hay)
    _same_results(*_both(pools, "query_batch", "alice", q, k=6))
    _same_tenant(jp, tp, "bob")


# ---------------------------------------------------------------------------
# a seeded randomized interleaved workload
# ---------------------------------------------------------------------------
def _workload(pools, steps, rng, n_tenants):
    """Interleave insert/bulk/update/delete/query/evict/admit/compact over
    every tenant on both pools; results, epochs and residency compared as
    we go."""
    jp, tp = pools
    tids = [f"t{i}" for i in range(n_tenants)]
    vecs = make_corpus(256, DIM, seed=int(rng.integers(1 << 30)))
    counters = dict.fromkeys(tids, 0)
    for i, tid in enumerate(tids):
        _both(pools, "insert", tid, "seed", DATA[i])
    for _ in range(steps):
        tid = tids[int(rng.integers(len(tids)))]
        live = tp.keys(tid)
        assert live == jp.keys(tid)
        op = int(rng.integers(9))
        if op == 0 or not live:                        # insert
            key = f"k{counters[tid]}"
            counters[tid] += 1
            _both(pools, "insert", tid, key, vecs[int(rng.integers(256))])
        elif op == 1:                                  # bulk (dups ok)
            n = int(rng.integers(1, 5))
            ks = [f"k{counters[tid] + j % 3}" for j in range(n)]
            counters[tid] += n
            _both(pools, "bulk_insert", tid, ks,
                  vecs[rng.integers(0, 256, n)])
        elif op == 2:                                  # update
            key = live[int(rng.integers(len(live)))]
            _both(pools, "update", tid, key, vecs[int(rng.integers(256))])
        elif op == 3:                                  # delete
            _both(pools, "delete", tid, live[int(rng.integers(len(live)))])
        elif op == 4:                                  # query
            k = int(rng.integers(1, 6))
            _same_results(*_both(pools, "query_batch", tid,
                                 vecs[rng.integers(0, 256, 3)], k=k))
        elif op == 5:                                  # cross-tenant query
            ts = [tids[int(j)] for j in rng.integers(0, len(tids), 4)]
            q = vecs[rng.integers(0, 256, 4)]
            outs = []
            for p in pools:                 # a tenant emptied by deletes
                try:                        # raises in both packages
                    outs.append(p.query_batch_multi(q, ts, k=3))
                except ValueError as e:
                    outs.append(str(e))
            if isinstance(outs[0], str):
                assert outs[1] == outs[0] == "index is empty"
            else:
                _same_results(*outs)
        elif op == 6:                                  # evict (page out)
            if tid in tp.resident_tenants():
                _both(pools, "evict", tid)
        elif op == 7:                                  # admit (page in)
            _both(pools, "admit", tid)
        else:                                          # compact
            _both(pools, "compact", tid)
        assert tp.epoch(tid) == jp.epoch(tid), tid
        assert tp.resident_tenants() == jp.resident_tenants()
    return tids


@pytest.mark.parametrize("seed,codec,durable", [
    (0, "fp32", False), (1, "int8", True), (2, "bf16", True)])
def test_randomized_workload_matches_reference(seed, codec, durable,
                                               tmp_path):
    roots = ((str(tmp_path / "ref"), str(tmp_path / "port")) if durable
             else (None, None))
    pools = _pools(codec, roots, slab_rows=8, max_resident=6)
    jp, tp = pools
    tids = _workload(pools, 70, np.random.default_rng(seed), 8)
    assert tp.mutation_epoch == jp.mutation_epoch and tp.stats == jp.stats
    for tid in tids:
        tp.admit(tid)
        jp.admit(tid)
        _same_tenant(jp, tp, tid)
    if durable:
        _both(pools, "flush")
        for tid in tids:
            _same_store_tree(os.path.join(roots[0], "tenants", tid),
                             os.path.join(roots[1], "tenants", tid))


# ---------------------------------------------------------------------------
# serving: the engine, the pipeline, generate_rag and launch.serve
# ---------------------------------------------------------------------------
def test_retrieval_engine_pool_mode_matches_reference():
    pools = _pools("int8", slab_rows=8)
    for j, tid in enumerate(("a", "b", "c")):
        _both(pools, "bulk_insert", tid, [f"{tid}{i}" for i in range(9)],
              DATA[j * 9:(j + 1) * 9])
    engines = (JRetrievalEngine(pools[0], max_batch=8),
               RetrievalEngine(pools[1], max_batch=8))
    q = np.concatenate([DATA[:5], DATA[:2]])
    tenants = ["a", "b", "c", "a", "b", "a", "c"]
    want, got = (e.retrieve(q, k=4, tenants=tenants) for e in engines)
    for w, g, tid in zip(want, got, tenants):
        assert g.tenant == tid and g.keys == w.keys
        assert all(k.startswith(tid) for k in g.keys)
        np.testing.assert_allclose(g.dists, w.dists, rtol=0, atol=1e-5)
    # one search for the whole cross-tenant tick; repeats hit the cache
    assert engines[1].stats.searches == 1
    again = engines[1].retrieve(q[:3], k=4, tenants=tenants[:3])
    assert all(r.from_cache for r in again)
    engines[0].retrieve(q[:3], k=4, tenants=tenants[:3])
    assert engines[1].stats.as_dict() == engines[0].stats.as_dict()
    with pytest.raises(ValueError, match="length mismatch"):
        engines[1].retrieve(q[:2], k=2, tenants=["a"])


def _docs(rows):
    return [[(d.key, d.text) for d in row] for row in rows]


def test_rag_pipeline_pool_mode_matches_reference():
    jrag = JRAGPipeline(index=JPool(dtype="int8", slab_rows=8))
    trag = RAGPipeline(index=IndexPool(dtype="int8", slab_rows=8,
                                       device="cpu"))
    rags = (jrag, trag)
    docs = list(BUILTIN_CORPUS)
    for rag in rags:
        assert rag.pool_mode
        rag.add_documents(docs, tenant="alice")
        rag.add_documents(docs[:6], tenant="bob")
        rag.add_document("note", "alice keeps private notes", tenant="alice")
    qs = ["how does hnsw search work", "why is on device retrieval private"]
    ts = ["alice", "bob"]
    want, got = (rag.retrieve_batch(qs, k=3, tenants=ts) for rag in rags)
    assert _docs(got) == _docs(want)
    top = got[1][0].key
    for rag in rags:
        rag.delete_document(top, tenant="bob")
        rag.update_document("note", "bob reads nothing of alice",
                            tenant="alice")
    want, got = (rag.retrieve_batch(qs, k=3, tenants=ts) for rag in rags)
    assert _docs(got) == _docs(want) and top not in [d.key for d in got[1]]
    assert [trag.current_epoch(t) for t in ts] == \
        [jrag.current_epoch(t) for t in ts]
    assert trag.current_epoch() == jrag.current_epoch()
    for rag in rags:
        rag.register_texts(docs, tenant="bob")
    assert _docs([trag.retrieve(qs[0], k=2, tenant="bob")]) == \
        _docs([jrag.retrieve(qs[0], k=2, tenant="bob")])
    with pytest.raises(ValueError, match="pass tenant="):
        trag.retrieve(qs[0])


def test_generate_rag_with_tenants():
    """``ServeEngine.generate_rag(tenants=)`` serves each request from its
    own tenant's corpus: the docs the reference pipeline retrieves for the
    same queries and tenants."""
    cfg = get_smoke_config("llama3-8b")
    model = ttf.init_lm(cfg, seed=0, device="cpu")
    trag = RAGPipeline(index=IndexPool(slab_rows=8, device="cpu"))
    jrag = JRAGPipeline(index=JPool(slab_rows=8))
    for rag in (jrag, trag):
        rag.add_documents(list(BUILTIN_CORPUS)[:6], tenant="a")
        rag.add_documents(list(BUILTIN_CORPUS)[6:], tenant="b")
    qs = ["how does hnsw search work"] * 2 + ["what is private"]
    ts = ["a", "b", "b"]
    eng = ServeEngine(model, cfg, slots=2, max_len=96, device="cpu")
    rows = eng.generate_rag(trag, qs, k=2, tenants=ts, max_new_tokens=2)
    want = jrag.retrieve_batch(qs, k=2, tenants=ts)
    assert [[d.key for d in r["docs"]] for r in rows] == \
        [[d.key for d in w] for w in want]
    assert all(len(r["response"].split()) == 2 for r in rows)
    with pytest.raises(ValueError, match="length mismatch"):
        eng.generate_rag(trag, qs, tenants=ts[:1])


@pytest.mark.parametrize("durable", [False, True])
def test_launch_serve_tenants_on_cpu(durable, tmp_path, caplog):
    argv = ["--rag", "--tenants", "2", "--max-resident", "1",
            "--index-dtype", "int8", "--device", "cpu", "--requests", "4",
            "--max-new", "2", "--max-len", "96", "--slots", "2"]
    if durable:
        argv += ["--store-dir", str(tmp_path / "pool")]
    with caplog.at_level(logging.INFO, logger="repro_torch"):
        out = tserve.main(argv)
    reqs = out["reqs"]
    assert [r.tenant for r in reqs] == ["tenant0", "tenant1"] * 2
    jrag = JRAGPipeline(index=JPool(dtype="int8", max_resident=1))
    for tid in ("tenant0", "tenant1"):
        jrag.add_documents(list(BUILTIN_CORPUS), tenant=tid)
    want = jrag.retrieve_batch([r.query for r in reqs], k=3,
                               tenants=[r.tenant for r in reqs])
    assert [[d.key for d in r.docs] for r in reqs] == \
        [[d.key for d in w] for w in want]
    pool = out["rag"].index
    assert pool.stats["evictions"] >= 2 and "pool: 2 tenants" in caplog.text
    if not durable:
        return
    epochs = [pool.epoch(t) for t in ("tenant0", "tenant1")]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="repro_torch"):
        warm = tserve.main(argv)
    assert "tenant0: warm restore" in caplog.text
    assert [warm["rag"].index.epoch(t) for t in ("tenant0", "tenant1")] == \
        epochs                                 # nothing re-inserted
    assert [[d.key for d in r.docs] for r in warm["reqs"]] == \
        [[d.key for d in r.docs] for r in reqs]
