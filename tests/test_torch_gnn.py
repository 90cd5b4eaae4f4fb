"""Port parity for ``models/gnn.py`` and ``models/sampler.py`` (CPU)
against ``repro`` on the smoke config, the reference's own weights
(``convert.sage_params_from_jax``) and graphs from ``make_graph``.

Tolerances: the CSR and the sampled ids exactly (the sampler fed the
reference's own uniform draw); the sampled and molecule forwards and the
loss values within rtol = atol = 1e-5; the full-graph logits within
rtol = atol = 1e-4 (the port sums each node's messages as one segment
after a sort by destination, the reference scatter-adds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.data import synthetic as jsyn
from repro.models import gnn as jgnn
from repro.models import sampler as jsampler
from repro_torch.configs import get_smoke_config
from repro_torch.convert import sage_params_from_jax
from repro_torch.data import synthetic
from repro_torch.models import gnn as tgnn
from repro_torch.models import sampler as tsampler

N, DEG, D, C, BATCH = 200, 5, 12, 4, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget_smoke_config("graphsage-reddit"), \
        get_smoke_config("graphsage-reddit")
    params = jax.tree.map(np.asarray, jgnn.init_sage(jax.random.PRNGKey(0),
                                                     jcfg, D, C))
    # one zero-degree node: its sample falls back to itself
    g = synthetic.make_graph(N, DEG, D, C, seed=1)
    keep = g.edge_src != 7
    src, dst = g.edge_src[keep], g.edge_dst[keep]
    row_ptr, col_idx = tsampler.make_csr(N, src, dst)
    return dict(jcfg=jcfg, cfg=cfg, params=params,
                tparams=sage_params_from_jax(params), g=g, src=src, dst=dst,
                row_ptr=row_ptr, col_idx=col_idx)


@pytest.mark.parametrize("n,e,seed", [(40, 200, 0), (1000, 5000, 1),
                                      (50, 0, 2)])
def test_make_csr_matches_reference(n, e, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    got, want = tsampler.make_csr(n, src, dst), jsampler.make_csr(n, src, dst)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fanout,seed", [(1, 0), (7, 1), (15, 2)])
def test_sampler_ids_from_reference_draw(setup, fanout, seed):
    """The step from uniforms to ids is the reference's: fed its own
    ``jax.random.uniform`` draw, the ids are equal."""
    key = jax.random.PRNGKey(seed)
    seeds = np.arange(0, N, 3, dtype=np.int32)
    rp, ci = setup["row_ptr"], setup["col_idx"]
    want = jsampler.sample_neighbors(key, jnp.asarray(rp), jnp.asarray(ci),
                                     jnp.asarray(seeds), fanout)
    u = jax.random.uniform(key, (seeds.shape[0], fanout))
    got = tsampler.neighbors_from_uniform(_t(u), _t(rp), _t(ci), _t(seeds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generator_sampler_draws_csr_neighbours(setup):
    rp, ci = setup["row_ptr"], setup["col_idx"]
    adj = {i: set(ci[rp[i]:rp[i + 1]].tolist()) for i in range(N)}
    assert not adj[7]
    seeds = torch.arange(N, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    out = tsampler.sample_neighbors(gen, _t(rp), _t(ci), seeds, 9)
    again = tsampler.sample_neighbors(torch.Generator().manual_seed(0),
                                      _t(rp), _t(ci), seeds, 9)
    assert out.shape == (N, 9) and torch.equal(out, again)
    for i in range(N):
        assert set(out[i].tolist()) <= (adj[i] or {i}), i


def test_full_graph_forward_matches_reference(setup):
    s = setup
    feats = s["g"].feats
    want = jgnn.sage_full_forward(s["params"], s["jcfg"], jnp.asarray(feats),
                                  jnp.asarray(s["src"]), jnp.asarray(s["dst"]))
    got = tgnn.sage_full_forward(s["tparams"], s["cfg"], _t(feats),
                                 _t(s["src"]), _t(s["dst"]))
    _close(got, want, 1e-4)
    labels, mask = s["g"].labels, (np.arange(N) % 3 == 0).astype(np.float32)
    _close(tgnn.sage_full_loss(s["tparams"], s["cfg"], _t(feats),
                               _t(s["src"]), _t(s["dst"]), _t(labels),
                               _t(mask)),
           jgnn.sage_full_loss(s["params"], s["jcfg"], jnp.asarray(feats),
                               jnp.asarray(s["src"]), jnp.asarray(s["dst"]),
                               jnp.asarray(labels), jnp.asarray(mask)), 1e-4)


def test_sampled_forward_and_train_step_match_reference(setup, monkeypatch):
    """``sampled_train_from_graph`` with the reference's two draws
    injected: the same sampled tree, the same loss value."""
    s = setup
    key = jax.random.PRNGKey(3)
    f1, f2 = s["cfg"].sample_sizes
    seeds = np.arange(5, 5 + BATCH, dtype=np.int32)
    labels = s["g"].labels[seeds]
    rp, ci, feats = s["row_ptr"], s["col_idx"], s["g"].feats
    want = jgnn.sampled_train_from_graph(
        s["params"], s["jcfg"], jnp.asarray(rp), jnp.asarray(ci),
        jnp.asarray(feats), jnp.asarray(seeds), jnp.asarray(labels), key,
        (f1, f2))
    k1, k2 = jax.random.split(key)
    draws = iter([jax.random.uniform(k1, (BATCH, f1)),
                  jax.random.uniform(k2, (BATCH * f1, f2))])
    monkeypatch.setattr(tsampler, "draw_uniform",
                        lambda gen, shape: _t(next(draws)))
    gen = torch.Generator()
    got = tgnn.sampled_train_from_graph(
        s["tparams"], s["cfg"], _t(rp), _t(ci), _t(feats), _t(seeds),
        _t(labels), gen, (f1, f2))
    _close(got, want)
    # the forward itself on one sampled tree
    draws = iter([jax.random.uniform(k1, (BATCH, f1)),
                  jax.random.uniform(k2, (BATCH * f1, f2))])
    (n1, n2), xs = tgnn.sample_tree(gen, _t(rp), _t(ci), _t(feats),
                                    _t(seeds), (f1, f2))
    jn1 = jsampler.sample_neighbors(k1, jnp.asarray(rp), jnp.asarray(ci),
                                    jnp.asarray(seeds), f1)
    np.testing.assert_array_equal(n1.numpy(), np.asarray(jn1))
    _close(tgnn.sage_sampled_forward(s["tparams"], s["cfg"], *xs),
           jgnn.sage_sampled_forward(s["params"], s["jcfg"],
                                     *(jnp.asarray(x.numpy()) for x in xs)))


def test_molecule_forward_matches_reference(setup):
    s = setup
    batch = next(synthetic.molecule_batches(6, 12, D, C, seed=2))
    jb = next(jsyn.molecule_batches(6, 12, D, C, seed=2))
    np.testing.assert_array_equal(batch["adj"], jb["adj"])
    _close(tgnn.sage_molecule_forward(s["tparams"], s["cfg"],
                                      _t(batch["feats"]), _t(batch["adj"])),
           jgnn.sage_molecule_forward(s["params"], s["jcfg"],
                                      jnp.asarray(batch["feats"]),
                                      jnp.asarray(batch["adj"])))
    _close(tgnn.sage_molecule_loss(s["tparams"], s["cfg"], _t(batch["feats"]),
                                   _t(batch["adj"]), _t(batch["labels"])),
           jgnn.sage_molecule_loss(s["params"], s["jcfg"],
                                   jnp.asarray(batch["feats"]),
                                   jnp.asarray(batch["adj"]),
                                   jnp.asarray(batch["labels"])))


def test_init_sage_layout(setup):
    s = setup
    a = tgnn.init_sage(s["cfg"], D, C, seed=4, device="cpu")
    b = tgnn.init_sage(s["cfg"], D, C, seed=4, device="cpu")
    for la, lb, lj in zip(a["layers"], b["layers"], s["params"]["layers"]):
        for name in ("w_self", "w_neigh", "b"):
            assert tuple(la[name].shape) == lj[name].shape
            assert torch.equal(la[name], lb[name])
    assert tuple(a["w_out"].shape) == s["params"]["w_out"].shape
