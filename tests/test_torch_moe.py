"""Port parity for ``models/moe.py`` (CPU) against ``repro.models.moe``
on seeded inputs and the reference's own weights.

Routing is integer output: each token's top-k experts (the reference's
``lax.top_k`` ids, recorded from its own call), each assignment's
position within its expert, the keep mask and the slots must be equal.
The layer's output and the Switch aux loss agree within 1e-5 (fp32
products; the port sums a token's k rows in a fixed order where the
reference scatter-adds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as tmoe


def _layer(cfg: JMoEConfig, d: int, seed: int = 0):
    """(reference layer params, port ``MoE`` holding the same weights)."""
    p = jax.tree.map(lambda x: np.array(x[0]),
                     jmoe.init_moe_layer(jax.random.PRNGKey(seed), 1, d, cfg))
    mod = tmoe.MoE(d, MoEConfig(**dataclasses.asdict(cfg)), device="cpu")
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    return p, mod.requires_grad_(False)


def _reference(p, cfg, x, monkeypatch):
    """The reference's (out, aux) and the (gate_w, ids) its ``lax.top_k``
    returned, recorded from the call (traced once under ``jax.jit``)."""
    top_k = jax.lax.top_k

    def run(p, x):
        seen = []

        def recording(a, k):
            seen.append(top_k(a, k))
            return seen[-1]

        monkeypatch.setattr(jax.lax, "top_k", recording)
        out, aux = jmoe.moe_ffn(p, cfg, x)
        monkeypatch.undo()
        (gate_w, ids), = seen
        return out, aux, gate_w[0], ids[0]

    return tuple(np.asarray(a) for a in jax.jit(run)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


def _positions(ids: np.ndarray, n_slots: int) -> np.ndarray:
    """Each (token, k) assignment's position within its expert, counted in
    flattened (token, k) order (a loop, the dispatch's definition)."""
    seen = np.zeros(n_slots, np.int64)
    pos = np.empty(ids.size, np.int64)
    for a, e in enumerate(ids.reshape(-1)):
        pos[a] = seen[e]
        seen[e] += 1
    return pos


def _check(cfg, d, t, monkeypatch, seed=1, x=None, p_mod=None):
    p, mod = p_mod or _layer(cfg, d)
    if x is None:
        x = np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)
    out_j, aux_j, gate_j, ids_j = _reference(p, cfg, x, monkeypatch)
    tcfg = MoEConfig(**dataclasses.asdict(cfg))
    xt = torch.from_numpy(x)
    probs, gate_w, ids, pos, keep = tmoe.route(mod, tcfg, xt)
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    # the recorded top-k probabilities, renormalized as the reference does
    gate_j = gate_j / np.maximum(gate_j.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(gate_w.numpy(), gate_j, rtol=0, atol=1e-6)
    C = tmoe.capacity(t, tcfg)
    assert C == jmoe.capacity(t, cfg)
    want_pos = _positions(ids_j, cfg.n_slots)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_pos < C)
    slot = np.where(want_pos < C, ids_j.reshape(-1) * C + want_pos,
                    cfg.n_slots * C)
    np.testing.assert_array_equal(
        torch.where(keep, ids.reshape(-1) * C + pos,
                    cfg.n_slots * C).numpy(), slot)
    out, aux = tmoe.moe_ffn(mod, tcfg, xt)
    np.testing.assert_allclose(out.numpy(), out_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=0, atol=1e-5)
    return keep.numpy(), ids.numpy()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("t", [4, 64])
def test_moe_ffn_matches_reference(arch, t, monkeypatch):
    """The smoke configs' MoE at a decode tick's 4 tokens and a prefill's
    64."""
    cfg = jget_smoke_config(arch)
    _check(cfg.moe, cfg.d_model, t, monkeypatch)


def test_moe_ffn_drops_past_capacity_as_reference(monkeypatch):
    """capacity_factor 0.25: assignments past C go to the sink."""
    cfg = JMoEConfig(n_experts=8, top_k=2, d_ff=16, capacity_factor=0.25)
    keep, _ = _check(cfg, 12, 96, monkeypatch)
    assert 0 < keep.sum() < keep.size


def test_padded_experts_are_dead_as_reference(monkeypatch):
    """pad_experts_to: slots past n_experts get no token."""
    base = jget_smoke_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(base.moe, pad_experts_to=8)
    keep, ids = _check(cfg, base.d_model, 48, monkeypatch)
    assert ids.max() < cfg.n_experts < cfg.n_slots


def test_tied_probabilities_keep_the_lower_expert(monkeypatch):
    """A zero router gives every token equal probabilities: the top k are
    experts 0 .. k-1, as ``lax.top_k`` orders ties."""
    cfg = JMoEConfig(n_experts=6, top_k=3, d_ff=8, capacity_factor=8.0)
    p, mod = _layer(cfg, 10)
    p["router"] = np.zeros_like(p["router"])
    with torch.no_grad():
        mod.router.zero_()
    _, ids = _check(cfg, 10, 16, monkeypatch, p_mod=(p, mod))
    np.testing.assert_array_equal(ids, np.tile(np.arange(3), (16, 1)))


def test_capacity_matches_reference():
    for n_experts, top_k, cf in [(64, 8, 1.25), (40, 8, 1.25), (8, 2, 1.25),
                                 (5, 2, 0.25), (4, 3, 0.5)]:
        jcfg = JMoEConfig(n_experts=n_experts, top_k=top_k, d_ff=8,
                          capacity_factor=cf)
        tcfg = MoEConfig(**dataclasses.asdict(jcfg))
        for t in (1, 4, 7, 64, 1000, 1024):
            assert tmoe.capacity(t, tcfg) == jmoe.capacity(t, jcfg)
    # a decode tick of 4 slots, and a 4 x 256 prefill (olmoe, granite)
    olmoe = jget_smoke_config("olmoe-1b-7b").moe
    assert tmoe.capacity(4, dataclasses.replace(olmoe, n_experts=64,
                                                top_k=8)) == 8
    assert tmoe.capacity(1024, dataclasses.replace(olmoe, n_experts=64,
                                                   top_k=8)) == 160
    assert tmoe.capacity(1024, dataclasses.replace(olmoe, n_experts=40,
                                                   top_k=8)) == 256


def test_moe_init_scheme():
    """``reset_parameters`` draws the reference's scheme: router, we1,
    we3 at std 0.02, we2 at 0.02 / sqrt(2 L)."""
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff=64)
    mod = tmoe.MoE(96, cfg, device="cpu").requires_grad_(False)
    mod.reset_parameters(torch.Generator().manual_seed(0), n_layers=8)
    assert tuple(mod.router.shape) == (96, 8)
    assert tuple(mod.we1.shape) == tuple(mod.we3.shape) == (8, 96, 64)
    assert tuple(mod.we2.shape) == (8, 64, 96)
    for w, std in ((mod.router, 0.02), (mod.we1, 0.02), (mod.we3, 0.02),
                   (mod.we2, 0.005)):
        assert abs(float(w.std()) / std - 1) < 0.1
