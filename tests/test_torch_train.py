"""Port parity for the LM train step (CPU): ``train/optimizer.py``,
``train/train_loop.py``, ``models/transformer.py``'s ``lm_loss`` and
``forward_hidden``, the packed causal attention, ``launch/train.py``'s
LM build and the tree helpers of ``utils.py``, each against ``repro``
on the same inputs (the reference's weights carried across by
``convert.lm_params_from_jax``, its optimizer state compared through
``convert.opt_state_from_jax``).

Tolerances:
  * ``adamw_update`` and ``clip_by_global_norm`` on the same grads: p, m
    and v within rtol 1e-6 (atol 1e-7); the schedules within rtol 1e-6;
    the tree helpers within rtol 1e-6;
  * the loss and the global grad norm of a step within 1e-5 relative
    (fp32 sums in another order);
  * after two steps, m and v within 1e-4 x max|leaf| per leaf; each
    weight within 5e-2 x lr + 1e-6 x |p| elementwise and the weights'
    gap within 1e-4 of the update's norm. Adam's m/sqrt(v) is sign-like
    where a gradient sits within rounding of zero (or of eps), so a few
    elements move by a share of lr: the worst measured was 1.1e-2 x lr,
    above 1e-3 x lr on fewer than 1e-4 of the elements;
  * gradients of the loss variants (remat off, chunked loss, packed
    attention) within rtol 1e-5, atol 1e-5 x max|grad|; the packed
    attention within 1e-5 of the reference's packed and masked forms;
  * bf16 compute: the loss and every gradient leaf within 3e-2 x
    max|value| of the reference's at ``jnp.bfloat16`` (the bound
    ``test_torch_bf16.py`` holds bf16 logits to: roundings that XLA's
    fused program drops move values by an ulp here and there).
"""
import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.configs import get_smoke_config as jget_smoke_config
from repro.launch import train as jlaunch
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import utils as tutils
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic
from repro_torch.convert import (
    lm_params_from_jax,
    named_from_jax,
    opt_state_from_jax,
)
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.common import _ProductF32, named_tensors
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

LMS = ["llama3-8b", "minitron-8b", "h2o-danube-3-4b", "olmoe-1b-7b",
       "granite-moe-3b-a800m"]
ARGS = argparse.Namespace(seed=0, batch=4, seq=32, device="cpu")
PEAK_LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_lm(jparams, cfg) -> ttf.LM:
    model = ttf.LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(_np(jparams)))
    return model.requires_grad_(False)


def _opt(lib):
    return lib.AdamWConfig(lr=lib.warmup_cosine(PEAK_LR, 2, 10))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def assert_state_close(model, tstate, jparams, jstate, jparams0, lr: float):
    """The port's weights, m and v after a step against the reference's,
    at the module docstring's tolerances."""
    want = named_from_jax(_np(jparams), model)
    start = named_from_jax(_np(jparams0), model)
    wstate = opt_state_from_jax(_np(jstate), like=model)
    assert int(tstate.step) == int(wstate.step)
    gap = upd = 0.0
    for name, p in named_tensors(model):
        p, w = p.detach(), want[name].to(p.dtype)
        tol = 5e-2 * lr + 1e-6 * w.abs()
        assert bool(((p - w).abs() <= tol).all()), name
        gap += float(((p - w).double() ** 2).sum())
        upd += float(((w - start[name]).double() ** 2).sum())
        for got, ref in ((tstate.m[name], wstate.m[name]),
                         (tstate.v[name], wstate.v[name])):
            assert float((got - ref).abs().max()) <= 1e-4 * float(
                ref.abs().max()) + 1e-30, name
    assert gap ** 0.5 <= 1e-4 * upd ** 0.5


# ---------------------------------------------------------------------------
# optimizer, schedules, tree helpers
# ---------------------------------------------------------------------------
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32),
            "s": [rng.normal(size=(2, 2, 2)).astype(np.float32)]}


@pytest.mark.parametrize("grad_clip,weight_decay",
                         [(0.0, 0.0), (1.0, 0.0), (0.0, 0.5), (0.5, 0.1)])
def test_adamw_update_matches_reference(grad_clip, weight_decay):
    """Three steps on the same numpy grads (the decay on the rank >= 2
    leaves, the clip on the global norm)."""
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = jax.tree.map(torch.from_numpy, _tree(0))
    jc, tc = (lib.AdamWConfig(lr=lib.warmup_cosine(0.1, 2, 5), b2=0.99,
                              grad_clip=grad_clip,
                              weight_decay=weight_decay)
              for lib in (jopt, topt))
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: 3.0 * a, _tree(10 + i))
        jp, js, jm = jopt.adamw_update(jc, jp, jax.tree.map(jnp.asarray, g),
                                       js)
        tp, ts, tm = topt.adamw_update(tc, tp, named_from_jax(g, tp), ts)
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
    for got, want in ((named_tensors(tp), named_from_jax(_np(jp), tp)),
                      (ts.m.items(), named_from_jax(_np(js.m), tp)),
                      (ts.v.items(), named_from_jax(_np(js.v), tp))):
        for name, t in got:
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-7)
    assert int(ts.step) == int(js.step) == 3


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 10, 100), (3e-4, 5, 30),
                                               (0.1, 0, 1)])
def test_schedules_match_reference(peak, warmup, total):
    js, ts = jopt.warmup_cosine(peak, warmup, total), \
        topt.warmup_cosine(peak, warmup, total)
    for step in range(0, total + 5):
        want = float(js(step))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-6 * abs(want) + 1e-12, step
    assert float(topt.constant_lr(peak)(3)) == float(jopt.constant_lr(peak)(3))


@pytest.mark.parametrize("scale", [0.05, 1.0, 40.0])
def test_clip_by_global_norm_matches_reference(scale):
    g = jax.tree.map(lambda a: scale * a, _tree(3))
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tp = jax.tree.map(torch.from_numpy, _tree(3))
    tg, tn = topt.clip_by_global_norm(named_from_jax(g, tp), 1.0)
    assert _rel(tn, jn) <= 1e-6
    want = named_from_jax(_np(jg), tp)
    for name, t in tg.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-6)


def test_tree_helpers_match_reference():
    jt, tt = jax.tree.map(jnp.asarray, _tree(4)), \
        jax.tree.map(torch.from_numpy, _tree(4))
    assert tutils.tree_size(tt) == jutils.tree_size(jt) == 23
    assert tutils.tree_bytes(tt) == jutils.tree_bytes(jt)
    assert tutils.tree_bytes(tutils.tree_cast(tt, torch.bfloat16)) == \
        jutils.tree_bytes(jutils.tree_cast(jt, jnp.bfloat16))
    assert _rel(tutils.tree_norm(tt), jutils.tree_norm(jt)) <= 1e-6
    assert _rel(tutils.tree_norm(tutils.tree_scale(
        tutils.tree_add(tt, tt), 0.5)), jutils.tree_norm(jt)) <= 1e-6
    assert float(tutils.tree_norm(tutils.tree_zeros_like(tt))) == 0.0
    assert tutils.Policy().compute_dtype == torch.bfloat16
    assert tutils.FULL_PRECISION.compute_dtype == torch.float32
    cast = tutils.DEFAULT_POLICY.cast_compute({"i": torch.arange(3),
                                              "f": torch.ones(2)})
    assert cast["i"].dtype == torch.int64 and cast["f"].dtype == torch.bfloat16
    for n in (0, 1023, 1024, 5e9):
        assert tutils.human_bytes(n) == jutils.human_bytes(n)
        assert tutils.human_count(n) == jutils.human_count(n)
    secs, out = tutils.timed(lambda x: x + 1, torch.ones(2), n=2)
    assert secs >= 0.0 and torch.equal(out, torch.full((2,), 2.0))


def test_product_f32_backward_is_the_widened_paths():
    """The card's fp32-output product (``_ProductF32``) differentiates as
    autograd does through the CPU's widened operands: its backward run on
    the CPU against autograd of ``a.float() @ b.float()``, 2-D and 3-D,
    bf16 and fp16."""
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.bfloat16, torch.float16):
        for shape_a, shape_b in (((5, 7), (7, 3)), ((2, 5, 7), (2, 7, 3))):
            a = torch.randn(shape_a, generator=gen).to(dtype)
            b = torch.randn(shape_b, generator=gen).to(dtype)
            g = torch.randn(shape_a[:-1] + shape_b[-1:], generator=gen)
            a.requires_grad_(True)
            b.requires_grad_(True)
            want = torch.autograd.grad(a.float() @ b.float(), (a, b), g)
            ctx = argparse.Namespace(saved_tensors=(a.detach(), b.detach()),
                                     needs_input_grad=(True, True))
            got = _ProductF32.backward(ctx, g)
            for x, y in zip(got, want):
                assert x.dtype == dtype
                assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the LM's decay rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b"])
def test_lm_decay_rule_is_the_references(arch):
    """``reference_rank`` gives every port leaf the rank of the
    reference's leaf it maps to; one step with zero grads and
    ``weight_decay`` 1.0 then moves every per-layer norm as the
    reference's [L, D] norms move, and leaves ``final_norm``."""
    jcfg, cfg = jget_smoke_config(arch), get_smoke_config(arch)
    jparams = jtf.init_lm(jax.random.PRNGKey(1), jcfg)
    model = _port_lm(jparams, cfg)
    ranks = topt.reference_rank(model)
    jranks = {"embed.weight": jparams["embed"].ndim,
              "final_norm": jparams["final_norm"].ndim,
              "out_head.weight": jparams["out_head"].ndim}
    for name in ranks:
        if name.startswith("layers."):
            leaf = name.split(".")[-2 if name.endswith(".weight") else -1]
            jranks[name] = jparams["layers"][leaf].ndim
    assert ranks == jranks
    decay = topt.decayed(model)
    assert not decay["final_norm"]
    assert all(decay[f"layers.{i}.{n}"] for i in range(cfg.n_layers)
               for n in ("attn_norm", "ffn_norm"))
    jc, tc = (lib.AdamWConfig(lr=0.1, weight_decay=1.0, grad_clip=0.0)
              for lib in (jopt, topt))
    jp, _, _ = jopt.adamw_update(jc, jparams, jax.tree.map(
        jnp.zeros_like, jparams), jopt.adamw_init(jparams))
    zeros = {n: torch.zeros_like(p) for n, p in named_tensors(model)}
    topt.adamw_update(tc, model, zeros, topt.adamw_init(model))
    want = named_from_jax(_np(jp), model)
    for name, p in named_tensors(model):
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    assert torch.equal(model.final_norm, torch.ones(cfg.d_model))
    assert torch.allclose(model.layers[0].attn_norm,
                          torch.full((cfg.d_model,), 0.9))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_build(arch):
    jcfg, jparams, _, _ = jlaunch.build(arch, "smoke", ARGS)
    return jcfg, jparams


def _builds(arch, **replace):
    """Both packages' ``launch.train.build`` at the smoke preset (the
    reference's built once an arch: its arrays are immutable), the port
    holding the reference's weights, and the batch stream (the numpy
    generators are the reference's bit for bit); ``replace`` edits both
    configs."""
    jcfg, jparams = _reference_build(arch)
    cfg, _, _, data = tlaunch.build(arch, "smoke", ARGS)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        cfg = dataclasses.replace(cfg, **replace)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, jparams, cfg, _port_lm(jparams, cfg), data


def _two_steps(arch, microbatches=1):
    jcfg, jparams, cfg, model, data = _builds(arch)
    jstep = jloop.make_train_step(
        lambda p, tokens, labels: jtf.lm_loss(p, jcfg, tokens, labels,
                                              dtype=jnp.float32),
        _opt(jopt), microbatches=microbatches, donate=False)
    tstep = tloop.make_train_step(
        lambda p, tokens, labels: ttf.lm_loss(p, tokens, labels,
                                              dtype=torch.float32),
        _opt(topt), microbatches=microbatches)
    js, ts = jopt.adamw_init(jparams), tloop.init_train_state(model)
    jp = jparams
    for _ in range(2):
        batch = next(data)
        jp0 = jp
        jp, js, jm = jstep(jp, js, batch)
        model, ts, tm = tstep(model, ts, batch)
        assert tm["loss"].dtype == torch.float32
        assert _rel(tm["loss"], jm["loss"]) <= 1e-5
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
    assert_state_close(model, ts, jp, js, jp0, PEAK_LR)


@pytest.mark.parametrize("arch", LMS)
def test_lm_train_steps_match_reference(arch):
    """Two ``make_train_step`` steps of each LM's smoke config, built by
    both packages' ``launch.train.build``, from the reference's weights:
    losses, grad norms, then the weights, m and v."""
    _two_steps(arch)


def test_microbatched_step_matches_reference():
    _two_steps("olmoe-1b-7b", microbatches=2)


def _loss_and_grads(jcfg, jparams, model, batch, dtype, impl="masked"):
    jloss, jgrads = jax.value_and_grad(lambda p: jtf.lm_loss(
        p, jcfg, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]),
        dtype=dtype, impl=impl))(jparams)
    tdtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    model.requires_grad_(True)
    loss = ttf.lm_loss(model, torch.from_numpy(batch["tokens"]),
                       torch.from_numpy(batch["labels"]), dtype=tdtype,
                       impl=impl)
    names, leaves = zip(*named_tensors(model))
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    return (float(jloss), named_from_jax(_np(jgrads), model),
            loss.detach(), grads)


def _assert_grads(grads, want, rtol=1e-5):
    for name, g in grads.items():
        w = want[name].float()
        scale = max(float(w.abs().max()), 1e-12)
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=rtol,
                                   atol=rtol * scale, err_msg=name)


@pytest.mark.parametrize("arch,replace", [
    ("llama3-8b", {"remat": False}),
    ("olmoe-1b-7b", {"remat": False}),
    ("llama3-8b", {"chunked_loss": 8}),
    ("h2o-danube-3-4b", {"chunked_loss": 16, "remat": False})])
def test_loss_variants_match_reference(arch, replace):
    """``cfg.remat`` off and ``cfg.chunked_loss``: the loss and every
    gradient against the reference's with the same config, and against
    the port's default (remat on, full logits)."""
    jcfg, jparams, cfg, model, data = _builds(arch, **replace)
    batch = next(data)
    jl, jg, loss, grads = _loss_and_grads(jcfg, jparams, model, batch,
                                          jnp.float32)
    assert _rel(loss, jl) <= 1e-5
    _assert_grads(grads, jg)
    plain = _port_lm(jparams, get_smoke_config(arch)).requires_grad_(True)
    l0 = ttf.lm_loss(plain, torch.from_numpy(batch["tokens"]),
                     torch.from_numpy(batch["labels"]))
    g0 = torch.autograd.grad(l0, [p for _, p in named_tensors(plain)])
    assert _rel(loss, l0.detach()) <= 1e-5
    _assert_grads(grads, {n: g for (n, _), g in zip(named_tensors(plain),
                                                    g0)})


@pytest.mark.parametrize("s,blk", [(32, 8), (48, 8), (32, 16), (24, 8)])
def test_packed_attention_matches_reference(s, blk):
    """``blocked_attention(impl="packed")`` against the reference's packed
    form and both packages' masked forms; an odd block count (48 / 8 = 6
    is even, 24 / 8 = 3 is not) falls back to masked in both."""
    rng = np.random.default_rng(s + blk)
    q, k, v = (rng.normal(size=(2, s, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tattn.blocked_attention(tq, tk, tv, block_q=blk, block_k=blk,
                                  impl="packed")
    for impl in ("packed", "masked"):
        want = jattn.blocked_attention(jq, jk, jv, block_q=blk, block_k=blk,
                                       impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    masked = tattn.blocked_attention(tq, tk, tv, block_q=blk, block_k=blk)
    np.testing.assert_allclose(got.numpy(), masked.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_packed_lm_loss_matches_reference():
    jcfg, jparams, cfg, model, data = _builds("llama3-8b")
    batch = next(data)
    jl, jg, loss, grads = _loss_and_grads(jcfg, jparams, model, batch,
                                          jnp.float32, impl="packed")
    assert _rel(loss, jl) <= 1e-5
    _assert_grads(grads, jg)


@pytest.mark.parametrize("arch", ["llama3-8b", "h2o-danube-3-4b"])
def test_bf16_loss_matches_reference(arch):
    """``lm_loss(dtype=torch.bfloat16)`` from fp32 weights (every weight
    cast once at entry, norms included) against the reference at
    ``jnp.bfloat16``: the loss and each gradient leaf (fp32, the casts'
    backward) within 3e-2 x max|value|."""
    jcfg, jparams, cfg, model, data = _builds(arch)
    batch = next(data)
    jl, jg, loss, grads = _loss_and_grads(jcfg, jparams, model, batch,
                                          jnp.bfloat16)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - jl) <= 3e-2 * abs(jl)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        w = jg[name].float()
        assert float((g - w).abs().max()) <= 3e-2 * float(w.abs().max()), \
            name


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_routing_in_a_train_step_is_the_references(arch, monkeypatch):
    """The routing of a train step's forward is integer output: each
    layer's top-k ids (the reference's ``lax.top_k`` ids, recorded from
    its unrolled forward), each assignment's position within its expert
    and the keep mask equal the reference's exactly."""
    from repro_torch.models import moe as tmoe

    jcfg, jparams, cfg, model, data = _builds(arch)
    batch = next(data)
    top_k, seen = jax.lax.top_k, []

    def run(p, tokens):
        def recording(a, k):
            seen.append(top_k(a, k))
            return seen[-1]
        monkeypatch.setattr(jax.lax, "top_k", recording)
        jtf.forward_hidden(p, dataclasses.replace(
            jcfg, scan_layers=False, remat=False), tokens, dtype=jnp.float32)
        monkeypatch.undo()
        return [ids for _, ids in seen]

    want = [np.asarray(i)[0] for i in jax.jit(run)(
        jparams, jnp.asarray(batch["tokens"]))]
    route, got = tmoe.route, []

    def recording(p, mcfg, x):
        got.append(route(p, mcfg, x))
        return got[-1]

    monkeypatch.setattr(tmoe, "route", recording)
    step = tloop.make_train_step(
        lambda p, tokens, labels: ttf.lm_loss(p, tokens, labels), _opt(topt))
    step(model, tloop.init_train_state(model), batch)
    assert len(want) == cfg.n_layers and len(got) >= cfg.n_layers
    C = tmoe.capacity(batch["tokens"].size, cfg.moe)
    for ids_j, (_, _, ids, pos, keep) in zip(want, got):
        np.testing.assert_array_equal(ids.numpy(), ids_j)
        seen_e = np.zeros(cfg.moe.n_slots, np.int64)
        pos_j = np.empty(ids_j.size, np.int64)
        for a, e in enumerate(ids_j.reshape(-1)):
            pos_j[a], seen_e[e] = seen_e[e], seen_e[e] + 1
        np.testing.assert_array_equal(pos.numpy(), pos_j)
        np.testing.assert_array_equal(keep.numpy(), pos_j < C)


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------
def test_fit_losses_match_reference():
    jcfg, jparams, cfg, model, _ = _builds("granite-moe-3b-a800m")
    jstep = jloop.make_train_step(
        lambda p, tokens, labels: jtf.lm_loss(p, jcfg, tokens, labels,
                                              dtype=jnp.float32),
        _opt(jopt), donate=False)
    tstep = tloop.make_train_step(
        lambda p, tokens, labels: ttf.lm_loss(p, tokens, labels),
        _opt(topt))

    def data():
        return synthetic.lm_batches(cfg.vocab, 4, 17, seed=3)

    _, _, jh = jloop.fit(jparams, jstep, data(), steps=4, log_every=0)
    _, ts, th = tloop.fit(model, tstep, data(), steps=4, log_every=2)
    assert [h["step"] for h in th] == [0, 1, 2, 3]
    for got, want in zip(th, jh):
        assert _rel(got["loss"], want["loss"]) <= 1e-5
    assert int(ts.step) == 4


def test_fit_with_a_checkpoint_manager_raises(tmp_path, monkeypatch):
    """A checkpoint that cannot be written stops ``fit`` with the
    writer's error (a full disk) at that step's save; nothing is
    published."""
    from repro_torch.train import checkpoint as tckpt

    _, _, _, model, data = _builds("llama3-8b")
    step = tloop.make_train_step(
        lambda p, tokens, labels: ttf.lm_loss(p, tokens, labels), _opt(topt))

    def full_disk(*a, **kw):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(tckpt.np, "savez", full_disk)
    ckpt = tckpt.CheckpointManager(str(tmp_path))
    with pytest.raises(OSError, match="No space"):
        tloop.fit(model, step, data, steps=3, ckpt=ckpt, ckpt_every=2,
                  log_every=0)
    assert ckpt.all_steps() == []


def test_fit_with_a_checkpoint_manager_saves_the_references_steps(
        tmp_path):
    """``fit(ckpt=)`` saves after step i where (i + 1) % ckpt_every == 0,
    as the reference's: 5 steps, a checkpoint every 2, keep 2 -> the
    same steps on disk and the same ``__meta__`` bytes; the port's state
    at step 4 (restored into a fresh LM) against the reference's file at
    the module docstring's tolerances."""
    from repro.train import checkpoint as jckpt
    from repro_torch.convert import tree_from_checkpoint
    from repro_torch.train import checkpoint as tckpt

    jcfg, jparams, cfg, model, _ = _builds("llama3-8b")
    jstep = jloop.make_train_step(
        lambda p, tokens, labels: jtf.lm_loss(p, jcfg, tokens, labels,
                                              dtype=jnp.float32),
        _opt(jopt), donate=False)
    tstep = tloop.make_train_step(
        lambda p, tokens, labels: ttf.lm_loss(p, tokens, labels), _opt(topt))

    def data():
        return synthetic.lm_batches(cfg.vocab, 4, 17, seed=5)

    jck = jckpt.CheckpointManager(str(tmp_path / "ref"), keep=2)
    tck = tckpt.CheckpointManager(str(tmp_path / "port"), keep=2,
                                  async_save=True)
    jloop.fit(jparams, jstep, data(), steps=5, ckpt=jck, ckpt_every=2,
              log_every=0)
    tloop.fit(model, tstep, data(), steps=5, ckpt=tck, ckpt_every=2,
              log_every=0)
    tck.wait()
    assert tck.all_steps() == jck.all_steps() == [2, 4]
    for s in (2, 4):
        with np.load(tck._path(s)) as a, np.load(jck._path(s)) as b:
            assert a["__meta__"].tobytes() == b["__meta__"].tobytes()
    fresh = ttf.LM(cfg, device="cpu").requires_grad_(False)
    got, _ = tck.restore({"params": fresh, "opt": topt.adamw_init(fresh)},
                         step=4)
    with np.load(jck._path(4)) as z:
        ref = tree_from_checkpoint(z)
    opt = ref["opt"]
    assert_state_close(got["params"], got["opt"], ref["params"],
                       jopt.OptState(opt["m"], opt["v"], opt["step"]),
                       jparams, PEAK_LR)
