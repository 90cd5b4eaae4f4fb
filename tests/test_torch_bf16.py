"""Port parity at a 16-bit compute dtype (CPU): the LMs of ``launch.serve
--arch`` served in bf16 — weights cast where used, activations and the KV
cache in bf16, fp32 sums — against ``repro`` at ``dtype=jnp.bfloat16``,
on the same numpy-seeded inputs, the weights carried across by
``convert.lm_params_from_jax``.

Tolerances, and why:

* ``flash_decode``'s plain version on bf16 and fp16 q/K/V: within 1e-5 of
  the reference's (both widen exactly, then sum in fp32 in another order).
* Modules run op by op (attention, the MoE layer, a decoder layer): equal
  bit for bit, or within 1e-5 on fp32 outputs.
* Whole models: logits within 3e-2 x max|reference logit| over a prefill
  and 8 decode ticks; layer 0's cached K/V equal on >= 99 % of elements
  and within one bf16 ulp elsewhere (int8 under ``kv_quant``: one step).
  The reference runs its layers as one compiled ``lax.scan``, and XLA
  drops some of the bf16 roundings between fused ops that the port (and
  the reference run op by op) makes, so the later layers' bf16 values
  move by an ulp here and there; layer 0 sees the same inputs. Measured
  at these seeds (prefill + 8 ticks): logits within 0.0035 x max|logit|
  (llama3-8b, h2o-danube-3-4b; minitron-8b 0.0032, llama3-8b kv_quant
  0.0034, olmoe-1b-7b 0.0027, granite-moe-3b-a800m 0.0016); layer 0's
  K/V 100 % equal in every case.
* Greedy tokens equal up to the first position where the reference's
  top-2 logit margin is under the logit tolerance.

The reference's MoE einsums multiply bf16 by bf16 into fp32 over a batch
axis, which XLA's CPU runtime does not implement
("DotThunk: BF16 x BF16 = F32"). For the MoE configs ``repro.models.moe``
is run with an einsum that widens its 16-bit operands to fp32 first: the
same products (exact in fp32) summed in fp32, which is what
``preferred_element_type=float32`` asks for. No reference file changes.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.kernels import ops as jops
from repro.models import attention as jatt
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tatt
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import ServeEngine

BF16 = (torch.bfloat16, jnp.bfloat16)
LOGIT_TOL = 3e-2          # x max|reference logit|
ARCHS = ["llama3-8b", "h2o-danube-3-4b", "olmoe-1b-7b",
         "granite-moe-3b-a800m", "minitron-8b"]


def _wide_einsum(spec, *ops, preferred_element_type=None, **kw):
    if preferred_element_type == jnp.float32:
        ops = [o.astype(jnp.float32)
               if o.dtype in (jnp.bfloat16, jnp.float16) else o for o in ops]
    return jnp.einsum(spec, *ops, preferred_element_type=preferred_element_type,
                      **kw)


@pytest.fixture(autouse=True)
def _moe_on_xla_cpu(monkeypatch):
    """``repro.models.moe`` with the widening einsum (module docstring)."""
    shim = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                    if not n.startswith("__")})
    shim.einsum = _wide_einsum
    monkeypatch.setattr(jmoe, "jnp", shim)


def _np(x) -> np.ndarray:
    """A JAX or torch array as fp32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype != np.int8 else a


def _ulp(x: np.ndarray) -> np.ndarray:
    """bf16's unit in the last place at each |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_cache_layer(got, want, what):
    """Equal on >= 99 % of elements, within a bf16 ulp (int8: a step)
    elsewhere; returns the equal share."""
    got, want = _np(got), _np(want)
    same = float((got == want).mean())
    diff = np.abs(got - want)
    if want.dtype == np.int8:
        assert diff.max() <= 1, f"{what}: int8 steps {diff.max()}"
    else:
        ulp = _ulp(np.maximum(np.abs(got), np.abs(want)))
        assert (diff <= ulp).all(), f"{what}: past one bf16 ulp"
    assert same >= 0.99, f"{what}: {same:.4f} equal"
    return same


def _cfgs(arch: str, kv_quant: bool = False):
    jcfg = dataclasses.replace(jget_smoke_config(arch), kv_quant=kv_quant)
    cfg = dataclasses.replace(get_smoke_config(arch), kv_quant=kv_quant)
    if arch == "olmoe-1b-7b":        # no drops: routing is all that differs
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=16.0))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _lm(arch: str, kv_quant: bool = False, weights=torch.float32):
    """(reference cfg, fp32 reference params, port cfg, port model with the
    same weights, held in ``weights``)."""
    jcfg, cfg = _cfgs(arch, kv_quant)
    params = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    model = ttf.LM(cfg, device="cpu", dtype=weights)
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.array, params), dtype=weights))
    return jcfg, params, cfg, model.requires_grad_(False)


# ---------------------------------------------------------------------------
# flash_decode's plain version and the attention module
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
@pytest.mark.parametrize("b,h,kvh,dh,s,cur", [
    (4, 8, 2, 64, 40, [1, 13, 40, 29]), (3, 6, 2, 120, 33, 20),
    (2, 4, 4, 128, 17, [17, 0])])
def test_flash_decode_plain_16bit_matches_reference(dtype, b, h, kvh, dh, s,
                                                    cur):
    """The port's plain ``flash_decode`` (the CPU branch of
    ``ops.flash_decode``) on bf16 / fp16 q, K, V against the reference's
    ``ops.flash_decode``: fp32 out, within 1e-5."""
    tdt, jdt = {"bf16": BF16, "fp16": (torch.float16, jnp.float16)}[dtype]
    rng = np.random.default_rng(b * 100 + dh)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in (
        (b, h, dh), (b, s, kvh, dh), (b, s, kvh, dh)))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    got = tops.flash_decode(tq, tk, tv, torch.as_tensor(cur, dtype=torch.int32))
    want = jops.flash_decode(jq, jk, jv, jnp.asarray(cur, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_attention_at_bf16_matches_reference():
    """``blocked_attention`` (causal prefill), ``swa_blocked_attention``,
    ``decode_attention`` and ``reference_attention`` on bf16 q/K/V: fp32
    scores and values, the output cast to bf16, equal to the reference's
    bit for bit (within a bf16 ulp where fp32 sums round apart)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 48, n, 16)).astype(np.float32)
               for n in (4, 2, 2))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    cur = np.array([48, 17], np.int32)
    pairs = [
        (tatt.blocked_attention(tq, tk, tv, causal=True, block_q=16,
                                block_k=16),
         jatt.blocked_attention(jq, jk, jv, causal=True, block_q=16,
                                block_k=16)),
        (tatt.swa_blocked_attention(tq, tk, tv, window=20, block_q=16,
                                    block_k=16),
         jatt.swa_blocked_attention(jq, jk, jv, window=20, block_q=16,
                                    block_k=16)),
        (tatt.decode_attention(tq[:, :1], tk, tv, torch.from_numpy(cur)),
         jatt.decode_attention(jq[:, :1], jk, jv, jnp.asarray(cur))),
        (tatt.reference_attention(tq, tk, tv, causal=True, window=20),
         jatt.reference_attention(jq, jk, jv, causal=True, window=20))]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        _assert_cache_layer(got, want, "attention")


def test_products_at_bf16_sum_in_fp32():
    """``linear_f32`` and ``bmm_f32`` on bf16 operands: fp32 results, the
    exact products summed in fp32 (as the fp32 product of the widened
    operands)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 3, 24, generator=g).to(torch.bfloat16)
    w = torch.randn(7, 24, generator=g).to(torch.bfloat16)
    a = torch.randn(4, 6, 24, generator=g).to(torch.bfloat16)
    bm = torch.randn(4, 24, 9, generator=g).to(torch.bfloat16)
    got = tcommon.linear_f32(x, w)
    assert got.dtype == torch.float32 and got.shape == (5, 3, 7)
    torch.testing.assert_close(got, x.float() @ w.float().T, rtol=0,
                               atol=1e-6)
    got = tcommon.bmm_f32(a, bm)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.float() @ bm.float(), rtol=0,
                               atol=1e-6)
    assert tcommon.weight(w, torch.bfloat16) is w


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_layer_at_bf16_matches_reference(arch):
    """Layer 0's MoE on bf16 tokens: the router in fp32, bf16 gathered
    rows, fp32 expert products and combine, a bf16 output equal to the
    reference's (within a bf16 ulp where the combine's fp32 sum rounds
    apart: the reference scatter-adds, the port sums over k)."""
    jcfg, params, cfg, model = _lm(arch)
    x = np.random.default_rng(8).normal(size=(24, cfg.d_model)).astype(
        np.float32)
    lp = jax.tree.map(lambda p: p[0], params["layers"])
    want, jaux = jmoe.moe_ffn({n: lp[n] for n in ("router", "we1", "we2",
                                                   "we3")}, jcfg.moe,
                              jnp.asarray(x).astype(jnp.bfloat16))
    got, aux = tmoe.moe_ffn(model.layers[0].moe, cfg.moe,
                            torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _assert_cache_layer(got, want, f"{arch} MoE")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# whole models: prefill and decode at bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kv_quant", [(a, False) for a in ARCHS]
                         + [("llama3-8b", True)])
def test_prefill_and_decode_at_bf16_match_reference(arch, kv_quant):
    """fp32 weights computed at bf16 in both packages: ragged prompts (40
    tokens, past danube's 32-token window: the ring rolls), then 8
    greedy decode ticks fed the reference's tokens, through the flash and
    the dense path. Logits within 3e-2 x max|logit|; layer 0's cached K/V
    as the module docstring says; the cache in bf16 (int8 + fp32 scales
    under ``kv_quant``)."""
    jcfg, params, cfg, model = _lm(arch, kv_quant)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab, size=(2, 40)).astype(np.int32)
    lens = np.array([40, 29], np.int32)
    jl, jc = jtf.prefill(params, jcfg, jnp.asarray(toks), dtype=jnp.bfloat16,
                         max_len=48, prompt_lens=jnp.asarray(lens))
    tl, tc = ttf.prefill(model, torch.as_tensor(toks), max_len=48,
                         prompt_lens=torch.as_tensor(lens),
                         dtype=torch.bfloat16)
    assert tl.dtype == torch.float32
    assert tc.k.dtype == (torch.int8 if kv_quant else torch.bfloat16)
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        _assert_cache_layer(got[0], want[0], f"{arch} layer 0 cache")
    scale = np.abs(np.asarray(jl)).max()
    gap = np.abs(tl.numpy() - np.asarray(jl)).max()
    jdecode = jax.jit(lambda p, t, c: jtf.decode_step(
        p, jcfg, t, c, dtype=jnp.bfloat16))
    caches = {"flash": tc, "dense": ttf.KVCache(*(
        None if t is None else t.clone()
        for t in (tc.k, tc.v, tc.cur_len, tc.k_scale, tc.v_scale)))}
    nxt = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)[:, None]
    for _ in range(8):
        jl, jc = jdecode(params, jnp.asarray(nxt), jc)
        scale = max(scale, np.abs(np.asarray(jl)).max())
        for impl in ("flash", "dense"):
            tl, caches[impl] = ttf.decode_step(
                model, torch.as_tensor(nxt), caches[impl], attn_impl=impl,
                dtype=torch.bfloat16)
            gap = max(gap, np.abs(tl.numpy() - np.asarray(jl)).max())
        nxt = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)[:, None]
    assert gap <= LOGIT_TOL * scale, (gap, scale)
    np.testing.assert_array_equal(caches["flash"].cur_len.numpy(),
                                  np.asarray(jc.cur_len))


@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b"])
def test_fp32_weights_at_bf16_equal_bf16_weights(arch):
    """The port with fp32 weights at ``dtype=bf16`` (each weight cast where
    it is used) equals the port with the same weights stored in bf16 (the
    cast a no-op) bit for bit, prefill and decode; ``dtype=None`` is the
    weights' own dtype. The MoE router runs on its weights in fp32, never
    cast to the compute dtype (the reference's): a router stored in bf16
    routes on rounded weights, so there the fp32 model holds the bf16
    weights' values."""
    _, _, cfg, m32 = _lm(arch)
    _, _, _, m16 = _lm(arch, weights=torch.bfloat16)
    if cfg.moe is not None:
        m32 = ttf.LM(cfg, device="cpu").requires_grad_(False)
        m32.load_state_dict({n: w.float() for n, w in
                             m16.state_dict().items()})
    assert m16.embed.weight.dtype == m16.dtype == torch.bfloat16
    toks = torch.as_tensor(np.random.default_rng(10).integers(
        0, cfg.vocab, size=(2, 20)).astype(np.int32))
    a, ca = ttf.prefill(m32, toks, max_len=32, dtype=torch.bfloat16)
    b, cb = ttf.prefill(m16, toks, max_len=32)
    assert torch.equal(a, b) and torch.equal(ca.k, cb.k)
    nxt = a[:, 0].argmax(-1, keepdim=True)
    a, ca = ttf.decode_step(m32, nxt, ca, dtype=torch.bfloat16)
    b, cb = ttf.decode_step(m16, nxt, cb)
    assert torch.equal(a, b) and torch.equal(ca.v, cb.v)


def test_lm_params_from_jax_takes_the_bf16_tree():
    """The reference's ``init_lm(dtype=jnp.bfloat16)`` tree (numpy arrays
    of ``ml_dtypes.bfloat16``) converts bit for bit into bf16 tensors, an
    LM in bf16 loads it, and ``dtype=`` casts."""
    jcfg, cfg = _cfgs("olmoe-1b-7b")
    params = jtf.init_lm(jax.random.PRNGKey(1), jcfg, dtype=jnp.bfloat16)
    tree = jax.tree.map(np.array, params)
    sd = lm_params_from_jax(tree)
    bits = lambda a: np.ascontiguousarray(a).view(np.uint16)  # noqa: E731
    assert sd["embed.weight"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["embed.weight"].view(torch.int16)
                                  .numpy().view(np.uint16),
                                  bits(tree["embed"]))
    np.testing.assert_array_equal(
        sd["layers.1.wq.weight"].view(torch.int16).numpy().view(np.uint16),
        bits(tree["layers"]["wq"][1].T))
    np.testing.assert_array_equal(
        sd["layers.0.moe.we2"].view(torch.int16).numpy().view(np.uint16),
        bits(tree["layers"]["we2"][0]))
    model = ttf.LM(cfg, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(sd)
    cast = lm_params_from_jax(tree, dtype=torch.float32)
    assert cast["out_head.weight"].dtype == torch.float32
    assert torch.equal(cast["out_head.weight"],
                       sd["out_head.weight"].float())


# ---------------------------------------------------------------------------
# the serving engine at bf16
# ---------------------------------------------------------------------------
def _record(engine):
    """Wrap ``engine._sample`` to keep each (rid, position)'s logits."""
    seen, sample = {}, engine._sample

    def rec(row, rid, t):
        seen[(rid, t)] = np.asarray(row, np.float32)
        return sample(row, rid, t)

    engine._sample = rec
    return seen


@pytest.mark.parametrize("arch", ["llama3-8b", "h2o-danube-3-4b"])
def test_serve_engine_at_bf16_greedy_matches_reference(arch):
    """``ServeEngine(dtype=torch.bfloat16)`` over fp32 weights (prefill
    and every decode tick at bf16, a bf16 cache) against the reference's
    ``ServeEngine(dtype=jnp.bfloat16)``: greedy tokens equal up to each
    request's first position where the reference's top-2 margin is under
    the logit tolerance, at least 8 positions compared."""
    jcfg, params, cfg, model = _lm(arch)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (7, 19, 36, 12, 25, 3, 44, 16)]
    jeng = JServeEngine(params, jcfg, slots=2, max_len=64,
                        dtype=jnp.bfloat16)
    teng = ServeEngine(model, cfg, slots=2, max_len=64,
                       dtype=torch.bfloat16, device="cpu")
    assert teng.cache.k.dtype == torch.bfloat16
    jseen, tseen = _record(jeng), _record(teng)
    want = jeng.generate(prompts, max_new_tokens=10)
    got = teng.generate(prompts, max_new_tokens=10)
    compared = 0
    for rid, (g, w) in enumerate(zip(got, want)):
        for t, (gt, wt) in enumerate(zip(g, w)):
            row = jseen[(rid, t)]
            top2 = np.sort(row)[-2:]
            np.testing.assert_allclose(tseen[(rid, t)], row, rtol=0,
                                       atol=LOGIT_TOL * np.abs(row).max())
            if top2[1] - top2[0] < LOGIT_TOL * np.abs(row).max():
                break
            assert gt == wt, (rid, t)
            compared += 1
    assert compared >= 8, compared
