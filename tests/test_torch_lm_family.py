"""Port parity for the LMs of ``launch.serve --arch`` past the dense llama
(CPU): sliding-window attention with its ring cache (h2o-danube-3-4b),
MoE (olmoe-1b-7b, granite-moe-3b-a800m), minitron-8b and the int8 KV
cache, each against ``repro`` at its smoke config with the weights
carried across by ``convert.lm_params_from_jax``.

Tolerances: logits and fp32 caches within 1e-4 (fp32 products summed in
another order); greedy tokens, retrieved keys and ``cur_len`` equal. The
int8 cache is integer output: the port's payload and scales equal the
reference's quantizer applied to the same fp32 K/V, exactly; against the
reference's own cache (whose K/V differ in the last bits) the payload may
move by one step where a value sits on a rounding edge.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.data import corpus as jcorpus
from repro.models import transformer as jtf
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.rag import RAGPipeline as JRAGPipeline
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import corpus as tcorpus
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.rag import RAGPipeline

NEW_LMS = ["h2o-danube-3-4b", "minitron-8b", "olmoe-1b-7b",
           "granite-moe-3b-a800m"]
QUERIES = ["how does hnsw search work",
           "why is on device retrieval private",
           "what does the document store hold",
           "how are vectors compared"]


@functools.lru_cache(maxsize=None)
def _lm(arch: str, kv_quant: bool = False):
    """(reference cfg, reference params, port cfg, port model) with the
    same weights; the reference's prefill and decode_step jitted."""
    jcfg = dataclasses.replace(jget_smoke_config(arch), kv_quant=kv_quant)
    params = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(get_smoke_config(arch), kv_quant=kv_quant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = ttf.LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.array, params)))
    model.requires_grad_(False)
    return jcfg, params, cfg, model


@functools.lru_cache(maxsize=None)
def _jitted(arch: str, kv_quant: bool, max_len: int):
    jcfg, _, _, _ = _lm(arch, kv_quant)
    prefill = jax.jit(lambda p, t, lens: jtf.prefill(
        p, jcfg, t, dtype=jnp.float32, max_len=max_len, prompt_lens=lens))
    decode = jax.jit(lambda p, t, c: jtf.decode_step(
        p, jcfg, t, c, dtype=jnp.float32))
    return prefill, decode


def _copy(c: ttf.KVCache) -> ttf.KVCache:
    return ttf.KVCache(*(None if t is None else t.clone() for t in (
        c.k, c.v, c.cur_len, c.k_scale, c.v_scale)))


def _rollout(arch, toks, lens, max_len, steps, kv_quant=False):
    """Prefill ``toks`` (right-padded to ``lens``) in both packages, then
    ``steps`` decode ticks fed the reference's greedy tokens, the port
    through both attention paths. Returns the port's and the reference's
    caches after prefill and the largest logit gap."""
    jcfg, params, cfg, model = _lm(arch, kv_quant)
    jprefill, jdecode = _jitted(arch, kv_quant, max_len)
    jl, jc = jprefill(params, jnp.asarray(toks), jnp.asarray(lens))
    tl, tc = ttf.prefill(model, torch.as_tensor(toks), max_len=max_len,
                         prompt_lens=torch.as_tensor(lens))
    first = (tc, jc)
    gap = np.abs(tl.numpy() - np.asarray(jl)).max()
    caches = {impl: _copy(tc) for impl in ("flash", "dense")}
    nxt = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)[:, None]
    for _ in range(steps):
        jl, jc = jdecode(params, jnp.asarray(nxt), jc)
        for impl in ("flash", "dense"):
            tl, caches[impl] = ttf.decode_step(
                model, torch.as_tensor(nxt), caches[impl], attn_impl=impl)
            gap = max(gap, np.abs(tl.numpy() - np.asarray(jl)).max())
        np.testing.assert_array_equal(caches["flash"].cur_len.numpy(),
                                      np.asarray(jc.cur_len))
        nxt = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)[:, None]
    return first, (caches["flash"], jc), gap


@pytest.mark.parametrize("arch", NEW_LMS)
def test_prefill_and_decode_match_reference(arch):
    """Ragged prompts, then 3 decode ticks through the flash and the dense
    path."""
    cfg = get_smoke_config(arch)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(3, 12)).astype(np.int32)
    (tc, jc), (tc2, jc2), gap = _rollout(arch, toks, np.array(
        [12, 5, 9], np.int32), max_len=32, steps=3)
    assert gap <= 1e-4, gap
    for got, want in ((tc, jc), (tc2, jc2)):
        np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v),
                                   rtol=0, atol=1e-4)


def test_swa_ring_wraps_as_reference():
    """A 40-token prompt past the 32-token window: prefill keeps the last
    32 positions rolled into the ring (slot p % 32), and 8 decode ticks
    (to 48, as the reference's own ring test) overwrite the oldest."""
    arch = "h2o-danube-3-4b"
    cfg = get_smoke_config(arch)
    assert ttf.cache_len(cfg, 48) == cfg.sliding_window == 32
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 40)).astype(np.int32)
    (tc, jc), (tc2, jc2), gap = _rollout(arch, toks, np.array(
        [40, 40], np.int32), max_len=48, steps=8)
    assert tc.k.shape[2] == 32
    assert gap <= 1e-4, gap
    for got, want in ((tc, jc), (tc2, jc2)):
        np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k),
                                   rtol=0, atol=1e-4)
    assert np.asarray(jc2.cur_len).tolist() == [48, 48]


def test_quantize_kv_is_the_reference_quantizer():
    """The same fp32 rows -> the same int8 payload and scales, bit for
    bit, with halves rounded to even on both sides."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 2, 16)).astype(np.float32)
    x[0, 0, 0] = np.arange(16) - 7.5        # scale 1/127 * 8.5: ties
    x[0, 0, 1] = 127 * (np.arange(16) % 4 - 1.5) / 1.5
    got_q, got_s = ttf._quantize_kv(torch.from_numpy(x))
    want_q, want_s = jtf._quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(
        ttf._dequantize_kv(got_q, got_s, torch.float32).numpy(),
        np.asarray(jtf._dequantize_kv(want_q, want_s, jnp.float32)))


@pytest.mark.parametrize("arch", ["llama3-8b"] + NEW_LMS)
def test_kv_quant_cache_and_decode_match_reference(arch):
    """Under ``kv_quant`` the cache is the reference's quantizer applied
    to the port's own fp32 K/V (exactly), within one step of the
    reference's cache, and decode logits stay within 1e-4 of the
    reference's int8-cache decode (danube: a prompt past the window)."""
    cfg = get_smoke_config(arch)
    S, max_len = (40, 48) if cfg.sliding_window else (12, 32)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, S)).astype(np.int32)
    lens = np.array([S, S - 5], np.int32)
    (tc, jc), _, gap = _rollout(arch, toks, lens, max_len=max_len, steps=3,
                                kv_quant=True)
    assert gap <= 1e-4, gap
    assert tc.k.dtype == torch.int8 and tc.k_scale.dtype == torch.float32
    assert tuple(tc.k_scale.shape) == tuple(tc.k.shape[:-1])
    # the same model's fp32 cache through the reference's quantizer
    _, _, _, model = _lm(arch, kv_quant=True)
    fp32 = ttf.LM(dataclasses.replace(cfg, kv_quant=False), device="cpu")
    fp32.load_state_dict(model.state_dict())
    _, c32 = ttf.prefill(fp32, torch.as_tensor(toks), max_len=max_len,
                         prompt_lens=torch.as_tensor(lens))
    for pay, scale, x in ((tc.k, tc.k_scale, c32.k),
                          (tc.v, tc.v_scale, c32.v)):
        want_q, want_s = jtf._quantize_kv(jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(pay.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(want_s))
    # against the reference's own int8 cache
    step = np.abs(tc.k.numpy().astype(np.int32)
                  - np.asarray(jc.k).astype(np.int32))
    assert step.max() <= 1 and step.mean() < 1e-3
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale),
                               rtol=1e-5, atol=0)


def _serve_rag(eng, k=2, max_new=5):
    reqs = [eng.submit_rag(q, k=k, max_new_tokens=max_new) for q in QUERIES]
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [([d.key for d in r.docs], r.out_tokens, r.prompt) for r in reqs]


@pytest.mark.parametrize("arch,kv_quant", [("olmoe-1b-7b", False),
                                           ("h2o-danube-3-4b", False),
                                           ("h2o-danube-3-4b", True)])
def test_rag_engine_greedy_matches_reference(arch, kv_quant):
    """``ServeEngine`` greedy tokens equal the reference engine's: an MoE
    config, and the SWA ring (RAG prompts past the 32-token window) with
    and without the int8 cache (the ``decode_32k`` preset)."""
    jcfg, params, cfg, model = _lm(arch, kv_quant)
    jrag = JRAGPipeline(index_kind="flat")
    jrag.add_documents(jcorpus.BUILTIN_CORPUS)
    jeng = JServeEngine(params, jcfg, pipeline=jrag, slots=2, max_len=64,
                        dtype=jnp.float32)
    trag = RAGPipeline(index_kind="flat", device="cpu")
    trag.add_documents(tcorpus.BUILTIN_CORPUS)
    teng = ServeEngine(model, cfg, pipeline=trag, slots=2, max_len=64,
                       device="cpu")
    want, got = _serve_rag(jeng), _serve_rag(teng)
    assert got == want
    assert teng.cache.k.shape[2] == ttf.cache_len(cfg, 64)
    if cfg.sliding_window:       # some prompt rolled in the ring
        assert max(int((tcorpus.encode_ids(r[2], cfg.vocab, 63) > 0).sum())
                   for r in got) > cfg.sliding_window
    assert (teng.cache.k_scale is not None) == kv_quant


@pytest.mark.parametrize("arch", ["llama3-8b"] + NEW_LMS)
def test_launch_serve_main_serves_each_lm_on_cpu(arch):
    out = tserve.main(["--arch", arch, "--rag", "--index", "flat",
                       "--device", "cpu", "--requests", "3", "--max-new",
                       "3", "--max-len", "129", "--slots", "2"])
    assert len(out["reqs"]) == 3 and all(r.done for r in out["reqs"])
    assert all(len(r.docs) == 3 for r in out["reqs"])
    assert out["tokens"] == 3 * 2       # the first token comes from prefill
    cfg = get_smoke_config(arch)
    assert out["engine"].model.cfg == cfg
    assert out["engine"].cache.k.shape[2] == ttf.cache_len(cfg, 129)


@pytest.mark.parametrize("d_model,n_heads,n_kv_heads", [
    (1920, 16, 4), (3840, 32, 8)])          # half and all of danube's width
def test_kv_quant_error_is_the_reference_error(d_model, n_heads, n_kv_heads):
    """The int8 cache's logit gap to the fp32 cache grows with d_model in
    the reference's scheme (at danube's full width it leaves the bound of
    the reference's smoke test). At d_model 1,920 and at danube's 3,840,
    Dh 120 (2 layers, d_ff 512, vocab 1,024: ~0.4 GB of fp32 weights at
    3,840), 16 teacher-forced ticks: the port's gap is the reference's
    within 5 %, and its int8 decode stays within a tenth of that gap of
    the reference's."""
    from repro.configs.base import LMConfig as JLMConfig
    from repro_torch.configs.base import LMConfig
    kw = dict(name="wide", n_layers=2, d_model=d_model, n_heads=n_heads,
              n_kv_heads=n_kv_heads, d_ff=512, vocab=1024,
              rope_theta=10000.0)
    params = jtf.init_lm(jax.random.PRNGKey(0), JLMConfig(**kw))
    toks = np.random.default_rng(5).integers(
        0, kw["vocab"], size=(2, 80)).astype(np.int32)
    logits = {}
    for q in (False, True):
        jcfg, cfg = JLMConfig(**kw, kv_quant=q), LMConfig(**kw, kv_quant=q)
        model = ttf.LM(cfg, device="cpu").requires_grad_(False)
        model.load_state_dict(lm_params_from_jax(
            jax.tree.map(np.array, params)))
        jdecode = jax.jit(lambda p, t, c: jtf.decode_step(
            p, jcfg, t, c, dtype=jnp.float32))
        _, jc = jtf.prefill(params, jcfg, jnp.asarray(toks[:, :64]),
                            dtype=jnp.float32, max_len=80)
        _, tc = ttf.prefill(model, torch.as_tensor(toks[:, :64]), max_len=80)
        got, want = [], []
        for t in range(64, 80):
            jl, jc = jdecode(params, jnp.asarray(toks[:, t:t + 1]), jc)
            tl, tc = ttf.decode_step(model, torch.as_tensor(toks[:, t:t + 1]),
                                     tc)
            got.append(tl.numpy())
            want.append(np.asarray(jl))
        logits[q] = (np.stack(got), np.stack(want))
    port_gap = np.abs(logits[True][0] - logits[False][0]).max()
    ref_gap = np.abs(logits[True][1] - logits[False][1]).max()
    assert ref_gap > 1e-2                 # the scheme's error is visible
    assert abs(port_gap - ref_gap) <= 0.05 * ref_gap, (port_gap, ref_gap)
    assert np.abs(logits[True][0] - logits[True][1]).max() <= 0.1 * ref_gap
