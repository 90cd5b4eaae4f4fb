"""The hand CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one:
a CUDA kernel has no CPU mode. They import only torch and the port, so
they run where JAX is not installed:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances: fp32 summation order only (1e-5 for distances, 2e-5 for
attention); ids must be equal on integer-valued l2 inputs, whose
arithmetic is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _int_graph(seed, n, d, m2, b, graph="random"):
    """Integer-valued rows and queries and a random layer-0 graph with -1
    padding and a few all -1 lists. ``graph``: "empty", every list all -1
    (the search ends after its first hop); "repeat", lists drawn from 12
    ids, so that ids repeat within and across the lists of a hop."""
    rng = np.random.default_rng(seed)
    vec = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    nbrs = rng.integers(0, 12 if graph == "repeat" else n,
                        size=(n, m2)).astype(np.int32)
    nbrs[rng.random((n, m2)) < 0.15] = -1                   # -1 padding
    nbrs[rng.integers(0, n, size=5)] = -1                    # whole -1 rows
    if graph == "empty":
        nbrs[:] = -1
    q = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    ep = rng.integers(0, n, size=b).astype(np.int32)
    return vec, nbrs, q, ep


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric,d,offset", [
    ("cosine", 96, 0), ("l2", 96, 0), ("ip", 30, 0),     # D % 4 != 0
    ("l2", 96, 1)])                                       # unaligned rows
def test_gather_distance_kernel_matches_plain(cuda_device, metric, d,
                                              offset):
    """Both row-load paths: float4 and, for D % 4 != 0 or a 16-byte
    misaligned view, scalar."""
    rng = np.random.default_rng(20)
    flat = np.zeros(5000 * d + offset, np.float32)
    flat[offset:] = _unit(rng.normal(size=(5000, d))).reshape(-1)
    vec = _t(flat).to(cuda_device)[offset:].view(5000, d)
    q = _t(_unit(rng.normal(size=(33, d)))).to(cuda_device)
    ids = _t(rng.integers(0, 5000, size=(33, 17)).astype(np.int32)).to(
        cuda_device)
    torch.testing.assert_close(
        tops.gather_distance(vec, q, ids, metric=metric),
        tref.gather_distance_ref(vec, q, ids, metric=metric),
        rtol=0, atol=1e-5)


def _rows_at(vec, device, offset):
    """fp32 rows on the card, ``offset`` floats into their buffer (a view
    that is not 16-byte aligned when offset % 4 != 0)."""
    flat = np.zeros(vec.size + offset, np.float32)
    flat[offset:] = vec.reshape(-1)
    return _t(flat).to(device)[offset:].view(*vec.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("b,expand_t,ef,d,m2,max_iters,graph,offset", [
    (40, 1, 24, 16, 16, None, "random", 0),
    (40, 4, 24, 16, 16, None, "random", 0),
    (40, 3, 10, 30, 10, None, "random", 0),   # non-pow2 ef, T*2M, D % 4
    (40, 4, 16, 16, 16, 5, "random", 0), (40, 4, 16, 16, 16, 0, "random", 0),
    (1, 4, 64, 384, 32, None, "random", 0),   # the served ring: a whole hop
    (8, 4, 64, 384, 32, None, "random", 0),
    (8, 1, 64, 384, 32, None, "random", 0),
    (1500, 4, 64, 384, 32, None, "random", 0),  # more than are resident
    (1500, 1, 24, 384, 32, None, "random", 0),
    (64, 4, 64, 64, 64, None, "random", 0),    # 256 candidates a hop
    (1024, 4, 20, 384, 10, None, "random", 0),  # the bulk build's shape
    (8, 4, 64, 1000, 16, None, "random", 0),   # wider than a whole hop
    (300, 4, 64, 1000, 32, None, "random", 0),  # chunks of a small ring
    (40, 4, 24, 96, 16, None, "random", 1),    # 4 bytes off: element copy
    (8, 4, 64, 384, 32, None, "random", 1),
    (40, 4, 24, 96, 16, None, "empty", 0),     # every list all -1
    (40, 4, 24, 96, 16, None, "repeat", 0),    # ids repeat in a hop
    (40, 1, 24, 96, 16, None, "repeat", 0),
    (8, 4, 64, 384, 32, 0, "random", 0), (8, 4, 64, 384, 32, 5, "random", 0)])
def test_beam_search_kernel_matches_plain(cuda_device, b, expand_t, ef, d,
                                          m2, max_iters, graph, offset):
    """Integer-valued l2 rows: ids and distances equal the plain
    version's on every block shape of ``ops._beam_plan``."""
    vec, nbrs, q, ep = _int_graph(21, n=3000, d=d, m2=m2, b=b, graph=graph)
    rows = _rows_at(vec, cuda_device, offset)
    assert bool(tops._aligned16(rows)) == (offset == 0 and d % 4 == 0)
    args = [rows] + [_t(a).to(cuda_device) for a in (nbrs, q, ep)]
    ep_d = tref.gather_distance_ref(args[0], args[2], args[3][:, None],
                                    metric="l2")[:, 0].contiguous()
    kw = dict(ef=ef, metric="l2", expand_t=expand_t, max_iters=max_iters)
    ki, kd = tops.beam_search(*args, ep_d, **kw)
    ri, rd = tref.beam_search_ref(*args, ep_d, **kw)
    torch.testing.assert_close(ki, ri, rtol=0, atol=0)
    torch.testing.assert_close(kd, rd, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "int8"])
@pytest.mark.parametrize("expand_t,ef", [(4, 8), (1, 8), (4, 16), (2, 12)])
def test_beam_search_kernel_distances_past_inf(cuda_device, codec, expand_t,
                                               ef):
    """Rows whose l2 distance overflows to inf (fp32 rows x 1e19, or int8
    rows with a scale of 1e19) sort after the (INF, -1) empty slots, and
    half the entry points start there: ids and distances equal the plain
    version's."""
    vec, nbrs, q, ep = _int_graph(28, n=600, d=32, m2=4, b=6)
    huge = np.random.default_rng(ef).random(600) < 0.6
    huge[ep[:3]], huge[ep[3:]] = True, False
    if codec == "fp32":
        rows = _t(vec * np.where(huge, 1e19, 1).astype(np.float32)[:, None])
        scl = None
    else:
        rows = _t(vec.astype(np.int8))
        scl = _t(np.where(huge, 1e19, 1).astype(np.float32)).to(cuda_device)
    rows = rows.to(cuda_device)
    nb, qq, e = (_t(a).to(cuda_device) for a in (nbrs, q, ep))
    ep_d = tref.gather_distance_ref(rows, qq, e[:, None], metric="l2",
                                    scales=scl)[:, 0].contiguous()
    assert bool(torch.isinf(ep_d).any())
    kw = dict(ef=ef, metric="l2", scales=scl, expand_t=expand_t)
    ki, kd = tops.beam_search(rows, nb, qq, e, ep_d, **kw)
    ri, rd = tref.beam_search_ref(rows, nb, qq, e, ep_d, **kw)
    torch.testing.assert_close(ki, ri, rtol=0, atol=0)
    torch.testing.assert_close(kd, rd, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("b,d,m2,ef,t", [
    (8, 384, 32, 64, 4), (1024, 384, 32, 64, 4), (1024, 384, 10, 20, 4),
    (1024, 384, 32, 64, 1), (8, 1000, 16, 64, 4), (1500, 30, 64, 40, 4)])
def test_beam_plan_is_the_kernels_layout(cuda_device, codec, b, d, m2, ef,
                                         t):
    """The plan's shared bytes are the kernel's own layout's, and the card
    keeps at least the blocks an SM that 64 registers a thread and the
    block's shared memory (+ 1 KB reserved, of 228 KB) allow."""
    info = tops.beam_search_info(b, d, codec, m2, ef, t, device=cuda_device)
    assert info["kernel_shared_bytes"] == info["shared_bytes"]
    fits = min(1024 // info["threads"],
               233_472 // (info["shared_bytes"] + 1024))
    assert info["blocks_per_sm"] >= fits >= 1


def _flash_args(seed, b, s, kvh, g, dh, cur, device, offset=0):
    """Seeded q, k, v (k and v ``offset`` floats into their buffers: a
    16-byte misaligned view when offset % 4 != 0) and cur_len on the
    card."""
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(b, g * kvh, dh)).astype(np.float32))
    kv = []
    for _ in range(2):
        n = b * s * kvh * dh
        flat = np.zeros(n + offset, np.float32)
        flat[offset:] = rng.normal(size=n)
        kv.append(_t(flat).to(device)[offset:].view(b, s, kvh, dh))
    cur = cur if np.isscalar(cur) else _t(np.asarray(cur, np.int32)).to(
        device)
    return q.to(device), kv[0], kv[1], cur


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,dh,s,cur", [
    (4, 1, 64, 300, [1, 31, 33, 300]), (4, 4, 64, 300, [1, 31, 33, 300]),
    (4, 4, 128, 4100, [1, 31, 33, 4100]), (4, 2, 256, 70, [1, 31, 33, 70]),
    (1, 4, 128, 8192, [8192]),              # one group over every block
    (1, 4, 128, 8192, [5001]),
    (8, 4, 128, 100, [1, 15, 16, 17, 31, 32, 48, 100]),  # tile edges
    (8, 1, 128, 1000, [3, 16, 999, 1000, 64, 65, 2, 1]),
    (8, 8, 128, 600, [600, 1, 512, 513, 17, 256, 300, 599]),
    (3, 4, 256, 500, [500, 257, 3]), (3, 8, 64, 500, [500, 129, 3]),
    (3, 4, 30, 200, [200, 33, 5]),          # Dh % 4 != 0: element copies
    (3, 3, 128, 200, [200, 33, 5]),         # G 3: a padded head group
    (2, 16, 128, 300, [300, 77]),           # G 16: two head groups
    (2, 2, 1000, 64, [64, 20]),             # wide rows, one ring stage
    # the served geometries of the other LMs (4 slots x 256): olmoe G 1,
    # Dh 128; granite G 3, Dh 64; danube G 4, Dh 120 (a row of 30 float4s,
    # lanes past it), also at its 4,096-position ring
    (4, 1, 128, 256, [2, 86, 171, 256]), (4, 3, 64, 256, [2, 86, 171, 256]),
    (4, 4, 120, 256, [2, 86, 171, 256]), (2, 4, 120, 4096, [4096, 1000])])
def test_flash_decode_kernel_matches_plain(cuda_device, b, g, dh, s, cur):
    args = _flash_args(22, b, s, 2, g, dh, cur, cuda_device)
    torch.testing.assert_close(tops.flash_decode(*args),
                               tref.flash_decode_ref(*args),
                               rtol=0, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cur", [5000, 9000, [9000, 1, 8192, 40]])
def test_flash_decode_kernel_scalar_and_clamped_cur_len(cuda_device, cur):
    """A scalar ``cur_len`` and lengths past S, clamped to S."""
    args = _flash_args(23, 4, 8192, 8, 4, 128, cur, cuda_device)
    torch.testing.assert_close(tops.flash_decode(*args),
                               tref.flash_decode_ref(*args),
                               rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_flash_decode_kernel_misaligned_cache_and_zero_length(cuda_device):
    """A cache view 4 bytes off 16-byte alignment takes the element-copy
    instance; a row at cur_len 0 gets zeros (the TPU kernel's), the others
    the plain version's."""
    q, k, v, cur = _flash_args(24, 3, 300, 2, 4, 128, [0, 300, 45],
                               cuda_device, offset=1)
    got = tops.flash_decode(q, k, v, cur)
    assert bool((got[0] == 0).all())
    torch.testing.assert_close(got[1:], tref.flash_decode_ref(
        q, k, v, cur)[1:], rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_flash_decode_kernel_tickets_reset_between_calls(cuda_device):
    """Three launches back to back on one stream with other shapes (more
    groups, then fewer): each leaves its group counters at zero for the
    next, through the one cached scratch."""
    shapes = [(8, 4, 128, 8192, [8192, 4000, 1, 17, 8192, 300, 5000, 64]),
              (2, 8, 64, 3000, [3000, 1500]),
              (8, 4, 128, 8192, [1, 8192, 8192, 16, 7000, 33, 2048, 4097])]
    calls = [_flash_args(25 + i, b, s, 8, g, dh, cur, cuda_device)
             for i, (b, g, dh, s, cur) in enumerate(shapes)]
    outs = [tops.flash_decode(*a) for a in calls]
    for a, o in zip(calls, outs):
        torch.testing.assert_close(o, tref.flash_decode_ref(*a), rtol=0,
                                   atol=2e-5)
    again = tops.flash_decode(*calls[0])
    torch.testing.assert_close(again, outs[0], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# flash_decode on bf16 and fp16 q/K/V
# ---------------------------------------------------------------------------
_HALF = {"bf16": torch.bfloat16, "fp16": torch.float16}


def _flash_args_16(seed, b, s, kvh, g, dh, cur, device, dtype, offset=0):
    """``_flash_args`` in a 2-byte ``dtype``: k and v ``offset`` elements
    into their buffers (off 16-byte alignment when offset % 8 != 0)."""
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(b, g * kvh, dh)).astype(np.float32)).to(
        device, dtype)
    kv = []
    for _ in range(2):
        n = b * s * kvh * dh
        flat = torch.zeros(n + offset, dtype=dtype, device=device)
        flat[offset:] = _t(rng.normal(size=n).astype(np.float32)).to(
            device, dtype)
        kv.append(flat[offset:].view(b, s, kvh, dh))
    cur = cur if np.isscalar(cur) else _t(np.asarray(cur, np.int32)).to(
        device)
    return q, kv[0], kv[1], cur


def _flash_16_case(args, codec):
    """One call, counted on the codec's instance, against the plain
    version on the same 2-byte tensors (2e-5: both widen exactly)."""
    from repro_torch.core import dispatch
    dispatch.reset()
    got = tops.flash_decode(*args)
    assert got.dtype == torch.float32
    assert dispatch.get(f"kernel.flash_decode.{codec}") == 1
    assert dispatch.get("kernel.flash_decode") == 1
    torch.testing.assert_close(got, tref.flash_decode_ref(*args), rtol=0,
                               atol=2e-5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["bf16", "fp16"])
@pytest.mark.parametrize("b,g,dh,s,cur", [
    # the served caches (4 slots x 256): olmoe G 1 Dh 128, granite G 3 Dh
    # 64, danube G 4 Dh 120 (240-byte rows), llama / minitron G 4 Dh 128
    (4, 1, 128, 256, [2, 86, 171, 256]), (4, 3, 64, 256, [2, 86, 171, 256]),
    (4, 4, 120, 256, [2, 86, 171, 256]), (4, 4, 128, 256, [2, 86, 171, 256]),
    (2, 4, 120, 4096, [4096, 1000]),
    (8, 4, 128, 8192, [1, 33, 1000, 4097, 5000, 6143, 8191, 8192]),
    (1, 4, 128, 8192, [8192]), (2, 1, 64, 8192, [8192, 5001]),
    (8, 4, 128, 100, [1, 15, 16, 17, 31, 32, 48, 100]),   # tile edges
    (2, 16, 128, 300, [300, 77]),            # two head groups
    (2, 2, 1000, 64, [64, 20]),              # wide rows, one ring stage
    (3, 4, 36, 200, [200, 33, 5]),           # Dh % 8 != 0: element copies
    (3, 4, 30, 200, [200, 33, 5])])
def test_flash_decode_16bit_kernel_matches_plain(cuda_device, codec, b, g,
                                                 dh, s, cur):
    """The bf16 and fp16 instances at every served geometry (G 1, 3, 4;
    Dh 64, 120, 128), S 256 and 8,192, and the element-by-element path
    (rows not a whole number of 16 bytes)."""
    _flash_16_case(_flash_args_16(30, b, s, 2, g, dh, cur, cuda_device,
                                  _HALF[codec]), codec)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["bf16", "fp16"])
@pytest.mark.parametrize("cur", [5000, 9000, [9000, 1, 8192, 40],
                                 [0, 8192, 0, 3]])
def test_flash_decode_16bit_scalar_clamped_and_zero_cur_len(cuda_device,
                                                            codec, cur):
    """A scalar ``cur_len``, lengths past S (clamped to S), and rows at 0
    (zeros, as the fp32 instance writes)."""
    q, k, v, c = _flash_args_16(31, 4, 8192, 8, 4, 128, cur, cuda_device,
                                _HALF[codec])
    got = tops.flash_decode(q, k, v, c)
    want = tref.flash_decode_ref(q, k, v, c)
    zero = torch.as_tensor(cur, device=cuda_device).reshape(-1).expand(4) == 0
    assert bool((got[zero] == 0).all())
    torch.testing.assert_close(got[~zero], want[~zero], rtol=0, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["bf16", "fp16"])
@pytest.mark.parametrize("offset", [1, 4])       # 2 and 8 bytes off 16
def test_flash_decode_16bit_misaligned_cache(cuda_device, codec, offset):
    """A cache view off 16-byte alignment takes the element-copy instance
    (Dh 128 and 120), and matches the plain version."""
    for dh in (128, 120):
        _flash_16_case(_flash_args_16(32, 3, 300, 2, 4, dh, [300, 1, 45],
                                      cuda_device, _HALF[codec], offset),
                       codec)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["bf16", "fp16"])
def test_flash_decode_16bit_tickets_reset_between_calls(cuda_device, codec):
    """Launches of both 16-bit instances and the fp32 one back to back on
    one stream, through the one cached scratch: each leaves its counters
    at zero for the next."""
    shapes = [(8, 4, 128, 8192, [8192, 4000, 1, 17, 8192, 300, 5000, 64]),
              (2, 8, 64, 3000, [3000, 1500]),
              (8, 4, 120, 4096, [1, 4096, 4096, 16, 700, 33, 2048, 4095])]
    calls = [_flash_args_16(33 + i, b, s, 8, g, dh, cur, cuda_device,
                            _HALF[codec])
             for i, (b, g, dh, s, cur) in enumerate(shapes)]
    calls.insert(1, _flash_args(36, 4, 2000, 8, 4, 128, [2000, 1, 999, 64],
                                cuda_device))
    outs = [tops.flash_decode(*a) for a in calls]
    for a, o in zip(calls, outs):
        torch.testing.assert_close(o, tref.flash_decode_ref(*a), rtol=0,
                                   atol=2e-5)
    again = tops.flash_decode(*calls[0])
    torch.testing.assert_close(again, outs[0], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["bf16", "fp16"])
@pytest.mark.parametrize("b,g,dh,s,cur", [
    (3, 4, 1152, 300, [300, 33, 1]), (2, 2, 2048, 200, [200, 77]),
    (2, 1, 1030, 50, 50)])
def test_flash_decode_16bit_wide_heads_match_plain(cuda_device, codec, b, g,
                                                   dh, s, cur):
    """Heads past 1,024 elements take the wide kernel's 16-bit instance."""
    _flash_16_case(_flash_args_16(34, b, s, 2, g, dh, cur, cuda_device,
                                  _HALF[codec]), codec)


@pytest.mark.cuda
def test_flash_decode_mixed_dtypes_raise(cuda_device):
    """On the card q, k and v share one dtype; the error names them (the
    wrapper never casts)."""
    q, k, v, cur = _flash_args(35, 2, 64, 2, 2, 64, [64, 3], cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tops.flash_decode(q, k.to(torch.bfloat16), v.to(torch.bfloat16), cur)
    with pytest.raises(TypeError, match="float16"):
        tops.flash_decode(q.to(torch.bfloat16), k.to(torch.bfloat16),
                          v.to(torch.float16), cur)
    with pytest.raises(TypeError, match="float64"):
        tops.flash_decode(q.double(), k.double(), v.double(), cur)


def _lm_16(arch, device, weights=torch.float32, seed=0):
    """A smoke-config LM on ``device`` with the CPU's seeded weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as ttf
    cfg = get_smoke_config(arch)
    cpu = ttf.init_lm(cfg, seed=seed, device="cpu")
    model = ttf.LM(cfg, device=device, dtype=weights).requires_grad_(False)
    model.load_state_dict({n: w.to(weights) for n, w in
                           cpu.state_dict().items()})
    return cfg, model


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "h2o-danube-3-4b",
                                  "olmoe-1b-7b"])
def test_bf16_decode_step_flash_matches_dense(cuda_device, arch):
    """bf16 weights, activations and cache on the card: 8 decode ticks
    through the bf16 ``flash_decode`` (one launch a layer a tick, no other
    attention) against the dense path from the same cache, logits within
    3e-2 x max|logit| (the bf16 casts of two fp32 attention outputs that
    differ in summation order)."""
    from repro_torch.core import dispatch
    from repro_torch.models import transformer as ttf
    cfg, model = _lm_16(arch, cuda_device, torch.bfloat16)
    toks = _t(np.random.default_rng(42).integers(
        0, cfg.vocab, size=(2, 40)).astype(np.int32)).to(cuda_device)
    lens = _t(np.array([40, 31], np.int32))
    logits, cache = ttf.prefill(model, toks, max_len=48, prompt_lens=lens)
    assert cache.k.dtype == torch.bfloat16 and logits.dtype == torch.float32
    nxt = logits[:, 0].argmax(-1, keepdim=True)
    for _ in range(8):
        dense = ttf.KVCache(cache.k.clone(), cache.v.clone(),
                            cache.cur_len.clone())
        dispatch.reset()
        lf, cache = ttf.decode_step(model, nxt, cache)
        assert dispatch.get("kernel.flash_decode.bf16") == cfg.n_layers
        assert dispatch.get("kernel.flash_decode") == cfg.n_layers
        ld, _ = ttf.decode_step(model, nxt, dense, attn_impl="dense")
        torch.testing.assert_close(lf, ld, rtol=0,
                                   atol=3e-2 * ld.abs().max().item())
        nxt = lf[:, 0].argmax(-1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b"])
def test_bf16_serve_engine_on_card_matches_cpu(cuda_device, arch):
    """``ServeEngine(dtype=torch.bfloat16)`` over fp32 weights on the card
    against the same engine on the CPU: greedy tokens equal up to each
    request's first position where the CPU's top-2 margin is under 3e-2 x
    max|logit|, at least 8 positions compared; the card's logits within
    that tolerance of the CPU's there."""
    from repro_torch.serve.engine import ServeEngine
    tol = 3e-2
    rows = {}
    engines = {}
    for dev in ("cpu", cuda_device):
        cfg, model = _lm_16(arch, dev)
        eng = ServeEngine(model, cfg, slots=2, max_len=64,
                          dtype=torch.bfloat16, device=dev)
        seen, sample = {}, eng._sample

        def rec(row, rid, t, seen=seen, sample=sample):
            seen[(rid, t)] = np.asarray(row, np.float32)
            return sample(row, rid, t)

        eng._sample = rec
        rng = np.random.default_rng(43)
        prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
                   for n in (7, 19, 36, 12, 25, 3, 44, 16)]
        engines[str(dev)] = eng.generate(prompts, max_new_tokens=10)
        rows[str(dev)] = seen
        assert eng.cache.k.dtype == torch.bfloat16
    got, want = engines[str(cuda_device)], engines["cpu"]
    compared = 0
    for rid, (g, w) in enumerate(zip(got, want)):
        for t, (gt, wt) in enumerate(zip(g, w)):
            row = rows["cpu"][(rid, t)]
            scale = np.abs(row).max()
            np.testing.assert_allclose(rows[str(cuda_device)][(rid, t)], row,
                                       rtol=0, atol=tol * scale)
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] < tol * scale:
                break
            assert gt == wt, (rid, t)
            compared += 1
    assert compared >= 8, compared


# ---------------------------------------------------------------------------
# distance_topk (ops.flat_topk)
# ---------------------------------------------------------------------------
def _encoded(codec_name, x, device):
    """fp32 rows -> (device rows, device scales or None) through the port's
    codec."""
    from repro_torch.core.codec import device_rows, get_codec
    enc, scales = get_codec(codec_name).encode(x)
    return (device_rows(enc, device),
            None if scales is None else device_rows(scales, device))


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("b,n,d,k", [(1, 5000, 384, 10), (7, 997, 30, 5),
                                     (8, 4000, 384, 40), (9, 2000, 96, 10),
                                     (130, 3000, 64, 64)])
def test_flat_topk_kernel_matches_plain(cuda_device, codec, metric, b, n, d,
                                        k):
    """Random rows: both paths (B <= 8 streaming, larger B on the tensor
    cores) at B 1, 7, 8, 9 and 130, D % 16 != 0 (scalar row loads), k up
    to 64. Distances to 1e-5 where the ids agree."""
    rng = np.random.default_rng(30)
    x = _unit(rng.normal(size=(n, d)))
    db, scales = _encoded(codec, x, cuda_device)
    q = _t(_unit(rng.normal(size=(b, d)))).to(cuda_device)
    kd, ki = tops.flat_topk(db, q, k, metric=metric, scales=scales)
    rd, ri = tref.distance_topk_ref(db, q, k, metric=metric, scales=scales)
    assert ki.dtype == ri.dtype == torch.int32 and ki.shape == (b, k)
    same = (ki == ri).all(dim=1)
    assert same.float().mean().item() >= 0.9
    torch.testing.assert_close(kd[same], rd[same], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("b,d", [(8, 1536), (8, 4096), (5, 1537)])
@pytest.mark.parametrize("k", [10, 40, 300])
def test_flat_topk_kernel_exact_at_wide_rows(cuda_device, codec, b, d, k):
    """The streaming path serves any D: its queries sit in shared memory
    where they fit (D 1536 and 1537 at k 10) and are read through L1
    where they do not (k 40; k 300, the widest list, in two passes; D 4096
    at every k). D 1537 takes no 16-byte query loads, B 5 is 5 of a tile
    of 8. On integer-valued l2 rows in [-2, 2] (exact arithmetic, many
    ties) ids and distances equal the plain version's."""
    n = 2000
    rng = np.random.default_rng(35)
    x = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    qn = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    if codec == "int8":
        db = _t(x.astype(np.int8)).to(cuda_device)
        scales = torch.ones(n, device=cuda_device)
    else:
        db, scales = _encoded(codec, x, cuda_device)
    q = _t(qn).to(cuda_device)
    kd, ki = tops.flat_topk(db, q, k, metric="l2", scales=scales)
    rd, ri = tref.distance_topk_ref(db, q, k, metric="l2", scales=scales)
    torch.testing.assert_close(ki, ri, rtol=0, atol=0)
    torch.testing.assert_close(kd, rd, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("b,n,k", [(3, 771, 10), (100, 1027, 10),
                                   (5, 4000, 64), (9, 300, 200)])
def test_flat_topk_kernel_exact_on_integer_ties(cuda_device, codec, b, n, k):
    """Integer-valued l2 rows in [-2, 2] (exact arithmetic, many equal
    distances): ids and distances equal the plain version's, ties broken
    on the smaller id. N = 771 at B 3 and 1027 at B 100 leave the last row
    range 3 rows, fewer than k; k = 200 takes the widest list."""
    rng = np.random.default_rng(31)
    x = rng.integers(-2, 3, size=(n, 32)).astype(np.float32)
    qn = rng.integers(-2, 3, size=(b, 32)).astype(np.float32)
    if codec == "int8":
        db = _t(x.astype(np.int8)).to(cuda_device)
        scales = torch.ones(n, device=cuda_device)
    else:
        db, scales = _encoded(codec, x, cuda_device)
    q = _t(qn).to(cuda_device)
    kd, ki = tops.flat_topk(db, q, k, metric="l2", scales=scales)
    rd, ri = tref.distance_topk_ref(db, q, k, metric="l2", scales=scales)
    torch.testing.assert_close(ki, ri, rtol=0, atol=0)
    torch.testing.assert_close(kd, rd, rtol=0, atol=0)
    assert int(ki.max()) < n and int(ki.min()) >= 0


@pytest.mark.cuda
def test_flat_topk_kernel_short_last_range(cuda_device):
    """The last row range holds 3 rows, fewer than k: its empty slots
    (INF, -1) never reach the merged result, and no id >= N appears."""
    from repro_torch.core import dispatch
    small, splits, rows = tops._topk_plan(3, 771, cuda_device)
    assert small and 0 < 771 - (splits - 1) * rows < 10
    rng = np.random.default_rng(32)
    db = _t(_unit(rng.normal(size=(771, 64)))).to(cuda_device)
    q = _t(_unit(rng.normal(size=(3, 64)))).to(cuda_device)
    dispatch.reset()
    kd, ki = tops.flat_topk(db, q, 10)
    assert dispatch.get("kernel.distance_topk") == 1
    assert bool((ki >= 0).all()) and bool((ki < 771).all())
    assert bool((kd < 1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("b", [1, 8, 9])
@pytest.mark.parametrize("k", [256, 257, 1000, 1203])
def test_flat_topk_passes_exact_on_integer_ties(cuda_device, codec, b, k):
    """Any k <= N: one launch for k <= 256, ceil(k / 256) passes above,
    each after the last (d, id) of the one before. Integer-valued l2 rows
    in [-2, 2] tie across the pass boundaries, and ids and distances
    equal the plain version's exactly; N 1203 leaves a short last range
    on the streaming path."""
    from repro_torch.core import dispatch
    n = 1203
    rng = np.random.default_rng(33)
    x = rng.integers(-2, 3, size=(n, 32)).astype(np.float32)
    qn = rng.integers(-2, 3, size=(b, 32)).astype(np.float32)
    if codec == "int8":
        db = _t(x.astype(np.int8)).to(cuda_device)
        scales = torch.ones(n, device=cuda_device)
    else:
        db, scales = _encoded(codec, x, cuda_device)
    q = _t(qn).to(cuda_device)
    dispatch.reset()
    kd, ki = tops.flat_topk(db, q, k, metric="l2", scales=scales)
    assert dispatch.get("kernel.distance_topk") == -(-k // 256)
    rd, ri = tref.distance_topk_ref(db, q, k, metric="l2", scales=scales)
    torch.testing.assert_close(ki, ri, rtol=0, atol=0)
    torch.testing.assert_close(kd, rd, rtol=0, atol=0)
    small, splits, rows = tops._topk_plan(b, n, cuda_device)
    if small:
        assert 0 < n - (splits - 1) * rows < rows


@pytest.mark.cuda
def test_index_queries_above_the_list_size_match_cpu(cuda_device):
    """The three ways a k above 256 list slots reaches the index API:
    int8 flat query_batch(k=100) (over-fetch 400), fp32 and bf16 flat
    k 300, HNSW.exact_query(k=300); on the card equal to the CPU, keys in
    order. Integer-valued l2 rows and queries (each row holding a 127, so
    the int8 scale is 1.0 and bf16 holds them exactly) make every distance
    exact on both devices: random rows would swap near-tied neighbours
    under the two summation orders."""
    from repro_torch.core.index import make_index
    rng = np.random.default_rng(34)
    data = rng.integers(-127, 128, size=(2000, 64)).astype(np.float32)
    data[:, 0] = 127
    qs = rng.integers(-127, 128, size=(5, 64)).astype(np.float32)
    keys = [f"r{i}" for i in range(2000)]

    def run(device):
        out = []
        for dtype, k in (("int8", 100), ("fp32", 300), ("bf16", 300)):
            idx = make_index("flat", dim=64, metric="l2", dtype=dtype,
                             device=device)
            idx.bulk_insert(keys, data)
            out.append(idx.query_batch(qs, k=k))
        h = make_index("hnsw", dim=64, metric="l2", M=8,
                       ef_construction=40, device=device)
        h.bulk_insert(keys[:500], data[:500])
        out.append(h.exact_query(qs, k=300))
        return out

    for (ck, cd), (gk, gd) in zip(run("cpu"), run(cuda_device)):
        assert gk == ck
        np.testing.assert_array_equal(np.asarray(gd), np.asarray(cd))


# ---------------------------------------------------------------------------
# gather_distance and beam_search over encoded rows (bf16, int8 + scales)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("metric,d,offset", [
    ("cosine", 384, 0), ("l2", 384, 0), ("ip", 30, 0),   # D 30: scalar loads
    ("l2", 384, 1)])                                      # unaligned rows
def test_gather_distance_codec_kernel_matches_plain(cuda_device, codec,
                                                    metric, d, offset):
    """The bf16 and int8 instances against the plain version, on both row
    loads: 16-byte vectors, and scalar loads for D 30 or a view whose
    base is not 16-byte aligned."""
    from repro_torch.core.codec import get_codec
    rng = np.random.default_rng(23)
    n = 5000
    enc, scales = get_codec(codec).encode(_unit(rng.normal(size=(n, d))))
    flat = np.zeros(n * d + offset, enc.dtype)
    flat[offset:] = enc.reshape(-1)
    rows = _encoded_flat(flat, codec, cuda_device)[offset:].view(n, d)
    scl = None if scales is None else _t(scales).to(cuda_device)
    q = _t(_unit(rng.normal(size=(33, d)))).to(cuda_device)
    ids = _t(rng.integers(0, n, size=(33, 17)).astype(np.int32)).to(
        cuda_device)
    assert bool(tops._aligned16(rows)) == (offset == 0 and d == 384)
    torch.testing.assert_close(
        tops.gather_distance(rows, q, ids, metric=metric, scales=scl),
        tref.gather_distance_ref(rows, q, ids, metric=metric, scales=scl),
        rtol=0, atol=1e-5)


def _encoded_flat(flat, codec, device):
    """A flat encoded host array -> a 1-D device tensor of the row dtype
    (bf16 bits viewed as torch.bfloat16)."""
    from repro_torch.core.codec import device_rows
    return device_rows(flat[None], device)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("b,expand_t,ef,d,m2,offset", [
    (40, 1, 24, 32, 16, 0), (40, 4, 24, 32, 16, 0),
    (40, 3, 10, 30, 10, 0),        # non-pow2 ef, T*2M and scalar loads
    (40, 4, 64, 384, 10, 0),       # the served width, M 5
    (1, 4, 64, 384, 32, 0), (8, 4, 64, 384, 32, 0),   # the served ring
    (1500, 4, 64, 384, 32, 0), (1500, 1, 64, 384, 32, 0),
    (64, 4, 64, 384, 64, 0),       # 256 candidates a hop
    (1024, 4, 20, 384, 10, 0),     # the bulk build's shape
    (40, 4, 24, 384, 16, 3)])      # a misaligned view: element copy
def test_beam_search_codec_kernel_exact_on_integer_rows(
        cuda_device, codec, b, expand_t, ef, d, m2, offset):
    """Integer-valued l2 rows (int8 with scales 1.0; bf16 holds small
    integers exactly): the kernel's ids and distances equal the plain
    version's."""
    from repro_torch.core.codec import get_codec
    vec, nbrs, q, ep = _int_graph(24, n=2000, d=d, m2=m2, b=b)
    enc = vec.astype(np.int8) if codec == "int8" else \
        get_codec("bf16").encode(vec)[0]
    flat = np.zeros(enc.size + offset, enc.dtype)
    flat[offset:] = enc.reshape(-1)
    rows = _encoded_flat(flat, codec, cuda_device)[offset:].view(2000, d)
    assert bool(tops._aligned16(rows)) == (offset == 0 and d != 30)
    scl = torch.ones(2000, device=cuda_device) if codec == "int8" else None
    nb, qq, e = (_t(a).to(cuda_device) for a in (nbrs, q, ep))
    ep_d = tref.gather_distance_ref(rows, qq, e[:, None], metric="l2",
                                    scales=scl)[:, 0].contiguous()
    kw = dict(ef=ef, metric="l2", scales=scl, expand_t=expand_t)
    ki, kd = tops.beam_search(rows, nb, qq, e, ep_d, **kw)
    ri, rd = tref.beam_search_ref(rows, nb, qq, e, ep_d, **kw)
    torch.testing.assert_close(ki, ri, rtol=0, atol=0)
    torch.testing.assert_close(kd, rd, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["bf16", "int8"])
@pytest.mark.parametrize("d,b", [(30, 64), (384, 64), (384, 8), (384, 1500)])
def test_beam_search_codec_kernel_matches_plain(cuda_device, codec, d, b):
    """Random cosine rows through the port's codec: ids equal on most
    queries, distances within 1e-5 where they are."""
    from repro_torch.core.codec import device_rows, get_codec
    rng = np.random.default_rng(25)
    n, m2 = 3000, 16
    enc, scales = get_codec(codec).encode(_unit(rng.normal(size=(n, d))))
    rows = device_rows(enc, cuda_device)
    scl = None if scales is None else _t(scales).to(cuda_device)
    nbrs = _t(rng.integers(0, n, size=(n, m2)).astype(np.int32)).to(
        cuda_device)
    q = _t(_unit(rng.normal(size=(b, d)))).to(cuda_device)
    ep = _t(rng.integers(0, n, size=b).astype(np.int32)).to(cuda_device)
    ep_d = tref.gather_distance_ref(rows, q, ep[:, None],
                                    scales=scl)[:, 0].contiguous()
    ki, kd = tops.beam_search(rows, nbrs, q, ep, ep_d, ef=32, scales=scl)
    ri, rd = tref.beam_search_ref(rows, nbrs, q, ep, ep_d, ef=32,
                                  scales=scl)
    same = (ki == ri).all(dim=1)
    assert same.float().mean().item() >= 0.9
    torch.testing.assert_close(kd[same], rd[same], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("d,b", [(384, 8), (384, 300), (1000, 8), (30, 40)])
def test_beam_search_distances_are_gather_distances(cuda_device, codec, d,
                                                    b):
    """The two kernels sum every (query, row) pair in the same order: the
    beam's distances equal ``gather_distance``'s of its ids, bit for bit
    (q in registers, q from shared memory, element copies)."""
    from repro_torch.core.codec import device_rows, get_codec
    rng = np.random.default_rng(27)
    n, m2 = 3000, 16
    x = _unit(rng.normal(size=(n, d)))
    if codec == "fp32":
        rows, scl = _t(x).to(cuda_device), None
    else:
        enc, scales = get_codec(codec).encode(x)
        rows = device_rows(enc, cuda_device)
        scl = None if scales is None else _t(scales).to(cuda_device)
    nbrs = _t(rng.integers(0, n, size=(n, m2)).astype(np.int32)).to(
        cuda_device)
    q = _t(_unit(rng.normal(size=(b, d)))).to(cuda_device)
    ep = _t(rng.integers(0, n, size=b).astype(np.int32)).to(cuda_device)
    ep_d = tops.gather_distance(rows, q, ep[:, None], scales=scl)[:, 0]
    ki, kd = tops.beam_search(rows, nbrs, q, ep, ep_d.contiguous(), ef=32,
                              scales=scl)
    assert bool((ki >= 0).all())
    assert torch.equal(kd, tops.gather_distance(rows, q, ki, scales=scl))


# ---------------------------------------------------------------------------
# the hop kernel's pair layouts, and the one-launch greedy descent
# ---------------------------------------------------------------------------
def _codec_rows(x, codec, device, offset=0):
    """fp32 rows -> (rows of ``codec`` on the card, ``offset`` elements into
    their buffer, and their scales or None)."""
    from repro_torch.core.codec import get_codec
    if codec == "fp32":
        enc, scales = x, None
    else:
        enc, scales = get_codec(codec).encode(x)
    flat = np.zeros(enc.size + offset, enc.dtype)
    flat[offset:] = enc.reshape(-1)
    rows = _encoded_flat(flat, codec, device)[offset:].view(*x.shape)
    return rows, None if scales is None else _t(scales).to(device)


def _upper(rng, layers, n, m):
    """A random upper table [L, N, M] with 15 % -1 padding and a few all -1
    lists."""
    up = rng.integers(0, n, size=(layers, n, m)).astype(np.int32)
    up[rng.random(up.shape) < 0.15] = -1
    up[:, rng.integers(0, n, size=7)] = -1
    return up


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("b,k", [(8, 16), (1024, 5), (1024, 32), (3, 1),
                                 (300, 6), (40, 64)])
def test_gather_distance_kernel_pair_layouts(cuda_device, codec, b, k):
    """Every block shape of ``ops._gather_plan`` (1 to 8 warps a block; a
    query's last warp with 1 to 4 pairs) against the plain version
    (1e-5), and its distances equal the same pairs scored one query at a
    time."""
    rng = np.random.default_rng(31)
    n, d = 4000, 384
    rows, scl = _codec_rows(_unit(rng.normal(size=(n, d))), codec,
                            cuda_device)
    q = _t(_unit(rng.normal(size=(b, d)))).to(cuda_device)
    ids = _t(rng.integers(0, n, size=(b, k)).astype(np.int32)).to(
        cuda_device)
    got = tops.gather_distance(rows, q, ids, scales=scl)
    torch.testing.assert_close(
        got, tref.gather_distance_ref(rows, q, ids, scales=scl),
        rtol=0, atol=1e-5)
    one = torch.cat([tops.gather_distance(rows, q[i:i + 1], ids[i:i + 1],
                                          scales=scl) for i in range(3)])
    assert torch.equal(got[:3], one)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("b,m,layers", [(8, 16, 3), (1024, 5, 8)])
@pytest.mark.parametrize("metric,d,offset", [
    ("cosine", 384, 0), ("l2", 384, 0), ("ip", 30, 0), ("cosine", 96, 0),
    ("cosine", 1000, 0), ("l2", 96, 1), ("cosine", 384, 3)])
def test_greedy_descent_equals_per_hop_loop(cuda_device, codec, b, m, layers,
                                            metric, d, offset):
    """The one-launch descent's (ep, ep_dist) equal the per-hop loop's
    through the hop kernel bit for bit, at the served (B 8, M 16) and the
    bulk build's (B 1024, M 5) shapes, on 16-byte rows in the ring,
    element reads (D 30, misaligned views) and D 1000."""
    from repro_torch.core import dispatch
    rng = np.random.default_rng(32)
    n = 3000
    rows, scl = _codec_rows(_unit(rng.normal(size=(n, d))), codec,
                            cuda_device, offset)
    up = _t(_upper(rng, layers, n, m)).to(cuda_device)
    q = _t(_unit(rng.normal(size=(b, d)))).to(cuda_device)
    ep = torch.full((b,), 17, dtype=torch.int32, device=cuda_device)
    ep_d = tops.gather_distance(rows, q, ep[:, None], metric=metric,
                                scales=scl)[:, 0].contiguous()
    kw = dict(max_level=layers, metric=metric, scales=scl)
    dispatch.reset()
    ge, gd = tops.greedy_descent(rows, up, q, ep, ep_d, **kw)
    assert dispatch.get("hnsw.descent_launches") == 1
    assert dispatch.get(f"kernel.gather_distance.{codec}") == 1
    we, wd = tref.greedy_descent_ref(rows, up, q, ep, ep_d,
                                     gather=tops.gather_distance, **kw)
    assert torch.equal(ge, we)
    assert torch.equal(gd, wd)
    assert bool((ge != ep).any())
    # the descent's distances are the hop kernel's of its ids
    assert torch.equal(gd, tops.gather_distance(rows, q, ge[:, None],
                                                metric=metric,
                                                scales=scl)[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("m", [1, 4, 5, 16, 32, 33, 100])
def test_greedy_descent_exact_on_integer_rows(cuda_device, codec, m):
    """Integer-valued l2 rows (exact arithmetic): the descent equals the
    plain version, ties included (the lowest slot wins), for one to 25
    warps a block; max_level 0 launches nothing."""
    from repro_torch.core import dispatch
    vec, _, q, _ = _int_graph(33, n=2000, d=64, m2=4, b=64)
    rows, scl = _codec_rows(vec, codec, cuda_device)
    if codec == "int8":
        rows, scl = _t(vec.astype(np.int8)).to(cuda_device), torch.ones(
            2000, device=cuda_device)
    rng = np.random.default_rng(m)
    up = _t(_upper(rng, 4, 2000, m)).to(cuda_device)
    qq = _t(q).to(cuda_device)
    ep = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    ep_d = tref.gather_distance_ref(rows, qq, ep[:, None], metric="l2",
                                    scales=scl)[:, 0].contiguous()
    kw = dict(metric="l2", scales=scl)
    for level in (4, 2):
        ge, gd = tops.greedy_descent(rows, up, qq, ep, ep_d, max_level=level,
                                     **kw)
        we, wd = tref.greedy_descent_ref(rows, up, qq, ep, ep_d,
                                         max_level=level, **kw)
        assert torch.equal(ge, we) and torch.equal(gd, wd)
    dispatch.reset()
    ge, gd = tops.greedy_descent(rows, up, qq, ep, ep_d, max_level=0, **kw)
    assert ge is ep and gd is ep_d
    assert dispatch.get("kernel.gather_distance") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("d,m", [(384, 16), (384, 5), (1000, 32), (30, 16),
                                 (8000, 32)])
def test_descent_plan_is_the_kernels_layout(cuda_device, codec, d, m):
    """The plan's shared bytes are the kernel's own layout's; rows wider
    than the ring (8000 fp32 x 32) are read from global memory."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library("gather_distance")
    size = lib.greedy_descent_smem_bytes
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    vec = int(d * tops._ELEM_BYTES[codec] % 16 == 0)
    threads, ring, smem, per_sm = tops._descent_plan(d, codec, m, vec)
    assert smem == size(d, tops._ELEM_BYTES[codec], m, ring)
    assert ring == int(vec and m * d * tops._ELEM_BYTES[codec] < 200_000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_served_search_descends_in_one_launch(cuda_device, dtype):
    """A search on the card: one descent launch, one beam launch, no host
    sync; the keys equal the same index searched on the CPU."""
    from repro_torch.core import dispatch
    from repro_torch.core.index import make_index
    rng = np.random.default_rng(34)
    data = rng.integers(-4, 5, size=(3000, 64)).astype(np.float32)
    q = rng.integers(-4, 5, size=(8, 64)).astype(np.float32)
    keys = [f"d{i}" for i in range(3000)]
    out = {}
    for device in ("cpu", cuda_device):
        idx = make_index("hnsw", dim=64, metric="l2", M=4,
                         ef_construction=40, dtype=dtype, device=device)
        idx.bulk_insert(keys, data)
        assert idx.host_graph().max_level >= 2
        idx.query_batch(q[:1], k=5)                 # uploads the graph
        dispatch.reset()
        out[str(device)] = idx.query_batch(q, k=5)[0]
        counts = dispatch.snapshot()
    assert out["cpu"] == out[str(cuda_device)]
    assert counts["hnsw.descent_launches"] == 1
    assert counts["kernel.gather_distance"] == 1
    assert counts["kernel.beam_search"] == 1
    assert counts.get("hnsw.host_syncs", 0) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("d,b", [(384, 8), (384, 300), (1000, 8), (30, 40)])
def test_descent_distances_are_gather_distances(cuda_device, codec, d, b):
    """The descent and the hop kernel sum every (query, row) pair in the
    same order (as ``beam_search`` does): the descent's ep_dist equals
    ``gather_distance``'s distance of its ep, bit for bit."""
    rng = np.random.default_rng(35)
    n, m = 3000, 16
    rows, scl = _codec_rows(_unit(rng.normal(size=(n, d))), codec,
                            cuda_device)
    up = _t(_upper(rng, 2, n, m)).to(cuda_device)
    q = _t(_unit(rng.normal(size=(b, d)))).to(cuda_device)
    ep = _t(rng.integers(0, n, size=b).astype(np.int32)).to(cuda_device)
    ep_d = tops.gather_distance(rows, q, ep[:, None], scales=scl)[:, 0]
    ge, gd = tops.greedy_descent(rows, up, q, ep, ep_d.contiguous(),
                                 max_level=2, scales=scl)
    moved = ge != ep
    assert bool(moved.any())
    assert torch.equal(gd, tops.gather_distance(rows, q, ge[:, None],
                                                scales=scl)[:, 0])


@pytest.mark.cuda
def test_codec_kernels_check_their_rows(cuda_device):
    """int8 rows need fp32 scales; bf16 and fp32 rows take none."""
    rows = torch.zeros(10, 16, dtype=torch.int8, device=cuda_device)
    q = torch.zeros(2, 16, device=cuda_device)
    ids = torch.zeros(2, 3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="scales"):
        tops.gather_distance(rows, q, ids)
    with pytest.raises(ValueError, match="scales"):
        tops.gather_distance(rows.to(torch.bfloat16), q, ids,
                             scales=torch.ones(10, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_bulk_build_on_card_bit_identical_to_cpu(cuda_device, metric):
    """Integer-valued rows (exact arithmetic): the graph bulk-built on the
    card — searches through the kernels, selects and connects on the card
    — equals the same call on the CPU bit for bit."""
    from repro_torch.core import dispatch
    from repro_torch.core import hnsw_build as tbuild
    rng = np.random.default_rng(26)
    data = rng.integers(-4, 5, size=(3000, 32)).astype(np.float32)
    kw = dict(M=8, ef_construction=40, metric=metric, seed=2, bootstrap=64,
              batch_size=512)
    dispatch.reset()
    gc = tbuild.bulk_build(data, device=cuda_device, **kw)
    assert dispatch.get("kernel.beam_search") == 6     # one per batch
    assert dispatch.get("kernel.gather_distance") > 0
    gh = tbuild.bulk_build(data, device="cpu", **kw)
    for name in ("neighbors0", "upper", "levels", "vectors"):
        np.testing.assert_array_equal(getattr(gc, name), getattr(gh, name),
                                      err_msg=name)
    assert (gc.entry, gc.max_level) == (gh.entry, gh.max_level)


@pytest.mark.cuda
def test_select_neighbors_on_card_refuses_tf32(cuda_device):
    """The pairwise block must be full fp32 for the build to equal the
    CPU's; with TF32 matmuls switched on the op raises."""
    v = torch.randint(-4, 5, (20, 8), device=cuda_device).float()
    cand = torch.randint(-1, 20, (3, 6), device=cuda_device,
                         dtype=torch.int32)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="tf32"):
            tops.select_neighbors(v, v[:3], cand, m=4, metric="l2")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    ids, _ = tops.select_neighbors(v, v[:3], cand, m=4, metric="l2")
    want, _ = tref.select_neighbors_ref(v.cpu(), v[:3].cpu(), cand.cpu(),
                                        m=4, metric="l2")
    assert torch.equal(ids.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("e", [10, 32, 64])      # scalar, vector loads
@pytest.mark.parametrize("l", [1, 50])
@pytest.mark.parametrize("weights", ["none", "zero", "random"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_matches_plain(cuda_device, e, l, weights,
                                            combine, dtype):
    """The kernel against its plain version (rtol 1e-5 / atol 1e-5: fp32
    summation order only); integer-valued rows with 0/1 weights exactly."""
    # B 77: no multiple of a block's bags
    _bag_case(cuda_device, e, l, weights, combine, dtype, 77, 27 + e + l)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hnsw", "flat"])
def test_int8_store_restores_onto_card(cuda_device, kind, tmp_path):
    """A small int8 store warm-restored onto the card gives the keys its
    restore onto the CPU gives; the restored HNSW uploads its graph on the
    first query."""
    from repro_torch.core import dispatch
    from repro_torch.core.index import make_index
    from repro_torch.store import IndexStore
    rng = np.random.default_rng(28)
    data = rng.normal(size=(400, 32)).astype(np.float32)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    sd = str(tmp_path / "s")
    cfg = dict(dim=32, M=8, ef_construction=40, dtype="int8")
    idx = make_index(kind, store=sd, device="cpu", **cfg)
    idx.bulk_insert([f"d{i}" for i in range(400)], data)
    idx._store.snapshot(idx)
    for i in range(10):
        idx.delete(f"d{i}")
    idx.insert("late", data[10] + 0.5)
    card = IndexStore(sd).load_index(device=cuda_device)
    cpu = IndexStore(sd).load_index(device="cpu")
    assert card.mutation_epoch == cpu.mutation_epoch == idx.mutation_epoch
    dispatch.reset()
    kc, dc = card.query_batch(q, k=5)
    ki, di = cpu.query_batch(q, k=5)
    assert kc == ki
    np.testing.assert_allclose(dc, di, rtol=1e-5, atol=1e-5)
    counter = ("kernel.beam_search.int8" if kind == "hnsw"
               else "kernel.distance_topk.int8")
    assert dispatch.get(counter) == 1
    if kind == "hnsw":
        assert dispatch.get("hnsw.h2d_bytes") > 0


# ---------------------------------------------------------------------------
# HNSW search past M 128: the descent's rounds of 128 slots and the beam's
# waves of 1,024 candidates
# ---------------------------------------------------------------------------
def _wide_case(seed, codec, m, b, integer, device):
    """Rows (random unit rows through the codec, or integer-valued rows:
    bf16 exact, int8 with scales 1.0), an upper table [2, N, M], a
    layer-0 graph [N, 2M], queries and entry points on the card."""
    rng = np.random.default_rng(seed)
    n, d = 3000, 384
    if integer:
        vec = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
        q = rng.integers(-3, 4, size=(b, d)).astype(np.float32)
        if codec == "int8":
            rows = _t(vec.astype(np.int8)).to(device)
            scl = torch.ones(n, device=device)
        else:
            rows, scl = _codec_rows(vec, codec, device)
    else:
        vec = _unit(rng.normal(size=(n, d)))
        q = _unit(rng.normal(size=(b, d)))
        rows, scl = _codec_rows(vec, codec, device)
    nbrs = rng.integers(0, n, size=(n, 2 * m)).astype(np.int32)
    nbrs[rng.random(nbrs.shape) < 0.15] = -1
    up = _upper(rng, 2, n, m)
    ep = rng.integers(0, n, size=b).astype(np.int32)
    return (rows, scl, _t(up).to(device), _t(nbrs).to(device),
            _t(q).to(device), _t(ep).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("m", [129, 200, 256])
@pytest.mark.parametrize("t", [4, 1])
def test_wide_descent_and_beam_match_plain(cuda_device, codec, m, t):
    """Random cosine rows at D 384, M 129 to 256: the descent's (ep,
    ep_dist) equal the per-hop loop's through the hop kernel bit for bit
    and the plain version's ep on most queries; the beam's ids equal the
    plain version's on most queries, distances within 1e-5 where they
    are."""
    rows, scl, up, nbrs, q, ep = _wide_case(40 + m, codec, m, 8, False,
                                            cuda_device)
    ep_d = tops.gather_distance(rows, q, ep[:, None],
                                scales=scl)[:, 0].contiguous()
    kw = dict(max_level=2, scales=scl)
    ge, gd = tops.greedy_descent(rows, up, q, ep, ep_d, **kw)
    le, ld = tref.greedy_descent_ref(rows, up, q, ep, ep_d,
                                     gather=tops.gather_distance, **kw)
    assert torch.equal(ge, le) and torch.equal(gd, ld)
    we, wd = tref.greedy_descent_ref(rows, up, q, ep, ep_d, **kw)
    same = ge == we
    assert same.float().mean().item() >= 0.75
    torch.testing.assert_close(gd[same], wd[same], rtol=0, atol=1e-5)
    kw = dict(ef=64, expand_t=t, scales=scl)
    ki, kd = tops.beam_search(rows, nbrs, q, ge, gd, **kw)
    ri, rd = tref.beam_search_ref(rows, nbrs, q, ge, gd, **kw)
    same = (ki == ri).all(dim=1)
    assert same.float().mean().item() >= 0.75
    torch.testing.assert_close(kd[same], rd[same], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("m", [129, 200, 256])
@pytest.mark.parametrize("t", [4, 1])
@pytest.mark.parametrize("b", [8, 300])
def test_wide_descent_and_beam_exact_on_integer_rows(cuda_device, codec, m,
                                                     t, b):
    """Integer-valued l2 rows (exact arithmetic), M 129 to 256: the
    descent and the beam equal the plain version's ids and distances,
    at the served batch and at one that fills the SMs."""
    rows, scl, up, nbrs, q, ep = _wide_case(50 + m, codec, m, b, True,
                                            cuda_device)
    ep_d = tref.gather_distance_ref(rows, q, ep[:, None], metric="l2",
                                    scales=scl)[:, 0].contiguous()
    kw = dict(max_level=2, metric="l2", scales=scl)
    ge, gd = tops.greedy_descent(rows, up, q, ep, ep_d, **kw)
    we, wd = tref.greedy_descent_ref(rows, up, q, ep, ep_d, **kw)
    assert torch.equal(ge, we) and torch.equal(gd, wd)
    kw = dict(ef=64, expand_t=t, metric="l2", scales=scl)
    ki, kd = tops.beam_search(rows, nbrs, q, ge, gd, **kw)
    ri, rd = tref.beam_search_ref(rows, nbrs, q, ge, gd, **kw)
    torch.testing.assert_close(ki, ri, rtol=0, atol=0)
    torch.testing.assert_close(kd, rd, rtol=0, atol=0)


@pytest.mark.cuda
def test_bulk_build_at_m130_bit_identical_to_cpu(cuda_device):
    """M 130 (descent lists of 130 slots, beam hops of 1,040 candidates):
    the graph bulk-built on the card from integer-valued l2 rows equals
    the CPU's bit for bit."""
    from repro_torch.core import dispatch
    from repro_torch.core import hnsw_build as tbuild
    rng = np.random.default_rng(36)
    data = rng.integers(-4, 5, size=(4000, 32)).astype(np.float32)
    kw = dict(M=130, ef_construction=40, metric="l2", seed=2, bootstrap=64,
              batch_size=1024)
    dispatch.reset()
    gc = tbuild.bulk_build(data, device=cuda_device, **kw)
    assert dispatch.get("kernel.beam_search") > 0
    assert dispatch.get("hnsw.descent_launches") > 0
    gh = tbuild.bulk_build(data, device="cpu", **kw)
    assert gh.upper.shape[2] == 130
    for name in ("neighbors0", "upper", "levels", "vectors"):
        np.testing.assert_array_equal(getattr(gc, name), getattr(gh, name),
                                      err_msg=name)
    assert (gc.entry, gc.max_level) == (gh.entry, gh.max_level)


# ---------------------------------------------------------------------------
# flash_decode past Dh 1024, embedding_bag's splits and NaN rows
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("b,g,dh,s,cur", [
    (3, 4, 1152, 300, [300, 33, 1]), (2, 2, 2048, 200, [200, 77]),
    (2, 1, 1030, 50, 50)])                  # Dh % 4 != 0, scalar cur_len
def test_flash_decode_wide_heads_match_plain(cuda_device, b, g, dh, s, cur):
    """Heads wider than 1,024 floats take the wide kernel (one launch,
    counted as flash_decode's) and match the plain version."""
    from repro_torch.core import dispatch
    args = _flash_args(29, b, s, 2, g, dh, cur, cuda_device)
    dispatch.reset()
    got = tops.flash_decode(*args)
    assert dispatch.get("kernel.flash_decode") == 1
    torch.testing.assert_close(got, tref.flash_decode_ref(*args), rtol=0,
                               atol=2e-5)


def _bag_case(cuda_device, e, l, weights, combine, dtype, b, seed):
    """The kernel against its plain version (rtol 1e-5 / atol 1e-5: fp32
    summation order only); integer-valued rows with 0/1 weights exactly."""
    from repro_torch.core import dispatch
    rng = np.random.default_rng(seed)
    r = 5000
    table = _t(rng.normal(size=(r, e)).astype(np.float32)).to(
        cuda_device, dtype)
    ids = _t(rng.integers(0, r, size=(b, l)).astype(np.int32)).to(
        cuda_device)
    w = None
    if weights != "none":
        wn = rng.random((b, l)).astype(np.float32)
        if weights == "zero":
            wn[:] = 0.0
        wn[min(3, b - 1)] = 0.0          # one all-zero bag in every case
        w = _t(wn).to(cuda_device)
    dispatch.reset()
    got = tops.embedding_bag(table, ids, w, combine=combine)
    assert dispatch.get("kernel.embedding_bag") == 1
    want = tref.embedding_bag_ref(table, ids, w, combine=combine)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    tint = _t(rng.integers(-8, 9, size=(r, e)).astype(np.float32)).to(
        cuda_device, dtype)
    wint = _t((rng.random((b, l)) < 0.5).astype(np.float32)).to(cuda_device)
    got = tops.embedding_bag(tint, ids, wint, combine=combine)
    want = tref.embedding_bag_ref(tint, ids, wint, combine=combine)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("e", [10, 32, 64])      # scalar, vector loads
@pytest.mark.parametrize("l", [1, 50])
@pytest.mark.parametrize("weights", ["none", "zero", "random"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 512])
def test_embedding_bag_kernel_matches_plain_at_batch(cuda_device, e, l,
                                                     weights, combine, dtype,
                                                     b):
    """B 1 and the serve batch B 512, where a bag's members split over up
    to 8 warps (``ops._bag_plan``), and L 1, a warp's lone member."""
    _bag_case(cuda_device, e, l, weights, combine, dtype, b, 27 + e + l + b)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l", [(7, 50), (512, 50), (3, 1)])
def test_embedding_bag_zero_weight_does_not_hide_nan(cuda_device, bad,
                                                     combine, dtype, b, l):
    """A zero-weight member whose row holds NaN or Inf: 0 x NaN and 0 x
    Inf are NaN, so the bag is NaN wherever the plain version's is."""
    rng = np.random.default_rng(37)
    tn = rng.normal(size=(100, 64)).astype(np.float32)
    tn[5, ::3] = bad
    table = _t(tn).to(cuda_device, dtype)
    ids = rng.integers(6, 100, size=(b, l)).astype(np.int32)
    ids[::2, 0] = 5                          # every other bag holds row 5
    wn = rng.random((b, l)).astype(np.float32)
    wn[::2, 0] = 0.0                         # at weight 0
    ids, w = _t(ids).to(cuda_device), _t(wn).to(cuda_device)
    got = tops.embedding_bag(table, ids, w, combine=combine)
    want = tref.embedding_bag_ref(table, ids, w, combine=combine)
    assert bool(torch.isnan(want[0]).any())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)


# ---------------------------------------------------------------------------
# IVF: the hop kernel at the probe's shapes, k-means on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("b,nlist,cap,nprobe", [
    (8, 64, 300, 8), (3, 16, 8192, 16), (1, 7, 1 << 17, 1),
    (2, 5, 40_000, 4)])                  # K = nprobe x cap up to 2^17+
def test_gather_distance_at_ivf_shapes_matches_plain(cuda_device, codec, b,
                                                     nlist, cap, nprobe):
    """The coarse launch (K = nlist on fp32 centroids) and the fine one
    (K = nprobe x cap on the codec's rows, -1 list pads clipped to row 0
    and masked after the call), against the plain version."""
    from repro_torch.core.ivf import INF
    from repro_torch.kernels.ref import smallest_k
    rng = np.random.default_rng(41 + cap)
    n = 50_000
    x = _unit(rng.normal(size=(n, 64)))
    rows, scales = _codec_rows(x, codec, cuda_device)
    cent = _t(_unit(rng.normal(size=(nlist, 64)))).to(cuda_device)
    q = _t(_unit(rng.normal(size=(b, 64)))).to(cuda_device)
    coarse = torch.arange(nlist, dtype=torch.int32,
                          device=cuda_device).expand(b, nlist).contiguous()
    got = tops.gather_distance(cent, q, coarse)
    torch.testing.assert_close(got, tref.gather_distance_ref(cent, q, coarse),
                               rtol=0, atol=1e-5)
    lists = rng.integers(0, n, size=(nlist, cap)).astype(np.int32)
    lists[rng.random((nlist, cap)) < 0.3] = -1           # list padding
    lists = _t(lists).to(cuda_device)
    probe = smallest_k(got, coarse, nprobe)[1]
    cand = lists[probe.long()].reshape(b, nprobe * cap)
    ids = torch.clamp(cand, 0, n - 1)
    d = tops.gather_distance(rows, q, ids, scales=scales)
    want = tref.gather_distance_ref(rows, q, ids, scales=scales)
    torch.testing.assert_close(d, want, rtol=0, atol=1e-5)
    valid = cand >= 0
    torch.testing.assert_close(torch.where(valid, d, INF),
                               torch.where(valid, want, INF), rtol=0,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_ivf_index_on_card_matches_cpu(cuda_device, codec, metric):
    """An IVFVectorIndex on the card and its state on the CPU (the same
    centroids): equal keys; the k clamp and missing slots as the CPU's."""
    from repro_torch.core.index import make_index
    rng = np.random.default_rng(43)
    data = rng.normal(size=(6000, 48)).astype(np.float32)
    q = rng.normal(size=(16, 48)).astype(np.float32)
    card = make_index("ivf", metric=metric, dtype=codec, nlist=32, nprobe=4,
                      device=cuda_device)
    card.bulk_insert([f"d{i}" for i in range(6000)], data)
    card.query(q[0], 3)
    cpu = make_index("ivf", device="cpu", **card.config_dict())
    cpu.restore_state(*card.state_dict())
    for k, nprobe in ((10, None), (40, 32), (5000, 1)):
        ck, cd = card.query_batch(q, k, nprobe=nprobe)
        pk, pd = cpu.query_batch(q, k, nprobe=nprobe)
        assert ck == pk
        np.testing.assert_allclose(cd, pd, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kmeans_on_card_is_deterministic(cuda_device):
    """Two trainings on the card give the same centroids and assignments
    bit for bit (the per-cluster sums are a one-hot product, no float
    atomics)."""
    from repro_torch.core.ivf import kmeans
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(47)
    x = _t(rng.normal(size=(200_000, 96)).astype(np.float32))
    runs = [kmeans(x.to(cuda_device), 64, 8, seed=3) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    c, a = runs[0]
    assert c.shape == (64, 96) and bool(torch.isfinite(c).all())
    assert torch.bincount(a, minlength=64).sum().item() == 200_000


@pytest.mark.cuda
def test_kmeans_refuses_tf32(cuda_device):
    from repro_torch.core.ivf import kmeans
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full-fp32"):
            kmeans(torch.ones(10, 4, device=cuda_device), 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# the sharded index (n_shards > 1): shards on cuda:0 repeated, or on
# distinct cards, against the same index on the CPU
# ---------------------------------------------------------------------------
SHARD_KINDS = ["flat", "ivf", "hnsw", "tiered"]


def _sharded_rows(integer: bool):
    """Integer-valued l2 rows (each holding a 127, so the int8 scale is 1.0
    and bf16 holds them exactly: every distance is exact on both devices)
    or random cosine rows."""
    rng = np.random.default_rng(51)
    if integer:
        data = rng.integers(-127, 128, size=(3000, 64)).astype(np.float32)
        data[:, 0] = 127
        q = rng.integers(-127, 128, size=(8, 64)).astype(np.float32)
        return data, q, "l2"
    data = rng.normal(size=(3000, 64)).astype(np.float32)
    return data, rng.normal(size=(8, 64)).astype(np.float32), "cosine"


def _sharded_card_and_cpu(kind, codec, n_shards, device, integer):
    """An index of ``kind`` at ``n_shards`` on the card after inserts,
    deletes and an update, and the same state restored on the CPU."""
    from repro_torch.core.index import make_index
    data, q, metric = _sharded_rows(integer)
    cfg = dict(nlist=16, nprobe=4) if kind == "ivf" else dict(
        M=8, ef_construction=40)
    card = make_index(kind, dim=64, metric=metric, dtype=codec,
                      n_shards=n_shards, device=device, **cfg)
    card.bulk_insert([f"d{i}" for i in range(2990)], data[:2990])
    for i in range(2990, 3000):
        card.insert(f"d{i}", data[i])
    card.update("d5", data[6])
    for i in range(0, 300, 7):
        card.delete(f"d{i}")
    card.query(q[0], 3)                            # trains IVF
    cpu = make_index(kind, device="cpu", **card.config_dict())
    cpu.restore_state(*card.state_dict())
    return card, cpu, q


def _assert_sharded_answers(card, cpu, q, exact: bool):
    from repro_torch.core import dispatch
    for fn, k in (("query_batch", 10), ("exact_query", 12)):
        dispatch.reset()
        ck, cd = getattr(card, fn)(q, k)
        counts = dispatch.snapshot()
        pk, pd = getattr(cpu, fn)(q, k)
        assert ck == pk, fn
        if exact:
            np.testing.assert_array_equal(np.asarray(cd), np.asarray(pd))
        else:
            np.testing.assert_allclose(np.asarray(cd), np.asarray(pd),
                                       rtol=1e-5, atol=1e-5)
        assert sum(counts.get(c, 0) for c in dispatch.KERNEL_COUNTERS) > 0
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("kind", SHARD_KINDS)
def test_sharded_index_on_one_card_matches_cpu(cuda_device, kind, codec,
                                               monkeypatch):
    """4 shards on cuda:0 (``REPRO_TORCH_SHARD_DEVICES``): each shard's
    kernels launch on the card; keys and distances equal the CPU's on
    integer rows; on float rows flat and IVF keys equal, distances within
    1e-5."""
    from repro_torch.core import dispatch
    monkeypatch.setenv("REPRO_TORCH_SHARD_DEVICES", ",".join(["cuda:0"] * 4))
    card, cpu, q = _sharded_card_and_cpu(kind, codec, 4, cuda_device, True)
    assert card.shard_count == 4
    _assert_sharded_answers(card, cpu, q, exact=True)
    dispatch.reset()
    card.query_batch(q, 10)
    counts = dispatch.snapshot()
    if kind == "flat":
        assert counts["kernel.distance_topk"] == 4
    elif kind == "ivf":          # one coarse launch (one device), 4 fine
        assert counts["kernel.gather_distance"] == 5
    else:
        assert counts["kernel.beam_search"] == 4
    if kind in ("flat", "ivf"):
        card, cpu, q = _sharded_card_and_cpu(kind, codec, 4, cuda_device,
                                             False)
        _assert_sharded_answers(card, cpu, q, exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SHARD_KINDS)
def test_sharded_index_on_distinct_cards_matches_cpu(cuda_device, kind,
                                                     monkeypatch):
    """One shard a card (shard s on cuda:s), against the CPU: the shards'
    tensors live on their own cards and the merge meets on cuda:0."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    monkeypatch.delenv("REPRO_TORCH_SHARD_DEVICES", raising=False)
    s = min(n, 4)
    card, cpu, q = _sharded_card_and_cpu(kind, "int8", s, cuda_device, True)
    if kind in ("flat", "ivf"):
        placed = card._rows.pack()
        assert [b.device.index for b in placed.blocks] == list(range(s))
    else:
        inner = card.inner if kind == "tiered" else card
        assert [c.device.index for c in inner._shards] == list(range(s))
    _assert_sharded_answers(card, cpu, q, exact=True)


@pytest.mark.cuda
def test_shard_devices_raises_without_the_recipe(cuda_device, monkeypatch):
    """More shards than cards raises, naming ``REPRO_TORCH_SHARD_DEVICES``;
    never a quiet fallback to repeated or CPU devices."""
    from repro_torch.core.index import make_index
    from repro_torch.core.sharded import max_shards, shard_devices
    monkeypatch.delenv("REPRO_TORCH_SHARD_DEVICES", raising=False)
    n = torch.cuda.device_count()
    assert max_shards("cuda") == n
    with pytest.raises(ValueError, match="REPRO_TORCH_SHARD_DEVICES"):
        shard_devices(n + 1, "cuda")
    for kind in SHARD_KINDS:
        with pytest.raises(ValueError, match="REPRO_TORCH_SHARD_DEVICES"):
            make_index(kind, n_shards=n + 1, device="cuda")
    monkeypatch.setenv("REPRO_TORCH_SHARD_DEVICES",
                       ",".join(["cuda:0"] * (n + 1)))
    assert shard_devices(n + 1, "cuda") == [torch.device("cuda", 0)] * (n + 1)
    assert max_shards("cuda") == n + 1
    with pytest.raises(ValueError, match="lists"):
        shard_devices(n + 2, "cuda")
    monkeypatch.setenv("REPRO_TORCH_SHARD_DEVICES", f"cuda:0,cuda:{n}")
    with pytest.raises(ValueError, match="not one of"):
        shard_devices(2, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 3, 4, 8])
def test_tree_merge_on_card_matches_cpu(cuda_device, s):
    """The tree's stable sorts on the card give the CPU oracle's (d, id)
    order bit for bit, ties included."""
    from repro_torch.distributed.collectives import (topk_merge_axis,
                                                     tree_merge)
    rng = np.random.default_rng(60 + s)
    parts = []
    for j in range(s):
        d = np.sort(rng.integers(0, 5, size=(64, 40)) / 4, axis=1)
        ids = rng.permutation(10_000)[:64 * 40].reshape(64, 40) + j * 10_000
        parts.append((_t(d.astype(np.float32)), _t(ids.astype(np.int32))))
    want = topk_merge_axis(parts, 40, tie_break_ids=True, tree=False)
    for gd, gi in tree_merge([(d.to(cuda_device), i.to(cuda_device))
                              for d, i in parts], 40, tie_break_ids=True):
        assert torch.equal(gd.cpu(), want[0])
        assert torch.equal(gi.cpu(), want[1])


def _pool_card_and_cpu(codec, n_shards, device, integer):
    """An ``IndexPool`` on the card and one on the CPU after the same
    mutations: twelve tenants of 40-183 rows (padded slab widths 4, 8 and
    16 at R 16), deletes, updates, an evict and admit, a compact."""
    from repro_torch.core import IndexPool
    data, q, metric = _sharded_rows(integer)
    pools = [IndexPool(dim=64, metric=metric, dtype=codec, n_shards=n_shards,
                       slab_rows=16, max_resident=12, device=d)
             for d in (device, "cpu")]
    for p in pools:
        for j in range(12):
            lo = j * 240
            p.bulk_insert(f"t{j}", [f"d{i}" for i in range(lo, lo + 40 + 13
                                                           * j)],
                          data[lo:lo + 40 + 13 * j])
        for j in range(0, 12, 3):
            p.delete(f"t{j}", f"d{j * 240 + 1}")
            p.update(f"t{j}", f"d{j * 240 + 2}", data[2999])
        p.evict("t4")
        p.admit("t4")
        p.compact("t3")
    return pools, q


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("integer", [True, False])
def test_pool_slab_scan_kernel_matches_plain(cuda_device, codec, integer):
    """A tenant's slab scan as ``tenant_topk`` makes it (its slabs
    gathered out of the shared block, k + slack rows) through the
    ``distance_topk`` kernel against the plain version on the same
    gathered rows, at B 8 and B 128; and one single-tenant search is one
    launch of the codec's instance."""
    from repro_torch.core import dispatch
    from repro_torch.core import tenancy as tten
    (card, _), q = _pool_card_and_cpu(codec, 1, cuda_device, integer)
    _, bl, gi, sc = card._arena.pack_arena()
    rng = np.random.default_rng(52)
    for tid in ("t0", "t5", "t11"):
        tbl = card._arena._device_tables(tid)[0]
        _, _, slack, live = card._arena.tenant_table(tid)
        db, g, s = tten._slab_gather(bl[0], gi[0], None if sc is None
                                     else sc[0], tbl, 16)
        for b in (8, 128):
            qq = _t(q[rng.integers(0, 8, b)] + (0 if integer else rng.normal(
                size=(b, 64)).astype(np.float32))).to(cuda_device)
            kk = min(40 + slack, db.shape[0])
            got = tops.flat_topk(db, qq, kk, metric="l2" if integer
                                 else "cosine", scales=s)
            want = tref.distance_topk_ref(db, qq, kk, metric="l2" if integer
                                          else "cosine", scales=s)
            if integer:
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
            else:
                err = (got[0] - want[0]).abs()
                assert err.max().item() <= 1e-5
                assert bool(((got[1] == want[1]) | (err <= 1e-6)).all())
        dispatch.reset()
        card.query_batch(tid, q, k=10)
        assert dispatch.get(f"kernel.distance_topk.{codec}") == 1
        assert dispatch.get("kernel.distance_topk") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("shards", [1, 4])
def test_pool_on_card_matches_cpu(cuda_device, codec, shards, monkeypatch):
    """The card pool (4 shards on cuda:0 through
    ``REPRO_TORCH_SHARD_DEVICES``) against the CPU pool: keys and
    distances equal on integer rows (single-tenant and cross-tenant
    searches), epochs and canonical state equal; on float rows keys
    equal, distances within 1e-5."""
    from repro_torch.core import dispatch
    monkeypatch.setenv("REPRO_TORCH_SHARD_DEVICES",
                       ",".join(["cuda:0"] * shards))
    for integer in (True, False):
        (card, cpu), q = _pool_card_and_cpu(codec, shards, cuda_device,
                                            integer)
        tids = [f"t{j}" for j in range(12)]
        for tid in tids:
            dispatch.reset()
            ck, cd = card.query_batch(tid, q, k=10)
            assert dispatch.get(f"kernel.distance_topk.{codec}") == shards
            pk, pd = cpu.query_batch(tid, q, k=10)
            assert ck == pk and card.epoch(tid) == cpu.epoch(tid)
            if integer:
                np.testing.assert_array_equal(cd, pd)
            else:
                np.testing.assert_allclose(cd, pd, rtol=1e-5, atol=1e-5)
            a, b = card._arena.tenant_rows(tid), cpu._arena.tenant_rows(tid)
            assert a[0] == b[0]
            assert all(x is None and y is None or x.tobytes() == y.tobytes()
                       for x, y in zip(a[1:], b[1:]))
        mixed = [tids[j % 12] for j in range(0, 96, 5)][:16]
        qm = np.concatenate([q, q])
        ck, cd = card.query_batch_multi(qm, mixed, k=10)
        pk, pd = cpu.query_batch_multi(qm, mixed, k=10)
        assert ck == pk
        np.testing.assert_allclose(cd, pd, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the other LMs: the MoE layer, the SWA ring and the int8 KV cache on the
# card against the CPU
# ---------------------------------------------------------------------------
def _moe_on_both(cfg, d, t, device, seed=40):
    """A seeded MoE layer and tokens, on the CPU and on the card."""
    from repro_torch.models import moe as tmoe
    cpu = tmoe.MoE(d, cfg, device="cpu").requires_grad_(False)
    cpu.reset_parameters(torch.Generator().manual_seed(seed), n_layers=4)
    x = _t(np.random.default_rng(seed).normal(size=(t, d)).astype(
        np.float32))
    card = tmoe.MoE(d, cfg, device=device).requires_grad_(False)
    card.load_state_dict(cpu.state_dict())
    return cpu, card, x


def _tie_gap_ok(probs, k):
    """Tokens whose k-th and (k+1)-th router probabilities differ by more
    than 1e-5: there the two devices must route alike."""
    top = torch.sort(probs, dim=-1, descending=True).values
    return (top[:, k - 1] - top[:, k]) > 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n_experts,pad,top_k,d,f", [
    (64, 0, 8, 2048, 64),           # olmoe's router, a narrow expert
    (40, 48, 8, 1536, 32)])         # granite's, padded as at decode_32k
def test_moe_layer_on_card_matches_cpu(cuda_device, n_experts, pad, top_k,
                                       d, f):
    """256 tokens: router ids and the keep mask equal the CPU's wherever
    the k-th probability clears the next by 1e-5 (>= 99 % of tokens),
    outputs within 1e-4 there, and two card runs equal bit for bit (no
    float atomics in the combine)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as tmoe
    cfg = MoEConfig(n_experts=n_experts, top_k=top_k, d_ff=f,
                    pad_experts_to=pad)
    cpu, card, x = _moe_on_both(cfg, d, 256, cuda_device)
    xc = x.to(cuda_device)
    probs, _, ids, _, keep = tmoe.route(cpu, cfg, x)
    _, _, ids_c, _, keep_c = tmoe.route(card, cfg, xc)
    ok = _tie_gap_ok(probs, top_k)
    assert ok.float().mean() >= 0.99
    assert torch.equal(ids_c.cpu()[ok], ids[ok])
    assert torch.equal(keep_c.cpu().reshape(-1, top_k)[ok],
                       keep.reshape(-1, top_k)[ok])
    assert int(ids_c.max()) < n_experts
    out, aux = tmoe.moe_ffn(cpu, cfg, x)
    out_c, aux_c = tmoe.moe_ffn(card, cfg, xc)
    again, aux_again = tmoe.moe_ffn(card, cfg, xc)
    torch.testing.assert_close(out_c.cpu()[ok], out[ok], rtol=0, atol=1e-4)
    torch.testing.assert_close(aux_c.cpu(), aux, rtol=0, atol=1e-5)
    assert torch.equal(again, out_c) and torch.equal(aux_again, aux_c)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "olmoe-1b-7b"])
def test_lm_decode_on_card_matches_cpu(cuda_device, arch, kv_quant):
    """Smoke-size decode on the card (flash_decode, one launch a layer a
    tick) against the CPU: danube's ring past its window (a 40-token
    prompt, 8 ticks to 48) and olmoe's MoE, each with and without the
    int8 cache. Logits within 1e-4; the int8 payload within one step of
    the CPU's (values on a rounding edge), scales within 1e-5."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import dispatch
    from repro_torch.models import transformer as ttf
    cfg = dataclasses.replace(get_smoke_config(arch), kv_quant=kv_quant)
    cpu = ttf.init_lm(cfg, seed=0, device="cpu")
    card = ttf.LM(cfg, device=cuda_device).requires_grad_(False)
    card.load_state_dict(cpu.state_dict())
    toks = _t(np.random.default_rng(41).integers(
        0, cfg.vocab, size=(2, 40)).astype(np.int32))
    lens = _t(np.array([40, 31], np.int32))
    lc, cc = ttf.prefill(cpu, toks, max_len=48, prompt_lens=lens)
    lg, cg = ttf.prefill(card, toks, max_len=48, prompt_lens=lens)
    torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
    for _ in range(8):
        nxt = lc[:, 0].argmax(-1, keepdim=True)
        dispatch.reset()
        lc, cc = ttf.decode_step(cpu, nxt, cc)
        lg, cg = ttf.decode_step(card, nxt.to(cuda_device), cg)
        assert dispatch.get("kernel.flash_decode") == cfg.n_layers
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
    assert cg.k.shape[2] == ttf.cache_len(cfg, 48)
    if kv_quant:
        step = (cg.k.cpu().int() - cc.k.int()).abs()
        assert int(step.max()) <= 1
        torch.testing.assert_close(cg.k_scale.cpu(), cc.k_scale, rtol=1e-5,
                                   atol=0)


# ---------------------------------------------------------------------------
# the off-path models at their smoke configs, card against CPU
# ---------------------------------------------------------------------------
RECSYS_ARCHS = {"fm": "fm", "wide-deep": "wide_deep", "bert4rec": "bert4rec",
                "mind": "mind"}


def _recsys_outputs(kind, params, cfg, batch, device):
    from repro_torch.models import recsys as trs

    def t(name):
        return _t(batch[name]).to(device)

    if kind in ("fm", "wide_deep"):
        args = (t("sparse_ids"), t("dense"))
        return [getattr(trs, f"{kind}_forward")(params, cfg, *args),
                getattr(trs, f"{kind}_loss")(params, cfg, *args, t("labels"))]
    if kind == "bert4rec":
        seq = t("item_seq")
        return [trs.bert4rec_user_embedding(params, cfg, seq),
                trs.bert4rec_loss(params, cfg, seq, t("labels"),
                                  t("label_mask"))]
    return [trs.mind_user_embedding(params, cfg, t("behavior"),
                                    t("behavior_mask")),
            trs.mind_loss(params, cfg, t("behavior"), t("behavior_mask"),
                          t("target"), t("neg"))]


def _near(got, want):
    """Card against CPU within 1e-4 x max|value|."""
    want = want.float().cpu()
    tol = 1e-4 * max(want.abs().max().item(), 1e-30)
    assert (got.float().cpu() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(RECSYS_ARCHS))
def test_recsys_model_on_card_matches_cpu(cuda_device, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.flat import FlatIndex
    from repro_torch.data import synthetic
    from repro_torch.models import recsys as trs
    from repro_torch.models.common import tree_to

    kind, cfg = RECSYS_ARCHS[arch], get_smoke_config(arch)
    cpu = trs.INIT[kind](cfg, seed=0, device="cpu")
    card = tree_to(cpu, cuda_device)
    if kind in ("fm", "wide_deep"):
        batch = next(synthetic.ctr_batches(cfg.n_sparse, cfg.rows_per_field,
                                           cfg.n_dense, 64, seed=1))
    elif kind == "bert4rec":
        batch = next(synthetic.masked_item_batches(cfg.n_items, cfg.seq_len,
                                                   64, seed=2))
    else:
        batch = next(synthetic.seq_rec_batches(cfg.n_items, cfg.seq_len, 64,
                                               seed=3))
    for got, want in zip(_recsys_outputs(kind, card, cfg, batch, cuda_device),
                         _recsys_outputs(kind, cpu, cfg, batch, "cpu")):
        assert got.is_cuda and got.shape == want.shape
        _near(got, want)
    if kind == "mind":       # retrieval_cand: distance_topk at k 100
        interests = trs.mind_user_embedding(
            cpu, cfg, _t(batch["behavior"][:1]),
            _t(batch["behavior_mask"][:1]))[0].numpy()
        items = cpu["items"].numpy()
        kd, ki = FlatIndex.build(items, metric="ip", device=cuda_device) \
            .query(interests, k=100)
        rd, ri = FlatIndex.build(items, metric="ip", device="cpu") \
            .query(interests, k=100)
        err = (kd.cpu() - rd).abs()
        assert err.max().item() <= 1e-5
        assert bool(((ki.cpu() == ri) | (err <= 1e-6)).all())


@pytest.mark.cuda
def test_graphsage_on_card_matches_cpu(cuda_device):
    """The full-graph forward twice on the card, equal bit for bit (no
    float atomics) and near the CPU's; the sampler's ids on the card are
    CSR neighbours, and the sampled forward on them near the CPU's; the
    molecule forward near the CPU's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic
    from repro_torch.models import gnn as tgnn
    from repro_torch.models.common import tree_to

    cfg = get_smoke_config("graphsage-reddit")
    n, d, c = 300, 12, 4
    g = synthetic.make_graph(n, 5, d, c, seed=1)
    cpu = tgnn.init_sage(cfg, d, c, seed=0, device="cpu")
    card = tree_to(cpu, cuda_device)
    arrays = [_t(a) for a in (g.feats, g.edge_src, g.edge_dst)]
    want = tgnn.sage_full_forward(cpu, cfg, *arrays)
    runs = [tgnn.sage_full_forward(card, cfg,
                                   *(a.to(cuda_device) for a in arrays))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    _near(runs[0], want)
    rp, ci, feats = (_t(a).to(cuda_device)
                     for a in (g.row_ptr, g.col_idx, g.feats))
    seeds = torch.arange(0, n, 5, dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    (n1, n2), xs = tgnn.sample_tree(gen, rp, ci, feats, seeds,
                                    cfg.sample_sizes)
    for s, nb in ((seeds, n1), (n1.reshape(-1), n2)):
        s, nb = s.cpu().long(), nb.cpu().long()
        lo, hi = _t(g.row_ptr)[s].long(), _t(g.row_ptr)[s + 1].long()
        ok = [set(nb[i].tolist()) <= (set(g.col_idx[lo[i]:hi[i]].tolist())
                                     or {int(s[i])}) for i in range(len(s))]
        assert all(ok)
    _near(tgnn.sage_sampled_forward(card, cfg, *xs),
          tgnn.sage_sampled_forward(cpu, cfg, *(x.cpu() for x in xs)))
    mol = next(synthetic.molecule_batches(16, 30, 16, 2, seed=2))
    mcpu = tgnn.init_sage(cfg, 16, 2, seed=1, device="cpu")
    _near(tgnn.sage_molecule_forward(tree_to(mcpu, cuda_device), cfg,
                                     _t(mol["feats"]).to(cuda_device),
                                     _t(mol["adj"]).to(cuda_device)),
          tgnn.sage_molecule_forward(mcpu, cfg, _t(mol["feats"]),
                                     _t(mol["adj"])))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("fn", ["linear_f32", "linear", "bmm_f32"])
def test_products_train_on_card_as_on_cpu(cuda_device, fn, dtype):
    """The 16-bit products with fp32 sums (``models.common``): on the card
    one ``out_dtype`` product (``linear_f32``, ``bmm_f32``: the autograd
    ``_ProductF32``) or a 16-bit ``F.linear`` (``linear``), on the CPU
    the widened operands. Outputs and both gradients near the CPU's: the
    fp32 results within 1e-5 relative of the largest, the 16-bit ones
    (rounded once) within two of their ulps of the largest."""
    from repro_torch.models import common

    gen = torch.Generator().manual_seed(0)
    shapes = (((4, 33, 64), (4, 64, 48)) if fn == "bmm_f32" else
              ((2, 33, 64), (48, 64)))
    a, b = (torch.randn(s, generator=gen).to(dtype) for s in shapes)

    def run(dev):
        x = a.to(dev).requires_grad_(True)
        w = b.to(dev).requires_grad_(True)
        out = getattr(common, fn)(x, w)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            1)).to(dev, out.dtype)
        return (out,) + torch.autograd.grad(out, (x, w), g)

    ulp = 2.0 ** (-7 if dtype == torch.bfloat16 else -10)
    for got, want in zip(run(cuda_device), run("cpu")):
        assert got.dtype == want.dtype
        rel = 1e-5 if got.dtype == torch.float32 else 2 * ulp
        scale = want.float().abs().max().item()
        assert (got.cpu().float() - want.float()).abs().max().item() \
            <= rel * scale


def _train_pair(cuda_device, arch):
    """(step, CPU LM, card LM with the same weights, batches)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig, warmup_cosine
    from repro_torch.train.train_loop import make_train_step

    cfg = get_smoke_config(arch)
    cpu = tf.init_lm(cfg, seed=0, device="cpu")
    card = tf.LM(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    step = make_train_step(lambda p, tokens, labels: tf.lm_loss(
        p, tokens, labels), AdamWConfig(lr=warmup_cosine(1e-3, 2, 10)))
    data = lm_batches(cfg.vocab, 4, 33, seed=1)
    return step, cpu, card, [next(data) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b"])
def test_train_steps_on_card_match_cpu(cuda_device, arch):
    """Two ``make_train_step`` steps of a dense and an MoE smoke LM on the
    card and on the CPU from the same weights: losses and grad norms
    within 1e-5 relative; after the first step (the same weights, so m
    and v are the gradients' own) m and v within 1e-4 x max|leaf|; after
    the second the weights within 5e-2 x lr + 1e-6 x |p|
    (``tests/test_torch_train.py``'s bound against the reference)."""
    from repro_torch.models.common import named_tensors
    from repro_torch.train.train_loop import init_train_state

    step, cpu, card, batches = _train_pair(cuda_device, arch)
    sc, sd = init_train_state(cpu), init_train_state(card)
    for i, batch in enumerate(batches):
        _, sc, mc = step(cpu, sc, batch)
        _, sd, md = step(card, sd, batch)
        for key in ("loss", "grad_norm"):
            want = mc[key].item()
            assert abs(md[key].item() - want) <= 1e-5 * abs(want)
        for name in sc.m if i == 0 else ():
            for got, ref in ((sd.m[name], sc.m[name]),
                             (sd.v[name], sc.v[name])):
                assert (got.cpu() - ref).abs().max().item() <= \
                    1e-4 * ref.abs().max().item() + 1e-30, name
    want = dict(named_tensors(cpu))
    for name, p in named_tensors(card):
        w = want[name].detach()
        assert bool(((p.detach().cpu() - w).abs()
                     <= 5e-2 * 1e-3 + 1e-6 * w.abs()).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b"])
def test_train_step_on_card_is_bit_for_bit(cuda_device, arch):
    """The same step twice on the card from the same state: the same loss
    and grad norm, weights, m and v, bit for bit."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import named_tensors
    from repro_torch.train.train_loop import init_train_state

    step, cpu, card, batches = _train_pair(cuda_device, arch)
    twin = tf.LM(card.cfg, device=cuda_device)
    twin.load_state_dict(cpu.state_dict())
    runs = [step(m, init_train_state(m), batches[0]) for m in (card, twin)]
    (_, s0, m0), (_, s1, m1) = runs
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for (name, p), (_, q) in zip(named_tensors(card), named_tensors(twin)):
        assert torch.equal(p, q), name
        assert torch.equal(s0.m[name], s1.m[name]), name
        assert torch.equal(s0.v[name], s1.v[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["fm", "wide-deep", "bert4rec", "mind",
                                  "graphsage-reddit"])
def test_family_train_step_on_card_is_bit_for_bit(cuda_device, arch):
    """``launch.train.build``'s smoke run of each other family on the
    card, its first step twice from the same fresh state (the lookups'
    and gathers' gradients add repeated ids): the same loss, weights, m
    and v, bit for bit."""
    import argparse
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.common import named_tensors
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import init_train_state, make_train_step

    args = argparse.Namespace(seed=0, batch=64, seq=32, device=cuda_device)
    runs = []
    for _ in range(2):
        _, params, loss_fn, data = tlaunch.build(arch, "smoke", args)
        _, state, metrics = make_train_step(loss_fn, AdamWConfig())(
            params, init_train_state(params), next(data))
        runs.append((params, state, metrics))
    (p0, s0, m0), (p1, s1, m1) = runs
    assert torch.equal(m0["loss"], m1["loss"])
    for (name, a), (_, b) in zip(named_tensors(p0), named_tensors(p1)):
        assert torch.equal(a, b), name
        assert torch.equal(s0.m[name], s1.m[name]), name
        assert torch.equal(s0.v[name], s1.v[name]), name


# ---------------------------------------------------------------------------
# checkpoints, fault tolerance and the distributed training layer
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_checkpoint_of_card_tensors_restores_bit_equal(cuda_device,
                                                       tmp_path):
    """A smoke LM and its optimizer state on the card (fp32, and a bf16
    copy of the weights) saved async and restored onto the card: every
    leaf bit-equal, new tensors on the card; ``inplace`` into a fresh LM
    keeps its storage."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import CheckpointManager, tree_leaves
    from repro_torch.train.optimizer import adamw_init

    cfg = get_smoke_config("llama3-8b")
    model = tf.init_lm(cfg, seed=1, device=cuda_device)
    state = adamw_init(model)
    for t in state.m.values():
        t.normal_()
    half = tf.init_lm(cfg, seed=2, device=cuda_device, dtype=torch.bfloat16)
    tree = {"params": model, "opt": state, "half": half}
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save(3, tree)
    got, meta = ckpt.restore(tree)
    assert meta["step"] == 3 and meta["dtypes"]
    for (k, a), (_, b) in zip(tree_leaves(tree), tree_leaves(got)):
        assert b.is_cuda and b.dtype == a.dtype and torch.equal(a, b), k
        assert a.data_ptr() != b.data_ptr(), k
    fresh = tf.init_lm(cfg, seed=9, device=cuda_device)
    ptr = fresh.embed.weight.data_ptr()
    ckpt.restore({"params": fresh, "opt": adamw_init(fresh),
                  "half": tf.init_lm(cfg, seed=9, device=cuda_device,
                                     dtype=torch.bfloat16)}, inplace=True)
    assert fresh.embed.weight.data_ptr() == ptr
    assert torch.equal(fresh.embed.weight, model.embed.weight)


@pytest.mark.cuda
def test_run_resilient_on_card_is_bit_for_bit(cuda_device, tmp_path):
    """The reference's smoke setup on the card: failures at 3 (from
    scratch) and 7 (restored from step 5, async saves) replay to every
    loss, weight, m and v of the failure-free run, bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import CheckpointManager, tree_leaves
    from repro_torch.train.fault_tolerance import run_resilient
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import make_train_step

    cfg = get_smoke_config("llama3-8b")
    model = tf.init_lm(cfg, seed=0, device=cuda_device)
    step = make_train_step(lambda p, tokens, labels: tf.lm_loss(
        p, tokens, labels), AdamWConfig(lr=1e-3))

    def batch_fn(s):
        return next(lm_batches(cfg.vocab, 8, 33, seed=0, start_step=s))

    runs = []
    for name, fail in (("clean", []), ("fail", [3, 7])):
        p, s, info = run_resilient(
            model, step, batch_fn, steps=12, ckpt_every=5, fail_at=fail,
            ckpt=CheckpointManager(str(tmp_path / name), async_save=True))
        runs.append((dict(tree_leaves({"params": p, "opt": s})), info))
    (a, ia), (b, ib) = runs
    assert ia["restarts"] == 0 and ib["restarts"] == 2
    assert ia["losses"] == ib["losses"]
    for k, t in a.items():
        assert t.is_cuda and torch.equal(t, b[k]), k


@pytest.mark.cuda
def test_pipeline_on_card_equals_sequential_oracle(cuda_device):
    """Four llama smoke layers as four stages on ``cuda:0`` x 4 (stages
    sharing the card), 6 microbatches: the output and the gradients of
    its sum bit for bit against the layers run one after another."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), n_layers=4)
    model = tf.init_lm(cfg, seed=3, device=cuda_device)
    stacked, stage = tf.stack_layers(model), tf.layer_stage(cfg)
    x = torch.randn(6, 2, 16, cfg.d_model, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    mesh = Mesh((4,), ("pp",), device=cuda_device)

    def sequential(p, x):
        ps = [{k: v[s] for k, v in p.items()} for s in range(4)]
        out = []
        for m in range(x.shape[0]):
            h = x[m]
            for s in range(4):
                h = stage(ps[s], h)
            out.append(h)
        return torch.stack(out)

    def run(fn):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in stacked.items()}
        out = fn(leaves, x)
        return out.detach(), torch.autograd.grad(out.sum(),
                                                 list(leaves.values()))

    got = run(lambda p, x: pipeline_apply(mesh, "pp", stage, p, x))
    want = run(sequential)
    assert got[0].is_cuda and torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1003])
def test_compressed_psum_on_card_equals_cpu(cuda_device, n):
    """8 replicas on ``cuda:0``: every replica's result equal to the
    CPU's, bit for bit (the divisions are by tensors)."""
    from repro_torch.distributed.collectives import compressed_psum

    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(8, n)).astype(np.float32))
    cpu = compressed_psum(list(x))
    card = compressed_psum([r.to(cuda_device) for r in x])
    for c in card:
        assert c.is_cuda and torch.equal(c.cpu(), cpu[0])


def _count(arch_id, shape, device, n_layers=None):
    """``op_analysis``'s count of a dry-run cell at its published width on
    ``device`` (a one-card host mesh on the card)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis, steps
    from repro_torch.launch.mesh import make_host_mesh

    arch = dataclasses.replace(get_config(arch_id), shapes=(shape,))
    mesh = make_host_mesh(1, 1, device=None if device == "cuda" else device)
    cell = steps.cell_for(arch, shape, mesh, device=device,
                          n_layers=n_layers)
    return op_analysis.analyze(cell.fn, *cell.args)


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id,kind,dims,layers", [
    ("llama3-8b", "decode", {"seq_len": 2048, "global_batch": 8}, 1),
    ("mememo", "retrieval", {"batch": 16, "n_candidates": 100_000,
                             "dim": 384, "k": 10}, None),
    ("mememo", "retrieval", {"batch": 1, "n_candidates": 100_000,
                             "dim": 384, "k": 10}, None)])
def test_cell_counts_the_same_on_the_card_as_on_meta(cuda_device, arch_id,
                                                     kind, dims, layers):
    """A decode cell (bf16 flash_decode, every slot attending S) and the
    retrieval cells (distance_topk at both paths): the card's count of
    FLOPs and bytes equals the meta count exactly, each hand kernel is
    costed by its formula and launched, and nothing is uncosted."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import dispatch

    shape = ShapeSpec("cell", kind, dims)
    meta = _count(arch_id, shape, "meta", layers)
    dispatch.reset()
    card = _count(arch_id, shape, "cuda", layers)
    kernel = "flash_decode" if kind == "decode" else "distance_topk"
    assert dispatch.get(f"kernel.{kernel}") >= 1
    for key in ("flops", "flops_by_dtype", "bytes", "kernels", "uncosted",
                "collective_bytes"):
        assert card[key] == meta[key], key
    assert card["uncosted"] == {}
