"""Public wrappers for the kernel layer, dispatched by the tensors' device.

A CUDA tensor goes to the hand kernel (``kernels/csrc/*.cu``, built at
first use by ``kernels.build``); a CPU tensor goes to the plain PyTorch
version in ``kernels.ref``. There is no switch that sends CUDA tensors to
the plain version, and no build or launch failure is caught: a kernel
that cannot build or launch raises.

Each wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current stream, raises the
launch error, and bumps its ``kernel.<name>`` counter (core/dispatch.py)
on the kernel branch only, beside ``kernel.<name>.<codec>`` for the row
codec it read (fp32, bf16, int8; fp16 for ``flash_decode``).
``gather_distance``, ``beam_search`` and ``flat_topk`` take fp32, bf16
and int8 (+ fp32 scales) rows: one CUDA kernel per function, instantiated
per row type; ``greedy_descent`` is a second entry point of
``gather_distance``'s kernel source and counts as its launch;
``embedding_bag`` takes fp32 and bf16 tables; ``flash_decode`` takes q,
K and V of one float type (fp32, bf16 or fp16).
``select_neighbors`` is plain PyTorch on either device (the JAX package
keeps it jnp-only too).

Tensors on ``meta`` launch nothing: they have no device to compute on,
so the plain version runs there and allocates nothing. While an op
counter counts (``counting``; ``launch/op_analysis.py``), each entry
point reports its call to it with its arguments, and the counter costs
the call by the formula of the kernel's work and ignores the ops the
call runs inside (the plain version's, or the wrapper's own), so a
program counts the same on ``meta``, the CPU and the card; each launch
is reported too, so a launch outside a costed call cannot pass unseen.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.core import dispatch
from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# row dtype -> codec name (counter suffix, C symbol suffix)
CODEC_OF = {torch.float32: "fp32", torch.bfloat16: "bf16", torch.int8: "int8"}
_SYM_SUFFIX = {"fp32": "f32", "bf16": "bf16", "int8": "int8", "fp16": "f16"}
# flash_decode's q/K/V dtype -> its instance (counter suffix)
FLASH_CODEC_OF = {torch.float32: "fp32", torch.bfloat16: "bf16",
                  torch.float16: "fp16"}

# kernel name -> (C symbol, argtypes); a symbol with "{}" has one entry
# point per row codec
_SIGS = {
    "gather_distance": ("gather_distance_{}",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P]),
    "greedy_descent": ("greedy_descent_{}",
                       [_P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "beam_search": ("beam_search_{}",
                    [_P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P]),
    "flash_decode": ("flash_decode_{}",
                     [_P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    "flash_decode_wide": ("flash_decode_wide_{}",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "distance_topk": ("distance_topk",
                      [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "embedding_bag": ("embedding_bag_{}",
                      [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
}
# entry point -> the kernel (its library and launch counters) it belongs to
_KERNEL_OF = {"greedy_descent": "gather_distance",
              "flash_decode_wide": "flash_decode"}
_FNS: dict[tuple[str, str], tuple] = {}


def _kernel(name: str, codec: str):
    """-> (C function, error-string function) of entry point ``name`` for
    rows of ``codec``."""
    fns = _FNS.get((name, codec))
    if fns is None:
        lib = build.library(_KERNEL_OF.get(name, name))
        sym, argtypes = _SIGS[name]
        fn = getattr(lib, sym.format(_SYM_SUFFIX[codec]))
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fns = _FNS[(name, codec)] = (fn, err)
    return fns


def _launch(name: str, codec: str, *args) -> None:
    fn, err = _kernel(name, codec)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    kernel = _KERNEL_OF.get(name, name)
    dispatch.bump(f"kernel.{kernel}")
    dispatch.bump(f"kernel.{kernel}.{codec}")
    if _COUNTER is not None:
        _COUNTER.launch(kernel)


# the op counter told of every entry point's call and every launch, while
# one counts (``counting``)
_COUNTER = None


@contextlib.contextmanager
def counting(counter):
    """Report the entry points' calls (``counter.call(name, fn, args,
    kwargs)``, which runs the call) and the launches
    (``counter.launch(kernel)``) to ``counter`` inside the block."""
    global _COUNTER
    prev, _COUNTER = _COUNTER, counter
    try:
        yield counter
    finally:
        _COUNTER = prev


def _costed(fn):
    """An entry point whose calls go through the counting op counter."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if _COUNTER is None:
            return fn(*args, **kwargs)
        return _COUNTER.call(fn.__name__, fn, args, kwargs)
    return entry


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU or all on ``meta`` (no launch: the plain version computes
    nothing there); anything else raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"} or types == {"meta"}:
        return False
    devs = {t.device for t in tensors}
    if types == {"cuda"} and len(devs) == 1:
        return True
    raise ValueError(f"kernel inputs on mixed devices: {sorted(map(str, devs))}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _aligned16(t: torch.Tensor) -> int:
    """1 when the rows of the 2-D ``t`` can be read as 16-byte vectors:
    rows of a whole number of 16 bytes and a 16-byte-aligned base (a
    sliced view may not be)."""
    return int((t.shape[1] * t.element_size()) % 16 == 0
               and t.data_ptr() % 16 == 0)


def _metric_code(metric: str) -> int:
    if metric not in _ref.METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of "
                         f"{_ref.METRICS}")
    return 1 if metric == "l2" else 0


def _check_rows(vectors: torch.Tensor, scales: torch.Tensor | None) -> str:
    """The row table of a kernel -> its codec: fp32 and bf16 rows without
    scales, int8 rows with fp32 scales [N]; all contiguous."""
    codec = CODEC_OF.get(vectors.dtype)
    if codec is None:
        raise TypeError(f"vectors: expected one of {list(CODEC_OF)}, got "
                        f"{vectors.dtype}")
    _check(vectors, "vectors", vectors.dtype, 2)
    if (scales is not None) != (codec == "int8"):
        need = "need" if codec == "int8" else "take no"
        raise ValueError(f"{codec} rows {need} per-row scales")
    if scales is not None:
        _check(scales, "scales", torch.float32, 1)
        if scales.shape[0] != vectors.shape[0]:
            raise ValueError(f"scales {tuple(scales.shape)} for "
                             f"{vectors.shape[0]} rows")
    return codec


def _opt_ptr(t: torch.Tensor | None):
    return None if t is None else _ptr(t)


# ---------------------------------------------------------------------------
def _aligned_q(q: torch.Tensor) -> torch.Tensor:
    """``q`` itself, or a copy when a view's base is not 16-byte aligned:
    the kernels read a query's floats as float4."""
    return q if q.data_ptr() % 16 == 0 else q.clone()


@_costed
def gather_distance(vectors: torch.Tensor, q: torch.Tensor, ids: torch.Tensor,
                    *, metric: str = "cosine",
                    scales: torch.Tensor | None = None) -> torch.Tensor:
    """Fused gather + distance: vectors [N,D] (f32, bf16, or int8 with
    ``scales`` [N] decoding each row by a multiply), q [B,D] f32, ids
    [B,K] i32 -> [B,K] f32 (``1 - <q,x>`` for cosine/ip, squared L2 for
    l2). Callers pre-clip ids to [0, N) and mask invalid slots after the
    call. On the card a warp scores four of a query's pairs, the warps
    spread over the grid (``_gather_plan``)."""
    l2 = _metric_code(metric)
    tensors = (vectors, q, ids) if scales is None else (vectors, q, ids,
                                                         scales)
    if not _on_cuda(*tensors):
        return _ref.gather_distance_ref(vectors, q, ids, metric=metric,
                                        scales=scales)
    codec = _check_rows(vectors, scales)
    _check(q, "q", torch.float32, 2)
    _check(ids, "ids", torch.int32, 2)
    n, d = vectors.shape
    b, k = ids.shape
    if q.shape != (b, d):
        raise ValueError(f"q {tuple(q.shape)} does not match ids {b} x D {d}")
    out = torch.empty((b, k), dtype=torch.float32, device=q.device)
    if b * k:
        threads, blocks = _gather_plan(b, k, _sm_count(q.device))
        q = _aligned_q(q)
        with torch.cuda.device(q.device):
            _launch("gather_distance", codec, _ptr(vectors), _opt_ptr(scales),
                    _ptr(q), _ptr(ids), _ptr(out), b, k, d, n, l2,
                    _aligned16(vectors), threads, blocks, _stream(q))
    return out


_GATHER_MAX_WARPS = 8


def _gather_plan(b: int, k: int, sm_count: int) -> tuple[int, int]:
    """-> (threads, blocks) of a ``gather_distance`` launch. A warp scores
    four of one query's pairs, so a query takes ceil(K / 4) warps. A
    block takes the most warps (at most 8) that still leave at least one
    block an SM, so that B 8 x K 16 (32 warps) and B 1024 x K 5 (2,048)
    reach the SMs."""
    warps = b * -(-k // 4)
    w = _GATHER_MAX_WARPS
    while w > 1 and -(-warps // w) < sm_count:
        w //= 2
    return 32 * w, -(-warps // w)


@_costed
def greedy_descent(vectors: torch.Tensor, upper: torch.Tensor,
                   q: torch.Tensor, ep: torch.Tensor, ep_dist: torch.Tensor,
                   *, max_level: int, metric: str = "cosine",
                   scales: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The upper-layer greedy descent of an HNSW search: vectors [N,D]
    (f32, bf16, or int8 with ``scales`` [N]), upper [L,N,M] i32 (-1 pad),
    q [B,D] f32, ep [B] i32, ep_dist [B] f32 -> (ep, ep_dist) after
    descending layers ``max_level`` .. 1 (``max_level`` <= L), the
    result of ``core/hnsw.py``'s per-hop greedy loop layer by layer.

    On the card ONE launch of the descent kernel (every layer and hop on
    the device, no host sync), counted under ``kernel.gather_distance``
    and ``hnsw.descent_launches`` (each beside its ``.<codec>``);
    ``max_level`` 0 launches nothing and returns ``ep`` and ``ep_dist``
    as they are. On the CPU the plain version's lock-step loop, whose
    condition reads count under ``hnsw.host_syncs``."""
    l2 = _metric_code(metric)
    tensors = (vectors, upper, q, ep, ep_dist)
    if scales is not None:
        tensors += (scales,)
    if not _on_cuda(*tensors):
        stats = {}
        out = _ref.greedy_descent_ref(vectors, upper, q, ep, ep_dist,
                                      max_level=max_level, metric=metric,
                                      scales=scales, stats=stats)
        dispatch.bump("hnsw.host_syncs", stats["syncs"])
        return out
    codec = _check_rows(vectors, scales)
    _check(upper, "upper", torch.int32, 3)
    _check(q, "q", torch.float32, 2)
    _check(ep, "ep", torch.int32, 1)
    _check(ep_dist, "ep_dist", torch.float32, 1)
    n, d = vectors.shape
    layers, _, m = upper.shape
    b = q.shape[0]
    if upper.shape[1] != n or q.shape[1] != d or ep.shape != (b,) \
            or ep_dist.shape != (b,):
        raise ValueError("greedy_descent: inconsistent shapes")
    max_level = int(max_level)
    if not 0 <= max_level <= layers:
        raise ValueError(f"greedy_descent: max_level {max_level} outside "
                         f"[0, {layers}]")
    if b == 0 or max_level == 0:
        return ep, ep_dist
    vec = _aligned16(vectors)
    threads, ring, _, _ = _descent_plan(d, codec, m, vec)
    q = _aligned_q(q)
    out_ep = torch.empty_like(ep)
    out_d = torch.empty_like(ep_dist)
    with torch.cuda.device(q.device):
        _launch("greedy_descent", codec, _ptr(vectors), _opt_ptr(scales),
                _ptr(upper), _ptr(q), _ptr(ep), _ptr(ep_dist), _ptr(out_ep),
                _ptr(out_d), b, n, d, m, max_level, l2, vec, ring, threads,
                _stream(q))
    dispatch.bump("hnsw.descent_launches")
    dispatch.bump(f"hnsw.descent_launches.{codec}")
    return out_ep, out_d


_DESCENT_MAX_THREADS = 1024
_SM_THREADS = 2048
_SM_BLOCKS = 32


def _descent_layout_bytes(d: int, elem: int, m: int, ring: int) -> int:
    """Shared-memory bytes of a descent block, as the kernel lays them out
    (``descent_layout`` in gather_distance.cu): the ring of M rows when
    staged, the mbarrier, the list and its scales, and the warps' bests
    for two hops."""
    return (m * _r16(d * elem) if ring else 0) + 16 + 2 * _r16(m * 4) + 768


def _descent_plan(d: int, codec: str, m: int, vec: int
                  ) -> tuple[int, int, int, int]:
    """-> (threads, ring, shared bytes, blocks an SM) of a descent launch.

    One block a query: a warp scores four list slots, so ceil(M / 4)
    warps put every row of a hop in flight; past M 128 the block's 32
    warps take the list in rounds of 128 slots. The rows go to a shared
    ring (one bulk copy a row) when they are 16-byte rows and M of them
    fit a block's 227 KB; else they are read from global memory (``ring``
    0). Blocks an SM: what the SM's threads, blocks and shared memory
    allow (1 KB of each block's reserved). M < 1, or a list (its M ids
    and scales) past the block's shared memory, raises."""
    if codec not in _ELEM_BYTES:
        raise ValueError(f"unknown codec {codec!r}")
    elem = _ELEM_BYTES[codec]
    if m < 1 or _descent_layout_bytes(d, elem, m, 0) > _SMEM_BLOCK:
        raise ValueError(f"greedy_descent: M {m} outside [1, "
                         f"{DESCENT_MAX_M}] (a hop's list of M ids and M "
                         f"scales in a block's {_SMEM_BLOCK} bytes of "
                         "shared memory)")
    threads = min(_DESCENT_MAX_THREADS, 32 * -(-m // 4))
    ring = int(bool(vec) and _descent_layout_bytes(d, elem, m, 1)
               <= _SMEM_BLOCK)
    smem = _descent_layout_bytes(d, elem, m, ring)
    per_sm = min(_SM_BLOCKS, _SM_THREADS // threads,
                 _SMEM_SM // (smem + _SMEM_RESERVED))
    return threads, ring, smem, per_sm


@_costed
def beam_search(vectors: torch.Tensor, neighbors0: torch.Tensor,
                q: torch.Tensor, ep: torch.Tensor, ep_dist: torch.Tensor, *,
                ef: int, metric: str = "cosine",
                scales: torch.Tensor | None = None, expand_t: int = 4,
                max_iters: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole layer-0 ef-beam HNSW search in ONE launch: per hop, the top
    ``expand_t`` unexpanded beam entries expand together (neighbor gather,
    dedup, fused decode + row distance, merge). vectors [N,D] (f32, bf16,
    or int8 with ``scales`` [N]), neighbors0 [N,2M] i32, q [B,D],
    ep/ep_dist [B] -> (ids [B,ef] i32, dists [B,ef] f32) ascending by
    (d, id), empty slots (-1, INF). On the card the block shape and the
    rows in flight come from ``_beam_plan``; a shape no plan fits
    raises."""
    l2 = _metric_code(metric)
    tensors = (vectors, neighbors0, q, ep, ep_dist)
    if scales is not None:
        tensors += (scales,)
    if not _on_cuda(*tensors):
        return _ref.beam_search_ref(vectors, neighbors0, q, ep, ep_dist,
                                    ef=ef, metric=metric, scales=scales,
                                    expand_t=expand_t, max_iters=max_iters)
    codec = _check_rows(vectors, scales)
    _check(neighbors0, "neighbors0", torch.int32, 2)
    _check(q, "q", torch.float32, 2)
    _check(ep, "ep", torch.int32, 1)
    _check(ep_dist, "ep_dist", torch.float32, 1)
    n, d = vectors.shape
    m2 = neighbors0.shape[1]
    b = q.shape[0]
    if neighbors0.shape[0] != n or q.shape[1] != d or ep.shape != (b,) \
            or ep_dist.shape != (b,):
        raise ValueError("beam_search: inconsistent shapes")
    ef = int(ef)
    t, budget, hops = _ref.beam_schedule(ef, expand_t, max_iters)
    efp = _ref.next_pow2(ef)
    ids = torch.empty((b, ef), dtype=torch.int32, device=q.device)
    dists = torch.empty((b, ef), dtype=torch.float32, device=q.device)
    if b:
        threads, ring, _ = _beam_plan(b, d, codec, m2, ef, t,
                                      _sm_count(q.device))
        with torch.cuda.device(q.device):
            _launch("beam_search", codec, _ptr(vectors), _opt_ptr(scales),
                    _ptr(neighbors0), _ptr(q), _ptr(ep), _ptr(ep_dist),
                    _ptr(ids), _ptr(dists), b, n, d, m2, ef, efp, t, budget,
                    hops, l2, _aligned16(vectors), threads, ring, _stream(q))
    return ids, dists


# beam_search's block shapes: at most 512 threads (the kernel's launch
# bounds, 64 registers a thread, so 1,024 threads an SM), 2 candidate
# slots a thread a wave; the card's shared memory a block and an SM
# (H100: 227 KB a block of the SM's 228 KB, 1 KB of each block's
# reserved)
_BEAM_MAX_THREADS = 512
_BEAM_SM_THREADS = 1024
_SMEM_BLOCK = 232_448
_SMEM_SM = 233_472
_SMEM_RESERVED = 1024
_ELEM_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}
# the widest upper-layer list a descent block holds: M ids and M scales
# beside the mbarrier and the warps' bests (``_descent_layout_bytes``
# without the ring)
DESCENT_MAX_M = (_SMEM_BLOCK - 16 - 768) // 32 * 16 // 4


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def _beam_layout_bytes(d: int, elem: int, m2: int, ef: int, t: int,
                       threads: int, ring: int) -> int:
    """Shared-memory bytes of a ``beam_search`` block, as the kernel lays
    them out (``make_layout`` in beam_search.cu): the ring of ``ring``
    rows, two id tables (2^k >= 2 (ef + T 2M) slots of 4 bytes each), the
    kept candidates' keys, the mbarrier and two hops' counters, q, the
    beam's two buffers, the frontier mask, four candidate arrays and each
    warp's frontier nodes."""
    w = t * m2
    efp = _ref.next_pow2(ef)
    return (ring * _r16(d * elem) + _ref.next_pow2(2 * (ef + w)) * 8
            + _r16(w * 8) + 32 + _r16(d * 4) + 2 * _r16(efp * 12)
            + _r16(-(-efp // 32) * 4) + 4 * _r16(w * 4)
            + _r16(threads // 32 * t * 4))


def _beam_plan(b: int, d: int, codec: str, m2: int, ef: int, t: int,
               sm_count: int) -> tuple[int, int, int]:
    """-> (threads, ring rows, shared bytes) of a ``beam_search`` launch.

    One block a query. ``b`` queries over ``sm_count`` SMs want
    ceil(b / sm_count) blocks resident an SM (at most 8, rounded up to a
    power of two); threads are what the registers leave for that many
    (512 for 1 or 2, 256 for 4, 128 for 8), and each block takes an equal
    share of the SM's shared memory, up to 227 KB. A hop's T * 2M
    candidates go through the neighbour read and the dedup in waves of
    two a thread. The ring, the rows in flight at once, takes what the
    rest of the block leaves, up to the T * 2M candidates of a hop: a
    whole hop at B <= the SM count (192 KB for fp32 rows of 384 at T 4,
    2M 32). Fewer blocks an SM are tried when not one ring row fits; a
    shape where even one block an SM holds no row beside the search
    state (the id tables, 2^k >= 2 (ef + T 2M) slots of 8 bytes, and 24
    bytes a candidate) raises, naming that limit."""
    if codec not in _ELEM_BYTES:
        raise ValueError(f"unknown codec {codec!r}")
    elem = _ELEM_BYTES[codec]
    w = t * m2
    want = _ref.next_pow2(max(1, min(8, -(-b // max(1, sm_count)))))
    per_sm = want
    while per_sm >= 1:
        threads = min(_BEAM_MAX_THREADS, _BEAM_SM_THREADS // per_sm)
        budget = min(_SMEM_BLOCK, _SMEM_SM // per_sm - _SMEM_RESERVED)
        fixed = _beam_layout_bytes(d, elem, m2, ef, t, threads, 0)
        ring = min(w, max(0, budget - fixed) // _r16(d * elem))
        if ring >= 1:
            return threads, ring, fixed + ring * _r16(d * elem)
        per_sm //= 2
    raise ValueError(
        f"beam_search: no block shape fits D {d} {codec} rows with T {t} x "
        f"2M {m2} candidates a hop and ef {ef}: the search state "
        f"({_beam_layout_bytes(d, elem, m2, ef, t, _BEAM_MAX_THREADS, 0)} "
        f"bytes) and one row ({_r16(d * elem)}) exceed a block's "
        f"{_SMEM_BLOCK} bytes of shared memory")


def beam_search_info(b: int, d: int, codec: str, m2: int, ef: int, t: int,
                     *, vec: int = 1, device=None) -> dict:
    """The plan of a ``beam_search`` launch on the card beside what the
    built kernel reports for it: threads, ring rows, the plan's shared
    bytes and the kernel's own layout's, and blocks resident an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    threads, ring, smem = _beam_plan(b, d, codec, m2, ef, t,
                                     _sm_count(device))
    lib = build.library("beam_search")
    size = lib.beam_search_smem_bytes
    size.argtypes = [_I] * 7
    size.restype = ctypes.c_longlong
    occ = lib.beam_search_occupancy
    occ.argtypes = [_I, _I, _I, _I, ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    elem = _ELEM_BYTES[codec]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = occ(elem, d, vec, threads, smem, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"beam_search occupancy query failed (cudaError "
                           f"{rc})")
    return dict(threads=threads, ring_rows=ring, shared_bytes=smem,
                kernel_shared_bytes=int(size(d, elem, m2, ef, t, threads,
                                             ring)),
                blocks_per_sm=blocks.value)


def select_neighbors(vectors: torch.Tensor, q: torch.Tensor,
                     cand_ids: torch.Tensor, *, m: int,
                     metric: str = "cosine",
                     scales: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched HNSW neighbor-selection heuristic (Malkov Alg. 4 with the
    pruned-candidate backfill): vectors [N,D] (any codec dtype, ``scales``
    [N] decodes), q [B,D], cand_ids [B,C] i32 -1-pad -> (ids [B,m] i32
    -1-pad, dists [B,m] f32 INF-pad), per row output-identical to the host
    ``select_heuristic_host`` oracle.

    Plain PyTorch on every device, as the JAX package keeps it jnp-only:
    one [B,C,C] einsum (full fp32: it needs TF32 off, PyTorch's default)
    and a C-step masked keep-scan. It is no TPU kernel, so nothing counts
    its launches."""
    _metric_code(metric)
    if torch.backends.cuda.matmul.allow_tf32 and q.device.type == "cuda":
        raise RuntimeError("select_neighbors needs full-fp32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is set")
    return _ref.select_neighbors_ref(vectors, q, cand_ids, m=m,
                                     metric=metric, scales=scales)


_FLASH_WARPS = 8          # consumer warps of a flash_decode block, at most
_FLASH_MAX_DH = 1024      # the stream kernel's heads; wider ones go wide
_FLASH_HEAD = 16          # floats before a partial's acc: m[8], l[8]
# the wide kernel's heads: q and acc (2 Dh floats) + 16 in a block's 227 KB
FLASH_WIDE_MAX_DH = (_SMEM_BLOCK // 4 - 16) // 2


@_costed
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cur_len) -> torch.Tensor:
    """Decode attention: q [B,H,Dh], k/v [B,S,KVH,Dh] -> [B,H,Dh] f32.
    ``cur_len`` is a scalar or a per-sequence [B] vector of live prefix
    lengths (continuous batching: one launch serves slots at different
    depths), clamped to [0, S]. On the card q, k and v share one dtype,
    fp32, bf16 or fp16, and the kernel's instance for it reads them as
    they are (no cast: a 2-byte cache moves half the bytes); the scores,
    softmax and output are fp32, as the plain version's upcast.

    On the card one launch a call: the blocks split the live positions
    among themselves on the device (no host sync), and the last partial
    of each (b, KV head, head group) merges them. Heads wider than 1,024
    floats take the wide kernel of the same source (one block a query
    head, q and acc in shared memory; Dh past ``FLASH_WIDE_MAX_DH``
    raises). A contiguous int32 [B] ``cur_len`` on the device (the
    decode path's) is used as it is; the scratch is cached per device
    and stream, so ``out`` is the only allocation a call."""
    if not _on_cuda(q, k, v):
        return _ref.flash_decode_ref(q, k, v, cur_len)
    codec = FLASH_CODEC_OF.get(q.dtype)
    if codec is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: q, k and v must share one dtype of "
                        f"{sorted(FLASH_CODEC_OF.values())}; got q {q.dtype}, "
                        f"k {k.dtype}, v {v.dtype}")
    _check(q, "q", q.dtype, 3)
    _check(k, "k", q.dtype, 4)
    _check(v, "v", q.dtype, 4)
    b, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, s, kvh, dh) or v.shape != k.shape or h % kvh:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if dh > FLASH_WIDE_MAX_DH:
        raise ValueError(f"flash_decode: Dh {dh} > {FLASH_WIDE_MAX_DH} (a "
                         "head's q and acc in a block's shared memory)")
    if not (isinstance(cur_len, torch.Tensor) and cur_len.dtype == torch.int32
            and cur_len.shape == (b,) and cur_len.device == q.device
            and cur_len.is_contiguous()):
        cur_len = torch.as_tensor(cur_len, dtype=torch.int32,
                                  device=q.device).reshape(-1).expand(
                                      b).contiguous()
    if dh > _FLASH_MAX_DH:
        out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
        if b:
            with torch.cuda.device(q.device):
                _launch("flash_decode_wide", codec, _ptr(q), _ptr(k),
                        _ptr(v), _ptr(cur_len), _ptr(out), b, h, s, kvh, dh,
                        dh ** -0.5, _stream(q))
        return out
    vec = _flash_vec(dh, q.element_size(), q, k, v)
    gb, ng, grid = _flash_plan(h // kvh, dh, vec, q.device)
    part, _, tickets = _scratch(q, "flash_decode",
                                (grid + b * kvh * ng) * _FLASH_WARPS
                                * (_FLASH_HEAD + gb * dh), 0, b * kvh * ng)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    if b:
        with torch.cuda.device(q.device):
            _launch("flash_decode", codec, _ptr(q), _ptr(k), _ptr(v),
                    _ptr(cur_len), _ptr(out), _ptr(part), _ptr(tickets), b,
                    h, s, kvh, dh, gb, ng, vec, grid, _FLASH_WARPS,
                    dh ** -0.5, _stream(q))
    return out


def _flash_vec(dh: int, elem: int, *tensors: torch.Tensor) -> int:
    """1 when a row of ``dh`` elements of ``elem`` bytes is a whole number
    of 16 bytes and every tensor is 16-byte aligned: the bulk-copy ring
    and 4-element lane reads (Dh % 4 == 0 in fp32, Dh % 8 == 0 in bf16
    and fp16); else the element-by-element instance."""
    return int((dh * elem) % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _flash_plan(g: int, dh: int, vec: int, device) -> tuple[int, int, int]:
    """-> (gb, ng, grid) of a ``flash_decode`` launch: the query heads of
    a KV head go in ``ng`` groups of ``gb`` (a power of two <= 8, with
    gb x the lane columns' width <= 1024 floats, so that a lane's q and
    acc stay in registers; 1 on the element-by-element path), and the
    grid is one block per SM, each taking an equal share of the live
    tiles."""
    if vec:
        width = 128 * (1 << max(0, -(-dh // 128) - 1).bit_length())
        gb = min(1 << max(0, g - 1).bit_length(), 8, 1024 // width)
    else:
        gb = 1
    return gb, -(-g // gb), _sm_count(device)


def _sm_count(device) -> int:
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


# row dtype -> distance_topk's dtype code (0 f32, 1 bf16, 2 int8)
_ROW_DTYPES = {dt: i for i, dt in enumerate(CODEC_OF)}
TOPK_PASS_K = 256         # list slots the kernel keeps per query: one pass
TOPK_SMALL_B = 8          # B <= this takes the streaming path
_TOPK_MIN_GROUPS = 8      # row groups a streaming block takes at least
_TOPK_BQ = 64             # queries of a tensor-core tile (B > 8)
_SMS: dict[torch.device, int] = {}
_SCRATCH: dict[tuple, list] = {}


def _topk_plan(b: int, n: int, device) -> tuple[int, int, int]:
    """-> (small, splits, rows_per_split) of one ``distance_topk`` launch.

    B <= 8 takes the streaming path (``small``): one block per SM at
    most, each owning ``rows_per_split`` rows, a whole number of its
    warps' row groups (8 rows for B 1..4, 4 rows for B 5..8, so that a
    group holds 32 or fewer (row, query) sums) and at least 8 groups.
    Larger B takes the tensor-core tile of 64 queries x 128 rows, its N
    rows cut into ranges of whole tiles so that the grid is one wave of
    two blocks per SM (the tile's residency at k <= 32): longer ranges,
    so fewer of a range's tiles beat its lists' k-th entries. Each
    range's block leaves k partials per query, which the last block of
    its query tile merges in the same launch."""
    sms = _sm_count(device)
    if b <= TOPK_SMALL_B:
        rg = 8 if b <= 4 else 4
        groups = -(-n // rg)
        blocks = max(1, min(sms, -(-groups // _TOPK_MIN_GROUPS)))
        rows = -(-groups // blocks) * rg
        return 1, -(-n // rows), rows
    bn = 128
    tiles = -(-n // bn)
    splits = max(1, min(tiles, -(-2 * sms // -(-b // _TOPK_BQ))))
    rows = -(-tiles // splits) * bn
    return 0, -(-n // rows), rows


def _scratch(q: torch.Tensor, kernel: str, floats: int, ints: int,
             tickets: int) -> list:
    """-> [float buffer, int32 buffer, tickets] of at least the sizes
    asked, for ``kernel``'s launches on ``q``'s device and current stream,
    kept between calls (launches on one stream run in order). The
    zeroed int32 ticket counters are the kernels' fused merges: the last
    block (or warp) to finish a tile or group merges its partials and
    sets its counter back to 0, so the counters are zeroed once and
    reused by every later launch."""
    key = (kernel, q.device, torch.cuda.current_stream(q.device).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf[0].numel() < floats or buf[1].numel() < ints \
            or buf[2].numel() < tickets:
        old = [0, 0, 16] if buf is None else [t.numel() for t in buf]
        n = [max(floats, old[0]), max(ints, old[1]), max(tickets, old[2])]
        buf = _SCRATCH[key] = [
            torch.empty(n[0], dtype=torch.float32, device=q.device),
            torch.empty(n[1], dtype=torch.int32, device=q.device),
            torch.zeros(n[2], dtype=torch.int32, device=q.device)]
    return buf


def topk_in_passes(run_pass, b: int, k: int, device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best (d, id) of B queries in ceil(k / 256) passes of at most
    256 each: ``run_pass(out_d, out_i, after)`` fills the [B, kp] column
    views with the kp best entries strictly after ``after`` = (d [B],
    id [B]), the previous pass's last column (None for the first pass).
    The order is strict on (d, id), so ties across a pass boundary stay
    exact. Device-agnostic: ``flat_topk`` runs the kernel through it on
    the card, the tests the plain version on the CPU."""
    out_d = torch.empty((b, k), dtype=torch.float32, device=device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=device)
    if k <= TOPK_PASS_K:
        run_pass(out_d, out_i, None)
        return out_d, out_i
    for c0 in range(0, k, TOPK_PASS_K):
        c1 = min(k, c0 + TOPK_PASS_K)
        after = None if c0 == 0 else (out_d[:, c0 - 1], out_i[:, c0 - 1])
        run_pass(out_d[:, c0:c1], out_i[:, c0:c1], after)
    return out_d, out_i


@_costed
def flat_topk(db: torch.Tensor, q: torch.Tensor, k: int, *,
              metric: str = "cosine", scales: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: db [N,D] (f32, bf16, or int8 with ``scales`` [N] f32
    decoding each row by a multiply), q [B,D] f32 -> (dists [B,k] f32,
    ids [B,k] i32), ascending by (d, id); 1 <= k <= N.

    On the card a search of k <= 256 is one launch: the blocks scan row
    ranges and the last one to finish merges their lists into the
    result. Larger k runs ``topk_in_passes``: ceil(k / 256) launches,
    each writing its columns of the result in place."""
    l2 = _metric_code(metric)
    tensors = (db, q) if scales is None else (db, q, scales)
    if not _on_cuda(*tensors):
        return _ref.distance_topk_ref(db, q, k, metric=metric, scales=scales)
    codec = _check_rows(db, scales)
    _check(q, "q", torch.float32, 2)
    n, d = db.shape
    b = q.shape[0]
    if q.shape[1] != d:
        raise ValueError(f"q {tuple(q.shape)} does not match db "
                         f"{tuple(db.shape)}")
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"flat_topk: k={k} needs 1 <= k <= N={n}")
    if b == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    small, splits, rows = _topk_plan(b, n, q.device)
    entries = b * splits * min(k, TOPK_PASS_K)
    part_d, part_i, tickets = _scratch(
        q, "distance_topk", entries, entries,
        1 if small else -(-b // _TOPK_BQ))

    def run_pass(out_d, out_i, after):
        ad, ai = (None, None) if after is None else after
        with torch.cuda.device(q.device):
            _launch("distance_topk", codec, _ptr(db), _opt_ptr(scales),
                    _ptr(q), _ptr(out_d), _ptr(out_i), out_d.stride(0),
                    _opt_ptr(ad), _opt_ptr(ai), 0 if ad is None
                    else ad.stride(0), _ptr(part_d), _ptr(part_i),
                    _ptr(tickets), b, n, d, out_d.shape[1], splits, rows,
                    l2, _ROW_DTYPES[db.dtype], small, _aligned16(db),
                    _stream(q))

    return topk_in_passes(run_pass, b, k, q.device)


@_costed
def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor | None = None, *,
                  combine: str = "sum") -> torch.Tensor:
    """EmbeddingBag: table [R,E] (f32 or bf16), ids [B,L] i32, weights
    [B,L] f32 or None -> bags [B,E] f32, ``sum`` or ``mean`` (by L, or by
    ``max(sum w, 1e-9)`` with weights). Ids must lie in [0, R): the
    kernel, like the TPU's, does not range-check them. On the card a
    bag's members split over ``_bag_plan``'s warps."""
    if combine not in ("sum", "mean"):
        raise ValueError(f"unknown combine {combine!r}; expected 'sum' or "
                         "'mean'")
    tensors = (table, ids) if weights is None else (table, ids, weights)
    if not _on_cuda(*tensors):
        return _ref.embedding_bag_ref(table, ids, weights, combine=combine)
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table: expected float32 or bfloat16, got "
                        f"{table.dtype}")
    _check(table, "table", table.dtype, 2)
    _check(ids, "ids", torch.int32, 2)
    if weights is not None:
        _check(weights, "weights", torch.float32, 2)
        if weights.shape != ids.shape:
            raise ValueError(f"weights {tuple(weights.shape)} do not match "
                             f"ids {tuple(ids.shape)}")
    b, l = ids.shape
    e = table.shape[1]
    out = torch.empty((b, e), dtype=torch.float32, device=table.device)
    if b and e:
        splits = _bag_plan(b, l, e, _sm_count(table.device))
        with torch.cuda.device(table.device):
            _launch("embedding_bag", CODEC_OF[table.dtype], _ptr(table),
                    _ptr(ids), _opt_ptr(weights), _ptr(out), b, l, e,
                    int(combine == "mean"), _aligned16(table), splits,
                    _stream(table))
    return out


_BAG_WARPS = 8            # warps of an embedding_bag block
_BAG_SM_WARPS = 32        # warps an SM the plan aims to fill
_BAG_SPLIT_SMEM = 48 * 1024


def _bag_plan(b: int, l: int, e: int, sm_count: int) -> int:
    """-> the warps a bag of an ``embedding_bag`` launch (1, 2, 4 or 8).
    A warp takes a whole bag when B warps fill the card (32 an SM); a
    smaller batch splits each bag's L members over more warps of one
    block, while every warp keeps at least two members and the block's
    partial sums (8 x (E + 1) floats) fit 48 KB of shared memory."""
    splits = 1
    while (splits < _BAG_WARPS and b * splits < _BAG_SM_WARPS * sm_count
           and 2 * (2 * splits) <= l            # two members a warp
           and _BAG_WARPS * (e + 1) * 4 <= _BAG_SPLIT_SMEM):
        splits *= 2
    return splits
