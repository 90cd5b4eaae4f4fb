"""Op-level cost analysis of a PyTorch program, the port's counterpart of
``repro/launch/hlo_analysis.py``.

No torch program emits HLO, so nothing is parsed. ``analyze(fn, *args,
**kwargs)`` runs ``fn`` once under a ``TorchDispatchMode``, which sees
every aten op the eager program dispatches: the forward and autograd's
backward alike, every trip of a Python loop, a checkpointed block's
recompute. It rolls them up into:

  flops             products by ``torch.utils.flop_counter``'s registered
                    formulas (mm, bmm, addmm, baddbmm, convolution, SDPA);
                    an elementwise op one a result element; a reduction,
                    sort, scan, softmax or accumulating scatter one an
                    element it reads (the reference counts its
                    ``_ELEMWISE`` ops and its reduce and sort so).
  flops_by_dtype    the same keyed by the units they run on: "bf16" and
                    "fp16" (tensor-core products), "tf32" (an fp32 product
                    while ``torch.backends.cuda.matmul.allow_tf32`` is
                    set), "fp32" (other fp32 products, and every operation
                    outside the tensor cores).
  bytes             each op's tensor operands plus its results (the
                    elements a stride reaches), views and allocations
                    free; a gather reads and writes its result rows; an
                    in-place indexed write (``index_put_``, ``scatter_``
                    ...) reads and writes its update; ``copy_`` reads its
                    source and writes its destination. Every eager op is
                    a kernel boundary, so this is the analogue of the
                    reference's fusion-boundary bytes: an upper bound on
                    HBM traffic.
  collective_bytes  bytes copied between two distinct accelerator
  collectives       devices, by op: what the one-process port moves where
                    the reference runs collectives (the sharded merge's
                    peer copies). A ``meta`` run holds every tensor on one
                    device, so there it is 0.
  peak_live_bytes   the peak of the bytes of live tensor storages during
                    ``fn``, its inputs included.
  uncosted          op names with no formula, with their counts: the
                    analogue of the reference's ``dynamic_whiles``, a flag
                    that the count is incomplete.
  kernels           hand-kernel entry points costed by formula, by name.

Hand kernels. Each entry point of ``kernels/ops.py`` reports its call
(``ops.counting``); ``FORMULAS`` costs it by the work the kernel
computes, distinct bytes read once and written once and its operations
(the bounds ``chip_smoke.py`` prints), and the ops inside the call (the
plain version's, or the wrapper's own) are ignored, so a program counts
the same on ``meta``, the CPU and the card. Where the work depends on
values a ``meta`` tensor lacks, a formula takes the shape's full extent
(``flash_decode``'s live prefix is the cache's S). An entry point with no
formula (``greedy_descent`` and ``beam_search``, whose hops depend on the
data) and a launch outside a costed call show up in ``uncosted``.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

aten = torch.ops.aten

# views and allocations: no bytes, no operations
_FREE = {aten._unsafe_view, aten.empty, aten.empty_strided, aten.empty_like,
         aten.new_empty, aten.new_empty_strided, aten.lift_fresh,
         aten.detach, aten.alias, aten.resize_, aten.set_}
# ops that move data and compute nothing
_MOVES = {aten.clone, aten._to_copy, aten.copy_, aten.copy, aten.cat,
          aten.stack, aten.index, aten.index_select, aten.gather,
          aten.embedding, aten.scatter, aten.index_put, aten.fill_,
          aten.fill, aten.zero_, aten.zeros_like, aten.ones_like,
          aten.full_like, aten.full, aten.zeros, aten.ones, aten.arange,
          aten.scalar_tensor, aten.lift_fresh_copy, aten.constant_pad_nd,
          aten.roll, aten.flip, aten.repeat, aten.slice_scatter,
          aten.select_scatter, aten.new_zeros, aten.new_ones,
          aten.new_full, aten.tril, aten.triu, aten.masked_fill,
          aten.rand, aten.randn, aten.normal_, aten.uniform_,
          aten.randint, aten.bernoulli_, aten.index_copy_, aten.scatter_,
          aten.index_put_, aten.searchsorted, aten.one_hot,
          aten.repeat_interleave, aten.as_strided_scatter,
          aten.masked_fill_, aten.select_backward, aten.slice_backward}
# gathers: they touch their result's rows, not their whole source
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# in-place indexed writes -> the position of their update operand
_SCATTERS = {aten.index_put_: 2, aten.scatter_: 3, aten.scatter_add_: 3,
             aten.index_add_: 3, aten.index_copy_: 3}
# one operation an element read (reductions without the tag, scans,
# sorts, softmax, accumulating scatters) -> the position of that operand
_PER_READ = {aten.sort: 0, aten.topk: 0, aten.cumsum: 0, aten.cumprod: 0,
             aten._softmax: 0, aten._log_softmax: 0,
             aten._softmax_backward_data: 0,
             aten._log_softmax_backward_data: 0, aten.logsumexp: 0,
             aten.linalg_vector_norm: 0, aten.native_layer_norm: 0,
             aten.native_layer_norm_backward: 0, aten.segment_reduce: 0,
             aten._segment_reduce_backward: 0,
             aten.embedding_dense_backward: 0, aten.scatter_add: 3,
             aten.scatter_add_: 3, aten.index_add: 3, aten.index_add_: 3,
             aten.nll_loss_forward: 0, aten.nll_loss_backward: 0,
             aten.argsort: 0}
# elementwise ops without the pointwise tag: one operation a result element
_ELEMWISE = {aten.floor_divide}
_PRODUCT_OPERAND = {aten.addmm: 1, aten.baddbmm: 1}
_UNITS = {torch.bfloat16: "bf16", torch.float16: "fp16"}


# ---------------------------------------------------------------------------
# Hand-kernel formulas: distinct bytes read once and written once, and the
# operations by the units they run on
# ---------------------------------------------------------------------------
def flash_decode_work(b: int, h: int, kvh: int, dh: int, live: int,
                      elem: int) -> tuple[float, dict]:
    """``flash_decode`` on q [B,H,Dh] and K/V [B,S,KVH,Dh] of ``elem``
    bytes, ``live`` positions summed over the batch: the live K and V
    rows, q, the fp32 output and ``cur_len`` once each; 4 H Dh operations
    a live position on the CUDA cores (2-byte elements are widened)."""
    return (float(live * kvh * dh * elem * 2 + b * h * dh * (elem + 4)
                  + b * 4), {"fp32": 4.0 * live * h * dh})


def flat_topk_work(n: int, d: int, elem: int, scaled: bool, b: int,
                   k: int) -> tuple[float, dict]:
    """``flat_topk`` of B queries over N rows of D ``elem``-byte elements
    (int8 rows ``scaled``): the rows, scales and queries read once, k fp32
    distances and k int32 ids a query written once. Operations: 2 B N D
    on the CUDA cores at B <= 8 (the streaming path); above, the
    tensor-core path's split-TF32 products, 3 x 2 B N D for fp32 rows and
    2 x for bf16 and int8 rows (exact in TF32)."""
    nbytes = float(n * d * elem + (n * 4 if scaled else 0) + b * d * 4
                   + b * k * 8)
    if b <= ops.TOPK_SMALL_B:
        return nbytes, {"fp32": 2.0 * b * n * d}
    return nbytes, {"tf32": (3 if elem == 4 else 2) * 2.0 * b * n * d}


def gather_distance_work(rows: int, d: int, elem: int, scaled: bool, b: int,
                         k: int) -> tuple[float, dict]:
    """``gather_distance`` of B x K pairs reading ``rows`` distinct rows:
    each row (+ scale) once, q, the ids and the output; a multiply-add an
    element, plus the decode multiply under int8."""
    return (float(rows * (d * elem + (4 if scaled else 0)) + b * d * 4
                  + b * k * 8), {"fp32": (3.0 if scaled else 2.0) * b * k * d})


def embedding_bag_work(rows: int, members: int, b: int, l: int, e: int,
                       elem: int, weighted: bool) -> tuple[float, dict]:
    """``embedding_bag`` of B bags of L ids over a table of E-wide rows of
    ``elem`` bytes: the ``rows`` distinct rows the ``members`` that count
    read, the ids (and weights) and the fp32 output; a multiply-add an
    element of a member."""
    return (float(rows * e * elem + b * l * (8 if weighted else 4)
                  + b * e * 4), {"fp32": 2.0 * members * e})


def _known(*tensors) -> bool:
    """True when the tensors hold values (not ``meta``)."""
    return all(t.device.type != "meta" for t in tensors)


def _distinct(ids: torch.Tensor, rows: int) -> int:
    if not _known(ids):
        return min(ids.numel(), rows)
    return torch.unique(ids).numel()


def _flash_decode(q, k, v, cur_len):
    b, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    lens = torch.as_tensor(cur_len)
    if _known(lens):
        live = int(torch.clamp(lens.reshape(-1).expand(b), 0, s).sum())
    else:
        live = b * s
    return flash_decode_work(b, h, kvh, dh, live, q.element_size())


def _flat_topk(db, q, k, *, metric="cosine", scales=None):
    n, d = db.shape
    return flat_topk_work(n, d, db.element_size(), scales is not None,
                          q.shape[0], int(k))


def _gather_distance(vectors, q, ids, *, metric="cosine", scales=None):
    n, d = vectors.shape
    b, k = ids.shape
    return gather_distance_work(_distinct(ids, n), d, vectors.element_size(),
                                scales is not None, b, k)


def _embedding_bag(table, ids, weights=None, *, combine="sum"):
    b, l = ids.shape
    r, e = table.shape
    if weights is not None and _known(weights, ids):
        live = weights > 0
        rows, members = torch.unique(ids[live]).numel(), int(live.sum())
    else:
        rows, members = _distinct(ids, r), b * l
    return embedding_bag_work(rows, members, b, l, e, table.element_size(),
                              weights is not None)


# entry point of kernels/ops.py -> its work (nbytes, {units: operations})
FORMULAS = {"flash_decode": _flash_decode, "flat_topk": _flat_topk,
            "gather_distance": _gather_distance,
            "embedding_bag": _embedding_bag}


# ---------------------------------------------------------------------------
def _bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t``'s strides reach (a broadcast dim of
    stride 0 is one element)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``: nested dicts, lists, tuples and
    dataclasses (a ``KVCache``), and the parameters and buffers of its
    modules."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _units(t: torch.Tensor) -> str:
    if t.dtype in _UNITS:
        return _UNITS[t.dtype]
    if t.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "fp32"


@dataclasses.dataclass
class OpCounts:
    flops_by_dtype: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: float = 0.0
    collectives: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    uncosted: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    kernels: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    live_bytes: int = 0
    peak_live_bytes: int = 0


class OpCounter(TorchDispatchMode):
    """The dispatch mode behind ``analyze``, and the op counter that
    ``kernels.ops`` reports its entry points' calls and launches to."""

    def __init__(self):
        super().__init__()
        self.counts = OpCounts()
        self._inside = 0            # depth of costed entry-point calls
        self._live: dict[int, int] = {}
        self._refs: dict[int, object] = {}

    # -- storages --------------------------------------------------------
    def track(self, tree) -> None:
        """Count the storages of the tensors of ``tree`` as live until
        they are freed."""
        c = self.counts
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            c.live_bytes += st.nbytes()

            def freed(_, key=key):
                self.counts.live_bytes -= self._live.pop(key, 0)
                self._refs.pop(key, None)

            self._refs[key] = weakref.ref(st, freed)
        c.peak_live_bytes = max(c.peak_live_bytes, c.live_bytes)

    # -- the hooks of kernels/ops.py -------------------------------------
    def call(self, name: str, fn, args, kwargs):
        self._inside += 1           # the formula's own ops count nothing
        try:
            if self._inside == 1:
                self._cost_call(name, args, kwargs)
            out = fn(*args, **kwargs)
        finally:
            self._inside -= 1
        if self._inside == 0:
            self.track(out)
        return out

    def _cost_call(self, name: str, args, kwargs) -> None:
        formula = FORMULAS.get(name)
        if formula is None:
            self.counts.uncosted[f"ops.{name}"] += 1
            return
        nbytes, flops = formula(*args, **kwargs)
        self.counts.bytes += nbytes
        self.counts.flops_by_dtype.update(flops)
        self.counts.kernels[name] += 1

    def launch(self, kernel: str) -> None:
        if self._inside == 0:
            self.counts.uncosted[f"kernel.{kernel}"] += 1

    # -- every aten op ---------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _meta_key(func, args, kwargs)
        hit = _META.get(key) if key is not None else None
        if hit is None:
            out = func(*args, **kwargs)
            cost = _op_cost(func, args, kwargs, out)
            if key is not None:
                _META[key] = (_template(out), cost)
        else:
            template, cost = hit
            out = _rebuild(template)
        if self._inside == 0:
            self._add(cost)
            self.track(out)
        return out

    def _add(self, cost) -> None:
        nbytes, unit, flops, peer, uncosted = cost
        c = self.counts
        c.bytes += nbytes
        if flops:
            c.flops_by_dtype[unit] += flops
        if peer:
            c.collectives[peer[0]] += peer[1]
        if uncosted:
            c.uncosted[uncosted] += 1


def _op_cost(func, args, kwargs, out):
    """-> (bytes, units, operations, (op, peer-copy bytes) or None, the
    op's name when it has no formula, else None) of one aten op."""
    packet = func.overloadpacket
    outs = _tensors(out)
    if func.is_view or packet in _FREE or not outs and packet not in _SCATTERS:
        return 0, None, 0, None, None
    ins = _tensors((args, kwargs))
    # bytes
    if packet in _GATHERS:
        idx = sum(_bytes(t) for t in ins[1:] if not t.is_floating_point())
        nbytes = 2 * sum(_bytes(t) for t in outs) + idx
    elif packet in _SCATTERS:
        pos = _SCATTERS[packet]
        upd = args[pos] if len(args) > pos else None
        upd_b = _bytes(upd) if isinstance(upd, torch.Tensor) else 0
        nbytes = 2 * upd_b + sum(_bytes(t) for t in _tensors(args[1:pos]))
    elif packet is aten.copy_:
        nbytes = _bytes(args[0]) + _bytes(args[1])
    elif packet in (aten.fill_, aten.zero_):
        nbytes = _bytes(args[0])
    else:
        nbytes = sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs)
    # peer copies between two accelerator devices
    peer = None
    if packet in (aten._to_copy, aten.copy_) and ins and outs:
        src, dst = ins[-1].device, outs[0].device
        if src != dst and src.type == dst.type and src.type not in (
                "cpu", "meta"):
            peer = (str(packet), _bytes(outs[0]))
    # operations
    if packet in flop_registry:
        operand = ins[_PRODUCT_OPERAND.get(packet, 0)]
        # mm/bmm's out_dtype overload: the formula takes the operands
        operands = [a for a in args if not isinstance(a, torch.dtype)]
        return (nbytes, _units(operand),
                flop_registry[packet](*operands, **kwargs, out_val=out),
                peer, None)
    if packet in _PER_READ:
        pos = _PER_READ[packet]
        src = args[pos] if len(args) > pos else None
        n = src.numel() if isinstance(src, torch.Tensor) else 0
        return nbytes, "fp32", n, peer, None
    if torch.Tag.reduction in func.tags:
        return nbytes, "fp32", ins[0].numel() if ins else 0, peer, None
    if torch.Tag.pointwise in func.tags or packet in _ELEMWISE:
        return nbytes, "fp32", sum(t.numel() for t in outs), peer, None
    return nbytes, None, 0, peer, None if packet in _MOVES else str(packet)


# ---------------------------------------------------------------------------
# A meta op's result and cost follow from its inputs' shapes alone, so a
# repeated op (a layer's, an attention block's) is computed once: its
# outputs are rebuilt from the first call's metadata.
# ---------------------------------------------------------------------------
_META: dict = {}
_ATOMS = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


class _Uncached(Exception):
    pass


def _sig(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Uncached
        return (x.shape, x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, _ATOMS):
        return type(x), x
    if isinstance(x, (list, tuple)):
        return type(x), tuple(_sig(v) for v in x)
    raise _Uncached


def _meta_key(func, args, kwargs):
    """A key of a functional op on ``meta`` (its outputs new storages on
    ``meta``: meta tensor inputs, or a factory asked for ``meta``), else
    None."""
    if func.is_view or func._schema.is_mutable or \
            func.overloadpacket in _FREE:
        return None
    try:
        key = (func, _sig(args), _sig(tuple(kwargs.items())),
               torch.backends.cuda.matmul.allow_tf32)      # _units
    except _Uncached:                   # a tensor off meta, or an object
        return None
    dev = kwargs.get("device")
    if _tensors(args) or dev is not None and torch.device(dev).type == "meta":
        return key
    return None                         # a factory for another device


def _template(out):
    if isinstance(out, torch.Tensor):
        return ("T", out.shape, out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), tuple(_template(o) for o in out))
    return ("V", out)


def _rebuild(t):
    if t[0] == "T":
        return torch.empty_strided(t[1], t[2], dtype=t[3], device="meta")
    if t[0] == "V":
        return t[1]
    vals = tuple(_rebuild(x) for x in t[1])
    return vals if t[0] is tuple else list(vals) if t[0] is list \
        else t[0](vals)


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under the counter -> the counts
    (module docstring) and ``out``, what ``fn`` returned."""
    counter = OpCounter()
    counter.track((args, kwargs))
    with ops.counting(counter), counter:
        out = fn(*args, **kwargs)
    c = counter.counts
    return {
        "flops": float(sum(c.flops_by_dtype.values())),
        "flops_by_dtype": {k: float(v) for k, v in
                           sorted(c.flops_by_dtype.items())},
        "bytes": float(c.bytes),
        "collective_bytes": float(sum(c.collectives.values())),
        "collectives": dict(c.collectives),
        "peak_live_bytes": int(c.peak_live_bytes),
        "uncosted": dict(c.uncosted),
        "kernels": dict(c.kernels),
        "out": out,
    }

