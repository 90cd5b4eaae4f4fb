"""Dry-run cell builders, ported from ``repro/launch/steps.py``: one
program per (arch x shape), with its inputs.

``build_cell(arch_id, shape_name, mesh, tuning)`` returns ``(fn, args)``,
the port's own step and its inputs on ``device``: on ``meta`` (the
default) they have shapes and dtypes and no values, so a cell at its
published size allocates nothing; on a real device the inputs are
seeded draws (token and row ids in range), for the card cells of
``chip_smoke.py``. ``make_cell`` also returns each input's logical axes,
from which ``arg_bytes_per_dev`` takes the per-device bytes of the
reference's in-shardings.

Shape kinds -> program:
  train / sampled_train  -> loss, gradients and the AdamW update
                            (``train_loop.make_train_step``)
  prefill                -> the prompt pass building the KV cache
  decode                 -> one token against a seq_len cache
  serve                  -> the recsys forward or user embedding
  retrieval              -> ``core/distributed.py:sharded_flat_topk``
                            over the mesh's devices

The LMs serve with bf16 weights and compute in bf16, as the reference's
cells do (its ``lm_loss``, ``prefill`` and ``decode_step`` default to
bf16; the port's take the weights' dtype unless told). The program does
not depend on the mesh, which the one process does not split, except a
retrieval cell's shard count; the mesh gives the axes their sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.distributed import sharded_flat_topk
from repro_torch.distributed.sharding import (
    Mesh,
    axis_rules,
    bytes_per_device,
    spec_for,
)
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.models.common import named_tensors
from repro_torch.train.optimizer import (
    AdamWConfig,
    OptState,
    adamw_init,
    opt_state_axes,
)
from repro_torch.train.train_loop import make_train_step
from repro_torch.utils import generator

OPT_CFG = AdamWConfig(lr=3e-4)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Cell:
    """A cell's program ``fn(*args)``, its inputs, each input's logical
    axes (a tuple for a tensor, a dict by leaf name for a parameter tree,
    the container's shape for an ``OptState`` or a ``KVCache``) and the
    logical-axis rules it runs under."""

    fn: Callable
    args: tuple
    axes: tuple
    rules: dict | None = None


class _Draws:
    """A cell's inputs on ``device``: seeded draws, nothing on ``meta``."""

    def __init__(self, device, seed: int = 0):
        self.g = generator(seed, device)

    def ints(self, shape, high: int, low: int = 0,
             dtype=torch.int32) -> torch.Tensor:
        return torch.randint(low, high, shape, generator=self.g,
                             device=self.g.device, dtype=torch.int64
                             ).to(dtype)

    def floats(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device=self.g.device,
                           dtype=dtype)


def _train_fn(loss_fn: Callable, names: tuple[str, ...]) -> Callable:
    """``loss_fn(params, **batch)`` -> the full train step ``fn(params,
    opt_state, *batch)`` (loss, gradients and AdamW)."""
    step = make_train_step(loss_fn, OPT_CFG)

    def fn(params, opt_state, *batch):
        return step(params, opt_state, dict(zip(names, batch)))

    return fn


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------
def _lm_overrides(mcfg, shape_kind: str, tuning: dict | None):
    """Per-cell implementation knobs (baseline unless tuning overrides)."""
    t = dict(tuning or {})
    if "moe_pad_experts" in t and mcfg.moe is not None:
        mcfg = dataclasses.replace(
            mcfg, moe=dataclasses.replace(
                mcfg.moe, pad_experts_to=int(t["moe_pad_experts"])))
    fields = {f.name for f in dataclasses.fields(mcfg)}
    upd = {k: v for k, v in t.items() if k in fields}
    return dataclasses.replace(mcfg, **upd) if upd else mcfg


def _rules(tuning: dict | None):
    """Logical->mesh rule overrides, e.g. FSDP: {"heads": ["data","model"]}."""
    r = (tuning or {}).get("rules")
    if not r:
        return None
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in r.items()}


def lm_cell(arch: ArchConfig, shape: ShapeSpec, mesh: Mesh,
            tuning: dict | None = None, *, device="meta",
            n_layers: int | None = None) -> Cell:
    mcfg = _lm_overrides(arch.model, shape.kind, tuning)
    if n_layers is not None:
        mcfg = dataclasses.replace(mcfg, n_layers=n_layers)
    B, S = shape["global_batch"], shape["seq_len"]
    t = tuning or {}
    impl = t.get("attn_impl", "masked")
    draws = _Draws(device)
    p_axes = tf.lm_param_axes(mcfg)

    if shape.kind == "train":
        # param storage dtype: fp32 master (default) or bf16 + fp32 state
        model = tf.init_lm(mcfg, 0, device,
                           _DTYPES[t.get("param_dtype", "float32")])
        opt = adamw_init(model)
        o_axes = (OptState(p_axes, p_axes, ()) if t.get("opt_like_params")
                  else opt_state_axes(p_axes))
        tok = draws.ints((B, S), mcfg.vocab)

        def loss(p, tokens, labels):
            return tf.lm_loss(p, tokens, labels, dtype=torch.bfloat16,
                              impl=impl)

        return Cell(_train_fn(loss, ("tokens", "labels")),
                    (model, opt, tok, tok),
                    (p_axes, o_axes, ("batch", None), ("batch", None)))

    # serving params in bf16
    model = tf.init_lm(mcfg, 0, device, torch.bfloat16)
    if shape.kind == "prefill":
        def prefill(p, tokens):
            return tf.prefill(p, tokens, dtype=torch.bfloat16)

        return Cell(prefill, (model, draws.ints((B, S), mcfg.vocab)),
                    (p_axes, ("batch", None)))

    if shape.kind == "decode":
        Sc = tf.cache_len(mcfg, S)
        L, KVH, Dh = mcfg.n_layers, mcfg.n_kv_heads, mcfg.dh
        shp = (L, B, Sc, KVH, Dh)
        if mcfg.kv_quant:
            k, v = (draws.ints(shp, 128, -127, torch.int8) for _ in range(2))
            ks, vs = (draws.floats(shp[:-1]).abs() for _ in range(2))
        else:
            k, v = (draws.floats(shp, torch.bfloat16) for _ in range(2))
            ks = vs = None
        # every slot one position short of full: each attends Sc positions
        cur = torch.full((B,), Sc - 1, dtype=torch.int32, device=k.device)
        cache = tf.KVCache(k, v, cur, ks, vs)
        kv_ax = (None, "batch", "kv_seq", None, None)
        sc_ax = kv_ax[:-1] if mcfg.kv_quant else None
        cache_axes = tf.KVCache(kv_ax, kv_ax, (None,), sc_ax, sc_ax)

        def decode(p, token, cache):
            return tf.decode_step(p, token, cache, dtype=torch.bfloat16)

        return Cell(decode, (model, draws.ints((B, 1), mcfg.vocab), cache),
                    (p_axes, ("batch", None), cache_axes))

    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------
def gnn_cell(arch: ArchConfig, shape: ShapeSpec, mesh: Mesh,
             tuning: dict | None = None, *, device="meta",
             n_layers: int | None = None) -> Cell:
    mcfg = arch.model
    d_feat, n_classes = shape["d_feat"], shape["n_classes"]
    draws = _Draws(device)
    params = gnn_lib.init_sage(mcfg, d_feat, n_classes, 0, device)
    p_axes = gnn_lib.sage_param_axes(mcfg)
    state = (params, adamw_init(params))
    state_axes = (p_axes, opt_state_axes(p_axes))

    if shape.kind == "train" and shape.name != "molecule":
        n, e = shape["n_nodes"], shape["n_edges"]
        n += (-n) % 256               # pad nodes: mesh-divisible sharding
        e += (-e) % 256               # pad edges (dummy-node self-loops)

        def loss(p, feats, src, dst, labels, mask):
            return gnn_lib.sage_full_loss(p, mcfg, feats, src, dst, labels,
                                          mask)

        batch = (draws.floats((n, d_feat)), draws.ints((e,), n),
                 draws.ints((e,), n), draws.ints((n,), n_classes),
                 draws.floats((n,)).gt(0).float())
        return Cell(_train_fn(loss, ("feats", "src", "dst", "labels",
                                     "mask")),
                    state + batch,
                    state_axes + (("nodes", None), ("edges",), ("edges",),
                                  ("nodes",), ("nodes",)))

    if shape.kind == "sampled_train":
        n, e, b = shape["n_nodes"], shape["n_edges"], shape["batch_nodes"]
        n += (-n) % 256               # pad nodes: mesh-divisible sharding
        fanouts = (shape["fanout1"], shape["fanout2"])

        def loss(p, row_ptr, col_idx, feats, seeds, labels):
            return gnn_lib.sampled_train_from_graph(
                p, mcfg, row_ptr, col_idx, feats, seeds, labels,
                generator(0, feats.device), fanouts)

        # a CSR of about e / n neighbours a node
        row_ptr = torch.clamp(torch.arange(n + 1, device=draws.g.device)
                              * (-(-e // n)), max=e).to(torch.int32)
        batch = (row_ptr, draws.ints((e,), n), draws.floats((n, d_feat)),
                 draws.ints((b,), n), draws.ints((b,), n_classes))
        return Cell(_train_fn(loss, ("row_ptr", "col_idx", "feats", "seeds",
                                     "labels")),
                    state + batch,
                    state_axes + ((None,), ("edges",), ("nodes", None),
                                  ("batch",), ("batch",)))

    # molecule: batched small graphs
    g, nn = shape["batch"], shape["n_nodes"]

    def loss(p, feats, adj, labels):
        return gnn_lib.sage_molecule_loss(p, mcfg, feats, adj, labels)

    batch = (draws.floats((g, nn, d_feat)),
             draws.floats((g, nn, nn)).gt(0).float(),
             draws.ints((g,), n_classes))
    return Cell(_train_fn(loss, ("feats", "adj", "labels")), state + batch,
                state_axes + (("batch", None, None), ("batch", None, None),
                              ("batch",)))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------
def _retrieval(mesh: Mesh, draws: _Draws, n: int, dim: int, nq: int, k: int,
               metric: str, tuning: dict | None) -> Cell:
    """The sharded flat top-k over the mesh's devices: ``n`` rows padded
    with sentinel rows to a multiple of the mesh's size."""
    t = tuning or {}
    n += (-n) % mesh.size
    devices = list(mesh.devices.flat)
    wire_bf16 = bool(t.get("wire_bf16", False))
    db = draws.floats((n, dim), _DTYPES[t.get("db_dtype", "float32")])

    def retrieval(db, q):
        return sharded_flat_topk(devices, db, q, k, metric=metric,
                                 wire_bf16=wire_bf16)

    return Cell(retrieval, (db, draws.floats((nq, dim))),
                (("db_rows", None), (None, None)))


def recsys_cell(arch: ArchConfig, shape: ShapeSpec, mesh: Mesh,
                tuning: dict | None = None, *, device="meta",
                n_layers: int | None = None) -> Cell:
    mcfg = arch.model
    kind = mcfg.kind
    draws = _Draws(device)
    if shape.kind == "retrieval":
        nq = shape["batch"] * max(mcfg.n_interests, 1)
        return _retrieval(mesh, draws, shape["n_candidates"], mcfg.embed_dim,
                          nq, 100, "ip", tuning)

    params = rs.INIT[kind](mcfg, 0, device)
    p_axes = rs.AXES[kind](mcfg)
    B = shape["batch"]
    serve = shape.kind == "serve"
    state = (params,) if serve else (params, adamw_init(params))
    state_axes = (p_axes,) if serve else (p_axes, opt_state_axes(p_axes))

    def cell(step, names, batch, batch_axes) -> Cell:
        if serve:
            return Cell(step, state + batch, state_axes + batch_axes)
        return Cell(_train_fn(step, names), state + batch,
                    state_axes + batch_axes)

    if kind in ("fm", "wide_deep"):
        ids = draws.ints((B, mcfg.n_sparse), mcfg.rows_per_field)
        dense = draws.floats((B, mcfg.n_dense))
        if serve:
            fwd = rs.fm_forward if kind == "fm" else rs.wide_deep_forward
            return cell(lambda p, ids, dense: fwd(p, mcfg, ids, dense), (),
                        (ids, dense), (("batch", None), ("batch", None)))
        lss = rs.fm_loss if kind == "fm" else rs.wide_deep_loss
        return cell(lambda p, ids, dense, labels: lss(p, mcfg, ids, dense,
                                                      labels),
                    ("ids", "dense", "labels"),
                    (ids, dense, draws.ints((B,), 2)),
                    (("batch", None), ("batch", None), ("batch",)))

    S = mcfg.seq_len
    if kind == "bert4rec":
        seq = draws.ints((B, S), mcfg.n_items)
        if serve:
            return cell(lambda p, seq: rs.bert4rec_user_embedding(p, mcfg,
                                                                  seq),
                        (), (seq,), (("batch", None),))
        # fixed-count masked positions (20%): [B,M,V] logits, not [B,S,V]
        M = max(S // 5, 1)
        return cell(lambda p, seq, mpos, labels: rs.bert4rec_masked_loss(
                        p, mcfg, seq, mpos, labels),
                    ("seq", "mpos", "labels"),
                    (seq, draws.ints((B, M), S),
                     draws.ints((B, M), mcfg.n_items)),
                    (("batch", None),) * 3)

    # mind
    beh = draws.ints((B, S), mcfg.n_items)
    bm = draws.floats((B, S)).gt(-1).float()
    if serve:
        return cell(lambda p, beh, bm: rs.mind_user_embedding(p, mcfg, beh,
                                                              bm),
                    (), (beh, bm), (("batch", None), ("batch", None)))
    return cell(lambda p, beh, bm, tgt, neg: rs.mind_loss(p, mcfg, beh, bm,
                                                          tgt, neg),
                ("beh", "bm", "tgt", "neg"),
                (beh, bm, draws.ints((B,), mcfg.n_items),
                 draws.ints((B, 16), mcfg.n_items)),
                (("batch", None), ("batch", None), ("batch",),
                 ("batch", None)))


# ---------------------------------------------------------------------------
# MeMemo (the paper's own shapes)
# ---------------------------------------------------------------------------
def retrieval_cell(arch: ArchConfig, shape: ShapeSpec, mesh: Mesh,
                   tuning: dict | None = None, *, device="meta",
                   n_layers: int | None = None) -> Cell:
    return _retrieval(mesh, _Draws(device), shape["n_candidates"],
                      shape["dim"], shape["batch"], shape["k"],
                      arch.model.metric, tuning)


BUILDERS = {"lm": lm_cell, "gnn": gnn_cell, "recsys": recsys_cell,
            "retrieval": retrieval_cell}


def make_cell(arch_id: str, shape_name: str, mesh: Mesh,
              tuning: dict | None = None, *, device="meta",
              n_layers: int | None = None) -> Cell:
    """The cell of (arch, shape) with its inputs' axes; ``n_layers`` cuts
    an LM's depth (the dry run leaves the published config)."""
    arch = get_config(arch_id)
    return cell_for(arch, arch.shape(shape_name), mesh, tuning,
                    device=device, n_layers=n_layers)


def cell_for(arch: ArchConfig, shape: ShapeSpec, mesh: Mesh,
             tuning: dict | None = None, *, device="meta",
             n_layers: int | None = None) -> Cell:
    """``make_cell`` of a config and shape given as they are (the tests'
    smoke configs)."""
    cell = BUILDERS[arch.family](arch, shape, mesh, tuning, device=device,
                                 n_layers=n_layers)
    cell.rules = _rules(tuning)
    fn = cell.fn

    def wrapped(*args):
        with axis_rules(mesh, cell.rules):
            return fn(*args)

    cell.fn = wrapped
    return cell


def build_cell(arch_id: str, shape_name: str, mesh: Mesh,
               tuning: dict | None = None, *, device="meta",
               n_layers: int | None = None) -> tuple[Callable, tuple]:
    """-> (fn, args): the cell's program and its inputs on ``device``."""
    cell = make_cell(arch_id, shape_name, mesh, tuning, device=device,
                     n_layers=n_layers)
    return cell.fn, cell.args


def _leaf_axes(arg: Any, axes: Any) -> list[tuple[torch.Tensor, tuple]]:
    """(tensor, logical axes) for each tensor of an input."""
    if arg is None:
        return []
    if isinstance(arg, torch.Tensor):
        return [(arg, axes)]
    if isinstance(axes, dict):
        return [(t, axes[n]) for n, t in named_tensors(arg)]
    if dataclasses.is_dataclass(arg):
        return [pair for f in dataclasses.fields(arg)
                for pair in _leaf_axes(getattr(arg, f.name),
                                       getattr(axes, f.name))]
    return [pair for a, ax in zip(arg, axes) for pair in _leaf_axes(a, ax)]


def arg_bytes_per_dev(cell: Cell, mesh: Mesh) -> int:
    """Bytes of the cell's inputs a device holds under the reference's
    in-shardings: each leaf split by ``spec_for`` of its logical axes
    under the cell's rules (``sharding.bytes_per_device``)."""
    with axis_rules(mesh, cell.rules):
        return sum(bytes_per_device(t.shape, spec_for(t.shape, ax), mesh,
                                    t.element_size())
                   for t, ax in _leaf_axes(cell.args, cell.axes))


def arg_bytes(cell: Cell) -> int:
    """Bytes of the cell's inputs, whole."""
    return sum(t.numel() * t.element_size()
               for t, _ in _leaf_axes(cell.args, cell.axes))
