"""Dry run: count every (arch x input-shape x mesh) cell and cost it
against the roofline of the card, ported from ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod --out build/scratch/dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k

Each cell's program (``launch/steps.py``) runs once at its published
config on the ``meta`` device, where nothing is allocated, under the op
counter (``launch/op_analysis.py``). The count is made once per (arch,
shape, tuning) and shared by the meshes: the one-process program does
not change with the mesh (a retrieval cell's shard count aside, which
is counted per mesh size). The program is the whole job's, so its
FLOPs are split evenly over the mesh's chips (``op_flops_per_dev``);
the memory term is the analytic byte model of ``launch/model_costs.py``
per device, as in the reference, with the op bytes beside it as an
upper bound (``t_memory_ops_s``). A ``meta`` run moves nothing between
devices, so its collective term is 0.

Peaks (NVIDIA H100 SXM data sheet, dense, at the full 700 W limit).
"""
from __future__ import annotations

import argparse
import gc
import json
import time
import traceback

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh, tp_size
from repro_torch.launch.model_costs import model_bytes
from repro_torch.launch.op_analysis import analyze
from repro_torch.launch.steps import arg_bytes, arg_bytes_per_dev, make_cell
from repro_torch.utils import human_bytes, logger

# H100 SXM data sheet at 700 W: dense tensor-core rates for bf16/fp16 and
# TF32, the fp32 rate outside the tensor cores, HBM3 rate and size, and
# NVLink 4's rate each way
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "fp32": 67e12}
HBM_BW = 3.35e12             # B/s / chip
NVLINK_BW = 450e9            # B/s / chip, each way
HBM_PER_CHIP = 80e9

# ---------------------------------------------------------------------------
# Tuned per-cell configurations, the reference's. ``--preset tuned``
# applies these; ``--preset baseline`` runs the paper-faithful/naive
# configuration for comparison.
# ---------------------------------------------------------------------------
_FSDP_RULES = {
    "heads": ["data", "model"], "mlp": ["data", "model"],
    "vocab": ["data", "model"], "kv_heads": ["data", "model"],
    "act_heads": None, "batch": ["data", "model"],
    "tokens": ["data", "model"],
}
_LM_TRAIN_DENSE = {
    "chunked_loss": 512, "opt_like_params": True, "param_dtype": "bfloat16",
    "attn_impl": "packed", "attn_block_k": 512, "rules": _FSDP_RULES,
}
_LM_TRAIN_MOE = {"chunked_loss": 512}      # grouped dispatch is code-default
_RETRIEVAL = {"db_dtype": "bfloat16", "wire_bf16": True}
_KVQ = {"kv_quant": True}                  # int8 KV cache (decode cells)

TUNED: dict = {
    ("llama3-8b", "train_4k"): _LM_TRAIN_DENSE,
    ("h2o-danube-3-4b", "train_4k"): _LM_TRAIN_DENSE,
    ("minitron-8b", "train_4k"): _LM_TRAIN_DENSE,
    ("olmoe-1b-7b", "train_4k"): _LM_TRAIN_MOE,
    ("granite-moe-3b-a800m", "train_4k"): {**_LM_TRAIN_MOE,
                                           "moe_pad_experts": 48,
                                           "vocab": 49408},   # pad 49155
    ("granite-moe-3b-a800m", "prefill_32k"): {"moe_pad_experts": 48},
    ("granite-moe-3b-a800m", "decode_32k"): {**_KVQ, "moe_pad_experts": 48},
    ("llama3-8b", "decode_32k"): _KVQ,
    ("h2o-danube-3-4b", "decode_32k"): _KVQ,
    ("h2o-danube-3-4b", "long_500k"): _KVQ,
    ("minitron-8b", "decode_32k"): _KVQ,
    ("olmoe-1b-7b", "decode_32k"): _KVQ,
    ("mememo", "query_1m"): _RETRIEVAL,
    ("mememo", "query_rt"): _RETRIEVAL,
    ("mind", "retrieval_cand"): _RETRIEVAL,
    ("wide-deep", "retrieval_cand"): _RETRIEVAL,
    ("bert4rec", "retrieval_cand"): _RETRIEVAL,
    ("fm", "retrieval_cand"): _RETRIEVAL,
}


# ---------------------------------------------------------------------------
def model_flops(arch_id: str, shape_name: str) -> float:
    """Analytic 'useful' FLOPs per step, whole job (all devices)."""
    arch = get_config(arch_id)
    shape = arch.shape(shape_name)
    m = arch.model
    if arch.family == "lm":
        n_act = m.active_param_count
        if shape.kind == "train":
            tokens = shape["global_batch"] * shape["seq_len"]
            return 6.0 * n_act * tokens
        if shape.kind == "prefill":
            tokens = shape["global_batch"] * shape["seq_len"]
            return 2.0 * n_act * tokens
        # decode: one token per sequence + attention over the cache
        b, s = shape["global_batch"], shape["seq_len"]
        s_eff = min(s, m.sliding_window or s)
        attn = 4.0 * b * s_eff * m.n_layers * m.n_kv_heads * m.dh
        return 2.0 * n_act * b + attn
    if arch.family == "gnn":
        h = m.d_hidden
        if shape.name == "molecule":
            e_eff = shape["batch"] * shape["n_edges"]
            n_eff = shape["batch"] * shape["n_nodes"]
        elif shape.kind == "sampled_train":
            b, f1, f2 = shape["batch_nodes"], shape["fanout1"], shape["fanout2"]
            n_eff = b * (1 + f1 + f1 * f2)
            e_eff = b * (f1 + f1 * f2)
        else:
            n_eff, e_eff = shape["n_nodes"], shape["n_edges"]
        d = shape["d_feat"]
        fwd = 2.0 * n_eff * (d * h + h * h) * 2 + 2.0 * e_eff * (d + h)
        return 3.0 * fwd if "train" in shape.kind else fwd
    if arch.family == "recsys":
        if shape.kind == "retrieval":
            nq = shape["batch"] * max(m.n_interests, 1)
            return 2.0 * nq * shape["n_candidates"] * m.embed_dim
        b = shape["batch"]
        if m.kind in ("fm", "wide_deep"):
            per = 2.0 * m.n_sparse * m.embed_dim
            for a, bdim in zip((m.n_sparse * m.embed_dim + m.n_dense,)
                               + tuple(m.mlp_dims), tuple(m.mlp_dims) + (1,)):
                per += 2.0 * a * bdim
        elif m.kind == "bert4rec":
            d, s = m.embed_dim, m.seq_len
            per_tok = (12 * d * d + 4 * d * s) * m.n_blocks
            per = s * per_tok
            if shape.kind == "train":       # M=S/5 masked-position logits
                per += (s // 5) * 2 * d * m.n_items
        else:  # mind
            d, s = m.embed_dim, m.seq_len
            per = 2 * s * d * d + m.capsule_iters * 4 * m.n_interests * s * d
        fwd = per * b
        return 3.0 * fwd if shape.kind == "train" else fwd
    # mememo retrieval
    return 2.0 * shape["batch"] * shape["n_candidates"] * shape["dim"]


def compute_seconds(flops_by_dtype: dict, chips: int = 1) -> float:
    """The counted operations over the card's peak for their units, split
    evenly over ``chips``."""
    return sum(f / PEAK_FLOPS[k] for k, f in flops_by_dtype.items()) / chips


# ---------------------------------------------------------------------------
_COUNTS: dict = {}


def count_cell(arch_id: str, shape_name: str, mesh,
               tuning: dict | None = None, *, device="meta",
               n_layers: int | None = None) -> dict:
    """One count of the cell's program -> ``analyze``'s counts (without
    the program's output) plus ``count_s``, ``arg_bytes`` (the inputs,
    whole) and ``arg_bytes_per_dev`` on ``mesh``."""
    cell = make_cell(arch_id, shape_name, mesh, tuning, device=device,
                     n_layers=n_layers)
    t0 = time.perf_counter()
    counts = analyze(cell.fn, *cell.args)
    counts.pop("out")
    counts["count_s"] = time.perf_counter() - t0
    counts["arg_bytes"] = arg_bytes(cell)
    counts["arg_bytes_per_dev"] = arg_bytes_per_dev(cell, mesh)
    del cell
    gc.collect()
    return counts


def run_cell(arch_id: str, shape_name: str, mesh, mesh_name: str,
             tuning: dict | None = None) -> dict:
    chips = mesh.size
    retrieval = get_config(arch_id).shape(shape_name).kind == "retrieval"
    key = (arch_id, shape_name, json.dumps(tuning or {}, sort_keys=True),
           chips if retrieval else None)    # a shard a chip
    fresh = key not in _COUNTS
    if fresh:
        _COUNTS[key] = count_cell(arch_id, shape_name, mesh, tuning)
    c = dict(_COUNTS[key])
    if not fresh:       # the per-device input bytes follow the mesh
        c["arg_bytes_per_dev"] = arg_bytes_per_dev(
            make_cell(arch_id, shape_name, mesh, tuning), mesh)

    mf_total = model_flops(arch_id, shape_name)
    mf_dev = mf_total / chips
    mb_dev = model_bytes(arch_id, shape_name, chips, tp_size(mesh), tuning)
    op_flops_dev = c["flops"] / chips
    t_comp = compute_seconds(c["flops_by_dtype"], chips)
    t_mem = mb_dev / HBM_BW                    # analytic bytes a device
    t_mem_ops = c["bytes"] / chips / HBM_BW    # eager op bytes, even split
    t_coll = c["collective_bytes"] / chips / NVLINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values())
    total = c["arg_bytes_per_dev"] + (c["peak_live_bytes"]
                                      - c["arg_bytes"]) / chips

    return {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "chips": int(chips),
        "status": "ok",
        "device": "meta",
        "count_s": round(c["count_s"], 2) if fresh else 0.0,
        "op_flops": c["flops"],
        "op_flops_per_dev": op_flops_dev,        # an even split
        "op_flops_by_dtype": c["flops_by_dtype"],
        "op_bytes": c["bytes"],
        "op_bytes_per_dev": c["bytes"] / chips,  # an even split
        "model_bytes_per_dev": mb_dev,
        "coll_bytes_per_dev": c["collective_bytes"] / chips,
        "coll_by_kind": {k: round(v) for k, v in c["collectives"].items()},
        "uncosted": c["uncosted"],
        "kernels": c["kernels"],
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_memory_ops_s": t_mem_ops, "t_collective_s": t_coll,
        "bottleneck": bottleneck,
        "roofline_fraction": (t_comp / step_time) if step_time > 0 else 0.0,
        "model_flops_per_dev": mf_dev,
        "useful_ratio": mf_dev / op_flops_dev if op_flops_dev else 0.0,
        "arg_bytes_per_dev": c["arg_bytes_per_dev"],
        "peak_live_bytes": c["peak_live_bytes"],
        "total_bytes_per_dev": int(total),       # an even-split estimate
        "fits_hbm": bool(total <= HBM_PER_CHIP),
        "tuning": tuning or {},
    }


def iter_cells(archs, shapes):
    for arch_id in archs:
        arch = get_config(arch_id)
        for shape in arch.shapes:
            if shapes and shape.name not in shapes:
                continue
            if shape.kind == "build":
                continue            # host-side builder, not a step program
            yield arch_id, shape.name, (shape.name in arch.skip_shapes)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--tuning", default=None,
                    help="JSON dict of implementation overrides")
    ap.add_argument("--preset", default="baseline",
                    choices=["baseline", "tuned"])
    args = ap.parse_args(argv)

    archs = args.arch or list(ALL_ARCHS)
    tuning = json.loads(args.tuning) if args.tuning else None
    meshes = []
    if args.mesh in ("pod", "both"):
        meshes.append(("pod_16x16", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multipod", "both"):
        meshes.append(("multipod_2x16x16", make_production_mesh(multi_pod=True)))

    rows = []
    for mesh_name, mesh in meshes:
        for arch_id, shape_name, skipped in iter_cells(archs, args.shape):
            tag = f"{arch_id} x {shape_name} x {mesh_name}"
            if skipped:
                logger.info(f"SKIP  {tag} (mandated: full attention at 500k, "
                            "see DESIGN.md section 5)")
                rows.append({"arch": arch_id, "shape": shape_name,
                             "mesh": mesh_name, "status": "skipped_mandated"})
                continue
            cell_tuning = tuning
            if cell_tuning is None and args.preset == "tuned":
                cell_tuning = TUNED.get((arch_id, shape_name))
            try:
                row = run_cell(arch_id, shape_name, mesh, mesh_name,
                               cell_tuning)
                logger.info(
                    f"OK    {tag}: count={row['count_s']}s "
                    f"bottleneck={row['bottleneck']} "
                    f"t=({row['t_compute_s']:.2e},{row['t_memory_s']:.2e},"
                    f"{row['t_collective_s']:.2e})s "
                    f"mem/dev={human_bytes(row['total_bytes_per_dev'])} "
                    f"fits={row['fits_hbm']} useful={row['useful_ratio']:.2f}"
                    + (f" uncosted={row['uncosted']}" if row["uncosted"]
                       else ""))
            except Exception as e:
                logger.info(f"FAIL  {tag}: {type(e).__name__}: {str(e)[:200]}")
                row = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                       "status": "failed", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            rows.append(row)
            if args.out:           # incremental write (long runs)
                with open(args.out, "w") as f:
                    json.dump(rows, f, indent=1)

    ok = sum(1 for r in rows if r.get("status") == "ok")
    fail = sum(1 for r in rows if r.get("status") == "failed")
    skip = sum(1 for r in rows if r.get("status") == "skipped_mandated")
    logger.info(f"dry-run complete: {ok} ok, {fail} failed, {skip} skipped "
                f"(mandated)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        logger.info(f"wrote {args.out}")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
