"""The dry run's cells against the reference's: ``repro_torch.launch.steps``
counted by ``op_analysis`` beside ``repro.launch.steps`` compiled by XLA
on the CPU and read by ``hlo_analysis``.

One smoke-size cell of each kind (LM train, prefill and decode,
GraphSAGE's full-graph train, a recsys serve, MeMemo's retrieval) from
the same configs: the port's FLOPs must lie within 10 % of the
reference's (the two count elementwise work on different op sets: XLA's
fused HLO and PyTorch's eager aten ops; the products are the same). The
port's per-device input bytes on a (2, 2) mesh must equal the
reference's compiled argument size for the tuned LM train cell, whose
FSDP rules split every leaf the same way in both layouts; the reference
runs in a subprocess with four host devices.

Then the cell that ``chip_smoke.py`` phase 16 counts on the card,
llama3-8b ``decode_32k`` cut to 2 layers, on ``meta``, and
``dryrun.main`` end to end on MeMemo's cells.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import base as tbase, get_config as tget
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import dryrun, op_analysis as oa, steps as tsteps
from repro_torch.launch.mesh import make_host_mesh

SRC = Path(__file__).resolve().parents[1] / "src"
FLOPS_RTOL = 0.10

# (arch, shape name, kind, dims): one smoke-size cell a kind
SMOKE_CELLS = [
    ("llama3-8b", "train_s", "train", {"seq_len": 64, "global_batch": 4}),
    ("llama3-8b", "prefill_s", "prefill", {"seq_len": 64,
                                           "global_batch": 4}),
    ("llama3-8b", "decode_s", "decode", {"seq_len": 64, "global_batch": 4}),
    ("graphsage-reddit", "full_graph_s", "train",
     {"n_nodes": 300, "n_edges": 1200, "d_feat": 32, "n_classes": 5}),
    ("wide-deep", "serve_s", "serve", {"batch": 64}),
    ("mememo", "query_s", "retrieval",
     {"batch": 4, "n_candidates": 2048, "dim": 32, "k": 10}),
]


def _port_count(arch_id, shape):
    arch = dataclasses.replace(tget(arch_id), model=tsmoke(arch_id),
                               shapes=(shape,))
    cell = tsteps.cell_for(arch, shape, make_host_mesh(1, 1, device="meta"))
    return oa.analyze(cell.fn, *cell.args)


def _reference_flops(arch_id, name, kind, dims):
    import jax
    from repro.configs import base as jbase
    from repro.configs import get_config as jget
    from repro.configs import get_smoke_config as jsmoke
    from repro.launch import hlo_analysis, steps as jsteps
    from repro.launch.mesh import make_host_mesh as jmesh

    shape = jbase.ShapeSpec(name, kind, dims)
    arch = dataclasses.replace(jget(arch_id), model=jsmoke(arch_id),
                               shapes=(shape,))
    fn, specs, shard, out_shard = jsteps.BUILDERS[arch.family](
        arch, shape, jmesh(1, 1), None)
    kw = {} if out_shard is None else {"out_shardings": out_shard}
    compiled = jax.jit(fn, in_shardings=shard, **kw).lower(*specs).compile()
    return hlo_analysis.analyze(compiled.as_text())["flops"]


@pytest.mark.parametrize("arch_id,name,kind,dims", SMOKE_CELLS,
                         ids=[f"{c[0]}-{c[2]}" for c in SMOKE_CELLS])
def test_cell_flops_within_10pct_of_the_reference(arch_id, name, kind,
                                                  dims):
    port = _port_count(arch_id, tbase.ShapeSpec(name, kind, dims))
    ref = _reference_flops(arch_id, name, kind, dims)
    ratio = port["flops"] / ref
    print(f"{arch_id} {kind}: port {port['flops']:.6g} reference "
          f"{ref:.6g} ratio {ratio:.4f}")
    assert abs(ratio - 1) <= FLOPS_RTOL, ratio
    assert port["uncosted"] == {}
    assert port["collective_bytes"] == 0
    if kind == "decode":
        assert port["kernels"] == {"flash_decode": 2}
    if kind == "retrieval":
        assert port["kernels"] == {"flat_topk": 1}


def test_lm_train_arg_bytes_equal_the_reference_on_a_2x2_mesh():
    """The tuned dense LM train cell (FSDP rules, bf16 params, m and v
    laid out as the params) at smoke dims that the mesh divides."""
    tuning = dryrun.TUNED[("llama3-8b", "train_4k")]
    dims = {"seq_len": 32, "global_batch": 4}
    code = textwrap.dedent(f"""
        import dataclasses, jax
        from repro.configs import base, get_config, get_smoke_config
        from repro.launch import steps
        shape = base.ShapeSpec("t", "train", {dims!r})
        arch = dataclasses.replace(get_config("llama3-8b"),
                                   model=get_smoke_config("llama3-8b"),
                                   shapes=(shape,))
        mesh = jax.make_mesh((2, 2), ("data", "model"))
        fn, specs, shard, out_shard = steps.lm_cell(arch, shape, mesh,
                                                    {tuning!r})
        c = jax.jit(fn, in_shardings=shard, out_shardings=out_shard
                    ).lower(*specs).compile()
        print("ARG", c.memory_analysis().argument_size_in_bytes)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = int(res.stdout.split("ARG")[-1])
    shape = tbase.ShapeSpec("t", "train", dims)
    arch = dataclasses.replace(tget("llama3-8b"),
                               model=tsmoke("llama3-8b"), shapes=(shape,))
    mesh = Mesh((2, 2), ("data", "model"), device="meta")
    cell = tsteps.cell_for(arch, shape, mesh, tuning)
    assert tsteps.arg_bytes_per_dev(cell, mesh) == want
    assert tsteps.arg_bytes(cell) > 3 * want      # split four ways


def test_phase16_decode_cell_on_meta():
    """llama3-8b decode_32k at its published width, 2 layers: two
    flash_decode calls, each costed at the full cache (every slot attends
    S), nothing uncosted, bf16 products, and nothing allocated."""
    cell = tsteps.make_cell("llama3-8b", "decode_32k",
                            make_host_mesh(1, 1, device="meta"), n_layers=2)
    r = oa.analyze(cell.fn, *cell.args)
    assert r["kernels"] == {"flash_decode": 2} and r["uncosted"] == {}
    m = tget("llama3-8b").model
    b, s = 128, 32768
    flash_b, flash_f = oa.flash_decode_work(b, m.n_heads, m.n_kv_heads, m.dh,
                                            b * s, 2)
    assert r["bytes"] > 2 * flash_b
    assert r["flops_by_dtype"]["fp32"] >= 2 * flash_f["fp32"]
    assert r["flops_by_dtype"]["bf16"] > 0
    logits, cache = r["out"]
    assert logits.device.type == "meta" and logits.shape == (b, 1, m.vocab)
    assert r["peak_live_bytes"] >= tsteps.arg_bytes(cell)


def test_dryrun_main_counts_mememo_cells(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch mememo --mesh both
    --preset tuned``: both retrieval cells on both meshes ok (the build
    shape skipped), the rows' keys, distance_topk costed by formula and
    nothing uncosted."""
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--arch", "mememo", "--mesh", "both", "--preset",
                        "tuned", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [(r["shape"], r["mesh"]) for r in rows] == [
        (s, m) for m in ("pod_16x16", "multipod_2x16x16")
        for s in ("query_1m", "query_rt")]
    for r in rows:
        assert r["status"] == "ok" and r["device"] == "meta"
        assert r["uncosted"] == {} and r["coll_bytes_per_dev"] == 0
        assert r["kernels"] == {"flat_topk": r["chips"]}
        assert r["tuning"] == dryrun.TUNED[("mememo", r["shape"])]
        assert r["bottleneck"] in ("compute", "memory")
        assert r["model_flops_per_dev"] == dryrun.model_flops(
            "mememo", r["shape"]) / r["chips"]
        assert r["fits_hbm"]
        for key in ("t_compute_s", "t_memory_s", "t_memory_ops_s",
                    "t_collective_s", "op_flops_per_dev", "arg_bytes_per_dev",
                    "total_bytes_per_dev", "useful_ratio", "count_s"):
            assert key in r
