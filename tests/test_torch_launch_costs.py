"""The dry run's arithmetic and its op counter: ``repro_torch.launch``'s
``model_costs``, ``dryrun.model_flops`` / ``TUNED``, ``mesh`` and
``op_analysis``.

``model_flops`` and ``model_bytes`` must equal the reference's exactly for
every cell the dry run yields, at 256 and 512 chips, with no tuning and
with the cell's tuned entry; the meshes and their helpers must give the
reference's values. The reference's ``launch/dryrun.py`` asks JAX for 512
host devices when it is imported, so its values come from one subprocess
(the counterpart of ``tests/test_distributed.py``'s), never from this
process, which must keep its one CPU device.

The op counter is held to exact counts on small programs: a product is
2 M N K, a Python loop of five steps five times one step, a checkpointed
block's backward one forward more, an op's bytes its operands plus its
results, and a hand kernel's entry point its formula and nothing of its
plain version.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ALL_ARCHS
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, mesh as tmesh, op_analysis as oa
from repro_torch.launch.model_costs import model_bytes

SRC = Path(__file__).resolve().parents[1] / "src"
CHIPS = (256, 512)
CELLS = [(a, s) for a, s, _ in dryrun.iter_cells(list(ALL_ARCHS), None)]


def _key(arch, shape, chips, preset):
    return f"{arch}|{shape}|{chips}|{preset}"


@pytest.fixture(scope="module")
def reference():
    """The reference's model_flops, model_bytes, TUNED and production
    meshes, from a subprocess with 512 host devices."""
    code = textwrap.dedent(f"""
        import json
        from repro.configs import ALL_ARCHS
        from repro.launch import dryrun
        from repro.launch.mesh import (batch_axes, dp_size, make_host_mesh,
                                       make_production_mesh, model_axis,
                                       tp_size)
        from repro.launch.model_costs import model_bytes
        out = {{"flops": {{}}, "bytes": {{}}, "tuned": {{}}, "meshes": {{}}}}
        for a, s, _ in dryrun.iter_cells(list(ALL_ARCHS), None):
            out["flops"][a + "|" + s] = dryrun.model_flops(a, s)
            for chips in {CHIPS!r}:
                for preset in ("baseline", "tuned"):
                    t = (dryrun.TUNED.get((a, s)) if preset == "tuned"
                         else None)
                    out["bytes"][f"{{a}}|{{s}}|{{chips}}|{{preset}}"] = \\
                        model_bytes(a, s, chips, 16, t)
        out["tuned"] = {{a + "|" + s: t for (a, s), t in
                        dryrun.TUNED.items()}}
        for name, m in (("pod", make_production_mesh(multi_pod=False)),
                        ("multipod", make_production_mesh(multi_pod=True)),
                        ("host", make_host_mesh(4, 4))):
            out["meshes"][name] = dict(
                shape=dict(m.shape), axes=list(m.axis_names),
                batch_axes=list(batch_axes(m)), model_axis=model_axis(m),
                dp=dp_size(m), tp=tp_size(m), size=int(m.devices.size))
        print("JSON" + json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JSON")]
    return json.loads(line[-1][4:])


@pytest.mark.parametrize("arch,shape", CELLS, ids=lambda x: str(x))
def test_model_flops_and_bytes_equal_the_reference(reference, arch, shape):
    """Every cell, at 256 and 512 chips (tp 16), baseline and tuned."""
    assert dryrun.model_flops(arch, shape) == \
        reference["flops"][f"{arch}|{shape}"]
    for chips in CHIPS:
        for preset in ("baseline", "tuned"):
            t = dryrun.TUNED.get((arch, shape)) if preset == "tuned" \
                else None
            assert model_bytes(arch, shape, chips, 16, t) == \
                reference["bytes"][_key(arch, shape, chips, preset)], \
                (chips, preset)


def test_tuned_presets_are_the_reference(reference):
    assert {f"{a}|{s}": t for (a, s), t in dryrun.TUNED.items()} == \
        reference["tuned"]


def test_production_meshes_have_the_reference_shapes(reference):
    """The counterpart of test_distributed.py's production-mesh test: the
    shapes, axes and helpers of the reference's meshes, every coordinate
    on ``meta``."""
    for name, multi in (("pod", False), ("multipod", True)):
        m = tmesh.make_production_mesh(multi_pod=multi)
        want = reference["meshes"][name]
        assert dict(m.shape) == want["shape"]
        assert list(m.axis_names) == want["axes"]
        assert m.size == want["size"]
        assert list(tmesh.batch_axes(m)) == want["batch_axes"]
        assert tmesh.model_axis(m) == want["model_axis"]
        assert tmesh.dp_size(m) == want["dp"]
        assert tmesh.tp_size(m) == want["tp"]
        assert {d.type for d in m.devices.flat} == {"meta"}


def test_host_mesh_clamps_to_the_devices():
    """The reference's clamping: one device gives (1, 1) at any ask, as
    the reference's does in a one-device process."""
    for data, model in ((1, 1), (4, 4), (2, 8)):
        m = tmesh.make_host_mesh(data, model, device="cpu")
        assert dict(m.shape) == {"data": 1, "model": 1}
        assert tmesh.dp_size(m) == tmesh.tp_size(m) == 1
        assert tmesh.batch_axes(m) == ("data",)


# ---------------------------------------------------------------------------
# op_analysis on small programs
# ---------------------------------------------------------------------------
def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def test_matmul_counts_2mnk_and_its_bytes():
    m, k, n = 8, 16, 32
    a = torch.randn(m, k, generator=_g())
    w = torch.randn(k, n, generator=_g(1))
    r = oa.analyze(torch.mm, a, w)
    assert r["flops"] == 2 * m * n * k
    assert r["flops_by_dtype"] == {"fp32": 2.0 * m * n * k}
    assert r["bytes"] == 4 * (m * k + k * n + m * n)
    assert r["uncosted"] == {} and r["kernels"] == {}
    r16 = oa.analyze(torch.mm, a.bfloat16(), w.bfloat16())
    assert r16["flops_by_dtype"] == {"bf16": 2.0 * m * n * k}


def test_elementwise_bytes_are_operands_plus_results():
    x = torch.randn(6, 10, generator=_g())
    y = torch.randn(6, 10, generator=_g(1))
    r = oa.analyze(torch.add, x, y)
    assert r["flops"] == 60 and r["bytes"] == 3 * 60 * 4
    # a broadcast operand reads its own elements once
    r = oa.analyze(torch.mul, x, y[:1])
    assert r["bytes"] == (60 + 10 + 60) * 4
    # a reduction reads every element once
    r = oa.analyze(lambda t: t.sum(dim=1), x)
    assert r["flops"] == 60 and r["bytes"] == (60 + 6) * 4


def test_python_loop_counts_each_trip():
    """The counterpart of the reference's scan-trips test: five trips of
    tanh(x @ w) count five times one."""
    x = torch.randn(4, 16, generator=_g())
    w = torch.randn(16, 16, generator=_g(1))

    def step(x, w):
        return torch.tanh(x @ w)

    def loop(x, w):
        for _ in range(5):
            x = step(x, w)
        return x

    one, five = oa.analyze(step, x, w), oa.analyze(loop, x, w)
    assert one["flops"] == 2 * 4 * 16 * 16 + 4 * 16
    assert five["flops"] == 5 * one["flops"]
    assert five["bytes"] == 5 * one["bytes"]


def test_checkpoint_backward_counts_one_forward_more():
    x = torch.randn(8, 32, generator=_g())
    w = torch.randn(32, 32, generator=_g(1), requires_grad=True)

    def block(x, w):
        return torch.tanh(x @ w)

    def grads(remat):
        def fn(x, w):
            h = checkpoint(block, x, w, use_reentrant=False) if remat \
                else block(x, w)
            return torch.autograd.grad(h.sum(), w)
        return oa.analyze(fn, x, w)

    fwd = oa.analyze(block, x, w)
    plain, remat = grads(False), grads(True)
    assert fwd["flops"] == 2 * 8 * 32 * 32 + 8 * 32
    assert remat["flops"] - plain["flops"] == fwd["flops"]


def test_flash_decode_counts_its_formula_and_not_its_plain_path():
    b, h, kvh, s, dh = 2, 8, 2, 64, 16
    q = torch.randn(b, h, dh, generator=_g())
    k = torch.randn(b, s, kvh, dh, generator=_g(1))
    v = torch.randn(b, s, kvh, dh, generator=_g(2))
    lens = torch.tensor([5, 64], dtype=torch.int32)
    r = oa.analyze(ops.flash_decode, q, k, v, lens)
    nbytes, flops = oa.flash_decode_work(b, h, kvh, dh, 69, 4)
    assert r["bytes"] == nbytes and r["flops_by_dtype"] == flops
    assert r["kernels"] == {"flash_decode": 1} and r["uncosted"] == {}
    assert torch.equal(r["out"], ops.flash_decode(q, k, v, lens))
    # a scalar cur_len past S counts S a sequence; on meta, the whole S
    r = oa.analyze(ops.flash_decode, q, k, v, 100)
    assert r["bytes"] == oa.flash_decode_work(b, h, kvh, dh, b * s, 4)[0]
    meta = [t.to("meta") for t in (q, k, v, lens)]
    r = oa.analyze(ops.flash_decode, *meta)
    assert r["flops_by_dtype"] == oa.flash_decode_work(b, h, kvh, dh, b * s,
                                                       4)[1]
    assert r["out"].device.type == "meta"


@pytest.mark.parametrize("b", [4, 16])
def test_flat_topk_counts_its_formula_and_not_its_plain_path(b):
    """The streaming path's fp32 work at B <= 8, the split-TF32 path's
    above; bf16 rows count two products."""
    n, d, k = 500, 24, 7
    db = torch.randn(n, d, generator=_g())
    q = torch.randn(b, d, generator=_g(1))
    for rows in (db, db.bfloat16()):
        r = oa.analyze(ops.flat_topk, rows, q, k, metric="l2")
        nbytes, flops = oa.flat_topk_work(n, d, rows.element_size(), False,
                                          b, k)
        assert r["bytes"] == nbytes and r["flops_by_dtype"] == flops
        assert r["kernels"] == {"flat_topk": 1} and r["uncosted"] == {}
    assert list(flops) == (["fp32"] if b <= ops.TOPK_SMALL_B else ["tf32"])


def test_other_entry_points_cost_or_flag_their_calls():
    """gather_distance and embedding_bag by formula; the data-dependent
    beam_search shows up in ``uncosted``."""
    n, d = 64, 8
    vec = torch.randn(n, d, generator=_g())
    q = torch.randn(3, d, generator=_g(1))
    ids = torch.tensor([[1, 2, 2, 5]] * 3, dtype=torch.int32)
    r = oa.analyze(ops.gather_distance, vec, q, ids)
    assert (r["bytes"], r["flops_by_dtype"]) == \
        oa.gather_distance_work(3, d, 4, False, 3, 4)
    w = torch.tensor([[1.0, 0.0, 1.0, 1.0]] * 3)
    r = oa.analyze(ops.embedding_bag, vec, ids, w)
    assert (r["bytes"], r["flops_by_dtype"]) == \
        oa.embedding_bag_work(3, 9, 3, 4, d, 4, True)
    nbrs = torch.randint(0, n, (n, 4), generator=_g(2), dtype=torch.int32)
    ep = torch.zeros(3, dtype=torch.int32)
    r = oa.analyze(ops.beam_search, vec, nbrs, q, ep, torch.zeros(3), ef=4)
    assert r["uncosted"] == {"ops.beam_search": 1} and r["flops"] == 0


def test_peak_live_bytes_follow_storages():
    x = torch.randn(1000, generator=_g())

    def fn(x):
        y = x * 2            # 4 KB alive beside x
        del y
        return (x + 1).sum()

    r = oa.analyze(fn, x)
    assert r["peak_live_bytes"] == 2 * 4000 + 4      # x, x + 1, the sum
    assert r["collective_bytes"] == 0 and r["collectives"] == {}
