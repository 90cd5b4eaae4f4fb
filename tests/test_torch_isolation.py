"""The port stands alone: ``src/repro_torch`` (the durable store
``repro_torch.store`` included), ``chip_smoke.py``, the timing and
profiling scripts under ``scripts/`` and the examples
``examples/torch_*.py`` import neither JAX nor the JAX package, and the
entry points refuse to fall back to the CPU when a card was asked for
and none is present."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _port_files():
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*.py"))
            + sorted((ROOT / "examples").glob("torch_*.py")))


def _port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_store_package_is_covered():
    """The store is pure numpy in the JAX package too; the port keeps its
    own copy, and the checks above read every module of it."""
    mods = _port_modules()
    for m in ("repro_torch.store", "repro_torch.store.wal",
              "repro_torch.store.snapshot", "repro_torch.store.store"):
        assert m in mods


def test_training_layer_is_covered():
    """The checkpoints, fault tolerance and the distributed training layer
    are modules of the port, read by the checks above."""
    mods = _port_modules()
    for m in ("repro_torch.train.checkpoint",
              "repro_torch.train.fault_tolerance",
              "repro_torch.distributed.sharding",
              "repro_torch.distributed.pipeline",
              "repro_torch.distributed.collectives"):
        assert m in mods


def test_tooling_is_covered():
    """The dry-run tooling (the reference's ``launch/`` modules that read
    XLA's artifacts, and the op counter in place of its HLO parser) is
    made of modules of the port, read by the checks above."""
    mods = _port_modules()
    for m in ("repro_torch.launch.mesh", "repro_torch.launch.model_costs",
              "repro_torch.launch.op_analysis", "repro_torch.launch.steps",
              "repro_torch.launch.dryrun"):
        assert m in mods


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_entry_points_refuse_missing_card(monkeypatch, tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.index import make_index
    from repro_torch.core.interface import HNSW
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch import serve
    from repro_torch.models import encoder, gnn, recsys
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.rag import RAGPipeline

    store = str(tmp_path / "store")
    make_index("flat", store=store, device="cpu").insert(
        "a", np.ones(4, np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3-8b")
    for call in (lambda: HNSW(),
                 lambda: make_index("hnsw"),
                 lambda: make_index("flat", dtype="int8"),
                 lambda: make_index("flat", store=store),      # warm restore
                 lambda: RAGPipeline(),
                 lambda: tf.init_lm(cfg),
                 lambda: tf.init_cache(cfg, 1, 8),
                 lambda: ServeEngine(tf.init_lm(cfg, device="cpu"), cfg),
                 lambda: serve.main(["--rag", "--requests", "1"]),
                 lambda: encoder.init_encoder(recsys._bert4rec_enc_cfg(
                     get_smoke_config("bert4rec"))),
                 *(lambda kind=kind, arch=arch: recsys.INIT[kind](
                     get_smoke_config(arch))
                   for kind, arch in (("fm", "fm"), ("wide_deep", "wide-deep"),
                                      ("bert4rec", "bert4rec"),
                                      ("mind", "mind"))),
                 lambda: gnn.init_sage(get_smoke_config("graphsage-reddit"),
                                       8, 2),
                 lambda: Mesh((2, 2), ("data", "model")),
                 lambda: pipeline_apply(Mesh((4,), ("pp",)), "pp",
                                        lambda p, x: x, {}, torch.ones(2, 1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asking for the CPU explicitly is the supported way to run there
    idx = HNSW(device="cpu")
    idx.insert("a", np.ones(4, np.float32))
    assert idx.query(np.ones(4, np.float32), k=1)[0] == ["a"]
    assert idx.exact_query(np.ones(4, np.float32), k=1)[0] == ["a"]
    assert Mesh((2,), ("pp",), device="cpu").devices[1] == torch.device("cpu")


def test_examples_load_no_jax_and_refuse_missing_card():
    """Each ``examples/torch_*.py`` loads without JAX or ``repro``, and its
    ``main()`` (``--device cuda`` by default) raises without a card."""
    names = sorted(p.stem for p in (ROOT / "examples").glob("torch_*.py"))
    assert names == ["torch_distributed_retrieval",
                     "torch_fault_tolerant_training", "torch_quickstart",
                     "torch_rag_playground"]
    code = ("import importlib.util, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"for name in {names!r}:\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            f"        name, {str(ROOT / 'examples')!r} + '/' + name + '.py')\n"
            "    mod = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(mod)\n"
            "    try:\n"
            "        mod.main()\n"
            "    except RuntimeError as e:\n"
            "        assert 'no CUDA device' in str(e), (name, e)\n"
            "    else:\n"
            "        raise AssertionError(name + ' ran without a card')\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Copied alone into an empty directory (no repo around it), the
    script exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
