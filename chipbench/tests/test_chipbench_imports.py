"""What the harness may import: nothing of JAX or the JAX package anywhere
(top-level names compared whole: the port's name begins with the JAX
package's), and nothing of the program in the yardstick (the reference,
the traffic generator and the arithmetic)."""
import ast
import sys

from chipbench.lib import env, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("lib/arith.py", "lib/beam_work.py", "lib/reference.py",
             "lib/traffic.py", "lib/trace.py", "lib/spec.py", "lib/env.py")


def top_names(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(spec.HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = top_names(f) & FORBIDDEN
        assert not bad, f"{f}: {bad}"


def test_the_yardstick_imports_nothing_of_the_program():
    for rel in YARDSTICK:
        names = top_names(spec.HERE / rel)
        assert "repro_torch" not in names, rel
    for f in (spec.HERE / "metrics").glob("*.py"):
        assert "repro_torch" not in top_names(f), f


def test_forbidden_modules_compared_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert not set(env.forbidden_loaded()) & {"repro_torch_like",
                                               "jaxtyping"}
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in env.forbidden_loaded()
