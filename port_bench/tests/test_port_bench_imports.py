"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the renderer.  Names are compared whole, by
the part before the first dot: ``ipu_path_trace_tpu_torch`` begins with
``ipu_path_trace_tpu`` and is the renderer, not the JAX package."""

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH.parent))

from port_bench import run  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "ipu_path_trace_tpu"}
PROGRAM = "ipu_path_trace_tpu_torch"
MODULES = sorted(BENCH.rglob("*.py"))


def imports(path: Path) -> list[tuple[str, int]]:
    """(top-level name, relative level) of every import in the file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".", 1)[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                out.append((node.module.split(".", 1)[0] if node.module else "", node.level))
            else:
                out.append((node.module.split(".", 1)[0], 0))
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "find_spec") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            out.append((node.args[0].value.split(".", 1)[0], 0))
    return out


def test_walks_every_module():
    assert len(MODULES) >= 15
    assert BENCH / "run.py" in MODULES
    assert BENCH / "reference" / "replay.py" in MODULES


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    bad = {name for name, level in imports(path) if level == 0 and name in FORBIDDEN}
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_renderer(path):
    names = imports(path)
    assert all(name != PROGRAM for name, level in names if level == 0), path
    # Relative imports stay inside the reference.
    assert all(level <= 1 for _, level in names), path
    assert all(name != "port_bench" for name, level in names if level == 0), path


def test_names_are_compared_whole():
    assert run.forbidden_modules(["ipu_path_trace_tpu_torch.runtime.app", "numpy"]) == []
    assert run.forbidden_modules(["ipu_path_trace_tpu.ops", "jaxlib.xla"]) == [
        "ipu_path_trace_tpu", "jaxlib"]
    assert run.forbidden_modules(["jax_utils", "flaxen"]) == []


def test_the_checker_sees_a_forbidden_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom ipu_path_trace_tpu.ops import x\n"
                   "from ipu_path_trace_tpu_torch.ops import y\nfrom . import z\n")
    assert imports(src) == [("jax", 0), ("ipu_path_trace_tpu", 0),
                            ("ipu_path_trace_tpu_torch", 0), ("", 1)]
