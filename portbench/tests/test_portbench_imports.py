"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the benchmarked program. Top-level module
names are compared whole: the port's name begins with the JAX package's."""

import ast
import subprocess
import sys

import pytest

from portbench.lib import files

FORBIDDEN = {"jax", "jaxlib", "flax", "dstack_tpu"}
SOURCES = sorted(p for p in files.ROOT.rglob("*.py")
                 if "tests" not in p.relative_to(files.ROOT).parts)


def top_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(files.ROOT)))
def test_no_jax(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((files.ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_imports(path) <= {"__future__", "dataclasses", "math", "typing", "torch",
                                 "portbench"}
    assert all(n.startswith(("portbench.reference", "torch")) or "." not in n
               for n in _modules(path))


def _modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process leaves no JAX module loaded."""
    code = (
        "import sys, time, torch, pathlib\n"
        "from portbench import run\n"
        "from portbench.tests import tiny\n"
        f"root = tiny.write(pathlib.Path({str(tmp_path)!r}))\n"
        "r = run.load_run('tiny.serve', 3, 0.3, False, torch.device('cpu'), time.monotonic(),"
        " extra=[root])\n"
        "run.execute(r)\n"
        "print(sorted(set(r.records['forbidden']) | set(run.forbidden_modules())))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=files.ROOT.parent, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
