"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the references import nothing of the port."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "cnns_slfp_quantization_tpu"}
PORT = "cnns_slfp_quantization_tpu_torch"
# the yardstick: what the comparison and the counts rest on
YARDSTICK = ("reference", "inputs.py", "checks.py", "work.py", "peaks.py",
             "kernel_class.py", "control.py")


def imported(path: pathlib.Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add((node.module or "").split(".")[0])
    return out


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.relative_to(HERE).parts[0] in YARDSTICK],
    ids=lambda p: str(p.relative_to(HERE)))
def test_yardstick_imports_nothing_of_the_port(path):
    assert PORT not in imported(path)


def test_the_guard_compares_whole_names():
    from benchmark import run

    assert run.FORBIDDEN == ("jax", "jaxlib", "flax",
                             "cnns_slfp_quantization_tpu")
    assert PORT.split(".")[0] not in run.FORBIDDEN
