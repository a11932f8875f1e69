"""No file of the benchmark imports JAX or helen_tpu (top-level names
compared whole: helen_tpu_torch begins with helen_tpu), and the reference
imports nothing of the program."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "helen_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    root = os.path.join(HERE, sub)
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_or_helen_tpu(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference"), ids=os.path.basename)
def test_reference_is_plain(path):
    assert set(_imports(path)) <= {"__future__", "typing", "torch", "numpy", "math"}


def test_scan_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import helen_tpu_torch.ops\nfrom helen_tpu.io import x\nimport jaxlib\n")
    assert set(_imports(str(src))) & FORBIDDEN == {"helen_tpu", "jaxlib"}
