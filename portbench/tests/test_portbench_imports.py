"""An import scan over portbench/: no module whose top-level name, taken
whole, is jax, jaxlib, flax or eas_snn_tpu; the reference imports nothing
of the port (eas_snn_tpu_torch) either."""

import ast
import os

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "eas_snn_tpu"}
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(PORTBENCH)
                 for f in fs if f.endswith(".py"))


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, PORTBENCH) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_scan_takes_top_level_names_whole():
    assert "eas_snn_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if os.sep + "reference"
                                  + os.sep in p])
def test_reference_imports_nothing_of_the_port(path):
    assert "eas_snn_tpu_torch" not in top_level_imports(path)
    assert "harness" not in top_level_imports(path)
