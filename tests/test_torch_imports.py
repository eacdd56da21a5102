"""The port must run where JAX is absent: no module of
``tobac_flow_tpu_torch`` may import ``jax``, ``jaxlib`` or the JAX package
``tobac_flow_tpu``.  Checked on the source with an AST scan, because the
test interpreter itself may have JAX loaded already."""

import ast
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parent.parent / "tobac_flow_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tobac_flow_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PORT.parent)))
def test_no_jax_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), filename=str(path))))
    assert not roots & set(FORBIDDEN), f"{path.name} imports {sorted(roots & set(FORBIDDEN))}"


def test_bench_scene_needs_no_jax():
    """``chip_smoke.py`` imports ``bench`` for the scene and markers: the
    module's top level and the functions it calls must import no JAX."""
    tree = ast.parse((PORT.parent / "bench.py").read_text())
    used = {"_n_cells", "_cell_params", "make_scene", "make_markers"}
    nodes = [n for n in tree.body if not isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    nodes += [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in used]
    assert len(nodes) > len(used)
    roots = set().union(*(_imported_roots(n) for n in nodes))
    assert "numpy" in roots and not roots & set(FORBIDDEN), sorted(roots)


def test_parity_scene_needs_no_jax():
    """``chip_smoke.py`` imports ``tools/parity_detect.make_multistorm_scene``
    for the detection chain's scene: the module's top level and that
    function must import no JAX."""
    tree = ast.parse((PORT.parent / "tools" / "parity_detect.py").read_text())
    nodes = [n for n in tree.body if not isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    nodes += [n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_multistorm_scene"]
    assert any(isinstance(n, ast.FunctionDef) for n in nodes)
    roots = set().union(*(_imported_roots(n) for n in nodes))
    assert "numpy" in roots and not roots & set(FORBIDDEN), sorted(roots)


def test_scan_sees_the_package():
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"ops/ws_sweeps.py", "ops/watershed.py", "models/farneback.py", "pipeline.py",
            "ops/convolve.py", "ops/sobel.py", "ops/morphology.py", "ops/ccl.py",
            "core/flow.py", "models/variational.py", "segment/label.py",
            "detect/fused.py", "detect/detection.py", "detect/chain.py",
            "utils/labels.py"} <= names
    assert "tobac_flow_tpu" in set(_imported_roots(ast.parse("import tobac_flow_tpu.ops")))
