"""The port must run where JAX is absent: no module of
``tobac_flow_tpu_torch`` may import ``jax``, ``jaxlib`` or the JAX package
``tobac_flow_tpu``.  Checked on the source with an AST scan, because the
test interpreter itself may have JAX loaded already.  And ``chip_smoke.py``
must run where h5py is absent: no module on its import path imports h5py
when it is imported (writing a file imports it)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parent.parent / "tobac_flow_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tobac_flow_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"] + [
    PORT.parent / "tools" / name
    for name in ("torch_flood_memory.py", "torch_chunked_fixed_point.py",
                 "torch_goes_probe.py", "torch_scatter_min_forms.py",
                 "torch_legacy_probe.py", "torch_sharded_probe.py",
                 "torch_profile_probe.py")]


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


def _module_level(tree):
    """The module's statements outside function and class bodies."""
    todo, out = list(tree.body), []
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        out.append(node)
        todo.extend(ast.iter_child_nodes(node))
    return out


@pytest.mark.parametrize(
    "path", SOURCES + [PORT.parent / "bench.py", PORT.parent / "tools" / "parity_detect.py"],
    ids=lambda p: str(p.relative_to(PORT.parent)),
)
def test_no_module_level_h5py(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = {r for node in _module_level(tree)
             if isinstance(node, (ast.Import, ast.ImportFrom, ast.Call))
             for r in _imported_roots(node)}
    assert "h5py" not in roots, f"{path.name} imports h5py when it is imported"


def test_chip_smoke_imports_no_h5py():
    """Importing ``chip_smoke``, and so every module it uses, in a fresh
    interpreter loads no h5py."""
    code = "import sys, chip_smoke; print('h5py' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=PORT.parent, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "False", out.stdout


def test_scan_sees_the_package():
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"ops/ws_sweeps.py", "ops/watershed.py", "models/farneback.py", "pipeline.py",
            "ops/convolve.py", "ops/sobel.py", "ops/morphology.py", "ops/ccl.py",
            "core/flow.py", "models/variational.py", "segment/label.py",
            "detect/fused.py", "detect/detection.py", "detect/chain.py",
            "utils/labels.py", "utils/stats.py", "data/ncdataset.py", "schema/dataset.py",
            "cli/common.py", "cli/dcc_detect_synthetic.py", "device.py",
            "utils/datetime_utils.py", "utils/geo.py", "data/abi.py", "data/io.py",
            "data/dataloader.py", "data/dataset_utils.py", "cli/dcc_detect_goes.py",
            "track/__init__.py", "track/linking.py", "track/file_linker.py", "track/store.py",
            "cli/link_dcc_files.py", "cli/combine_dccs.py", "cli/linking_parallel.py",
            "cli/relabel_linked_files.py", "utils/filters.py", "schema/postprocess.py",
            "cli/relabel_postprocess.py", "cli/postprocess_dcc.py", "cli/quick_fix.py",
            "cli/dcc_statistics.py", "config.py", "utils/normalisation.py", "ops/warp.py",
            "models/dis.py", "models/tvl1.py", "models/deepflow.py", "models/pcaflow.py",
            "models/simpleflow.py", "models/sparse_to_dense.py",
            "segment/subsegment.py", "legacy.py", "decorators.py", "cli/dcc_detect_legacy.py",
            "data/nexrad.py", "data/nexrad_level2.py", "cli/grid_nexrad.py", "cli/grid_flux.py",
            "cli/grid_flux_native.py", "detect/__init__.py", "detect/analysis.py"} <= names
    # the time-chunked flood and the grouped stages live in these modules
    assert "_watershed_time_chunked" in (PORT / "ops" / "watershed.py").read_text()
    assert "group_size" in (PORT / "pipeline.py").read_text()
    # the GOES ingest's output dataset, and the statistics of a field
    assert "def create_new_goes_ds" in (PORT / "schema" / "dataset.py").read_text()
    assert "def get_bulk_stats" in (PORT / "schema" / "dataset.py").read_text()
    assert "tobac_flow_tpu" in set(_imported_roots(ast.parse("import tobac_flow_tpu.ops")))


CONFIGURED_PATH = (
    "tobac_flow_tpu_torch.config", "tobac_flow_tpu_torch.models.dis",
    "tobac_flow_tpu_torch.models.tvl1", "tobac_flow_tpu_torch.models.deepflow",
    "tobac_flow_tpu_torch.models.pcaflow", "tobac_flow_tpu_torch.models.simpleflow",
    "tobac_flow_tpu_torch.models.sparse_to_dense", "tobac_flow_tpu_torch.segment.subsegment",
    # the legacy path and the radar and flux gridding
    "tobac_flow_tpu_torch.legacy", "tobac_flow_tpu_torch.decorators",
    "tobac_flow_tpu_torch.detect", "tobac_flow_tpu_torch.cli.dcc_detect_legacy",
    "tobac_flow_tpu_torch.data.nexrad", "tobac_flow_tpu_torch.data.nexrad_level2",
    "tobac_flow_tpu_torch.cli.grid_nexrad", "tobac_flow_tpu_torch.cli.grid_flux",
    "tobac_flow_tpu_torch.cli.grid_flux_native",
)


@pytest.fixture(scope="module")
def imported_without_jax():
    """Each module of the configured flow path imported in one fresh
    interpreter where importing JAX fails: the modules that imported."""
    code = ("import importlib, sys; sys.modules['jax'] = None; "
            "sys.modules['tobac_flow_tpu'] = None\n"
            f"for name in {CONFIGURED_PATH!r}:\n"
            "    try:\n        importlib.import_module(name)\n        print(name)\n"
            "    except ImportError as err:\n        print(name, 'failed:', err, file=sys.stderr)")
    out = subprocess.run([sys.executable, "-c", code], cwd=PORT.parent, check=True,
                         capture_output=True, text=True, timeout=120)
    return set(out.stdout.split()), out.stderr


@pytest.mark.parametrize("module", CONFIGURED_PATH)
def test_new_modules_import_without_jax(module, imported_without_jax):
    """Each module of the configured flow path, the legacy path and the
    gridding imports where JAX does not."""
    imported, errors = imported_without_jax
    assert module in imported, errors
