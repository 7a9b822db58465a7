"""The port stands alone: no module under src/repro_torch/, no
benchmarks/torch_*.py and not chip_smoke.py imports jax, the JAX package or
one of its benchmark modules (benchmarks/common.py imports JAX)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "benchmarks").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
            if node.module == "benchmarks":  # from benchmarks import <module>
                yield from (f"benchmarks.{alias.name}" for alias in node.names)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"plopper.py", "syr2k.py", "matmul.py", "autotune.py", "chip_smoke.py",
            "torch_tables.py", "torch_common.py", "mla.py", "moe.py", "ssm.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"
        # the port's benchmarks import only the port's benchmark modules
        parts = mod.split(".")
        if top == "benchmarks" and len(parts) > 1:
            assert parts[1].startswith("torch_"), f"{path.relative_to(ROOT)} imports {mod}"


# ---------------------------------------------------------------------------
# completeness: every module and benchmark of the JAX package has a
# counterpart in the port
# ---------------------------------------------------------------------------

REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
# reference module -> the port's counterpart, where the names differ
MODULE_MAP = {
    # the port runs eager PyTorch: no HLO text to parse; its collectives are
    # the c10d operators a dispatch mode sees
    "perf/hlo.py": "perf/collectives.py",
    # an op-level counter under a dispatch mode in place of the HLO walker
    "perf/hlo_cost.py": "perf/op_cost.py",
}
BENCHMARK_MAP = {
    # the kernels' tuning on the Hopper cost model in place of Pallas' on v5e
    "pallas_tuning.py": "torch_kernel_tuning.py",
    # the port's shared machinery (common.py imports JAX)
    "common.py": "torch_common.py",
}
# names of this slice's reference modules -> the port's, where they differ
NAME_MAP = {
    "lower_cell": "build_cell",           # traces a DTensor step instead of lowering
    "analyze_compiled": "analyze_step",   # from a counted Cost, not a compiled module
    "score_lowered": "score_cell",
    "module_cost": "step_cost",
    "parse_module": "trace_step",
    "parse_collectives": "collective_kind",  # per c10d operator, not per HLO line
    "shape_bytes": "tensor_bytes",
}
SLICE_MODULES = ("core/plopper.py", "core/__init__.py", "models/model.py",
                 "models/__init__.py", "parallel/sharding.py", "parallel/__init__.py",
                 "launch/mesh.py", "launch/__init__.py", "launch/cells.py", "launch/dryrun.py",
                 "perf/roofline.py", "perf/hlo.py", "perf/hlo_cost.py", "perf/__init__.py")


def _all_names(path: pathlib.Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AugAssign) else []
        if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
            out |= set(ast.literal_eval(node.value))
    return out


def _top_level_names(path: pathlib.Path) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in node.names}
    return out


@pytest.mark.parametrize("rel", sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")))
def test_every_reference_module_has_a_port_counterpart(rel):
    assert (PORT / MODULE_MAP.get(rel, rel)).is_file(), rel


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "benchmarks").glob("*.py")
                                        if not p.name.startswith("torch_")))
def test_every_reference_benchmark_has_a_port_counterpart(name):
    assert (ROOT / "benchmarks" / BENCHMARK_MAP.get(name, f"torch_{name}")).is_file(), name


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_the_slices_reference_names_exist_in_the_port(rel):
    """Every public name of this slice's reference modules (plopper's
    CostModelEvaluator and model's abstract_params among them) is defined in
    the port's counterpart, under the name NAME_MAP gives where it differs."""
    have = _top_level_names(PORT / MODULE_MAP.get(rel, rel))
    missing = {n for n in _all_names(REF / rel) if NAME_MAP.get(n, n) not in have}
    assert not missing, (rel, sorted(missing))


def test_the_name_checks_cover_the_evaluator_and_abstract_params():
    assert "CostModelEvaluator" in _all_names(PORT / "core" / "plopper.py")
    assert "CostModelEvaluator" in _all_names(PORT / "core" / "__init__.py")
    assert "abstract_params" in _all_names(PORT / "models" / "model.py")
    assert "abstract_params" in _all_names(PORT / "models" / "__init__.py")
