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
            "torch_tables.py", "torch_common.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"
        # the port's benchmarks import only the port's benchmark modules
        parts = mod.split(".")
        if top == "benchmarks" and len(parts) > 1:
            assert parts[1].startswith("torch_"), f"{path.relative_to(ROOT)} imports {mod}"
