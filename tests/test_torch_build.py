"""The ctypes bindings of repro_torch.kernels.build against the C interfaces
of the CUDA sources they load, and the build's refusal without nvcc. Runs
without a card: the sources are read as text, nothing is compiled."""

import ctypes
import re

import pytest

from repro_torch.kernels import build

C_TYPES = {
    "int": ctypes.c_int,
    "float": ctypes.c_float,
    "long long": ctypes.c_longlong,
    "void*": ctypes.c_void_p,
    "const void*": ctypes.c_void_p,
}

EXTERN_C = re.compile(r'extern "C" ([^(]+?)\s*\b(\w+)\(([^)]*)\)')
PARAM = re.compile(r"^(.*?)\s*\b\w+$")  # a parameter's type: all but its name


def _c_type(text: str) -> str:
    return re.sub(r"\s*\*", "*", " ".join(text.split()))


def _c_functions(name: str) -> dict[str, tuple[str, list[str]]]:
    """{function: (return type, [parameter types])} of the extern "C"
    definitions in csrc/<name>.cu."""
    src = (build.CSRC / f"{name}.cu").read_text()
    return {fn: (_c_type(ret), [_c_type(PARAM.match(p.strip()).group(1))
                                for p in params.split(",") if p.strip()])
            for ret, fn, params in EXTERN_C.findall(src)}


BOUND = [(name, fn) for name, fns in build.KERNELS.items() for fn in fns]


@pytest.mark.parametrize("name,fn", BOUND, ids=[fn for _, fn in BOUND])
def test_binding_matches_c_signature(name, fn):
    argtypes, restype = build.KERNELS[name][fn]
    funcs = _c_functions(name)
    assert fn in funcs, f"csrc/{name}.cu defines no extern \"C\" {fn}"
    ret, params = funcs[fn]
    assert C_TYPES[ret] is restype
    assert [C_TYPES[t] for t in params] == argtypes


@pytest.mark.parametrize("name", list(build.KERNELS))
def test_every_exported_function_is_bound(name):
    exported = set(_c_functions(name)) - {"cuda_error_string"}
    assert exported == set(build.KERNELS[name])


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
