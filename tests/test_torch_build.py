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
    "long long*": ctypes.POINTER(ctypes.c_longlong),
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


def test_target_hash_covers_the_shared_headers(monkeypatch, tmp_path):
    # a source may include any csrc/*.cuh: editing one rebuilds every source
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._target("k")
    assert build._target("k") == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = build._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert build._target("k") not in (first, second)


@pytest.mark.parametrize("name", list(build.KERNELS))
def test_included_headers_exist(name):
    src = (build.CSRC / f"{name}.cu").read_text()
    for header in re.findall(r'#include "([^"]+)"', src):
        assert (build.CSRC / header).is_file(), f"csrc/{name}.cu includes a missing {header}"


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112syr2k_kernelILb1ELb1ELi4ELb1EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112syr2k_kernelILb1ELb1ELi4ELb1EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 106 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113matmul_kernelI13__nv_bfloat16Lb0ELi4ELi4ELb0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113matmul_kernelI13__nv_bfloat16Lb0ELi4ELi4ELb0EEEvNS_4ArgsE
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__bcca10_9_matmul_cu_a1044b9513matmul_kernelIfLb1ELi1ELi4ELb1EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Used 40 registers, used 1 barriers
"""


def test_ptxas_entries_reads_each_instantiation():
    got = build.ptxas_entries(PTXAS_LOG)
    assert got == [
        dict(kernel="syr2k_kernel", args=[1, 1, 4, 1], registers=106, spill_stores=0,
             spill_loads=0),
        dict(kernel="matmul_kernel", args=["bfloat16", 0, 4, 4, 0], registers=80,
             spill_stores=4, spill_loads=8),
        dict(kernel="matmul_kernel", args=["float", 1, 1, 4, 1], registers=40,
             spill_stores=0, spill_loads=0),
    ]
    assert build.ptxas_entries("") == []
