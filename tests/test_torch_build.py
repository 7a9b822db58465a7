"""The ctypes bindings of repro_torch.kernels.build against the C interfaces
of the CUDA sources they load, and the build's refusal without nvcc. Runs
without a card: the sources are read as text, nothing is compiled."""

import collections
import ctypes
import re
import types

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


class _Event:
    def __init__(self):
        self.streams = []

    def record(self, stream=None):
        self.streams.append(stream)


def test_launch_mark_records_once_and_disarms():
    ev, end, leads = _Event(), _Event(), []
    build.mark_launch()  # none armed: nothing happens
    build.mark_end()
    build.arm_launch_mark(ev, "stream")
    build.mark_launch()
    build.mark_launch()  # a call's later launches leave the first mark alone
    assert ev.streams == ["stream"]
    assert build.disarm_launch_mark() == (True, False)
    build.arm_launch_mark(ev, "stream")
    assert build.disarm_launch_mark() == (False, False)  # armed, but nothing launched
    build.mark_launch()
    assert ev.streams == ["stream"]
    # the end mark: recorded after every launch once the first mark fired,
    # so its last record is the call's last launch; the lead runs once,
    # just before the first mark
    build.arm_launch_mark(ev, "s", end=end, lead=lambda: leads.append(len(ev.streams)))
    build.mark_end()  # before the call's first device operation: not yet
    assert end.streams == [] and leads == []
    build.mark_launch()
    build.mark_end()
    build.mark_launch()
    build.mark_end()
    assert leads == [1] and ev.streams == ["stream", "s"] and end.streams == ["s", "s"]
    assert build.disarm_launch_mark() == (True, True)
    build.mark_end()
    assert end.streams == ["s", "s"]


def test_lead_host_sec_is_the_path_from_the_first_mark_to_the_first_launch(monkeypatch):
    ev, end = _Event(), _Event()
    now = [10.0]
    monkeypatch.setattr(build, "time", types.SimpleNamespace(perf_counter=lambda: now[0]))
    build.lead_host_sec()  # whatever an earlier test left
    build.arm_launch_mark(ev, "s", end=end)
    now[0] = 11.0
    build.mark_launch()  # the first mark: the path starts
    now[0] = 11.25
    build.mark_end()  # the first launch returned
    now[0] = 12.0
    build.mark_launch()
    build.mark_end()  # a later launch leaves the path alone
    assert build.disarm_launch_mark() == (True, True)
    assert build.lead_host_sec() == 0.25
    assert build.lead_host_sec() is None  # read once
    build.arm_launch_mark(ev, "s", end=end)
    build.mark_launch()
    assert build.disarm_launch_mark() == (True, False)  # no launch: no path
    assert build.lead_host_sec() is None


def test_lead_cycles_follow_the_hosts_path(monkeypatch):
    from repro_torch.core import plopper

    paths = collections.deque(maxlen=32)
    monkeypatch.setattr(plopper, "_lead_paths", paths)
    assert plopper.lead_cycles() == plopper.LEAD_CYCLES  # no timed call yet
    paths.extend([20e-6] * 9)  # a fast host: the fixed spin covers twice its path
    assert plopper.lead_cycles() == plopper.LEAD_CYCLES
    paths.extend([150e-6] * 10 + [5e-3] * 3)  # a slow host, and a few stalls
    assert plopper.lead_cycles() == int(2 * 150e-6 / plopper.LEAD_SEC * plopper.LEAD_CYCLES)
    paths.extend([1.0] * 32)  # never more than the cap
    assert plopper.lead_cycles() == plopper.LEAD_MAX_CYCLES


class _Lib:
    @staticmethod
    def cuda_error_string(err):
        return b"an error"


def test_check_records_the_end_mark_after_a_launch():
    ev, end = _Event(), _Event()
    build.arm_launch_mark(ev, "s", end=end)
    build.mark_launch()
    build.check(_Lib, 0, "kernel")
    with pytest.raises(RuntimeError, match="an error"):
        build.check(_Lib, 1, "kernel")
    assert end.streams == ["s", "s"]
    assert build.disarm_launch_mark() == (True, True)


@pytest.mark.parametrize("module", ["floyd_warshall", "flash_attention", "lu"])
def test_a_copy_after_the_last_launch_is_marked(module):
    # a card path that copies its result out of a padded buffer after its
    # last launch records the end mark after the copy
    src = (build.CSRC.parent / f"{module}.py").read_text().splitlines()
    copies = [i for i, line in enumerate(src) if re.search(r"\[.*:N.*\]\.contiguous\(\)|"
                                                          r"\[\.\.\., :hd\]\.contiguous\(\)",
                                                          line)]
    assert copies
    for i in copies:
        assert src[i + 1].strip().startswith("build.mark_end()"), (module, i + 1, src[i])


WRAPPERS = ("covariance", "decode_attention", "flash_attention", "floyd_warshall", "heat3d",
            "lu", "matmul", "syr2k")


@pytest.mark.parametrize("module", WRAPPERS)
def test_every_launcher_call_is_marked(module):
    # a shadow sample starts at its call's first launch only if every
    # wrapper marks the launch just before calling its launcher
    src = (build.CSRC.parent / f"{module}.py").read_text().splitlines()
    calls = [i for i, line in enumerate(src) if re.search(r"\blib\.\w+_launch\(", line)]
    assert calls
    for i in calls:
        assert src[i - 1].strip() == "build.mark_launch()", (module, i + 1, src[i])
