"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes). The build runs
at first use, from the sources in this checkout only, into
``kernels/build/<name>-<hash>/`` (listed in ``.gitignore``); the hash covers
the source, the shared headers ``csrc/*.cuh`` and the compiler flags, so an
edited kernel or header is rebuilt and an unchanged one is loaded as it is. A missing ``nvcc`` or a failed compile
raises: there is no fallback.

    from repro_torch.kernels import build
    seconds = build.build_all()          # every kernel, compiled in parallel
    lib = build.load("syr2k")            # ctypes.CDLL, argtypes declared
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KERNELS", "NVCC_FLAGS", "SECONDS", "arm_launch_mark", "build_all", "check",
           "disarm_launch_mark", "load", "mark_end", "mark_launch", "nvcc_path", "ptxas_entries",
           "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# source name -> {C function: (argtypes, restype)}. The launchers return a
# cudaError_t; *_smem_bytes return the bytes of dynamic shared memory a block
# needs (-1 for a tile the kernel cannot hold), from the kernel's own layout;
# syr2k's, matmul's, covariance's and flash_attention's take the device's
# limit, which sets their rings' depth.
KERNELS: dict[str, dict[str, tuple[list, type]]] = {
    "syr2k": {
        # C, A, B, O, N, M, alpha, beta, bi, bj, bk, pack_a, pack_b, interchange,
        # smem limit, stream
        "syr2k_launch": ([_P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        # bi, bj, bk, pack_a, pack_b, smem limit
        "syr2k_smem_bytes": ([_I, _I, _I, _I, _I, _I], _L),
    },
    "matmul": {
        # A, B, O, M, K, N, bm, bn, bk, pack, interchange, in_bf16, out_bf16,
        # smem limit, stream, the route taken (out: 1 the tensor cores, 0 FFMA)
        "matmul_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                           ctypes.POINTER(_L)], _I),
        # bm, bn, bk, in_bf16, smem limit
        "matmul_smem_bytes": ([_I, _I, _I, _I, _I], _L),
    },
    "covariance": {
        # data, mean, O, N, M, bi, bj, bk, fuse_center, interchange, smem limit,
        # stream
        "covariance_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        # bi, bj, bk, smem limit
        "covariance_smem_bytes": ([_I, _I, _I, _I], _L),
    },
    "floyd_warshall": {
        # D, ldd, A, lda, B, ldb, O, ldo, n, m, bs, bi, bj, unroll, smem limit,
        # stream
        "minplus_launch": ([_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                           _I),
        # bi, bj, bs, smem limit
        "minplus_smem_bytes": ([_I, _I, _I, _I], _L),
        # D, ld, off, bs, stream: the in-block closure, in place
        "closure_launch": ([_P, _I, _I, _I, _P], _I),
    },
    "heat3d": {
        # A, O, T, n0, n1, n2, bi, fuse_t, passes, stream
        "heat3d_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
        # n0, n1, n2, bi, fuse_t, out[4] <- tile rows, blocks, threads and
        # shared memory bytes of one pass on this card
        "heat3d_plan": ([_I, _I, _I, _I, _I, ctypes.POINTER(_L)], _I),
    },
    "flash_attention": {
        # q, k, v, o, BH, Sq, Sk, hd, bq, bk, scale, causal, bf16, smem limit,
        # stream
        "flash_attention_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
                                   _I),
        # bq, bk, hd, bf16, smem limit
        "flash_attention_smem_bytes": ([_I, _I, _I, _I, _I], _L),
    },
    "decode_attention": {
        # q, k, v, cur_pos, o, workspace, counters, BH, G, S, hd, Kh, stride_b,
        # stride_s, stride_h, heads of a q/o row, bk, hg, nsplit, ring, window, scale,
        # bf16, stream
        "decode_attention_launch": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L,
                                     _L, _I, _I, _I, _I, _I, _I, _F, _I, _P], _I),
        # G, bk, hd, bf16
        "decode_attention_smem_bytes": ([_I, _I, _I, _I], _L),
        # BH, S, bk, hg, SM count -> splits of the key axis
        "decode_attention_splits": ([_I, _I, _I, _I, _I], _I),
        # BH, G, hd, nsplit -> bytes of f32 partials
        "decode_attention_workspace_bytes": ([_I, _I, _I, _I], _L),
    },
    "lu": {
        # A, ld, off, bs, stream: the diagonal-block factor, in place
        "lu_factor_diag_launch": ([_P, _I, _I, _I, _P], _I),
        # bs
        "lu_factor_diag_smem_bytes": ([_I], _L),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (searched PATH and $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built on this machine")


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, every shared header
    in ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def _start(name: str, nvcc: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _target(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a library


def build_all(names=None) -> float:
    """Compile every kernel not yet built for the current sources, one
    ``nvcc`` per source, all started together. Returns the wall seconds;
    :data:`SECONDS` maps each source compiled to the seconds its ``nvcc``
    took."""
    names = list(KERNELS if names is None else names)
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if not _target(n).exists()]
        if todo:
            nvcc = nvcc_path()
            started = [(n, *_start(n, nvcc)) for n in todo]
            errors: dict[str, str] = {}

            def finish(n, proc, tmp, out):  # one thread per nvcc: each is timed alone
                try:
                    _finish(n, proc, tmp, out)
                except RuntimeError as e:
                    errors[n] = str(e)
                SECONDS[n] = time.perf_counter() - t0

            # daemon: joined just below, so the flag only keeps an interrupted
            # build from holding the interpreter open on a stuck nvcc
            threads = [threading.Thread(target=finish, args=job, daemon=True)
                       for job in started]
            for t in threads:
                t.start()
            for t in threads:  # wait for every nvcc, then report
                t.join()
            if errors:
                raise RuntimeError("\n".join(errors[n] for n in todo if n in errors))
    return time.perf_counter() - t0


SECONDS: dict[str, float] = {}  # source -> nvcc seconds of its last build in this process


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (argtypes, restype) in KERNELS[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return _loaded[name]


def ptxas_report(name: str) -> str:
    """``nvcc -Xptxas -v`` output of the last build of ``name`` (registers,
    shared memory and spills per kernel instantiation)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_NAME = re.compile(r"(?=(\d{1,3})([A-Za-z_]\w*?_kernel)I)")
_TEMPLATE_ARG = re.compile(r"L[bi](\d+)E|(f)(?=L)|13__nv_(bfloat16)")


def ptxas_entries(report: str) -> list[dict]:
    """One dict per kernel instantiation of a ``ptxas -v`` report:
    ``kernel`` (the unmangled name), ``args`` (its template arguments, as
    ``float``/``bfloat16`` and integers, bools as 0/1), ``registers``,
    ``spill_stores`` and ``spill_loads`` (bytes)."""
    out: list[dict] = []
    for line in report.splitlines():
        if m := _ENTRY.search(line):
            mangled = m.group(1)
            # the name is a length-prefixed <n><identifier> ending in _kernel;
            # the anonymous namespace before it may end in digits too
            name = next((m.group(2) for m in _NAME.finditer(mangled)
                         if int(m.group(1)) == len(m.group(2))), None)
            body = mangled.split("_kernelI", 1)[1] if "_kernelI" in mangled else ""
            args = [int(a) if a else ("float" if f else "bfloat16")
                    for a, f, b in _TEMPLATE_ARG.findall(body)]
            out.append(dict(kernel=name or mangled, args=args,
                            registers=0, spill_stores=0, spill_loads=0))
        elif out and (m := _SPILL.search(line)):
            out[-1]["spill_stores"], out[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif out and (m := _REGS.search(line)):
            out[-1]["registers"] = int(m.group(1))
    return out


class _Marks(threading.local):
    """This thread's armed marks. The class defaults make a read on a
    thread that never armed one a plain lookup, where ``getattr`` with a
    default on a bare ``threading.local`` raises and catches an exception
    inside, on every launch of a host-paced driver's hundreds."""

    pending = None  # (start event, stream, lead) until the first mark fires
    end = None  # (end event, stream) while armed
    ended = False  # the end mark was recorded
    fired_at = 0.0  # perf_counter when the first mark fired (its lead queued)
    lead_sec = None  # host seconds from the first mark to the first launch's return


_marks = _Marks()


def arm_launch_mark(event, stream, end=None, lead=None) -> None:
    """Have the next call's first device operation on this thread record
    ``event`` on ``stream`` just before it, and each launch after that
    record ``end`` just after it (:func:`mark_end`): an evaluator's run and
    a shadow sample (:class:`repro_torch.core.plopper.LaunchClock`) are
    timed between the two, so the host's Python path before the call's
    first device operation and after its last is not in the time.
    ``lead``, when given, runs on the host just before the first mark is
    recorded (the clock queues a short spin there, so that the host
    enqueues the call while the device is busy)."""
    _marks.pending = (event, stream, lead)
    _marks.end = None if end is None else (end, stream)
    _marks.ended = False


def mark_launch() -> None:
    """Called by every wrapper just before its launcher, and by a card path
    that runs torch work ahead of its first launch (a mean, a padded copy,
    a memset) before that work: records an armed launch mark, once (one
    thread-local read when none is armed)."""
    pending = _marks.pending
    if pending is not None:
        _marks.pending = None
        event, stream, lead = pending
        _marks.fired_at = time.perf_counter()
        if lead is not None:
            lead()
        event.record(stream)


def mark_end() -> None:
    """Called by :func:`check` after every launch, and by a card path that
    runs torch work after its last launch (a copy out of a padded buffer)
    after that work: records the armed end mark again, once the call's first
    mark has fired, so that the last record is the call's last device
    operation."""
    end = _marks.end
    if end is not None and _marks.pending is None:
        end[0].record(end[1])
        if not _marks.ended:
            _marks.lead_sec = time.perf_counter() - _marks.fired_at
        _marks.ended = True


def disarm_launch_mark() -> tuple[bool, bool]:
    """Disarms this thread's marks; returns whether the first mark fired and
    whether the end mark was recorded after it."""
    fired, ended = _marks.pending is None, _marks.ended
    _marks.pending = _marks.end = None
    _marks.ended = False
    return fired, ended


def lead_host_sec() -> float | None:
    """Host seconds from this thread's last first mark to the return of its
    call's first launch (the path a timed call's lead spin has to cover),
    or None when no armed call has launched since the last read."""
    sec, _marks.lead_sec = _marks.lead_sec, None
    return sec


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by one of ``lib``'s
    launchers; after a launch, the armed end mark (:func:`mark_end`)."""
    mark_end()
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: cudaError_t {err} ({msg})")
