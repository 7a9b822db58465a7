#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's main path — the paper's autotuning loop with the CUDA
kernels as the tuned programs — and checks each kernel on the card:

  1. device: name, count, power limit; TF32 switched off for the yardsticks;
  2. build: both kernels from src/repro_torch/kernels/csrc/ with nvcc (sm_90a);
  3. kernel vs plain PyTorch version at the paper's LARGE sizes, over the
     knob combinations, with the tolerance stated beside each error;
  4. times at the default config (CUDA events, after warm-up): kernel,
     plain version, one PyTorch library call, and the roofline bound;
  5. the main path: `repro_torch.launch.autotune.main` campaigns for syr2k
     and mm3 at LARGE, whose kernel launch counts, OK share and best config
     are checked.

The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Any failed phase raises and the
script exits non-zero without that line. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# published H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores
# and HBM3 bandwidth — the roofline every bound_ms below is taken against
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Tolerances scaled to the outputs they hold. syr2k's entries are sums of
# 1000 unscaled products (|O| up to a few hundred); the JAX suite's atol
# 5e-3 stays, with an rtol of 1e-4. mm3's inputs are scaled by
# 1/sqrt(columns) (ref.init_mm3), so each product's entries are ~0.03: f32
# is held to 1e-5 + 1e-4*|want|, and bf16, which the kernel and its plain
# version round alike, to about 2 bf16 ulps (2^-7 relative each).
SYR2K_TOL = dict(atol=5e-3, rtol=1e-4)
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=1e-3, rtol=1.6e-2)

SYR2K_EVALS = 60
MM3_EVALS = 40


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def compare(name, got, want, tol) -> float:
    """Print and check max abs/rel error of ``got`` against ``want``."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} "
                             f"or non-finite output")
    diff = (g - w).abs()
    abs_err = diff.max().item()
    rel_err = (diff / w.abs().clamp_min(1e-6)).max().item()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * w.abs()).all())
    print(f"  {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
          f"tol=atol {tol['atol']:g} + rtol {tol['rtol']:g}*|want| -> "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return abs_err


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` back-to-back
    calls, between two CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def rejected_points(name: str, dims, limit: int) -> tuple[int, int]:
    """(rejected, total) points of the gpu space at ``dims`` that the
    wrappers refuse before launch: a tile whose shared memory (the kernel
    library's own count) exceeds ``limit``, or that the register tile cannot
    hold."""
    import itertools

    from repro_torch.kernels.matmul import matmul_smem_bytes
    from repro_torch.kernels.spaces import GPU_TILES, GPU_TILES_K
    from repro_torch.kernels.syr2k import syr2k_smem_bytes

    def refused(nbytes: int) -> bool:
        return nbytes < 0 or nbytes > limit

    tiles = list(itertools.product(GPU_TILES, GPU_TILES_K, GPU_TILES))
    if name == "syr2k":
        N, M = dims
        # 2x2x2 points per tile triple (pack_a, pack_b, interchange), as the
        # paper counts them; without pack_a, pack_b is inactive (not packed)
        packs = [(True, True), (True, False), (False, False), (False, False)]
        bad = sum(refused(syr2k_smem_bytes(min(bi, N), min(bj, N), min(bk, M), pa, pb))
                  for (bi, bk, bj) in tiles for (pa, pb) in packs) * 2
        return bad, len(tiles) * 8
    P, Q, R, S, T = dims
    shapes = [(P, Q, R), (R, S, T), (P, R, T)]
    bad = sum(any(refused(matmul_smem_bytes(min(bm, m), min(bn, n), min(bk, k)))
                  for (m, k, n) in shapes) for (bm, bk, bn) in tiles)
    return bad * 2 ** 7, len(tiles) * 2 ** 7


def run_campaign(kernel: str, evals: int, db: str) -> dict:
    """One `repro_torch.launch.autotune.main` campaign; echoes its output and
    returns the JSON summary it prints."""
    from repro_torch.launch import autotune

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = autotune.main(["--kernel", kernel, "--learner", "RF",
                            "--max-evals", str(evals), "--db", db])
    text = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"autotune {kernel} exited {rc}:\n{text}")
    head, _, body = text.partition("\n{")
    summary = json.loads("{" + body)
    print("  " + head.strip().splitlines()[-1], flush=True)
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout of "
              f"the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    from repro_torch.core.database import OK, PerformanceDatabase
    from repro_torch.kernels import build, ops, problems, ref
    from repro_torch.kernels.matmul import tiled_matmul, tiled_matmul_plain
    from repro_torch.kernels.syr2k import syr2k, syr2k_plain
    from repro_torch.kernels.util import max_shared_memory_per_block

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. device ------------------------------------------------------------
    phase("1. device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smem_limit = max_shared_memory_per_block(dev)
    print(f"  device: {kind} (count {count}), "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
          f"shared memory per block (opt-in): {smem_limit} B")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("  TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    print("  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    print(smi.splitlines()[0], flush=True)

    # ---- 2. build -------------------------------------------------------------
    phase("2. build")
    build_sec = build.build_all()
    print(f"  nvcc sm_90a build of syr2k.cu + matmul.cu (in parallel): {build_sec:.1f} s")
    for name in build.KERNELS:
        report = build.ptxas_report(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = [ln.strip() for ln in report.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"  ptxas {name}: {len(regs)} kernel instantiations, registers per "
              f"thread {min(regs, default=0)}..{max(regs, default=0)}, spills: "
              f"{spills or 'none'}")
    build.load("syr2k")
    build.load("matmul")

    # ---- 3. kernel vs plain at LARGE ------------------------------------------
    phase("3. kernel vs plain version on the card, LARGE")
    errs = {"syr2k": 0.0, "matmul": 0.0}
    syr2k_dims = problems.LARGE_SHAPES["syr2k"]
    C, A, B = problems.problem_inputs("syr2k", syr2k_dims, dev)
    want = syr2k_plain(C, A, B)
    base = dict(bi=64, bj=64, bk=32)
    cfgs = [dict(base, pack_a=pa, pack_b=pb, interchange=ic)
            for pa, pb in ((False, False), (True, False), (True, True))
            for ic in (False, True)]
    cfgs += [dict(bi=48, bj=80, bk=24, pack_a=True, pack_b=False),
             dict(bi=128, bj=112, bk=16, pack_a=True, pack_b=True, interchange=True),
             dict(bi=8, bj=24, bk=256, pack_a=False, pack_b=False)]
    for cfg in cfgs:
        got = syr2k(C, A, B, **cfg)
        torch.cuda.synchronize()
        errs["syr2k"] = max(errs["syr2k"], compare(f"syr2k {cfg}", got, want, SYR2K_TOL))

    P, Q, R, S, T = problems.LARGE_SHAPES["mm3"]
    Am, Bm, Cm, Dm = problems.problem_inputs("mm3", (P, Q, R, S, T), dev)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = Am.to(dtype), Bm.to(dtype)
        for pack in (True, False):
            for ic in (False, True):
                cfg = dict(bm=64, bn=64, bk=32, pack=pack, interchange=ic)
                got = tiled_matmul(a, b, **cfg)
                torch.cuda.synchronize()
                wantm = tiled_matmul_plain(a, b, bk=32, pack=pack, out_dtype=dtype)
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                errs["matmul"] = max(errs["matmul"], compare(
                    f"matmul {P}x{Q}@{Q}x{R} {str(dtype)[6:]} {cfg}", got, wantm, tol))
    got = tiled_matmul(Am, Bm, bm=48, bn=80, bk=24, pack=False, interchange=True)
    wantm = tiled_matmul_plain(Am, Bm, bk=24, pack=False, out_dtype=torch.float32)
    errs["matmul"] = max(errs["matmul"], compare(
        "matmul f32 ragged bm=48 bn=80 bk=24 pack=False interchange", got, wantm, F32_TOL))
    got = ops.mm3_op(Am, Bm, Cm, Dm, config=dict(fuse_second=True, pack2=False, inter3=True))
    errs["matmul"] = max(errs["matmul"], compare(
        "mm3 f32 fuse_second pack2=False inter3", got, ref.mm3_ref(Am, Bm, Cm, Dm), F32_TOL))
    for name, dims in (("syr2k", syr2k_dims), ("mm3", (P, Q, R, S, T))):
        bad, total = rejected_points(name, dims, smem_limit)
        print(f"  gpu space {name}: {bad} of {total} points rejected before launch "
              f"at LARGE (shared memory over {smem_limit} B)")

    # ---- 4. times at the default config ----------------------------------------
    phase("4. times at the default config, LARGE (L2-warm: the working set "
          "fits in the 50 MB L2, as in the paper's repeated runs)")
    N, M = syr2k_dims
    alpha, beta = 1.5, 1.2
    sy_cfg = ops.DEFAULTS["syr2k"]
    rows = {}
    # one product suffices (B A^T = (A B^T)^T): 2 N^2 M flops, though the
    # kernel computes both
    b_ms, b_by = bound(2.0 * N * N * M, 4.0 * (2 * N * M + 2 * N * N))
    rows["syr2k"] = dict(
        ms=time_ms(lambda: ops.syr2k_op(C, A, B, alpha, beta)),
        plain_ms=time_ms(lambda: syr2k_plain(C, A, B, alpha, beta)),
        library_ms=time_ms(lambda: torch.addmm(
            torch.addmm(C, A, B.T, beta=beta, alpha=alpha), B, A.T, alpha=alpha)),
        bound_ms=b_ms, bound_by=b_by)
    print(f"  syr2k {sy_cfg}: kernel {rows['syr2k']['ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), plain {rows['syr2k']['plain_ms']:.4f} ms, "
          f"library (2x torch.addmm, f32, no TF32) {rows['syr2k']['library_ms']:.4f} ms")

    def mm3_plain():
        E = tiled_matmul_plain(Am, Bm, bk=32, pack=True, out_dtype=torch.float32)
        F = tiled_matmul_plain(Cm, Dm, bk=32, pack=True, out_dtype=torch.float32)
        return tiled_matmul_plain(E, F, bk=32, pack=True, out_dtype=torch.float32)

    mm_flops = 2.0 * (P * Q * R + R * S * T + P * R * T)
    mm_bytes = 4.0 * ((P * Q + Q * R + P * R) + (R * S + S * T + R * T)
                      + (P * R + R * T + P * T))
    b_ms, b_by = bound(mm_flops, mm_bytes)
    rows["matmul"] = dict(
        ms=time_ms(lambda: ops.mm3_op(Am, Bm, Cm, Dm)),
        plain_ms=time_ms(mm3_plain),
        library_ms=time_ms(lambda: torch.matmul(torch.matmul(Am, Bm), torch.matmul(Cm, Dm))),
        bound_ms=b_ms, bound_by=b_by)
    print(f"  matmul x3 (mm3 f32) {ops.DEFAULTS['mm3']}: kernel {rows['matmul']['ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), plain {rows['matmul']['plain_ms']:.4f} ms, "
          f"library (3x torch.matmul, f32, no TF32) {rows['matmul']['library_ms']:.4f} ms",
          flush=True)

    # ---- 5. the main path --------------------------------------------------------
    phase("5. main path: repro_torch.launch.autotune campaigns at LARGE")
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for kernel, wrapper, evals, wname in (("syr2k", syr2k, SYR2K_EVALS, "syr2k"),
                                              ("mm3", tiled_matmul, MM3_EVALS, "matmul")):
            db = os.path.join(tmp, kernel)
            wrapper.launches = 0
            summary = run_campaign(kernel, evals, db)
            launches[wname] = wrapper.launches
            recs = PerformanceDatabase(db).records
            n_ok = sum(r.status == OK for r in recs)
            t, wall = summary["timings"], summary["wall_sec"]
            tuner = t["ask_sec"] + t["tell_sec"]
            timed = sum(sum(r.info.get("times_sec", ())) for r in recs)
            print(f"  {kernel}: {len(recs)} records, {n_ok} ok, {wrapper.__name__} "
                  f"launches {wrapper.launches}; best {summary['best_objective_sec'] * 1e3:.4f} ms "
                  f"at eval {summary['found_at_eval']} {summary['best_config']}; wall "
                  f"{wall:.2f} s ({len(recs) / wall:.1f} evals/s), ask {t['ask_sec']:.2f} s, "
                  f"tell {t['tell_sec']:.3f} s, wait {t['wait_sec']:.2f} s (tuner share "
                  f"{tuner / wall:.1%}); CUDA-event time of the timed runs "
                  f"{timed:.3f} s ({timed / wall:.1%} of wall)", flush=True)
            if len(recs) != evals:
                raise AssertionError(f"{kernel}: {len(recs)} records for {evals} evaluations")
            if wrapper.launches < n_ok:
                raise AssertionError(f"{kernel}: {wrapper.launches} launches < {n_ok} ok evals")
            if n_ok * 2 < evals:
                raise AssertionError(f"{kernel}: only {n_ok} of {evals} evaluations ok")
            best = summary["best_config"]
            if kernel == "syr2k":
                got, want = ops.syr2k_op(C, A, B, config=best), syr2k_plain(C, A, B)
                tol = SYR2K_TOL
            else:
                got, want = ops.mm3_op(Am, Bm, Cm, Dm, config=best), ref.mm3_ref(Am, Bm, Cm, Dm)
                tol = F32_TOL
            torch.cuda.synchronize()
            compare(f"{kernel} best config vs plain", got, want, tol)

    kernels = [
        dict(name="syr2k", route="cuda", source="src/repro_torch/kernels/csrc/syr2k.cu",
             replaces="src/repro/kernels/syr2k.py:32", launches=launches["syr2k"],
             max_abs_err=errs["syr2k"], **rows["syr2k"]),
        dict(name="matmul", route="cuda", source="src/repro_torch/kernels/csrc/matmul.cu",
             replaces="src/repro/kernels/matmul.py:34", launches=launches["matmul"],
             max_abs_err=errs["matmul"], **rows["matmul"]),
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was never launched on the main path")
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
