#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's main path — the paper's autotuning loop with the CUDA
kernels as the tuned programs, for all six of the paper's benchmarks — and
checks each kernel on the card:

  1. device: name, count, power limit; TF32 switched off for the yardsticks;
  2. build: every source in src/repro_torch/kernels/csrc/ with nvcc (sm_90a),
     one nvcc per source, all started together, each one's seconds; ptxas
     registers and spills, per instantiation for syr2k, matmul, covariance,
     floyd_warshall, heat3d, flash_attention (hd 16 to 256) and
     decode_attention (every multiple of 16 up to 256) (the main paths'
     spill nothing);
  3. kernel vs plain PyTorch version at the paper's LARGE sizes, over the
     knob combinations, with the tolerance stated beside each error (0 for
     the min-plus kernel on views and in place, the blocked Floyd-Warshall
     at every bs of the gpu space, heat3d at every point of its space and
     the two helpers, which must agree bit for bit; syr2k and covariance on NaN-poisoned
     outputs, with the same bits from every configuration, covariance's
     exactly symmetric; the matmul also at the model's skinny shapes; the
     3xTF32 tensor-core matmul's largest error in each tolerance class, over
     its matmul, mm3 and lu cases: the probe of that route), and the
     gpu-space points each wrapper rejects before launch;
  4. times at the default config (CUDA events, after warm-up): kernel,
     plain version, one PyTorch library call where there is one, and the
     roofline bound (and the flops syr2k and covariance compute beside
     it); the matmul also at the serving path's shapes (device time,
     torch.profiler); decode_attention's split of the key axis and its
     workspace, and its device time at the model's shape; for
     lu, floyd_warshall and heat3d also the kernel launches, the host wall
     time and the device time (torch.profiler) per call; Floyd-Warshall's
     device time split into panels, trailing updates, closures and copies,
     heat3d's per pass beside its events time and a library yardstick
     (1,000 F.conv3d steps, timed together);
  5. the main path: `repro_torch.launch.autotune.main` campaigns at LARGE
     for syr2k, mm3, lu, covariance, floyd_warshall and heat3d, each with
     its wrappers' launch counts set to 0 just before and read just after,
     whose launch counts, OK share and best config are checked;
  6. the serving path: `repro_torch.launch.serve` on qwen2-0.5b at full
     width in f32 (batch 4, prompt 256, 32 new tokens, random weights from a
     seed) through the dispatch service, with the launch counts set to 0
     just before and read just after: flash_attention per prefill forward,
     decode_attention and matmul per decode step are asserted; memory,
     prefill, TTFT, ms per decode step beside its bound, tokens/s and the
     device's busy share of one decode step; a PagedKVCache round whose
     tokens must equal each request's solo greedy_decode; and a short run on
     the card against the same weights on the CPU (plain versions there).

Phases 3 and 4 also hold flash_attention and decode_attention against their
plain versions at LARGE, at head_dim 256, at head sizes between the
instantiations (80, 96, 112, 160, 192; decode also with more query heads
than one launch takes) and at the model's shapes, and time
them beside
scaled_dot_product_attention (a yardstick only: the port never calls it);
decode_attention with per-row positions that leave whole splits of the key
axis empty, rows at cur_pos = -1 exactly 0, and repeated calls (also after a
call at another BH) bit-identical.

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
# the tiled matmul's f32 path past 8 rows runs on the tensor cores in
# 3xTF32 (csrc/gemm_tf32.cuh): three TF32 products per f32 product, so its
# peak is a third of the data sheet's 495 TFLOP/s dense TF32
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# f32 minimum: the CUDA C Programming Guide's arithmetic-instruction
# throughput table gives compute capability 9.0 128 f32 add/multiply/FMA
# results but 64 compare/minimum/maximum results per clock and SM, so min is
# a quarter of the 67 TFLOP/s (which counts an FFMA as two operations);
# Floyd-Warshall's add issues beside it, on the FMA pipe
PEAK_F32_MIN = PEAK_F32_FLOPS / 4

# Tolerances scaled to the outputs they hold. syr2k's entries are sums of
# 1000 unscaled products (|O| up to a few hundred); the JAX suite's atol
# 5e-3 stays, with an rtol of 1e-4. mm3's inputs are scaled by
# 1/sqrt(columns) (ref.init_mm3), so each product's entries are ~0.03: f32
# is held to 1e-5 + 1e-4*|want|, and bf16, which the kernel and its plain
# version round alike, to about 2 bf16 ulps (2^-7 relative each).
SYR2K_TOL = dict(atol=5e-3, rtol=1e-4)
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=1e-3, rtol=1.6e-2)
# covariance of standard normal data: ~1 on the diagonal, ~0.03 off it; each
# entry sums 1400 products. lu's entries run up to N=2000 on the diagonal;
# against its plain version (the same blocked schedule, the GEMM in cuBLAS)
# only the trailing GEMMs' summation order differs; against the unblocked
# lu_ref the triangular solves and the updates associate differently, so it
# keeps the JAX suite's 5e-3. Floyd-Warshall's path lengths are sums of a
# few edges in [1, 10): against the unblocked reference they differ by the
# rounding of the adds' association. heat3d's values lie in [0, 1].
COV_TOL = F32_TOL
LU_TOL = dict(atol=1e-5, rtol=1e-6)
LU_REF_TOL = dict(atol=5e-3, rtol=1e-5)
FW_REF_TOL = dict(atol=1e-5, rtol=1e-6)
HEAT_TOL = dict(atol=1e-6, rtol=0.0)
EXACT = dict(atol=0.0, rtol=0.0)

# Attention outputs are softmax-weighted averages of standard normal values
# (|O| up to ~4); the kernels and their plain versions differ only in the
# order of the f32 sums and in expf against torch.exp (an ulp), so they are
# held to 2e-5 + 1e-4*|want|; bf16 outputs, rounded alike from f32 on both
# sides, differ by at most one bf16 ulp (2^-7 relative at worst: rtol 8e-3,
# with atol 1e-4 for outputs near 0; measured 6.1e-5 at (4, 200, 128)
# causal on an H100 80GB HBM3 at 700 W). The serving logits of 24 f32
# layers on the card (CUDA kernels, cuBLAS) against the CPU (plain versions,
# CPU BLAS) differ by the summation orders of every product on the way:
# held to 1e-3 + 1e-3*|want| (|logits| ~ 1), with the greedy tokens equal.
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
ATTN_BF16_TOL = dict(atol=1e-4, rtol=8e-3)
LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)

# the kernels line's names -> the wrapper that counts their launches
WRAPPER_OF = {"syr2k": "syr2k", "matmul": "tiled_matmul", "covariance": "covariance",
              "minplus": "minplus_update", "heat3d": "heat3d",
              "lu_factor_diag": "lu_factor_diag", "closure": "closure_in_block",
              "flash_attention": "flash_attention", "decode_attention": "decode_attention"}
# the serving phase: qwen2-0.5b at full width, f32
SERVE = dict(arch="qwen2-0.5b", batch=4, prompt_len=256, gen=32, seed=0)
# the instantiations the main paths run at their defaults (ptxas template
# arguments): syr2k<PACK_A, PACK_B, RT, VEC16> at 64x64 tiles of M = 1000;
# matmul_tf32<PACK, VEC16> (f32 on the tensor cores) at 64x64 tiles (mm3,
# lu, the prefill unembed) and matmul<input, PACK, TM, TN, VEC16> (FFMA) at
# the model's 8-row decode tiles; covariance<FUSE_CENTER, RT, VEC16> at
# 64x64 tiles of M = 1200; flash<dtype, hd, CAUSAL> and decode<dtype, hd,
# VEC16> at the model's f32, hd 64; minplus<TM, TN, UNROLL, VEC16> at unroll
# 4 for the default 64x64 trailing tiles (8x4) and the 64x16 panels (4x4);
# heat3d<FUSE_T, VEC16> at fuse_t 2 on N = 120; phase 2 asserts that they
# spill nothing (the other instantiations' spills are printed)
MAIN_PATH_INSTANCES = {"syr2k": ([1, 1, 4, 1],),
                       "matmul": ([1, 1], ["float", 1, 1, 4, 1]),
                       "covariance": ([1, 4, 1],),
                       "floyd_warshall": ([8, 4, 4, 1], [4, 4, 4, 1]),
                       "heat3d": ([2, 1],),
                       "flash_attention": (["float", 64, 1],),
                       "decode_attention": (["float", 64, 1],)}
# the serving path's matmul shapes (qwen2-0.5b, batch 4, prompt 256): name,
# (M, K, N), launches per decode step (or per prefill forward)
SERVE_MATMULS = (("decode unembed", (4, 896, 151936), "1 per decode step"),
                 ("decode output projection", (4, 896, 896), "24 per decode step"),
                 ("prefill unembed", (1024, 896, 151936), "1 per prefill forward"))
# (kernel, evaluations) of phase 5; heat3d's space has 12 points
CAMPAIGNS = (("syr2k", 60), ("mm3", 40), ("lu", 30), ("covariance", 30),
             ("floyd_warshall", 30), ("heat3d", 12))


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def compare(name, got, want, tol, probe=None) -> float:
    """Print and check max abs/rel error of ``got`` against ``want``. With
    ``probe`` = (dict, tolerance class), also record there the largest
    max_abs_err and error / tolerance of the class."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} "
                             f"or non-finite output")
    diff = (g - w).abs()
    abs_err = diff.max().item()
    rel_err = (diff / w.abs().clamp_min(1e-6)).max().item()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * w.abs()).all())
    if probe is not None:
        share = (diff / (tol["atol"] + tol["rtol"] * w.abs())).max().item()
        prev = probe[0].get(probe[1], (0.0, 0.0))
        probe[0][probe[1]] = (max(prev[0], abs_err), max(prev[1], share))
    print(f"  {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
          f"tol=atol {tol['atol']:g} + rtol {tol['rtol']:g}*|want| -> "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return abs_err


def poison_next(shape, device) -> None:
    """Free a NaN-filled f32 block of ``shape``: the caching allocator hands
    it to the next allocation of that size, so an output element that a
    kernel never writes reads NaN and fails the finite check."""
    import torch

    torch.full(shape, float("nan"), device=device)


def model_operands(M: int, K: int, N: int, device, seed: int = 0):
    """x (M, K) and w (K, N), standard normal scaled by 1/sqrt(columns) as
    ref.init_mm3 scales mm3's operands, made on the device from a seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(M, K, device=device, generator=g) / K ** 0.5,
            torch.randn(K, N, device=device, generator=g) / N ** 0.5)


def lower_tile_flops(n: int, bi: int, bj: int, per_element: float) -> float:
    """Flops a kernel that pairs mirrored tiles of an n x n output executes
    (syr2k.cu, covariance.cu): ``per_element`` per element of every block's
    tile, padded to multiples of 8, over the blocks not wholly above the
    diagonal."""
    pi, pj = -(-bi // 8) * 8, -(-bj // 8) * 8
    blocks = sum(1 for ti in range(-(-n // bi)) for tj in range(-(-n // bj))
                 if min((ti + 1) * bi, n) - 1 >= tj * bj)
    return per_element * pi * pj * blocks


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


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """(least ms, "operations" or "bytes"): the larger of ``flops`` at
    ``peak`` (PEAK_F32_FLOPS on the CUDA cores, PEAK_3XTF32_FLOPS for the
    matmul's tensor-core path, PEAK_F32_MIN for minima) and ``nbytes`` at
    PEAK_HBM_BYTES."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def host_ms(fn, iters: int = 5) -> float:
    """Mean host wall milliseconds per call of ``fn``, each call followed by
    a synchronize, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def device_time(fn) -> tuple[float, dict]:
    """Device kernel milliseconds of one call of ``fn`` under torch.profiler
    (after one unprofiled warm-up call), and {kernel name: (count, ms)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {e.key: (e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    return sum(ms for _, ms in by_name.values()), by_name


def device_kernels_in_order(fn) -> list[tuple[str, float]]:
    """(name, device milliseconds) of every device kernel, copy and fill of
    one call of ``fn`` in the order they ran (torch.profiler's trace, after
    one unprofiled warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return [(e["name"], e["dur"] / 1e3) for e in sorted(evs, key=lambda e: e["ts"])]


def launches_per_call(fn, wrappers) -> dict:
    """Kernel launches of one call of ``fn``, per wrapper."""
    before = {w.__name__: w.launches for w in wrappers}
    fn()
    return {w.__name__: w.launches - before[w.__name__] for w in wrappers}


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

    from repro_torch.kernels.covariance import covariance_smem_bytes
    from repro_torch.kernels.floyd_warshall import PANEL_TILE, minplus_smem_bytes
    from repro_torch.kernels.heat3d import heat3d_smem_bytes
    from repro_torch.kernels.lu import lu_factor_diag_smem_bytes
    from repro_torch.kernels.spaces import kernel_space

    tiles = list(itertools.product(GPU_TILES, GPU_TILES_K, GPU_TILES))
    if name == "covariance":
        N, M = dims
        bad = sum(refused(covariance_smem_bytes(min(bi, M), min(bj, M), min(bk, N), limit))
                  for (bi, bk, bj) in tiles)
        return bad * 4, len(tiles) * 4  # x fuse_center x interchange
    if name == "lu":
        (N,) = dims
        cs = kernel_space("lu")
        pts = list(itertools.product(cs["bs"].sequence, cs["bm"].sequence, cs["bn"].sequence))
        # the first (largest) trailing update and the diagonal factor
        bad = sum(refused(matmul_smem_bytes(min(bm, N - bs), min(bn, N - bs), bs, limit=limit))
                  or refused(lu_factor_diag_smem_bytes(bs)) for (bs, bm, bn) in pts)
        return bad * 2, len(pts) * 2  # x pack
    if name == "floyd_warshall":
        (N,) = dims
        cs = kernel_space("floyd_warshall")
        pts = list(itertools.product(cs["bs"].sequence, cs["bi"].sequence, cs["bj"].sequence))
        # the trailing update and the two panels (one tile across the block)
        bad = sum(any(refused(minplus_smem_bytes(a, b, bs, limit)) for a, b in
                      ((bi, bj), (bs, PANEL_TILE), (PANEL_TILE, bs)))
                  for (bs, bi, bj) in pts)
        return bad * 4, len(pts) * 4  # x unroll
    if name == "flash_attention":
        from repro_torch.kernels.flash_attention import flash_attention_smem_bytes
        hd = dims[3]
        cs = kernel_space(name)
        pts = list(itertools.product(cs["bq"].sequence, cs["bk"].sequence))
        return sum(refused(flash_attention_smem_bytes(bq, bk, hd)) for bq, bk in pts), len(pts)
    if name == "decode_attention":
        from repro_torch.kernels.decode_attention import decode_attention_smem_bytes
        _, G, S, hd = dims
        cs = kernel_space(name)
        pts = cs["bk"].sequence
        return sum(refused(decode_attention_smem_bytes(G, min(bk, S), hd)) for bk in pts), len(pts)
    if name == "heat3d":
        N, _ = dims
        cs = kernel_space("heat3d")
        pts = list(itertools.product(cs["bi"].sequence, cs["fuse_t"].choices))
        return sum(refused(heat3d_smem_bytes((N, N, N), bi, ft)) for bi, ft in pts), len(pts)
    if name == "syr2k":
        N, M = dims
        # 2x2x2 points per tile triple (pack_a, pack_b, interchange), as the
        # paper counts them; without pack_a, pack_b is inactive (not packed)
        packs = [(True, True), (True, False), (False, False), (False, False)]
        bad = sum(refused(syr2k_smem_bytes(min(bi, N), min(bj, N), min(bk, M), pa, pb, limit))
                  for (bi, bk, bj) in tiles for (pa, pb) in packs) * 2
        return bad, len(tiles) * 8
    P, Q, R, S, T = dims
    shapes = [(P, Q, R), (R, S, T), (P, R, T)]
    bad = sum(any(refused(matmul_smem_bytes(min(bm, m), min(bn, n), min(bk, k), limit=limit))
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


def attention_inputs(BH: int, Sq: int, Sk: int, hd: int, dev, seed: int = 0):
    """q (BH, Sq, hd), k and v (BH, Sk, hd): standard normal f32 from numpy."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
                 for shape in ((BH, Sq, hd), (BH, Sk, hd), (BH, Sk, hd)))


def check_attention(dev, errs: dict) -> None:
    """Phase 3 for flash_attention and decode_attention: the kernels against
    their plain versions at LARGE and at the model's shapes."""
    import torch

    from repro_torch.kernels import problems
    from repro_torch.kernels.decode_attention import (
        CacheRows,
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    def flash_case(label, q, k, v, causal, bq, bk, tol=ATTN_TOL):
        got = flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
        torch.cuda.synchronize()
        err = compare(f"flash_attention {label} causal={causal} bq={bq} bk={bk}", got,
                      flash_attention_plain(q, k, v, causal=causal), tol)
        errs["flash_attention"] = max(errs["flash_attention"], err)

    BH, S, _, hd = problems.LARGE_SHAPES["flash_attention"]
    q, k, v = attention_inputs(BH, S, S, hd, dev)
    for causal, bq, bk in ((True, 64, 64), (True, 128, 32), (True, 32, 128), (False, 64, 64)):
        flash_case(f"LARGE ({BH}, {S}, {hd})", q, k, v, causal, bq, bk)
    del q, k, v
    # the model's prefill: batch 4 x 2 kv heads, prompt 256, hd 64
    q, k, v = attention_inputs(8, 256, 256, 64, dev, seed=1)
    for bq, bk in ((64, 64), (16, 16), (128, 128), (48, 80)):
        flash_case("model (8, 256, 64)", q, k, v, True, bq, bk)
    q, k, v = attention_inputs(3, 250, 131, 64, dev, seed=2)       # ragged edges
    for causal in (True, False):
        flash_case("ragged Sq=250 Sk=131 hd=64", q, k, v, causal, 64, 64)
    q, k, v = (t.to(torch.bfloat16) for t in attention_inputs(4, 200, 200, 128, dev, seed=3))
    flash_case("bf16 (4, 200, 128)", q, k, v, True, 64, 64, ATTN_BF16_TOL)
    # head_dim 256 (gemma3-1b's): causal and not, tiles that take one or two
    # ring stages, ragged edges, bf16
    q, k, v = attention_inputs(4, 1000, 1000, 256, dev, seed=11)
    for causal, bq, bk in ((True, 64, 64), (False, 64, 64), (True, 32, 128), (True, 128, 32)):
        flash_case("hd 256 (4, 1000, 256)", q, k, v, causal, bq, bk)
    q, k, v = attention_inputs(3, 250, 131, 256, dev, seed=12)
    for causal in (True, False):
        flash_case("ragged Sq=250 Sk=131 hd=256", q, k, v, causal, 64, 64)
    q, k, v = (t.to(torch.bfloat16) for t in attention_inputs(4, 200, 200, 256, dev, seed=13))
    flash_case("bf16 (4, 200, 256)", q, k, v, True, 64, 64, ATTN_BF16_TOL)

    # head sizes between the instantiations: run zero-padded to the next one
    for hd_ in (80, 96, 112, 160, 192):
        q, k, v = attention_inputs(4, 600, 571, hd_, dev, seed=40 + hd_)
        for causal in (True, False):
            flash_case(f"hd {hd_} (4, 600/571, {hd_})", q, k, v, causal, 64, 64)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        flash_case(f"bf16 hd {hd_} (4, 600/571, {hd_})", q, k, v, True, 64, 32, ATTN_BF16_TOL)
    del q, k, v

    def decode_case(label, q, k, v, cp, ring, window, bk, hg, tol=ATTN_TOL):
        got = decode_attention(q, k, v, cp, ring=ring, window=window, bk=bk, hg=hg)
        torch.cuda.synchronize()
        kr, vr = (t.rows() if isinstance(t, CacheRows) else t for t in (k, v))
        err = compare(f"decode_attention {label} ring={ring} window={window} bk={bk} hg={hg}",
                      got, decode_attention_plain(q, kr, vr, cp, ring=ring, window=window), tol)
        errs["decode_attention"] = max(errs["decode_attention"], err)
        if bool((cp < 0).any()) and bool(got[cp < 0].ne(0).any()):
            raise AssertionError("decode_attention: a cur_pos = -1 row is not exactly 0")
        again = decode_attention(q, k, v, cp, ring=ring, window=window, bk=bk, hg=hg)
        if not torch.equal(got, again):
            raise AssertionError(f"decode_attention {label}: a second call gives other bits")
        return got

    BH, G, S, hd = problems.LARGE_SHAPES["decode_attention"]
    q, _, _ = attention_inputs(BH, G, 1, hd, dev, seed=4)
    _, k, v = attention_inputs(BH, 1, S, hd, dev, seed=5)
    full = torch.full((BH,), S - 1, dtype=torch.int32, device=dev)
    for bk, hg in ((128, 1), (64, 2), (32, 4), (256, 1)):
        decode_case(f"LARGE ({BH}, {G}, {S}, {hd}) full cache", q, k, v, full, False, 0, bk, hg)
    # the key axis split across blocks, per-row positions: an empty row
    # (cur_pos = -1), rows whose valid slots all lie in the first split, rows
    # ending inside a split, full rows and rows past the cache
    mixed = torch.tensor([-1, 0, 5, 127, 128, 1000, 2047, 2048, 3000, S - 2, S - 1, S, S + 700,
                          2 * S + 5, 64, -1], dtype=torch.int32, device=dev)
    for ring, window in ((False, 0), (True, 0), (False, 1000), (True, 300)):
        decode_case(f"LARGE ({BH}, {G}, {S}, {hd}) per-row positions", q, k, v, mixed, ring,
                    window, 128, 1)
    first = decode_attention(q, k, v, mixed, bk=128)
    qm, _, _ = attention_inputs(8, 7, 1, 64, dev, seed=9)
    _, km, vm = attention_inputs(8, 1, 288, 64, dev, seed=10)
    decode_attention(qm, km, vm, 260, bk=128)  # another BH, other row groups and counters
    if not torch.equal(first, decode_attention(q, k, v, mixed, bk=128)):
        raise AssertionError("decode_attention: bits differ after a call at another BH")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    decode_case(f"LARGE bf16 ({BH}, {G}, {S}, {hd}) per-row positions", qb, kb, vb, mixed,
                False, 0, 128, 1, ATTN_BF16_TOL)
    del qb, kb, vb
    # head_dim 256 at G = 8 (the most it takes): the key axis split, per-row
    # positions, ring and window, f32 and bf16
    q2, _, _ = attention_inputs(BH, 8, 1, 256, dev, seed=14)
    _, k2, v2 = attention_inputs(BH, 1, S, 256, dev, seed=15)
    for ring, window in ((False, 0), (True, 0), (False, 1000), (True, 300)):
        decode_case(f"hd 256 ({BH}, 8, {S}, 256) per-row positions", q2, k2, v2, mixed, ring,
                    window, 32, 1)
    q2, k2, v2 = (t.to(torch.bfloat16) for t in (q2, k2, v2))
    decode_case(f"hd 256 bf16 ({BH}, 8, {S}, 256) per-row positions", q2, k2, v2, mixed, True,
                0, 32, 1, ATTN_BF16_TOL)
    del q2, k2, v2
    # head sizes between the powers of two (instantiations of their own),
    # and more query heads than one launch takes (groups of heads, one
    # launch each)
    for hd_ in (80, 96, 112, 160, 192):
        q2, _, _ = attention_inputs(BH, 8, 1, hd_, dev, seed=50 + hd_)
        _, k2, v2 = attention_inputs(BH, 1, S, hd_, dev, seed=60 + hd_)
        for ring, window in ((False, 0), (True, 0), (False, 1000), (True, 300)):
            decode_case(f"hd {hd_} ({BH}, 8, {S}, {hd_}) per-row positions", q2, k2, v2,
                        mixed, ring, window, 32, 1)
        q2, k2, v2 = (t.to(torch.bfloat16) for t in (q2, k2, v2))
        decode_case(f"hd {hd_} bf16 ({BH}, 8, {S}, {hd_}) per-row positions", q2, k2, v2,
                    mixed, True, 0, 64, 1, ATTN_BF16_TOL)
    for G_, hd_ in ((20, 128), (12, 192), (40, 64)):
        q2, _, _ = attention_inputs(BH, G_, 1, hd_, dev, seed=70 + G_)
        _, k2, v2 = attention_inputs(BH, 1, S, hd_, dev, seed=80 + G_)
        n0 = decode_attention.launches
        decode_case(f"G={G_} past one launch ({BH}, {G_}, {S}, {hd_})", q2, k2, v2, mixed,
                    True, 300, 32, 1)
        print(f"    {(decode_attention.launches - n0) // 2} launches a call (groups of "
              f"heads)", flush=True)
    del q2, k2, v2
    # the model's bucket of 288 at cur_pos 260 (three splits of 128, the last
    # 32 slots: S not a multiple of the split) and a bucket below bk
    for ring in (False, True):
        decode_case("model (8, 7, 288, 64) cur_pos 260", qm, km, vm,
                    torch.full((8,), 260, dtype=torch.int32, device=dev), ring, 0, 128, 1)
    decode_case("model (8, 7, 100, 64), S < bk", qm, km[:, :100].contiguous(),
                vm[:, :100].contiguous(), torch.tensor([-1, 0, 5, 50, 99, 150, 20, 77],
                                                       dtype=torch.int32, device=dev),
                True, 0, 128, 1)
    # the model's decode: batch 4 x 2 kv heads, G = 7, hd 64, bucket 384;
    # per-row positions, one row empty (cur_pos = -1), one past the bucket
    q, _, _ = attention_inputs(8, 7, 1, 64, dev, seed=6)
    _, k, v = attention_inputs(8, 1, 384, 64, dev, seed=7)
    cp = torch.tensor([-1, 0, 17, 127, 128, 255, 383, 500], dtype=torch.int32, device=dev)
    for ring, window in ((False, 0), (True, 0), (False, 100), (True, 100)):
        for bk, hg in ((128, 1), (64, 2), (256, 4)):
            decode_case("model (8, 7, 384, 64)", q, k, v, cp, ring, window, bk, hg)
    # the model's cache layout, read in place: (B, S, K, hd) as (B*K, S, hd) rows
    _, kc, vc = attention_inputs(4, 1, 384 * 2, 64, dev, seed=8)
    kc, vc = kc.reshape(4, 384, 2, 64), vc.reshape(4, 384, 2, 64)
    for bk, hg in ((128, 2), (32, 1)):
        decode_case("model cache layout (4, 384, 2, 64) in place", q, CacheRows(kc),
                    CacheRows(vc), cp, False, 0, bk, hg)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, kc, vc))
    decode_case("model cache layout bf16 (4, 384, 2, 64) in place", qb, CacheRows(kb),
                CacheRows(vb), cp, True, 100, 128, 1, ATTN_BF16_TOL)


def time_attention(rows: dict) -> None:
    """Phase 4 for flash_attention and decode_attention at LARGE (the rows of
    the kernels line) and at the model's shapes (printed): kernel, plain
    version, scaled_dot_product_attention in f32 (a yardstick the port never
    calls) and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, problems
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.model_kernels import (
        decode_attention_builder,
        flash_attention_builder,
    )

    dev = torch.device("cuda")
    flash = flash_attention_builder(ops.DEFAULTS["flash_attention"], causal=True)
    decode = decode_attention_builder(ops.DEFAULTS["decode_attention"])

    def flash_row(BH, S, hd, seed):
        q, k, v = attention_inputs(BH, S, S, hd, dev, seed)
        b_ms, b_by = bound(4.0 * BH * S * S * hd * 0.5, 4.0 * BH * (2 * S + 2 * S) * hd)
        return dict(ms=time_ms(lambda: flash(q, k, v)),
                    plain_ms=time_ms(lambda: flash_attention_plain(q, k, v), iters=5),
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True)),
                    bound_ms=b_ms, bound_by=b_by)

    def decode_row(BH, G, S, hd, cp, seed):
        q, _, _ = attention_inputs(BH, G, 1, hd, dev, seed)
        _, k, v = attention_inputs(BH, 1, S, hd, dev, seed + 1)
        cp = torch.as_tensor(cp, dtype=torch.int32, device=dev).expand(BH).contiguous()
        # the slots this run's positions read (a causal cache holds cur_pos + 1)
        slots = int(torch.clamp(cp + 1, 0, S).sum())
        b_ms, b_by = bound(4.0 * G * hd * slots, 4.0 * (2 * slots * hd + 2 * BH * G * hd))
        # SDPA on the same keys: the valid prefix of every row (a boolean mask)
        mask = (torch.arange(S, device=dev)[None, None, :] <= cp[:, None, None])
        return dict(ms=time_ms(lambda: decode(q, k, v, cp)),
                    plain_ms=time_ms(lambda: decode_attention_plain(q, k, v, cp)),
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask)),
                    bound_ms=b_ms, bound_by=b_by)

    def show(name, shape, cfg, r, what):
        print(f"  {name} {shape} {cfg}: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; counted: {what}), plain {r['plain_ms']:.4f} ms, library "
              f"(scaled_dot_product_attention, f32) {r['library_ms']:.4f} ms "
              f"({r['ms'] / r['library_ms']:.2f}x)", flush=True)

    BH, S, _, hd = problems.LARGE_SHAPES["flash_attention"]
    rows["flash_attention"] = flash_row(BH, S, hd, 0)
    flash_what = "4*BH*S^2*hd/2 causal flops at 67 TFLOP/s; q, k, v read and o written once"
    show("flash_attention LARGE causal", (BH, S, hd), ops.DEFAULTS["flash_attention"],
         rows["flash_attention"], flash_what)
    show("flash_attention hd 256 causal", (8, 2048, 256), ops.DEFAULTS["flash_attention"],
         flash_row(8, 2048, 256, 3), flash_what)
    show("flash_attention model prefill causal", (8, 256, 64),
         ops.DEFAULTS["flash_attention"], flash_row(8, 256, 64, 1), flash_what)
    # device time per launch (torch.profiler): at the model's shape a launch
    # is shorter than the host's wrapper call
    for (BH_, S_, hd_) in ((BH, S, hd), (8, 2048, 256), (8, 256, 64)):
        q, k, v = attention_inputs(BH_, S_, S_, hd_, dev, 5)
        dev_ms = device_time(lambda: [flash(q, k, v) for _ in range(10)])[0]
        print(f"  flash_attention ({BH_}, {S_}, {hd_}) causal: {dev_ms / 10:.4f} ms per launch "
              f"on the device (torch.profiler)", flush=True)
        del q, k, v
    BH, G, S, hd = problems.LARGE_SHAPES["decode_attention"]
    rows["decode_attention"] = decode_row(BH, G, S, hd, S - 1, 2)
    dec_what = "the k and v slots each row's cur_pos reads, q read and o written once"
    show("decode_attention LARGE full cache", (BH, G, S, hd),
         ops.DEFAULTS["decode_attention"], rows["decode_attention"], dec_what)
    show("decode_attention model decode, cur_pos 260", (8, 7, 288, 64),
         ops.DEFAULTS["decode_attention"], decode_row(8, 7, 288, 64, 260, 4), dec_what)
    # where a call's kernel is shorter than the host's wrapper, back-to-back
    # calls time the host: the device time per launch (torch.profiler), at
    # LARGE and at the model's shape, at the default bk and at 128
    from repro_torch.kernels.decode_attention import decode_attention

    for (BH_, G_, S_, hd_, cp_) in ((BH, G, S, hd, S - 1), (8, 7, 288, 64, 260)):
        q, _, _ = attention_inputs(BH_, G_, 1, hd_, dev, 4)
        _, k, v = attention_inputs(BH_, 1, S_, hd_, dev, 5)
        cp = torch.full((BH_,), cp_, dtype=torch.int32, device=dev)
        for bk in sorted({ops.DEFAULTS["decode_attention"]["bk"], 128}):
            dev_ms = device_time(
                lambda: [decode_attention(q, k, v, cp, bk=bk) for _ in range(20)])[0]
            print(f"  decode_attention ({BH_}, {G_}, {S_}, {hd_}), cur_pos {cp_}, bk={bk}: "
                  f"{dev_ms / 20:.4f} ms per launch on the device (torch.profiler)", flush=True)
        del q, k, v
    from repro_torch.kernels.decode_attention import decode_attention_plan

    d_cfg = ops.DEFAULTS["decode_attention"]
    for label, (BH_, G_, S_, hd_) in (("LARGE", (BH, G, S, hd)), ("model", (8, 7, 288, 64))):
        bk_ = min(d_cfg["bk"], S_)
        nsplit, ws = decode_attention_plan(BH_, G_, S_, hd_, bk_, d_cfg["hg"], dev)
        print(f"  decode_attention {label} ({BH_}, {G_}, {S_}, {hd_}) {d_cfg}: key axis in "
              f"{nsplit} splits of {-(-(-(-S_ // bk_)) // nsplit)} x {bk_} slots, "
              f"{nsplit * -(-BH_ // d_cfg['hg'])} blocks on "
              f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs, workspace "
              f"{ws} B of f32 partials + {-(-BH_ // d_cfg['hg']) * 4} B of counters", flush=True)


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def tree_bytes(tree: dict) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def serving(launches: dict, dev) -> None:
    """Phase 6: the serving path at full width on ``dev``. Adds the main
    path's launch counts to ``launches``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.serve import PagedKVCache, greedy_decode, make_serve_step, prefill

    wrappers = (flash_attention, decode_attention, tiled_matmul)
    B, P, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    cfg = dataclasses.replace(get_config(SERVE["arch"]), dtype=torch.float32)
    L, G = cfg.n_layers, cfg.n_heads // cfg.n_kv_heads

    # -- the main path, through the serving entry point
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = serve_cli.serve(SERVE["arch"], batch=B, prompt_len=P, gen=gen, seed=SERVE["seed"],
                        device=dev)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()
    serve_cli.report(r)
    toks = r["tokens"]
    if tuple(toks.shape) != (B, gen) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"serve: tokens of shape {tuple(toks.shape)} outside the vocab")
    # one prefill forward, then P replayed and gen generated decode steps
    steps = P + gen
    want = {"flash_attention": G * L, "decode_attention": L * steps,
            "tiled_matmul": (L + 1) * (1 + steps)}
    print(f"  launches over the serve run: {counts} (expected {want}: {G} query groups x "
          f"{L} layers in the prefill forward; {L} decode_attention and {L} + 1 matmuls "
          f"per decode step, {steps} steps; {L} + 1 matmuls in the forward)")
    if counts != want:
        raise AssertionError(f"serve launch counts {counts} != {want}")
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    if r["stats"]["build_failed"] or r["stats"]["store_default"] == 0:
        raise AssertionError(f"serve dispatch stats {r['stats']}")

    # -- per call, on the same weights (init_params from the same seed)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SERVE["seed"]))
    svc = DispatchService()
    g = torch.Generator(device=dev).manual_seed(SERVE["seed"] + 1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)
    fwd = lambda: forward(params, {"tokens": prompt}, cfg, service=svc)  # noqa: E731
    n_fwd = launches_per_call(fwd, wrappers)
    cache = init_cache(cfg, B, P + gen, device=dev)
    tok = prompt[:, -1:]
    step = lambda: decode_step(params, cache, tok, P, cfg, service=svc)  # noqa: E731
    n_step = launches_per_call(step, wrappers)
    print(f"  launches per prefill forward {n_fwd}, per decode step {n_step}")
    if n_fwd != {"flash_attention": G * L, "decode_attention": 0, "tiled_matmul": L + 1} \
            or n_step != {"flash_attention": 0, "decode_attention": L, "tiled_matmul": L + 1}:
        raise AssertionError("per-call launch counts differ from 7 x 24 flash per forward, "
                             "24 decode_attention and 25 matmul per decode step")

    fwd_ms, step_ms = host_ms(fwd, iters=3), host_ms(step, iters=10)
    weights = tree_bytes(params) - params["embed"].numel() * 4   # the lookup reads B rows
    kv = 2 * L * B * (P + 1) * cfg.n_kv_heads * cfg.hd * 4
    step_bound = (weights + kv) / PEAK_HBM_BYTES * 1e3
    dev_ms, by_name = device_time(step)
    n_kernels = sum(c for c, _ in by_name.values())
    busy = "not measured (the profiler recorded no device time)" if dev_ms == 0.0 else \
        (f"{n_kernels} device kernels, {dev_ms:.4f} ms busy of {step_ms:.4f} ms host wall "
         f"({dev_ms / step_ms:.1%}; {step_ms / n_kernels * 1e3:.1f} us of host wall per kernel)")
    print(f"  memory: peak {peak / 1e9:.3f} GB allocated (torch.cuda.max_memory_allocated), "
          f"weights {tree_bytes(params) / 1e9:.3f} GB f32 of which the contiguous unembed "
          f"embed_t {params['embed_t'].numel() * 4 / 1e9:.3f} GB, KV cache "
          f"{r['cache_mb']:.1f} MB")
    print(f"  prefill forward (prompt {P}, batch {B}): {fwd_ms:.3f} ms host wall; TTFT "
          f"{r['prefill_ms']:.2f} ms (forward + filling the cache by replaying the prompt "
          f"through decode_step, the JAX package's prefill)")
    print(f"  decode: {r['decode_ms_per_step']:.4f} ms per step in the serve run, "
          f"{step_ms:.4f} ms alone; bound {step_bound:.4f} ms (bytes: {weights / 1e9:.3f} GB "
          f"of weights and {kv / 1e6:.1f} MB of cache read per step at 3.35 TB/s); "
          f"{r['tokens_per_sec']:.1f} tok/s over the run")
    for label, kname in (("the tiled matmul (csrc/matmul.cu)", "matmul_kernel"),
                         ("decode_attention (csrc/decode_attention.cu)", "decode_kernel")):
        n = sum(c for k, (c, _) in by_name.items() if kname in k)
        ms = sum(t for k, (_, t) in by_name.items() if kname in k)
        print(f"  one decode step on the device: {label} x{n} {ms:.4f} ms of {dev_ms:.4f} ms")
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:5]
    print(f"  one decode step on the device (torch.profiler): {busy}; largest: "
          + "; ".join(f"{k[:50]} x{c} {t:.4f} ms" for k, (c, t) in top), flush=True)

    # -- a PagedKVCache round against each request's solo greedy_decode
    rounds, lens = 16, (64, 128, 200, 256)
    pc = PagedKVCache(cfg, max_batch=8, max_len=max(lens) + rounds + 1, page_size=128,
                      device=dev)
    svc.attach_kv_cache(pc)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=g, device=dev) for n in lens]
    solo = [greedy_decode(params, cfg, p, steps=rounds + 1, max_len=pc.alloc, service=svc)[0]
            for p in prompts]
    serve = make_serve_step(cfg, service=svc)
    slots, out = [1, 2, 5, 7], []
    for slot, p in zip(slots, prompts):
        logits, pcache = prefill(params, {"tokens": p}, cfg, max_len=pc.alloc, service=svc)
        pc.admit(slot, pcache, p.shape[1])
        out.append([int(torch.argmax(logits[0, -1]))])
    cur = torch.tensor([[t[-1]] for t in out], device=dev)
    buckets = []
    for _ in range(rounds):
        bucket = pc.seq_bucket(slots)
        buckets.append(bucket)
        view = pc.view(slots, bucket)
        nxt, _, view = serve(params, view, cur, pc.pos_vector(slots) + 1)
        pc.writeback(slots, bucket, view)
        pc.advance(slots)
        for i, t in enumerate(out):
            t.append(int(nxt[i, 0]))
        cur = nxt
    for n, got, want_ in zip(lens, out, solo):
        if got != want_.tolist():
            raise AssertionError(f"paged round, prompt {n}: {got} != solo {want_.tolist()}")
    print(f"  PagedKVCache: 4 requests (prompts {lens}) in 8 slots, page 128, {rounds} "
          f"rounds (buckets {sorted(set(buckets))}): tokens equal each request's solo "
          f"greedy_decode; {json.dumps(svc.telemetry()['kv_cache'])}", flush=True)

    # -- the card against the CPU, same weights, a short run
    p1 = prompt[:1, :32]
    want_logits, _ = forward(params, {"tokens": p1}, cfg, service=svc)
    want_toks = greedy_decode(params, cfg, p1, steps=8, max_len=40, service=svc)
    cpu = torch.device("cpu")
    params_cpu = tree_to(params, cpu)
    del params, cache, pc
    svc_cpu = DispatchService()
    got_logits, _ = forward(params_cpu, {"tokens": p1.to(cpu)}, cfg, service=svc_cpu)
    got_toks = greedy_decode(params_cpu, cfg, p1.to(cpu), steps=8, max_len=40, service=svc_cpu)
    compare("serve logits, card vs CPU (qwen2-0.5b full width, prompt 32)",
            want_logits.cpu(), got_logits, LOGIT_TOL)
    if not torch.equal(want_toks.cpu(), got_toks):
        raise AssertionError(f"greedy tokens card {want_toks.tolist()} != CPU {got_toks.tolist()}")
    print(f"  greedy tokens (8), card and CPU: {want_toks[0].tolist()} (equal)", flush=True)


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
    from repro_torch.kernels.covariance import covariance, covariance_plain
    from repro_torch.kernels.floyd_warshall import (
        PANEL_TILE,
        closure_in_block,
        closure_plain,
        floyd_warshall,
        floyd_warshall_plain,
        minplus_update,
        minplus_update_plain,
    )
    from repro_torch.kernels.heat3d import heat3d, heat3d_plain, heat3d_plan
    from repro_torch.kernels.lu import lu, lu_factor_diag, lu_factor_diag_plain, lu_plain
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
    print(f"  nvcc sm_90a build of {', '.join(f'{n}.cu' for n in build.KERNELS)} "
          f"(one nvcc each, in parallel): {build_sec:.1f} s; per source: "
          + ", ".join(f"{n} {t:.1f} s" for n, t in sorted(build.SECONDS.items(),
                                                          key=lambda x: -x[1])))
    for name in build.KERNELS:
        report = build.ptxas_report(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = [ln.strip() for ln in report.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"  ptxas {name}: {len(regs)} kernel instantiations, registers per "
              f"thread {min(regs, default=0)}..{max(regs, default=0)}, spills: "
              f"{spills or 'none'}")
    for name in MAIN_PATH_INSTANCES:
        entries = build.ptxas_entries(build.ptxas_report(name))
        for e in entries:
            print(f"  ptxas {e['kernel']}<{', '.join(map(str, e['args']))}>: "
                  f"{e['registers']} registers, spills {e['spill_stores']} B stored, "
                  f"{e['spill_loads']} B loaded")
        for args in MAIN_PATH_INSTANCES[name]:
            found = [e for e in entries if e["args"] == args]
            if not found:
                raise AssertionError(f"{name}: no ptxas entry for the main path's instance {args}")
            if any(e["spill_stores"] + e["spill_loads"] for e in found):
                raise AssertionError(f"{name}: the main path's instance {args} spills")
    for name in build.KERNELS:
        build.load(name)

    # ---- 3. kernel vs plain at LARGE ------------------------------------------
    phase("3. kernel vs plain version on the card, LARGE (and the model's shapes)")
    errs = {"syr2k": 0.0, "matmul": 0.0, "covariance": 0.0, "minplus": 0.0,
            "heat3d": 0.0, "lu_factor_diag": 0.0, "closure": 0.0,
            "flash_attention": 0.0, "decode_attention": 0.0}
    probe = {}  # tolerance class -> (largest max_abs_err, largest error / tolerance)
    syr2k_dims = problems.LARGE_SHAPES["syr2k"]
    C, A, B = problems.problem_inputs("syr2k", syr2k_dims, dev)
    want = syr2k_plain(C, A, B)
    base = dict(bi=64, bj=64, bk=32)
    cfgs = [dict(base, pack_a=pa, pack_b=pb, interchange=ic)
            for pa, pb in ((False, False), (True, False), (True, True))
            for ic in (False, True)]
    cfgs += [dict(bi=48, bj=80, bk=24, pack_a=True, pack_b=False),
             dict(bi=128, bj=112, bk=16, pack_a=True, pack_b=True, interchange=True),
             dict(bi=8, bj=24, bk=256, pack_a=False, pack_b=False),
             # rectangles straddling the diagonal
             dict(bi=128, bj=8, bk=32, pack_a=True, pack_b=True),
             dict(bi=8, bj=128, bk=32, pack_a=True, pack_b=True, interchange=True)]
    first = None
    for cfg in cfgs:
        poison_next(C.shape, dev)  # an element the kernel never writes stays NaN
        got = syr2k(C, A, B, **cfg)
        torch.cuda.synchronize()
        errs["syr2k"] = max(errs["syr2k"], compare(f"syr2k {cfg}", got, want, SYR2K_TOL))
        first = got if first is None else first
        if not torch.equal(got, first):
            raise AssertionError(f"syr2k {cfg}: bits differ from {cfgs[0]}")
    print(f"  syr2k: all {len(cfgs)} configurations give identical bits, on NaN-poisoned outputs")

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
                f32 = dtype == torch.float32
                errs["matmul"] = max(errs["matmul"], compare(
                    f"matmul {P}x{Q}@{Q}x{R} {str(dtype)[6:]} {cfg}", got, wantm,
                    F32_TOL if f32 else BF16_TOL, (probe, "F32_TOL") if f32 else None))
    got = tiled_matmul(Am, Bm, bm=48, bn=80, bk=24, pack=False, interchange=True)
    wantm = tiled_matmul_plain(Am, Bm, bk=24, pack=False, out_dtype=torch.float32)
    errs["matmul"] = max(errs["matmul"], compare(
        "matmul f32 ragged bm=48 bn=80 bk=24 pack=False interchange", got, wantm, F32_TOL,
        (probe, "F32_TOL")))
    # column tiles off 16-byte words (N % 4 == 0, bn % 4 != 0): scalar stores;
    # row tiles of 24 and 40 (padded to the tensor cores' warp pieces),
    # chunks off the mma's k step of 8, a 128-deep chunk
    for bm, bn, bk, pack in ((64, 50, 32, True), (64, 50, 32, False), (24, 40, 12, True),
                             (40, 128, 20, False), (128, 128, 128, True)):
        poison_next((P, R), dev)
        got = tiled_matmul(Am, Bm, bm=bm, bn=bn, bk=bk, pack=pack)
        torch.cuda.synchronize()
        errs["matmul"] = max(errs["matmul"], compare(
            f"matmul f32 bm={bm} bn={bn} bk={bk} pack={pack}", got,
            tiled_matmul_plain(Am, Bm, bk=bk, pack=pack, out_dtype=torch.float32), F32_TOL,
            (probe, "F32_TOL")))
    got = ops.mm3_op(Am, Bm, Cm, Dm, config=dict(fuse_second=True, pack2=False, inter3=True))
    errs["matmul"] = max(errs["matmul"], compare(
        "mm3 f32 fuse_second pack2=False inter3", got, ref.mm3_ref(Am, Bm, Cm, Dm), F32_TOL,
        (probe, "F32_TOL")))
    errs["matmul"] = max(errs["matmul"], compare(
        "mm3 f32 default config", ops.mm3_op(Am, Bm, Cm, Dm), ref.mm3_ref(Am, Bm, Cm, Dm),
        F32_TOL, (probe, "F32_TOL")))
    # skinny M at the model's shapes: the decode unembed and output projection
    # (8-row tiles: the FFMA loop, not the tensor cores)
    for (M_, K_, N_) in ((1, 896, 151936), (4, 896, 151936), (7, 896, 151936),
                         (1, 896, 896), (4, 896, 896), (7, 896, 896)):
        a, b = model_operands(M_, K_, N_, dev)
        poison_next((M_, N_), dev)
        got = tiled_matmul(a, b, bm=64, bn=64, bk=32)
        torch.cuda.synchronize()
        errs["matmul"] = max(errs["matmul"], compare(
            f"matmul f32 skinny ({M_}, {K_}) @ ({K_}, {N_}) bm=64 bn=64 bk=32", got,
            tiled_matmul_plain(a, b, bk=32, pack=True, out_dtype=torch.float32), F32_TOL))
        del a, b, got

    # covariance: fuse_center x interchange, ragged tiles (1200 % 64 != 0),
    # bi != bj across the diagonal, bk not dividing N, each on a NaN-poisoned
    # output; exactly symmetric, with the same bits from every configuration
    cov_dims = problems.LARGE_SHAPES["covariance"]
    (data,) = problems.problem_inputs("covariance", cov_dims, dev)
    want = covariance_plain(data)
    cfgs = [dict(bi=64, bj=64, bk=32, fuse_center=fc, interchange=ic)
            for fc in (True, False) for ic in (False, True)]
    cfgs += [dict(bi=48, bj=80, bk=24, fuse_center=True),  # 1400 % 24 != 0
             dict(bi=48, bj=80, bk=24, fuse_center=False, interchange=True),
             dict(bi=128, bj=112, bk=48, fuse_center=False, interchange=True),
             dict(bi=128, bj=8, bk=256, fuse_center=True, interchange=True),
             dict(bi=8, bj=128, bk=192, fuse_center=True)]
    first = None
    for cfg in cfgs:
        poison_next((cov_dims[1], cov_dims[1]), dev)
        got = covariance(data, **cfg)
        torch.cuda.synchronize()
        errs["covariance"] = max(errs["covariance"], compare(
            f"covariance {cov_dims} {cfg}", got, want, COV_TOL))
        if not torch.equal(got, got.T):
            raise AssertionError(f"covariance {cfg}: the output is not exactly symmetric")
        first = got if first is None else first
        if not torch.equal(got, first):
            raise AssertionError(f"covariance {cfg}: bits differ from {cfgs[0]}")
    print(f"  covariance: all {len(cfgs)} configurations give identical, exactly symmetric "
          f"bits, on NaN-poisoned outputs")

    # min-plus and the blocked Floyd-Warshall: bit for bit against the plain
    # versions with the same bs; the blocked result also against the
    # unblocked reference
    (fw_n,) = problems.LARGE_SHAPES["floyd_warshall"]
    (W,) = problems.problem_inputs("floyd_warshall", (fw_n,), dev)
    fw_ref = ref.floyd_warshall_ref(W)
    # min-plus on views of the padded matrix, as the driver launches it: the
    # phase-2 panels in place (one tile across the block), the trailing
    # update into a second buffer, at the default tiles and two others
    Np = -(-fw_n // 64) * 64
    Wp = torch.nn.functional.pad(W, (0, Np - fw_n, 0, Np - fw_n), value=1e18)
    off = Np // 2
    for ti, tj, unroll in ((64, 64, 4), (40, 112, 8), (128, 128, 1)):
        D = Wp.clone()
        diag = D[off:off + 64, off:off + 64].clone()
        want_row = minplus_update_plain(D[off:off + 64], diag, D[off:off + 64])
        row = D[off:off + 64]
        minplus_update(row, diag, row, bi=64, bj=PANEL_TILE, unroll=unroll, out=row)
        got_row = row.clone()  # the column panel rewrites the diagonal block
        want_col = minplus_update_plain(D[:, off:off + 64], D[:, off:off + 64], diag)
        col = D[:, off:off + 64]
        minplus_update(col, col, diag, bi=PANEL_TILE, bj=64, unroll=unroll, out=col)
        E = torch.full_like(D, float("nan"))
        minplus_update(D, col, row, bi=ti, bj=tj, unroll=unroll, out=E)
        torch.cuda.synchronize()
        for label, got, want_ in (("row panel in place", got_row, want_row),
                                  ("column panel in place", D[:, off:off + 64], want_col),
                                  (f"trailing {ti}x{tj}", E, minplus_update_plain(D, col, row))):
            errs["minplus"] = max(errs["minplus"], compare(
                f"minplus {Np}x64 (x) 64x{Np} views, {label}, unroll={unroll}", got, want_,
                EXACT))
        del D, E
    for bs in (16, 32, 64, 128, 256):  # every bs of the gpu space
        want_fw = floyd_warshall_plain(W, bs=bs)
        for bi, bj, unroll in ((64, 64, 4), (24, 128, 1), (112, 40, 8)):
            got = floyd_warshall(W, bs=bs, bi=bi, bj=bj, unroll=unroll,
                                 allow_semiring_reassociation=True)
            torch.cuda.synchronize()
            errs["minplus"] = max(errs["minplus"], compare(
                f"floyd_warshall N={fw_n} bs={bs} bi={bi} bj={bj} unroll={unroll} vs "
                f"blocked plain", got, want_fw, EXACT))
        compare(f"floyd_warshall N={fw_n} bs={bs} vs unblocked floyd_warshall_ref",
                got, fw_ref, FW_REF_TOL)
    for off, bs in ((0, 64), (fw_n // 2 - 64, 128), (fw_n - 256, 256)):
        D = W.clone()
        closure_in_block(D, off, bs)
        torch.cuda.synchronize()
        errs["closure"] = max(errs["closure"], compare(
            f"closure_in_block off={off} bs={bs}", D[off:off + bs, off:off + bs],
            closure_plain(W[off:off + bs, off:off + bs]), EXACT))

    # heat3d at every point of its gpu space (bi = 1 with fuse_t = 2 is where
    # the JAX kernel's halo is short): the plain version's bits
    heat_n, tsteps = problems.LARGE_SHAPES["heat3d"]
    (H,) = problems.problem_inputs("heat3d", (heat_n, tsteps), dev)
    heat_ref = ref.heat3d_ref(H, tsteps)
    for bi in (1, 2, 4, 8, 16, 32):
        for ft in (1, 2):
            got = heat3d(H, tsteps, bi=bi, fuse_t=ft)
            torch.cuda.synchronize()
            errs["heat3d"] = max(errs["heat3d"], compare(
                f"heat3d N={heat_n} tsteps={tsteps} bi={bi} fuse_t={ft} "
                f"{heat3d_plan((heat_n,) * 3, bi, ft)} vs heat3d_plain", got, heat_ref, EXACT))

    # lu: bs dividing N and not, pack on and off, against the plain blocked
    # lu with the same bs and against the unblocked reference
    (lu_n,) = problems.LARGE_SHAPES["lu"]
    (Alu,) = problems.problem_inputs("lu", (lu_n,), dev)
    lu_ref_out = ref.lu_ref(Alu)
    for bs in (8, 32, 128):
        for pack in (True, False):
            got = lu(Alu, bs=bs, bm=64, bn=48, pack=pack)
            torch.cuda.synchronize()
            compare(f"lu N={lu_n} bs={bs} pack={pack} vs blocked plain", got,
                    lu_plain(Alu, bs=bs, pack=pack), LU_TOL, (probe, "LU_TOL"))
        compare(f"lu N={lu_n} bs={bs} vs unblocked lu_ref", got, lu_ref_out, LU_REF_TOL,
                (probe, "LU_REF_TOL"))
    compare(f"lu N={lu_n} default config vs blocked plain", ops.lu_op(Alu),
            lu_plain(Alu, bs=ops.DEFAULTS["lu"]["bs"], pack=ops.DEFAULTS["lu"]["pack"]), LU_TOL,
            (probe, "LU_TOL"))
    # the tensor-core route's probe: its largest error in each class (the
    # f32 matmul, mm3 and lu cases above; the skinny rows run the FFMA loop)
    for cls, (abs_err, share) in probe.items():
        print(f"  3xTF32 matmul probe, {cls} {globals()[cls]}: largest max_abs_err "
              f"{abs_err:.3e}, {share:.3f} of the tolerance", flush=True)
    if any(share > 1.0 for _, share in probe.values()):
        raise AssertionError("the 3xTF32 matmul misses a tolerance")
    for off, bs in ((0, 64), (lu_n // 2 - 64, 128), (lu_n - 8, 8)):
        M = Alu.clone()
        lu_factor_diag(M, off, bs)
        torch.cuda.synchronize()
        errs["lu_factor_diag"] = max(errs["lu_factor_diag"], compare(
            f"lu_factor_diag off={off} bs={bs}", M[off:off + bs, off:off + bs],
            lu_factor_diag_plain(Alu[off:off + bs, off:off + bs]), EXACT))

    check_attention(dev, errs)

    for name in ("syr2k", "mm3", "lu", "covariance", "floyd_warshall", "heat3d",
                 "flash_attention", "decode_attention"):
        bad, total = rejected_points(name, problems.LARGE_SHAPES[name], smem_limit)
        print(f"  gpu space {name}: {bad} of {total} points rejected before launch "
              f"at LARGE (shared memory over {smem_limit} B, or a tile past the "
              f"register tile)")

    # ---- 4. times at the default config ----------------------------------------
    phase("4. times at the default config, LARGE (L2-warm: the working set "
          "fits in the 50 MB L2, as in the paper's repeated runs)")
    N, M = syr2k_dims
    alpha, beta = 1.5, 1.2
    sy_cfg = ops.DEFAULTS["syr2k"]
    rows = {}
    # one product suffices (S = A B^T + B A^T is symmetric): 2 N^2 M flops;
    # the kernel skips the blocks above the diagonal
    b_ms, b_by = bound(2.0 * N * N * M, 4.0 * (2 * N * M + 2 * N * N))
    done = lower_tile_flops(N, min(sy_cfg["bi"], N), min(sy_cfg["bj"], N), 4.0 * M)
    rows["syr2k"] = dict(
        ms=time_ms(lambda: ops.syr2k_op(C, A, B, alpha, beta)),
        plain_ms=time_ms(lambda: syr2k_plain(C, A, B, alpha, beta)),
        library_ms=time_ms(lambda: torch.addmm(
            torch.addmm(C, A, B.T, beta=beta, alpha=alpha), B, A.T, alpha=alpha)),
        bound_ms=b_ms, bound_by=b_by)
    print(f"  syr2k {sy_cfg}: kernel {rows['syr2k']['ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), plain {rows['syr2k']['plain_ms']:.4f} ms, "
          f"library (2x torch.addmm, f32, no TF32) {rows['syr2k']['library_ms']:.4f} ms")
    print(f"  syr2k flops: the kernel computes {done / 1e9:.4f} GFLOP (blocks on or below the "
          f"diagonal, tiles padded to 8), {done / (2.0 * N * N * M):.3f}x the bound's "
          f"2*N^2*M = {2.0 * N * N * M / 1e9:.4f} GFLOP (both products everywhere: "
          f"{4.0 * N * N * M / 1e9:.4f})")

    def mm3_plain():
        E = tiled_matmul_plain(Am, Bm, bk=32, pack=True, out_dtype=torch.float32)
        F = tiled_matmul_plain(Cm, Dm, bk=32, pack=True, out_dtype=torch.float32)
        return tiled_matmul_plain(E, F, bk=32, pack=True, out_dtype=torch.float32)

    mm_flops = 2.0 * (P * Q * R + R * S * T + P * R * T)
    mm_bytes = 4.0 * ((P * Q + Q * R + P * R) + (R * S + S * T + R * T)
                      + (P * R + R * T + P * T))
    b_ms, b_by = bound(mm_flops, mm_bytes, peak=PEAK_3XTF32_FLOPS)  # on the tensor cores
    rows["matmul"] = dict(
        ms=time_ms(lambda: ops.mm3_op(Am, Bm, Cm, Dm)),
        plain_ms=time_ms(mm3_plain),
        library_ms=time_ms(lambda: torch.matmul(torch.matmul(Am, Bm), torch.matmul(Cm, Dm))),
        bound_ms=b_ms, bound_by=b_by)
    print(f"  matmul x3 (mm3 f32) {ops.DEFAULTS['mm3']}: kernel {rows['matmul']['ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}, 3xTF32 at {PEAK_3XTF32_FLOPS / 1e12:.0f} TFLOP/s; "
          f"{bound(mm_flops, mm_bytes)[0]:.4f} ms at the f32 FFMA rate), plain {rows['matmul']['plain_ms']:.4f} ms, "
          f"library (3x torch.matmul, f32, no TF32) {rows['matmul']['library_ms']:.4f} ms",
          flush=True)
    # the serving path's shapes, at the serving default (ops.DEFAULTS["matmul"])
    mm_cfg = {k: v for k, v in ops.DEFAULTS["matmul"].items() if k in ("bm", "bn", "bk", "pack",
                                                                      "interchange")}
    for label, (M_, K_, N_), per in SERVE_MATMULS:
        a, b = model_operands(M_, K_, N_, dev, seed=1)
        # past 8 rows the f32 path runs on the tensor cores (3xTF32)
        tc = min(mm_cfg["bm"], M_) > 8
        s_ms, s_by = bound(2.0 * M_ * K_ * N_, 4.0 * (M_ * K_ + K_ * N_ + M_ * N_),
                           peak=PEAK_3XTF32_FLOPS if tc else PEAK_F32_FLOPS)
        k_ev = time_ms(lambda: tiled_matmul(a, b, **mm_cfg), iters=10)
        k_dev = device_time(lambda: [tiled_matmul(a, b, **mm_cfg) for _ in range(10)])[0] / 10
        l_ev = time_ms(lambda: torch.matmul(a, b), iters=10)
        l_dev = device_time(lambda: [torch.matmul(a, b) for _ in range(10)])[0] / 10
        p_ms = time_ms(lambda: tiled_matmul_plain(a, b, bk=mm_cfg["bk"], pack=True,
                                                  out_dtype=torch.float32), iters=10)
        print(f"  matmul serving {label} ({M_}, {K_}) @ ({K_}, {N_}) f32 {mm_cfg}, {per}: "
              f"kernel {k_dev:.4f} ms on the device (torch.profiler; CUDA events "
              f"{k_ev:.4f} ms), bound {s_ms:.4f} ms ({s_by}, "
              f"{'3xTF32 tensor cores' if tc else 'f32 FFMA'}), plain {p_ms:.4f} ms, library "
              f"(torch.matmul, f32) {l_dev:.4f} ms on the device (CUDA events {l_ev:.4f} ms)",
              flush=True)
        del a, b

    # the second slice's kernels: covariance, lu (its trailing GEMMs run
    # through matmul.cu), floyd_warshall (min-plus), heat3d, and the helpers
    M_cov = cov_dims[1]
    b_ms, b_by = bound(float(M_cov) * (M_cov + 1) * cov_dims[0],
                       4.0 * (cov_dims[0] * M_cov + M_cov * M_cov))
    rows["covariance"] = dict(
        ms=time_ms(lambda: ops.covariance_op(data)),
        plain_ms=time_ms(lambda: covariance_plain(data)),
        library_ms=time_ms(lambda: torch.cov(data.T)),
        bound_ms=b_ms, bound_by=b_by)
    print(f"  covariance {ops.DEFAULTS['covariance']}: kernel {rows['covariance']['ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; counted: M(M+1)N flops, the symmetric half), plain "
          f"{rows['covariance']['plain_ms']:.4f} ms, library (torch.cov(data.T), f32, no TF32) "
          f"{rows['covariance']['library_ms']:.4f} ms", flush=True)
    cov_cfg = ops.DEFAULTS["covariance"]
    done = lower_tile_flops(M_cov, min(cov_cfg["bi"], M_cov), min(cov_cfg["bj"], M_cov),
                            2.0 * cov_dims[0])
    print(f"  covariance flops: the kernel computes {done / 1e9:.4f} GFLOP ({done / 2e9:.4f} G "
          f"FFMA; blocks on or below the diagonal, tiles padded to 8), "
          f"{done / (float(M_cov) * (M_cov + 1) * cov_dims[0]):.3f}x the bound's M(M+1)N = "
          f"{float(M_cov) * (M_cov + 1) * cov_dims[0] / 1e9:.4f} GFLOP (both halves: "
          f"{2.0 * M_cov * M_cov * cov_dims[0] / 1e9:.4f}); "
          f"{done / (rows['covariance']['ms'] * 1e-3) / 1e12:.2f} TFLOP/s executed", flush=True)

    def per_call(name, fn, wrappers, event_ms):
        n = launches_per_call(fn, wrappers)
        wall = host_ms(fn)
        print(f"  {name}: kernel launches per call {n}, host wall per call "
              f"(perf_counter around call + synchronize) {wall:.4f} ms, CUDA-event time "
              f"{event_ms:.4f} ms", flush=True)
        dev_ms, kernels_by_name = device_time(fn)
        if dev_ms == 0.0:
            print(f"  {name}: device busy time per call: not measured (the profiler "
                  f"recorded no device time)")
            return
        top = sorted(kernels_by_name.items(), key=lambda kv: -kv[1][1])[:4]
        print(f"  {name}: device kernels per call (torch.profiler) "
              f"{sum(c for c, _ in kernels_by_name.values())}, busy {dev_ms:.4f} ms "
              f"({dev_ms / wall:.1%} of the host wall); largest: "
              + "; ".join(f"{k[:60]} x{c} {t:.4f} ms" for k, (c, t) in top), flush=True)

    lu_bs = ops.DEFAULTS["lu"]["bs"]
    b_ms, b_by = bound(2.0 / 3.0 * lu_n ** 3, 4.0 * 2 * lu_n * lu_n)
    lu_row = dict(ms=time_ms(lambda: ops.lu_op(Alu)),
                  plain_ms=time_ms(lambda: lu_plain(Alu, bs=lu_bs), iters=5, warmup=1),
                  library_ms=time_ms(lambda: torch.linalg.lu_factor_ex(Alu, pivot=False)),
                  bound_ms=b_ms, bound_by=b_by)
    print(f"  lu {ops.DEFAULTS['lu']}: kernel {lu_row['ms']:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}; counted: 2/3 N^3 flops), plain {lu_row['plain_ms']:.4f} ms, library "
          f"(torch.linalg.lu_factor_ex(A, pivot=False)) {lu_row['library_ms']:.4f} ms")
    per_call("lu", lambda: ops.lu_op(Alu), (lu_factor_diag, tiled_matmul), lu_row["ms"])

    fw_bs = ops.DEFAULTS["floyd_warshall"]["bs"]
    b_ms, b_by = bound(float(fw_n) ** 3, 4.0 * 2 * fw_n * fw_n, peak=PEAK_F32_MIN)
    rows["minplus"] = dict(
        ms=time_ms(lambda: ops.floyd_warshall_op(W)),
        plain_ms=time_ms(lambda: floyd_warshall_plain(W, bs=fw_bs), iters=3, warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    print(f"  floyd_warshall {ops.DEFAULTS['floyd_warshall']}: kernel "
          f"{rows['minplus']['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; counted: N^3 f32 minima at "
          f"{PEAK_F32_MIN / 1e12:.2f} T/s, the add beside each on the FMA pipe), plain "
          f"{rows['minplus']['plain_ms']:.4f} ms, library: none (no PyTorch call computes "
          f"min-plus closure)")
    per_call("floyd_warshall", lambda: ops.floyd_warshall_op(W),
             (closure_in_block, minplus_update), rows["minplus"]["ms"])
    # the call's device time by part: each round launches the closure, copies
    # the diagonal block, then the row panel, the column panel and the
    # trailing update, in that order
    parts = {"row panels": [], "column panels": [], "trailing updates": [], "closures": [],
             "copies and fills": []}
    n_mp = 0
    for name, ms in device_kernels_in_order(lambda: ops.floyd_warshall_op(W)):
        if "minplus_kernel" in name:
            parts[("row panels", "column panels", "trailing updates")[n_mp % 3]].append(ms)
            n_mp += 1
        elif "closure_kernel" in name:
            parts["closures"].append(ms)
        else:
            parts["copies and fills"].append(ms)
    print(f"  floyd_warshall device time by part (torch.profiler trace, one call, "
          f"{sum(map(len, parts.values()))} device kernels; 355 before the driver passed views): "
          + "; ".join(f"{k} x{len(v)} {sum(v):.4f} ms ({sum(v) / max(len(v), 1) * 1e3:.1f} us "
                      f"each)" for k, v in parts.items()), flush=True)
    Np = -(-fw_n // fw_bs) * fw_bs
    Wp = torch.nn.functional.pad(W, (0, Np - fw_n, 0, Np - fw_n), value=1e18)
    col, row = Wp[:, :fw_bs].contiguous(), Wp[:fw_bs].contiguous()
    mp_cfg = {k: v for k, v in ops.DEFAULTS["floyd_warshall"].items() if k != "bs"}
    E = torch.empty_like(Wp)
    tr_ev = time_ms(lambda: minplus_update(Wp, col, row, out=E, **mp_cfg), iters=50)
    tr_dev = device_time(lambda: [minplus_update(Wp, col, row, out=E, **mp_cfg)
                                  for _ in range(20)])[0] / 20
    print(f"  one trailing min-plus update {Np}x{fw_bs} (x) {fw_bs}x{Np} {mp_cfg}: "
          f"{tr_dev:.4f} ms on the device (CUDA events {tr_ev:.4f} ms), bound "
          f"{bound(float(Np) * Np * fw_bs, 4.0 * 3 * Np * Np, peak=PEAK_F32_MIN)[0]:.4f} ms "
          f"(N^2 bs minima at {PEAK_F32_MIN / 1e12:.2f} T/s)")
    Dp, diag = Wp.clone(), Wp[:fw_bs, :fw_bs].clone()
    rp = Dp[:fw_bs]
    pn_cfg = dict(bi=fw_bs, bj=PANEL_TILE, unroll=mp_cfg["unroll"])
    pn_ev = time_ms(lambda: minplus_update(rp, diag, rp, out=rp, **pn_cfg), iters=50)
    pn_dev = device_time(lambda: [minplus_update(rp, diag, rp, out=rp, **pn_cfg)
                                  for _ in range(20)])[0] / 20
    print(f"  one row panel {fw_bs}x{fw_bs} (x) {fw_bs}x{Np} in place {pn_cfg}: "
          f"{pn_dev:.4f} ms on the device (CUDA events {pn_ev:.4f} ms), bound "
          f"{bound(float(Np) * fw_bs * fw_bs, 4.0 * 2 * Np * fw_bs, peak=PEAK_F32_MIN)[0]:.4f} ms",
          flush=True)
    del Dp, E

    b_ms, b_by = bound(13.0 * 2 * tsteps * (heat_n - 2) ** 3, 4.0 * 2 * heat_n ** 3)
    # the library yardstick: the same 7-point weights as one F.conv3d over
    # the interior (0.25 at the centre, 0.125 at the six neighbours), called
    # 2 * tsteps times back to back and timed as a whole. Interior only, not
    # the reference's rounding (cuDNN sums the seven products its own way).
    wgt = torch.zeros(1, 1, 3, 3, 3, device=dev)
    wgt[0, 0, 1, 1, 1] = 0.25
    for d in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        wgt[(0, 0) + d] = 0.125
    H5 = H[None, None]
    conv_ms = time_ms(lambda: [torch.nn.functional.conv3d(H5, wgt) for _ in range(2 * tsteps)],
                      iters=3, warmup=1)
    rows["heat3d"] = dict(
        ms=time_ms(lambda: ops.heat3d_op(H, tsteps), iters=10),
        plain_ms=time_ms(lambda: heat3d_plain(H, tsteps), iters=3, warmup=1),
        library_ms=conv_ms, bound_ms=b_ms, bound_by=b_by)
    h_cfg = ops.DEFAULTS["heat3d"]
    passes = 2 * tsteps // h_cfg["fuse_t"]
    print(f"  heat3d {h_cfg} {heat3d_plan((heat_n,) * 3, h_cfg['bi'], h_cfg['fuse_t'])}: "
          f"kernel {rows['heat3d']['ms']:.4f} ms ({rows['heat3d']['ms'] / passes * 1e3:.2f} us "
          f"a pass by CUDA events, {passes} passes), bound {b_ms:.4f} ms ({b_by}; counted: 13 "
          f"flops per interior point and step), plain {rows['heat3d']['plain_ms']:.4f} ms, "
          f"library {conv_ms:.4f} ms (F.conv3d, TF32 off, {2 * tsteps} calls timed together, "
          f"{conv_ms / (2 * tsteps) * 1e3:.2f} us a call: interior only, not the reference's "
          f"rounding)", flush=True)
    per_call("heat3d", lambda: ops.heat3d_op(H, tsteps), (heat3d,), rows["heat3d"]["ms"])
    h_dev = device_time(lambda: ops.heat3d_op(H, tsteps))[0]
    print(f"  heat3d per pass: {h_dev / passes * 1e3:.2f} us on the device (torch.profiler, "
          f"kernels only) against {rows['heat3d']['ms'] / passes * 1e3:.2f} us by CUDA events "
          f"(the gaps between back-to-back launches included)", flush=True)

    blk = Alu[:lu_bs, :lu_bs].contiguous()
    b_ms, b_by = bound(2.0 / 3.0 * lu_bs ** 3, 4.0 * 2 * lu_bs * lu_bs)
    rows["lu_factor_diag"] = dict(
        ms=time_ms(lambda: lu_factor_diag(blk.clone(), 0, lu_bs)),
        plain_ms=time_ms(lambda: lu_factor_diag_plain(blk)),
        library_ms=time_ms(lambda: torch.linalg.lu_factor_ex(blk, pivot=False)),
        bound_ms=b_ms, bound_by=b_by)
    clo = W[:fw_bs, :fw_bs].contiguous()
    b_ms, b_by = bound(float(fw_bs) ** 3, 4.0 * 2 * fw_bs * fw_bs, peak=PEAK_F32_MIN)
    rows["closure"] = dict(
        ms=time_ms(lambda: closure_in_block(clo.clone(), 0, fw_bs)),
        plain_ms=time_ms(lambda: closure_plain(clo)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    for name, bs in (("lu_factor_diag", lu_bs), ("closure", fw_bs)):
        r = rows[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"  {name} helper, one {bs}x{bs} block (with the clone it works on): kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}", flush=True)

    time_attention(rows)

    # ---- 5. the main path --------------------------------------------------------
    phase("5. main path: repro_torch.launch.autotune campaigns at LARGE")
    paths = {  # kernel -> wrappers whose counts its campaign must raise
        "syr2k": (syr2k,), "mm3": (tiled_matmul,),
        "lu": (tiled_matmul, lu_factor_diag), "covariance": (covariance,),
        "floyd_warshall": (minplus_update, closure_in_block), "heat3d": (heat3d,)}

    def best_check(kernel, best):
        if kernel == "syr2k":
            return ops.syr2k_op(C, A, B, config=best), syr2k_plain(C, A, B), SYR2K_TOL
        if kernel == "mm3":
            return ops.mm3_op(Am, Bm, Cm, Dm, config=best), ref.mm3_ref(Am, Bm, Cm, Dm), F32_TOL
        if kernel == "lu":
            cfg = dict(ops.DEFAULTS["lu"], **best)
            return ops.lu_op(Alu, config=best), lu_plain(Alu, bs=cfg["bs"], pack=cfg["pack"]), LU_TOL
        if kernel == "covariance":
            return ops.covariance_op(data, config=best), covariance_plain(data), COV_TOL
        if kernel == "floyd_warshall":
            cfg = dict(ops.DEFAULTS["floyd_warshall"], **best)
            return ops.floyd_warshall_op(W, config=best), floyd_warshall_plain(W, bs=cfg["bs"]), EXACT
        return ops.heat3d_op(H, tsteps, config=best), heat_ref, HEAT_TOL

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for kernel, evals in CAMPAIGNS:
            db = os.path.join(tmp, kernel)
            wrappers = paths[kernel]
            for w in wrappers:
                w.launches = 0
            summary = run_campaign(kernel, evals, db)
            counts = {w.__name__: w.launches for w in wrappers}
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            recs = PerformanceDatabase(db).records
            n_ok = sum(r.status == OK for r in recs)
            t, wall = summary["timings"], summary["wall_sec"]
            tuner = t["ask_sec"] + t["tell_sec"]
            timed = sum(sum(r.info.get("times_sec", ())) for r in recs)
            print(f"  {kernel}: {len(recs)} records, {n_ok} ok, launches {counts}; best "
                  f"{summary['best_objective_sec'] * 1e3:.4f} ms at eval "
                  f"{summary['found_at_eval']} {summary['best_config']}; wall "
                  f"{wall:.2f} s ({len(recs) / wall:.1f} evals/s), ask {t['ask_sec']:.2f} s, "
                  f"tell {t['tell_sec']:.3f} s, wait {t['wait_sec']:.2f} s (tuner share "
                  f"{tuner / wall:.1%}); CUDA-event time of the timed runs "
                  f"{timed:.3f} s ({timed / wall:.1%} of wall)", flush=True)
            if len(recs) != evals:
                raise AssertionError(f"{kernel}: {len(recs)} records for {evals} evaluations")
            for name, n in counts.items():
                if n < n_ok:
                    raise AssertionError(f"{kernel}: {name} launched {n} times < {n_ok} ok evals")
            if n_ok * 2 < evals:
                raise AssertionError(f"{kernel}: only {n_ok} of {evals} evaluations ok")
            got, want, tol = best_check(kernel, summary["best_config"])
            torch.cuda.synchronize()
            compare(f"{kernel} best config vs plain", got, want, tol)

    # ---- 6. the serving path ------------------------------------------------------
    phase("6. serving path: repro_torch.launch.serve, qwen2-0.5b full width, f32")
    serving(launches, dev)

    def entry(name, source, replaces):
        return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, launches=launches[WRAPPER_OF[name]],
                    max_abs_err=errs[name], **rows[name])

    kernels = [
        entry("syr2k", "syr2k.cu", "src/repro/kernels/syr2k.py:32"),
        entry("matmul", "matmul.cu", "src/repro/kernels/matmul.py:34"),
        entry("covariance", "covariance.cu", "src/repro/kernels/covariance.py:28"),
        entry("minplus", "floyd_warshall.cu", "src/repro/kernels/floyd_warshall.py:40"),
        entry("heat3d", "heat3d.cu", "src/repro/kernels/heat3d.py:71"),
        entry("lu_factor_diag", "lu.cu", "src/repro/kernels/lu.py:33"),
        entry("closure", "floyd_warshall.cu", "src/repro/kernels/floyd_warshall.py:93"),
        entry("flash_attention", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:37"),
        entry("decode_attention", "decode_attention.cu",
              "src/repro/kernels/decode_attention.py:62"),
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
