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
     the two helpers (at every bs of their gpu spaces, on and off 16-byte
     words), which must agree bit for bit; syr2k and covariance on NaN-poisoned
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
     lu's into diagonal factors, triangular solves, trailing updates and the
     rest; the two helpers at every bs of their spaces, a launch and a step,
     beside their dependency floor (mma_rate.py's probe, device times by
     torch.profiler as the helpers': an empty kernel and the helper's
     exchange steps) and their ops/bytes bound;
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
     tokens must equal each request's solo run (greedy_decode's serve loop
     on the prefill it was admitted from); and a short run on
     the card against the same weights on the CPU (plain versions there);
  7. the tuning loop: (a) `launch.autotune --store` publishes a syr2k
     campaign's best at LARGE, `DispatchService` resolves it as an exact hit
     and serves that config (against the plain version), and a
     `--warm-start` campaign evaluates it first; (b) qwen2-0.5b served as in
     phase 6 with a `BackgroundTuner` (8 evaluations a campaign): every
     serving signature's miss enqueues one campaign on the card, each
     publishes, and a second run on that store resolves every signature
     exactly and enqueues nothing, with its greedy tokens and first logits
     against run 1's; each signature's device time, default against tuned;
     (c) a `GuardAgent` shadow-times run 2 on the device (epsilon 0.25) with
     no quarantine; then a record of the decode step's output projection at
     1/20 of its measured time is quarantined two watch windows later,
     serving falls back and a re-campaign is enqueued; what the 8
     background evaluations found at the decode output projection, (4, 896)
     @ (896, 896), beside the default config;
  8. the multi-fidelity cascade (repro_torch.fidelity), each part with the
     launch counts set to 0 just before and read just after: (a)
     `launch.fidelity audit` on all nine kernels at LARGE, 16 seeded configs
     of each gpu space, the Hopper cost model's Spearman rho against
     CUDA-event times, strong or weak (the report, with every pair, goes to
     fidelity_audit.json in $CHIP_SMOKE_OUT, default build/), the same
     audit at the proxy rung's PROXY_DIMS (`audit --proxy-dims`) for syr2k,
     mm3 and covariance, each rho beside LARGE's, and the cost
     model's shared-memory verdicts against SmemBudget's over sampled
     configs; (b) `launch.autotune
     --kernel syr2k --cascade --rung-budgets 64,16,8` at LARGE: records carry
     their rung, at most 8 evaluations at full size, syr2k's launches equal
     the timed runs of rungs 1-2, the best config against the plain version,
     a rerun with --resume a no-op; each rung's seconds, the calibration fit
     and the best objective beside phase 5's flat campaign; (c) one
     BackgroundTuner(cascade=True) campaign at the decode output
     projection's signature, (4, 896) @ (896, 896), whose record the service
     then resolves exactly;
  9. the paper's tables on the card (benchmarks/torch_tables.py), each with
     the launch counts set to 0 just before and read just after: Tables 1-7
     at LARGE, the five rows of each (the naive loop, the library, the
     kernel at the heuristic tiles and at the paper's, the autotuned winner
     of an RF campaign cut in length to 20 evaluations, heat3d's 12), a
     config the wrapper refuses printed `rejected` and followed by its
     `_clipped` row (a time, or `rejected` again); each winner, and each
     config rows 3-4 ran, against the kernel's plain version at phase 3's
     tolerances; then the four-learner study (benchmarks/torch_learners.py,
     syr2k at LARGE, 30 evaluations a learner): each learner's best, where
     it found it and its skipped duplicates; the phase's seconds.

 10. the MoE family (each arch with the launch counts set to 0 just before
     and read just after its served run): mixtral-8x7b (4 of 32 layers) and
     deepseek-v2-236b (3 of 60: the dense layer 0 and 2 MoE layers) at full
     width in f32 from seeded weights, batch 4, prompt 128, 16 new tokens,
     through greedy_decode and a DispatchService; the matmul's launches per
     forward and per decode step (mixtral 5, deepseek 1; no attention
     kernel: mixtral has a sliding window, MLA is plain, as in the JAX
     package), TTFT, ms per decode step beside two bytes bounds (all weights
     but the embed table; only the top-k experts), the busy share of one
     step, the new matmul signatures against torch.matmul, peak memory; MLA's
     absorbed and naive schedules on one filled cache (1e-3); a
     PagedKVCache round for mixtral against each request's solo run; the
     card against the CPU at one MoE layer (mixtral 1
     layer, deepseek 2) on a prompt of 8, beside the least routing margin.
 11. the SSM, hybrid and VLM families (each arch with the launch counts
     set to 0 just before and read just after its served run):
     mamba2-780m (48 Mamba2 layers), zamba2-1.2b (7 of its 38 Mamba2 layers,
     its check depth: phase 17 serves all 38 in bf16; the shared attention
     block at 2 sites) and qwen2-vl-7b (28 layers, M-RoPE)
     at full width in f32 from seeded weights, batch 4,
     prompt 128 (two SSD chunks), 16 new tokens, through greedy_decode and a
     DispatchService; the launches per forward and per decode step asserted
     exactly (mamba2: the unembed's matmul; zamba2: a flash call a site and
     forward, a decode_attention launch a site and step, a matmul more; qwen2-vl: 196 flash
     calls, 28 decode_attention, 29 matmuls), TTFT, ms per decode step beside
     its bytes bound (weights but the embed table, zamba2's shared block once
     a site, the Mamba2 state read and written, the K/V read), the busy share
     and device kernels of one step, peak memory; the new matmul, flash and
     decode signatures against their plain versions and timed beside
     torch.matmul and SDPA; a PagedKVCache round for qwen2-vl; the card
     against the CPU at the depth cut (mamba2 4 layers, zamba2 7, qwen2-vl
     2), beside the least gap between the top two logits.
 12. training (the launch counts set to 0 before and read after: training
     passes no dispatch service, as the JAX package's step, so they stay
     0): (a) `repro_torch.launch.train.run` on qwen2-0.5b at full width and
     full depth in f32, batch 8 x 512, 8 steps on one repeated batch, the
     losses and grad norms finite and the last loss below the first; ms a
     step, tokens/s, the step's FLOPs as a share of the f32 peak, peak
     memory, one step's device time by kernel class (torch.profiler); (b)
     the first two steps again under remat "full" and "dots": the first
     loss equal within 1e-6, the peaks; (c) the card against the CPU at 2
     layers (batch 2 x 64, 3 steps, the same weights and batches): losses
     and grad norms per step, the parameters after step 1 (an element past
     the tolerance must have a gradient Adam's first step cannot resolve);
     (d) a step of mamba2-780m (full depth) and mixtral-8x7b (1 layer); (e)
     an AsyncCheckpointer save of (c)'s 2 GB train state restored bit for
     bit, then `launch.train --reduced` on the card resuming from step 4.
 13. the audio family: (a) whisper-large-v3 at full width, 2 encoder
     layers over 1500 frames and 2 decoder layers with cross-attention (its
     check depth: phase 17 serves the 32 + 32 in bf16), in f32 from seeded
     weights and frames, batch 4,
     prompt 64, 16 new tokens, through greedy_decode and a DispatchService,
     with the launch counts set to 0 just before and read just after: the
     matmul once a forward and once a decode step (the unembed), no
     attention kernel; the cross K/V a prefill leaves against the encoder's
     output recomputed; TTFT, the forward alone, ms per decode step beside
     its bytes bound (the decoder's weights, the cross and self K/V), the
     busy share and the largest device kernels of one step, tokens/s, peak
     memory; (b) the unembed's signatures (4 and 256 rows @ (1280, 51,866):
     N not a multiple of 4) against their plain version and timed beside
     torch.matmul; (c) the card against the CPU at 2 + 2 layers; (d) one
     train step at full depth under remat "full" (FLOPs counted from the
     leaves), the first step at 4 + 4 layers under each remat policy, the
     card against the CPU at 2 + 2 layers over 3 steps.
 14. serving under load: (a) every decode_attention signature the
     benchmark's tuned run can meet (batch 1, 2, 4, 8; the page-aligned
     buckets of every page size, and the full allocation) against the plain
     version at every bk/hg of the gpu space; then
     `benchmarks/torch_serve_bench.main` with the launch counts set to 0
     just before and read just after: qwen2-0.5b at full width in f32, the
     JAX package's full workload cut to 16 requests (at 12/s, prompts
     16/32/48),
     modes einsum (no kernel), default and tuned, the guard's shadow
     overhead (at most 2%) and drift loop, its tripwires; per mode p50/p99
     token latency, TTFT p50, tokens/s and launches; each request's ids
     equal in the default and tuned modes; `launch.obs summarize --metrics`
     on its snapshot; the typical decode signature timed at the tuned and
     the default config beside SDPA; (b) gemma3-1b (a prompt of 520, past
     its window of 512), minitron-4b and qwen1.5-0.5b at full width through
     `launch.serve.serve` at their check depths (6, 2 and 2 layers: phase 17
     serves every layer in bf16), batch 4, 16 new tokens, each with
     the launch counts set to 0 just before and read just after, asserted
     per forward and per step (gemma3: the matmul alone, its windowed
     attention plain); TTFT, ms per decode step beside its bytes bound, busy
     share, peak memory; the new matmul and attention signatures against
     their plain versions, timed beside torch.matmul and SDPA; the card
     against the CPU at that depth (gemma3 6 layers, one local:global
     period, also its forward past the window; the others 2).
 15. the fleet and the analyzer (each part with the launch counts set to 0
     just before and read just after): (a) two DispatchServices in one
     process, hosts A and B, each with its own TuningStore, Replica and
     SyncAgent over one FileTransport directory: A's BackgroundTuner
     campaign (8 evaluations) for syr2k at LARGE publishes, and after a
     sync_once on each, B's calls resolve A's config as an exact hit with
     no campaign enqueued and launch syr2k once each, against the plain
     version; (b) B serves mm3 at a record of its own through a jit_cached
     proxy, A publishes a faster one (both timed here by CUDA events), the
     sync invalidates B's executable (serve_rebuilt), B launches matmul.cu
     with A's config, and A's quarantine of that record reaches B, bans its
     reintroduction and returns B to its own record; (c) a host C pulls over
     HTTP (a FleetServer on 127.0.0.1, port 0) and serves as B did, bit for
     bit; (d) `launch.analyze space --json` on all nine kernels (host at the
     bench dims, cost and gpu at LARGE; written to analyze_space.json in
     $CHIP_SMOKE_OUT) with each row's infeasible and warned shares, up to 4
     sampled configs that the gpu target accepts (warned ones first) of
     each PolyBench kernel launched and held against the plain version,
     and `launch.analyze lint`: 0 findings over src/repro_torch.
 16. parallelism, the roofline and the dry-run (no kernel of the table on
     this path; the launch counts set to 0 just before and read just after):
     (a) `python -m repro_torch.launch.dryrun` in subprocesses on the CPU,
     a fake world of 256 / 512 ranks each: qwen2-0.5b's train_4k,
     prefill_32k and decode_32k on the 16x16 mesh and one cell of every
     other family at full width and full depth (mamba2-780m and gemma3-1b
     on 2x16x16), each row's dominant term and bound, roofline fraction,
     6ND/counted, collective bytes by kind, peak per device and fits_card
     (the card's memory), then `benchmarks/torch_roofline_table.py` over
     them; (b) phase 12's step (qwen2-0.5b, batch 8 x 512, full depth, f32)
     with its params and AdamW moments as DTensors on `local_mesh("cuda")`
     (NCCL, world 1) and act_spec/logits_spec, 3 steps' losses against the
     plain step's (1e-6 relative), ms a step beside the plain step's, and
     `perf.op_cost.trace_step` of one plain step: FLOPs beside the closed
     form, bytes, the roofline bound with the card's figures beside the
     measured ms; (c) `ft.compression.compressed_psum` over NCCL with each
     payload (the wire dtype read from the counted c10d call), and
     `benchmarks/torch_compression_bench.py`'s bytes per parameter; (d)
     `benchmarks/torch_hillclimb.py --probe` on qwen2-0.5b train_4k (16x16,
     full width and full depth; its rows in 3 worker processes) and a
     4-evaluation campaign through CostModelEvaluator (2 in flight), then
     `benchmarks/torch_flash_adjust.py` on the probe's JSON. The
     subprocesses of (a) and (c) run beside (b); (d)'s start before phase
     10 and run beside phases 10-13, and phase 14 starts after they end
     (its timed gates run on a quiet host).
 17. the catalog in its own dtype, bf16 (the matmul's bf16 wgmma route
     in the kernels line as matmul_bf16, its split stream for the decode's
     rows as matmul_split; the launch counts set to 0 just before each
     model's greedy run and read just after): (a) the bf16 matmul against
     its plain version at three served forward products and two ragged
     shapes, every chunk of the gpu space under tiles that take pack on and
     off, either raster order, out f32 and bf16; the split stream (rows 1,
     4 and 8, f32 and bf16) at every column tile and chunk at mixtral's
     output projection and whisper's unembed, repeated calls bit-identical,
     and the wgmma route at every tile past 8 rows; (b) the catalog's ten
     configs served in bf16 at full width through greedy_decode and a
     DispatchService (batch 4, prompt 128, 16 tokens): qwen2-0.5b,
     qwen2-vl-7b, mamba2-780m, gemma3-1b, minitron-4b, qwen1.5-0.5b,
     zamba2-1.2b and whisper-large-v3 (32 + 32 layers over 1500 frames) at
     full depth, mixtral-8x7b at 16 of 32 layers, deepseek-v2-236b at 6 of
     60 (its dense layer 0 and 5 MoE layers), the routes asserted per
     signature (whisper's forward unembed, N = 51,866, on mma.sync):
     TTFT, ms a decode step beside its bf16 bytes bound, tok/s, peak
     memory, busy share and device kernels a step beside the f32 phases'
     figures; each served matmul signature against its plain version, timed
     beside torch.matmul in bf16; the attention kernels at the bf16 model
     shapes beside SDPA in bf16 (gemma3's hd 256 with its window and
     whisper's cross-attention over 1500 frames too, which their served
     runs keep plain); a bf16 PagedKVCache round (qwen2-0.5b), its tokens
     equal each request's solo run up to a near-tie; (c) the card against
     the CPU in bf16 at phases 10-14's check depths over the check's prompt
     and the card's greedy tokens, teacher-forced, beside the least router
     (MoE) or top-2 logit margin of the card's run: the logits within a
     share of the largest |logit|, greedy tokens equal up to a near-tie,
     the argmax equal at every position whose CPU margin clears that share
     (at least a quarter of them), a MoE position whose experts the card
     and the CPU chose differently named and left out. Phases 11 and 17
     share one serving function (serve_arch), phases 13 and 17 another
     (audio_serve), in f32 and in bf16.

Phases 3 and 4 also hold flash_attention and decode_attention against their
plain versions at LARGE, at head_dim 256, at head sizes between the
instantiations (80, 96, 112, 160, 192; decode also with more query heads
than one launch takes), past 256 (272, 320, 512: column groups of 256; flash
at (8, 2048, hd), decode at LARGE's rows and the model's bucket) and at the
model's shapes, and time
them beside
scaled_dot_product_attention (a yardstick only: the port never calls it);
decode_attention with per-row positions that leave whole splits of the key
axis empty, rows at cur_pos = -1 exactly 0, and repeated calls (also after a
call at another BH) bit-identical; decode_attention also at head sizes off
the multiples of 16 (40, 72, 100: run at the next one, loads masked).

Phases 6, 10, 11, 13, 14 and 17 also hold the route csrc/matmul.cu reported
for every served matmul (check_routes): a decode step's rows on the split
stream in either dtype, a bf16 forward's on wgmma, an f32 forward's on
mma.sync in 3xTF32; the kernels line's matmul_split row is the split stream
at mixtral's bf16 decode output projection, (4, 4096) @ (4096, 4096).

The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Any failed phase raises and the
script exits non-zero without that line. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()  # the run's start, which each phase's banner counts from
ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# the H100 SXM's peaks every bound_ms below is taken against, from their
# one owner, the port's cost model (repro_torch.kernels.cost): f32 FFMA on the
# CUDA cores (67 TFLOP/s, the data sheet's dense f32) and HBM3 (3.35 TB/s);
# the tiled matmul's f32 path past 8 rows on the tensor cores in 3xTF32
# (csrc/gemm_tf32.cuh: three TF32 products per f32 product, a third of the
# data sheet's 495 TFLOP/s dense TF32); f32 minima, a quarter of the FFMA
# rate (the CUDA C Programming Guide's throughput table gives compute
# capability 9.0 64 compare/minimum results per clock and SM against 128 FMA;
# Floyd-Warshall's add issues beside each, on the FMA pipe); the bf16
# matmul past 8 rows against the data sheet's dense bf16 tensor-core peak
# (989 TFLOP/s)
if os.path.isdir(os.path.join(SRC, "repro_torch")):
    sys.path.insert(0, SRC)
    from repro_torch.kernels.cost import FFMA_FLOPS as PEAK_F32_FLOPS
    from repro_torch.kernels.cost import HBM_BYTES_PER_SEC as PEAK_HBM_BYTES
    from repro_torch.kernels.cost import MINMAX_OPS as PEAK_F32_MIN
    from repro_torch.kernels.cost import TF32X3_FLOPS as PEAK_3XTF32_FLOPS
    from repro_torch.kernels.cost import BF16_FLOPS as PEAK_BF16_FLOPS

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
# head sizes past 256 (column groups of 256 in both attention kernels)
WIDE_HEAD_SIZES = (272, 320, 512)

# the kernels line's names -> the wrapper that counts their launches
WRAPPER_OF = {"syr2k": "syr2k", "matmul": "tiled_matmul", "covariance": "covariance",
              "minplus": "minplus_update", "heat3d": "heat3d",
              "lu_factor_diag": "lu_factor_diag", "closure": "closure_in_block",
              "flash_attention": "flash_attention", "decode_attention": "decode_attention",
              "matmul_bf16": "matmul_bf16", "matmul_split": "matmul_split"}
# each served model's figures, by arch (phases 6, 10 and 11, in f32), which
# phase 17 prints beside its bf16 ones
SERVED: dict = {}
# the serving phase: qwen2-0.5b at full width, f32
SERVE = dict(arch="qwen2-0.5b", batch=4, prompt_len=256, gen=32, seed=0)
# phase 10: the MoE family at full width, f32, depth cut: (arch, layers
# served, layers of the card-against-CPU check: one MoE layer, deepseek's
# dense layer 0 before it); batch 4, prompt 128, 16 new tokens; the check's
# prompt; the paged round's prompts and rounds (mixtral)
MOE_ARCHS = (("mixtral-8x7b", 4, 1), ("deepseek-v2-236b", 3, 2))
MOE_SERVE = dict(batch=4, prompt_len=128, gen=16, seed=0, check_prompt=8, check_gen=4,
                 paged_lens=(16, 40, 64, 100), paged_rounds=8)
# phase 11: the SSM, hybrid and VLM families at full width, f32: (arch,
# layers served (None: all), layers of the card-against-CPU check: mamba2 4,
# zamba2 7 (a segment of 6 and one of 1: both of its shared block's segment
# shapes), qwen2-vl 2); zamba2 is served at its check depth, since phase 17
# serves its 38 layers in bf16; batch 4, prompt 128 (two SSD chunks of 64),
# 16 new tokens; the check's prompt, new tokens and SSD chunk (two chunks);
# the paged round's prompts and rounds (qwen2-vl)
SSM_ARCHS = (("mamba2-780m", None, 4), ("zamba2-1.2b", 7, 7), ("qwen2-vl-7b", None, 2))
SSM_SERVE = dict(batch=4, prompt_len=128, gen=16, seed=0, check_prompt=16, check_gen=4,
                 check_chunk=8, paged_arch="qwen2-vl-7b", paged_lens=(16, 40, 64, 100),
                 paged_rounds=8)
# phase 12: training on the card, f32 (TF32 off, phase 1): (a) qwen2-0.5b at
# full width and full depth through launch.train.run, 8 steps on one
# repeated batch of 8 x 512; (b) its first two steps again under remat
# "full" and "dots" (the first's loss, the second's time); (c) the card against the CPU at full width, depth cut to 2
# layers, batch 2 x 64, 3 steps, the same weights and batches; (d) one step
# of mamba2-780m (full depth) and of mixtral-8x7b (depth cut to 1), batch 2
# x 256; (e) an AsyncCheckpointer save of (c)'s train state restored bit for
# bit, then the CLI's resume at --reduced (steps 4, then 6)
# (lr 1e-3, a 0.5B model's usual peak, below the CLI's 3e-3 for the reduced
# configs: Adam moves every weight about lr a step, 3% of qwen2's init scale)
TRAIN = dict(arch="qwen2-0.5b", batch=8, seq=512, steps=8, seed=0, lr=1e-3)
TRAIN_CHECK = dict(layers=2, batch=2, seq=64, steps=3)
TRAIN_ONE_STEP = (("mamba2-780m", None), ("mixtral-8x7b", 1))
TRAIN_ONE_STEP_SHAPE = dict(batch=2, seq=256)
# card (cuBLAS) against CPU (its BLAS), f32: a step's loss and grad norm
# differ by the products' summation orders (relative 1e-4 and 1e-3); the
# parameters after step 1 (|p| ~ 0.03, moved about lr = 1e-3 each) to 1e-6 +
# 1e-5*|cpu|. Adam's first step is g / (|g| + eps) per element (eps 1e-8): it
# follows a gradient's rounding where |g| is within 100 eps (1e-6; the
# gradients' rms is about 1e-3) or where the two devices do not determine
# the gradient to 1% (the first moment, (1 - b1) g, tells), and its element
# then moves up to lr either way: an element past the tolerance must be one
# of those
TRAIN_TOL = dict(loss_rtol=1e-4, gnorm_rtol=1e-3, param=dict(atol=1e-6, rtol=1e-5),
                 grad_rtol=1e-2, grad_floor=1e-6)
# remat changes no value: the first step's loss under each policy
REMAT_RTOL = 1e-6
# phase 13: the audio family, whisper-large-v3 at full width (32 encoder
# layers over 1500 frames, 32 decoder layers with cross-attention), f32: (a)
# served through greedy_decode and a DispatchService at the check's 2 + 2
# layers (phase 17 serves all 32 + 32 in bf16), batch 4, prompt 64, 16 new
# tokens, the frames drawn from seed + 2 as launch.serve draws them; (c) the
# card against the CPU at 2 + 2
# layers, batch 2, prompt 8, 4 new tokens; (d) one train step at full depth
# under remat "full" (batch 2 x 128 decoder tokens and the frames; "none"
# would hold every layer's activations beside 31.3 GB of weights,
# gradients and moments), the first step under each policy at 4 + 4 layers,
# and the card against the CPU at 2 + 2 layers (TRAIN_CHECK's shape and
# steps, phase 12's rule)
AUDIO = dict(arch="whisper-large-v3", batch=4, prompt_len=64, gen=16, seed=0,
             check_layers=2, check_batch=2, check_prompt=8, check_gen=4)
AUDIO_TRAIN = dict(batch=2, seq=128, remat="full", policy_layers=4, check_layers=2)
# phase 14: serving under load. (a) benchmarks/torch_serve_bench.py's main on
# qwen2-0.5b at full width, f32, with the JAX package's full workload (rate
# 12/s, prompts 16/32/48, outputs 4 + geometric mean 24 capped at 48,
# max_batch 8, max_len 1024, 12 candidates) cut from 24 requests to 16 (the
# three modes at 24 took 85-110 s of the phase's 196-198 s on an H100 80GB
# HBM3 at 700 W), and the guard's drift loop; its JSON and obs snapshot
# written to $CHIP_SMOKE_OUT (default build/); (b)
# the rest of the dense catalog at full width through launch.serve.serve,
# batch 4, 16 new tokens, f32, at the depth of the card-against-CPU check
# (phase 17 serves every layer in bf16): (arch, prompt, layers served and
# checked); the check's greedy run at a prompt of 16 (a
# prompt past gemma3's window there would replay 520 steps on the CPU, 30 s),
# and for gemma3, whose served prompt crosses its window of 512, the forward's
# logits at that prompt too; its check at one local:global period (5 local
# layers, 1 global)
LOAD_WORKLOAD = dict(requests=16, rate=12.0, prompt_lens=(16, 32, 48), out_mean=24,
                     out_cap=48, max_batch=8, max_len=1024, seed=1234)
# the flags that set them (prompts and outputs are the bench's non-quick sizes)
LOAD_BENCH_ARGV = ["--inject-drift"] + [
    a for k in ("requests", "rate", "max_batch", "max_len", "seed")
    for a in (f"--{k.replace('_', '-')}", str(LOAD_WORKLOAD[k]))]
CATALOG_ARCHS = (("gemma3-1b", 520, 6), ("minitron-4b", 128, 2), ("qwen1.5-0.5b", 128, 2))
CATALOG_SERVE = dict(batch=4, gen=16, seed=0, check_prompt=16, check_gen=4)
# what may stay allocated on the card after a served (or trained) model is
# dropped (phases 10, 11 and 13), cuBLAS's workspaces freed first (32 MiB
# for each thread and stream that called it: a backward runs on autograd's
# own thread): the weights are 3-37 GB; a leaked view of one layer's output
# projection keeps mixtral's 4 stacked ones, 268 MB
LEFT_BYTES = 64 << 20
# the instantiations the main paths run at their defaults (ptxas template
# arguments): syr2k<PACK_A, PACK_B, RT, VEC16> at 64x64 tiles of M = 1000;
# matmul_tc<input, PACK, VEC16> (mma.sync: f32 in 3xTF32) at 64x64 tiles
# (mm3, lu, the f32 prefill's products), matmul_wgmma<GROUPS, BN> (bf16
# past 8 rows: one warpgroup, N 64) at the bf16 forward's 64x64 tiles, and
# matmul_split<input, TM, LB, PACK> (the split stream: 4 rows, 16-byte
# loads) at the decode's 4-row tiles, f32 and bf16;
# covariance<FUSE_CENTER, RT, VEC16> at 64x64 tiles of M = 1200;
# flash<dtype, hd, CAUSAL> and decode<dtype, hd, VEC16, MASK, WIDE> at the
# model's f32, hd 64; minplus<TM, TN, UNROLL, VEC16> at
# unroll 4 for the default 64x64 trailing tiles (8x4) and the 64x16 panels
# (4x4), and closure_tile<BS> and lu_tile<BS, TPR> at the default bs 64;
# heat3d<FUSE_T, VEC16> at fuse_t 2 on N = 120; phase 2 asserts that they
# spill nothing (the other instantiations' spills are printed)
MAIN_PATH_INSTANCES = {"syr2k": ([1, 1, 4, 1],),
                       "matmul": (["float", 1, 1], [1, 64], ["float", 4, 16, 1],
                                  ["bfloat16", 4, 16, 1]),
                       "covariance": ([1, 4, 1],),
                       "floyd_warshall": ([8, 4, 4, 1], [4, 4, 4, 1], [64]),
                       "heat3d": ([2, 1],),
                       "lu": ([64, 8],),
                       "flash_attention": (["float", 64, 1],),
                       "decode_attention": (["float", 64, 1, 0, 0],)}
# the serving path's matmul shapes (qwen2-0.5b, batch 4, prompt 256): name,
# (M, K, N), launches per decode step (or per prefill forward)
SERVE_MATMULS = (("decode unembed", (4, 896, 151936), "1 per decode step"),
                 ("decode output projection", (4, 896, 896), "24 per decode step"),
                 ("prefill unembed", (1024, 896, 151936), "1 per prefill forward"))
# phase 7: the autotune campaign that publishes to a store and the warm
# start from it (syr2k at LARGE), background campaigns' evaluations, the
# guard's shadow-sampled fraction and the share of those samples that race a
# challenger, and decode steps per watch window
# (24 output projections a step: 36 samples of it a window at epsilon 0.25)
TUNE = dict(offline_evals=12, warm_evals=3, bg_evals=8, epsilon=0.25, challengers=0.1,
            steps_per_window=6)
# phase 15: the fleet and the analyzer. (a) host A's background campaign
# for syr2k at LARGE (phase 7's 8 evaluations), and host B's calls of the
# replicated config; (b) mm3's record that host B serves at first (tiles of
# 16, which the 3xTF32 route pads to 32) and host A's better one (the
# defaults, 64 x 64); (d) the sampled configs per (kernel, target) of
# `launch.analyze space`, the candidates drawn per PolyBench kernel and
# the most that `gpu` accepts launched (warned ones first)
FLEET = dict(bg_evals=8, calls=3, mm3_slow=dict(bm=16, bn=16), audit_samples=128,
             candidates=64, launch_configs=4, seed=1234)
# phase 16: (a) the dry-run's cells (arch, shape, multi-pod): qwen2-0.5b's
# three on 16x16, one of every other family, two of them on 2x16x16, all at
# full width and full depth, at most DRYRUN_PROCS at once; (b) phase 12's
# step on the card's own mesh, 3 steps; the losses against the plain step's;
# (d) the hillclimb's cell (full width, full depth), campaign length and
# worker processes (the probe's rows, the campaign's evaluations in flight)
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", False), ("qwen2-0.5b", "prefill_32k", False),
                ("qwen2-0.5b", "decode_32k", False), ("mixtral-8x7b", "decode_32k", False),
                ("deepseek-v2-236b", "decode_32k", False),
                ("mamba2-780m", "decode_32k", True), ("zamba2-1.2b", "decode_32k", False),
                ("qwen2-vl-7b", "decode_32k", False), ("whisper-large-v3", "decode_32k", False),
                ("gemma3-1b", "prefill_32k", True))
DRYRUN_PROCS = 5  # 10 cells of 24-40 s: two waves on the card machine's 8 cores
DTENSOR_STEPS = 3
DTENSOR_LOSS_RTOL = 1e-6
HILLCLIMB = dict(arch="qwen2-0.5b", shape="train_4k", evals=4, probe_parallel=3,
                 campaign_parallel=2)
# (kernel, evaluations) of phase 5; heat3d's space has 12 points
CAMPAIGNS = (("syr2k", 60), ("mm3", 40), ("lu", 30), ("covariance", 30),
             ("floyd_warshall", 30), ("heat3d", 12))
# phase 8: the kernels audited at the proxy rung's dims beside LARGE
PROXY_AUDIT = ("syr2k", "mm3", "covariance")
# phase 9: each table's campaign (heat3d's space has 12 points) and the
# learner study's campaigns, evaluations each
TABLE_EVALS = dict(default=20, heat3d=12, learners=30)
# phase 17: the catalog in its own dtype, bf16, on the card. (a) the bf16
# matmul (wgmma past 8 rows, mma.sync with pack off, the split stream at 8)
# against its plain version at the served forward products and two ragged
# shapes; (b) each arch served in bf16 through greedy_decode and a
# DispatchService: (arch, layers served (None: all), layers of the
# card-against-CPU check, those of phases 10, 11, 13 and 14, and phase 12's 2
# for qwen2-0.5b); batch 4, prompt 128, 16 new tokens (mixtral's 16 of 32
# layers: 2.90 GB a layer in bf16, about 47 GB with embed and unembed;
# deepseek's 6 of 60, its dense layer 0 and 5 MoE layers: about 7.9 GB a MoE
# layer, 43 GB with embed and unembed; whisper 32 + 32 layers over 1500
# frames from seed + 2); the check's prompt, new tokens (prompt + tokens
# whole SSD chunks) and chunk; the paged round's prompts and rounds
# (qwen2-0.5b); (c) the card against the CPU in bf16 over the check's prompt
# and the card's greedy tokens, teacher-forced: the logits within
# BF16_LOGIT_REL of the CPU's largest |logit| (bf16 rounds at other places in
# cuBLAS and the kernels than on the CPU; about three times the largest
# share measured on an H100 80GB HBM3 at 700 W: dense, moe and vlm
# 0.63-0.67%, ssm 1.75%, over the prompt alone; audio 0.93% (whisper at
# 2 + 2) over prompt and tokens; hybrid about twice zamba2's 4.28% at 7
# layers, as the CPU tests' 8% is: three times would leave the argmax rule
# below, whose margin is this share, fewer positions than it needs), greedy
# tokens equal up to the first step whose CPU top-2 margin is under that
# share, and the argmax equal at every position
# whose CPU top-2 margin clears it, at least ARGMAX_SHARE of the positions;
# for the MoE family a position whose experts the card and the CPU chose
# differently (a routing near-tie in bf16), and the later positions that
# attend to it through a later layer, are named and left out of both
BF16_ARCHS = (("qwen2-0.5b", None, 2), ("qwen2-vl-7b", None, 2), ("mixtral-8x7b", 16, 1),
              ("mamba2-780m", None, 4), ("gemma3-1b", None, 6), ("minitron-4b", None, 2),
              ("qwen1.5-0.5b", None, 2), ("zamba2-1.2b", None, 7),
              ("whisper-large-v3", None, 2), ("deepseek-v2-236b", 6, 2))
BF16_SERVE = dict(batch=4, prompt_len=128, gen=16, seed=0, check_prompt=16, check_gen=8,
                  check_chunk=8, paged_arch="qwen2-0.5b", paged_lens=(16, 24, 32, 40),
                  paged_rounds=8)
BF16_LOGIT_REL = {"dense": 0.02, "moe": 0.02, "vlm": 0.02, "ssm": 0.04, "hybrid": 0.08,
                  "audio": 0.03}
ARGMAX_SHARE = 0.25
BF16_MATMUL_SHAPES = (("qwen2-0.5b forward output projection", (512, 896, 896)),
                      ("mixtral-8x7b forward output projection", (512, 4096, 4096)),
                      ("qwen2-vl-7b forward output projection", (512, 3584, 3584)),
                      ("ragged", (97, 203, 77)), ("ragged", (200, 136, 520)))


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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


def bound(flops: float, nbytes: float, peak: float | None = None) -> tuple[float, str]:
    """(least ms, "operations" or "bytes"): the larger of ``flops`` at
    ``peak`` (PEAK_F32_FLOPS on the CUDA cores, the default;
    PEAK_3XTF32_FLOPS for the matmul's tensor-core path, PEAK_F32_MIN for
    minima) and ``nbytes`` at PEAK_HBM_BYTES."""
    t_ops, t_bytes = flops / (peak or PEAK_F32_FLOPS), nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def queued_ms(fn, calls: int = 10, spin_cycles: int = 20_000_000) -> float | None:
    """Device milliseconds a call of ``fn``: ``calls`` calls enqueued behind
    a spin kernel (about 10 ms), so that they run back to back on the device
    whatever the host's time to enqueue them, between two CUDA events; None
    when the host had not enqueued them all before the spin ended."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    queued = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / calls if queued else None


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


def reset_routes() -> None:
    """Set the matmul's per-route counts to 0 (beside the wrappers' launch
    counts, just before a main path)."""
    from repro_torch.kernels.matmul import reset_route_counts

    reset_route_counts()


def check_routes(what: str, want: dict, launches: dict | None = None,
                 only: tuple | None = None) -> dict:
    """The routes csrc/matmul.cu reported over a main path (counted since
    reset_routes) against the routes its products must take: a decode step's
    rows (at most 8) on the split stream in either dtype, a bf16 forward's on
    wgmma, an f32 forward's on mma.sync (3xTF32). ``only``: where the counts
    per route are not fixed (the serving benchmark's guard replays sampled
    calls), the routes that may appear, each at least once. Adds the split
    and the bf16 tensor-core launches to ``launches`` (the kernels line's
    matmul_split and matmul_bf16 rows)."""
    from repro_torch.kernels.matmul import tiled_matmul

    got = {k: v for k, v in tiled_matmul.route_launches.items() if v}
    if only is not None:
        print(f"  {what}: the matmul's routes {got} (each of {list(only)}, no other)",
              flush=True)
        if set(got) != set(only):
            raise AssertionError(f"{what}: matmul routes {got}, expected {list(only)}")
    else:
        want = {k: v for k, v in want.items() if v}
        print(f"  {what}: the matmul's routes {got} (expected {want})", flush=True)
        if got != want:
            raise AssertionError(f"{what}: matmul routes {got} != {want}")
    if launches is not None:
        launches["matmul_split"] = launches.get("matmul_split", 0) + got.get("split", 0)
    return got


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


def run_cli(argv: list[str]) -> tuple[dict, str]:
    """One `repro_torch.launch.autotune.main` run; echoes the last line before
    its JSON summary and returns (the summary, the lines before it)."""
    from repro_torch.launch import autotune

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = autotune.main(argv)
    text = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"autotune {' '.join(argv)} exited {rc}:\n{text}")
    head, _, body = text.partition("\n{")
    print("  " + head.strip().splitlines()[-1], flush=True)
    return json.loads("{" + body), head


def run_campaign(kernel: str, evals: int, db: str) -> dict:
    """One `repro_torch.launch.autotune.main` campaign; returns its summary."""
    return run_cli(["--kernel", kernel, "--learner", "RF", "--max-evals", str(evals),
                    "--db", db])[0]


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
        decode_attention_column_groups,
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
    # head sizes past 256: column groups of 256 output columns, the scores in
    # chunks of 128 columns, at (8, 2048, hd), ragged and in bf16
    for hd_ in WIDE_HEAD_SIZES:
        q, k, v = attention_inputs(8, 2048, 2048, hd_, dev, seed=100 + hd_)
        for causal, bq, bk in ((True, 64, 64), (False, 64, 64), (True, 128, 32), (True, 32, 128)):
            flash_case(f"hd {hd_} (8, 2048, {hd_})", q, k, v, causal, bq, bk)
        q, k, v = attention_inputs(3, 250, 131, hd_, dev, seed=110 + hd_)
        for causal in (True, False):
            flash_case(f"ragged Sq=250 Sk=131 hd={hd_}", q, k, v, causal, 64, 64)
        q, k, v = (t.to(torch.bfloat16) for t in attention_inputs(4, 600, 571, hd_, dev,
                                                                  seed=120 + hd_))
        for causal in (True, False):
            flash_case(f"bf16 hd {hd_} (4, 600/571, {hd_})", q, k, v, causal, 64, 32,
                       ATTN_BF16_TOL)
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
    # head sizes off the multiples of 16: run at the next one, the cache's
    # loads masked past hd (hd 100 in bf16: rows off 16-byte words, the
    # element-form copies); the model's cache layout read in place at hd 72
    for hd_ in (40, 72, 100):
        q2, _, _ = attention_inputs(BH, 8, 1, hd_, dev, seed=90 + hd_)
        _, k2, v2 = attention_inputs(BH, 1, S, hd_, dev, seed=95 + hd_)
        for ring, window in ((False, 0), (True, 0), (True, 300)):
            decode_case(f"hd {hd_} ({BH}, 8, {S}, {hd_}) per-row positions", q2, k2, v2,
                        mixed, ring, window, 32, 1)
        q2, k2, v2 = (t.to(torch.bfloat16) for t in (q2, k2, v2))
        decode_case(f"hd {hd_} bf16 ({BH}, 8, {S}, {hd_}) per-row positions", q2, k2, v2,
                    mixed, True, 0, 64, 1, ATTN_BF16_TOL)
    # head sizes past 256: column groups of V across blocks, K's scores in
    # chunks of 256, at LARGE's rows and positions, f32 and bf16, and a G that
    # takes two launches (8 heads a launch past 256)
    for hd_ in WIDE_HEAD_SIZES:
        q2, _, _ = attention_inputs(BH, 8, 1, hd_, dev, seed=130 + hd_)
        _, k2, v2 = attention_inputs(BH, 1, S, hd_, dev, seed=140 + hd_)
        for ring, window in ((False, 0), (True, 0), (False, 1000), (True, 300)):
            decode_case(f"hd {hd_} ({BH}, 8, {S}, {hd_}) per-row positions", q2, k2, v2,
                        mixed, ring, window, 32, 1)
        decode_case(f"hd {hd_} ({BH}, 8, {S}, {hd_}) full cache", q2, k2, v2, full, False, 0,
                    128, 2)
        q2, k2, v2 = (t.to(torch.bfloat16) for t in (q2, k2, v2))
        decode_case(f"hd {hd_} bf16 ({BH}, 8, {S}, {hd_}) per-row positions", q2, k2, v2,
                    mixed, True, 0, 64, 1, ATTN_BF16_TOL)
        q2, _, _ = attention_inputs(8, 12, 1, hd_, dev, seed=150 + hd_)
        _, k2, v2 = attention_inputs(8, 1, 288, hd_, dev, seed=160 + hd_)
        n0 = decode_attention.launches
        decode_case(f"hd {hd_} G=12 (8, 12, 288, {hd_}) cur_pos 260", q2, k2, v2,
                    torch.full((8,), 260, dtype=torch.int32, device=dev), True, 0, 32, 1)
        print(f"    {(decode_attention.launches - n0) // 2} launches a call (groups of heads), "
              f"{decode_attention_column_groups(hd_)} column groups a launch", flush=True)
    qc, _, _ = attention_inputs(8, 7, 1, 72, dev, seed=97)
    kc, vc = (torch.randn(4, 300, 2, 72, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(98 + i))
              for i in range(2))
    decode_case("hd 72 model cache (4, 300, 2, 72) read in place", qc, CacheRows(kc),
                CacheRows(vc), torch.tensor([-1, 0, 17, 150, 299, 400, 64, 200],
                                            dtype=torch.int32, device=dev), False, 0, 32, 2)
    del q2, k2, v2, qc, kc, vc
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
    for hd_ in WIDE_HEAD_SIZES:  # column groups of 256: the scores once per group
        show(f"flash_attention hd {hd_} causal", (8, 2048, hd_), ops.DEFAULTS["flash_attention"],
             flash_row(8, 2048, hd_, 200 + hd_), flash_what)
    # device time per launch (torch.profiler): at the model's shape a launch
    # is shorter than the host's wrapper call
    for (BH_, S_, hd_) in ((BH, S, hd), (8, 2048, 256), (8, 256, 64),
                           *((8, 2048, h) for h in WIDE_HEAD_SIZES)):
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
    for hd_ in WIDE_HEAD_SIZES:  # column groups of 256: K read once per group
        show(f"decode_attention hd {hd_}, cur_pos 260", (8, 7, 288, hd_),
             ops.DEFAULTS["decode_attention"], decode_row(8, 7, 288, hd_, 260, 4 + hd_),
             dec_what)
    # where a call's kernel is shorter than the host's wrapper, back-to-back
    # calls time the host: the device time per launch (torch.profiler), at
    # LARGE and at the model's shape, at the default bk and at 128
    from repro_torch.kernels.decode_attention import decode_attention

    for (BH_, G_, S_, hd_, cp_) in ((BH, G, S, hd, S - 1), (8, 7, 288, 64, 260),
                                    *((8, 7, 288, h, 260) for h in WIDE_HEAD_SIZES)):
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


def tree_numel(tree: dict) -> int:
    return sum(tree_numel(v) if isinstance(v, dict) else v.numel() for v in tree.values())


def near_tie_steps(what: str, got: list, want: list, margins: list, floor: float) -> int:
    """The steps of ``got`` checked equal to ``want``: up to the first step
    whose margin (the top two logits' gap where ``want`` was chosen) is
    under ``floor`` (0: every step); raises at a differing step before it."""
    for i, (a, b) in enumerate(zip(got, want)):
        if margins[i] < floor:
            return i
        if a != b:
            raise AssertionError(f"{what}: step {i}, token {a} != {b} at a margin "
                                 f"{margins[i]:.4g} (a near-tie is under {floor:.4g}); {got} "
                                 f"against {want}")
    return len(want)


def paged_round(label: str, cfg, params, svc, g, dev, lens, rounds: int, slots,
                near_tie: float = 0.0) -> tuple[list, list]:
    """A PagedKVCache round: one request a prompt of each length in
    ``lens`` (tokens from ``g``), prefilled once and admitted into
    ``slots`` of 8 (page 128), then ``rounds`` decode rounds on bucketed
    views at per-row positions; each request's tokens must equal its solo
    run (greedy_decode's serve loop on the prefilled dense cache), with a
    ``near_tie`` share (bf16: the paged views' other cache lengths round
    otherwise) up to the first step whose solo top-2 logit margin is under
    that share of the solo runs' largest |logit|. Attaches the cache to
    ``svc``; returns the buckets the rounds used and the steps checked a
    request."""
    import torch

    from repro_torch.serve import PagedKVCache, make_serve_step, prefill

    pc = PagedKVCache(cfg, max_batch=8, max_len=max(lens) + rounds + 1, page_size=128,
                      device=dev)
    svc.attach_kv_cache(pc)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=g, device=dev) for n in lens]
    serve = make_serve_step(cfg, service=svc)
    solo, margins, scale = [], [], 0.0
    for slot, p in zip(slots, prompts):
        logits, cache = prefill(params, {"tokens": p}, cfg, max_len=pc.alloc, service=svc)
        pc.admit(slot, cache, p.shape[1])   # a copy: the solo run goes on in `cache`
        lg, toks, ms = logits[0, -1].float(), [], []
        for t in range(rounds + 1):
            top = torch.topk(lg, 2).values
            ms.append(float(top[0] - top[1]))
            scale = max(scale, float(lg.abs().max()))
            toks.append(int(torch.argmax(lg)))
            if t < rounds:
                _, lgs, cache = serve(params, cache, torch.tensor([[toks[-1]]], device=dev),
                                      p.shape[1] + t)
                lg = lgs[0].float()
        solo.append(toks)
        margins.append(ms)
    out = [[t[0]] for t in solo]
    cur = torch.tensor(out, device=dev)
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
    checked = [near_tie_steps(f"{label} paged round, prompt {n}", got, want, ms,
                              near_tie * scale)
               for n, got, want, ms in zip(lens, out, solo, margins)]
    return sorted(set(buckets)), checked


def matmul_signatures(arch: str, svc, sigs, dev, seed: int, dtype=None,
                      rows: dict | None = None) -> None:
    """The matmul at new signatures, (label, rows, w, launches), in ``dtype``
    (None: f32) at the rows the path gives them (4 in a decode step: the
    split stream; B*P in the forward: the tensor cores, f32 in 3xTF32 on
    mma.sync, bf16 on wgmma), each held against its plain version (the
    pack=True product: for f32 torch.matmul, TF32 being off; for bf16 one
    rounding of the f32 sum) at phase 3's tolerance for the dtype, then
    timed: 10 calls queued behind a spin, between CUDA events (torch.profiler
    can lose the events of such calls; back-to-back calls where the host
    fell behind the spin), beside torch.matmul in the dtype, the plain
    version (bf16: in f32 it is torch.matmul) and the bound (the route's
    peak: the tensor cores' past 8 rows, FFMA's on the split stream). The
    row names the route matmul_launch reported. With ``rows``, each row
    lands in ``rows[(arch, label)]``, its largest error under
    ``max_abs_err``."""
    import torch

    from repro_torch.kernels.matmul import tiled_matmul, tiled_matmul_plain

    bf16 = dtype == torch.bfloat16
    gx = torch.Generator(device=dev).manual_seed(seed)
    for label, M, w, per in sigs:
        K, N = w.shape
        x = torch.randn(M, K, generator=gx, device=dev)
        if bf16:
            x = (x / K ** 0.5).bfloat16()
        fn = svc.dispatch("matmul", x, w)
        before = dict(tiled_matmul.route_launches)
        got = fn(x, w)
        (route,) = [k for k, v in tiled_matmul.route_launches.items() if v != before[k]]
        tc = route in ("wgmma", "mma_sync")
        name = (f"{arch}{' bf16' if bf16 else ''} matmul {label} ({M}, {K}) @ ({K}, {N}) "
                + {"wgmma": "wgmma", "mma_sync": "3xTF32" if not bf16 else "bf16 mma.sync",
                   "split": "split stream", "ffma": "FFMA"}[route])
        plain = lambda: tiled_matmul_plain(x, w, bk=K, pack=True, out_dtype=x.dtype)  # noqa: E731
        err = compare(f"{name}, against its plain version", got, plain(),
                      BF16_TOL if bf16 else F32_TOL)
        k_ms = queued_ms(lambda: fn(x, w)) or time_ms(lambda: fn(x, w), iters=10)
        l_ms = (queued_ms(lambda: torch.matmul(x, w))
                or time_ms(lambda: torch.matmul(x, w), iters=10))
        p_ms = time_ms(plain, iters=5) if bf16 else None
        peak = (PEAK_BF16_FLOPS if bf16 else PEAK_3XTF32_FLOPS) if tc else PEAK_F32_FLOPS
        b_ms, b_by = bound(2.0 * M * K * N, x.element_size() * (M * K + K * N + M * N),
                           peak=peak)
        if rows is not None:
            rows[(arch, label)] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                                       bound_by=b_by, max_abs_err=err)
        print(f"  {name}, {per}: kernel {k_ms:.4f} ms on the device, bound {b_ms:.4f} ms "
              f"({b_by}), " + ("" if p_ms is None else f"plain {p_ms:.4f} ms, ")
              + f"torch.matmul {l_ms:.4f} ms", flush=True)


def serving(launches: dict, dev) -> float:
    """Phase 6: the serving path at full width on ``dev``. Adds the main
    path's launch counts to ``launches``; returns the serve run's ms per
    decode step."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.serve import greedy_decode

    wrappers = (flash_attention, decode_attention, tiled_matmul)
    B, P, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    cfg = dataclasses.replace(get_config(SERVE["arch"]), dtype=torch.float32)
    L, G = cfg.n_layers, cfg.n_heads // cfg.n_kv_heads

    # -- the main path, through the serving entry point
    for w in wrappers:
        w.launches = 0
    reset_routes()
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
    check_routes("serve", {"split": (L + 1) * steps, "mma_sync": L + 1}, launches)
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
    SERVED[SERVE["arch"]] = served_record(
        L, P, gen, B, {"prefill_sec": r["prefill_ms"] / 1e3,
                       "decode_sec": r["decode_ms_per_step"] * gen / 1e3},
        step_ms, step_bound, peak, dev_ms, n_kernels)

    # -- a PagedKVCache round against each request's solo run
    rounds, lens = 16, (64, 128, 200, 256)
    buckets, _ = paged_round(SERVE["arch"], cfg, params, svc, g, dev, lens, rounds,
                             [1, 2, 5, 7])
    print(f"  PagedKVCache: 4 requests (prompts {lens}) in 8 slots, page 128, {rounds} "
          f"rounds (buckets {buckets}): tokens equal each request's solo run; "
          f"{json.dumps(svc.telemetry()['kv_cache'])}", flush=True)

    # -- the card against the CPU, same weights, a short run
    p1 = prompt[:1, :32]
    want_logits, _ = forward(params, {"tokens": p1}, cfg, service=svc)
    want_toks = greedy_decode(params, cfg, p1, steps=8, max_len=40, service=svc)
    cpu = torch.device("cpu")
    params_cpu = tree_to(params, cpu)
    del params, cache
    svc_cpu = DispatchService()
    got_logits, _ = forward(params_cpu, {"tokens": p1.to(cpu)}, cfg, service=svc_cpu)
    got_toks = greedy_decode(params_cpu, cfg, p1.to(cpu), steps=8, max_len=40, service=svc_cpu)
    compare("serve logits, card vs CPU (qwen2-0.5b full width, prompt 32)",
            want_logits.cpu(), got_logits, LOGIT_TOL)
    if not torch.equal(want_toks.cpu(), got_toks):
        raise AssertionError(f"greedy tokens card {want_toks.tolist()} != CPU {got_toks.tolist()}")
    print(f"  greedy tokens (8), card and CPU: {want_toks[0].tolist()} (equal)", flush=True)
    return r["decode_ms_per_step"]


@contextlib.contextmanager
def routing_margins(out: list):
    """Record, for every ``moe_ffn`` call inside, the least gap between the
    k-th and (k+1)-th router probability over its tokens (from
    router_choices's records, when the block ends)."""
    import torch

    calls: list = []
    with router_choices(calls):
        yield
    for probs, idx, _ in calls:
        k = idx.shape[-1]
        top = torch.topk(probs, k + 1, dim=-1).values
        out.append(float((top[:, k - 1] - top[:, k]).min()))


def expert_bytes(params: dict, cfg) -> tuple[int, int]:
    """(bytes of the routed experts' weights, of the top_k of them a token
    routes to) over the stacked MoE layers."""
    moe = params["layers"]["moe"]
    total = sum(moe[w].numel() * moe[w].element_size() for w in ("wg", "wu", "wd"))
    return total, total * cfg.top_k // cfg.n_experts


def moe_arch(arch: str, n_layers: int, launches: dict, dev):
    """Phase 10 for one arch: serve it at full width with ``n_layers``
    layers through greedy_decode and a DispatchService, with the launch
    counts set to 0 just before and read just after (added to
    ``launches``); then per-call launches and times, the decode step's two
    bytes bounds and busy share, the new matmul signatures against their
    plain version, MLA's two schedules (deepseek) and a PagedKVCache round
    (mixtral). Returns (the served config, the prompt generator): the
    model's tensors die with this call's locals."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.serve import greedy_decode, make_serve_step, prefill

    wrappers = (flash_attention, decode_attention, tiled_matmul)
    B, P, gen, seed = (MOE_SERVE[k] for k in ("batch", "prompt_len", "gen", "seed"))
    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype=torch.float32, n_layers=n_layers)
    gqa = cfg.attn_type == "gqa"
    per_step = n_layers + 1 if gqa else 1     # GQA output projections + the unembed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    svc = DispatchService()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)

    # -- the main path: greedy_decode (prefill: forward + the prompt's replay)
    for w in wrappers:
        w.launches = 0
    reset_routes()
    timings: dict = {}
    toks = greedy_decode(params, cfg, prompt, steps=gen, max_len=P + gen, service=svc,
                         timings=timings)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()
    if tuple(toks.shape) != (B, gen) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch}: tokens of shape {tuple(toks.shape)} outside the vocab")
    check_routes(arch, {"split": per_step * (P + gen), "mma_sync": per_step}, launches)
    want = {"flash_attention": 0, "decode_attention": 0,
            "tiled_matmul": per_step * (1 + P + gen)}
    print(f"  {arch} ({n_layers} of {full.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, vocab {cfg.vocab_size}): launches over "
          f"greedy_decode {counts} (expected {want}: {per_step} matmul per forward and per "
          f"decode step, {P + gen} steps; no attention kernel, "
          f"{'a sliding window' if gqa else 'MLA'})")
    if counts != want:
        raise AssertionError(f"{arch}: launch counts {counts} != {want}")
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    if svc.stats["build_failed"] or svc.stats["store_default"] == 0:
        raise AssertionError(f"{arch}: dispatch stats {svc.stats}")
    print(f"  {arch} dispatch stats: {json.dumps(svc.stats)}; first request "
          f"{toks[0].tolist()}", flush=True)

    # -- per call: launches, times, the decode step's bounds and busy share
    fwd = lambda: forward(params, {"tokens": prompt}, cfg, service=svc)  # noqa: E731
    n_fwd = launches_per_call(fwd, wrappers)
    cache = init_cache(cfg, B, P + gen, device=dev)
    tok = prompt[:, -1:]
    step = lambda: decode_step(params, cache, tok, P, cfg, service=svc)  # noqa: E731
    n_step = launches_per_call(step, wrappers)
    one = {"flash_attention": 0, "decode_attention": 0, "tiled_matmul": per_step}
    print(f"  {arch} launches per prefill forward {n_fwd}, per decode step {n_step}")
    if n_fwd != one or n_step != one:
        raise AssertionError(f"{arch}: per-call launch counts differ from {one}")
    fwd_ms, step_ms = host_ms(fwd, iters=3), host_ms(step, iters=10)
    embed = params["embed"].numel() * 4          # the lookup reads B rows
    weights = tree_bytes(params) - embed
    experts, active = expert_bytes(params, cfg)
    # the cache a step must read: P + 1 positions of K and V, or of MLA's latent
    per_pos = 2 * cfg.n_kv_heads * cfg.hd if gqa else cfg.kv_lora_rank + cfg.qk_rope_dim
    kv = n_layers * B * (P + 1) * per_pos * 4
    all_ms = (weights + kv) / PEAK_HBM_BYTES * 1e3
    top_ms = (weights - experts + active + kv) / PEAK_HBM_BYTES * 1e3
    dev_ms, by_name = device_time(step)
    n_kernels = sum(c for c, _ in by_name.values())
    busy = None if dev_ms == 0.0 else dev_ms / step_ms
    top5 = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:5]
    print(f"  {arch} memory: peak {peak / 1e9:.3f} GB allocated over the served run "
          f"(torch.cuda.max_memory_allocated), weights {tree_bytes(params) / 1e9:.3f} GB f32")
    print(f"  {arch} TTFT {timings['prefill_sec'] * 1e3:.2f} ms (forward + the prompt's replay "
          f"through decode_step); forward alone {fwd_ms:.3f} ms host wall")
    print(f"  {arch} decode: {timings['decode_sec'] / gen * 1e3:.4f} ms per step in the run, "
          f"{step_ms:.4f} ms alone; bounds (bytes at 3.35 TB/s): all weights but the embed "
          f"table {all_ms:.4f} ms ({(weights + kv) / 1e9:.3f} GB with {kv / 1e6:.1f} MB of "
          f"cache), only the top-{cfg.top_k} experts {top_ms:.4f} ms "
          f"({(weights - experts + active + kv) / 1e9:.3f} GB)")
    print(f"  {arch} one decode step on the device (torch.profiler): "
          + ("not measured (the profiler recorded no device time)" if busy is None else
             f"{n_kernels} device kernels, {dev_ms:.4f} ms busy of {step_ms:.4f} ms host "
             f"wall ({busy:.1%})") + "; largest: "
          + "; ".join(f"{k[:50]} x{c} {t:.4f} ms" for k, (c, t) in top5), flush=True)
    SERVED[arch] = served_record(n_layers, P, gen, B, timings, step_ms, all_ms, peak, dev_ms,
                                 n_kernels)

    # -- the new matmul signatures, against their plain version and timed
    sigs = [("decode unembed", B, params["unembed"], "1 per decode step"),
            ("forward unembed", B * P, params["unembed"], "1 per forward")]
    if gqa:
        wo = params["layers"]["wo"][0]
        sigs = [("decode output projection", B, wo, f"{n_layers} per decode step"),
                ("forward output projection", B * P, wo, f"{n_layers} per forward")] + sigs
    matmul_signatures(arch, svc, sigs, dev, seed + 2)

    # -- MLA's two schedules on one filled cache
    if not gqa:
        _, filled = prefill(params, {"tokens": prompt}, cfg, max_len=P + gen, service=svc)
        outs = []
        for absorb in (True, False):
            serve = make_serve_step(cfg, mla_absorb=absorb, service=svc)
            c = {k: {n: t.clone() for n, t in v.items()} for k, v in filled.items()}
            outs.append(serve(params, c, tok, P)[1])
        compare(f"{arch} decode logits, absorb=True vs absorb=False on one filled cache "
                f"(the reference's tolerance)", outs[0], outs[1], dict(atol=1e-3, rtol=1e-3))

    # -- a PagedKVCache round against each request's solo run
    if gqa:
        rounds, lens = MOE_SERVE["paged_rounds"], MOE_SERVE["paged_lens"]
        paged_round(arch, cfg, params, svc, g, dev, lens, rounds, [0, 3, 4, 6])
        print(f"  {arch} PagedKVCache: 4 requests (prompts {lens}) in 8 slots, page 128, "
              f"{rounds} rounds of per-row positions through the routed experts: tokens "
              f"equal each request's solo run; "
              f"{json.dumps(svc.telemetry()['kv_cache'])}", flush=True)
    return cfg, g


def card_vs_cpu(arch: str, cfg, check_layers: int, g, dev, margins_of, margin_what: str,
                serve: dict, near_tie: float = 0.0, **fw_kw) -> None:
    """The last check of phases 10, 11, 14 and 17 for one arch: the card
    against the CPU, same weights drawn from ``serve["seed"]`` in
    ``cfg.dtype``, at full width with ``check_layers`` layers (the audio
    family: as many encoder and decoder layers, over frames from ``g``), a
    prompt of ``serve["check_prompt"]`` tokens from ``g`` and
    ``serve["check_gen"]`` new ones (``fw_kw`` to the forward), beside the
    least margin ``margins_of`` records over the card's greedy run (the
    router's, or the top two logits'): forward logits at LOGIT_TOL and
    greedy tokens equal. With a ``near_tie`` share (bf16, which rounds at
    other places in cuBLAS and the kernels than on the CPU) the forward runs
    over the prompt and the card's greedy tokens, teacher-forced: the logits
    within that share of the CPU's largest |logit|, the tokens equal up to
    the first step whose top-2 margin in the CPU's logits is under it, and
    the argmax equal at every position whose CPU margin clears it, at least
    ARGMAX_SHARE of them; a MoE position whose experts the two devices chose
    differently, and the later ones that attend to it through a later
    layer, are named and left out of the logits' and the argmax's checks."""
    import dataclasses

    import torch

    from repro_torch.dispatch import DispatchService
    from repro_torch.models import forward, init_params
    from repro_torch.serve import greedy_decode

    P1, gen1 = serve["check_prompt"], serve["check_gen"]
    audio = cfg.family == "audio"
    ccfg = dataclasses.replace(cfg, n_layers=check_layers,
                               **({"n_encoder_layers": check_layers} if audio else {}))
    cparams = init_params(ccfg, torch.Generator(device=dev).manual_seed(serve["seed"]))
    svc = DispatchService()
    p1 = torch.randint(0, ccfg.vocab_size, (1, P1), generator=g, device=dev)
    frames = ({"enc_embed": torch.randn(1, ccfg.encoder_len, ccfg.d_model, generator=g,
                                        device=dev)} if audio else {})
    margins: list = []
    with margins_of(margins):
        want_toks = greedy_decode(cparams, ccfg, p1, steps=gen1, max_len=P1 + gen1,
                                  service=svc, **frames, **fw_kw)
    seq = torch.cat([p1, want_toks], 1) if near_tie else p1
    card_routes: list = []
    with router_choices(card_routes):
        want_logits, _ = forward(cparams, {"tokens": seq, **frames}, ccfg, service=svc, **fw_kw)
    cpu = torch.device("cpu")
    cparams_cpu = tree_to(cparams, cpu)
    want_logits, want_toks, seq = want_logits.cpu(), want_toks.cpu(), seq.cpu()
    frames = {k: v.cpu() for k, v in frames.items()}
    del cparams, svc
    torch.cuda.empty_cache()
    svc_cpu = DispatchService()
    cpu_routes: list = []
    with router_choices(cpu_routes):
        got_logits, _ = forward(cparams_cpu, {"tokens": seq, **frames}, ccfg, service=svc_cpu,
                                **fw_kw)
    got_toks = greedy_decode(cparams_cpu, ccfg, seq[:, :P1], steps=gen1, max_len=P1 + gen1,
                             service=svc_cpu, **frames, **fw_kw)
    del cparams_cpu
    what = f"{arch}{' bf16' if near_tie else ''}"
    print(f"  {what} card vs CPU at {check_layers} of {cfg.n_layers} layer(s), prompt {P1}"
          + "".join(f", {k} {v}" for k, v in fw_kw.items()) + f": least {margin_what} "
          f"{min(margins):.3e} (the forward and {P1 + gen1} decode steps on the card)")
    if not near_tie:
        compare(f"{arch} logits, card vs CPU (full width, {check_layers} layer(s), prompt {P1})",
                want_logits, got_logits, LOGIT_TOL)
        if not torch.equal(want_toks, got_toks):
            raise AssertionError(f"{arch} greedy tokens card {want_toks.tolist()} != CPU "
                                 f"{got_toks.tolist()}")
        print(f"  {arch} greedy tokens ({gen1}), card and CPU: {want_toks[0].tolist()} (equal)",
              flush=True)
        return
    # the positions a routing near-tie reaches: a token whose top-k experts
    # differ between the card and the CPU, a token whose kept experts differ
    # (a flip moves the later tokens' capacity slots in the experts it
    # leaves and takes), and, below a MoE layer that is not the last, the
    # later positions of its row (the layers after it attend to the token)
    flips = torch.zeros(seq.shape[1], dtype=torch.bool)
    named = torch.zeros_like(flips)
    noise = 0.0
    for i, ((pc, ic, kc), (pp, ip, kp)) in enumerate(zip(card_routes, cpu_routes)):
        noise = max(noise, float((pc - pp).abs().max()))
        flips |= (ic != ip).any(-1)
        moved = (ic != ip).any(-1) | (kc != kp).any(-1)
        named |= moved if i == len(card_routes) - 1 else torch.cummax(moved.int(), 0).values.bool()
    top = torch.topk(got_logits[0].float(), 2, dim=-1).values
    cpu_margins = (top[:, 0] - top[:, 1])                               # (P1 + gen1,)
    scale = float(got_logits.abs().max())
    diff = (want_logits[0].float() - got_logits[0].float()).abs().amax(-1)
    kept = float(diff[~named].max()) if bool((~named).any()) else 0.0
    print(f"  {what} logits over the prompt and the card's {gen1} tokens, teacher-forced: max "
          f"|card - CPU| {float(diff.max()):.4g} = {float(diff.max()) / scale:.3%} of the CPU's "
          f"largest |logit| {scale:.4g}, outside the routing near-ties {kept / scale:.3%} "
          f"(tolerance {near_tie:.0%})"
          + (f"; routing: {int(flips.sum())} of {flips.numel()} positions took other experts "
             f"on the card (named near-ties, with the capacity drops they moved: "
             f"{named.nonzero()[:, 0].tolist()}), router probabilities {noise:.3e} apart at "
             f"most" if card_routes else ""), flush=True)
    if not kept <= near_tie * scale:
        past = ((diff > near_tie * scale) & ~named).nonzero()[:, 0].tolist()
        raise AssertionError(f"{what} logits card vs CPU: {kept:.4g} past {near_tie:.0%} of "
                             f"{scale:.4g} outside the routing near-ties, at positions {past}")
    # a step whose position a routing near-tie reaches counts as a near-tie
    steps = torch.where(named, -1.0, cpu_margins)[P1 - 1:P1 - 1 + gen1].tolist()
    n = near_tie_steps(f"{what} greedy tokens, card vs CPU", want_toks[0].tolist(),
                       got_toks[0].tolist(), steps, near_tie * scale)
    print(f"  {what} greedy tokens ({gen1}), card {want_toks[0].tolist()}, CPU "
          f"{got_toks[0].tolist()}: equal over the first {n} (up to a near-tie under "
          f"{near_tie * scale:.4g}); CPU top-2 margins {[round(m, 4) for m in steps]}",
          flush=True)
    cleared = (cpu_margins > near_tie * scale) & ~named
    agree = want_logits[0].argmax(-1) == got_logits[0].argmax(-1)
    need = math.ceil(ARGMAX_SHARE * seq.shape[1])
    print(f"  {what} teacher-forced argmax, card vs CPU: {int(agree[cleared].sum())} of "
          f"{int(cleared.sum())} positions whose CPU top-2 margin clears "
          f"{near_tie * scale:.4g} agree (at least {need} of {seq.shape[1]} must be compared; "
          f"{int(agree.sum())} of all {seq.shape[1]} agree)", flush=True)
    if int(cleared.sum()) < need or not bool(agree[cleared].all()):
        raise AssertionError(f"{what} teacher-forced argmax card vs CPU: "
                             f"{int(agree[cleared].sum())} of {int(cleared.sum())} compared "
                             f"positions agree, at least {need} needed")


@contextlib.contextmanager
def router_choices(out: list):
    """Record, for every ``moe_ffn`` call inside, on the CPU: its router
    probabilities (T, E), its top-k experts (T, k, sorted) and the experts
    each token keeps after the capacity drops (T, E), worked out as
    ``models/moe.py`` works them out (per group of ``group_size`` tokens, C
    slots an expert in token order); a measurement hook of this script: the
    call itself runs unchanged."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import blocks

    orig = blocks.moe_ffn

    def recording(p, x, *, top_k, capacity_factor=1.25, group_size=2048, **kw):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p["router"], dim=-1)
        idx = torch.topk(probs, top_k, dim=-1).indices
        T, E = probs.shape
        G = min(group_size, T)
        C = max(int(capacity_factor * G * top_k / E), 4)
        mask = F.one_hot(idx, E).sum(1)
        keep = torch.cat([(m.cumsum(0) <= C) & (m > 0) for m in mask.split(G)])
        out.append((probs.cpu(), idx.sort(-1).values.cpu(), keep.cpu()))
        return orig(p, x, top_k=top_k, capacity_factor=capacity_factor, group_size=group_size,
                    **kw)

    blocks.moe_ffn = recording
    try:
        yield
    finally:
        blocks.moe_ffn = orig


def released(arch: str, base: int, after: str) -> None:
    """Check that a served model's tensors (and then the check's) left the
    card: at most LEFT_BYTES more allocated than ``base``, taken before its
    weights were drawn."""
    import gc

    import torch

    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    print(f"  {arch} after {after}: {left / 1e6:.1f} MB more allocated than before its "
          f"weights were drawn (at most {LEFT_BYTES / 1e6:.0f} MB)", flush=True)
    if left > LEFT_BYTES:
        raise AssertionError(f"{arch}: {left} bytes of the served model left on the card")


def moe_phase(launches: dict, dev) -> None:
    """Phase 10: the MoE family on the card, one arch after the other. The
    served model's tensors are gone from the card before the check's
    weights, and the next arch's, are drawn."""
    import torch

    t10 = time.perf_counter()
    for arch, n_layers, check_layers in MOE_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        cfg, g = moe_arch(arch, n_layers, launches, dev)
        released(arch, base, "the served run")
        card_vs_cpu(arch, cfg, check_layers, g, dev, routing_margins,
                    f"gap between the k-th and (k+1)-th router probability (k = {cfg.top_k})",
                    MOE_SERVE)
        released(arch, base, "the card-against-CPU check")
        print(f"  {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  phase 10: {time.perf_counter() - t10:.1f} s", flush=True)


@contextlib.contextmanager
def logit_margins(out: list):
    """Record, for every forward and decode step the serving loop runs
    inside (``repro_torch.serve.step``'s), the least gap between the top two
    logits over its positions and rows (a measurement hook of this script:
    the calls themselves run unchanged)."""
    import torch

    from repro_torch.serve import step

    orig_forward, orig_decode = step.forward, step.decode_step

    def record(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        out.append(float((top[..., 0] - top[..., 1]).min()))

    def forward(*args, **kw):
        logits, aux = orig_forward(*args, **kw)
        record(logits)
        return logits, aux

    def decode_step(*args, **kw):
        logits, cache = orig_decode(*args, **kw)
        record(logits)
        return logits, cache

    step.forward, step.decode_step = forward, decode_step
    try:
        yield
    finally:
        step.forward, step.decode_step = orig_forward, orig_decode


def served_launches(cfg) -> tuple[dict, dict]:
    """The kernel launches one forward and one decode step of ``cfg`` make,
    as the code implies them: the SSM family's unembed alone, and MLA's
    (deepseek: its attention, output projection and experts are plain, as
    in the JAX package); zamba2's shared block at each site (G flash calls a
    forward, one decode launch a step, its output projection) and the
    unembed; a windowed arch (gemma3's local:global schedule, mixtral's
    window) each layer's output projection and the unembed, its attention
    plain as in the JAX package; qwen2-vl's and the other dense archs'
    layers as qwen2-0.5b's."""
    if cfg.family == "ssm" or cfg.attn_type == "mla":
        return ({"flash_attention": 0, "decode_attention": 0, "tiled_matmul": 1},
                {"flash_attention": 0, "decode_attention": 0, "tiled_matmul": 1})
    if cfg.sliding_window or cfg.local_global_ratio:
        one = {"flash_attention": 0, "decode_attention": 0, "tiled_matmul": cfg.n_layers + 1}
        return one, dict(one)
    n = -(-cfg.n_layers // cfg.attn_every) if cfg.family == "hybrid" else cfg.n_layers
    G = cfg.n_heads // cfg.n_kv_heads
    return ({"flash_attention": G * n, "decode_attention": 0, "tiled_matmul": n + 1},
            {"flash_attention": 0, "decode_attention": n, "tiled_matmul": n + 1})


def served_record(layers: int, prompt: int, gen: int, B: int, timings: dict, alone_ms: float,
                  bound_ms: float, peak: int, dev_ms: float, kernels: int) -> dict:
    """A served run's figures, which phase 17 prints beside its bf16 ones:
    TTFT, ms a decode step in the run and alone, the step's bytes bound,
    tok/s over the decode steps, peak GB, the step's busy share (None where
    the profiler recorded no device time) and device kernels."""
    return dict(layers=layers, prompt=prompt, gen=gen, ttft_ms=timings["prefill_sec"] * 1e3,
                step_ms=timings["decode_sec"] / gen * 1e3, alone_ms=alone_ms,
                bound_ms=bound_ms, tok_s=B * gen / timings["decode_sec"], peak_gb=peak / 1e9,
                busy=None if dev_ms == 0.0 else dev_ms / alone_ms, kernels=kernels)


def served_line(fig: dict | None) -> str:
    if fig is None:
        return "none (not served by this run)"
    return (f"{fig['layers']} layers, prompt {fig['prompt']}, {fig['gen']} new tokens: TTFT "
            f"{fig['ttft_ms']:.2f} ms, decode {fig['step_ms']:.4f} ms per step "
            f"({fig['alone_ms']:.4f} ms alone) against {fig['bound_ms']:.4f} ms, "
            f"{fig['tok_s']:.1f} tok/s, peak {fig['peak_gb']:.3f} GB, "
            + ("busy not measured" if fig["busy"] is None else
               f"{fig['kernels']} device kernels a step, {fig['busy']:.1%} busy"))


def serve_arch(arch: str, launches: dict, dev, serve: dict, dtype, n_layers: int | None = None,
               rows: dict | None = None):
    """Phases 11 and 17 for one arch: serve it at full width in ``dtype``
    with ``n_layers`` layers (None: all) through greedy_decode and a
    DispatchService, with the launch counts (and the bf16 tensor-core
    matmul's) set to 0 just before and read just after (added to
    ``launches``); then per-call launches and times, the decode step's bytes
    bound and busy share (bf16: beside the f32 phases' figures), the new
    matmul (``rows``: matmul_signatures's) and attention signatures against
    their plain versions and timed, and for ``serve["paged_arch"]`` a
    PagedKVCache round (bf16: up to a near-tie). Returns (the served config,
    the prompt generator): the model's tensors die with this call's
    locals."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.serve import greedy_decode

    wrappers = (flash_attention, decode_attention, tiled_matmul)
    B, P, gen, seed = (serve[k] for k in ("batch", "prompt_len", "gen", "seed"))
    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype=dtype, n_layers=n_layers or full.n_layers)
    bf16 = dtype == torch.bfloat16
    what = f"{arch}{' bf16' if bf16 else ''}"
    L, fam = cfg.n_layers, cfg.family
    windowed = bool(cfg.sliding_window or cfg.local_global_ratio)
    one_fwd, one_step = served_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    svc = DispatchService()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)

    # -- the main path: greedy_decode (prefill: forward + the prompt's replay)
    for w in wrappers:
        w.launches = 0
    reset_routes()
    timings: dict = {}
    toks = greedy_decode(params, cfg, prompt, steps=gen, max_len=P + gen, service=svc,
                         timings=timings)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    tc = tiled_matmul.bf16_tc_launches
    peak = torch.cuda.max_memory_allocated()
    if tuple(toks.shape) != (B, gen) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{what}: tokens of shape {tuple(toks.shape)} outside the vocab")
    steps = P + gen
    want = {k: one_fwd[k] + one_step[k] * steps for k in one_fwd}
    # the forward's B * P rows take the tensor cores (bf16: wgmma; f32:
    # mma.sync in 3xTF32), a decode step's B rows the split stream
    want_tc = one_fwd["tiled_matmul"] if bf16 else 0
    check_routes(what, {"split": one_step["tiled_matmul"] * steps,
                        "wgmma" if bf16 else "mma_sync": one_fwd["tiled_matmul"]}, launches)
    print(f"  {what} ({fam}, {L} of {full.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}): launches over greedy_decode {counts}, of the matmul's {tc} on "
          f"the bf16 tensor cores (expected {want} and {want_tc}: {one_fwd} per forward, "
          f"{one_step} per decode step, {steps} steps)")
    if counts != want or tc != want_tc:
        raise AssertionError(f"{what}: launch counts {counts}, {tc} != {want}, {want_tc}")
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    launches["matmul_bf16"] = launches.get("matmul_bf16", 0) + tc
    if svc.stats["build_failed"] or svc.stats["store_default"] == 0:
        raise AssertionError(f"{what}: dispatch stats {svc.stats}")
    print(f"  {what} dispatch stats: {json.dumps(svc.stats)}; first request "
          f"{toks[0].tolist()}", flush=True)

    # -- per call: launches, times, the decode step's bound and busy share
    fwd = lambda: forward(params, {"tokens": prompt}, cfg, service=svc)  # noqa: E731
    n_fwd = launches_per_call(fwd, wrappers)
    cache = init_cache(cfg, B, P + gen, device=dev)
    tok = prompt[:, -1:]
    step = lambda: decode_step(params, cache, tok, P, cfg, service=svc)  # noqa: E731
    n_step = launches_per_call(step, wrappers)
    print(f"  {what} launches per prefill forward {n_fwd}, per decode step {n_step}")
    if n_fwd != one_fwd or n_step != one_step:
        raise AssertionError(f"{what}: per-call launch counts differ from {one_fwd} and "
                             f"{one_step}")
    fwd_ms, step_ms = host_ms(fwd, iters=3), host_ms(step, iters=10)
    # the bytes a step must move: every weight but the embed table (the
    # lookup reads B rows; every routed expert of a MoE layer), zamba2's
    # shared block once a site (268 MB at its width: the L2 cannot hold it
    # from one site to the next), the Mamba2 state read and written, the K/V
    # of P + 1 positions read at each attention site (a windowed arch's
    # attention, plain, at every layer; MLA's latent and rotary key at every
    # layer)
    weights = tree_bytes(params) - params["embed"].numel() * params["embed"].element_size()
    sites = one_step["decode_attention"]
    if fam == "hybrid":
        weights += (sites - 1) * tree_bytes(params["shared_attn"])
    state = 2 * tree_bytes(cache["layers"]) if fam in ("ssm", "hybrid") else 0
    mla = cfg.attn_type == "mla"
    kv_sites = L if windowed or mla else sites
    per_pos = cfg.kv_lora_rank + cfg.qk_rope_dim if mla else 2 * cfg.n_kv_heads * cfg.hd
    kv = kv_sites * B * (P + 1) * per_pos * dtype.itemsize
    step_bound = (weights + state + kv) / PEAK_HBM_BYTES * 1e3
    dev_ms, by_name = device_time(step)
    n_kernels = sum(c for c, _ in by_name.values())
    top5 = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:5]
    fig = served_record(L, P, gen, B, timings, step_ms, step_bound, peak, dev_ms, n_kernels)
    print(f"  {what} memory: peak {peak / 1e9:.3f} GB allocated over the served run "
          f"(torch.cuda.max_memory_allocated), weights {tree_bytes(params) / 1e9:.3f} GB "
          f"{'bf16 (the router, norms and biases f32)' if bf16 else 'f32'}"
          + (f", of which the routed experts {expert_bytes(params, cfg)[0] / 1e9:.3f} GB "
             f"(a step's top-{cfg.top_k}: {expert_bytes(params, cfg)[1] / 1e9:.3f} GB)"
             if fam == "moe" else ""))
    print(f"  {what} TTFT {fig['ttft_ms']:.2f} ms (forward + the prompt's replay through "
          f"decode_step); forward alone {fwd_ms:.3f} ms host wall")
    print(f"  {what} decode: {fig['step_ms']:.4f} ms per step in the run, "
          f"{step_ms:.4f} ms alone; bound {step_bound:.4f} ms (bytes at 3.35 TB/s: "
          f"{weights / 1e9:.3f} GB of weights, {state / 1e6:.1f} MB of Mamba2 state read and "
          f"written, {kv / 1e6:.1f} MB of {'latent cache' if mla else 'K/V'} read); "
          f"{fig['tok_s']:.1f} tok/s over the decode steps")
    print(f"  {what} one decode step on the device (torch.profiler): "
          + ("not measured (the profiler recorded no device time)" if dev_ms == 0.0 else
             f"{n_kernels} device kernels, {dev_ms:.4f} ms busy of {step_ms:.4f} ms host "
             f"wall ({dev_ms / step_ms:.1%})") + "; largest: "
          + "; ".join(f"{k[:50]} x{c} {t:.4f} ms" for k, (c, t) in top5), flush=True)
    if bf16:
        print(f"  {what}: {served_line(fig)}; the f32 phase's: {served_line(SERVED.get(arch))}",
              flush=True)
    else:
        SERVED[arch] = fig

    # -- the new matmul signatures, against their plain version and timed
    unembed = params["embed_t"] if cfg.tie_embeddings else params["unembed"]
    sigs = [("decode unembed", B, unembed, "1 per decode step"),
            ("forward unembed", B * P, unembed, "1 per forward")]
    if fam != "ssm" and not mla:
        wo = params["shared_attn"]["wo"] if fam == "hybrid" else params["layers"]["wo"][0]
        sigs = [("decode output projection", B, wo, f"{kv_sites} per decode step"),
                ("forward output projection", B * P, wo, f"{kv_sites} per forward")] + sigs
    matmul_signatures(arch, svc, sigs, dev, seed + 2, dtype, rows)

    # -- the attention signatures, against their plain versions and timed
    # (a windowed arch's attention stays plain, as in the JAX package: gemma3's
    # shapes are held and timed all the same, none launched by the served run)
    if fam != "ssm" and not windowed and not mla:
        attention_signatures(arch, svc, cfg, B, P, gen, sites, dev, seed, dtype)
    if cfg.local_global_ratio:   # flash over the prompt (inside the window: causal), and
        # decode at a position past the window, over a cache of window + P slots
        K, G, w = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.sliding_window
        attention_shapes(what, svc, dev, seed + 5, dtype,
                         (B * K, P, P, cfg.hd, True, f"{G} calls a layer where the forward took "
                                                     f"the kernel (0: plain)"),
                         (B, K, G, w + P, cfg.hd, w + P // 2, w,
                          "a local layer's step (0 a step: plain)"))

    # -- a PagedKVCache round against each request's solo run, on
    # per-row positions (qwen2-vl: through M-RoPE's three sections)
    if arch == serve["paged_arch"]:
        rounds, lens = serve["paged_rounds"], serve["paged_lens"]
        near_tie = BF16_LOGIT_REL[fam] if bf16 else 0.0
        buckets, checked = paged_round(what, cfg, params, svc, g, dev, lens, rounds,
                                       [1, 2, 5, 7], near_tie)
        print(f"  {what} PagedKVCache: 4 requests (prompts {lens}) in 8 slots, page 128, "
              f"{rounds} rounds of per-row positions (buckets {buckets}): tokens equal each "
              f"request's solo run over {checked} of {rounds + 1} steps"
              + (f" (up to a near-tie under {near_tie:.0%} of the largest |logit|)"
                 if near_tie else "") + f"; {json.dumps(svc.telemetry()['kv_cache'])}",
              flush=True)
    return cfg, g


def attention_signatures(arch: str, svc, cfg, B: int, P: int, gen: int, sites: int, dev,
                         seed: int, dtype=None) -> None:
    """The attention kernels at an arch's served signatures in ``dtype``
    (None: f32; bf16 in, f32 math, bf16 out), through attention_shapes:
    flash at the prompt (one of G calls a layer or site), decode against
    the model's (B, P + gen, K, hd) cache at position P; ``sites`` is the
    attention sites a forward or step."""
    import torch

    dt = dtype or torch.float32
    K, hd, G = cfg.n_kv_heads, cfg.hd, cfg.n_heads // cfg.n_kv_heads
    attention_shapes(f"{arch}{' bf16' if dt == torch.bfloat16 else ''}", svc, dev, seed + 3, dt,
                     (B * K, P, P, hd, True, f"{G * sites} calls a forward"),
                     (B, K, G, P + gen, hd, P, 0, f"{sites} a decode step"))


def attention_shapes(what: str, svc, dev, seed: int, dtype, flash: tuple,
                     decode: tuple) -> None:
    """The attention kernels at one flash and one decode shape in ``dtype``
    (a served signature, or one whose served run keeps its attention plain,
    as the JAX package does), each held against its plain version at phase
    3's tolerance, then queued and timed beside scaled_dot_product_attention
    in the dtype (a yardstick the port never calls) and the bound: ``flash``
    = (BH, Sq, Sk, hd, causal, note), ``decode`` = (B, K, G, S, hd, position,
    window, note) against a (B, S, K, hd) cache read in place."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import CacheRows, decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain

    name, tol = ("bf16", ATTN_BF16_TOL) if dtype == torch.bfloat16 else ("f32", ATTN_TOL)
    size = dtype.itemsize
    BH, Sq, Sk, hd, causal, note = flash
    gq = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(BH, Sq, hd, generator=gq, device=dev).to(dtype)
    k, v = (torch.randn(BH, Sk, hd, generator=gq, device=dev).to(dtype) for _ in range(2))
    fn = svc.dispatch("flash_attention", q, k, v, causal=causal)
    label = f"{what} flash_attention ({BH}, {Sq}, {hd}) over {Sk} keys{' causal' if causal else ''}"
    compare(f"{label}, against its plain version", fn(q, k, v),
            flash_attention_plain(q, k, v, causal=causal), tol)
    k_ms = queued_ms(lambda: fn(q, k, v))
    l_ms = queued_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
    pairs = Sq * Sk * (0.5 if causal else 1.0)
    b_ms, b_by = bound(4.0 * BH * pairs * hd, size * BH * (2 * Sq + 2 * Sk) * hd)
    print(f"  {label}, {note}: kernel " + ("not measured" if k_ms is None else f"{k_ms:.4f} ms")
          + f" queued on the device, bound {b_ms:.4f} ms ({b_by}), SDPA {name} "
          + ("not measured" if l_ms is None else f"{l_ms:.4f} ms"), flush=True)
    B, K, G, S, hd, pos, window, note = decode
    qd = torch.randn(B * K, G, hd, generator=gq, device=dev).to(dtype)
    kc, vc = (torch.randn(B, S, K, hd, generator=gq, device=dev).to(dtype) for _ in range(2))
    cp = torch.full((B * K,), pos, dtype=torch.int32, device=dev)
    kr, vr = CacheRows(kc), CacheRows(vc)
    fn = svc.dispatch("decode_attention", qd, kr, vr, cp, ring=False, window=window)
    label = (f"{what} decode_attention ({B * K}, {G}, {S}, {hd}) at position {pos}"
             + (f", window {window}" if window else ""))
    compare(f"{label}, the cache read in place, against its plain version", fn(qd, kr, vr, cp),
            decode_attention_plain(qd, kr, vr, cp, window=window), tol)
    krow, vrow = kr.rows().contiguous(), vr.rows().contiguous()
    kpos = torch.arange(S, device=dev)[None, None, :]
    mask = (kpos <= cp[:, None, None]) & ((cp[:, None, None] - kpos < window) if window else True)
    k_ms = queued_ms(lambda: fn(qd, kr, vr, cp))
    l_ms = queued_ms(lambda: F.scaled_dot_product_attention(qd, krow, vrow, attn_mask=mask))
    slots = B * K * min(pos + 1, window or pos + 1)
    b_ms, b_by = bound(4.0 * G * hd * slots, size * (2 * slots * hd + 2 * B * K * G * hd))
    print(f"  {label}, {note}: kernel " + ("not measured" if k_ms is None else f"{k_ms:.4f} ms")
          + f" queued on the device, bound {b_ms:.4f} ms ({b_by}), SDPA {name} on the rows "
          + ("not measured" if l_ms is None else f"{l_ms:.4f} ms"), flush=True)


def ssm_phase(launches: dict, dev) -> None:
    """Phase 11: the SSM, hybrid and VLM families on the card, one arch after
    the other. The served model's tensors are gone from the card before the
    check's weights, and the next arch's, are drawn."""
    import torch

    t11 = time.perf_counter()
    for arch, n_layers, check_layers in SSM_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        cfg, g = serve_arch(arch, launches, dev, SSM_SERVE, torch.float32, n_layers)
        released(arch, base, "the served run")
        card_vs_cpu(arch, cfg, check_layers, g, dev, logit_margins,
                    "gap between the top two logits", SSM_SERVE,
                    ssm_chunk=SSM_SERVE["check_chunk"])
        released(arch, base, "the card-against-CPU check")
        print(f"  {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  phase 11: {time.perf_counter() - t11:.1f} s", flush=True)


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """A training step's FLOPs: 6 per parameter and token, plus attention's
    score and value products over the whole S x S square (the chunked path
    masks the causal half, it does not skip it), the backward twice the
    forward."""
    attn = 3 * 4 * batch * cfg.n_heads * seq * seq * cfg.hd * cfg.n_layers
    return 6.0 * n_params * batch * seq + attn


def audio_frames(cfg, batch: int, seed: int):
    """Frame embeddings (batch, encoder_len, d_model), standard normal,
    drawn on the CPU from ``seed`` (so that the card and the CPU get the
    same)."""
    import torch

    return torch.randn(batch, cfg.encoder_len, cfg.d_model,
                       generator=torch.Generator().manual_seed(seed))


def train_run(cfg, params: dict, batch: int, seq: int, steps: int, seed: int,
              snapshot: bool = False, **step_kw):
    """``steps`` train steps of ``cfg`` from ``params`` (on their device) on
    SyntheticLM batches drawn from ``seed`` (the audio family's with frames
    from ``audio_frames``): (params, opt state, [(loss, aux, grad norm) a
    step], with ``snapshot`` (params, first moment) after step 1 on the
    host, else None)."""
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    dev = tree_leaves(params)[0].device
    opt = init_train_state(params)
    step = make_train_step(cfg, **step_kw)
    stream = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    out, first = [], None
    for s in range(steps):
        b = make_batch(stream, s, dev)
        if cfg.family == "audio":
            b["enc_embed"] = audio_frames(cfg, batch, seed + 1 + s).to(dev)
        params, opt, m = step(params, opt, b)
        out.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
        if s == 0 and snapshot:
            first = tree_map(lambda t: t.detach().to("cpu", copy=True),
                             {"params": params, "m": opt["m"]})
    return params, opt, out, first


def train_main(dev) -> None:
    """Phase 12 (a) and (b): qwen2-0.5b at full width and full depth through
    ``launch.train.run``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.cost import hopper
    from repro_torch.launch import train as train_cli

    a = TRAIN
    cfg = dataclasses.replace(get_config(a["arch"]), dtype=torch.float32)
    t0 = time.perf_counter()
    r = train_cli.run(a["arch"], batch=a["batch"], seq=a["seq"], steps=a["steps"],
                      seed=a["seed"], lr=a["lr"], device=dev, fixed_batch=True, log_every=1)
    losses, gnorms = r["losses"], r["grad_norms"]
    if not (all(map(math.isfinite, losses)) and all(map(math.isfinite, gnorms))):
        raise AssertionError(f"training: non-finite losses {losses} or grad norms {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training: the last loss {losses[-1]} is not below the first "
                             f"{losses[0]} on a repeated batch")
    flops = train_flops(cfg, r["params"], a["batch"], a["seq"])
    peak_flops = hopper().ffma_flops
    ms = r["ms_per_step"]
    print(f"  (a) {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{r['params'] / 1e6:.1f}M parameters, batch {a['batch']} x {a['seq']}, "
          f"{a['steps']} steps on one batch, lr {a['lr']}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}", flush=True)
    print(f"  (a) ms a step: median {ms:.2f} (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in r['step_sec'])}), "
          f"{r['tokens_per_sec']:,.0f} tokens/s; {flops / 1e12:.3f} TFLOP a step (6 x "
          f"params x tokens + attention), {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
          f"{flops / (ms * 1e-3) / peak_flops:.1%} of the f32 peak "
          f"({peak_flops / 1e12:.0f} TFLOP/s, kernels/cost.py:hopper()); peak allocated "
          f"{r['peak_bytes'] / 1e9:.3f} GB; stragglers {r['stragglers']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    peaks = {"none": r["peak_bytes"]}
    for remat in ("full", "dots"):
        rr = train_cli.run(a["arch"], batch=a["batch"], seq=a["seq"], steps=2, seed=a["seed"],
                           lr=a["lr"], device=dev, fixed_batch=True, remat=remat)
        peaks[remat] = rr["peak_bytes"]
        rel = abs(rr["losses"][0] - losses[0]) / abs(losses[0])
        print(f"  (b) remat {remat!r}: first loss {rr['losses'][0]:.6f} against "
              f"{losses[0]:.6f} (relative {rel:.2e}, at most {REMAT_RTOL:g}); the second "
              f"step {rr['step_sec'][1] * 1e3:.2f} ms against {ms:.2f}", flush=True)
        if rel > REMAT_RTOL:
            raise AssertionError(f"remat {remat!r} changed the first loss: {rr['losses'][0]} "
                                 f"against {losses[0]}")
    print("  (b) peak allocated over a step: " + ", ".join(
        f"remat {k!r} {v / 1e9:.3f} GB" for k, v in peaks.items()), flush=True)
    train_profile(cfg, dev)


def train_profile(cfg, dev) -> None:
    """Phase 12 (a), where a step's time goes: one step of (a)'s shape under
    torch.profiler (after an unprofiled one), its device time by kernel
    class (cuBLAS products; the rest: softmax, norms, AdamW's elementwise
    passes, copies) and the busy share of its wall time."""
    import gc

    import torch

    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.models import init_params, trainable
    from repro_torch.train import init_train_state, make_train_step

    a = TRAIN
    params = trainable(init_params(cfg, torch.Generator(device=dev).manual_seed(a["seed"])))
    opt = init_train_state(params)
    step = make_train_step(cfg, lr=a["lr"])
    batch = make_batch(SyntheticLM(cfg.vocab_size, a["seq"], a["batch"], seed=a["seed"]), 0, dev)
    step(params, opt, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, opt, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, by_name = device_time(lambda: step(params, opt, batch))
    products = {k: v for k, v in by_name.items() if re.search(r"gemm|cutlass|xmma", k, re.I)}
    gemm_ms = sum(ms for _, ms in products.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"  (a) one step under torch.profiler: {busy:.2f} ms on the device of {wall:.2f} ms "
          f"wall ({busy / wall:.1%} busy), {sum(n for n, _ in by_name.values()):,} device "
          f"kernels; cuBLAS products {gemm_ms:.2f} ms ({gemm_ms / busy:.1%}) in "
          f"{sum(n for n, _ in products.values())} calls; the rest {busy - gemm_ms:.2f} ms; "
          "top: " + "; ".join(f"{k[:60]} x{n} {ms:.2f} ms" for k, (n, ms) in top), flush=True)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()


def train_vs_cpu(dev, cfg, label: str) -> dict:
    """Phase 12 (c) (and 13 (d)): the same weights of ``cfg`` (drawn on the
    CPU) and batches on the card and on the CPU, full width, depth cut;
    returns the card's train state after the steps."""
    import torch

    from repro_torch.models import init_params, trainable
    from repro_torch.tree import tree_leaves, tree_map

    c, tol = TRAIN_CHECK, TRAIN_TOL
    t0 = time.perf_counter()
    base = trainable(init_params(cfg, torch.Generator().manual_seed(TRAIN["seed"])))
    runs = {}
    for name, device in (("cpu", torch.device("cpu")), ("card", dev)):
        params = tree_map(lambda t: t.to(device, copy=True), base)
        runs[name] = train_run(cfg, params, c["batch"], c["seq"], c["steps"], TRAIN["seed"],
                               snapshot=True, lr=TRAIN["lr"])
    (p_card, opt_card, out_card, first_card), (_, _, out_cpu, first_cpu) = \
        runs["card"], runs["cpu"]
    for s, ((l1, _, g1), (l0, _, g0)) in enumerate(zip(out_card, out_cpu)):
        dl, dg = abs(l1 - l0) / abs(l0), abs(g1 - g0) / abs(g0)
        print(f"  {label} step {s}: loss card {l1:.6f} cpu {l0:.6f} (relative {dl:.2e}, at most "
              f"{tol['loss_rtol']:g}); grad norm card {g1:.5f} cpu {g0:.5f} (relative "
              f"{dg:.2e}, at most {tol['gnorm_rtol']:g})", flush=True)
        if dl > tol["loss_rtol"] or dg > tol["gnorm_rtol"] or not math.isfinite(l1 + g1):
            raise AssertionError(f"{cfg.name} training, card vs CPU, step {s}: loss {l1} / {l0}, "
                                 f"grad norm {g1} / {g0}")
    n = past = sensitive = unexplained = 0
    worst = g_past = 0.0
    for p1, p0, m1, m0 in zip(tree_leaves(first_card["params"]), tree_leaves(first_cpu["params"]),
                              tree_leaves(first_card["m"]), tree_leaves(first_cpu["m"])):
        diff = (p1 - p0).abs()
        off = diff > tol["param"]["atol"] + tol["param"]["rtol"] * p0.abs()
        g = m0.abs() / 0.1  # the first moment after step 1 is (1 - b1) g, b1 = 0.9
        noisy = ((m1 - m0).abs() > tol["grad_rtol"] * m0.abs()) | (g < tol["grad_floor"])
        n += p0.numel()
        past += int(off.sum())
        sensitive += int(noisy.sum())
        unexplained += int((off & ~noisy).sum())
        if bool(off.any()):
            g_past = max(g_past, float(g[off].max()))
        if bool((~noisy).any()):
            worst = max(worst, float(diff[~noisy].max()))
    print(f"  {label} parameters after step 1: {n:,} elements, {past:,} past 1e-6 + 1e-5*|cpu| "
          f"(Adam's sign-like first step; their largest gradient {g_past:.3e}); each must be "
          f"among the {sensitive:,} whose gradient is below {tol['grad_floor']:g} or differs "
          f"between card and CPU by more than {tol['grad_rtol']:.0%}"
          f"{'' if unexplained == 0 else f' ({unexplained} are not)'}; largest difference "
          f"elsewhere {worst:.3e}; {time.perf_counter() - t0:.1f} s", flush=True)
    if unexplained:
        raise AssertionError(f"{cfg.name} training, card vs CPU: {unexplained} parameters "
                             f"off after step 1 with the gradient agreeing")
    return {"params": p_card, "opt": opt_card}


def train_one_step(dev) -> None:
    """Phase 12 (d): one step each of mamba2-780m (full depth: the SSD
    backward) and mixtral-8x7b (depth cut: the GShard dispatch's backward
    and the routers' aux loss) from weights drawn on the card."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, trainable
    from repro_torch.tree import tree_leaves

    sh = TRAIN_ONE_STEP_SHAPE
    for arch, layers in TRAIN_ONE_STEP:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = trainable(init_params(cfg, torch.Generator(device=dev).manual_seed(0)))
        n = sum(t.numel() for t in tree_leaves(params))
        _, _, out, _ = train_run(cfg, params, sh["batch"], sh["seq"], 1, 0, lr=TRAIN["lr"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        loss, aux, gnorm = out[0]
        print(f"  (d) {arch}, {cfg.n_layers} layer(s) of {get_config(arch).n_layers}, "
              f"{n / 1e6:.1f}M parameters, batch {sh['batch']} x {sh['seq']}: loss {loss:.4f}, "
              f"aux {aux:.4f}, grad norm {gnorm:.4f}; peak allocated {peak / 1e9:.3f} GB; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not all(map(math.isfinite, (loss, aux, gnorm))) or (cfg.family == "moe") != (aux > 0):
            raise AssertionError(f"{arch}: a train step gave loss {loss}, aux {aux}, "
                                 f"grad norm {gnorm}")
        del params, out
        gc.collect()
        torch.cuda.empty_cache()


def train_checkpoints(state: dict) -> None:
    """Phase 12 (e): an AsyncCheckpointer save of ``state`` (on the card)
    restored bit for bit, then the CLI's resume on the card at --reduced."""
    import torch

    from repro_torch.ckpt import AsyncCheckpointer, restore
    from repro_torch.launch import train as train_cli
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(state)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        ck = AsyncCheckpointer(tmp)
        t0 = time.perf_counter()
        ck.save(state, step=TRAIN_CHECK["steps"])
        t_snap = time.perf_counter() - t0
        ck.close()
        t_save = time.perf_counter() - t0
        shard = os.path.join(tmp, f"step_{TRAIN_CHECK['steps']:08d}", "shard_0.msgpack.zst")
        size = os.path.getsize(shard)
        with open(shard, "rb") as f:
            flag = f.read(1)
        t0 = time.perf_counter()
        got, step = restore(tmp, state)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
            for a, b in zip(tree_leaves(got), leaves))
        print(f"  (e) AsyncCheckpointer: {len(leaves)} leaves, {nbytes / 1e9:.3f} GB on the "
              f"card; snapshot to the host {t_snap:.2f} s (the caller's thread), written "
              f"{t_save:.2f} s after the call ({size / 1e9:.3f} GB shard, flag {flag!r}); "
              f"restore to the card {t_restore:.2f} s; every leaf bit for bit: {same}",
              flush=True)
        if step != TRAIN_CHECK["steps"] or not same:
            raise AssertionError("the restored train state differs from the saved one")
        del got
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        argv = ["--reduced", "--batch", "4", "--seq", "32", "--ckpt-dir", tmp]
        texts = []
        for extra in (["--steps", "4", "--ckpt-every", "2"], ["--steps", "6"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train_cli.main(argv + extra)
            texts.append(buf.getvalue())
            if rc != 0:
                raise AssertionError(f"launch.train {' '.join(argv + extra)} exited {rc}")
        if "device=cuda" not in texts[0] or "resumed from step 4" not in texts[1] \
                or "resumed" in texts[0]:
            raise AssertionError("launch.train did not resume from step 4 on the card:\n"
                                 + "\n".join(texts))
        print("  (e) python -m repro_torch.launch.train --reduced (no --device: the card) "
              "--steps 4 --ckpt-every 2, then --steps 6: "
              + texts[1].strip().splitlines()[1], flush=True)


def training_phase(launches: dict, dev) -> None:
    """Phase 12: training on the card (no dispatch service: no hand-written
    kernel runs; the counts, set to 0 before, must stay 0)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.covariance import covariance
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.floyd_warshall import closure_in_block, minplus_update
    from repro_torch.kernels.heat3d import heat3d
    from repro_torch.kernels.lu import lu_factor_diag
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.kernels.syr2k import syr2k

    wrappers = (syr2k, tiled_matmul, covariance, minplus_update, heat3d, lu_factor_diag,
                closure_in_block, flash_attention, decode_attention)
    t12 = time.perf_counter()
    for w in wrappers:
        w.launches = 0
    train_main(dev)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), dtype=torch.float32,
                              n_layers=TRAIN_CHECK["layers"])
    state = train_vs_cpu(dev, cfg, "(c)")
    train_one_step(dev)
    train_checkpoints(state)
    del state
    counts = {w.__name__: w.launches for w in wrappers}
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    print(f"  launches over phase 12: {counts} (training passes no dispatch service)",
          flush=True)
    if any(counts.values()):
        raise AssertionError(f"training launched a hand-written kernel: {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 12: {time.perf_counter() - t12:.1f} s", flush=True)


def layer_of(stack: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views) out of a stacked tree."""
    return {k: layer_of(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


def audio_serve(launches: dict, dev, serve: dict, dtype, n_layers: int | None = None,
                rows: dict | None = None):
    """Phases 13 (a) and (b) and 17: whisper-large-v3 at full width in
    ``dtype`` with ``n_layers`` encoder and decoder layers (None: all)
    through greedy_decode and a DispatchService, with the launch counts (and
    the bf16 tensor-core matmul's) set to 0 just before and read just after
    (added to ``launches``); then the cross cache a prefill leaves against
    the encoder's output recomputed, per-call launches and times, the decode
    step's bytes bound and busy share (bf16: beside the f32 phase's
    figures), the unembed's two signatures against their plain version and
    timed (``rows``: matmul_signatures's), and in bf16 the cross-attention's
    shapes. Returns (the served config, the prompt generator): the model's
    tensors die with this call's locals."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.models import blocks, decode_step, forward, init_params
    from repro_torch.serve import greedy_decode, prefill

    wrappers = (flash_attention, decode_attention, tiled_matmul)
    B, P, gen, seed = (serve[k] for k in ("batch", "prompt_len", "gen", "seed"))
    full = get_config(AUDIO["arch"])
    cfg = dataclasses.replace(full, dtype=dtype, n_layers=n_layers or full.n_layers,
                              n_encoder_layers=n_layers or full.n_encoder_layers)
    bf16 = dtype == torch.bfloat16
    what = f"{cfg.name}{' bf16' if bf16 else ''}"
    L, Le, Se, K, hd = cfg.n_layers, cfg.n_encoder_layers, cfg.encoder_len, cfg.n_kv_heads, cfg.hd
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    svc = DispatchService()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev, generator=g)
    # f32 frames, cast to the config's dtype by the model (the JAX package's
    # enc_embed.astype(cfg.dtype))
    frames = torch.randn(B, Se, cfg.d_model, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed + 2))

    # -- the main path: greedy_decode (prefill: forward + the prompt's replay)
    for w in wrappers:
        w.launches = 0
    reset_routes()
    timings: dict = {}
    toks = greedy_decode(params, cfg, prompt, steps=gen, max_len=P + gen, service=svc,
                         timings=timings, enc_embed=frames)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    tc = tiled_matmul.bf16_tc_launches
    peak = torch.cuda.max_memory_allocated()
    if tuple(toks.shape) != (B, gen) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{what}: tokens of shape {tuple(toks.shape)} outside the vocab")
    steps = P + gen
    # the unembed: the forward's B * P rows on mma.sync in either dtype
    # (N = 51,866 is not a multiple of 8, which TMA needs: csrc/matmul.cu
    # hands bf16 to mma.sync), each step's B rows on the split stream
    # (N % 4 = 2: 8-byte loads in f32, 4-byte in bf16)
    check_routes(what, {"split": steps, "mma_sync": 1}, launches)
    want = {"flash_attention": 0, "decode_attention": 0, "tiled_matmul": 1 + steps}
    print(f"  (a) {what} ({Le} encoder layers over {Se} frames, {L} decoder layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab_size}), batch {B}, prompt {P}, {gen} tokens: "
          f"launches over greedy_decode {counts}, of the matmul's {tc} on the bf16 tensor cores "
          f"(expected {want} and {1 if bf16 else 0}: the unembed once a forward and once a "
          f"decode step, {steps} steps; the encoder and decoder layers pass no service, as in "
          f"the JAX package)")
    if counts != want or tc != (1 if bf16 else 0):
        raise AssertionError(f"{what}: launch counts {counts}, {tc} != {want}")
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    launches["matmul_bf16"] = launches.get("matmul_bf16", 0) + tc
    if svc.stats["build_failed"] or svc.stats["store_default"] == 0:
        raise AssertionError(f"{what}: dispatch stats {svc.stats}")
    print(f"  (a) dispatch stats: {json.dumps(svc.stats)}; first request {toks[0].tolist()}",
          flush=True)

    # -- the cross cache a prefill leaves, against the encoder's output
    # recomputed here layer by layer
    batch = {"tokens": prompt, "enc_embed": frames}
    _, cache = prefill(params, batch, cfg, max_len=P + gen, service=svc)
    cross = cache["cross"]
    empty = [i for i in range(L) if not (bool(cross["k"][i].any()) and bool(cross["v"][i].any()))]
    if empty:
        raise AssertionError(f"{cfg.name}: the prefill left the cross K/V of decoder layers "
                             f"{empty} zero")
    enc = frames.to(dtype)
    enc_pos = torch.arange(Se, device=dev)[None, :].expand(B, Se)
    for i in range(Le):
        enc, _ = blocks.attn_layer_train(layer_of(params["enc_layers"], i), enc, cfg=cfg,
                                         positions=enc_pos, window=None, causal=False)
    last = layer_of(params["dec_layers"], L - 1)
    for name, w in (("k", last["xk"]), ("v", last["xv"])):
        compare(f"{what} cross {name.upper()} of decoder layer {L - 1} after prefill "
                f"(max |.| {float(cross[name][L - 1].abs().max()):.3f}), against the encoder's "
                f"output recomputed @ x{name}", cross[name][L - 1],
                (enc.to(dtype) @ w).reshape(B, Se, K, hd), BF16_TOL if bf16 else F32_TOL)
    del enc

    # -- per call: launches, times, the decode step's bound and busy share
    fwd = lambda: forward(params, batch, cfg, service=svc)  # noqa: E731
    n_fwd = launches_per_call(fwd, wrappers)
    tok = prompt[:, -1:]
    step = lambda: decode_step(params, cache, tok, P, cfg, service=svc)  # noqa: E731
    n_step = launches_per_call(step, wrappers)
    one = {"flash_attention": 0, "decode_attention": 0, "tiled_matmul": 1}
    print(f"  (a) launches per prefill forward {n_fwd}, per decode step {n_step}")
    if n_fwd != one or n_step != one:
        raise AssertionError(f"{what}: per-call launch counts differ from {one}")
    fwd_ms, step_ms = host_ms(fwd, iters=3), host_ms(step, iters=10)
    # the bytes a step must move: the decoder's weights but xk and xv (the
    # cross K/V are cached), the unembed embed_t (the lookup reads B rows of
    # embed), the cross K/V and the self K/V of P + 1 positions read
    dec = params["dec_layers"]
    weights = (tree_bytes(dec) - tree_bytes({"xk": dec["xk"], "xv": dec["xv"]})
               + tree_bytes({"e": params["embed_t"], "n": params["final_norm"]}))
    size = dtype.itemsize
    cross_b = 2 * L * B * Se * K * hd * size
    kv = 2 * L * B * (P + 1) * K * hd * size
    step_bound = (weights + cross_b + kv) / PEAK_HBM_BYTES * 1e3
    dev_ms, by_name = device_time(step)
    n_kernels = sum(c for c, _ in by_name.values())
    top5 = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:5]
    leaves = tree_numel(params) - params["embed_t"].numel()
    fig = served_record(L, P, gen, B, timings, step_ms, step_bound, peak, dev_ms, n_kernels)
    print(f"  (a) memory: peak {peak / 1e9:.3f} GB allocated over the served run "
          f"(torch.cuda.max_memory_allocated); weights {tree_bytes(params) / 1e9:.3f} GB "
          f"{'bf16 (norms f32)' if bf16 else 'f32'} (tree_bytes), of which the contiguous "
          f"unembed embed_t {params['embed_t'].numel() * size / 1e9:.3f} GB; the leaves but "
          f"embed_t hold {leaves:,} values, param_count() gives {cfg.param_count():,} (it "
          f"leaves out the decoder's cross-attention: {leaves - cfg.param_count():,}); cross K/V "
          f"cache {cross_b / 1e9:.3f} GB")
    print(f"  (a) TTFT {timings['prefill_sec'] * 1e3:.2f} ms (forward, the cross K/V written "
          f"by it, + the prompt's replay through decode_step); forward alone {fwd_ms:.3f} ms "
          f"host wall")
    print(f"  (a) decode: {timings['decode_sec'] / gen * 1e3:.4f} ms per step in the run, "
          f"{step_ms:.4f} ms alone; bound {step_bound:.4f} ms (bytes at 3.35 TB/s: "
          f"{weights / 1e9:.3f} GB of weights, {cross_b / 1e9:.3f} GB of cross K/V and "
          f"{kv / 1e6:.1f} MB of self K/V read); {B * gen / timings['decode_sec']:.1f} tok/s "
          f"over the decode steps")
    print(f"  (a) one decode step on the device (torch.profiler): "
          + ("not measured (the profiler recorded no device time)" if dev_ms == 0.0 else
             f"{n_kernels} device kernels, {dev_ms:.4f} ms busy of {step_ms:.4f} ms host "
             f"wall ({dev_ms / step_ms:.1%})") + "; largest: "
          + "; ".join(f"{k[:50]} x{c} {t:.4f} ms" for k, (c, t) in top5), flush=True)
    if bf16:
        print(f"  {what}: {served_line(fig)}; the f32 phase's: "
              f"{served_line(SERVED.get(cfg.name))}", flush=True)
    else:
        SERVED[cfg.name] = fig

    # -- (b) the unembed's two signatures (N = 51,866: no operand on 16-byte
    # words), against their plain version, then timed
    matmul_signatures(cfg.name, svc, [("decode unembed", B, params["embed_t"], "1 per decode step"),
                                      ("forward unembed", B * P, params["embed_t"],
                                       "1 per forward")], dev, seed + 3, dtype, rows)
    if bf16:   # cross-attention's shapes, plain in the served run (no service there)
        G = cfg.n_heads // K
        attention_shapes(what, svc, dev, seed + 5, dtype,
                         (B * K, P, Se, hd, False, f"cross-attention over {Se} frames, {G} "
                                                   f"call(s) a decoder layer (0: plain)"),
                         (B, K, G, Se, hd, Se - 1, 0, "a step's cross-attention over the "
                                                      "cache a prefill fills (0 a step: plain)"))
    return cfg, g


def audio_vs_cpu(cfg, dev) -> None:
    """Phase 13 (c): the card against the CPU at full width and 1500 frames,
    depth cut to ``AUDIO["check_layers"]`` encoder and decoder layers, the
    same weights and frames: forward logits at LOGIT_TOL and greedy tokens
    equal, beside the least gap between the top two logits."""
    import dataclasses

    import torch

    from repro_torch.dispatch import DispatchService
    from repro_torch.models import forward, init_params
    from repro_torch.serve import greedy_decode

    a = AUDIO
    n, Bc, P1, gen1 = a["check_layers"], a["check_batch"], a["check_prompt"], a["check_gen"]
    ccfg = dataclasses.replace(cfg, n_layers=n, n_encoder_layers=n)
    cparams = init_params(ccfg, torch.Generator(device=dev).manual_seed(a["seed"]))
    g = torch.Generator(device=dev).manual_seed(a["seed"] + 4)
    p1 = torch.randint(0, ccfg.vocab_size, (Bc, P1), generator=g, device=dev)
    f1 = torch.randn(Bc, ccfg.encoder_len, ccfg.d_model, generator=g, device=dev)
    svc = DispatchService()
    margins: list = []
    with logit_margins(margins):
        want_toks = greedy_decode(cparams, ccfg, p1, steps=gen1, max_len=P1 + gen1,
                                  service=svc, enc_embed=f1)
    want_logits, _ = forward(cparams, {"tokens": p1, "enc_embed": f1}, ccfg, service=svc)
    cpu = torch.device("cpu")
    cparams_cpu = tree_to(cparams, cpu)
    want_logits, want_toks, p1, f1 = want_logits.cpu(), want_toks.cpu(), p1.cpu(), f1.cpu()
    del cparams, svc
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    svc_cpu = DispatchService()
    got_logits, _ = forward(cparams_cpu, {"tokens": p1, "enc_embed": f1}, ccfg, service=svc_cpu)
    got_toks = greedy_decode(cparams_cpu, ccfg, p1, steps=gen1, max_len=P1 + gen1,
                             service=svc_cpu, enc_embed=f1)
    del cparams_cpu
    print(f"  (c) {cfg.name} card vs CPU at {n} + {n} of {cfg.n_encoder_layers} + "
          f"{cfg.n_layers} layers, batch {Bc}, prompt {P1}, {ccfg.encoder_len} frames: least gap "
          f"between the top two logits {min(margins):.3e} (the forward and {P1 + gen1} decode "
          f"steps on the card); the CPU's side {time.perf_counter() - t0:.1f} s")
    compare(f"{cfg.name} logits, card vs CPU ({n} + {n} layers, prompt {P1})",
            want_logits, got_logits, LOGIT_TOL)
    if not torch.equal(want_toks, got_toks):
        raise AssertionError(f"{cfg.name} greedy tokens card {want_toks.tolist()} != CPU "
                             f"{got_toks.tolist()}")
    print(f"  (c) {cfg.name} greedy tokens ({gen1}), card and CPU: {want_toks.tolist()} (equal)",
          flush=True)


def audio_train_flops(cfg, params: dict, batch: int, seq: int) -> float:
    """A training step's model FLOPs counted from the leaves: 2 per value of
    each weight matrix (each layer's slice of a stacked leaf) and each row
    it multiplies (the encoder's matrices and the decoder's xk, xv: batch x
    encoder_len rows; the decoder's other matrices and the tied unembed:
    batch x seq), plus attention's score and value products (the encoder's
    frames squared, the decoder's whole S x S square, the cross-attention's
    S x frames), the backward twice the forward. remat's recomputation is
    not counted. (``param_count()`` leaves out the cross-attention, so 6 x
    params x tokens would undercount.)"""
    def matrices(tree: dict) -> int:
        return sum(matrices(v) if isinstance(v, dict) else (v.numel() if v.ndim == 3 else 0)
                   for v in tree.values())

    enc_rows, dec_rows = batch * cfg.encoder_len, batch * seq
    dec = params["dec_layers"]
    cross_kv = dec["xk"].numel() + dec["xv"].numel()
    fwd = 2.0 * (matrices(params["enc_layers"]) * enc_rows + cross_kv * enc_rows
                 + (matrices(dec) - cross_kv) * dec_rows + params["embed"].numel() * dec_rows)
    Se = cfg.encoder_len
    attn = 4.0 * batch * cfg.n_heads * cfg.hd * (cfg.n_encoder_layers * Se * Se
                                                 + cfg.n_layers * (seq * seq + seq * Se))
    return 3.0 * (fwd + attn)


def audio_training(dev) -> None:
    """Phase 13 (d): whisper-large-v3 trained on the card: two make_train_step
    steps at full width and full depth under remat "full" on one batch (the
    first's loss, aux and grad norm; each step's ms; FLOPs counted from the
    leaves as a share of the f32 peak; peak memory), the first step at 4 + 4
    layers under each policy (losses equal, peaks), the card against the
    CPU at 2 + 2 layers over 3 steps."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.kernels.cost import hopper
    from repro_torch.models import init_params, trainable
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    t, seed, lr = AUDIO_TRAIN, AUDIO["seed"], TRAIN["lr"]
    cfg = dataclasses.replace(get_config(AUDIO["arch"]), dtype=torch.float32)

    def batch_of(c):
        b = make_batch(SyntheticLM(c.vocab_size, t["seq"], t["batch"], seed=seed), 0, dev)
        b["enc_embed"] = audio_frames(c, t["batch"], seed + 1).to(dev)
        return b

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = trainable(init_params(cfg, torch.Generator(device=dev).manual_seed(seed)))
    n = sum(x.numel() for x in tree_leaves(params))
    flops = audio_train_flops(cfg, params, t["batch"], t["seq"])
    opt = init_train_state(params)
    step = make_train_step(cfg, lr=lr, remat=t["remat"])
    b = batch_of(cfg)
    ms, first = [], None
    for _ in range(2):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - ts) * 1e3)
        first = first or (float(m["loss"]), float(m["aux"]), float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    loss, aux, gnorm = first
    peak_flops = hopper().ffma_flops
    print(f"  (d) {cfg.name}, {cfg.n_encoder_layers} + {cfg.n_layers} layers, {n / 1e6:.1f}M "
          f"parameters (the train state's leaves), batch {t['batch']} x {t['seq']} decoder "
          f"tokens + {cfg.encoder_len} frames, remat {t['remat']!r}, lr {lr}: first step loss "
          f"{loss:.4f}, aux {aux:.4f}, grad norm {gnorm:.4f}; second step loss "
          f"{float(m['loss']):.4f}", flush=True)
    print(f"  (d) ms a step: {ms[0]:.1f} (the first) and {ms[1]:.1f}; {flops / 1e12:.3f} TFLOP a "
          f"step counted from the leaves (remat's recomputation not counted), "
          f"{flops / (ms[1] * 1e-3) / 1e12:.2f} TFLOP/s in the second, "
          f"{flops / (ms[1] * 1e-3) / peak_flops:.1%} of the f32 peak "
          f"({peak_flops / 1e12:.0f} TFLOP/s); peak allocated {peak / 1e9:.3f} GB; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not all(map(math.isfinite, (loss, aux, gnorm))) or aux != 0.0:
        raise AssertionError(f"{cfg.name}: a train step gave loss {loss}, aux {aux}, "
                             f"grad norm {gnorm}")
    del params, opt, step, m
    gc.collect()
    torch.cuda.empty_cache()

    nl = t["policy_layers"]
    pcfg = dataclasses.replace(cfg, n_layers=nl, n_encoder_layers=nl)
    base = trainable(init_params(pcfg, torch.Generator(device=dev).manual_seed(seed)))
    b = batch_of(pcfg)
    losses, peaks = {}, {}
    for remat in ("none", "full", "dots"):
        params = tree_map(lambda x: x.clone(), base)
        opt = init_train_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, m = make_train_step(pcfg, lr=lr, remat=remat)(params, opt, b)
        losses[remat] = float(m["loss"])
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
        del params, opt, m
    rel = {k: abs(v - losses["none"]) / abs(losses["none"]) for k, v in losses.items()}
    print(f"  (d) {nl} + {nl} layers, the first step under each remat policy: "
          + ", ".join(f"{k!r} loss {v:.6f} (relative {rel[k]:.2e}), peak {peaks[k] / 1e9:.3f} GB"
                      for k, v in losses.items()) + f" (at most {REMAT_RTOL:g} apart)",
          flush=True)
    if max(rel.values()) > REMAT_RTOL:
        raise AssertionError(f"{cfg.name}: remat changed the first loss: {losses}")
    del base
    gc.collect()
    torch.cuda.empty_cache()
    nc = t["check_layers"]
    train_vs_cpu(dev, dataclasses.replace(cfg, n_layers=nc, n_encoder_layers=nc), "(d)")
    gc.collect()
    torch.cuda.empty_cache()


def audio_phase(launches: dict, dev) -> None:
    """Phase 13: the audio family on the card. The served model's tensors
    are gone from the card before the check's weights, and the training
    parts', are drawn."""
    import torch

    t13 = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg, _ = audio_serve(launches, dev, AUDIO, torch.float32, AUDIO["check_layers"])
    released(cfg.name, base, "the served run")
    audio_vs_cpu(cfg, dev)
    released(cfg.name, base, "the card-against-CPU check")
    audio_training(dev)
    released(cfg.name, base, "training")
    print(f"  phase 13: {time.perf_counter() - t13:.1f} s", flush=True)


def load_bench(launches: dict, dev) -> None:
    """Phase 14 (a): the serving benchmark at full width. First every
    decode_attention signature its tuned run can meet (the batch ladder x
    the page-aligned buckets of every page the campaign can pick, and the
    replay's full allocation) against the plain version at every bk/hg of
    the gpu space; then `torch_serve_bench.main` with the launch counts set
    to 0 just before and read just after (added to ``launches``): its
    tripwires, the kernels in the default and tuned modes and none in the
    einsum mode, each request's ids equal between default and tuned, and
    ``launch.obs summarize --metrics`` on its snapshot."""
    import torch

    sys.path.insert(0, ROOT)
    from benchmarks import torch_serve_bench as tsb
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        CacheRows,
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.kernels.spaces import PAGE_SIZES_HOST, kernel_space
    from repro_torch.launch import obs as obs_cli

    w = LOAD_WORKLOAD
    cfg = get_config("qwen2-0.5b")
    K, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    workload = tsb.make_workload(w["requests"], w["rate"], w["prompt_lens"], w["out_mean"],
                                 w["out_cap"], w["seed"])
    max_resident = max(r["prompt_len"] + r["out_len"] for r in workload)
    buckets = sorted({b for page in PAGE_SIZES_HOST
                      for b in [*range(page, -(-max_resident // page) * page + 1, page),
                                -(-w["max_len"] // page) * page]})
    space = kernel_space("decode_attention", target="gpu")
    g = torch.Generator(device=dev).manual_seed(14)
    for bsz in (1, 2, 4, 8):
        worst, n = 0.0, 0
        for S in buckets:
            q = torch.randn(bsz * K, G, hd, generator=g, device=dev)
            kr, vr = (CacheRows(torch.randn(bsz, S, K, hd, generator=g, device=dev))
                      for _ in range(2))
            cp = torch.randint(0, S, (bsz * K,), generator=g, device=dev, dtype=torch.int32)
            cp[0] = S - 1
            want = decode_attention_plain(q, kr, vr, cp)
            for bk in space["bk"].sequence:
                for hg in space["hg"].sequence:
                    diff = (decode_attention(q, kr, vr, cp, bk=bk, hg=hg) - want).abs()
                    if not bool((diff <= ATTN_TOL["atol"] + ATTN_TOL["rtol"]
                                 * want.abs()).all()):
                        raise AssertionError(f"decode_attention ({bsz * K}, {G}, {S}, {hd}) "
                                             f"bk={bk} hg={hg} disagrees with its plain "
                                             f"version: max abs err {diff.max().item():.3e}")
                    worst, n = max(worst, diff.max().item()), n + 1
        print(f"  (a) decode_attention at batch {bsz} ({bsz * K}, {G}, S, {hd}), S in "
              f"{buckets}, per-row positions: {n} configs x buckets against the plain "
              f"version, max abs err {worst:.3e} (tol atol {ATTN_TOL['atol']:g} + rtol "
              f"{ATTN_TOL['rtol']:g}*|want|)", flush=True)

    out_dir = os.environ.get("CHIP_SMOKE_OUT", os.path.join(ROOT, "build"))
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "BENCH_torch_serve.json")
    obs_out = os.path.join(out_dir, "BENCH_torch_serve.obs.jsonl")
    for f in (out, obs_out):
        if os.path.exists(f):
            os.remove(f)   # write_snapshot appends
    wrappers = (flash_attention, decode_attention, tiled_matmul)
    record: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        for wr in wrappers:
            wr.launches = 0
        reset_routes()
        rc = tsb.main(LOAD_BENCH_ARGV + ["--store", tmp, "--out", out, "--obs-out", obs_out],
                      record=record)
        torch.cuda.synchronize()
        counts = {wr.__name__: wr.launches for wr in wrappers}
    # the prompts' forwards (16-48 rows, f32) on mma.sync, the decode rounds
    # (at most 8 rows) and the prompts' replays on the split stream
    check_routes("(a) torch_serve_bench", {}, launches, only=("split", "mma_sync"))
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    if rc != 0:
        raise AssertionError(f"torch_serve_bench exited {rc}: "
                             f"{record.get('fail', 'no tripwire named')}")
    modes, payload = record["modes"], record["payload"]
    for mode, r in modes.items():
        print(f"  (a) {mode}: token latency p50 {r['token_lat_p50_ms']:.3f} ms, p99 "
              f"{r['token_lat_p99_ms']:.3f} ms; TTFT p50 {r['ttft_p50_ms']:.1f} ms; "
              f"{r['throughput_tok_s']:.2f} tok/s ({r['tokens']} tokens in "
              f"{r['wall_sec']:.2f} s); launches {r['launches']}; page {r['page_size']}; "
              f"kv_cache at peak {json.dumps(r['kv_cache'])}"
              + (f"; dispatch {json.dumps(r['dispatch'])}" if "dispatch" in r else ""),
              flush=True)
    tuned = modes["tuned"]
    print(f"  (a) tuned config {tuned['decode_config']} (page {tuned['decode_config']['page']}, "
          f"{tuned['page_axis']}); the campaign: "
          + "; ".join(f"{c['config']} {c['seconds'] * 1e3:.4f} ms" for c in tuned["campaign"]),
          flush=True)
    guard = payload["guard"]
    print(f"  (a) guard: the least call {guard['min_shadow_ms']:.4f} ms guarded against "
          f"{guard['min_plain_ms']:.4f} ms unguarded ({guard['shadow_overhead_frac']:+.2%}; "
          f"limit 2%), p50 {guard['p50_shadow_ms']:.4f} / {guard['p50_plain_ms']:.4f} ms; "
          f"drift injected {guard['injected_delay_sec'] * 1e3:.0f} ms a call, "
          f"{guard['calls_per_window']} calls a window read from "
          f"{guard['watched_histogram']}: {[d['reason'] for d in guard['decisions']]}, "
          f"fallback {guard['fallback_ok']}; shadow {json.dumps(guard['shadow'])}", flush=True)
    print(f"  (a) launches over the benchmark: {counts} (the modes' "
          + ", ".join(f"{m} {r['launches']}" for m, r in modes.items())
          + "; the rest the campaign, the probe and the guard phase)", flush=True)
    if any(modes["einsum"]["launches"].values()) or \
            min(min(modes[m]["launches"].values()) for m in ("default", "tuned")) < 1:
        raise AssertionError(f"launches per mode: {[r['launches'] for r in modes.values()]}")
    ids = {m: r["ids"] for m, r in modes.items()}
    if ids["default"] != ids["tuned"]:
        diff = [i for i in ids["default"] if ids["default"][i] != ids["tuned"][i]]
        raise AssertionError(f"generated ids of requests {diff} differ between the default "
                             f"and the tuned mode")
    same = [i for i in ids["einsum"] if ids["einsum"][i] == ids["default"][i]]
    print(f"  (a) every request's ids equal between default and tuned ({len(ids['tuned'])} "
          f"requests); einsum (torch operations, no kernel) equal for {len(same)} of "
          f"{len(ids['einsum'])}", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_cli.main(["summarize", "--metrics", obs_out])
    hists = [h for h in json.loads(buf.getvalue())["metrics"]["histograms"]
             if h["name"] == "dispatch_execute_seconds"]
    kernels = sorted({h["labels"]["kernel"] for h in hists})
    if rc != 0 or not {"flash_attention", "decode_attention"} <= set(kernels):
        raise AssertionError(f"launch.obs summarize --metrics: exit {rc}, kernels {kernels}")
    print(f"  (a) launch.obs summarize --metrics {os.path.relpath(obs_out, ROOT)}: "
          f"dispatch_execute_seconds of {kernels} over "
          f"{sum(h['count'] for h in hists)} calls in {len(hists)} signatures; wrote "
          f"{os.path.relpath(out, ROOT)}", flush=True)

    # the decode signature the tuned run meets most (the full batch at the
    # median request's bucket), per-row positions, the cache read in place:
    # the tuned and the default config against the plain version, queued
    # beside scaled_dot_product_attention in f32 on the rows and the bound
    import torch.nn.functional as F

    from repro_torch.dispatch.registry import get as get_variant
    from repro_torch.kernels.model_kernels import decode_attention_builder

    resident = sorted(r["prompt_len"] + r["out_len"] // 2 for r in workload)[len(workload) // 2]
    page = tuned["decode_config"]["page"]
    S, BH = min(-(-resident // page) * page, w["max_len"]), w["max_batch"] * K
    q = torch.randn(BH, G, hd, generator=g, device=dev)
    kc, vc = (torch.randn(w["max_batch"], S, K, hd, generator=g, device=dev) for _ in range(2))
    kr, vr = CacheRows(kc), CacheRows(vc)
    cp = torch.randint(0, S, (BH,), generator=g, device=dev, dtype=torch.int32)
    want = decode_attention_plain(q, kr, vr, cp)
    slots = int((cp + 1).sum())
    b_ms, b_by = bound(4.0 * G * hd * slots, 4.0 * (2 * slots * hd + 2 * BH * G * hd))
    krow, vrow = kr.rows().contiguous(), vr.rows().contiguous()
    mask = torch.arange(S, device=dev)[None, None, :] <= cp[:, None, None]
    l_ms = queued_ms(lambda: F.scaled_dot_product_attention(q, krow, vrow, attn_mask=mask))
    for label, c in (("tuned", tuned["decode_config"]),
                     ("default", get_variant("decode_attention").default_config("gpu"))):
        fn = decode_attention_builder(c)
        compare(f"(a) decode_attention ({BH}, {G}, {S}, {hd}) at the {label} config {c}, "
                f"against its plain version", fn(q, kr, vr, cp), want, ATTN_TOL)
        k_ms = queued_ms(lambda: fn(q, kr, vr, cp))
        print(f"  (a) decode_attention ({BH}, {G}, {S}, {hd}), {label} config: kernel "
              + ("not measured" if k_ms is None else f"{k_ms:.4f} ms")
              + f" queued on the device, bound {b_ms:.4f} ms ({b_by}), SDPA f32 on the rows "
              + ("not measured" if l_ms is None else f"{l_ms:.4f} ms"), flush=True)


def catalog_arch(arch: str, P: int, n_layers: int, launches: dict, dev):
    """Phase 14 (b) for one arch: serve it at full width with ``n_layers``
    layers through launch.serve.serve with the launch counts set to 0 just before
    and read just after (added to ``launches``); then per-call launches and
    times, the decode step's bytes bound and busy share, and the new matmul
    and attention signatures against their plain versions and timed.
    Returns (the served config, the prompt generator)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import decode_step, forward, init_cache, init_params

    wrappers = (flash_attention, decode_attention, tiled_matmul)
    B, gen, seed = (CATALOG_SERVE[k] for k in ("batch", "gen", "seed"))
    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype=torch.float32, n_layers=n_layers)
    L = cfg.n_layers
    one_fwd, one_step = served_launches(cfg)
    if cfg.local_global_ratio and P <= cfg.sliding_window:
        raise AssertionError(f"{arch}: a prompt of {P} does not cross the window")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    reset_routes()
    r = serve_cli.serve(arch, batch=B, prompt_len=P, gen=gen, seed=seed, device=dev,
                        n_layers=n_layers)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()
    serve_cli.report(r)
    toks = r["tokens"]
    if tuple(toks.shape) != (B, gen) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch}: tokens of shape {tuple(toks.shape)} outside the vocab")
    steps = P + gen
    want = {k: one_fwd[k] + one_step[k] * steps for k in one_fwd}
    print(f"  {arch} ({L} of {full.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv, "
          f"hd {cfg.hd}, vocab {cfg.vocab_size}, "
          f"{'tied' if cfg.tie_embeddings else 'untied'}"
          + (f", window {cfg.sliding_window} on {cfg.local_global_ratio} of every "
             f"{cfg.local_global_ratio + 1} layers" if cfg.local_global_ratio else "")
          + f"): launches over launch.serve {counts} (expected {want}: {one_fwd} per forward, "
          f"{one_step} per decode step, {steps} steps)", flush=True)
    if counts != want:
        raise AssertionError(f"{arch}: launch counts {counts} != {want}")
    check_routes(arch, {"split": one_step["tiled_matmul"] * steps,
                        "mma_sync": one_fwd["tiled_matmul"]}, launches)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    if r["stats"]["build_failed"] or r["stats"]["store_default"] == 0:
        raise AssertionError(f"{arch}: dispatch stats {r['stats']}")

    # -- per call, on the same weights and prompt (launch.serve's seeds)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    svc = DispatchService()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)
    fwd = lambda: forward(params, {"tokens": prompt}, cfg, service=svc)  # noqa: E731
    n_fwd = launches_per_call(fwd, wrappers)
    cache = init_cache(cfg, B, P + gen, device=dev)
    tok = prompt[:, -1:]
    step = lambda: decode_step(params, cache, tok, P, cfg, service=svc)  # noqa: E731
    n_step = launches_per_call(step, wrappers)
    print(f"  {arch} launches per prefill forward {n_fwd}, per decode step {n_step}")
    if n_fwd != one_fwd or n_step != one_step:
        raise AssertionError(f"{arch}: per-call launch counts differ from {one_fwd} and "
                             f"{one_step}")
    fwd_ms, step_ms = host_ms(fwd, iters=3), host_ms(step, iters=10)
    # the bytes a step must move: every weight but the embed table (the
    # lookup reads B rows), the K/V of P + 1 positions read
    weights = tree_bytes(params) - params["embed"].numel() * 4
    kv = 2 * L * B * (P + 1) * cfg.n_kv_heads * cfg.hd * 4
    step_bound = (weights + kv) / PEAK_HBM_BYTES * 1e3
    dev_ms, by_name = device_time(step)
    n_kernels = sum(c for c, _ in by_name.values())
    top5 = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:5]
    print(f"  {arch} memory: peak {peak / 1e9:.3f} GB allocated over the served run "
          f"(torch.cuda.max_memory_allocated), weights {tree_bytes(params) / 1e9:.3f} GB f32")
    print(f"  {arch} TTFT {r['prefill_ms']:.2f} ms (forward + the prompt's replay through "
          f"decode_step); forward alone {fwd_ms:.3f} ms host wall")
    print(f"  {arch} decode: {r['decode_ms_per_step']:.4f} ms per step in the run, "
          f"{step_ms:.4f} ms alone; bound {step_bound:.4f} ms (bytes at 3.35 TB/s: "
          f"{weights / 1e9:.3f} GB of weights, {kv / 1e6:.1f} MB of K/V read); "
          f"{B * 1e3 / r['decode_ms_per_step']:.1f} tok/s over the decode steps, "
          f"{r['tokens_per_sec']:.2f} over the run")
    print(f"  {arch} one decode step on the device (torch.profiler): "
          + ("not measured (the profiler recorded no device time)" if dev_ms == 0.0 else
             f"{n_kernels} device kernels, {dev_ms:.4f} ms busy of {step_ms:.4f} ms host "
             f"wall ({dev_ms / step_ms:.1%})") + "; largest: "
          + "; ".join(f"{k[:50]} x{c} {t:.4f} ms" for k, (c, t) in top5), flush=True)
    SERVED[arch] = served_record(L, P, gen, B, {"prefill_sec": r["prefill_ms"] / 1e3,
                                                "decode_sec": r["decode_ms_per_step"] * gen / 1e3},
                                 step_ms, step_bound, peak, dev_ms, n_kernels)

    # -- the new signatures, against their plain versions and timed
    unembed = params["embed_t"] if cfg.tie_embeddings else params["unembed"]
    wo = params["layers"]["wo"][0]
    matmul_signatures(arch, svc, [
        ("decode output projection", B, wo, f"{L} per decode step"),
        ("forward output projection", B * P, wo, f"{L} per forward"),
        ("decode unembed", B, unembed, "1 per decode step"),
        ("forward unembed", B * P, unembed, "1 per forward")], dev, seed + 2)
    if one_step["decode_attention"]:
        attention_signatures(arch, svc, cfg, B, P, gen, L, dev, seed)
    return cfg, g


def window_vs_cpu(arch: str, cfg, check_layers: int, P: int, g, dev) -> None:
    """The forward's logits at a prompt of ``P`` tokens past the window, on
    the card against the CPU, same weights (from CATALOG_SERVE's seed), at
    full width with ``check_layers`` layers: the local layers mask there."""
    import dataclasses

    import torch

    from repro_torch.dispatch import DispatchService
    from repro_torch.models import forward, init_params

    ccfg = dataclasses.replace(cfg, n_layers=check_layers)
    cparams = init_params(ccfg, torch.Generator(device=dev).manual_seed(CATALOG_SERVE["seed"]))
    p1 = torch.randint(0, ccfg.vocab_size, (1, P), generator=g, device=dev)
    want, _ = forward(cparams, {"tokens": p1}, ccfg, service=DispatchService())
    want = want.cpu()
    cparams_cpu = tree_to(cparams, torch.device("cpu"))
    del cparams
    torch.cuda.empty_cache()
    got, _ = forward(cparams_cpu, {"tokens": p1.cpu()}, ccfg, service=DispatchService())
    compare(f"{arch} forward logits, card vs CPU (full width, {check_layers} layers, prompt "
            f"{P} past the window of {cfg.sliding_window})", want, got, LOGIT_TOL)


def load_phase(launches: dict, dev) -> None:
    """Phase 14: serving under load (the benchmark at full width), then the
    rest of the dense catalog at full width and full depth, one arch after
    the other; a served model's tensors are gone from the card before the
    check's weights, and the next arch's, are drawn."""
    import torch

    t14 = time.perf_counter()
    load_bench(launches, dev)
    print(f"  (a) {time.perf_counter() - t14:.1f} s", flush=True)
    for arch, P, check_layers in CATALOG_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        cfg, g = catalog_arch(arch, P, check_layers, launches, dev)
        released(arch, base, "the served run")
        card_vs_cpu(arch, cfg, check_layers, g, dev, logit_margins,
                    "gap between the top two logits", CATALOG_SERVE)
        if cfg.local_global_ratio:
            window_vs_cpu(arch, cfg, check_layers, P, g, dev)
        released(arch, base, "the card-against-CPU check")
        print(f"  (b) {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  phase 14: {time.perf_counter() - t14:.1f} s", flush=True)


def kernel_inputs(kernel: str, sig: tuple, dev) -> tuple[tuple, dict]:
    """Seeded inputs of a serving kernel at a dispatch signature, and the
    static keywords the signature folds in (decode's cache fully resident)."""
    from repro_torch.kernels import problems

    args = problems.problem_inputs(kernel, problems.dims_from_signature(kernel, sig), dev)
    if kernel == "flash_attention":
        return args, {"causal": tuple(sig[3]) == (2,)}
    if kernel == "decode_attention":
        return args, {"ring": tuple(sig[4]) == (2,),
                      "window": sig[5][0] if sig[5][0] > 1 else 0}
    return args, {}


def cascade_phase(launches: dict, dev, syr2k_args: tuple, flat: dict) -> None:
    """Phase 8: the multi-fidelity cascade on the card. (a) The cost model's
    rank audit at LARGE and its shared-memory verdicts against SmemBudget's;
    (b) a syr2k cascade through the autotune CLI, and its resume; (c) a
    background cascade campaign at the decode output projection's signature.
    Adds the launch counts of each part (set to 0 just before it, read just
    after) to ``launches``; ``flat`` is phase 5's syr2k summary."""
    import numpy as np
    import torch

    from repro_torch.analyze import feasibility
    from repro_torch.core.database import OK, PerformanceDatabase
    from repro_torch.dispatch import BackgroundTuner, DispatchService, TuningStore
    from repro_torch.kernels import cost, ops, problems
    from repro_torch.kernels.covariance import covariance
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.floyd_warshall import closure_in_block, minplus_update
    from repro_torch.kernels.heat3d import heat3d
    from repro_torch.kernels.lu import lu_factor_diag
    from repro_torch.kernels.matmul import tiled_matmul, tiled_matmul_plain
    from repro_torch.kernels.spaces import kernel_space
    from repro_torch.kernels.syr2k import syr2k, syr2k_plain
    from repro_torch.launch import fidelity as fidelity_cli

    t8 = time.perf_counter()
    wrappers = (syr2k, tiled_matmul, covariance, minplus_update, closure_in_block, heat3d,
                lu_factor_diag, flash_attention, decode_attention)

    def counted(fn):
        for w in wrappers:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = {w.__name__: w.launches for w in wrappers}
        for name, k in n.items():
            launches[name] = launches.get(name, 0) + k
        return out, {k: v for k, v in n.items() if v}

    # -- (a) the rank audit at LARGE, and the model's refusals against SmemBudget's
    out_dir = os.environ.get("CHIP_SMOKE_OUT", os.path.join(ROOT, "build"))
    os.makedirs(out_dir, exist_ok=True)
    report = os.path.join(out_dir, "fidelity_audit.json")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (rc, n) = counted(lambda: fidelity_cli.main(
            ["audit", "--samples", "16", "--repeats", "3", "--out", report]))
    with open(report) as fh:
        audit = json.load(fh)
    rows = {r["kernel"]: r for r in audit["audit"]}
    print(f"  (a) audit: 16 seeded configs a kernel at LARGE, CUDA events (min of 3), "
          f"{time.perf_counter() - t0:.1f} s, launches {n}; card {audit['card']}; "
          f"model {audit['hw']['name']}, {audit['hw']['sms']} SMs")
    for k in sorted(rows):
        r = rows[k]
        rho = "nan" if r["rho"] is None else f"{r['rho']:+.3f}"
        print(f"      {k:17s} rho {rho} over {r['n_paired']} pairs ({r['n_dropped']} "
              f"dropped) at {tuple(r['dims'])}: {'strong' if r['screen_ok'] else 'weak'}")
    if rc != 0 or sorted(rows) != sorted(cost.KERNEL_COST_FNS) or \
            any(r["n_paired"] < 3 for r in rows.values()):
        raise AssertionError(f"fidelity audit: rc {rc}, rows {sorted(rows)}")
    # the proxy rung audited at its own dims, beside LARGE's rho
    for k in PROXY_AUDIT:
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            (rc, n) = counted(lambda: fidelity_cli.main(
                ["audit", "--kernel", k, "--proxy-dims", "--samples", "16", "--repeats", "3",
                 "--json"]))
        proxy = json.loads(buf.getvalue())
        (p,) = proxy["audit"]
        if rc != 0 or proxy["dims"] != "proxy" or \
                tuple(p["dims"]) != problems.PROXY_DIMS[k] or p["n_paired"] < 3:
            raise AssertionError(f"proxy audit of {k}: rc {rc}, {proxy['dims']}, {p}")
        rho = "nan" if p["rho"] is None else f"{p['rho']:+.3f}"
        big = "nan" if rows[k]["rho"] is None else f"{rows[k]['rho']:+.3f}"
        times_ms = sorted(x["measured_sec"] * 1e3 for x in p["pairs"]
                          if x["measured_sec"] is not None)
        print(f"      {k:17s} at PROXY_DIMS {tuple(p['dims'])}: rho {rho} over "
              f"{p['n_paired']} pairs ({'strong' if p['screen_ok'] else 'weak'}); at LARGE "
              f"{big}; measured {times_ms[0]:.4f}..{times_ms[-1]:.4f} ms, "
              f"{time.perf_counter() - t0:.1f} s, launches {n}", flush=True)
    limit = feasibility.smem_limit()
    checked = refused = 0
    for k in sorted(cost.KERNEL_COST_FNS):
        dims = problems.LARGE_SHAPES[k]
        ctx = feasibility.RuleContext(kernel=k, dims=dims, target="gpu")
        space = kernel_space(k, target="gpu", seed=3)
        for cfg in space.sample_configurations(64, np.random.default_rng(3)):
            budget = list(feasibility.SmemBudget().check(cfg, ctx))
            t, _ = cost.kernel_cost(k, cfg, *dims)
            if np.isinf(t) != bool(budget):
                raise AssertionError(f"{k} {cfg}: cost {t}, SmemBudget {budget}")
            checked, refused = checked + 1, refused + bool(budget)
        t, _ = cost.kernel_cost(k, space.default_configuration(), *dims)
        if not np.isfinite(t):
            raise AssertionError(f"{k}: the gpu default is infinite at LARGE")
    print(f"      cost model vs SmemBudget (limit {limit} B): {checked} sampled configs, "
          f"{refused} refused by both, none by one alone; every gpu default finite")

    # -- (b) the syr2k cascade through the CLI at LARGE, and its resume
    C, A, B = syr2k_args
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cascade_") as tmp:
        db = os.path.join(tmp, "syr2k")
        argv = ["--kernel", "syr2k", "--learner", "RF", "--cascade",
                "--rung-budgets", "64,16,8", "--db", db]
        (summary, _), n = counted(lambda: run_cli(argv))
        block = summary["cascade"]
        recs = [PerformanceDatabase(os.path.join(db, f"rung{i}")).records for i in range(3)]
        for i, rr in enumerate(recs):
            if any(r.status == OK and r.info.get("rung") != i for r in rr):
                raise AssertionError(f"rung {i}: a record without its rung")
        timed = sum(len(r.info.get("times_sec", ())) + 1 for rr in recs[1:] for r in rr
                    if r.status == OK)   # warm-up + repeats, one launch each
        if block["hw_evals"] > 8 or len(recs[2]) > 8 or n.get("syr2k", 0) != timed:
            raise AssertionError(f"cascade: hw evaluations {block['hw_evals']}, "
                                 f"syr2k launches {n} against {timed} timed runs")
        best = summary["best_config"]
        got = ops.syr2k_op(C, A, B, config=best)
        torch.cuda.synchronize()
        compare(f"syr2k cascade best {best} vs plain", got, syr2k_plain(C, A, B), SYR2K_TOL)
        for stat, sec, rr in zip(block["rungs"], block["eval_sec"], recs):
            ok = sorted(r.objective for r in rr if r.status == OK)
            print(f"      rung {stat['rung']} ({stat['name']}): {stat['screened']} "
                  f"evaluated ({stat['failed']} failed), {stat['promoted']} promoted, "
                  f"{sec:.2f} s in its evaluator; objectives {ok[0] * 1e3:.4f}.."
                  f"{ok[-1] * 1e3:.4f} ms")
        print(f"      calibration (bias, scale, pairs): "
              + "; ".join(f"{c['bias']:.4g}, {c['scale']:.3f}, {c['n_pairs']}"
                          for c in block["calibration"]))
        print(f"  (b) cascade 64,16,8: best {summary['best_objective_sec'] * 1e3:.4f} ms "
              f"{best}, {block['hw_evals']} evaluations at LARGE, wall "
              f"{summary['wall_sec']:.2f} s, launches {n}; phase 5's flat campaign: best "
              f"{flat['best_objective_sec'] * 1e3:.4f} ms, {flat['n_evaluated'] + flat['n_failed']} "
              f"evaluations at LARGE, wall {flat['wall_sec']:.2f} s", flush=True)
        # beside it, the same budget at full size without the proxy rung
        (two, _), n2 = counted(lambda: run_cli(
            ["--kernel", "syr2k", "--learner", "RF", "--cascade", "--rung-budgets", "64,8"]))
        print(f"      cost -> full size only (64,8): best {two['best_objective_sec'] * 1e3:.4f} ms "
              f"{two['best_config']}, wall {two['wall_sec']:.2f} s, launches {n2}")
        (again, head), n = counted(lambda: run_cli(argv + ["--resume"]))
        if n or any(r["screened"] for r in again["cascade"]["rungs"]) or \
                "resume: rung 2 (hw) has" not in head:
            raise AssertionError(f"cascade --resume was not a no-op: launches {n}, "
                                 f"{again['cascade']['rungs']}")
        print(f"      --resume: nothing evaluated, no launch, best "
              f"{again['best_objective_sec'] * 1e3:.4f} ms")

    # -- (c) a background cascade at the decode output projection's signature
    x, w = model_operands(4, 896, 896, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bgcascade_") as tmp:
        store = TuningStore(tmp)
        tuner = BackgroundTuner(store, max_workers=1, max_evals=8, n_initial=4, cascade=True)
        svc = DispatchService(store, tuner=tuner)
        try:
            t0 = time.perf_counter()
            (recs, n) = counted(lambda: (svc.call("matmul", x, w), tuner.drain(timeout=600))[1])
            if tuner.errors or len(recs) != 1 or recs[0] is None or \
                    tuner.stats["cascade_campaigns"] != 1 or n.get("tiled_matmul", 0) < 1:
                raise AssertionError(f"background cascade: {recs}, {tuner.errors}, "
                                     f"{tuner.stats}, launches {n}")
        finally:
            tuner.shutdown()
        rec = recs[0]
        again = DispatchService(store)
        out, _ = counted(lambda: again.call("matmul", x, w))
        if again.stats["store_exact"] != 1:
            raise AssertionError(f"the published record did not resolve: {again.stats}")
        torch.cuda.synchronize()
        compare(f"matmul (4, 896) @ (896, 896) at the published {rec.config} vs plain", out,
                tiled_matmul_plain(x, w, bk=int(rec.config["bk"]),
                                   pack=bool(rec.config["pack"]), out_dtype=torch.float32),
                F32_TOL)
        tel = svc.telemetry()
        print(f"  (c) BackgroundTuner(cascade=True): {rec.objective * 1e3:.4f} ms at "
              f"{rec.config} published in {time.perf_counter() - t0:.1f} s; screened "
              f"{tel['screened']}, promoted {tel['promoted']}, cascade campaigns "
              f"{tel['cascade_campaigns']}; the next service resolves it (store_exact "
              f"{again.stats['store_exact']})")
    print(f"  phase 8: {time.perf_counter() - t8:.1f} s", flush=True)


def tables_phase(launches: dict, best_check) -> None:
    """Phase 9: the paper's Tables 1-7 on the card (benchmarks/torch_tables.py)
    and the four-learner study (benchmarks/torch_learners.py). Each table's
    rows are printed and checked: a time, or `rejected` followed by its
    `_clipped` row; the correctness row 1.0; the winner and every config rows
    3-4 ran against the kernel's plain version by ``best_check(kernel,
    config)`` (phase 5's checks at phase 3's tolerances). Adds each part's
    launch counts (set to 0 just before it, read just after) to
    ``launches``."""
    import math

    import torch

    from benchmarks import torch_tables
    from benchmarks.torch_common import emit
    from benchmarks.torch_learners import learner_campaigns
    from repro_torch.kernels.covariance import covariance
    from repro_torch.kernels.floyd_warshall import closure_in_block, minplus_update
    from repro_torch.kernels.heat3d import heat3d
    from repro_torch.kernels.lu import lu_factor_diag
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.kernels.syr2k import syr2k

    t9 = time.perf_counter()
    wrappers = (syr2k, tiled_matmul, covariance, minplus_update, closure_in_block, heat3d,
                lu_factor_diag)

    def counted(fn):
        for w in wrappers:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = {w.__name__: w.launches for w in wrappers}
        for name, k in n.items():
            launches[name] = launches.get(name, 0) + k
        return out, {k: v for k, v in n.items() if v}

    kernels = ("syr2k", "mm3", "lu", "heat3d", "covariance", "floyd_warshall")
    for kernel, table in zip(kernels, torch_tables.ALL_TABLES):
        evals = TABLE_EVALS.get(kernel, TABLE_EVALS["default"])
        t0 = time.perf_counter()
        rows, n = counted(lambda: table(None, evals, "RF"))
        emit(rows)
        name = rows[0].name.split("/")[0]
        labels = [r.name.split("/", 1)[1] for r in rows]
        want = ["naive", "xla_default"]
        for fixed in ("blocked_heur", "blocked_paper"):
            want += [fixed, f"{fixed}_clipped"] if f"{fixed}_clipped" in labels else [fixed]
        want += ["autotuned_RF", "autotuned_correct"]
        by = {r.name.split("/", 1)[1]: r for r in rows}
        if labels != want:
            raise AssertionError(f"{name}: rows {labels}, expected {want}")
        for label in want[:-1]:
            us = by[label].us
            # a refused config is printed `rejected` and followed by its
            # `_clipped` row, which may be refused in turn
            rejected = us is None and by[label].derived.startswith("rejected: ") and \
                (label.endswith("_clipped") or f"{label}_clipped" in by)
            if not rejected and (us is None or not math.isfinite(us) or us <= 0):
                raise AssertionError(f"{name}/{label}: {by[label]}")
        if by["autotuned_correct"].us != 1.0:
            raise AssertionError(f"{name}: the winner disagrees with ref at 2e-2")
        # every config that ran, the winner and rows 3-4, against the plain version
        for label in want[2:-1]:
            if by[label].us is not None:
                got, plain, tol = best_check(kernel, by[label].config)
                torch.cuda.synchronize()
                compare(f"{name}/{label} {by[label].config} vs plain", got, plain, tol)
        rank = sorted((r.us, r.name.split("/", 1)[1]) for r in rows[:-1] if r.us is not None)
        print(f"  {name}: {time.perf_counter() - t0:.1f} s, {evals} RF evaluations, launches "
              f"{n}; fastest first: " + ", ".join(label for _, label in rank), flush=True)

    t0 = time.perf_counter()
    evals = TABLE_EVALS["learners"]
    results, n = counted(lambda: learner_campaigns(evals))
    for learner, res in results.items():
        b = res.best
        if b is None or res.n_evaluated + res.n_skipped + res.n_failed < evals:
            raise AssertionError(f"learner {learner}: {res.n_evaluated} evaluated, "
                                 f"{res.n_skipped} skipped, {res.n_failed} failed")
        print(f"  learners_syr2k/{learner}: best {b.objective * 1e3:.4f} ms (campaign "
              f"objective) at evaluation {b.index}, {res.n_evaluated} real evaluations of "
              f"{evals}, skipped duplicates {res.n_skipped}; {b.config}", flush=True)
    print(f"  learner study: {time.perf_counter() - t0:.1f} s, launches {n}")
    print(f"  phase 9: {time.perf_counter() - t9:.1f} s", flush=True)


def tuning_loop(launches: dict, dev, syr2k_args: tuple, phase6_ms: float) -> None:
    """Phase 7: the tuning loop on the card. (a) An offline campaign
    publishes to a store that the dispatch service resolves as an exact hit,
    and a warm-started campaign re-evaluates that record first. (b) Serving
    with a BackgroundTuner: every miss enqueues a campaign on the card that
    publishes and hot-swaps; a second run on that store resolves every
    signature exactly and enqueues nothing. (c) A GuardAgent shadow-times the
    second run on the device with no quarantine; a record with an impossible
    objective is quarantined two windows later, serving falls back and a
    re-campaign is enqueued. Adds the launch counts of each part (set to 0
    just before it, read just after) to ``launches``; ``phase6_ms`` is
    phase 6's ms per decode step (default configs, no tuner, no guard)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.database import PerformanceDatabase
    from repro_torch.dispatch import (
        BackgroundTuner,
        DispatchService,
        TuningRecord,
        TuningStore,
        parse_signature_key,
        resolve,
        signature_key,
    )
    from repro_torch.dispatch.registry import get as get_variant
    from repro_torch.guard import GuardAgent, ShadowPolicy, WatchPolicy
    from repro_torch.guard.watch import SHADOW_HISTOGRAM, window_stats
    from repro_torch.kernels import problems
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.kernels.syr2k import syr2k, syr2k_plain
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import decode_step, forward, init_cache, init_params
    from repro_torch.obs import MetricsRegistry

    t7 = time.perf_counter()
    wrappers = (syr2k, flash_attention, decode_attention, tiled_matmul)

    def counted(fn):
        """``fn()`` with the wrappers' counts set to 0 just before and read just
        after (added to ``launches``); returns (its result, the counts)."""
        for w in wrappers:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = {w.__name__: w.launches for w in wrappers}
        for name, k in n.items():
            launches[name] = launches.get(name, 0) + k
        return out, n

    C, A, B = syr2k_args
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        # -- (a) offline campaign -> store -> exact hit; warm start
        offline = os.path.join(tmp, "offline")
        (summary, _), n = counted(lambda: run_cli(
            ["--kernel", "syr2k", "--learner", "RF", "--max-evals", str(TUNE["offline_evals"]),
             "--store", offline]))
        best = summary["best_config"]
        (rec,) = TuningStore(offline).records()
        if (rec.signature, rec.backend, rec.config) != \
                (problems.problem_signature_for("syr2k", "gpu"), "gpu", best) or n["syr2k"] < 1:
            raise AssertionError(f"autotune --store published {rec} (launches {n})")
        svc = DispatchService(TuningStore(offline))
        out, n = counted(lambda: svc.call("syr2k", C, A, B))
        served = svc.dispatch("syr2k", C, A, B).__wrapped__.fn.keywords["config"]
        if svc.stats["store_exact"] != 1 or svc.stats["build_failed"] or \
                svc.stats["infeasible"] or n["syr2k"] != 1 or \
                {k: served[k] for k in best} != best:
            raise AssertionError(f"store resolution: stats {svc.stats}, launches {n}, "
                                 f"served {served} for the published {best}")
        compare(f"syr2k at LARGE through the store's record {best} vs plain", out,
                syr2k_plain(C, A, B), SYR2K_TOL)
        warm_db = os.path.join(tmp, "warm")
        (_, head), _ = counted(lambda: run_cli(
            ["--kernel", "syr2k", "--learner", "RF", "--max-evals", str(TUNE["warm_evals"]),
             "--warm-start", offline, "--db", warm_db]))
        first = PerformanceDatabase(warm_db).records[0].config
        if "warm-start: nearest store config re-evaluated first" not in head or first != best:
            raise AssertionError(f"warm start: first evaluation {first}, store's {best}")
        print(f"  (a) autotune --store: {rec.objective * 1e3:.4f} ms at {best} published for "
              f"{signature_key(rec.signature)}; DispatchService: store_exact "
              f"{svc.stats['store_exact']}, the published config served; --warm-start: "
              f"first evaluation {first}", flush=True)

        # -- (b) serving misses tune in the background; run 2 resolves them
        cfg = dataclasses.replace(get_config(SERVE["arch"]), dtype=torch.float32)
        Bn, P, gen, seed = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"], SERVE["seed"]
        serving = os.path.join(tmp, "serving")
        # one campaign at a time: two would time each other's kernels too
        tuner1 = BackgroundTuner(TuningStore(serving), max_workers=1,
                                 max_evals=TUNE["bg_evals"])
        enqueued = []
        submit = tuner1.submit

        def recording_submit(kernel, signature, backend, **kw):
            fut = submit(kernel, signature, backend, **kw)
            if fut is not None:
                enqueued.append((kernel, tuple(signature)))
            return fut

        tuner1.submit = recording_submit
        # distance 0: a near neighbor does not stand in, every signature is tuned
        svc1 = DispatchService(TuningStore(serving), tuner=tuner1, distance_threshold=0.0,
                               metrics=MetricsRegistry())

        def serve_run(service):
            return serve_cli.serve(SERVE["arch"], batch=Bn, prompt_len=P, gen=gen, seed=seed,
                                   device=dev, service=service)

        r1, n1 = counted(lambda: serve_run(svc1))
        for kernel, sig in enqueued:
            print(f"  (b) run 1 enqueued {kernel} {signature_key(sig)}", flush=True)
        distinct = {(h["labels"]["kernel"], h["labels"]["signature"])
                    for h in svc1.metrics.snapshot()["histograms"]
                    if h["name"] == "dispatch_execute_seconds"}
        if not enqueued or svc1.stats["bg_enqueued"] != len(enqueued) or \
                {(k, signature_key(sig)) for k, sig in enqueued} != distinct:
            raise AssertionError(f"run 1: bg_enqueued {svc1.stats['bg_enqueued']}, "
                                 f"{len(enqueued)} campaigns recorded, serving signatures "
                                 f"{sorted(distinct)}")
        t0 = time.perf_counter()
        tuner1.drain(timeout=240)
        tuner1.shutdown()
        drained = time.perf_counter() - t0
        if tuner1.errors:
            raise AssertionError(f"background campaigns failed: {tuner1.errors}")
        store = TuningStore(serving)
        published = {}
        for kernel, sig in enqueued:
            rec = store.get(kernel, sig, "gpu")
            if rec is None:
                raise AssertionError(f"no record published for {kernel} {signature_key(sig)}")
            published[(kernel, sig)] = rec
            print(f"  (b) published {kernel} {signature_key(sig)}: {rec.config}, "
                  f"{rec.objective * 1e3:.4f} ms (CUDA events, one call), {rec.n_evals} "
                  f"evaluations", flush=True)
        print(f"  (b) run 1: {r1['decode_ms_per_step']:.4f} ms/step with campaigns in flight "
              f"(tuner ask {tuner1.stats['ask_sec']:.2f} s, tell "
              f"{tuner1.stats['tell_sec']:.2f} s, wait {tuner1.stats['wait_sec']:.2f} s over "
              f"{tuner1.stats['campaigns']} campaigns), TTFT {r1['prefill_ms']:.1f} ms; the "
              f"campaigns drained {drained:.1f} s after the run; launches {n1}", flush=True)

        # run 2 on the store, a guard shadow-timing it on the device
        tuner2 = BackgroundTuner(TuningStore(serving), max_workers=1,
                                 max_evals=TUNE["bg_evals"])
        registry = MetricsRegistry()
        svc2 = DispatchService(TuningStore(serving), tuner=tuner2, metrics=registry)
        guard = GuardAgent(svc2, watch=WatchPolicy(interval_sec=1.0, drift_factor=3.0,
                                                   hysteresis=2, cooldown_sec=0.0,
                                                   min_samples=8),
                           shadow=ShadowPolicy(epsilon=TUNE["epsilon"],
                                               challenger_fraction=TUNE["challengers"], seed=0))
        svc2.attach_guard(guard)
        guard.start()
        r2, n2 = counted(lambda: serve_run(svc2))
        guard.stop()
        guard.check_once()  # the run's last window
        st2 = svc2.stats
        store.refresh()  # the shadow tells and challengers of run 2
        exact = {signature_key(sig): resolve(store, kernel, sig, "gpu")
                 for kernel, sig in enqueued}
        print(f"  (b) run 2 (tuned configs, the guard at epsilon {TUNE['epsilon']}): "
              f"{r2['decode_ms_per_step']:.4f} ms/step (run 1 {r1['decode_ms_per_step']:.4f} "
              f"with campaigns in flight, phase 6 {phase6_ms:.4f} with neither), TTFT "
              f"{r2['prefill_ms']:.1f} ms; stats {json.dumps(st2)}; launches {n2}; guard "
              f"decisions {guard.decisions}", flush=True)
        if st2["bg_enqueued"] or st2["store_exact"] < len(enqueued) or st2["store_default"] \
                or st2["store_near"] or st2["build_failed"] or st2["infeasible"] \
                or not all(r is not None and r.exact for r in exact.values()) \
                or min(n2[w] for w in ("flash_attention", "decode_attention",
                                       "tiled_matmul")) < 1:
            raise AssertionError(f"run 2 on the store: stats {st2}, launches {n2}, guard "
                                 f"decisions {guard.decisions}")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        prompt = torch.randint(0, cfg.vocab_size, (Bn, P), generator=g, device=dev)
        flips = (r1["tokens"] != r2["tokens"]).nonzero().tolist()
        if flips:
            print(f"  (b) greedy tokens of run 2 differ from run 1's at {flips} (a near tie)",
                  flush=True)
        want, _ = forward(params, {"tokens": prompt}, cfg, service=DispatchService())
        got, _ = forward(params, {"tokens": prompt}, cfg,
                         service=DispatchService(TuningStore(serving)))
        compare("first step's logits, tuned configs vs the gpu defaults (qwen2-0.5b, prompt "
                f"{P}, batch {Bn})", got[:, -1], want[:, -1], LOGIT_TOL)
        if not flips:
            print(f"  (b) greedy tokens of run 2 equal run 1's ({Bn} x {gen})", flush=True)
        hd_all = cfg.n_heads * cfg.hd
        proj = ((Bn, hd_all), (hd_all, cfg.d_model))  # the decode step's output projection
        for (kernel, sig), rec in published.items():
            args, static = kernel_inputs(kernel, sig, dev)
            spec = get_variant(kernel)
            final_cfg = store.get(kernel, sig, "gpu").config
            times = {}
            for label, cfg_ in (("default", spec.default_config("gpu")),
                                ("background campaign's", rec.config),
                                ("store's after run 2", final_cfg)):
                variant = spec.builder(cfg_, **static)
                ms = queued_ms(lambda: variant(*args))
                times[label] = "not measured" if ms is None else f"{ms:.4f} ms"
            print(f"  (b) {kernel} {signature_key(sig)}: device time a call (CUDA events, 10 "
                  f"calls queued behind a spin kernel): "
                  + ", ".join(f"{k} {v}" for k, v in times.items())
                  + f" ({rec.config}; {final_cfg})", flush=True)
            if (kernel, sig) == ("matmul", proj):
                # what the evaluations, timed from the call's first device
                # operation to its last, find at a kernel of a few tens of
                # microseconds
                found = times["background campaign's"]
                print(f"  (b) output projection {signature_key(sig)}: "
                      f"{TUNE['bg_evals']} background evaluations found {rec.config} at "
                      f"{rec.objective * 1e3:.4f} ms (its objective, from the first device "
                      f"operation to the last); device time queued: default "
                      f"{times['default']}, found {found}",
                      flush=True)
            del args

        # -- (c) the guard: a clean run, then an impossible baseline
        shadow = guard.shadow.snapshot_stats()
        windows = window_stats(None, registry.snapshot(), SHADOW_HISTOGRAM)
        for (kernel, key, _), w in sorted(windows.items()):
            base = published[(kernel, parse_signature_key(key))].objective
            now = store.get(kernel, parse_signature_key(key), "gpu").objective
            print(f"  (c) {kernel} {key}: {w['count']} shadow samples, p50 "
                  f"{w['p50'] * 1e3:.4f} ms over the background campaign's objective "
                  f"{base * 1e3:.4f} ms = {w['p50'] / base:.2f}x (the store's now "
                  f"{now * 1e3:.4f} ms, {w['p50'] / now:.2f}x; the watch quarantines past "
                  f"{guard.watch.drift_factor}x)", flush=True)
        print(f"  (c) guard over run 2: {json.dumps(shadow)}; checks "
              f"{guard.stats['checks']}, quarantines {guard.stats['quarantines']}", flush=True)
        if shadow["shadow_evals"] < 1 or shadow["challenger_evals"] < 1 \
                or guard.stats["quarantines"]:
            raise AssertionError(f"guard over the clean run: {shadow}, {guard.stats}, "
                                 f"{guard.decisions}")
        key = signature_key(proj)
        p50 = windows[("matmul", key, "gpu")]["p50"]
        store.refresh()
        rec = store.get("matmul", proj, "gpu")
        if not store.put(TuningRecord("matmul", proj, "gpu", dict(rec.config), p50 / 20,
                                      source="chip_smoke")):
            raise AssertionError(f"the impossible baseline was not accepted over {rec}")
        cache = init_cache(cfg, Bn, P + gen, device=dev)
        tok = prompt[:, -1:]
        enq0 = svc2.stats["bg_enqueued"]
        guard.check_once()  # the window base
        decisions = []
        for window in range(2):
            for i in range(TUNE["steps_per_window"]):
                decode_step(params, cache, tok, P + i % gen, cfg, service=svc2)
            decisions += guard.check_once()
        if [(x["kernel"], x["signature"]) for x in decisions] != [("matmul", key)] \
                or not decisions[0]["retune_requested"] \
                or svc2.stats["bg_enqueued"] != enq0 + 1:
            raise AssertionError(f"drift: decisions {decisions}, stats {svc2.stats}")
        store.refresh()
        quars = [q for q in store.quarantines("matmul") if q["reason"].startswith("drift:")]
        fallback, res = svc2.resolve_config("matmul", proj)
        logits, _ = decode_step(params, cache, tok, P, cfg, service=svc2)
        if not quars or (res is not None and res.exact) or not torch.isfinite(logits).all():
            raise AssertionError(f"after the quarantine: {quars}, resolution {res}")
        print(f"  (c) record at 1/20 of the measured {p50 * 1e3:.4f} ms for matmul {key}: "
              f"quarantined two windows later ({decisions[0]['reason']}), serving falls back to "
              f"{'a neighbor' if res is not None else 'the default'} {fallback}, bg_enqueued "
              f"{enq0} -> {svc2.stats['bg_enqueued']}", flush=True)
        tuner2.drain(timeout=120)
        tuner2.shutdown()
        if tuner2.errors:
            raise AssertionError(f"the re-campaign failed: {tuner2.errors}")
        del params, cache
    print(f"  phase 7: {time.perf_counter() - t7:.1f} s", flush=True)


def fleet_phase(launches: dict, dev) -> None:
    """Phase 15: the fleet and the analyzer on the card (see the module
    docstring). Adds the launch counts of each part (set to 0 just before
    it, read just after) to ``launches``."""
    import numpy as np
    import torch

    from repro_torch.analyze.feasibility import check_config
    from repro_torch.core.space import config_key
    from repro_torch.dispatch import (
        BackgroundTuner,
        DispatchService,
        TuningRecord,
        TuningStore,
        shape_signature,
        signature_key,
    )
    from repro_torch.fleet import FileTransport, FleetServer, HttpTransport, Replica, SyncAgent
    from repro_torch.kernels import ops, problems, ref
    from repro_torch.kernels.covariance import covariance, covariance_plain
    from repro_torch.kernels.floyd_warshall import (
        closure_in_block,
        floyd_warshall_plain,
        minplus_update,
    )
    from repro_torch.kernels.heat3d import heat3d
    from repro_torch.kernels.lu import lu_factor_diag, lu_plain
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.kernels.spaces import kernel_space
    from repro_torch.kernels.syr2k import syr2k, syr2k_plain
    from repro_torch.launch import analyze as analyze_cli

    t15 = time.perf_counter()

    def counted(wrappers, fn):
        for w in wrappers:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = {w.__name__: w.launches for w in wrappers}
        for name, k in n.items():
            launches[name] = launches.get(name, 0) + k
        return out, n

    def served(svc, kernel, *args):
        return svc.dispatch(kernel, *args).__wrapped__.fn.keywords["config"]

    def host(root, name, transport):
        store = TuningStore(os.path.join(root, name))
        tuner = BackgroundTuner(store, max_workers=1, max_evals=FLEET["bg_evals"])
        svc = DispatchService(store, tuner=tuner)
        return store, tuner, svc, SyncAgent(Replica(store, service=svc), transport)

    def zero_evals(label, svc, tuner, n, calls, want_cfg):
        """A host that serves a replicated record: an exact hit, nothing
        enqueued, no campaign, one launch a call, the replicated config."""
        st = svc.stats
        if st["store_exact"] < 1 or st["bg_enqueued"] or tuner.stats["campaigns"] \
                or st["sync_applied"] < 1 or n["syr2k"] != calls \
                or {k: served(svc, "syr2k", C, A, B)[k] for k in want_cfg} != want_cfg:
            raise AssertionError(f"{label}: stats {st}, tuner {tuner.stats}, launches {n}")

    C, A, B = problems.problem_inputs("syr2k", problems.LARGE_SHAPES["syr2k"], dev)
    sig = shape_signature([C, A, B])
    want = syr2k_plain(C, A, B)
    calls = FLEET["calls"]
    tuners = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        shared = os.path.join(tmp, "shared")
        try:
            # -- (a) host A's campaign, served by host B
            t0 = time.perf_counter()
            store_a, tuner_a, svc_a, agent_a = host(tmp, "a", FileTransport(shared))
            store_b, tuner_b, svc_b, agent_b = host(tmp, "b", FileTransport(shared))
            tuners += [tuner_a, tuner_b]
            _, n_a = counted((syr2k,), lambda: (svc_a.call("syr2k", C, A, B),
                                                tuner_a.drain(timeout=240)))
            rec_a = store_a.get("syr2k", sig, "gpu")
            if tuner_a.errors or rec_a is None or svc_a.stats["bg_enqueued"] != 1 \
                    or n_a["syr2k"] < 1 + FLEET["bg_evals"]:
                raise AssertionError(f"host A's campaign: {tuner_a.errors}, {rec_a}, "
                                     f"{svc_a.stats}, launches {n_a}")
            sync_a, sync_b = agent_a.sync_once(), agent_b.sync_once()
            outs, n_b = counted((syr2k,), lambda: [svc_b.call("syr2k", C, A, B)
                                                    for _ in range(calls)])
            zero_evals("host B", svc_b, tuner_b, n_b, calls, rec_a.config)
            if svc_a.stats["sync_published"] < 1 or "error" in sync_a or "error" in sync_b:
                raise AssertionError(f"sync: A {sync_a} {svc_a.stats}, B {sync_b}")
            compare(f"syr2k at LARGE on host B with host A's {rec_a.config} vs plain",
                    outs[-1], want, SYR2K_TOL)
            print(f"  (a) host A: {rec_a.n_evals} background evaluations, "
                  f"{rec_a.objective * 1e3:.4f} ms at {rec_a.config} published for "
                  f"{signature_key(sig)} (launches {n_a}); sync A {sync_a}, B {sync_b}; "
                  f"host B: {calls} calls, launches {n_b}, stats {json.dumps(svc_b.stats)}, "
                  f"campaigns {tuner_b.stats['campaigns']}, telemetry lag "
                  f"{svc_b.telemetry()['sync_last_age_sec']} s; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)

            # -- (b) hot swap of mm3 on host B, then A's quarantine
            t0 = time.perf_counter()
            margs = problems.problem_inputs("mm3", problems.LARGE_SHAPES["mm3"], dev)
            msig = shape_signature(list(margs))
            mwant = ref.mm3_ref(*margs)
            slow = dict(ops.DEFAULTS["mm3"], **FLEET["mm3_slow"])
            fast = dict(ops.DEFAULTS["mm3"])
            secs = {k: time_ms(lambda c=c: ops.mm3_op(*margs, config=c)) / 1e3
                    for k, c in (("slow", slow), ("fast", fast))}
            if secs["fast"] >= secs["slow"]:
                raise AssertionError(f"mm3: the defaults {secs['fast']} s do not beat "
                                     f"tiles of 16 {secs['slow']} s")
            mine = TuningRecord("mm3", msig, "gpu", slow, secs["slow"], source="hostB")
            better = TuningRecord("mm3", msig, "gpu", fast, secs["fast"], source="hostA")
            store_b.put(mine)
            step = svc_b.jit_cached("fleet_mm3", lambda *a: svc_b.call("mm3", *a))
            results = {}
            for label in ("B's own record", "A's record after the sync",
                          "B's own record after A's quarantine"):
                if label != "B's own record":
                    if label.startswith("A's record"):
                        store_a.put(better)
                    else:
                        store_a.quarantine(better, reason="chip_smoke: quarantined on host A")
                    agent_a.sync_once()
                    if agent_b.sync_once()["applied"] < 1:
                        raise AssertionError(f"mm3 {label}: the sync applied nothing")
                rebuilt = svc_b.stats["serve_rebuilt"]
                got, n = counted((tiled_matmul,), lambda: step(*margs))
                cfg = served(svc_b, "mm3", *margs)
                expect = fast if label.startswith("A's record") else slow
                if {k: cfg[k] for k in expect} != expect or n["tiled_matmul"] < 1 or \
                        (label != "B's own record" and svc_b.stats["serve_rebuilt"] != rebuilt + 1):
                    raise AssertionError(f"mm3 {label}: served {cfg}, launches {n}, stats "
                                         f"{svc_b.stats}")
                results[label] = (n, svc_b.stats["serve_rebuilt"] - rebuilt)
                compare(f"mm3 at LARGE on host B, {label} ({expect['bm']}x{expect['bn']} "
                        f"tiles) vs plain", got, mwant, F32_TOL)
            banned = not store_b.put(TuningRecord("mm3", msig, "gpu", fast, secs["fast"] / 2,
                                                  source="hostB"))
            if not banned or store_b.get("mm3", msig, "gpu").config != slow:
                raise AssertionError(f"A's quarantine on host B: banned {banned}, "
                                     f"{store_b.get('mm3', msig, 'gpu')}")
            print(f"  (b) mm3 {signature_key(msig)}: B's record {secs['slow'] * 1e3:.4f} ms "
                  f"(tiles 16x16), A's {secs['fast'] * 1e3:.4f} ms (64x64), CUDA events; "
                  + "; ".join(f"{k}: launches {v[0]}, serve_rebuilt +{v[1]}"
                              for k, v in results.items())
                  + f"; the quarantined config refused by B's store; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)

            # -- (c) the same over HTTP (127.0.0.1, a free port)
            t0 = time.perf_counter()
            server = FleetServer(agent_a.replica).start()
            try:
                store_c, tuner_c, svc_c, agent_c = host(tmp, "c", HttpTransport(server.url))
                tuners.append(tuner_c)
                sync_c = agent_c.sync_once()
                outs_c, n_c = counted((syr2k,), lambda: [svc_c.call("syr2k", C, A, B)
                                                          for _ in range(calls)])
            finally:
                server.stop()
            zero_evals("host C (HTTP)", svc_c, tuner_c, n_c, calls, rec_a.config)
            if "error" in sync_c or not torch.equal(outs_c[-1], outs[-1]):
                raise AssertionError(f"host C over HTTP: sync {sync_c}, the same bits as "
                                     f"host B's: {torch.equal(outs_c[-1], outs[-1])}")
            print(f"  (c) host C over {server.url}: sync {sync_c}, {calls} calls, launches "
                  f"{n_c}, output bit-identical to host B's; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            for t in tuners:
                t.shutdown()

    # -- (d) the analyzer
    t0 = time.perf_counter()
    out_dir = os.environ.get("CHIP_SMOKE_OUT", os.path.join(ROOT, "build"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analyze_cli.main(["space", "--json", "--samples", str(FLEET["audit_samples"]),
                               "--seed", str(FLEET["seed"]),
                               "--out", os.path.join(out_dir, "analyze_space.json")])
    audit = json.loads(buf.getvalue())
    rows = audit["audit"]
    kernels = sorted(problems.LARGE_SHAPES)
    if rc or not audit["gpu"]["audited"] or \
            sorted((r["kernel"], r["target"]) for r in rows) != \
            sorted((k, t) for k in kernels for t in ("host", "cost", "gpu")):
        raise AssertionError(f"launch.analyze space: rc {rc}, gpu {audit['gpu']}")
    print(f"  (d) launch.analyze space: {FLEET['audit_samples']} samples and the default a "
          f"space, gpu against {audit['gpu']['smem_limit']} B of shared memory a block "
          f"({audit['gpu']['device']}); {time.perf_counter() - t0:.1f} s", flush=True)
    for r in rows:
        top = ", ".join(f"{c} {n}" for c, n in list(r["codes"].items())[:3]) or "-"
        print(f"  (d) {r['kernel']:<16} {r['target']:<4} {r['dims']}: infeasible "
              f"{r['infeasible_fraction']:.1%}, warned {r['pathological_fraction']:.1%} "
              f"({top})", flush=True)

    def run_op(kernel, args, dims, cfg):
        if kernel == "heat3d":
            return ops.heat3d_op(args[0], dims[1], config=cfg)
        return {"syr2k": ops.syr2k_op, "mm3": ops.mm3_op, "lu": ops.lu_op,
                "covariance": ops.covariance_op,
                "floyd_warshall": ops.floyd_warshall_op}[kernel](*args, config=cfg)

    def plain_of(kernel, args, dims, full):
        """(what the plain output depends on, the plain version, tolerance):
        phase 5's checks."""
        if kernel == "lu":
            return ((full["bs"], full["pack"]),
                    lambda: lu_plain(args[0], bs=full["bs"], pack=full["pack"]), LU_TOL)
        if kernel == "floyd_warshall":
            return (full["bs"],), lambda: floyd_warshall_plain(args[0], bs=full["bs"]), EXACT
        plain, tol = {"syr2k": (lambda: syr2k_plain(*args), SYR2K_TOL),
                      "mm3": (lambda: ref.mm3_ref(*args), F32_TOL),
                      "covariance": (lambda: covariance_plain(args[0]), COV_TOL),
                      "heat3d": (lambda: ref.heat3d_ref(args[0], dims[1]), HEAT_TOL)}[kernel]
        return (), plain, tol

    t0 = time.perf_counter()
    paths = {"syr2k": (syr2k,), "mm3": (tiled_matmul,),
             "lu": (tiled_matmul, lu_factor_diag), "covariance": (covariance,),
             "floyd_warshall": (minplus_update, closure_in_block), "heat3d": (heat3d,)}
    for kernel, wrappers in paths.items():
        dims = problems.LARGE_SHAPES[kernel]
        args = problems.problem_inputs(kernel, dims, dev)
        space = kernel_space(kernel, "gpu", seed=FLEET["seed"])
        cands = space.sample_configurations(FLEET["candidates"],
                                            np.random.default_rng(FLEET["seed"]))
        verdicts = {config_key(c): (c, check_config(kernel, c, dims=dims, target="gpu"))
                    for c in cands}
        accepted = [(c, v) for c, v in verdicts.values() if v.ok]
        picks = sorted(accepted, key=lambda cv: not cv[1].warnings)[:FLEET["launch_configs"]]
        plains = {}
        for cfg, verdict in picks:
            key, plain, tol = plain_of(kernel, args, dims, dict(ops.DEFAULTS[kernel], **cfg))
            got, n = counted(wrappers, lambda: run_op(kernel, args, dims, cfg))
            if key not in plains:
                plains[key] = plain()
            if min(n.values()) < 1:
                raise AssertionError(f"{kernel} {cfg}: accepted by gpu, launches {n}")
            warned = ",".join(f.code for f in verdict.warnings) or "none"
            compare(f"{kernel} at LARGE, gpu-accepted {cfg} (warned: {warned}); launches "
                    f"{n}", got, plains[key], tol)
        print(f"  (d) {kernel}: {len(accepted)} of {len(verdicts)} sampled configs accepted "
              f"by gpu, {sum(bool(v.warnings) for _, v in accepted)} of them warned; "
              f"{len(picks)} launched", flush=True)
    print(f"  (d) accepted implies launches: {time.perf_counter() - t0:.1f} s", flush=True)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analyze_cli.main(["lint", "--json"])
    lint = json.loads(buf.getvalue())
    port = os.path.realpath(os.path.join(SRC, "repro_torch"))
    if rc or lint["n_findings"] or os.path.realpath(lint["paths"][0]) != port:
        raise AssertionError(f"launch.analyze lint: rc {rc}, {lint}")
    print(f"  (d) launch.analyze lint {lint['paths'][0]}: exit {rc}, "
          f"{lint['n_findings']} findings", flush=True)
    print(f"  phase 15: {time.perf_counter() - t15:.1f} s", flush=True)


def spawn(argv: list[str], log: str, **env_vars) -> subprocess.Popen:
    """A CPU-side subprocess of phase 16 from the repository's root (the
    port's package and the benchmarks importable), its output to ``log``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, ROOT]), **env_vars)
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT)


def finished(proc: subprocess.Popen, log: str, what: str, timeout: float = 600) -> str:
    """Wait for ``proc`` and return its output (without torch's warning lines);
    raise with the output's end if it failed."""
    rc = proc.wait(timeout=timeout)
    with open(log) as f:
        out = "".join(ln for ln in f if not ln.startswith("[rank0]:W"))
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}:\n{out[-3000:]}")
    return out


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def dtensor_step(dev) -> None:
    """Phase 16 (b): phase 12's step with DTensor params on the card's own
    mesh against the plain step, and the counted cost of a plain step."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.models import init_params, trainable
    from repro_torch.parallel import Spec, batch_specs, distribute, make_profile, param_specs
    from repro_torch.parallel.sharding import named
    from repro_torch.perf.op_cost import trace_step
    from repro_torch.perf.roofline import analyze_step, hardware
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    a = TRAIN
    cfg = dataclasses.replace(get_config(a["arch"]), dtype=torch.float32)
    params = trainable(init_params(cfg, torch.Generator(device=dev).manual_seed(a["seed"])))
    n_params = sum(t.numel() for t in tree_leaves(params))
    stream = SyntheticLM(cfg.vocab_size, a["seq"], a["batch"], seed=a["seed"])
    batches = [make_batch(stream, s, dev) for s in range(DTENSOR_STEPS)]
    step_p = make_train_step(cfg, lr=a["lr"])
    with local_mesh(dev) as mesh:
        prof = make_profile(mesh, "train", a["batch"])
        p_specs = param_specs(params, mesh, prof, cfg)
        params_d = distribute(tree_map(torch.clone, params), mesh, p_specs)
        opt_d = distribute(init_train_state(params), mesh,
                           {"m": p_specs, "v": p_specs, "step": Spec()})
        act = named(mesh, Spec(prof.batch_axes, None, None))
        logits = named(mesh, Spec(prof.batch_axes, None, "model"))
        step_d = make_train_step(cfg, lr=a["lr"], act_spec=act, logits_spec=logits)
        print(f"  local mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} over "
              f"{torch.distributed.get_backend()}, world {torch.distributed.get_world_size()}; "
              f"embed placed {params_d['embed'].placements}, act_spec {act}, "
              f"logits_spec {logits}", flush=True)
        opt_p = init_train_state(params)
        ms = {"plain": [], "dtensor": []}
        for i, b in enumerate(batches):
            b_d = distribute(b, mesh, batch_specs(b, mesh, prof))
            losses = {}
            for name, run in (("plain", lambda: step_p(params, opt_p, b)),
                              ("dtensor", lambda: step_d(params_d, opt_d, b_d))):
                sync(dev)
                t0 = time.perf_counter()
                _, _, m = run()
                loss = m["loss"]
                losses[name] = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                                     else loss)
                sync(dev)
                ms[name].append((time.perf_counter() - t0) * 1e3)
            rel = abs(losses["dtensor"] - losses["plain"]) / abs(losses["plain"])
            print(f"  step {i}: loss plain {losses['plain']:.7f} dtensor "
                  f"{losses['dtensor']:.7f} (rel {rel:.2e}, tol {DTENSOR_LOSS_RTOL:g}); ms "
                  f"plain {ms['plain'][-1]:.1f} dtensor {ms['dtensor'][-1]:.1f}", flush=True)
            if not rel <= DTENSOR_LOSS_RTOL:
                raise AssertionError(f"phase 16: the DTensor step's loss is {rel:.2e} off "
                                     f"the plain step's")
        del params_d, opt_d
    steady = {k: statistics.median(v[1:]) for k, v in ms.items()}
    print(f"  ms a step after the first: plain {steady['plain']:.1f}, DTensor on the local "
          f"mesh {steady['dtensor']:.1f} ({steady['dtensor'] / steady['plain']:.3f}x)",
          flush=True)
    sync(dev)
    t0 = time.perf_counter()
    trace = trace_step(step_p, params, opt_p, batches[0])
    sync(dev)
    counted_ms = (time.perf_counter() - t0) * 1e3
    hw = hardware(torch.float32)
    rep = analyze_step(trace.cost, 1, trace.peak_bytes, None, hw)
    closed = train_flops(cfg, n_params, a["batch"], a["seq"])
    print(f"  trace_step of one plain step ({trace.ops} ops, {counted_ms:.0f} ms with the "
          f"counter on): {trace.cost.flops:.4e} FLOPs (closed form {closed:.4e}, "
          f"{trace.cost.flops / closed:.3f}x), {trace.cost.bytes:.4e} bytes, collectives "
          f"{trace.collectives.summary()}", flush=True)
    print(f"  roofline on {hw.name} (f32 FFMA {hw.peak_flops:.3g} FLOP/s, HBM "
          f"{hw.hbm_bw:.3g} B/s): compute {rep.compute_sec * 1e3:.1f} ms, memory "
          f"{rep.memory_sec * 1e3:.1f} ms -> bound {rep.bound_sec * 1e3:.1f} ms "
          f"({rep.dominant}) against {steady['plain']:.1f} ms measured "
          f"({rep.bound_sec * 1e3 / steady['plain']:.2f} of it)", flush=True)
    if not math.isfinite(trace.cost.flops) or trace.cost.flops < closed * 0.8:
        raise AssertionError(f"phase 16: counted FLOPs {trace.cost.flops:.4e} below the "
                             f"closed form {closed:.4e}")


def compression_on_card(dev) -> None:
    """Phase 16 (c): compressed_psum over NCCL with each payload, the wire
    dtype read from the counted c10d call."""
    import torch
    import torch.distributed as dist

    from repro_torch.ft.compression import compressed_psum
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.perf.op_cost import trace_step

    x = torch.randn(1 << 20, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    with local_mesh(dev):
        for name, dtype in (("f32", None), ("bf16", torch.bfloat16), ("int8", torch.int8)):
            if dtype is None:
                def fn(v):
                    v = v.clone()
                    dist.all_reduce(v)
                    return v
            else:
                def fn(v, dtype=dtype):
                    return compressed_psum(v, dtype=dtype)
            tr = trace_step(fn, x)
            y = tr.result
            sync(dev)
            err = float((y - x).abs().max())
            wire = tr.payload_dtypes.get("all-reduce", [])
            want = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}[name]
            bound = {"f32": 0.0, "bf16": float(x.abs().max()) * 2 ** -8,
                     "int8": float(x.abs().max()) / 127 * 0.5 + 1e-6}[name]
            print(f"  compressed_psum {name} over NCCL (world 1): wire dtypes {wire}, "
                  f"all-reduce {tr.cost.coll_by_kind.get('all-reduce', 0) / x.numel():.4f} "
                  f"B/value, max |psum - x| {err:.3e} (bound {bound:.3e})", flush=True)
            if want not in wire or err > bound:
                raise AssertionError(f"phase 16: compressed_psum {name}: wire {wire}, "
                                     f"error {err:.3e}")


def phase16_dir() -> str:
    return os.path.join(os.environ.get("CHIP_SMOKE_OUT", os.path.join(ROOT, "build")),
                        "phase16")


def hillclimb_start() -> dict:
    """Phase 16 (d)'s hillclimb, started early: the probe and the campaign
    at full width and full depth in CPU subprocesses (their evaluations in
    worker processes), which run beside phases 10-13 and are joined before
    phase 14's timed gates (:func:`hillclimb_join`); phase 16 reads them.
    Every process they start is stopped when this script exits."""
    import atexit
    import glob

    out = phase16_dir()
    os.makedirs(out, exist_ok=True)
    for f in glob.glob(os.path.join(out, "*.json")):
        os.remove(f)
    h = HILLCLIMB
    side = {
        "probe": spawn(["-m", "benchmarks.torch_hillclimb", "--arch", h["arch"], "--shape",
                        h["shape"], "--probe", "--parallel", str(h["probe_parallel"]),
                        "--out", os.path.join(out, "hillclimb_probe.json")],
                       os.path.join(out, "probe.log")),
        "campaign": spawn(["-m", "benchmarks.torch_hillclimb", "--arch", h["arch"],
                           "--shape", h["shape"], "--evals", str(h["evals"]), "--parallel",
                           str(h["campaign_parallel"]), "--out",
                           os.path.join(out, "hillclimb.json")],
                          os.path.join(out, "campaign.log")),
    }
    side["t0"] = time.perf_counter()

    def stop():
        for proc in (side["probe"], side["campaign"]):
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    print(f"  phase 16 (d): the hillclimb's probe and campaign ({h['arch']} {h['shape']}, "
          f"full width and full depth) start in CPU subprocesses beside phases 10-13",
          flush=True)
    return side


def hillclimb_join(side: dict) -> None:
    """Wait for the hillclimb's subprocesses (before phase 14's timed gates)."""
    t = time.perf_counter()
    for what in ("probe", "campaign"):
        side[what].wait(timeout=900)
    now = time.perf_counter()
    print(f"  phase 16 (d): the hillclimb's subprocesses ended {now - side['t0']:.1f} s "
          f"after they started ({now - t:.1f} s waited for here)", flush=True)


def parallel_phase(launches: dict, dev, hill: dict) -> None:
    """Phase 16: the dry-run at the production meshes, the card's own mesh,
    compression and the knobs' hillclimb (see the module docstring; the
    hillclimb ran beside phases 10-13, ``hill``). No kernel of the table is
    on this path: its launch counts (0) are added to ``launches``."""
    from repro_torch.kernels import (
        covariance,
        decode_attention,
        flash_attention,
        floyd_warshall,
        heat3d,
        lu,
        matmul,
        syr2k,
    )

    wrappers = [syr2k.syr2k, matmul.tiled_matmul, covariance.covariance,
                floyd_warshall.minplus_update, floyd_warshall.closure_in_block, heat3d.heat3d,
                lu.lu_factor_diag, flash_attention.flash_attention,
                decode_attention.decode_attention]
    for w in wrappers:
        w.launches = 0
    t16 = time.perf_counter()
    out = phase16_dir()
    probe_json = os.path.join(out, "hillclimb_probe.json")
    side = {
        "probe": hill["probe"], "campaign": hill["campaign"],
        "compression": spawn(["-m", "benchmarks.torch_compression_bench", "--out",
                              os.path.join(out, "compression.json")],
                             os.path.join(out, "compression.log")),
    }
    cells, running = list(DRYRUN_CELLS), []

    def top_up():
        while cells and sum(p.poll() is None for *_, p in running) < DRYRUN_PROCS:
            arch, shape, mp = cells.pop(0)
            name = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
            log = os.path.join(out, f"dryrun_{name}.log")
            running.append((name, log, time.perf_counter(), spawn(
                ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                 *(["--multi-pod"] if mp else []), "--force", "--out",
                 os.path.join(out, f"dryrun_{name}.json")], log)))

    try:
        parallel_parts(dev, out, side, cells, running, top_up, probe_json)
    finally:  # stop every subprocess this phase started, also when a part failed
        for proc in [*side.values(), *(p for *_, p in running)]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    counts = {w.__name__: w.launches for w in wrappers}
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    print(f"  launches over phase 16: {counts} (no kernel of the table on this path)")
    print(f"  phase 16: {time.perf_counter() - t16:.1f} s", flush=True)


def parallel_parts(dev, out: str, side: dict, cells: list, running: list, top_up,
                   probe_json: str) -> None:
    """Phase 16's parts in order, while the subprocesses run."""
    import glob
    import json as _json

    h = HILLCLIMB
    top_up()
    print("  (b) phase 12's step on the card's own mesh, DTensor against plain "
          "(the dry-run's subprocesses run meanwhile)", flush=True)
    dtensor_step(dev)
    print("  (c) compression on the card", flush=True)
    compression_on_card(dev)
    print("  (a) the dry-run at the production meshes (CPU subprocesses, fake worlds of "
          "256 / 512 ranks; rows traced without the card's compute, with its memory)",
          flush=True)
    i = 0
    while i < len(running) or cells:
        top_up()
        name, log, t0, proc = running[i]
        text = finished(proc, log, f"dryrun {name}")
        rows = [ln for ln in text.splitlines() if ln.startswith("[ok]") or
                ln.startswith("[error]") or ln.startswith("[skipped]")]
        print(f"  {rows[-1] if rows else text[-400:]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        i += 1
    merged = []
    for f in sorted(glob.glob(os.path.join(out, "dryrun_*.json"))):
        with open(f) as fh:
            merged += _json.load(fh)
    bad = [r for r in merged if r["status"] != "ok"]
    if bad or len(merged) != len(DRYRUN_CELLS):
        raise AssertionError(f"phase 16: dry-run rows not ok: {bad}")
    kinds = {r["shape"].split("_")[0] for r in merged}
    meshes = {r["mesh"] for r in merged}
    if not ({"train", "prefill", "decode"} <= kinds and {"16x16", "2x16x16"} <= meshes):
        raise AssertionError(f"phase 16: the dry-run covers kinds {kinds}, meshes {meshes}")
    table = os.path.join(out, "dryrun_torch.json")
    with open(table, "w") as fh:
        _json.dump(merged, fh, indent=1)
    for mesh in ("16x16", "2x16x16"):
        text = finished(spawn(["-m", "benchmarks.torch_roofline_table", mesh],
                              os.path.join(out, f"table_{mesh}.log"),
                              REPRO_TORCH_DRYRUN_JSON=table),
                        os.path.join(out, f"table_{mesh}.log"), "roofline_table")
        print(f"  benchmarks/torch_roofline_table.py {mesh} (H100 figures):")
        print("\n".join("    " + ln for ln in text.splitlines()), flush=True)
    print("  (c) benchmarks/torch_compression_bench.py (fake world of 8):", flush=True)
    text = finished(side["compression"], os.path.join(out, "compression.log"), "compression")
    print("\n".join("    " + ln for ln in text.splitlines()), flush=True)
    with open(os.path.join(out, "compression.json")) as fh:
        per = {k: v["bytes_per_param"] for k, v in _json.load(fh).items()}
    if not (3.9 < per["f32"] < 4.1 and 1.9 < per["bf16"] < 2.1 and 0.9 < per["int8"] < 1.1):
        raise AssertionError(f"phase 16: compression bytes per parameter {per}")
    print("  (d) benchmarks/torch_hillclimb.py --probe and a campaign through "
          "CostModelEvaluator (full width, full depth; evaluations in worker processes):",
          flush=True)
    for what, payload in (("probe", probe_json), ("campaign",
                                                  os.path.join(out, "hillclimb.json"))):
        log = os.path.join(out, f"{what}.log")
        text = finished(side[what], log, f"hillclimb {what}")
        print("\n".join("    " + ln for ln in text.splitlines()[-8:]), flush=True)
        with open(payload) as fh:
            failed = [r for r in _json.load(fh)["log"] if "error" in r]
        if failed:  # a configuration that cannot be traced is a fault of the port
            raise AssertionError(f"phase 16: hillclimb {what}: {failed[0]['error']}")
    text = finished(spawn(["-m", "benchmarks.torch_flash_adjust", "--arch", h["arch"],
                           "--hillclimb-json", probe_json, "--out",
                           os.path.join(out, "flash_adjust.json")],
                          os.path.join(out, "flash_adjust.log")),
                    os.path.join(out, "flash_adjust.log"), "flash_adjust")
    print("  benchmarks/torch_flash_adjust.py on the probe's baseline:")
    print("\n".join("    " + ln for ln in text.splitlines()), flush=True)


def bf16_matmul_checks(dev, errs: dict) -> None:
    """Phase 17 (a): the bf16 matmul against its plain version at the
    served product shapes and two ragged ones: every bk of GPU_TILES_K, each
    under four tiles that between them take pack on and off, either raster
    order and out f32 and bf16 (rows past 8: the tensor cores). bf16 outputs
    at phase 3's bf16 tolerance, f32 ones at its f32 tolerance (the products
    of bf16 operands are exact in f32 on both sides: only the sums' order
    differs)."""
    import torch

    from repro_torch.kernels.matmul import tiled_matmul, tiled_matmul_plain
    from repro_torch.kernels.spaces import GPU_TILES_K

    t0 = time.perf_counter()
    tiles = ((64, 64, True, False, torch.bfloat16), (128, 128, False, True, torch.float32),
             (40, 96, True, True, torch.float32), (128, 64, False, False, torch.bfloat16))
    n, worst, largest = 0, 0.0, 0.0
    for label, (M, K, N) in BF16_MATMUL_SHAPES:
        a, b = (t.bfloat16() for t in model_operands(M, K, N, dev, seed=7))
        for bk in GPU_TILES_K:
            for bm, bn, pack, inter, out in tiles:
                got = tiled_matmul(a, b, bm=bm, bn=bn, bk=bk, pack=pack, interchange=inter,
                                   out_dtype=out).float()
                want = tiled_matmul_plain(a, b, bk=min(bk, K), pack=pack,
                                          out_dtype=out).float()
                tol = BF16_TOL if out == torch.bfloat16 else F32_TOL
                diff = (got - want).abs()
                share = float((diff / (tol["atol"] + tol["rtol"] * want.abs())).max())
                if not torch.isfinite(got).all() or not share <= 1.0:
                    raise AssertionError(
                        f"bf16 matmul {label} ({M}, {K}) @ ({K}, {N}) bm={bm} bn={bn} bk={bk} "
                        f"pack={pack} interchange={inter} out {out}: {share:.3g} of the "
                        f"tolerance")
                worst, largest, n = max(worst, share), max(largest, float(diff.max())), n + 1
        print(f"  bf16 matmul {label} ({M}, {K}) @ ({K}, {N}): {len(GPU_TILES_K)} chunks x "
              f"{len(tiles)} tiles agree with the plain version", flush=True)
    torch.cuda.synchronize()
    errs["matmul_bf16"] = largest
    print(f"  bf16 matmul: {n} launches against the plain version, largest error "
          f"{largest:.3e} ({worst:.3f} of the tolerance), {time.perf_counter() - t0:.1f} s",
          flush=True)


def matmul_route_checks(dev, errs: dict) -> None:
    """Phase 17 (a): the matmul's split stream and wgmma route against the
    plain version. The split stream (rows 1, 4 and 8, f32 and bf16) at
    mixtral's output projection (its K split over a cluster) and whisper's
    unembed (N = 51,866: narrower loads, element stores): every column tile
    of the gpu space, each with another chunk, pack on, and two chunks with
    pack off, out in either dtype, each route reported; repeated calls
    bit-identical. The wgmma route at every tile past 8 rows of the gpu
    space, chunk 32, at a ragged shape. (tests/test_torch_gpu.py takes every
    tile with every chunk.) Phase 3's tolerances; the largest errors land in
    errs["matmul_split"] and errs["matmul_bf16"]."""
    import torch

    from repro_torch.kernels.matmul import tiled_matmul, tiled_matmul_plain
    from repro_torch.kernels.spaces import GPU_TILES, GPU_TILES_K

    t0 = time.perf_counter()

    def check(what, a, b, route, pack, bk, out, **cfg):
        before = dict(tiled_matmul.route_launches)
        got = tiled_matmul(a, b, bk=bk, pack=pack, out_dtype=out, **cfg).float()
        taken = [k for k, v in tiled_matmul.route_launches.items() if v != before[k]]
        want = tiled_matmul_plain(a, b, bk=min(bk, a.shape[1]), pack=pack,
                                  out_dtype=out).float()
        tol = BF16_TOL if out == torch.bfloat16 or (a.dtype == torch.bfloat16 and not pack) \
            else F32_TOL
        diff = (got - want).abs()
        if taken != [route] or not torch.isfinite(got).all() or \
                not bool((diff <= tol["atol"] + tol["rtol"] * want.abs()).all()):
            raise AssertionError(f"{what} {cfg} bk={bk} pack={pack} out {out}: route {taken}, "
                                 f"max_abs_err {float(diff.max()):.3e}")
        return float(diff.max())

    n, split_err, wg_err = 0, 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        other = torch.bfloat16 if dtype == torch.float32 else torch.float32
        for K, N in ((4096, 4096), (1280, 51866)):
            for M in (1, 4, 8):
                a, b = (t.to(dtype) for t in model_operands(M, K, N, dev, seed=M))
                for i, (bn, bk) in enumerate(zip(GPU_TILES, GPU_TILES_K)):
                    split_err = max(split_err, check(
                        f"split stream ({M}, {K}) @ ({K}, {N})", a, b, "split", True, bk,
                        (dtype, other)[i % 2], bm=64, bn=bn, interchange=bool(i % 3 == 0)))
                    n += 1
                for bk in (32, 256):
                    split_err = max(split_err, check(
                        f"split stream ({M}, {K}) @ ({K}, {N})", a, b, "split", False, bk,
                        dtype, bm=64, bn=64))
                    n += 1
                first = tiled_matmul(a, b, bm=64, bn=64, bk=32)
                if not all(torch.equal(tiled_matmul(a, b, bm=64, bn=64, bk=32), first)
                           for _ in range(3)):
                    raise AssertionError(f"split stream ({M}, {K}) @ ({K}, {N}): repeated "
                                         f"calls differ")
        print(f"  split stream, {dtype}: rows 1, 4, 8 at (., 4096) @ (4096, 4096) and "
              f"(., 1280) @ (1280, 51866), every column tile, repeated calls bit-identical",
              flush=True)
    a, b = (t.bfloat16() for t in model_operands(97, 136, 520, dev, seed=11))
    for bm in GPU_TILES[1:]:
        for i, bn in enumerate(GPU_TILES):
            wg_err = max(wg_err, check("wgmma (97, 136) @ (136, 520)", a, b, "wgmma", True,
                                       32, (torch.bfloat16, torch.float32)[i % 2], bm=bm,
                                       bn=bn, interchange=bool(i % 3 == 0)))
            n += 1
    torch.cuda.synchronize()
    errs["matmul_split"] = max(errs.get("matmul_split", 0.0), split_err)
    errs["matmul_bf16"] = max(errs["matmul_bf16"], wg_err)
    print(f"  the matmul's routes: {n} launches against the plain version, largest error "
          f"split {split_err:.3e}, wgmma {wg_err:.3e}, {time.perf_counter() - t0:.1f} s",
          flush=True)


def bf16_phase(launches: dict, dev, errs: dict, rows: dict) -> None:
    """Phase 17: the catalog in its own dtype on the card. The bf16 matmul
    against its plain version, then each of the catalog's ten configs
    served in bf16 (whisper through audio_serve, the others through
    serve_arch) and checked against the CPU, one after the other (the
    served model's tensors leave the card before the check's, and the next
    arch's, are drawn); the kernels line's matmul_bf16 row is mixtral's
    forward output projection."""
    import torch

    from repro_torch.configs import get_config

    t17 = time.perf_counter()
    bf16_matmul_checks(dev, errs)
    matmul_route_checks(dev, errs)
    mm_rows: dict = {}
    for arch, n_layers, check_layers in BF16_ARCHS:
        if get_config(arch).dtype != torch.bfloat16:
            raise AssertionError(f"{arch}: the catalog's dtype is {get_config(arch).dtype}")
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        if get_config(arch).family == "audio":
            cfg, g = audio_serve(launches, dev, BF16_SERVE, torch.bfloat16, n_layers, mm_rows)
        else:
            cfg, g = serve_arch(arch, launches, dev, BF16_SERVE, torch.bfloat16, n_layers,
                                mm_rows)
        released(arch, base, "the bf16 served run")
        if cfg.family == "moe":
            margins_of, margin_what = routing_margins, (
                f"gap between the k-th and (k+1)-th router probability (k = {cfg.top_k})")
        else:
            margins_of, margin_what = logit_margins, "gap between the top two logits"
        card_vs_cpu(arch, cfg, check_layers, g, dev, margins_of, margin_what, BF16_SERVE,
                    near_tie=BF16_LOGIT_REL[cfg.family], ssm_chunk=BF16_SERVE["check_chunk"])
        released(arch, base, "the bf16 card-against-CPU check")
        print(f"  {arch} bf16: {time.perf_counter() - t0:.1f} s", flush=True)
    rows["matmul_bf16"] = dict(mm_rows[("mixtral-8x7b", "forward output projection")])
    errs["matmul_bf16"] = max(errs["matmul_bf16"], rows["matmul_bf16"].pop("max_abs_err"))
    rows["matmul_split"] = dict(mm_rows[("mixtral-8x7b", "decode output projection")])
    errs["matmul_split"] = max(errs["matmul_split"], rows["matmul_split"].pop("max_abs_err"))
    print(f"  phase 17: {time.perf_counter() - t17:.1f} s", flush=True)


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
    from repro_torch.kernels.spaces import kernel_space
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
    # (tiles of at most 8 rows: the split stream, not the tensor cores)
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
    # the closure helper at every bs of the gpu space (one warp, one CTA, a
    # cluster of CTAs), at offsets on and off 16-byte words, between them,
    # and past the space (the block in global memory)
    fw_space = kernel_space("floyd_warshall")["bs"].sequence
    for off, bs in [(off, bs) for bs in fw_space for off in (0, 37, fw_n // 2 - 64, fw_n - bs)] \
            + [(3, 24), (fw_n // 3, 100), (8, 200), (5, 300)]:
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
    # f32 matmul, mm3 and lu cases above; the skinny rows run the split stream)
    for cls, (abs_err, share) in probe.items():
        print(f"  3xTF32 matmul probe, {cls} {globals()[cls]}: largest max_abs_err "
              f"{abs_err:.3e}, {share:.3f} of the tolerance", flush=True)
    if any(share > 1.0 for _, share in probe.values()):
        raise AssertionError("the 3xTF32 matmul misses a tolerance")
    # the diagonal-factor helper at every bs of the gpu space (one warp up to
    # 32, a row's threads within a warp past it), on and off 16-byte words,
    # between them, and past the space (the block in shared memory, up to
    # the 240 that fits it)
    lu_space_bs = kernel_space("lu")["bs"].sequence
    for off, bs in [(off, bs) for bs in lu_space_bs for off in (0, 37, lu_n // 2 - 64,
                                                                  lu_n - bs)] \
            + [(5, 12), (lu_n // 3, 48), (9, 100), (7, 192), (lu_n - 240, 240)]:
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
    # the call's device time by part: each block step factors the diagonal
    # block, solves the two panels (torch.linalg.solve_triangular), copies
    # them and updates the trailing block (matmul.cu)
    lu_parts = {"diagonal factors": [], "trailing updates": [], "triangular solves": [],
                "copies, fills and other": []}
    for name, ms in device_kernels_in_order(lambda: ops.lu_op(Alu)):
        if any(k in name for k in ("lu_warp_kernel", "lu_tile_kernel", "lu_smem_kernel")):
            lu_parts["diagonal factors"].append(ms)
        elif "matmul" in name:
            lu_parts["trailing updates"].append(ms)
        elif "trsm" in name or "triangular" in name:
            lu_parts["triangular solves"].append(ms)
        else:
            lu_parts["copies, fills and other"].append(ms)
    print(f"  lu device time by part (torch.profiler trace, one call, "
          f"{sum(map(len, lu_parts.values()))} device kernels): "
          + "; ".join(f"{k} x{len(v)} {sum(v):.4f} ms ({sum(v) / max(len(v), 1) * 1e3:.1f} us "
                      f"each)" for k, v in lu_parts.items()), flush=True)

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
        elif "closure" in name:
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

    # the helpers: bs dependent steps each, so beside the ops/bytes bound
    # the dependency floor (mma_rate.py's probe: an empty kernel plus bs
    # exchange steps of the helper's thread map, device durations under
    # torch.profiler as the helpers' own), at every bs of the gpu
    # spaces; each launch on a fresh copy of the block (the closure of a
    # closed block is as long, but an LU of an LU is not a fair input)
    sys.path.insert(0, ROOT)
    import mma_rate

    probe = mma_rate.dependency_floor()
    print(f"  dependency floor probe (mma_rate.py; device durations, torch.profiler): empty "
          f"kernel {probe['empty_kernel_us']:.3f} us; one exchange step "
          + ", ".join(f"{k} {v:.1f} ns" for k, v in probe["step_ns"].items()), flush=True)

    def helper_times(fn, block, bs, kernel_name, n=40):
        copies = [block.clone() for _ in range(n + 3)]
        for c in copies[:3]:
            fn(c, 0, bs)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for c in copies[3:]:
            fn(c, 0, bs)
        end.record()
        end.synchronize()
        ev = start.elapsed_time(end) / n
        _, by_name = device_time(lambda: [fn(block.clone(), 0, bs) for _ in range(n)])
        launched = [(c, t) for k, (c, t) in by_name.items() if kernel_name in k]
        dev_ms = sum(t for _, t in launched) / max(sum(c for c, _ in launched), 1)
        return ev, dev_ms

    def steps_of(name, bs):
        """The helper's dependent exchange steps at bs, by the probe's kinds:
        one warp's shuffles up to 32; past it one barrier a step among the
        CTA's threads, and at 256 a cluster barrier every 8 steps in place of
        a CTA's."""
        if bs <= 32:
            return {"warp shuffle": bs}
        if name == "lu_factor_diag":
            return {"512 threads": bs}
        if bs <= 128:
            return {"256 threads": bs}
        return {"256 threads": bs - bs // 8, "cluster of 8": bs // 8}

    helper_rows = {}
    for name, fn, space, src, kname, default_bs in (
            ("lu_factor_diag", lu_factor_diag, kernel_space("lu")["bs"].sequence, Alu, "lu_",
             lu_bs),
            ("closure", closure_in_block, kernel_space("floyd_warshall")["bs"].sequence, W,
             "closure", fw_bs)):
        for bs in space:
            blk = src[:bs, :bs].contiguous()
            ev, dev_ms = helper_times(fn, blk, bs, kname)
            floor = mma_rate.floor_ms(probe, steps_of(name, bs))
            if name == "closure":
                b_ms, b_by = bound(float(bs) ** 3, 4.0 * 2 * bs * bs, peak=PEAK_F32_MIN)
            else:
                b_ms, b_by = bound(2.0 / 3.0 * bs ** 3, 4.0 * 2 * bs * bs)
            print(f"  {name} helper bs={bs} ({steps_of(name, bs)}): {ev * 1e3:.2f} us a launch "
                  f"by CUDA events, {dev_ms * 1e3:.2f} us on the device (torch.profiler), "
                  f"{dev_ms * 1e6 / bs:.1f} ns a step; dependency floor {floor * 1e3:.2f} us "
                  f"(an empty kernel and those steps), {dev_ms / floor:.2f}x it; ops/bytes bound "
                  f"{b_ms:.6f} ms ({b_by})", flush=True)
            helper_rows[(name, bs)] = dict(ms=ev, device_ms=dev_ms, floor_ms=floor, bound_ms=b_ms,
                                           bound_by=b_by)
        blk = src[:default_bs, :default_bs].contiguous()
        r = helper_rows[(name, default_bs)]
        plain = lu_factor_diag_plain if name == "lu_factor_diag" else closure_plain
        rows[name] = dict(
            ms=r["ms"], plain_ms=time_ms(lambda: plain(blk)),
            library_ms=(time_ms(lambda: torch.linalg.lu_factor_ex(blk, pivot=False))
                        if name == "lu_factor_diag" else None),
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], dependency_floor_ms=r["floor_ms"])
        lib = "none" if rows[name]["library_ms"] is None else f"{rows[name]['library_ms']:.4f} ms"
        print(f"  {name} helper at the default bs={default_bs}: kernel {r['ms']:.4f} ms, "
              f"dependency floor {r['floor_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}), plain {rows[name]['plain_ms']:.4f} ms, library {lib}",
              flush=True)

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

    launches, phase5 = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for kernel, evals in CAMPAIGNS:
            db = os.path.join(tmp, kernel)
            wrappers = paths[kernel]
            for w in wrappers:
                w.launches = 0
            summary = phase5[kernel] = run_campaign(kernel, evals, db)
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
    phase6_ms = serving(launches, dev)

    # ---- 7. the tuning loop --------------------------------------------------------
    phase("7. tuning loop: autotune publishes to the store serving reads, misses tune in "
          "the background, the guard times on the card")
    tuning_loop(launches, dev, (C, A, B), phase6_ms)

    # ---- 8. the multi-fidelity cascade ------------------------------------------------
    phase("8. the multi-fidelity cascade: the Hopper cost model's rank audit, "
          "autotune --cascade, a background cascade")
    cascade_phase(launches, dev, (C, A, B), phase5["syr2k"])

    # ---- 9. the paper's tables -------------------------------------------------------
    phase("9. the paper's tables on the card: Tables 1-7 at LARGE and the four-learner "
          "study (benchmarks/torch_tables.py, benchmarks/torch_learners.py)")
    tables_phase(launches, best_check)

    hill = hillclimb_start()

    # ---- 10. the MoE family ----------------------------------------------------------
    phase("10. the MoE family on the card: mixtral-8x7b and deepseek-v2-236b at full width, "
          "depth cut, f32, through greedy_decode and the dispatch service")
    moe_phase(launches, dev)

    # ---- 11. the SSM, hybrid and VLM families -------------------------------------------
    phase("11. the SSM, hybrid and VLM families on the card: mamba2-780m, zamba2-1.2b (7 "
          "layers) and qwen2-vl-7b at full width, f32, through greedy_decode and the "
          "dispatch service")
    ssm_phase(launches, dev)

    # ---- 12. training ---------------------------------------------------------------
    phase("12. training on the card: qwen2-0.5b at full width and full depth through "
          "repro_torch.launch.train, remat, card against CPU, mamba2 and mixtral steps, "
          "checkpoints")
    training_phase(launches, dev)

    # ---- 13. the audio family -----------------------------------------------------------
    phase("13. the audio family on the card: whisper-large-v3 at full width, f32, served "
          "through greedy_decode and the dispatch service at 2 + 2 layers, and trained")
    audio_phase(launches, dev)
    hillclimb_join(hill)

    # ---- 14. serving under load -----------------------------------------------------------
    phase("14. serving under load: benchmarks/torch_serve_bench.py at full width (einsum, "
          "default and tuned modes, the guard's drift loop), then gemma3-1b (6 layers), "
          "minitron-4b and qwen1.5-0.5b (2) at full width through launch.serve")
    load_phase(launches, dev)

    # ---- 15. the fleet and the analyzer ----------------------------------------------------
    phase("15. the fleet and the analyzer on the card: one host's campaign served by another "
          "with zero local evaluations (file and HTTP transports), a hot swap and a "
          "quarantine, launch.analyze space and lint")
    fleet_phase(launches, dev)

    # ---- 16. parallelism, the roofline and the dry-run ----------------------------------
    phase("16. parallelism, the roofline and the dry-run: launch.dryrun at the production "
          "meshes, phase 12's step as DTensors on the card's own mesh, compression over "
          "NCCL, the knobs' hillclimb")
    parallel_phase(launches, dev, hill)

    # ---- 17. the catalog in its own dtype -----------------------------------------------
    phase("17. the catalog in bf16 on the card: the matmul's bf16 wgmma route and split "
          "stream against its plain version, qwen2-0.5b, qwen2-vl-7b, mixtral-8x7b "
          "(16 layers), mamba2-780m, gemma3-1b, minitron-4b, qwen1.5-0.5b, zamba2-1.2b, "
          "whisper-large-v3 and deepseek-v2-236b (6 layers) served in bf16 at full width, the "
          "card against the CPU")
    bf16_phase(launches, dev, errs, rows)

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
        entry("matmul_bf16", "matmul.cu", "src/repro/kernels/matmul.py:34"),
        entry("matmul_split", "matmul.cu", "src/repro/kernels/matmul.py:34"),
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
