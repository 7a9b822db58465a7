"""Analytic cost model of the port's CUDA kernels on Hopper — rung 0 of the
fidelity ladder (:mod:`repro_torch.fidelity`), the counterpart of
``repro.kernels.cost``, which models the Pallas kernels on a TPU v5e.

For a configuration at given problem dims the model derives, from what the
CUDA kernels and their drivers do:

  * **feasibility**: the kernel's own shared memory per block
    (``*_smem_bytes``, through
    :func:`repro_torch.analyze.feasibility.smem_needs`, the numbers
    ``SmemBudget`` and the wrappers refuse on) against the card's per-block
    limit; +inf with ``info["infeasible"]`` where it does not fit. Like
    ``SmemBudget`` this needs the built library, so without a card nothing
    is refused;
  * **compute**: each launch's work over the peak of the route it takes
    (f32 FFMA on the CUDA cores; for the matmul past 8 rows, ``csrc/matmul.cu``,
    3xTF32 on ``mma.sync`` in f32 and the bf16 peak on ``wgmma`` or
    ``mma.sync``, its split stream of at most 8 rows on the CUDA cores;
    FMNMX+FADD for min-plus), on the tile padded to ``ALIGN = 8``
    (``csrc/gemm_f32.cuh``; ``mma.sync`` to its 32 x 32 warp pieces,
    ``wgmma`` to 64), in waves of blocks over the SMs: the
    blocks an SM holds are set by shared memory, threads (2,048 an SM) and
    32 blocks, and a block gets the smaller of its share of the SM and the
    lanes its threads fill (128 an SM);
  * **memory**: the bytes the tile schedule moves — every tile's A and B
    panels through L2, and from HBM the operands once where they fit in L2
    together, else as streamed;
  * **launches**: each launch costs :data:`LAUNCH_SEC` (the host's share of
    a launch from Python), counted by running the driver's own code
    (``kernels/lu.py``, ``floyd_warshall.py``, ``m3mm.py``) on meta tensors;
    heat3d's passes go out from one C loop and cost :data:`PASS_SEC` each.

Modeled seconds = max(compute, memory) + launch terms. The numbers are a
ranking model: rung 0 only has to order configurations as the card does
(``python -m repro_torch.launch.fidelity audit`` measures how well it
does), calibration maps its scale onto measured seconds.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.ops import config_of
from repro_torch.kernels.util import cdiv

__all__ = ["Hopper", "H100_SXM5", "hopper", "kernel_cost", "KERNEL_COST_FNS",
           "matmul_route", "matmul_splits",
           "FFMA_FLOPS", "TF32X3_FLOPS", "BF16_FLOPS", "MINMAX_OPS", "HBM_BYTES_PER_SEC",
           "HBM_BYTES", "NVLINK_BYTES_PER_SEC",
           "L2_BYTES_PER_SEC", "LAUNCH_SEC", "PASS_SEC"]

# the H100 SXM5's peaks, the bounds' figures (PERF.md): f32 FFMA on the CUDA
# cores, f32 products in 3xTF32 on the tensor cores (a third of the TF32
# mma.sync rate), FMNMX+FADD pairs (min-plus), HBM3
FFMA_FLOPS = 67e12
TF32X3_FLOPS = 165e12
MINMAX_OPS = 16.75e12
HBM_BYTES_PER_SEC = 3.35e12
# the figures of a model step's three-term bound (the ``perf`` package),
# from NVIDIA's H100 SXM5 data sheet: the dense bf16 tensor-core peak (989 TFLOP/s, no
# sparsity), the card's 80 GB (the card's own total_memory replaces it at
# run time), and NVLink's 900 GB/s a card, both directions together: 450 GB/s
# a direction
BF16_FLOPS = 989e12
HBM_BYTES = 80e9
NVLINK_BYTES_PER_SEC = 4.5e11  # 450 GB/s
# model parameters, not measured peaks: L2's read rate (about 5.5 TB/s on
# an H100 by public microbenchmarks); the host's share of one launch issued
# from Python (lu's 410 device kernels a call take 7.5-10.5 ms, about 18 us
# each, PERF.md section 5), and of one pass of heat3d's C loop (about an
# empty launch's gap, 3 us)
L2_BYTES_PER_SEC = 5.5e12
LAUNCH_SEC = 18e-6
PASS_SEC = 3e-6
# a step of the single-block helpers' dependency chain (lu's diagonal
# factor, the in-block closure; on an H100 an LU row step takes 224 ns and
# the closure at bs 64 8.3 us, PERF.md)
HELPER_STEP_SEC = 0.2e-6
# an operand the syr2k/matmul inner loop reads from global memory instead of
# staging it (pack off) crosses L2 about this many times more often (L1
# catches part of the re-reads of a block's threads)
UNSTAGED_REREAD = 2.0

_F32 = 4
ALIGN = 8           # csrc/gemm_f32.cuh: tile extents padded to multiples of 8
TC_PIECE = 32       # csrc/matmul.cu: mma.sync warps hold 32 x 32 pieces
# csrc/matmul.cu: the mma's k (m16n8k8 TF32 for f32 operands, m16n8k16 for
# bf16), the multiple an mma.sync chunk is padded to
MMA_K = {4: 8, 2: 16}
# csrc/matmul.cu's wgmma route (bf16 past 8 rows, pack=True, K and N
# multiples of 8): rows pad to 64 a warpgroup (64 or 128), columns to the
# instruction's N (64 or 128); a chunk is bk rounded up to 16 k of the
# operands (no zeros), so only K's last chunk pads
WG_ROWS = 64
WG_COLS = 64
WG_K = 16
# csrc/matmul.cu's split route (tiles of at most 8 rows): 128 threads a
# block, each 16 bytes of columns; up to SPLIT_MAX CTAs a column tile, each
# at least SPLIT_MIN_KC of K, chosen for the least waves x (a CTA's share of
# the tile's bytes + SPLIT_FIXED_BYTES); the model takes SPLIT_SLOTS_PER_SM
# CTAs an SM (the kernel reads its occupancy on the card: 4-5 a SM, clusters
# of 8 packing 496 of 528 places on an H100)
SPLIT_THREADS = 128
SPLIT_MAX = 8
SPLIT_MIN_KC = 64
SPLIT_FIXED_BYTES = 32768
SPLIT_SLOTS_PER_SM = 4
LANES_PER_SM = 128  # FP32 lanes (4 schedulers x 32)
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
SMEM_RESERVED = 1024  # shared memory the runtime keeps per block


@dataclasses.dataclass(frozen=True)
class Hopper:
    """What the model knows of the card."""

    name: str
    sms: int
    smem_per_block: int   # opt-in dynamic shared memory one block may use
    smem_per_sm: int
    l2_bytes: int
    ffma_flops: float = FFMA_FLOPS
    tf32x3_flops: float = TF32X3_FLOPS
    minmax_ops: float = MINMAX_OPS
    hbm_bytes_per_sec: float = HBM_BYTES_PER_SEC
    bf16_flops: float = BF16_FLOPS
    hbm_bytes: float = HBM_BYTES
    nvlink_bytes_per_sec: float = NVLINK_BYTES_PER_SEC
    l2_bytes_per_sec: float = L2_BYTES_PER_SEC
    launch_sec: float = LAUNCH_SEC
    pass_sec: float = PASS_SEC

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# without a card: the H100 SXM5's (132 SMs, 227 KB opt-in shared memory a
# block of 228 KB an SM, 50 MB L2)
H100_SXM5 = Hopper(name="NVIDIA H100 SXM5 (model defaults)", sms=132,
                   smem_per_block=227 * 1024, smem_per_sm=228 * 1024,
                   l2_bytes=50 * 1024 * 1024)


@functools.lru_cache(maxsize=8)
def _card(index: int) -> Hopper:
    from repro_torch.kernels.util import max_shared_memory_per_block

    props = torch.cuda.get_device_properties(index)
    return dataclasses.replace(
        H100_SXM5, name=props.name, sms=int(props.multi_processor_count),
        smem_per_block=max_shared_memory_per_block(torch.device("cuda", index)),
        smem_per_sm=int(getattr(props, "shared_memory_per_multiprocessor",
                                H100_SXM5.smem_per_sm)),
        l2_bytes=int(getattr(props, "L2_cache_size", H100_SXM5.l2_bytes)),
        hbm_bytes=float(props.total_memory))


def hopper() -> Hopper:
    """The current card's description, or :data:`H100_SXM5` without one."""
    if torch.cuda.is_available():
        return _card(torch.cuda.current_device())
    return H100_SXM5


# ---------------------------------------------------------------------------
# one launch: waves of blocks, the route's peak, the bytes it moves
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Launch:
    blocks: int          # blocks that do the work
    threads: int         # threads a block
    work: float          # operations of the padded tiles, all blocks
    peak: float          # the route's rate (operations/s)
    hbm: float           # bytes from and to HBM
    l2: float            # bytes through L2
    smem: int | None = None   # shared memory a block (None: not known here)
    tensor_cores: bool = False
    draw: float = 1.0    # share of HBM's rate its blocks can draw
    count: int = 1       # identical launches in a row


def _launch_sec(hw: Hopper, ln: _Launch) -> float:
    """max(compute, memory) of one launch, times its count."""
    per_sm = THREADS_PER_SM // max(ln.threads, 1)
    if ln.smem is not None and ln.smem > 0:
        per_sm = min(per_sm, hw.smem_per_sm // (ln.smem + SMEM_RESERVED))
    per_sm = max(1, min(per_sm, BLOCKS_PER_SM))
    resident = min(per_sm, cdiv(max(ln.blocks, 1), hw.sms))
    waves = cdiv(max(ln.blocks, 1), hw.sms * per_sm)
    sm_rate = ln.peak / hw.sms
    # a block's share of its SM: 1/resident, or what its threads fill
    # (tensor cores: one per scheduler, a warp each)
    fill = (cdiv(ln.threads, 32) / 4) if ln.tensor_cores else ln.threads / LANES_PER_SM
    block_rate = sm_rate * min(1.0 / resident, fill)
    compute = waves * (ln.work / max(ln.blocks, 1)) / block_rate
    memory = max(ln.hbm / (hw.hbm_bytes_per_sec * ln.draw), ln.l2 / hw.l2_bytes_per_sec)
    return ln.count * max(compute, memory)


def _pad(x: int, m: int) -> int:
    return cdiv(x, m) * m


def _reg_tile(pm: int, pn: int) -> int:
    """csrc/gemm_f32.cuh's reg_tile: 8 x 8 accumulators a thread past 64."""
    return 8 if (pm > 64 or pn > 64) else 4


def _lower_tiles(n: int, bi: int, bj: int) -> int:
    """Tiles of an n x n output on or below the diagonal: the blocks of the
    symmetric kernels (syr2k, covariance) that work; the rest exit at once."""
    return sum(min(cdiv(min((ti + 1) * bi, n), bj), cdiv(n, bj))
               for ti in range(cdiv(n, bi)))


def _operands_hbm(hw: Hopper, operands: float, streamed: float) -> float:
    """Operands that fit in L2 together cross HBM once, else as streamed."""
    return operands if operands <= hw.l2_bytes else max(operands, streamed)


def _ffma_gemm(hw, *, M, N, K, bm, bn, bk, smem, out_bytes, extra_hbm=0.0,
               unstaged_a=False, unstaged_b=False, tiles=None, products=1,
               in_bytes=_F32):
    """An FFMA tile product (syr2k, covariance): the tile padded to ALIGN,
    RT x RT accumulators a thread, K in bk chunks, ``products`` multiply-adds
    a term, operands of ``in_bytes`` an element."""
    pm, pn = _pad(bm, ALIGN), _pad(bn, ALIGN)
    rt = _reg_tile(pm, pn)
    threads = (pm // rt) * (pn // rt)
    kp = cdiv(K, bk) * bk
    mi, nj = cdiv(M, bm), cdiv(N, bn)
    blocks = tiles if tiles is not None else mi * nj
    work = 2.0 * products * blocks * pm * pn * kp
    # every tile streams its A rows and B columns over K (clamped rows)
    a_panel = (M * nj if tiles is None else blocks * bm) * K * in_bytes
    b_panel = (N * mi if tiles is None else blocks * bn) * K * in_bytes
    stream = a_panel * (UNSTAGED_REREAD if unstaged_a else 1.0) \
        + b_panel * (UNSTAGED_REREAD if unstaged_b else 1.0)
    operands = (M + N) * K * in_bytes
    hbm = _operands_hbm(hw, operands, a_panel + b_panel) + M * N * out_bytes + extra_hbm
    return _Launch(blocks=blocks, threads=threads, work=work, peak=hw.ffma_flops,
                   hbm=hbm, l2=stream + M * N * out_bytes + extra_hbm, smem=smem)


def matmul_route(M: int, K: int, N: int, bm: int, pack: bool, in_bytes: int = _F32) -> str:
    """The route ``csrc/matmul.cu`` takes for a clamped tile (its
    ``matmul_launch``, operands assumed 16-byte aligned, as the port's
    tensors are): ``split`` for tiles of at most 8 rows, ``wgmma`` for bf16
    past 8 rows with pack on and K and N multiples of 8, else ``mma_sync``
    (the FFMA fallback of f32 128-row tiles with the deepest chunks is not
    modelled)."""
    if min(bm, max(M, 1)) <= ALIGN:
        return "split"
    if in_bytes == 2 and pack and K % 8 == 0 and N % 8 == 0:
        return "wgmma"
    return "mma_sync"


def matmul_splits(M: int, K: int, N: int, bm: int, bn: int, pack: bool, sms: int,
                  in_bytes: int = _F32) -> int:
    """CTAs the split route puts on one column tile (``csrc/matmul.cu``'s
    ``split::best_splits``, clamped tiles), with SPLIT_SLOTS_PER_SM CTAs an
    SM, 15/16 of them in clusters: 1 where the tiles fill half a wave or
    more of one wave, else the least waves x (a CTA's bytes + its fixed
    cost)."""
    tiles = cdiv(M, bm) * cdiv(N, bn)
    if not pack or SPLIT_SLOTS_PER_SM * sms <= 2 * tiles <= 2 * SPLIT_SLOTS_PER_SM * sms:
        return 1   # one wave, at least half full: unsplit
    tile_bytes = K * bn * in_bytes
    best, best_cost = 1, 0.0
    for s in range(1, max(1, min(SPLIT_MAX, K // SPLIT_MIN_KC)) + 1):
        slots = SPLIT_SLOTS_PER_SM * sms * (1 if s == 1 else 15) // (1 if s == 1 else 16)
        cost = cdiv(tiles * s, slots) * (tile_bytes / s + SPLIT_FIXED_BYTES)
        if s == 1 or cost < best_cost:
            best, best_cost = s, cost
    return best


def _matmul_launch(hw, M, K, N, bm, bn, bk, pack, smem, in_bytes=_F32):
    """One ``tiled_matmul`` launch (csrc/matmul.cu), its output in the
    operands' dtype (``in_bytes`` an element), on the route the kernel takes
    (:func:`matmul_route`): the split stream (CUDA cores; B's bytes read
    once a row tile, its K split over :func:`matmul_splits` CTAs; rows
    padded to 4 or 8, columns to a thread's 16 bytes), ``wgmma`` at the
    bf16 peak on its 64-row, 64-column padding, or ``mma.sync`` (f32 in
    3xTF32, the k chunk padded to 8; bf16 the chunk padded to 16);
    ``pack=False`` reads and writes the O tile once per bk chunk."""
    bm, bn, bk = min(bm, max(M, 1)), min(bn, max(N, 1)), min(bk, max(K, 1))
    rmw = 0.0 if pack else 2.0 * (cdiv(K, bk) - 1) * M * N * in_bytes
    mi, nj = cdiv(M, bm), cdiv(N, bn)
    operands = (M + N) * K * in_bytes
    out = M * N * in_bytes
    a_panel, b_panel = M * nj * K * in_bytes, N * mi * K * in_bytes
    route = matmul_route(M, K, N, bm, pack, in_bytes)
    if route == "split":
        splits = matmul_splits(M, K, N, bm, bn, pack, hw.sms, in_bytes)
        vw = 16 // in_bytes
        cg = cdiv(bn, vw)
        threads = cg * max(1, SPLIT_THREADS // cg)
        return _Launch(blocks=mi * nj * splits, threads=threads,
                       work=2.0 * mi * nj * (4 if bm <= 4 else ALIGN) * cg * vw * K,
                       peak=hw.ffma_flops,
                       hbm=_operands_hbm(hw, operands, a_panel + b_panel) + out + rmw,
                       l2=a_panel + b_panel + out + rmw, smem=smem)
    if route == "wgmma":
        pm, pn, kc = _pad(bm, WG_ROWS), _pad(bn, WG_COLS), _pad(bk, WG_K)
        return _Launch(blocks=mi * nj, threads=(pm // WG_ROWS) * 128 + 32,
                       work=2.0 * mi * nj * pm * pn * cdiv(K, kc) * kc, peak=hw.bf16_flops,
                       hbm=_operands_hbm(hw, operands, a_panel + b_panel) + out,
                       l2=a_panel + b_panel + out, smem=smem, tensor_cores=True)
    pm, pn = _pad(bm, TC_PIECE), _pad(bn, TC_PIECE)
    kp = cdiv(K, bk) * _pad(bk, MMA_K[in_bytes])
    return _Launch(blocks=mi * nj, threads=(pm // TC_PIECE) * (pn // TC_PIECE) * 32,
                   work=2.0 * mi * nj * pm * pn * kp,
                   peak=hw.tf32x3_flops if in_bytes == _F32 else hw.bf16_flops,
                   hbm=_operands_hbm(hw, operands, a_panel + b_panel) + out + rmw,
                   l2=a_panel + b_panel + out + rmw, smem=smem, tensor_cores=True)


# ---------------------------------------------------------------------------
# shared memory (the feasibility pass's numbers) and the result
# ---------------------------------------------------------------------------

def _smem(kernel: str, cfg: Mapping, dims: tuple,
          dtype=None) -> tuple[list | None, int | None]:
    """(parts, limit): :func:`~repro_torch.analyze.feasibility.smem_needs`
    for operands of ``dtype`` (None: unknown) on the card, (None, None)
    without one."""
    from repro_torch.analyze import feasibility

    limit = feasibility.smem_limit()
    if limit is None:
        return None, None
    if dtype is None:
        return feasibility.smem_needs(kernel, cfg, dims, limit), limit
    return feasibility.smem_needs(kernel, cfg, dims, limit, dtype), limit


def _infeasible(parts, limit) -> dict | None:
    from repro_torch.analyze.feasibility import smem_findings

    found = list(smem_findings(parts, limit)) if parts else []
    if not found:
        return None
    return {"infeasible": "smem", "reasons": sorted({f.code for f in found}),
            "smem_bytes": max(b for _, b in parts), "smem_limit": limit}


def _part(parts, i: int = 0) -> int | None:
    return None if not parts or i >= len(parts) else int(parts[i][1])


def _finish(hw: Hopper, launches: list[_Launch], *, flops: float, compulsory: float,
            peak: float, n_launches: int, parts, launch_sec: float | None = None,
            extra_sec: float = 0.0):
    """(modeled seconds, info): the launches' device time and ``extra_sec``
    (the helpers' dependency chains), plus ``n_launches`` at ``launch_sec``
    (default: the host's share of a launch from Python)."""
    device = sum(_launch_sec(hw, ln) for ln in launches) + extra_sec
    t = device + n_launches * (hw.launch_sec if launch_sec is None else launch_sec)
    return t, {
        "hbm_bytes": float(sum(ln.count * ln.hbm for ln in launches)),
        "smem_bytes": None if not parts else max(int(b) for _, b in parts),
        "flops": float(flops),
        # operations of the padded tiles the launches run (feasibility's
        # PaddingWaste reads it beside flops)
        "padded_work": float(sum(ln.count * ln.work for ln in launches)),
        "launches": int(n_launches),
        "modeled_sec": t,
        "device_sec": device,
        "compulsory_bytes": float(compulsory),
        "peak": float(peak),
    }


# ---------------------------------------------------------------------------
# the nine kernels (shape arguments as repro.kernels.cost's)
# ---------------------------------------------------------------------------

def syr2k_cost(cfg: Mapping, N: int, M: int, *, hw: Hopper | None = None, dtype=None):
    hw = hw or hopper()
    parts, limit = _smem("syr2k", cfg, (N, M))
    bad = _infeasible(parts, limit)
    if bad:
        return float("inf"), bad
    c = config_of("syr2k", cfg)
    bi, bj, bk = (min(int(c[k]), d) for k, d in (("bi", N), ("bj", N), ("bk", M)))
    # one product per mirrored pair: two FFMA a term on the working tiles
    ln = _ffma_gemm(hw, M=N, N=N, K=M, bm=bi, bn=bj, bk=bk, smem=_part(parts),
                    out_bytes=_F32, extra_hbm=N * N * _F32, products=2,
                    tiles=_lower_tiles(N, bi, bj), unstaged_a=not c["pack_a"],
                    unstaged_b=not c["pack_b"])
    flops = 2.0 * N * (N + 1) * M
    return _finish(hw, [ln], flops=flops, compulsory=(2 * N * M + 2 * N * N) * _F32,
                   peak=hw.ffma_flops, n_launches=1, parts=parts)


def covariance_cost(cfg: Mapping, N: int, M: int, *, hw: Hopper | None = None,
                    dtype=None):
    hw = hw or hopper()
    parts, limit = _smem("covariance", cfg, (N, M))
    bad = _infeasible(parts, limit)
    if bad:
        return float("inf"), bad
    c = config_of("covariance", cfg)
    bi, bj, bk = (min(int(c[k]), d) for k, d in (("bi", M), ("bj", M), ("bk", N)))
    fuse = bool(c["fuse_center"])
    # kernels/covariance.py: the mean, the centring pass unless fused, the kernel
    centre = 0.0 if fuse else 2.0 * N * M * _F32
    ln = _ffma_gemm(hw, M=M, N=M, K=N, bm=bi, bn=bj, bk=bk, smem=_part(parts),
                    out_bytes=_F32, extra_hbm=centre, tiles=_lower_tiles(M, bi, bj))
    flops = float(M) * (M + 1) * N
    return _finish(hw, [ln], flops=flops, compulsory=(N * M + M * M) * _F32,
                   peak=hw.ffma_flops, n_launches=2 if fuse else 3, parts=parts)


def matmul_cost(cfg: Mapping, M: int, K: int, N: int, *, hw: Hopper | None = None,
                dtype: torch.dtype | None = None):
    """The model's matmul at (M, K) @ (K, N) in ``dtype`` (its operands' and
    output's: f32, the default, or bf16; a signature carries none), in the
    route and layout the kernel runs for that dtype."""
    hw = hw or hopper()
    parts, limit = _smem("matmul", cfg, (M, K, N), dtype)
    bad = _infeasible(parts, limit)
    if bad:
        return float("inf"), bad
    # model_kernels.matmul_builder's defaults
    bm, bn, bk = (int(cfg.get(k, 128)) for k in ("bm", "bn", "bk"))
    size = torch.tensor([], dtype=dtype or torch.float32).element_size()
    ln = _matmul_launch(hw, M, K, N, bm, bn, bk, bool(cfg.get("pack", False)), _part(parts),
                        in_bytes=size)
    return _finish(hw, [ln], flops=2.0 * M * N * K,
                   compulsory=(M * K + K * N + M * N) * size, peak=ln.peak,
                   n_launches=1, parts=parts)


@functools.lru_cache(maxsize=256)
def _mm3_products(P, Q, R, S, T) -> tuple:
    """(m, k, n) of each launch of ``m3mm._chain``, from the driver's code."""
    from repro_torch.kernels import m3mm

    shapes = []

    def record(a, b, which, out_dtype):
        shapes.append((a.shape[0], a.shape[1], b.shape[1]))
        return torch.empty((a.shape[0], b.shape[1]), device="meta")

    meta = [torch.empty(s, device="meta") for s in ((P, Q), (Q, R), (R, S), (S, T))]
    m3mm._chain(*meta, record)
    return tuple(shapes)


def mm3_cost(cfg: Mapping, P: int, Q: int, R: int, S: int, T: int, *,
             hw: Hopper | None = None, dtype=None):
    hw = hw or hopper()
    parts, limit = _smem("mm3", cfg, (P, Q, R, S, T))
    bad = _infeasible(parts, limit)
    if bad:
        return float("inf"), bad
    c = config_of("mm3", cfg)
    bm, bn, bk = (int(c[k]) for k in ("bm", "bn", "bk"))
    launches, flops, comp = [], 0.0, 0.0
    for i, (m, k, n) in enumerate(_mm3_products(P, Q, R, S, T)):
        launches.append(_matmul_launch(hw, m, k, n, bm, bn, bk, bool(c[f"pack{i + 1}"]),
                                       _part(parts, i)))
        flops += 2.0 * m * n * k
        comp += (m * k + k * n + m * n) * _F32
    route = hw.tf32x3_flops if all(ln.tensor_cores for ln in launches) else hw.ffma_flops
    return _finish(hw, launches, flops=flops, compulsory=comp, peak=route,
                   n_launches=len(launches), parts=parts)


class _Count(TorchDispatchMode):
    """Counts the operations a driver dispatches that are not views: on the
    card each is a device kernel (a copy, a solve, an elementwise op)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=256)
def _lu_plan(N: int, bs: int) -> tuple[int, int, tuple]:
    """(other launches, diagonal factors, trailing GEMM shapes) of
    ``lu._blocked`` at (N, bs), from running it on meta tensors."""
    from repro_torch.kernels import lu as L

    factors, gemms = [], []

    def matmul(a, b):
        gemms.append((a.shape[0], a.shape[1], b.shape[1]))
        return torch.empty((a.shape[0], b.shape[1]), device="meta")

    with _Count() as count:
        L._blocked(torch.empty((N, N), device="meta"), bs,
                   lambda M, off, b: factors.append(b), matmul)
    return count.n, len(factors), tuple(gemms)


def lu_cost(cfg: Mapping, N: int, *, hw: Hopper | None = None, dtype=None):
    hw = hw or hopper()
    parts, limit = _smem("lu", cfg, (N,))
    bad = _infeasible(parts, limit)
    if bad:
        return float("inf"), bad
    c = config_of("lu", cfg)
    bs = min(int(c["bs"]), N)
    others, factors, gemms = _lu_plan(N, bs)
    launches = [_matmul_launch(hw, m, k, n, int(c["bm"]), int(c["bn"]), bs, bool(c["pack"]),
                               _part(parts, 1)) for m, k, n in gemms]
    flops = sum(2.0 * m * k * n for m, k, n in gemms)
    n = others + factors + len(gemms)
    return _finish(hw, launches, flops=flops, compulsory=2 * N * N * _F32,
                   peak=hw.tf32x3_flops, n_launches=n, parts=parts,
                   extra_sec=factors * bs * HELPER_STEP_SEC)


@functools.lru_cache(maxsize=256)
def _fw_plan(N: int, bs: int, bi: int, bj: int) -> tuple[int, int, tuple]:
    """(other launches, closures, min-plus launches (n, m, k, ti, tj)) of
    ``floyd_warshall._blocked``, from running it on meta tensors."""
    from repro_torch.kernels import floyd_warshall as FW

    closures, products = [], []

    def minplus(D, A, B, ti, tj, out):
        products.append((D.shape[0], D.shape[1], A.shape[1], min(ti, D.shape[0]),
                         min(tj, D.shape[1])))

    with _Count() as count:
        FW._blocked(torch.empty((N, N), device="meta"), bs, bi, bj, minplus,
                    lambda D, off, b: closures.append(b))
    return count.n, len(closures), tuple(products)


def floyd_warshall_cost(cfg: Mapping, N: int, *, hw: Hopper | None = None, dtype=None):
    hw = hw or hopper()
    parts, limit = _smem("floyd_warshall", cfg, (N,))
    bad = _infeasible(parts, limit)
    if bad:
        return float("inf"), bad
    from repro_torch.kernels.floyd_warshall import PANEL_TILE

    c = config_of("floyd_warshall", cfg)
    bs = min(int(c["bs"]), N)
    Np = cdiv(N, bs) * bs
    bi, bj = min(int(c["bi"]), Np), min(int(c["bj"]), Np)
    # the smem parts' order: the trailing tile, the row panel's, the column panel's
    tiles = [(bi, bj), (bs, min(PANEL_TILE, Np)), (min(PANEL_TILE, Np), bs)]
    others, closures, products = _fw_plan(N, bs, bi, bj)
    launches = []
    for n, m, k, ti, tj in products:
        pm, pn = _pad(ti, 4), _pad(tj, 4)
        rt = _reg_tile(pm, pn)
        blocks = cdiv(n, ti) * cdiv(m, tj)
        panels = (n * cdiv(m, tj) + m * cdiv(n, ti)) * k * _F32
        launches.append(_Launch(
            blocks=blocks, threads=min(256, cdiv(pm, rt) * cdiv(pn, rt)),
            work=float(blocks) * pm * pn * k, peak=hw.minmax_ops,
            hbm=2.0 * n * m * _F32 + (n + m) * k * _F32,
            l2=2.0 * n * m * _F32 + panels, smem=_part(parts, tiles.index((ti, tj)))))
    ops = float(N) ** 3
    return _finish(hw, launches, flops=ops, compulsory=2 * N * N * _F32,
                   peak=hw.minmax_ops, n_launches=others + closures + len(products),
                   parts=parts, extra_sec=closures * bs * HELPER_STEP_SEC)


_HEAT_FLOPS = 12  # flops a point per application (7-point masked update)


def heat3d_cost(cfg: Mapping, N: int, tsteps: int, *, hw: Hopper | None = None,
                dtype=None):
    from repro_torch.kernels.heat3d import heat3d_passes

    hw = hw or hopper()
    parts, limit = _smem("heat3d", cfg, (N, tsteps))
    bad = _infeasible(parts, limit)
    if bad:
        return float("inf"), bad
    c = config_of("heat3d", cfg)
    bi, fuse = min(int(c["bi"]), N), int(c["fuse_t"])
    passes = heat3d_passes(tsteps, fuse)
    grid = float(N) ** 3 * _F32
    # a pass reads each slab with its fuse-deep halo on both sides and
    # recomputes the halo: application a computes bi + 2 (fuse - a) planes
    planes = sum(bi + 2 * (fuse - a) for a in range(1, fuse + 1))
    work = cdiv(N, bi) * planes * float(N) * N * _HEAT_FLOPS
    reads = grid * (bi + 2 * fuse) / bi
    # the two buffers stay in L2 between passes where they fit: the grid
    # crosses HBM once in, once out
    hbm = 2 * grid / passes if 2 * grid <= hw.l2_bytes else reads + grid
    ln = _Launch(blocks=hw.sms, threads=256, work=work, peak=hw.ffma_flops, hbm=hbm,
                 l2=reads + grid, count=passes)
    return _finish(hw, [ln], flops=2.0 * tsteps * N ** 3 * _HEAT_FLOPS, compulsory=2 * grid,
                   peak=hw.ffma_flops, n_launches=passes, parts=parts,
                   launch_sec=hw.pass_sec)


def flash_attention_cost(cfg: Mapping, BH: int, Sq: int, Sk: int, hd: int, *,
                         hw: Hopper | None = None, dtype=None):
    """Causal, as the benchmark problem and the model's prefill call it."""
    from repro_torch.kernels.flash_attention import STEP, flash_attention_head_size

    hw = hw or hopper()
    parts, limit = _smem("flash_attention", cfg, (BH, Sq, Sk, hd), dtype)
    bad = _infeasible(parts, limit)
    if bad:
        return float("inf"), bad
    bq = min(int(cfg.get("bq", 128)), _pad(Sq, STEP))
    bk = min(int(cfg.get("bk", 128)), _pad(Sk, STEP))
    hdk = flash_attention_head_size(hd)
    nq = cdiv(Sq, bq)
    # key blocks each q tile visits (blocks wholly above the diagonal skipped)
    keys = sum(min(cdiv(min((i + 1) * bq, Sq), bk), cdiv(Sk, bk)) * bk for i in range(nq))
    groups = cdiv(hdk, 256)
    work = BH * groups * bq * keys * 2.0 * hdk * 2
    kv = BH * keys * hdk * 2.0 * _F32 * groups
    qo = 2.0 * BH * Sq * hd * _F32
    ln = _Launch(blocks=BH * nq * groups, threads=4 * bq, work=work, peak=hw.ffma_flops,
                 hbm=_operands_hbm(hw, 2.0 * BH * Sk * hd * _F32, kv) + qo, l2=kv + qo,
                 smem=_part(parts))
    flops = 2.0 * BH * Sq * Sk * hd
    return _finish(hw, [ln], flops=flops, compulsory=2.0 * BH * (Sq + Sk) * hd * _F32,
                   peak=hw.ffma_flops, n_launches=1, parts=parts)


def decode_attention_cost(cfg: Mapping, BH: int, G: int, S: int, hd: int, *,
                          hw: Hopper | None = None, dtype=None):
    """Memory-bound by construction: the cache crosses HBM once per token.
    The kernel splits the key axis in whole ``bk`` blocks, at most 32
    splits, over ``ceil(BH / hg)`` row groups; few blocks leave SMs idle."""
    hw = hw or hopper()
    parts, limit = _smem("decode_attention", cfg, (BH, G, S, hd), dtype)
    bad = _infeasible(parts, limit)
    if bad:
        return float("inf"), bad
    bk = max(1, min(int(cfg.get("bk", 128)), S))
    hg = max(1, min(int(cfg.get("hg", 1)), BH))
    groups = cdiv(BH, hg)
    splits = min(32, cdiv(S, bk))
    blocks = groups * splits
    cache = 2.0 * BH * _pad(S, bk) * hd * _F32
    partials = 0.0 if splits == 1 else 2.0 * BH * splits * G * (hd + 2) * _F32
    qo = 2.0 * BH * G * hd * _F32
    # a block streams its split's keys: fewer blocks than SMs cannot draw
    # the card's bandwidth
    ln = _Launch(blocks=blocks, threads=256, work=4.0 * BH * G * _pad(S, bk) * hd,
                 peak=hw.ffma_flops, hbm=cache + partials + qo,
                 l2=cache + partials + qo, smem=_part(parts),
                 draw=min(1.0, blocks / hw.sms))
    return _finish(hw, [ln], flops=4.0 * BH * G * S * hd,
                   compulsory=2.0 * BH * S * hd * _F32 + qo, peak=hw.ffma_flops,
                   n_launches=1, parts=parts)


KERNEL_COST_FNS = {
    "syr2k": syr2k_cost,
    "mm3": mm3_cost,
    "lu": lu_cost,
    "heat3d": heat3d_cost,
    "covariance": covariance_cost,
    "floyd_warshall": floyd_warshall_cost,
    "flash_attention": flash_attention_cost,
    "decode_attention": decode_attention_cost,
    "matmul": matmul_cost,
}


def kernel_cost(name: str, cfg: Mapping, *shape_args, hw: Hopper | None = None,
                dtype: torch.dtype | None = None):
    """Returns (modeled_seconds, info); +inf with ``info["infeasible"]`` when
    the config does not fit the card. Every model takes the operands'
    ``dtype`` where it is known (a served call's; None: unknown): the
    matmul's route, layout and bytes read it (None: f32), the attention
    kernels only their shared memory (their bytes are modelled in f32), and
    the PolyBench kernels, f32 only, not at all."""
    return KERNEL_COST_FNS[name](cfg, *shape_args, hw=hw, dtype=dtype)
