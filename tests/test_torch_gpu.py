"""The CUDA kernels on the card against their plain versions, at small
ragged shapes. Every test here carries the ``gpu`` marker and skips without
a CUDA device; on the card: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py``. This file imports neither jax nor repro, so it
runs where only the port is installed."""

import numpy as np
import pytest
import torch

from repro_torch.core import PENALTY, TimingEvaluator
from repro_torch.kernels import floyd_warshall as fw
from repro_torch.kernels import ops, problems
from repro_torch.kernels.covariance import covariance, covariance_plain, covariance_smem_bytes
from repro_torch.kernels.floyd_warshall import (
    closure_in_block,
    closure_plain,
    floyd_warshall,
    floyd_warshall_plain,
    minplus_smem_bytes,
    minplus_update,
    minplus_update_plain,
)
from repro_torch.kernels.heat3d import heat3d, heat3d_plain, heat3d_step, heat3d_step_plain
from repro_torch.kernels.lu import lu, lu_factor_diag, lu_factor_diag_plain, lu_plain
from repro_torch.kernels.matmul import matmul_smem_bytes, tiled_matmul, tiled_matmul_plain
from repro_torch.kernels.syr2k import syr2k, syr2k_plain, syr2k_smem_bytes
from repro_torch.kernels.util import ConfigRejected, max_shared_memory_per_block

# scaled to the outputs, as in chip_smoke.py: syr2k entries are ~30 here;
# the matmul's (1/sqrt(columns)-scaled inputs) ~0.1, where bf16, rounded
# alike by the kernel and its plain version, is held to about 2 ulps
SYR2K_TOL = dict(atol=5e-3, rtol=1e-4)
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=1e-3, rtol=1.6e-2)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: pytest -m gpu tests/test_torch_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


def test_syr2k_matches_plain_and_counts_launches(cuda):
    C, A, B = problems.problem_inputs("syr2k", (200, 130), cuda)
    want = syr2k_plain(C, A, B)
    before = syr2k.launches
    cfgs = (dict(bi=64, bj=64, bk=32, pack_a=True, pack_b=True),
            dict(bi=48, bj=80, bk=24, interchange=True),
            dict(bi=128, bj=8, bk=4, pack_a=True))
    outs = [syr2k(C, A, B, **cfg) for cfg in cfgs]
    for out in outs:
        _close(out, want, SYR2K_TOL)
    # one summation order whatever the schedule: identical bits
    assert all(torch.equal(outs[0], out) for out in outs[1:])
    assert syr2k.launches == before + len(cfgs)


@pytest.mark.parametrize("cfg", [
    dict(bi=128, bj=8, bk=16, pack_a=True, pack_b=True),
    dict(bi=8, bj=128, bk=32, pack_a=True, pack_b=True, interchange=True),
    dict(bi=24, bj=56, bk=12, pack_a=True),
    dict(bi=64, bj=40, bk=64, pack_a=False, pack_b=False, interchange=True),
])
def test_syr2k_rectangles_on_poisoned_outputs(cuda, cfg):
    # ragged N, bi != bj: every element is written once, by the block holding
    # it at (max, min) of its indices, whatever the tiles
    C, A, B = problems.problem_inputs("syr2k", (203, 130), cuda)
    want = syr2k_plain(C, A, B)
    torch.full((203, 203), float("nan"), device=cuda)  # the next output's block
    got = syr2k(C, A, B, **cfg)
    assert torch.isfinite(got).all()
    _close(got, want, SYR2K_TOL)
    assert torch.equal(got, syr2k(C, A, B, bi=64, bj=64, bk=32, pack_a=True, pack_b=True))


@pytest.mark.parametrize("M", [1, 4, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(96, 1000), (130, 90)])
def test_matmul_skinny_rows(cuda, M, dtype, K, N):
    # the model's decode: bm=64 clamps to M rows, an 8-row tile; 96 x 1000
    # stages by 16-byte copies, the ragged 130 x 90 element by element
    a, b = (t.to(dtype) for t in problems.problem_inputs("mm3", (M, K, N, 1, 1), cuda)[:2])
    torch.full((M, N), float("nan"), device=cuda)
    got = tiled_matmul(a, b, bm=64, bn=64, bk=32)
    want = tiled_matmul_plain(a, b, bk=32, pack=True, out_dtype=dtype)
    _close(got, want, F32_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pack", [True, False])
def test_matmul_matches_plain(cuda, dtype, pack):
    a, b = problems.problem_inputs("mm3", (130, 70, 90, 1, 1), cuda)[:2]
    a, b = a.to(dtype), b.to(dtype)
    got = tiled_matmul(a, b, bm=48, bn=80, bk=24, pack=pack, interchange=True)
    want = tiled_matmul_plain(a, b, bk=24, pack=pack, out_dtype=dtype)
    assert got.dtype == dtype
    _close(got, want, F32_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("bn", [50, 30])
@pytest.mark.parametrize("pack", [True, False])
def test_matmul_tiles_not_a_multiple_of_4_columns(cuda, bn, pack):
    # N % 4 == 0 but bn % 4 != 0: the second column tile starts off a 16-byte
    # word, so the output is stored element by element (a float4 store there
    # would fault)
    a, b = problems.problem_inputs("mm3", (70, 96, 200, 1, 1), cuda)[:2]
    torch.full((70, 200), float("nan"), device=cuda)
    got = tiled_matmul(a, b, bm=32, bn=bn, bk=32, pack=pack)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, tiled_matmul_plain(a, b, bk=32, pack=pack, out_dtype=torch.float32), F32_TOL)


def test_mm3_fuse_second_matches_reference(cuda):
    arrs = problems.problem_inputs("mm3", (80, 70, 60, 50, 40), cuda)
    got = ops.mm3_op(*arrs, config=dict(bm=24, bn=40, bk=16, fuse_second=True, pack3=False))
    A, B, C, D = arrs
    _close(got, (A @ B) @ (C @ D), F32_TOL)


LIMIT = 232448  # an H100's opt-in shared memory per block


def test_syr2k_smem_accounting(cuda):
    # a stage: one chunk per packed operand and side, pi (pj) rows padded to
    # 8, each bk floats padded to 32 bytes plus 16; three stages where they
    # fit the limit, at least the pi x (pj + 1) f32 tile of the transposed
    # store; -1 past the register tile
    assert syr2k_smem_bytes(64, 64, 32, False, False, LIMIT) == 4 * 64 * 65
    assert syr2k_smem_bytes(64, 64, 32, True, False, LIMIT) == 3 * 2 * 64 * 144
    assert syr2k_smem_bytes(64, 64, 32, True, True, LIMIT) == 3 * 4 * 64 * 144
    assert syr2k_smem_bytes(48, 80, 24, True, True, LIMIT) == 3 * 2 * (48 + 80) * 112
    assert syr2k_smem_bytes(8, 8, 8, True, False, LIMIT) == 3 * 2 * 8 * 48
    assert syr2k_smem_bytes(256, 64, 8, True, True, LIMIT) == -1
    # the ring gives up stages before the tile is refused
    stage = 4 * 64 * 144
    assert syr2k_smem_bytes(64, 64, 32, True, True, 2 * stage + 100) == 2 * stage
    assert syr2k_smem_bytes(64, 64, 32, True, True, stage + 100) == stage
    assert syr2k_smem_bytes(64, 64, 32, True, True, stage - 100) == stage  # refused
    assert syr2k_smem_bytes(64, 64, 32, True, True) == syr2k_smem_bytes(
        64, 64, 32, True, True, max_shared_memory_per_block(cuda))


def test_matmul_smem_accounting(cuda):
    # past 8 rows on mma.sync: A's chunk (bm and bn padded to whole 32 x 32
    # warp pieces, bk to the mma's k, 8 for f32 and 16 for bf16; A's rows
    # padded to 32 bytes plus 16) and B's (those k rows of the padded
    # columns plus 8 elements), three stages where they fit; a bf16 tile
    # may also take wgmma (64-row, 64-column padding, the chunk rounded up to
    # 16, up to 4 stages, 1024 bytes of alignment and the barriers), so it is
    # asked for the larger of the two; tiles of at most 8 rows (the split
    # stream): A's 32 KB piece and the block's reduction buffer (rows padded
    # to 4 or 8, 16 bytes of columns a thread, up to 128 threads)
    def tc(pm, pn, kf, size=4):
        return pm * (-(-kf * size // 32) * 32 + 16) + kf * size * (pn + 8)

    def wgmma(pm, pn, kc, stages=4):
        return 1024 + 16 * 4 + stages * (pm * kc * 2 + kc * pn * 2)

    def split(tm, bn, size):
        vw = 16 // size
        cg = -(-bn // vw)
        return 32768 + cg * max(1, 128 // cg) * tm * vw * 4

    assert matmul_smem_bytes(64, 64, 32, limit=LIMIT) == 3 * tc(64, 64, 32)
    assert matmul_smem_bytes(64, 64, 32, limit=LIMIT) == 3 * (64 * 144 + 32 * 288)
    assert matmul_smem_bytes(48, 80, 24, limit=LIMIT) == 3 * (64 * 112 + 24 * 416)
    assert matmul_smem_bytes(128, 8, 8, limit=LIMIT) == 3 * (128 * 48 + 8 * 160)
    assert matmul_smem_bytes(40, 50, 12, limit=LIMIT) == 3 * tc(64, 64, 16)
    assert matmul_smem_bytes(4, 64, 32, limit=LIMIT) == split(4, 64, 4) == 40960
    assert matmul_smem_bytes(8, 24, 4, limit=LIMIT) == split(8, 24, 4)
    assert matmul_smem_bytes(64, 64, 32, torch.bfloat16, LIMIT) == wgmma(64, 64, 32)
    assert 3 * tc(64, 64, 32, 2) < wgmma(64, 64, 32)
    assert matmul_smem_bytes(48, 80, 24, torch.bfloat16, LIMIT) == wgmma(64, 128, 32)
    assert matmul_smem_bytes(128, 128, 256, torch.bfloat16, LIMIT) == tc(128, 128, 256, 2)
    assert tc(128, 128, 256, 2) > wgmma(128, 128, 256, stages=1)
    assert matmul_smem_bytes(4, 64, 32, torch.bfloat16, LIMIT) == split(4, 64, 2) == 49152
    # a tile whose padded tensor-core layout does not fit takes the FFMA
    # loop's: one stage of 112 rows of A and 256 rows of 96 columns
    assert matmul_smem_bytes(112, 96, 256, limit=LIMIT) == 112 * 1040 + 256 * 384
    assert matmul_smem_bytes(64, 136, 8, limit=LIMIT) == -1
    stage = 64 * 144 + 32 * 288
    assert matmul_smem_bytes(64, 64, 32, limit=stage + 1) == stage


@pytest.mark.parametrize("bm,bn,bk", [(8, 24, 4), (24, 50, 12), (40, 30, 40), (8, 128, 256),
                                      (112, 8, 16)])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_tiles_pad_to_the_mma(cuda, bm, bn, bk, pack, dtype):
    # row tiles of 24 and 40 pad to the tensor cores' 32-row warp pieces,
    # 8-row tiles keep the FFMA loop, column tiles not a multiple of 4,
    # chunks not a multiple of the mma's k (8 for f32, 16 for bf16), ragged
    # edges everywhere; on a NaN-poisoned output
    a, b = (t.to(dtype) for t in problems.problem_inputs("mm3", (130, 70, 90, 1, 1), cuda)[:2])
    torch.full((130, 90), float("nan"), device=cuda)
    got = tiled_matmul(a, b, bm=bm, bn=bn, bk=bk, pack=pack, interchange=bm > 32)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and got.dtype == dtype
    _close(got, tiled_matmul_plain(a, b, bk=bk, pack=pack, out_dtype=dtype),
           F32_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("pack", [True, False])
def test_matmul_f32_tiles_past_the_tensor_core_layout(cuda, pack):
    # 112 x 96 x 256: the tensor cores' layout (padded to 128 x 96 plus 8
    # words) needs more shared memory than the card has; the FFMA loop runs it
    a, b = problems.problem_inputs("mm3", (150, 300, 140, 1, 1), cuda)[:2]
    got = tiled_matmul(a, b, bm=112, bn=96, bk=256, pack=pack, interchange=True)
    _close(got, tiled_matmul_plain(a, b, bk=256, pack=pack, out_dtype=torch.float32), F32_TOL)


def test_matmul_f32_in_bf16_out(cuda):
    a, b = problems.problem_inputs("mm3", (100, 64, 72, 1, 1), cuda)[:2]
    for pack in (True, False):
        got = tiled_matmul(a, b, bm=32, bn=40, bk=16, pack=pack, out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        _close(got, tiled_matmul_plain(a, b, bk=16, pack=pack, out_dtype=torch.bfloat16),
               BF16_TOL)


@pytest.mark.parametrize("bk", [32, 128])
@pytest.mark.parametrize("pack", [True, False])
def test_matmul_3xtf32_keeps_f32_accuracy_over_a_long_k(cuda, pack, bk):
    # the forward's output projection at mixtral's K (512 rows of a prompt
    # batch), rows of unit scale so that the outputs are ~N(0, 1): mma.sync's
    # f32 accumulation rounds toward zero, and a sum carried through it over
    # all of K was 1.5e-4 off the plain version at this shape
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(512, 4096, generator=g, device=cuda)
    b = torch.randn(4096, 1024, generator=g, device=cuda) / 64
    got = tiled_matmul(a, b, bm=64, bn=64, bk=bk, pack=pack)
    _close(got, tiled_matmul_plain(a, b, bk=bk, pack=pack, out_dtype=torch.float32), F32_TOL)


def test_oversized_tiles_are_rejected_before_launch(cuda):
    a, b = problems.problem_inputs("mm3", (300, 300, 300, 1, 1), cuda)[:2]
    before = tiled_matmul.launches
    with pytest.raises(ConfigRejected):
        tiled_matmul(a, b, bm=256, bn=64, bk=32)
    with pytest.raises(ConfigRejected):
        tiled_matmul(a, b, bm=128, bn=128, bk=300)  # one stage: 311 KB > 227 KB
    assert tiled_matmul.launches == before
    res = TimingEvaluator(problems.gpu_problem("syr2k", (300, 200), cuda))(
        dict(bi=128, bj=128, bk=256, pack_a=True, pack_b=True))
    assert not res.ok and res.objective == PENALTY


def test_timing_evaluator_times_the_kernel(cuda):
    factory = problems.gpu_problem("syr2k", (256, 192), cuda)
    before = syr2k.launches
    res = TimingEvaluator(factory, repeats=3, warmup=1)(ops.DEFAULTS["syr2k"])
    assert res.ok and 0 < res.objective < 1.0
    assert syr2k.launches == before + 4


# ---------------------------------------------------------------------------
# covariance, floyd_warshall, heat3d, lu
# ---------------------------------------------------------------------------

# covariance entries are ~1 on the diagonal (standard normal data); lu's run
# up to N on the diagonal, where its plain version's cuBLAS GEMM sums in
# another order than the kernel's FFMA loop
COV_TOL = dict(atol=1e-5, rtol=1e-4)
LU_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("cfg", [
    dict(bi=64, bj=64, bk=32, fuse_center=True),
    dict(bi=48, bj=80, bk=24, fuse_center=False, interchange=True),
    dict(bi=128, bj=8, bk=256, fuse_center=True, interchange=True),
])
def test_covariance_matches_plain(cuda, cfg):
    (data,) = problems.problem_inputs("covariance", (77, 130), cuda)  # bk does not divide N
    before = covariance.launches
    got = covariance(data, **cfg)
    assert covariance.launches == before + 1
    _close(got, covariance_plain(data), COV_TOL)


def test_covariance_smem_accounting(cuda):
    # the column means (pi + pj floats), then stages of two slabs, bk rows of
    # the tile padded to 8 floats each: six where six fit 110 KB, else three
    # as the limit allows; at least the pi x (pj + 1) f32 tile of the
    # transposed store; -1 past the register tile
    assert covariance_smem_bytes(64, 64, 32, LIMIT) == 4 * 128 + 6 * 4 * 32 * 128
    assert covariance_smem_bytes(48, 80, 24, LIMIT) == 4 * 128 + 6 * 4 * 24 * 128
    assert covariance_smem_bytes(64, 64, 64, LIMIT) == 4 * 128 + 3 * 4 * 64 * 128
    assert covariance_smem_bytes(128, 128, 64, LIMIT) == 4 * 256 + 3 * 4 * 64 * 256
    assert covariance_smem_bytes(8, 8, 4, LIMIT) == 4 * 16 + 6 * 4 * 4 * 16
    assert covariance_smem_bytes(136, 64, 8, LIMIT) == -1
    # the ring gives up stages before the tile is refused
    stage, mean = 4 * 32 * 128, 4 * 128
    assert covariance_smem_bytes(64, 64, 32, mean + 2 * stage + 100) == mean + 2 * stage
    assert covariance_smem_bytes(64, 64, 32, mean + stage + 100) == mean + stage
    assert covariance_smem_bytes(64, 64, 32, stage - 100) == mean + stage  # refused
    assert covariance_smem_bytes(64, 64, 32) == covariance_smem_bytes(
        64, 64, 32, max_shared_memory_per_block(cuda))


@pytest.mark.parametrize("interchange", [False, True])
@pytest.mark.parametrize("fuse_center", [True, False])
def test_covariance_symmetric_tiles_on_poisoned_outputs(cuda, interchange, fuse_center):
    # ragged M, bi != bj, rectangles across the diagonal: every element is
    # written once, by the block holding it at (max, min) of its indices, in
    # one summation order, so O is exactly symmetric and its bits do not
    # depend on the tiles, the chunk or the raster
    (data,) = problems.problem_inputs("covariance", (77, 203), cuda)
    want = covariance_plain(data)
    outs = []
    for cfg in (dict(bi=48, bj=80, bk=24), dict(bi=128, bj=8, bk=16),
                dict(bi=8, bj=128, bk=77), dict(bi=30, bj=50, bk=7), dict(bi=64, bj=64, bk=32)):
        torch.full((203, 203), float("nan"), device=cuda)  # the next output's block
        got = covariance(data, fuse_center=fuse_center, interchange=interchange, **cfg)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), cfg
        assert torch.equal(got, got.T), cfg
        _close(got, want, COV_TOL)
        outs.append(got)
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
def test_minplus_bit_exact(cuda, unroll):
    rng = np.random.default_rng(unroll)
    D, A, B = (torch.from_numpy(rng.uniform(0, 10, s).astype(np.float32)).to(cuda)
               for s in ((150, 170), (150, 70), (70, 170)))
    before = minplus_update.launches
    got = minplus_update(D, A, B, bi=48, bj=80, unroll=unroll)
    assert minplus_update.launches == before + 1
    assert torch.equal(got, minplus_update_plain(D, A, B))


def test_minplus_smem_accounting(cuda):
    # the ring's stages (one per 32-deep chunk of bs, at most three, fewer
    # under a small limit), each A's chunk (pm rows, k-contiguous, padded to
    # an odd number of 16-byte words) then B's (kc rows of pn columns); the
    # tile padded to its register tile only (4 x 4 below 64 x 64, 8 x 4 from
    # there, 8 x 8 past 256 threads)
    def stage(pm, pn, kc):
        return pm * ((4 * kc + 31) // 32 * 32 + 16) + kc * 4 * pn

    assert minplus_smem_bytes(64, 64, 64, LIMIT) == 2 * stage(64, 64, 32) == 34816
    assert minplus_smem_bytes(128, 128, 256, LIMIT) == 3 * stage(128, 128, 32)
    assert minplus_smem_bytes(128, 128, 256, 40000) == stage(128, 128, 32)  # one stage fits
    assert minplus_smem_bytes(48, 80, 16, LIMIT) == stage(48, 80, 16)
    assert minplus_smem_bytes(24, 40, 64, LIMIT) == 2 * stage(24, 40, 32)  # 24 rows cost 24
    assert minplus_smem_bytes(8, 64, 64, LIMIT) == 2 * stage(8, 64, 32)
    assert minplus_smem_bytes(66, 66, 64, LIMIT) == 2 * stage(72, 68, 32)  # 8 x 4
    # the driver's panels at bs = 256: one tile across the whole block
    assert minplus_smem_bytes(256, fw.PANEL_TILE, 256, LIMIT) == 3 * stage(256, 16, 32)
    assert minplus_smem_bytes(fw.PANEL_TILE, 256, 256, LIMIT) == 3 * stage(16, 256, 32)
    assert minplus_smem_bytes(fw.MAX_TILE + 8, 8, 64, LIMIT) == -1   # extent past 256
    assert minplus_smem_bytes(256, 256, 64, LIMIT) == -1             # 1,024 threads


@pytest.mark.parametrize("bs", [16, 100, 256])
def test_floyd_warshall_bit_exact_and_counts(cuda, bs):
    (W,) = problems.problem_inputs("floyd_warshall", (300,), cuda)
    W0 = W.clone()
    c0, m0 = closure_in_block.launches, minplus_update.launches
    got = floyd_warshall(W, bs=bs, bi=48, bj=64, unroll=4, allow_semiring_reassociation=True)
    nb = -(-300 // bs)
    assert closure_in_block.launches == c0 + nb
    assert minplus_update.launches == m0 + 3 * nb
    assert torch.equal(got, floyd_warshall_plain(W, bs=bs))
    assert torch.equal(W, W0)  # the input is never written


@pytest.mark.parametrize("tile", [8, 16, 24, 40, 112, 128])
@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
def test_minplus_views_and_in_place_panels(cuda, tile, unroll):
    # strided views of one matrix (leading dimension 260 > the panel's
    # width), the phase-2 panels in place, the trailing update out of place
    (W,) = problems.problem_inputs("floyd_warshall", (260,), cuda)
    off, bs = 64, 64
    D = W.clone()
    diag = D[off:off + bs, off:off + bs].clone()
    want_row = minplus_update_plain(D[off:off + bs], diag, D[off:off + bs])
    row = D[off:off + bs]
    minplus_update(row, diag, row, bi=bs, bj=tile, unroll=unroll, out=row)
    assert torch.equal(D[off:off + bs], want_row)
    want_col = minplus_update_plain(D[:, off:off + bs], D[:, off:off + bs], diag)
    col = D[:, off:off + bs]
    minplus_update(col, col, diag, bi=tile, bj=bs, unroll=unroll, out=col)
    assert torch.equal(D[:, off:off + bs], want_col)
    E = torch.full_like(D, float("nan"))
    minplus_update(D, col, row, bi=tile, bj=tile, unroll=unroll, out=E)
    assert torch.equal(E, minplus_update_plain(D, col, row))
    # a ragged contraction (bs = 70, off 16-byte words): element copies
    A, B = W[:, 3:73], W[5:75]
    assert torch.equal(minplus_update(W, A, B, bi=tile, bj=tile, unroll=unroll),
                       minplus_update_plain(W, A, B))


@pytest.mark.parametrize("N,bs", [(300, 16), (333, 32), (300, 64), (301, 128), (290, 256),
                                  (97, 48)])
def test_floyd_warshall_bit_exact_ragged(cuda, N, bs):
    # every bs of the gpu space (and one off it) on N that bs does not divide
    (W,) = problems.problem_inputs("floyd_warshall", (N,), cuda)
    for bi, bj, unroll in ((64, 64, 4), (24, 112, 1), (128, 40, 8)):
        got = floyd_warshall(W, bs=bs, bi=bi, bj=bj, unroll=unroll,
                             allow_semiring_reassociation=True)
        assert torch.equal(got, floyd_warshall_plain(W, bs=bs)), (bi, bj, unroll)


def test_closure_matches_plain(cuda):
    # every bs of the gpu space (one warp, one CTA, a cluster of CTAs) at
    # offsets 0 and off 16-byte words, bs between the instantiations, and bs
    # past the space (the block in global memory): bit for bit, nothing
    # outside the block written
    from repro_torch.kernels.spaces import floyd_warshall_space

    (W,) = problems.problem_inputs("floyd_warshall", (400,), cuda)
    space = floyd_warshall_space("gpu")["bs"].sequence
    assert tuple(space) == (16, 32, 64, 128, 256)
    cases = [(off, bs) for bs in space for off in (0, 37, 400 - bs)]
    cases += [(3, 24), (8, 48), (50, 100), (100, 200), (0, 257), (37, 300)]
    for off, bs in cases:
        D = W.clone()
        before = closure_in_block.launches
        closure_in_block(D, off, bs)
        assert closure_in_block.launches == before + 1
        want = W.clone()
        want[off:off + bs, off:off + bs] = closure_plain(W[off:off + bs, off:off + bs])
        assert torch.equal(D, want), (off, bs)


@pytest.mark.parametrize("bi,fuse_t", [(8, 1), (8, 2), (1, 2), (7, 2), (32, 1)])
def test_heat3d_matches_reference(cuda, bi, fuse_t):
    (A,) = problems.problem_inputs("heat3d", (37, 1), cuda)  # 37: ragged in i, j and k
    A0 = A.clone()
    before = heat3d.launches
    got = heat3d(A, 3, bi=bi, fuse_t=fuse_t)
    assert heat3d.launches == before + 6 // fuse_t  # one launch per pass, one C call
    # the kernel computes in the reference's order without contraction
    assert torch.equal(got, heat3d_plain(A, 3))
    assert torch.equal(A, A0)
    assert torch.equal(heat3d_step(A, bi=bi, fuse_t=fuse_t), heat3d_step_plain(A, fuse_t))


@pytest.mark.parametrize("N", [37, 130])
@pytest.mark.parametrize("bi", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("fuse_t", [1, 2])
def test_heat3d_every_space_point_bit_exact(cuda, N, bi, fuse_t):
    # all 12 points of the gpu space on grids ragged against the 120-wide k
    # tile (130: two k tiles) and off 16-byte rows (37); bi = 1 with fuse_t = 2
    # is the JAX kernel's short halo
    from repro_torch.kernels.heat3d import heat3d_plan

    (A,) = problems.problem_inputs("heat3d", (N, 1), cuda)
    plan = heat3d_plan((N, N, N), bi, fuse_t)
    assert plan["tj"] >= 1 and plan["blocks"] >= 1
    got = heat3d(A, 2, bi=bi, fuse_t=fuse_t)
    assert torch.equal(got, heat3d_plain(A, 2))


def test_lu_factor_diag_matches_plain(cuda):
    # every bs of the gpu space (one warp up to 32, a row's threads within a
    # warp past it) at offsets 0 and off 16-byte words, bs between the
    # instantiations, and bs past 128 (the block in shared memory, up to the
    # 240 that fits it): bit for bit, nothing outside the block written
    from repro_torch.kernels.spaces import lu_space

    (A,) = problems.problem_inputs("lu", (300,), cuda)
    space = lu_space("gpu")["bs"].sequence
    assert tuple(space) == (8, 16, 32, 64, 128)
    cases = [(off, bs) for bs in space for off in (0, 37, 300 - bs)]
    cases += [(5, 12), (9, 28), (64, 48), (101, 100), (0, 129), (7, 192), (60, 240)]
    for off, bs in cases:
        M = A.clone()
        before = lu_factor_diag.launches
        lu_factor_diag(M, off, bs)
        assert lu_factor_diag.launches == before + 1
        want = A.clone()
        want[off:off + bs, off:off + bs] = lu_factor_diag_plain(A[off:off + bs, off:off + bs])
        assert torch.equal(M, want), (off, bs)
    with pytest.raises(ConfigRejected):  # 241 x 242 floats pass 227 KB of shared memory
        lu_factor_diag(A.clone(), 0, 241)


@pytest.mark.parametrize("bs,pack", [(32, True), (28, False), (128, True), (64, True), (8, False)])
def test_lu_matches_plain_and_counts(cuda, bs, pack):
    (A,) = problems.problem_inputs("lu", (300,), cuda)
    A0 = A.clone()
    f0, m0 = lu_factor_diag.launches, tiled_matmul.launches
    got = lu(A, bs=bs, bm=48, bn=64, pack=pack)
    nb = -(-300 // bs)
    assert lu_factor_diag.launches == f0 + nb
    assert tiled_matmul.launches == m0 + nb - 1
    _close(got, lu_plain(A, bs=bs, pack=pack), LU_TOL)
    assert torch.equal(A, A0)


def test_new_kernels_reject_oversized_tiles_before_launch(cuda):
    (data,) = problems.problem_inputs("covariance", (300, 300), cuda)
    before = covariance.launches
    with pytest.raises(ConfigRejected):
        covariance(data, bi=256, bj=64, bk=32)
    with pytest.raises(ConfigRejected):
        covariance(data, bi=128, bj=128, bk=256)  # 256 * 2 * 132 floats > 227 KB
    assert covariance.launches == before
    D = torch.zeros(300, 300, device=cuda)
    with pytest.raises(ConfigRejected):  # 32 x 32 threads of 8 x 8
        minplus_update(D, D[:, :16].contiguous(), D[:16].contiguous(), bi=256, bj=256)
    with pytest.raises(TypeError):
        covariance(data.double())


# ---------------------------------------------------------------------------
# the serving path: flash_attention, decode_attention, dispatch, one step
# ---------------------------------------------------------------------------

# softmax-weighted averages of standard normal values; kernel and plain
# version differ in summation order only (chip_smoke.py's ATTN_TOL)
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16 attention outputs, rounded from f32 alike by the kernel and its plain
# version, differ by at most one bf16 ulp (2^-7 relative at worst); the
# measured error on an H100 is 6.1e-5 at (4, 200, 128) causal
ATTN_BF16_TOL = dict(atol=1e-4, rtol=8e-3)


def _normal(cuda, *shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda) for s in shapes]


@pytest.mark.parametrize("Sq,Sk,hd,causal,bq,bk", [
    (77, 131, 64, False, 32, 16),
    (100, 100, 128, True, 128, 64),
    (50, 70, 16, True, 16, 128),
    (65, 65, 32, False, 64, 64),
    (256, 256, 64, True, 64, 64),
    (90, 61, 256, True, 64, 64),
    (33, 200, 256, False, 16, 128),
])
def test_flash_attention_matches_plain(cuda, Sq, Sk, hd, causal, bq, bk):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = _normal(cuda, (3, Sq, hd), (3, Sk, hd), (3, Sk, hd))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
    assert flash_attention.launches == before + 1
    _close(got, flash_attention_plain(q, k, v, causal=causal), ATTN_TOL)
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    got = flash_attention(*bf, causal=causal, bq=bq, bk=bk)
    assert got.dtype == torch.bfloat16
    _close(got, flash_attention_plain(*bf, causal=causal), ATTN_BF16_TOL)


@pytest.mark.parametrize("ring,window", [(False, 0), (True, 0), (False, 9), (True, 9)])
@pytest.mark.parametrize("bk,hg", [(16, 1), (64, 2), (256, 4)])
def test_decode_attention_matches_plain(cuda, ring, window, bk, hg):
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain

    BH, G, S, hd = 6, 7, 40, 64
    q, k, v = _normal(cuda, (BH, G, hd), (BH, S, hd), (BH, S, hd), seed=1)
    cp = torch.tensor([-1, 0, 13, S - 1, S + 25, 20], dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, cp, ring=ring, window=window, bk=bk, hg=hg)
    _close(got, decode_attention_plain(q, k, v, cp, ring=ring, window=window), ATTN_TOL)
    assert torch.count_nonzero(got[0]) == 0   # cur_pos = -1: exactly 0


def test_decode_attention_reads_the_model_cache_in_place(cuda):
    from repro_torch.kernels.decode_attention import (
        CacheRows,
        decode_attention,
        decode_attention_plain,
    )

    B, S, K, G, hd = 3, 50, 2, 7, 64
    q, kc, vc = _normal(cuda, (B * K, G, hd), (B, S, K, hd), (B, S, K, hd), seed=2)
    cp = torch.tensor([4, 4, 49, 49, 20, 20], dtype=torch.int32, device=cuda)
    got = decode_attention(q, CacheRows(kc), CacheRows(vc), cp, bk=16, hg=2)
    want = decode_attention_plain(q, CacheRows(kc).rows(), CacheRows(vc).rows(), cp)
    _close(got, want, ATTN_TOL)


def _decode_cases(cuda, BH, G, S, hd, seed):
    q, k, v = _normal(cuda, (BH, G, hd), (BH, S, hd), (BH, S, hd), seed=seed)
    # an empty row, rows whose valid slots all lie in the first split, a full
    # row, one past the cache, one mid-way
    cp = torch.tensor([-1, 0, 5, S - 1, S + 25, S // 2 + 3][:BH], dtype=torch.int32,
                      device=cuda)
    return q, k, v, cp


@pytest.mark.parametrize("ring,window", [(False, 0), (True, 0), (False, 9), (True, 300)])
@pytest.mark.parametrize("S,bk,hg", [(1000, 32, 1), (1000, 64, 2), (777, 128, 1), (40, 64, 1)])
def test_decode_attention_split_key_axis(cuda, ring, window, S, bk, hg):
    # S = 1000 and 777 split into whole bk blocks, the last one ragged; S = 40
    # below bk is one split; splits with no valid slot skip their loads
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
        decode_attention_plan,
    )

    BH, G, hd = 6, 7, 64
    q, k, v, cp = _decode_cases(cuda, BH, G, S, hd, seed=S + bk)
    nsplit, ws = decode_attention_plan(BH, G, S, hd, min(bk, S), hg, cuda)
    assert (nsplit > 1) == (S > bk) and (ws > 0) == (nsplit > 1)
    before = decode_attention.launches
    got = decode_attention(q, k, v, cp, ring=ring, window=window, bk=bk, hg=hg)
    assert decode_attention.launches == before + 1
    _close(got, decode_attention_plain(q, k, v, cp, ring=ring, window=window), ATTN_TOL)
    assert torch.count_nonzero(got[0]) == 0   # cur_pos = -1: exactly 0
    # the same bits again: the partials merge in a fixed order
    assert torch.equal(got, decode_attention(q, k, v, cp, ring=ring, window=window, bk=bk,
                                             hg=hg))


@pytest.mark.parametrize("G,hd", [(128, 16), (3, 16), (64, 32), (1, 32), (16, 128), (5, 128)])
def test_decode_attention_head_sizes(cuda, G, hd):
    # every head size at its largest G (8 * 256 / hd: eight heads a thread
    # in the P V pass) and at a small one, split and not, f32 and bf16
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain

    for S, bk in ((300, 32), (20, 32)):
        q, k, v, cp = _decode_cases(cuda, 6, G, S, hd, seed=G + hd + S)
        got = decode_attention(q, k, v, cp, ring=True, window=50, bk=bk)
        _close(got, decode_attention_plain(q, k, v, cp, ring=True, window=50), ATTN_TOL)
        assert torch.count_nonzero(got[0]) == 0
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        got = decode_attention(qb, kb, vb, cp, bk=bk)
        _close(got, decode_attention_plain(qb, kb, vb, cp), ATTN_BF16_TOL)


def test_decode_attention_counters_return_to_zero(cuda):
    # a call at one BH, one at another (other row groups, other counters),
    # then the first again: identical bits, so every counter was left at 0
    from repro_torch.kernels.decode_attention import decode_attention

    first = _decode_cases(cuda, 6, 8, 1000, 128, seed=3)
    other = _decode_cases(cuda, 3, 8, 1000, 128, seed=4)
    a = decode_attention(*first, bk=32)
    b = decode_attention(*other, bk=32)
    c = decode_attention(*first, bk=32)
    b2 = decode_attention(*other, bk=64, hg=2)
    torch.cuda.synchronize()
    assert torch.equal(a, c)
    _close(b, b2, ATTN_TOL)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention_split_cache_rows_and_bf16(cuda, ring):
    from repro_torch.kernels.decode_attention import (
        CacheRows,
        decode_attention,
        decode_attention_plain,
    )

    B, S, K, G, hd = 3, 600, 2, 7, 64
    q, kc, vc = _normal(cuda, (B * K, G, hd), (B, S, K, hd), (B, S, K, hd), seed=5)
    cp = torch.tensor([-1, 4, 599, 650, 300, 31], dtype=torch.int32, device=cuda)
    got = decode_attention(q, CacheRows(kc), CacheRows(vc), cp, ring=ring, bk=64, hg=2)
    want = decode_attention_plain(q, CacheRows(kc).rows(), CacheRows(vc).rows(), cp, ring=ring)
    _close(got, want, ATTN_TOL)
    assert torch.count_nonzero(got[0]) == 0
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, kc, vc))
    got = decode_attention(qb, CacheRows(kb), CacheRows(vb), cp, ring=ring, bk=32)
    assert got.dtype == torch.bfloat16
    _close(got, decode_attention_plain(qb, CacheRows(kb).rows(), CacheRows(vb).rows(), cp,
                                       ring=ring), ATTN_BF16_TOL)
    assert torch.count_nonzero(got[0]) == 0
    assert torch.equal(got, decode_attention(qb, CacheRows(kb), CacheRows(vb), cp, ring=ring,
                                             bk=32))


def test_attention_smem_accounting(cuda):
    from repro_torch.kernels.decode_attention import decode_attention_smem_bytes
    from repro_torch.kernels.flash_attention import flash_attention_smem_bytes

    # Q [bq][hd] and two ring stages of one K or V block [bk][hd], in the
    # input dtype, unpadded (the chunks are swizzled), then P [bq][bk] f32;
    # one stage where two do not fit the limit
    def flash(bq, bk, hd, size, stages):
        return bq * hd * size + stages * bk * hd * size + 4 * bq * bk

    assert flash_attention_smem_bytes(64, 64, 128, limit=LIMIT) == flash(64, 64, 128, 4, 2)
    assert flash_attention_smem_bytes(64, 64, 128, limit=LIMIT) == 114688  # two blocks an SM
    assert flash_attention_smem_bytes(16, 32, 64, limit=LIMIT) == flash(16, 32, 64, 4, 2)
    assert flash_attention_smem_bytes(64, 64, 256, limit=LIMIT) == flash(64, 64, 256, 4, 2)
    assert flash_attention_smem_bytes(64, 64, 256, torch.bfloat16, LIMIT) == \
        flash(64, 64, 256, 2, 2)
    assert flash_attention_smem_bytes(128, 128, 128, limit=LIMIT) == flash(128, 128, 128, 4, 1)
    assert flash_attention_smem_bytes(128, 64, 256, limit=LIMIT) == flash(128, 64, 256, 4, 1)
    assert flash_attention_smem_bytes(128, 128, 256, limit=LIMIT) > LIMIT  # refused
    assert flash_attention_smem_bytes(8, 64, 64, limit=LIMIT) == -1     # not a multiple of 16
    assert flash_attention_smem_bytes(64, 256, 64, limit=LIMIT) == -1   # past 128
    # another head size runs padded to the next instantiation
    assert flash_attention_smem_bytes(64, 64, 96, limit=LIMIT) == flash(64, 64, 128, 4, 2)
    assert flash_attention_smem_bytes(64, 64, 160, limit=LIMIT) == flash(64, 64, 256, 4, 2)
    # past 256: the next multiple of 64, each stage one score chunk (Q and K,
    # 128 columns) or one column group of V (256 columns), then P
    def wide(bq, bk, size, stages):
        return stages * max((bq + bk) * 128 * size, bk * 256 * size) + 4 * bq * bk

    assert flash_attention_smem_bytes(64, 64, 512, limit=LIMIT) == wide(64, 64, 4, 2)
    assert flash_attention_smem_bytes(128, 128, 512, limit=LIMIT) == wide(128, 128, 4, 1)
    assert flash_attention_smem_bytes(64, 64, 272, torch.bfloat16, LIMIT) == wide(64, 64, 2, 2)
    assert flash_attention_smem_bytes(64, 64, 272, limit=LIMIT) == \
        flash_attention_smem_bytes(64, 64, 320, limit=LIMIT)
    assert flash_attention_smem_bytes(128, 128, 512, limit=LIMIT) <= LIMIT  # every tile fits
    # q [G][hd + 4], S [G][33], m/l/alpha [3][G] in f32, rounded up to 16
    # bytes; then three ring stages of 32 slots of K (rows padded to an odd
    # number of 16-byte words) and V, in the cache's dtype, or the P V
    # pass's 256 / (hd / 4) slot groups' f32 sums of G x hd if larger; bk
    # does not enter
    head = -(-4 * (7 * 68 + 7 * 33 + 3 * 7) // 16) * 16
    assert decode_attention_smem_bytes(7, 128, 64) == head + 3 * 32 * (272 + 256)
    assert decode_attention_smem_bytes(7, 32, 64) == head + 3 * 32 * (272 + 256)
    assert decode_attention_smem_bytes(7, 128, 64, torch.bfloat16) == head + 4 * 16 * 7 * 64
    head = -(-4 * (8 * 260 + 8 * 33 + 3 * 8) // 16) * 16
    assert decode_attention_smem_bytes(8, 32, 256) == head + 3 * 32 * (1040 + 1024)
    assert decode_attention_smem_bytes(8, 32, 256, torch.bfloat16) == head + 3 * 32 * (528 + 512)
    assert decode_attention_smem_bytes(8, 32, 256) <= LIMIT
    assert decode_attention_smem_bytes(9, 32, 256) == -1    # G past 8 * 256 / hd
    assert decode_attention_smem_bytes(7, 512, 64) == -1
    assert decode_attention_smem_bytes(17, 64, 128) == -1   # G past 8 * 256 / hd
    # every multiple of 16: hd 96, G 7 (256 / 24 = 10 slot groups of P V sums)
    head = -(-4 * (7 * 100 + 7 * 33 + 3 * 7) // 16) * 16
    assert decode_attention_smem_bytes(7, 64, 96) == head + 3 * 32 * (400 + 384)
    # a head size off the multiples of 16 runs at the next one
    assert decode_attention_smem_bytes(7, 64, 72) == decode_attention_smem_bytes(7, 64, 80)
    # past 256: q [G][round_up(hd, 16) + 4], a stage holds 32 slots of one
    # 256-column chunk of K or of one column group of V, not both
    head = -(-4 * (8 * 516 + 8 * 33 + 3 * 8) // 16) * 16
    assert decode_attention_smem_bytes(8, 32, 512) == head + 3 * 32 * 1040
    assert decode_attention_smem_bytes(8, 32, 500) == decode_attention_smem_bytes(8, 32, 512)
    assert decode_attention_smem_bytes(9, 32, 512) == -1    # 8 heads a launch past 256


def test_attention_oversized_tiles_are_rejected_before_launch(cuda):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _normal(cuda, (2, 300, 256), (2, 300, 256), (2, 300, 256))
    f0 = flash_attention.launches
    with pytest.raises(ConfigRejected):
        flash_attention(q, k, v, bq=128, bk=128)   # 320 KB of shared memory at one stage
    with pytest.raises(ConfigRejected):
        flash_attention(q, k, v, bq=40, bk=64)     # not a multiple of 16
    qw, kw, vw = _normal(cuda, (2, 30, 272), (2, 30, 272), (2, 30, 272))
    with pytest.raises(ConfigRejected):
        flash_attention(qw, kw, vw, bq=48, bk=24)  # past 256 too: not a multiple of 16
    assert flash_attention.launches == f0
    qd, kd, vd = _normal(cuda, (2, 17, 128), (2, 300, 128), (2, 300, 128))
    d0 = decode_attention.launches
    with pytest.raises(ConfigRejected):            # past 256 too: bk past 256
        decode_attention(*_normal(cuda, (2, 4, 272), (2, 300, 272), (2, 300, 272)), 299,
                         bk=512)
    with pytest.raises(ConfigRejected):
        decode_attention(qd[:, :8].contiguous(), kd, vd, 299, bk=512)  # bk past 256
    assert decode_attention.launches == d0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_256(cuda, causal, dtype):
    # gemma3-1b's head size, ragged Sq and Sk, at every tile of the gpu space
    # that fits the card's shared memory
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
        flash_attention_smem_bytes,
    )
    from repro_torch.kernels.spaces import FLASH_TILES_GPU

    q, k, v = (t.to(dtype) for t in _normal(cuda, (3, 150, 256), (3, 137, 256), (3, 137, 256),
                                            seed=11))
    want = flash_attention_plain(q, k, v, causal=causal)
    limit = max_shared_memory_per_block(cuda)
    ran = 0
    for bq in FLASH_TILES_GPU:
        for bk in FLASH_TILES_GPU:
            if flash_attention_smem_bytes(bq, bk, 256, dtype, limit) > limit:
                continue
            got = flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
            assert got.dtype == dtype
            _close(got, want, ATTN_TOL if dtype == torch.float32 else ATTN_BF16_TOL)
            ran += 1
    assert ran >= 12 if dtype == torch.float32 else ran == 16


@pytest.mark.parametrize("ring,window", [(False, 0), (True, 0), (False, 9), (True, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_head_dim_256(cuda, ring, window, dtype):
    # G = 8 (the most hd 256 takes), the key axis split across blocks, and
    # the same bits from a second call
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
        decode_attention_plan,
    )

    q, k, v, cp = _decode_cases(cuda, 6, 8, 1000, 256, seed=21)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    nsplit, _ = decode_attention_plan(6, 8, 1000, 256, 32, 1, cuda)
    assert nsplit > 1
    got = decode_attention(q, k, v, cp, ring=ring, window=window, bk=32)
    _close(got, decode_attention_plain(q, k, v, cp, ring=ring, window=window),
           ATTN_TOL if dtype == torch.float32 else ATTN_BF16_TOL)
    assert torch.count_nonzero(got[0]) == 0   # cur_pos = -1: exactly 0
    assert torch.equal(got, decode_attention(q, k, v, cp, ring=ring, window=window, bk=32))


@pytest.mark.parametrize("hd", [80, 96, 112, 160, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_other_head_sizes(cuda, hd, dtype):
    # head sizes between the instantiations run zero-padded to the next one
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = (t.to(dtype) for t in _normal(cuda, (3, 150, hd), (3, 137, hd), (3, 137, hd),
                                            seed=hd))
    tol = ATTN_TOL if dtype == torch.float32 else ATTN_BF16_TOL
    for causal in (True, False):
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal, bq=64, bk=32)
        assert flash_attention.launches == before + 1
        assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
        _close(got, flash_attention_plain(q, k, v, causal=causal), tol)


def test_flash_attention_padding_keeps_the_bits(cuda):
    # the zero columns come after the real ones: hd 64 run at 128 with q, k, v
    # zero-padded and the true scale gives the hd 64 kernel's bits
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _normal(cuda, (3, 100, 64), (3, 100, 64), (3, 100, 64), seed=31)
    pad = [torch.nn.functional.pad(t, (0, 64)) for t in (q, k, v)]
    for causal in (True, False):
        want = flash_attention(q, k, v, causal=causal, bq=32, bk=64)
        got = flash_attention(*pad, causal=causal, bq=32, bk=64, scale=64 ** -0.5)
        assert torch.equal(got[..., :64], want)
        assert torch.count_nonzero(got[..., 64:]) == 0


@pytest.mark.parametrize("hd", [80, 96, 112, 160, 192])
@pytest.mark.parametrize("ring,window", [(False, 0), (True, 0), (True, 300)])
def test_decode_attention_other_head_sizes(cuda, hd, ring, window):
    # instantiated head sizes, the key axis split, f32 and bf16, and a model
    # cache read in place
    from repro_torch.kernels.decode_attention import (
        CacheRows,
        decode_attention,
        decode_attention_plain,
    )

    q, k, v, cp = _decode_cases(cuda, 6, 7, 1000, hd, seed=hd)
    before = decode_attention.launches
    got = decode_attention(q, k, v, cp, ring=ring, window=window, bk=32)
    assert decode_attention.launches == before + 1
    _close(got, decode_attention_plain(q, k, v, cp, ring=ring, window=window), ATTN_TOL)
    assert torch.count_nonzero(got[0]) == 0
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = decode_attention(qb, kb, vb, cp, ring=ring, window=window, bk=64)
    _close(got, decode_attention_plain(qb, kb, vb, cp, ring=ring, window=window),
           ATTN_BF16_TOL)
    kc, vc = (t.reshape(3, 2, 1000, hd).transpose(1, 2).contiguous() for t in (k, v))
    got = decode_attention(q, CacheRows(kc), CacheRows(vc), cp, ring=ring, window=window,
                           bk=128, hg=2)
    _close(got, decode_attention_plain(q, k, v, cp, ring=ring, window=window), ATTN_TOL)


@pytest.mark.parametrize("G,hd", [(17, 128), (40, 64), (9, 256), (26, 80), (13, 160)])
def test_decode_attention_heads_past_one_launch(cuda, G, hd):
    # G past 8 * 256 / hd: one launch per group of heads, each in place in
    # q's and the output's rows
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_head_groups,
        decode_attention_plain,
    )

    groups = decode_attention_head_groups(G, hd)
    assert len(groups) > 1
    q, k, v, cp = _decode_cases(cuda, 5, G, 700, hd, seed=G)
    for ring, bk in ((False, 32), (True, 128)):
        before = decode_attention.launches
        got = decode_attention(q, k, v, cp, ring=ring, bk=bk)
        assert decode_attention.launches == before + len(groups)
        _close(got, decode_attention_plain(q, k, v, cp, ring=ring), ATTN_TOL)
        assert torch.count_nonzero(got[0]) == 0
        assert torch.equal(got, decode_attention(q, k, v, cp, ring=ring, bk=bk))


@pytest.mark.parametrize("hd", [272, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_past_head_size_256(cuda, hd, dtype):
    # column groups of 256 output columns, scores in chunks of 128: causal
    # and not, ragged Sq and Sk, tiles taking one or two ring stages
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = (t.to(dtype) for t in _normal(cuda, (3, 150, hd), (3, 137, hd), (3, 137, hd),
                                            seed=hd))
    tol = ATTN_TOL if dtype == torch.float32 else ATTN_BF16_TOL
    for causal in (True, False):
        for bq, bk in ((64, 64), (32, 128), (128, 16)):
            before = flash_attention.launches
            got = flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
            assert flash_attention.launches == before + 1
            assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
            _close(got, flash_attention_plain(q, k, v, causal=causal), tol)
    # every column group computes the same scores: a second call, same bits
    assert torch.equal(got, flash_attention(q, k, v, causal=False, bq=128, bk=16))


@pytest.mark.parametrize("hd", [272, 320, 512])
@pytest.mark.parametrize("ring,window", [(False, 0), (True, 0), (False, 9), (True, 300)])
def test_decode_attention_past_head_size_256(cuda, hd, ring, window):
    # column groups of V across blocks, the key axis split, per-row
    # positions, f32 and bf16, a model cache read in place, and a G that
    # takes two launches (8 heads a launch past 256)
    from repro_torch.kernels.decode_attention import (
        CacheRows,
        decode_attention,
        decode_attention_head_groups,
        decode_attention_plain,
        decode_attention_plan,
    )

    q, k, v, cp = _decode_cases(cuda, 6, 7, 1000, hd, seed=hd)
    assert decode_attention_plan(6, 7, 1000, hd, 32, 1, cuda)[0] > 1
    before = decode_attention.launches
    got = decode_attention(q, k, v, cp, ring=ring, window=window, bk=32)
    assert decode_attention.launches == before + 1
    _close(got, decode_attention_plain(q, k, v, cp, ring=ring, window=window), ATTN_TOL)
    assert torch.count_nonzero(got[0]) == 0
    assert torch.equal(got, decode_attention(q, k, v, cp, ring=ring, window=window, bk=32))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = decode_attention(qb, kb, vb, cp, ring=ring, window=window, bk=64)
    _close(got, decode_attention_plain(qb, kb, vb, cp, ring=ring, window=window),
           ATTN_BF16_TOL)
    kc, vc = (t.reshape(3, 2, 1000, hd).transpose(1, 2).contiguous() for t in (k, v))
    got = decode_attention(q, CacheRows(kc), CacheRows(vc), cp, ring=ring, window=window,
                           bk=128, hg=2)
    _close(got, decode_attention_plain(q, k, v, cp, ring=ring, window=window), ATTN_TOL)
    G = 12
    assert len(decode_attention_head_groups(G, hd)) == 2
    q, k, v, cp = _decode_cases(cuda, 5, G, 300, hd, seed=hd + 1)
    before = decode_attention.launches
    got = decode_attention(q, k, v, cp, ring=ring, window=window, bk=64)
    assert decode_attention.launches == before + 2
    _close(got, decode_attention_plain(q, k, v, cp, ring=ring, window=window), ATTN_TOL)


def test_decode_attention_past_256_off_the_multiples_of_16(cuda):
    # hd 300 (f32) and 290 (bf16: rows off 16-byte words, element copies):
    # the last chunk and column group masked past hd
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain

    for hd, dtype in ((300, torch.float32), (290, torch.bfloat16)):
        q, k, v, cp = _decode_cases(cuda, 6, 5, 400, hd, seed=hd)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        got = decode_attention(q, k, v, cp, ring=True, window=200, bk=32)
        _close(got, decode_attention_plain(q, k, v, cp, ring=True, window=200),
               ATTN_TOL if dtype == torch.float32 else ATTN_BF16_TOL)


# an untileable bq (the feasibility pass's shared-memory rule refuses it
# before the build guard), and the chunked torch variant, which does not run
# on the card (the build guard refuses it)
@pytest.mark.parametrize("poison", [dict(impl="pallas", bq=8, bk=64),
                                    dict(impl="xla", bq=64, bk=64)])
def test_dispatch_degrades_a_poisoned_record_to_the_kernel(cuda, tmp_path, poison):
    from repro_torch.dispatch import DispatchService, TuningRecord, TuningStore
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.model_kernels import flash_attention_signature

    q, k, v = _normal(cuda, (4, 64, 64), (4, 64, 64), (4, 64, 64))
    store = TuningStore(str(tmp_path))
    store.put(TuningRecord("flash_attention", flash_attention_signature(4, 64, 64, 64),
                           "gpu", poison, 1e-6))
    svc = DispatchService(store)
    before = flash_attention.launches
    got = svc.call("flash_attention", q, k, v, causal=True)
    stat, reason = (("infeasible", "smem_unsupported") if poison["impl"] == "pallas"
                    else ("build_failed", "build_failed"))
    assert svc.stats[stat] == 1 and flash_attention.launches == before + 1
    assert svc.stats["infeasible"] + svc.stats["build_failed"] == 1
    assert store.quarantines("flash_attention")[0]["reason"] == reason
    _close(got, flash_attention_plain(q, k, v), ATTN_TOL)


def test_dispatch_operand_fault_keeps_a_sound_record(cuda, tmp_path):
    from repro_torch.dispatch import DispatchService, TuningRecord, TuningStore
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.model_kernels import flash_attention_signature

    q, v = _normal(cuda, (4, 64, 64), (4, 64, 64))
    (wide,) = _normal(cuda, (4, 64, 128))
    k = wide[..., ::2]                   # the record's shape, not contiguous
    signature = flash_attention_signature(4, 64, 64, 64)
    store = TuningStore(str(tmp_path))
    store.put(TuningRecord("flash_attention", signature, "gpu",
                           dict(impl="pallas", bq=32, bk=64), 1e-6))
    svc = DispatchService(store)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="contiguous"):
        svc.call("flash_attention", q, k, v, causal=True)
    assert svc.stats["store_exact"] == 1 and svc.stats["build_failed"] == 0
    assert store.quarantines() == [] and flash_attention.launches == before
    assert store.get("flash_attention", signature, "gpu") is not None


def test_fleet_host_b_serves_host_a_config_with_zero_evaluations(cuda, tmp_path):
    # host A's record reaches host B through the fleet's file transport; B
    # resolves it as an exact hit, enqueues no campaign and launches the
    # kernel with A's config
    from repro_torch.dispatch import (
        BackgroundTuner,
        DispatchService,
        TuningRecord,
        TuningStore,
        shape_signature,
    )
    from repro_torch.fleet import FileTransport, Replica, SyncAgent

    C, A, B = problems.problem_inputs("syr2k", (200, 130), cuda)
    signature = shape_signature([C, A, B])
    cfg = dict(bi=48, bj=80, bk=24, pack_a=True, pack_b=False, interchange=True)
    shared = str(tmp_path / "shared")
    store_a = TuningStore(str(tmp_path / "a"))
    agent_a = SyncAgent(Replica(store_a), FileTransport(shared))
    store_a.put(TuningRecord("syr2k", signature, "gpu", cfg, 1e-4, n_evals=8,
                             source="campaign:hostA"))
    store_b = TuningStore(str(tmp_path / "b"))
    tuner = BackgroundTuner(store_b, max_workers=1, max_evals=2)
    try:
        svc = DispatchService(store_b, tuner=tuner)
        agent_b = SyncAgent(Replica(store_b, service=svc), FileTransport(shared))
        agent_a.sync_once()
        assert agent_b.sync_once()["applied"] == 1
        before = syr2k.launches
        got = svc.call("syr2k", C, A, B)
        served = svc.dispatch("syr2k", C, A, B).__wrapped__.fn.keywords["config"]
        assert syr2k.launches == before + 1
        assert {k: served[k] for k in cfg} == cfg
        assert svc.stats["store_exact"] >= 1 and svc.stats["bg_enqueued"] == 0
        assert svc.stats["sync_applied"] == 1 and tuner.stats["campaigns"] == 0
        _close(got, syr2k_plain(C, A, B), SYR2K_TOL)
    finally:
        tuner.shutdown()


def test_one_decode_step_launches_the_kernels(cuda):
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import decode_step, forward, init_cache, init_params

    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    svc = DispatchService()
    toks = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda)
    f0, m0 = flash_attention.launches, tiled_matmul.launches
    logits, _ = forward(params, {"tokens": toks}, cfg, service=svc)
    G = cfg.n_heads // cfg.n_kv_heads
    assert flash_attention.launches == f0 + G * cfg.n_layers
    assert tiled_matmul.launches == m0 + cfg.n_layers + 1
    cache = init_cache(cfg, 2, 12, device=cuda)
    d0, m0 = decode_attention.launches, tiled_matmul.launches
    step_logits, _ = decode_step(params, cache, toks[:, :1], 0, cfg, service=svc)
    torch.cuda.synchronize()
    assert decode_attention.launches == d0 + cfg.n_layers
    assert tiled_matmul.launches == m0 + cfg.n_layers + 1
    assert torch.isfinite(logits).all() and torch.isfinite(step_logits).all()
    # the same step without the service: the same logits, no kernel
    plain, _ = decode_step(params, init_cache(cfg, 2, 12, device=cuda), toks[:, :1], 0, cfg)
    _close(step_logits, plain, dict(atol=1e-4, rtol=1e-4))
    # one request: the flattened K/V and query groups are strided views at
    # B = 1, which the wrappers must not be handed
    one, _ = forward(params, {"tokens": toks[:1]}, cfg, service=svc)
    _close(one, logits[:1], dict(atol=1e-4, rtol=1e-4))


# ---------------------------------------------------------------------------
# the tuning loop on the card: PolyBench builders, background campaigns on
# their own stream, shadow samples in device time, the shared-memory rule
# ---------------------------------------------------------------------------

POLYBENCH_SMALL = {"syr2k": (203, 130), "mm3": (70, 50, 60, 40, 30), "lu": (150,),
                   "heat3d": (30, 2), "covariance": (150, 97), "floyd_warshall": (150,)}


def _polybench_want(kernel, args, cfg, tsteps):
    from repro_torch.kernels import ref
    from repro_torch.kernels.covariance import covariance_plain

    if kernel == "syr2k":
        return syr2k_plain(*args), SYR2K_TOL
    if kernel == "mm3":
        return ref.mm3_ref(*args), F32_TOL
    if kernel == "lu":
        c = ops.config_of("lu", cfg)
        return lu_plain(*args, bs=c["bs"], pack=c["pack"]), LU_TOL
    if kernel == "heat3d":
        return heat3d_plain(*args, tsteps), dict(atol=1e-6, rtol=0.0)
    if kernel == "covariance":
        return covariance_plain(*args), COV_TOL
    return floyd_warshall_plain(*args, bs=ops.config_of("floyd_warshall", cfg)["bs"]), \
        dict(atol=0.0, rtol=0.0)


@pytest.mark.parametrize("kernel", sorted(POLYBENCH_SMALL))
def test_polybench_builders_launch_the_kernels(cuda, kernel):
    from repro_torch.kernels import variants
    from repro_torch.kernels.spaces import kernel_space

    dims = POLYBENCH_SMALL[kernel]
    args = problems.problem_inputs(kernel, dims, cuda)
    static = {"tsteps": dims[1]} if kernel == "heat3d" else {}
    space = kernel_space(kernel, "gpu", seed=5)
    rng = np.random.default_rng(5)
    counters = {"syr2k": syr2k, "mm3": tiled_matmul, "lu": lu_factor_diag,
                "heat3d": heat3d, "covariance": covariance, "floyd_warshall": minplus_update}
    for cfg in [space.default_configuration()] + [space.sample_configuration(rng)
                                                  for _ in range(3)]:
        v = variants.DISPATCH_BUILDERS[kernel](cfg, **static)
        try:
            v.check(*args)
        except ConfigRejected:
            continue
        before = counters[kernel].launches
        got = v(*args)
        torch.cuda.synchronize()
        assert counters[kernel].launches > before
        want, tol = _polybench_want(kernel, args, cfg, static.get("tsteps"))
        _close(got, want, tol)


def test_background_campaign_times_on_its_own_stream(cuda, tmp_path):
    from repro_torch.dispatch import BackgroundTuner, DispatchService, TuningStore

    store = TuningStore(str(tmp_path / "s"))
    tuner = BackgroundTuner(store, max_workers=1, max_evals=4, n_initial=2)
    svc = DispatchService(store, tuner=tuner)
    streams = []
    a, b = _normal(cuda, (4, 96), (96, 200))
    real = tiled_matmul

    def spy(cfg):   # the matmul builder, recording the thread and stream of each run
        import threading

        from repro_torch.kernels.model_kernels import matmul_builder

        built = matmul_builder(cfg)

        def run(x, w):
            streams.append((threading.get_ident(), torch.cuda.current_stream().cuda_stream))
            return built(x, w)
        return run

    from repro_torch.dispatch import register
    from repro_torch.kernels.spaces import kernel_space

    register("matmul_on_stream", spy, space=lambda target="gpu": kernel_space("matmul", target))
    try:
        before = real.launches
        out = svc.call("matmul_on_stream", a, b)
        (rec,) = tuner.drain()
        assert tuner.errors == [] and rec is not None
        assert svc.stats["bg_enqueued"] == 1 and real.launches > before + 1
        import threading

        serving = (threading.get_ident(), torch.cuda.current_stream().cuda_stream)
        campaign = [st for st in streams if st != serving]
        assert streams.count(serving) == 1 and campaign
        assert all(t != serving[0] and st != serving[1] for t, st in campaign)
        # a CUDA-event objective: device seconds of one call, microseconds here
        assert 0.0 < rec.objective < 1e-2 and rec.backend == "gpu"
        _close(out, tiled_matmul_plain(a, b, bk=32, pack=True, out_dtype=torch.float32),
               F32_TOL)
    finally:
        tuner.shutdown()


def test_shadow_sample_is_device_time(cuda, tmp_path):
    from repro_torch.core import TimingEvaluator
    from repro_torch.dispatch import DispatchService, TuningStore
    from repro_torch.guard import GuardAgent, ShadowPolicy
    from repro_torch.guard.watch import SHADOW_HISTOGRAM, window_stats
    from repro_torch.kernels.model_kernels import matmul_builder
    from repro_torch.obs import MetricsRegistry

    a, b = _normal(cuda, (1024, 896), (896, 4096))
    svc = DispatchService(TuningStore(str(tmp_path)), metrics=MetricsRegistry())
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=1.0, challenger_fraction=0.0))
    fn = svc.dispatch("matmul", a, b)
    for _ in range(3):      # the library's load and first launch, unsampled
        fn(a, b)
    svc.attach_guard(guard)
    for _ in range(12):
        fn(a, b)
    (w,) = window_stats(None, svc.metrics.snapshot(), SHADOW_HISTOGRAM).values()
    assert w["count"] == 12
    shadow = w["sum"] / w["count"]
    cfg = svc.resolve_config("matmul", ((1024, 896), (896, 4096)))[0]
    timed = TimingEvaluator(lambda c: (matmul_builder(c), (a, b)), repeats=12)(cfg).objective
    assert 0.5 * timed <= shadow <= 2.0 * timed, (shadow, timed)


def test_shadow_clock_starts_at_the_first_launch(cuda):
    # host time before a call's first kernel launch is not in its sample; a
    # call of torch operations alone is timed from the clock's start
    import time

    from repro_torch.core.plopper import LaunchClock

    a, b = _normal(cuda, (256, 256), (256, 256))
    tiled_matmul(a, b)  # the library's load and first launch
    torch.cuda.synchronize()
    clock = LaunchClock((a, b))
    time.sleep(0.02)
    tiled_matmul(a, b)
    launched = clock.stop()
    clock = LaunchClock((a, b))
    time.sleep(0.02)
    torch.matmul(a, b)
    untracked = clock.stop()
    assert 0.0 < launched < 0.01 and untracked >= 0.02, (launched, untracked)


def _profiled_device_sec(fn, calls: int = 3, reps: int = 10) -> float:
    """The most, over ``calls`` profiler sessions of ``reps`` calls of
    ``fn`` each, of the mean per call of the sum of its device kernels,
    copies and fills (torch.profiler), in seconds: the profiler at times
    records only part of a session (a Floyd-Warshall call at N = 1000
    summed 0.0, 0.19 and 0.48 ms in three sessions of one call; a decode
    call and a 25 us matmul, 0.0 in each), and a lost event only lowers a
    sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sums = []
    for _ in range(calls):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
        sums.append(sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / 1e6 / reps)
    assert max(sums) > 0, "the profiler recorded no device time"
    return max(sums)


def _queued_device_sec(fn, calls: int = 20) -> float:
    """Device seconds a call of ``fn``: ``calls`` calls queued behind a spin
    kernel between two CUDA events, so the host's launch path overlaps the
    device's work (chip_smoke.py's phase 7 reads a call so). The spin (about
    10 ms) outlasts the host's path for all the calls, so that none of them
    waits on the host: a call whose kernel is shorter than its host path
    (the split matmul at (4, 896) @ (896, 896), about 7 us) would otherwise
    read the host's pace. The start event must still be pending when the
    last call is queued."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    assert not start.query(), "the host fell behind the spin"
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def _mark_paths(dev):
    """(name, call) of every card path that runs torch work before its first
    launch of a port kernel, at the shapes the main paths give them."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    (data,) = problems.problem_inputs("covariance", problems.LARGE_SHAPES["covariance"], dev)
    (A,) = problems.problem_inputs("lu", problems.LARGE_SHAPES["lu"], dev)
    (W,) = problems.problem_inputs("floyd_warshall", (1000,), dev)
    q, k, v, cp = problems.problem_inputs("decode_attention", (8, 7, 288, 64), dev)
    fq, fk, fv = problems.problem_inputs("flash_attention", (8, 512, 512, 80), dev)
    positions = cp.tolist()  # a host list: the call copies it to the card
    return {
        "covariance, fuse_center=False": (
            lambda: ops.covariance_op(data, config=dict(fuse_center=False)), (data,)),
        "covariance, fuse_center=True": (lambda: ops.covariance_op(data), (data,)),
        "lu at LARGE": (lambda: ops.lu_op(A), (A,)),
        "floyd_warshall at 1000": (lambda: ops.floyd_warshall_op(W), (W,)),
        "decode_attention, positions from a list": (
            lambda: decode_attention(q, k, v, positions), (q, k, v)),
        "flash_attention at hd 80 (padded)": (
            lambda: flash_attention(fq, fk, fv, causal=True), (fq, fk, fv)),
    }


MARK_PATHS = ("covariance, fuse_center=False", "covariance, fuse_center=True", "lu at LARGE",
              "floyd_warshall at 1000", "decode_attention, positions from a list",
              "flash_attention at hd 80 (padded)")


@pytest.mark.parametrize("path", MARK_PATHS)
def test_clock_covers_the_calls_device_kernels(cuda, path):
    # the clock starts at the call's first device operation: the torch work
    # a card path runs before its first launch (a mean and the centring
    # pass, a padded copy, a clone, the positions) is inside the time
    from repro_torch.core.plopper import LaunchClock

    fn, args = _mark_paths(cuda)[path]
    for _ in range(2):
        fn()
    device = _profiled_device_sec(fn)
    clocked = []
    for _ in range(3):
        clock = LaunchClock(args)
        fn()
        clocked.append(clock.stop())
    assert min(clocked) >= 0.95 * device, (path, clocked, device)


@pytest.mark.parametrize("path", ("covariance, fuse_center=False", "lu at LARGE"))
def test_evaluator_times_cover_the_calls_device_kernels(cuda, path):
    # TimingEvaluator times each run from the same point as the guard's
    # shadow samples, so no part of the call's device work is left out
    fn, args = _mark_paths(cuda)[path]
    res = TimingEvaluator(lambda cfg: ((lambda *_: fn()), args), repeats=3)({})
    assert res.ok
    assert res.objective >= 0.95 * _profiled_device_sec(fn), (path, res.info)


def test_clock_ends_at_the_calls_last_launch(cuda):
    # host time after a call's last launch (its return path, here a sleep)
    # is not in its time: each launch records the end mark after it
    import time

    from repro_torch.core.plopper import LaunchClock

    a, b = _normal(cuda, (256, 256), (256, 256))
    tiled_matmul(a, b)  # the library's load and first launch
    torch.cuda.synchronize()
    clock = LaunchClock((a, b))
    tiled_matmul(a, b)
    time.sleep(0.02)
    assert 0.0 < clock.stop() < 0.01


def test_a_small_kernels_objective_is_its_device_time(cuda):
    # a matmul of a few us (the serving shape phase 7 tunes in the
    # background): its objective is within 1.5x of the call's device time
    # (queued behind a spin), not its launch and return paths on the host
    x, w = _normal(cuda, (4, 896), (896, 896))

    def call():
        return tiled_matmul(x, w)

    for _ in range(3):
        call()
    device = min(_queued_device_sec(call) for _ in range(3))
    res = TimingEvaluator(lambda cfg: ((lambda *_: call()), (x, w)), repeats=5)({})
    assert res.ok
    assert 0.9 * device <= res.objective <= 1.5 * device, (res.info, device)


def test_covariance_default_tiles_run_at_large(cuda):
    # the wrapper's own defaults are a point the card takes
    (data,) = problems.problem_inputs("covariance", problems.LARGE_SHAPES["covariance"], cuda)
    _close(covariance(data), covariance_plain(data), COV_TOL)


def test_every_wrappers_default_tiles_pass_its_check_at_large(cuda):
    from repro_torch.kernels.covariance import covariance_check
    from repro_torch.kernels.floyd_warshall import floyd_warshall_check
    from repro_torch.kernels.heat3d import heat3d_check
    from repro_torch.kernels.lu import lu_check
    from repro_torch.kernels.matmul import tiled_matmul_check
    from repro_torch.kernels.syr2k import syr2k_check

    def inputs(name):
        return problems.problem_inputs(name, problems.LARGE_SHAPES[name], cuda)

    C, A, B = inputs("syr2k")
    syr2k_check(C, A, B)
    a, b = _normal(cuda, (1000, 1200), (1200, 1100))
    tiled_matmul_check(a, b)
    lu_check(*inputs("lu"))
    covariance_check(*inputs("covariance"))
    floyd_warshall_check(*inputs("floyd_warshall"))
    heat3d_check(inputs("heat3d")[0], problems.LARGE_SHAPES["heat3d"][1])


def test_smem_budget_refuses_what_the_wrappers_refuse(cuda):
    import itertools

    from repro_torch.analyze import check_config
    from repro_torch.dispatch.registry import get
    from repro_torch.kernels.spaces import GPU_TILES, GPU_TILES_K, kernel_space

    def refused_by_wrapper(kernel, cfg, args, static):
        try:
            get(kernel).builder(cfg, **static).check(*args)
        except ConfigRejected:
            return True
        return False

    for kernel in ("syr2k", "mm3", "lu", "heat3d", "covariance", "floyd_warshall",
                   "flash_attention", "decode_attention", "matmul"):
        dims = problems.LARGE_SHAPES[kernel]
        args = problems.problem_inputs(kernel, dims, cuda)
        static = {"tsteps": dims[1]} if kernel == "heat3d" else {}
        if kernel in ("flash_attention", "decode_attention", "matmul"):
            # the rule asks for bf16 operands (a signature carries no dtype)
            args = tuple(t.to(torch.bfloat16) if t.is_floating_point() else t for t in args)
            static = {"causal": True} if kernel == "flash_attention" else \
                {"ring": False, "window": 0} if kernel == "decode_attention" else {}
        space = kernel_space(kernel, "gpu", seed=2)
        if kernel == "covariance":    # every point
            cfgs = [dict(fuse_center=f, interchange=i, bi=bi, bk=bk, bj=bj)
                    for f, i, bi, bk, bj in itertools.product(
                        (True, False), (True, False), GPU_TILES, GPU_TILES_K, GPU_TILES)]
        else:
            rng = np.random.default_rng(2)
            cfgs = [space.sample_configuration(rng) for _ in range(300)]
        rule = [not check_config(kernel, c, dims=dims, target="gpu").ok for c in cfgs]
        wrapper = [refused_by_wrapper(kernel, c, args, static) for c in cfgs]
        assert rule == wrapper, kernel
        if kernel == "covariance":
            assert sum(rule) == 12 and len(cfgs) == 5324


@pytest.mark.parametrize("hd", [40, 72, 100])
def test_decode_attention_head_sizes_off_the_multiples_of_16(cuda, hd):
    from repro_torch.kernels.decode_attention import (
        CacheRows,
        decode_attention,
        decode_attention_plain,
        decode_ref,
    )

    launches = decode_attention.launches
    for S, bk in ((300, 32), (20, 32)):
        q, k, v, cp = _decode_cases(cuda, 6, 7, S, hd, seed=hd + S)
        full = torch.full((6,), S - 1, dtype=torch.int32, device=cuda)
        _close(decode_attention(q, k, v, full, bk=bk), decode_ref(q, k, v, full), ATTN_TOL)
        got = decode_attention(q, k, v, cp, ring=True, window=50, bk=bk)
        _close(got, decode_attention_plain(q, k, v, cp, ring=True, window=50), ATTN_TOL)
        assert torch.count_nonzero(got[0]) == 0
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        _close(decode_attention(qb, kb, vb, cp, bk=bk), decode_attention_plain(qb, kb, vb, cp),
               ATTN_BF16_TOL)
    # the model's cache layout, read in place (rows not on 16-byte words at hd 100)
    B, S, K, G = 3, 200, 2, 5
    q, kc, vc = _normal(cuda, (B * K, G, hd), (B, S, K, hd), (B, S, K, hd), seed=hd)
    cp = torch.tensor([-1, 4, 199, 250, 100, 31], dtype=torch.int32, device=cuda)
    got = decode_attention(q, CacheRows(kc), CacheRows(vc), cp, bk=64, hg=2)
    _close(got, decode_attention_plain(q, CacheRows(kc).rows(), CacheRows(vc).rows(), cp),
           ATTN_TOL)
    assert decode_attention.launches > launches


@pytest.mark.parametrize("kernel", sorted(problems.LARGE_SHAPES))
def test_cost_model_refuses_exactly_what_smem_budget_refuses(cuda, kernel):
    # the card's own shared-memory numbers: the cost model is +inf exactly
    # where SmemBudget (and so the wrapper) refuses, and finite at the default
    from repro_torch.analyze import feasibility
    from repro_torch.kernels import cost
    from repro_torch.kernels.spaces import kernel_space

    dims = problems.LARGE_SHAPES[kernel]
    ctx = feasibility.RuleContext(kernel=kernel, dims=dims, target="gpu")
    space = kernel_space(kernel, target="gpu", seed=5)
    for cfg in space.sample_configurations(48, np.random.default_rng(5)):
        refused = list(feasibility.SmemBudget().check(cfg, ctx))
        t, info = cost.kernel_cost(kernel, cfg, *dims)
        assert np.isinf(t) == bool(refused), (cfg, refused, info)
        if not refused:
            assert info["smem_bytes"] <= max_shared_memory_per_block(cuda)
    assert np.isfinite(cost.kernel_cost(kernel, space.default_configuration(), *dims)[0])
    assert cost.hopper().sms == torch.cuda.get_device_properties(0).multi_processor_count


# ---------------------------------------------------------------------------
# the MoE family on the card: routed experts, MLA, launches per decode step
# ---------------------------------------------------------------------------

MOE_ARCHS = ("mixtral-8x7b", "deepseek-v2-236b")


def _reduced_model(arch, device, dtype=torch.float32):
    """The reduced config of ``arch`` in ``dtype``, weights drawn on the CPU
    from a seed, and a copy of them on ``device``."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params, _tree_to(params, device)


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["no-drop", "drops"])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, cf):
    from repro_torch.models.moe import init_moe, moe_ffn

    p = init_moe(torch.Generator().manual_seed(1), 32, 48, n_experts=6, n_shared=1,
                 dtype=torch.float32)
    x = torch.randn(3, 10, 32, generator=torch.Generator().manual_seed(2))
    want, want_aux = moe_ffn(p, x, top_k=2, capacity_factor=cf, group_size=12)
    got, aux = moe_ffn(_tree_to(p, cuda), x.to(cuda), top_k=2, capacity_factor=cf,
                       group_size=12)
    _close(got, want, dict(atol=1e-5, rtol=1e-4))
    _close(aux, want_aux, dict(atol=1e-6, rtol=1e-5))


@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "naive"])
def test_mla_decode_on_the_card_matches_the_cpu(cuda, absorb):
    from repro_torch.models.mla import init_mla_cache, mla_decode

    cfg, params, params_gpu = _reduced_model("deepseek-v2-236b", cuda)
    p, pg = params["dense0"]["mla"], params_gpu["dense0"]["mla"]
    xs = torch.randn(5, 2, 1, cfg.d_model, generator=torch.Generator().manual_seed(3))
    cache = init_mla_cache(cfg, 2, 8, torch.float32)
    cache_gpu = init_mla_cache(cfg, 2, 8, torch.float32, cuda)
    for t in range(5):
        want, cache = mla_decode(p, xs[t], cache, cfg, t, absorb=absorb)
        got, cache_gpu = mla_decode(pg, xs[t].to(cuda), cache_gpu, cfg, t, absorb=absorb)
        _close(got, want, dict(atol=1e-5, rtol=1e-4))
    _close(cache_gpu["c_kv"], cache["c_kv"], dict(atol=1e-5, rtol=1e-4))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_greedy_on_the_card_matches_the_cpu(cuda, arch):
    from repro_torch.dispatch import DispatchService
    from repro_torch.serve import greedy_decode

    cfg, params, params_gpu = _reduced_model(arch, cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 7), generator=torch.Generator().manual_seed(4))
    want = greedy_decode(params, cfg, prompt, steps=12, max_len=20,
                         service=DispatchService())
    got = greedy_decode(params_gpu, cfg, prompt.to(cuda), steps=12, max_len=20,
                        service=DispatchService())
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_step_launches_the_matmul(cuda, arch):
    """mixtral: each layer's output projection and the unembed; deepseek:
    the unembed (MLA's output projection is a plain product, as in the JAX
    package); neither reaches the attention kernels (a window, MLA)."""
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import decode_step, forward, init_cache

    cfg, _, params = _reduced_model(arch, cuda)
    svc = DispatchService()
    want = cfg.n_layers + 1 if cfg.attn_type == "gqa" else 1
    toks = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda)
    before = (flash_attention.launches, decode_attention.launches, tiled_matmul.launches)
    forward(params, {"tokens": toks}, cfg, service=svc)
    cache = init_cache(cfg, 2, 12, device=cuda)
    mid = tiled_matmul.launches
    logits, _ = decode_step(params, cache, toks[:, :1], 0, cfg, service=svc)
    torch.cuda.synchronize()
    assert mid - before[2] == want and tiled_matmul.launches - mid == want
    assert (flash_attention.launches, decode_attention.launches) == before[:2]
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the SSM, hybrid and VLM families on the card: tokens, launches, f32 state
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2-780m", "zamba2-1.2b", "qwen2-vl-7b")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_hybrid_vlm_on_the_card_match_the_cpu(cuda, arch):
    """Forward logits (SSD chunk 4: two chunks) and 8 greedy tokens of the
    reduced arch through the dispatch service: the card's kernels against
    the CPU's plain versions on the same weights."""
    from repro_torch.dispatch import DispatchService
    from repro_torch.models import forward
    from repro_torch.serve import greedy_decode

    cfg, params, params_gpu = _reduced_model(arch, cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(4))
    want, _ = forward(params, {"tokens": prompt}, cfg, ssm_chunk=4, service=DispatchService())
    got, _ = forward(params_gpu, {"tokens": prompt.to(cuda)}, cfg, ssm_chunk=4,
                     service=DispatchService())
    _close(got, want, dict(atol=1e-4, rtol=1e-3))
    want = greedy_decode(params, cfg, prompt, steps=8, max_len=16, service=DispatchService())
    got = greedy_decode(params_gpu, cfg, prompt.to(cuda), steps=8, max_len=16,
                        service=DispatchService())
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("arch,per_forward,per_step", [
    # mamba2: the unembed alone; zamba2 (5 layers, attention every 2: 3
    # sites, G = 1): a flash call, a decode launch and an output projection
    # a site, and the unembed; qwen2-vl (2 layers, G = 2): 2 flash calls, a
    # decode launch and an output projection a layer, and the unembed
    ("mamba2-780m", (0, 1), (0, 1)),
    ("zamba2-1.2b", (3, 4), (3, 4)),
    ("qwen2-vl-7b", (4, 3), (2, 3)),
])
def test_ssm_hybrid_vlm_launches_per_forward_and_step(cuda, arch, per_forward, per_step):
    """(attention kernel, matmul) launches of one forward (flash) and of one
    decode step (decode_attention)."""
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import decode_step, forward, init_cache

    cfg, _, params = _reduced_model(arch, cuda)
    svc = DispatchService()
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda)
    f0, d0, m0 = flash_attention.launches, decode_attention.launches, tiled_matmul.launches
    forward(params, {"tokens": toks}, cfg, service=svc)
    f1, d1, m1 = flash_attention.launches, decode_attention.launches, tiled_matmul.launches
    cache = init_cache(cfg, 2, 12, device=cuda)
    logits, _ = decode_step(params, cache, toks[:, :1], 0, cfg, service=svc)
    torch.cuda.synchronize()
    assert (f1 - f0, m1 - m0) == per_forward and d1 == d0
    assert (decode_attention.launches - d1, tiled_matmul.launches - m1) == per_step
    assert flash_attention.launches == f1 and torch.isfinite(logits).all()


def test_ssd_state_stays_f32_under_bf16_on_the_card(cuda):
    """A bf16 mamba2: the conv window and SSM state stay f32 through decode
    steps on the card (against the CPU's at bf16's tolerance), and the
    chunked scan's final state is f32."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.ssm import ssd

    cfg, params, params_gpu = _reduced_model("mamba2-780m", cuda, torch.bfloat16)
    caches = [init_cache(cfg, 2, 8), init_cache(cfg, 2, 8, device=cuda)]
    toks = torch.randint(0, cfg.vocab_size, (2, 4), generator=torch.Generator().manual_seed(5))
    for t in range(4):
        want, _ = decode_step(params, caches[0], toks[:, t:t + 1], t, cfg)
        got, _ = decode_step(params_gpu, caches[1], toks[:, t:t + 1].to(cuda), t, cfg)
        _close(got, want, dict(atol=3e-2, rtol=3e-2))
    for name in ("conv", "ssm"):
        assert caches[1]["layers"][name].dtype == torch.float32
        _close(caches[1]["layers"][name], caches[0]["layers"][name], dict(atol=3e-2, rtol=3e-2))
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(2, 16, 4, 8, generator=g, device=cuda).to(torch.bfloat16)
    dt = torch.rand(2, 16, 4, generator=g, device=cuda)
    A = -torch.rand(4, generator=g, device=cuda)
    B, C = (torch.randn(2, 16, 8, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    y, h = ssd(x, dt, A, B, C, chunk=8)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32 and torch.isfinite(h).all()


# ---------------------------------------------------------------------------
# training on the card: the step passes no dispatch service, as the JAX
# package's does, so it launches no hand-written kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x7b", "mamba2-780m"])
def test_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Three reduced train steps from the same weights and batches: the
    losses and grad norms of the card within 1e-4 of the CPU's (cuBLAS
    against the CPU's BLAS, f32), and no kernel launched."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.models import init_params, trainable
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    base = trainable(init_params(cfg, torch.Generator().manual_seed(0)))
    before = tiled_matmul.launches
    out = {}
    for dev in (torch.device("cpu"), cuda):
        params = tree_map(lambda t: t.to(dev, copy=True), base)
        opt = init_train_state(params)
        step = make_train_step(cfg, lr=1e-3, ssm_chunk=8)
        stream = SyntheticLM(cfg.vocab_size, 16, 4, seed=1)
        metrics = []
        for s in range(3):
            params, opt, m = step(params, opt, make_batch(stream, s, dev))
            assert m["loss"].device.type == dev.type
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        out[dev.type] = metrics
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)
    assert tiled_matmul.launches == before


def test_async_checkpoint_of_cuda_tensors_is_the_steps_own(cuda, tmp_path):
    """The snapshot holds every update queued before ``save`` and none of
    those after it, though the loop updates the tensors in place at once."""
    from repro_torch.ckpt import AsyncCheckpointer, restore

    w = torch.zeros(4_000_000, device=cuda)
    state = {"w": w, "step": torch.zeros((), dtype=torch.int32, device=cuda)}
    for _ in range(50):
        w.add_(1.0)
    state["step"] += 50
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(state, step=50)
    w.add_(1000.0)
    state["step"] += 1
    ck.close()
    got, step = restore(str(tmp_path), state)
    assert step == 50 and got["w"].device == w.device
    assert torch.equal(got["w"], torch.full_like(w, 50.0)) and int(got["step"]) == 50


def test_train_cli_resumes_on_the_card(cuda, tmp_path, capsys):
    from repro_torch.launch import train as train_cli

    argv = ["--reduced", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    assert train_cli.main(argv + ["--steps", "4", "--ckpt-every", "2"]) == 0
    assert "device=cuda" in capsys.readouterr().out
    r = train_cli.run(reduced=True, batch=2, seq=16, steps=6, ckpt_dir=str(tmp_path))
    assert "resumed from step 4" in capsys.readouterr().out
    assert r["start"] == 4 and r["device"].startswith("cuda") and r["peak_bytes"] > 0
    assert all(np.isfinite(r["losses"]))


def test_threads_launching_one_kernel_with_different_shared_memory(cuda):
    """Host threads (the background tuner's workers beside the serving
    thread) launch one matmul instantiation at once with tiles whose shared
    memory differs past 48 KB: no launch fails. Each launch used to set the
    kernel's cap to its own bytes, so one thread could lower it under
    another's launch ("invalid argument"); the cap is now the device's
    opt-in maximum."""
    import threading

    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(1024, 896, device=cuda, generator=g)
    b = torch.randn(896, 896, device=cuda, generator=g)
    tiles = [dict(bm=128, bn=128, bk=32), dict(bm=96, bn=128, bk=192),
             dict(bm=64, bn=128, bk=64), dict(bm=128, bn=96, bk=128)]
    assert all(matmul_smem_bytes(t["bm"], t["bn"], t["bk"]) > 48 * 1024 for t in tiles)
    errors = []

    def worker(k):
        stream = torch.cuda.Stream(device=cuda)
        with torch.cuda.stream(stream):
            for i in range(1000):
                try:
                    tiled_matmul(a, b, **tiles[(i + k) % len(tiles)])
                except RuntimeError as e:
                    errors.append(str(e))
                    break
        stream.synchronize()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and errors == []
    want = a @ b
    for t in tiles:
        _close(tiled_matmul(a, b, **t), want, dict(atol=1e-4, rtol=1e-4))


# ---------------------------------------------------------------------------
# the audio family on the card: the unembed's ragged N, tokens, launches
# ---------------------------------------------------------------------------

WHISPER = "whisper-large-v3"


@pytest.mark.parametrize("rows", [4, 256], ids=["decode", "forward"])
def test_matmul_at_the_whisper_unembed(cuda, rows):
    """(rows, 1280) @ (1280, 51,866) through the dispatch service at its
    default config, as the model calls it: 51,866 x 4 bytes is no whole
    number of 16-byte words, so neither operand is read by 16-byte copies
    (4 rows: the FFMA 8-row tile; 256: 3xTF32), on a NaN-poisoned output."""
    from repro_torch.dispatch import DispatchService

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(rows, 1280, generator=g, device=cuda)
    w = torch.randn(1280, 51866, generator=g, device=cuda) / 1280 ** 0.5
    fn = DispatchService().dispatch("matmul", x, w)
    torch.full((rows, 51866), float("nan"), device=cuda)
    before = tiled_matmul.launches
    got = fn(x, w)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1 and torch.isfinite(got).all()
    _close(got, tiled_matmul_plain(x, w, bk=32, pack=True, out_dtype=torch.float32), F32_TOL)


@pytest.mark.parametrize("rows", [8, 64])
@pytest.mark.parametrize("pack", [True, False])
def test_matmul_ragged_n_two_past_a_multiple_of_4(cuda, rows, pack):
    # N % 4 == 2, as the whisper unembed's: 4-byte copies for both operands,
    # on the FFMA 8-row tile (element-wise stores) and on 3xTF32 (8-byte
    # stores: N is even)
    a, b = problems.problem_inputs("mm3", (rows, 96, 1002, 1, 1), cuda)[:2]
    torch.full((rows, 1002), float("nan"), device=cuda)
    got = tiled_matmul(a, b, bm=64, bn=64, bk=32, pack=pack)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, tiled_matmul_plain(a, b, bk=32, pack=pack, out_dtype=torch.float32), F32_TOL)


def test_whisper_on_the_card_matches_the_cpu(cuda):
    """Reduced whisper through the dispatch service: forward logits and 8
    greedy tokens (the prefill fills the cross cache from the encoder) on
    the card against the CPU's plain versions, the same weights and frames;
    one tiled matmul a forward and one a decode step (the unembed), no
    attention kernel (the encoder and decoder pass no service)."""
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import decode_step, forward
    from repro_torch.serve import greedy_decode, prefill

    cfg, params, params_gpu = _reduced_model(WHISPER, cuda)
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (2, 7), generator=gen)
    frames = torch.randn(2, cfg.encoder_len, cfg.d_model, generator=gen)
    batch = {"tokens": prompt, "enc_embed": frames}
    batch_gpu = {k: v.to(cuda) for k, v in batch.items()}
    want, _ = forward(params, batch, cfg, service=DispatchService())
    f0, d0, m0 = flash_attention.launches, decode_attention.launches, tiled_matmul.launches
    svc = DispatchService()
    got, _ = forward(params_gpu, batch_gpu, cfg, service=svc)
    m1 = tiled_matmul.launches
    _, cache = prefill(params_gpu, batch_gpu, cfg, max_len=16, service=svc)
    m2 = tiled_matmul.launches
    decode_step(params_gpu, cache, prompt[:, :1].to(cuda), 7, cfg, service=svc)
    torch.cuda.synchronize()
    assert (m1 - m0, m2 - m1, tiled_matmul.launches - m2) == (1, 1 + 7, 1)
    assert (flash_attention.launches, decode_attention.launches) == (f0, d0)
    _close(got, want, dict(atol=1e-4, rtol=1e-3))
    want = greedy_decode(params, cfg, prompt, steps=8, max_len=16, service=DispatchService(),
                         enc_embed=frames)
    got = greedy_decode(params_gpu, cfg, prompt.to(cuda), steps=8, max_len=16,
                        service=DispatchService(), enc_embed=frames.to(cuda))
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# serving under load: the benchmark on the card, the injected latency the
# drift watch reads, and the signatures of gemma3-1b, minitron-4b and
# qwen1.5-0.5b at full width
# ---------------------------------------------------------------------------

def test_serve_bench_quick_on_the_card(cuda, tmp_path, capsys):
    """``benchmarks/torch_serve_bench.py --quick --reduced --inject-drift``
    on the card: exit 0; the kernels run in the default and tuned modes and
    none in the einsum mode; every request's ids equal across the three
    modes; the drift loop quarantines and falls back, read from the shadow
    samples' device time; the JSON stamped with the card."""
    import json

    from benchmarks import torch_serve_bench as tsb

    record = {}
    out = tmp_path / "b.json"
    rc = tsb.main(["--quick", "--reduced", "--inject-drift", "--store", str(tmp_path / "s"),
                   "--out", str(out), "--obs-out", str(tmp_path / "b.obs.jsonl")],
                  record=record)
    text = capsys.readouterr().out
    assert rc == 0, text
    modes = record["modes"]
    assert set(modes["einsum"]["launches"].values()) == {0}
    for mode in ("default", "tuned"):
        assert min(modes[mode]["launches"].values()) >= 1, modes[mode]["launches"]
    assert modes["einsum"]["ids"] == modes["default"]["ids"] == modes["tuned"]["ids"]
    data = json.loads(out.read_text())
    assert data["meta"]["card"] is not None and data["modes"]["tuned"]["page_axis"] == \
        "drawn by the bench"
    g = data["guard"]
    assert g["watched_histogram"] == "dispatch_shadow_seconds" and g["drift_ok"] \
        and g["fallback_ok"]


def test_injected_latency_is_in_a_shadow_samples_device_time(cuda, tmp_path):
    """On the card ``dispatch.latency`` spins the call's stream after its
    launches, inside the shadow clock's interval (a host sleep before the
    first launch would not be), and stays off the host's enqueue path."""
    from repro_torch.dispatch import DispatchService, TuningStore
    from repro_torch.guard import GuardAgent, ShadowPolicy, inject
    from repro_torch.guard.watch import SHADOW_HISTOGRAM, window_stats
    from repro_torch.obs import MetricsRegistry

    a, b = _normal(cuda, (4, 896), (896, 896))
    svc = DispatchService(TuningStore(str(tmp_path)), metrics=MetricsRegistry())
    fn = svc.dispatch("matmul", a, b)
    fn(a, b)
    svc.attach_guard(GuardAgent(svc, shadow=ShadowPolicy(epsilon=1.0,
                                                         challenger_fraction=0.0)))
    for _ in range(4):
        fn(a, b)
    base = svc.metrics.snapshot()
    with inject("dispatch.latency", delay_sec=0.02, where={"kernel": "matmul"}):
        for _ in range(4):
            fn(a, b)
    (clean,) = window_stats(None, base, SHADOW_HISTOGRAM).values()
    (slow,) = window_stats(base, svc.metrics.snapshot(), SHADOW_HISTOGRAM).values()
    assert clean["count"] == slow["count"] == 4
    assert clean["sum"] / 4 < 0.002 and 0.015 <= slow["sum"] / 4 <= 0.1, (clean, slow)
    torch.cuda.synchronize()
    _close(fn(a, b), tiled_matmul_plain(a, b, bk=32, pack=True, out_dtype=torch.float32),
           F32_TOL)


# (label, rows, K, N): the output projection and the unembed of each, at a
# decode step's 4 rows and a forward's B * P (gemma3: a prompt of 520, past
# its window of 512)
CATALOG_MATMULS = (
    ("gemma3-1b output projection", 4, 1024, 1152),
    ("gemma3-1b output projection", 2080, 1024, 1152),
    ("gemma3-1b tied unembed", 4, 1152, 262144),
    ("gemma3-1b tied unembed", 2080, 1152, 262144),
    ("minitron-4b output projection", 4, 3072, 3072),
    ("minitron-4b output projection", 512, 3072, 3072),
    ("minitron-4b unembed", 4, 3072, 256000),
    ("minitron-4b unembed", 512, 3072, 256000),
    ("qwen1.5-0.5b output projection", 4, 1024, 1024),
    ("qwen1.5-0.5b output projection", 512, 1024, 1024),
    ("qwen1.5-0.5b tied unembed", 4, 1024, 151936),
    ("qwen1.5-0.5b tied unembed", 512, 1024, 151936),
)


@pytest.mark.parametrize("label,rows,K,N", CATALOG_MATMULS,
                         ids=[f"{c[0].split()[0]}-{c[0].split()[-1]}-{c[1]}"
                              for c in CATALOG_MATMULS])
def test_matmul_at_the_catalogs_signatures(cuda, label, rows, K, N):
    """The tiled matmul at its default config through the dispatch service,
    as the model calls it (4 rows: the FFMA 8-row tile; more: 3xTF32), on a
    NaN-poisoned output, against its plain version."""
    from repro_torch.dispatch import DispatchService

    g = torch.Generator(device=cuda).manual_seed(rows + N)
    x = torch.randn(rows, K, generator=g, device=cuda)
    w = torch.randn(K, N, generator=g, device=cuda) / K ** 0.5
    fn = DispatchService().dispatch("matmul", x, w)
    torch.full((rows, N), float("nan"), device=cuda)
    before = tiled_matmul.launches
    got = fn(x, w)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1 and torch.isfinite(got).all()
    _close(got, torch.matmul(x, w), F32_TOL)


# (arch, batch, kv heads, query heads per kv head, head size, prompt)
CATALOG_ATTENTION = (("minitron-4b", 4, 8, 3, 128, 128), ("qwen1.5-0.5b", 4, 16, 1, 64, 128))


@pytest.mark.parametrize("arch,B,K,G,hd,P", CATALOG_ATTENTION, ids=[c[0] for c in
                                                                   CATALOG_ATTENTION])
def test_attention_at_the_catalogs_signatures(cuda, arch, B, K, G, hd, P):
    """flash_attention at the prompt's (B*K, P, hd), causal, and
    decode_attention against the model's (B, S, K, hd) cache read in place
    at per-row positions, through the dispatch service at their defaults,
    each against its plain version."""
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import (
        CacheRows,
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    svc = DispatchService()
    q, k, v = _normal(cuda, (B * K, P, hd), (B * K, P, hd), (B * K, P, hd), seed=1)
    f0, d0 = flash_attention.launches, decode_attention.launches
    got = svc.dispatch("flash_attention", q, k, v, causal=True)(q, k, v)
    _close(got, flash_attention_plain(q, k, v, causal=True), ATTN_TOL)
    S = P + 16
    qd, kc, vc = _normal(cuda, (B * K, G, hd), (B, S, K, hd), (B, S, K, hd), seed=2)
    cp = torch.randint(0, S, (B * K,), generator=torch.Generator().manual_seed(3),
                       dtype=torch.int32).to(cuda)
    cp[0] = P
    kr, vr = CacheRows(kc), CacheRows(vc)
    fn = svc.dispatch("decode_attention", qd, kr, vr, cp, ring=False, window=0)
    _close(fn(qd, kr, vr, cp), decode_attention_plain(qd, kr, vr, cp), ATTN_TOL)
    torch.cuda.synchronize()
    assert flash_attention.launches > f0 and decode_attention.launches > d0


@pytest.mark.parametrize("bsz", [1, 2, 4, 8])
def test_decode_attention_at_the_bench_ladder(cuda, bsz):
    """qwen2-0.5b's decode (2 kv heads, G = 7, hd 64) at the serving
    benchmark's batch ladder, across page-aligned buckets of every page size
    and the full allocation of 1024, per-row positions, against its plain
    version at the gpu space's default and every bk/hg of the space."""
    from repro_torch.kernels.decode_attention import (
        CacheRows,
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.kernels.spaces import kernel_space

    space = kernel_space("decode_attention", target="gpu")
    gen = torch.Generator().manual_seed(bsz)
    for S in (8, 16, 40, 64, 96, 128, 1024):
        q, kc, vc = _normal(cuda, (bsz * 2, 7, 64), (bsz, S, 2, 64), (bsz, S, 2, 64),
                            seed=S)
        cp = torch.randint(0, S, (bsz * 2,), generator=gen, dtype=torch.int32).to(cuda)
        kr, vr = CacheRows(kc), CacheRows(vc)
        want = decode_attention_plain(q, kr, vr, cp)
        for bk in space["bk"].sequence:
            for hg in space["hg"].sequence:
                _close(decode_attention(q, kr, vr, cp, bk=bk, hg=hg), want, ATTN_TOL)


# ---------------------------------------------------------------------------
# parallelism on the card's own mesh (chip_smoke.py phase 16 (b), (c))
# ---------------------------------------------------------------------------


def test_a_dtensor_train_step_on_the_cards_mesh_equals_the_plain_step(cuda):
    """Reduced qwen2-0.5b in f32: params and moments as DTensors on the
    (1, 1) NCCL mesh with act_spec/logits_spec. Step 0's gradients equal the
    plain step's at f32 tolerance (atol 1e-6, rtol 1e-5), 3 steps' losses
    within 1e-6 relative, and after 3 steps each param element equals the
    plain one at atol 1e-6 + rtol 1e-5, except the elements whose plain
    gradient, at some step, was non-zero and below ``floor`` (1e-4) of that
    step's largest gradient element: there the two paths' f32 sums (in
    other orders) decide the sign and size of Adam's update, which is about
    lr whatever the gradient's size, so those are held to Adam's bound, 2 lr
    a step, and counted (printed; at most a twentieth of the elements). On
    the H100 (700 W) 818 of 90688 elements were under the floor, the
    elements above it stayed within 0.09 of their tolerance, and under it
    the k bias's (gradients near 4e-7) went 22x past it."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.models import init_params, trainable
    from repro_torch.parallel import Spec, batch_specs, distribute, make_profile, param_specs
    from repro_torch.parallel.sharding import named
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import make_grad_step
    from repro_torch.tree import tree_leaves, tree_map

    lr, steps, floor = 1e-3, 3, 1e-4
    cfg = dataclasses.replace(get_reduced("qwen2-0.5b"), dtype=torch.float32)
    params = trainable(init_params(cfg, torch.Generator(device=cuda).manual_seed(0)))
    stream = SyntheticLM(cfg.vocab_size, 32, 4, seed=1)
    step = make_train_step(cfg, lr=lr)
    grads_of = make_grad_step(cfg)
    opt = init_train_state(params)
    noise = [torch.zeros_like(p, dtype=torch.bool) for p in tree_leaves(params)]
    with local_mesh(cuda) as mesh:
        prof = make_profile(mesh, "train", 4)
        specs = param_specs(params, mesh, prof, cfg)
        params_d = distribute(tree_map(torch.clone, params), mesh, specs)
        opt_d = distribute(init_train_state(params), mesh,
                           {"m": specs, "v": specs, "step": Spec()})
        act_spec = named(mesh, Spec(("data",), None, None))
        logits_spec = named(mesh, Spec(("data",), None, "model"))
        step_d = make_train_step(cfg, lr=lr, act_spec=act_spec, logits_spec=logits_spec)
        for s in range(steps):
            b = make_batch(stream, s, cuda)
            b_d = distribute(b, mesh, batch_specs(b, mesh, prof))
            _, _, grads = grads_of(params, b)
            top = max(float(g.abs().max()) for g in grads)
            for n, g in zip(noise, grads):
                n |= (g != 0) & (g.abs() < floor * top)
            if s == 0:
                _, _, grads_d = make_grad_step(cfg, act_spec=act_spec,
                                               logits_spec=logits_spec)(params_d, b_d)
                for gd, g in zip(grads_d, grads):
                    torch.testing.assert_close(gd.full_tensor(), g, atol=1e-6, rtol=1e-5)
            _, _, m = step(params, opt, b)
            _, _, md = step_d(params_d, opt_d, b_d)
            want, got = float(m["loss"]), float(md["loss"].full_tensor())
            assert abs(got - want) <= 1e-6 * abs(want), (s, got, want)
        under = sum(int(n.sum()) for n in noise)
        total = sum(n.numel() for n in noise)
        print(f"{under} of {total} elements under the noise floor")
        assert under <= total // 20
        for a, b, n in zip(tree_leaves(params_d), tree_leaves(params), noise):
            a = a.full_tensor()
            torch.testing.assert_close(a[~n], b[~n], atol=1e-6, rtol=1e-5)
            if n.any():
                assert float((a[n] - b[n]).abs().max()) <= steps * 2 * lr


@pytest.mark.parametrize("dtype,wire", [(None, "float32"), (torch.bfloat16, "bfloat16"),
                                        (torch.int8, "int8")])
def test_compressed_psum_over_nccl_sends_its_payloads_dtype(cuda, dtype, wire):
    import torch.distributed as dist

    from repro_torch.ft.compression import compressed_psum
    from repro_torch.launch.mesh import local_mesh
    from repro_torch.perf.op_cost import trace_step

    x = torch.randn(4096, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)

    def psum(v):
        if dtype is None:
            v = v.clone()
            dist.all_reduce(v)
            return v
        return compressed_psum(v, dtype=dtype)

    with local_mesh(cuda):
        trace = trace_step(psum, x)
    torch.cuda.synchronize()
    assert wire in trace.payload_dtypes["all-reduce"]
    per_value = {"float32": 4, "bfloat16": 2, "int8": 1}[wire]
    assert trace.cost.coll_by_kind["all-reduce"] == pytest.approx(per_value * x.numel(),
                                                                 abs=8)
    bound = {"float32": 0.0, "bfloat16": float(x.abs().max()) * 2 ** -8,
             "int8": float(x.abs().max()) / 127 * 0.5 + 1e-6}[wire]
    assert float((trace.result - x).abs().max()) <= bound


def test_step_cost_counts_a_plain_train_step_on_the_card(cuda):
    """The counter on CUDA tensors: the reduced train step's FLOPs equal its
    count on meta tensors (the counter reads shapes), and it launches none
    of the kernels of the table."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import abstract_params, init_params, trainable
    from repro_torch.perf.op_cost import step_cost
    from repro_torch.train import init_train_state, make_train_step

    cfg = dataclasses.replace(get_reduced("qwen1.5-0.5b"), dtype=torch.float32)
    params = trainable(init_params(cfg, torch.Generator(device=cuda).manual_seed(0)))
    batch = {k: torch.zeros(2, 16, dtype=torch.int64, device=cuda) for k in ("tokens", "labels")}
    got = step_cost(make_train_step(cfg), params, init_train_state(params), batch)
    meta = abstract_params(cfg)
    mbatch = {k: torch.zeros(2, 16, dtype=torch.int64, device="meta") for k in batch}
    want = step_cost(make_train_step(cfg), meta, init_train_state(meta), mbatch)
    assert got.flops == want.flops > 0


# ---------------------------------------------------------------------------
# bf16 on the tensor cores (csrc/gemm_bf16.cuh) and bf16 serving
# ---------------------------------------------------------------------------


def _bf16_operands(device, M, K, N, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return ((torch.randn(M, K, device=device, generator=g) / K ** 0.5).bfloat16(),
            (torch.randn(K, N, device=device, generator=g) / N ** 0.5).bfloat16())


def test_matmul_bf16_at_every_gpu_tile(cuda):
    """Every tile of the gpu space (11 x 11 row and column tiles, 11 chunks:
    8-row tiles on the FFMA loop, the rest on the tensor cores, chunks of 4,
    8 and 24 padded to the mma's 16) at a ragged and an aligned shape."""
    from repro_torch.kernels.spaces import GPU_TILES, GPU_TILES_K

    for M, K, N in ((97, 203, 77), (200, 136, 520)):
        a, b = _bf16_operands(cuda, M, K, N)
        for bm in GPU_TILES:
            for bn in GPU_TILES:
                for bk in GPU_TILES_K:
                    got = tiled_matmul(a, b, bm=bm, bn=bn, bk=bk)
                    _close(got, tiled_matmul_plain(a, b, bk=min(bk, K), pack=True,
                                                   out_dtype=torch.bfloat16), BF16_TOL)


@pytest.mark.parametrize("shape", [(512, 896, 4864), (512, 4096, 4096), (128, 3584, 18944),
                                   (4, 896, 151936)])
@pytest.mark.parametrize("pack", [True, False])
def test_matmul_bf16_at_the_served_shapes(cuda, shape, pack):
    """The served products (qwen2-0.5b's MLP width, mixtral's output
    projection, qwen2-vl's MLP, the decode unembed), output bf16 and f32,
    either raster order."""
    M, K, N = shape
    a, b = _bf16_operands(cuda, M, K, N, seed=1)
    for bm, bn, bk, inter in ((64, 64, 32, False), (128, 128, 64, True), (40, 96, 24, False),
                              (4, 128, 64, False)):
        for out in (torch.bfloat16, torch.float32):
            got = tiled_matmul(a, b, bm=bm, bn=bn, bk=bk, pack=pack, interchange=inter,
                               out_dtype=out)
            assert got.dtype == out
            _close(got, tiled_matmul_plain(a, b, bk=bk, pack=pack, out_dtype=out),
                   BF16_TOL if out == torch.bfloat16 or not pack else F32_TOL)


@pytest.mark.parametrize("bm,dtype,tc", [(64, torch.bfloat16, 1), (16, torch.bfloat16, 1),
                                         (8, torch.bfloat16, 0), (4, torch.bfloat16, 0),
                                         (64, torch.float32, 0)])
def test_matmul_counts_the_route_the_kernel_reports(cuda, bm, dtype, tc):
    """bf16_tc_launches counts the launches that matmul_launch reports on
    the tensor cores with bf16 operands: tiles past 8 rows (wgmma); tiles of
    at most 8 rows take the split stream, and f32 is not counted."""
    a, b = (t.to(dtype) for t in _bf16_operands(cuda, 64, 96, 80, seed=3))
    before = tiled_matmul.bf16_tc_launches
    routes = dict(tiled_matmul.route_launches)
    tiled_matmul(a, b, bm=bm, bn=64, bk=32)
    assert tiled_matmul.bf16_tc_launches == before + tc
    want = "split" if bm <= 8 else "wgmma" if dtype == torch.bfloat16 else "mma_sync"
    assert {k: v - routes[k] for k, v in tiled_matmul.route_launches.items()} == {
        r: int(r == want) for r in routes}


def test_a_bf16_call_runs_a_record_tuned_on_f32_operands(cuda, tmp_path):
    """A store record carries no dtype, so a record tuned on f32 operands
    resolves a bf16 call of the same shape: the tile runs on the bf16 path
    (here past 8 rows: the tensor cores) as an exact hit."""
    from repro_torch.dispatch import DispatchService, TuningRecord, TuningStore
    from repro_torch.dispatch.signature import shape_signature

    a, b = _bf16_operands(cuda, 512, 896, 4864, seed=2)
    store = TuningStore(str(tmp_path))
    cfg = dict(bm=48, bn=112, bk=24, pack=True, interchange=True)
    store.put(TuningRecord("matmul", shape_signature([a.float(), b.float()]), "gpu", cfg,
                           1e-5))
    svc = DispatchService(store)
    before, before_tc = tiled_matmul.launches, tiled_matmul.bf16_tc_launches
    got = svc.call("matmul", a, b)
    torch.cuda.synchronize()
    assert svc.stats["store_exact"] == 1 and svc.stats["build_failed"] == 0
    assert tiled_matmul.launches == before + 1 and got.dtype == torch.bfloat16
    assert tiled_matmul.bf16_tc_launches == before_tc + 1
    _close(got, tiled_matmul_plain(a, b, bk=24, pack=True, out_dtype=torch.bfloat16),
           BF16_TOL)


BF16_ARCHS = ("qwen2-0.5b", "mixtral-8x7b", "mamba2-780m", "qwen2-vl-7b")
# the reduced bf16 models' logits, card against CPU, relative to their
# largest |logit|: the two round bf16 at other places (cuBLAS and the
# kernels against the CPU's plain versions)
BF16_MARGIN = 0.03


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_greedy_on_the_card_matches_the_cpu_up_to_a_near_tie(cuda, arch):
    """A bf16 greedy_decode with a service, on the card and on the CPU, on
    the same weights: tokens equal up to the first step whose top-2 margin
    in the CPU's teacher-forced logits is under BF16_MARGIN of the largest
    |logit|."""
    from repro_torch.dispatch import DispatchService
    from repro_torch.models import forward
    from repro_torch.serve import greedy_decode

    cfg, params, params_gpu = _reduced_model(arch, cuda, torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(4))
    steps = 8
    want = greedy_decode(params, cfg, prompt, steps=steps, max_len=16,
                         service=DispatchService())
    got = greedy_decode(params_gpu, cfg, prompt.to(cuda), steps=steps, max_len=16,
                        service=DispatchService()).cpu()
    logits, _ = forward(params, {"tokens": torch.cat([prompt, want], 1)}, cfg)
    top2 = logits[:, 7:7 + steps].topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).min(dim=0).values
    scale = float(logits.abs().max())
    for i in range(steps):
        if margin[i] < BF16_MARGIN * scale:
            break
        assert torch.equal(got[:, i], want[:, i]), (arch, i)


# ---------------------------------------------------------------------------
# the matmul's split stream (tiles of at most 8 rows) and its wgmma route
# (bf16 past 8 rows): every gpu tile, ragged shapes, the route each call takes
# ---------------------------------------------------------------------------


def _operands(device, M, K, N, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return ((torch.randn(M, K, device=device, generator=g) / K ** 0.5).to(dtype),
            (torch.randn(K, N, device=device, generator=g) / N ** 0.5).to(dtype))


def _routes_of(fn):
    """The routes matmul_launch reported over fn(), by name."""
    before = dict(tiled_matmul.route_launches)
    fn()
    return {k: v - before[k] for k, v in tiled_matmul.route_launches.items() if v != before[k]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("K,N", [(203, 77), (136, 520)])
def test_matmul_split_route_at_every_gpu_tile(cuda, dtype, pack, K, N):
    """M = 1..8 rows (every row tile of the gpu space clamps to M) at every
    column tile and chunk, either raster order, out in the operands' dtype
    and in the other; N = 77 is odd (bf16 rows 2-byte aligned: element
    reads), 203 a ragged K; on a NaN-poisoned output."""
    from repro_torch.kernels.spaces import GPU_TILES, GPU_TILES_K

    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    n = 0
    for M in range(1, 9):
        a, b = _operands(cuda, M, K, N, dtype, seed=M)
        for i, (bn, bk) in enumerate((bn, bk) for bn in GPU_TILES for bk in GPU_TILES_K):
            out = (dtype, other)[i % 2]
            torch.full((M, N), float("nan"), device=cuda)
            got = tiled_matmul(a, b, bm=GPU_TILES[i % len(GPU_TILES)], bn=bn, bk=bk, pack=pack,
                               interchange=bool(i % 3 == 0), out_dtype=out)
            n += 1
            assert got.dtype == out and torch.isfinite(got.float()).all()
            tol = BF16_TOL if out == torch.bfloat16 or (dtype == torch.bfloat16 and not pack) \
                else F32_TOL
            _close(got, tiled_matmul_plain(a, b, bk=min(bk, K), pack=pack, out_dtype=out), tol)
    assert n == 8 * len(GPU_TILES) * len(GPU_TILES_K)


def test_matmul_split_route_takes_every_call_of_at_most_8_rows(cuda):
    for M in (1, 4, 8):
        for dtype in (torch.float32, torch.bfloat16):
            a, b = _operands(cuda, M, 96, 1000, dtype)
            for pack in (True, False):
                assert _routes_of(lambda: tiled_matmul(a, b, bm=64, bn=64, bk=32,
                                                       pack=pack)) == {"split": 1}
    # 8-row tiles of a taller product stream each row tile in turn
    a, b = _operands(cuda, 20, 896, 1000, torch.bfloat16)
    got = {}
    assert _routes_of(lambda: got.setdefault("o", tiled_matmul(a, b, bm=8, bn=40, bk=24))) \
        == {"split": 1}
    _close(got["o"], tiled_matmul_plain(a, b, bk=24, pack=True, out_dtype=torch.bfloat16),
           BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 4096, 4096), (4, 896, 896), (4, 3584, 3584),
                                   (8, 1280, 51866), (1, 5120, 2048)])
def test_matmul_split_route_is_bit_identical_over_repeated_calls(cuda, dtype, shape):
    """The decode's products split K over a cluster: the partial tiles are
    added in rank order through distributed shared memory, no atomics, so
    every call gives the same bits (the greedy tokens rely on it)."""
    from repro_torch.kernels.matmul import matmul_splits

    M, K, N = shape
    a, b = _operands(cuda, M, K, N, dtype, seed=7)
    first = tiled_matmul(a, b, bm=64, bn=64, bk=32)
    for _ in range(4):
        assert torch.equal(tiled_matmul(a, b, bm=64, bn=64, bk=32), first)
    _close(first, tiled_matmul_plain(a, b, bk=32, pack=True, out_dtype=dtype),
           F32_TOL if dtype == torch.float32 else BF16_TOL)
    if N <= 4096:
        assert matmul_splits(M, K, N, bm=M, bn=64, dtype=dtype) > 1


def test_matmul_split_counts_on_the_card(cuda):
    """The kernel's split count (its rule on this card's SM count and its
    occupancy): the decode's output projections split their K (a few dozen
    column tiles), qwen2's unembed (2,374 tiles, many waves) does not,
    pack=False never does, and no CTA takes less than 64 of K."""
    from repro_torch.kernels.matmul import matmul_splits

    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N in ((4, 4096, 4096), (4, 896, 896), (4, 3584, 3584)):
            assert 1 < matmul_splits(M, K, N, bm=M, bn=64, dtype=dtype) <= min(8, K // 64)
            assert matmul_splits(M, K, N, bm=M, bn=64, pack=False, dtype=dtype) == 1
        assert matmul_splits(4, 896, 151936, bm=4, bn=64, dtype=dtype) == 1
        assert matmul_splits(4, 100, 64, bm=4, bn=64, dtype=dtype) == 1
        assert matmul_splits(512, 896, 896, bm=64, bn=64, dtype=dtype) == 1


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(97, 136, 520), (130, 264, 88)])
def test_matmul_wgmma_route_at_every_gpu_tile(cuda, out, M, K, N):
    """Every bf16 tile past 8 rows of the gpu space (rows pad to 64 or 128,
    columns to 64 or 128, chunks round up to 16 k) with pack on: the wgmma
    route, ragged M and tiles that straddle N, either raster order."""
    from repro_torch.kernels.spaces import GPU_TILES, GPU_TILES_K

    a, b = _operands(cuda, M, K, N, torch.bfloat16, seed=5)
    calls = 0
    for bm in GPU_TILES[1:]:
        for i, (bn, bk) in enumerate((bn, bk) for bn in GPU_TILES for bk in GPU_TILES_K):
            got = {}
            routes = _routes_of(lambda: got.setdefault("o", tiled_matmul(
                a, b, bm=bm, bn=bn, bk=bk, interchange=bool(i % 2), out_dtype=out)))
            assert routes == {"wgmma": 1}, (bm, bn, bk)
            _close(got["o"], tiled_matmul_plain(a, b, bk=bk, pack=True, out_dtype=out),
                   BF16_TOL if out == torch.bfloat16 else F32_TOL)
            calls += 1
    assert calls == (len(GPU_TILES) - 1) * len(GPU_TILES) * len(GPU_TILES_K)


@pytest.mark.parametrize("case,want", [
    ("decode bf16", "split"), ("decode f32", "split"), ("forward bf16", "wgmma"),
    ("forward bf16 pack off", "mma_sync"), ("N off a multiple of 8", "mma_sync"),
    ("K off a multiple of 8", "mma_sync"), ("A's base off 16 bytes", "mma_sync"),
    ("forward f32", "mma_sync"), ("f32 past the tensor cores' layout", "ffma")])
def test_matmul_reports_the_route_each_shape_takes(cuda, case, want):
    """The route is chosen before the launch from dtype, tile, shape,
    alignment and pack, and reported; the hand-overs to mma.sync are the
    calls TMA cannot take and pack=False. Each agrees with the cost model's
    route where the bases are aligned."""
    from repro_torch.kernels import cost

    bf, f32 = torch.bfloat16, torch.float32
    M, K, N, dtype, cfg = {
        "decode bf16": (4, 896, 896, bf, {}),
        "decode f32": (4, 896, 896, f32, {}),
        "forward bf16": (512, 896, 896, bf, {}),
        "forward bf16 pack off": (512, 896, 896, bf, dict(pack=False)),
        "N off a multiple of 8": (256, 1280, 1002, bf, {}),
        "K off a multiple of 8": (256, 1282, 1000, bf, {}),
        "A's base off 16 bytes": (256, 896, 896, bf, {}),
        "forward f32": (512, 896, 896, f32, {}),
        "f32 past the tensor cores' layout": (150, 300, 140, f32,
                                              dict(bm=112, bn=96, bk=256)),
    }[case]
    a, b = _operands(cuda, M, K, N, dtype, seed=9)
    if case == "A's base off 16 bytes":
        flat = torch.empty(M * K + 1, dtype=dtype, device=cuda)
        flat[1:].copy_(a.reshape(-1))
        a = flat[1:].view(M, K)
    full = {**dict(bm=64, bn=64, bk=32, pack=True), **cfg}
    got = {}
    assert _routes_of(lambda: got.setdefault("o", tiled_matmul(a, b, **full))) == {want: 1}
    _close(got["o"], tiled_matmul_plain(a, b, bk=full["bk"], pack=full["pack"],
                                        out_dtype=dtype),
           BF16_TOL if dtype == bf else F32_TOL)
    if case not in ("A's base off 16 bytes", "f32 past the tensor cores' layout"):
        assert cost.matmul_route(M, K, N, min(full["bm"], M), full["pack"],
                                 a.element_size()) == want


@pytest.mark.parametrize("K", [4096, 16384])
@pytest.mark.parametrize("bm,bn,bk", [(64, 64, 32), (128, 128, 64), (128, 128, 256)])
def test_matmul_wgmma_keeps_f32_accuracy_over_a_long_k(cuda, K, bm, bn, bk):
    """bf16 operands, f32 out, outputs ~N(0, 1): each chunk sums in a fresh
    tile (the tensor cores' own accumulation, carried across chunks, was
    7.9e-5 of the output's rms off at K = 16,384), so the wgmma route holds
    the plain version's f32 sums to F32_TOL, as the 3xTF32 route does."""
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(256, K, generator=g, device=cuda).bfloat16()
    b = (torch.randn(K, 256, generator=g, device=cuda) / K ** 0.5).bfloat16()
    got = {}
    assert _routes_of(lambda: got.setdefault("o", tiled_matmul(
        a, b, bm=bm, bn=bn, bk=bk, out_dtype=torch.float32))) == {"wgmma": 1}
    _close(got["o"], tiled_matmul_plain(a, b, bk=bk, pack=True, out_dtype=torch.float32),
           F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_gpu_tile_still_fits_the_card(cuda, dtype):
    """No bf16 tile of the gpu space is refused for its shared memory, at 4
    rows (the split stream) or 512 (the tensor cores), and no f32 tile at 4
    rows: a record tuned on f32 operands runs on bf16 ones."""
    from repro_torch.kernels.matmul import matmul_tile_check
    from repro_torch.kernels.spaces import GPU_TILES, GPU_TILES_K

    limit = max_shared_memory_per_block(cuda)
    for bm in GPU_TILES:
        for bn in GPU_TILES:
            for bk in GPU_TILES_K:
                # every bf16 tile fits (the larger of its wgmma and mma.sync
                # layouts); f32 tiles past 8 rows keep their ring layouts,
                # whose deepest chunks the card refused before as now
                if dtype == torch.bfloat16 or bm <= 8:
                    assert 0 < matmul_smem_bytes(bm, bn, bk, dtype, limit) <= limit
                for M in ((4, 512) if dtype == torch.bfloat16 else (4,)):
                    matmul_tile_check(M, 4096, 4096, bm=bm, bn=bn, bk=bk, dtype=dtype,
                                      device=cuda)


# ---------------------------------------------------------------------------
# the rest of the catalog in bf16: the kernels at its new shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,K,G,hd,P", [(4, 1, 4, 256, 128), (4, 8, 3, 128, 128),
                                        (4, 16, 1, 64, 128), (4, 32, 1, 64, 128)],
                         ids=["gemma3", "minitron", "qwen1.5", "zamba2"])
def test_flash_attention_bf16_at_the_catalogs_prompts(cuda, B, K, G, hd, P):
    """bf16 in, f32 math, bf16 out, at a served prompt's (B*K, P, hd),
    causal (one of G calls a layer): gemma3's head size 256 (its local
    layers' window of 512 covers every key of a 128-token prompt, so the
    mask is the causal one; the served forward keeps a windowed arch's
    attention plain, as the JAX package), minitron's G = 3 at hd 128,
    qwen1.5's MHA and zamba2's shared block at hd 64."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = (t.bfloat16() for t in _normal(cuda, *[(B * K, P, hd)] * 3, seed=31))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16 and flash_attention.launches == before + 1
    _close(got, flash_attention_plain(q, k, v, causal=True), ATTN_BF16_TOL)


def test_flash_attention_bf16_over_whispers_frames(cuda):
    """Cross-attention's shape: a 128-token prompt's queries against 1500
    frames' keys, not causal, whisper's 20 heads at hd 64, batch 4."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = (t.bfloat16() for t in _normal(cuda, (80, 128, 64), (80, 1500, 64),
                                             (80, 1500, 64), seed=32))
    _close(flash_attention(q, k, v, causal=False),
           flash_attention_plain(q, k, v, causal=False), ATTN_BF16_TOL)


@pytest.mark.parametrize("ring", [False, True], ids=["window", "ring"])
def test_decode_attention_bf16_at_gemmas_window(cuda, ring):
    """gemma3's decode shape, (B*K, G, hd) = (4, 4, 256), at position 600
    past its window of 512: the local layers' mask over a full cache of 640
    slots (gemma3's own cache: a local:global arch keeps max_len), and the
    ring of 512 slots a uniform window keeps, past its wrap."""
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import CacheRows, decode_attention_plain

    S = 512 if ring else 640
    q, kc, vc = _normal(cuda, (4, 4, 256), (4, S, 1, 256), (4, S, 1, 256), seed=33)
    q, kc, vc = q.bfloat16(), kc.bfloat16(), vc.bfloat16()
    cp = torch.full((4,), 600, dtype=torch.int32, device=cuda)
    cp[1] = 517
    kr, vr = CacheRows(kc), CacheRows(vc)
    fn = DispatchService().dispatch("decode_attention", q, kr, vr, cp, ring=ring, window=512)
    got = fn(q, kr, vr, cp)
    assert got.dtype == torch.bfloat16
    _close(got, decode_attention_plain(q, kr, vr, cp, ring=ring, window=512), ATTN_BF16_TOL)


def test_decode_attention_bf16_over_whispers_cross_cache(cuda):
    """A decode step's cross-attention: (B*K, G, hd) = (80, 1, 64) against
    the (4, 1500, 20, 64) cross K/V a prefill fills, read in place, every
    frame valid."""
    from repro_torch.dispatch import DispatchService
    from repro_torch.kernels.decode_attention import CacheRows, decode_attention_plain

    q, kc, vc = _normal(cuda, (80, 1, 64), (4, 1500, 20, 64), (4, 1500, 20, 64), seed=34)
    q, kc, vc = q.bfloat16(), kc.bfloat16(), vc.bfloat16()
    cp = torch.full((80,), 1499, dtype=torch.int32, device=cuda)
    kr, vr = CacheRows(kc), CacheRows(vc)
    fn = DispatchService().dispatch("decode_attention", q, kr, vr, cp, ring=False, window=0)
    _close(fn(q, kr, vr, cp), decode_attention_plain(q, kr, vr, cp), ATTN_BF16_TOL)


@pytest.mark.parametrize("M", [4, 512])
@pytest.mark.parametrize("K,N,forward", [(1152, 262144, "wgmma"), (3072, 256000, "wgmma"),
                                         (1280, 51866, "mma_sync")],
                         ids=["gemma3 tied unembed", "minitron unembed", "whisper unembed"])
def test_matmul_bf16_at_the_catalogs_unembeds(cuda, M, K, N, forward):
    """The bf16 unembeds at a decode step's 4 rows (the split stream) and a
    forward's 512 (wgmma, where N is a multiple of 8; whisper's 51,866 is
    not, and TMA cannot take it: mma.sync), through the dispatch service's
    default config, each against its plain version and on the route it
    reports."""
    from repro_torch.dispatch import DispatchService

    a, b = _operands(cuda, M, K, N, torch.bfloat16, seed=35)
    fn = DispatchService().dispatch("matmul", a, b)
    got = {}
    assert _routes_of(lambda: got.setdefault("o", fn(a, b))) == {"split" if M == 4 else
                                                                 forward: 1}
    assert got["o"].dtype == torch.bfloat16
    _close(got["o"], tiled_matmul_plain(a, b, bk=K, pack=True, out_dtype=torch.bfloat16),
           BF16_TOL)
