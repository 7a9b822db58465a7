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
    # f32 past 8 rows (tensor cores): A's chunk (bm and bn padded to whole 32
    # x 32 warp pieces, bk to the mma's 8; A's rows of f32 padded to 32
    # bytes plus 16) and B's (those k rows of the padded columns plus 8
    # words); f32 8-row tiles and bf16 (FFMA): pm and pn padded to 8, bk to
    # 4; three stages where they fit
    def tc(pm, pn, kf):
        return pm * (-(-kf * 4 // 32) * 32 + 16) + kf * 4 * (pn + 8)

    assert matmul_smem_bytes(64, 64, 32, limit=LIMIT) == 3 * tc(64, 64, 32)
    assert matmul_smem_bytes(64, 64, 32, limit=LIMIT) == 3 * (64 * 144 + 32 * 288)
    assert matmul_smem_bytes(48, 80, 24, limit=LIMIT) == 3 * (64 * 112 + 24 * 416)
    assert matmul_smem_bytes(128, 8, 8, limit=LIMIT) == 3 * (128 * 48 + 8 * 160)
    assert matmul_smem_bytes(40, 50, 12, limit=LIMIT) == 3 * tc(64, 64, 16)
    assert matmul_smem_bytes(4, 64, 32, limit=LIMIT) == 3 * (8 * 144 + 32 * 256)
    assert matmul_smem_bytes(8, 24, 4, limit=LIMIT) == 3 * (8 * 48 + 4 * 96)
    assert matmul_smem_bytes(64, 64, 32, torch.bfloat16, LIMIT) == 3 * (64 * 80 + 32 * 128)
    assert matmul_smem_bytes(4, 64, 32, torch.bfloat16, LIMIT) == 3 * (8 * 80 + 32 * 128)
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
    # row tiles of 8, 24 and 40 pad to the mma's 16 (f32; bf16 keeps the FFMA
    # loop), column tiles not a multiple of 4, chunks not a multiple of 8,
    # ragged edges everywhere; on a NaN-poisoned output
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
    (W,) = problems.problem_inputs("floyd_warshall", (400,), cuda)
    for off, bs in ((0, 64), (100, 128), (40, 256)):
        D = W.clone()
        closure_in_block(D, off, bs)
        want = W.clone()
        want[off:off + bs, off:off + bs] = closure_plain(W[off:off + bs, off:off + bs])
        assert torch.equal(D, want)


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
    (A,) = problems.problem_inputs("lu", (300,), cuda)
    for off, bs in ((0, 32), (37, 64), (172, 128)):
        M = A.clone()
        before = lu_factor_diag.launches
        lu_factor_diag(M, off, bs)
        assert lu_factor_diag.launches == before + 1
        want = A.clone()
        want[off:off + bs, off:off + bs] = lu_factor_diag_plain(A[off:off + bs, off:off + bs])
        assert torch.equal(M, want)


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
    assert flash_attention_smem_bytes(64, 64, 512, limit=LIMIT) == -1
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
    assert decode_attention_smem_bytes(7, 64, 72) == -1     # not a multiple of 16


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
        flash_attention(qw, kw, vw)                # head size past 256
    assert flash_attention.launches == f0
    qd, kd, vd = _normal(cuda, (2, 17, 128), (2, 300, 128), (2, 300, 128))
    d0 = decode_attention.launches
    with pytest.raises(ConfigRejected):            # head size off the multiples of 16
        decode_attention(qd[..., :72].contiguous(), kd[..., :72].contiguous(),
                         vd[..., :72].contiguous(), 299, bk=128)
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


# an untileable bq, and the chunked torch variant, which does not run on the card
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
    assert svc.stats["build_failed"] == 1 and flash_attention.launches == before + 1
    assert store.quarantines("flash_attention")[0]["reason"] == "build_failed"
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
