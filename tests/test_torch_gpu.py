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
from repro_torch.kernels.util import ConfigRejected

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pack", [True, False])
def test_matmul_matches_plain(cuda, dtype, pack):
    a, b = problems.problem_inputs("mm3", (130, 70, 90, 1, 1), cuda)[:2]
    a, b = a.to(dtype), b.to(dtype)
    got = tiled_matmul(a, b, bm=48, bn=80, bk=24, pack=pack, interchange=True)
    want = tiled_matmul_plain(a, b, bk=24, pack=pack, out_dtype=dtype)
    assert got.dtype == dtype
    _close(got, want, F32_TOL if dtype == torch.float32 else BF16_TOL)


def test_mm3_fuse_second_matches_reference(cuda):
    arrs = problems.problem_inputs("mm3", (80, 70, 60, 50, 40), cuda)
    got = ops.mm3_op(*arrs, config=dict(bm=24, bn=40, bk=16, fuse_second=True, pack3=False))
    A, B, C, D = arrs
    _close(got, (A @ B) @ (C @ D), F32_TOL)


def test_syr2k_smem_accounting(cuda):
    # per packed operand: k-major chunks of (rows padded to 64) + 4 floats,
    # one for the i tile and one for the j tile; -1 past the register tile
    assert syr2k_smem_bytes(64, 64, 32, False, False) == 0
    assert syr2k_smem_bytes(64, 64, 32, True, False) == 4 * 32 * 68 * 2
    assert syr2k_smem_bytes(64, 64, 32, True, True) == 4 * 32 * 68 * 4
    assert syr2k_smem_bytes(48, 80, 24, True, True) == 4 * 2 * (24 * 68 + 24 * 132)
    assert syr2k_smem_bytes(8, 8, 8, True, False) == 4 * 2 * 8 * 68
    assert syr2k_smem_bytes(256, 64, 8, True, True) == -1


def test_matmul_smem_accounting(cuda):
    assert matmul_smem_bytes(64, 64, 32) == 4 * 32 * (68 + 68)
    assert matmul_smem_bytes(48, 80, 24) == 4 * 24 * (68 + 132)
    assert matmul_smem_bytes(128, 8, 8) == 4 * 8 * (132 + 68)
    assert matmul_smem_bytes(64, 136, 8) == -1


def test_oversized_tiles_are_rejected_before_launch(cuda):
    a, b = problems.problem_inputs("mm3", (300, 300, 300, 1, 1), cuda)[:2]
    before = tiled_matmul.launches
    with pytest.raises(ConfigRejected):
        tiled_matmul(a, b, bm=256, bn=64, bk=32)
    with pytest.raises(ConfigRejected):
        tiled_matmul(a, b, bm=128, bn=128, bk=300)  # 300 * 2 * 132 floats > 227 KB
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
    # two k-major chunks: bk rows of (tile padded to 64) + 4 floats each
    assert covariance_smem_bytes(64, 64, 32) == 4 * 32 * (68 + 68)
    assert covariance_smem_bytes(48, 80, 24) == 4 * 24 * (68 + 132)
    assert covariance_smem_bytes(136, 64, 8) == -1


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
    # the contraction streams in chunks of 32: independent of bs past 32
    assert minplus_smem_bytes(64, 64, 256) == 4 * 32 * (68 + 68)
    assert minplus_smem_bytes(128, 128, 256) == 4 * 32 * (132 + 132)
    assert minplus_smem_bytes(48, 80, 16) == 4 * 16 * (68 + 132)
    assert minplus_smem_bytes(fw.MAX_TILE, fw.MAX_TILE, 64) > 0
    assert minplus_smem_bytes(fw.MAX_TILE + 8, 64, 64) == -1


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


@pytest.mark.parametrize("bs,pack", [(32, True), (28, False), (128, True)])
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
    D = torch.zeros(200, 200, device=cuda)
    with pytest.raises(ConfigRejected):
        minplus_update(D, D[:, :16].contiguous(), D[:16].contiguous(), bi=192, bj=64)
    with pytest.raises(TypeError):
        covariance(data.double())
