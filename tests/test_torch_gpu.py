"""The CUDA kernels on the card against their plain versions, at small
ragged shapes. Every test here carries the ``gpu`` marker and skips without
a CUDA device; on the card: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py``. This file imports neither jax nor repro, so it
runs where only the port is installed."""

import numpy as np
import pytest
import torch

from repro_torch.core import PENALTY, TimingEvaluator
from repro_torch.kernels import ops, problems
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
