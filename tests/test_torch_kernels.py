"""repro_torch kernels against the JAX package: the same numpy inputs go
through the Pallas kernel (interpret mode) and the port's wrapper (its plain
version on the CPU), at the JAX suite's own tolerances. The CUDA kernels
themselves run only on the card (tests/test_torch_gpu.py; ``python3
chip_smoke.py`` holds them against the plain versions at the paper's LARGE
sizes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.m3mm import mm3 as jax_mm3
from repro.kernels.matmul import tiled_matmul as jax_tiled_matmul
from repro.kernels.syr2k import syr2k as jax_syr2k
from repro_torch.kernels import ops, problems, ref
from repro_torch.kernels.m3mm import mm3
from repro_torch.kernels.matmul import tiled_matmul, tiled_matmul_check, tiled_matmul_plain
from repro_torch.kernels.syr2k import syr2k, syr2k_plain
from repro_torch.kernels.util import pad_to, resolve_device, unpad

SYR2K_TOL = dict(atol=5e-3, rtol=5e-3)     # tests/test_kernels.py:90-91
F32_TOL = dict(atol=2e-3, rtol=2e-3)       # tests/test_kernels.py:31
BF16_TOL = dict(atol=3e-2, rtol=3e-2)      # tests/test_kernels.py:30, pack=True
BF16_RMW_TOL = dict(atol=1e-1, rtol=1e-1)  # tests/test_kernels.py:57, pack=False


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), **tol)


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


# ---------------------------------------------------------------------------
# syr2k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(72, 56), (50, 37)])
@pytest.mark.parametrize("cfg", [
    dict(bi=32, bj=32, bk=32),
    dict(bi=16, bj=32, bk=16, interchange=True),
    dict(bi=32, bj=16, bk=64, pack_a=True, pack_b=True),
])
def test_syr2k_matches_pallas_and_ref(shape, cfg):
    C, A, B = ref.init_syr2k(*shape, seed=3)
    want_pallas = jax_syr2k(_jax(C), _jax(A), _jax(B), interpret=True, **cfg)
    want_ref = jref.syr2k_ref(_jax(C), _jax(A), _jax(B))
    Ct, At, Bt = ref.to_device((C, A, B), "cpu")
    got = syr2k(Ct, At, Bt, **cfg)
    assert got.shape == (shape[0], shape[0]) and got.dtype == torch.float32
    _close(got, want_pallas, SYR2K_TOL)
    _close(got, want_ref, SYR2K_TOL)


def test_syr2k_op_defaults_and_inactive_pack_b():
    C, A, B = ref.to_device(ref.init_syr2k(40, 24, seed=1), "cpu")
    want = ref.syr2k_ref(C, A, B, 1.5, 1.2)
    _close(ops.syr2k_op(C, A, B), want, SYR2K_TOL)
    # a sampled config without pack_a leaves the inactive pack_b out
    _close(ops.syr2k_op(C, A, B, config={"pack_a": False, "bi": 8}), want, SYR2K_TOL)


# ---------------------------------------------------------------------------
# tiled matmul and mm3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("interchange", [False, True])
def test_tiled_matmul_matches_pallas(dtype, pack, interchange):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((100, 70), dtype=np.float32)
    b = rng.standard_normal((70, 90), dtype=np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cfg = dict(bm=32, bn=32, bk=16, pack=pack, interchange=interchange)
    want = jax_tiled_matmul(_jax(a, jdt), _jax(b, jdt), interpret=True, **cfg)
    at, bt = ref.to_device((a, b), "cpu", dtype=tdt)
    got = tiled_matmul(at, bt, **cfg)
    assert got.dtype == tdt and got.shape == (100, 90)
    tol = F32_TOL if dtype == "float32" else (BF16_TOL if pack else BF16_RMW_TOL)
    _close(got, np.asarray(want.astype(jnp.float32)), tol)


@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("pack", [True, False])
def test_tiled_matmul_skinny_rows_match_pallas(M, pack):
    """A few rows under a 64-row tile, as in the model's decode: bm clamps to
    M in both packages."""
    rng = np.random.default_rng(11 + M)
    a = rng.standard_normal((M, 96), dtype=np.float32)
    b = rng.standard_normal((96, 200), dtype=np.float32)
    cfg = dict(bm=64, bn=64, bk=32, pack=pack)
    want = jax_tiled_matmul(_jax(a), _jax(b), interpret=True, **cfg)
    at, bt = ref.to_device((a, b), "cpu")
    assert tiled_matmul_check(at, bt, bm=64, bn=64, bk=32) == (M, 64, 32)
    got = tiled_matmul(at, bt, **cfg)
    assert got.shape == (M, 200) and got.dtype == torch.float32
    _close(got, want, F32_TOL)


def test_tiled_matmul_out_dtype_and_clamping():
    a, b = ref.to_device(ref.init_mm3(24, 20, 18, 1, 1)[:2], "cpu")
    want = a @ b
    got = tiled_matmul(a.bfloat16(), b.bfloat16(), bm=512, bn=512, bk=512,
                       out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, want, BF16_TOL)


def test_tiled_matmul_plain_rounds_per_chunk():
    """pack=False rounds each bk chunk's partial product to out_dtype and
    re-rounds the running sum, as the kernel's read-modify-write does."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((8, 64), dtype=np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((64, 8), dtype=np.float32)).bfloat16()
    o = torch.zeros(8, 8, dtype=torch.bfloat16)
    for k0 in range(0, 64, 16):
        part = (a[:, k0:k0 + 16].float() @ b[k0:k0 + 16].float()).bfloat16()
        o = (o.float() + part.float()).bfloat16()
    got = tiled_matmul_plain(a, b, bk=16, pack=False, out_dtype=torch.bfloat16)
    assert torch.equal(got, o)


@pytest.mark.parametrize("fuse", [False, True])
def test_mm3_matches_pallas(fuse):
    arrs = ref.init_mm3(48, 40, 36, 44, 52, seed=2)
    cfg = dict(bm=16, bn=16, bk=16, fuse_second=fuse, pack2=False, inter3=True)
    want = jax_mm3(*(_jax(x) for x in arrs), interpret=True, **cfg)
    got = mm3(*ref.to_device(arrs, "cpu"), **cfg)
    _close(got, want, SYR2K_TOL)
    _close(got, jref.mm3_ref(*(_jax(x) for x in arrs)), SYR2K_TOL)


def test_mm3_op_default_merging():
    arrs = ref.to_device(ref.init_mm3(20, 18, 16, 14, 12), "cpu")
    assert ops.DEFAULTS["mm3"]["bm"] == 64
    _close(ops.mm3_op(*arrs), ref.mm3_ref(*arrs), SYR2K_TOL)
    # unknown keys are ignored, known keys override the defaults
    _close(ops.mm3_op(*arrs, config={"bm": 8, "fuse_second": True, "bogus": 1}),
           ref.mm3_ref(*arrs), SYR2K_TOL)
    merged = ops._merged("syr2k", {"bi": 8, "nope": 3})
    assert merged["bi"] == 8 and "nope" not in merged
    assert merged["bj"] == ops.DEFAULTS["syr2k"]["bj"]


# ---------------------------------------------------------------------------
# utilities, inputs and the device policy
# ---------------------------------------------------------------------------


def test_pad_unpad_match_reference():
    from repro.kernels import util as jutil

    x = np.arange(35, dtype=np.float32).reshape(5, 7)
    got = pad_to(torch.from_numpy(x), (4, 8), value=-1.0)
    want = jutil.pad_to(jnp.asarray(x), (4, 8), value=-1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(unpad(got, (5, 7)).numpy(), x)


def test_init_shapes_and_scaling():
    C, A, B = ref.init_syr2k(12, 9, seed=5)
    assert C.shape == (12, 12) and A.shape == B.shape == (12, 9)
    assert all(x.dtype == np.float32 for x in (C, A, B))
    np.testing.assert_array_equal(ref.init_syr2k(12, 9, seed=5)[1], A)
    A3, B3, C3, D3 = ref.init_mm3(400, 300, 200, 100, 50)
    # 1/sqrt(columns) scaling keeps entries at variance 1/columns
    assert abs(A3.std() * np.sqrt(300) - 1.0) < 0.05
    assert abs(D3.std() * np.sqrt(50) - 1.0) < 0.05


def test_problem_signature_matches_reference():
    for name in problems.LARGE_SHAPES:
        dims = problems.LARGE_SHAPES[name]
        assert ref.problem_signature(name, *dims) == jref.problem_signature(name, *dims)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        problems.gpu_problem("syr2k", (16, 8))
    assert resolve_device("cpu") == torch.device("cpu")
