"""The port's lu, covariance, heat3d and floyd_warshall against the JAX
package: the same numpy inputs go through the Pallas kernels (interpret
mode) or the JAX plain code and through the port's wrappers (their plain
versions on the CPU), at the JAX suite's tolerances (tests/test_kernels.py:
lu 5e-3, the others F32TOL 2e-3). The CUDA kernels themselves run only on the
card (tests/test_torch_gpu.py, ``python3 chip_smoke.py``)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import spaces as jspaces
from repro.kernels.covariance import covariance as jax_covariance
from repro.kernels.floyd_warshall import _closure_in_block as jax_closure
from repro.kernels.floyd_warshall import floyd_warshall as jax_floyd_warshall
from repro.kernels.floyd_warshall import minplus_update as jax_minplus_update
from repro.kernels.heat3d import heat3d as jax_heat3d
from repro.kernels.heat3d import heat3d_step as jax_heat3d_step
from repro.kernels.lu import _factor_diag as jax_factor_diag
from repro.kernels.lu import lu as jax_lu
from repro.kernels.problems import BENCH_DIMS as JBENCH_DIMS
from repro.kernels.problems import LARGE_SHAPES as JLARGE_SHAPES
from repro_torch.core.database import PerformanceDatabase
from repro_torch.kernels import floyd_warshall as fw
from repro_torch.kernels import ops, problems, ref, spaces
from repro_torch.kernels.covariance import covariance, covariance_plain
from repro_torch.kernels.floyd_warshall import (
    closure_in_block,
    closure_plain,
    floyd_warshall,
    floyd_warshall_plain,
    minplus_update,
    minplus_update_plain,
)
from repro_torch.kernels.heat3d import heat3d, heat3d_plain, heat3d_step, heat3d_step_plain
from repro_torch.kernels.lu import lu, lu_factor_diag, lu_factor_diag_plain, lu_plain
from repro_torch.launch import autotune

LU_TOL = dict(atol=5e-3, rtol=5e-3)   # tests/test_kernels.py:112
F32_TOL = dict(atol=2e-3, rtol=2e-3)  # tests/test_kernels.py:31 (F32TOL)

NEW_KERNELS = ("lu", "heat3d", "covariance", "floyd_warshall")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), **tol)


def _jax(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _cpu(*arrays):
    return ref.to_device(arrays, "cpu")


# ---------------------------------------------------------------------------
# covariance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,cfg", [
    ((90, 48), dict(bi=16, bj=16, bk=32, fuse_center=True)),
    ((90, 48), dict(bi=32, bj=16, bk=16, fuse_center=False, interchange=True)),
    ((77, 40), dict(bi=16, bj=16, bk=32, fuse_center=True)),  # bk does not divide N
])
def test_covariance_matches_pallas_and_ref(shape, cfg):
    (data,) = ref.init_covariance(*shape, seed=4)
    (dt,) = _cpu(data)
    got = covariance(dt, **cfg)
    assert got.shape == (shape[1], shape[1]) and got.dtype == torch.float32
    _close(got, jax_covariance(_jax(data), interpret=True, **cfg), F32_TOL)
    _close(got, jref.covariance_ref(_jax(data)), F32_TOL)


def test_covariance_plain_matches_reference():
    (data,) = ref.init_covariance(60, 24, seed=1)
    _close(covariance_plain(*_cpu(data)), jref.covariance_ref(_jax(data)), F32_TOL)
    _close(ref.covariance_ref(*_cpu(data)), jref.covariance_ref(_jax(data)), F32_TOL)


# ---------------------------------------------------------------------------
# lu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs", [8, 16, 28])
def test_lu_block_sizes_match_pallas_and_ref(bs):
    (A,) = ref.init_lu(64, seed=2)
    (At,) = _cpu(A)
    got = lu(At, bs=bs, bm=32, bn=32)
    _close(got, jax_lu(_jax(A), bs=bs, bm=32, bn=32, interpret=True), LU_TOL)
    _close(got, jref.lu_ref(_jax(A)), LU_TOL)
    _close(lu_plain(At, bs=bs, pack=False), got, LU_TOL)


def test_lu_reconstructs_matrix():
    (A,) = ref.init_lu(48)
    out = lu(*_cpu(A), bs=16).numpy()
    L = np.tril(out, -1) + np.eye(48)
    U = np.triu(out)
    _close(L @ U, A, dict(atol=1e-2, rtol=1e-2))  # tests/test_kernels.py:120


def test_lu_ref_matches_reference():
    (A,) = ref.init_lu(40, seed=3)
    _close(ref.lu_ref(*_cpu(A)), jref.lu_ref(_jax(A)), LU_TOL)


def test_lu_factor_diag_plain_matches_reference():
    (A,) = ref.init_lu(24, seed=5)
    (At,) = _cpu(A)
    want = jax_factor_diag(_jax(A))
    _close(lu_factor_diag_plain(At), want, dict(atol=1e-6, rtol=1e-6))
    M = At.clone()
    lu_factor_diag(M, 0, 24)  # the wrapper, in place, on the CPU
    _close(M, want, dict(atol=1e-6, rtol=1e-6))


# ---------------------------------------------------------------------------
# floyd_warshall
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(bs=16, bi=32, bj=32, unroll=1),
    dict(bs=32, bi=16, bj=64, unroll=4),
    dict(bs=24, bi=16, bj=16, unroll=8),  # bs does not divide N: padded at 1e18
])
def test_floyd_warshall_matches_pallas_and_ref(cfg):
    (W,) = ref.init_floyd_warshall(64, seed=6)
    got = floyd_warshall(*_cpu(W), allow_semiring_reassociation=True, **cfg)
    _close(got, jax_floyd_warshall(_jax(W), allow_semiring_reassociation=True,
                                   interpret=True, **cfg), F32_TOL)
    _close(got, jref.floyd_warshall_ref(_jax(W)), F32_TOL)
    assert torch.equal(got, floyd_warshall_plain(*_cpu(W), bs=cfg["bs"]))


@pytest.mark.parametrize("N,bs", [(64, 16), (64, 32), (70, 24), (96, 32), (50, 16)])
def test_floyd_warshall_bit_identical_to_pallas(N, bs):
    # the driver's schedule (in-place panels on views, ping-pong trailing
    # update) against the JAX package's Pallas blocked Floyd-Warshall in
    # interpret mode, on non-integer weights: the same bits, at bs that
    # divide N and bs that do not
    (W,) = ref.init_floyd_warshall(N, seed=N + bs)
    got = floyd_warshall(*_cpu(W), bs=bs, bi=16, bj=32, unroll=4,
                         allow_semiring_reassociation=True)
    want = jax_floyd_warshall(_jax(W), bs=bs, bi=16, bj=32, unroll=4,
                              allow_semiring_reassociation=True, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_minplus_update_writes_views_in_place():
    # the phase-2 panels: out is the operand's own view, one tile spanning it
    rng = np.random.default_rng(3)
    (D,) = _cpu(rng.uniform(1, 10, (40, 40)).astype(np.float32))
    diag = D[8:16, 8:16].clone()
    want_row = minplus_update_plain(D[8:16], diag, D[8:16])
    row = D[8:16]
    assert minplus_update(row, diag, row, bi=8, bj=16, out=row) is row
    assert torch.equal(D[8:16], want_row)
    want_col = minplus_update_plain(D[:, 8:16], D[:, 8:16], diag)
    col = D[:, 8:16]
    minplus_update(col, col, diag, bi=16, bj=8, out=col)
    assert torch.equal(D[:, 8:16], want_col)


def test_minplus_aliasing_rule():
    # out may be D, and may be A (B) only as the same view with one tile
    # spanning all its columns (rows): no block reads another block's tile
    D = torch.zeros(32, 32)
    diag = torch.zeros(8, 8)
    row, col = D[8:16], D[:, 8:16]
    fw._check_aliasing(row, diag, row, row, bi=8, bj=16)        # row panel
    fw._check_aliasing(col, col, diag, col, bi=16, bj=8)        # column panel
    fw._check_aliasing(D, col, row, torch.empty(32, 32), 64, 64)  # trailing, out of place
    with pytest.raises(ValueError, match="may be B"):
        fw._check_aliasing(row, diag, row, row, bi=4, bj=16)    # two tiles down the rows
    with pytest.raises(ValueError, match="may be A"):
        fw._check_aliasing(col, col, diag, col, bi=16, bj=4)
    with pytest.raises(ValueError, match="overlaps D"):
        fw._check_aliasing(D[:16], col[:16], row, D[1:17], 16, 16)


def test_floyd_warshall_requires_reassociation_flag():
    (W,) = _cpu(*ref.init_floyd_warshall(16))
    with pytest.raises(ValueError, match="reassociat"):
        floyd_warshall(W, bs=8)


def test_floyd_warshall_is_idempotent():
    (W,) = ref.init_floyd_warshall(40)
    D = floyd_warshall(*_cpu(W), bs=8, allow_semiring_reassociation=True).numpy()
    # the closure is a fixed point of one more min-plus relaxation
    D2 = np.minimum(D, (D[:, :, None] + D[None, :, :]).min(axis=1))
    np.testing.assert_allclose(D, D2, atol=1e-4)


def test_minplus_and_closure_plain_match_reference():
    rng = np.random.default_rng(0)
    D = rng.uniform(0, 10, (40, 50)).astype(np.float32)
    A = rng.uniform(0, 10, (40, 12)).astype(np.float32)
    B = rng.uniform(0, 10, (12, 50)).astype(np.float32)
    want = np.asarray(jax_minplus_update(_jax(D), _jax(A), _jax(B), bi=16, bj=16,
                                         unroll=2, interpret=True))
    np.testing.assert_array_equal(minplus_update_plain(*_cpu(D, A, B)).numpy(), want)
    np.testing.assert_array_equal(minplus_update(*_cpu(D, A, B), unroll=2).numpy(), want)
    (W,) = ref.init_floyd_warshall(24, seed=7)
    want = np.asarray(jax_closure(_jax(W)))
    np.testing.assert_array_equal(closure_plain(*_cpu(W)).numpy(), want)
    (Wt,) = _cpu(W)
    closure_in_block(Wt, 0, 24)
    np.testing.assert_array_equal(Wt.numpy(), want)


def test_minplus_update_rejects_unknown_unroll():
    D, A, B = _cpu(np.zeros((4, 4)), np.zeros((4, 2)), np.zeros((2, 4)))
    with pytest.raises(ValueError, match="unroll"):
        minplus_update(D, A, B, unroll=3)


# ---------------------------------------------------------------------------
# heat3d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bi,fuse_t", [(4, 1), (8, 2), (16, 1), (7, 1)])
def test_heat3d_matches_pallas_and_ref(bi, fuse_t):
    (A,) = ref.init_heat3d(18, seed=8)
    got = heat3d(*_cpu(A), 2, bi=bi, fuse_t=fuse_t)
    _close(got, jax_heat3d(_jax(A), 2, bi=bi, fuse_t=fuse_t, interpret=True), F32_TOL)
    _close(got, jref.heat3d_ref(_jax(A), 2), F32_TOL)


def test_heat3d_bi1_fuse2_matches_reference():
    """bi=1 with fuse_t=2 is a point of the heat3d space. The JAX kernel
    builds its 2-deep halo from the neighbour blocks with
    ``prev_ref[...][-h:]`` / ``next_ref[...][:h]``
    (src/repro/kernels/heat3d.py:74); a 1-row block holds fewer than h=2 rows,
    so its halo is short and its result is wrong there (max abs 0.117 from
    heat3d_ref on an 18^3 grid, 2 time steps). The port reads the halo from
    global memory, so this test holds it to the reference function only."""
    for n, tsteps in ((18, 2), (10, 1)):
        (A,) = ref.init_heat3d(n, seed=9)
        got = heat3d(*_cpu(A), tsteps, bi=1, fuse_t=2)
        _close(got, jref.heat3d_ref(_jax(A), tsteps), F32_TOL)


def test_heat3d_step_plain_matches_reference():
    (A,) = ref.init_heat3d(12, seed=10)
    for fuse_t in (1, 2):
        want = jax_heat3d_step(_jax(A), bi=4, fuse_t=fuse_t, interpret=True)
        _close(heat3d_step_plain(*_cpu(A), fuse_t), want, F32_TOL)
        _close(heat3d_step(*_cpu(A), bi=4, fuse_t=fuse_t), want, F32_TOL)
    _close(heat3d_plain(*_cpu(A), 3), jref.heat3d_ref(_jax(A), 3), F32_TOL)


def test_heat3d_rejects_fuse_t_not_dividing_passes():
    (A,) = _cpu(*ref.init_heat3d(6))
    with pytest.raises(ValueError, match="fuse_t"):
        heat3d(A, 1, fuse_t=3)


# ---------------------------------------------------------------------------
# ops, inputs, spaces and problems
# ---------------------------------------------------------------------------


def test_ops_accept_config_dicts():
    (W,) = ref.init_floyd_warshall(32)
    _close(ops.floyd_warshall_op(*_cpu(W), config={"bs": 8, "junk_key": 1}),
           jref.floyd_warshall_ref(_jax(W)), F32_TOL)
    (Ah,) = ref.init_heat3d(12)
    _close(ops.heat3d_op(*_cpu(Ah), 1, config={"bi": 4, "fuse_t": 1}),
           jref.heat3d_ref(_jax(Ah), 1), F32_TOL)
    (Al,) = ref.init_lu(32)
    _close(ops.lu_op(*_cpu(Al), config={"bs": 8, "pack": False}), jref.lu_ref(_jax(Al)), LU_TOL)
    (dat,) = ref.init_covariance(40, 24)
    _close(ops.covariance_op(*_cpu(dat), config={"bi": 8, "bj": 8, "fuse_center": False}),
           jref.covariance_ref(_jax(dat)), F32_TOL)
    merged = ops._merged("floyd_warshall", {"unroll": 8, "nope": 3})
    assert merged["unroll"] == 8 and "nope" not in merged


@pytest.mark.parametrize("name,fn,dims", [
    ("lu", lambda A: ops.lu_op(A, config={"bs": 16}), (40,)),
    ("covariance", lambda D: ops.covariance_op(D, config={"fuse_center": False}), (30, 20)),
    ("floyd_warshall", lambda W: ops.floyd_warshall_op(W, config={"bs": 16}), (40,)),
    ("heat3d", lambda A: ops.heat3d_op(A, 2, config={"fuse_t": 2}), (10, 2)),
    ("heat3d_step", lambda A: heat3d_step(A, fuse_t=2), (10, 2)),
])
def test_no_wrapper_writes_its_input(name, fn, dims):
    args = problems.problem_inputs(name.replace("_step", ""), dims, "cpu")
    before = [a.clone() for a in args]
    fn(*args)
    assert all(torch.equal(a, b) for a, b in zip(args, before))


def test_wrappers_are_f32_only():
    (A,) = _cpu(*ref.init_lu(8))
    with pytest.raises(TypeError):
        lu(A.double())
    with pytest.raises(TypeError):
        covariance(A.double())
    with pytest.raises(TypeError):
        floyd_warshall(A.double(), allow_semiring_reassociation=True)
    with pytest.raises(TypeError):
        heat3d(A.double()[None], 1)


def test_init_matches_the_reference_distributions():
    (A,) = ref.init_lu(50)
    assert np.allclose(np.diag(A).mean(), 50, atol=0.5)
    (H,) = ref.init_heat3d(10)
    assert H.shape == (10, 10, 10) and 0 <= H.min() and H.max() < 1
    (W,) = ref.init_floyd_warshall(30)
    assert np.all(np.diag(W) == 0) and W[~np.eye(30, dtype=bool)].min() >= 1
    assert W.max() < 10
    (D,) = ref.init_covariance(400, 30)
    assert abs(D.std() - 1) < 0.05
    np.testing.assert_array_equal(ref.init_covariance(400, 30)[0], D)


def test_problem_dims_match_reference():
    for name in NEW_KERNELS:
        assert problems.BENCH_DIMS[name] == JBENCH_DIMS[name]
        assert problems.LARGE_SHAPES[name] == JLARGE_SHAPES[name]


def _hp_spec(hp):
    return (type(hp).__name__, getattr(hp, "sequence", getattr(hp, "choices", None)),
            hp.default)


@pytest.mark.parametrize("name", NEW_KERNELS)
def test_host_spaces_match_reference_and_gpu_sizes(name):
    mine, theirs = spaces.kernel_space(name, "host"), jspaces.kernel_space(name, "host")
    assert mine.param_names == theirs.param_names
    for p in mine.param_names:
        assert _hp_spec(mine[p]) == _hp_spec(theirs[p])
    gpu = spaces.kernel_space(name, "gpu")
    want = {"lu": 1210, "covariance": 5324, "heat3d": 12, "floyd_warshall": 2420}[name]
    assert gpu.cardinality() == want
    assert {p: gpu[p].default for p in gpu.param_names} == ops.DEFAULTS[name]


# ---------------------------------------------------------------------------
# the CLI on the CPU backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", NEW_KERNELS)
def test_cli_cpu_backend_campaign(kernel, tmp_path, capsys):
    db = str(tmp_path / kernel)
    rc = autotune.main(["--kernel", kernel, "--backend", "cpu", "--max-evals", "4",
                        "--db", db, "--seed", "5"])
    assert rc == 0
    out = capsys.readouterr().out
    summary = json.loads("{" + out.partition("\n{")[2])
    assert summary["device"] == "cpu"
    assert summary["launches"] == {autotune.KERNEL_WRAPPERS[kernel].__name__: 0}
    assert summary["n_evaluated"] == 4 and summary["n_failed"] == 0
    recs = PerformanceDatabase(db).records
    assert len(recs) == 4
    assert min(r.objective for r in recs) == summary["best_objective_sec"]


@pytest.mark.parametrize("kernel", NEW_KERNELS)
def test_cli_gpu_backend_needs_a_card(kernel):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        autotune.main(["--kernel", kernel, "--max-evals", "1"])
