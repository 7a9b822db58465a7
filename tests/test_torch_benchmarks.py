"""The port's benchmark scripts (benchmarks/torch_*.py) on the CPU: the naive
row against the JAX package's, each table's rows, the rejected-then-clipped
rule, the entry point's exit code, and the smoke runs of the kernel tuning,
fidelity and tuner-overhead benchmarks. Inputs are drawn once with numpy
and handed to both packages. No wall-clock gate: timings on a shared CPU
would make one flaky."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.tuner_overhead as jto
import repro.kernels.ref as JR
import repro.kernels.variants as JV
from benchmarks import torch_fidelity_bench, torch_run, torch_tables
from benchmarks import torch_tuner_overhead as tto
from benchmarks.torch_common import bench_meta, clip_config, f32_matmuls, run_table
from benchmarks.torch_kernel_tuning import tune_all
from repro_torch.core import ConfigRejected
from repro_torch.dispatch import TuningStore
from repro_torch.kernels import problems, ref
from repro_torch.kernels.spaces import kernel_space
from repro_torch.kernels.variants import naive_fns

# the JAX suite's tolerances (tests/test_kernels.py): f32 2e-3, mm3 and
# covariance 5e-3
F32TOL = dict(atol=2e-3, rtol=2e-3)
LOOSE = dict(atol=5e-3, rtol=5e-3)
ROWS = ["naive", "xla_default", "blocked_heur", "blocked_paper", "autotuned_RF",
        "autotuned_correct"]


def _np(t):
    return np.asarray(t, dtype=np.float32)


@pytest.mark.parametrize("kernel,dims,tol", [
    ("syr2k", (48, 32), F32TOL),
    ("mm3", (40, 36, 32, 30, 34), LOOSE),
    ("covariance", (60, 48), LOOSE),
])
def test_naive_rows_match_the_reference(kernel, dims, tol):
    init = {"syr2k": ref.init_syr2k, "mm3": ref.init_mm3,
            "covariance": ref.init_covariance}[kernel]
    arrays = init(*dims, seed=3)
    got = naive_fns()[kernel](*(torch.from_numpy(a) for a in arrays))
    want = JV.naive_fns()[kernel](*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_naive_rows_of_the_other_three_are_their_refs():
    fns = naive_fns()
    assert (fns["lu"], fns["heat3d"], fns["floyd_warshall"]) == \
        (ref.lu_ref, ref.heat3d_ref, ref.floyd_warshall_ref)


def _jax_library(kernel, args):
    a = [jnp.asarray(t.numpy()) for t in args]
    if kernel == "heat3d":
        return JR.heat3d_ref(a[0], problems.BENCH_DIMS["heat3d"][1])
    return {"syr2k": JR.syr2k_ref, "mm3": JR.mm3_ref, "lu": JR.lu_ref,
            "covariance": JR.covariance_ref,
            "floyd_warshall": JR.floyd_warshall_ref}[kernel](*a)


@pytest.mark.parametrize("table", torch_tables.ALL_TABLES, ids=lambda t: t.__name__)
def test_table_rows_on_the_cpu(table):
    kernel = {"table1_syr2k": "syr2k", "table2_mm3": "mm3", "table3_lu": "lu",
              "table4_heat3d": "heat3d", "table5_covariance": "covariance",
              "table67_floyd_warshall": "floyd_warshall"}[table.__name__]
    rows = table("cpu", max_evals=3)
    prefix = torch_tables.make_table(kernel, "cpu").name
    assert prefix == table.__name__.replace("table2_mm3", "table2_3mm")
    assert [r.name for r in rows] == [f"{prefix}/{r}" for r in ROWS]
    assert all(r.us > 0 for r in rows[:-1])
    assert rows[-1].us == 1.0  # the winner agrees with ref
    assert "evaluated=3" in rows[4].derived and rows[4].config
    # row 2, the library, against the JAX package's ref on the same inputs
    t = torch_tables.make_table(kernel, "cpu")
    tol = LOOSE if kernel in ("mm3", "covariance") else F32TOL
    np.testing.assert_allclose(_np(t.library(*t.args)), _np(_jax_library(kernel, t.args)),
                               **tol)


@pytest.mark.parametrize("max_bk", [4096, 128])
def test_a_rejected_config_is_printed_then_clipped(max_bk):
    space = kernel_space("syr2k", target="gpu")
    C, A, B = (torch.from_numpy(a) for a in ref.init_syr2k(24, 16))

    def factory(cfg):  # a stand-in wrapper: refuses tiles past 128, as the card's does,
        def fn(*args):  # and chunks past max_bk (a stage past the shared memory)
            if any(int(cfg.get(k, 0)) > 128 for k in ("bi", "bj")):
                raise ConfigRejected(f"tile {cfg['bi']}x{cfg['bj']} past the register tile")
            if int(cfg["bk"]) > max_bk:
                raise ConfigRejected(f"bk={cfg['bk']} past the shared memory")
            return ref.syr2k_ref(*args)

        return fn, (C, A, B)

    heur = dict(bi=128, bk=128, bj=128, interchange=False, pack_a=False, pack_b=False)
    paper = dict(bi=96, bk=2048, bj=256, bm=96, interchange=True, pack_a=True, pack_b=True)
    rows = run_table("t", lambda *a: ref.syr2k_ref(*a), ref.syr2k_ref, (C, A, B), factory,
                     space, heur, paper, max_evals=2)
    names = [r.name for r in rows]
    assert names == ["t/naive", "t/xla_default", "t/blocked_heur", "t/blocked_paper",
                     "t/blocked_paper_clipped", "t/autotuned_RF"]
    rejected, clipped = rows[3], rows[4]
    assert rejected.us is None and rejected.derived.startswith("rejected: tile 96x256")
    assert clipped.config == dict(pack_a=True, pack_b=True, interchange=True, bi=96, bk=256,
                                  bj=128)
    assert rows[2].us > 0
    if max_bk > 256:
        assert clipped.us > 0
    else:  # refused again: printed so, and nothing further is tried
        assert clipped.us is None and clipped.derived.startswith("rejected: bk=256")


def test_library_row_runs_without_tf32_and_leaves_the_flags_as_they_were():
    C, A, B = (torch.from_numpy(a) for a in ref.init_syr2k(24, 16))
    seen = []

    def library(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return ref.syr2k_ref(*args)

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        run_table("t", ref.syr2k_ref, library, (C, A, B), lambda cfg: (ref.syr2k_ref, (C, A, B)),
                  kernel_space("syr2k", target="gpu"), dict(bi=64), dict(bi=32), max_evals=2)
        with pytest.raises(RuntimeError), f32_matmuls():
            raise RuntimeError("a library call that fails")
        after = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert seen and set(seen) == {(False, False)}
    assert after == (True, True)


def test_clip_config_takes_the_nearest_entry():
    space = kernel_space("floyd_warshall", target="gpu")
    assert clip_config(dict(bs=4, bi=8, bj=8, unroll=1, extra=3), space) == \
        dict(bs=16, bi=8, bj=8, unroll=1)
    assert clip_config(dict(bs=100, bi=20, bj=8), space) == dict(bs=128, bi=16, bj=8)
    with pytest.raises(ValueError):
        clip_config(dict(pack_a="maybe"), kernel_space("syr2k", target="gpu"))


def test_run_exits_non_zero_when_a_table_raises(monkeypatch, tmp_path, capsys):
    def boom(device=None, max_evals=0, learner="RF"):
        raise RuntimeError("a broken table")

    monkeypatch.setattr(torch_tables, "ALL_TABLES", [boom] + torch_tables.ALL_TABLES)
    monkeypatch.setenv("REPRO_BENCH_EVALS", "2")
    monkeypatch.setenv("REPRO_BENCH_ONLY", "boom,table5")
    out = tmp_path / "tables.json"
    assert torch_run.main(["--device", "cpu", "--out", str(out)]) == 1
    printed = capsys.readouterr().out
    assert "boom/ERROR" in printed and "table5_covariance/autotuned_correct,1.0" in printed
    report = json.loads(out.read_text())
    assert report["failed"] == ["boom"] and report["meta"]["card"] is None
    assert [r["name"] for r in report["tables"]["table5_covariance"]["rows"]][0] == \
        "table5_covariance/naive"
    monkeypatch.setenv("REPRO_BENCH_ONLY", "table5")
    assert torch_run.main(["--device", "cpu", "--out", str(out)]) == 0


def test_bench_meta_stamps_torch_and_the_card():
    meta = bench_meta("cpu")
    assert meta["torch"] == torch.__version__ and meta["card"] is None
    assert {"host", "git_sha", "timestamp", "cuda", "device"} <= set(meta)


def test_kernel_tuning_against_the_cost_model_publishes(tmp_path):
    rows = tune_all(max_evals=3, store=str(tmp_path), device="cpu")
    assert [r.name for r in rows] == [f"kernel_tuning/{k}" for k in problems.LARGE_SHAPES]
    assert all(r.us > 0 and "util=" in r.derived for r in rows)
    recs = {r.kernel: r for r in TuningStore(str(tmp_path)).records()}
    assert set(recs) == set(problems.LARGE_SHAPES)
    for k, rec in recs.items():
        assert rec.backend == "cost"
        assert tuple(rec.signature) == problems.problem_signature_for(k, "cost")


def test_fidelity_bench_quick_writes_a_stamped_report(tmp_path):
    out = tmp_path / "fidelity.json"
    rc = torch_fidelity_bench.main(["--quick", "--no-check", "--device", "cpu", "--kernels",
                                    "mm3", "--budgets", "16,4", "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    (row,) = report["kernels"]
    assert report["meta"]["device"] == "cpu" and report["budgets"] == [16, 4]
    assert row["flat"]["hw_evals"] == 16 and row["cascade"]["hw_evals"] <= 4
    assert row["flat"]["retimed_sec"] > 0 and row["cascade"]["retimed_sec"] > 0
    assert (tmp_path / "fidelity.obs.jsonl").exists()


def test_tuner_overhead_quick_writes_a_stamped_report(tmp_path):
    out = tmp_path / "overhead.json"
    assert tto.main(["--quick", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert sorted(report["learners"]) == ["GP", "RF"]
    assert sorted(report["learners"]["RF"]) == ["200", "50"]
    assert report["meta"]["torch"] == torch.__version__
    assert report["cascade"]["hw_evals"] == 8


@pytest.mark.parametrize("learner", ["RF", "ET", "GBRT", "GP"])
def test_tuner_overhead_proposals_equal_the_reference(learner):
    # the synthetic campaign's fixed-seed asks, bit for bit
    ours, theirs = tto.seeded_search(learner, 24), jto.seeded_search(learner, 24)
    for _ in range(3):
        a, b = ours.ask(), theirs.ask()
        assert a == b
        ours.tell(a, tto.EvalResult(tto.objective(a), True, {}))
        theirs.tell(b, jto.EvalResult(jto.objective(b), True, {}))


def test_tuner_overhead_cascade_counts_equal_the_reference():
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.obs.metrics import MetricsRegistry

    ours, theirs = tto.time_cascade(MetricsRegistry()), jto.time_cascade(JRegistry())
    keys = ("screened", "promoted", "hw_evals", "n_pruned")
    assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
