"""repro_torch's copied BO core against repro's: at a fixed seed the four
learners propose bit-identical configuration sequences on the syr2k host
space (the contract tests/test_engine.py pins for the reference), a
performance database written by repro loads in repro_torch and resumes with
exactly the remaining budget, and parallel campaigns keep the budget."""

import math
import os

import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.kernels.spaces import syr2k_space as jax_syr2k_space
from repro_torch.engine import Campaign
from repro_torch.kernels.spaces import syr2k_space

MAX_EVALS = 14


def objective(cfg) -> float:
    """Deterministic analytic stand-in for a timing: smooth in the log tile
    sizes, with a gain for packing and a cost for interchange."""
    return (1.0
            - 0.2 * bool(cfg["pack_a"]) - 0.1 * bool(cfg.get("pack_b", False))
            + 0.05 * bool(cfg["interchange"])
            + 0.01 * abs(math.log2(cfg["bi"]) - 5.0)
            + 0.02 * abs(math.log2(cfg["bj"]) - 6.0)
            + 0.005 * abs(math.log2(cfg["bk"]) - 4.0))


def _spy(core, calls):
    def evaluate(cfg):
        calls.append(dict(cfg))
        return core.EvalResult(objective(cfg), True, {})
    return evaluate


def _records(db):
    return [(r.index, r.status, r.config, r.objective, r.info) for r in db.records]


def test_host_space_is_the_reference_space():
    a, b = syr2k_space(target="host"), jax_syr2k_space(target="host")
    assert a.param_names == b.param_names
    assert a.cardinality() == b.cardinality() == 10648
    assert a.default_configuration() == b.default_configuration()
    assert [a.sample_configuration() for _ in range(20)] == \
           [b.sample_configuration() for _ in range(20)]


@pytest.mark.parametrize("learner", ["RF", "ET", "GBRT", "GP"])
def test_fixed_seed_trajectories_are_bit_identical(learner):
    ref_calls, got_calls = [], []
    want = jcore.autotune(jax_syr2k_space(target="host"), _spy(jcore, ref_calls),
                          max_evals=MAX_EVALS, learner=learner, seed=11)
    got = tcore.autotune(syr2k_space(target="host"), _spy(tcore, got_calls),
                         max_evals=MAX_EVALS, learner=learner, seed=11)
    assert got_calls == ref_calls
    assert _records(got.db) == _records(want.db)
    assert (got.best.index, got.best.objective) == (want.best.index, want.best.objective)


def test_reference_db_loads_and_resumes(tmp_path):
    db_path = str(tmp_path / "db")
    k = 6
    jcore.autotune(jax_syr2k_space(target="host"), _spy(jcore, []),
                   max_evals=k, learner="RF", seed=5, db_path=db_path)
    want = jcore.PerformanceDatabase(db_path)
    got = tcore.PerformanceDatabase(db_path)
    assert _records(got) == _records(want) and len(got) == k
    with open(os.path.join(db_path, "results.csv")) as f:
        header = f.readline().strip().split(",")
    assert header[-3:] == ["objective", "elapsed_sec", "status"]

    # the reference's own resume of a copy of the same checkpoint
    ref_path = str(tmp_path / "db_ref")
    os.makedirs(ref_path)
    for name in os.listdir(db_path):
        with open(os.path.join(db_path, name), "rb") as src, \
                open(os.path.join(ref_path, name), "wb") as dst:
            dst.write(src.read())
    ref_calls, got_calls = [], []
    jcore.autotune(jax_syr2k_space(target="host"), _spy(jcore, ref_calls),
                   max_evals=MAX_EVALS, learner="RF", seed=5, db_path=ref_path)
    res = tcore.autotune(syr2k_space(target="host"), _spy(tcore, got_calls),
                         max_evals=MAX_EVALS, learner="RF", seed=5, db_path=db_path)
    assert len(got_calls) == MAX_EVALS - k
    assert got_calls == ref_calls
    assert len(res.db) == MAX_EVALS
    assert _records(tcore.PerformanceDatabase(db_path)) == \
           _records(jcore.PerformanceDatabase(ref_path))


def test_parallel_campaign_keeps_budget():
    calls = []
    res = Campaign(syr2k_space(target="host"), _spy(tcore, calls),
                   max_evals=MAX_EVALS, learner="RF", seed=3, parallel=2).run()
    assert len(res.db) == MAX_EVALS == len(calls)
    keys = [tuple(sorted(c.items())) for c in calls]
    assert len(set(keys)) == len(keys)
    assert res.n_evaluated == MAX_EVALS and res.timings["n_tells"] == MAX_EVALS
