"""repro_torch's autotune CLI and timing evaluator on the CPU backend (the
plain versions at bench sizes): the CLI writes the reference's database
layout and prints the reference's summary keys plus the device and the
kernel launch count; the evaluator turns only pre-launch rejections into
penalties."""

import json
import os

import pytest

from repro_torch.core import PENALTY, ConfigRejected, PerformanceDatabase, TimingEvaluator
from repro_torch.launch import autotune

REFERENCE_KEYS = {"best_config", "best_objective_sec", "found_at_eval", "importance"}


def _summary(out: str) -> dict:
    head, _, body = out.partition("\n{")
    return json.loads("{" + body)


@pytest.mark.parametrize("kernel", ["syr2k", "mm3"])
def test_cli_cpu_backend_writes_db_and_summary(kernel, tmp_path, capsys):
    db = str(tmp_path / kernel)
    rc = autotune.main(["--kernel", kernel, "--backend", "cpu", "--max-evals", "6",
                        "--db", db, "--seed", "3"])
    assert rc == 0
    summary = _summary(capsys.readouterr().out)
    assert REFERENCE_KEYS <= set(summary)
    assert summary["device"] == "cpu"
    wrapper = "syr2k" if kernel == "syr2k" else "tiled_matmul"
    assert summary["launches"] == {wrapper: 0}  # the CPU runs the plain version
    assert summary["n_evaluated"] == 6 and summary["n_failed"] == 0
    assert {"ask_sec", "tell_sec", "wait_sec"} <= set(summary["timings"])
    assert os.path.exists(os.path.join(db, "results.csv"))
    assert os.path.exists(os.path.join(db, "results.jsonl"))
    recs = PerformanceDatabase(db).records
    assert len(recs) == 6
    assert min(r.objective for r in recs) == summary["best_objective_sec"]


def test_cli_resume_continues_with_remaining_budget(tmp_path, capsys):
    db = str(tmp_path / "db")
    autotune.main(["--kernel", "syr2k", "--backend", "cpu", "--max-evals", "4", "--db", db])
    capsys.readouterr()
    autotune.main(["--kernel", "syr2k", "--backend", "cpu", "--max-evals", "7",
                   "--db", db, "--resume"])
    out = capsys.readouterr().out
    assert "resume: 4 record(s) checkpointed, 3 evaluation(s) remaining" in out
    assert len(PerformanceDatabase(db).records) == 7


def test_cli_rejects_resume_without_db():
    with pytest.raises(SystemExit):
        autotune.main(["--kernel", "syr2k", "--backend", "cpu", "--resume"])


def test_cli_help_names_unported_flags(capsys):
    with pytest.raises(SystemExit):
        autotune.main(["--help"])
    out = capsys.readouterr().out
    for flag in ("--warm-start", "--store", "--cascade", "--prune-infeasible"):
        assert flag in out


def test_timing_evaluator_reports_minimum_cpu_time():
    calls = []

    def factory(cfg):
        return (lambda x: calls.append(x)), (cfg["x"],)

    res = TimingEvaluator(factory, repeats=3, warmup=2)({"x": 1})
    assert res.ok and len(res.info["times_sec"]) == 3
    assert res.objective == min(res.info["times_sec"])
    assert calls == [1] * 5


def test_timing_evaluator_penalises_only_rejected_configs():
    def rejecting(cfg):
        raise ConfigRejected("tile needs too much shared memory")

    res = TimingEvaluator(rejecting)({})
    assert not res.ok and res.objective == PENALTY and res.info["rejected"]

    def broken(cfg):
        def fn():
            raise RuntimeError("CUDA launch failed")
        return fn, ()

    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        TimingEvaluator(broken)({})
