"""Shared benchmark machinery of the PyTorch/CUDA port: the per-table
comparison runner, the counterpart of ``benchmarks/common.py`` (which
imports JAX, so the port keeps its own).

Each PolyBench table compares five ways to run the benchmark, the paper's
rows:

  row 1  naive          the untransformed loop nest, one torch row product
                        a step (``repro_torch.kernels.variants.naive_fns``;
                        lu, heat3d and Floyd-Warshall: their ``ref``)
                                                       ("gcc -O3")
  row 2  xla_default    the library: ``repro_torch.kernels.ref.*_ref``,
                        torch's own operators, TF32 off ("clang -O3")
  row 3  blocked_heur   the CUDA kernel at the compiler's heuristic tiles
                        (128^3)                        ("clang -O3 + polly")
  row 4  blocked_paper  the CUDA kernel at the paper's default tiles
                        (96, 2048, 256)                ("polly + pragmas")
  row 5  autotuned      the CUDA kernel at the best config of an RF
                        campaign over the ``gpu`` space ("+ ytopt")

The row names are the JAX package's, so the two packages' tables line up
row for row. Rows 3 and 4 run their config verbatim first; a config the
kernel's wrapper refuses before launch (``ConfigRejected``: a tile past the
kernel's register tile, a stage past the card's shared memory) prints as
``rejected`` with the wrapper's message, followed by a ``_clipped`` row at
the nearest point of the space, each knob clipped into its sequence (a
time, or ``rejected`` again where the card refuses that point too). No
config is substituted silently.

**One timer for every row** (:func:`time_callable`): on the card the mean
of back-to-back calls between two CUDA events after warm-up, the minimum of
three such batches; on the CPU the minimum of three ``perf_counter`` calls,
as the JAX package times. The autotuned row re-times the campaign's winner
with the same timer and prints the campaign's own objective beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import platform
import socket
import subprocess
import time
from typing import Any, Callable, Mapping

import torch

from repro_torch.core import ConfigRejected, TimingEvaluator, autotune
from repro_torch.core.space import ConfigurationSpace, Ordinal

__all__ = ["DEFAULT_EVALS", "Row", "bench_meta", "clip_config", "emit", "f32_matmuls",
           "run_table", "time_callable", "write_bench_json"]

DEFAULT_EVALS = 30  # campaign length when REPRO_BENCH_EVALS is unset (paper: 200)


@dataclasses.dataclass
class Row:
    """One benchmark row: ``us`` per call (None for a rejected config) and
    the config it ran, where there is one."""

    name: str
    us: float | None
    derived: str
    config: dict | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@contextlib.contextmanager
def f32_matmuls():
    """TF32 off inside the block and restored after it, so that the library
    rows compute in f32 as the kernels do, and no caller's flags change."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def bench_meta(device: torch.device | str | None = None) -> dict:
    """Provenance stamp of every ``BENCH_torch_*.json``: host, commit and
    time as the JAX package stamps, plus torch's and CUDA's versions and the
    card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (None on the CPU)."""
    from repro_torch.launch.fidelity import card_name_and_power_limit

    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):  # no git: a copy of the tree
        sha = None
    on_card = torch.device(device or "cuda").type == "cuda"
    return {
        "host": socket.gethostname(),
        "platform": platform.platform(),
        "machine": platform.machine(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": str(device or "cuda"),
        "card": card_name_and_power_limit() if on_card else None,
        "git_sha": sha,
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
    }


def write_bench_json(path: str, payload: dict, device=None) -> dict:
    """Stamp ``payload`` with :func:`bench_meta` and write it as JSON;
    returns the stamped dict."""
    out = {"meta": bench_meta(device), **payload}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True, default=str)
    return out


# a batch of back-to-back calls on the card lasts about BATCH_SEC, and holds
# 1 to MAX_CALLS calls: the fast kernels' rows take 20 calls a batch (as
# chip_smoke.py's phase 4 times them), a plain Floyd-Warshall of 255 ms one
BATCH_SEC = 0.02
MAX_CALLS = 20


def time_callable(fn: Callable, args: tuple, batches: int = 3, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``. On the card: after ``warmup``
    calls, one timed call sets the batch length; each of ``batches`` batches
    is that many back-to-back calls between two CUDA events, and the least
    batch mean is the time. On the CPU the least of ``batches`` single
    ``perf_counter`` calls."""
    for _ in range(warmup):
        fn(*args)
    if not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        times = []
        for _ in range(batches):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
        return min(times)

    def batch(calls: int) -> float:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / calls

    one = batch(1)
    calls = max(1, min(MAX_CALLS, int(BATCH_SEC / max(one, 1e-9))))
    return min(batch(calls) for _ in range(batches))


def clip_config(config: Mapping[str, Any], space: ConfigurationSpace) -> dict:
    """The nearest point of ``space`` to ``config``: each ordinal knob of the
    space clipped into its sequence (its nearest entry; the smaller on a
    tie), categorical knobs kept where the space has the value; knobs the
    space does not hold are dropped."""
    out = {}
    for name in space.param_names:
        if name not in config:
            continue
        hp, v = space[name], config[name]
        if isinstance(hp, Ordinal) and v not in hp.sequence:
            v = min(hp.sequence, key=lambda s: (abs(s - v), s))
        elif not hp.validate(v):
            raise ValueError(f"{name}={v!r} is not in the space's {hp}")
        out[name] = v
    return out


def _fixed_row(row: str, cfg: dict, factory: Callable) -> Row:
    """``cfg``'s row: its time, or ``rejected`` with the wrapper's message."""
    fn, fargs = factory(cfg)
    try:
        return Row(row, time_callable(fn, fargs) * 1e6, f"config={cfg}", dict(cfg))
    except ConfigRejected as e:
        return Row(row, None, f"rejected: {e}; config={cfg}", dict(cfg))


def _timed_config(name: str, label: str, cfg: dict, factory: Callable,
                  space: ConfigurationSpace) -> list[Row]:
    """Row 3 or 4: ``cfg`` verbatim; if the wrapper refuses it, its
    ``rejected`` row and then the ``_clipped`` row (which may be refused in
    turn, and is then printed ``rejected`` too: nothing further is tried)."""
    row = _fixed_row(f"{name}/{label}", cfg, factory)
    if row.us is not None:
        return [row]
    return [row, _fixed_row(f"{name}/{label}_clipped", clip_config(cfg, space), factory)]


def run_table(
    name: str,
    naive_fn: Callable,
    library_fn: Callable,
    args: tuple,
    variant_factory: Callable,
    space: ConfigurationSpace,
    heur_config: dict,
    paper_config: dict,
    max_evals: int = DEFAULT_EVALS,
    learner: str = "RF",
    check_against: torch.Tensor | None = None,
) -> list[Row]:
    """The table's rows, in the paper's order (see the module docstring);
    ``check_against`` adds the winner's correctness row (``allclose`` at
    2e-2, as the JAX package checks)."""
    with f32_matmuls():
        library_sec = time_callable(library_fn, args)
    rows = [Row(f"{name}/naive", time_callable(naive_fn, args) * 1e6, "gcc-O3-role"),
            Row(f"{name}/xla_default", library_sec * 1e6,
                "clang-O3-role: torch operators, TF32 off")]
    rows += _timed_config(name, "blocked_heur", heur_config, variant_factory, space)
    rows += _timed_config(name, "blocked_paper", paper_config, variant_factory, space)

    ev = TimingEvaluator(variant_factory, repeats=2, warmup=1)
    res = autotune(space, ev, max_evals=max_evals, learner=learner, seed=1234)
    best = res.best
    if best is None:
        raise RuntimeError(f"{name}: every one of {max_evals} evaluations was rejected")
    fn, fargs = variant_factory(best.config)
    rows.append(Row(
        f"{name}/autotuned_{learner}", time_callable(fn, fargs) * 1e6,
        f"campaign_objective_us={best.objective * 1e6:.1f};at_eval={best.index}/{max_evals};"
        f"evaluated={res.n_evaluated};failed={res.n_failed};config={best.config}",
        dict(best.config)))
    if check_against is not None:
        got = fn(*fargs)
        ok = bool(torch.allclose(got.float(), check_against.float(), atol=2e-2, rtol=2e-2))
        rows.append(Row(f"{name}/autotuned_correct", float(ok), "allclose-vs-ref"))
    return rows


def emit(rows) -> None:
    """Print ``rows`` as the JAX package's CSV: ``name,us_per_call,derived``
    (``rejected`` in place of a time)."""
    for r in rows:
        us = "rejected" if r.us is None else f"{r.us:.1f}"
        print(f"{r.name},{us},{r.derived}", flush=True)
