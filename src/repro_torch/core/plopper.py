"""Plopper: turn a configuration into a measurable program and score it.

In the paper the plopper substitutes ``#P0..#Pm`` into a code mold, invokes
``clang`` and runs the binary (exe.pl). Here the "mold" is a *variant factory*
— a Python callable ``factory(config) -> (fn, args)`` that closes over the
configuration — and :class:`TimingEvaluator` runs and times it: with CUDA
events when the arguments live on the card (:class:`LaunchClock`, the clock
the guard's shadow samples use too), with ``perf_counter`` on the CPU.
:class:`CostModelEvaluator` (backend B2) scores a configuration without
running it: the roofline bound of a traced step (``repro_torch.perf``).

Failure contract. Only a configuration the kernel wrapper refuses *before*
launch (:class:`ConfigRejected`: a tile whose shared memory exceeds the
device's per-block limit, a tile wider than the kernel's register tile)
becomes a penalty record, so one illegal point cannot end a campaign. A
kernel that fails to build, a refused launch, or a CUDA fault while it runs
propagates: it is a defect of the port, never a slow configuration.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import threading
import time
import traceback
from typing import Any, Callable, Mapping

import torch

__all__ = [
    "ConfigRejected",
    "CostModelEvaluator",
    "EvalResult",
    "LaunchClock",
    "TimingEvaluator",
    "DeadlineEvaluator",
    "PENALTY",
]

PENALTY = float(1.0e9)


class ConfigRejected(ValueError):
    """A configuration a kernel wrapper refuses before launching anything."""


@dataclasses.dataclass
class EvalResult:
    objective: float
    ok: bool
    info: dict


def _tensors(args: tuple):
    """The tensor arguments, and the tensor fields of view arguments (such
    as ``CacheRows``)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif dataclasses.is_dataclass(a) and not isinstance(a, type):
            for f in dataclasses.fields(a):
                if isinstance(getattr(a, f.name), torch.Tensor):
                    yield getattr(a, f.name)


def _on_cuda(args) -> bool:
    return any(t.is_cuda for t in _tensors(args))


# the spin queued ahead of a timed call's first mark: at least 0.1 ms at the
# H100's clock, longer than a fast host takes from that mark to its first
# launch; a slower host's spin is longer (lead_cycles)
LEAD_CYCLES = 200_000
LEAD_SEC = 1e-4  # LEAD_CYCLES at about 2 GHz
LEAD_MAX_CYCLES = 20 * LEAD_CYCLES

# host seconds from the first mark to the first launch of recent timed calls
_lead_paths: collections.deque = collections.deque(maxlen=32)


def lead_cycles() -> int:
    """The spin ahead of a timed call: twice the median host path from the
    first mark to the first launch over the last timed calls, at least
    :data:`LEAD_CYCLES`, at most :data:`LEAD_MAX_CYCLES`. A host whose path
    outlasts a fixed spin leaves the device idle inside the timed span: on
    a slow host a healthy decode attention read 4.6 times its objective
    and the drift watch quarantined it."""
    if not _lead_paths:
        return LEAD_CYCLES
    want = 2.0 * statistics.median(_lead_paths) / LEAD_SEC * LEAD_CYCLES
    return int(min(LEAD_MAX_CYCLES, max(LEAD_CYCLES, want)))


class LaunchClock:
    """Times one call on ``args``, started at construction: on the card a
    pair of ``torch.cuda.Event`` records on the current stream (device
    seconds); on the CPU a ``perf_counter`` interval. The one clock of the
    evaluator's runs and of the guard's shadow samples, so that the store's
    objective and the live samples the drift watch holds to it measure the
    same thing.

    On the card the clock first waits for the work already queued on the
    current stream, so that the call starts on an idle stream. It then
    times the call from its first device operation to its last: the
    wrappers record the armed start event before the first device work of
    their call (:func:`repro_torch.kernels.build.mark_launch`) and the armed
    end event after each launch and after torch work that follows the last
    one (:func:`repro_torch.kernels.build.mark_end`). Just before the start
    is recorded the clock queues a spin of :func:`lead_cycles` on the
    stream, so the start fires when the spin ends, by which time the host
    has queued the call's first kernels (the spin follows the host's
    measured path from that mark to the first launch): neither the host's Python path
    around the call nor its launch overhead is in the time of a small call,
    only the host's pace between the launches of a host-driven schedule
    (lu, Floyd-Warshall) that outruns the spin. A sampled call's device work
    starts that much later. Timed on the host, a small call's time rose and
    fell with the load on the host: the drift watch read a healthy record's
    live p50 at three times its objective and quarantined it, and a
    campaign ranked configs by their host path. A call
    that launches none of the port's kernels (a variant of torch
    operations) is timed from the clock's start to its return. The waits
    are on events of this stream, never a device-wide synchronise: a
    background campaign's stream is not waited for."""

    def __init__(self, args: tuple):
        self.start = self.end = None
        if _on_cuda(args):
            from repro_torch.kernels import build

            queued = torch.cuda.Event()
            queued.record()
            queued.synchronize()
            stream = torch.cuda.current_stream()
            self.start = torch.cuda.Event(enable_timing=True)
            self.launch = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record(stream)
            cycles = lead_cycles()
            build.arm_launch_mark(self.launch, stream, end=self.end,
                                  lead=lambda: torch.cuda._sleep(cycles))
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Seconds of the call's device work (on the card) or since
        construction (on the CPU)."""
        if self.start is None:
            return time.perf_counter() - self.t0
        from repro_torch.kernels import build

        fired, ended = build.disarm_launch_mark()
        path = build.lead_host_sec()
        if path is not None:
            _lead_paths.append(path)
        if not ended:  # no launch (torch operations alone, or a copy)
            self.end.record()
        self.end.synchronize()
        return (self.launch if fired else self.start).elapsed_time(self.end) / 1e3


class TimingEvaluator:
    """Measured run time of ``fn(*args)`` for ``factory(config) -> (fn, args)``.

    The variant is warmed up ``warmup`` times, then timed ``repeats`` times;
    the *minimum* is reported (the paper reports the smallest execution time
    of repeated runs). On the card each run is timed by a
    :class:`LaunchClock`, from the run's first device operation to its last
    (device time, with the host's pace between the launches of a
    host-driven schedule); timed runs on one card are serialised by a lock
    so that concurrent evaluations (``parallel>1``) never overlap on the
    device. On the CPU each run is a ``perf_counter`` interval.
    """

    def __init__(self, factory: Callable[[Mapping[str, Any]], tuple], repeats: int = 3,
                 warmup: int = 1, penalty: float = PENALTY):
        self.factory = factory
        self.repeats = repeats
        self.warmup = warmup
        self.penalty = penalty
        self._device_lock = threading.Lock()

    def __call__(self, config: Mapping[str, Any]) -> EvalResult:
        try:
            fn, args = self.factory(config)
            if _on_cuda(args):
                with self._device_lock:
                    times = self._time_cuda(fn, args)
            else:
                times = self._time_cpu(fn, args)
        except ConfigRejected as e:
            return EvalResult(self.penalty, False,
                              {"error": f"ConfigRejected: {e}", "rejected": True})
        return EvalResult(min(times), True, {"times_sec": times})

    def _time_cuda(self, fn, args) -> list[float]:
        for _ in range(self.warmup):
            fn(*args)
        times = []
        for _ in range(self.repeats):
            clock = LaunchClock(args)
            fn(*args)
            times.append(clock.stop())
        return times

    def _time_cpu(self, fn, args) -> list[float]:
        for _ in range(self.warmup):
            fn(*args)
        times = []
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
        return times


def _score_planned(built) -> tuple[float, dict]:
    from repro_torch.perf.roofline import score_cell  # lazy: perf imports the models

    plan, mesh = built
    return score_cell(plan, mesh)


class CostModelEvaluator:
    """Backend B2: the roofline score of a traced step (nothing runs on a
    device).

    ``factory(config)`` must return a *thunk* that builds the cell to score
    (by default a ``(CellPlan, mesh)`` pair, ``launch.cells.plan_cell``), so
    that building it happens inside the failure guard. ``score(built) ->
    (seconds, info)`` defaults to the roofline bound of the traced cell
    (``perf.roofline.score_cell``); injectable for tests. A failure while
    building or scoring becomes a penalty record, as in the reference: one
    configuration that cannot be traced must not end a campaign.
    """

    def __init__(self, factory: Callable[[Mapping[str, Any]], Callable[[], Any]],
                 score: Callable[[Any], tuple[float, dict]] | None = None,
                 penalty: float = PENALTY):
        self.factory = factory
        self.score = score or _score_planned
        self.penalty = penalty

    def __call__(self, config: Mapping[str, Any]) -> EvalResult:
        try:
            thunk = self.factory(config)
            seconds, info = self.score(thunk())
            return EvalResult(float(seconds), True, info)
        except Exception as e:  # noqa: BLE001 — any failure becomes a penalty
            return EvalResult(
                self.penalty, False,
                {"error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc(limit=3)},
            )


class DeadlineEvaluator:
    """Straggler mitigation for evaluation campaigns: give up on a candidate
    whose evaluation exceeds ``deadline_sec`` and penalize it.

    Wall-clock is checked *after* the inner call returns (JAX work is not
    preemptible from Python), so the deadline converts stragglers into
    penalized records rather than hung campaigns on *subsequent* candidates:
    any candidate observed to exceed the deadline is recorded as failed, and
    the measured time still feeds the DB so findMin never selects it.
    """

    def __init__(self, inner: Callable[[Mapping[str, Any]], EvalResult], deadline_sec: float):
        self.inner = inner
        self.deadline_sec = deadline_sec

    def __call__(self, config: Mapping[str, Any]) -> EvalResult:
        t0 = time.perf_counter()
        res = self.inner(config)
        wall = time.perf_counter() - t0
        if wall > self.deadline_sec:
            info = dict(res.info)
            info["straggler_wall_sec"] = wall
            return EvalResult(max(res.objective, self.inner_penalty()), False, info)
        return res

    def inner_penalty(self) -> float:
        return getattr(self.inner, "penalty", PENALTY)
