"""Plopper: turn a configuration into a measurable program and score it.

In the paper the plopper substitutes ``#P0..#Pm`` into a code mold, invokes
``clang`` and runs the binary (exe.pl). Here the "mold" is a *variant factory*
— a Python callable ``factory(config) -> (fn, args)`` that closes over the
configuration — and :class:`TimingEvaluator` runs and times it: with CUDA
events when the arguments live on the card, with ``perf_counter`` on the CPU.

Failure contract. Only a configuration the kernel wrapper refuses *before*
launch (:class:`ConfigRejected`: a tile whose shared memory exceeds the
device's per-block limit, a tile wider than the kernel's register tile)
becomes a penalty record, so one illegal point cannot end a campaign. A
kernel that fails to build, a refused launch, or a CUDA fault while it runs
propagates: it is a defect of the port, never a slow configuration.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Mapping

import torch

__all__ = [
    "ConfigRejected",
    "EvalResult",
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


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


class TimingEvaluator:
    """Measured run time of ``fn(*args)`` for ``factory(config) -> (fn, args)``.

    The variant is warmed up ``warmup`` times, then timed ``repeats`` times;
    the *minimum* is reported (the paper reports the smallest execution time
    of repeated runs). On the card each run sits between a pair of
    ``torch.cuda.Event(enable_timing=True)`` records on the current stream,
    so the number is device time, not enqueue time; timed runs on one card
    are serialised by a lock so that concurrent evaluations (``parallel>1``)
    never overlap on the device. On the CPU each run is a ``perf_counter``
    interval.
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
        torch.cuda.synchronize()
        times = []
        for _ in range(self.repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
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
