"""Evaluation executors: how a campaign turns proposed configs into results.

An executor is anything with ``submit(config) -> Future[EvalResult]``,
``max_inflight`` (the batch width the campaign should ask for), and
``shutdown()``. Two implementations cover the stack:

  * :class:`InlineExecutor` — evaluates synchronously inside ``submit``;
    ``max_inflight == 1``, so a campaign on it *is* the paper's serial loop.
  * :class:`ThreadExecutor` — a thread pool evaluating ``max_workers``
    candidates concurrently. The evaluator must be thread-safe (the stock
    :class:`~repro_torch.core.plopper.TimingEvaluator` and the roofline
    cost-model evaluators are).

The evaluator itself is orthogonal: :func:`evaluator_for_spec` builds the
right one for a dispatch-registry :class:`VariantSpec` — the spec's
``make_evaluator`` override (e.g. the roofline cost backend registered by
``repro_torch.kernels.problems.register_cost_backend``) when present, wall-clock
timing otherwise. That is what lets background campaigns tune TPU-target
schedules on a host with no TPU attached.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Any, Callable, Mapping, Protocol, runtime_checkable

from repro_torch.core.plopper import EvalResult

__all__ = [
    "Executor",
    "InlineExecutor",
    "ThreadExecutor",
    "make_executor",
    "evaluator_for_spec",
]


@runtime_checkable
class Executor(Protocol):
    max_inflight: int

    def submit(self, config: Mapping[str, Any]) -> "cf.Future[EvalResult]": ...

    def shutdown(self, wait: bool = True) -> None: ...


class InlineExecutor:
    """Synchronous executor: ``submit`` evaluates immediately and returns an
    already-completed future. Evaluator exceptions propagate through the
    future exactly as they would from a direct call."""

    max_inflight = 1

    def __init__(self, evaluator: Callable[[Mapping[str, Any]], EvalResult]):
        self.evaluator = evaluator

    def submit(self, config: Mapping[str, Any]) -> cf.Future:
        fut: cf.Future = cf.Future()
        try:
            fut.set_result(self.evaluator(config))
        except BaseException as e:  # noqa: BLE001 — surfaced at fut.result()
            fut.set_exception(e)
        return fut

    def shutdown(self, wait: bool = True) -> None:
        pass


class ThreadExecutor:
    """Thread-pool executor evaluating up to ``max_workers`` configs at once."""

    def __init__(self, evaluator: Callable[[Mapping[str, Any]], EvalResult],
                 max_workers: int = 4):
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        self.evaluator = evaluator
        self.max_inflight = max_workers
        self._pool = cf.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="repro-engine")

    def submit(self, config: Mapping[str, Any]) -> cf.Future:
        return self._pool.submit(self.evaluator, dict(config))

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)


def make_executor(evaluator: Callable[[Mapping[str, Any]], EvalResult],
                  parallel: int = 1) -> Executor:
    """Inline for ``parallel=1`` (bit-for-bit serial semantics), thread pool
    for ``parallel>1``."""
    if parallel <= 1:
        return InlineExecutor(evaluator)
    return ThreadExecutor(evaluator, max_workers=parallel)


def evaluator_for_spec(spec, factory: Callable) -> Callable[[Mapping[str, Any]], EvalResult]:
    """Evaluator for a dispatch-registry ``VariantSpec``: the spec's
    ``make_evaluator`` override (cost backends, custom scorers) when present,
    else wall-clock timing of ``factory(config) -> (fn, args)``."""
    if spec.make_evaluator is not None:
        return spec.make_evaluator(factory)
    from repro_torch.core.plopper import TimingEvaluator

    return TimingEvaluator(factory, repeats=spec.eval_repeats, warmup=spec.eval_warmup)
