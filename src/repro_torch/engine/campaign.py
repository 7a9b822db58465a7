"""Campaign: the single ask/evaluate/tell loop behind the whole tuning stack.

Semantics (all inherited from the paper's loop, generalized to ``q`` in
flight):

  * **budget** — ``max_evals`` counts database records: real evaluations,
    failures, and GP duplicate-skips all consume budget, exactly as in the
    serial loop (the paper's "GP finishes only 66 of 200" asymmetry).
  * **batching** — proposals come from ``BayesianSearch.ask(n)``; each
    in-flight config is a constant-liar observation, so concurrent
    candidates diversify instead of piling onto one optimum. With
    ``parallel=1`` (the :class:`~repro_torch.engine.executors.InlineExecutor`)
    the ask → evaluate → tell interleaving is byte-identical to the legacy
    serial loop, so fixed-seed trajectories are preserved.
  * **learner asymmetry** — RF/ET/GBRT never re-propose a config that is
    recorded *or* in flight; GP proposals that duplicate a recorded or
    in-flight config are told as skipped (budget consumed, nothing run).
  * **crash safety** — every ``tell`` appends one JSONL line via
    :class:`~repro_torch.core.database.PerformanceDatabase`; a campaign killed
    after ``k`` records resumes from the same ``db_path`` and performs
    exactly ``max_evals - k`` further proposals, never re-evaluating a
    completed config.
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from typing import Any, Callable, Mapping

from repro_torch.core.database import FAILED, OK, SKIPPED_DUPLICATE, PerformanceDatabase, Record
from repro_torch.core.plopper import EvalResult
from repro_torch.core.search import BayesianSearch, SearchResult
from repro_torch.core.space import ConfigurationSpace, config_key
from repro_torch.engine.executors import Executor, make_executor
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import span as obs_span

__all__ = ["Campaign"]


class Campaign:
    """One autotuning campaign: space + evaluator (or executor) + budget.

    ``evaluator`` is any ``config -> EvalResult`` callable; ``parallel`` picks
    the executor width (1 = inline/serial). Alternatively pass a ready-made
    ``executor`` (anything satisfying :class:`~repro_torch.engine.executors.Executor`)
    — then ``evaluator``/``parallel`` are ignored and the campaign does not
    shut the executor down when it finishes.
    """

    def __init__(
        self,
        space: ConfigurationSpace,
        evaluator: Callable[[Mapping[str, Any]], EvalResult] | None = None,
        *,
        executor: Executor | None = None,
        max_evals: int = 100,
        learner: str = "RF",
        seed: int = 1234,
        db: PerformanceDatabase | None = None,
        db_path: str | None = None,
        n_initial: int = 10,
        init_method: str = "lhs",
        kappa: float = 1.96,
        acq: str = "LCB",
        parallel: int = 1,
        warm_start: list | None = None,
        warm_start_records: list[tuple[Mapping[str, Any], float]] | None = None,
        callback: Callable[[Record], None] | None = None,
        feasibility: Callable[[Mapping[str, Any]], bool] | None = None,
        rung: int | None = None,
    ):
        if executor is None and evaluator is None:
            raise ValueError("Campaign needs an evaluator or an executor")
        self._owns_executor = executor is None
        self.learner = learner.upper()
        # rung-aware contract (repro_torch.fidelity): a campaign running as one
        # rung of a multi-fidelity cascade carries its rung level. Every
        # record's info gains {"rung": r}, the campaign_* metrics gain a
        # rung label (per-rung latency histograms), and timings reports the
        # level. With rung=None (every pre-fidelity caller) nothing changes:
        # labels, info dicts, and RNG consumption are byte-identical, which
        # is what keeps single-rung q=1 trajectories pinned to the paper.
        self.rung = rung
        self._labels = {"learner": self.learner}
        if rung is not None:
            self._labels["rung"] = int(rung)
        # obs integration: per-phase latencies land in the process registry
        # (campaign_{ask,tell,wait,evaluate}_seconds{learner=}) alongside the
        # plain `timings` dict below, and each phase opens a trace span —
        # a campaign run with REPRO_TRACE set renders as one timeline.
        self._metrics = get_registry()
        if executor is None:
            evaluator = self._instrument_evaluator(evaluator)
        self.executor = executor if executor is not None else make_executor(evaluator, parallel)
        self.max_evals = max_evals
        self.warm_start = list(warm_start or [])
        self.callback = callback
        self.db = db if db is not None else PerformanceDatabase(
            db_path, param_names=space.param_names)
        self.search = BayesianSearch(
            space, learner=learner, kappa=kappa, acq=acq, n_initial=n_initial,
            init_method=init_method, seed=seed, db=self.db,
            prior_records=warm_start_records, feasibility=feasibility,
        )
        # optimizer-overhead telemetry: how much wall-clock the tuner itself
        # costs (surrogate fits + acquisition scans in ask, DB appends in
        # tell) vs time blocked on evaluation results. Fed into
        # SearchResult.timings and aggregated by BackgroundTuner.stats so
        # serving hosts can watch the tuner's CPU bill.
        # n_pruned mirrors BayesianSearch.n_pruned: candidates the static
        # feasibility pass (repro_torch.analyze) discarded before acquisition
        # scoring — 0 unless a feasibility predicate was supplied.
        self.timings = {"ask_sec": 0.0, "tell_sec": 0.0, "wait_sec": 0.0,
                        "n_asks": 0, "n_tells": 0, "n_pruned": 0}
        if rung is not None:
            self.timings["rung"] = int(rung)

    # -- introspection -----------------------------------------------------------

    @property
    def q(self) -> int:
        """Max candidates in flight (the executor's width)."""
        return max(1, getattr(self.executor, "max_inflight", 1))

    @property
    def remaining(self) -> int:
        """Budget left: proposals this campaign will still make (the resume
        contract — a campaign killed after ``k`` records reports and performs
        exactly ``max_evals - k`` more)."""
        return max(0, self.max_evals - len(self.db))

    # -- the loop ----------------------------------------------------------------

    def run(self) -> SearchResult:
        try:
            self._run_warm_start()
            self._run_main_loop()
        finally:
            if self._owns_executor:
                self.executor.shutdown(wait=True)
        return self.result()

    def _instrument_evaluator(self, evaluator):
        """Wrap the evaluator so each evaluation is a trace span and a
        ``campaign_evaluate_seconds`` observation (runs on executor worker
        threads; shard-local recording keeps it lock-free)."""
        metrics, labels = self._metrics, self._labels

        def evaluate(cfg):
            t0 = time.perf_counter()
            try:
                with obs_span("campaign.evaluate", **labels):
                    return evaluator(cfg)
            finally:
                metrics.observe("campaign_evaluate_seconds",
                                time.perf_counter() - t0, **labels)

        return evaluate

    def _tell(self, config: Mapping[str, Any], result: EvalResult) -> None:
        if self.rung is not None:
            # rung-stamped records: the cascade (and anyone reading the
            # JSONL) can attribute each observation to its fidelity level
            result = EvalResult(result.objective, result.ok,
                                {**result.info, "rung": self.rung})
        t0 = time.perf_counter()
        with obs_span("campaign.tell", **self._labels):
            rec = self.search.tell(config, result)
        dt = time.perf_counter() - t0
        self.timings["tell_sec"] += dt
        self.timings["n_tells"] += 1
        self._metrics.observe("campaign_tell_seconds", dt, **self._labels)
        if self.callback:
            self.callback(rec)

    def _tell_skipped(self, config: Mapping[str, Any]) -> None:
        t0 = time.perf_counter()
        with obs_span("campaign.tell", skipped=True, **self._labels):
            rec = self.search.tell_skipped(config)
        dt = time.perf_counter() - t0
        self.timings["tell_sec"] += dt
        self.timings["n_tells"] += 1
        self._metrics.observe("campaign_tell_seconds", dt, **self._labels)
        if self.callback:
            self.callback(rec)

    def _ask(self, n: int) -> list[dict]:
        t0 = time.perf_counter()
        with obs_span("campaign.ask", n=n, **self._labels):
            batch = self.search.ask(n)
        dt = time.perf_counter() - t0
        self.timings["ask_sec"] += dt
        self.timings["n_asks"] += 1
        self.timings["n_pruned"] = self.search.n_pruned
        self._metrics.observe("campaign_ask_seconds", dt, **self._labels)
        return batch

    def _run_warm_start(self) -> None:
        """Evaluate warm-start configs first (known defaults, store bests) so
        the surrogate — and the final best — always include them. Results are
        told in submission order, keeping record indices deterministic at any
        executor width."""
        inflight: list[tuple[cf.Future, dict]] = []
        try:
            for cfg in self.warm_start:
                if len(self.db) + len(inflight) >= self.max_evals:
                    break  # budget exhausted: later warm configs can't run either
                if self.db.contains(cfg) or self.search.is_pending(cfg):
                    continue
                self.search.mark_pending(cfg)
                inflight.append((self.executor.submit(cfg), cfg))
            for fut, cfg in inflight:
                self._tell(cfg, fut.result())
        except BaseException:
            # a failing warm eval abandons its siblings; release their pending
            # slots so a caller that catches and re-runs isn't poisoned
            for _, cfg in inflight:
                self.search.clear_pending(cfg)
            raise

    def _run_main_loop(self) -> None:
        inflight: dict[cf.Future, dict] = {}
        keys_inflight: set[tuple] = set()
        order: list[cf.Future] = []  # submission order, for deterministic tells
        try:
            while True:
                # fill: propose until the executor is saturated or the budget
                # (records + in-flight) is fully committed
                while True:
                    want = min(self.q - len(inflight),
                               self.max_evals - len(self.db) - len(inflight))
                    if want <= 0:
                        break
                    progressed = False
                    for cfg in self._ask(want):
                        key = config_key(cfg)
                        if not self.search.dedups_against_db:
                            if self.db.contains(cfg):
                                # GP: a proposal duplicating a *recorded*
                                # config consumes budget unrun (the paper's
                                # budget asymmetry)
                                self._tell_skipped(cfg)
                                progressed = True
                                continue
                            if key in keys_inflight:
                                # duplicate of an unmeasured in-flight config:
                                # skipping now would record a NaN objective as
                                # the config's canonical lookup entry and
                                # erase its constant-liar row — defer instead
                                # until the real result lands
                                continue
                        fut = self.executor.submit(cfg)
                        inflight[fut] = cfg
                        keys_inflight.add(key)
                        order.append(fut)
                        progressed = True
                    if not progressed:
                        break  # only deferred duplicates: wait for results
                if not inflight:
                    break  # budget fully recorded (evals + skips)
                t0 = time.perf_counter()
                done, _ = cf.wait(list(inflight), return_when=cf.FIRST_COMPLETED)
                dt = time.perf_counter() - t0
                self.timings["wait_sec"] += dt
                self._metrics.observe("campaign_wait_seconds", dt,
                                      **self._labels)
                for fut in [f for f in order if f in done]:
                    cfg = inflight.pop(fut)
                    keys_inflight.discard(config_key(cfg))
                    order.remove(fut)
                    self._tell(cfg, fut.result())
        except BaseException:
            # a failing future abandons its siblings; release their pending
            # slots so a caller that catches and re-runs isn't poisoned
            for cfg in inflight.values():
                self.search.clear_pending(cfg)
            raise

    def result(self) -> SearchResult:
        """Summary over the database (complete or mid-flight)."""
        recs = self.db.records
        return SearchResult(
            db=self.db, best=self.db.best(),
            n_evaluated=sum(1 for r in recs if r.status == OK),
            n_skipped=sum(1 for r in recs if r.status == SKIPPED_DUPLICATE),
            n_failed=sum(1 for r in recs if r.status == FAILED),
            learner=self.learner,
            timings=dict(self.timings),
        )
