"""CascadeCampaign: successive-halving multi-fidelity search — a copy of
``repro.fidelity.cascade`` on the port's engine.

The cascade runs one :class:`~repro_torch.engine.Campaign` per rung, bottom-up::

    rung 0 (cost):   screen wide  — budget 64, promote top 8
    rung 1 (proxy):  re-measure   — budget 16, promote top 4
    rung 2 (hw):     ground truth — budget 8  → the answer

Each rung's campaign is seeded two ways from the rungs below it:

  * **promotions** — the lower rung's top-k configurations are evaluated
    *first* at the new fidelity (the engine's ``warm_start`` path), so the
    expensive rung spends its budget on the cheap rung's shortlist before
    exploring on its own;
  * **priors** — every lower-rung observation enters the surrogate as a
    virtual observation (the ``warm_start_records`` machinery), calibrated
    onto the target rung's scale by the online per-rung bias/scale model
    (:class:`~repro_torch.fidelity.calibrate.RungCalibration`, learned from the
    paired measurements the promotions themselves produce). Records are
    passed in ascending fidelity order; the search dedupes by canonical
    config key keeping the highest-fidelity row, so a config observed at
    three rungs trains the surrogate exactly once.

Every rung checkpoints through its own ``PerformanceDatabase`` JSONL under
``<db_root>/rung<level>/``. A killed cascade resumes with exactly the
remaining per-rung budgets: completed rungs replay as no-ops (their budget
is already recorded), the interrupted rung continues from its checkpoint,
and — because promotions, calibration pairs, and priors are all derived
from the rung databases — a fixed-seed resumed run is replay-identical to
an uninterrupted one.

Each rung is split into two campaign phases over the *same* database:
phase A evaluates the promotions (no priors, no proposals — it consumes no
RNG), then calibration is refreshed so the fresh (low, high) pairs inform
it, then phase B spends the rest of the rung budget on calibrated-prior BO.
Without the split, the first hardware rung would receive priors on the raw
cost-model scale — orders of magnitude off — because no paired measurement
exists yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Mapping

import numpy as np

from repro_torch.core.database import OK, PerformanceDatabase, Record
from repro_torch.core.search import SearchResult
from repro_torch.core.space import ConfigurationSpace, config_key
from repro_torch.engine import Campaign
from repro_torch.fidelity.calibrate import RungCalibration, pairs_from_records
from repro_torch.fidelity.ladder import FidelityLadder
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import span as obs_span

__all__ = ["CascadeCampaign", "CascadeResult"]

_SEED_STRIDE = 7919  # prime stride: distinct, deterministic per-rung streams


@dataclasses.dataclass
class CascadeResult:
    """Per-rung results plus the cascade's own accounting."""

    ladder: FidelityLadder
    rungs: list[SearchResult]
    best: Record | None            # the top (ground-truth) rung's best
    stats: dict                    # screened/promoted per rung + aggregates
    timings: dict                  # ask/tell/wait summed over every rung

    @property
    def hw_evals(self) -> int:
        """Records spent at the top rung — the hardware bill the cascade
        exists to shrink."""
        return self.stats["rungs"][-1]["evaluated"] + \
            self.stats["rungs"][-1]["failed"]

    def summary(self) -> str:
        parts = []
        for rung, res, st in zip(self.ladder, self.rungs, self.stats["rungs"]):
            parts.append(f"{rung.name}[{st['evaluated']}ev"
                         f"/{st['promoted']}up]" if rung.promote else
                         f"{rung.name}[{st['evaluated']}ev]")
        head = f"cascade {' -> '.join(parts)}"
        if self.best is None:
            return head + " best=<none>"
        return head + f" best={self.best.objective:.6g} config={self.best.config}"


class CascadeCampaign:
    """Screen on cheap rungs, promote the top-k, measure only the shortlist.

    ``db_root`` is a directory; each rung checkpoints under
    ``<db_root>/rung<level>/`` (``None`` = in-memory, no resume).
    ``kernel`` only labels the obs counters. Everything else matches
    :class:`~repro_torch.engine.Campaign`'s knobs and is applied per rung.
    """

    def __init__(
        self,
        space: ConfigurationSpace,
        ladder: FidelityLadder,
        *,
        db_root: str | None = None,
        learner: str = "RF",
        seed: int = 1234,
        n_initial: int = 10,
        init_method: str = "lhs",
        kappa: float = 1.96,
        acq: str = "LCB",
        parallel: int = 1,
        warm_start: list | None = None,
        warm_start_records: list[tuple[Mapping[str, Any], float]] | None = None,
        feasibility: Callable[[Mapping[str, Any]], bool] | None = None,
        callback: Callable[[Record], None] | None = None,
        kernel: str | None = None,
        min_calibration_pairs: int = 3,
    ):
        self.space = space
        self.ladder = ladder
        self.db_root = db_root
        self.learner = learner
        self.seed = seed
        self.n_initial = n_initial
        self.init_method = init_method
        self.kappa = kappa
        self.acq = acq
        self.parallel = parallel
        self.warm_start = list(warm_start or [])
        # external priors at ground-truth fidelity (e.g. the background
        # tuner's nearest-store-neighbor records): they seed the *top* rung's
        # surrogate, appended after the calibrated lower-rung priors so the
        # dedup-keep-last contract lets a true measurement override a
        # calibrated estimate of the same config
        self.warm_start_records = list(warm_start_records or [])
        self.feasibility = feasibility
        self.callback = callback
        self.kernel = kernel
        self.min_calibration_pairs = min_calibration_pairs
        self._metrics = get_registry()
        self._dbs: dict[int, PerformanceDatabase] = {}

    # -- per-rung plumbing -------------------------------------------------------

    def _db(self, level: int) -> PerformanceDatabase:
        db = self._dbs.get(level)
        if db is None:
            path = None if self.db_root is None else \
                os.path.join(self.db_root, f"rung{level}")
            db = self._dbs[level] = PerformanceDatabase(
                path, param_names=self.space.param_names)
        return db

    def _labels(self, rung) -> dict:
        labels = {"rung": rung.level}
        if self.kernel is not None:
            labels["kernel"] = self.kernel
        return labels

    def _adjacent_calibrations(self, upto: int) -> list[RungCalibration]:
        """``calibs[i]`` maps rung ``i``'s scale onto rung ``i+1``'s, fit
        from configs both databases have measured (promotions create these
        pairs). Derived from the JSONLs alone, so resume re-learns the
        identical mapping."""
        calibs = []
        for i in range(upto):
            c = RungCalibration(min_pairs=self.min_calibration_pairs)
            lo = self._db(self.ladder[i].level).records
            hi = self._db(self.ladder[i + 1].level).records
            for low, high in pairs_from_records(lo, hi):
                c.update(low, high)
            calibs.append(c)
        return calibs

    def _priors_for(self, rung_idx: int) -> list[tuple[dict, float]] | None:
        """Every lower-rung observation, chained through the adjacent
        calibrations onto the target rung's scale, in ascending fidelity
        order (the dedup-keep-last contract of ``warm_start_records``)."""
        priors: list[tuple[dict, float]] = []
        if rung_idx > 0:
            calibs = self._adjacent_calibrations(rung_idx)
            for j in range(rung_idx):
                for rec in self._db(self.ladder[j].level).records:
                    if rec.status != OK or not np.isfinite(rec.objective):
                        continue
                    obj = float(rec.objective)
                    for c in calibs[j:rung_idx]:
                        obj = c.apply(obj)
                    priors.append((dict(rec.config), obj))
        if rung_idx == len(self.ladder) - 1:
            priors.extend((dict(c), float(o)) for c, o in self.warm_start_records)
        return priors or None

    def _promotions(self, rung_idx: int) -> list[dict]:
        """Top-k configs of rung ``rung_idx`` by objective (OK records only,
        deduped by canonical key) — the shortlist the next rung measures."""
        rung = self.ladder[rung_idx]
        ranked = sorted(self._db(rung.level).evaluated(),
                        key=lambda r: (r.objective, r.index))
        out, seen = [], set()
        for rec in ranked:
            key = config_key(rec.config)
            if key in seen or not np.isfinite(rec.objective):
                continue
            seen.add(key)
            out.append(dict(rec.config))
            if len(out) >= rung.promote:
                break
        return out

    def _campaign(self, rung, *, max_evals: int, warm_start: list,
                  priors, db: PerformanceDatabase) -> Campaign:
        executor = rung.executor
        return Campaign(
            self.space,
            None if executor is not None else rung.evaluator,
            executor=executor,
            max_evals=max_evals,
            learner=self.learner,
            seed=self.seed + _SEED_STRIDE * rung.level,
            db=db,
            n_initial=self.n_initial,
            init_method=self.init_method,
            kappa=self.kappa,
            acq=self.acq,
            parallel=self.parallel,
            warm_start=warm_start,
            warm_start_records=priors,
            callback=self.callback,
            feasibility=self.feasibility,
            rung=rung.level,
        )

    # -- the cascade -------------------------------------------------------------

    def run(self) -> CascadeResult:
        results: list[SearchResult] = []
        rung_stats: list[dict] = []
        timings = {"ask_sec": 0.0, "tell_sec": 0.0, "wait_sec": 0.0}
        promoted: list[dict] = []
        for i, rung in enumerate(self.ladder):
            db = self._db(rung.level)
            already = len(db)   # resumed records count against this budget
            with obs_span("fidelity.rung", rung_name=rung.name,
                          **self._labels(rung)):
                warm = promoted if i > 0 else list(self.warm_start)
                if warm:
                    # phase A: measure the shortlist (and any rung-0 seeds)
                    # first. Proposes nothing, so it consumes no RNG; on
                    # resume, already-recorded promotions are skipped and
                    # the budget cap keeps the phase a strict subset of the
                    # rung's own budget.
                    res = self._campaign(
                        rung, max_evals=min(len(warm), rung.budget),
                        warm_start=warm, priors=None, db=db).run()
                    self._merge_timings(timings, res.timings)
                # phase B: calibration now sees the pairs phase A produced
                res = self._campaign(
                    rung, max_evals=rung.budget, warm_start=[],
                    priors=self._priors_for(i), db=db).run()
            self._merge_timings(timings, res.timings)
            results.append(res)
            fresh = len(db) - already
            promoted = self._promotions(i) if rung.promote else []
            stat = {
                "rung": rung.level, "name": rung.name,
                "budget": rung.budget, "screened": fresh,
                "evaluated": res.n_evaluated, "failed": res.n_failed,
                "skipped": res.n_skipped, "promoted": len(promoted),
            }
            rung_stats.append(stat)
            labels = self._labels(rung)
            self._metrics.add("fidelity_screened_total", fresh, **labels)
            if promoted:
                self._metrics.add("fidelity_promoted_total", len(promoted),
                                  **labels)

        calibs = self._adjacent_calibrations(len(self.ladder) - 1)
        stats = {
            "rungs": rung_stats,
            "screened": sum(s["screened"] for s in rung_stats[:-1]),
            "promoted": sum(s["promoted"] for s in rung_stats),
            "calibration": [c.describe() for c in calibs],
        }
        return CascadeResult(
            ladder=self.ladder, rungs=results,
            best=self._db(self.ladder.top.level).best(),
            stats=stats, timings=timings)

    @staticmethod
    def _merge_timings(into: dict, timings: dict | None) -> None:
        if timings:
            for k in ("ask_sec", "tell_sec", "wait_sec"):
                into[k] += timings.get(k, 0.0)
