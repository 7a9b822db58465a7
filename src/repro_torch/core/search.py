"""Bayesian-optimization search loop (Sec. 2.2/2.3 of the paper).

Loop semantics reproduce ytopt's behavior, including the paper's observed
learner asymmetry:

  * initialization — a small batch of random or Latin-hypercube samples is
    evaluated to seed the performance database;
  * iteration — fit the surrogate on the DB, draw a candidate pool, rank by
    the LCB acquisition, and select;
  * duplicate handling — RF/ET/GBRT consult the performance DB and *re-select*
    until a fresh configuration is found, so they spend the full evaluation
    budget. GP (as shipped in ytopt at the time) does not: a duplicate
    proposal is recorded as skipped and still consumes budget, which is why
    the paper's GP run "finishes only 66 of the 200 evaluations" on syr2k.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np

from repro_torch.core import acquisition as acq_mod
from repro_torch.core import surrogates
from repro_torch.core.database import FAILED, OK, SKIPPED_DUPLICATE, PerformanceDatabase, Record
from repro_torch.core.plopper import EvalResult
from repro_torch.core.space import ConfigurationSpace, config_key

__all__ = ["SearchResult", "BayesianSearch", "run_search"]


@dataclasses.dataclass
class SearchResult:
    db: PerformanceDatabase
    best: Record | None
    n_evaluated: int
    n_skipped: int
    n_failed: int
    learner: str
    # optimizer-overhead telemetry (CATBench-style): cumulative seconds the
    # campaign spent inside ask/tell vs waiting on evaluations. None for
    # results not produced by a Campaign.
    timings: dict | None = None

    def summary(self) -> str:
        b = self.best
        head = (
            f"[{self.learner}] evals={self.n_evaluated} skipped={self.n_skipped} "
            f"failed={self.n_failed}"
        )
        if b is None:
            return head + " best=<none>"
        return head + f" best={b.objective:.6g} @eval#{b.index} config={b.config}"


class BayesianSearch:
    """ask/tell Bayesian optimizer over a :class:`ConfigurationSpace`.

    Supports batched proposals: ``ask(n)`` returns ``n`` distinct candidates
    using a constant-liar fill-in — each proposal is registered as a
    *pending* evaluation whose objective is lied to be the mean of the
    observed values, so refitting the surrogate between in-batch proposals
    steers later candidates away from (already-claimed) regions, the qLCB
    batch strategy. ``tell``/``tell_skipped`` clear the pending entry. With
    an empty pending set, ``ask()`` is bit-for-bit the serial single-point
    proposal loop, which is how ``q=1`` campaigns reproduce legacy serial
    trajectories exactly.
    """

    def __init__(
        self,
        space: ConfigurationSpace,
        learner: str = "RF",
        acq: str = "LCB",
        kappa: float = 1.96,
        n_initial: int = 10,
        init_method: str = "lhs",
        n_candidates: int = 512,
        seed: int = 1234,
        db: PerformanceDatabase | None = None,
        prior_records: list[tuple[Mapping[str, Any], float]] | None = None,
        feasibility: Callable[[Mapping[str, Any]], bool] | None = None,
    ):
        self.space = space
        self.learner_name = learner.upper()
        self.acq = acq_mod.make_acquisition(acq)
        self.kappa = kappa
        self.init_method = init_method
        self.n_candidates = n_candidates
        # static feasibility predicate (repro_torch.analyze): candidates it
        # rejects are pruned from the pool before acquisition scoring, so
        # the optimizer never spends surrogate evaluations on configs that
        # cannot build. Opt-in (None = off) — pruning changes which configs
        # reach the acquisition argsort, and the bit-identical legacy
        # trajectory contract covers the default-off path.
        self.feasibility = feasibility
        self.n_pruned = 0  # statically-infeasible candidates discarded
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.db = db if db is not None else PerformanceDatabase()
        self._init_queue: list[dict] = []
        self._model = None
        # hot-path caches: encoded training rows by record index (the DB is
        # append-only, so rows never go stale), the persistent GP whose
        # Cholesky factor extends incrementally across tells, and — inside an
        # ask(n) batch — the sampled-and-encoded base candidate pool
        self._enc_by_index: dict[int, np.ndarray] = {}
        self._gp: surrogates.GaussianProcess | None = None
        self._batch_active = False
        self._pool_base: tuple[list[dict], np.ndarray] | None = None
        # configs proposed but not yet told: config_key -> config. They act
        # as constant-liar observations in _training_data and are excluded
        # from re-proposal, enabling n candidates in flight at once.
        self._pending: dict[tuple, dict] = {}
        # warm start: (config, objective) pairs from a prior campaign (e.g. a
        # TuningStore nearest neighbor) become virtual observations — they seed
        # the surrogate without consuming evaluation budget, and each prior
        # replaces one random initialization sample. Priors occupy the leading
        # training rows (see _training_data); note this row layout changed in
        # the vectorization PR (records-first before), so *warm-started*
        # trajectories differ from older runs — the bit-identity contract
        # covers prior-free campaigns, which are the paper's.
        self._prior_X, self._prior_y = self._encode_priors(prior_records or [])
        self.n_priors = 0 if self._prior_y is None else len(self._prior_y)
        self.n_initial = max(1, n_initial - self.n_priors) if self.n_priors else n_initial

    def _encode_priors(self, records):
        """Encode prior (config, objective) pairs as virtual observations.

        A config may appear more than once — a multi-fidelity cascade
        (repro_torch.fidelity) observes the same schedule at several rungs. Priors
        are deduped by canonical config key so a config contributes exactly
        one training row: callers list records in ascending fidelity order,
        and the *last* (highest-fidelity) objective wins, at the first
        occurrence's row position so the prior-row layout stays stable.
        Configs already recorded in the DB are dropped entirely — a resumed
        campaign's real observation at the current fidelity would otherwise
        be double-counted against its own lower-rung prior.
        """
        by_key: dict[tuple, tuple[np.ndarray, float]] = {}
        for cfg, obj in records:
            try:  # foreign configs (other space revisions) are skipped, not fatal
                self.space.validate(cfg)
                if self.db.contains(cfg):
                    continue
                # dict insertion order keeps the first occurrence's position;
                # assignment keeps the last occurrence's (highest-rung) value
                key = config_key(cfg)
                enc = by_key[key][0] if key in by_key else self.space.encode(cfg)
                by_key[key] = (enc, float(obj))
            except Exception:
                continue
        if not by_key:
            return None, None
        X = np.stack([enc for enc, _ in by_key.values()])
        y = np.array([obj for _, obj in by_key.values()])
        return X, y

    # GP is the learner that does NOT consult the DB to re-select on duplicates
    @property
    def dedups_against_db(self) -> bool:
        return self.learner_name != "GP"

    # -- ask -------------------------------------------------------------------

    def _initial_batch(self) -> list[dict]:
        n = self.n_initial
        if self.init_method == "lhs":
            return self.space.latin_hypercube(n, self.rng)
        return self.space.sample_configurations(n, self.rng)

    def _training_data(self):
        """All recorded evaluations; failures are clipped to a soft penalty so
        the surrogate learns to avoid the region without its scale exploding.
        Pending (in-flight) configs are appended as constant-liar rows whose
        objective is the mean of the real observations, so a batch's later
        proposals see its earlier ones as already claimed."""
        recs = [r for r in self.db.records if r.status in (OK, FAILED)]
        if not recs:
            if self._prior_X is not None:
                return self._liar_augment(self._prior_X, self._prior_y)
            return (None, None) if not self._pending else self._liar_augment(None, None)
        ok_vals = [r.objective for r in recs if r.status == OK]
        cap = (max(ok_vals) * 2.0 + 1e-9) if ok_vals else 1.0
        X = self._encode_records(recs)
        y = np.array([min(r.objective, cap) for r in recs])
        if self._prior_X is not None:
            # priors lead so the row layout is [fixed priors, append-only
            # records, liar tail]: each tell extends the matrix instead of
            # inserting mid-array, which is what lets the GP's incremental
            # Cholesky reuse its cached prefix on warm-started campaigns
            X = np.concatenate([self._prior_X, X])
            y = np.concatenate([self._prior_y, y])
        return self._liar_augment(X, y)

    def _encode_records(self, recs) -> np.ndarray:
        """Encoded feature rows for DB records, memoized by record index (the
        DB is append-only): each record is encoded exactly once per campaign
        instead of once per ask. Row values are identical to
        ``space.encode_many([r.config for r in recs])``."""
        rows = []
        for r in recs:
            row = self._enc_by_index.get(r.index)
            if row is None:
                row = self._enc_by_index[r.index] = self.space.encode(r.config)
            rows.append(row)
        if not rows:
            return np.zeros((0, self.space.n_features()))
        return np.stack(rows)

    def _liar_augment(self, X, y):
        """Append one (encoded config, lied objective) row per pending eval.
        No-op — returning X, y untouched — when nothing is pending, which is
        what keeps ``q=1`` campaigns identical to the legacy serial loop."""
        if not self._pending:
            return X, y
        Xp = self.space.encode_many(list(self._pending.values()))
        lie = float(np.mean(y)) if y is not None and len(y) else 0.0
        yp = np.full(len(Xp), lie)
        if X is None:
            return Xp, yp
        return np.concatenate([X, Xp]), np.concatenate([y, yp])

    # -- pending (in-flight) bookkeeping ---------------------------------------

    def mark_pending(self, config: Mapping[str, Any]) -> None:
        """Register an in-flight evaluation (no-op for configs already in the
        DB — a real observation beats a lie)."""
        key = config_key(config)
        if key not in self._pending and not self.db.contains(config):
            self._pending[key] = dict(config)

    def clear_pending(self, config: Mapping[str, Any]) -> None:
        self._pending.pop(config_key(config), None)

    def is_pending(self, config: Mapping[str, Any]) -> bool:
        return config_key(config) in self._pending

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def _is_fresh(self, config: Mapping[str, Any]) -> bool:
        return not self.db.contains(config) and not self.is_pending(config)

    def _candidate_pool(self) -> tuple[list[dict], np.ndarray]:
        """Candidate pool plus its encoded feature matrix. Inside an
        ``ask(n)`` batch the ``n_candidates`` base samples are drawn and
        encoded exactly once (the first model-guided proposal caches them);
        later proposals only draw fresh mutation candidates around the
        incumbent — their constant-liar rows already steer them apart, so
        re-sampling the whole pool per proposal bought nothing but CPU."""
        if self._batch_active and self._pool_base is not None:
            base, Xb = self._pool_base
        else:
            base = self.space.sample_configurations(self.n_candidates, self.rng)
            Xb = self.space.encode_many(base)
            # prune before caching so a batch pays the feasibility sweep of
            # the base pool once, and n_pruned counts each config once
            base, Xb = self._apply_feasibility(base, Xb)
            if self._batch_active:
                self._pool_base = (base, Xb)
        best = self.db.best()
        if best is not None:  # local perturbations around incumbent
            extra = [self.space.mutate(best.config, self.rng)
                     for _ in range(self.n_candidates // 8)]
            if extra:
                Xe = self.space.encode_many(extra)
                extra, Xe = self._apply_feasibility(extra, Xe)
            if extra:
                return base + extra, np.concatenate([Xb, Xe])
        return list(base), Xb

    def _apply_feasibility(self, pool: list[dict], X: np.ndarray):
        """Drop statically-infeasible candidates (and their feature rows)
        before they reach the surrogate. Sampling already consumed the RNG,
        so pruning never perturbs the stream; with the predicate unset this
        is an identity pass. If *every* candidate is infeasible the raw pool
        survives as a fallback — proposing a doomed config (which tell()
        records as failed) beats proposing nothing."""
        if self.feasibility is None or not pool:
            return pool, X
        mask = np.fromiter((bool(self.feasibility(c)) for c in pool),
                           dtype=bool, count=len(pool))
        n_bad = int(len(pool) - mask.sum())
        if n_bad == 0:
            return pool, X
        self.n_pruned += n_bad
        if not mask.any():
            return pool, X
        return [c for c, keep in zip(pool, mask) if keep], X[mask]

    def ask(self, n: int | None = None) -> dict | list[dict]:
        """Propose the next candidate(s). ``ask()`` returns a single config
        (legacy serial API, no pending registration). ``ask(n)`` returns a
        list of ``n`` configs, each registered pending with a constant-liar
        observation so they can be evaluated concurrently; callers must
        ``tell``/``tell_skipped`` each one to release its pending slot.
        The base candidate pool is sampled and encoded once per batch, so
        ``ask(1)`` consumes RNG exactly like the legacy serial ``ask()``."""
        if n is None:
            return self._ask_one()
        batch = []
        self._batch_active, self._pool_base = True, None
        try:
            for _ in range(n):
                cfg = self._ask_one()
                self.mark_pending(cfg)
                batch.append(cfg)
        finally:
            self._batch_active, self._pool_base = False, None
        return batch

    def _ask_one(self) -> dict:
        # 1) initialization phase (pending evals count toward the quota)
        if len(self.db) + self.n_pending < self.n_initial:
            if not self._init_queue:
                self._init_queue = self._initial_batch()
            while self._init_queue:
                cfg = self._init_queue.pop(0)
                if not self.dedups_against_db or self._is_fresh(cfg):
                    return cfg
            return self.space.sample_configuration(self.rng)

        # 2) model-guided phase
        X, y = self._training_data()
        if X is None or len(np.unique(y)) < 2:
            return self.space.sample_configuration(self.rng)
        seed = int(self.rng.integers(2**31))  # drawn even on the GP-reuse path
        if self.learner_name == "GP":
            # persistent GP: the cached Cholesky factor extends incrementally
            # over the unchanged row-prefix instead of refitting the whole
            # length-scale grid on every proposal (see GaussianProcess)
            if self._gp is None:
                self._gp = surrogates.make_learner("GP", seed=seed)
            model = self._gp.partial_fit(X, y)
        else:
            model = surrogates.make_learner(self.learner_name, seed=seed)
            model.fit(X, y)
        self._model = model

        pool, Xc = self._candidate_pool()
        mu, sigma = model.predict(Xc)
        best = self.db.best()
        scores = self.acq(mu, sigma, kappa=self.kappa,
                          best=best.objective if best else float(np.min(y)))
        order = np.argsort(scores)

        if self.dedups_against_db:
            for i in order:
                if self._is_fresh(pool[int(i)]):
                    return pool[int(i)]
            return self.space.sample_configuration(self.rng)  # pool exhausted
        # GP path: return the argmin even if it repeats a previous evaluation
        return pool[int(order[0])]

    # -- tell ------------------------------------------------------------------

    def tell(self, config: Mapping[str, Any], result: EvalResult) -> Record:
        self.clear_pending(config)
        status = OK if result.ok else FAILED
        return self.db.add(config, result.objective, status=status, info=result.info)

    def tell_skipped(self, config: Mapping[str, Any]) -> Record:
        self.clear_pending(config)
        prior = self.db.lookup(config)
        obj = prior.objective if prior else float("nan")
        return self.db.add(config, obj, status=SKIPPED_DUPLICATE,
                           info={"duplicate_of": prior.index if prior else None})


def run_search(
    space: ConfigurationSpace,
    evaluator: Callable[[Mapping[str, Any]], EvalResult],
    max_evals: int = 100,
    learner: str = "RF",
    seed: int = 1234,
    db_path: str | None = None,
    n_initial: int = 10,
    init_method: str = "lhs",
    kappa: float = 1.96,
    acq: str = "LCB",
    callback: Callable[[Record], None] | None = None,
    warm_start: list | None = None,
    warm_start_records: list[tuple[Mapping[str, Any], float]] | None = None,
    parallel: int = 1,
    executor=None,
    feasibility: Callable[[Mapping[str, Any]], bool] | None = None,
) -> SearchResult:
    """Run a full campaign (Sec. 2.3 steps 4-8) — a thin adapter over
    :class:`repro_torch.engine.Campaign`. Resumable: if ``db_path`` already holds
    records, the campaign continues from them. ``warm_start`` configs (e.g.
    the known default schedule, or a TuningStore best) are evaluated first so
    the surrogate — and the final best — always include them.
    ``warm_start_records`` are already-measured (config, objective) pairs
    from prior campaigns: they seed the surrogate as virtual observations and
    shrink the random-initialization phase, so a warm-started campaign
    converges in far fewer evaluations. ``parallel`` > 1 evaluates that many
    candidates concurrently (constant-liar batching, thread-pool executor);
    ``parallel=1`` reproduces the legacy serial trajectory bit-for-bit."""
    from repro_torch.engine import Campaign  # deferred: engine builds on this module

    return Campaign(
        space, evaluator, max_evals=max_evals, learner=learner, seed=seed,
        db_path=db_path, n_initial=n_initial, init_method=init_method,
        kappa=kappa, acq=acq, callback=callback, warm_start=warm_start,
        warm_start_records=warm_start_records, parallel=parallel,
        executor=executor, feasibility=feasibility,
    ).run()
