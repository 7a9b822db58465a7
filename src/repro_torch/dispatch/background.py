"""Background tuning: async BO campaigns feeding the store — a copy of
``repro.dispatch.background`` on the port's engine.

A dispatch-time cache miss (or a too-distant / stale resolution) enqueues a
campaign on a small thread worker pool. Each campaign is a
:class:`repro_torch.engine.Campaign` — the exact offline machinery —
warm-started from the store's nearest-neighbor records
(:func:`repro_torch.dispatch.lookup.warm_start_material`), so an online campaign
typically needs a fraction of the offline 200-evaluation budget. With
``parallel > 1`` each campaign additionally keeps that many candidate
evaluations in flight (constant-liar batching), saturating idle cores. The
winning config is published back to the :class:`TuningStore` (an atomic
best-only append, i.e. the hot swap) and an ``on_done`` callback lets the
dispatch service invalidate its compiled-executable cache for the affected
signature.

In-flight deduplication is by ``(kernel, signature, backend)``: a hot
serving path that misses a thousand times enqueues one campaign, not a
thousand (:meth:`BackgroundTuner.inflight` lets the service skip copying a
miss's arguments for a campaign already in flight).

On the card each campaign runs on a ``torch.cuda.Stream`` of its own: the
evaluator records its CUDA events on the current stream
(:class:`~repro_torch.core.plopper.TimingEvaluator`), and on the serving
thread's stream they would time serving kernels too. The campaigns' timed
runs still share the device with serving (and with each other when
``max_workers > 1``), so an objective measured while serving is an upper
bound on the quiet card's.

With ``cascade=True`` a campaign for a fidelity-ready kernel is a
:class:`repro_torch.fidelity.CascadeCampaign`: rung 0 screens a wide pool
on the Hopper cost model at the signature's dims
(:func:`~repro_torch.kernels.problems.dims_from_signature`), and only the
promoted top-k are timed on the card (rung 1, the campaign's own
evaluator). A ``cost`` backend, a kernel the cost model does not cover, or a
signature whose dims cannot be derived keeps the flat campaign.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import threading
import time
from typing import Any, Callable

import torch

from repro_torch.dispatch.lookup import warm_start_material
from repro_torch.dispatch.signature import ShapeSignature, signature_key
from repro_torch.dispatch.store import TuningRecord, TuningStore
from repro_torch.engine import Campaign
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import span as obs_span

__all__ = ["BackgroundTuner"]


class BackgroundTuner:
    def __init__(
        self,
        store: TuningStore,
        *,
        max_workers: int = 2,
        max_evals: int = 20,
        learner: str = "RF",
        seed: int = 1234,
        n_initial: int = 4,
        warm_neighbors: int = 3,
        parallel: int = 1,
        on_publish: Callable[[TuningRecord], None] | None = None,
        harden: Any | None = None,
        cascade: bool = False,
        cascade_budgets: tuple[int, int] | None = None,
    ):
        self.store = store
        # multi-fidelity cascade (repro_torch.fidelity): when enabled,
        # campaigns for fidelity-ready kernels screen a wide pool on the
        # Hopper cost model (rung 0) and promote only the top-k to the real
        # evaluator (rung 1), so the card pays a fraction of the timed
        # evaluations. Applies only when the backend is not already "cost"
        # (screening the cost model with itself is a no-op) and the problem
        # dims are derivable from the runtime signature; otherwise campaigns
        # silently fall back to the flat single-fidelity path.
        # cascade_budgets = (screen_budget, hw_budget); the default screens
        # 4x the flat budget analytically but spends only half of it on
        # the card.
        self.cascade = cascade
        self.cascade_budgets = cascade_budgets
        # repro_torch.guard.HardenPolicy (or None): when set, every campaign's
        # evaluator runs behind a HardenedExecutor — per-eval deadlines,
        # crash isolation, pathological-slowdown reclassification — so a
        # hung or crashing config becomes a penalized FailureObservation
        # instead of wedging a tuner worker
        self.harden = harden
        # fired after every campaign's store publish (even a rejected
        # no-improvement one): DispatchService.attach_sync hooks this so the
        # fleet SyncAgent pushes fresh results without waiting an interval
        self.on_publish = on_publish
        self.max_evals = max_evals
        self.learner = learner
        self.seed = seed
        self.n_initial = n_initial
        self.warm_neighbors = warm_neighbors
        self.parallel = parallel
        self._pool = cf.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="repro-torch-bg-tune")
        self._inflight: set[tuple] = set()
        self._futures: list[cf.Future] = []
        self._lock = threading.Lock()
        self.errors: list[tuple[tuple, BaseException]] = []
        # optimizer-overhead telemetry, aggregated across campaigns from
        # Campaign.timings: ask_sec + tell_sec is the CPU the tuner itself
        # bills to the serving host (CATBench's first-class overhead metric);
        # wait_sec is time blocked on evaluations. A serving dashboard that
        # sees ask_sec rival the eval budget knows the surrogate — not the
        # kernels — is eating the cores.
        # screened/promoted mirror the repro_torch.fidelity counters: configs
        # discarded on the cheap rung vs graduated to the card (both 0 when
        # cascade is off) — DispatchService.telemetry() surfaces them
        self.stats = {"campaigns": 0, "ask_sec": 0.0, "tell_sec": 0.0,
                      "wait_sec": 0.0, "cascade_campaigns": 0,
                      "screened": 0, "promoted": 0}

    # -- submission --------------------------------------------------------------

    def submit(
        self,
        kernel: str,
        signature: ShapeSignature,
        backend: str,
        *,
        space: Any,
        evaluator: Callable,
        max_evals: int | None = None,
        on_done: Callable[[str, ShapeSignature, str], None] | None = None,
        dtype=None,
    ) -> cf.Future | None:
        """Enqueue one campaign per distinct key; returns None when one is
        already in flight for this ``(kernel, signature, backend)``.
        ``dtype``: the call's operands' (a signature carries none), which the
        cascade's cost rung screens in."""
        key = (kernel, signature_key(signature), backend)
        with self._lock:
            if key in self._inflight:
                return None
            self._inflight.add(key)
        try:
            fut = self._pool.submit(
                self._campaign, key, kernel, signature, backend, space, evaluator,
                max_evals or self.max_evals, on_done, dtype)
        except RuntimeError:  # pool shut down: serving degrades, never crashes
            with self._lock:
                self._inflight.discard(key)
            return None
        with self._lock:
            self._futures.append(fut)
        return fut

    def inflight(self, kernel: str, signature: ShapeSignature, backend: str) -> bool:
        """True while a campaign for this key is queued or running."""
        with self._lock:
            return (kernel, signature_key(signature), backend) in self._inflight

    def _warm_start(self, kernel: str, signature: ShapeSignature, backend: str):
        """Nearest store records become warm-start material (see
        :func:`repro_torch.dispatch.lookup.warm_start_material`)."""
        return warm_start_material(
            self.store, kernel, signature, backend, neighbors=self.warm_neighbors)

    def _cascade_ladder(self, kernel, signature, backend, evaluator,
                        executor, max_evals, dtype=None):
        """Cost → card ladder for this campaign, or None for the flat
        path: cascade off, backend already analytic, kernel not
        fidelity-ready, or dims underivable from the runtime signature."""
        if not self.cascade or backend == "cost":
            return None
        from repro_torch.kernels.problems import (
            dims_from_signature,
            fidelity_ready,
            make_cost_evaluator,
        )

        if not fidelity_ready(kernel):
            return None
        try:
            dims = dims_from_signature(kernel, tuple(signature))
        except Exception:
            return None
        from repro_torch.fidelity import FidelityLadder, Rung

        screen, hw = self.cascade_budgets or (max_evals * 4,
                                              max(2, max_evals // 2))
        promote = max(1, min(screen, hw, max(2, hw // 2)))
        return FidelityLadder([
            Rung(0, "cost", make_cost_evaluator(kernel, dims, dtype=dtype),
                 budget=int(screen), promote=promote),
            Rung(1, "hw", evaluator, budget=int(hw), executor=executor),
        ])

    def _campaign(self, key, kernel, signature, backend, space, evaluator,
                  max_evals, on_done, dtype=None) -> TuningRecord | None:
        sig_key = signature_key(signature)
        registry = get_registry()
        try:
            t0 = time.perf_counter()
            with obs_span("tuner.campaign", kernel=kernel, signature=sig_key,
                          backend=backend, max_evals=max_evals), _own_stream():
                warm_cfgs, warm_recs = self._warm_start(kernel, signature, backend)
                executor = None
                if self.harden is not None:
                    import dataclasses as _dc

                    from repro_torch.guard.harden import HardenedExecutor

                    policy = self.harden
                    if policy.baseline_sec is None and warm_recs:
                        # warm-start incumbents arm the pathological-
                        # slowdown check with a region-realistic baseline
                        policy = _dc.replace(
                            policy,
                            baseline_sec=min(o for _, o in warm_recs))
                    executor = HardenedExecutor(
                        evaluator, policy, parallel=self.parallel,
                        metrics=registry, labels={"kernel": kernel})
                ladder = self._cascade_ladder(
                    kernel, signature, backend, evaluator, executor, max_evals, dtype)
                if ladder is not None:
                    from repro_torch.fidelity import CascadeCampaign

                    cres = CascadeCampaign(
                        space, ladder, learner=self.learner, seed=self.seed,
                        n_initial=self.n_initial, parallel=self.parallel,
                        warm_start=warm_cfgs, warm_start_records=warm_recs,
                        kernel=kernel).run()
                    result = cres.rungs[-1]  # publish from the card's rung
                    timings, cascade_stats = cres.timings, cres.stats
                else:
                    result = Campaign(
                        space, evaluator, executor=executor,
                        max_evals=max_evals, learner=self.learner,
                        seed=self.seed, n_initial=self.n_initial, parallel=self.parallel,
                        warm_start=warm_cfgs, warm_start_records=warm_recs).run()
                    timings, cascade_stats = result.timings, None
            registry.add("tuner_campaigns_total", kernel=kernel)
            registry.observe("tuner_campaign_seconds",
                             time.perf_counter() - t0, kernel=kernel)
            if timings:
                with self._lock:
                    self.stats["campaigns"] += 1
                    for k in ("ask_sec", "tell_sec", "wait_sec"):
                        self.stats[k] += timings[k]
                    if cascade_stats is not None:
                        self.stats["cascade_campaigns"] += 1
                        self.stats["screened"] += cascade_stats["screened"]
                        self.stats["promoted"] += cascade_stats["promoted"]
            if result.best is None:
                return None
            rec = self._publishable(result, kernel, signature, backend)
            if rec is None:
                return None
            with obs_span("tuner.publish", kernel=kernel, signature=sig_key):
                self.store.put(rec)
            registry.add("tuner_publish_total", kernel=kernel)
            if self.on_publish is not None:
                self.on_publish(rec)
            if on_done is not None:
                on_done(kernel, signature, backend)
            return rec
        except BaseException as e:  # noqa: BLE001 — a worker must never die silently
            with self._lock:
                self.errors.append((key, e))
            return None
        finally:
            with self._lock:
                self._inflight.discard(key)

    def _publishable(self, result, kernel, signature, backend) -> TuningRecord | None:
        """Best evaluated config that the store will actually serve again:
        quarantined configs (e.g. the drift-banned incumbent a re-campaign
        just re-measured as fastest) are skipped in favor of the next-best,
        so a drift recovery publishes a *replacement* rather than silently
        re-proposing the banned config and leaving the key empty."""
        self.store.refresh()  # fold tombstones appended during the campaign
        candidates = sorted(result.db.evaluated(), key=lambda r: r.objective)
        for cand in candidates:
            rec = TuningRecord(
                kernel=kernel, signature=signature, backend=backend,
                config=dict(cand.config), objective=float(cand.objective),
                n_evals=len(result.db), source="background")
            if not self.store.is_quarantined(rec):
                return rec
        return None

    # -- lifecycle ---------------------------------------------------------------

    def drain(self, timeout: float | None = None) -> list[TuningRecord | None]:
        """Block until every submitted campaign finishes; returns their
        published records (None for no-improvement or failed campaigns —
        failures are collected in ``self.errors``, not raised). ``timeout``
        is one deadline shared across all futures — total wait is bounded by
        ``timeout`` seconds, not ``n_futures x timeout``."""
        with self._lock:
            futs = list(self._futures)
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for f in futs:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"drain deadline ({timeout}s) exceeded with "
                    f"{len(futs) - len(out)} campaign(s) unfinished")
            try:
                out.append(f.result(timeout=remaining))
            except cf.TimeoutError:  # normalize (distinct class before 3.11)
                raise TimeoutError(
                    f"drain deadline ({timeout}s) exceeded with "
                    f"{len(futs) - len(out)} campaign(s) unfinished") from None
        return out

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)


def _own_stream():
    """A CUDA stream of the campaign's own as the current stream where there
    is a card (the evaluator's events are recorded on it), else nothing."""
    if torch.cuda.is_available():
        return torch.cuda.stream(torch.cuda.Stream())
    return contextlib.nullcontext()
