"""Optimizer-overhead benchmark of the port: how much wall-clock the BO loop
itself costs. A copy of ``benchmarks/tuner_overhead.py`` on
``repro_torch.core`` and ``repro_torch.obs``, run on the host of the card's
machine.

CATBench (Tørring et al. 2024) makes optimizer overhead a first-class metric
for compiler-autotuning loops: at the paper's scale (200 evaluations over
spaces of up to 170k configurations) the surrogate fit + acquisition scan can
dominate the tuning loop once the evaluations themselves are cheap (the cost
backend, or a kernel of a few hundred microseconds on the card). This
benchmark times the ``ask`` / ``tell`` hot path of
:class:`repro_torch.core.search.BayesianSearch` at n ∈ {50, 100, 200}
observations for all four learners and writes
``BENCH_torch_tuner_overhead.json`` (stamped by
``benchmarks.torch_common.bench_meta``) plus an obs snapshot beside it with
``bench_{ask,tell,ask_batch}_seconds`` histograms labeled per learner. A tiny
synthetic cascade rides along so the snapshot also carries the
repro_torch.fidelity screen/promote counters and the feasibility-pruning
count (``n_pruned``). Nothing here touches the card: the objective is
synthetic, the same as the JAX package's, so the two packages' fixed-seed
proposals can be held against each other.

Usage::

    PYTHONPATH=src:. python -m benchmarks.torch_tuner_overhead            # full matrix
    PYTHONPATH=src:. python -m benchmarks.torch_tuner_overhead --quick    # smoke run

It times and gates nothing: a wall-clock budget on a shared host is a
flaky gate (the JAX package keeps its ask-budget tripwire for its own CI).
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np

from benchmarks.torch_common import write_bench_json
from repro_torch.core.plopper import EvalResult
from repro_torch.core.search import BayesianSearch
from repro_torch.core.space import Categorical, ConfigurationSpace, Ordinal
from repro_torch.obs.export import write_snapshot
from repro_torch.obs.metrics import MetricsRegistry, summarize_histograms

TILES = (4, 8, 16, 20, 32, 64, 96, 100, 128, 256, 2048)  # the paper's 11-entry list


def make_space(seed: int = 1234) -> ConfigurationSpace:
    """A syr2k-shaped space scaled toward the paper's largest (170,368-config
    mvt space): pragma on/off categoricals plus 11-entry tile-size ordinals."""
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        Categorical("p_interchange", (True, False), default=False),
        Categorical("p_pack_a", (True, False), default=False),
        Categorical("p_pack_b", (True, False), default=False),
        Categorical("p_vectorize", (True, False), default=False),
        Ordinal("t_l1", TILES, default=96),
        Ordinal("t_l2", TILES, default=96),
        Ordinal("t_l3", TILES, default=96),
        Ordinal("u_factor", TILES, default=4),
    ])
    return cs


def objective(cfg) -> float:
    t = 1.0
    t -= 0.25 * bool(cfg["p_pack_a"]) + 0.15 * bool(cfg["p_pack_b"])
    t -= 0.1 * bool(cfg["p_interchange"]) + 0.05 * bool(cfg["p_vectorize"])
    for k, opt in (("t_l1", 64), ("t_l2", 32), ("t_l3", 96), ("u_factor", 8)):
        t += 2e-4 * abs(int(cfg[k]) - opt)
    return t


def seeded_search(learner: str, n_obs: int, seed: int = 1234) -> BayesianSearch:
    """A search whose DB already holds ``n_obs`` told observations — the
    steady state whose per-iteration ask/tell cost we measure."""
    search = BayesianSearch(make_space(seed), learner=learner, seed=seed,
                            n_initial=min(10, n_obs))
    rng = np.random.default_rng(seed + 1)
    for cfg in search.space.sample_configurations(n_obs, rng):
        search.tell(cfg, EvalResult(objective(cfg), True, {}))
    return search


def time_learner(learner: str, n_obs: int, repeats: int, batch: int,
                 seed: int = 1234, registry: MetricsRegistry | None = None) -> dict:
    search = seeded_search(learner, n_obs, seed)
    registry = registry if registry is not None else MetricsRegistry()
    labels = {"learner": learner, "n_obs": n_obs}

    # the real loop shape: every ask is followed by a tell, so each fit sees
    # freshly-grown training data (no artificial repeat-ask memoization)
    ask_times, tell_times = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        cfg = search.ask()
        ask_times.append(time.perf_counter() - t0)
        registry.observe("bench_ask_seconds", ask_times[-1], **labels)
        t0 = time.perf_counter()
        search.tell(cfg, EvalResult(objective(cfg), True, {}))
        tell_times.append(time.perf_counter() - t0)
        registry.observe("bench_tell_seconds", tell_times[-1], **labels)

    # batched ask: n proposals through one pooled candidate set + liar refits
    batch_times = []
    for _ in range(max(1, repeats // 2)):
        t0 = time.perf_counter()
        cfgs = search.ask(batch)
        batch_times.append(time.perf_counter() - t0)
        registry.observe("bench_ask_batch_seconds", batch_times[-1],
                         batch=batch, **labels)
        for cfg in cfgs:
            search.tell(cfg, EvalResult(objective(cfg), True, {}))

    return {
        "ask_sec": statistics.median(ask_times),
        "ask_mean_sec": statistics.fmean(ask_times),
        f"ask_batch{batch}_sec": statistics.median(batch_times),
        "tell_sec": statistics.median(tell_times),
        "repeats": repeats,
    }


def time_cascade(registry: MetricsRegistry, seed: int = 1234) -> dict:
    """One tiny synthetic cascade so the overhead snapshot also carries the
    repro_torch.fidelity counters (``fidelity_screened_total`` /
    ``fidelity_promoted_total``), the per-rung campaign latency histograms,
    and a non-zero feasibility-pruning count (``n_pruned``) — the tuner's
    full telemetry surface in one artifact."""
    from repro_torch.fidelity import CascadeCampaign, FidelityLadder, Rung
    from repro_torch.obs.metrics import get_registry, set_registry

    space = make_space(seed)
    ladder = FidelityLadder([
        Rung(0, "cost", lambda c: EvalResult(1e-3 * objective(c), True, {}),
             budget=24, promote=4),
        Rung(1, "hw", lambda c: EvalResult(objective(c), True, {}), budget=8),
    ])
    prev = get_registry()
    set_registry(registry)  # campaigns bind the process registry at build
    try:
        res = CascadeCampaign(
            space, ladder, seed=seed, n_initial=6, kernel="synthetic",
            feasibility=lambda c: int(c["t_l1"]) <= 1024).run()
    finally:
        set_registry(prev)
    return {
        "screened": res.stats["screened"],
        "promoted": res.stats["promoted"],
        "hw_evals": res.hw_evals,
        "n_pruned": sum(r.timings.get("n_pruned", 0) for r in res.rungs),
        "ask_sec": res.timings["ask_sec"],
        "tell_sec": res.timings["tell_sec"],
    }


def run(learners, sizes, repeats, batch, out, seed=1234):
    # every ask/tell lands in one registry as bench_{ask,tell,ask_batch}_seconds
    # histograms labeled (learner, n_obs) — the same snapshot format the rest
    # of the obs stack speaks, so a dashboard ingesting dispatch snapshots
    # can ingest benchmark runs unchanged
    registry = MetricsRegistry()
    results: dict = {
        "space_cardinality": make_space().cardinality(),
        "sizes": list(sizes),
        "learners": {},
    }
    for learner in learners:
        per_n = {}
        for n_obs in sizes:
            per_n[str(n_obs)] = time_learner(learner, n_obs, repeats, batch,
                                             seed, registry=registry)
            print(f"[{learner}] n={n_obs}: ask={per_n[str(n_obs)]['ask_sec'] * 1e3:.2f}ms "
                  f"ask(batch{batch})={per_n[str(n_obs)][f'ask_batch{batch}_sec'] * 1e3:.2f}ms "
                  f"tell={per_n[str(n_obs)]['tell_sec'] * 1e6:.1f}us", flush=True)
        results["learners"][learner] = per_n
    results["cascade"] = time_cascade(registry, seed)
    print(f"[cascade] screened={results['cascade']['screened']} "
          f"promoted={results['cascade']['promoted']} "
          f"hw_evals={results['cascade']['hw_evals']} "
          f"n_pruned={results['cascade']['n_pruned']}", flush=True)
    snapshot = registry.snapshot()
    results["obs"] = summarize_histograms(snapshot)
    write_bench_json(out, results, device="cpu")
    obs_out = os.path.splitext(out)[0] + ".obs.jsonl"
    write_snapshot(obs_out, registry=registry, bench="tuner_overhead")
    print(f"wrote {out} and {obs_out}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--learners", nargs="*", default=["RF", "ET", "GBRT", "GP"])
    ap.add_argument("--sizes", nargs="*", type=int, default=[50, 100, 200])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--quick", action="store_true",
                    help="smoke run: RF+GP only, n in {50, 200}, 3 repeats")
    ap.add_argument("--out", default="BENCH_torch_tuner_overhead.json")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)
    if args.quick:
        args.learners = ["RF", "GP"]
        args.sizes = [50, 200]
        args.repeats = 3
    run(args.learners, args.sizes, args.repeats, args.batch, args.out, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
