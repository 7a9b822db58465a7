"""Autotuning CLI — the paper's ytopt interface (--max-evals / --learner) over
:class:`repro_torch.engine.Campaign`, with the CUDA kernels as the tuned
programs.

    PYTHONPATH=src python -m repro_torch.launch.autotune --kernel syr2k \\
        --max-evals 200 --learner RF --db results/syr2k_rf_gpu

--kernel takes the paper's six benchmarks: syr2k, mm3, lu, covariance,
heat3d and floyd_warshall; and the serving path's kernels, flash_attention,
decode_attention and matmul (at a 16-head 4k-context shape and a
2000x2300x2600 product on the card). --backend gpu (the default) times the
hand-written CUDA kernels of the benchmark's path at the paper's LARGE
sizes with CUDA events, over the ``gpu`` space; every evaluation launches
them. --backend cpu times the plain PyTorch versions at small bench sizes
over the paper's ``host`` space (for tests and machines without a card).
--backend cost scores the ``gpu`` space at LARGE with the Hopper cost model
of the CUDA kernels (``repro_torch.kernels.cost``), launching nothing.

--parallel N keeps N candidate evaluations in flight (constant-liar
batching; on the card the timed runs themselves are serialised so they never
overlap). --resume requires --db and continues a killed campaign from its
JSONL checkpoint with exactly the remaining budget.

--warm-start STORE_DIR seeds the campaign from a repro_torch.dispatch
TuningStore: the store's nearest tuned config (by log-scale shape distance)
is evaluated first and its neighbors seed the surrogate. --store STORE_DIR
publishes this campaign's winner back (both flags may name the same dir).
The record is keyed by the kernel, the canonical problem's signature
(``kernels.problems.problem_signature_for``: LARGE on gpu, the bench size on
cpu) and a ``backend`` that is the CLI's own, ``gpu`` or ``cpu``: a
``DispatchService(store, backend=...)`` of the same name resolves it as an
exact hit for a call at that shape (the service's default, ``gpu``, on the
card; ``backend="cpu", target="host"`` for the plain versions).
--prune-infeasible drops statically infeasible candidates from the
acquisition pool (repro_torch.analyze's feasibility rules, at the campaign's
dims; on gpu also the kernels' shared memory against the card's) and
prints how many.

--cascade runs a repro_torch.fidelity multi-fidelity cascade instead of a
flat campaign: a wide pool is screened on the Hopper cost model, the top-k
re-timed at reduced proxy dims (``kernels.problems.PROXY_DIMS``), and only
the survivors timed at full size (LARGE on the card, the bench size with
--backend cpu); --rung-budgets / --promote shape the ladder. With --db,
each rung checkpoints under <db>/rung<level>/ and --resume continues with
exactly the remaining per-rung budgets. The printed JSON gains a
``cascade`` block: the cascade's per-rung stats and calibration, each
rung's evaluation seconds and the wall time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.core import TimingEvaluator, autotune
from repro_torch.core.database import PerformanceDatabase
from repro_torch.core.findmin import importance_report
from repro_torch.kernels.covariance import covariance
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.floyd_warshall import minplus_update
from repro_torch.kernels.heat3d import heat3d
from repro_torch.kernels.matmul import tiled_matmul
from repro_torch.kernels.problems import (
    BENCH_DIMS,
    LARGE_SHAPES,
    gpu_problem,
    make_cost_evaluator,
    problem_signature_for,
)
from repro_torch.kernels.spaces import KERNEL_SPACES, kernel_space
from repro_torch.kernels.syr2k import syr2k
from repro_torch.kernels.util import resolve_device

# the wrapper whose launch count proves a campaign went through the kernel
KERNEL_WRAPPERS = {"syr2k": syr2k, "mm3": tiled_matmul, "lu": tiled_matmul,
                   "covariance": covariance, "heat3d": heat3d,
                   "floyd_warshall": minplus_update, "flash_attention": flash_attention,
                   "decode_attention": decode_attention, "matmul": tiled_matmul}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.autotune",
        description="Bayesian-optimization autotuning of the CUDA kernels.")
    ap.add_argument("--kernel", required=True, choices=sorted(KERNEL_SPACES))
    ap.add_argument("--max-evals", type=int, default=100,
                    help="evaluation budget (paper default: 100; paper runs: 200)")
    ap.add_argument("--learner", default="RF", choices=["RF", "ET", "GBRT", "GP"])
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu", "cost"],
                    help="gpu: CUDA kernels at LARGE sizes (default); "
                         "cpu: plain versions at bench sizes; "
                         "cost: the Hopper cost model at LARGE sizes")
    ap.add_argument("--db", default=None, help="performance database directory")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--parallel", type=int, default=1, metavar="N",
                    help="candidate evaluations in flight (1 = serial paper loop)")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed campaign from --db's JSONL checkpoint")
    ap.add_argument("--warm-start", default=None, metavar="STORE_DIR",
                    help="TuningStore to warm-start from (nearest-neighbor seed)")
    ap.add_argument("--store", default=None, metavar="STORE_DIR",
                    help="TuningStore to publish this campaign's best into")
    ap.add_argument("--prune-infeasible", action="store_true",
                    help="statically prune infeasible candidates from the "
                         "acquisition pool (repro_torch.analyze feasibility "
                         "rules; off by default — pruning changes fixed-seed "
                         "trajectories)")
    ap.add_argument("--cascade", action="store_true",
                    help="multi-fidelity cascade (repro_torch.fidelity): screen "
                         "on the Hopper cost model, re-time a reduced proxy "
                         "shape, and spend full timings only on promoted "
                         "top-k configs")
    ap.add_argument("--rung-budgets", default=None, metavar="B0,B1[,B2]",
                    help="per-rung evaluation budgets, bottom-up (2 entries "
                         "= cost->hw, 3 = cost->proxy->hw; default 64,16,8)")
    ap.add_argument("--promote", default=None, metavar="K1[,K2]",
                    help="top-k promoted from each non-top rung "
                         "(default: half the next rung's budget)")
    args = ap.parse_args(argv)

    if args.resume and not args.db:
        ap.error("--resume requires --db (the checkpoint to resume from)")
    if args.cascade and args.backend == "cost":
        ap.error("--cascade needs a timed backend above the analytic model; "
                 "--backend cost IS the cascade's rung 0")
    if (args.rung_budgets or args.promote) and not args.cascade:
        ap.error("--rung-budgets/--promote only apply with --cascade")

    dims = (BENCH_DIMS if args.backend == "cpu" else LARGE_SHAPES)[args.kernel]
    space = kernel_space(args.kernel, target="host" if args.backend == "cpu" else "gpu",
                         seed=args.seed)
    if args.backend == "gpu":
        resolve_device("cuda")  # raises without a card
        device = torch.cuda.get_device_name(torch.cuda.current_device())
    else:
        device = "cpu" if args.backend == "cpu" else "cost model"
    evaluator = None  # the cascade builds its rungs' own
    if args.backend == "cost" and not args.cascade:
        evaluator = make_cost_evaluator(args.kernel)
    elif not args.cascade:
        evaluator = TimingEvaluator(gpu_problem(args.kernel, dims, device="cpu" if
                                                args.backend == "cpu" else "cuda"),
                                    repeats=3, warmup=1)

    sig = problem_signature_for(args.kernel, args.backend)
    warm_cfgs, warm_recs = None, None
    if args.warm_start:
        from repro_torch.dispatch import TuningStore
        from repro_torch.dispatch.lookup import warm_start_material
        warm_cfgs, warm_recs = warm_start_material(
            TuningStore(args.warm_start), args.kernel, sig, args.backend)
        if warm_cfgs is not None:
            print(f"warm-start: nearest store config re-evaluated first, "
                  f"{len(warm_recs or [])} neighbor(s) seed the surrogate")
        else:
            print("warm-start: store has no compatible record; cold start")

    feasibility = None
    if args.prune_infeasible:
        from repro_torch.analyze.feasibility import feasibility_filter
        feasibility = feasibility_filter(
            args.kernel, dims=dims, target="host" if args.backend == "cpu" else "gpu")

    if args.resume and not args.cascade:
        k = len(PerformanceDatabase(args.db).records)
        print(f"resume: {k} record(s) checkpointed, "
              f"{max(0, args.max_evals - k)} evaluation(s) remaining")

    wrapper = KERNEL_WRAPPERS[args.kernel]
    launches0 = wrapper.launches
    t0 = time.perf_counter()
    cascade_stats = None
    if args.cascade:
        res, cascade_stats = _cascade(args, space, warm_cfgs, warm_recs, feasibility)
    else:
        res = autotune(space, evaluator, max_evals=args.max_evals,
                       learner=args.learner, seed=args.seed, db_path=args.db,
                       parallel=args.parallel, warm_start=warm_cfgs,
                       warm_start_records=warm_recs, feasibility=feasibility)
    wall = time.perf_counter() - t0
    if feasibility is not None and res.timings:
        print(f"feasibility: pruned {res.timings.get('n_pruned', 0)} "
              f"statically-infeasible candidate(s) from the acquisition pool")

    if args.store and res.best is not None:
        from repro_torch.dispatch import TuningRecord, TuningStore
        TuningStore(args.store).put(TuningRecord(
            kernel=args.kernel, signature=sig, backend=args.backend,
            config=dict(res.best.config), objective=float(res.best.objective),
            n_evals=len(res.db), source=f"cli:{args.db or 'ephemeral'}"))

    print(res.summary())
    best = res.best  # None when every evaluation was rejected
    out = {
        "best_config": best.config if best else None,
        "best_objective_sec": best.objective if best else None,
        "found_at_eval": best.index if best else None,
        "importance": importance_report(res.db),
        "device": device,
        "launches": {wrapper.__name__: wrapper.launches - launches0},
        "n_evaluated": res.n_evaluated,
        "n_failed": res.n_failed,
        "wall_sec": wall,
        "timings": res.timings,
    }
    if cascade_stats is not None:
        out["cascade"] = cascade_stats
    print(json.dumps(out, indent=2, default=str))
    return 0


def _cascade(args, space, warm_cfgs, warm_recs, feasibility):
    """Run the CLI's cascade; returns the top rung's result (the answer and
    what ``--store`` publishes) and the cascade's stats, with each rung's
    seconds in its evaluator."""
    from repro_torch.fidelity import CascadeCampaign, FidelityLadder, default_ladder

    budgets = tuple(int(x) for x in (args.rung_budgets or "64,16,8").split(","))
    promote = tuple(int(x) for x in args.promote.split(",")) if args.promote else None
    ladder = default_ladder(args.kernel, budgets=budgets, promote=promote, repeats=3,
                            device="cpu" if args.backend == "cpu" else "cuda")
    eval_sec = [0.0] * len(ladder)

    def timed(i, evaluate):
        def run(cfg):
            t0 = time.perf_counter()
            try:
                return evaluate(cfg)
            finally:
                eval_sec[i] += time.perf_counter() - t0
        return run

    ladder = FidelityLadder([dataclasses.replace(r, evaluator=timed(i, r.evaluator))
                             for i, r in enumerate(ladder)])
    if args.resume:
        for rung in ladder:
            k = len(PerformanceDatabase(os.path.join(args.db, f"rung{rung.level}")).records)
            print(f"resume: rung {rung.level} ({rung.name}) has {k} "
                  f"record(s), {max(0, rung.budget - k)} remaining")
    cres = CascadeCampaign(
        space, ladder, db_root=args.db, learner=args.learner, seed=args.seed,
        parallel=args.parallel, warm_start=warm_cfgs, warm_start_records=warm_recs,
        feasibility=feasibility, kernel=args.kernel).run()
    print(cres.summary())
    stats = dict(cres.stats, hw_evals=cres.hw_evals, ladder=ladder.describe(),
                 eval_sec=eval_sec)
    return cres.rungs[-1], stats


if __name__ == "__main__":
    raise SystemExit(main())
