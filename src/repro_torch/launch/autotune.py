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

--parallel N keeps N candidate evaluations in flight (constant-liar
batching; on the card the timed runs themselves are serialised so they never
overlap). --resume requires --db and continues a killed campaign from its
JSONL checkpoint with exactly the remaining budget.
"""

from __future__ import annotations

import argparse
import json
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
from repro_torch.kernels.problems import BENCH_DIMS, LARGE_SHAPES, gpu_problem
from repro_torch.kernels.spaces import KERNEL_SPACES, kernel_space
from repro_torch.kernels.syr2k import syr2k

NOT_YET_PORTED = """\
not ported yet (the JAX package's repro.launch.autotune has them):
  --warm-start, --store   not wired to repro_torch.dispatch's tuning store yet
  --cascade               waits for repro_torch.fidelity
  --prune-infeasible      waits for repro_torch.analyze"""

# the wrapper whose launch count proves a campaign went through the kernel
KERNEL_WRAPPERS = {"syr2k": syr2k, "mm3": tiled_matmul, "lu": tiled_matmul,
                   "covariance": covariance, "heat3d": heat3d,
                   "floyd_warshall": minplus_update, "flash_attention": flash_attention,
                   "decode_attention": decode_attention, "matmul": tiled_matmul}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.autotune",
        description="Bayesian-optimization autotuning of the CUDA kernels.",
        epilog=NOT_YET_PORTED, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", required=True, choices=sorted(KERNEL_SPACES))
    ap.add_argument("--max-evals", type=int, default=100,
                    help="evaluation budget (paper default: 100; paper runs: 200)")
    ap.add_argument("--learner", default="RF", choices=["RF", "ET", "GBRT", "GP"])
    ap.add_argument("--backend", default="gpu", choices=["gpu", "cpu"],
                    help="gpu: CUDA kernels at LARGE sizes (default); "
                         "cpu: plain versions at bench sizes")
    ap.add_argument("--db", default=None, help="performance database directory")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--parallel", type=int, default=1, metavar="N",
                    help="candidate evaluations in flight (1 = serial paper loop)")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed campaign from --db's JSONL checkpoint")
    args = ap.parse_args(argv)

    if args.resume and not args.db:
        ap.error("--resume requires --db (the checkpoint to resume from)")

    if args.backend == "gpu":
        factory = gpu_problem(args.kernel, LARGE_SHAPES[args.kernel], device="cuda")
        space = kernel_space(args.kernel, target="gpu", seed=args.seed)
        device = torch.cuda.get_device_name(torch.cuda.current_device())
    else:
        factory = gpu_problem(args.kernel, BENCH_DIMS[args.kernel], device="cpu")
        space = kernel_space(args.kernel, target="host", seed=args.seed)
        device = "cpu"
    evaluator = TimingEvaluator(factory, repeats=3, warmup=1)

    if args.resume:
        k = len(PerformanceDatabase(args.db).records)
        print(f"resume: {k} record(s) checkpointed, "
              f"{max(0, args.max_evals - k)} evaluation(s) remaining")

    wrapper = KERNEL_WRAPPERS[args.kernel]
    launches0 = wrapper.launches
    t0 = time.perf_counter()
    res = autotune(space, evaluator, max_evals=args.max_evals,
                   learner=args.learner, seed=args.seed, db_path=args.db,
                   parallel=args.parallel)
    wall = time.perf_counter() - t0

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
    print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
