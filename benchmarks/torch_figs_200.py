"""The paper's Figs 3-6 at full budget on the port, the counterpart of
``benchmarks/figs_200.py``: 200-evaluation syr2k campaigns under each of the
four learners, with best-so-far trajectories (the red line in the paper's
figures) in ``<outdir>/fig_syr2k_<learner>.csv`` and a summary stamped by
``benchmarks.torch_common.bench_meta``.

This is where GP's duplicate skipping shows at the paper's own scale: GP
spends budget on repeated proposals and completes fewer real evaluations
than RF/ET/GBRT (the paper saw 66 of 200).

    PYTHONPATH=src:. python -m benchmarks.torch_figs_200 [--evals 200] [--device cpu]

On the card the campaigns time the CUDA kernel at LARGE over the ``gpu``
space; with ``--device cpu`` the plain version at ``BENCH_DIMS``.
"""

from __future__ import annotations

import argparse
import csv
import os

from benchmarks.torch_common import write_bench_json
from benchmarks.torch_learners import learner_campaigns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--evals", type=int, default=200)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the campaigns run (default: the card)")
    ap.add_argument("--outdir", default="results", help="where the trajectory CSVs go")
    ap.add_argument("--out", default="BENCH_torch_learners.json",
                    help="the stamped summary")
    args = ap.parse_args(argv)

    results = learner_campaigns(args.evals, args.device)
    os.makedirs(args.outdir, exist_ok=True)
    summary = {}
    for learner, res in results.items():
        traj = res.db.best_trajectory()
        path = os.path.join(args.outdir, f"fig_syr2k_{learner}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["evaluation", "objective_sec", "best_so_far_sec", "status"])
            for rec, best in zip(res.db.records, traj):
                w.writerow([rec.index, rec.objective, best, rec.status])
        b = res.best
        summary[learner] = {
            "best_sec": b.objective, "found_at_eval": b.index,
            "real_evaluations": res.n_evaluated, "skipped_duplicates": res.n_skipped,
            "budget": args.evals, "config": b.config,
            "ask_sec": res.timings["ask_sec"], "wait_sec": res.timings["wait_sec"],
        }
        print(f"[{learner:4s}] best={b.objective * 1e6:9.1f}us @eval {b.index:3d}  "
              f"real_evals={res.n_evaluated:3d}/{args.evals}  skipped_dups={res.n_skipped}",
              flush=True)
    write_bench_json(args.out, {"kernel": "syr2k", "evals": args.evals, "seed": 1234,
                                "learners": summary}, device=args.device)
    print(f"wrote {args.out} and {args.outdir}/fig_syr2k_*.csv")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
