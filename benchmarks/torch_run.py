"""Benchmark entry point of the port, one function per paper table: the
counterpart of ``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV (``rejected`` in place of a time
for a config the kernel's wrapper refuses) and writes every row to a JSON
stamped by ``benchmarks.torch_common.bench_meta`` (``--out``). Runs on the
card unless ``--device cpu`` is given (the plain versions at BENCH_DIMS).

Knobs (environment, as the JAX package's):
  REPRO_BENCH_EVALS    autotuning campaign length (default 30; paper: 200)
  REPRO_BENCH_LEARNER  surrogate of the per-table campaigns (default RF)
  REPRO_BENCH_ONLY     comma-separated filter of table names (substrings;
                       also "kernel_tuning" and "learners")

A table that raises prints an ERROR row and the run goes on with the
others, then exits non-zero. The JAX package's roofline rows
(``benchmarks/roofline_table.py``) wait for the port's ``perf/`` (ROADMAP
Queue 1, item 7); this entry point does not print them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

from benchmarks.torch_common import DEFAULT_EVALS, Row, emit, write_bench_json


def main(argv=None) -> int:
    from benchmarks import torch_tables
    from benchmarks.torch_kernel_tuning import tune_all
    from benchmarks.torch_learners import learner_comparison

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], epilog=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the rows run (default: the card)")
    ap.add_argument("--out", default="BENCH_torch_tables.json",
                    help="the stamped JSON of every row")
    args = ap.parse_args(argv)
    evals = int(os.environ.get("REPRO_BENCH_EVALS", str(DEFAULT_EVALS)))
    learner = os.environ.get("REPRO_BENCH_LEARNER", "RF")
    only = [s for s in os.environ.get("REPRO_BENCH_ONLY", "").split(",") if s]

    def wanted(name: str) -> bool:
        return not only or any(o in name for o in only)

    parts = [(fn.__name__, lambda fn=fn: fn(args.device, evals, learner))
             for fn in torch_tables.ALL_TABLES]
    parts += [("kernel_tuning", lambda: tune_all(max(evals, 40), device=args.device)),
              ("learners", lambda: learner_comparison(evals, args.device))]
    t_start = time.time()
    results, failed = {}, []
    for name, run in parts:
        if not wanted(name):
            continue
        t0 = time.time()
        try:
            rows = run()
        except Exception:  # noqa: BLE001 — one broken table must not stop the others
            failed.append(name)
            rows = [Row(f"{name}/ERROR", None, repr(traceback.format_exc(limit=4)))]
        emit(rows)
        results[name] = {"rows": [r.to_dict() for r in rows], "sec": time.time() - t0}
        print(f"# {name} took {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    write_bench_json(args.out, {"evals": evals, "learner": learner, "failed": failed,
                                "tables": results}, device=args.device)
    print(f"# total {time.time() - t_start:.1f}s; wrote {args.out}", file=sys.stderr)
    if failed:
        print(f"FAIL: {', '.join(failed)} raised", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
