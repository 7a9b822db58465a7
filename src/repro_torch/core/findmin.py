"""findMin.py (Sec. 2.3 step 8): mine the performance database for the best
configuration and report it."""

from __future__ import annotations

import json
import os
import sys

from repro_torch.core.database import PerformanceDatabase, Record

__all__ = ["find_min", "load_database", "main"]


def load_database(db_path: str) -> PerformanceDatabase:
    return PerformanceDatabase(db_path)


def find_min(db: PerformanceDatabase) -> Record | None:
    return db.best()


def importance_report(db: PerformanceDatabase, top: int = 5) -> list[tuple[str, float]]:
    """Step 9's 'identify the most important features': rank parameters by the
    spread of mean objective across their observed values (one-way effect)."""
    recs = db.evaluated()
    if not recs:
        return []
    names = sorted({k for r in recs for k in r.config})
    scores = []
    for name in names:
        by_value: dict = {}
        for r in recs:
            by_value.setdefault(repr(r.config.get(name)), []).append(r.objective)
        means = [sum(v) / len(v) for v in by_value.values() if v]
        if len(means) > 1:
            scores.append((name, max(means) - min(means)))
    scores.sort(key=lambda kv: -kv[1])
    return scores[:top]


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m repro_torch.core.findmin <db_dir>", file=sys.stderr)
        return 2
    db_path = argv[0]
    if not os.path.isdir(db_path):
        print(f"no such database directory: {db_path}", file=sys.stderr)
        return 2
    db = load_database(db_path)
    best = find_min(db)
    if best is None:
        print("database holds no successful evaluations")
        return 1
    print(json.dumps({
        "best_objective": best.objective,
        "at_evaluation": best.index,
        "config": best.config,
        "n_records": len(db),
        "importance": importance_report(db),
    }, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
