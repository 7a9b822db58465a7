"""Performance database: the autotuner's memory and its fault-tolerance log.

Mirrors ytopt's two output files (Sec. 2.3 step 6): ``results.csv`` (one row
per evaluation: parameter values, objective, elapsed wall-clock) and
``results.jsonl`` (full records, one JSON object per line, appended per
evaluation so a campaign's persistence cost stays O(n) instead of the old
rewrite-the-whole-JSON-array O(n²); legacy ``results.json`` directories are
still loadable and are migrated on first open). The DB also provides the duplicate check the
paper describes ("At the evaluation stage, check the performance database to
make sure that this chosen configuration is new") and is the resume log: a
search restarted on the same DB path continues where it stopped, which is the
checkpoint/restart story for long autotuning campaigns.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
from typing import Any, Iterable, Mapping

from repro_torch.core.jsonl import append_jsonl, repair_torn_tail
from repro_torch.core.space import config_key

__all__ = ["Record", "PerformanceDatabase"]

OK = "ok"
FAILED = "failed"
SKIPPED_DUPLICATE = "skipped-duplicate"


@dataclasses.dataclass
class Record:
    index: int
    config: dict
    objective: float
    elapsed_sec: float
    status: str = OK
    info: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "config": self.config,
            "objective": self.objective,
            "elapsed_sec": self.elapsed_sec,
            "status": self.status,
            "info": self.info,
        }

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "Record":
        return cls(
            index=int(d["index"]),
            config=dict(d["config"]),
            objective=float(d["objective"]),
            elapsed_sec=float(d["elapsed_sec"]),
            status=str(d.get("status", OK)),
            info=dict(d.get("info", {})),
        )


class PerformanceDatabase:
    """In-memory DB with optional persistent ``results.csv``/``results.json``."""

    def __init__(self, path: str | None = None, param_names: Iterable[str] | None = None):
        self.path = path
        self.param_names = list(param_names) if param_names else []
        self.records: list[Record] = []
        self._seen: dict[tuple, int] = {}
        self._t0 = time.perf_counter()
        if path:
            os.makedirs(path, exist_ok=True)
            self._maybe_load()

    # -- core API ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.records)

    def contains(self, config: Mapping[str, Any]) -> bool:
        return config_key(config) in self._seen

    def lookup(self, config: Mapping[str, Any]) -> Record | None:
        idx = self._seen.get(config_key(config))
        return self.records[idx] if idx is not None else None

    def add(
        self,
        config: Mapping[str, Any],
        objective: float,
        elapsed_sec: float | None = None,
        status: str = OK,
        info: Mapping[str, Any] | None = None,
    ) -> Record:
        rec = Record(
            index=len(self.records),
            config=dict(config),
            objective=float(objective),
            elapsed_sec=float(
                elapsed_sec if elapsed_sec is not None else time.perf_counter() - self._t0
            ),
            status=status,
            info=dict(info or {}),
        )
        self.records.append(rec)
        key = config_key(config)
        if key not in self._seen:  # first occurrence wins lookup
            self._seen[key] = rec.index
        if self.path:
            # deferred import: obs sits above core in the layering, and the
            # span is only worth paying for on the persistent path
            from repro_torch.obs.trace import span as obs_span

            with obs_span("db.checkpoint", index=rec.index):
                self._append_csv(rec)
                self._append_jsonl(rec)
        return rec

    # -- analysis (findMin.py role lives in findmin.py, built on these) ----------

    def evaluated(self) -> list[Record]:
        return [r for r in self.records if r.status == OK]

    def best(self) -> Record | None:
        ok = self.evaluated()
        return min(ok, key=lambda r: r.objective) if ok else None

    def best_trajectory(self) -> list[float]:
        """Running best objective per evaluation (the red line in Figs 3-11)."""
        out, cur = [], float("inf")
        for r in self.records:
            if r.status == OK:
                cur = min(cur, r.objective)
            out.append(cur)
        return out

    # -- persistence --------------------------------------------------------------

    def _csv_path(self) -> str:
        return os.path.join(self.path, "results.csv")

    def _json_path(self) -> str:
        return os.path.join(self.path, "results.json")

    def _jsonl_path(self) -> str:
        return os.path.join(self.path, "results.jsonl")

    def _ensure_param_names(self, config: Mapping[str, Any]) -> None:
        for k in config:
            if k not in self.param_names:
                self.param_names.append(k)

    def _append_csv(self, rec: Record) -> None:
        self._ensure_param_names(rec.config)
        path = self._csv_path()
        new = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(self.param_names + ["objective", "elapsed_sec", "status"])
            w.writerow(
                [json.dumps(rec.config.get(k)) for k in self.param_names]
                + [rec.objective, rec.elapsed_sec, rec.status]
            )

    def _append_jsonl(self, rec: Record) -> None:
        # each record is a crash-safe resume point
        append_jsonl(self._jsonl_path(), rec.to_json())

    def _load_records(self, data: Iterable[Mapping[str, Any]]) -> None:
        for d in data:
            rec = Record.from_json(d)
            rec.index = len(self.records)
            self.records.append(rec)
            key = config_key(rec.config)
            self._seen.setdefault(key, rec.index)

    def _maybe_load(self) -> None:
        jsonl = self._jsonl_path()
        if os.path.exists(jsonl):
            # terminate any torn tail first so later appends stay
            # line-delimited instead of merging into the fragment
            repair_torn_tail(jsonl)
            with open(jsonl) as f:
                rows = []
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rows.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue  # isolated torn fragment from a crash
            self._load_records(rows)
            return
        legacy = self._json_path()
        if not os.path.exists(legacy):
            return
        with open(legacy) as f:
            self._load_records(json.load(f))
        # migrate once so future appends extend the full history
        tmp = jsonl + ".tmp"
        with open(tmp, "w") as f:
            for r in self.records:
                f.write(json.dumps(r.to_json()) + "\n")
        os.replace(tmp, jsonl)
