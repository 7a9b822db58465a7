"""Exposition: JSONL snapshots, Prometheus text format, and an HTTP endpoint
— a copy of ``repro.obs.export``.

* :func:`write_snapshot` appends one self-describing line (host/pid/time +
  the full registry snapshot) to a JSONL file — the cross-process handoff
  format: a serving process writes, ``python -m repro_torch.launch.guard``
  reads (bucket boundaries are fixed, so merging is exact).
* :func:`prometheus_text` renders a snapshot in the Prometheus text
  exposition format (``_bucket{le=...}`` cumulative histograms, ``_sum`` /
  ``_count``), with every metric name prefixed ``repro_``.
* :class:`ObsServer` mounts ``GET /metrics`` (Prometheus text) and
  ``GET /snapshot`` (JSON) on a stdlib ``http.server``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Mapping

from repro_torch.core.jsonl import append_jsonl, repair_torn_tail
from repro_torch.obs.metrics import (
    BUCKET_BOUNDS,
    MetricsRegistry,
    get_registry,
    merge_snapshots,
)

__all__ = [
    "write_snapshot",
    "read_snapshot_file",
    "prometheus_text",
    "ObsServer",
]


def write_snapshot(path: str, registry: MetricsRegistry | None = None,
                   **meta) -> dict:
    """Append one snapshot line ``{"time", "host", "pid", **meta,
    "snapshot": {...}}`` to ``path``; returns the line written."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    repair_torn_tail(path)
    line = {
        "time": time.time(),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        **meta,
        "snapshot": (registry or get_registry()).snapshot(),
    }
    append_jsonl(path, line)
    return line


def read_snapshot_file(path: str, merge: bool = True) -> dict | list[dict]:
    """Load a snapshot JSONL file. ``merge=True`` (default) folds every line
    into one merged snapshot; ``merge=False`` returns the raw lines."""
    lines: list[dict] = []
    if os.path.exists(path):
        with open(path) as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    obj = json.loads(raw)
                except json.JSONDecodeError:
                    continue  # torn tail
                if isinstance(obj, dict) and "snapshot" in obj:
                    lines.append(obj)
    if not merge:
        return lines
    return merge_snapshots(*(line["snapshot"] for line in lines))


# -- Prometheus text exposition ---------------------------------------------------


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(labels: Mapping[str, str], extra: str | None = None) -> str:
    parts = [f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    return repr(float(v)) if v != int(v) else str(int(v))


def prometheus_text(snapshot: Mapping[str, Any] | None = None,
                    registry: MetricsRegistry | None = None,
                    prefix: str = "repro_") -> str:
    """Render a snapshot (or a live registry's snapshot) as Prometheus text
    exposition. Histograms emit cumulative ``_bucket{le=...}`` series plus
    ``_sum``/``_count``, matching the fixed log2 bucket schema."""
    if snapshot is None:
        snapshot = (registry or get_registry()).snapshot()
    out: list[str] = []
    by_name: dict[str, list[dict]] = {}
    for kind in ("counters", "gauges", "histograms"):
        for row in snapshot.get(kind, []):
            by_name.setdefault((kind, row["name"]), []).append(row)
    for (kind, name), rows in sorted(by_name.items()):
        full = prefix + name
        ptype = {"counters": "counter", "gauges": "gauge",
                 "histograms": "histogram"}[kind]
        out.append(f"# TYPE {full} {ptype}")
        for row in rows:
            labels = row["labels"]
            if kind in ("counters", "gauges"):
                out.append(f"{full}{_labels_str(labels)} {_fmt(row['value'])}")
                continue
            cum = 0
            for i, c in enumerate(row["counts"]):
                cum += int(c)
                le = _fmt(BUCKET_BOUNDS[i]) if i < len(BUCKET_BOUNDS) else "+Inf"
                le_label = 'le="' + le + '"'
                out.append(f"{full}_bucket{_labels_str(labels, le_label)} {cum}")
            out.append(f"{full}_sum{_labels_str(labels)} {repr(float(row['sum']))}")
            out.append(f"{full}_count{_labels_str(labels)} {int(row['count'])}")
    return "\n".join(out) + "\n"


# -- HTTP endpoint ----------------------------------------------------------------


class _ObsHandler(BaseHTTPRequestHandler):
    source: Callable[[], dict]  # bound by ObsServer via subclassing

    def log_message(self, *args):  # quiet: scraping must not spam stderr
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            snap = type(self).source()
            self._send(200, prometheus_text(snap).encode(),
                       "text/plain; version=0.0.4")
        elif path == "/snapshot":
            self._send(200, json.dumps(type(self).source()).encode(),
                       "application/json")
        else:
            self._send(404, b'{"error": "not found"}', "application/json")


class ObsServer:
    """Threaded ``/metrics`` + ``/snapshot`` endpoint. Serves the default
    registry unless given an explicit ``registry`` or a ``source`` callable
    (e.g. a lambda re-reading a snapshot file).
    ``port=0`` picks a free port — read it back from ``.port``."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 source: Callable[[], dict] | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        if source is None:
            source = lambda: (registry or get_registry()).snapshot()  # noqa: E731
        handler = type("BoundObsHandler", (_ObsHandler,),
                       {"source": staticmethod(source)})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ObsServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="repro-torch-obs-http",
                daemon=True)
            self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
