"""Localhost HTTP push/pull transport, built on stdlib ``http.server`` so
tests and single-machine fleets need no extra dependencies.

One side runs a :class:`FleetServer` wrapping its :class:`Replica`; peers
point an :class:`HttpTransport` at it:

* ``GET /vv``            → the server's version vector (JSON);
* ``GET /ops?vv=<json>`` → JSONL of every op the server knows that the
  vector does not cover (own *and* replicated, so ops propagate
  transitively through any reachable peer);
* ``POST /ops``          → JSONL body of ops the client pushes; the server
  ingests them through its replica (merge + store fold + service
  invalidation) and answers ``{"applied": n}``;
* ``GET /status``        → the replica's status dict;
* ``GET /metrics``       → this process's obs registry in Prometheus text
  form (sync-duration/replication-lag histograms and any other metrics the
  serving process records).

``push`` asks the peer for its vector first and ships only the delta, so
re-pushing after a restart is a no-op — the same idempotence contract as
the file transport, with the high-water mark held by the peer.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.fleet.oplog import Op, OpLog
from repro_torch.fleet.sync import Replica
from repro_torch.fleet.transport import Transport

__all__ = ["FleetServer", "HttpTransport"]


def _ops_to_jsonl(ops) -> bytes:
    return "".join(json.dumps(op.to_json()) + "\n" for op in ops).encode()


def _ops_from_jsonl(data: bytes) -> list[Op]:
    # per-line tolerance, like the file transport: one foreign op (say, a
    # kind from a newer release) must not wedge every valid op in the batch
    out = []
    for line in data.decode(errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(Op.from_json(json.loads(line)))
        except (json.JSONDecodeError, KeyError, ValueError):
            continue
    return out


class _Handler(BaseHTTPRequestHandler):
    replica: Replica  # bound by FleetServer via subclassing

    def log_message(self, *args):  # quiet: serving paths must not spam stderr
        pass

    def _send(self, code: int, body: bytes, ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        url = urllib.parse.urlparse(self.path)
        oplog = self.replica.oplog
        if url.path == "/vv":
            oplog.refresh()
            self._send(200, json.dumps(oplog.version_vector()).encode())
        elif url.path == "/ops":
            q = urllib.parse.parse_qs(url.query)
            try:
                vv = json.loads(q.get("vv", ["{}"])[0])
            except json.JSONDecodeError:
                self._send(400, b'{"error": "bad vv"}')
                return
            oplog.refresh()
            self._send(200, _ops_to_jsonl(oplog.ops_after(vv)),
                       ctype="application/jsonl")
        elif url.path == "/status":
            self._send(200, json.dumps(self.replica.status()).encode())
        elif url.path == "/metrics":
            from repro_torch.obs.export import prometheus_text

            self._send(200, prometheus_text().encode(),
                       ctype="text/plain; version=0.0.4; charset=utf-8")
        else:
            self._send(404, b'{"error": "not found"}')

    def do_POST(self):  # noqa: N802
        if urllib.parse.urlparse(self.path).path != "/ops":
            self._send(404, b'{"error": "not found"}')
            return
        length = int(self.headers.get("Content-Length", 0))
        ops = _ops_from_jsonl(self.rfile.read(length))
        applied = self.replica.ingest(ops)
        self._send(200, json.dumps({"applied": applied,
                                    "received": len(ops)}).encode())


class FleetServer:
    """Threaded HTTP endpoint for one replica; ``port=0`` picks a free port
    (read it back from ``.port``)."""

    def __init__(self, replica: Replica, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundFleetHandler", (_Handler,), {"replica": replica})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "FleetServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="repro-torch-fleet-http",
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


class HttpTransport(Transport):
    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def describe(self) -> str:
        return self.url

    def _get(self, path: str) -> bytes:
        with urllib.request.urlopen(self.url + path, timeout=self.timeout) as r:
            return r.read()

    def _remote_vv(self) -> dict:
        return json.loads(self._get("/vv"))

    def push(self, oplog: OpLog) -> int:
        ops = oplog.ops_after(self._remote_vv())
        if not ops:
            return 0
        req = urllib.request.Request(
            self.url + "/ops", data=_ops_to_jsonl(ops),
            headers={"Content-Type": "application/jsonl"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            json.loads(r.read())  # surface malformed replies as errors
        return len(ops)

    def pull(self, oplog: OpLog) -> list[Op]:
        vv = urllib.parse.quote(json.dumps(oplog.version_vector()))
        return _ops_from_jsonl(self._get(f"/ops?vv={vv}"))

    def pending(self, oplog: OpLog) -> int:
        return len(oplog.ops_after(self._remote_vv()))

    def status(self) -> dict:
        """The peer's own status dict (including its ``obs`` histogram
        summaries) — ``launch.fleet status --transport http://...`` shows the
        serving process's numbers, not just this client's."""
        return json.loads(self._get("/status"))
