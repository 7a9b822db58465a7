"""repro_torch.fleet — cross-host TuningStore replication, a copy of
``repro.fleet`` (the oplog's on-disk format is the same byte for byte, so
the two packages replicate into each other's stores).

The distribution layer over :mod:`repro_torch.dispatch`: every store mutation
becomes a stamped op in an append-only per-host oplog, transports move op
deltas between hosts (shared-directory/object-store files, or a localhost
HTTP push/pull pair), and an anti-entropy :class:`SyncAgent` periodically
merges remote ops back into the live store — deterministically (lowest
objective wins per key, quarantine/tombstone aware, idempotent under
re-application) — and invalidates the dispatch service's compiled
executables so better fleet configs hot-swap into serving.

    from repro_torch import dispatch, fleet
    svc = dispatch.configure("results/store")
    rep = fleet.Replica(svc.store, service=svc)
    agent = fleet.SyncAgent(rep, fleet.FileTransport("/mnt/shared/fleet"),
                            interval_sec=30).start()
    # one host's 200-eval campaign is now every host's warm start

See :mod:`repro_torch.fleet.oplog` for the on-disk oplog layout and the
convergence guarantees, :mod:`repro_torch.fleet.transport` for the transport
contract; ``python -m repro_torch.launch.fleet`` is the CLI.
"""

from repro_torch.fleet.oplog import OP_KINDS, MergeState, Op, OpLog
from repro_torch.fleet.sync import Replica, SyncAgent
from repro_torch.fleet.transport import FileTransport, Transport, transport_from_spec

__all__ = [
    "OP_KINDS",
    "FileTransport",
    "FleetServer",
    "HttpTransport",
    "MergeState",
    "Op",
    "OpLog",
    "Replica",
    "SyncAgent",
    "Transport",
    "transport_from_spec",
]


def __getattr__(name):
    # http.server machinery loads lazily: most fleets use the file transport
    if name in ("FleetServer", "HttpTransport"):
        from repro_torch.fleet import http as _http

        return getattr(_http, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
