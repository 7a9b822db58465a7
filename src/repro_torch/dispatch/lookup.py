"""Nearest-neighbor config resolution over the tuning store.

An exact ``(kernel, signature, backend)`` hit wins outright. Otherwise the
store's records for the same kernel+backend are ranked by log-scale shape
distance (see :mod:`repro.dispatch.signature`) and the closest compatible
record is returned, annotated with its distance so callers can decide
whether the neighbor is close enough to serve as-is or should also trigger
a background re-tune.
"""

from __future__ import annotations

import dataclasses

from repro_torch.dispatch.signature import ShapeSignature, signature_distance
from repro_torch.dispatch.store import TuningRecord, TuningStore

__all__ = ["Resolution", "resolve", "warm_start_material"]


@dataclasses.dataclass
class Resolution:
    record: TuningRecord
    distance: float      # 0.0 for an exact hit
    exact: bool

    @property
    def config(self) -> dict:
        return self.record.config


def resolve(
    store: TuningStore,
    kernel: str,
    signature: ShapeSignature,
    backend: str,
    max_distance: float | None = None,
) -> Resolution | None:
    """Exact hit, else nearest compatible neighbor within ``max_distance``
    (no bound when ``None``). Returns ``None`` when nothing qualifies."""
    hit = store.get(kernel, signature, backend)
    if hit is not None:
        return Resolution(hit, 0.0, True)
    best, best_d = None, float("inf")
    for rec in store.records(kernel=kernel, backend=backend):
        d = signature_distance(signature, rec.signature)
        if d < best_d:
            best, best_d = rec, d
    if best is None or best_d == float("inf"):
        return None
    if max_distance is not None and best_d > max_distance:
        return None
    return Resolution(best, best_d, False)


def warm_start_material(
    store: TuningStore,
    kernel: str,
    signature: ShapeSignature,
    backend: str,
    neighbors: int = 3,
) -> tuple[list[dict] | None, list[tuple[dict, float]] | None]:
    """Warm-start material for a campaign targeting ``signature``, derived
    from the store's nearest records: ``(configs, records)`` where
    ``configs`` is the single closest config (to re-evaluate first, so the
    campaign's best can never regress below the stored optimum) and
    ``records`` are up to ``neighbors`` further (config, objective) pairs
    that seed the surrogate as virtual observations. The re-evaluated config
    is excluded from the virtual observations — its real evaluation plus the
    prior row would double-count it in the surrogate's training data.
    Returns ``(None, None)`` when the store has no compatible record.

    This is the one warm-start policy shared by the background tuner, the
    autotune CLI, and the pallas-tuning benchmark (previously three
    divergent copies)."""
    from repro_torch.core.space import config_key
    from repro_torch.dispatch.signature import signature_distance as _dist

    # fold in records other writers appended since our last read — with
    # fleet replication (repro.fleet) a neighbor may have been tuned on a
    # different host and synced in moments ago; campaigns should warm-start
    # from the whole fleet's material, not this process's stale view
    store.refresh()
    ranked = sorted(
        store.records(kernel=kernel, backend=backend),
        key=lambda r: _dist(signature, r.signature))
    ranked = [r for r in ranked if _dist(signature, r.signature) != float("inf")]
    if not ranked:
        return None, None
    configs = [dict(ranked[0].config)]
    first = config_key(ranked[0].config)
    records = [(dict(r.config), float(r.objective))
               for r in ranked[1 : neighbors + 1]
               if config_key(r.config) != first]
    return configs, records or None
