"""Elastic scaling: re-plan the production mesh when devices are lost — a
copy of ``repro.ft.elastic``.

A shrink/regrow is: pick a new shape from the allowed ladder, rebuild the
step for it, restore the last checkpoint, continue. This module holds the
planning logic (pure, unit-testable); the port has no mesh yet (ROADMAP.md
Queue 1, item 7)."""

from __future__ import annotations

import dataclasses

__all__ = ["MeshPlan", "plan_mesh", "LADDER"]

# allowed (pod, data, model) shapes, preference order (biggest first)
LADDER = [
    (2, 16, 16),
    (1, 16, 16),
    (1, 8, 16),
    (1, 8, 8),
    (1, 4, 8),
    (1, 4, 4),
    (1, 2, 4),
    (1, 1, 4),
    (1, 1, 2),
    (1, 1, 1),
]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    n_devices: int
    dropped: int   # healthy devices left unused by this plan

    @property
    def multi_pod(self) -> bool:
        return self.shape[0] > 1


def plan_mesh(healthy_devices: int, ladder=LADDER) -> MeshPlan:
    """Largest ladder entry that fits the healthy-device count."""
    for shape in ladder:
        n = shape[0] * shape[1] * shape[2]
        if n <= healthy_devices:
            axes = ("pod", "data", "model") if shape[0] > 1 else ("data", "model")
            eff = shape if shape[0] > 1 else shape[1:]
            return MeshPlan(eff, axes, n, healthy_devices - n)
    raise RuntimeError("no devices healthy")
