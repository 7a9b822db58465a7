"""Three-term roofline model of a traced step on Hopper — the counterpart of
``repro.perf.roofline``, and backend B2's objective. Terms (seconds):

    compute    = FLOPs_global    / (chips * PEAK_FLOPS)
    memory     = bytes_global    / (chips * HBM_BW)
    collective = collective_bytes_pd / LINK_BW          (per-device traffic
                                                          over the card's links)

:func:`repro_torch.perf.op_cost.trace_step` counts one device's share, so
global = per_device * chips; the collective term uses the per-device
traffic directly. The bound is max(terms) — the dominant term — and the
roofline fraction is compute/max(terms).

Hardware: an NVIDIA H100, the figures of ``kernels/cost.py:hopper()`` — the
card's own memory at run time, and NVIDIA's data sheet for the rest: the
dense bf16 tensor-core peak for a cell in bf16 (the catalog's dtype), the
FFMA peak for a cell in f32, HBM3's rate and NVLink's rate a direction.
Without a card the H100 SXM5's data-sheet figures (``H100_SXM5``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.cost import H100_SXM5, Hopper, hopper
from repro_torch.perf.collectives import CollectiveStats
from repro_torch.perf.op_cost import Cost, StepTrace, trace_step

__all__ = ["HW", "Hardware", "RooflineReport", "analyze_step", "score_cell", "trace_cell",
           "hardware", "report_of"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # FLOP/s per card at the cell's dtype
    hbm_bw: float            # bytes/s per card
    link_bw: float           # bytes/s per card, one direction of NVLink
    memory_bytes: float      # the card's memory


def hardware(dtype=torch.bfloat16, card: Hopper | None = None) -> Hardware:
    """The roofline's figures for a step in ``dtype`` on ``card`` (default:
    ``hopper()``, the current card or the H100 SXM5's data sheet)."""
    card = card or hopper()
    peak = card.ffma_flops if dtype == torch.float32 else card.bf16_flops
    return Hardware(name=card.name, peak_flops=peak, hbm_bw=card.hbm_bytes_per_sec,
                    link_bw=card.nvlink_bytes_per_sec, memory_bytes=card.hbm_bytes)


HW = hardware(torch.bfloat16, H100_SXM5)


@dataclasses.dataclass
class RooflineReport:
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: CollectiveStats
    peak_memory_per_device: float | None
    hw: Hardware = HW
    model_flops: float | None = None  # 6*N*D-style useful FLOPs (global)

    # -- the three terms (seconds) ------------------------------------------

    @property
    def flops_global(self) -> float:
        return self.flops_per_device * self.chips

    @property
    def compute_sec(self) -> float:
        return self.flops_global / (self.chips * self.hw.peak_flops)

    @property
    def memory_sec(self) -> float:
        return (self.bytes_per_device * self.chips) / (self.chips * self.hw.hbm_bw)

    @property
    def collective_sec(self) -> float:
        return self.collective_bytes_per_device / self.hw.link_bw

    @property
    def bound_sec(self) -> float:
        return max(self.compute_sec, self.memory_sec, self.collective_sec)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_sec,
            "memory": self.memory_sec,
            "collective": self.collective_sec,
        }
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step bound spent doing tensor-core math:
        compute/bound. 1.0 means perfectly compute-bound."""
        b = self.bound_sec
        return self.compute_sec / b if b > 0 else 0.0

    @property
    def useful_flops_ratio(self) -> float | None:
        """MODEL_FLOPS / counted FLOPs — how much counted compute is useful
        (catches remat and redundancy: heads replicated over ``model``)."""
        if self.model_flops is None or self.flops_global == 0:
            return None
        return self.model_flops / self.flops_global

    @property
    def fits_card(self) -> bool | None:
        """Whether the peak live bytes per device fit the card's memory."""
        if self.peak_memory_per_device is None:
            return None
        return self.peak_memory_per_device <= self.hw.memory_bytes

    def row(self) -> dict:
        return {
            "chips": self.chips,
            "compute_sec": self.compute_sec,
            "memory_sec": self.memory_sec,
            "collective_sec": self.collective_sec,
            "dominant": self.dominant,
            "bound_sec": self.bound_sec,
            "roofline_fraction": self.roofline_fraction,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "peak_memory_per_device": self.peak_memory_per_device,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collective_detail": self.collectives.summary(),
            "collective_bytes_by_kind": dict(self.collectives.bytes_by_kind),
            "hw": self.hw.name,
            "peak_flops": self.hw.peak_flops,
        }


def analyze_step(cost: Cost, chips: int, peak_memory: float | None = None,
                 model_flops: float | None = None, hw: Hardware = HW,
                 collectives: CollectiveStats | None = None) -> RooflineReport:
    """A RooflineReport from a step's per-device :class:`Cost` (the
    counterpart of ``analyze_compiled``)."""
    coll = collectives or CollectiveStats(dict(cost.coll_by_kind),
                                          {k: -1 for k in cost.coll_by_kind})
    return RooflineReport(chips=chips, flops_per_device=cost.flops,
                          bytes_per_device=cost.bytes,
                          collective_bytes_per_device=cost.collective_bytes,
                          collectives=coll, peak_memory_per_device=peak_memory, hw=hw,
                          model_flops=model_flops)


def report_of(trace: StepTrace, chips: int, model_flops: float | None = None,
              hw: Hardware = HW) -> RooflineReport:
    """The report of a :func:`trace_step` result."""
    return analyze_step(trace.cost, chips, trace.peak_bytes, model_flops, hw,
                        trace.collectives)


def trace_cell(plan, mesh, hw: Hardware | None = None) -> tuple[StepTrace, RooflineReport]:
    """Build the planned cell on ``mesh`` (``launch.cells.build_cell``),
    trace its step and report it with the roofline of ``hw`` (by default
    :func:`hardware` at the cell's dtype): (trace, report)."""
    from repro_torch.launch.cells import build_cell  # lazy: cells imports models

    cell, aux = build_cell(plan, mesh)
    trace = trace_step(cell.fn, *cell.args)
    return trace, report_of(trace, plan.chips, aux["model_flops"],
                            hw or hardware(plan.cfg.dtype))


def score_cell(plan, mesh, hw: Hardware | None = None) -> tuple[float, dict]:
    """Backend-B2 objective: trace the cell's step on ``mesh`` and return the
    roofline bound (seconds) — the modeled step time — plus the row (the
    counterpart of ``score_lowered``)."""
    _, rep = trace_cell(plan, mesh, hw)
    return rep.bound_sec, rep.row()
