"""repro_torch.perf — the op-level cost counter and the Hopper roofline (the
counterpart of ``repro.perf``)."""

from repro_torch.perf.collectives import (
    DTYPE_BYTES,
    CollectiveStats,
    collective_kind,
    tensor_bytes,
)
from repro_torch.perf.op_cost import Cost, StepTrace, step_cost, trace_step
from repro_torch.perf.roofline import (
    HW,
    Hardware,
    RooflineReport,
    analyze_step,
    hardware,
    score_cell,
)

__all__ = [
    "CollectiveStats", "DTYPE_BYTES", "collective_kind", "tensor_bytes",
    "Cost", "StepTrace", "step_cost", "trace_step",
    "HW", "Hardware", "RooflineReport", "analyze_step", "hardware", "score_cell",
]
