"""repro_torch.fidelity — multi-fidelity cascade campaigns with top-k
promotion, the counterpart of ``repro.fidelity``.

A declarative :class:`FidelityLadder` (the Hopper cost model of the CUDA
kernels → reduced-shape proxy timing on the card → full timing on the
card) plus a :class:`CascadeCampaign` that screens a wide configuration
pool on the cheap rungs and promotes only the top-k to the next —
successive-halving budgets — while every rung's observations feed the
surrogate as calibrated priors. See ``python -m
repro_torch.launch.fidelity audit`` for the rank-correlation contract that
decides which kernels may screen analytically.
"""

from repro_torch.fidelity.calibrate import RungCalibration, pairs_from_records
from repro_torch.fidelity.cascade import CascadeCampaign, CascadeResult
from repro_torch.fidelity.ladder import FidelityLadder, Rung, default_ladder

__all__ = [
    "CascadeCampaign",
    "CascadeResult",
    "FidelityLadder",
    "Rung",
    "RungCalibration",
    "default_ladder",
    "pairs_from_records",
]
