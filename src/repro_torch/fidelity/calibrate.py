"""Per-rung bias/scale calibration between fidelities — a copy of
``repro.fidelity.calibrate``.

A cost-model score and a measurement live on different scales (the Hopper
model's seconds vs CUDA-event seconds of a launch from the host — often far
apart), and a proxy-shape timing is systematically faster than
the full shape. Feeding raw low-rung objectives into a higher rung's
surrogate as priors would teach it a wrong *level* even when the *ordering*
is right. :class:`RungCalibration` learns the mapping online from paired
observations — configurations measured at both rungs, which the cascade's
promotions produce for free — as a log-space affine model::

    log(high) ≈ a + b · log(low)

i.e. a multiplicative bias (``e^a``) and a power-law scale (``b``). With
fewer than ``min_pairs`` pairs the model degrades gracefully: a single pair
calibrates the median ratio (pure bias, ``b = 1``); no pairs at all is the
identity. ``b`` is clipped to a sane band so two noisy early pairs cannot
invert or explode the mapping.

Calibration state is *derived*, never persisted: the cascade rebuilds it
from the per-rung performance databases (joining records by canonical
config key), which is what makes a resumed cascade's calibration identical
to an uninterrupted run's.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["RungCalibration", "pairs_from_records"]

_B_MIN, _B_MAX = 0.25, 4.0  # power-law clip band
_EPS = 1e-12                # objectives at/below this are uncalibratable


class RungCalibration:
    """Online low-rung → high-rung objective mapping."""

    def __init__(self, min_pairs: int = 3):
        self.min_pairs = min_pairs
        self._low: list[float] = []
        self._high: list[float] = []
        self._coef: tuple[float, float] | None = None  # (a, b), lazily fit

    @property
    def n_pairs(self) -> int:
        return len(self._low)

    def update(self, low: float, high: float) -> bool:
        """Add one paired observation; non-finite or non-positive values
        (failure penalties, infeasible scores) are rejected — they would
        poison the fit and carry no scale information."""
        low, high = float(low), float(high)
        if not (math.isfinite(low) and math.isfinite(high)):
            return False
        if low <= _EPS or high <= _EPS:
            return False
        self._low.append(low)
        self._high.append(high)
        self._coef = None
        return True

    def _fit(self) -> tuple[float, float]:
        if self._coef is not None:
            return self._coef
        lx = np.log(np.asarray(self._low))
        ly = np.log(np.asarray(self._high))
        if len(lx) < self.min_pairs or float(np.ptp(lx)) < 1e-9:
            # bias-only: not enough pairs (or a degenerate vertical cloud)
            # to estimate a slope — match the median log-ratio
            a = float(np.median(ly - lx))
            self._coef = (a, 1.0)
            return self._coef
        b, a = np.polyfit(lx, ly, 1)
        b = float(min(_B_MAX, max(_B_MIN, b)))
        # re-center the intercept after clipping so the mapping still passes
        # through the cloud's median
        a = float(np.median(ly - b * lx))
        self._coef = (a, b)
        return self._coef

    def apply(self, low: float) -> float:
        """Map a low-rung objective onto the high rung's scale. Identity
        with no pairs; non-positive/non-finite inputs pass through untouched
        (penalty semantics are scale-free already)."""
        low = float(low)
        if not self._low or not math.isfinite(low) or low <= _EPS:
            return low
        a, b = self._fit()
        return math.exp(a + b * math.log(low))

    def describe(self) -> dict:
        if not self._low:
            return {"n_pairs": 0, "bias": 1.0, "scale": 1.0}
        a, b = self._fit()
        return {"n_pairs": self.n_pairs, "bias": math.exp(a), "scale": b}


def pairs_from_records(low_records, high_records) -> list[tuple[float, float]]:
    """Join two record lists by canonical config key, yielding
    (low_objective, high_objective) pairs for configs observed (status OK)
    at both rungs — the calibration's training set, re-derivable from the
    per-rung JSONLs on resume. When a config was evaluated more than once
    at a rung the first OK observation wins (record order is deterministic,
    so so is the join)."""
    from repro_torch.core.database import OK
    from repro_torch.core.space import config_key

    lows: dict[tuple, float] = {}
    for r in low_records:
        if r.status == OK:
            lows.setdefault(config_key(r.config), float(r.objective))
    pairs = []
    seen: set[tuple] = set()
    for r in high_records:
        key = config_key(r.config)
        if r.status == OK and key in lows and key not in seen:
            seen.add(key)
            pairs.append((lows[key], float(r.objective)))
    return pairs
