"""Acquisition functions for Bayesian optimization.

The paper uses the lower-confidence-bound (LCB) acquisition: minimize
``mu - kappa * sigma`` so uncertainty draws the search toward unexplored,
potentially-better regions while the surrogate mean exploits known-good ones.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["lcb", "expected_improvement", "ACQUISITIONS", "make_acquisition"]


def lcb(mu: np.ndarray, sigma: np.ndarray, kappa: float = 1.96, **_) -> np.ndarray:
    """Lower confidence bound. Smaller is more promising (we minimize)."""
    return mu - kappa * sigma


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _norm_cdf(z):
    # Abramowitz–Stegun style erf; avoids a scipy dependency
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def expected_improvement(mu: np.ndarray, sigma: np.ndarray, best: float = 0.0, xi: float = 0.01,
                         **_) -> np.ndarray:
    """Negated EI for minimization (smaller return = more promising)."""
    sigma = np.maximum(sigma, 1e-12)
    z = (best - xi - mu) / sigma
    ei = (best - xi - mu) * _norm_cdf(z) + sigma * _norm_pdf(z)
    return -ei


ACQUISITIONS = ("LCB", "EI")


def make_acquisition(name: str):
    name = name.upper()
    if name == "LCB":
        return lcb
    if name == "EI":
        return expected_improvement
    raise ValueError(f"unknown acquisition {name!r}; options: {ACQUISITIONS}")
