"""Rank-correlation audit: does the cost model order configs like the card?
A copy of ``repro.fidelity.audit`` that measures the CUDA kernels.

Rung 0 of the fidelity ladder screens with the analytic cost model, so the
cascade's whole premise is that the model's *ordering* (not its absolute
scale — calibration handles that) agrees with measured timing. This module
makes that a checkable contract: sample configurations, score each with the
cost model and with wall-clock timing at the same problem dims, and report
the Spearman rank correlation ρ. Kernels whose ρ clears the threshold are
safe to screen analytically (``screen_ok``); weak kernels are flagged so a
cascade over them leans on the proxy rung instead.

``python -m repro_torch.launch.fidelity audit`` exposes this as a CLI
(``--out`` keeps every pair, with the card's description and the shared
memory the model read, so a test can recompute ρ from a recorded run:
``tests/test_torch_fidelity.py``).
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np

__all__ = ["spearman_rho", "audit_kernel", "audit_kernels", "DEFAULT_RHO_MIN"]

# below this the cost model is no better than a weak shuffle — don't screen
DEFAULT_RHO_MIN = 0.2


def spearman_rho(x: Sequence[float], y: Sequence[float]) -> float:
    """Spearman rank correlation without scipy: average-rank both vectors
    (ties share the mean of their rank block), then Pearson on the ranks.
    Returns NaN for fewer than 3 pairs or a degenerate (constant) vector."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if x.size < 3 or x.size != y.size:
        return float("nan")

    def ranks(v: np.ndarray) -> np.ndarray:
        order = np.argsort(v, kind="stable")
        r = np.empty(v.size, dtype=float)
        r[order] = np.arange(1, v.size + 1, dtype=float)
        # average ties so equal scores carry equal rank
        for val in np.unique(v):
            mask = v == val
            if mask.sum() > 1:
                r[mask] = r[mask].mean()
        return r

    rx, ry = ranks(x), ranks(y)
    sx, sy = rx.std(), ry.std()
    if sx < 1e-12 or sy < 1e-12:
        return float("nan")
    return float(np.mean((rx - rx.mean()) * (ry - ry.mean())) / (sx * sy))


def audit_kernel(
    kernel: str,
    *,
    n_samples: int = 10,
    seed: int = 7,
    dims: tuple | None = None,
    target: str | None = None,
    repeats: int = 1,
    warmup: int = 1,
    rho_min: float = DEFAULT_RHO_MIN,
    measure: Callable[[Mapping], float] | None = None,
    device: str | None = None,
) -> dict:
    """Audit one kernel: cost-model score vs measured time over a fixed-seed
    sample of its configuration space, both at the same ``dims`` — by
    default the dims a campaign tunes at, which rung 0 screens at:
    :data:`~repro_torch.kernels.problems.LARGE_SHAPES` on the card,
    :data:`~repro_torch.kernels.problems.BENCH_DIMS` on the CPU.

    ``measure`` injects the ground-truth scorer (``config -> seconds``) —
    tests use synthetic measurements; the default times the kernel with
    CUDA events on ``device`` (the card unless ``"cpu"``, where it
    wall-clocks the plain version). ``target`` picks the space flavour
    (``gpu`` on the card, ``host`` on the CPU by default; the dims follow
    it). Configs the cost
    model rejects (shared memory) or whose measurement fails are dropped
    from the correlation and counted in ``n_dropped``. ``pairs`` keeps each
    sampled config with its modeled and measured seconds and the shared
    memory the model read (None without a card).
    """
    from repro_torch.analyze import feasibility
    from repro_torch.core.plopper import TimingEvaluator
    from repro_torch.kernels.problems import (
        BENCH_DIMS,
        LARGE_SHAPES,
        gpu_problem,
        make_cost_evaluator,
    )
    from repro_torch.kernels.spaces import kernel_space
    from repro_torch.kernels.util import resolve_device

    dev = resolve_device(device) if measure is None else None
    if target is None:
        target = "host" if dev is not None and dev.type == "cpu" else "gpu"
    dims = tuple(dims) if dims is not None else \
        (BENCH_DIMS if target == "host" else LARGE_SHAPES)[kernel]
    cost = make_cost_evaluator(kernel, dims)
    if measure is None:
        timer = TimingEvaluator(gpu_problem(kernel, dims, device=dev),
                                repeats=repeats, warmup=warmup)

        def measure(cfg, _timer=timer):
            res = _timer(cfg)
            return float(res.objective) if res.ok else float("nan")

    space = kernel_space(kernel, target=target, seed=seed)
    rng = np.random.default_rng(seed)
    configs = space.sample_configurations(n_samples, rng)
    limit = feasibility.smem_limit()

    cost_scores, times, dropped, pairs = [], [], 0, []
    for cfg in configs:
        c = cost(cfg)
        smem = None if limit is None else feasibility.smem_needs(kernel, cfg, dims, limit)
        pair = {"config": dict(cfg), "modeled_sec": float(c.objective) if c.ok else None,
                "measured_sec": None,
                "smem": None if smem is None else [int(b) for _, b in smem]}
        pairs.append(pair)
        if not c.ok or not np.isfinite(c.objective):
            dropped += 1
            continue
        t = float(measure(cfg))
        if not np.isfinite(t) or t <= 0:
            dropped += 1
            continue
        pair["measured_sec"] = t
        cost_scores.append(float(c.objective))
        times.append(t)

    rho = spearman_rho(cost_scores, times)
    return {
        "kernel": kernel,
        "dims": list(dims),
        "target": target,
        "n_sampled": len(configs),
        "n_paired": len(times),
        "n_dropped": dropped,
        "rho": None if np.isnan(rho) else round(rho, 4),
        "rho_min": rho_min,
        "screen_ok": bool(not np.isnan(rho) and rho >= rho_min),
        "smem_limit": limit,
        "pairs": pairs,
    }


def audit_kernels(
    kernels: Sequence[str] | None = None,
    **kwargs,
) -> list[dict]:
    """Audit every ``fidelity_ready`` kernel (or an explicit subset), in
    sorted order so reports and tests are stable."""
    from repro_torch.kernels.cost import KERNEL_COST_FNS

    if kernels is None:
        kernels = sorted(KERNEL_COST_FNS)
    return [audit_kernel(k, **kwargs) for k in kernels]
