"""High-level autotuning API: the framework's user-facing entry point.

``autotune()`` wires a ConfigurationSpace + evaluator + learner into a full
:class:`repro_torch.engine.Campaign` (the paper's --max-evals / --learner CLI
options map 1:1, plus ``parallel`` for batched concurrent evaluation), and
``compare_learners()`` runs the paper's four-learner study.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

from repro_torch.core.plopper import EvalResult
from repro_torch.core.search import SearchResult, run_search
from repro_torch.core.space import ConfigurationSpace
from repro_torch.core.surrogates import LEARNERS

__all__ = ["autotune", "compare_learners"]


def autotune(
    space: ConfigurationSpace,
    evaluator: Callable[[Mapping[str, Any]], EvalResult],
    max_evals: int = 100,
    learner: str = "RF",
    seed: int = 1234,
    db_path: str | None = None,
    parallel: int = 1,
    **kw,
) -> SearchResult:
    """Run one autotuning campaign. ``learner`` in {RF, ET, GBRT, GP} (paper
    default: RF); ``max_evals`` is the paper's -max-evals (default 100).
    ``parallel`` > 1 keeps that many evaluations in flight (constant-liar
    batching over a thread pool; the evaluator must be thread-safe);
    ``parallel=1`` is the paper's serial loop, bit-for-bit."""
    return run_search(
        space, evaluator, max_evals=max_evals, learner=learner, seed=seed,
        db_path=db_path, parallel=parallel, **kw,
    )


def compare_learners(
    space: ConfigurationSpace,
    evaluator: Callable[[Mapping[str, Any]], EvalResult],
    max_evals: int = 100,
    learners: tuple[str, ...] = LEARNERS,
    seed: int = 1234,
    db_root: str | None = None,
    **kw,
) -> dict[str, SearchResult]:
    """The paper's Sec. 4 methodology: run the same campaign under each of the
    four surrogate models and compare best objective / eval-found-at."""
    out: dict[str, SearchResult] = {}
    for learner in learners:
        db_path = f"{db_root}/{learner}" if db_root else None
        out[learner] = autotune(
            space, evaluator, max_evals=max_evals, learner=learner, seed=seed,
            db_path=db_path, **kw,
        )
    return out
