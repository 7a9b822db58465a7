"""repro_torch.analyze — static analysis for the tuning stack: the
counterpart of ``repro.analyze``'s feasibility pass.

:mod:`repro_torch.analyze.feasibility` holds declarative per-kernel
constraint rules that judge a configuration against the problem dims before
anything is built or launched: the search path prunes with them
(``launch.autotune --prune-infeasible``) and the dispatch service checks
store records with them before its build guard. The JAX package's
concurrency lint (``repro.analyze.lint``) is not ported yet.
"""

from repro_torch.analyze.feasibility import (
    Feasibility,
    Finding,
    check_config,
    feasibility_filter,
    kernel_rules,
)

__all__ = [
    "Feasibility",
    "Finding",
    "check_config",
    "feasibility_filter",
    "kernel_rules",
]
