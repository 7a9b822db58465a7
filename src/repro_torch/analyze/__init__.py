"""repro_torch.analyze — static analysis for the tuning stack, the
counterpart of ``repro.analyze``.

Two passes, no builds, no launches:

  * :mod:`repro_torch.analyze.feasibility` — declarative per-kernel
    constraint rules that judge a configuration against the problem dims
    before anything is built or launched: the search path prunes with them
    (``launch.autotune --prune-infeasible``) and the dispatch service checks
    store records with them before its build guard;
  * :mod:`repro_torch.analyze.lint` — an AST-based concurrency lint that
    checks the documented threading invariants of ``src/repro_torch`` itself
    (lock order, guarded shared-state mutation, monotonic duration clocks,
    daemon/stop handling for threads).

CLI: ``python -m repro_torch.launch.analyze {space,lint}``.
"""

from repro_torch.analyze.feasibility import (
    Feasibility,
    Finding,
    check_config,
    feasibility_filter,
    kernel_rules,
)
from repro_torch.analyze.lint import LintFinding, lint_paths, lint_source

__all__ = [
    "Feasibility",
    "Finding",
    "check_config",
    "feasibility_filter",
    "kernel_rules",
    "LintFinding",
    "lint_paths",
    "lint_source",
]
