"""repro_torch.guard — the resilience layer, the counterpart of
``repro.guard``: hardened campaign evaluation (``harden``), shadow
evaluation on the device (``shadow``), the drift/regression watch
(``watch``) and deterministic fault injection (``faults``, a copy).

Imports are lazy (PEP 562), as in ``repro.guard``, so that
``repro_torch.core.jsonl`` can import ``repro_torch.guard.faults`` without
pulling in torch and the dispatch machinery.
"""

_EXPORTS = {
    "FaultInjected": "faults",
    "Fault": "faults",
    "inject": "faults",
    "fault_point": "faults",
    "fault_hit": "faults",
    "install_env_faults": "faults",
    "clear_faults": "faults",
    "active_faults": "faults",
    "CATALOG": "faults",
    "FailureObservation": "harden",
    "HardenPolicy": "harden",
    "HardenedExecutor": "harden",
    "ShadowPolicy": "shadow",
    "ShadowEvaluator": "shadow",
    "WatchPolicy": "watch",
    "GuardAgent": "watch",
    "window_stats": "watch",
    "replay_decisions": "watch",
    "guard_counters": "watch",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.guard' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"repro_torch.guard.{mod}"), name)
