"""repro_torch.guard — deterministic fault injection (copy of
repro.guard.faults). The hardened/shadow/watch layers are not ported yet.

Imports are lazy (PEP 562), as in ``repro.guard``, so that
``repro_torch.core.jsonl`` can import ``repro_torch.guard.faults`` cheaply.
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
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.guard' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"repro_torch.guard.{mod}"), name)
