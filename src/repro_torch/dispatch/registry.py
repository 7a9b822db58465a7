"""Dispatch registry: kernel name -> how to build a tuned variant.

Each entry ties together the three things the runtime needs: a *builder*
(``builder(config, **static_kw) -> fn(*arrays)``) producing the concrete
kernel call for a configuration, the kernel's :class:`ConfigurationSpace`
factory (``space(target) -> ConfigurationSpace``) for background campaigns,
and the space default as the last-resort config when the store is empty.

The built-in model kernels register themselves from
``repro_torch.kernels.model_kernels`` on first use (lazy, to keep this
module import-light and cycle-free); user kernels register with
:func:`register`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

__all__ = ["VariantSpec", "register", "get", "registered"]


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    name: str
    builder: Callable[..., Callable]            # builder(config, **static_kw) -> fn
    space: Callable[[str], Any]                 # target -> ConfigurationSpace
    eval_repeats: int = 1                       # timing repeats for background tuning
    eval_warmup: int = 1
    # optional override for background campaigns: factory(cfg) -> (fn, args)
    # goes in, evaluator(cfg) -> EvalResult comes out. Defaults to wall-clock
    # timing (TimingEvaluator); inject e.g. a cost-model scorer instead.
    make_evaluator: Callable[[Callable], Callable] | None = None

    def default_config(self, target: str = "host") -> dict:
        return self.space(target).default_configuration()


_REGISTRY: dict[str, VariantSpec] = {}
_builtins_loaded = False


def register(
    name: str,
    builder: Callable[..., Callable],
    space: Callable[[str], Any],
    **kw,
) -> VariantSpec:
    spec = VariantSpec(name=name, builder=builder, space=space, **kw)
    _REGISTRY[name] = spec
    return spec


def _ensure_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    from repro_torch.kernels import model_kernels

    # the model kernels only: the PolyBench DISPATCH_BUILDERS wait for their
    # host molds (kernels/variants.py is not ported yet)
    model_kernels.register_model_kernels()     # flash + decode attention, matmul


def get(name: str) -> VariantSpec:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no dispatch variant registered for kernel {name!r}; "
            f"known: {sorted(_REGISTRY)}"
        ) from None


def registered() -> list[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)
