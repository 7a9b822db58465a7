"""Problem sizes, the variant factory the autotuner times, and the cost
backend's evaluators.

  * ``BENCH_DIMS`` — small sizes for the CPU backend (plain versions, tests);
    the same as ``repro.kernels.problems.BENCH_DIMS``.
  * ``LARGE_SHAPES`` — the paper's LARGE dataset sizes, which the GPU
    backend times on the card.
  * ``PROXY_DIMS`` — the fidelity ladder's reduced proxy sizes (rung 1),
    the same as ``repro.kernels.problems.PROXY_DIMS``.

:func:`gpu_problem` creates a problem's inputs on the device once per
campaign and returns the ``factory(config) -> (fn, args)`` that
:class:`~repro_torch.core.plopper.TimingEvaluator` runs: every evaluation
reuses the same device tensors, and on the card every one is a launch of the
CUDA kernel with the proposed schedule.

:func:`problem_signature_for` gives the store signature of a backend's
canonical problem, the one ``repro_torch.dispatch`` derives from the
runtime arguments, so that a record an offline campaign publishes resolves
as an exact hit at ``dispatch()`` time; :func:`dims_from_signature` inverts
it.

:func:`make_cost_evaluator` scores configs with the Hopper cost model
(:func:`repro_torch.kernels.cost.kernel_cost`) at fixed dims, and
:func:`register_cost_backend` re-registers every costed kernel with a
``VariantSpec.make_evaluator`` that derives the dims from a campaign's
argument shapes, so a :class:`~repro_torch.dispatch.BackgroundTuner`
attached to a ``DispatchService(backend="cost")`` tunes analytically.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core.plopper import EvalResult

from repro_torch.kernels import model_kernels, ops, ref
from repro_torch.kernels.util import resolve_device

__all__ = ["BENCH_DIMS", "LARGE_SHAPES", "PROXY_DIMS", "dims_from_signature",
           "fidelity_ready", "fidelity_readiness", "gpu_problem", "make_cost_evaluator",
           "problem_inputs", "problem_signature_for", "register_cost_backend"]

BENCH_DIMS = {
    "syr2k": (240, 200),
    "mm3": (200, 180, 160, 150, 170),
    "lu": (256,),
    "heat3d": (40, 8),
    "covariance": (300, 240),
    "floyd_warshall": (240,),
    "flash_attention": (4, 128, 128, 64),
    "decode_attention": (8, 2, 128, 64),   # (BH, G, seq_bucket, hd)
    "matmul": (256, 192, 224),
}

LARGE_SHAPES = {
    "syr2k": (1200, 1000),
    "mm3": (800, 900, 1000, 1100, 1200),
    "lu": (2000,),
    "heat3d": (120, 500),
    "covariance": (1400, 1200),
    "floyd_warshall": (2800,),
    # the serving kernels: a 16-head 4k-context serving shape, the JAX
    # package's LARGE analog
    "flash_attention": (16, 4096, 4096, 128),
    "decode_attention": (16, 8, 4096, 128),
    "matmul": (2000, 2300, 2600),
}

# reduced-shape proxy sizes (repro_torch.fidelity rung 1): about half the
# linear problem dims (an eighth of the work for the cubic kernels); heat3d
# also cuts tsteps (a pure multiplier on config ranking)
PROXY_DIMS = {
    "syr2k": (120, 100),
    "mm3": (100, 90, 80, 75, 85),
    "lu": (128,),
    "heat3d": (24, 4),
    "covariance": (150, 120),
    "floyd_warshall": (120,),
    "flash_attention": (2, 64, 64, 64),
    "decode_attention": (4, 2, 64, 64),
    "matmul": (128, 96, 112),
}

_OPS = {"syr2k": ops.syr2k_op, "mm3": ops.mm3_op, "lu": ops.lu_op,
        "covariance": ops.covariance_op, "floyd_warshall": ops.floyd_warshall_op}
# the serving kernels: their dispatch builders, over a sampled config
_MODEL_HOSTS = {"flash_attention": model_kernels.flash_attention_host,
                "decode_attention": model_kernels.decode_attention_host,
                "matmul": model_kernels.matmul_host}


def problem_inputs(name: str, dims: tuple, device, seed: int = 0):
    """The problem's inputs, drawn with numpy from ``seed`` and moved to
    ``device``. heat3d's dims are (N, tsteps): its one input is the N^3 grid;
    decode_attention's last input is the int32 cur_pos vector."""
    if name == "decode_attention":
        q, k, v, cur_pos = model_kernels.init_decode_attention(*dims, seed=seed)
        return ref.to_device((q, k, v), device) + (
            torch.from_numpy(cur_pos).to(device),)
    init = {"syr2k": ref.init_syr2k, "mm3": ref.init_mm3, "lu": ref.init_lu,
            "heat3d": lambda N, tsteps, seed: ref.init_heat3d(N, seed=seed),
            "covariance": ref.init_covariance,
            "floyd_warshall": ref.init_floyd_warshall,
            "flash_attention": model_kernels.init_flash_attention,
            "matmul": model_kernels.init_matmul}[name]
    return ref.to_device(init(*dims, seed=seed), device)


def gpu_problem(name: str, dims: tuple | None = None, device=None, seed: int = 0):
    """Variant factory for ``name`` at ``dims`` (default :data:`LARGE_SHAPES`)
    on ``device`` (default ``cuda``; ``"cpu"`` runs the plain versions).
    The inputs are created once, here, not once per evaluation."""
    dev = resolve_device(device)
    dims = LARGE_SHAPES[name] if dims is None else tuple(dims)
    args = problem_inputs(name, dims, dev, seed)
    if name in _MODEL_HOSTS:
        return _MODEL_HOSTS[name](args)
    if name == "heat3d":
        tsteps = dims[1]

        def op(A, config):
            return ops.heat3d_op(A, tsteps, config=config)
    else:
        op = _OPS[name]

    def factory(config):
        return (lambda *xs: op(*xs, config=config)), args

    return factory


def problem_signature_for(kernel: str, backend: str) -> tuple:
    """Per-argument store signature of ``kernel``'s canonical problem on
    ``backend``: ``gpu`` and ``cost`` campaigns run at :data:`LARGE_SHAPES`
    (as the JAX package's ``cost`` backend), ``cpu`` campaigns at
    :data:`BENCH_DIMS` (as its ``host`` backend)."""
    if backend not in ("gpu", "cpu", "cost"):
        raise ValueError(f"backend must be 'gpu', 'cpu' or 'cost', got {backend!r}")
    dims = BENCH_DIMS[kernel] if backend == "cpu" else LARGE_SHAPES[kernel]
    return ref.problem_signature(kernel, *dims)


def dims_from_signature(kernel: str, signature) -> tuple:
    """Inverse of :func:`repro_torch.kernels.ref.problem_signature`: the
    problem dims of a (possibly runtime-derived) shape signature. Trailing
    static-kwarg entries (flash attention's folded ``causal`` flag) are
    ignored; a heat3d signature without its ``tsteps`` entry scores one
    step."""
    if kernel == "syr2k":
        return (signature[0][0], signature[1][1])
    if kernel == "mm3":
        (P, Q), (_, R_), (_, S), (_, T) = signature[:4]
        return (P, Q, R_, S, T)
    if kernel in ("lu", "floyd_warshall"):
        return (signature[0][0],)
    if kernel == "heat3d":
        t = signature[1][0] if len(signature) > 1 and len(signature[1]) == 1 else 1
        return (signature[0][0], t)
    if kernel == "covariance":
        return tuple(signature[0])
    if kernel == "flash_attention":
        (BH, Sq, hd), (_, Sk, _) = signature[0], signature[1]
        return (BH, Sq, Sk, hd)
    if kernel == "decode_attention":
        (BH, G, hd), (_, S, _) = signature[0], signature[1]
        return (BH, G, S, hd)
    if kernel == "matmul":
        (M, K), (_, N) = signature[0], signature[1]
        return (M, K, N)
    raise KeyError(f"unknown kernel {kernel!r}")


def fidelity_ready(kernel: str) -> bool:
    """True when ``kernel`` can take part in the fidelity ladder's rung 0:
    the cost model has an entry to screen it with."""
    from repro_torch.kernels.cost import KERNEL_COST_FNS

    return kernel in KERNEL_COST_FNS


def fidelity_readiness() -> dict[str, bool]:
    """``kernel -> fidelity_ready`` over every dispatch-registered kernel."""
    from repro_torch.dispatch.registry import registered

    return {name: fidelity_ready(name) for name in registered()}


def make_cost_evaluator(kernel: str, dims: tuple | None = None,
                        dtype=None) -> Callable:
    """``config -> EvalResult`` scored by the Hopper cost model at ``dims``
    (default: :data:`LARGE_SHAPES`) for operands of ``dtype`` where given
    (``kernels.cost.kernel_cost``). A config that does not fit the card
    comes back failed at 1e9 with the model's info (the JAX package's
    penalty semantics)."""
    from repro_torch.kernels.cost import kernel_cost

    shape = tuple(dims) if dims is not None else LARGE_SHAPES[kernel]

    def evaluate(cfg: Mapping) -> EvalResult:
        t, info = kernel_cost(kernel, cfg, *shape, dtype=dtype)
        if not np.isfinite(t):
            return EvalResult(1e9, False, info)
        return EvalResult(t, True, info)

    return evaluate


def _cost_make_evaluator(kernel: str) -> Callable:
    """A ``VariantSpec.make_evaluator``: given a background campaign's
    ``factory(config) -> (fn, args)``, an evaluator that never runs ``fn``:
    it derives the problem dims from the args' shapes, and the operands'
    dtype from the first, and scores the config with the cost model."""

    def make(factory: Callable) -> Callable:
        inner: list[Callable] = []  # built once, after dims are derived

        def evaluate(cfg: Mapping) -> EvalResult:
            if not inner:
                from repro_torch.dispatch.signature import shape_signature

                _, args = factory(cfg)
                sig = shape_signature(args)
                dtype = next((a.dtype for a in args if isinstance(a, torch.Tensor)), None)
                inner.append(make_cost_evaluator(kernel, dims_from_signature(kernel, sig),
                                                 dtype=dtype))
            return inner[0](cfg)

        return evaluate

    return make


def register_cost_backend() -> None:
    """Re-register every costed kernel in the dispatch registry with the cost
    model as its background-campaign evaluator (each keeps its builder and
    space): campaigns of a ``DispatchService(backend="cost")`` then score
    schedules analytically instead of timing them."""
    from repro_torch.dispatch.registry import get, register
    from repro_torch.kernels.cost import KERNEL_COST_FNS

    for name in KERNEL_COST_FNS:
        spec = get(name)  # loads the built-ins
        register(name, spec.builder, spec.space, eval_repeats=spec.eval_repeats,
                 eval_warmup=spec.eval_warmup, make_evaluator=_cost_make_evaluator(name))
