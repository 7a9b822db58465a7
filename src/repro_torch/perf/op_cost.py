"""Op-level cost counter: FLOPs / bytes / collective bytes of one step per
device — the counterpart of ``repro.perf.hlo_cost``.

The reference walks a compiled XLA module's HLO text. The port runs eager
PyTorch, so :func:`trace_step` runs the step under a dispatch mode and
counts each operator as it is dispatched:

  * **local ops only.** A ``DTensor`` operator is handed back to DTensor
    (the mode returns ``NotImplemented`` for it), which runs the operator on
    the local shards and issues the collectives of its redistributions;
    those come through the mode again and are counted. The operators
    DTensor runs on fake tensors to propagate shardings are not counted.
    So the counts are one device's, as the reference's post-partitioning
    module is;
  * **FLOPs**: matmuls, convolutions and attention by
    ``torch.utils.flop_counter``'s registered formulas (2MNK for a
    matmul); elementwise arithmetic at prod(result) per operation and a
    reduction at prod(operand), as ``hlo_cost.py`` counts them, with the
    fused eager operators (softmax, SiLU and their backwards) at the
    operations they stand for (:data:`ELEMENTWISE`);
  * **bytes**: each operator's operands plus its result; views count 0.
    Eager PyTorch fuses nothing, so this is what eager moves, more than
    XLA's post-fusion bytes (a deliberate divergence, ROADMAP.md);
  * **collectives**: by the reference's kinds, payload max(result,
    operand) (:mod:`repro_torch.perf.collectives`);
  * **live bytes**: every storage an operator creates counts from its
    creation until it is freed, on top of the arguments' storages; the
    peak is the counterpart of the reference's ``memory_analysis()``
    (arguments + temporaries + outputs).

The port loops over layers in Python, so a layer's operators are counted
once per layer: no trip-count multiplication. A kernel wrapper of
``repro_torch.kernels`` that launches a CUDA kernel through ``ctypes`` is
invisible to a dispatch mode, so :func:`trace_step` raises when the
wrappers' launch counters move during the call, rather than count such a
kernel as free.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.perf.collectives import (
    CollectiveStats,
    collective_kind,
    payload_bytes,
    tensor_bytes,
)

__all__ = ["Cost", "StepTrace", "step_cost", "trace_step", "ELEMENTWISE", "REDUCTIONS"]

# eager operator (overload packet name, in-place ``_`` dropped) -> arithmetic
# operations per result element, as the reference counts the HLO the same
# math lowers to (a fused eager operator counts the operations it stands
# for; its reductions count at their operand's size, which is the result's)
ELEMENTWISE = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "maximum": 1, "minimum": 1,
    "pow": 1, "exp": 1, "expm1": 1, "log": 1, "log1p": 1, "log2": 1, "rsqrt": 1,
    "sqrt": 1, "tanh": 1, "neg": 1, "abs": 1, "sign": 1, "floor": 1, "ceil": 1,
    "round": 1, "sigmoid": 1, "cos": 1, "sin": 1, "atan2": 1, "erf": 1,
    "remainder": 1, "reciprocal": 1, "square": 1,
    "addcmul": 2, "addcdiv": 2, "lerp": 2,
    "silu": 2,                        # logistic, multiply
    "softplus": 2,                    # exp, log1p
    "gelu": 8,                        # the tanh form
    "_softmax": 5,                    # max, subtract, exp, sum, divide
    "_log_softmax": 5,                # max, subtract, exp, sum, subtract
    "_softmax_backward_data": 4,      # multiply, sum, subtract, multiply
    "_log_softmax_backward_data": 4,  # exp, sum, multiply, subtract
    "silu_backward": 5,
    "tanh_backward": 3,
    "sigmoid_backward": 3,
    "gelu_backward": 12,
    "threshold_backward": 1,
}
# reductions: prod(operand) each (``mean`` adds its divide on the result)
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum", "cumprod",
              "logsumexp", "var", "std", "norm", "linalg_vector_norm", "any", "all",
              "argmax", "argmin"}
# operators that move no data: views the schema does not mark, factories of
# uninitialised memory
_NO_BYTES = {"_unsafe_view", "view", "alias", "detach", "lift_fresh", "_reshape_alias",
             "empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like",
             "wait_tensor", "_wrap_tensor_autograd"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)

    def __iadd__(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        self.collective_bytes += other.collective_bytes
        for k, v in other.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + v
        return self

    def scaled(self, n: float) -> "Cost":
        return Cost(self.flops * n, self.bytes * n, self.collective_bytes * n,
                    {k: v * n for k, v in self.coll_by_kind.items()})


@dataclasses.dataclass
class StepTrace:
    """What :func:`trace_step` counted in one call of the step."""

    cost: Cost
    collectives: CollectiveStats   # bytes and op counts by kind
    arg_bytes: float               # the arguments' storages (params, state, batch)
    peak_bytes: float              # arguments + the most live bytes at once
    ops: int                       # operators counted
    result: Any
    payload_dtypes: dict = dataclasses.field(default_factory=dict)  # kind -> dtypes


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _tensors(e)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _numel(x) -> float:
    return float(sum(t.numel() for t in _tensors(x)))


def _name(func) -> str:
    """The operator's overload packet name, an in-place ``_`` dropped."""
    name = func.overloadpacket.__name__ if hasattr(func, "overloadpacket") else str(func)
    return name[:-1] if name.endswith("_") else name


def _sharding_propagation() -> bool:
    """Whether the operator runs inside a fake-tensor mode: DTensor's
    sharding propagation on global shapes, not one device's work."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.coll_count: dict = defaultdict(int)
        self.coll_dtypes: dict = defaultdict(set)
        self.ops = 0
        self.live = 0.0
        self.peak = 0.0
        self._seen: set = set()     # storages already counted (their _cdata)
        self._refs: list = []

    def track(self, t: torch.Tensor, initial: bool = False) -> float:
        """Count ``t``'s storage as live until it is freed; its bytes if new."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return 0.0
        self._seen.add(key)
        n = float(st.nbytes())

        def release(_ref, n=0.0 if initial else n, key=key):
            self._seen.discard(key)
            self.live -= n

        self._refs.append(weakref.ref(st, release))
        if not initial:
            self.live += n
            self.peak = max(self.peak, self.live)
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs the local ops, which come back here
        out = func(*args, **kwargs)
        if _sharding_propagation():
            return out
        self.ops += 1
        name = _name(func)
        kind = collective_kind(func)
        c = self.cost
        if kind is not None:
            payload = payload_bytes(args, out)
            c.collective_bytes += payload
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + payload
            self.coll_count[kind] += 1
            self.coll_dtypes[kind].update(str(t.dtype).replace("torch.", "")
                                          for t in _tensors(args))
        else:
            packet = getattr(func, "overloadpacket", None)
            if packet in flop_registry:
                c.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
            elif name in ELEMENTWISE:
                c.flops += ELEMENTWISE[name] * _numel(out)
            elif name in REDUCTIONS:
                c.flops += _numel(args[:1])
                if name == "mean":
                    c.flops += _numel(out)
        if not (getattr(func, "is_view", False) or name in _NO_BYTES):
            c.bytes += tensor_bytes(list(_tensors(args))) + tensor_bytes(list(_tensors(out)))
        for t in _tensors(out):
            self.track(t)
        return out


def _wrappers() -> list:
    """The kernel wrappers that count their CUDA launches."""
    from repro_torch.kernels import (
        covariance,
        decode_attention,
        flash_attention,
        floyd_warshall,
        heat3d,
        lu,
        matmul,
        syr2k,
    )

    return [syr2k.syr2k, matmul.tiled_matmul, covariance.covariance,
            floyd_warshall.minplus_update, floyd_warshall.closure_in_block, heat3d.heat3d,
            lu.lu_factor_diag, flash_attention.flash_attention,
            decode_attention.decode_attention]


def trace_step(fn, *args, **kwargs) -> StepTrace:
    """Run ``fn(*args, **kwargs)`` once under the counter and return what it
    counted (one device's share for DTensor arguments). Raises
    ``RuntimeError`` if a kernel wrapper launched a CUDA kernel inside the
    call: the counter cannot see such a kernel."""
    wrappers = _wrappers()
    before = [w.launches for w in wrappers]
    counter = _Counter()
    arg_bytes = sum(counter.track(_local(t), initial=True)
                    for t in _tensors((args, kwargs)))
    with counter:
        result = fn(*args, **kwargs)
    moved = {w.__name__: w.launches - b for w, b in zip(wrappers, before) if w.launches != b}
    if moved:
        raise RuntimeError(f"kernel wrappers launched inside the counted call: {moved}; "
                           f"a dispatch mode cannot see a kernel launched through ctypes")
    c = counter.cost
    stats = CollectiveStats(dict(c.coll_by_kind), dict(counter.coll_count))
    return StepTrace(cost=c, collectives=stats, arg_bytes=arg_bytes,
                     peak_bytes=arg_bytes + counter.peak, ops=counter.ops, result=result,
                     payload_dtypes={k: sorted(v) for k, v in counter.coll_dtypes.items()})


def step_cost(fn, *args, **kwargs) -> Cost:
    """FLOPs, bytes and collective bytes of one call of ``fn`` per device."""
    return trace_step(fn, *args, **kwargs).cost
