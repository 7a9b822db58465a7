"""Shape signatures: the key half of the tuning store's ``(kernel, shape,
backend)`` addressing scheme.

A signature is a tuple of per-argument dimension tuples — ``((1200, 1000),)``
for syr2k's ``A``, ``((64, 64), (8,))`` for an array plus a static scalar
knob. Two signatures are *compatible* when their nested structure matches
(same arity, same ranks); distance between compatible signatures is the RMS
of log-ratios over corresponding dimensions, so 128→256 is "one doubling
away" regardless of whether the dim is 8 or 8192. That log-scale metric is
what lets an unseen shape resolve to the closest tuned configuration instead
of a naive default: tile-size landscapes are scale-free in the problem dims.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Sequence

__all__ = [
    "ShapeSignature",
    "shape_signature",
    "signature_key",
    "parse_signature_key",
    "compatible",
    "signature_distance",
    "bucket_signature",
]

# one inner tuple of positive ints per runtime argument
ShapeSignature = tuple

def _arg_dims(arg: Any) -> tuple:
    shape = getattr(arg, "shape", None)
    if shape is not None:
        return tuple(int(d) for d in shape)
    if isinstance(arg, bool):
        # bools must stay distinguishable: max(1, int(·)) would collapse
        # True and False onto the same dim (e.g. causal/non-causal attention)
        return (2 if arg else 1,)
    if isinstance(arg, (int, float)):
        return (max(1, int(arg)),)  # static scalar knobs (e.g. tsteps) count as a dim
    if isinstance(arg, (tuple, list)):
        return tuple(max(1, int(d)) for d in arg)
    raise TypeError(f"cannot derive a shape signature from {type(arg).__name__}")


def shape_signature(args: Iterable[Any]) -> ShapeSignature:
    """Signature of a runtime argument list (arrays, ints, or dim tuples)."""
    return tuple(_arg_dims(a) for a in args)


def signature_key(sig: ShapeSignature) -> str:
    """Canonical string form used as the JSON/store key, e.g. ``1200x1000;8``."""
    return ";".join("x".join(str(int(d)) for d in dims) for dims in sig)


def parse_signature_key(key: str) -> ShapeSignature:
    if not key:
        return ()
    return tuple(tuple(int(d) for d in part.split("x")) for part in key.split(";"))


def _flat(sig: ShapeSignature) -> list:
    return [d for dims in sig for d in dims]


def compatible(a: ShapeSignature, b: ShapeSignature) -> bool:
    return tuple(len(dims) for dims in a) == tuple(len(dims) for dims in b)


def signature_distance(a: ShapeSignature, b: ShapeSignature) -> float:
    """RMS log2-ratio over dims; ``inf`` for structurally incompatible sigs.

    0.0 = identical; 1.0 = every dim off by a factor of two on average."""
    if not compatible(a, b):
        return math.inf
    fa, fb = _flat(a), _flat(b)
    if not fa:
        return 0.0
    sq = sum((math.log2(max(x, 1)) - math.log2(max(y, 1))) ** 2 for x, y in zip(fa, fb))
    return math.sqrt(sq / len(fa))


def bucket_signature(sig: ShapeSignature, base: float = 2.0) -> ShapeSignature:
    """Round every dim to the nearest power of ``base`` — collapses near-equal
    shapes onto one store key so serving traffic with jittery batch sizes
    doesn't fragment the store."""

    def snap(d: int) -> int:
        if d <= 1:
            return 1
        return int(round(base ** round(math.log(d, base))))

    return tuple(tuple(snap(d) for d in dims) for dims in sig)
