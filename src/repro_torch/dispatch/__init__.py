"""repro_torch.dispatch — tuning store + runtime kernel dispatch.

The counterpart of ``repro.dispatch``: a persistent :class:`TuningStore` of
best-known configs keyed by ``(kernel, shape-signature, backend)``,
nearest-neighbor resolution for shapes no campaign ever saw, a
:func:`dispatch` runtime API with an in-process executable cache, and
background BO campaigns (:class:`BackgroundTuner`, warm-started from the
store) that hot-swap better configs in as they land. The store, signatures,
lookup, registry and background tuner are copies of the JAX package's
modules (the registry holds the PolyBench and the model kernels); the
service is rewritten for eager PyTorch.

    from repro_torch import dispatch
    svc = dispatch.configure("results/store",
                             tuner=dispatch.BackgroundTuner(dispatch.TuningStore("results/store")))
    out = svc.call("flash_attention", q, k, v, causal=True)
"""

from repro_torch.dispatch.background import BackgroundTuner
from repro_torch.dispatch.lookup import Resolution, resolve
from repro_torch.dispatch.registry import VariantSpec, get, register, registered
from repro_torch.dispatch.service import (
    DispatchService,
    call,
    configure,
    dispatch,
    get_service,
)
from repro_torch.dispatch.signature import (
    ShapeSignature,
    bucket_signature,
    compatible,
    parse_signature_key,
    shape_signature,
    signature_distance,
    signature_key,
)
from repro_torch.dispatch.store import TuningRecord, TuningStore

__all__ = [
    "BackgroundTuner",
    "DispatchService",
    "Resolution",
    "ShapeSignature",
    "TuningRecord",
    "TuningStore",
    "VariantSpec",
    "bucket_signature",
    "call",
    "compatible",
    "configure",
    "dispatch",
    "get",
    "get_service",
    "parse_signature_key",
    "register",
    "registered",
    "resolve",
    "shape_signature",
    "signature_distance",
    "signature_key",
]
