"""PolyBench dispatch builders: the paper's six benchmarks as dispatch
variants — the counterpart of ``repro.kernels.variants``'s
``DISPATCH_BUILDERS``, ``*_host`` factories and
``register_dispatch_variants``.

Each builder takes a configuration (the schema of ``spaces.py``, either
flavour) and returns a :class:`~repro_torch.kernels.model_kernels.Variant`:

  * calling it runs the port's wrapper through ``ops.*_op`` with the
    config: on CUDA tensors the hand-written kernel (``csrc/*.cu``), on CPU
    tensors its plain version;
  * its ``check`` runs the wrapper's checks before a launch (the
    ``*_check`` beside each wrapper) and launches nothing: the dispatch
    service's build guard for store-resolved configs.

The JAX package's builders return blocked XLA programs timed on the host
(its "molds", ``blocked_matmul_host``, ``syr2k_variant``, ...); here the
tuned program is the CUDA kernel itself, so no mold is ported. The builders
cast their tiles to ``int`` as the JAX package's ``_ints`` does, so a
record whose tile is not an integer fails at build time (``ValueError``),
where the service degrades it.

syr2k takes ``alpha=1.5, beta=1.2`` as the JAX package's builder does;
heat3d's ``tsteps`` is a static keyword of the dispatch call (it folds into
the signature), 8 by default as there.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Mapping

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.covariance import covariance_check
from repro_torch.kernels.floyd_warshall import floyd_warshall_check
from repro_torch.kernels.heat3d import heat3d_check
from repro_torch.kernels.lu import lu_check
from repro_torch.kernels.matmul import matmul_tile_check, tiled_matmul_check
from repro_torch.kernels.model_kernels import Variant
from repro_torch.kernels.syr2k import syr2k_check

__all__ = [
    "syr2k_builder", "mm3_builder", "lu_builder", "heat3d_builder", "covariance_builder",
    "floyd_warshall_builder", "DISPATCH_BUILDERS", "register_dispatch_variants",
    "syr2k_host", "mm3_host", "lu_host", "heat3d_host", "covariance_host",
    "floyd_warshall_host", "HOST_VARIANTS", "naive_fns",
]

# timed runs per background-campaign evaluation (the minimum is the
# objective). The JAX package times one; on the card a campaign's runs share
# the device with serving, and the minimum of three keeps a run that waited
# on serving kernels out of the store
EVAL_REPEATS = 3

_TILES = {"syr2k": ("bi", "bj", "bk"), "mm3": ("bm", "bn", "bk"), "lu": ("bs", "bm", "bn"),
          "heat3d": ("bi", "fuse_t"), "covariance": ("bi", "bj", "bk"),
          "floyd_warshall": ("bs", "bi", "bj", "unroll")}


def _config(name: str, cfg: Mapping[str, Any]) -> dict:
    """The wrapper's knobs for ``cfg`` (``ops.config_of``), tiles as ints."""
    kw = ops.config_of(name, cfg)
    for t in _TILES[name]:
        kw[t] = int(kw[t])
    return kw


def syr2k_builder(cfg: Mapping[str, Any]) -> Variant:
    kw = _config("syr2k", cfg)
    return Variant(functools.partial(ops.syr2k_op, alpha=1.5, beta=1.2, config=kw),
                   functools.partial(syr2k_check, bi=kw["bi"], bj=kw["bj"], bk=kw["bk"],
                                     pack_a=kw["pack_a"], pack_b=kw["pack_b"]))


def mm3_builder(cfg: Mapping[str, Any]) -> Variant:
    kw = _config("mm3", cfg)
    tiles = dict(bm=kw["bm"], bn=kw["bn"], bk=kw["bk"])

    def check(A, B, C, D):
        tiled_matmul_check(A, B, **tiles)
        tiled_matmul_check(C, D, **tiles)
        # the third product, E (P x R) @ F (R x T), in the middle dtype
        matmul_tile_check(A.shape[0], B.shape[1], D.shape[1], **tiles,
                          dtype=torch.float32 if kw["fuse_second"] else A.dtype,
                          device=A.device)

    return Variant(functools.partial(ops.mm3_op, config=kw), check)


def lu_builder(cfg: Mapping[str, Any]) -> Variant:
    kw = _config("lu", cfg)
    return Variant(functools.partial(ops.lu_op, config=kw),
                   functools.partial(lu_check, bs=kw["bs"], bm=kw["bm"], bn=kw["bn"]))


def heat3d_builder(cfg: Mapping[str, Any], tsteps: int = 8) -> Variant:
    kw = _config("heat3d", cfg)
    tsteps = int(tsteps)

    def check(A):
        heat3d_check(A, tsteps, bi=kw["bi"], fuse_t=kw["fuse_t"])

    return Variant(lambda A: ops.heat3d_op(A, tsteps, config=kw), check)


def covariance_builder(cfg: Mapping[str, Any]) -> Variant:
    kw = _config("covariance", cfg)
    return Variant(functools.partial(ops.covariance_op, config=kw),
                   functools.partial(covariance_check, bi=kw["bi"], bj=kw["bj"], bk=kw["bk"]))


def floyd_warshall_builder(cfg: Mapping[str, Any]) -> Variant:
    kw = _config("floyd_warshall", cfg)
    return Variant(functools.partial(ops.floyd_warshall_op, config=kw),
                   functools.partial(floyd_warshall_check, bs=kw["bs"], bi=kw["bi"],
                                     bj=kw["bj"], unroll=kw["unroll"]))


DISPATCH_BUILDERS = {
    "syr2k": syr2k_builder,
    "mm3": mm3_builder,
    "lu": lu_builder,
    "heat3d": heat3d_builder,
    "covariance": covariance_builder,
    "floyd_warshall": floyd_warshall_builder,
}


def register_dispatch_variants() -> None:
    """Register the PolyBench kernels into the repro_torch.dispatch registry
    (called lazily by the registry itself, idempotent by construction)."""
    from repro_torch.dispatch.registry import register
    from repro_torch.kernels.spaces import kernel_space

    for name, builder in DISPATCH_BUILDERS.items():
        register(name, builder, space=functools.partial(kernel_space, name),
                 eval_repeats=EVAL_REPEATS)


# ---------------------------------------------------------------------------
# factories: problem -> (factory(config) -> (variant, args)) for TimingEvaluator
# ---------------------------------------------------------------------------


def _host_factory(builder: Callable, problem: tuple, **static_kw) -> Callable:
    def factory(cfg):
        return builder(cfg, **static_kw), problem

    return factory


def syr2k_host(problem):
    return _host_factory(syr2k_builder, problem)


def mm3_host(problem):
    return _host_factory(mm3_builder, problem)


def lu_host(problem):
    return _host_factory(lu_builder, problem)


def heat3d_host(problem, tsteps):
    return _host_factory(heat3d_builder, problem, tsteps=tsteps)


def covariance_host(problem):
    return _host_factory(covariance_builder, problem)


def floyd_warshall_host(problem):
    return _host_factory(floyd_warshall_builder, problem)


HOST_VARIANTS = {
    "syr2k": syr2k_host,
    "mm3": mm3_host,
    "lu": lu_host,
    "heat3d": heat3d_host,
    "covariance": covariance_host,
    "floyd_warshall": floyd_warshall_host,
}


def naive_fns() -> dict[str, Callable]:
    """The untransformed loop nests (the paper's "gcc -O3 on the original
    code" row), the counterpart of ``repro.kernels.variants.naive_fns``: a
    Python loop over rows, one torch vector-matrix product a row, neither
    tiled nor handed to a library's matrix product whole. lu, heat3d and
    Floyd-Warshall take their ``ref`` functions, as the JAX package's do.
    Only the benchmark tables call these; they are no dispatch variant."""

    def matvec_rows(a, b):
        out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
        for i in range(a.shape[0]):
            out[i] = a[i] @ b
        return out

    def syr2k(C, A, B):
        out = torch.empty_like(C)
        for i in range(A.shape[0]):
            out[i] = 1.5 * (A[i] @ B.T) + 1.5 * (B[i] @ A.T) + 1.2 * C[i]
        return out

    def mm3(A, B, C, D):
        return matvec_rows(matvec_rows(A, B), matvec_rows(C, D))

    def covariance(data):
        n, m = data.shape
        c = data - data.mean(0, keepdim=True)
        out = torch.empty((m, m), dtype=data.dtype, device=data.device)
        for i in range(m):
            out[i] = c[:, i] @ c / (n - 1.0)
        return out

    return {
        "syr2k": syr2k,
        "mm3": mm3,
        "lu": ref.lu_ref,
        "heat3d": ref.heat3d_ref,
        "covariance": covariance,
        "floyd_warshall": ref.floyd_warshall_ref,
    }
