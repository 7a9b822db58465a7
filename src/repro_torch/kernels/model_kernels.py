"""Model-kernel dispatch builders: the serving path's tunable kernels.

The counterpart of ``repro.kernels.model_kernels``: flash attention (``bq``
/``bk`` tiles), decode attention (``bk``/``hg``) and the tiled matmul behind
the model's output projection and tied unembed, each registered in
:mod:`repro_torch.dispatch` with its space. ``repro_torch.models`` reaches
them through the ``service=`` path (``models.attention``,
``models.common.service_matmul``).

The ``impl`` axis keeps the JAX package's values, so tuning-store records
carry over between the packages:

  * ``"pallas"`` — the port's hand-written kernel: the CUDA kernel
    (``csrc/flash_attention.cu``, ``csrc/decode_attention.cu``) for tensors
    on the card, its plain version for tensors on the CPU;
  * ``"xla"`` — the chunked torch variant (:func:`chunked_attention_xla`,
    :func:`~repro_torch.kernels.decode_attention.chunked_decode_xla`), the
    counterpart of the JAX package's XLA fallback. It runs on CPU tensors
    only: on the card it raises :class:`ConfigRejected` (so a store record
    that names it degrades to the kernel), and the ``gpu`` spaces do not
    offer it.

The ``matmul`` builder calls the port's :func:`tiled_matmul`
(``csrc/matmul.cu``) where the JAX package's calls its blocked XLA host mold
(``variants.blocked_matmul_host``); both compute ``x @ w``, and on the card
the knobs (``bm``/``bn``/``bk``/``pack``/``interchange``) change the
generated code. ``pack`` differs in meaning: in ``matmul.cu``
``pack=False`` is a read-modify-write of the output per ``bk`` chunk, in
the mold it only forces operand copies; in f32 the two differ only in
summation order.

Every builder returns a :class:`Variant`: calling it runs the kernel, and its
``check`` runs the wrapper's checks before a launch without launching — the
dispatch service's build guard for store-resolved configs.

Signature scheme (the JAX package's): a flash call is keyed
``((BH, Sq, hd), (BH, Sk, hd), (BH, Sk, hd), (2,))``, the trailing dim the
static ``causal`` flag ((2,) causal, (1,) not); ``BH`` is batch times kv
heads, since the GQA route dispatches per kv-head group.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.kernels.decode_attention import (
    chunked_decode_xla,
    decode_attention,
    decode_attention_check,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_check
from repro_torch.kernels.matmul import tiled_matmul, tiled_matmul_check
from repro_torch.kernels.util import ConfigRejected

__all__ = [
    "Variant", "chunked_attention_xla", "flash_attention_builder", "matmul_builder",
    "decode_attention_builder", "decode_attention_signature",
    "flash_attention_signature", "init_flash_attention", "init_matmul",
    "init_decode_attention", "decode_attention_host",
    "flash_attention_host", "matmul_host", "MODEL_KERNEL_BUILDERS",
    "register_model_kernels",
]

_NEG = -1.0e30


@dataclasses.dataclass(frozen=True)
class Variant:
    """A built dispatch variant: ``variant(*args)`` runs it;
    ``variant.check(*args)`` runs its pre-launch checks (shapes, dtypes,
    shared memory against the device's limit) and launches nothing."""

    fn: Callable
    check: Callable

    def __call__(self, *args):
        return self.fn(*args)


def chunked_attention_xla(
    q: torch.Tensor,            # (BH, Sq, hd) — batch*heads flattened
    k: torch.Tensor,            # (BH, Sk, hd)
    v: torch.Tensor,            # (BH, Sk, hd)
    *,
    causal: bool = True,
    bq: int = 128,
    scale: float | None = None,
) -> torch.Tensor:
    """The materializing variant: per q-chunk full-score softmax in f32.
    Same contract as :func:`~repro_torch.kernels.flash_attention.flash_attention`
    so the two are interchangeable variants under one dispatch entry."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    bq = min(int(bq), Sq)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for q0 in range(0, Sq, bq):
        qblk = q[:, q0:q0 + bq].float()
        s = torch.einsum("bqh,bsh->bqs", qblk, kf) * scale
        if causal:
            qpos = torch.arange(q0, q0 + qblk.shape[1], device=q.device)
            s = torch.where(qpos[None, :, None] >= kpos[None, None, :], s, _NEG)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bqs,bsh->bqh", p, vf).to(q.dtype))
    return torch.cat(outs, dim=1)


def _host_variant(fn: Callable, **tiles) -> Variant:
    """A chunked ``impl="xla"`` variant. Its check: the chunk sizes are
    positive and the operands lie on the CPU; the variant runs the check
    before every call, so it never runs a plain version on the card."""
    def check(*args):
        for name, t in tiles.items():
            if int(t) < 1:
                raise ConfigRejected(f"{name}={t} must be positive")
        for a in args:
            dev = getattr(a, "device", None)
            if dev is not None and dev.type != "cpu":
                raise ConfigRejected(f"impl='xla' is the host variant; on {dev} the "
                                     f"port runs its kernel (impl='pallas')")

    def run(*args):
        check(*args)
        return fn(*args)

    return Variant(run, check)


# ---------------------------------------------------------------------------
# dispatch builders: config (+ static kwargs) -> Variant(*arrays)
# ---------------------------------------------------------------------------


def flash_attention_builder(cfg: Mapping[str, Any], *, causal: bool = True) -> Variant:
    impl = str(cfg.get("impl", "pallas"))
    bq, bk = int(cfg.get("bq", 128)), int(cfg.get("bk", 128))
    if impl == "xla":
        return _host_variant(functools.partial(chunked_attention_xla, causal=causal, bq=bq),
                             bq=bq)
    if impl == "pallas":
        return Variant(functools.partial(flash_attention, causal=causal, bq=bq, bk=bk),
                       functools.partial(flash_attention_check, bq=bq, bk=bk))
    raise ValueError(f"unknown flash_attention impl {impl!r}")


def decode_attention_builder(cfg: Mapping[str, Any], *, ring: bool = False,
                             window: int = 0) -> Variant:
    """Decode-attention variants under one dispatch entry. A ``page`` in
    the config (the host flavour's, the serving benchmark's and the JAX
    package's records carry one) is the paged cache's layout, not the
    kernel's: the builder does not read it (see
    :func:`~repro_torch.kernels.spaces.decode_attention_space`)."""
    impl = str(cfg.get("impl", "pallas"))
    bk, hg = int(cfg.get("bk", 128)), int(cfg.get("hg", 1))
    if impl == "xla":
        return _host_variant(functools.partial(chunked_decode_xla, ring=ring, window=window,
                                               bk=bk), bk=bk)
    if impl == "pallas":
        return Variant(functools.partial(decode_attention, ring=ring, window=window,
                                         bk=bk, hg=hg),
                       functools.partial(decode_attention_check, bk=bk, hg=hg))
    raise ValueError(f"unknown decode_attention impl {impl!r}")


def matmul_builder(cfg: Mapping[str, Any]) -> Variant:
    tiles = dict(bm=int(cfg.get("bm", 128)), bn=int(cfg.get("bn", 128)),
                 bk=int(cfg.get("bk", 128)))
    return Variant(functools.partial(tiled_matmul, **tiles,
                                     interchange=bool(cfg.get("interchange", False)),
                                     pack=bool(cfg.get("pack", False))),
                   functools.partial(tiled_matmul_check, **tiles))


MODEL_KERNEL_BUILDERS = {
    "flash_attention": flash_attention_builder,
    "decode_attention": decode_attention_builder,
    "matmul": matmul_builder,
}


def register_model_kernels() -> None:
    """Register the model kernels into the repro_torch.dispatch registry
    (called lazily by the registry itself, idempotent by construction)."""
    from repro_torch.dispatch.registry import register
    from repro_torch.kernels.spaces import kernel_space

    from repro_torch.kernels.variants import EVAL_REPEATS

    for name, builder in MODEL_KERNEL_BUILDERS.items():
        register(name, builder, space=functools.partial(kernel_space, name),
                 eval_repeats=EVAL_REPEATS)


# ---------------------------------------------------------------------------
# store-signature / problem helpers (offline campaigns, CLI, tests)
# ---------------------------------------------------------------------------


def flash_attention_signature(BH: int, Sq: int, Sk: int, hd: int,
                              causal: bool = True) -> tuple:
    """The signature ``service.dispatch('flash_attention', q, k, v,
    causal=...)`` derives at runtime; the trailing dim is the static
    ``causal`` kwarg folded into the signature ((2,) = causal, (1,) = not —
    the two masking modes must not share tuned records)."""
    return ((BH, Sq, hd), (BH, Sk, hd), (BH, Sk, hd), (2,) if causal else (1,))


def decode_attention_signature(BH: int, G: int, S: int, hd: int,
                               *, ring: bool = False, window: int = 0) -> tuple:
    """The signature ``service.dispatch('decode_attention', q, k, v,
    cur_pos, ring=..., window=...)`` derives at runtime. ``BH`` is batch
    times kv heads, ``S`` the seq bucket; the (BH,) entry is the per-row
    ``cur_pos`` vector; the trailing dims are the static ``ring``/``window``
    kwargs in sorted order ((2,) = ring, (1,) = linear; window clamps to
    (1,) when disabled)."""
    return ((BH, G, hd), (BH, S, hd), (BH, S, hd), (BH,),
            (2,) if ring else (1,), (max(1, int(window)),))


def init_flash_attention(BH: int, Sq: int, Sk: int, hd: int, seed: int = 0):
    """f32 numpy (q, k, v), standard normal."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, Sq, hd), dtype=np.float32)
    k = rng.standard_normal((BH, Sk, hd), dtype=np.float32)
    v = rng.standard_normal((BH, Sk, hd), dtype=np.float32)
    return q, k, v


def init_decode_attention(BH: int, G: int, S: int, hd: int, seed: int = 0):
    """f32 numpy (q, k, v) and int32 cur_pos = S - 1 (a fully resident cache)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, G, hd), dtype=np.float32)
    k = rng.standard_normal((BH, S, hd), dtype=np.float32)
    v = rng.standard_normal((BH, S, hd), dtype=np.float32)
    return q, k, v, np.full((BH,), S - 1, np.int32)


def init_matmul(M: int, K: int, N: int, seed: int = 0):
    """f32 numpy (a, b), scaled by 1/sqrt(K) and 1/sqrt(N) as the JAX
    package's ``init_matmul`` does."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K), dtype=np.float32) / np.float32(np.sqrt(K))
    b = rng.standard_normal((K, N), dtype=np.float32) / np.float32(np.sqrt(N))
    return a, b


def flash_attention_host(problem):
    def factory(cfg):
        return flash_attention_builder(cfg), problem

    return factory


def decode_attention_host(problem):
    def factory(cfg):
        return decode_attention_builder(cfg), problem

    return factory


def matmul_host(problem):
    def factory(cfg):
        return matmul_builder(cfg), problem

    return factory
