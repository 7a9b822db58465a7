"""Flash attention forward: online-softmax attention over (BH, S, hd) rows,
the prefill kernel of the serving path.

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` for tensors on the card, and takes the plain
PyTorch version :func:`flash_attention_plain` only for tensors on the CPU.
Same contract as ``repro.kernels.flash_attention.flash_attention``:

  * ``q`` (BH, Sq, hd), ``k``/``v`` (BH, Sk, hd), batch*heads flattened;
  * ``causal`` masks key positions after the query position (both counted
    from 0); keys at or past Sk are masked (the kernel masks the ragged edge
    instead of padding);
  * f32 math whatever the input dtype (f32 or bf16 on the card); the output
    is ``acc / max(l, 1e-30)`` in the input dtype;
  * ``bq``/``bk`` -> the query tile and the key block of the online-softmax
    loop; clamped to the sequence lengths (rounded up to the kernel's
    16-row step);
  * every head size on the card (the CPU takes any): up to 256 the kernel is
    instantiated for 16, 32, 64, 128 and 256, and another size runs at the
    next of them; past 256 at the next multiple of 64, in column groups of
    256 output columns, one block each, every block computing the full
    scores in chunks of 128 columns (:func:`flash_attention_head_size`). q,
    k and v are zero-padded along hd inside the wrapper and the output
    sliced back. The padded columns come after the real ones in every dot
    product, so they add only exact ``+0*0`` terms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.util import (
    ConfigRejected,
    cdiv,
    check_operand,
    max_shared_memory_per_block,
)

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_smem_bytes",
           "flash_attention_check", "flash_attention_head_size"]

_NEG = -1.0e30
DTYPES = (torch.float32, torch.bfloat16)
STEP = 16  # the kernel's tiles: multiples of 16 keys (a half-warp) and query rows
HEAD_SIZES = (16, 32, 64, 128, 256)  # the kernel's instantiations
WIDE_STEP = 64      # past 256: head sizes run at the next multiple of 64


def flash_attention_head_size(hd: int) -> int:
    """The head size a head size ``hd`` runs at on the card (the wrapper
    zero-pads up to it): the smallest of :data:`HEAD_SIZES` not below it,
    and past 256 the next multiple of 64, run in ``ceil(size / 256)``
    column groups. Raises :class:`ConfigRejected` below 1."""
    if hd < 1:
        raise ConfigRejected(f"flash_attention hd={hd}: head sizes start at 1")
    if hd <= HEAD_SIZES[-1]:
        return next(h for h in HEAD_SIZES if hd <= h)
    return -(-hd // WIDE_STEP) * WIDE_STEP


def flash_attention_smem_bytes(bq: int, bk: int, hd: int, dtype: torch.dtype = torch.float32,
                               limit: int | None = None) -> int:
    """Dynamic shared memory (bytes) one block of ``csrc/flash_attention.cu``
    needs for this tile, head size (run at :func:`flash_attention_head_size`)
    and input ``dtype`` (staged as it is) under a per-block ``limit``
    (default: the current card's), or -1 for a tile or head size the kernel
    does not take. The kernel's ring takes two stages where they fit the
    limit, else one, so a result above it means even one stage does not fit.
    The kernel's own layout answers, so the library is built first."""
    if limit is None:
        limit = max_shared_memory_per_block(torch.device("cuda"))
    try:
        hd = flash_attention_head_size(hd)
    except ConfigRejected:
        return -1
    return build.load("flash_attention").flash_attention_smem_bytes(
        bq, bk, hd, int(dtype == torch.bfloat16), int(limit))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """The plain version: the same masked softmax in dense f32 PyTorch ops,
    with the kernel's zeroed masked probabilities and ``max(l, 1e-30)``."""
    Sq, hd = q.shape[1], q.shape[2]
    Sk = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    s = torch.einsum("bqh,bsh->bqs", q.float(), k.float()) * scale
    if causal:
        valid = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Sk, device=q.device)
    else:
        valid = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    s = torch.where(valid, s, _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    o = torch.einsum("bqs,bsh->bqh", p, v.float()) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.to(q.dtype)


def _tiles(Sq: int, Sk: int, bq: int, bk: int) -> tuple[int, int]:
    if int(bq) < 1 or int(bk) < 1:
        raise ConfigRejected(f"flash_attention tiles must be positive, got bq={bq} bk={bk}")
    return min(int(bq), cdiv(Sq, STEP) * STEP), min(int(bk), cdiv(Sk, STEP) * STEP)


def flash_attention_check(q, k, v, *, bq: int = 128, bk: int = 128) -> tuple[int, int]:
    """The wrapper's checks before a launch, without launching: operands
    (shape, dtype, device, contiguity) and, on the card, the tile's shared
    memory against the device's limit. Raises :class:`ConfigRejected` for a
    tile the kernel cannot run; returns the clamped ``(bq, bk)``."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention takes (BH, S, hd) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    bq, bk = _tiles(Sq, Sk, bq, bk)
    if q.device.type == "cpu":
        return bq, bk
    dev = q.device
    check_operand("q", q, (BH, Sq, hd), DTYPES, dev)
    check_operand("k", k, (BH, Sk, hd), (q.dtype,), dev)
    check_operand("v", v, (BH, Sk, hd), (q.dtype,), dev)
    flash_attention_head_size(hd)  # raises for a head size below 1
    limit = max_shared_memory_per_block(dev)
    smem = flash_attention_smem_bytes(bq, bk, hd, q.dtype, limit)
    if smem < 0:
        raise ConfigRejected(f"flash_attention bq={bq} bk={bk} hd={hd}: the kernel takes "
                             f"tiles that are multiples of {STEP} up to 128")
    if smem > limit:
        raise ConfigRejected(f"flash_attention bq={bq} bk={bk} hd={hd} needs {smem} B of "
                             f"shared memory, the device allows {limit} B per block")
    return bq, bk


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    bq: int = 128,
    bk: int = 128,
    scale: float | None = None,
) -> torch.Tensor:
    bq, bk = flash_attention_check(q, k, v, bq=bq, bk=bk)
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)

    dev = q.device
    hdk = flash_attention_head_size(hd)
    out = torch.empty((BH, Sq, hdk), dtype=q.dtype, device=dev)
    lib = build.load("flash_attention")
    with torch.cuda.device(dev):
        # the host's work before the first mark (as decode_attention)
        stream = torch.cuda.current_stream(dev).cuda_stream
        smem = max_shared_memory_per_block(dev)
        build.mark_launch()  # the call's device work starts with the padding
        if hdk != hd:  # zero columns after the real ones: exact +0*0 terms
            q, k, v = (F.pad(t, (0, hdk - hd)) for t in (q, k, v))
        build.mark_launch()
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq, Sk, hdk,
            bq, bk, float(scale), int(causal), int(q.dtype == torch.bfloat16), smem, stream)
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    if hdk != hd:
        out = out[..., :hd].contiguous()
        build.mark_end()  # the call's device work ends with the copy out
    return out


flash_attention.launches = 0  # kernel launches since the last reset (chip_smoke reads it)
