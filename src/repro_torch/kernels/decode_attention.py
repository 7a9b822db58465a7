"""Decode attention: one new token's G query heads per cache row against a
filled KV cache, with per-row positions — the serving path's per-token
kernel.

:func:`decode_attention` launches the hand-written CUDA kernel
``csrc/decode_attention.cu`` for tensors on the card, and takes the plain
PyTorch version :func:`decode_attention_plain` only for tensors on the CPU.
Same contract as ``repro.kernels.decode_attention.decode_attention``:

  * ``q`` (BH, G, hd) — batch*kv_heads rows, G query heads each;
  * ``k``/``v`` (BH, S, hd) — S is the seq bucket — or a :class:`CacheRows`
    view of the model's (B, S, K, hd) cache, whose row ``r`` is
    ``(r // K, r % K)``: the kernel reads it in place, where the JAX
    package's ``transpose(0, 2, 1, 3).reshape`` would copy the whole cache
    of every layer at every token in PyTorch;
  * ``cur_pos`` (BH,) int32 per-row positions (a scalar broadcasts);
  * ``ring``/``window`` — the mask is ``_decode_mask``'s; masked slots get
    ``p = 0``, so a row with ``cur_pos = -1`` returns exactly 0;
  * ``bk`` -> the KV block of the online-softmax loop: the kernel splits the
    key axis across blocks in whole ``bk`` blocks (:func:`decode_attention_plan`),
    ``hg`` -> how many rows one block of the kernel walks;
  * every head size on the card (the CPU takes any): up to 256 the kernel
    is instantiated for the multiples of 16, and another size runs at the
    next of them with the cache's loads masked past hd (zeros land in
    shared memory; the cache is read in place, never padded by a copy), and
    only the hd real output columns stored; past 256 one launch covers the
    head in column groups of 256 (a grid dimension: each block computes the
    full scores, hd in chunks of 256, and P V for its own columns of V,
    :func:`decode_attention_column_groups`); a G past the heads one launch
    takes (8 * 256 / round_up(hd, 16) up to 256, past it 8 or as many as
    keep q's rows within 64 KB) is split into groups of heads that fit, one
    launch each (:func:`decode_attention_head_groups`).

Also here, as torch functions: :func:`chunked_decode_xla` (the JAX package's
``impl="xla"`` variant: the same recurrence over ``bk`` chunks in tensor
ops) and :func:`decode_ref` (the dense oracle, softmax over the masked
scores as the JAX package writes it).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.util import (
    ConfigRejected,
    check_operand,
    max_shared_memory_per_block,
)

__all__ = ["CacheRows", "decode_attention", "decode_attention_plain",
           "decode_attention_smem_bytes", "decode_attention_check",
           "decode_attention_plan", "decode_attention_head_groups",
           "decode_attention_column_groups", "chunked_decode_xla", "decode_ref", "decode_mask"]

_NEG = -1.0e30
DTYPES = (torch.float32, torch.bfloat16)
HEAD_STEP, MAX_HEAD = 16, 256  # the kernel's instantiations: multiples of 16 up to 256
HEADS_PER_LAUNCH = 8 * 256     # G * hd of one launch at most (8 heads a thread, 256 threads)
COLUMN_GROUP = 256             # past 256: the columns of V and O one block takes
WIDE_HEADS = 8                 # past 256: heads one launch takes at most
WIDE_Q_FLOATS = 16384          # past 256: q's staged rows of one launch, f32 (64 KB)


def decode_attention_column_groups(hd: int) -> int:
    """Column groups of V and O a launch covers for head size ``hd``: 1 up
    to 256, else ``ceil(round_up(hd, 16) / 256)``, one block each."""
    hdp = -(-hd // HEAD_STEP) * HEAD_STEP
    return 1 if hdp <= MAX_HEAD else -(-hdp // COLUMN_GROUP)


def decode_attention_head_groups(G: int, hd: int) -> list[tuple[int, int]]:
    """The query heads ``[g0, g1)`` of each launch for G heads of size hd:
    one group where G fits the kernel, else the fewest groups that fit, as
    equal as can be. One launch takes 8 * 256 / round_up(hd, 16) heads up to
    256 (the instantiation ``round_up(hd, 16)``), past it 8, or as many as
    keep q's staged rows within 64 KB. Raises :class:`ConfigRejected` for a
    head size below 1, or one whose single q row does not fit."""
    if hd < 1:
        raise ConfigRejected(f"decode_attention hd={hd}: head sizes start at 1")
    if G < 1:
        raise ValueError(f"decode_attention needs at least one query head, got G={G}")
    hdp = -(-hd // HEAD_STEP) * HEAD_STEP
    if hdp <= MAX_HEAD:
        fit = HEADS_PER_LAUNCH // hdp
    else:
        fit = min(WIDE_HEADS, WIDE_Q_FLOATS // (hdp + 4))
        if fit < 1:
            raise ConfigRejected(f"decode_attention hd={hd}: one q row past {WIDE_Q_FLOATS} "
                                 f"floats does not fit the block's shared memory")
    n = -(-G // fit)
    return [(i * G // n, (i + 1) * G // n) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class CacheRows:
    """The (B*K, S, hd) row view of a (B, S, K, hd) KV cache, row ``b*K + k``
    at ``cache[b, :, k]``. PyTorch cannot express it as one strided tensor,
    so it stays a view the kernel addresses itself; ``shape`` is the row
    layout's, so dispatch signatures match the JAX package's."""

    cache: torch.Tensor  # (B, S, K, hd)

    @property
    def shape(self) -> tuple[int, int, int]:
        B, S, K, hd = self.cache.shape
        return (B * K, S, hd)

    def rows(self) -> torch.Tensor:
        """A (B*K, S, hd) tensor of the rows (a copy)."""
        B, S, K, hd = self.cache.shape
        return self.cache.permute(0, 2, 1, 3).reshape(B * K, S, hd)


def _rows(x) -> torch.Tensor:
    return x.rows() if isinstance(x, CacheRows) else x


def _positions(cur_pos, BH: int, device) -> torch.Tensor:
    if isinstance(cur_pos, int):  # no host-device copy, no synchronisation
        return torch.full((BH,), cur_pos, dtype=torch.int32, device=device)
    cp = torch.as_tensor(cur_pos, dtype=torch.int32, device=device).reshape(-1)
    if cp.shape[0] == 1 and BH > 1:
        cp = cp.expand(BH)
    if cp.shape[0] != BH:
        raise ValueError(f"cur_pos has {cp.shape[0]} rows, expected {BH}")
    return cp.contiguous()


def decode_mask(slots: torch.Tensor, cp: torch.Tensor, *, s_real: int, ring: bool,
                window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_decode_mask`` of the JAX package: (kpos, valid) for int cache-slot
    indices ``slots`` and per-row positions ``cp`` (broadcastable)."""
    if ring:
        kpos = cp - torch.remainder(cp - slots, s_real)  # floor mod, as jnp.mod
    else:
        kpos = torch.broadcast_to(slots, torch.broadcast_shapes(slots.shape, cp.shape))
    valid = (slots < s_real) & (kpos >= 0) & (kpos <= cp)
    if window > 0:
        valid = valid & ((cp - kpos) < window)
    return kpos, valid


def decode_attention_smem_bytes(G: int, bk: int, hd: int,
                                dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory (bytes) one block of ``csrc/decode_attention.cu``
    needs for (G, bk, hd) and the cache's ``dtype``, or -1 for what the
    kernel does not take. The kernel's own layout answers, so the library is
    built first."""
    return build.load("decode_attention").decode_attention_smem_bytes(
        G, bk, hd, int(dtype == torch.bfloat16))


def decode_attention_plan(BH: int, G: int, S: int, hd: int, bk: int, hg: int,
                          device: torch.device) -> tuple[int, int]:
    """``(nsplit, workspace bytes)`` of a launch: the key axis split into
    whole ``bk`` blocks for about four blocks per SM of ``device`` (at most
    32 splits), from the shapes alone (never ``cur_pos``, which lives on the
    device), and the f32 partials of the splits (0 for one split). The
    kernel library answers; the answer is cached per shape and device, since
    the wrapper asks at every decode step."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _plan(BH, G, S, hd, bk, hg, index)


@functools.lru_cache(maxsize=1024)
def _plan(BH: int, G: int, S: int, hd: int, bk: int, hg: int, index: int) -> tuple[int, int]:
    lib = build.load("decode_attention")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    nsplit = lib.decode_attention_splits(BH, S, bk, hg, sms)
    return nsplit, lib.decode_attention_workspace_bytes(BH, G, hd, nsplit)


# (device index, stream) -> (f32 partials, int32 arrival counters). The kernel
# leaves every counter at 0, so a buffer serves every later launch on its
# stream; one stream's launches run in order, so they may share it.
_WORKSPACES: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(dev: torch.device, stream: int, nbytes: int,
               groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    ws, counters = _WORKSPACES.get(key, (None, None))
    if ws is None or ws.numel() * 4 < nbytes:
        ws = torch.empty((nbytes + 3) // 4, dtype=torch.float32, device=dev)
    if counters is None or counters.numel() < groups:
        counters = torch.zeros(groups, dtype=torch.int32, device=dev)
    _WORKSPACES[key] = (ws, counters)
    return ws, counters


def decode_attention_plain(q, k, v, cur_pos, *, ring: bool = False, window: int = 0,
                           scale: float | None = None) -> torch.Tensor:
    """The plain version: the masked online-softmax result in dense f32
    PyTorch ops — scores masked, ``p`` zeroed on masked slots, and
    ``acc / max(l, 1e-30)``, so a fully masked row is 0 as in the kernel."""
    k, v = _rows(k), _rows(v)
    BH, G, hd = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    cp = _positions(cur_pos, BH, q.device).reshape(BH, 1, 1)
    s = torch.einsum("bgh,bsh->bgs", q.float(), k.float()) * scale
    slots = torch.arange(S, dtype=torch.int32, device=q.device).reshape(1, 1, S)
    _, valid = decode_mask(slots, cp, s_real=S, ring=ring, window=int(window or 0))
    s = torch.where(valid, s, _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    o = torch.einsum("bgs,bsh->bgh", p, v.float()) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.to(q.dtype)


def decode_attention_check(q, k, v, cur_pos=None, *, bk: int = 128,
                           hg: int = 1) -> tuple[int, int]:
    """The wrapper's checks before a launch, without launching: operands
    (shape, dtype, device, contiguity) and, on the card, the block's shared
    memory against the device's limit. Raises :class:`ConfigRejected` for a
    configuration the kernel cannot run; returns the clamped ``(bk, hg)``.
    Takes the launch's arguments; ``cur_pos`` is read at launch only. The
    shared memory is that of the largest group of heads one launch takes."""
    BH, G, hd = q.shape
    S = k.shape[1]
    if int(bk) < 1 or int(hg) < 1:
        raise ConfigRejected(f"decode_attention bk={bk} hg={hg} must be positive")
    bk, hg = min(int(bk), S), min(int(hg), BH)
    if tuple(k.shape) != (BH, S, hd) or tuple(v.shape) != (BH, S, hd):
        raise ValueError(f"decode_attention k/v rows {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return bk, hg
    dev = q.device
    check_operand("q", q, (BH, G, hd), DTYPES, dev)
    for name, t in (("k", k), ("v", v)):
        t = t.cache if isinstance(t, CacheRows) else t
        check_operand(name, t, tuple(t.shape), (q.dtype,), dev)
    Gl = max(g1 - g0 for g0, g1 in decode_attention_head_groups(G, hd))
    smem = decode_attention_smem_bytes(Gl, bk, hd, q.dtype)
    if smem < 0:
        raise ConfigRejected(f"decode_attention G={G} bk={bk} hd={hd}: the kernel takes bk "
                             f"up to 256 (and {Gl} heads a launch at most)")
    limit = max_shared_memory_per_block(dev)
    if smem > limit:
        raise ConfigRejected(f"decode_attention G={G} bk={bk} hd={hd} needs {smem} B of "
                             f"shared memory, the device allows {limit} B per block")
    return bk, hg


def decode_attention(
    q: torch.Tensor,
    k,
    v,
    cur_pos,
    *,
    ring: bool = False,
    window: int = 0,
    bk: int = 128,
    hg: int = 1,
    scale: float | None = None,
) -> torch.Tensor:
    """One-token attention against a filled cache, per-row positions."""
    bk, hg = decode_attention_check(q, k, v, cur_pos, bk=bk, hg=hg)
    BH, G, hd = q.shape
    S = k.shape[1]
    window = int(window or 0)
    scale = scale if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, cur_pos, ring=ring, window=window, scale=scale)

    dev = q.device
    if isinstance(k, CacheRows) != isinstance(v, CacheRows):
        raise TypeError("decode_attention: k and v must share one layout")
    if isinstance(k, CacheRows):
        if k.cache.stride() != v.cache.stride():
            raise ValueError("decode_attention: k and v caches must share their strides")
        Kh = k.cache.shape[2]
        sb, ss, sh, _ = k.cache.stride()
        kt, vt = k.cache, v.cache
    else:
        Kh, (sb, ss, _), sh = 1, k.stride(), 0
        kt, vt = k, v
    out = torch.empty((BH, G, hd), dtype=q.dtype, device=dev)
    lib = build.load("decode_attention")
    esize = q.element_size()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # one launch per group of heads, each reading and writing its heads
        # of every row in place (rows of G heads). The host plans every
        # launch before the first mark: a timed call's lead spin then covers
        # only the positions and the launcher's own path, and a slow host
        # leaves no idle gap in the call's device time.
        plans = []
        for g0, g1 in decode_attention_head_groups(G, hd):
            nsplit, ws_bytes = decode_attention_plan(BH, g1 - g0, S, hd, bk, hg, dev)
            plans.append((g0, g1 - g0, nsplit) + _workspace(
                dev, stream, ws_bytes, -(-BH // hg) * decode_attention_column_groups(hd)))
        build.mark_launch()  # the call's device work starts with the positions
        cp = _positions(cur_pos, BH, dev)
        for g0, Gg, nsplit, ws, counters in plans:
            build.mark_launch()
            err = lib.decode_attention_launch(
                q.data_ptr() + g0 * hd * esize, kt.data_ptr(), vt.data_ptr(), cp.data_ptr(),
                out.data_ptr() + g0 * hd * esize, ws.data_ptr(), counters.data_ptr(), BH, Gg,
                S, hd, Kh, sb, ss, sh, G, bk, hg, nsplit, int(bool(ring)), window,
                float(scale), int(q.dtype == torch.bfloat16), stream)
            build.check(lib, err, "decode_attention")
            decode_attention.launches += 1
    return out


decode_attention.launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def chunked_decode_xla(q, k, v, cur_pos, *, ring: bool = False, window: int = 0,
                       bk: int = 128, scale: float | None = None) -> torch.Tensor:
    """The JAX package's ``impl="xla"`` variant: the same contract and the
    same online-softmax recurrence, over ``bk``-length cache chunks in torch
    tensor ops (interchangeable with :func:`decode_attention` under one
    dispatch entry)."""
    k, v = _rows(k), _rows(v)
    BH, G, hd = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    bk = max(1, min(int(bk), S))
    cp = _positions(cur_pos, BH, q.device).reshape(BH, 1, 1)
    window = int(window or 0)
    qf = q.float()
    m = torch.full((BH, G, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, G, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, bk):
        kb, vb = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        s = torch.einsum("bgh,bsh->bgs", qf, kb) * scale
        slots = torch.arange(k0, k0 + kb.shape[1], dtype=torch.int32,
                             device=q.device).reshape(1, 1, -1)
        _, valid = decode_mask(slots, cp, s_real=S, ring=ring, window=window)
        s = torch.where(valid, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bgs,bsh->bgh", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def decode_ref(q, k, v, cur_pos, *, ring: bool = False, window: int = 0,
               scale: float | None = None) -> torch.Tensor:
    """Dense reference in the kernel's (BH, G, hd) layout, as the JAX
    package writes it: softmax over the masked scores. (A row with no valid
    slot gets a uniform softmax here, where the kernels return 0.)"""
    k, v = _rows(k), _rows(v)
    BH, G, hd = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    cp = _positions(cur_pos, BH, q.device).reshape(BH, 1, 1)
    s = torch.einsum("bgh,bsh->bgs", q.float(), k.float()) * scale
    slots = torch.arange(S, dtype=torch.int32, device=q.device).reshape(1, 1, S)
    _, valid = decode_mask(slots, cp, s_real=S, ring=ring, window=int(window or 0))
    p = torch.softmax(torch.where(valid, s, _NEG), dim=-1)
    return torch.einsum("bgs,bsh->bgh", p, v.float()).to(q.dtype)
