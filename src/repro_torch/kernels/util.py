"""Shared kernel utilities: padding, device policy, device limits."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.plopper import ConfigRejected

__all__ = ["ConfigRejected", "cdiv", "pad_to", "unpad", "resolve_device",
           "max_shared_memory_per_block", "check_operand"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    the CPU. Asking for ``cuda`` (explicitly or by default) on a machine
    without a card raises — nothing silently carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --backend cpu) to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x: torch.Tensor, multiples: tuple[int, ...], value: float = 0.0) -> torch.Tensor:
    """Pad each dim of ``x`` with ``value`` up to the next multiple of ``multiples``."""
    pads = []
    for dim, m in zip(x.shape, multiples):
        pads.append(cdiv(dim, m) * m - dim)
    if not any(pads):
        return x
    # F.pad lists (before, after) pairs from the last dim backwards
    spec = []
    for p in reversed(pads):
        spec += [0, p]
    return F.pad(x, spec, value=value)


def unpad(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    if tuple(x.shape) == tuple(shape):
        return x
    return x[tuple(slice(0, s) for s in shape)]


@functools.lru_cache(maxsize=64)
def max_shared_memory_per_block(device: torch.device) -> int:
    """Opt-in dynamic shared memory one block may use on ``device``, read at
    run time (H100 SXM and PCIe parts differ, and so may later cards), once
    per device: the wrappers ask before every launch."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin",
                       props.shared_memory_per_block))


def check_operand(name: str, t: torch.Tensor, shape: tuple[int, ...],
                  dtypes: tuple[torch.dtype, ...], device: torch.device) -> None:
    """Validate one kernel operand before its pointer is handed to CUDA."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
