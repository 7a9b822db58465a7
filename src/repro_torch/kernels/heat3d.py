"""heat-3d: PolyBench's 3-axis second-difference stencil (the paper's Sec. 4.4).

heat-3d applies a masked 7-point update to the interior of an N^3 grid,
twice per time step. :func:`heat3d_step` (``fuse_t`` applications in one
pass) and :func:`heat3d` (``2*tsteps/fuse_t`` passes) launch the
hand-written CUDA kernel ``csrc/heat3d.cu`` for tensors on the card, and take
the plain versions :func:`heat3d_step_plain` and :func:`heat3d_plain` only
for tensors on the CPU. Knobs (the JAX package's):

  * ``bi``     — the i-extent of one block's slab;
  * ``fuse_t`` — stencil applications per pass (temporal blocking with an
                 ``fuse_t``-deep halo, read from global memory).

A block marches along i through its slab and halo over a tile of ``TJ`` rows
(j) by 120 columns (k); the kernel library picks ``TJ`` for the grid and the
card (:func:`heat3d_plan`), so that a pass is about one wave of blocks.

On the card every pass of one call goes out from one C call
(``heat3d_launch`` loops over the passes, ping-ponging two buffers), so a
heat3d evaluation costs one ctypes call whatever ``tsteps`` is. The input is
never written.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.util import (
    ConfigRejected,
    check_operand,
    max_shared_memory_per_block,
)

__all__ = ["heat3d", "heat3d_check", "heat3d_step", "heat3d_plain", "heat3d_step_plain",
           "heat3d_smem_bytes", "heat3d_plan", "heat3d_passes"]

FUSE_T = (1, 2)


def heat3d_passes(tsteps: int, fuse_t: int) -> int:
    """Passes (launches) of :func:`heat3d`: 2*tsteps applications, fuse_t a pass."""
    return 2 * tsteps // fuse_t


def heat3d_plan(shape: tuple[int, int, int], bi: int, fuse_t: int) -> dict:
    """The launch ``csrc/heat3d.cu`` makes for a grid of ``shape`` on the
    current card: the tile's j rows ``tj`` (0 if no tile fits), ``blocks``
    and ``threads`` per pass and dynamic shared memory ``smem`` (bytes) per
    block (-1 if no tile fits). The kernel library answers from its
    launcher's own code, so it is built first."""
    n0, n1, n2 = shape
    lib = build.load("heat3d")
    out = (ctypes.c_longlong * 4)()
    build.check(lib, lib.heat3d_plan(n0, n1, n2, min(bi, n0), fuse_t, out), "heat3d")
    tj, blocks, threads, smem = out
    return dict(tj=tj, blocks=blocks, threads=threads, smem=smem)


def heat3d_smem_bytes(shape: tuple[int, int, int], bi: int, fuse_t: int) -> int:
    """Dynamic shared memory (bytes) one block of ``csrc/heat3d.cu`` needs
    for a grid of ``shape`` at this slab height and fusion depth (-1 where
    no tile fits)."""
    return heat3d_plan(shape, bi, fuse_t)["smem"]


def heat3d_step_plain(A: torch.Tensor, fuse_t: int = 1) -> torch.Tensor:
    """The plain version of one pass: ``fuse_t`` masked applications."""
    for _ in range(fuse_t):
        A = ref.heat3d_masked_step(A)
    return A


def heat3d_plain(A: torch.Tensor, tsteps: int) -> torch.Tensor:
    """The plain version of :func:`heat3d`: 2*tsteps masked applications
    (the knobs do not change the arithmetic)."""
    return ref.heat3d_ref(A, tsteps)


def heat3d_check(A: torch.Tensor, tsteps: int | None = None, *, bi: int = 8,
                 fuse_t: int = 1) -> int:
    """The wrapper's checks before a launch, without launching: the grid's
    rank and dtype and, on the card, the operand; and the config: ``fuse_t``
    one of :data:`FUSE_T` dividing ``2*tsteps`` (where ``tsteps`` is given)
    and, on the card, the block's shared memory against the device's limit.
    Raises :class:`ConfigRejected` for a config the kernel cannot run;
    returns the clamped ``bi``."""
    if A.dim() != 3:
        raise ValueError(f"heat3d grid must be 3-D, got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"heat3d is f32 only, got {A.dtype}")
    if fuse_t not in FUSE_T:
        raise ConfigRejected(f"fuse_t must be one of {FUSE_T}, got {fuse_t}")
    if tsteps is not None and (2 * tsteps) % fuse_t:
        raise ConfigRejected("fuse_t must divide 2*tsteps")
    n0, n1, n2 = A.shape
    bi = min(bi, n0)
    if A.device.type == "cpu":
        return bi
    dev = A.device
    check_operand("A", A, (n0, n1, n2), (torch.float32,), dev)
    with torch.cuda.device(dev):
        smem = heat3d_smem_bytes((n0, n1, n2), bi, fuse_t)
    limit = max_shared_memory_per_block(dev)
    if smem < 0 or smem > limit:
        raise ConfigRejected(f"heat3d bi={bi} fuse_t={fuse_t} needs {smem} B of "
                             f"shared memory, the device allows {limit} B per block")
    return bi


def _passes(A: torch.Tensor, bi: int, fuse_t: int, passes: int) -> torch.Tensor:
    """``passes`` passes of the kernel over A (checked), from one C call."""
    dev = A.device
    n0, n1, n2 = A.shape
    out = torch.empty_like(A)
    build.mark_launch()  # no pass at all still copies A
    if passes == 0:
        return out.copy_(A)
    tmp = torch.empty_like(A) if passes > 1 else out
    lib = build.load("heat3d")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.mark_launch()
        err = lib.heat3d_launch(A.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                                n0, n1, n2, bi, fuse_t, passes, stream)
    build.check(lib, err, "heat3d")
    heat3d.launches += passes
    return out


def heat3d_step(A: torch.Tensor, *, bi: int = 8, fuse_t: int = 1) -> torch.Tensor:
    """``fuse_t`` masked stencil applications in one pass."""
    bi = heat3d_check(A, bi=bi, fuse_t=fuse_t)
    if A.device.type == "cpu":
        return heat3d_step_plain(A, fuse_t)
    return _passes(A, bi, fuse_t, 1)


def heat3d(A: torch.Tensor, tsteps: int, *, bi: int = 8, fuse_t: int = 1) -> torch.Tensor:
    """PolyBench heat-3d: 2*tsteps stencil applications (A->B->A per step)."""
    bi = heat3d_check(A, tsteps, bi=bi, fuse_t=fuse_t)
    if A.device.type == "cpu":
        return heat3d_plain(A, tsteps)
    return _passes(A, bi, fuse_t, heat3d_passes(tsteps, fuse_t))


heat3d.launches = 0  # kernel launches (passes) since the last reset (chip_smoke reads it)
