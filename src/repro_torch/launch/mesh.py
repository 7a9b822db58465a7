"""Mesh construction: the production meshes over the world that exists, a
mesh for an elastic plan, and the two worlds the port traces and runs in —
the counterpart of ``repro.launch.mesh``.

The reference forces 256 / 512 host devices through ``XLA_FLAGS`` and lets
XLA partition for them. torch's ``DeviceMesh`` needs a process group of
that many ranks, so :func:`fake_world` makes one in this process: torch's
fake process group, whose collectives move nothing. With meta tensors for
the local shards, a step traced there allocates nothing and issues every
collective of one rank (``repro_torch.perf.op_cost`` counts them).
:func:`local_mesh` is the world of the devices the process has: one card
over NCCL (or the CPU over gloo), a (1, 1) ``("data", "model")`` mesh.

torch allows one default group per process, so the two contexts are
strictly sequential and each tears its group down. Like the reference's,
importing this module touches no device state.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_mesh_from_plan", "fake_world", "local_mesh",
           "mesh_name"]

# the device type the current world's meshes are built on (set by the
# contexts below: "cpu" in a fake world, the device's type in a local one)
_WORLD: dict = {}


def _require_no_world() -> None:
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already: torch allows one a "
                           "process, and fake_world/local_mesh each make and destroy their own")


def _mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a world of "
                           f"{math.prod(shape)} ranks: enter fake_world({math.prod(shape)}) "
                           f"(a device-free trace) or a real process group first")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_WORLD.get("device_type", "cpu"), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) = 256 ranks, axes (data, model).
    Multi-pod: (2, 16, 16) = 512 ranks, axes (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_mesh_from_plan(plan):
    """Build a mesh from an elastic MeshPlan (repro_torch.ft.elastic)."""
    return _mesh(tuple(plan.shape), tuple(plan.axes))


def mesh_name(mesh) -> str:
    """'16x16', '2x16x16', '1x1': the reference's row key."""
    return "x".join(map(str, tuple(mesh.shape)))


@contextlib.contextmanager
def fake_world(n: int):
    """A world of ``n`` ranks in this process (this process is rank 0) on
    torch's fake process group: a mesh over it places tensors and issues
    collectives that move nothing. The one place the port imports
    ``torch.testing._internal.distributed.fake_pg``, which is private API."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"fake_world needs torch's fake process group "
                           f"(torch.testing._internal.distributed.fake_pg, private API), "
                           f"which this torch {torch.__version__} lacks: {e}") from e
    _require_no_world()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(n))
    _WORLD["device_type"] = "cpu"
    try:
        yield
    finally:
        _WORLD.clear()
        dist.destroy_process_group()


@contextlib.contextmanager
def local_mesh(device="cuda"):
    """A (1, 1) ``("data", "model")`` mesh over the process's own device: one
    card over NCCL, or with ``device="cpu"`` the CPU over gloo; a world of 1
    on an in-process store (no network)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("local_mesh('cuda') needs a card; device='cpu' runs over gloo")
    _require_no_world()
    if device.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if device.index is None
                           else device.index)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    _WORLD["device_type"] = device.type
    try:
        yield _mesh((1, 1), ("data", "model"))
    finally:
        _WORLD.clear()
        dist.destroy_process_group()
