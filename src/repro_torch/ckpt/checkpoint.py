"""Checkpointing: msgpack(+zstd when available) snapshots of a tree of
tensors with atomic rename, async save and step-addressed resume — the
counterpart of ``repro.ckpt.checkpoint``, in its format: the same files
(``step_%08d/shard_0.msgpack.zst`` and ``meta.json``), the same one-byte
format flag (``\\x00`` raw msgpack, ``\\x01`` zstd), the leaves in the JAX
package's flattening order (:mod:`repro_torch.tree`) and the same leaf
records (``{"d": dtype, "s": shape, "b": bytes}``, bfloat16 as its uint16
bits). A checkpoint written by either package restores in the other.

The MessagePack is the port's own (:mod:`repro_torch.ckpt.codec`): the
port does not depend on ``msgpack``. ``zstandard`` stays optional, as in the
JAX package; without it shards are written raw, and a zstd shard cannot be
read.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.ckpt.codec import pack, unpack
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten, treedef_str

try:
    import zstandard
except ImportError:  # optional: fall back to uncompressed shards
    zstandard = None

__all__ = ["save", "restore", "AsyncCheckpointer", "latest_step"]

_MAGIC = "repro-ckpt-v1"
_FLAG_RAW = b"\x00"
_FLAG_ZSTD = b"\x01"
_SHARD = "shard_0.msgpack.zst"


def _pack_leaf(x) -> dict:
    t = torch.as_tensor(x).detach().cpu().contiguous()
    bf16 = t.dtype == torch.bfloat16
    a = (t.view(torch.int16).numpy().view(np.uint16) if bf16 else t.numpy())
    return {"d": "bfloat16" if bf16 else a.dtype.str, "s": list(a.shape),
            "b": memoryview(a.reshape(-1).view(np.uint8))}


def _unpack_leaf(rec: dict) -> torch.Tensor:
    if rec["d"] == "bfloat16":
        a = np.frombuffer(rec["b"], np.uint16).reshape(rec["s"]).copy()
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(rec["b"], np.dtype(rec["d"])).reshape(rec["s"]).copy())


def save(path: str, tree, step: int, *, meta: dict | None = None, level: int = 3) -> str:
    """Write <path>/step_<n>/ with shard payload + metadata; atomic rename.
    Leaves are tensors (on any device) or numpy arrays."""
    pieces = pack({"magic": _MAGIC, "leaves": [_pack_leaf(x) for x in tree_leaves(tree)]})
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, _SHARD), "wb") as f:
        if zstandard is not None:
            f.write(_FLAG_ZSTD + zstandard.ZstdCompressor(level=level).compress(b"".join(pieces)))
        else:  # the pieces as they are: no joined copy of the payload
            f.write(_FLAG_RAW)
            for piece in pieces:
                f.write(piece)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "treedef": treedef_str(tree), "meta": meta or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _steps(path: str) -> list[int]:
    return [int(d.split("_")[1]) for d in os.listdir(path)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = _steps(path)
    return max(steps) if steps else None


def _payload(data: bytes):
    flag, body = data[:1], memoryview(data)[1:]
    if flag == _FLAG_RAW:
        return body
    if zstandard is None:
        raise RuntimeError("checkpoint shard is zstd-compressed but zstandard is not installed")
    # flag \x01, or a legacy flagless shard: a bare zstd frame
    return zstandard.ZstdDecompressor().decompress(body if flag == _FLAG_ZSTD else data)


def restore(path: str, tree_template, step: int | None = None):
    """Restore into the structure of ``tree_template`` (shapes validated);
    returns (tree, step). Each leaf takes its record's dtype and, where the
    template's leaf is a tensor, that tensor's device."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    with open(os.path.join(path, f"step_{step:08d}", _SHARD), "rb") as f:
        obj = unpack(_payload(f.read()))
    if not isinstance(obj, dict) or obj.get("magic") != _MAGIC:
        raise ValueError("corrupt checkpoint")
    leaves = tree_leaves(tree_template)
    rec = obj["leaves"]
    if len(rec) != len(leaves):
        raise ValueError(f"leaf count mismatch: ckpt {len(rec)} vs template {len(leaves)}")
    out = []
    for r, tmpl in zip(rec, leaves):
        t = _unpack_leaf(r)
        if tuple(t.shape) != tuple(np.shape(tmpl)):
            raise ValueError(f"shape mismatch {tuple(t.shape)} vs {tuple(np.shape(tmpl))}")
        out.append(t.to(tmpl.device) if isinstance(tmpl, torch.Tensor) else t)
    return tree_unflatten(tree_template, out), step


def _host_copy(x):
    """A host copy no later in-place update can reach (a CUDA tensor's copy
    waits for the work queued before it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


class AsyncCheckpointer:
    """Overlap checkpoint serialization with training (one in flight)."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: cf.Future | None = None

    def save(self, tree, step: int, meta: dict | None = None):
        self.wait()
        # the device->host copy happens on the caller's thread: the snapshot
        # is this step's values, whatever the training loop updates in place
        host_tree = tree_map(_host_copy, tree)
        self._pending = self._pool.submit(self._do_save, host_tree, step, meta)

    def _do_save(self, host_tree, step, meta):
        save(self.path, host_tree, step, meta=meta)
        self._gc()

    def _gc(self):
        for s in sorted(_steps(self.path))[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"), ignore_errors=True)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self):
        """Wait for the save in flight, then stop the writer thread."""
        try:
            self.wait()
        finally:
            self._pool.shutdown()
