"""repro_torch.ckpt — checkpoints in the JAX package's format
(msgpack+zstd) with async save and resume (the counterpart of
``repro.ckpt``)."""

from repro_torch.ckpt.checkpoint import AsyncCheckpointer, latest_step, restore, save

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
