"""Synthetic token pipeline — the counterpart of ``repro.data.pipeline``.

Deterministic (seeded counter-based) token generation with document
packing: :class:`SyntheticLM` is the JAX package's numpy code, so both
packages draw the same batches from one seed. :func:`make_batch` puts a
batch on the device as int64 tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

__all__ = ["SyntheticLM", "make_batch"]


@dataclasses.dataclass
class SyntheticLM:
    """Packed-documents LM stream: documents of random length separated by
    EOS, labels = next token (shifted), deterministic in (seed, step)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 1
    mean_doc_len: int = 256

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.global_batch, self.seq_len
        toks = rng.integers(2, self.vocab_size, size=(B, S + 1), dtype=np.int32)
        # stamp EOS at geometric document boundaries (packing)
        p = 1.0 / max(self.mean_doc_len, 2)
        eos_mask = rng.random((B, S + 1)) < p
        toks = np.where(eos_mask, self.eos_id, toks)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch(stream: SyntheticLM, step: int, device=None) -> dict:
    """The batch of ``step`` as int64 tensors on ``device`` (the CPU by
    default)."""
    return {k: torch.from_numpy(v.astype(np.int64)).to(device)
            for k, v in stream.batch_at(step).items()}
