"""Deterministic synthetic data (``repro/data/pipeline.py``).

Batches are a pure function of (seed, step): the same
``np.random.default_rng((seed, step))`` draws as the reference, so both
packages see identical batches.  Each rank takes its contiguous
``local_batch`` slice of the global batch, as the reference's batch
sharding gives each device: slice ``dp_index(rank, mesh)``, the rank's
coordinates on the dp axes ("pod", "data"), so every rank of a model
group reads the same rows (``parallel/sharding.py::batch_spec``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.parallel.sharding import dp_index, local_batch


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class TokenPipeline:
    """Synthetic LM token stream: (tokens, labels) of (B, S) int32, and
    one standard-normal array per ``extra_specs`` entry (name → (per-sample
    shape, numpy dtype), drawn after the tokens in the dict's order, as
    the reference draws them: musicgen's ``frame_embeds``).

    ``mesh`` gives the data-parallel size (``None`` = one rank holding the
    whole batch) and ``rank`` this process's slice; ``global_tokens`` is
    the global batch's token count, a scalar f32 tensor.  Tensors are put
    on ``device``.
    """

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, mesh=None, rank: int = 0,
                 extra_specs: dict[str, tuple[tuple[int, ...], Any]] | None = None,
                 device: str | torch.device = "cuda"):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.local = (global_batch if mesh is None
                      else local_batch(global_batch, mesh))
        self.rank = rank if mesh is None else dp_index(rank, mesh)
        self.extra = extra_specs or {}
        self.device = torch.device(device)

    def batch_at(self, step: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.vocab, (self.global_batch, self.seq_len + 1),
                            dtype=np.int32)
        rows = slice(self.rank * self.local, (self.rank + 1) * self.local)
        batch = {
            "tokens": _put(toks[rows, :-1], self.device),
            "labels": _put(toks[rows, 1:], self.device),
            "global_tokens": torch.tensor(float(self.global_batch * self.seq_len),
                                          dtype=torch.float32, device=self.device),
        }
        for name, (shape, dtype) in self.extra.items():
            x = rng.standard_normal((self.global_batch, *shape)).astype(dtype)
            batch[name] = _put(x[rows], self.device)
        return batch


class ImagePipeline:
    """Synthetic image classification stream (paper's CIFAR/ImageNet).

    ``mesh`` gives the data-parallel size (``None`` = one rank holding
    the whole batch) and ``rank`` this process's rank, whose data-parallel
    index picks its slice; tensors are put on ``device``.
    """

    def __init__(self, img_size: int, num_classes: int, global_batch: int,
                 *, seed: int = 0, mesh=None, rank: int = 0,
                 device: str | torch.device = "cuda"):
        self.img_size = img_size
        self.num_classes = num_classes
        self.global_batch = global_batch
        self.seed = seed
        self.local = (global_batch if mesh is None
                      else local_batch(global_batch, mesh))
        self.rank = rank if mesh is None else dp_index(rank, mesh)
        self.device = torch.device(device)

    def batch_at(self, step: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, step))
        images = rng.standard_normal(
            (self.global_batch, self.img_size, self.img_size, 3)
        ).astype(np.float32)
        labels = rng.integers(0, self.num_classes, (self.global_batch,),
                              dtype=np.int32)
        lo = self.rank * self.local
        return {
            "images": torch.from_numpy(images[lo:lo + self.local]).to(self.device),
            "labels": torch.from_numpy(labels[lo:lo + self.local]).to(self.device),
            "global_tokens": torch.tensor(float(self.global_batch),
                                          dtype=torch.float32, device=self.device),
        }
