"""Helpers shared across the port: the device default, the seeds,
param-tree walks, host-side padding, and the log-probability gather of
``align_anything_tpu/utils/tools.py``."""

from __future__ import annotations

import os
import random
from typing import Any, Callable, Sequence

import numpy as np
import torch


def default_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as given, else the first CUDA device.  Raises where there
    is none: the port runs on the card unless the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           'CPU')
    return torch.device('cuda', 0)


def seed_everything(seed: int) -> torch.Generator:
    """Seed ``random``, numpy and torch; return the root CPU generator that
    takes the place of the JAX root key (the trainers draw their keys from
    it)."""
    seed = int(seed)
    os.environ['PYTHONHASHSEED'] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf of a nested dict; same structure out."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_leaves(tree: Any) -> list[torch.Tensor]:
    """Tensor leaves of a nested dict, in a fixed (insertion) order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in param_leaves(v)]
    return [tree]


def left_padding(sequences: Sequence[np.ndarray], padding_value: int | float,
                 total_length: int | None = None) -> np.ndarray:
    """Stack variable-length 1-D sequences with left padding (host-side)."""
    max_len = total_length if total_length is not None else max(len(s) for s in sequences)
    out = np.full((len(sequences), max_len), padding_value,
                  dtype=np.asarray(sequences[0]).dtype)
    for i, seq in enumerate(sequences):
        seq = np.asarray(seq)[:max_len]
        out[i, max_len - len(seq):] = seq
    return out


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; clamps to the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def gather_log_probabilities(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Log-probabilities of ``labels`` under ``logits``: (B, L, V), (B, L)
    -> (B, L) fp32, as logit[label] - logsumexp(logits).  Out-of-vocab
    labels do not poison the batch: as JAX ``take_along_axis(mode='clip')``
    does, a negative label counts from the end and the result is clipped
    into [0, V)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    v = logits.shape[-1]
    idx = labels.to(torch.long)
    idx = torch.where(idx < 0, idx + v, idx).clamp(0, v - 1)
    return torch.gather(logits, -1, idx[..., None]).squeeze(-1) - lse
