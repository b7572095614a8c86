"""Helpers shared across the port: the device default, the seeds,
param-tree walks, and the port of ``align_anything_tpu/utils/tools.py``:
host-side padding, the log-probability gather, masked means, first / last
true index, and the tokenizer helpers of the RL trainers."""

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


def right_padding(sequences: Sequence[np.ndarray], padding_value: int | float,
                  total_length: int | None = None) -> np.ndarray:
    """Stack variable-length 1-D sequences with right padding (host-side),
    to ``total_length`` when given (truncating longer ones)."""
    max_len = total_length if total_length is not None else max(len(s) for s in sequences)
    out = np.full((len(sequences), max_len), padding_value,
                  dtype=np.asarray(sequences[0]).dtype)
    for i, seq in enumerate(sequences):
        seq = np.asarray(seq)[:max_len]
        out[i, :len(seq)] = seq
    return out


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


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Mean of per-sequence masked means.  An all-masked row contributes 0
    instead of 0/0."""
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    return ((x * mask).sum(dim=-1)
            / mask.sum(dim=-1).clamp_min(1)).mean()


def masked_mean_global(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Global masked mean: sum(x*mask)/sum(mask)."""
    mask = mask.to(x.dtype)
    return (x * mask).sum() / mask.sum().clamp_min(1)


def first_true_index(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (or the dim's length if
    none)."""
    first = torch.argmax(mask.to(torch.int32), dim=dim)
    return first + torch.where(mask.any(dim=dim), 0, mask.shape[dim])


def last_true_index(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the last True along ``dim`` (assumes at least one True)."""
    size = mask.shape[dim]
    return size - 1 - torch.argmax(
        torch.flip(mask, dims=(dim,)).to(torch.int32), dim=dim)


def split_prompt_response(texts: list[str], split_token: str
                          ) -> tuple[list[str], list[str]]:
    prompts, responses = [], []
    for text in texts:
        prompt, response = text.split(split_token, maxsplit=1)
        assert prompt and response, f'invalid text: {text}'
        prompts.append(prompt)
        responses.append(response)
    return prompts, responses


def is_same_tokenizer(tokenizer, other_tokenizer) -> bool:
    """True when two tokenizers produce identical token streams: same class
    and same vocab (``HashTokenizer`` has no ``get_vocab``: same class is
    enough)."""
    if tokenizer is other_tokenizer:
        return True
    if tokenizer.__class__ != other_tokenizer.__class__:
        return False
    if not hasattr(tokenizer, 'get_vocab'):
        return True
    return tokenizer.get_vocab() == other_tokenizer.get_vocab()


def batch_retokenize(input_ids: np.ndarray, src_tokenizer, dest_tokenizer,
                     total_length: int,
                     skip_special_tokens: bool = True) -> dict[str, np.ndarray]:
    """Re-tokenize a batch of ids from one tokenizer to another, host-side,
    right-padded / truncated to ``total_length``.  Each decoded text gets
    the destination EOS appended, so the reward model's end score lands on
    a real token."""
    texts = src_tokenizer.batch_decode(np.asarray(input_ids),
                                       skip_special_tokens=skip_special_tokens)
    encoded = [dest_tokenizer(t + (dest_tokenizer.eos_token or ''),
                              add_special_tokens=True)['input_ids']
               for t in texts]
    pad_id = dest_tokenizer.pad_token_id
    if pad_id is None:
        pad_id = dest_tokenizer.eos_token_id or 0
    ids = right_padding(encoded, pad_id, total_length=total_length)
    mask = right_padding([np.ones(len(e), np.int32) for e in encoded], 0,
                         total_length=total_length)
    return {'input_ids': ids.astype(np.int32),
            'attention_mask': mask.astype(np.int32)}
