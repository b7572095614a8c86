"""Host-side helpers used by the generation engines."""

from __future__ import annotations

from typing import Sequence

import numpy as np


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
