"""Rotary position embeddings (Llama/Qwen-style half-rotation layout),
and Qwen2-VL's multimodal m-rope (``apply_mrope``).

The table is computed apart from its application, so a decode step slices
one position without recomputing sin/cos.  All math in float32.
"""

from __future__ import annotations

import math

import torch

from align_anything_tpu_torch.utils.tools import default_device


def rope_table(max_len: int, head_dim: int, theta: float = 10000.0,
               scaling: float = 1.0,
               llama3: tuple[float, float, float, int] | None = None,
               device: torch.device | str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables of shape (max_len, head_dim/2), float32.

    ``llama3``: (factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings), the Llama-3.1 frequency-banded
    scaling (HF modeling_rope_utils._compute_llama3_parameters).  On
    ``device``, by default the first CUDA device."""
    device = default_device(device)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    if llama3 is not None:
        factor, low, high, orig_max = llama3
        low_wavelen = orig_max / low
        high_wavelen = orig_max / high
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (orig_max / wavelen - low) / (high - low)
        mid = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(wavelen > low_wavelen, inv_freq / factor,
                               torch.where(wavelen < high_wavelen, inv_freq,
                                           mid))
    positions = torch.arange(max_len, dtype=torch.float32,
                             device=device) / scaling
    freqs = torch.outer(positions, inv_freq)  # (L, D/2)
    return torch.sin(freqs), torch.cos(freqs)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., L, H, D) by position-indexed tables.

    ``positions``: (..., L) integer positions; sin/cos: (max_len, D/2).
    HF half-rotation: x = [x1, x2] -> [x1*cos - x2*sin, x2*cos + x1*sin]."""
    dtype = x.dtype
    d_half = x.shape[-1] // 2
    sin_p = sin[positions][..., None, :]  # (..., L, 1, D/2)
    cos_p = cos[positions][..., None, :]
    x1 = x[..., :d_half].to(torch.float32)
    x2 = x[..., d_half:].to(torch.float32)
    out = torch.cat([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p], dim=-1)
    return out.to(dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor, sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal rotary (Qwen2-VL m-rope): ``positions`` (3, B, L) holds
    the (temporal, height, width) ids; the i-th slice of ``sections[i]``
    dim pairs rotates by stream i.  ``sum(sections) == D/2``.  Text-only
    tokens (three equal streams) reduce exactly to :func:`apply_rope`."""
    dtype = x.dtype
    d_half = x.shape[-1] // 2
    if sum(sections) != d_half:
        raise ValueError(f'mrope sections {tuple(sections)} sum to '
                         f'{sum(sections)}, not D/2 = {d_half}')

    def gather(table):
        parts, off = [], 0
        for i, sec in enumerate(sections):
            parts.append(table[positions[i]][..., off:off + sec])
            off += sec
        return torch.cat(parts, dim=-1)[..., None, :]   # (B, L, 1, D/2)

    sin_p, cos_p = gather(sin), gather(cos)
    x1 = x[..., :d_half].to(torch.float32)
    x2 = x[..., d_half:].to(torch.float32)
    out = torch.cat([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p], dim=-1)
    return out.to(dtype)
