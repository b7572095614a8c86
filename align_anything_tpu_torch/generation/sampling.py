"""Token sampling: greedy / temperature / top-k / top-p."""

from __future__ import annotations

import torch

NEG_INF = -1e10


def _apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    if top_k <= 0:
        return logits
    vals = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values
    cutoff = vals[..., -1:]
    return torch.where(logits < cutoff, NEG_INF, logits)


def _apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the smallest set of tokens whose cumulative prob exceeds top_p
    keep_sorted = cum - probs < top_p
    cutoff = torch.where(keep_sorted, sorted_logits,
                         torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, NEG_INF, logits)


def sample_token(logits: torch.Tensor, generator: torch.Generator | None, *,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 greedy: bool = False) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int64.  Categorical draws use the
    Gumbel-max trick with noise from ``generator`` (on the logits' device)."""
    if greedy or temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits.float() / max(temperature, 1e-6)
    logits = _apply_top_k(logits, top_k)
    logits = _apply_top_p(logits, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0)))
    return (logits + gumbel).argmax(dim=-1)
