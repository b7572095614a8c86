"""Supervised (next-token cross-entropy) loss: the port of
``align_anything_tpu/losses/sft.py``.

Numerics-parity with HF ``model(**batch).loss`` used by the reference SFT
trainers (trainers/text_to_text/sft.py): shift-by-one CE averaged over
labels != ignore_index.
"""

from __future__ import annotations

import torch

from align_anything_tpu_torch.utils.tools import gather_log_probabilities

IGNORE_INDEX = -100


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = IGNORE_INDEX,
                       shift: bool = True) -> dict[str, torch.Tensor]:
    """Mean next-token CE.  logits: (B, L, V); labels: (B, L).

    ``shift=True`` predicts labels[t+1] from logits[t] (HF convention).
    """
    if shift:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    logp = gather_log_probabilities(logits, safe_labels)
    count = valid.sum().clamp_min(1)
    loss = -(logp * valid).sum() / count
    return {'loss': loss, 'num_tokens': valid.sum()}
