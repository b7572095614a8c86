"""Alignment losses as plain functions over batch tensors: the port of
``align_anything_tpu/losses`` (the preference losses and SFT's cross
entropy so far; the PPO family comes with its slice)."""

from align_anything_tpu_torch.losses.preference import (
    bradley_terry_loss,
    dpo_loss,
    kto_loss,
    orpo_loss,
    sequence_logprobs,
    simpo_loss,
    unmatched_kl_estimate,
)
from align_anything_tpu_torch.losses.sft import cross_entropy_loss

__all__ = [
    'bradley_terry_loss',
    'cross_entropy_loss',
    'dpo_loss',
    'kto_loss',
    'orpo_loss',
    'simpo_loss',
    'sequence_logprobs',
    'unmatched_kl_estimate',
]
