"""Alignment losses as plain functions over batch tensors: the port of
``align_anything_tpu/losses`` (the preference losses so far; SFT and the
PPO family come with their slices)."""

from align_anything_tpu_torch.losses.preference import (
    bradley_terry_loss,
    dpo_loss,
    kto_loss,
    orpo_loss,
    sequence_logprobs,
    simpo_loss,
    unmatched_kl_estimate,
)

__all__ = [
    'bradley_terry_loss',
    'dpo_loss',
    'kto_loss',
    'orpo_loss',
    'simpo_loss',
    'sequence_logprobs',
    'unmatched_kl_estimate',
]
