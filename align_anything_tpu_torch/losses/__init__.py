"""Alignment losses as plain functions over batch tensors: the port of
``align_anything_tpu/losses`` (the preference losses, SFT's cross entropy
and the PPO family)."""

from align_anything_tpu_torch.losses.ppo import (
    add_kl_divergence_regularization,
    cumulative_returns,
    gae_advantages,
    group_relative_rewards,
    grpo_group_advantages,
    grpo_loss,
    ppo_actor_loss,
    ppo_critic_loss,
)
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
    'add_kl_divergence_regularization',
    'bradley_terry_loss',
    'cross_entropy_loss',
    'cumulative_returns',
    'dpo_loss',
    'gae_advantages',
    'group_relative_rewards',
    'grpo_group_advantages',
    'grpo_loss',
    'kto_loss',
    'orpo_loss',
    'ppo_actor_loss',
    'ppo_critic_loss',
    'simpo_loss',
    'sequence_logprobs',
    'unmatched_kl_estimate',
]
