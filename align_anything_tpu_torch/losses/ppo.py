"""PPO-family losses: GAE, clipped policy / value losses, KL reward
shaping, group estimators, GRPO.  The port of
``align_anything_tpu/losses/ppo.py``, formula for formula.

The JAX reversed ``lax.scan`` of GAE and of the discounted returns becomes
a reversed Python loop over the T completion positions (one fused update of
a (B,) carry per position); the one-hot EOS add becomes a ``scatter_add``
at each row's last real token.  ``jax.lax.stop_gradient`` becomes
``.detach()``.
"""

from __future__ import annotations

import torch

from align_anything_tpu_torch.utils.tools import (
    last_true_index,
    masked_mean,
    masked_mean_global,
)


def _reverse_discounted(x: torch.Tensor, discount: float) -> torch.Tensor:
    """y[:, t] = x[:, t] + discount * y[:, t+1] over the last dim, y = 0
    beyond the end."""
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[:, 0])
    for t in range(x.shape[-1] - 1, -1, -1):
        carry = x[:, t] + discount * carry
        out[:, t] = carry
    return out


def gae_advantages(values: torch.Tensor, rewards: torch.Tensor,
                   sequence_mask: torch.Tensor, start: int,
                   gamma: float, gae_lambda: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized Advantage Estimation over [start, L).

    values/rewards: (B, L); sequence_mask: (B, L).  Returns (advantages,
    returns), each (B, L-start); the advantages carry no gradient."""
    mask = sequence_mask.to(values.dtype)
    values = values * mask
    rewards = rewards * mask
    # next_values[t] = values[t+1] (0 beyond the end)
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])],
                            dim=-1)
    deltas = rewards + gamma * next_values - values
    advantages = _reverse_discounted(deltas[:, start:], gamma * gae_lambda)
    returns = advantages + values[:, start:]
    return advantages.detach(), returns


def ppo_actor_loss(log_probs: torch.Tensor, old_log_probs: torch.Tensor,
                   advantages: torch.Tensor, mask: torch.Tensor,
                   clip_range_ratio: float) -> torch.Tensor:
    """Clipped surrogate policy loss."""
    ratios = torch.exp(log_probs - old_log_probs)
    surrogate1 = advantages * ratios
    surrogate2 = advantages * torch.clamp(ratios, 1.0 - clip_range_ratio,
                                          1.0 + clip_range_ratio)
    return -masked_mean(torch.minimum(surrogate1, surrogate2), mask)


def ppo_critic_loss(values: torch.Tensor, old_values: torch.Tensor,
                    returns: torch.Tensor, mask: torch.Tensor,
                    clip_range_value: float) -> torch.Tensor:
    """Clipped value loss."""
    values_clipped = torch.minimum(
        torch.maximum(values, old_values - clip_range_value),
        old_values + clip_range_value)
    vf_loss1 = torch.square(values - returns)
    vf_loss2 = torch.square(values_clipped - returns)
    return 0.5 * masked_mean(torch.maximum(vf_loss1, vf_loss2), mask)


def add_kl_divergence_regularization(reward: torch.Tensor,
                                     log_probs: torch.Tensor,
                                     ref_log_probs: torch.Tensor,
                                     sequence_mask: torch.Tensor,
                                     kl_coeff: float,
                                     clip_range_score: float) -> torch.Tensor:
    """Per-token KL penalty with the scalar reward added at each row's last
    real token, clipped.  reward: (B,); the rest (B, L)."""
    end_index = last_true_index(sequence_mask.bool())
    rewards = -kl_coeff * (log_probs - ref_log_probs)
    rewards = rewards.scatter_add(
        -1, end_index[:, None], reward[:, None].to(rewards.dtype))
    return torch.clamp(rewards, -clip_range_score, clip_range_score)


def cumulative_returns(rewards: torch.Tensor, sequence_mask: torch.Tensor,
                       start: int, gamma: float) -> torch.Tensor:
    """Discounted reward-to-go over [start, L)."""
    rewards = (rewards * sequence_mask.to(rewards.dtype))[:, start:]
    return _reverse_discounted(rewards, gamma)


def group_relative_rewards(rewards: torch.Tensor, n_samples: int,
                           estimator: str) -> torch.Tensor:
    """Per-token rewards grouped across the n samples of each prompt
    (consecutive rows belong to one prompt).

    estimator: 'rloo' (leave-one-out baseline), 'reinforce_baseline'
    (group mean), 'group_norm' (group mean / population std)."""
    shape = rewards.shape
    grouped = rewards.reshape(-1, n_samples, *shape[1:])
    if estimator == 'rloo':
        baseline = (grouped.sum(1, keepdim=True) - grouped) / (n_samples - 1)
        grouped = grouped - baseline
    elif estimator == 'reinforce_baseline':
        grouped = grouped - grouped.mean(1, keepdim=True)
    elif estimator == 'group_norm':
        mean = grouped.mean(1, keepdim=True)
        std = grouped.std(1, keepdim=True, correction=0) + 1e-9
        grouped = (grouped - mean) / std
    else:
        raise ValueError(f'unknown group estimator: {estimator}')
    return grouped.reshape(shape)


def grpo_group_advantages(rewards: torch.Tensor, num_generations: int,
                          eps: float = 1e-4) -> torch.Tensor:
    """Group-normalized advantages with the Bessel-corrected std.

    rewards: (B*G,) grouped contiguously per prompt -> (B*G,)."""
    grouped = rewards.reshape(-1, num_generations)
    mean = grouped.mean(dim=1, keepdim=True)
    std = torch.sqrt(torch.square(grouped - mean).sum(dim=1, keepdim=True)
                     / max(num_generations - 1, 1)) + eps
    return ((grouped - mean) / std).reshape(-1)


def grpo_loss(per_token_logps: torch.Tensor,
              ref_per_token_logps: torch.Tensor, advantages: torch.Tensor,
              completion_mask: torch.Tensor,
              beta: float) -> dict[str, torch.Tensor]:
    """GRPO policy loss with token-level KL.

    per_token_logps: (N, T) over completion tokens; advantages: (N,);
    completion_mask: (N, T)."""
    diff = ref_per_token_logps - per_token_logps
    per_token_kl = torch.exp(diff) - diff - 1
    ratio = torch.exp(per_token_logps - per_token_logps.detach())
    per_token_loss = -(ratio * advantages[:, None] - beta * per_token_kl)
    loss = masked_mean_global(per_token_loss, completion_mask)
    kl = masked_mean_global(per_token_kl.detach(), completion_mask)
    return {'loss': loss, 'kl': kl}
