"""Preference-based losses: Bradley-Terry RM, DPO, KTO, ORPO, SimPO.

The port of ``align_anything_tpu/losses/preference.py``, formula for
formula.  Each takes per-sample response log-prob aggregates; the batch
contract is the preference collators':
- ``logits``: (2B, L, V), better rows stacked above worse;
- ``input_ids``: (2B, L); ``response_mask``: (2B, L-1), True at next-token
  positions that belong to the response.
``jax.lax.stop_gradient`` becomes ``.detach()``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from align_anything_tpu_torch.utils.tools import gather_log_probabilities


def sequence_logprobs(logits: torch.Tensor, input_ids: torch.Tensor,
                      response_mask: torch.Tensor) -> torch.Tensor:
    """Sum of response-token log-probs per sequence -> (B,)."""
    logp = gather_log_probabilities(logits[:, :-1], input_ids[:, 1:])
    return (logp * response_mask).sum(dim=-1)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    b = x.shape[0] // 2
    return x[:b], x[b:]


def _rewards(scale_coeff: float, better: torch.Tensor,
             worse: torch.Tensor) -> dict[str, torch.Tensor]:
    better_reward = scale_coeff * better.detach()
    worse_reward = scale_coeff * worse.detach()
    return {
        'reward': better_reward + worse_reward,
        'better_sample_reward': better_reward,
        'worse_sample_reward': worse_reward,
        'reward_accuracy': (better_reward > worse_reward).float().mean(),
        'reward_margin': better_reward - worse_reward,
    }


def _weighted_mean(losses: torch.Tensor,
                   sample_weight: torch.Tensor | None) -> torch.Tensor:
    if sample_weight is None:
        return losses.mean()
    return (losses * sample_weight).sum() / sample_weight.sum().clamp_min(1)


def bradley_terry_loss(higher_end_scores: torch.Tensor,
                       lower_end_scores: torch.Tensor,
                       regularization: float = 0.0) -> dict[str, torch.Tensor]:
    """RM loss: -logsigmoid(r_hi - r_lo) [+ reg * mean(r^2)]."""
    loss = -F.logsigmoid(higher_end_scores - lower_end_scores).mean()
    if regularization > 0.0:
        loss = loss + regularization * torch.stack(
            [lower_end_scores, higher_end_scores]).square().mean()
    accuracy = (higher_end_scores > lower_end_scores).float().mean()
    return {'loss': loss, 'accuracy': accuracy,
            'higher_end_reward': higher_end_scores,
            'lower_end_reward': lower_end_scores}


def dpo_loss(logprobs: torch.Tensor, ref_logprobs: torch.Tensor,
             input_ids: torch.Tensor, response_mask: torch.Tensor,
             scale_coeff: float) -> dict[str, torch.Tensor]:
    """DPO sigmoid loss on summed response log-probs.

    ``logprobs`` / ``ref_logprobs``: per-token gathered log-probs (2B, L-1);
    the reference's must carry no gradient."""
    lp = (logprobs * response_mask).sum(dim=-1)
    ref_lp = (ref_logprobs * response_mask).sum(dim=-1)
    better_lp, worse_lp = _split(lp)
    ref_better_lp, ref_worse_lp = _split(ref_lp)
    better_log_ratio = better_lp - ref_better_lp
    worse_log_ratio = worse_lp - ref_worse_lp
    losses = -F.logsigmoid(scale_coeff * (better_log_ratio - worse_log_ratio))
    return {'loss': losses.mean(),
            **_rewards(scale_coeff, better_log_ratio, worse_log_ratio)}


def kto_loss(logprobs: torch.Tensor, ref_logprobs: torch.Tensor,
             response_mask: torch.Tensor, kl: torch.Tensor | float,
             scale_coeff: float, scale_better: float, scale_worse: float,
             sample_weight: torch.Tensor | None = None
             ) -> dict[str, torch.Tensor]:
    """KTO loss with a precomputed KL baseline ``kl`` (see
    ``unmatched_kl_estimate``); ``sample_weight`` zeroes degenerate pairs."""
    lp = (logprobs * response_mask).sum(dim=-1)
    ref_lp = (ref_logprobs * response_mask).sum(dim=-1)
    better_lp, worse_lp = _split(lp)
    ref_better_lp, ref_worse_lp = _split(ref_lp)
    better_log_ratio = better_lp - ref_better_lp
    worse_log_ratio = worse_lp - ref_worse_lp
    losses = (
        scale_better * (1 - torch.sigmoid(scale_coeff
                                          * (better_log_ratio - kl)))
        - scale_worse * (1 - torch.sigmoid(scale_coeff
                                           * (kl - worse_log_ratio))))
    return {'loss': _weighted_mean(losses, sample_weight),
            **_rewards(scale_coeff, better_log_ratio, worse_log_ratio)}


def unmatched_kl_estimate(logprobs: torch.Tensor, ref_logprobs: torch.Tensor,
                          response_mask: torch.Tensor) -> torch.Tensor:
    """KTO's KL baseline: max(mean(logp - ref_logp), 0) over response
    tokens."""
    diff = (logprobs - ref_logprobs) * response_mask
    kl = diff.sum() / response_mask.sum().clamp_min(1)
    return kl.clamp_min(0.0)


def orpo_loss(logprobs: torch.Tensor, input_ids: torch.Tensor,
              response_mask: torch.Tensor, response_lengths: torch.Tensor,
              scale_coeff: float,
              sample_weight: torch.Tensor | None = None
              ) -> dict[str, torch.Tensor]:
    """ORPO: SFT NLL + lambda * odds-ratio loss; reference-free.
    ``response_lengths``: (2B,) length normalizer."""
    lp = (logprobs * response_mask).sum(dim=-1)
    # clamp below 0: an all-masked row has avg 0 and log1p(-exp(0)) = -inf,
    # which zero weighting cannot mask (0 * inf = NaN)
    avg_lp = (lp / response_lengths).clamp_max(-1e-6)
    better_avg, worse_avg = _split(avg_lp)
    log_odds = (better_avg - worse_avg) - (
        torch.log1p(-torch.exp(better_avg))
        - torch.log1p(-torch.exp(worse_avg)))
    losses = -better_avg + scale_coeff * -F.logsigmoid(log_odds)
    return {'loss': _weighted_mean(losses, sample_weight),
            **_rewards(scale_coeff, better_avg, worse_avg)}


def simpo_loss(logprobs: torch.Tensor, response_mask: torch.Tensor,
               response_lengths: torch.Tensor, scale_coeff: float,
               gamma: float, sample_weight: torch.Tensor | None = None
               ) -> dict[str, torch.Tensor]:
    """SimPO: -logsigmoid(beta * (avg_w - avg_l) - gamma)."""
    lp = (logprobs * response_mask).sum(dim=-1)
    avg_lp = lp / response_lengths
    better_avg, worse_avg = _split(avg_lp)
    losses = -F.logsigmoid(scale_coeff * (better_avg - worse_avg) - gamma)
    return {'loss': _weighted_mean(losses, sample_weight),
            **_rewards(scale_coeff, better_avg, worse_avg)}
