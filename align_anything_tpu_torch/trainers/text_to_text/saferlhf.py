"""Safe-RLHF trainer: PPO with a cost model and a Lagrange multiplier, the
port of ``align_anything_tpu/trainers/text_to_text/saferlhf.py``
(reference: trainers/text_image_to_text/saferlhf.py:64-498, the text-only
variant of Safe-RLHF-V).

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.saferlhf \\
        --actor_model_name_or_path <dir|preset> \\
        --reward_model_name_or_path <RM slice dir> \\
        --cost_model_name_or_path <cost model slice dir> \\
        --train_datasets <path> --train_template PKUSafeRLHF \\
        --output_dir ./output/saferlhf

Six param trees on the trainer's device: ``PPOTrainer``'s actor (trained),
reference, reward model and reward critic (trained), plus the cost model
(frozen; default: the reward model's checkpoint) and the cost critic
(trained; default: the cost model's checkpoint), whose optimizer takes the
critic's keys (``critic_lr``, ...).

Per prompt batch (``train_step``):
  1. the PPO rollout and scoring pass, then the cost model's end scores and
     the cost critic's values under ``torch.no_grad()``, over the
     rollout's media too where it has them (``MEDIA_KEYS``: Safe-RLHF-V's
     ``pixel_values``); the episode costs join a window of
     ``episode_cost_window_size``;
  2. per micro-batch: the KL-shaped rewards and costs (the cost's shaping
     takes the negated log-probs), GAE for each, the dual-combined
     advantage ``(reward_adv - lambda * cost_adv) / (1 + lambda)`` with
     ``lambda = exp(log_lambda)``, then three updates from the same batch:
     the actor's clipped surrogate, the reward critic's and the cost
     critic's clipped value losses (and the optional PTX step);
  3. once per round, after the updates: the multiplier by SGD on
     ``-(episode_cost - threshold) * exp(log_lambda)`` (saferlhf.py:492-498),
     once ``global_step`` reaches ``lambda_update_delay_steps``.
The reported ``train/*`` metrics are the LAST micro-batch's, as the JAX
trainer reports them (its PPO averages over the round; ROADMAP R10), plus
``train/log_lambda`` and ``train/episode_cost``; ``perf/*`` as PPO's, the
cost scoring counted in ``perf/scoring_s``.
"""

from __future__ import annotations

import collections
import os
import sys
import time
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.losses import (
    add_kl_divergence_regularization,
    gae_advantages,
    ppo_actor_loss,
    ppo_critic_loss,
)
from align_anything_tpu_torch.models import score_model
from align_anything_tpu_torch.trainers.base import init_train_state
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.optimizer import make_optimizer
from align_anything_tpu_torch.trainers.text_to_text.ppo import (
    PPOTrainer,
    load_score_model_params,
)
from align_anything_tpu_torch.utils.tools import masked_mean

MEDIA_KEYS = ('pixel_values', 'audio_values')


class SafeRLHFTrainer(PPOTrainer):
    def init_models(self) -> None:
        super().init_models()
        mc = self.cfgs.model_cfgs
        cost_path = mc.cost_model_name_or_path or mc.reward_model_name_or_path
        cost_critic_path = mc.cost_critic_model_name_or_path or cost_path
        self.cost_params, self.cost_cfg = self.load_model(cost_path,
                                                          self.next_rng)
        self.cost_params.update(load_score_model_params(
            cost_path if cost_path and os.path.isdir(cost_path) else None,
            self.cost_cfg.hidden_size, self.next_rng(), self.device))
        cost_critic_params, self.cost_critic_cfg = self.load_model(
            cost_critic_path, self.next_rng)
        cost_critic_params.update(load_score_model_params(
            cost_critic_path if cost_critic_path
            and os.path.isdir(cost_critic_path) else None,
            self.cost_critic_cfg.hidden_size, self.next_rng(), self.device))
        self.cost_critic_params = self.trainable(cost_critic_params)

    def init_engines(self) -> None:
        if self.lora_requested():
            # JAX's update differentiates the actor's log-probs of the
            # adapter tree as if it were the model (saferlhf.py:141-145) and
            # fails at the first round (ROADMAP R18)
            raise ValueError('Safe-RLHF does not run with '
                             'lora_cfgs.use_lora: its actor update reads the '
                             'adapters as the model, in the reference '
                             'trainer too')
        super().init_engines()
        tc = self.cfgs.train_cfgs

        # the Lagrange multiplier's state (saferlhf.py:99-111)
        self.log_lambda = float(np.log(float(tc.lambda_init or 1.0)))
        self.lambda_lr = float(tc.lambda_lr or 0.04)
        self.lambda_max = tc.lambda_max
        self.lambda_update_delay_steps = int(tc.lambda_update_delay_steps or 0)
        self.threshold = float(tc.threshold if tc.threshold is not None
                               else 0.0)
        self.episode_costs = collections.deque(
            maxlen=int(tc.episode_cost_window_size or 128))

        total = self.total_training_steps(self.train_iterator)
        rl_steps = max(total * self.update_iters, 1)
        self.cost_critic_tx, self.cost_critic_schedule = make_optimizer(
            float(tc.critic_lr or 5e-6),
            lr_scheduler_type=tc.critic_lr_scheduler_type or 'constant',
            total_steps=rl_steps,
            lr_warmup_ratio=float(tc.critic_lr_warmup_ratio or 0.0),
            weight_decay=float(tc.critic_weight_decay or 0.0),
            adam_betas=tuple(tc.adam_betas or (0.9, 0.95)),
            max_grad_norm=float(tc.max_grad_norm or 1.0))
        self.cost_critic_state = init_train_state(self.cost_critic_params,
                                                  self.cost_critic_tx)
        del self.cost_critic_params

    # cost-model hooks ---------------------------------------------------

    def compute_cost_end_scores(self, params: dict, batch: dict
                                ) -> torch.Tensor:
        return score_model.forward(
            params, self.cost_cfg, batch['input_ids'],
            attention_mask=batch['attention_mask']).end_scores.squeeze(-1)

    def compute_cost_values(self, params: dict, batch: dict
                            ) -> torch.Tensor:
        return score_model.forward(
            params, self.cost_critic_cfg, batch['input_ids'],
            attention_mask=batch['attention_mask']
        ).scores.squeeze(-1)[:, :-1]

    # ------------------------------------------------------------------

    @torch.no_grad()
    def score_cost(self, seq: torch.Tensor, mask: torch.Tensor,
                   **media: torch.Tensor) -> dict[str, torch.Tensor]:
        """The cost model's end scores and the cost critic's values of the
        rollout sequences, with the rollout's media (``pixel_values``,
        ``audio_values``) where it has them."""
        batch = {'input_ids': seq, 'attention_mask': mask, **media}
        return {'cost': self.compute_cost_end_scores(self.cost_params, batch),
                'cost_values': self.compute_cost_values(
                    self.cost_critic_state.params, batch)}

    def rollout(self, prompt_batch: dict) -> dict[str, Any]:
        out = super().rollout(prompt_batch)
        t0 = time.perf_counter()
        # a multimodal rollout's media reach the cost model and the cost
        # critic, as in JAX's rollout (saferlhf.py:213-225)
        media = {k: out[k] for k in MEDIA_KEYS if k in out}
        out.update(self.score_cost(out['input_ids'], out['attention_mask'],
                                   **media))
        self.episode_costs.extend(out['cost'].float().cpu().tolist())
        out['perf/scoring_s'] += time.perf_counter() - t0
        return out

    def _micro_batches(self, rollout: dict):
        for i, micro in enumerate(super()._micro_batches(rollout)):
            sl = slice(i * self.micro_bs, (i + 1) * self.micro_bs)
            micro['old_cost_values'] = rollout['cost_values'][sl]
            micro['cost'] = rollout['cost'][sl]
            yield micro

    def safe_rl_step(self, batch: dict, start: int, log_lambda: float
                     ) -> dict[str, torch.Tensor]:
        """One update of actor, reward critic and cost critic on a
        micro-batch; ``start``: the prompt block's length - 1."""
        sequence_mask = batch['sequence_mask']
        old_log_probs = batch['old_log_probs']
        ref_log_probs = batch['ref_log_probs']

        old_rewards = add_kl_divergence_regularization(
            batch['reward'], old_log_probs, ref_log_probs, sequence_mask,
            self.kl_coeff, self.clip_score)
        # the cost's KL shaping takes the negated log-probs
        # (saferlhf.py:463-476)
        old_costs = add_kl_divergence_regularization(
            batch['cost'], -old_log_probs, -ref_log_probs, sequence_mask,
            self.kl_coeff, self.clip_score)
        reward_adv, reward_ret = gae_advantages(
            batch['old_reward_values'], old_rewards, sequence_mask, start,
            self.gamma, self.gae_lambda)
        cost_adv, cost_ret = gae_advantages(
            batch['old_cost_values'], old_costs, sequence_mask, start,
            self.gamma, self.gae_lambda)
        multiplier = torch.exp(torch.tensor(log_lambda, dtype=torch.float32,
                                            device=sequence_mask.device))
        advantages = (reward_adv - multiplier * cost_adv) / (1.0 + multiplier)
        mask = sequence_mask[:, start:]

        log_probs = self.compute_actor_logprobs(self.actor_state.params,
                                                batch)
        actor_loss = ppo_actor_loss(log_probs[:, start:],
                                    old_log_probs[:, start:], advantages,
                                    mask, self.clip_ratio)
        self.actor_state, actor_norm = self._update(
            self.actor_state, self.actor_tx, actor_loss)

        values = self.compute_critic_values(self.critic_state.params, batch)
        reward_critic_loss = ppo_critic_loss(
            values[:, start:], batch['old_reward_values'][:, start:],
            reward_ret, mask, self.clip_value)
        self.critic_state, critic_norm = self._update(
            self.critic_state, self.critic_tx, reward_critic_loss)

        cost_values = self.compute_cost_values(self.cost_critic_state.params,
                                               batch)
        cost_critic_loss = ppo_critic_loss(
            cost_values[:, start:], batch['old_cost_values'][:, start:],
            cost_ret, mask, self.clip_value)
        self.cost_critic_state, cost_critic_norm = self._update(
            self.cost_critic_state, self.cost_critic_tx, cost_critic_loss)

        return {
            'train/actor_loss': actor_loss.detach(),
            'train/reward_critic_loss': reward_critic_loss.detach(),
            'train/cost_critic_loss': cost_critic_loss.detach(),
            'train/reward': batch['reward'].mean(),
            'train/cost': batch['cost'].mean(),
            'train/lambda': multiplier,
            'train/reward_advantage': masked_mean(reward_adv, mask),
            'train/cost_advantage': masked_mean(cost_adv, mask),
            'train/kl_divergence':
                ((old_log_probs - ref_log_probs)[:, start:] * mask
                 ).sum(-1).mean(),
            'train/actor_grad_norm': actor_norm,
            'train/reward_critic_grad_norm': critic_norm,
            'train/cost_critic_grad_norm': cost_critic_norm,
        }

    def train_step(self, prompt_batch: dict) -> dict[str, Any]:
        rollout = self.rollout(prompt_batch)
        t0 = time.perf_counter()
        metrics: dict[str, Any] = {}
        for _ in range(self.update_iters):
            for micro in self._micro_batches(rollout):
                m = self.safe_rl_step(micro, rollout['start'],
                                      self.log_lambda)
                # the last micro-batch's metrics (saferlhf.py:242)
                metrics = {k: float(v) for k, v in m.items()}
                if self.ptx_iterator is not None:
                    ptx_batch = self.put_batch(next(self._ptx_cycle))
                    metrics['train/ptx_loss'] = float(self.ptx_step(ptx_batch))
        self._update_lambda()
        metrics['train/log_lambda'] = self.log_lambda
        metrics['train/episode_cost'] = (float(np.mean(self.episode_costs))
                                         if self.episode_costs else 0.0)
        self._sync()
        metrics['perf/update_s'] = time.perf_counter() - t0
        for k in ('perf/rollout_s', 'perf/scoring_s',
                  'perf/generated_tokens'):
            metrics[k] = rollout[k]
        return metrics

    def _update_lambda(self) -> None:
        """SGD on -(episode_cost - threshold) * exp(log_lambda)
        (saferlhf.py:492-498), on the host in float64."""
        if (not self.episode_costs
                or self.global_step < self.lambda_update_delay_steps):
            return
        episode_cost = float(np.mean(self.episode_costs))
        grad = -(episode_cost - self.threshold) * np.exp(self.log_lambda)
        grad = float(np.clip(grad, -1e6, 1e6))
        self.log_lambda -= self.lambda_lr * grad
        if self.lambda_max:
            self.log_lambda = min(self.log_lambda,
                                  float(np.log(float(self.lambda_max))))


def main():
    trainer_main(SafeRLHFTrainer, task='text_to_text/saferlhf')


if __name__ == '__main__':
    sys.exit(main())
