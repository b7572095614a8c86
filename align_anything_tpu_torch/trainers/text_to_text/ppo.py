"""PPO trainer: four models on one GPU, the port of
``align_anything_tpu/trainers/text_to_text/ppo.py`` (reference:
trainers/text_to_text/ppo.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.ppo \\
        --actor_model_name_or_path <dir|preset> \\
        --reward_model_name_or_path <RM slice dir> \\
        --train_datasets <path> --train_template PKUSafeRLHF \\
        --output_dir ./output/ppo

The actor (trained), a frozen fp32 copy of it as the reference, the reward
model (frozen) and the critic (trained) are four param trees on the
trainer's device.  The reward and critic are score models whose heads come
from ``score_head.npy`` beside their checkpoint (the RM trainer's export),
or a fresh init where there is none; the critic defaults to the reward
model's checkpoint.  Rollouts run the actor's live params, so there is no
weight sync.

Per prompt batch (``train_step``):
  1. rollout: ``generate`` (``rollout_backend`` 'batch': one prefill, then
     lockstep decode) or the continuous-batching engine ('continuous':
     per-request admission, lanes retire at EOS), giving the (B, P+T)
     block of left-padded prompts and completions padded after EOS; then
     one scoring pass under ``torch.no_grad()``: actor and reference
     log-probs, critic values and reward end scores (re-tokenized on the
     host first when the reward model's tokenizer differs);
  2. update: ``update_iters`` x micro-batches of ``rl_step``: KL-shaped
     rewards, then GAE or another estimator, then the clipped actor and
     critic losses, each model with its own ``ClippedAdamW`` and schedule;
  3. the optional PTX step after each ``rl_step``: SFT loss x ``ptx_coeff``
     on the actor.
Reported metrics are means over micro-batches x ``update_iters``;
``perf/rollout_s``, ``perf/scoring_s`` and ``perf/update_s`` split the
round's wall clock and ``perf/generated_tokens`` counts the completion
tokens.

With LoRA (``--use_lora``, QLoRA with ``--use_bnb``) the adapters sit on
the actor alone: its train state holds them, the policy is them attached to
the frozen, possibly quantized, base (``actor_policy``), and that base is
the reference, so no second actor-sized tree is held.  The critic and the
reward model stay full.  ``save`` exports the merged actor.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.data import PromptOnlyDataset, SupervisedDataset
from align_anything_tpu_torch.generation import GenerationConfig, generate
from align_anything_tpu_torch.losses import (
    add_kl_divergence_regularization,
    cross_entropy_loss,
    cumulative_returns,
    gae_advantages,
    group_relative_rewards,
    ppo_actor_loss,
    ppo_critic_loss,
)
from align_anything_tpu_torch.models import score_model, transformer
from align_anything_tpu_torch.ops.logprobs import token_logprobs
from align_anything_tpu_torch.trainers.base import (
    TrainerBase,
    TrainState,
    init_train_state,
)
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.optimizer import make_optimizer
from align_anything_tpu_torch.utils.tools import (
    batch_retokenize,
    is_same_tokenizer,
    masked_mean,
    tree_map,
)

ESTIMATORS = ('gae', 'reinforce', 'rloo', 'reinforce_baseline', 'group_norm')


def load_score_model_params(path: str | None, hidden_size: int,
                            generator: torch.Generator,
                            device: torch.device | str | None = None) -> dict:
    """The score head as a param subtree: from ``score_head.npy`` beside
    ``path`` if there is one (the RM trainer saves it), else fresh."""
    return {'score_head': {'w': score_model.load_score_head(
        path, hidden_size, generator, device=device)}}


class PPOTrainer(TrainerBase):
    def init_models(self) -> None:
        mc = self.cfgs.model_cfgs
        actor_params, self.model_cfg = self.load_model(
            mc.actor_model_name_or_path, self.next_rng)
        self.tokenizer = self.load_tokenizer_for(
            mc.actor_model_name_or_path, self.model_cfg, padding_side='left')
        self.actor_params = self.trainable(
            self.shard_model_params(actor_params, self.model_cfg))
        # the frozen reference is the starting policy, in fp32 (with LoRA
        # the frozen base, set in init_engines)
        self.ref_params = (None if self.lora_requested() else
                           tree_map(lambda t: t.detach().clone(),
                                    self.actor_params))

        # reward model (frozen) + critic (trained), both score models
        reward_path = mc.reward_model_name_or_path
        critic_path = mc.reward_critic_model_name_or_path or reward_path
        reward_params, self.reward_cfg = self.load_model(reward_path,
                                                         self.next_rng)
        reward_params.update(load_score_model_params(
            reward_path if reward_path and os.path.isdir(reward_path) else None,
            self.reward_cfg.hidden_size, self.next_rng(), self.device))
        critic_params, self.critic_cfg = self.load_model(critic_path,
                                                         self.next_rng)
        critic_params.update(load_score_model_params(
            critic_path if critic_path and os.path.isdir(critic_path) else None,
            self.critic_cfg.hidden_size, self.next_rng(), self.device))
        self.reward_params = reward_params
        self.critic_params = self.trainable(critic_params)

        # a reward model may ship its own tokenizer (reference
        # ppo.py:225-236 via tools.py:416 batch_retokenize); rollouts are
        # re-tokenized on the host when the vocabularies differ
        self.reward_tokenizer = self.tokenizer
        if reward_path:
            try:
                self.reward_tokenizer = self.load_tokenizer_for(
                    reward_path, self.reward_cfg, padding_side='right')
            except (OSError, ValueError):
                self.reward_tokenizer = self.tokenizer
        if is_same_tokenizer(self.tokenizer, self.reward_tokenizer):
            self.reward_tokenizer = self.tokenizer

    def init_datasets(self) -> None:
        dc = self.cfgs.data_cfgs
        tc = self.cfgs.train_cfgs
        template = self.make_chat_template(dc.train_template, self.tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        dataset = PromptOnlyDataset(
            dc.train_datasets, template, self.tokenizer, max_length=max_len,
            split=dc.train_split, size=dc.train_size,
            data_files=dc.train_data_files)
        buckets = self.padding_buckets()
        # one device: every global batch is the per-device batch
        prompt_bs = int(tc.per_device_prompt_batch_size or 1)
        self.train_iterator = self.make_iterator(
            dataset, prompt_bs, dataset.get_collator(buckets=buckets))

        self.make_eval_prompt_iterator(PromptOnlyDataset, self.tokenizer)

        self.ptx_iterator = None
        if dc.ptx_datasets:
            ptx_template = self.make_chat_template(
                dc.ptx_template or dc.train_template, self.tokenizer)
            ptx_ds = SupervisedDataset(
                dc.ptx_datasets, ptx_template, self.tokenizer,
                max_length=max_len, split=dc.ptx_split, size=dc.ptx_size,
                data_files=dc.ptx_data_files)
            ptx_bs = int(tc.per_device_train_batch_size or 1)
            self.ptx_iterator = self.make_iterator(
                ptx_ds, ptx_bs, ptx_ds.get_collator(buckets=buckets))

    # ------------------------------------------------------------------

    def init_engines(self) -> None:
        tc = self.cfgs.train_cfgs
        total = self.total_training_steps(self.train_iterator)
        self.update_iters = int(tc.update_iters or 1)
        rl_steps = max(total * self.update_iters, 1)

        self.actor_tx, self.actor_schedule = make_optimizer(
            float(tc.actor_lr or 1e-5),
            lr_scheduler_type=tc.actor_lr_scheduler_type or 'cosine',
            total_steps=rl_steps,
            lr_warmup_ratio=float(tc.actor_lr_warmup_ratio or 0.0),
            weight_decay=float(tc.actor_weight_decay or 0.0),
            adam_betas=tuple(tc.adam_betas or (0.9, 0.95)),
            max_grad_norm=float(tc.max_grad_norm or 1.0))
        self.critic_tx, self.critic_schedule = make_optimizer(
            float(tc.critic_lr or 5e-6),
            lr_scheduler_type=tc.critic_lr_scheduler_type or 'constant',
            total_steps=rl_steps,
            lr_warmup_ratio=float(tc.critic_lr_warmup_ratio or 0.0),
            weight_decay=float(tc.critic_weight_decay or 0.0),
            adam_betas=tuple(tc.adam_betas or (0.9, 0.95)),
            max_grad_norm=float(tc.max_grad_norm or 1.0))
        self.params = self.actor_params
        if self.init_peft():
            # actor-adapter (Q)LoRA PPO: the frozen base is the reference
            # too (the reference holds four engines,
            # trainers/base/rl_trainer.py:198)
            self.ref_params = self.base_params
            self.actor_params = self.lora_params
            del self.lora_params
        del self.params
        self.actor_state = init_train_state(self.actor_params, self.actor_tx)
        self.critic_state = init_train_state(self.critic_params,
                                             self.critic_tx)
        del self.actor_params, self.critic_params

        self.gen_cfg = GenerationConfig(
            max_new_tokens=int(tc.max_new_tokens or 512),
            temperature=float(tc.temperature if tc.temperature is not None
                              else 1.0),
            top_p=float(tc.top_p if tc.top_p is not None else 1.0),
            greedy=False)

        self.kl_coeff = float(tc.kl_coeff or 0.02)
        self.clip_ratio = float(tc.clip_range_ratio or 0.2)
        self.clip_score = float(tc.clip_range_score or 50.0)
        self.clip_value = float(tc.clip_range_value or 5.0)
        self.gamma = float(tc.gamma if tc.gamma is not None else 1.0)
        self.gae_lambda = float(tc.gae_lambda if tc.gae_lambda is not None
                                else 0.95)
        # pluggable advantage estimators (multi_ppo.py:95-101,515-566)
        self.estimator = tc.advantage_estimator or 'gae'
        if self.estimator not in ESTIMATORS:
            raise ValueError(f'unknown advantage_estimator '
                             f'{self.estimator!r} ({ESTIMATORS})')
        self.n_samples_per_prompt = int(tc.n_samples_per_prompt or 1)
        if (self.estimator in ('rloo', 'reinforce_baseline', 'group_norm')
                and self.n_samples_per_prompt < 2):
            raise ValueError(f'{self.estimator} requires '
                             'n_samples_per_prompt > 1')
        self.ptx_coeff = float(tc.ptx_coeff if tc.ptx_coeff is not None
                               else 16.0)
        # one device: the micro-batch is the per-device batch
        self.micro_bs = int(tc.per_device_train_batch_size or 1)

        # rollout backend: 'batch' = lockstep padded generate;
        # 'continuous' = per-request admission through the continuous-
        # batching engine, whose short completions retire their lanes early
        self.rollout_backend = str(tc.rollout_backend or 'batch')
        if self.rollout_backend not in ('batch', 'continuous'):
            raise ValueError(f'unknown rollout_backend '
                             f'{self.rollout_backend!r}')
        self.rollout_num_slots = (int(tc.rollout_num_slots)
                                  if tc.rollout_num_slots else None)
        self._cont_engine = None

    def actor_policy(self) -> dict:
        """The actor's params for a forward: the train state's, attached to
        the frozen base under LoRA (JAX ``_actor_policy``)."""
        params = self.actor_state.params
        return (self.lora_policy(params, self.base_params) if self.use_lora
                else params)

    # loss hooks -------------------------------------------------------

    def compute_actor_logprobs(self, params: dict, batch: dict
                               ) -> torch.Tensor:
        return token_logprobs(params, self.model_cfg, batch['input_ids'],
                              attention_mask=batch['attention_mask'])

    def compute_critic_values(self, params: dict, batch: dict
                              ) -> torch.Tensor:
        return score_model.forward(
            params, self.critic_cfg, batch['input_ids'],
            attention_mask=batch['attention_mask']
        ).scores.squeeze(-1)[:, :-1]

    # ------------------------------------------------------------------

    def reward_scores(self, seq: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
        """(B,) reward end scores of rollout sequences; the reward model
        scores its own tokenizer's ids (host-side re-tokenization) when its
        tokenizer differs from the actor's."""
        if self.reward_tokenizer is not self.tokenizer:
            rbatch = self.put_batch(batch_retokenize(
                seq.cpu().numpy(), self.tokenizer, self.reward_tokenizer,
                total_length=seq.shape[1]))
            seq, mask = rbatch['input_ids'], rbatch['attention_mask']
        return score_model.forward(self.reward_params, self.reward_cfg, seq,
                                   attention_mask=mask
                                   ).end_scores.squeeze(-1)

    @torch.no_grad()
    def score_rollout(self, seq: torch.Tensor, mask: torch.Tensor,
                      reward: torch.Tensor | None = None
                      ) -> dict[str, torch.Tensor]:
        """The post-generation scoring pass (ppo.py:224-289 analog).
        ``reward``, when given, stands for the reward model's end scores,
        which are then not computed."""
        return {
            'log_probs': token_logprobs(self.actor_policy(), self.model_cfg,
                                        seq, attention_mask=mask),
            'ref_log_probs': token_logprobs(self.ref_params, self.model_cfg,
                                            seq, attention_mask=mask),
            'reward': (self.reward_scores(seq, mask) if reward is None
                       else reward),
            'reward_values': self.compute_critic_values(
                self.critic_state.params,
                {'input_ids': seq, 'attention_mask': mask}),
        }

    def _generate_continuous(self, prompt_batch: dict
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Continuous-engine rollout: unpad the left-padded prompts into
        per-request token lists, decode with early lane retirement and
        admission, and re-assemble the fixed (B, P+T) block the scoring
        pass expects (the prompt block left-padded exactly as the collator
        built it, so ``start`` stays uniform)."""
        from align_anything_tpu_torch.generation.continuous import (  # noqa: PLC0415
            ContinuousBatchingEngine,
        )

        ids = np.asarray(prompt_batch['input_ids'])
        mask = np.asarray(prompt_batch['attention_mask'])
        b, p = ids.shape
        t = self.gen_cfg.max_new_tokens
        max_len = -(-(p + t) // 256) * 256
        slots = self.rollout_num_slots or min(b, 8)
        if (self._cont_engine is None
                or self._cont_engine.max_len < max_len
                or self._cont_engine.num_slots != slots):
            self._cont_engine = ContinuousBatchingEngine(
                self.model_cfg, num_slots=slots, max_len=max_len)
        prompts = [ids[i][mask[i].astype(bool)].tolist() for i in range(b)]
        outs = self._cont_engine.generate(
            self.actor_policy(), prompts, self.gen_cfg, self.next_rng())
        pad = (self.gen_cfg.pad_token_id
               if self.gen_cfg.pad_token_id is not None
               else self.model_cfg.pad_token_id)
        comp = np.full((b, t), pad, np.int64)
        cmask = np.zeros((b, t), np.int64)
        for i, toks in enumerate(outs):
            toks = toks[:t]
            comp[i, :len(toks)] = toks
            cmask[i, :len(toks)] = 1
        block = self.put_batch({
            'input_ids': np.concatenate([ids.astype(np.int64), comp], axis=1),
            'attention_mask': np.concatenate([mask.astype(np.int64), cmask],
                                             axis=1)})
        return block['input_ids'], block['attention_mask']

    def rollout(self, prompt_batch: dict) -> dict[str, Any]:
        t0 = time.perf_counter()
        if self.rollout_backend == 'continuous':
            seq, seq_mask = self._generate_continuous(prompt_batch)
        else:
            prompts = self.put_batch(prompt_batch)
            gen = generate(self.actor_policy(), self.model_cfg,
                           self.gen_cfg, prompts['input_ids'],
                           prompts['attention_mask'], self.next_rng())
            seq = gen['sequences']
            seq_mask = gen['attention_mask']
        self._sync()
        t1 = time.perf_counter()
        scores = self.score_rollout(seq, seq_mask)
        self._sync()
        p = prompt_batch['input_ids'].shape[1]
        return {
            'input_ids': seq,
            'attention_mask': seq_mask,
            'start': p - 1,
            **scores,
            'perf/rollout_s': t1 - t0,
            'perf/scoring_s': time.perf_counter() - t1,
            'perf/generated_tokens': int(seq_mask[:, p:].sum()),
        }

    def _micro_batches(self, rollout: dict):
        n = rollout['input_ids'].shape[0]
        for i in range(0, n, self.micro_bs):
            sl = slice(i, i + self.micro_bs)
            yield {
                'input_ids': rollout['input_ids'][sl],
                'attention_mask': rollout['attention_mask'][sl],
                'sequence_mask': rollout['attention_mask'][sl, 1:].float(),
                'old_log_probs': rollout['log_probs'][sl],
                'ref_log_probs': rollout['ref_log_probs'][sl],
                'old_reward_values': rollout['reward_values'][sl],
                'reward': rollout['reward'][sl],
            }

    def _update(self, state: TrainState, tx, loss: torch.Tensor,
                scale: float | None = None) -> tuple[TrainState, torch.Tensor]:
        """Backward of ``loss`` into ``state``'s leaves (their gradients
        times ``scale`` when given), then clip and AdamW at
        ``schedule(state.step)``.  Returns the state and the grad norm."""
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if scale is not None:
            for p in state.optimizer.param_groups[0]['params']:
                if p.grad is not None:
                    p.grad.mul_(scale)
        norm = tx.apply_(state.optimizer, state.step)
        return TrainState(state.params, state.optimizer, state.step + 1), norm

    def rl_step(self, batch: dict, start: int) -> dict[str, torch.Tensor]:
        """One PPO update of actor and critic on a micro-batch
        (ppo.py:309-398 analog).  ``start``: the prompt block's length - 1,
        the first log-prob position of the completions."""
        sequence_mask = batch['sequence_mask']
        old_log_probs = batch['old_log_probs']
        ref_log_probs = batch['ref_log_probs']
        reward = batch['reward']

        old_rewards = add_kl_divergence_regularization(
            reward, old_log_probs, ref_log_probs, sequence_mask,
            self.kl_coeff, self.clip_score)
        if self.estimator == 'gae':
            advantages, returns = gae_advantages(
                batch['old_reward_values'], old_rewards, sequence_mask, start,
                self.gamma, self.gae_lambda)
        else:
            shaped = old_rewards
            if self.estimator != 'reinforce':
                shaped = group_relative_rewards(
                    shaped, self.n_samples_per_prompt, self.estimator)
            returns = cumulative_returns(shaped, sequence_mask, start,
                                         self.gamma)
            returns = returns * sequence_mask[:, start:]
            advantages = returns.detach()
        mask = sequence_mask[:, start:]

        log_probs = self.compute_actor_logprobs(self.actor_policy(), batch)
        actor_loss = ppo_actor_loss(log_probs[:, start:],
                                    old_log_probs[:, start:], advantages,
                                    mask, self.clip_ratio)
        self.actor_state, actor_norm = self._update(
            self.actor_state, self.actor_tx, actor_loss)

        values = self.compute_critic_values(self.critic_state.params, batch)
        critic_loss = ppo_critic_loss(values[:, start:],
                                      batch['old_reward_values'][:, start:],
                                      returns, mask, self.clip_value)
        self.critic_state, critic_norm = self._update(
            self.critic_state, self.critic_tx, critic_loss)

        lengths = mask.sum(-1)
        return {
            'train/actor_loss': actor_loss.detach(),
            'train/reward_critic_loss': critic_loss.detach(),
            'train/reward': reward.mean(),
            'train/reward_with_kl_penalty':
                (old_rewards[:, start:] * mask).sum(-1).mean(),
            'train/reward_advantage': masked_mean(advantages, mask),
            'train/reward_return': masked_mean(returns, mask),
            'train/reward_value': masked_mean(values.detach()[:, start:],
                                              mask),
            'train/kl_divergence':
                ((old_log_probs - ref_log_probs)[:, start:] * mask
                 ).sum(-1).mean(),
            'train/mean_generated_length': lengths.mean(),
            'train/max_generated_length': lengths.max(),
            'train/actor_grad_norm': actor_norm,
            'train/reward_critic_grad_norm': critic_norm,
        }

    def ptx_step(self, batch: dict) -> torch.Tensor:
        """SFT loss on a PTX batch; its gradients x ``ptx_coeff`` update
        the actor."""
        logits = transformer.forward(
            self.actor_policy(), self.model_cfg, batch['input_ids'],
            attention_mask=batch['attention_mask']).logits
        loss = cross_entropy_loss(logits, batch['labels'])['loss']
        self.actor_state, _ = self._update(self.actor_state, self.actor_tx,
                                           loss, scale=self.ptx_coeff)
        return loss.detach()

    def train_step(self, prompt_batch: dict) -> dict[str, Any]:
        rollout = self.rollout(prompt_batch)
        t0 = time.perf_counter()
        # reported metrics are the MEAN over every micro-batch x update
        # iteration of the round (reference ppo.py:372-398)
        sums: dict[str, float] = {}
        counts: dict[str, int] = {}
        for _ in range(self.update_iters):
            for micro in self._micro_batches(rollout):
                m = self.rl_step(micro, rollout['start'])
                if self.ptx_iterator is not None:
                    ptx_batch = self.put_batch(next(self._ptx_cycle))
                    m['train/ptx_loss'] = self.ptx_step(ptx_batch)
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
                    counts[k] = counts.get(k, 0) + 1
        metrics: dict[str, Any] = {k: sums[k] / counts[k] for k in sums}
        # a max is not averaged away (the reference reports the round max)
        metrics['train/max_generated_length'] = float(
            rollout['attention_mask'][:, 1:].float()
            [:, rollout['start']:].sum(-1).max())
        metrics['train/actor_lr'] = float(
            self.actor_schedule(self.actor_state.step))
        metrics['train/reward_critic_lr'] = float(
            self.critic_schedule(self.critic_state.step))
        self._sync()
        metrics['perf/update_s'] = time.perf_counter() - t0
        for k in ('perf/rollout_s', 'perf/scoring_s',
                  'perf/generated_tokens'):
            metrics[k] = rollout[k]
        return metrics

    def train(self) -> None:
        if self.ptx_iterator is not None:
            def cycle():
                epoch = 0
                while True:
                    yield from self.ptx_iterator.epoch_batches(epoch)
                    epoch += 1
            self._ptx_cycle = cycle()
        super().train()

    def eval(self) -> dict[str, float]:
        """Generation-based eval with the table dump (rl_trainer.py:288-329),
        plus the reward model's mean score over the eval completions."""
        with torch.no_grad():
            return self.generation_eval(self.actor_policy(),
                                        score_fn=self.reward_scores)

    def save(self, tag: int | None = None) -> None:
        if self.use_lora:
            # the merged actor (base + baked adapters, dense leaves)
            self.save_lora_merged(tag, state=self.actor_state)
            return
        self.save_state_and_slice(self.actor_state, self.model_cfg,
                                  self.tokenizer, tag)


def main():
    trainer_main(PPOTrainer, task='text_to_text/ppo')


if __name__ == '__main__':
    sys.exit(main())
