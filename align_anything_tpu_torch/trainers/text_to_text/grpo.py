"""GRPO trainer: group-relative policy optimization without a critic, the
port of ``align_anything_tpu/trainers/text_to_text/grpo.py`` (reference:
trainers/text_to_text/grpo.py:230-335).

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.grpo \\
        --actor_model_name_or_path <dir|preset> \\
        --reward_model_name_or_path <RM slice dir> \\
        --train_datasets <path> --train_template PKUSafeRLHF \\
        --num_generations 4 --output_dir ./output/grpo

Three param trees on the trainer's device: the actor (trained), a frozen
fp32 copy of it as the reference, and the reward model (frozen; a score
model whose head comes from ``score_head.npy`` beside its checkpoint, or a
fresh init where there is none).

Per prompt batch (``train_step``): each prompt is repeated
``num_generations`` times, a group's rows consecutive; ``generate`` samples
the completions from the actor's live params; the reward model scores the
end states under ``torch.no_grad()``; the advantages are normalized within
each group; then one update over all B x G rows (no micro-batches) applies
GRPO's token-level loss with the KL to the reference, whose log-probs are
computed under ``torch.no_grad()``.  Log-probs are sliced from the prompt
block's length - 1, the first completion token.  ``train/lr`` is the
schedule at the step count after the update.  ``perf/rollout_s``,
``perf/scoring_s`` and ``perf/update_s`` split the round's wall clock and
``perf/generated_tokens`` counts the completion tokens.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.data import PromptOnlyDataset
from align_anything_tpu_torch.generation import GenerationConfig, generate
from align_anything_tpu_torch.losses import grpo_group_advantages, grpo_loss
from align_anything_tpu_torch.models import score_model
from align_anything_tpu_torch.ops.logprobs import token_logprobs
from align_anything_tpu_torch.trainers.base import TrainerBase
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.ppo import (
    load_score_model_params,
)
from align_anything_tpu_torch.utils.tools import tree_map


class GRPOTrainer(TrainerBase):
    def init_models(self) -> None:
        mc = self.cfgs.model_cfgs
        actor_params, self.model_cfg = self.load_model(
            mc.actor_model_name_or_path, self.next_rng)
        self.tokenizer = self.load_tokenizer_for(
            mc.actor_model_name_or_path, self.model_cfg, padding_side='left')
        self.actor_params = self.trainable(
            self.shard_model_params(actor_params, self.model_cfg))
        # the frozen reference is the starting policy, in fp32
        self.ref_params = tree_map(lambda t: t.detach().clone(),
                                   self.actor_params)

        reward_path = mc.reward_model_name_or_path
        self.reward_params, self.reward_cfg = self.load_model(reward_path,
                                                              self.next_rng)
        self.reward_params.update(load_score_model_params(
            reward_path if reward_path and os.path.isdir(reward_path) else None,
            self.reward_cfg.hidden_size, self.next_rng(), self.device))

    def init_datasets(self) -> None:
        dc = self.cfgs.data_cfgs
        template = self.make_chat_template(dc.train_template, self.tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        dataset = PromptOnlyDataset(
            dc.train_datasets, template, self.tokenizer, max_length=max_len,
            split=dc.train_split, size=dc.train_size,
            data_files=dc.train_data_files)
        # one device: every global batch is the per-device batch
        prompt_bs = int(self.cfgs.train_cfgs.per_device_prompt_batch_size or 1)
        self.train_iterator = self.make_iterator(
            dataset, prompt_bs,
            dataset.get_collator(buckets=self.padding_buckets()))
        self.make_eval_prompt_iterator(PromptOnlyDataset, self.tokenizer)

    def init_engines(self) -> None:
        tc = self.cfgs.train_cfgs
        self.num_generations = int(tc.num_generations or 4)
        self.beta = float(tc.beta if tc.beta is not None else 0.04)
        total = self.total_training_steps(self.train_iterator)
        tx, self.schedule = self.build_optimizer(total)
        # JAX's GRPO never calls init_peft: it trains the full actor whatever
        # lora_cfgs and bnb_cfgs say (ROADMAP R17), and so does the port
        bc = self.cfgs.bnb_cfgs
        if self.lora_requested() or (bc and bc.use_bnb):
            self.logger.print('GRPO ignores lora_cfgs and bnb_cfgs, as the '
                              'reference trainer does: it trains the full '
                              'actor in fp32')
        self.actor_state = self.build_train_state(self.actor_params, tx)
        del self.actor_params
        self.gen_cfg = GenerationConfig(
            max_new_tokens=int(tc.max_new_tokens or 256),
            temperature=float(tc.temperature if tc.temperature is not None
                              else 1.0),
            top_p=float(tc.top_p if tc.top_p is not None else 1.0))
        self._step = self.compile_train_step(self.loss_fn, tx, self.schedule)

    # model-dependent hooks --------------------------------------------

    def compute_actor_logprobs(self, params: dict, batch: dict
                               ) -> torch.Tensor:
        return token_logprobs(params, self.model_cfg, batch['input_ids'],
                              attention_mask=batch['attention_mask'])

    @torch.no_grad()
    def reward_scores(self, seq: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
        """(B,) reward end scores of rollout sequences."""
        return score_model.forward(self.reward_params, self.reward_cfg, seq,
                                   attention_mask=mask
                                   ).end_scores.squeeze(-1)

    # ------------------------------------------------------------------

    def loss_fn(self, params: dict, batch: dict, prompt_len: int
                ) -> tuple[torch.Tensor, dict]:
        rewards = batch['rewards']
        completion_mask = batch['completion_mask'].float()
        advantages = grpo_group_advantages(rewards, self.num_generations)
        logp = self.compute_actor_logprobs(params, batch)
        per_token_logps = logp[:, prompt_len - 1:]
        with torch.no_grad():
            ref_logp = self.compute_actor_logprobs(
                self.ref_params, batch)[:, prompt_len - 1:]
        out = grpo_loss(per_token_logps, ref_logp, advantages,
                        completion_mask, self.beta)
        return out['loss'], {'train/loss': out['loss'].detach(),
                             'train/kl': out['kl'],
                             'train/reward': rewards.mean()}

    def train_step(self, prompt_batch: dict) -> dict[str, Any]:
        t0 = time.perf_counter()
        g = self.num_generations
        prompts = self.put_batch({
            'input_ids': np.repeat(prompt_batch['input_ids'], g, axis=0),
            'attention_mask': np.repeat(prompt_batch['attention_mask'], g,
                                        axis=0)})
        p = prompts['input_ids'].shape[1]
        gen = generate(self.actor_state.params, self.model_cfg, self.gen_cfg,
                       prompts['input_ids'], prompts['attention_mask'],
                       self.next_rng())
        self._sync()
        t1 = time.perf_counter()
        rewards = self.reward_scores(gen['sequences'], gen['attention_mask'])
        self._sync()
        t2 = time.perf_counter()
        batch = {
            'input_ids': gen['sequences'],
            'attention_mask': gen['attention_mask'],
            'rewards': rewards,
            'completion_mask': gen['completion_mask'],
        }
        self.actor_state, metrics = self._step(self.actor_state, batch, p)
        metrics = {k: float(v) for k, v in metrics.items()}
        self._sync()
        metrics['train/lr'] = float(self.schedule(self.actor_state.step))
        metrics['perf/rollout_s'] = t1 - t0
        metrics['perf/scoring_s'] = t2 - t1
        metrics['perf/update_s'] = time.perf_counter() - t2
        metrics['perf/generated_tokens'] = int(
            gen['attention_mask'][:, p:].sum())
        return metrics

    def eval(self) -> dict[str, float]:
        """Generation-based eval with the table dump (rl_trainer.py:288-329),
        plus the reward model's mean score over the eval completions."""
        with torch.no_grad():
            return self.generation_eval(self.actor_state.params,
                                        score_fn=self.reward_scores)

    def save(self, tag: int | None = None) -> None:
        self.save_state_and_slice(self.actor_state, self.model_cfg,
                                  self.tokenizer, tag)


def main():
    trainer_main(GRPOTrainer, task='text_to_text/grpo')


if __name__ == '__main__':
    sys.exit(main())
