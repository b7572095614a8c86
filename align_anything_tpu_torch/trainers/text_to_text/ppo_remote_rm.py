"""PPO with a remote rule-based reward server, the port of
``align_anything_tpu/trainers/text_to_text/ppo_remote_rm.py`` (reference:
trainers/text_to_text/ppo_remote_rm.py:127-364).

Launch (a server first: ``python -m
align_anything_tpu_torch.models.remote_rm.server --port 6000``):
    python -m align_anything_tpu_torch.trainers.text_to_text.ppo_remote_rm \\
        --actor_model_name_or_path <dir|preset> \\
        --train_datasets <path> --train_template PKUSafeRLHF \\
        --reward_server_endpoint http://127.0.0.1:6000/get_reward \\
        --output_dir ./output/ppo_remote_rm

``PPOTrainer`` with no local reward model: the scalar reward of a rollout is
the server's answer to a ``/get_reward`` POST of the decoded prompts and
completions (pads stripped, ``skip_special_tokens=True``), as float32.  The
critic still trains locally; it loads from
``reward_critic_model_name_or_path``, or else from the actor's checkpoint.
The rollout always runs ``generate``, the batch engine, whatever
``rollout_backend`` says, as the JAX trainer does.

The JAX trainer keeps the critic's starting params as a placeholder reward
model, runs a reward forward with them in every scoring pass and then
overwrites its result with the server's; the port skips that forward (the
rollout's keys are the same).  The placeholder stays, a frozen copy of the
critic as it starts, because the generation eval reads it: ``eval/reward``
is that critic's end score, not the server's (ROADMAP R11).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.generation import generate
from align_anything_tpu_torch.models.remote_rm import RemoteRewardModel
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.ppo import (
    PPOTrainer,
    load_score_model_params,
)
from align_anything_tpu_torch.utils.tools import tree_map


class PPORemoteRMTrainer(PPOTrainer):
    def init_models(self) -> None:
        mc = self.cfgs.model_cfgs
        actor_params, self.model_cfg = self.load_model(
            mc.actor_model_name_or_path, self.next_rng)
        self.tokenizer = self.load_tokenizer_for(
            mc.actor_model_name_or_path, self.model_cfg, padding_side='left')
        self.actor_params = self.trainable(
            self.shard_model_params(actor_params, self.model_cfg))
        self.ref_params = tree_map(lambda t: t.detach().clone(),
                                   self.actor_params)

        # the critic only; the reward signal is the remote server
        critic_path = (mc.reward_critic_model_name_or_path
                       or mc.actor_model_name_or_path)
        critic_params, self.critic_cfg = self.load_model(critic_path,
                                                         self.next_rng)
        critic_params.update(load_score_model_params(
            critic_path if critic_path and os.path.isdir(critic_path) else None,
            self.critic_cfg.hidden_size, self.next_rng(), self.device))
        self.critic_params = self.trainable(critic_params)

        # the placeholder reward model: the critic as it starts (R11)
        self.reward_cfg = self.critic_cfg
        self.reward_params = tree_map(lambda t: t.detach().clone(),
                                      self.critic_params)
        self.reward_tokenizer = self.tokenizer

        endpoint = (self.cfgs.train_cfgs.reward_server_endpoint
                    or 'http://127.0.0.1:6000/get_reward')
        self.remote_rm = RemoteRewardModel(
            endpoint,
            timeout=int(self.cfgs.train_cfgs.reward_server_timeout or 100))

    def init_engines(self) -> None:
        if self.lora_requested():
            # JAX's rollout generates from the adapter tree as if it were
            # the model (ppo_remote_rm.py:63) and fails at the first round
            # (ROADMAP R18)
            raise ValueError('remote-RM PPO does not run with '
                             'lora_cfgs.use_lora: its rollout reads the '
                             'adapters as the model, in the reference '
                             'trainer too')
        super().init_engines()

    def decode_rollout(self, prompt_ids: np.ndarray, completions: np.ndarray
                       ) -> tuple[list[str], list[str]]:
        """Prompts and completions as text, pads stripped (reference
        ppo_remote_rm.py:127-167)."""
        pad = self.tokenizer.pad_token_id

        def text(row):
            return self.tokenizer.decode([t for t in row if t != pad],
                                         skip_special_tokens=True)

        return ([text(row) for row in prompt_ids],
                [text(row) for row in completions])

    def rollout(self, prompt_batch: dict) -> dict[str, Any]:
        t0 = time.perf_counter()
        prompts = self.put_batch(prompt_batch)
        gen = generate(self.actor_state.params, self.model_cfg, self.gen_cfg,
                       prompts['input_ids'], prompts['attention_mask'],
                       self.next_rng())
        seq, seq_mask = gen['sequences'], gen['attention_mask']
        prompt_ids = np.asarray(prompt_batch['input_ids'])
        texts = self.decode_rollout(prompt_ids,
                                    gen['completions'].cpu().numpy())
        t1 = time.perf_counter()
        rewards = self.remote_rm.score(*texts)
        reward = torch.from_numpy(rewards.astype(np.float32)).to(self.device)
        scores = self.score_rollout(seq, seq_mask, reward=reward)
        self._sync()
        p = prompt_ids.shape[1]
        return {
            'input_ids': seq,
            'attention_mask': seq_mask,
            'start': p - 1,
            **scores,
            'perf/rollout_s': t1 - t0,
            'perf/scoring_s': time.perf_counter() - t1,
            'perf/generated_tokens': int(seq_mask[:, p:].sum()),
        }


def main():
    trainer_main(PPORemoteRMTrainer, task='text_to_text/ppo')


if __name__ == '__main__':
    sys.exit(main())
