"""Text-audio-to-text PPO, the port of
``align_anything_tpu/trainers/text_audio_to_text/ppo.py`` (reference:
trainers/text_audio_to_text/ppo.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_audio_to_text.ppo \\
        --model_name_or_path <Qwen2-Audio dir | text dir | preset> \\
        --train_datasets <path> --train_template AA_TA2T \\
        --output_dir ./output/ta2t_ppo

The text ``PPOTrainer`` over four audio-LM trees on the trainer's device,
all from ``model_name_or_path`` (loaded as TA2T SFT loads it): the actor
(trained), a frozen fp32 copy of it as the reference, and two more copies
with fresh fp32 score heads as the reward model (frozen) and the critic
(trained), as in JAX (``reward_model_name_or_path`` is not read).

A round: ``generate`` with the audio prefill (``audio.forward`` over the
prompt and its clips through ``media={'audio_values': ...}``, then
``audio.decode_forward`` a token a step over the cache); one scoring pass
with the clips under ``torch.no_grad()``; then the text trainer's
micro-batch updates, each with its rows' clips.  No PTX and no generation
eval, as in JAX.  ``save`` writes the actor's train state alone.

Freeze flags (ROADMAP §3 R13): ``ppo.yaml`` sets ``freeze_audio_tower``,
but JAX builds both optimizers without frozen labels, so the actor's and
the critic's towers train; the port does the same and says so in one line
at start-up.
"""

from __future__ import annotations

import sys
import time
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.data.audio import TA2TPromptOnlyDataset
from align_anything_tpu_torch.generation import generate
from align_anything_tpu_torch.models import audio, score_model
from align_anything_tpu_torch.trainers.base import FreezesNothingMixin
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_audio_to_text.rm import (
    audio_end_scores,
    audio_scores,
)
from align_anything_tpu_torch.trainers.text_audio_to_text.sft import (
    TA2TTrainerMixin,
)
from align_anything_tpu_torch.trainers.text_to_text.ppo import PPOTrainer
from align_anything_tpu_torch.utils.tools import tree_map


class TA2TRLMixin(FreezesNothingMixin, TA2TTrainerMixin):
    """What the TA2T RL trainers (PPO, GRPO) share: the audio actor, its
    reference and score copies, the audio prompt set, the audio-aware
    actor log-probs, the audio-prefilled ``generate``, and JAX's freezing
    (none: R13)."""

    def load_actor(self) -> None:
        """The actor (trainable fp32) and its frozen fp32 copy as the
        reference, a full one: the actor's tower trains (R13)."""
        self.actor_params = self.trainable(self.load_audio_lm())
        self.ref_params = tree_map(lambda t: t.detach().clone(),
                                   self.actor_params)

    def score_copy(self) -> dict:
        """A copy of the actor's starting tree with a fresh fp32 score
        head."""
        params = tree_map(lambda t: t.detach().clone(), self.actor_params)
        params['score_head'] = {'w': score_model.load_score_head(
            None, self.model_cfg.hidden_size, self.next_rng(),
            device=self.device)}
        return params

    def init_datasets(self) -> None:
        dc = self.cfgs.data_cfgs
        template = self.make_chat_template(dc.train_template, self.tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        dataset = self.make_dataset(
            TA2TPromptOnlyDataset, dc.train_datasets, template, max_len,
            split=dc.train_split, size=dc.train_size,
            data_files=dc.train_data_files)
        # one device: every global batch is the per-device batch
        prompt_bs = int(self.cfgs.train_cfgs.per_device_prompt_batch_size
                        or 1)
        self.train_iterator = self.make_iterator(
            dataset, prompt_bs,
            dataset.get_collator(buckets=self.padding_buckets()))
        self.eval_iterator = None
        self.ptx_iterator = None

    def compute_actor_logprobs(self, params: dict, batch: dict
                               ) -> torch.Tensor:
        return audio.token_logprobs(
            params, self.model_cfg, batch['input_ids'],
            attention_mask=batch['attention_mask'],
            audio_values=batch.get('audio_values'))

    def prompt_waves(self, prompt_batch: dict) -> torch.Tensor:
        """(B, waveform_len) fp32 clips of a prompt batch, on the device."""
        waves = np.stack([m.get('audio_values')
                          for m in prompt_batch['meta']]).astype(np.float32)
        return self.put_batch({'audio_values': waves})['audio_values']

    def generate_with_audio(self, prompts: dict, waves: torch.Tensor
                            ) -> dict[str, torch.Tensor]:
        """The actor's completions of left-padded prompts whose prefill
        takes their clips."""
        return generate(self.actor_state.params, self.model_cfg,
                        self.gen_cfg, prompts['input_ids'],
                        prompts['attention_mask'], self.next_rng(),
                        media={'audio_values': waves},
                        prefill_forward=audio.forward,
                        step_forward=audio.decode_forward)

    def save(self, tag: int | None = None) -> None:
        self.save_train_state_only(self.actor_state, tag)


class TA2TPPOTrainer(TA2TRLMixin, PPOTrainer):
    def init_models(self) -> None:
        self.load_actor()
        self.reward_cfg = self.critic_cfg = self.model_cfg
        self.reward_params = self.score_copy()
        self.critic_params = self.trainable(self.score_copy())

    def compute_critic_values(self, params: dict, batch: dict
                              ) -> torch.Tensor:
        return audio_scores(params, self.critic_cfg, batch)[:, :-1]

    @torch.no_grad()
    def score_rollout(self, seq: torch.Tensor, mask: torch.Tensor,
                      audio_values: torch.Tensor
                      ) -> dict[str, torch.Tensor]:
        """The post-generation scoring pass over the rollout and its clips:
        actor and reference log-probs, reward end scores, critic values."""
        batch = {'input_ids': seq, 'attention_mask': mask,
                 'audio_values': audio_values}
        return {
            'log_probs': self.compute_actor_logprobs(
                self.actor_state.params, batch),
            'ref_log_probs': self.compute_actor_logprobs(self.ref_params,
                                                         batch),
            'reward': audio_end_scores(self.reward_params, self.reward_cfg,
                                       batch),
            'reward_values': self.compute_critic_values(
                self.critic_state.params, batch),
        }

    def rollout(self, prompt_batch: dict) -> dict[str, Any]:
        t0 = time.perf_counter()
        waves = self.prompt_waves(prompt_batch)
        gen = self.generate_with_audio(self.put_batch(prompt_batch), waves)
        seq, seq_mask = gen['sequences'], gen['attention_mask']
        self._sync()
        t1 = time.perf_counter()
        scores = self.score_rollout(seq, seq_mask, waves)
        self._sync()
        p = prompt_batch['input_ids'].shape[1]
        return {
            'input_ids': seq,
            'attention_mask': seq_mask,
            'audio_values': waves,
            'start': p - 1,
            **scores,
            'perf/rollout_s': t1 - t0,
            'perf/scoring_s': time.perf_counter() - t1,
            'perf/generated_tokens': int(seq_mask[:, p:].sum()),
        }

    def _micro_batches(self, rollout: dict):
        for i, micro in enumerate(super()._micro_batches(rollout)):
            lo = i * self.micro_bs
            micro['audio_values'] = rollout['audio_values'][
                lo:lo + self.micro_bs]
            yield micro


def main():
    trainer_main(TA2TPPOTrainer, task='text_audio_to_text/ppo')


if __name__ == '__main__':
    sys.exit(main())
