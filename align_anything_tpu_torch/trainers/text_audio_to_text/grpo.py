"""Text-audio-to-text GRPO, the port of
``align_anything_tpu/trainers/text_audio_to_text/grpo.py`` (GRPO over
audio prompts; the reference has it for text only,
trainers/text_to_text/grpo.py:230-335).

Launch:
    python -m align_anything_tpu_torch.trainers.text_audio_to_text.grpo \\
        --model_name_or_path <Qwen2-Audio dir | text dir | preset> \\
        --train_datasets <path> --train_template AA_TA2T \\
        --output_dir ./output/ta2t_grpo

The text ``GRPOTrainer``'s loss and update over three audio-LM trees from
``model_name_or_path``: the actor (trained), its frozen fp32 copy as the
reference, and a copy with a fresh fp32 score head as the reward model
(frozen), as in JAX.  A round repeats each prompt and its clip
``num_generations`` times, generates with the audio prefill, scores the
end states with the clips, and makes one update over all rows.  It reads
the task ``text_audio_to_text/ppo``, as JAX does (there is no TA2T GRPO
config): ``num_generations`` and ``beta`` take their defaults (4, 0.04)
unless set through the environment (ROADMAP R9).  ``save`` writes the
actor's train state alone.

Freeze flags (ROADMAP §3 R13): JAX's ``build_optimizer`` labels
``self.params``, which this trainer never sets, so the actor's tower
trains; the port does the same and says so in one line at start-up.
"""

from __future__ import annotations

import sys
import time
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_audio_to_text.ppo import (
    TA2TRLMixin,
)
from align_anything_tpu_torch.trainers.text_audio_to_text.rm import (
    audio_end_scores,
)
from align_anything_tpu_torch.trainers.text_to_text.grpo import GRPOTrainer


class TA2TGRPOTrainer(TA2TRLMixin, GRPOTrainer):
    def init_models(self) -> None:
        self.load_actor()
        self.reward_params = self.score_copy()
        self.reward_cfg = self.model_cfg

    @torch.no_grad()
    def reward_scores(self, seq: torch.Tensor, mask: torch.Tensor,
                      audio_values: torch.Tensor | None = None
                      ) -> torch.Tensor:
        """(B,) reward end scores of rollout sequences and their clips."""
        return audio_end_scores(
            self.reward_params, self.reward_cfg,
            {'input_ids': seq, 'attention_mask': mask,
             'audio_values': audio_values})

    def train_step(self, prompt_batch: dict) -> dict[str, Any]:
        t0 = time.perf_counter()
        g = self.num_generations
        waves = self.prompt_waves(prompt_batch).repeat_interleave(g, 0)
        prompts = self.put_batch({
            'input_ids': np.repeat(prompt_batch['input_ids'], g, axis=0),
            'attention_mask': np.repeat(prompt_batch['attention_mask'], g,
                                        axis=0)})
        p = prompts['input_ids'].shape[1]
        gen = self.generate_with_audio(prompts, waves)
        self._sync()
        t1 = time.perf_counter()
        rewards = self.reward_scores(gen['sequences'], gen['attention_mask'],
                                     waves)
        self._sync()
        t2 = time.perf_counter()
        batch = {
            'input_ids': gen['sequences'],
            'attention_mask': gen['attention_mask'],
            'rewards': rewards,
            'completion_mask': gen['completion_mask'],
            'audio_values': waves,
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


def main():
    trainer_main(TA2TGRPOTrainer, task='text_audio_to_text/ppo')


if __name__ == '__main__':
    sys.exit(main())
