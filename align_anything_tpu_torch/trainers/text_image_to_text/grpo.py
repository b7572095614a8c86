"""Text-image-to-text GRPO, the port of
``align_anything_tpu/trainers/text_image_to_text/grpo.py`` (GRPO over
image prompts; the reference has it for text only,
trainers/text_to_text/grpo.py:230-335).

Launch:
    python -m align_anything_tpu_torch.trainers.text_image_to_text.grpo \\
        --actor_model_name_or_path <LLaVA dir> \\
        --reward_model_name_or_path <TI2T RM slice dir> \\
        --train_datasets <path> --train_template AA_TI2T \\
        --num_generations 4 --output_dir ./output/ti2t_grpo

The text ``GRPOTrainer``'s loss and update over three LLaVA-class trees:
the actor (trained), its frozen fp32 copy as the reference, and the
reward model (frozen, its head from ``score_head.npy``).  A round repeats
each prompt and its pixels ``num_generations`` times, generates with the
image prefill, scores the end states with the reward model and the
pixels, and makes one update over all rows with the pixel-aware
log-probs.  ``perf/*`` splits the round as the text trainer does.  No
generation eval, as in JAX.

Freeze flags (ROADMAP §3 R13): ``grpo.yaml`` sets ``freeze_vision_tower``,
but JAX's ``build_optimizer`` labels ``self.params``, which this trainer
never sets, so the actor's tower and projector train; the port does the
same and says so in one line at start-up.
"""

from __future__ import annotations

import sys
import time
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.ppo import (
    TI2TRLMixin,
)
from align_anything_tpu_torch.trainers.text_image_to_text.rm import (
    multimodal_end_scores,
)
from align_anything_tpu_torch.trainers.text_to_text.grpo import GRPOTrainer


class TI2TGRPOTrainer(TI2TRLMixin, GRPOTrainer):
    def init_models(self) -> None:
        self.load_actor()
        mc = self.cfgs.model_cfgs
        self.reward_params, self.reward_cfg = self.load_score(
            mc.reward_model_name_or_path or mc.actor_model_name_or_path)

    @torch.no_grad()
    def reward_scores(self, seq: torch.Tensor, mask: torch.Tensor,
                      pixel_values: torch.Tensor | None = None
                      ) -> torch.Tensor:
        """(B,) reward end scores of rollout sequences and their images."""
        return multimodal_end_scores(
            self.reward_params, self.reward_cfg,
            {'input_ids': seq, 'attention_mask': mask,
             'pixel_values': pixel_values})

    def train_step(self, prompt_batch: dict) -> dict[str, Any]:
        t0 = time.perf_counter()
        g = self.num_generations
        pixels = self.prompt_pixels(prompt_batch).repeat_interleave(g, 0)
        prompts = self.put_batch({
            'input_ids': np.repeat(prompt_batch['input_ids'], g, axis=0),
            'attention_mask': np.repeat(prompt_batch['attention_mask'], g,
                                        axis=0)})
        p = prompts['input_ids'].shape[1]
        gen = self.generate_with_image(prompts, pixels)
        self._sync()
        t1 = time.perf_counter()
        rewards = self.reward_scores(gen['sequences'], gen['attention_mask'],
                                     pixels)
        self._sync()
        t2 = time.perf_counter()
        batch = {
            'input_ids': gen['sequences'],
            'attention_mask': gen['attention_mask'],
            'rewards': rewards,
            'completion_mask': gen['completion_mask'],
            'pixel_values': pixels,
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
    trainer_main(TI2TGRPOTrainer, task='text_image_to_text/grpo')


if __name__ == '__main__':
    sys.exit(main())
