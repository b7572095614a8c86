"""Text-image-to-text PPO, the port of
``align_anything_tpu/trainers/text_image_to_text/ppo.py`` (reference:
trainers/text_image_to_text/ppo.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_image_to_text.ppo \\
        --actor_model_name_or_path <LLaVA dir> \\
        --reward_model_name_or_path <TI2T RM slice dir> \\
        --train_datasets <path> --train_template AA_TI2T \\
        --output_dir ./output/ti2t_ppo

The text ``PPOTrainer`` over four LLaVA-class trees on the trainer's
device: the actor (trained), a frozen fp32 copy of it as the reference,
the reward model (frozen) and the critic (trained), the last two with
their score heads from ``score_head.npy`` beside their checkpoints (the
TI2T RM trainer's export); the critic defaults to the reward model's
checkpoint.  Prompts come from ``TI2TPromptOnlyDataset``.

A round: ``generate`` with the image prefill (``multimodal.forward`` over
the prompt and its pixels, then ``multimodal.decode_forward`` a token a
step over the cache), always in lockstep, as JAX's TI2T rollout replaces
the text one (``rollout_backend`` is not read); then one scoring pass
with the pixels under ``torch.no_grad()``; then the text trainer's
micro-batch updates, each micro-batch with its rows' pixels.  The
``perf/*`` keys are the text trainer's.  No PTX and no generation eval,
as in JAX.  ``save`` writes the actor only.

Freeze flags (ROADMAP §3 R13): ``ppo.yaml`` sets
``freeze_vision_tower``, but JAX builds both optimizers without frozen
labels, so the actor's and the critic's towers and projectors train.
The port builds them the same way and says so in one line at start-up.
The config takes the run's compute dtype and no remat, as in JAX.
"""

from __future__ import annotations

import sys
import time
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.data.image import (
    ImageProcessor,
    ImageProcessorConfig,
    TI2TPromptOnlyDataset,
)
from align_anything_tpu_torch.generation import generate
from align_anything_tpu_torch.models import multimodal, score_model
from align_anything_tpu_torch.trainers.base import TrainerBase
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.rm import (
    multimodal_end_scores,
    multimodal_scores,
)
from align_anything_tpu_torch.trainers.text_image_to_text.sft import (
    compute_config,
    load_vision_lm,
)
from align_anything_tpu_torch.trainers.text_to_text.ppo import PPOTrainer
from align_anything_tpu_torch.utils.tools import tree_map


class TI2TRLMixin:
    """What the TI2T RL trainers (PPO, GRPO, Safe-RLHF-V) share: the
    multimodal actor and score models, the image prompt set, the
    pixel-aware actor log-probs, the image-prefilled ``generate``, and
    JAX's freezing (none: R13)."""

    def load_actor(self) -> None:
        """The actor from ``actor_model_name_or_path`` (trainable fp32)
        and its frozen fp32 copy as the reference, a full one: the actor's
        tower trains (R13)."""
        path = self.cfgs.model_cfgs.actor_model_name_or_path
        params, cfg, _ = load_vision_lm(path, device=self.device)
        self.model_cfg = compute_config(self, cfg)
        self.tokenizer = self.load_tokenizer_for(path, self.model_cfg,
                                                 padding_side='left')
        self.actor_params = self.trainable(params)
        self.ref_params = tree_map(lambda t: t.detach().clone(),
                                   self.actor_params)

    def load_score(self, path: str) -> tuple[dict, Any]:
        """A multimodal score model: the trunk from ``path`` in the actor's
        compute dtype and its head from ``score_head.npy`` beside it (a
        fresh one where there is none)."""
        params, cfg, _ = load_vision_lm(path, device=self.device)
        cfg = cfg.replace(compute_dtype=self.model_cfg.compute_dtype)
        params['score_head'] = {'w': score_model.load_score_head(
            path, cfg.hidden_size, self.next_rng(), device=self.device)}
        return params, cfg

    def init_datasets(self) -> None:
        dc = self.cfgs.data_cfgs
        template = self.make_chat_template(dc.train_template, self.tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        dataset = TI2TPromptOnlyDataset(
            dc.train_datasets, template, self.tokenizer,
            image_token_id=self.model_cfg.image_token_id,
            num_patches=self.model_cfg.vision.num_patches,
            image_processor=ImageProcessor(ImageProcessorConfig(
                size=self.model_cfg.vision.image_size)),
            max_length=max_len, split=dc.train_split, size=dc.train_size,
            data_files=dc.train_data_files)
        # one device: every global batch is the per-device batch
        prompt_bs = int(self.cfgs.train_cfgs.per_device_prompt_batch_size
                        or 1)
        self.train_iterator = self.make_iterator(
            dataset, prompt_bs,
            dataset.get_collator(buckets=self.padding_buckets()))
        self.eval_iterator = None
        self.ptx_iterator = None

    def frozen_modules(self) -> tuple[str, ...]:
        """None (R13): JAX's TI2T PPO builds its optimizers with
        ``make_optimizer`` and no frozen labels, and its TI2T GRPO's
        ``build_optimizer`` finds no ``self.params`` to label."""
        return ()

    def init_engines(self) -> None:
        named = TrainerBase.frozen_modules(self)
        if named:
            self.logger.print(
                f'freeze flags name {named}; as in JAX, the TI2T RL '
                'trainers freeze nothing, so they train them (ROADMAP §3 '
                'R13)')
        super().init_engines()

    def compute_actor_logprobs(self, params: dict, batch: dict
                               ) -> torch.Tensor:
        return multimodal.token_logprobs(
            params, self.model_cfg, batch['input_ids'],
            attention_mask=batch['attention_mask'],
            pixel_values=batch.get('pixel_values'))

    def prompt_pixels(self, prompt_batch: dict) -> torch.Tensor:
        """(B, C, H, W) fp32 pixels of a prompt batch, on the device."""
        pixels = np.stack([m.get('pixel_values')
                           for m in prompt_batch['meta']]).astype(np.float32)
        return self.put_batch({'pixel_values': pixels})['pixel_values']

    def generate_with_image(self, prompts: dict, pixels: torch.Tensor
                            ) -> dict[str, torch.Tensor]:
        """The actor's completions of left-padded prompts whose prefill
        takes their images."""
        return generate(self.actor_state.params, self.model_cfg,
                        self.gen_cfg, prompts['input_ids'],
                        prompts['attention_mask'], self.next_rng(),
                        pixel_values=pixels,
                        prefill_forward=multimodal.forward,
                        step_forward=multimodal.decode_forward)


class TI2TPPOTrainer(TI2TRLMixin, PPOTrainer):
    def init_models(self) -> None:
        self.load_actor()
        mc = self.cfgs.model_cfgs
        reward_path = (mc.reward_model_name_or_path
                       or mc.actor_model_name_or_path)
        critic_path = mc.reward_critic_model_name_or_path or reward_path
        self.reward_params, self.reward_cfg = self.load_score(reward_path)
        critic_params, self.critic_cfg = self.load_score(critic_path)
        self.critic_params = self.trainable(critic_params)

    def compute_critic_values(self, params: dict, batch: dict
                              ) -> torch.Tensor:
        return multimodal_scores(params, self.critic_cfg, batch)[:, :-1]

    @torch.no_grad()
    def score_rollout(self, seq: torch.Tensor, mask: torch.Tensor,
                      pixel_values: torch.Tensor
                      ) -> dict[str, torch.Tensor]:
        """The post-generation scoring pass over the rollout and its
        images: actor and reference log-probs, reward end scores, critic
        values."""
        batch = {'input_ids': seq, 'attention_mask': mask,
                 'pixel_values': pixel_values}
        return {
            'log_probs': self.compute_actor_logprobs(
                self.actor_state.params, batch),
            'ref_log_probs': self.compute_actor_logprobs(self.ref_params,
                                                         batch),
            'reward': multimodal_end_scores(self.reward_params,
                                            self.reward_cfg, batch),
            'reward_values': self.compute_critic_values(
                self.critic_state.params, batch),
        }

    def rollout(self, prompt_batch: dict) -> dict[str, Any]:
        t0 = time.perf_counter()
        pixels = self.prompt_pixels(prompt_batch)
        gen = self.generate_with_image(self.put_batch(prompt_batch), pixels)
        seq, seq_mask = gen['sequences'], gen['attention_mask']
        self._sync()
        t1 = time.perf_counter()
        scores = self.score_rollout(seq, seq_mask, pixels)
        self._sync()
        p = prompt_batch['input_ids'].shape[1]
        return {
            'input_ids': seq,
            'attention_mask': seq_mask,
            'pixel_values': pixels,
            'start': p - 1,
            **scores,
            'perf/rollout_s': t1 - t0,
            'perf/scoring_s': time.perf_counter() - t1,
            'perf/generated_tokens': int(seq_mask[:, p:].sum()),
        }

    def _micro_batches(self, rollout: dict):
        for i, micro in enumerate(super()._micro_batches(rollout)):
            lo = i * self.micro_bs
            micro['pixel_values'] = rollout['pixel_values'][
                lo:lo + self.micro_bs]
            yield micro


def main():
    trainer_main(TI2TPPOTrainer, task='text_image_to_text/ppo')


if __name__ == '__main__':
    sys.exit(main())
