"""The DPO train step (policy + frozen reference): the step of
``align_anything_tpu/trainers/text_to_text/dpo.py`` ``DPOTrainer``.

A batch is a dict of tensors: ``input_ids`` and ``attention_mask`` (2B, L),
better rows stacked above worse, and ``response_mask`` (2B, L-1).  The
reference model is a second param tree passed to ``step``; its log-probs
are computed under ``torch.no_grad()``.

The trainer's harness (datasets and collators, the tokenizer, loading an HF
checkpoint through ``hf_loader``, checkpoints, the CLI entry point) waits
for the port of ``trainers/base.py`` ``TrainerBase`` (ROADMAP, module
item 3); this module runs the step on params and batches its caller
makes.
"""

from __future__ import annotations

import torch

from align_anything_tpu_torch.losses import dpo_loss
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.ops.logprobs import token_logprobs
from align_anything_tpu_torch.trainers.base import (
    TrainState,
    init_train_state,
    make_train_step,
)
from align_anything_tpu_torch.trainers.optimizer import ClippedAdamW, Schedule


class DPOTrainer:
    def __init__(self, model_cfg: ModelConfig, tx: ClippedAdamW,
                 schedule: Schedule, scale_coeff: float = 0.1):
        self.model_cfg = model_cfg
        self.tx = tx
        self.scale_coeff = scale_coeff
        self._step = make_train_step(self.loss_fn, tx, schedule)

    def init_state(self, params: dict) -> TrainState:
        """Train state over ``params`` (trainable leaves, updated in
        place)."""
        return init_train_state(params, self.tx)

    def compute_token_logprobs(self, params: dict,
                               batch: dict) -> torch.Tensor:
        # chunked vocab projection: never materializes (B, L, V) logits
        return token_logprobs(params, self.model_cfg, batch['input_ids'],
                              attention_mask=batch['attention_mask'])

    def preference_loss(self, logp: torch.Tensor, ref_logp: torch.Tensor,
                        batch: dict) -> dict:
        return dpo_loss(logp, ref_logp, batch['input_ids'],
                        batch['response_mask'], scale_coeff=self.scale_coeff)

    def loss_fn(self, params: dict, ref_params: dict,
                batch: dict) -> tuple[torch.Tensor, dict]:
        logp = self.compute_token_logprobs(params, batch)
        with torch.no_grad():
            ref_logp = self.compute_token_logprobs(ref_params, batch)
        out = self.preference_loss(logp, ref_logp, batch)
        metrics = {
            'train/loss': out['loss'].detach(),
            'train/reward': out['reward'].mean(),
            'train/better_sample_reward': out['better_sample_reward'].mean(),
            'train/worse_sample_reward': out['worse_sample_reward'].mean(),
            'train/reward_accuracy': out['reward_accuracy'],
            'train/reward_margin': out['reward_margin'].mean(),
        }
        return out['loss'], metrics

    def step(self, state: TrainState, ref_params: dict,
             batch: dict) -> tuple[TrainState, dict]:
        """One update: the policy's forward and backward, the reference's
        forward, clip and AdamW.  Params are updated in place."""
        return self._step(state, ref_params, batch)
