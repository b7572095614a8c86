"""DPO trainer: policy + frozen reference on one GPU, the port of
``align_anything_tpu/trainers/text_to_text/dpo.py``.

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.dpo \\
        --model_name_or_path <dir|preset> --train_datasets <path> \\
        --train_template PKUSafeRLHF --output_dir ./output/dpo

``DPOStep`` is the update step: a batch is a dict of tensors,
``input_ids`` and ``attention_mask`` (2B, L), better rows stacked above
worse, and ``response_mask`` (2B, L-1).  The reference model is a second
param tree passed to ``step``; its log-probs are computed under
``torch.no_grad()``.  ``DPOTrainer`` is the trainer around it
(``trainers/base.py`` ``TrainerBase``): the HF checkpoint or preset, the
tokenizer, the preference dataset and collator, the optimizer, the loop and
the saves.  The reference tree is a frozen copy of the loaded policy.
ORPO and SimPO (``orpo.py``, ``simpo.py``) subclass it without a reference.

With LoRA (``--use_lora``, QLoRA with ``--use_bnb``) the train state holds
the adapters, the policy is the adapters attached to the frozen, possibly
quantized, base (``DPOStep``'s ``policy_of``), and the reference IS that
base: the adapters start at B = 0, so step 1's policy equals it exactly and
no second model is held.  ``save`` exports the merged model.
"""

from __future__ import annotations

import sys
from typing import Any, Callable

import numpy as np
import torch

from align_anything_tpu_torch.data import PreferenceDataset
from align_anything_tpu_torch.losses import dpo_loss
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.ops.logprobs import token_logprobs
from align_anything_tpu_torch.trainers.base import (
    TrainerBase,
    TrainState,
    init_train_state,
    make_train_step,
)
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.optimizer import (
    ClippedAdamW,
    MultiSteps,
    Schedule,
)
from align_anything_tpu_torch.utils.tools import tree_map


class DPOStep:
    """The DPO update step.  ``preference_loss`` (default: ``dpo_loss``)
    may be replaced by a reference-free loss, which gets ``ref_logp=None``
    when ``step`` is given no reference tree; ``compute_token_logprobs``
    (default: the decoder's chunked log-probs) by another model's, such as
    the multimodal one.  ``policy_of``, when given, maps the train state's
    params to the policy's (LoRA: the adapters attached to the base)."""

    def __init__(self, model_cfg: ModelConfig, tx: ClippedAdamW | MultiSteps,
                 schedule: Schedule, scale_coeff: float = 0.1,
                 preference_loss: Callable[..., dict] | None = None,
                 compute_token_logprobs: Callable[..., torch.Tensor]
                 | None = None,
                 policy_of: Callable[[dict], dict] | None = None):
        self.model_cfg = model_cfg
        self.tx = tx
        self.scale_coeff = scale_coeff
        self.policy_of = policy_of
        if preference_loss is not None:
            self.preference_loss = preference_loss
        if compute_token_logprobs is not None:
            self.compute_token_logprobs = compute_token_logprobs
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

    def loss_fn(self, params: dict, ref_params: dict | None,
                batch: dict) -> tuple[torch.Tensor, dict]:
        if self.policy_of is not None:
            params = self.policy_of(params)
        logp = self.compute_token_logprobs(params, batch)
        ref_logp = None
        if ref_params is not None:
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

    def step(self, state: TrainState, ref_params: dict | None,
             batch: dict) -> tuple[TrainState, dict]:
        """One update: the policy's forward and backward, the reference's
        forward, clip and AdamW.  Params are updated in place."""
        return self._step(state, ref_params, batch)


class DPOTrainer(TrainerBase):
    DATASET_CLS = PreferenceDataset
    NEEDS_REF = True  # ORPO/SimPO are reference-free and set this False

    def init_models(self) -> None:
        params, self.model_cfg = self.load_model(
            self.cfgs.model_cfgs.model_name_or_path, self.next_rng)
        self.tokenizer = self.load_tokenizer_for(
            self.cfgs.model_cfgs.model_name_or_path, self.model_cfg)
        self.params = self.trainable(
            self.shard_model_params(params, self.model_cfg))
        # with LoRA the frozen base is the reference (init_engines)
        self.ref_params = (self.reference_copy(self.params)
                           if self.NEEDS_REF and not self.lora_requested()
                           else None)

    def reference_copy(self, params: dict) -> dict:
        """The frozen reference = the starting policy (reference
        dpo.py:114-120): a copy of each leaf that training updates, and the
        policy's own tensors, detached, for the modules that the freeze
        flags name, which no step changes."""
        frozen = set(self.frozen_modules())
        return {k: tree_map(torch.Tensor.detach if k in frozen
                            else lambda t: t.detach().clone(), v)
                for k, v in params.items()}

    def init_datasets(self) -> None:
        dc = self.cfgs.data_cfgs
        template = self.make_chat_template(dc.train_template, self.tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        dataset = self.DATASET_CLS(
            dc.train_datasets, template, self.tokenizer, max_length=max_len,
            split=dc.train_split, size=dc.train_size,
            data_files=dc.train_data_files)
        buckets = self.padding_buckets()
        # one device: the global batch is the per-device batch
        batch_size = int(self.cfgs.train_cfgs.per_device_train_batch_size or 1)
        self.train_iterator = self.make_iterator(
            dataset, batch_size, dataset.get_collator(buckets=buckets))
        self.eval_iterator = None
        if dc.eval_datasets:
            eval_ds = self.DATASET_CLS(
                dc.eval_datasets, template, self.tokenizer, max_length=max_len,
                split=dc.eval_split, size=dc.eval_size)
            eval_bs = int(self.cfgs.train_cfgs.per_device_eval_batch_size or 1)
            self.eval_iterator = self.make_iterator(
                eval_ds, eval_bs, eval_ds.get_collator(buckets=buckets),
                shuffle=False)

    def preference_loss(self, logp, ref_logp, batch) -> dict:
        return dpo_loss(
            logp, ref_logp, batch['input_ids'], batch['response_mask'],
            scale_coeff=float(self.cfgs.train_cfgs.scale_coeff or 0.1))

    # another model's log-probs (the multimodal one's) replace DPOStep's
    # decoder log-probs where a subclass defines this method
    compute_token_logprobs = None

    def init_engines(self) -> None:
        total = self.total_training_steps(self.train_iterator)
        tx, schedule = self.build_optimizer(total)
        policy_of = None
        if self.init_peft():
            # the reference IS the frozen base (reference dpo.py:114-120
            # loads two engines)
            if self.NEEDS_REF:
                self.ref_params = self.base_params
            self.params = self.lora_params
            del self.lora_params

            def policy_of(adapters):
                return self.lora_policy(adapters, self.base_params)
        self.engine = DPOStep(
            self.model_cfg, tx, schedule,
            preference_loss=self.preference_loss,
            compute_token_logprobs=self.compute_token_logprobs,
            policy_of=policy_of)
        self.state = self.build_train_state(self.params, tx)
        del self.params
        self.state = self.maybe_resume(self.state)

    def train_step(self, batch: dict) -> dict[str, Any]:
        self.state, metrics = self.engine.step(self.state, self.ref_params,
                                               self.put_batch(batch))
        return {k: float(v) for k, v in metrics.items()}

    def eval(self) -> dict[str, Any]:
        if self.eval_iterator is None:
            return {}
        accs, margins = [], []
        for batch in self.eval_iterator.epoch_batches(0):
            with torch.no_grad():
                _, m = self.engine.loss_fn(self.state.params, self.ref_params,
                                           self.put_batch(batch))
            accs.append(float(m['train/reward_accuracy']))
            margins.append(float(m['train/reward_margin']))
        info = ({'eval/reward_accuracy': float(np.mean(accs)),
                 'eval/reward_margin': float(np.mean(margins))}
                if accs else {})
        if info:
            self.logger.log(info, step=self.global_step)
            self.logger.print(f'eval at step {self.global_step}: {info}')
        return info

    def save(self, tag: int | None = None) -> None:
        if self.use_lora:
            self.save_lora_merged(tag)
            return
        self.save_state_and_slice(self.state, self.model_cfg, self.tokenizer,
                                  tag)


def main():
    trainer_main(DPOTrainer, task='text_to_text/dpo')


if __name__ == '__main__':
    sys.exit(main())
