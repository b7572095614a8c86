"""Reward-model trainer: Bradley-Terry on preference pairs, the port of
``align_anything_tpu/trainers/text_to_text/rm.py`` (reference:
trainers/text_to_text/rm.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.rm \\
        --model_name_or_path <dir|preset> --train_datasets <path> \\
        --train_template PKUSafeRLHF --output_dir ./output/rm

The LM trunk (an HF checkpoint or a preset) gets a fresh fp32 score head;
the loss reads the end scores of the better and worse rows of the
preference batch.  The trunk's ``lm_head`` is never read (the score model
skips the vocab projection), so it gets a zero gradient and moves only by
weight decay, as in JAX.  ``save`` writes the HF slice of the trunk and
``score_head.npy`` beside it: the head's handoff to PPO and ``rm_score``.
With LoRA (``--use_lora``, QLoRA with ``--use_bnb``) the train state is
``{'lora': adapters, 'score_head': head}`` over the frozen, possibly
quantized, trunk, and the slice holds the merged trunk.
"""

from __future__ import annotations

import os
import sys
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.data import PreferenceDataset
from align_anything_tpu_torch.losses import bradley_terry_loss
from align_anything_tpu_torch.models import score_model
from align_anything_tpu_torch.trainers.base import TrainerBase
from align_anything_tpu_torch.trainers.cli import trainer_main


class RMTrainer(TrainerBase):
    DATASET_CLS = PreferenceDataset

    def init_models(self) -> None:
        params, self.model_cfg = self.load_model(
            self.cfgs.model_cfgs.model_name_or_path, self.next_rng)
        self.tokenizer = self.load_tokenizer_for(
            self.cfgs.model_cfgs.model_name_or_path, self.model_cfg)
        # a fresh score head on the (possibly pretrained) LM trunk
        params['score_head'] = {'w': score_model.load_score_head(
            None, self.model_cfg.hidden_size, self.next_rng(),
            device=self.device)}
        self.params = self.trainable(
            self.shard_model_params(params, self.model_cfg))

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

    def end_scores(self, params: dict, batch: dict
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(better, worse) end scores of a preference batch."""
        out = score_model.forward(params, self.model_cfg, batch['input_ids'],
                                  attention_mask=batch['attention_mask'])
        end = out.end_scores.squeeze(-1)
        b = end.shape[0] // 2
        return end[:b], end[b:]

    def loss_fn(self, params: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
        better, worse = self.end_scores(params, batch)
        res = bradley_terry_loss(
            better, worse,
            regularization=float(self.cfgs.train_cfgs.regularization or 0.0))
        return res['loss'], {'train/loss': res['loss'].detach(),
                             'train/accuracy': res['accuracy']}

    def init_engines(self) -> None:
        total = self.total_training_steps(self.train_iterator)
        tx, schedule = self.build_optimizer(total)
        if self.init_peft():
            # trainable: the adapters and the fresh score head; the trunk
            # stays frozen (possibly quantized), and the base keeps its
            # untrained copy of the head, as in JAX
            head = self.base_params['score_head']['w']
            self.state = self.build_train_state(
                {'lora': self.lora_params,
                 'score_head': {'w': head.detach().clone().requires_grad_(
                     True)}}, tx)
            del self.params, self.lora_params
            self.state = self.maybe_resume(self.state)
            self._step = self.compile_lora_train_step(self.lora_loss, tx,
                                                      schedule)
            return
        self.state = self.build_train_state(self.params, tx)
        del self.params
        self.state = self.maybe_resume(self.state)
        self._step = self.compile_train_step(self.loss_fn, tx, schedule)

    def lora_params_of(self, trainable: dict, base: dict) -> dict:
        """The score model's params: the adapters attached to ``base``, and
        the trained head."""
        return dict(self.lora_policy(trainable['lora'], base),
                    score_head=trainable['score_head'])

    def lora_loss(self, trainable: dict, base: dict, batch: dict
                  ) -> tuple[torch.Tensor, dict]:
        return self.loss_fn(self.lora_params_of(trainable, base), batch)

    def train_step(self, batch: dict) -> dict[str, Any]:
        inputs = ((self.base_params,) if self.use_lora else ()) + (
            self.put_batch(batch),)
        self.state, metrics = self._step(self.state, *inputs)
        return {k: float(v) for k, v in metrics.items()}

    def eval(self) -> dict[str, Any]:
        if self.eval_iterator is None:
            return {}
        accs = []
        params = (self.lora_params_of(self.state.params, self.base_params)
                  if self.use_lora else self.state.params)
        for batch in self.eval_iterator.epoch_batches(0):
            with torch.no_grad():
                _, m = self.loss_fn(params, self.put_batch(batch))
            accs.append(float(m['train/accuracy']))
        info = {'eval/accuracy': float(np.mean(accs))} if accs else {}
        if info:
            self.logger.log(info, step=self.global_step)
            self.logger.print(f'eval at step {self.global_step}: {info}')
        return info

    def save(self, tag: int | None = None) -> None:
        # the score head rides along in the train state; the HF slice holds
        # the LM trunk (merged under LoRA) and score_head.npy the head
        if self.use_lora:
            self.save_lora_merged(tag, adapters=self.state.params['lora'])
        else:
            self.save_state_and_slice(self.state, self.model_cfg,
                                      self.tokenizer, tag)
        out = self.cfgs.logger_cfgs.output_dir
        if out:
            head = self.state.params['score_head']['w'].detach().cpu().numpy()
            slice_dir = os.path.join(
                out, f'slice_{tag if tag is not None else self.global_step}')
            os.makedirs(slice_dir, exist_ok=True)
            np.save(os.path.join(slice_dir, 'score_head.npy'), head)


def main():
    trainer_main(RMTrainer, task='text_to_text/rm')


if __name__ == '__main__':
    sys.exit(main())
