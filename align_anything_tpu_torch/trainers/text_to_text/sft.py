"""Text-to-text SFT trainer, the port of
``align_anything_tpu/trainers/text_to_text/sft.py`` (reference:
trainers/text_to_text/sft.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.sft \\
        --model_name_or_path <dir|preset> --train_datasets <path> \\
        --train_template Alpaca --output_dir ./output/sft

With LoRA (``--use_lora``, QLoRA with ``--use_bnb``) the train state holds
the adapters over the frozen, possibly quantized, base, ``save`` exports
the merged model, and, as in JAX, ``load_checkpoint`` resumes nothing.

An MoE model adds ``router_aux_coef`` times the decoder's router
balancing loss to the loss and logs it as ``train/router_aux_loss`` (JAX
``sft.py:69-71``).

Left out with the module it needs: the pipeline stages and the 1F1B
schedule (one device).
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.data import SupervisedDataset
from align_anything_tpu_torch.losses import cross_entropy_loss
from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.trainers.base import TrainerBase
from align_anything_tpu_torch.trainers.cli import trainer_main


class SupervisedTrainer(TrainerBase):
    DATASET_CLS = SupervisedDataset

    def init_models(self) -> None:
        params, self.model_cfg = self.load_model(
            self.cfgs.model_cfgs.model_name_or_path, self.next_rng)
        self.tokenizer = self.load_tokenizer_for(
            self.cfgs.model_cfgs.model_name_or_path, self.model_cfg)
        self.params = self.trainable(
            self.shard_model_params(params, self.model_cfg))

    def init_datasets(self) -> None:
        dc = self.cfgs.data_cfgs
        template = self.make_chat_template(dc.train_template, self.tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        dataset = self.DATASET_CLS(
            dc.train_datasets, template, self.tokenizer, max_length=max_len,
            split=dc.train_split, size=dc.train_size,
            data_files=dc.train_data_files,
            name=dc.train_name, optional_args=dc.train_optional_args or ())
        buckets = self.padding_buckets()
        collator = dataset.get_collator(buckets=buckets)
        # one device: the global batch is the per-device batch
        batch_size = int(self.cfgs.train_cfgs.per_device_train_batch_size or 1)
        self.train_iterator = self.make_iterator(dataset, batch_size, collator)

        self.eval_iterator = None
        if dc.eval_datasets:
            eval_template = self.make_chat_template(
                dc.eval_template or dc.train_template, self.tokenizer)
            eval_ds = self.DATASET_CLS(
                dc.eval_datasets, eval_template, self.tokenizer,
                max_length=max_len, split=dc.eval_split, size=dc.eval_size,
                data_files=dc.eval_data_files)
            eval_bs = int(self.cfgs.train_cfgs.per_device_eval_batch_size or 1)
            self.eval_iterator = self.make_iterator(
                eval_ds, eval_bs, eval_ds.get_collator(buckets=buckets),
                shuffle=False)

    def loss_fn(self, params: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
        out = transformer.forward(params, self.model_cfg, batch['input_ids'],
                                  attention_mask=batch['attention_mask'])
        loss = cross_entropy_loss(out.logits, batch['labels'])['loss']
        metrics = {'train/loss': loss.detach()}
        if out.aux_loss is not None and self.model_cfg.router_aux_coef:
            loss = loss + self.model_cfg.router_aux_coef * out.aux_loss
            metrics['train/router_aux_loss'] = out.aux_loss.detach()
        return loss, metrics

    def init_engines(self) -> None:
        total = self.total_training_steps(self.train_iterator)
        tx, schedule = self.build_optimizer(total)
        if self.init_peft():
            # the adapters are the train state; the frozen base is an input
            # of the step (reference lora_cfgs path,
            # models/pretrained_model.py:196-252).  JAX's LoRA SFT does not
            # resume (ROADMAP R20), nor does this
            self.state = self.build_train_state(self.lora_params, tx)
            del self.params, self.lora_params
            self._step = self.compile_lora_train_step(self.lora_loss, tx,
                                                      schedule)
            return
        self.state = self.build_train_state(self.params, tx)
        del self.params  # lives inside state now
        self.state = self.maybe_resume(self.state)
        self._step = self.compile_train_step(self.loss_fn, tx, schedule)

    def lora_loss(self, adapters: dict, base: dict, batch: dict
                  ) -> tuple[torch.Tensor, dict]:
        """``loss_fn`` of the adapters attached to ``base``."""
        return self.loss_fn(self.lora_policy(adapters, base), batch)

    def train_step(self, batch: dict) -> dict[str, Any]:
        inputs = ((self.base_params,) if self.use_lora else ()) + (
            self.put_batch(batch),)
        self.state, metrics = self._step(self.state, *inputs)
        return {k: float(v) for k, v in metrics.items()}

    def eval(self) -> dict[str, Any]:
        if self.eval_iterator is None:
            return {}
        losses = []
        params = (self.lora_policy(self.state.params, self.base_params)
                  if self.use_lora else self.state.params)
        for batch in self.eval_iterator.epoch_batches(0):
            with torch.no_grad():
                loss, _ = self.loss_fn(params, self.put_batch(batch))
            losses.append(float(loss))
        info = {'eval/loss': float(np.mean(losses))} if losses else {}
        if info:
            self.logger.log(info, step=self.global_step)
            self.logger.print(f'eval at step {self.global_step}: {info}')
        return info

    def save(self, tag: int | None = None) -> None:
        if self.use_lora:
            # the merged export (save_full_model parity,
            # supervised_trainer.py:441-450)
            self.save_lora_merged(tag)
            return
        self.save_state_and_slice(self.state, self.model_cfg, self.tokenizer,
                                  tag)


def main():
    trainer_main(SupervisedTrainer, task='text_to_text/sft')


if __name__ == '__main__':
    sys.exit(main())
