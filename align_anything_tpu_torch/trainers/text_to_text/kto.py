"""KTO trainer, the port of
``align_anything_tpu/trainers/text_to_text/kto.py`` (reference:
trainers/text_to_text/kto.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.kto \\
        --model_name_or_path <dir|preset> --train_datasets <path> \\
        --train_template PKUSafeRLHF --output_dir ./output/kto

DPO's machinery (``DPOTrainer``: policy, frozen fp32 reference, the
preference data) with (a) a KL baseline estimated under ``torch.no_grad()``
on one batch of an *unmatched* prompt/response iterator
(``UnmatchedSupervisedDataset``, reference kto.py:62-80): once when the
engines are built, then before every step whose ``global_step`` is a
multiple of ``kl_steps``, each time from the next epoch of that iterator;
and (b) the KTO loss over divergence-sliced log-probs (kto.py:83-160).  The
baseline travels in the batch as a (1,) float32 tensor, ``kl_baseline``,
and is reported as ``train/kl_baseline``.  One device: the KL batch is
``per_device_kl_batch_size`` rows.
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.data import UnmatchedSupervisedDataset
from align_anything_tpu_torch.losses import kto_loss, unmatched_kl_estimate
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.dpo import DPOTrainer


class KTOTrainer(DPOTrainer):
    def init_datasets(self) -> None:
        super().init_datasets()
        dc = self.cfgs.data_cfgs
        template = self.make_chat_template(dc.train_template, self.tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        random_ds = UnmatchedSupervisedDataset(
            dc.train_datasets, template, self.tokenizer, max_length=max_len,
            split=dc.train_split, size=dc.train_size,
            data_files=dc.train_data_files,
            seed=int(self.cfgs.train_cfgs.seed or 42))
        # one device: the KL batch is the per-device KL batch
        kl_bs = int(self.cfgs.train_cfgs.per_device_kl_batch_size or 1)
        self.kl_iterator = self.make_iterator(
            random_ds, kl_bs, random_ds.get_collator(
                buckets=self.padding_buckets()))
        self.kl = 0.0
        self._kl_epoch = 0

    def init_engines(self) -> None:
        super().init_engines()
        self.refresh_kl()

    @torch.no_grad()
    def kl_estimate(self, batch: dict) -> torch.Tensor:
        """The KL baseline of the policy against the reference on one
        unmatched batch, over its response tokens.

        With LoRA the JAX estimate (``kto.py:44-61``) reads the adapter
        tree as the model and fails (a ``KeyError``): LoRA KTO runs there
        only while no KL batch is drawn.  The port raises here, at that
        point (ROADMAP R18)."""
        if self.use_lora:
            raise ValueError(
                "KTO's KL baseline reads the train state as the model, "
                'which under LoRA holds the adapters alone: the reference '
                'trainer fails here too; draw no KL batch (a '
                'per_device_kl_batch_size above the dataset) or train '
                'without lora_cfgs.use_lora')
        logp = self.engine.compute_token_logprobs(self.state.params, batch)
        ref_logp = self.engine.compute_token_logprobs(self.ref_params, batch)
        resp_mask = (batch['labels'][:, 1:] != -100).to(logp.dtype)
        return unmatched_kl_estimate(logp, ref_logp, resp_mask)

    def refresh_kl(self) -> None:
        """Estimate the KL baseline on the first batch of the unmatched
        iterator's next epoch (kto.py:62-80)."""
        try:
            batch = next(iter(self.kl_iterator.epoch_batches(self._kl_epoch)))
        except StopIteration:
            return
        self._kl_epoch += 1
        self.kl = float(self.kl_estimate(self.put_batch(batch)))

    def preference_loss(self, logp, ref_logp, batch) -> dict:
        tc = self.cfgs.train_cfgs
        return kto_loss(
            logp, ref_logp, batch['divergence_mask'],
            kl=batch['kl_baseline'][0],
            scale_coeff=float(tc.scale_coeff or 0.1),
            scale_better=float(tc.scale_better if tc.scale_better is not None
                               else 1.0),
            scale_worse=float(tc.scale_worse if tc.scale_worse is not None
                              else 1.0),
            sample_weight=batch['sample_weight'])

    def train_step(self, batch: dict) -> dict[str, Any]:
        kl_steps = int(self.cfgs.train_cfgs.kl_steps or 20)
        if self.global_step and self.global_step % kl_steps == 0:
            self.refresh_kl()
        batch = dict(batch, kl_baseline=np.asarray([self.kl], np.float32))
        metrics = super().train_step(batch)
        metrics['train/kl_baseline'] = self.kl
        return metrics


def main():
    trainer_main(KTOTrainer, task='text_to_text/kto')


if __name__ == '__main__':
    sys.exit(main())
