"""ORPO trainer — reference-free odds-ratio preference optimization, the
port of ``align_anything_tpu/trainers/text_to_text/orpo.py`` (reference:
trainers/text_to_text/orpo.py:38-105)."""

from __future__ import annotations

import sys

from align_anything_tpu_torch.losses import orpo_loss
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.dpo import DPOTrainer


class ORPOTrainer(DPOTrainer):
    NEEDS_REF = False

    def preference_loss(self, logp, ref_logp, batch) -> dict:
        return orpo_loss(
            logp, batch['input_ids'], batch['divergence_mask'],
            batch['seq_lengths'],
            scale_coeff=float(self.cfgs.train_cfgs.scale_coeff or 0.1),
            sample_weight=batch['sample_weight'])


def main():
    trainer_main(ORPOTrainer, task='text_to_text/orpo')


if __name__ == '__main__':
    sys.exit(main())
