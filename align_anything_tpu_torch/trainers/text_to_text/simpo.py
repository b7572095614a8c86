"""SimPO trainer — reference-free length-normalized preference loss, the
port of ``align_anything_tpu/trainers/text_to_text/simpo.py`` (reference:
trainers/text_to_text/simpo.py:38-105)."""

from __future__ import annotations

import sys

from align_anything_tpu_torch.losses import simpo_loss
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.dpo import DPOTrainer


class SimPOTrainer(DPOTrainer):
    NEEDS_REF = False

    def preference_loss(self, logp, ref_logp, batch) -> dict:
        tc = self.cfgs.train_cfgs
        return simpo_loss(
            logp, batch['divergence_mask'], batch['seq_lengths'],
            scale_coeff=float(tc.scale_coeff or 2.0),
            gamma=float(tc.gamma if tc.gamma is not None else 0.5),
            sample_weight=batch['sample_weight'])


def main():
    trainer_main(SimPOTrainer, task='text_to_text/simpo')


if __name__ == '__main__':
    sys.exit(main())
