"""Cost-model trainer for Safe RLHF, the port of
``align_anything_tpu/trainers/text_to_text/cost_model.py`` (reference:
trainers/text_to_text/cost_model.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.cost_model \\
        --model_name_or_path <dir|preset> --train_datasets <path> \\
        --train_template PKUSafeRLHF --output_dir ./output/cost

The reward model's machinery with the comparison reversed: the
preference collator puts the better (safer) rows first, and the model
learns a higher cost for the worse (unsafe) rows.
"""

from __future__ import annotations

import sys

import torch

from align_anything_tpu_torch.losses import bradley_terry_loss
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.rm import RMTrainer


class CostModelTrainer(RMTrainer):
    def loss_fn(self, params: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
        better, worse = self.end_scores(params, batch)
        # cost ordering: the unsafe ("worse") rows must score HIGHER cost
        res = bradley_terry_loss(
            worse, better,
            regularization=float(self.cfgs.train_cfgs.regularization or 0.0))
        return res['loss'], {'train/loss': res['loss'].detach(),
                             'train/accuracy': res['accuracy']}


def main():
    trainer_main(CostModelTrainer, task='text_to_text/rm')


if __name__ == '__main__':
    sys.exit(main())
