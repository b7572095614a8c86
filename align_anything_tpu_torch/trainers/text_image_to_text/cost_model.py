"""Text-image-to-text cost model, the port of
``align_anything_tpu/trainers/text_image_to_text/cost_model.py``
(reference: trainers/text_image_to_text/cost_model.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_image_to_text.cost_model \\
        --model_name_or_path <LLaVA dir> --train_datasets <path> \\
        --train_template AA_TI2T --output_dir ./output/ti2t_cost

The TI2T reward model's machinery with the text cost model's loss: the
unsafe ("worse") rows of a pair must score the HIGHER cost.  It reads the
task ``text_image_to_text/rm``, as in JAX.
"""

from __future__ import annotations

import sys

from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.rm import (
    TI2TRMTrainer,
)
from align_anything_tpu_torch.trainers.text_to_text.cost_model import (
    CostModelTrainer,
)


class TI2TCostModelTrainer(CostModelTrainer, TI2TRMTrainer):
    """MRO: the cost model's reversed loss over the TI2T reward model."""


def main():
    trainer_main(TI2TCostModelTrainer, task='text_image_to_text/rm')


if __name__ == '__main__':
    sys.exit(main())
