"""Text-image-to-text ORPO, the port of
``align_anything_tpu/trainers/text_image_to_text/orpo.py`` (ORPO over image
preference pairs; the reference has it for text only).

Launch:
    python -m align_anything_tpu_torch.trainers.text_image_to_text.orpo \\
        --model_name_or_path <LLaVA dir> --train_datasets <path> \\
        --train_template AA_TI2T --output_dir ./output/ti2t_orpo

The text ``ORPOTrainer``'s loss over ``TI2TDPOTrainer``'s model, image data
and log-probs, in JAX's order of bases. It reads the text task
``text_to_text/orpo``, as JAX does, whose YAML sets no freeze flag, so the
tower trains.
"""

from __future__ import annotations

import sys

from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.dpo import (
    TI2TDPOTrainer,
)
from align_anything_tpu_torch.trainers.text_to_text.orpo import ORPOTrainer


class TI2TORPOTrainer(ORPOTrainer, TI2TDPOTrainer):
    """MRO: the ORPO loss over the TI2T models and datasets."""


def main():
    trainer_main(TI2TORPOTrainer, task='text_to_text/orpo')


if __name__ == '__main__':
    sys.exit(main())
