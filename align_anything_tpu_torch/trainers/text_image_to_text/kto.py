"""Text-image-to-text KTO, the port of
``align_anything_tpu/trainers/text_image_to_text/kto.py`` (KTO over image
preference pairs; the reference has it for text only).

Launch:
    python -m align_anything_tpu_torch.trainers.text_image_to_text.kto \\
        --model_name_or_path <LLaVA dir> --train_datasets <path> \\
        --train_template AA_TI2T --output_dir ./output/ti2t_kto

The text ``KTOTrainer``'s loss over ``TI2TDPOTrainer``'s model, image data
and log-probs, in JAX's order of bases. It reads the text task
``text_to_text/kto``, as JAX does, whose YAML sets no freeze flag, so the
tower trains. The KL baseline's unmatched rows come from the template's
``format_unmatched_supervised_sample``, which for AA_TI2T is text only: the
baseline is estimated over rows without their image, as in JAX (ROADMAP §3
R14).
"""

from __future__ import annotations

import sys

from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.dpo import (
    TI2TDPOTrainer,
)
from align_anything_tpu_torch.trainers.text_to_text.kto import KTOTrainer


class TI2TKTOTrainer(KTOTrainer, TI2TDPOTrainer):
    """MRO: the KTO loss over the TI2T models and datasets."""


def main():
    trainer_main(TI2TKTOTrainer, task='text_to_text/kto')


if __name__ == '__main__':
    sys.exit(main())
