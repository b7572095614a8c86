"""Text-image-to-text DPO, the port of
``align_anything_tpu/trainers/text_image_to_text/dpo.py`` (reference:
trainers/text_image_to_text/dpo.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_image_to_text.dpo \\
        --model_name_or_path <LLaVA dir> --train_datasets <path> \\
        --train_template AA_TI2T --output_dir ./output/ti2t_dpo

The north-star config (LLaVA-1.5-7B TI2T DPO).  The text DPO trainer with
the multimodal model's log-probs and the image preference dataset; the
reference model is a frozen copy of the loaded policy that shares the
tensors of the frozen modules (the vision tower by default,
``freeze_vision_tower``).  KTO, ORPO and SimPO (``kto.py``, ``orpo.py``,
``simpo.py``) mix their text trainers over this one; the reference-free
ones hold no reference.
"""

from __future__ import annotations

import sys

import torch

from align_anything_tpu_torch.data.image import TI2TPreferenceDataset
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.sft import (
    TI2TTrainerMixin,
    mm_kwargs,
)
from align_anything_tpu_torch.trainers.text_to_text.dpo import DPOTrainer


class TI2TDPOTrainer(TI2TTrainerMixin, DPOTrainer):
    DATASET_CLS = TI2TPreferenceDataset

    def init_models(self) -> None:
        super().init_models()
        self.ref_params = (self.reference_copy(self.params)
                           if self.NEEDS_REF else None)

    def compute_token_logprobs(self, params: dict,
                               batch: dict) -> torch.Tensor:
        return self.mm.token_logprobs(
            params, self.model_cfg, batch['input_ids'],
            attention_mask=batch['attention_mask'],
            pixel_values=batch.get('pixel_values'), **mm_kwargs(batch))


def main():
    trainer_main(TI2TDPOTrainer, task='text_image_to_text/dpo')


if __name__ == '__main__':
    sys.exit(main())
