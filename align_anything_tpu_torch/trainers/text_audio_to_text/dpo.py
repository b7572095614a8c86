"""Text-audio-to-text DPO, the port of
``align_anything_tpu/trainers/text_audio_to_text/dpo.py`` (reference:
trainers/text_audio_to_text/dpo.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_audio_to_text.dpo \\
        --model_name_or_path <Qwen2-Audio dir | text dir | preset> \\
        --train_datasets <path> --train_template AA_TA2T \\
        --output_dir ./output/ta2t_dpo

The text DPO trainer with the audio LM's log-probs over audio preference
pairs (each pair's clip rides with both of its rows).  The reference is a
copy of the policy's starting tree; it shares the tensors of the modules
the freeze flags name (the tower, ``freeze_audio_tower``), which no step
changes.  The model is loaded as TA2T SFT loads it (``sft.py``).  ``save``
writes the train state alone, as JAX's does.
"""

from __future__ import annotations

import sys

import torch

from align_anything_tpu_torch.data.audio import TA2TPreferenceDataset
from align_anything_tpu_torch.models import audio
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_audio_to_text.sft import (
    TA2TTrainerMixin,
)
from align_anything_tpu_torch.trainers.text_to_text.dpo import DPOTrainer


class TA2TDPOTrainer(TA2TTrainerMixin, DPOTrainer):
    DATASET_CLS = TA2TPreferenceDataset

    def init_models(self) -> None:
        super().init_models()
        self.ref_params = self.reference_copy(self.params)

    def compute_token_logprobs(self, params: dict,
                               batch: dict) -> torch.Tensor:
        return audio.token_logprobs(
            params, self.model_cfg, batch['input_ids'],
            attention_mask=batch['attention_mask'],
            audio_values=batch.get('audio_values'))

    def save(self, tag: int | None = None) -> None:
        self.save_train_state_only(self.state, tag)


def main():
    trainer_main(TA2TDPOTrainer, task='text_audio_to_text/dpo')


if __name__ == '__main__':
    sys.exit(main())
