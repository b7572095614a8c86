"""Text-audio-to-text reward model, the port of
``align_anything_tpu/trainers/text_audio_to_text/rm.py`` (reference:
trainers/text_audio_to_text/rm.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_audio_to_text.rm \\
        --model_name_or_path <Qwen2-Audio dir | text dir | preset> \\
        --train_datasets <path> --train_template AA_TA2T \\
        --output_dir ./output/ta2t_rm

The text ``RMTrainer``'s Bradley-Terry loss over audio preference pairs: a
fresh fp32 score head on the audio LM's last hidden state (no vocab
projection), read at each row's last real token.  The model is loaded as
TA2T SFT loads it (``sft.py``); the freeze flags label the tree (the tower
by default).  ``save`` writes the train state alone, as JAX's does: the
TA2T PPO and GRPO trainers read no reward model (they score with fresh
heads on copies of the actor).
"""

from __future__ import annotations

import sys

import torch

from align_anything_tpu_torch.data.audio import TA2TPreferenceDataset
from align_anything_tpu_torch.models import audio, score_model
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_audio_to_text.sft import (
    TA2TTrainerMixin,
)
from align_anything_tpu_torch.trainers.text_to_text.rm import RMTrainer
from align_anything_tpu_torch.utils.tools import last_true_index


def audio_scores(params: dict, cfg: audio.AudioLMConfig,
                 batch: dict) -> torch.Tensor:
    """(B, L) fp32 per-token scores: the audio LM's last hidden state
    through the (E, 1) score head."""
    out = audio.forward(params, cfg, batch['input_ids'],
                        attention_mask=batch['attention_mask'],
                        audio_values=batch.get('audio_values'),
                        need_logits=False)
    return torch.einsum('ble,ed->bld', out.last_hidden_state.float(),
                        params['score_head']['w'].float()).squeeze(-1)


def audio_end_scores(params: dict, cfg: audio.AudioLMConfig,
                     batch: dict) -> torch.Tensor:
    """(B,) scores at each row's last real token."""
    scores = audio_scores(params, cfg, batch)
    end = last_true_index(batch['attention_mask'].bool())
    return scores.gather(1, end[:, None]).squeeze(1)


class TA2TRMTrainer(TA2TTrainerMixin, RMTrainer):
    DATASET_CLS = TA2TPreferenceDataset

    def init_models(self) -> None:
        params = self.load_audio_lm()
        params['score_head'] = {'w': score_model.load_score_head(
            None, self.model_cfg.hidden_size, self.next_rng(),
            device=self.device)}
        self.params = self.trainable(params)

    def end_scores(self, params: dict, batch: dict
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        end = audio_end_scores(params, self.model_cfg, batch)
        b = end.shape[0] // 2
        return end[:b], end[b:]

    def save(self, tag: int | None = None) -> None:
        self.save_train_state_only(self.state, tag)


def main():
    trainer_main(TA2TRMTrainer, task='text_audio_to_text/rm')


if __name__ == '__main__':
    sys.exit(main())
