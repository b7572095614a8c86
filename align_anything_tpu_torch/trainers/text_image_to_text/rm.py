"""Text-image-to-text reward model, the port of
``align_anything_tpu/trainers/text_image_to_text/rm.py`` (reference:
trainers/text_image_to_text/rm.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_image_to_text.rm \\
        --model_name_or_path <LLaVA dir> --train_datasets <path> \\
        --train_template AA_TI2T --output_dir ./output/ti2t_rm

The text ``RMTrainer`` over the LLaVA-class model: a fresh fp32 score head
on the multimodal trunk's last hidden state, Bradley-Terry on image
preference pairs.  The freeze flags of ``rm.yaml`` (the tower by default)
label the loaded tree, as JAX's ``build_optimizer`` labels ``self.params``.
The config takes the run's compute dtype and no remat, as in JAX.  ``save``
is the text trainer's: the LLaVA-layout slice of the trunk and
``score_head.npy`` beside it, which the TI2T PPO, GRPO and Safe-RLHF-V
trainers read.  Its images go through the fixed-resolution processor
whatever the checkpoint, as JAX's do (``rm.py:70``): a LLaVA-Next reward
model sees one crop an image, with no AnyRes tiles.
"""

from __future__ import annotations

import sys

import torch

from align_anything_tpu_torch.data.image import (
    ImageProcessor,
    ImageProcessorConfig,
    TI2TPreferenceDataset,
)
from align_anything_tpu_torch.models import multimodal, score_model
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.sft import (
    TI2TTrainerMixin,
    compute_config,
    load_llava_lm,
)
from align_anything_tpu_torch.trainers.text_to_text.rm import RMTrainer
from align_anything_tpu_torch.utils.tools import last_true_index


def multimodal_scores(params: dict, cfg: multimodal.MultimodalConfig,
                      batch: dict) -> torch.Tensor:
    """(B, L) fp32 per-token scores: the multimodal trunk's last hidden
    state (no vocab projection) through the (E, 1) score head."""
    out = multimodal.forward(params, cfg, batch['input_ids'],
                             attention_mask=batch['attention_mask'],
                             pixel_values=batch.get('pixel_values'),
                             need_logits=False)
    return torch.einsum('ble,ed->bld', out.last_hidden_state.float(),
                        params['score_head']['w'].float()).squeeze(-1)


def multimodal_end_scores(params: dict, cfg: multimodal.MultimodalConfig,
                          batch: dict) -> torch.Tensor:
    """(B,) scores at each row's last real token."""
    scores = multimodal_scores(params, cfg, batch)
    end = last_true_index(batch['attention_mask'].bool())
    return scores.gather(1, end[:, None]).squeeze(1)


class TI2TRMTrainer(TI2TTrainerMixin, RMTrainer):
    DATASET_CLS = TI2TPreferenceDataset

    def init_models(self) -> None:
        path = self.cfgs.model_cfgs.model_name_or_path
        params, cfg, self.mm = load_llava_lm(path, device=self.device)
        self.model_cfg = compute_config(self, cfg)
        self.tokenizer = self.load_tokenizer_for(path, self.model_cfg)
        params['score_head'] = {'w': score_model.load_score_head(
            None, self.model_cfg.hidden_size, self.next_rng(),
            device=self.device)}
        self.params = self.trainable(params)

    def make_image_processor(self) -> ImageProcessor:
        return ImageProcessor(ImageProcessorConfig(
            size=self.model_cfg.vision.image_size))

    def end_scores(self, params: dict, batch: dict
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        end = multimodal_end_scores(params, self.model_cfg, batch)
        b = end.shape[0] // 2
        return end[:b], end[b:]


def main():
    trainer_main(TI2TRMTrainer, task='text_image_to_text/rm')


if __name__ == '__main__':
    sys.exit(main())
