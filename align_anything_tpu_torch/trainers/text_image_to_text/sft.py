"""Text-image-to-text SFT, the port of
``align_anything_tpu/trainers/text_image_to_text/sft.py`` (reference:
trainers/text_image_to_text/sft.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_image_to_text.sft \\
        --model_name_or_path <LLaVA dir> --train_datasets <path> \\
        --train_template AA_TI2T --output_dir ./output/ti2t_sft

A LLaVA-class model: image patches merged over the <image> tokens, then the
same cross-entropy as text SFT; the modality lives in the data and model
layers.  The freeze flags of the config (``freeze_vision_tower`` by
default) leave their modules out of the optimizer and out of the backward.

Only LLaVA-1.5 checkpoints (``model_type`` 'llava') load; the JAX
package's other vision-LM families (Qwen2-VL, Qwen2.5-VL, MLlama, MiniCPM-V,
Idefics2, LLaVA-Next) and their image processors are not ported yet
(ROADMAP §1 item 12).
"""

from __future__ import annotations

import json
import os
import sys

import torch

from align_anything_tpu_torch.data.image import (
    ImageProcessor,
    ImageProcessorConfig,
    TI2TSupervisedDataset,
)
from align_anything_tpu_torch.losses import cross_entropy_loss
from align_anything_tpu_torch.models import multimodal
from align_anything_tpu_torch.models.hf_loader import load_multimodal_params
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.sft import SupervisedTrainer

MM_BATCH_KEYS = ('image_grid_thw', 'aspect_ratio_ids', 'aspect_ratio_mask',
                 'select_idx', 'tgt_sizes')


def mm_kwargs(batch: dict) -> dict:
    """Extra multimodal forward kwargs present in the batch (dynamic-
    resolution grids, MLlama tile metadata)."""
    return {k: batch[k] for k in MM_BATCH_KEYS if batch.get(k) is not None}


def load_vision_lm(path: str, device: torch.device | str | None = None):
    """(params, cfg, model module) for a vision-LM checkpoint directory on
    ``device`` (default: the first CUDA device).  LLaVA-1.5 only: another
    ``model_type`` raises."""
    with open(os.path.join(path, 'config.json')) as f:
        model_type = json.load(f).get('model_type')
    if model_type != 'llava':
        raise NotImplementedError(
            f'vision-LM model_type {model_type!r} is not ported yet (ROADMAP '
            '§1 item 12); the port loads LLaVA-1.5 (model_type llava)')
    params, cfg = load_multimodal_params(path, device=device)
    return params, cfg, multimodal


def compute_config(trainer, cfg: multimodal.MultimodalConfig
                   ) -> multimodal.MultimodalConfig:
    """The loaded config with the run's compute dtype (bf16 unless
    ``bf16`` is False) and nothing else, as JAX's TI2T RM, PPO, GRPO and
    Safe-RLHF-V trainers set it (no remat)."""
    tc = trainer.cfgs.train_cfgs
    cfg = cfg.replace(
        compute_dtype='bfloat16' if tc.bf16 in (True, None) else 'float32')
    multimodal.check_supported(cfg)
    return cfg


def runtime_config(trainer, cfg: multimodal.MultimodalConfig
                   ) -> multimodal.MultimodalConfig:
    """``compute_config`` plus the run's remat policy, as the JAX TI2T SFT
    and DPO trainers set them."""
    tc = trainer.cfgs.train_cfgs
    cfg = compute_config(trainer, cfg).replace(
        remat=trainer.mesh_config.remat
        if tc.gradient_checkpointing in (True, None) else 'none')
    multimodal.check_supported(cfg)
    return cfg


class TI2TTrainerMixin:
    """The LLaVA model and the image datasets of the TI2T trainers, over a
    text trainer's engine; ``DATASET_CLS`` is the image dataset."""

    def init_models(self) -> None:
        path = self.cfgs.model_cfgs.model_name_or_path
        params, cfg, self.mm = load_vision_lm(path, device=self.device)
        self.model_cfg = runtime_config(self, cfg)
        self.tokenizer = self.load_tokenizer_for(path, self.model_cfg)
        self.params = self.trainable(params)

    def make_image_processor(self) -> ImageProcessor:
        return ImageProcessor(ImageProcessorConfig(
            size=self.model_cfg.vision.image_size))

    def image_num_patches(self) -> int:
        """Per-image <image> expansion count."""
        return self.model_cfg.vision.num_patches

    def make_dataset(self, dataset_cls, path, template, max_len, **kw):
        return dataset_cls(
            path, template, self.tokenizer,
            image_token_id=self.model_cfg.image_token_id,
            num_patches=self.image_num_patches(),
            image_processor=self.make_image_processor(),
            max_length=max_len, **kw)

    def init_datasets(self) -> None:
        dc = self.cfgs.data_cfgs
        template = self.make_chat_template(dc.train_template, self.tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        dataset = self.make_dataset(
            self.DATASET_CLS, dc.train_datasets, template, max_len,
            split=dc.train_split, size=dc.train_size,
            data_files=dc.train_data_files)
        # one device: the global batch is the per-device batch
        batch_size = int(self.cfgs.train_cfgs.per_device_train_batch_size
                         or 1)
        self.train_iterator = self.make_iterator(
            dataset, batch_size,
            dataset.get_collator(buckets=self.padding_buckets()))
        self.eval_iterator = None


class TI2TSupervisedTrainer(TI2TTrainerMixin, SupervisedTrainer):
    DATASET_CLS = TI2TSupervisedDataset

    def loss_fn(self, params: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
        out = self.mm.forward(params, self.model_cfg, batch['input_ids'],
                              attention_mask=batch['attention_mask'],
                              pixel_values=batch.get('pixel_values'),
                              **mm_kwargs(batch))
        loss = cross_entropy_loss(out.logits, batch['labels'])['loss']
        return loss, {'train/loss': loss.detach()}


def main():
    trainer_main(TI2TSupervisedTrainer, task='text_image_to_text/sft')


if __name__ == '__main__':
    sys.exit(main())
