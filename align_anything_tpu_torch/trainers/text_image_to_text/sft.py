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

The LLaVA family loads: LLaVA-1.5 (``model_type`` 'llava'), LLaVA-Next
('llava_next', whose images go through ``AnyResProcessor``: crops, the
packing gather ``select_idx`` and a token count per image) and
LLaVA-NeXT-Video ('llava_next_video'); so do Qwen2-VL ('qwen2_vl') and
Qwen2.5-VL ('qwen2_5_vl'), whose images become patch rows
(``PatchProcessor`` at the fixed 224 px grid, or ``DynamicPatchProcessor``
under ``dynamic_resolution``: per-image grids ride the batch as
``image_grid_thw``), and so does Mllama ('mllama', whose images become
tiles through ``MllamaTileProcessor``: ``aspect_ratio_ids`` and
``aspect_ratio_mask`` ride the batch, one image token a row), and so does
Idefics2 ('idefics2', whose images become packed patch rows through
``Idefics2NaViTProcessor``: ``tgt_sizes`` rides the batch, and each image
expands to the perceiver's latent count), and so does MiniCPM-V
('minicpmv', whose images become a source crop and grid slices through
``MiniCPMVSliceProcessor`` in slice mode: the crops' packed patch rows and
``tgt_sizes`` ride the batch, and each image expands to its crop count
times the resampler's query count).

ROADMAP §3 R27, R30, R37 and R40: the freeze flags name the module keys
of the LLaVA tree (``freeze_vision_tower`` -> ``vision_tower``,
``freeze_mm_proj`` -> ``projector``); a Qwen2-VL tree names its tower and
merger ``visual`` (R27), an Mllama tree its tower ``vision_model`` (R30),
an Idefics2 tree its tower ``vision_model`` and its projection and
perceiver ``connector`` (R37), a MiniCPM-V tree its tower ``vpm`` and its
resampler ``resampler`` (R40), so under the YAMLs' ``freeze_vision_tower:
True`` nothing is frozen and the tower trains, as in JAX.  One line at
start-up names each flag that misses.

ROADMAP §3 R36: no Idefics2 export is ported (JAX's fails), so a run with
an ``output_dir`` on an Idefics2 checkpoint raises at start-up.  The
train-state checkpoint, the resume and the log directory all live under
``output_dir``, so an Idefics2 run has none of them until the writer is
ported.  A MiniCPM-V run exports, checkpoints and resumes (its writer is
``models/hf_loader.py`` ``save_minicpmv_params``).
"""

from __future__ import annotations

import json
import os
import sys

import torch

from align_anything_tpu_torch import checkpoint as ckpt_lib
from align_anything_tpu_torch.data.image import (
    AnyResProcessor,
    Idefics2NaViTProcessor,
    ImageProcessor,
    ImageProcessorConfig,
    MiniCPMVSliceProcessor,
    MllamaTileProcessor,
    TI2TSupervisedDataset,
)
from align_anything_tpu_torch.losses import cross_entropy_loss
from align_anything_tpu_torch.models import (
    idefics2,
    minicpmv,
    mllama,
    multimodal,
    qwen2_5_vl,
    qwen2_vl,
    transformer,
)
from align_anything_tpu_torch.models.hf_loader import (
    LLAVA_MODEL_TYPES,
    load_minicpmv_params,
    load_mllama_params,
    load_multimodal_params,
    load_qwen2_5_vl_params,
    load_qwen2_vl_params,
)
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.sft import SupervisedTrainer

VISION_LM_LOADERS = {'qwen2_vl': (load_qwen2_vl_params, qwen2_vl),
                     'qwen2_5_vl': (load_qwen2_5_vl_params, qwen2_5_vl),
                     'mllama': (load_mllama_params, mllama),
                     'idefics2': (idefics2.load_idefics2_params, idefics2),
                     'minicpmv': (load_minicpmv_params, minicpmv)}
# the fault that a freeze flag missing the family's tower is (ROADMAP §3)
MISSED_FREEZE_FAULTS = {qwen2_vl: 'R27', qwen2_5_vl: 'R27', mllama: 'R30',
                        idefics2: 'R37', minicpmv: 'R40'}
MM_BATCH_KEYS = ('image_grid_thw', 'aspect_ratio_ids', 'aspect_ratio_mask',
                 'select_idx', 'tgt_sizes')


def mm_kwargs(batch: dict) -> dict:
    """Extra multimodal forward kwargs present in the batch (AnyRes's
    ``select_idx``, Qwen2-VL's dynamic-resolution ``image_grid_thw``,
    Mllama's ``aspect_ratio_ids`` / ``aspect_ratio_mask``, Idefics2's and
    MiniCPM-V's ``tgt_sizes``)."""
    return {k: batch[k] for k in MM_BATCH_KEYS if batch.get(k) is not None}


def load_llava_lm(path: str, device: torch.device | str | None = None):
    """(params, cfg, ``multimodal``) for a LLaVA-family checkpoint
    (``LLAVA_MODEL_TYPES``) on ``device`` (default: the first CUDA device),
    as JAX's TI2T RM, PPO, GRPO and Safe-RLHF-V load theirs
    (``load_multimodal_params``); another ``model_type`` raises."""
    with open(os.path.join(path, 'config.json')) as f:
        model_type = json.load(f).get('model_type')
    if model_type not in LLAVA_MODEL_TYPES:
        raise NotImplementedError(
            f'model_type {model_type!r}: this trainer loads the LLaVA family '
            f'{LLAVA_MODEL_TYPES}, as in JAX (the other vision-LM families: '
            'ROADMAP §1 item 12)')
    params, cfg = load_multimodal_params(path, device=device)
    return params, cfg, multimodal


def load_vision_lm(path: str, device: torch.device | str | None = None):
    """(params, cfg, model module) for a vision-LM checkpoint directory on
    ``device`` (default: the first CUDA device), by its ``model_type``, as
    JAX's TI2T SFT and DPO dispatch: Qwen2-VL, Qwen2.5-VL, Mllama,
    Idefics2 and MiniCPM-V, else the LLaVA family (``load_llava_lm``);
    another ``model_type`` raises."""
    with open(os.path.join(path, 'config.json')) as f:
        model_type = json.load(f).get('model_type')
    if model_type in VISION_LM_LOADERS:
        load, module = VISION_LM_LOADERS[model_type]
        params, cfg = load(path, device=device)
        return params, cfg, module
    return load_llava_lm(path, device=device)


def compute_config(trainer, cfg):
    """The loaded config with the run's compute dtype (bf16 unless
    ``bf16`` is False) and nothing else, as JAX's TI2T RM, PPO, GRPO and
    Safe-RLHF-V trainers set it (no remat)."""
    tc = trainer.cfgs.train_cfgs
    cfg = cfg.replace(
        compute_dtype='bfloat16' if tc.bf16 in (True, None) else 'float32')
    transformer.check_supported(cfg.text)
    return cfg


def runtime_config(trainer, cfg):
    """``compute_config`` plus the run's remat policy, as the JAX TI2T SFT
    and DPO trainers set them."""
    tc = trainer.cfgs.train_cfgs
    cfg = compute_config(trainer, cfg).replace(
        remat=trainer.mesh_config.remat
        if tc.gradient_checkpointing in (True, None) else 'none')
    transformer.check_supported(cfg.text)
    return cfg


def report_missed_freeze_flags(trainer, params: dict) -> list[str]:
    """ROADMAP §3 R27 / R30 / R37 / R40: one line for each freeze flag
    that is set but names no module of ``params`` (so it freezes nothing,
    as in JAX); the lines are printed and returned."""
    tc = trainer.cfgs.train_cfgs
    fault = MISSED_FREEZE_FAULTS.get(trainer.mm, 'R27')
    lines = [f'{flag}: True names {names}, which the {trainer.mm.__name__} '
             f'tree {tuple(params)} does not hold: nothing is frozen and '
             f'those weights train, as in JAX (ROADMAP §3 {fault})'
             for flag, names in trainer.FREEZE_FLAG_MODULES
             if getattr(tc, flag, None)
             and not any(n in params for n in names)]
    for line in lines:
        print(line, flush=True)
    return lines


class TI2TTrainerMixin:
    """The vision-LM model and the image datasets of the TI2T trainers,
    over a text trainer's engine; ``DATASET_CLS`` is the image dataset."""

    def init_models(self) -> None:
        path = self.cfgs.model_cfgs.model_name_or_path
        params, cfg, self.mm = load_vision_lm(path, device=self.device)
        if self.cfgs.logger_cfgs.output_dir:
            # the export would fail after the last step: fail before the
            # first (ROADMAP §3 R36)
            ckpt_lib.check_hf_slice(cfg)
        self.model_cfg = runtime_config(self, cfg)
        self.tokenizer = self.load_tokenizer_for(path, self.model_cfg)
        report_missed_freeze_flags(self, params)
        self.params = self.trainable(params)

    def make_image_processor(self):
        """Mllama: ``MllamaTileProcessor`` (JAX ``sft.py:107-112``).
        Idefics2: ``Idefics2NaViTProcessor`` with the perceiver's latent
        count (JAX ``sft.py:128-135``).
        MiniCPM-V in slice mode: ``MiniCPMVSliceProcessor`` at
        ``scale_resolution`` (448 unless set) capped at the sincos table's
        side in pixels, ``max_slice_nums`` slices (9 unless set), grids
        capped at the table's side (JAX ``sft.py:136-150``); without slice
        mode the fixed-resolution processor below.
        Qwen2-VL / Qwen2.5-VL: ``DynamicPatchProcessor`` under
        ``dynamic_resolution`` (with ``min_pixels`` / ``max_pixels``), else
        the family's fixed-grid ``PatchProcessor`` (JAX ``sft.py:113-125``;
        the 2.5 tower's config serves the Qwen2-VL patchifier).  LLaVA:
        AnyRes tiling for a LLaVA-Next config (pinpoints), else the
        fixed-resolution CLIP processor."""
        tc = self.cfgs.train_cfgs
        if self.mm is mllama:
            return MllamaTileProcessor(self.model_cfg.vision)
        if self.mm is idefics2:
            return Idefics2NaViTProcessor(
                self.model_cfg.vision,
                n_latents=self.model_cfg.perceiver.resampler_n_latents)
        if self.mm is minicpmv and self.model_cfg.slice_mode:
            rcfg = self.model_cfg.resampler
            patch = self.model_cfg.vision.patch_size
            return MiniCPMVSliceProcessor(
                self.model_cfg.vision, query_num=rcfg.num_queries,
                scale_resolution=min(int(tc.scale_resolution or 448),
                                     rcfg.max_size * patch),
                max_slice_nums=(int(tc.max_slice_nums)
                                if tc.max_slice_nums else 9),
                max_grid_side=rcfg.max_size)
        if self.mm in (qwen2_vl, qwen2_5_vl):
            if tc.dynamic_resolution:
                return qwen2_vl.DynamicPatchProcessor(
                    self.model_cfg.vision,
                    min_pixels=(int(tc.min_pixels) if tc.min_pixels
                                else None),
                    max_pixels=(int(tc.max_pixels) if tc.max_pixels
                                else None))
            return self.mm.PatchProcessor(self.model_cfg.vision)
        if getattr(self.model_cfg, 'image_grid_pinpoints', None) is not None:
            return AnyResProcessor(self.model_cfg.vision,
                                   self.model_cfg.image_grid_pinpoints)
        return ImageProcessor(ImageProcessorConfig(
            size=self.model_cfg.vision.image_size))

    def image_num_patches(self) -> int:
        """Per-image <image> expansion count at the fixed grid (a processor
        that returns a dict gives each image's own count); Idefics2's
        perceiver compresses every grid to its latent count, MiniCPM-V's
        resampler every crop to its query count."""
        if self.mm is idefics2:
            return self.model_cfg.perceiver.resampler_n_latents
        if self.mm is minicpmv:
            return self.model_cfg.resampler.num_queries
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
