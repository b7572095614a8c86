"""Text-video-to-text SFT, the port of
``align_anything_tpu/trainers/text_video_to_text/sft.py`` (reference:
trainers/text_video_to_text/sft.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_video_to_text.sft \\
        --model_name_or_path <LLaVA-NeXT-Video dir> --train_datasets <path> \\
        --train_template AA_TV2T --output_dir ./output/tv2t_sft

The TI2T SFT trainer over video rows: ``n_frames`` frames sampled from
each video (``train_cfgs.n_frames``, 8 by default), every frame through
the vision tower.  For a LLaVA-NeXT-Video checkpoint (a
``spatial_pool_stride``) the <video> placeholder expands to n_frames x the
pooled grid of the video token, which the model's pooled branch merges;
otherwise to n_frames x the full patch grid of the image token.

The other TV2T trainers (``dpo``, ``rm``, ``ppo``, ``grpo``) expand
<video> to n_frames x the full patch grid of the image token whatever
the checkpoint, as JAX's do.  On a LLaVA-NeXT-Video checkpoint the model
then merges its pooled frames over the video token, which their rows do
not hold, so the video does not reach the model (ROADMAP §3 R26); they
say so in one line at start-up.
"""

from __future__ import annotations

import sys

from align_anything_tpu_torch.data.image import (
    ImageProcessor,
    ImageProcessorConfig,
)
from align_anything_tpu_torch.data.video import TV2TSupervisedDataset
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.sft import (
    TI2TSupervisedTrainer,
)


def video_dataset(trainer, dataset_cls, path: str, template, max_len: int,
                  image_token_id: int, num_patches: int, **kw):
    """A TV2T dataset of ``trainer``'s tokenizer: <video> expands to
    ``n_frames * num_patches`` ``image_token_id``s, frames through the
    fixed-resolution CLIP processor."""
    return dataset_cls(
        path, template, trainer.tokenizer, image_token_id=image_token_id,
        num_patches=num_patches,
        n_frames=int(trainer.cfgs.train_cfgs.n_frames or 8),
        image_processor=ImageProcessor(ImageProcessorConfig(
            size=trainer.model_cfg.vision.image_size)),
        max_length=max_len, **kw)


def image_token_video_dataset(trainer, dataset_cls, path: str, template,
                              max_len: int, **kw):
    """``video_dataset`` with JAX's choice for TV2T DPO, RM, PPO and GRPO:
    the image token and the full patch grid a frame.  On a config with a
    pool stride it says at start-up that the video is dropped (R26)."""
    cfg = trainer.model_cfg
    if cfg.spatial_pool_stride is not None:
        trainer.logger.print(
            f'<video> expands to image token {cfg.image_token_id} x '
            f'{cfg.vision.num_patches} a frame, but this LLaVA-NeXT-Video '
            f'config merges pooled frames over video token '
            f'{cfg.video_token_id}, which the rows do not hold: as in JAX, '
            'the video does not reach the model (ROADMAP §3 R26)')
    return video_dataset(trainer, dataset_cls, path, template, max_len,
                         cfg.image_token_id, cfg.vision.num_patches, **kw)


class TV2TSupervisedTrainer(TI2TSupervisedTrainer):
    def video_num_patches(self) -> int:
        """Per-frame <video> expansion: the pooled grid for LLaVA-Next-Video
        checkpoints (HF LlavaNextVideoPooler), the full grid otherwise."""
        stride = self.model_cfg.spatial_pool_stride
        if stride:
            side = (self.model_cfg.vision.image_size
                    // self.model_cfg.vision.patch_size // stride)
            return side * side
        return self.model_cfg.vision.num_patches

    def video_merge_token(self) -> int:
        return self.model_cfg.video_token_id or self.model_cfg.image_token_id

    def make_dataset(self, dataset_cls, path, template, max_len, **kw):
        return video_dataset(self, TV2TSupervisedDataset, path, template,
                             max_len, self.video_merge_token(),
                             self.video_num_patches(), **kw)


def main():
    trainer_main(TV2TSupervisedTrainer, task='text_video_to_text/sft')


if __name__ == '__main__':
    sys.exit(main())
