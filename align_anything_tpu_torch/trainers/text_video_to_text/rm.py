"""Text-video-to-text reward model, the port of
``align_anything_tpu/trainers/text_video_to_text/rm.py`` (reference:
trainers/text_video_to_text/rm.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_video_to_text.rm \\
        --model_name_or_path <LLaVA dir> --train_datasets <path> \\
        --train_template AA_TV2T --output_dir ./output/tv2t_rm

The TI2T reward model over video preference pairs (5-D ``pixel_values``),
<video> expanded to n_frames x the full patch grid of the image token, as
in JAX (on a LLaVA-NeXT-Video checkpoint: ROADMAP §3 R26, see
``sft.py``).  Its export (the trunk's slice and ``score_head.npy``) is
what the TV2T PPO and GRPO trainers read.
"""

from __future__ import annotations

import sys

from align_anything_tpu_torch.data.video import TV2TPreferenceDataset
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.rm import (
    TI2TRMTrainer,
)
from align_anything_tpu_torch.trainers.text_video_to_text.sft import (
    image_token_video_dataset,
)


class TV2TRMTrainer(TI2TRMTrainer):
    def make_dataset(self, dataset_cls, path, template, max_len, **kw):
        return image_token_video_dataset(self, TV2TPreferenceDataset, path,
                                         template, max_len, **kw)


def main():
    trainer_main(TV2TRMTrainer, task='text_video_to_text/rm')


if __name__ == '__main__':
    sys.exit(main())
