"""Text-video-to-text GRPO, the port of
``align_anything_tpu/trainers/text_video_to_text/grpo.py`` (see
``trainers/text_image_to_text/grpo.py``).

Launch:
    python -m align_anything_tpu_torch.trainers.text_video_to_text.grpo \\
        --actor_model_name_or_path <LLaVA dir> \\
        --reward_model_name_or_path <TV2T RM slice dir> \\
        --train_datasets <path> --train_template AA_TV2T \\
        --num_generations 4 --output_dir ./output/tv2t_grpo

TI2T GRPO over video prompts (5-D ``pixel_values``).  It reads the task
``text_image_to_text/grpo``, as JAX does (there is no TV2T GRPO config),
so ``n_frames`` is 8 unless given.  <video> expands to n_frames x the full
patch grid of the image token, as in JAX (on a LLaVA-NeXT-Video
checkpoint: ROADMAP §3 R26, see ``sft.py``).
"""

from __future__ import annotations

import sys

from align_anything_tpu_torch.data.video import TV2TPromptOnlyDataset
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.grpo import (
    TI2TGRPOTrainer,
)
from align_anything_tpu_torch.trainers.text_video_to_text.sft import (
    image_token_video_dataset,
)


class TV2TGRPOTrainer(TI2TGRPOTrainer):
    def make_prompt_dataset(self, path, template, max_len, **kw):
        return image_token_video_dataset(self, TV2TPromptOnlyDataset, path,
                                         template, max_len, **kw)


def main():
    trainer_main(TV2TGRPOTrainer, task='text_image_to_text/grpo')


if __name__ == '__main__':
    sys.exit(main())
