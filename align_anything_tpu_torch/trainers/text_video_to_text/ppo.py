"""Text-video-to-text PPO, the port of
``align_anything_tpu/trainers/text_video_to_text/ppo.py`` (reference:
trainers/text_video_to_text/ppo.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_video_to_text.ppo \\
        --actor_model_name_or_path <LLaVA dir> \\
        --reward_model_name_or_path <TV2T RM slice dir> \\
        --train_datasets <path> --train_template AA_TV2T \\
        --output_dir ./output/tv2t_ppo

TI2T PPO over video prompts: the rollout's prefill, the scoring pass and
the updates take each prompt's frames as 5-D ``pixel_values``; <video>
expands to n_frames x the full patch grid of the image token, as in JAX
(on a LLaVA-NeXT-Video checkpoint: ROADMAP §3 R26, see ``sft.py``).  No
PTX, as in JAX.
"""

from __future__ import annotations

import sys

from align_anything_tpu_torch.data.video import TV2TPromptOnlyDataset
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.ppo import (
    TI2TPPOTrainer,
)
from align_anything_tpu_torch.trainers.text_video_to_text.sft import (
    image_token_video_dataset,
)


class TV2TPPOTrainer(TI2TPPOTrainer):
    def make_prompt_dataset(self, path, template, max_len, **kw):
        return image_token_video_dataset(self, TV2TPromptOnlyDataset, path,
                                         template, max_len, **kw)


def main():
    trainer_main(TV2TPPOTrainer, task='text_video_to_text/ppo')


if __name__ == '__main__':
    sys.exit(main())
