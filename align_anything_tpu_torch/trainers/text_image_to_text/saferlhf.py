"""Safe-RLHF-V: multimodal PPO with a cost model and a Lagrange
multiplier, the port of
``align_anything_tpu/trainers/text_image_to_text/saferlhf.py`` (reference:
trainers/text_image_to_text/saferlhf.py:64-498).

Launch:
    python -m align_anything_tpu_torch.trainers.text_image_to_text.saferlhf \\
        --actor_model_name_or_path <LLaVA dir> \\
        --reward_model_name_or_path <TI2T RM slice dir> \\
        --cost_model_name_or_path <TI2T cost model slice dir> \\
        --train_datasets <path> --train_template AA_TI2T \\
        --output_dir ./output/ti2t_saferlhf

The text ``SafeRLHFTrainer`` (the dual-combined advantage, three updates
a micro-batch, the multiplier's SGD on the host) over ``TI2TPPOTrainer``'s
models, prompts, rollout and hooks: all six trees are LLaVA-class, the
cost model (frozen; default: the reward model's checkpoint, then the
actor's) and the cost critic (trained; default: the cost model's) with
their heads from ``score_head.npy``, and the pixels reach every scoring
pass and update.  As in TI2T PPO, nothing is frozen (ROADMAP §3 R13): the
cost critic's tower trains too.
"""

from __future__ import annotations

import sys

import torch

from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_image_to_text.ppo import (
    TI2TPPOTrainer,
)
from align_anything_tpu_torch.trainers.text_image_to_text.rm import (
    multimodal_end_scores,
    multimodal_scores,
)
from align_anything_tpu_torch.trainers.text_to_text.saferlhf import (
    SafeRLHFTrainer,
)


class TI2TSafeRLHFTrainer(SafeRLHFTrainer, TI2TPPOTrainer):
    def init_models(self) -> None:
        TI2TPPOTrainer.init_models(self)
        mc = self.cfgs.model_cfgs
        cost_path = (mc.cost_model_name_or_path
                     or mc.reward_model_name_or_path
                     or mc.actor_model_name_or_path)
        cost_critic_path = mc.cost_critic_model_name_or_path or cost_path
        self.cost_params, self.cost_cfg = self.load_score(cost_path)
        cost_critic_params, self.cost_critic_cfg = self.load_score(
            cost_critic_path)
        self.cost_critic_params = self.trainable(cost_critic_params)

    def compute_cost_end_scores(self, params: dict, batch: dict
                                ) -> torch.Tensor:
        return multimodal_end_scores(params, self.cost_cfg, batch)

    def compute_cost_values(self, params: dict, batch: dict
                            ) -> torch.Tensor:
        return multimodal_scores(params, self.cost_critic_cfg, batch)[:, :-1]


def main():
    trainer_main(TI2TSafeRLHFTrainer, task='text_image_to_text/saferlhf')


if __name__ == '__main__':
    sys.exit(main())
