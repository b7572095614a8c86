"""Multi-sample PPO: n completions per prompt, for the group advantage
estimators.  The port of
``align_anything_tpu/trainers/text_to_text/multi_ppo.py`` (reference:
trainers/text_to_text/multi_ppo.py:95-101,515-591).

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.multi_ppo \\
        --actor_model_name_or_path <dir|preset> \\
        --reward_model_name_or_path <RM slice dir> \\
        --train_datasets <path> --train_template PKUSafeRLHF \\
        --n_samples_per_prompt 4 --advantage_estimator rloo

``PPOTrainer`` carries the estimator switch (gae | reinforce | rloo |
reinforce_baseline | group_norm); this subclass repeats each prompt
``n_samples_per_prompt`` times, so a group's samples are consecutive rows.
"""

from __future__ import annotations

import sys

import numpy as np

from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.ppo import PPOTrainer


class MultiPPOTrainer(PPOTrainer):
    def rollout(self, prompt_batch: dict):
        n = self.n_samples_per_prompt
        if n > 1:
            prompt_batch = dict(
                prompt_batch,
                input_ids=np.repeat(prompt_batch['input_ids'], n, axis=0),
                attention_mask=np.repeat(prompt_batch['attention_mask'], n,
                                         axis=0),
            )
        return super().rollout(prompt_batch)


def main():
    trainer_main(MultiPPOTrainer, task='text_to_text/ppo')


if __name__ == '__main__':
    sys.exit(main())
