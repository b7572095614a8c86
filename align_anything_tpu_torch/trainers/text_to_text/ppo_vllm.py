"""PPO with per-request rollouts, the port of
``align_anything_tpu/trainers/text_to_text/ppo_vllm.py`` (reference:
trainers/text_to_text/ppo_vllm.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.ppo_vllm \\
        --actor_model_name_or_path <dir|preset> \\
        --reward_model_name_or_path <RM slice dir> \\
        --train_datasets <path> --train_template PKUSafeRLHF

The reference runs a vLLM server beside its trainer and syncs the actor's
weights into it after every update, to buy per-request admission: short
completions do not wait on long ones.  Here the rollout reads the actor's
live params (no sync), and the continuous-batching engine
(``generation/continuous.py``) retires lanes at EOS and refills them
within the round.  So this trainer is ``PPOTrainer`` with
``rollout_backend`` defaulting to 'continuous'; a ``--rollout_backend``
given on the command line wins.  No vLLM, no Ray.
"""

from __future__ import annotations

import sys

from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.ppo import PPOTrainer


class PPOVLLMTrainer(PPOTrainer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if not self.cfgs.train_cfgs.rollout_backend:
            self.rollout_backend = 'continuous'


def main():
    trainer_main(PPOVLLMTrainer, task='text_to_text/ppo')


if __name__ == '__main__':
    sys.exit(main())
