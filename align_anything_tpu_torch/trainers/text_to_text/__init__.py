"""Text-to-text trainers: SFT, DPO, KTO, ORPO, SimPO, the reward and cost
models, reward scoring, PPO, multi-sample PPO, GRPO, Safe-RLHF, PPO with a
remote reward server and PPO with the continuous rollout by default
(``python -m align_anything_tpu_torch.trainers.text_to_text.<algo>``)."""
