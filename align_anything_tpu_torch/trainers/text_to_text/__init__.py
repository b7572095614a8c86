"""Text-to-text trainers: SFT, DPO, ORPO, SimPO, the reward and cost
models, reward scoring, PPO and multi-sample PPO (``python -m
align_anything_tpu_torch.trainers.text_to_text.<algo>``)."""
