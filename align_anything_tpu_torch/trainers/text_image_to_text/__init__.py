"""Text-image-to-text trainers over the LLaVA-class model (``python -m
align_anything_tpu_torch.trainers.text_image_to_text.<algo>``): SFT, DPO,
the reward and cost models, PPO, GRPO, Safe-RLHF-V, KTO, ORPO and SimPO.
"""
