"""Text-to-text trainers: SFT, DPO, ORPO and SimPO (``python -m
align_anything_tpu_torch.trainers.text_to_text.<algo>``)."""
