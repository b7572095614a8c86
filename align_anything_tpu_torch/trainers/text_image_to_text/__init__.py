"""Text-image-to-text trainers: SFT and DPO over the LLaVA-class model
(``python -m align_anything_tpu_torch.trainers.text_image_to_text.<algo>``).
"""
