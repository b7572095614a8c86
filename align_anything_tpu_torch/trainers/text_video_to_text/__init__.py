"""Text-video-to-text trainers over the LLaVA-class model (``python -m
align_anything_tpu_torch.trainers.text_video_to_text.<algo>``): SFT, DPO,
the reward model, PPO and GRPO, each the image-text trainer of its name
over the video datasets of ``data/video.py``.
"""
