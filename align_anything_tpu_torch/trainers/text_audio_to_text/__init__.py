"""Text-audio-to-text trainers over the Qwen2-Audio-class model
(``python -m align_anything_tpu_torch.trainers.text_audio_to_text.<algo>``):
SFT, DPO, the reward model, PPO and GRPO over the audio datasets of
``data/audio.py``.
"""
