"""Text-video-to-text datasets, the port of
``align_anything_tpu/data/video.py`` (reference:
datasets/text_video_to_text/* + utils/process_video.py:35).

A raw "video" field may be a (T, H, W, C) array, a ``.npy`` path, or a list
of frames.  ``sample_frames`` picks ``n_frames`` uniformly (the reference's
decord/torchvision readers reduced to the same contract), and each frame
goes through the CLIP processor of ``data/image.py``: a row's
``pixel_values`` are (n_frames, C, H, W), and a batch's are 5-D.  The
``<video>`` placeholder expands to ``n_frames * num_patches`` copies of
the dataset's ``image_token_id`` (the trainers choose both: the pooled
count and the video token for LLaVA-NeXT-Video SFT, the full patch grid
and the image token elsewhere).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from align_anything_tpu_torch.data.datasets import (
    DEFAULT_BUCKETS,
    IGNORE_INDEX,
    PromptOnlyCollator,
    _common_prefix_len,
)
from align_anything_tpu_torch.data.image import (
    IMAGE_PLACEHOLDER,
    ImageProcessor,
    TI2TPreferenceCollator,
    TI2TSupervisedCollator,
    TI2TSupervisedDataset,
    expand_image_tokens,
)

VIDEO_PLACEHOLDER = '<video>'


def sample_frames(video: Any, n_frames: int) -> list[Any]:
    """``n_frames`` frames picked uniformly (``linspace`` over the frame
    indices, truncated) from a (T, H, W, C) array, a ``.npy`` path or a
    list of frames."""
    if isinstance(video, str) and video.endswith('.npy'):
        video = np.load(video)
    if isinstance(video, (np.ndarray, list, tuple)):
        t = video.shape[0] if isinstance(video, np.ndarray) else len(video)
        idx = np.linspace(0, t - 1, n_frames).astype(int)
        return [video[i] for i in idx]
    raise TypeError(f'unsupported video type: {type(video)}')


class TV2TSupervisedDataset(TI2TSupervisedDataset):
    """Video-grounded supervised rows (reference:
    datasets/text_video_to_text/supervised.py)."""

    def __init__(self, path: str, template, tokenizer, image_token_id: int,
                 num_patches: int, n_frames: int = 8,
                 image_processor: ImageProcessor | None = None, **kw):
        super().__init__(path, template, tokenizer,
                         image_token_id=image_token_id,
                         num_patches=num_patches,
                         image_processor=image_processor, **kw)
        self.n_frames = n_frames

    def _encode_mm(self, text: str) -> list[int]:
        text = text.replace(VIDEO_PLACEHOLDER, IMAGE_PLACEHOLDER)
        return expand_image_tokens(text, self.tokenizer, self.image_token_id,
                                   self.num_patches * self.n_frames)

    def _frames(self, mm: dict) -> np.ndarray | None:
        """(n_frames, C, H, W) of the row's video, or None."""
        if mm.get('video') is None:
            return None
        return np.stack([self.image_processor(f)
                         for f in sample_frames(mm['video'], self.n_frames)])

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, full_text, mm = self.template.format_supervised_sample(
            self.raw[idx])
        full_ids = self._encode_mm(full_text)[:self.max_length]
        prompt_ids = self._encode_mm(prompt_text)
        prompt_len = min(_common_prefix_len(prompt_ids, full_ids),
                         len(full_ids) - 1)
        labels = [IGNORE_INDEX] * prompt_len + full_ids[prompt_len:]
        labels = [IGNORE_INDEX if t == self.image_token_id else lab
                  for t, lab in zip(full_ids, labels)]
        return {'input_ids': full_ids, 'labels': labels,
                'prompt_len': prompt_len, 'pixel_values': self._frames(mm)}

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> TI2TSupervisedCollator:
        return TI2TSupervisedCollator(self.tokenizer.pad_token_id, buckets,
                                      pad_to)


class TV2TPreferenceDataset(TV2TSupervisedDataset):
    """Video-grounded preference pairs (reference:
    datasets/text_video_to_text/preference.py)."""

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, better_text, worse_text, mm = (
            self.template.format_preference_with_prompt(self.raw[idx]))
        better_ids = self._encode_mm(better_text)[:self.max_length]
        worse_ids = self._encode_mm(worse_text)[:self.max_length]
        prompt_ids = self._encode_mm(prompt_text)
        return {
            'better_input_ids': better_ids,
            'worse_input_ids': worse_ids,
            'better_prompt_len': min(_common_prefix_len(prompt_ids, better_ids),
                                     len(better_ids) - 1),
            'worse_prompt_len': min(_common_prefix_len(prompt_ids, worse_ids),
                                    len(worse_ids) - 1),
            'pixel_values': self._frames(mm),
        }

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> TI2TPreferenceCollator:
        return TI2TPreferenceCollator(self.tokenizer.pad_token_id, buckets,
                                      pad_to)


class TV2TPromptOnlyDataset(TV2TSupervisedDataset):
    """Video-grounded prompt-only rows for the RL rollouts: ``input_ids``
    the prompt with <video> expanded and no trailing EOS, ``meta``
    ``{'pixel_values': (n_frames, C, H, W)}`` (empty without a video).
    Unlike the image prompt set, rows are not deduplicated, as in JAX."""

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, mm = self.template.format_prompt_only_sample(
            self.raw[idx])
        ids = self._encode_mm(prompt_text)[:self.max_length]
        if ids and ids[-1] == self.tokenizer.eos_token_id:
            ids = ids[:-1]
        frames = self._frames(mm)
        return {'input_ids': ids,
                'meta': {} if frames is None else {'pixel_values': frames}}

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> PromptOnlyCollator:
        return PromptOnlyCollator(self.tokenizer.pad_token_id, buckets,
                                  pad_to)
