"""Image preprocessing + the text-image-to-text datasets and collators: the
port of the fixed-resolution part of ``align_anything_tpu/data/image.py``.

The host decodes and resizes (Pillow), rescales and normalizes with the
CLIP mean and std; the device does the patchify (``models/vision.py``).
Collators expand each ``<image>`` placeholder into ``num_patches`` copies of
the model's image token id (LLaVA processor semantics), so a row's length
is fixed per (text bucket, number of images).

``TI2TPromptOnlyDataset`` is the RL trainers' prompt set: each row holds
the prompt with its image expanded, and the image's pixels in ``meta``;
the text ``PromptOnlyCollator`` left-pads the rows.

Not ported yet, with the models and trainers that use them (ROADMAP §1 item
12): ``AnyResProcessor``, ``MiniCPMVSliceProcessor``,
``Idefics2NaViTProcessor`` and ``MllamaTileProcessor``.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Any, Sequence

import numpy as np

from align_anything_tpu_torch.data.chat_template import ChatTemplate
from align_anything_tpu_torch.data.datasets import (
    DEFAULT_BUCKETS,
    IGNORE_INDEX,
    PreferenceCollator,
    PreferenceDataset,
    PromptOnlyDataset,
    SupervisedDataset,
    _common_prefix_len,
)
from align_anything_tpu_torch.utils.tools import bucket_length

IMAGE_PLACEHOLDER = '<image>'

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ImageProcessorConfig:
    size: int = 224
    mean: tuple = CLIP_MEAN
    std: tuple = CLIP_STD


class ImageProcessor:
    """PIL image, array, path or bytes -> (C, H, W) float32: CLIP resize of
    the short side, center crop, normalize."""

    def __init__(self, config: ImageProcessorConfig = ImageProcessorConfig()):
        self.config = config

    def __call__(self, image: Any) -> np.ndarray:
        c = self.config
        arr = self._to_array(image)
        arr = self._resize_center_crop(arr, c.size)
        arr = arr.astype(np.float32) / 255.0
        mean = np.asarray(c.mean, np.float32)[:, None, None]
        std = np.asarray(c.std, np.float32)[:, None, None]
        return (arr.transpose(2, 0, 1) - mean) / std

    @staticmethod
    def _to_array(image: Any) -> np.ndarray:
        if isinstance(image, np.ndarray):
            arr = image
        elif hasattr(image, 'convert'):  # PIL
            arr = np.asarray(image.convert('RGB'))
        elif isinstance(image, (bytes, str)):
            from PIL import Image  # noqa: PLC0415

            img = (Image.open(io.BytesIO(image)) if isinstance(image, bytes)
                   else Image.open(image))
            arr = np.asarray(img.convert('RGB'))
        else:
            raise TypeError(f'unsupported image type: {type(image)}')
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr

    @staticmethod
    def _resize_center_crop(arr: np.ndarray, size: int) -> np.ndarray:
        h, w = arr.shape[:2]
        if (h, w) != (size, size):
            try:
                from PIL import Image  # noqa: PLC0415

                scale = size / min(h, w)
                nh, nw = round(h * scale), round(w * scale)
                img = Image.fromarray(arr).resize((nw, nh), Image.BICUBIC)
                arr = np.asarray(img)
            except ImportError:
                # without Pillow: a nearest-neighbour resample of the whole
                # image (no crop), as the JAX package does
                ys = np.linspace(0, h - 1, size).astype(int)
                xs = np.linspace(0, w - 1, size).astype(int)
                return arr[ys][:, xs]
            h, w = arr.shape[:2]
            top, left = (h - size) // 2, (w - size) // 2
            arr = arr[top:top + size, left:left + size]
        return arr


def expand_image_tokens(text: str, tokenizer, image_token_id: int,
                        num_patches: int) -> list[int]:
    """Tokenize ``text`` with each <image> replaced by ``num_patches``
    image-token ids (LlavaProcessor expansion semantics)."""
    parts = text.split(IMAGE_PLACEHOLDER)
    ids: list[int] = []
    for i, part in enumerate(parts):
        if i > 0:
            ids.extend([image_token_id] * num_patches)
        if part:
            out = tokenizer(part, add_special_tokens=(i == 0))
            part_ids = out['input_ids'] if isinstance(out, dict) else out.input_ids
            # strip a trailing eos on non-final segments and a leading bos
            # on all but the first
            if (i + 1 < len(parts) and part_ids
                    and part_ids[-1] == tokenizer.eos_token_id):
                part_ids = part_ids[:-1]
            if i > 0 and part_ids and part_ids[0] == getattr(
                    tokenizer, 'bos_token_id', None):
                part_ids = part_ids[1:]
            ids.extend(part_ids)
    return ids


class TI2TMixin:
    """Shared image plumbing for the TI2T dataset variants."""

    def _setup_mm(self, image_token_id: int, num_patches: int,
                  image_processor: ImageProcessor | None):
        self.image_token_id = image_token_id
        self.num_patches = num_patches
        self.image_processor = image_processor or ImageProcessor()

    def _encode_mm(self, text: str, n_tokens: int | None = None) -> list[int]:
        return expand_image_tokens(text, self.tokenizer, self.image_token_id,
                                   n_tokens or self.num_patches)

    def _process_image(self, image):
        """Run the image processor first: a processor that returns a dict
        decides how many <image> placeholders the text expands to
        (``num_tokens``)."""
        if image is None:
            return None, None
        out = self.image_processor(image)
        if isinstance(out, dict):
            return out, int(out['num_tokens'])
        return out, None


class TI2TSupervisedDataset(TI2TMixin, SupervisedDataset):
    """(reference: datasets/text_image_to_text/supervised.py:157-207)"""

    def __init__(self, path: str, template: ChatTemplate, tokenizer,
                 image_token_id: int, num_patches: int,
                 image_processor: ImageProcessor | None = None, **kw):
        super().__init__(path, template, tokenizer, **kw)
        self._setup_mm(image_token_id, num_patches, image_processor)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, full_text, mm = self.template.format_supervised_sample(
            self.raw[idx])
        pixel, n_tok = self._process_image(mm.get('image'))
        full_ids = self._encode_mm(full_text, n_tok)[:self.max_length]
        prompt_ids = self._encode_mm(prompt_text, n_tok)
        prompt_len = min(_common_prefix_len(prompt_ids, full_ids),
                         len(full_ids) - 1)
        labels = [IGNORE_INDEX] * prompt_len + full_ids[prompt_len:]
        # image tokens never contribute to the LM loss
        labels = [IGNORE_INDEX if t == self.image_token_id else lab
                  for t, lab in zip(full_ids, labels)]
        return {'input_ids': full_ids, 'labels': labels,
                'prompt_len': prompt_len, 'pixel_values': pixel}

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> 'TI2TSupervisedCollator':
        return TI2TSupervisedCollator(self.tokenizer.pad_token_id, buckets,
                                      pad_to)


def _stack_pixels(pixels: list) -> dict[str, np.ndarray]:
    """Stack per-sample processor outputs: arrays (fixed resolution) or
    dicts of named arrays; every key except the host-side ``num_tokens`` is
    batched, and a row without an image gets zeros."""
    first = next(p for p in pixels if p is not None)
    if isinstance(first, dict):
        zero = {k: np.asarray(v) * 0 for k, v in first.items()
                if k != 'num_tokens'}
        rows = [p if p is not None else zero for p in pixels]
        return {
            k: np.stack([np.asarray(r[k]) for r in rows]).astype(
                np.float32 if k == 'pixel_values' else np.int32)
            for k in zero
        }
    zero = first * 0
    return {'pixel_values': np.stack(
        [p if p is not None else zero for p in pixels]).astype(np.float32)}


class TI2TSupervisedCollator:
    def __init__(self, pad_token_id: int, buckets=DEFAULT_BUCKETS,
                 pad_to=None):
        self.pad_token_id = pad_token_id
        self.buckets = buckets
        self.pad_to = pad_to

    def __call__(self, samples: list[dict]) -> dict[str, np.ndarray]:
        max_len = max(len(s['input_ids']) for s in samples)
        length = self.pad_to or bucket_length(max_len, self.buckets)
        b = len(samples)
        input_ids = np.full((b, length), self.pad_token_id, np.int32)
        labels = np.full((b, length), IGNORE_INDEX, np.int32)
        mask = np.zeros((b, length), np.int32)
        pixels = []
        for i, s in enumerate(samples):
            ids = np.asarray(s['input_ids'][:length], np.int32)
            lab = np.asarray(s['labels'][:length], np.int32)
            input_ids[i, :len(ids)] = ids
            labels[i, :len(lab)] = lab
            mask[i, :len(ids)] = 1
            pixels.append(s['pixel_values'])
        batch = {'input_ids': input_ids, 'labels': labels,
                 'attention_mask': mask}
        if any(p is not None for p in pixels):
            batch.update(_stack_pixels(pixels))
        return batch


class TI2TPreferenceDataset(TI2TMixin, PreferenceDataset):
    """(reference: datasets/text_image_to_text/preference.py)"""

    def __init__(self, path: str, template: ChatTemplate, tokenizer,
                 image_token_id: int, num_patches: int,
                 image_processor: ImageProcessor | None = None, **kw):
        super().__init__(path, template, tokenizer, **kw)
        self._setup_mm(image_token_id, num_patches, image_processor)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, better_text, worse_text, mm = (
            self.template.format_preference_with_prompt(self.raw[idx]))
        pixel, n_tok = self._process_image(mm.get('image'))
        better_ids = self._encode_mm(better_text, n_tok)[:self.max_length]
        worse_ids = self._encode_mm(worse_text, n_tok)[:self.max_length]
        prompt_ids = self._encode_mm(prompt_text, n_tok)
        return {
            'better_input_ids': better_ids,
            'worse_input_ids': worse_ids,
            'better_prompt_len': min(_common_prefix_len(prompt_ids, better_ids),
                                     len(better_ids) - 1),
            'worse_prompt_len': min(_common_prefix_len(prompt_ids, worse_ids),
                                    len(worse_ids) - 1),
            'pixel_values': pixel,
        }

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> 'TI2TPreferenceCollator':
        return TI2TPreferenceCollator(self.tokenizer.pad_token_id, buckets,
                                      pad_to)


class TI2TPreferenceCollator:
    """The text preference collator, with pixel_values duplicated
    [better; worse]."""

    def __init__(self, pad_token_id: int, buckets=DEFAULT_BUCKETS,
                 pad_to=None):
        self.inner = PreferenceCollator(pad_token_id, buckets, pad_to)

    def __call__(self, samples: list[dict]) -> dict[str, np.ndarray]:
        batch = self.inner(samples)
        pixels = [s['pixel_values'] for s in samples]
        if any(p is not None for p in pixels):
            stacked = _stack_pixels(pixels)
            # rows are [better x B; worse x B]: the same image for both
            for key, arr in stacked.items():
                batch[key] = np.concatenate([arr, arr])
        return batch


class TI2TPromptOnlyDataset(TI2TMixin, PromptOnlyDataset):
    """Deduplicated image prompts for the RL trainers (JAX
    ``data/image.py`` ``TI2TPromptOnlyDataset``): a row's ``input_ids`` are
    the prompt with each <image> expanded to the image's tokens and no
    trailing EOS; its ``meta`` is ``{'pixel_values': (C, H, W)}``, or the
    template's mm-info where the row has no image.  Prompts are
    deduplicated by their text, as the text set does, so two rows that ask
    the same question of different images keep the first."""

    def __init__(self, path: str, template: ChatTemplate, tokenizer,
                 image_token_id: int, num_patches: int,
                 image_processor: ImageProcessor | None = None, **kw):
        PromptOnlyDataset.__init__(self, path, template, tokenizer, **kw)
        self._setup_mm(image_token_id, num_patches, image_processor)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        s = self.samples[idx]
        meta = dict(s['meta'])
        pixel, n_tok = self._process_image(meta.get('image'))
        ids = self._encode_mm(s['prompt_text'], n_tok)[:self.max_length]
        if ids and ids[-1] == self.tokenizer.eos_token_id:
            ids = ids[:-1]
        if pixel is not None:
            meta = {'pixel_values': pixel}
        return {'input_ids': ids, 'meta': meta}
