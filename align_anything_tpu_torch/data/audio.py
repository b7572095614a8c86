"""Text-audio-to-text datasets, the port of ``align_anything_tpu/data/audio.py``
(reference: datasets/text_audio_to_text/*).

The host loads each clip and pads (or cuts) it to a static
``waveform_len`` samples; the log-mel spectrogram runs on the model's
device (``ops/audio.py``).  An ``<audio>`` placeholder expands to the
encoder's fixed ``num_audio_tokens`` copies of the audio token.  A raw
"audio" field may be an HF audio dict (``{'array': ...}``), an array, a
list, a ``.npy`` path or a 16-bit PCM wav path (read with the standard
library's ``wave``); a multi-channel clip is averaged to mono.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from align_anything_tpu_torch.data.datasets import (
    DEFAULT_BUCKETS,
    IGNORE_INDEX,
    PreferenceCollator,
    PromptOnlyCollator,
    SupervisedDataset,
    _common_prefix_len,
)
from align_anything_tpu_torch.data.image import (
    IMAGE_PLACEHOLDER,
    expand_image_tokens,
)
from align_anything_tpu_torch.utils.tools import bucket_length

AUDIO_PLACEHOLDER = '<audio>'


def load_waveform(audio: Any, target_len: int,
                  sample_rate: int = 16000) -> np.ndarray:
    """Raw audio (array / list / .npy / wav path / HF audio dict) ->
    (target_len,) float32, zero-padded or cut.  ``sample_rate`` is not
    read: no resampling, as in JAX."""
    if isinstance(audio, dict) and 'array' in audio:
        wave = np.asarray(audio['array'], np.float32)
    elif isinstance(audio, np.ndarray):
        wave = audio.astype(np.float32)
    elif isinstance(audio, (list, tuple)):
        wave = np.asarray(audio, np.float32)
    elif isinstance(audio, str) and audio.endswith('.npy'):
        wave = np.load(audio).astype(np.float32)
    elif isinstance(audio, str):
        import wave as wave_mod  # noqa: PLC0415

        with wave_mod.open(audio, 'rb') as f:
            raw = f.readframes(f.getnframes())
            wave = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    else:
        raise TypeError(f'unsupported audio type: {type(audio)}')
    if wave.ndim > 1:
        wave = wave.mean(axis=-1)
    out = np.zeros(target_len, np.float32)
    out[:min(len(wave), target_len)] = wave[:target_len]
    return out


def _stack_waves(waves: list) -> np.ndarray | None:
    """(B, T) of the rows' waveforms, zeros for a row without one; None
    when no row has one."""
    if all(w is None for w in waves):
        return None
    zero = next(w for w in waves if w is not None) * 0
    return np.stack([w if w is not None else zero for w in waves])


class TA2TSupervisedDataset(SupervisedDataset):
    """Audio-grounded supervised rows (reference:
    datasets/text_audio_to_text/supervised.py): the audio tokens are never
    labels."""

    def __init__(self, path: str, template, tokenizer, audio_token_id: int,
                 num_audio_tokens: int, waveform_len: int = 480000, **kw):
        super().__init__(path, template, tokenizer, **kw)
        self.audio_token_id = audio_token_id
        self.num_audio_tokens = num_audio_tokens
        self.waveform_len = waveform_len

    def _encode_mm(self, text: str) -> list[int]:
        # the image expansion with the audio placeholder
        return expand_image_tokens(
            text.replace(AUDIO_PLACEHOLDER, IMAGE_PLACEHOLDER),
            self.tokenizer, self.audio_token_id, self.num_audio_tokens)

    def _wave(self, mm: dict) -> np.ndarray | None:
        return (load_waveform(mm['audio'], self.waveform_len)
                if mm.get('audio') is not None else None)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, full_text, mm = self.template.format_supervised_sample(
            self.raw[idx])
        full_ids = self._encode_mm(full_text)[:self.max_length]
        prompt_ids = self._encode_mm(prompt_text)
        prompt_len = min(_common_prefix_len(prompt_ids, full_ids),
                         len(full_ids) - 1)
        labels = [IGNORE_INDEX] * prompt_len + full_ids[prompt_len:]
        labels = [IGNORE_INDEX if t == self.audio_token_id else lab
                  for t, lab in zip(full_ids, labels)]
        return {'input_ids': full_ids, 'labels': labels,
                'prompt_len': prompt_len, 'audio_values': self._wave(mm)}

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> 'TA2TSupervisedCollator':
        return TA2TSupervisedCollator(self.tokenizer.pad_token_id, buckets,
                                      pad_to)


class TA2TSupervisedCollator:
    """Right-padded ids, labels and mask, and ``audio_values`` (B, T)."""

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
        for i, s in enumerate(samples):
            ids = np.asarray(s['input_ids'][:length], np.int32)
            lab = np.asarray(s['labels'][:length], np.int32)
            input_ids[i, :len(ids)] = ids
            labels[i, :len(lab)] = lab
            mask[i, :len(ids)] = 1
        batch = {'input_ids': input_ids, 'labels': labels,
                 'attention_mask': mask}
        waves = _stack_waves([s['audio_values'] for s in samples])
        if waves is not None:
            batch['audio_values'] = waves
        return batch


class TA2TPreferenceDataset(TA2TSupervisedDataset):
    """Audio-grounded preference pairs (reference:
    datasets/text_audio_to_text/preference.py)."""

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
            'audio_values': self._wave(mm),
        }

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> 'TA2TPreferenceCollator':
        return TA2TPreferenceCollator(self.tokenizer.pad_token_id, buckets,
                                      pad_to)


class TA2TPreferenceCollator:
    """The text preference collator, and ``audio_values`` stacked as
    [better; worse] (each pair's clip twice)."""

    def __init__(self, pad_token_id: int, buckets=DEFAULT_BUCKETS,
                 pad_to=None):
        self.inner = PreferenceCollator(pad_token_id, buckets, pad_to)

    def __call__(self, samples: list[dict]) -> dict[str, np.ndarray]:
        batch = self.inner(samples)
        waves = _stack_waves([s['audio_values'] for s in samples])
        if waves is not None:
            batch['audio_values'] = np.concatenate([waves, waves])
        return batch


class TA2TPromptOnlyDataset(TA2TSupervisedDataset):
    """Audio-grounded prompt-only rows for the RL rollouts (JAX keeps this
    class in ``trainers/text_audio_to_text/ppo.py``): ``input_ids`` the
    prompt with <audio> expanded and no trailing EOS, ``meta``
    ``{'audio_values': (waveform_len,)}`` (empty without a clip).  Rows are
    not deduplicated, as in JAX."""

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, mm = self.template.format_prompt_only_sample(
            self.raw[idx])
        ids = self._encode_mm(prompt_text)[:self.max_length]
        if ids and ids[-1] == self.tokenizer.eos_token_id:
            ids = ids[:-1]
        wave = self._wave(mm)
        return {'input_ids': ids,
                'meta': {} if wave is None else {'audio_values': wave}}

    def get_collator(self, buckets: Sequence[int] | None = None,
                     pad_to: int | None = None) -> PromptOnlyCollator:
        return PromptOnlyCollator(self.tokenizer.pad_token_id,
                                  buckets or DEFAULT_BUCKETS, pad_to)
