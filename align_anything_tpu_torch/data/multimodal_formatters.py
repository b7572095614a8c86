"""Multimodal dataset formatters: the port of the image-text, audio-text
and video templates of ``align_anything_tpu/data/multimodal_formatters.py``
(AA_TI2T, LLaVA_Instruct, RLAIFV, SPA_VL, SafeRLHF_V, AA_TA2T,
LibriSpeech, AA_TV2T, AudioCaps, AudioSet, Qwen2-VL), unchanged.

Rebuilds the reference's multimodal registrations
(configs/format_dataset.py).  Conversations carry an ``<image>``,
``<audio>`` or ``<video>`` placeholder in the text; the raw media rides in
the mm-info dict for the collator.  The templates of the generation
models (the diffusion ones, WavCaps and AA_T2A for text-to-audio) wait for
those models (ROADMAP §1 item 15).
"""

from __future__ import annotations

from align_anything_tpu_torch.data.formatters import BaseFormatter, _chat
from align_anything_tpu_torch.data.template_registry import register_template


@register_template('AA_TI2T')
class AA_TI2T(BaseFormatter):
    """align-anything text-image-to-text (format_dataset.py AA_TI2T)."""

    def format_supervised_sample(self, raw_sample: dict):
        prompt = f"<image>\n{raw_sample['question']}"
        return _chat(prompt, raw_sample['response']), {'image': raw_sample['image']}

    def format_preference_sample(self, raw_sample: dict):
        overall = int(raw_sample['overall_response'])
        better = raw_sample[f'response_{overall}']
        worse = raw_sample[f'response_{3 - overall}' if overall in (1, 2)
                           else 'response_1']
        prompt = f"<image>\n{raw_sample['question']}"
        return (_chat(prompt, better), _chat(prompt, worse),
                {'image': raw_sample['image']})

    def format_unmatched_supervised_sample(self, raw_for_prompt,
                                           raw_for_response):
        # KTO's KL baseline pairs prompts with shuffled responses; text-only
        # (no <image> placeholder) so the batch needs no pixel inputs
        response = (raw_for_response.get('response_1')
                    or raw_for_response.get('response_0') or '')
        return _chat(raw_for_prompt['question'], response), {}

    def format_prompt_only_sample(self, raw_sample: dict):
        return (_chat(f"<image>\n{raw_sample['question']}"),
                {'image': raw_sample['image']})


@register_template('LLaVA_Instruct')
class LlavaInstruct(BaseFormatter):
    """llava-instruct-150k style: conversations list + image file."""

    def format_supervised_sample(self, raw_sample: dict):
        conv = []
        for turn in raw_sample['conversations']:
            role = 'user' if turn.get('from') in ('human', 'user') else 'assistant'
            conv.append({'role': role, 'content': turn['value']})
        return conv, {'image': raw_sample.get('image')}


@register_template('RLAIFV')
class RLAIFV(BaseFormatter):
    """(format_dataset.py RLAIFV)"""

    def format_preference_sample(self, raw_sample: dict):
        prompt = f"<image>\n{raw_sample['question']}"
        return (_chat(prompt, raw_sample['chosen']),
                _chat(prompt, raw_sample['rejected']),
                {'image': raw_sample['image']})


@register_template('SPA_VL')
class SPA_VL(BaseFormatter):
    """(format_dataset.py SPA_VL — safety preference over images)"""

    def format_preference_sample(self, raw_sample: dict):
        prompt = f"<image>\n{raw_sample['question']}"
        return (_chat(prompt, raw_sample['chosen']),
                _chat(prompt, raw_sample['rejected']),
                {'image': raw_sample['image']})

    def format_prompt_only_sample(self, raw_sample: dict):
        return (_chat(f"<image>\n{raw_sample['question']}"),
                {'image': raw_sample['image']})


@register_template('SafeRLHF_V')
class SafeRLHFV(BaseFormatter):
    """Safe-RLHF-V reward/cost pairs (format_dataset.py SafeRLHF_V_*)."""

    def format_preference_sample(self, raw_sample: dict):
        better_id = int(raw_sample['better_response_id'])
        prompt = f"<image>\n{raw_sample['prompt']}"
        return (_chat(prompt, raw_sample[f'response_{better_id}']),
                _chat(prompt, raw_sample[f'response_{1 - better_id}']),
                {'image': raw_sample['image']})


@register_template('AA_TA2T')
class AA_TA2T(BaseFormatter):
    """align-anything text-audio-to-text (format_dataset.py AA_TA2T)."""

    def format_supervised_sample(self, raw_sample: dict):
        prompt = f"<audio>\n{raw_sample['question']}"
        return _chat(prompt, raw_sample['response']), {'audio': raw_sample['audio']}

    def format_prompt_only_sample(self, raw_sample: dict):
        return (_chat(f"<audio>\n{raw_sample['question']}"),
                {'audio': raw_sample['audio']})

    def format_preference_sample(self, raw_sample: dict):
        overall = int(raw_sample['overall_response'])
        better = raw_sample[f'response_{overall}']
        worse = raw_sample[f'response_{3 - overall}' if overall in (1, 2)
                           else 'response_1']
        prompt = f"<audio>\n{raw_sample['question']}"
        return (_chat(prompt, better), _chat(prompt, worse),
                {'audio': raw_sample['audio']})


@register_template('LibriSpeech')
class LibriSpeech(BaseFormatter):
    def format_supervised_sample(self, raw_sample: dict):
        prompt = '<audio>\nTranscribe the audio.'
        return _chat(prompt, raw_sample['text']), {'audio': raw_sample['audio']}


@register_template('AA_TV2T')
class AA_TV2T(BaseFormatter):
    """align-anything text-video-to-text (format_dataset.py AA_TV2T)."""

    def format_supervised_sample(self, raw_sample: dict):
        prompt = f"<video>\n{raw_sample['question']}"
        return _chat(prompt, raw_sample['response']), {'video': raw_sample['video']}

    def format_prompt_only_sample(self, raw_sample: dict):
        return (_chat(f"<video>\n{raw_sample['question']}"),
                {'video': raw_sample['video']})

    def format_preference_sample(self, raw_sample: dict):
        overall = int(raw_sample['overall_response'])
        better = raw_sample[f'response_{overall}']
        worse = raw_sample[f'response_{3 - overall}' if overall in (1, 2)
                           else 'response_1']
        prompt = f"<video>\n{raw_sample['question']}"
        return (_chat(prompt, better), _chat(prompt, worse),
                {'video': raw_sample['video']})


def _qwen2_vl_prompt(raw_sample: dict) -> tuple[str, dict]:
    """The question behind a ``<video>`` or ``<image>`` placeholder (a video
    first, as JAX checks), and the media it names."""
    prompt = raw_sample['question']
    if raw_sample.get('video') is not None:
        return f'<video>\n{prompt}', {'video': raw_sample['video']}
    if raw_sample.get('image') is not None:
        return f'<image>\n{prompt}', {'image': raw_sample['image']}
    return prompt, {}


@register_template('AudioCaps')
class AudioCaps(BaseFormatter):
    """(format_dataset.py:1410-1428): captioning over audio clips."""

    def format_supervised_sample(self, raw_sample: dict):
        prompt = '<audio>\nDescribe the audio.'
        return _chat(prompt, raw_sample['caption']), {
            'audio': raw_sample.get('audiocap_path') or raw_sample.get('audio')}

    def format_diffusion_supervised_sample(self, raw_sample: dict):
        return raw_sample['caption'], {
            'audio': raw_sample.get('audiocap_path') or raw_sample.get('audio')}


@register_template('AudioSet')
class AudioSet(AudioCaps):
    pass


@register_template('Qwen2-VL')
class Qwen2VL(BaseFormatter):
    """(format_dataset.py Qwen2-VL): image or video grounded conversations."""

    def format_supervised_sample(self, raw_sample: dict):
        prompt, media = _qwen2_vl_prompt(raw_sample)
        return _chat(prompt, raw_sample['response']), media

    def format_preference_sample(self, raw_sample: dict):
        overall = int(raw_sample['overall_response'])
        better = raw_sample[f'response_{overall}']
        worse = raw_sample[f'response_{3 - overall}' if overall in (1, 2)
                           else 'response_1']
        prompt, media = _qwen2_vl_prompt(raw_sample)
        return _chat(prompt, better), _chat(prompt, worse), media
