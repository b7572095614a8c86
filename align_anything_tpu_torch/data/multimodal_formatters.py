"""Multimodal dataset formatters: the port of the image-text templates of
``align_anything_tpu/data/multimodal_formatters.py`` (AA_TI2T,
LLaVA_Instruct, RLAIFV, SPA_VL, SafeRLHF_V), unchanged.

Rebuilds the reference's multimodal registrations
(configs/format_dataset.py).  Conversations carry an ``<image>``
placeholder in the text; the raw image rides in the mm-info dict for the
collator.  The audio and video templates wait for their models (ROADMAP
§1 item 12).
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
