"""Dataset formatters: raw samples -> chat conversations.

Re-implementations of the reference's registered templates
(configs/format_dataset.py:183-2147; 48 registrations).  Each formatter maps
a raw dataset row to `[{'role': ..., 'content': ...}, ...]` conversations
plus a multimodal-info dict.  The port of
``align_anything_tpu/data/formatters.py``, unchanged: the text-modality
set; the image-text formatters are in ``multimodal_formatters.py``.
"""

from __future__ import annotations

from typing import Any

from align_anything_tpu_torch.data.template_registry import register_template


Conversation = list[dict[str, Any]]


class BaseFormatter:
    system_prompt: str = ''

    def format_supervised_sample(self, raw_sample: dict) -> tuple[Conversation, dict]:
        raise NotImplementedError

    def format_preference_sample(self, raw_sample: dict
                                 ) -> tuple[Conversation, Conversation, dict]:
        raise NotImplementedError

    def format_prompt_only_sample(self, raw_sample: dict) -> tuple[Conversation, dict]:
        raise NotImplementedError

    def format_unmatched_supervised_sample(self, raw_sample_for_prompt: dict,
                                           raw_sample_for_response: dict
                                           ) -> tuple[Conversation, dict]:
        raise NotImplementedError

    def format_diffusion_supervised_sample(self, raw_sample: dict
                                           ) -> tuple[str, dict]:
        """-> (caption/prompt text, media dict) for diffusion training."""
        raise NotImplementedError

    def format_diffusion_preference_sample(self, raw_sample: dict
                                           ) -> tuple[str, dict]:
        raise NotImplementedError


def _chat(prompt: str, response: str | None = None) -> Conversation:
    conv = [{'role': 'user', 'content': prompt}]
    if response is not None:
        conv.append({'role': 'assistant', 'content': response})
    return conv


@register_template('Alpaca')
class Alpaca(BaseFormatter):
    """(format_dataset.py:183-194)"""

    def format_supervised_sample(self, raw_sample):
        prompt = ' '.join((raw_sample['instruction'], raw_sample['input']))
        return _chat(prompt, raw_sample['output']), {}


@register_template('PKUSafeRLHF')
class PKUSafeRLHF(BaseFormatter):
    """(format_dataset.py:197-245)"""

    def format_preference_sample(self, raw_sample):
        better_id = int(raw_sample['better_response_id'])
        better = raw_sample[f'response_{better_id}']
        worse = raw_sample[f'response_{1 - better_id}']
        prompt = raw_sample['prompt']
        meta = {'better_response': better, 'worse_response': worse}
        return _chat(prompt, better), _chat(prompt, worse), meta

    def format_prompt_only_sample(self, raw_sample):
        return _chat(raw_sample['prompt']), {}

    def format_unmatched_supervised_sample(self, raw_for_prompt, raw_for_response):
        return _chat(raw_for_prompt['prompt'],
                     raw_for_response['response_1']), {}

    def check_equal(self, raw_sample):
        return raw_sample['response_0'] == raw_sample['response_1']


@register_template('AA_T2T')
class AA_T2T(BaseFormatter):
    """align-anything text-to-text preference dataset."""

    def format_supervised_sample(self, raw_sample):
        return _chat(raw_sample['question'], raw_sample['response']), {}

    def format_preference_sample(self, raw_sample):
        overall = int(raw_sample['overall_response'])
        better = raw_sample[f'response_{overall}']
        worse = raw_sample[f'response_{3 - overall}' if overall in (1, 2)
                           else 'response_1']
        prompt = raw_sample['question']
        return _chat(prompt, better), _chat(prompt, worse), {}

    def format_prompt_only_sample(self, raw_sample):
        return _chat(raw_sample['question']), {}


@register_template('HOMEPAGE')
class Homepage(PKUSafeRLHF):
    pass


@register_template('Dialogue')
class Dialogue(BaseFormatter):
    def format_supervised_sample(self, raw_sample):
        return _chat(raw_sample['prompt'], raw_sample['response']), {}

    def format_prompt_only_sample(self, raw_sample):
        return _chat(raw_sample['prompt']), {}


@register_template('TLDR')
class TLDR(BaseFormatter):
    def format_supervised_sample(self, raw_sample):
        return _chat(raw_sample['prompt'], raw_sample['completion']), {}

    def format_prompt_only_sample(self, raw_sample):
        return _chat(raw_sample['prompt']), {}


@register_template('GSM8K')
class GSM8K(BaseFormatter):
    def format_supervised_sample(self, raw_sample):
        return _chat(raw_sample['question'], raw_sample['answer']), {}

    def format_prompt_only_sample(self, raw_sample):
        return _chat(raw_sample['question']), {}


@register_template('Math-Zero-RL')
class MathZeroRL(BaseFormatter):
    """Rule-based-reward RL prompts: carries the golden answer in meta."""

    def format_prompt_only_sample(self, raw_sample):
        prompt = raw_sample.get('problem') or raw_sample.get('question')
        return _chat(prompt), {'golden_answer': raw_sample.get('answer')}


@register_template('HelpSteer2')
class HelpSteer2(BaseFormatter):
    def format_preference_sample(self, raw_sample):
        prompt = raw_sample['prompt']
        if raw_sample['helpfulness_1'] >= raw_sample['helpfulness_2']:
            better, worse = raw_sample['response_1'], raw_sample['response_2']
        else:
            better, worse = raw_sample['response_2'], raw_sample['response_1']
        return _chat(prompt, better), _chat(prompt, worse), {}


@register_template('UltraFeedback')
class UltraFeedback(BaseFormatter):
    def format_preference_sample(self, raw_sample):
        prompt = raw_sample['prompt']
        return (_chat(prompt, raw_sample['chosen']),
                _chat(prompt, raw_sample['rejected']), {})

    def format_prompt_only_sample(self, raw_sample):
        return _chat(raw_sample['prompt']), {}


@register_template('O1_T2T')
class O1T2T(BaseFormatter):
    """Long-CoT SFT: concatenates reasoning and final answer."""

    def format_supervised_sample(self, raw_sample):
        response = raw_sample.get('response', '')
        thought = raw_sample.get('thought') or raw_sample.get('reasoning')
        if thought:
            response = f'<think>{thought}</think>\n{response}'
        return _chat(raw_sample['prompt'], response), {}
