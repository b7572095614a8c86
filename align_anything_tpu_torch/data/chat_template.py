"""Model chat formatting + the ChatTemplate facade.

Behavior-parity with configs/format_model.py:22-76 (HF ``apply_chat_template``
when the tokenizer has one, ``ROLE: text`` fallback otherwise) and
configs/template.py:25-114 (dataset formatter x model formatter composition,
prompt/full-text split for label masking, check_equal/check_validation).
The port of ``align_anything_tpu/data/chat_template.py``, unchanged.
"""

from __future__ import annotations

from typing import Any, Callable

from align_anything_tpu_torch.data.template_registry import get_template_class


class ModelFormatter:
    def __init__(self, formatter: Any = None,
                 custom_formatter: Callable | None = None) -> None:
        self.formatter = formatter
        if custom_formatter is not None:
            self.format_sample = custom_formatter
        elif (formatter is not None
              and hasattr(formatter, 'apply_chat_template')
              and getattr(formatter, 'chat_template', None)):
            self.format_sample = self.format_with_template
        else:
            self.format_sample = self.default_format

    def __call__(self, raw_sample: list[dict[str, Any]],
                 add_generation_prompt: bool = False) -> str:
        return self.format_sample(raw_sample, add_generation_prompt)

    def default_format(self, raw_sample: list[dict[str, Any]],
                       add_generation_prompt: bool = False) -> str:
        final_text = ''
        for line in raw_sample:
            content = line['content']
            if isinstance(content, list):
                for item in content:
                    if item.get('type') == 'text':
                        final_text += line['role'].upper() + ': ' + item['text'] + '\n'
            elif isinstance(content, str):
                final_text += line['role'].upper() + ': ' + content + '\n'
            else:
                raise ValueError(f'Unknown content type: {type(content)}')
        if add_generation_prompt:
            final_text += 'ASSISTANT: '
        return final_text

    def format_with_template(self, raw_sample: list[dict[str, Any]],
                             add_generation_prompt: bool = False) -> str:
        return self.formatter.apply_chat_template(
            raw_sample, tokenize=False,
            add_generation_prompt=add_generation_prompt,
        )


class ChatTemplate:
    """dataset formatter x model formatter; the datasets' single entry point."""

    def __init__(self, formatter: Any = None, template: str | None = None,
                 custom_formatter: Callable | None = None) -> None:
        self.dataset_formatter = get_template_class(template) if template else None
        self.model_formatter = ModelFormatter(formatter, custom_formatter)

    def format_supervised_sample(self, raw_sample: dict) -> tuple[str, str, Any]:
        conversation, mm_info = self.dataset_formatter.format_supervised_sample(raw_sample)
        prompt = conversation[:-1]
        return (self.model_formatter(prompt),
                self.model_formatter(conversation), mm_info)

    def format_preference_sample(self, raw_sample: dict) -> tuple[str, str, Any]:
        better, worse, mm_info = self.dataset_formatter.format_preference_sample(raw_sample)
        return self.model_formatter(better), self.model_formatter(worse), mm_info

    def format_preference_with_prompt(self, raw_sample: dict
                                      ) -> tuple[str, str, str, Any]:
        """(prompt_text, better_full, worse_full, mm_info) — lets collators
        mask prompt tokens exactly rather than re-deriving the split."""
        better, worse, mm_info = self.dataset_formatter.format_preference_sample(raw_sample)
        prompt = self.model_formatter(better[:-1])
        return (prompt, self.model_formatter(better),
                self.model_formatter(worse), mm_info)

    def format_diffusion_supervised_sample(self, raw_sample: dict):
        return self.dataset_formatter.format_diffusion_supervised_sample(
            raw_sample)

    def format_diffusion_preference_sample(self, raw_sample: dict):
        return self.dataset_formatter.format_diffusion_preference_sample(
            raw_sample)

    def format_prompt_only_sample(self, raw_sample: dict,
                                  apply_chat_template: bool = True) -> tuple[str, Any]:
        raw_prompt, mm_info = self.dataset_formatter.format_prompt_only_sample(raw_sample)
        if apply_chat_template:
            return self.model_formatter(raw_prompt, add_generation_prompt=True), mm_info
        content = raw_prompt[0]['content']
        if isinstance(content, list):
            return content[0]['text'], mm_info
        if isinstance(content, str):
            return content, mm_info
        raise ValueError(f'Unknown format for raw_prompt: {raw_prompt}')

    def format_unmatched_supervised_sample(self, raw_for_prompt: dict,
                                           raw_for_response: dict) -> tuple[str, str, Any]:
        conversation, mm_info = self.dataset_formatter.format_unmatched_supervised_sample(
            raw_for_prompt, raw_for_response)
        prompt = conversation[:-1]
        return (self.model_formatter(prompt),
                self.model_formatter(conversation), mm_info)

    def format_chat_sample(self, conversation: list[dict[str, Any]]) -> tuple[str, Any]:
        return self.model_formatter(conversation), {}

    def check_equal(self, raw_sample: dict) -> bool:
        if hasattr(self.dataset_formatter, 'check_equal'):
            return self.dataset_formatter.check_equal(raw_sample)
        better, worse, _ = self.dataset_formatter.format_preference_sample(raw_sample)
        return better == worse

    def check_validation(self, raw_sample: dict) -> bool:
        if hasattr(self.dataset_formatter, 'check_validation'):
            return self.dataset_formatter.check_validation(raw_sample)
        return True
