"""The data layer: the port of ``align_anything_tpu/data`` (templates,
chat formatting, tokenizers, datasets, collators, the iterator), with the
image-text templates (``multimodal_formatters.py``) and datasets
(``image.py``: the supervised, preference and prompt-only sets).  The
audio and video templates and the other multimodal processors are not
ported yet (ROADMAP §1 item 12)."""

from align_anything_tpu_torch.data import formatters  # noqa: F401  (registers templates)
from align_anything_tpu_torch.data import multimodal_formatters  # noqa: F401
from align_anything_tpu_torch.data.chat_template import ChatTemplate, ModelFormatter
from align_anything_tpu_torch.data.datasets import (
    DEFAULT_BUCKETS,
    IGNORE_INDEX,
    DataIterator,
    PreferenceCollator,
    PreferenceDataset,
    PromptOnlyCollator,
    PromptOnlyDataset,
    SupervisedCollator,
    SupervisedDataset,
    UnmatchedSupervisedDataset,
    load_raw_dataset,
)
from align_anything_tpu_torch.data.image import (
    ImageProcessor,
    ImageProcessorConfig,
    TI2TPreferenceDataset,
    TI2TPromptOnlyDataset,
    TI2TSupervisedDataset,
)
from align_anything_tpu_torch.data.template_registry import (
    TEMPLATE_REGISTRY,
    get_template_class,
    register_template,
)
from align_anything_tpu_torch.data.tokenizer import HashTokenizer, load_tokenizer

__all__ = [
    'ChatTemplate',
    'ModelFormatter',
    'DEFAULT_BUCKETS',
    'IGNORE_INDEX',
    'DataIterator',
    'PreferenceCollator',
    'PreferenceDataset',
    'PromptOnlyCollator',
    'PromptOnlyDataset',
    'SupervisedCollator',
    'SupervisedDataset',
    'UnmatchedSupervisedDataset',
    'load_raw_dataset',
    'ImageProcessor',
    'ImageProcessorConfig',
    'TI2TPreferenceDataset',
    'TI2TPromptOnlyDataset',
    'TI2TSupervisedDataset',
    'TEMPLATE_REGISTRY',
    'get_template_class',
    'register_template',
    'HashTokenizer',
    'load_tokenizer',
]
