"""The data layer: the port of ``align_anything_tpu/data`` (templates,
chat formatting, tokenizers, datasets, collators, the iterator), with the
image-text, audio and video templates (``multimodal_formatters.py``), the
image datasets (``image.py``: the supervised, preference and prompt-only
sets, AnyRes tiling), the audio ones (``audio.py``) and the video ones
(``video.py``).  The other multimodal processors are not ported yet
(ROADMAP §1 item 12)."""

from align_anything_tpu_torch.data import formatters  # noqa: F401  (registers templates)
from align_anything_tpu_torch.data import multimodal_formatters  # noqa: F401
from align_anything_tpu_torch.data.audio import (
    TA2TPreferenceDataset,
    TA2TPromptOnlyDataset,
    TA2TSupervisedDataset,
    load_waveform,
)
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
    AnyResProcessor,
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
from align_anything_tpu_torch.data.video import (
    TV2TPreferenceDataset,
    TV2TPromptOnlyDataset,
    TV2TSupervisedDataset,
    sample_frames,
)

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
    'AnyResProcessor',
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
    'TV2TPreferenceDataset',
    'TV2TPromptOnlyDataset',
    'TV2TSupervisedDataset',
    'sample_frames',
    'TA2TPreferenceDataset',
    'TA2TPromptOnlyDataset',
    'TA2TSupervisedDataset',
    'load_waveform',
]
