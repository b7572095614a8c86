from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.config import (
    PRESETS,
    ModelConfig,
    config_from_hf,
    llama_config,
    opt_config,
    qwen2_config,
    tiny_config,
)
from align_anything_tpu_torch.models.transformer import (
    KVCache,
    ModelOutput,
    forward,
    init_cache,
    init_params,
)

__all__ = [
    'PRESETS',
    'ModelConfig',
    'config_from_hf',
    'llama_config',
    'opt_config',
    'qwen2_config',
    'tiny_config',
    'KVCache',
    'ModelOutput',
    'forward',
    'init_cache',
    'init_params',
    'transformer',
]
