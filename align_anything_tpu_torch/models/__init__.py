from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.config import (
    ModelConfig,
    llama_config,
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
    'ModelConfig',
    'llama_config',
    'tiny_config',
    'KVCache',
    'ModelOutput',
    'forward',
    'init_cache',
    'init_params',
    'transformer',
]
