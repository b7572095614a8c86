from align_anything_tpu_torch.generation.continuous import (
    ContinuousBatchingEngine,
)
from align_anything_tpu_torch.generation.engine import (
    GenerationConfig,
    GenerationEngine,
    generate,
)
from align_anything_tpu_torch.generation.sampling import sample_token

__all__ = ['ContinuousBatchingEngine', 'GenerationConfig', 'GenerationEngine',
           'generate', 'sample_token']
