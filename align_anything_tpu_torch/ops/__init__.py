from align_anything_tpu_torch.ops.norms import layer_norm, rms_norm
from align_anything_tpu_torch.ops.rope import apply_rope, rope_table

__all__ = ['layer_norm', 'rms_norm', 'apply_rope', 'rope_table']
