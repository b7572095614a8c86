from align_anything_tpu_torch.utils.tools import (
    bucket_length,
    default_device,
    gather_log_probabilities,
    left_padding,
    param_leaves,
    seed_everything,
    tree_map,
)

__all__ = ['bucket_length', 'default_device', 'gather_log_probabilities',
           'left_padding', 'param_leaves', 'seed_everything', 'tree_map']
