from align_anything_tpu_torch.utils.tools import (
    batch_retokenize,
    bucket_length,
    default_device,
    first_true_index,
    gather_log_probabilities,
    is_same_tokenizer,
    last_true_index,
    left_padding,
    masked_mean,
    masked_mean_global,
    param_leaves,
    right_padding,
    seed_everything,
    split_prompt_response,
    tree_map,
)

__all__ = ['batch_retokenize', 'bucket_length', 'default_device',
           'first_true_index', 'gather_log_probabilities',
           'is_same_tokenizer', 'last_true_index', 'left_padding',
           'masked_mean', 'masked_mean_global', 'param_leaves',
           'right_padding', 'seed_everything', 'split_prompt_response',
           'tree_map']
