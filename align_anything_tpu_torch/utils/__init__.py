from align_anything_tpu_torch.utils.tools import bucket_length, left_padding

__all__ = ['bucket_length', 'left_padding']
