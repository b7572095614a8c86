"""align-anything-tpu-torch: the PyTorch and CUDA port of align_anything_tpu
for NVIDIA Hopper (H100).

The JAX package ``align_anything_tpu`` stays the reference; each module here
sits at the same path as its JAX counterpart and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports ``torch`` and
never ``jax``.  Every Pallas TPU kernel on a ported path becomes a kernel
written by hand for Hopper under ``csrc/``, built by nvcc at first use.

Ported so far: the int4 serving path (``generation/continuous.py`` over
``models/transformer.py`` with the int4 matmul kernel) and the text-to-text
trainers (``trainers/text_to_text/{sft,dpo,orpo,simpo}.py`` on the trainer
base, ``trainers/base.py``, over the decoder's training path with the
flash-attention kernel), with their configs, data layer, HF checkpoint
loader and checkpoints.  Entry points run on the first CUDA device unless
given ``device='cpu'``.
"""

__version__ = '0.1.0'
