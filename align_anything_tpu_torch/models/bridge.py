"""JAX param tree -> the port's tensors.

Takes the JAX package's parameter tree as nested dicts of numpy arrays and
returns the same tree with ``torch.Tensor`` leaves and the port's leaf
objects:

- ``Int4Weight`` flattened to ``{'values', 'scales', 'compute'}``;
- ``Int8Weight`` flattened to ``{'values', 'scales', 'compute', 'kind'}``
  with ``kind`` 'int8' (an int4 leaf may carry ``kind`` 'int4');
- ``LoraWeight`` flattened to ``{'base', 'a', 'b', 'scaling'}``, ``base``
  itself a flattened leaf.

Layouts are kept as they are: layer leaves stacked on a leading
``num_layers`` axis, einsum weight layouts (E, H, D), (H, D, E), (E, F), and
the quantized packings byte for byte.  ``trainable_from_jax_tree`` makes a
trainable fp32 tree and its frozen reference copy for the train step;
``lora_from_jax_tree`` the trainable adapters of ``models/lora.py``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.models.lora import LoraWeight
from align_anything_tpu_torch.models.quantization import Int4Weight, Int8Weight
from align_anything_tpu_torch.utils.tools import default_device, tree_map

_QUANT_KEYS = {'values', 'scales', 'compute'}
_LORA_KEYS = {'base', 'a', 'b', 'scaling'}


def tensor_from_numpy(a: np.ndarray, device: torch.device | str | None = None
                      ) -> torch.Tensor:
    """numpy array (bfloat16 included, via its 16-bit pattern) -> tensor on
    ``device`` (default: the first CUDA device)."""
    a = np.asarray(a).copy()          # own, writable, C-contiguous
    if a.dtype.name == 'bfloat16':
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(default_device(device))


def from_jax_tree(tree: Any, device: torch.device | str | None = None) -> Any:
    """Convert a nested dict of numpy arrays (see the module docstring)."""
    if isinstance(tree, dict):
        keys = set(tree)
        if keys in (_QUANT_KEYS, _QUANT_KEYS | {'kind'}):
            cls = Int8Weight if tree.get('kind') == 'int8' else Int4Weight
            return cls(values=tensor_from_numpy(tree['values'], device),
                       scales=tensor_from_numpy(tree['scales'], device),
                       compute=bool(tree['compute']))
        if keys == _LORA_KEYS:
            return LoraWeight(base=from_jax_tree(tree['base'], device),
                              a=tensor_from_numpy(tree['a'], device),
                              b=tensor_from_numpy(tree['b'], device),
                              scaling=float(tree['scaling']))
        return {k: from_jax_tree(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def trainable_from_jax_tree(tree: Any,
                            device: torch.device | str | None = None
                            ) -> tuple[Any, Any]:
    """A JAX fp param tree (numpy) -> (params, ref_params): fp32 leaves
    with ``requires_grad`` on ``device`` (default: the first CUDA device),
    and the frozen reference as a detached copy of them."""
    params = tree_map(lambda a: tensor_from_numpy(a, device).to(
        torch.float32).requires_grad_(True), tree)
    return params, tree_map(lambda t: t.detach().clone(), params)


def lora_from_jax_tree(tree: dict, device: torch.device | str | None = None
                       ) -> dict:
    """A JAX adapter tree (``{module: {'a', 'b'}}``, numpy) -> fp32 leaves
    with ``requires_grad`` on ``device`` (default: the first CUDA device),
    ready to be a train state's params."""
    return tree_map(lambda a: tensor_from_numpy(a, device).to(
        torch.float32).requires_grad_(True), tree)
