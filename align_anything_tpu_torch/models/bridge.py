"""JAX param tree -> the port's tensors.

Takes the JAX package's parameter tree as nested dicts of numpy arrays (an
``Int4Weight`` leaf flattened to ``{'values', 'scales', 'compute'}``) and
returns the same tree with ``torch.Tensor`` leaves and ``Int4Weight``
objects.  Layouts are kept as they are: layer leaves stacked on a leading
``num_layers`` axis, einsum weight layouts (E, H, D), (H, D, E), (E, F), and
the int4 packing byte for byte.  ``trainable_from_jax_tree`` makes a
trainable fp32 tree and its frozen reference copy for the train step.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.models.quantization import Int4Weight
from align_anything_tpu_torch.utils.tools import default_device, tree_map

_INT4_KEYS = {'values', 'scales', 'compute'}


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
        if set(tree) == _INT4_KEYS:
            return Int4Weight(values=tensor_from_numpy(tree['values'], device),
                              scales=tensor_from_numpy(tree['scales'], device),
                              compute=bool(tree['compute']))
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
