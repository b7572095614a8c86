"""LoRA adapters for the decoder, the port of
``align_anything_tpu/models/lora.py`` (reference:
models/pretrained_model.py:196-252 lora_cfgs path, supervised_trainer.py:
441-450 save/merge).

Adapters live in their own small tree, ``{module: {'a': (n, cin, r), 'b':
(n, r, cout)}}``, stacked over the layers like every layer leaf.
``attach_lora`` wraps each target weight of the frozen (possibly quantized)
base in a :class:`LoraWeight`; the decoder's ``_wmm`` then computes
``y = x @ W_base + s * (x @ A) @ B`` without forming ``W + s * A @ B``, so
gradients and optimizer state exist for the adapters alone.
``merge_lora`` bakes the adapters into dense base weights for the
full-model export (merge_and_unload parity).

The JAX ``lora_param_specs`` (sharding) has no counterpart on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.models.quantization import (
    QUANTIZED,
    dequantize_weight,
)
from align_anything_tpu_torch.utils.tools import default_device

# module name -> (param path inside layers, output axes after the E dim)
_TARGETS = {
    'q_proj': ('q', 'heads'),
    'k_proj': ('k', 'kv_heads'),
    'v_proj': ('v', 'kv_heads'),
    'o_proj': ('o', 'o'),
    'up_proj': ('up', 'mlp'),
    'gate_proj': ('gate', 'mlp'),
    'down_proj': ('down', 'down'),
}


def _target_shapes(cfg: ModelConfig, module: str) -> tuple[tuple, tuple]:
    """((n, cin), (n, cout)) of a target module's adapter pair."""
    n, e, h, kh, d, f = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim, cfg.mlp_dim)
    kind = _TARGETS[module][1]
    if kind == 'heads':
        return (n, e), (n, h * d)
    if kind == 'kv_heads':
        return (n, e), (n, kh * d)
    if kind == 'o':
        return (n, h * d), (n, e)
    if kind == 'mlp':
        return (n, e), (n, f)
    if kind == 'down':
        return (n, f), (n, e)
    raise ValueError(module)


def init_lora_params(cfg: ModelConfig, generator: torch.Generator,
                     r: int = 16,
                     target_modules: tuple = ('q_proj', 'v_proj'),
                     device: torch.device | str | None = None) -> dict:
    """A ~ N(0, 1/r) per peft convention, drawn from ``generator`` (which
    must live on ``device``, default the first CUDA device), and B = 0, so
    the adapted model starts equal to its base.  fp32 leaves."""
    device = default_device(device)
    lora: dict = {}
    for module in target_modules:
        (n, cin), (_, cout) = _target_shapes(cfg, module)
        lora[module] = {
            'a': torch.randn((n, cin, r), generator=generator,
                             device=device) / (r ** 0.5),
            'b': torch.zeros((n, r, cout), device=device),
        }
    return lora


@dataclasses.dataclass
class LoraWeight:
    """A weight leaf that carries a frozen base and low-rank adapters.

    ``base``: a tensor or an Int8Weight / Int4Weight (weight-only); ``a``:
    (..., cin, r); ``b``: (..., r, cout), cout the base's flattened output
    dims.  A leading layer dim on all of them is sliced by ``layer``, as
    ``models/transformer.py`` ``layer_params`` does for every layer leaf.
    ``_wmm`` computes the adapters' path at the activation level; with an
    8B int4 base, forming the effective weight would materialize about 14
    GB of bf16 weights a step."""

    base: Any
    a: torch.Tensor
    b: torch.Tensor
    scaling: float = 1.0

    def layer(self, li: int) -> 'LoraWeight':
        """Layer ``li`` of a layer-stacked leaf (views, no copy)."""
        base = (self.base[li] if isinstance(self.base, torch.Tensor)
                else self.base.layer(li))
        return LoraWeight(base, self.a[li], self.b[li], self.scaling)

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        """Dense ``base + s * A @ B`` in ``dtype`` (the JAX
        ``LoraWeight.astype``): for consumers outside ``_wmm``, such as
        export; training through ``transformer.forward`` never calls it."""
        delta = (self.a.float() @ self.b.float()) * self.scaling
        # stacked iff the adapters carry a leading layer dim
        base = dequantize_weight(self.base, torch.float32,
                                 stacked=self.a.ndim == 3)
        return (base + delta.reshape(base.shape)).to(dtype)


def attach_lora(base_params: dict, lora_params: dict, cfg: ModelConfig,
                r: int, alpha: float) -> dict:
    """Wrap each target weight leaf in a :class:`LoraWeight`.

    No weight math happens here: the returned tree shares every base tensor
    with ``base_params`` and references the adapter tensors, so gradients
    reach the adapters through ``_wmm``'s side path, and the base, which
    does not require grad, gets none."""
    if 'layers' not in base_params:
        raise ValueError('LoRA supports the generic decoder param tree only')
    scaling = alpha / r
    params = dict(base_params)
    layers = dict(params['layers'])
    for module, adapter in lora_params.items():
        name = _TARGETS[module][0]
        entry = dict(layers[name])
        entry['w'] = LoraWeight(base=entry['w'], a=adapter['a'],
                                b=adapter['b'], scaling=scaling)
        layers[name] = entry
    params['layers'] = layers
    return params


def merge_lora(base_params: dict, lora_params: dict, cfg: ModelConfig,
               r: int, alpha: float) -> dict:
    """Base + scaled adapter deltas, each target leaf a dense tensor (a
    quantized base is dequantized for the merge, in fp32).  The other
    leaves are the base's own."""
    scaling = alpha / r
    params = dict(base_params)
    layers = dict(params['layers'])
    for module, adapter in lora_params.items():
        name = _TARGETS[module][0]
        w = layers[name]['w']
        delta = (torch.einsum('ncr,nro->nco', adapter['a'], adapter['b'])
                 * scaling)
        if isinstance(w, QUANTIZED):
            w = dequantize_weight(w, delta.dtype, stacked=True)
        layers[name] = dict(layers[name],
                            w=w + delta.reshape(w.shape).to(w.dtype))
    params['layers'] = layers
    return params
