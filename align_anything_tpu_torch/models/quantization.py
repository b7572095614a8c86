"""Weight quantization: blockwise int4 (the bnb ``load_in_4bit`` analog) and
per-channel int8 (``load_in_8bit``).

Port of ``align_anything_tpu/models/quantization.py``; the storage layouts
are the JAX package's, byte for byte, so a quantized tree converts either
way through ``models/bridge.py``.  Int4:

- values: int8, two int4 values per byte, SPLIT-HALF within each group of
  ``gs`` elements along the contraction axis (element ``r`` in the low
  nibble, ``r + gs/2`` in the high), stored as ``(..., G, gs/2, ...)``;
- scales: fp32, ``(..., G, 1, ...)``, one per group and output column.

Int8: int8 values of the weight's shape and fp32 scales that keep the
contraction axes as size-1 dims (symmetric, per output channel).

A layer-stacked leaf carries a leading ``num_layers`` dim on both tensors;
``values[li]`` is a contiguous view, so no layer-indexing wrapper is needed.
The frozen base of QLoRA (``trainers/base.py`` ``init_peft``) is such a tree,
read weight-only: the decoder dequantizes a layer's leaf when it uses it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class Int8Weight:
    """int8 values + fp32 per-channel scales.  ``compute=True`` routes the
    decoder's matmuls through the int8 x int8 -> int32 product with
    per-row activation scales (``models/transformer.py`` ``_wmm``); else
    the weight is dequantized where it is used."""

    values: torch.Tensor      # int8, the weight's shape
    scales: torch.Tensor      # fp32, keepdims over the contraction axes
    compute: bool = False

    def layer(self, li: int) -> 'Int8Weight':
        """Layer ``li`` of a layer-stacked leaf (views, no copy)."""
        return Int8Weight(self.values[li], self.scales[li], self.compute)

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        """Dense weight in ``dtype`` (the JAX ``Int8Weight.astype``)."""
        return (self.values.to(torch.float32) * self.scales).to(dtype)


@dataclasses.dataclass
class Int4Weight:
    """int4 values + fp32 group scales.  ``compute=True`` routes eligible
    matmuls through the int4 kernel (``ops/int4_matmul.py``), which unpacks
    the nibbles on the fly instead of materializing a dense weight."""

    values: torch.Tensor      # int8 packed, (..., G, gs/2, ...)
    scales: torch.Tensor      # fp32, (..., G, 1, ...)
    compute: bool = False

    def layer(self, li: int) -> 'Int4Weight':
        """Layer ``li`` of a layer-stacked leaf (views, no copy)."""
        return Int4Weight(self.values[li], self.scales[li], self.compute)

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        """Dense weight of a layer-sliced leaf: (G*gs, ...) in ``dtype``
        (the JAX ``Int4Weight.astype``)."""
        low, high = unpack_int4(self.values)
        x = torch.cat([low, high], dim=1).to(torch.float32) * self.scales
        return x.reshape((-1,) + tuple(x.shape[2:])).to(dtype)


def unpack_int4(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-extended (low, high) nibbles of packed int8 ``values``, int32."""
    v = values.to(torch.int32)
    return ((v & 15) ^ 8) - 8, v >> 4


def quantize_int8(w: torch.Tensor, axes: tuple[int, ...],
                  compute: bool = False) -> Int8Weight:
    """Symmetric per-channel int8 over ``axes`` (the contraction dims of the
    matmul that consumes ``w``)."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=axes, keepdim=True)
    scales = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scales), -127, 127).to(torch.int8)
    return Int8Weight(values=q, scales=scales, compute=compute)


def quantize_int4(w: torch.Tensor, axes: tuple[int, ...],
                  group_size: int = 64, compute: bool = False) -> Int4Weight:
    """Blockwise symmetric int4 along the first contraction axis, which must
    be 0 (unstacked, e.g. lm_head) or 1 (layer-stacked)."""
    axis = axes[0]
    if axis > 1:
        raise ValueError('int4 grouping supports contraction axis 0/1 '
                         f'only (got {axis}); leave this weight fp')
    wf = w.to(torch.float32)
    dim = wf.shape[axis]
    gs = group_size if dim % group_size == 0 else dim
    if gs % 2:
        raise ValueError(f'int4 group size must be even (got {gs})')
    shape = wf.shape[:axis] + (dim // gs, gs) + wf.shape[axis + 1:]
    grouped = wf.reshape(shape)
    amax = grouped.abs().amax(dim=axis + 1, keepdim=True)
    scales = amax.clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(grouped / scales), -7, 7).to(torch.int32)
    half = gs // 2
    low = q.narrow(axis + 1, 0, half)
    high = q.narrow(axis + 1, half, half)
    # |high| <= 7, so (high << 4) | low-nibble fits int8 exactly
    packed = ((low & 0x0F) | (high << 4)).to(torch.int8)
    return Int4Weight(values=packed, scales=scales, compute=compute)


def _fuse_int4(leaves: list[Int4Weight]) -> Int4Weight:
    """Concatenate layer-stacked Int4Weights with the same contraction
    grouping along the output dim; out dims flatten to 1-D."""
    def flat(a: torch.Tensor) -> torch.Tensor:  # (n, G, gs/2, *out) -> (n, G, gs/2, prod)
        return a.reshape(tuple(a.shape[:3]) + (-1,))
    return Int4Weight(
        values=torch.cat([flat(w.values) for w in leaves], dim=-1),
        scales=torch.cat([flat(w.scales) for w in leaves], dim=-1),
        compute=leaves[0].compute)


# layer-weight key -> contraction axes in the layer-stacked layout
# (q/k/v (n,e,h,d) contract e; o (n,h,d,e) contracts h,d; up/gate (n,e,f)
# contract e; down (n,f,e) contracts f; router (n,e,x) contracts e)
_LAYER_AXES = {
    'q': (1,), 'k': (1,), 'v': (1,),
    'o': (1, 2),
    'up': (1,), 'gate': (1,), 'down': (1,),
    'router': (1,),
}
# MoE experts add an (n, X, ...) expert dim: up/gate (n,x,e,f) contract e;
# down (n,x,f,e) contracts f
_MOE_AXES = {'up': (2,), 'gate': (2,), 'down': (2,)}


def quantize_decoder_int8(params: dict, num_experts: int = 0,
                          compute: bool = False) -> dict:
    """int8-quantize a decoder param tree's matmul weights and ``lm_head``
    (embedding, norms and biases stay fp, the split bnb makes); an MoE
    tree's experts on their contraction axis 2 and its router too.
    ``compute=True`` marks them for the int8 product in the decoder (the
    MoE layer dequantizes its experts and router where it reads them, as
    JAX's does)."""
    out: dict[str, Any] = dict(params)
    layers = dict(params['layers'])
    for name, axes in _LAYER_AXES.items():
        if name not in layers:
            continue
        if num_experts and name in _MOE_AXES:
            axes = _MOE_AXES[name]
        sub = dict(layers[name])
        sub['w'] = quantize_int8(sub['w'], axes, compute=compute)
        layers[name] = sub
    out['layers'] = layers
    if 'lm_head' in params:
        out['lm_head'] = quantize_int8(params['lm_head'], (0,),
                                       compute=compute)
    return out


def quantize_decoder_int4(params: dict, num_experts: int = 0,
                          group_size: int = 64, compute: bool = False,
                          fuse: bool = False) -> dict:
    """int4-quantize a decoder param tree's matmul weights (embedding, norms
    and biases stay fp).  ``compute=True``: eligible matmuls run the int4
    kernel ('o' dequantizes: its groups run over heads only, not over the
    flattened contraction).  ``fuse=True``: merge q/k/v into one ``qkv``
    leaf and gate/up into ``gate_up`` (bias-free models only), one kernel
    launch instead of three.

    An MoE tree (``num_experts``) keeps its experts fp (the grouped layout
    takes contraction axis 0 or 1 only; theirs is 2) and quantizes its
    router, as JAX's does.  ``fuse=True`` there raises: JAX then tries to
    fuse the fp gate and up leaves and fails (``AttributeError``, ROADMAP
    R31)."""
    if num_experts and fuse:
        raise ValueError('quantize_decoder_int4(fuse=True) on an MoE tree: '
                         'its experts stay fp and do not fuse; the JAX '
                         'package fails here too (ROADMAP R31)')
    out: dict[str, Any] = dict(params)
    layers = dict(params['layers'])
    for name, axes in _LAYER_AXES.items():
        if name not in layers:
            continue
        if num_experts and name in _MOE_AXES:
            continue
        sub = dict(layers[name])
        sub['w'] = quantize_int4(sub['w'], axes, group_size=group_size,
                                 compute=compute)
        layers[name] = sub
    if fuse:
        if all(k in layers and 'b' not in layers[k] for k in ('q', 'k', 'v')):
            layers['qkv'] = {'w': _fuse_int4([layers.pop(k)['w']
                                              for k in ('q', 'k', 'v')])}
        if all(k in layers and 'b' not in layers[k] for k in ('gate', 'up')):
            layers['gate_up'] = {'w': _fuse_int4(
                [layers.pop(k)['w'] for k in ('gate', 'up')])}
    out['layers'] = layers
    if 'lm_head' in params:
        out['lm_head'] = quantize_int4(params['lm_head'], (0,),
                                       group_size=group_size, compute=compute)
    return out


QUANTIZED = (Int4Weight, Int8Weight)


def dequantize_weight(w, dtype: torch.dtype, stacked: bool = True
                      ) -> torch.Tensor:
    """Dense ``dtype`` view of a weight leaf: a tensor, a quantized leaf or
    a ``models/lora.py`` ``LoraWeight`` (whose own ``dequantize`` calls
    back here).

    An Int4Weight's grouped layout is defined on the LAYER-SLICED leaf
    (dims 0-1 = groups, gs/2), so a layer-stacked one (``stacked``)
    dequantizes layer by layer; int8 and fp leaves keep their shape either
    way."""
    if isinstance(w, torch.Tensor):
        return w.to(dtype)
    if stacked and isinstance(w, Int4Weight):
        return torch.stack([w.layer(li).dequantize(dtype)
                            for li in range(w.values.shape[0])])
    return w.dequantize(dtype)


def dequantize_decoder(params: dict, dtype: torch.dtype | None = None
                       ) -> dict:
    """Dense copy of every quantized leaf of a decoder tree (layer weights
    stacked, ``lm_head`` not): export-time only, for the HF writers, which
    take plain tensors.  ``dtype`` defaults to the embedding's."""
    dtype = dtype or params['embedding'].dtype
    out: dict[str, Any] = dict(params)
    layers = dict(params['layers'])
    for name, sub in layers.items():
        if isinstance(sub.get('w'), QUANTIZED):
            layers[name] = dict(sub, w=dequantize_weight(sub['w'], dtype,
                                                         stacked=True))
    out['layers'] = layers
    if isinstance(out.get('lm_head'), QUANTIZED):
        out['lm_head'] = dequantize_weight(out['lm_head'], dtype,
                                           stacked=False)
    return out


def weight_tensors(leaf) -> list[torch.Tensor]:
    """The tensors a weight leaf holds: itself, a quantized leaf's values and
    scales, or a LoRA leaf's base tensors and adapters."""
    if isinstance(leaf, torch.Tensor):
        return [leaf]
    if isinstance(leaf, QUANTIZED):
        return [leaf.values, leaf.scales]
    return weight_tensors(leaf.base) + [leaf.a, leaf.b]


def quantized_bytes(params: dict) -> int:
    """Total parameter bytes of a tree after quantization (for memory
    accounting)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    return sum(t.numel() * t.element_size() for t in weight_tensors(params))
