"""Decoder transformer: plain functions over a param tree of tensors.

Port of ``align_anything_tpu/models/transformer.py`` with the same param
tree (see ``models/bridge.py``): layer leaves stacked on a leading
``num_layers`` axis, einsum weight layouts (E, H, D), (H, D, E), (E, F),
compute in ``config.compute_dtype`` with fp32 softmax, norms and logits.

``forward`` covers four paths:
- no cache (training and scoring): ``ops/attention.causal_attention`` over
  the inputs (the flash-attention kernel on the card), each layer under
  ``torch.utils.checkpoint`` with the config's remat policy when gradients
  are being recorded;
- prefill: a cache and ``cache_offset == 0``; K/V are written at [0, L)
  and attention runs over the fresh K/V;
- a multi-token write at a static offset ``cache_offset > 0`` (the prefix
  cache's tail): K/V are written at [off, off + L) and attention runs over
  the whole cache with a slot-space causal mask, the query of row i at
  slot off + i;
- decode: one token per row written at ``cache_offset``, a Python int, a
  scalar tensor, or a (B,) tensor of per-row offsets (the continuous
  engine's per-slot lengths); attention over the cache with a slot mask.

A cache is any object with ``max_len`` and ``layer(li)``.  ``KVCache``'s
layers are (K, V) views; a layer object with an ``attend(q, k, v,
window)`` method writes and attends itself (the continuous engine's page
pool, ``generation/continuous.py`` ``PagedCache``).

The cache is a plain (L, B, KH, S, D) tensor pair, updated IN PLACE (one
``index_put_`` per layer and step), unlike the JAX package's functional
update.  The layer loop is a Python loop.  Prefill and decode attend
with ``_masked_attention``, as the JAX package does.

Gemma3's interleaved attention (``layer_is_sliding``): a sliding layer
takes the rope table of ``rope_local_theta`` and sees keys fewer than
``sliding_window`` positions back, through the kernel's window in training
(``ops/attention.windowed_causal_attention``) and through the masks of the
cache paths.

m-rope (``mrope_section``, the Qwen2-VL trunk): (3, B, L) positions rotate
q and k with ``ops/rope.apply_mrope``; (B, L) positions take plain rope, as
the decode steps do.

Mixture of experts (``num_experts``, Qwen3-MoE-class): a top-k router
replaces the MLP (``_moe_mlp``), with the dense dispatch (every expert on
every token, the top-k weights select) or, under ``moe_impl='sparse'``, the
sparse one (``_moe_sparse``: tokens sorted by expert, one product per
expert over its rows, ``ragged_dot``).  Every path returns the switch-style
balancing loss of each layer, and ``ModelOutput.aux_loss`` is its mean over
layers, taken over every token, pads included, as in JAX (ROADMAP R32).
The sparse dispatch reads the per-expert row counts on the host once a
layer (one ``bincount`` and one ``.tolist()``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.models.lora import LoraWeight
from align_anything_tpu_torch.models.quantization import (
    QUANTIZED,
    Int4Weight,
    Int8Weight,
    dequantize_weight,
)
from align_anything_tpu_torch.ops.attention import (
    causal_attention,
    windowed_causal_attention,
)
# the module, not its function: ops/int4_matmul.py imports models/, so
# either may be imported first
from align_anything_tpu_torch.ops import int4_matmul as k2
from align_anything_tpu_torch.ops.norms import layer_norm, rms_norm
from align_anything_tpu_torch.ops.rope import apply_mrope, apply_rope, rope_table
from align_anything_tpu_torch.utils.tools import default_device

NEG_INF = -2.3819763e38  # close to bf16 -inf without overflow
# 'none' and the nine policies of the JAX ``_remat_policy``
REMAT_POLICIES = ('none', 'full', 'dots_saveable', 'dots_nb', 'dots_flash',
                  'save_flash', 'save_attn', 'dots_saveable_flash',
                  'dots_mlp_lean', 'dots_mlp_lean_flash')


def torch_dtype(name: str) -> torch.dtype:
    """'float32' / 'bfloat16' / ... -> the torch dtype."""
    return getattr(torch, name)


def check_supported(c: ModelConfig) -> None:
    """Raise for the config options the port does not run yet."""
    missing = []
    if c.pp_stages > 1:
        missing.append('pipeline stages (pp_stages)')
    if c.remat not in REMAT_POLICIES:
        missing.append(f'remat policy {c.remat!r}')
    if missing:
        raise NotImplementedError('not ported yet: ' + ', '.join(missing))


@dataclasses.dataclass
class KVCache:
    """Per-model KV cache: (num_layers, B, KH, max_len, D) each for K and V."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def layer(self, li: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer ``li``'s (K, V) views (B, KH, max_len, D)."""
        return self.k[li], self.v[li]


@dataclasses.dataclass
class ModelOutput:
    logits: torch.Tensor                 # (B, L, V) float32
    last_hidden_state: torch.Tensor      # (B, L, E)
    cache: KVCache | None = None
    aux_loss: torch.Tensor | None = None  # MoE router balancing loss


def init_cache(config: ModelConfig, batch_size: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str | None = None) -> KVCache:
    """Zeroed cache on ``device`` (default: the first CUDA device)."""
    device = default_device(device)
    shape = (config.num_layers, batch_size, config.num_kv_heads, max_len,
             config.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_params(c: ModelConfig, n: int | None, dim: int,
                 device) -> dict:
    shape = (dim,) if n is None else (n, dim)
    p = {'w': torch.ones(shape, device=device)}
    if c.norm == 'layernorm':
        p['b'] = torch.zeros(shape, device=device)
    return p


def init_params(config: ModelConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random fp32 init with the JAX package's tree and shapes (the numbers
    differ: convert a JAX tree with ``models/bridge.py`` for parity), on
    ``device`` (default: the first CUDA device; ``generator`` must live
    there too)."""
    device = default_device(device)
    c = config
    check_supported(c)
    n, e, h, kh, d, f = (c.num_layers, c.hidden_size, c.num_heads,
                         c.num_kv_heads, c.head_dim, c.mlp_dim)

    def dense(*shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                * (1.0 / math.sqrt(fan_in)))

    layers: dict[str, Any] = {
        'attn_norm': _norm_params(c, n, e, device),
        'q': {'w': dense(n, e, h, d, fan_in=e)},
        'k': {'w': dense(n, e, kh, d, fan_in=e)},
        'v': {'w': dense(n, e, kh, d, fan_in=e)},
        'o': {'w': dense(n, h, d, e, fan_in=h * d)},
        'mlp_norm': _norm_params(c, n, e, device),
    }
    if c.num_experts:
        x_ = c.num_experts
        layers['router'] = {'w': dense(n, e, x_, fan_in=e)}
        layers['up'] = {'w': dense(n, x_, e, f, fan_in=e)}
        layers['gate'] = {'w': dense(n, x_, e, f, fan_in=e)}
        layers['down'] = {'w': dense(n, x_, f, e, fan_in=f)}
    else:
        layers['up'] = {'w': dense(n, e, f, fan_in=e)}
        layers['down'] = {'w': dense(n, f, e, fan_in=f)}
        if c.gated_mlp:
            layers['gate'] = {'w': dense(n, e, f, fan_in=e)}
    if c.qkv_bias:
        layers['q']['b'] = torch.zeros((n, h, d), device=device)
        layers['k']['b'] = torch.zeros((n, kh, d), device=device)
        layers['v']['b'] = torch.zeros((n, kh, d), device=device)
    if c.sandwich_norms:
        layers['post_attn_norm'] = _norm_params(c, n, e, device)
        layers['post_mlp_norm'] = _norm_params(c, n, e, device)
    if c.qk_norm == 'rmsnorm':
        layers['q_norm'] = {'w': torch.ones((n, d), device=device)}
        layers['k_norm'] = {'w': torch.ones((n, d), device=device)}
    elif c.qk_norm == 'layernorm_ph':
        layers['q_norm'] = {'w': torch.ones((n, h, d), device=device),
                            'b': torch.zeros((n, h, d), device=device)}
        layers['k_norm'] = {'w': torch.ones((n, kh, d), device=device),
                            'b': torch.zeros((n, kh, d), device=device)}
    if c.attn_out_bias:
        layers['o']['b'] = torch.zeros((n, e), device=device)
    if c.mlp_bias:
        layers['up']['b'] = torch.zeros((n, f), device=device)
        layers['down']['b'] = torch.zeros((n, e), device=device)

    params: dict[str, Any] = {
        'embedding': torch.randn((c.vocab_size, e), generator=generator,
                                 device=device) * 0.02,
        'layers': layers,
        'final_norm': _norm_params(c, None, e, device),
    }
    if c.positional == 'learned':
        params['pos_embedding'] = torch.randn(
            (c.max_position_embeddings + c.learned_pos_offset, e),
            generator=generator, device=device) * 0.02
    if not c.tie_word_embeddings:
        params['lm_head'] = dense(e, c.vocab_size, fan_in=e)
    return params


def layer_params(layers: dict, li: int) -> dict:
    """Layer ``li`` of the stacked layer tree (views, no copies)."""
    return {name: {k: (leaf[li] if isinstance(leaf, torch.Tensor)
                       else leaf.layer(li))
                   for k, leaf in sub.items()}
            for name, sub in layers.items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

class _QuantizedMatmul(torch.autograd.Function):
    """``einsum(eq, x, w)`` over a quantized weight leaf, dequantized in
    ``dtype`` in the forward and again in the backward: autograd keeps the
    packed leaf, not the dense copy that ``torch.einsum`` would save for the
    gradient of ``x`` (a layer's worth at every layer of a pass without
    remat).  The weight gets no gradient."""

    @staticmethod
    def forward(ctx, x, leaf, eq, dtype, shape):
        ctx.leaf, ctx.eq, ctx.dtype, ctx.shape = leaf, eq, dtype, shape
        return torch.einsum(eq, x, _QuantizedMatmul.dense(leaf, dtype, shape))

    @staticmethod
    def backward(ctx, grad):
        ins, out = ctx.eq.split('->')
        x_sub, w_sub = ins.split(',')
        w = _QuantizedMatmul.dense(ctx.leaf, ctx.dtype, ctx.shape)
        gx = torch.einsum(f'{out},{w_sub}->{x_sub}', grad, w)
        return gx, None, None, None, None

    @staticmethod
    def dense(leaf, dtype: torch.dtype, shape: tuple | None) -> torch.Tensor:
        w = leaf.dequantize(dtype)
        return w if shape is None else w.reshape(shape)


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x int8 (K, N) -> int32 (M, N), by
    ``torch._int_mm``.  Its CUDA route needs M > 16 and K, N multiples of
    8, so the operands are zero-padded to at least 32 rows and to K, N
    multiples of 8 (zeros add nothing to any sum) and the product cut
    back."""
    m, k = xq.shape
    n = wq.shape[1]
    mp, kp, np_ = max(m, 32), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        xq = F.pad(xq, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        wq = F.pad(wq, (0, np_ - n, 0, kp - k))
    return torch._int_mm(xq.contiguous(), wq.contiguous())[:m, :n]


def _int8_compute(x: torch.Tensor, w_leaf: Int8Weight, dtype: torch.dtype,
                  n_contract: int) -> torch.Tensor:
    """The int8-COMPUTE matmul (AQT-style, JAX ``_wmm``): activations
    quantized per row over the contracted axes, the int8 x int8 -> int32
    product, then both scales folded into the output."""
    batch_nd = x.ndim - n_contract
    axes = tuple(range(batch_nd, x.ndim))
    xf = x.to(torch.float32)
    a_scale = xf.abs().amax(dim=axes, keepdim=True).clamp_min(1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / a_scale), -127, 127).to(torch.int8)
    lead = tuple(x.shape[:batch_nd])
    out_dims = tuple(w_leaf.values.shape[n_contract:])
    acc = int8_product(xq.reshape(math.prod(lead), -1),
                       w_leaf.values.reshape(-1, math.prod(out_dims)))
    out = acc.reshape(lead + out_dims).to(torch.float32)
    a = a_scale.reshape(lead + (1,) * len(out_dims))
    # the scales keep the contracted axes as size-1 dims: dropping them
    # leaves the output dims, which broadcast against the product
    w_scale = w_leaf.scales.reshape(w_leaf.scales.shape[n_contract:])
    return (out * a * w_scale).to(dtype)


def _wmm(eq: str, x: torch.Tensor, w_leaf, dtype: torch.dtype,
         n_contract: int = 1) -> torch.Tensor:
    """Weight matmul that dispatches on the leaf type (JAX ``_wmm``).

    fp leaves: the einsum in ``dtype``.  ``LoraWeight``: the base's matmul
    plus ``s * (x @ A) @ B`` at the activation level.
    ``Int4Weight(compute=True)``: the int4 kernel (``ops/int4_matmul.py``)
    where it applies.  ``Int8Weight(compute=True)``: the int8 product.
    Other quantized leaves dequantize on read (``_QuantizedMatmul``)."""
    batch_nd = x.ndim - n_contract
    if isinstance(w_leaf, LoraWeight):
        out = _wmm(eq, x, w_leaf.base, dtype, n_contract=n_contract)
        xf = x if n_contract == 1 else x.reshape(
            tuple(x.shape[:batch_nd]) + (-1,))
        side = (xf.to(dtype) @ w_leaf.a.to(dtype)) @ w_leaf.b.to(dtype)
        return out + (w_leaf.scaling * side).reshape(out.shape).to(out.dtype)
    if isinstance(w_leaf, Int4Weight) and w_leaf.compute:
        xf = x if n_contract == 1 else x.reshape(
            tuple(x.shape[:batch_nd]) + (-1,))
        out = k2.int4_matmul(xf, w_leaf, dtype=dtype)
        if out is not None:
            return out
    if isinstance(w_leaf, Int8Weight) and w_leaf.compute:
        return _int8_compute(x, w_leaf, dtype, n_contract)
    if isinstance(w_leaf, QUANTIZED):
        # an int4 leaf grouped over part of the contraction, or stored
        # flattened, dequantizes to (K, ...): restore the einsum's shape
        shape = (tuple(x.shape[batch_nd:]) + (-1,) if n_contract == 2
                 else None)
        return _QuantizedMatmul.apply(x.to(dtype), w_leaf, eq, dtype, shape)
    return torch.einsum(eq, x.to(dtype), w_leaf.to(dtype))


def _head_logits(c: ModelConfig, params: dict, x: torch.Tensor
                 ) -> torch.Tensor:
    """x (B, L, E) post-final-norm -> fp32 logits (B, L, V) (softcap
    applied; the caller handles true_vocab_size)."""
    head = (params['embedding'].T if c.tie_word_embeddings
            else params['lm_head'])
    if getattr(head, 'compute', False):  # int8/int4-COMPUTE quantized head
        logits = _wmm('ble,ev->blv', x, head, torch.float32)
    else:
        dtype = torch_dtype(c.compute_dtype)
        w = dequantize_weight(head, dtype, stacked=False)
        # bf16 x bf16 products are exact in fp32: the fp32 einsum is the
        # JAX einsum with preferred_element_type=float32
        logits = torch.einsum('ble,ev->blv', x.to(dtype).float(), w.float())
    if c.final_logit_softcap:
        logits = torch.tanh(logits / c.final_logit_softcap) \
            * c.final_logit_softcap
    return logits


def _norm(config: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if config.norm == 'layernorm':
        return layer_norm(x, p['w'], p.get('b'), eps=config.norm_eps)
    w = p['w'] + 1.0 if config.norm_plus_one else p['w']  # Gemma (1+w)
    return rms_norm(x, w, eps=config.norm_eps)


def _qk_norm(c: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-head q/k normalization before RoPE.  x: (B, L, H, D)."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    if c.qk_norm == 'rmsnorm':
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                              + c.qk_norm_eps)
        w = p['w'].to(torch.float32)
        if c.norm_plus_one:
            w = w + 1.0
        return (xf * w).to(dtype)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + c.qk_norm_eps)
    xf = xf * p['w'].to(torch.float32) + p['b'].to(torch.float32)
    return xf.to(dtype)


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Attention with an explicit (B|1, 1, L, S) boolean mask.

    q: (B, L, H, D); k/v in cache layout (B, KH, S, D).  GQA is computed
    grouped (query heads reshaped to (KH, G)), so K/V heads are never
    repeated."""
    b, l, h, d = q.shape
    kh = k.shape[1]
    g = h // kh
    qg = q.reshape(b, l, kh, g, d)
    logits = torch.einsum('blkgd,bksd->bkgls', qg.float(), k.float()) \
        * (d ** -0.5)
    logits = logits.masked_fill(~mask[:, None], NEG_INF)  # (B,KH,G,L,S)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum('bkgls,bksd->bkgld', probs, v.to(q.dtype))
    return out.permute(0, 3, 1, 2, 4).reshape(b, l, h, d)


_ACT = {'silu': F.silu, 'gelu': lambda t: F.gelu(t, approximate='tanh'),
        'relu': F.relu}


def _decoder_layer(c: ModelConfig, lp: dict, x: torch.Tensor,
                   positions: torch.Tensor, sin: torch.Tensor,
                   cos: torch.Tensor, attention_mask: torch.Tensor | None,
                   layer_cache: tuple[torch.Tensor, torch.Tensor] | None,
                   cache_offset, layer_flag: int = 0,
                   rope_alt: tuple[torch.Tensor, torch.Tensor] | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One pre-norm decoder block.  x: (B, L, E).  ``layer_cache`` is this
    layer's (K, V) view (B, KH, S, D), written in place.  Returns the new x
    and the layer's MoE balancing loss (None for a dense MLP).

    ``layer_flag`` / ``rope_alt``: Gemma3-style interleaved attention, as in
    JAX: 1 marks a sliding-window layer, which takes the local rope table
    ``rope_alt`` and masks keys ``c.sliding_window`` or more positions
    behind the query.  The flag is a Python int, so no branch is traced."""
    dtype = x.dtype
    b, l = x.shape[:2]
    sliding = c.sliding_window is not None and layer_flag > 0
    if rope_alt is not None and layer_flag > 0:
        sin, cos = rope_alt
    h = _norm(c, lp['attn_norm'], x)
    if 'qkv' in lp:
        # fused q+k+v leaf (quantize_decoder_int4(fuse=True)): one call
        zq = c.num_heads * c.head_dim
        zk = c.num_kv_heads * c.head_dim
        qkv = _wmm('ble,ez->blz', h, lp['qkv']['w'], dtype)
        q = qkv[..., :zq].reshape(b, l, c.num_heads, c.head_dim)
        k = qkv[..., zq:zq + zk].reshape(b, l, c.num_kv_heads, c.head_dim)
        v = qkv[..., zq + zk:].reshape(b, l, c.num_kv_heads, c.head_dim)
    else:
        q = _wmm('ble,ehd->blhd', h, lp['q']['w'], dtype)
        k = _wmm('ble,ehd->blhd', h, lp['k']['w'], dtype)
        v = _wmm('ble,ehd->blhd', h, lp['v']['w'], dtype)
    if 'q' in lp and 'b' in lp['q']:
        q = q + lp['q']['b'].to(dtype)
        k = k + lp['k']['b'].to(dtype)
        v = v + lp['v']['b'].to(dtype)
    if c.qk_norm:
        q = _qk_norm(c, lp['q_norm'], q)
        k = _qk_norm(c, lp['k_norm'], k)
    if c.attn_scale is not None:
        # fold the override into q; attention keeps its internal d^-0.5
        q = q * (c.attn_scale * c.head_dim ** 0.5)
    if c.positional == 'rope' and c.mrope_section is not None \
            and positions.ndim == 3:
        # m-rope (Qwen2-VL): (3, B, L) streams rotate their head-dim
        # sections; scalar-stream positions (decode) take plain rope
        q = apply_mrope(q, positions, sin, cos, c.mrope_section)
        k = apply_mrope(k, positions, sin, cos, c.mrope_section)
    elif c.positional == 'rope':
        q = apply_rope(q, positions, sin, cos)
        k = apply_rope(k, positions, sin, cos)

    static = isinstance(cache_offset, int)
    if layer_cache is not None and hasattr(layer_cache, 'attend'):
        # a cache object that writes and attends itself (the continuous
        # engine's page pool)
        attn = layer_cache.attend(q, k, v,
                                  c.sliding_window if sliding else None)
    elif layer_cache is not None and static and cache_offset > 0 and l > 1:
        # multi-token write at a static offset (the prefix cache's tail):
        # write [off, off + L), then attend over the whole cache in slot
        # space, the query of row i at slot off + i
        ck, cv = layer_cache
        s, end = ck.shape[2], cache_offset + l
        if end > s:
            raise ValueError(f'cache write [{cache_offset}, {end}) past the '
                             f'cache ({s})')
        ck[:, :, cache_offset:end] = k.transpose(1, 2).to(ck.dtype)
        cv[:, :, cache_offset:end] = v.transpose(1, 2).to(cv.dtype)
        k_slots = torch.arange(s, device=x.device)[None, :]
        q_slots = cache_offset + torch.arange(l, device=x.device)[:, None]
        mask = k_slots <= q_slots
        if sliding:
            mask = mask & ((q_slots - k_slots) < c.sliding_window)
        mask = mask[None, None]                             # (1, 1, L, S)
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, :].bool()
        attn = _masked_attention(q, ck.to(dtype), cv.to(dtype), mask)
    elif layer_cache is not None and not (static and cache_offset == 0):
        if l != 1:
            raise ValueError('multi-token cache writes need a static offset; '
                             'decode writes one token at a time')
        # decode: each row writes its token at its own slot and attends
        # over the slots up to it
        ck, cv = layer_cache
        off = torch.as_tensor(cache_offset, device=x.device).reshape(-1)
        off = off.expand(b).to(torch.long)
        rows = torch.arange(b, device=x.device)
        ck[rows, :, off] = k[:, 0].to(ck.dtype)
        cv[rows, :, off] = v[:, 0].to(cv.dtype)
        slots = torch.arange(ck.shape[2], device=x.device)
        # slot space: each row's query sits at its slot ``off``
        mask = slots[None, :] <= off[:, None]
        if sliding:
            mask = mask & ((off[:, None] - slots[None, :]) < c.sliding_window)
        mask = mask[:, None, None, :]
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, :].bool()
        attn = _masked_attention(q, ck.to(dtype), cv.to(dtype), mask)
    elif layer_cache is not None:
        # prefill: write [0, L), then attend over the fresh K/V as stored
        # (rounded to the cache dtype)
        ck, cv = layer_cache
        ck[:, :, :l] = k.transpose(1, 2).to(ck.dtype)      # (B, KH, L, D)
        cv[:, :, :l] = v.transpose(1, 2).to(cv.dtype)
        idx = torch.arange(l, device=x.device)
        mask = idx[None, :] <= idx[:, None]
        if sliding:
            mask = mask & ((idx[:, None] - idx[None, :]) < c.sliding_window)
        mask = mask[None, None]                             # (1, 1, L, L)
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, :l].bool()
        attn = _masked_attention(q, ck[:, :, :l].to(dtype),
                                 cv[:, :, :l].to(dtype), mask)
    elif c.sliding_window is not None:
        attn = windowed_causal_attention(q, k, v, attention_mask,
                                         c.sliding_window, layer_flag,
                                         impl=c.attention_impl)
    else:
        attn = causal_attention(q, k, v, attention_mask, causal=True,
                                impl=c.attention_impl)

    out = _wmm('blhd,hde->ble', attn, lp['o']['w'], dtype, n_contract=2)
    if 'b' in lp['o']:
        out = out + lp['o']['b'].to(dtype)
    if c.sandwich_norms:
        out = _norm(c, lp['post_attn_norm'], out)
    if layer_cache is None and c.remat in ('save_flash', 'save_attn'):
        # the JAX 'attn_out' name, which these two policies keep; it is a
        # copy here, so the other policies do not emit it
        out = torch.ops.aat_torch.checkpoint_name(out, 'attn_out')
    x = x + out

    h = _norm(c, lp['mlp_norm'], x)
    act = _ACT[c.activation]
    aux = None
    if c.num_experts:
        down, aux = _moe_mlp(c, lp, h, act)
    else:
        if 'gate_up' in lp:
            # fused gate+up leaf (quantize_decoder_int4(fuse=True))
            gu = _wmm('ble,ez->blz', h, lp['gate_up']['w'], dtype)
            f = gu.shape[-1] // 2
            up = act(gu[..., :f]) * gu[..., f:]
        else:
            up = _wmm('ble,ef->blf', h, lp['up']['w'], dtype)
            if 'b' in lp['up']:
                up = up + lp['up']['b'].to(dtype)
            if c.gated_mlp:
                gate = _wmm('ble,ef->blf', h, lp['gate']['w'], dtype)
                up = act(gate) * up
            else:
                up = act(up)
        down = _wmm('blf,fe->ble', up, lp['down']['w'], dtype)
        if 'b' in lp['down']:
            down = down + lp['down']['b'].to(dtype)
    if c.sandwich_norms:
        down = _norm(c, lp['post_mlp_norm'], down)
    return x + down, aux


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def _route(c: ModelConfig, lp: dict, h: torch.Tensor) -> tuple:
    """The top-k router (JAX ``_moe_mlp``'s head): logits in the compute
    dtype, then fp32 softmax, the top ``num_experts_per_tok`` probabilities
    renormalised to sum to 1.  Returns (top_w (B, L, K) fp32, top_idx
    (B, L, K), weights (B, L, X) fp32: top_w at the chosen experts and 0
    elsewhere, the switch-style balancing loss X * sum_x f_x P_x)."""
    router = dequantize_weight(lp['router']['w'], h.dtype, stacked=False)
    probs = torch.softmax(torch.einsum('ble,ex->blx', h, router).float(),
                          dim=-1)
    # the top k of a stable descending sort: equal probabilities keep the
    # lower expert first, as jax.lax.top_k does (torch.topk promises no
    # order among ties, and bf16 logits over many experts do tie)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = c.num_experts_per_tok
    top_w, top_idx = top_w[..., :k], top_idx[..., :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    weights = (F.one_hot(top_idx, c.num_experts).to(probs.dtype)
               * top_w[..., None]).sum(-2)
    token_frac = (weights > 0).float().mean(dim=(0, 1))
    aux = c.num_experts * (token_frac * probs.mean(dim=(0, 1))).sum()
    return top_w, top_idx, weights, aux


def _moe_mlp(c: ModelConfig, lp: dict, h: torch.Tensor, act
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed mixture of experts (Qwen3-MoE-class), JAX
    ``_moe_mlp``.  h (B, L, E) -> (output (B, L, E), balancing loss).

    'dense' (the default, and any value but 'sparse'): every expert runs on
    every token and the top-k weights select; 'sparse': ``_moe_sparse``.
    Quantized expert and router leaves are dequantized where they are read
    (JAX ``.astype(dtype)``)."""
    dtype = h.dtype
    top_w, top_idx, weights, aux = _route(c, lp, h)
    if c.moe_impl == 'sparse':
        return _moe_sparse(c, lp, h, act, top_w, top_idx), aux
    b, l, e = h.shape
    n, x_, f = b * l, c.num_experts, c.mlp_dim
    hf = h.reshape(n, e)
    # up and gate as one (E, X*F) product each, the (B, L, X, F) outputs of
    # JAX's 'ble,xef->blxf' (the remat policies know them by that weight
    # shape, ``_up_shape``)
    up = (hf @ _experts_in(lp['up']['w'], dtype)).view(n, x_, f)
    gate = (hf @ _experts_in(lp['gate']['w'], dtype)).view(n, x_, f)
    mid = act(gate) * up                                      # (N, X, F)
    # 'blxf,xfe->blxe': one product per expert, batched over X
    down = dequantize_weight(lp['down']['w'], dtype, stacked=False)
    out = torch.bmm(mid.transpose(0, 1), down)                # (X, N, E)
    # 'blxe,blx->ble': batched over the tokens
    y = torch.bmm(weights.to(dtype).view(n, 1, x_), out.transpose(0, 1))
    return y.view(b, l, e), aux


def _experts_in(leaf, dtype: torch.dtype) -> torch.Tensor:
    """A layer's (X, E, F) expert leaf as one (E, X*F) matrix in ``dtype``
    (one cast-and-transpose copy)."""
    w = _experts(leaf, dtype)
    x_, e, f = w.shape
    out = torch.empty((e, x_, f), dtype=dtype, device=w.device)
    out.copy_(w.permute(1, 0, 2))
    return out.view(e, x_ * f)


def _moe_sparse(c: ModelConfig, lp: dict, h: torch.Tensor, act,
                top_w: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
    """The sparse dispatch (JAX ``_moe_sparse``): the N*K (token, expert)
    rows sorted by expert (a stable sort, as JAX's ``argsort``), one
    product per expert over its rows (``ragged_dot``), then the rows
    gathered back to (token, k) order and summed over K with their weights.
    The combine is a gather and a sum, not JAX's scatter-add
    (``.at[token_of].add``): on the card ``index_add_`` adds with atomics,
    so its bf16 sums would differ from run to run."""
    dtype = h.dtype
    b, l, e = h.shape
    k, n = c.num_experts_per_tok, b * l
    flat = top_idx.reshape(-1)                               # (N*K,)
    order = torch.argsort(flat, stable=True)
    sorted_rows = h.reshape(n, e)[order // k]                # (N*K, E)
    # the layer's one host sync: the per-expert row counts
    sizes = torch.bincount(flat, minlength=c.num_experts).tolist()
    up = ragged_dot(sorted_rows, _experts(lp['up']['w'], dtype), sizes)
    gate = ragged_dot(sorted_rows, _experts(lp['gate']['w'], dtype), sizes)
    down = ragged_dot(act(gate) * up, _experts(lp['down']['w'], dtype),
                      sizes)                                 # (N*K, E)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=order.device)
    rows = down[back].view(n, k, e)
    y = (rows * top_w.reshape(n, k).to(dtype)[..., None]).sum(dim=1)
    return y.view(b, l, e)


def _experts(leaf, dtype: torch.dtype) -> torch.Tensor:
    """A layer's expert leaf as a tensor: an fp leaf as it is (``ragged_dot``
    casts the experts it uses), a quantized one dequantized to ``dtype``."""
    return leaf if isinstance(leaf, torch.Tensor) else dequantize_weight(
        leaf, dtype, stacked=False)


@torch.library.custom_op('aat_torch::ragged_dot', mutates_args=())
def ragged_dot(x: torch.Tensor, w: torch.Tensor,
               group_sizes: list[int]) -> torch.Tensor:
    """``jax.lax.ragged_dot``: x (M, K) holds ``len(group_sizes)`` groups of
    consecutive rows; group g's rows times ``w[g].to(x.dtype)`` (w (G, K,
    N)) -> (M, N) in x's dtype, one ``torch.mm`` per non-empty group (rows
    past the groups are 0).  A custom op, so the remat policies see it as
    JAX's policies see ``ragged_dot``: not a dot, never saved."""
    out = x.new_zeros((x.shape[0], w.shape[2]))
    start = 0
    for g, rows in enumerate(group_sizes):
        if rows:
            torch.mm(x[start:start + rows], w[g].to(x.dtype),
                     out=out[start:start + rows])
        start += rows
    return out


def _ragged_dot_fake(x, w, group_sizes):
    return x.new_empty((x.shape[0], w.shape[2]))


def _ragged_dot_setup(ctx, inputs, output):
    x, w, group_sizes = inputs
    ctx.save_for_backward(x, w)
    ctx.group_sizes = group_sizes


def _ragged_dot_backward(ctx, grad):
    x, w = ctx.saved_tensors
    sizes = ctx.group_sizes
    gx = gw = None
    if ctx.needs_input_grad[0]:
        gx = ragged_dot(grad, w.transpose(1, 2), sizes)
    if ctx.needs_input_grad[1]:
        # the cast's gradient: computed in x's dtype, returned in w's
        gw = torch.zeros(w.shape, dtype=x.dtype, device=w.device)
        start = 0
        for g, rows in enumerate(sizes):
            if rows:
                torch.mm(x[start:start + rows].T, grad[start:start + rows],
                         out=gw[g])
            start += rows
        gw = gw.to(w.dtype)
    return gx, gw, None


ragged_dot.register_fake(_ragged_dot_fake)
ragged_dot.register_autograd(_ragged_dot_backward,
                             setup_context=_ragged_dot_setup)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@torch.library.custom_op('aat_torch::checkpoint_name', mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """A copy of ``x`` that a remat policy can save by ``name``: the JAX
    ``checkpoint_name``.  Custom ops may not return their input, hence the
    copy; the policy saves the copy, so it costs no memory beyond the save."""
    return x.clone()


checkpoint_name.register_fake(lambda x, name: torch.empty_like(x))
checkpoint_name.register_autograd(
    lambda ctx, grad: (grad, None),
    setup_context=lambda ctx, inputs, output: None)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_MATMULS = (torch.ops.aten.bmm.default,
                    torch.ops.aten.baddbmm.default)


def _weight_operand(op, args) -> torch.Tensor:
    """The right-hand operand of a matmul op (after ``addmm``'s and
    ``baddbmm``'s added term)."""
    return args[2] if op in (torch.ops.aten.addmm.default,
                             torch.ops.aten.baddbmm.default) else args[1]


def _no_batch_dims(op, args) -> bool:
    """A matmul without batch dims (JAX ``dots_with_no_batch_dims``).
    ``torch.einsum`` folds all of x's leading dims into M and runs a weight
    matmul as ``bmm`` over a batch of one, so such a ``bmm`` counts as
    unbatched; attention's einsums batch over B x heads."""
    if op in _MATMULS:
        return True
    return op in _BATCHED_MATMULS and _weight_operand(op, args).shape[0] == 1


def _policy_saves(remat: str, up_shape: tuple[int, int], op, args) -> bool:
    """Whether the remat policy ``remat`` keeps the output of ``op`` called
    on ``args``; what it does not keep is recomputed in the backward (the
    JAX ``_remat_policy``, ``transformer.py:624``).  ``up_shape`` is
    (hidden, mlp_dim): the weight of the up and gate projections."""
    matmul = op in _MATMULS or op in _BATCHED_MATMULS
    if op is torch.ops.aat_torch.flash_attention_fwd.default:
        # the kernel's (out, lse): the JAX 'flash_out' / 'flash_lse' names
        return remat in ('save_flash', 'dots_flash', 'dots_saveable_flash',
                         'dots_mlp_lean_flash')
    if op is torch.ops.aat_torch.checkpoint_name.default:
        return remat in ('save_flash', 'save_attn')          # 'attn_out'
    if remat in ('dots_saveable', 'dots_saveable_flash'):
        # every matmul output; without the kernel's names the forward
        # kernel re-runs in the backward
        return matmul
    if remat in ('dots_nb', 'dots_flash'):
        return _no_batch_dims(op, args)
    if remat in ('dots_mlp_lean', 'dots_mlp_lean_flash'):
        # dots_saveable minus the (B, L, mlp_dim) outputs of the up and
        # gate projections
        return matmul and tuple(
            _weight_operand(op, args).shape[-2:]) != up_shape
    return False      # 'save_flash' and 'save_attn' keep no matmul output


def _up_shape(c: ModelConfig) -> tuple[int, int]:
    """The weight shape by which ``dots_mlp_lean`` finds the up and gate
    projections: (hidden, mlp_dim), or (hidden, num_experts * mlp_dim) for
    the dense MoE dispatch's (E, X*F) products."""
    return (c.hidden_size, c.mlp_dim * (c.num_experts or 1))


@functools.lru_cache(maxsize=None)
def _remat_context(remat: str, up_shape: tuple[int, int]):
    """``context_fn`` for ``torch.utils.checkpoint`` under ``remat``."""
    if remat == 'full':
        return ckpt.noop_context_fn

    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE
                if _policy_saves(remat, up_shape, op, args)
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


def layer_call(remat: str, up_shape: tuple[int, int], fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with the remat
    policy ``remat`` when gradients are being recorded (as ``forward`` runs
    its layers); ``up_shape`` is the layer's (hidden, mlp) weight shape,
    which 'dots_mlp_lean' reads."""
    if remat == 'none' or not torch.is_grad_enabled():
        return fn(*args)
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           context_fn=_remat_context(remat, up_shape))


def forward(params: dict, config: ModelConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            positions: torch.Tensor | None = None,
            cache: KVCache | None = None,
            cache_offset: torch.Tensor | int = 0,
            need_logits: bool = True,
            inputs_embeds: torch.Tensor | None = None) -> ModelOutput:
    """Run the decoder.

    No cache: ``attention_mask`` is (B, L) over the inputs.  With a cache:
    inputs are written at ``cache_offset`` and ``attention_mask``, when
    given, is (B, max_len) over cache slots (and includes the new tokens).
    ``positions`` are required with a cache: (B, L), or (3, B, L) m-rope
    streams where the config has an ``mrope_section`` (Qwen2-VL; a decode
    step passes scalar-stream (B, 1) positions).  ``inputs_embeds`` (B, L, E),
    when given, replaces the embedding lookup of ``input_ids`` (the
    multimodal models merge image features into it); positions still come
    from the mask."""
    c = config
    check_supported(c)
    dtype = torch_dtype(c.compute_dtype)
    b, l = input_ids.shape
    dev = input_ids.device

    if positions is None:
        if cache is not None:
            raise ValueError('positions are required when using a KV cache')
        if attention_mask is not None:
            positions = (torch.cumsum(attention_mask, dim=-1) - 1).clamp_min(0)
        else:
            positions = torch.arange(l, device=dev).expand(b, l)
    positions = positions.to(torch.long)

    x = (inputs_embeds.to(dtype) if inputs_embeds is not None
         else params['embedding'][input_ids].to(dtype))
    if c.embedding_scale is not None:
        x = x * torch.tensor(c.embedding_scale, dtype=dtype)
    if c.positional == 'learned':
        x = x + params['pos_embedding'][positions + c.learned_pos_offset].to(dtype)
        sin = cos = None
    else:
        table_len = cache.max_len if cache is not None else max(
            l, c.max_position_embeddings)
        sin, cos = rope_table(table_len, c.head_dim, theta=c.rope_theta,
                              llama3=c.rope_llama3, device=dev)
    rope_alt = None
    if c.positional != 'learned' and c.rope_local_theta is not None:
        # the sliding layers' table (JAX builds it without llama3 scaling)
        rope_alt = rope_table(table_len, c.head_dim,
                              theta=c.rope_local_theta, device=dev)
    flags = c.layer_is_sliding or (0,) * c.num_layers

    remat = (cache is None and c.remat != 'none'
             and torch.is_grad_enabled())
    auxes = []
    for li in range(c.num_layers):
        lp = layer_params(params['layers'], li)
        layer_cache = None if cache is None else cache.layer(li)
        if remat:
            x, aux = ckpt.checkpoint(
                _decoder_layer, c, lp, x, positions, sin, cos, attention_mask,
                None, cache_offset, flags[li], rope_alt, use_reentrant=False,
                context_fn=_remat_context(c.remat, _up_shape(c)))
        else:
            x, aux = _decoder_layer(c, lp, x, positions, sin, cos,
                                    attention_mask, layer_cache, cache_offset,
                                    flags[li], rope_alt)
        auxes.append(aux)
    aux_loss = torch.stack(auxes).mean() if c.num_experts else None

    x = _norm(c, params['final_norm'], x)
    if not need_logits:
        return ModelOutput(logits=torch.zeros((b, 0, 0), device=dev),
                           last_hidden_state=x, cache=cache,
                           aux_loss=aux_loss)
    logits = _head_logits(c, params, x)
    if c.true_vocab_size is not None and c.true_vocab_size != c.vocab_size:
        logits = logits[..., :c.true_vocab_size]
    return ModelOutput(logits=logits, last_hidden_state=x, cache=cache,
                       aux_loss=aux_loss)
