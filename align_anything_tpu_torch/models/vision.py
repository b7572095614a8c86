"""CLIP-style ViT vision tower: the port of
``align_anything_tpu/models/vision.py``.

Plain functions over a param tree of tensors, with the JAX package's tree
and layouts (see ``models/bridge.py``): layer leaves stacked on a leading
``num_layers`` axis, einsum weights (E, H, D) for q/k/v and (H, D, E) for
the output projection, the patch embedding as a (P*P*C, E) matrix.  The
patchify is a reshape and one matmul, not a convolution.

Attention is full (non-causal) self-attention through
``ops/attention.causal_attention(..., causal=False)``: the flash-attention
kernel on the card, its plain version on a CPU tensor.  The layer loop runs
only the layers up to ``feature_layer`` (LLaVA's -2 runs 23 of 24).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from align_anything_tpu_torch.ops.attention import causal_attention
from align_anything_tpu_torch.ops.norms import layer_norm
from align_anything_tpu_torch.utils.tools import default_device


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    norm_eps: float = 1e-5
    activation: str = 'quick_gelu'   # CLIP default; 'gelu' for SigLIP-style
    use_class_token: bool = True
    # which hidden layer to emit (-1 = last, -2 = penultimate: LLaVA default)
    feature_layer: int = -2
    # 'default' drops the CLS token from the output; 'full' keeps it
    feature_select: str = 'default'
    # apply the final post_layernorm to the emitted features (SigLIP/Janus
    # towers tap the POST-normed last hidden; CLIP-in-LLaVA taps pre-norm
    # penultimate features)
    apply_post_norm: bool = False
    # CLIP applies a LayerNorm right after the embeddings; SigLIP/Janus
    # towers have none (a w=1,b=0 "identity" still normalizes!)
    use_pre_norm: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def layers_run(self) -> int:
        """Layers the forward runs: up to and including ``feature_layer``."""
        if self.feature_layer < 0:
            return self.num_layers + 1 + self.feature_layer
        return self.feature_layer


def init_params(cfg: ViTConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random fp32 init with the JAX package's tree and shapes (the numbers
    differ), on ``device`` (default: the first CUDA device; ``generator``
    must live there too)."""
    device = default_device(device)
    c = cfg
    n, d, h, f = c.num_layers, c.hidden_size, c.num_heads, c.mlp_dim
    hd = c.head_dim
    patch_dim = c.patch_size * c.patch_size * 3

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def dense(*shape, fan_in):
        return randn(*shape) * (1.0 / math.sqrt(fan_in))

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    params: dict[str, Any] = {
        'patch_embed': {'w': dense(patch_dim, d, fan_in=patch_dim),
                        'b': zeros(d)},
        'pos_embed': randn(c.num_patches + int(c.use_class_token), d) * 0.02,
        'pre_norm': {'w': ones(d), 'b': zeros(d)},
        'layers': {
            'norm1': {'w': ones(n, d), 'b': zeros(n, d)},
            'q': {'w': dense(n, d, h, hd, fan_in=d), 'b': zeros(n, h, hd)},
            'k': {'w': dense(n, d, h, hd, fan_in=d), 'b': zeros(n, h, hd)},
            'v': {'w': dense(n, d, h, hd, fan_in=d), 'b': zeros(n, h, hd)},
            'o': {'w': dense(n, h, hd, d, fan_in=d), 'b': zeros(n, d)},
            'norm2': {'w': ones(n, d), 'b': zeros(n, d)},
            'up': {'w': dense(n, d, f, fan_in=d), 'b': zeros(n, f)},
            'down': {'w': dense(n, f, d, fan_in=f), 'b': zeros(n, d)},
        },
        'post_norm': {'w': ones(d), 'b': zeros(d)},
    }
    if c.use_class_token:
        params['class_token'] = randn(d) * 0.02
    return params


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, N, P*P*C), each patch in the conv-weight order
    (C, P, P) so HF conv kernels map directly."""
    b, c, h, w = pixel_values.shape
    ph, pw = h // patch_size, w // patch_size
    x = pixel_values.reshape(b, c, ph, patch_size, pw, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5)  # (B, ph, pw, C, P, P)
    return x.reshape(b, ph * pw, c * patch_size * patch_size)


def _encoder_layer(cfg: ViTConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    h = layer_norm(x, lp['norm1']['w'], lp['norm1']['b'], eps=cfg.norm_eps)
    q = torch.einsum('bld,dhk->blhk', h, lp['q']['w'].to(dtype)) \
        + lp['q']['b'].to(dtype)
    k = torch.einsum('bld,dhk->blhk', h, lp['k']['w'].to(dtype)) \
        + lp['k']['b'].to(dtype)
    v = torch.einsum('bld,dhk->blhk', h, lp['v']['w'].to(dtype)) \
        + lp['v']['b'].to(dtype)
    attn = causal_attention(q, k, v, None, causal=False)
    out = torch.einsum('blhk,hkd->bld', attn, lp['o']['w'].to(dtype)) \
        + lp['o']['b'].to(dtype)
    x = x + out
    h = layer_norm(x, lp['norm2']['w'], lp['norm2']['b'], eps=cfg.norm_eps)
    up = torch.einsum('bld,df->blf', h, lp['up']['w'].to(dtype)) \
        + lp['up']['b'].to(dtype)
    if cfg.activation == 'quick_gelu':
        up = up * torch.sigmoid(1.702 * up)
    else:
        up = F.gelu(up)
    down = torch.einsum('blf,fd->bld', up, lp['down']['w'].to(dtype)) \
        + lp['down']['b'].to(dtype)
    return x + down


def forward(params: dict, cfg: ViTConfig, pixel_values: torch.Tensor,
            compute_dtype: str | torch.dtype = 'float32') -> torch.Tensor:
    """pixel_values (B, C, H, W) -> patch features (B, N[, +1], D)."""
    dtype = (getattr(torch, compute_dtype) if isinstance(compute_dtype, str)
             else compute_dtype)
    patches = patchify(pixel_values.to(dtype), cfg.patch_size)
    x = torch.einsum('bnp,pd->bnd', patches,
                     params['patch_embed']['w'].to(dtype))
    x = x + params['patch_embed']['b'].to(dtype)
    if cfg.use_class_token:
        cls = params['class_token'].to(dtype).expand(x.shape[0], 1,
                                                     cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
    x = x + params['pos_embed'].to(dtype)[None]
    if cfg.use_pre_norm:
        x = layer_norm(x, params['pre_norm']['w'], params['pre_norm']['b'],
                       eps=cfg.norm_eps)
    layers = params['layers']
    for li in range(cfg.layers_run):
        lp = {name: {k: leaf[li] for k, leaf in sub.items()}
              for name, sub in layers.items()}
        x = _encoder_layer(cfg, lp, x)
    if cfg.apply_post_norm:
        x = layer_norm(x, params['post_norm']['w'], params['post_norm']['b'],
                       eps=cfg.norm_eps)
    if cfg.feature_select == 'default' and cfg.use_class_token:
        x = x[:, 1:]
    return x
