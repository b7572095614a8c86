"""Qwen2.5-VL-class multimodal model: the port of
``align_anything_tpu/models/qwen2_5_vl.py`` (reference: models/qwen2_5_vl.py
wraps HF Qwen2_5_VLForConditionalGeneration).

Against the Qwen2-VL family (``models/qwen2_vl.py``):
- the vision blocks use RMSNorm and a biased SwiGLU MLP (gate / up / down)
  in place of LayerNorm and the fc1 / fc2 quick-GELU MLP;
- window attention: every block but ``fullatt_block_indexes`` attends only
  within ``window_size``-pixel windows.  HF reorders the patch stream by
  window and runs varlen attention over contiguous segments
  (modeling_qwen2_5_vl.py get_window_index); attention is permutation-
  equivariant per query, so, as in JAX, the patch stream stays in
  merge-block order and attention is masked to same-window pairs;
- the merger's ``ln_q`` is RMSNorm and projects to ``out_hidden_size``.

The text trunk is the same m-rope Qwen2 decoder, and the patch order, the
dynamic rotary and the m-rope positions are Qwen2-VL's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.qwen2_vl import (  # noqa: F401
    DynamicPatchProcessor,
    PatchProcessor,
    Qwen2VLConfig,
    _merge_block_coords,
    _vision_pos_freqs_dynamic,
    check_supported,
    decode_forward,
    forward_with_tower,
    logprobs_of,
    merger,
    mrope_positions,
    qwen2vl_patchify,
    rotate_half_pairs,
)
from align_anything_tpu_torch.models.transformer import NEG_INF, ModelOutput
from align_anything_tpu_torch.utils.tools import default_device


@dataclasses.dataclass(frozen=True)
class Qwen25VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280                 # HF vision_config.hidden_size
    num_heads: int = 16
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    intermediate_size: int = 3420
    window_size: int = 112
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    image_size: int = 224                 # fixed-resolution operating point

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def grid_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return (self.grid_side // self.spatial_merge_size) ** 2

    @property
    def patch_dim(self) -> int:
        return 3 * self.temporal_patch_size * self.patch_size ** 2

    @property
    def window_merge_side(self) -> int:
        """Window side in merged-token units (modeling_qwen2_5_vl.py:
        vit_merger_window_size)."""
        return self.window_size // self.spatial_merge_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class Qwen25VLConfig(Qwen2VLConfig):
    """Qwen2-VL's config (its pass-throughs and ``replace``) with the 2.5
    tower and the video token."""

    vision: Qwen25VLVisionConfig
    image_token_id: int = 151655
    video_token_id: int = 151656


def init_vision_params(vcfg: Qwen25VLVisionConfig, out_dim: int,
                       generator: torch.Generator,
                       device: torch.device | str | None = None) -> dict:
    """Random fp32 tower with the JAX package's tree and shapes (the
    numbers differ), on ``device`` (default: the first CUDA device)."""
    device = default_device(device)
    d, n, f = vcfg.embed_dim, vcfg.depth, vcfg.intermediate_size
    merged = d * vcfg.spatial_merge_size ** 2

    def dense(*shape, fan_in):
        return torch.randn(shape, generator=generator,
                           device=device) / math.sqrt(fan_in)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    return {
        'patch_embed': {'w': dense(vcfg.patch_dim, d, fan_in=vcfg.patch_dim)},
        'blocks': {
            'norm1': {'w': ones(n, d)},
            'norm2': {'w': ones(n, d)},
            'qkv': {'w': dense(n, d, 3 * d, fan_in=d), 'b': zeros(n, 3 * d)},
            'proj': {'w': dense(n, d, d, fan_in=d), 'b': zeros(n, d)},
            'gate': {'w': dense(n, d, f, fan_in=d), 'b': zeros(n, f)},
            'up': {'w': dense(n, d, f, fan_in=d), 'b': zeros(n, f)},
            'down': {'w': dense(n, f, d, fan_in=f), 'b': zeros(n, d)},
        },
        'merger': {
            'ln_q': {'w': ones(d)},
            'mlp0': {'w': dense(merged, merged, fan_in=merged),
                     'b': zeros(merged)},
            'mlp2': {'w': dense(merged, out_dim, fan_in=merged),
                     'b': zeros(out_dim)},
        },
    }


def init_params(cfg: Qwen25VLConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random fp32 ``{'language_model', 'visual'}`` tree on ``device``
    (default: the first CUDA device)."""
    device = default_device(device)
    check_supported(cfg)
    return {
        'language_model': transformer.init_params(cfg.text, generator,
                                                  device=device),
        'visual': init_vision_params(cfg.vision, cfg.text.hidden_size,
                                     generator, device=device),
    }


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
         ) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * w.float()).to(dtype)


def _merged_coords(vcfg: Qwen25VLVisionConfig, grid_hw: torch.Tensor,
                   n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Patch index (merge-block order) -> merged-unit (mh, mw) coordinates,
    each (B, N)."""
    block, _, _, bw = _merge_block_coords(vcfg.spatial_merge_size,
                                          grid_hw[:, 1], n_pad)
    return block // bw, block % bw


def window_masks(vcfg: Qwen25VLVisionConfig, grid_hw: torch.Tensor,
                 n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(full, window) (B, N, N) pair masks: both ends valid patches, and
    for the window mask in the same ``window_merge_side`` window."""
    valid = (torch.arange(n_pad, device=grid_hw.device)[None]
             < (grid_hw[:, 0] * grid_hw[:, 1])[:, None])          # (B, N)
    mh, mw = _merged_coords(vcfg, grid_hw, n_pad)
    wms = vcfg.window_merge_side
    wid = (mh // wms) * 65536 + (mw // wms)                        # (B, N)
    full = valid[:, :, None] & valid[:, None, :]
    return full, full & (wid[:, :, None] == wid[:, None, :])


def _pair_masked_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mask: torch.Tensor
                           ) -> torch.Tensor:
    """Non-causal attention under a (B, N, N) pair mask: fp32 logits and
    softmax, probabilities rounded to q's dtype before PV (JAX
    ``qwen2_5_vl.py:236-241``)."""
    hd = q.shape[-1]
    logits = torch.einsum('bnhd,bmhd->bhnm', q.float(), k.float()) \
        * hd ** -0.5
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum('bhnm,bmhd->bnhd', probs, v)


def _vision_block(vcfg, lp: dict, x: torch.Tensor, sin: torch.Tensor,
                  cos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    b, n = x.shape[:2]
    h, hd = vcfg.num_heads, vcfg.head_dim
    hidden = _rms(x, lp['norm1']['w'])
    qkv = (torch.einsum('bnd,de->bne', hidden, lp['qkv']['w'].to(dtype))
           + lp['qkv']['b'].to(dtype))
    q, k, v = (t.reshape(b, n, h, hd) for t in qkv.chunk(3, dim=-1))
    q, k = rotate_half_pairs(q, sin, cos), rotate_half_pairs(k, sin, cos)
    attn = _pair_masked_attention(q, k, v, mask)
    out = (torch.einsum('bnhd,hde->bne', attn,
                        lp['proj']['w'].to(dtype).reshape(h, hd, -1))
           + lp['proj']['b'].to(dtype))
    x = x + out
    hidden = _rms(x, lp['norm2']['w'])
    gate = (torch.einsum('bnd,df->bnf', hidden, lp['gate']['w'].to(dtype))
            + lp['gate']['b'].to(dtype))
    up = (torch.einsum('bnd,df->bnf', hidden, lp['up']['w'].to(dtype))
          + lp['up']['b'].to(dtype))
    down = (torch.einsum('bnf,fd->bnd', F.silu(gate) * up,
                         lp['down']['w'].to(dtype))
            + lp['down']['b'].to(dtype))
    return x + down


def vision_forward(params: dict, vcfg: Qwen25VLVisionConfig,
                   patches: torch.Tensor,
                   compute_dtype: str | torch.dtype = 'float32',
                   grid_hw: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, patch_dim) -> (B, N/merge^2, out_dim) with window attention
    in every block but ``fullatt_block_indexes`` (the module docstring);
    without ``grid_hw`` every row is the fixed grid."""
    dtype = (transformer.torch_dtype(compute_dtype)
             if isinstance(compute_dtype, str) else compute_dtype)
    b, n_pad, _ = patches.shape
    if grid_hw is None:
        g = vcfg.grid_side
        grid_hw = torch.full((b, 2), g, dtype=torch.int64,
                             device=patches.device)
    x = torch.einsum('bnp,pd->bnd', patches.to(dtype),
                     params['patch_embed']['w'].to(dtype))
    freqs = _vision_pos_freqs_dynamic(vcfg, grid_hw, n_pad)
    full_mask, win_mask = window_masks(vcfg, grid_hw, n_pad)
    sin, cos = torch.sin(freqs), torch.cos(freqs)          # (B, N, hd/2)
    full_blocks = set(vcfg.fullatt_block_indexes)
    blocks = params['blocks']
    for li in range(vcfg.depth):
        lp = {name: {k: leaf[li] for k, leaf in sub.items()}
              for name, sub in blocks.items()}
        x = _vision_block(vcfg, lp, x, sin, cos,
                          full_mask if li in full_blocks else win_mask)
    return merger(params['merger'], x, vcfg.spatial_merge_size,
                  lambda t, p: _rms(t, p['w']))


def forward(params: dict, cfg: Qwen25VLConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            pixel_values: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, cache=None,
            cache_offset: int = 0, need_logits: bool = True,
            image_grid_thw: torch.Tensor | None = None) -> ModelOutput:
    """Qwen2-VL's contract (``qwen2_vl.forward``): pre-extracted patch rows
    (one image a row, padded), merged over the <image> slots, m-rope
    positions."""
    return forward_with_tower(vision_forward, params, cfg, input_ids,
                              attention_mask=attention_mask,
                              pixel_values=pixel_values, positions=positions,
                              cache=cache, cache_offset=cache_offset,
                              need_logits=need_logits,
                              image_grid_thw=image_grid_thw)


def token_logprobs(params: dict, cfg: Qwen25VLConfig,
                   input_ids: torch.Tensor,
                   attention_mask: torch.Tensor | None = None,
                   pixel_values: torch.Tensor | None = None,
                   chunk_size: int = 256,
                   image_grid_thw: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """(B, L-1) log-probs of each next token."""
    out = forward(params, cfg, input_ids, attention_mask=attention_mask,
                  pixel_values=pixel_values, need_logits=False,
                  image_grid_thw=image_grid_thw)
    return logprobs_of(out, params, cfg, input_ids, chunk_size)
