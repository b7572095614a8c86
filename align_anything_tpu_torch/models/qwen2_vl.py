"""Qwen2-VL-class multimodal model: the port of
``align_anything_tpu/models/qwen2_vl.py`` (reference: models wrap HF
Qwen2VLForConditionalGeneration; trainers/text_image_to_text/* use it via
AutoModel).

Two pieces the LLaVA path does not have:
- a ViT whose attention rotates q and k by a 2-D rotary over the (h, w)
  patch coordinates, and whose output passes through a 2x2 PatchMerger;
- m-rope in the text trunk: (temporal, height, width) position streams
  rotate disjoint head-dim sections (``ops/rope.apply_mrope``, switched on
  by ``ModelConfig.mrope_section``).

Fixed resolution (one static grid, ``PatchProcessor``) and dynamic
resolution (``DynamicPatchProcessor``: per-image ``smart_resize`` grids,
patch rows padded to a shared count, ``image_grid_thw``) both run.  The
tower's attention is plain PyTorch (``ops/attention.xla_attention``), as
JAX's is: its head dim 80 has no flash-kernel path.

The param tree keeps the JAX package's keys, ``language_model`` (the
decoder of ``models/transformer.py``) and ``visual``, with the tower's
block leaves stacked on a leading ``depth`` axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from align_anything_tpu_torch.data.image import (
    CLIP_MEAN,
    CLIP_STD,
    ImageProcessor,
    ImageProcessorConfig,
)
from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.models.multimodal import merge_image_embeds
from align_anything_tpu_torch.models.transformer import ModelOutput
from align_anything_tpu_torch.ops.attention import xla_attention
from align_anything_tpu_torch.ops.logprobs import hidden_to_token_logprobs
from align_anything_tpu_torch.ops.norms import layer_norm
from align_anything_tpu_torch.utils.tools import default_device


@dataclasses.dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    mlp_ratio: float = 4.0
    image_size: int = 224            # fixed-resolution operating point

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def grid_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        """Post-merger token count for one image."""
        return (self.grid_side // self.spatial_merge_size) ** 2

    @property
    def patch_dim(self) -> int:
        return 3 * self.temporal_patch_size * self.patch_size ** 2


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    text: ModelConfig
    vision: Qwen2VLVisionConfig
    image_token_id: int = 151655

    @property
    def hidden_size(self) -> int:
        return self.text.hidden_size

    @property
    def vocab_size(self) -> int:
        return self.text.vocab_size

    @property
    def eos_token_id(self) -> int:
        return self.text.eos_token_id

    @property
    def pad_token_id(self) -> int:
        return self.text.pad_token_id

    @property
    def bos_token_id(self) -> int:
        return self.text.bos_token_id

    @property
    def true_vocab_size(self):
        return self.text.true_vocab_size

    @property
    def compute_dtype(self) -> str:
        return self.text.compute_dtype

    @property
    def tie_word_embeddings(self) -> bool:
        return self.text.tie_word_embeddings

    @property
    def final_logit_softcap(self):
        return self.text.final_logit_softcap

    def replace(self, **kw) -> 'Qwen2VLConfig':
        text_fields = {f.name for f in dataclasses.fields(ModelConfig)}
        text_kw = {k: v for k, v in kw.items() if k in text_fields}
        own_kw = {k: v for k, v in kw.items() if k not in text_fields}
        return dataclasses.replace(self, text=self.text.replace(**text_kw),
                                   **own_kw)


def check_supported(cfg) -> None:
    """Raise for the text-decoder options the port does not run yet."""
    transformer.check_supported(cfg.text)


def qwen2vl_patchify(image_chw: np.ndarray, vcfg) -> np.ndarray:
    """Normalized (C, H, W) image -> (grid_h * grid_w, patch_dim) patches
    in the processor's merge-block order (image_processing_qwen2_vl.py:
    281-295; a still image is tiled to ``temporal_patch_size`` frames)."""
    p, m, tp = (vcfg.patch_size, vcfg.spatial_merge_size,
                vcfg.temporal_patch_size)
    c, h, w = image_chw.shape
    gh, gw = h // p, w // p
    x = np.tile(image_chw[None], (tp, 1, 1, 1))       # (T, C, H, W)
    x = x.reshape(1, tp, c, gh // m, m, p, gw // m, m, p)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gh * gw, c * tp * p * p).astype(np.float32)


def _inv_freq(vcfg, device) -> torch.Tensor:
    dim = vcfg.head_dim // 2
    return 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                           device=device) / dim))


def _vision_pos_freqs(vcfg, device: torch.device | str | None = None
                      ) -> torch.Tensor:
    """(N_patches, head_dim/2) fp32 rotary angles over the fixed grid's
    (h, w) coordinates in merge-block order (modeling_qwen2_vl.py:
    673-700); the angles in fp64, then rounded, as JAX's numpy does."""
    device = default_device(device)
    g, m = vcfg.grid_side, vcfg.spatial_merge_size
    hpos = torch.arange(g, device=device)[:, None].expand(g, g)
    wpos = torch.arange(g, device=device)[None, :].expand(g, g)

    def blockify(ids):
        return ids.reshape(g // m, m, g // m, m).permute(0, 2, 1, 3) \
            .reshape(-1)

    hpos, wpos = blockify(hpos), blockify(wpos)
    inv = _inv_freq(vcfg, device)
    freqs = torch.cat([torch.outer(hpos.double(), inv),
                       torch.outer(wpos.double(), inv)], dim=-1)
    return freqs.float()


def _merge_block_coords(m: int, grid_w: torch.Tensor, n_pad: int
                        ) -> tuple[torch.Tensor, ...]:
    """Patch index in merge-block order -> its block, row in the block and
    column in the block, (1, N) each, and the merge blocks a grid row
    holds, (B, 1), from the grids' widths ``grid_w`` (B,)."""
    n = torch.arange(n_pad, device=grid_w.device)[None]
    bw = torch.clamp(grid_w[:, None] // m, min=1)
    return n // (m * m), (n % (m * m)) // m, n % m, bw


def _vision_pos_freqs_dynamic(vcfg, grid_hw: torch.Tensor,
                              n_pad: int) -> torch.Tensor:
    """Per-sample rotary angles for dynamic grids: ``grid_hw`` (B, 2) ->
    (B, N_pad, head_dim/2) fp32.  Inverts the processor's merge-block patch
    order from the patch index (reference process_qwen2vl.py:71
    smart_resize feeding variable grids)."""
    m = vcfg.spatial_merge_size
    block, rin, cin, bw = _merge_block_coords(m, grid_hw[:, 1], n_pad)
    hpos = (block // bw) * m + rin                    # (B, N)
    wpos = (block % bw) * m + cin
    dim = vcfg.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=grid_hw.device) / dim))
    return torch.cat([hpos[..., None].float() * inv_freq,
                      wpos[..., None].float() * inv_freq], dim=-1)


def init_vision_params(vcfg: Qwen2VLVisionConfig, out_dim: int,
                       generator: torch.Generator,
                       device: torch.device | str | None = None) -> dict:
    """Random fp32 tower with the JAX package's tree and shapes (the
    numbers differ), on ``device`` (default: the first CUDA device;
    ``generator`` must live there too)."""
    device = default_device(device)
    d, n = vcfg.embed_dim, vcfg.depth
    mlp = int(vcfg.embed_dim * vcfg.mlp_ratio)
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
            'norm1': {'w': ones(n, d), 'b': zeros(n, d)},
            'norm2': {'w': ones(n, d), 'b': zeros(n, d)},
            'qkv': {'w': dense(n, d, 3 * d, fan_in=d), 'b': zeros(n, 3 * d)},
            'proj': {'w': dense(n, d, d, fan_in=d), 'b': zeros(n, d)},
            'fc1': {'w': dense(n, d, mlp, fan_in=d), 'b': zeros(n, mlp)},
            'fc2': {'w': dense(n, mlp, d, fan_in=mlp), 'b': zeros(n, d)},
        },
        'merger': {
            'ln_q': {'w': ones(d), 'b': zeros(d)},
            'mlp0': {'w': dense(merged, merged, fan_in=merged),
                     'b': zeros(merged)},
            'mlp2': {'w': dense(merged, out_dim, fan_in=merged),
                     'b': zeros(out_dim)},
        },
    }


def init_params(cfg: Qwen2VLConfig, generator: torch.Generator,
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


def rotate_half_pairs(t: torch.Tensor, sin: torch.Tensor,
                      cos: torch.Tensor) -> torch.Tensor:
    """The tower's rotary: t (B, N, H, hd) by angles (B|1, N, hd/2), in
    fp32 and cast back (JAX ``qwen2_vl.py:235-241``)."""
    dtype = t.dtype
    half = t.shape[-1] // 2
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    t1, t2 = t[..., :half].float(), t[..., half:].float()
    return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], dim=-1).to(dtype)


def merger(mg: dict, x: torch.Tensor, m: int, norm) -> torch.Tensor:
    """PatchMerger: ``norm`` (ln_q), each merge block's m x m patches
    concatenated, then Linear-GELU(exact)-Linear.  (B, N, D) -> (B, N/m^2,
    out_dim)."""
    dtype = x.dtype
    x = norm(x, mg['ln_q'])
    b, n, d = x.shape
    merged = d * m * m
    x = x.reshape(b, n * d // merged, merged)
    x = F.gelu(torch.einsum('bnm,mk->bnk', x, mg['mlp0']['w'].to(dtype))
               + mg['mlp0']['b'].to(dtype))
    return (torch.einsum('bnk,ke->bne', x, mg['mlp2']['w'].to(dtype))
            + mg['mlp2']['b'].to(dtype))


def _vision_block(vcfg, lp: dict, x: torch.Tensor, sin: torch.Tensor,
                  cos: torch.Tensor, patch_mask: torch.Tensor | None
                  ) -> torch.Tensor:
    dtype = x.dtype
    h, hd = vcfg.num_heads, vcfg.head_dim
    hidden = layer_norm(x, lp['norm1']['w'], lp['norm1']['b'], eps=1e-6)
    qkv = (torch.einsum('bnd,de->bne', hidden, lp['qkv']['w'].to(dtype))
           + lp['qkv']['b'].to(dtype))
    b, n, _ = qkv.shape
    q, k, v = (t.reshape(b, n, h, hd) for t in qkv.chunk(3, dim=-1))
    q, k = rotate_half_pairs(q, sin, cos), rotate_half_pairs(k, sin, cos)
    attn = xla_attention(q, k, v, attention_mask=patch_mask, causal=False)
    out = (torch.einsum('bnhd,hde->bne', attn,
                        lp['proj']['w'].to(dtype).reshape(h, hd, -1))
           + lp['proj']['b'].to(dtype))
    x = x + out
    hidden = layer_norm(x, lp['norm2']['w'], lp['norm2']['b'], eps=1e-6)
    up = (torch.einsum('bnd,df->bnf', hidden, lp['fc1']['w'].to(dtype))
          + lp['fc1']['b'].to(dtype))
    up = up * torch.sigmoid(1.702 * up)               # quick_gelu
    down = (torch.einsum('bnf,fd->bnd', up, lp['fc2']['w'].to(dtype))
            + lp['fc2']['b'].to(dtype))
    return x + down


def vision_forward(params: dict, vcfg: Qwen2VLVisionConfig,
                   patches: torch.Tensor,
                   compute_dtype: str | torch.dtype = 'float32',
                   grid_hw: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, patch_dim) -> (B, N/merge^2, out_dim).

    ``grid_hw`` (B, 2): dynamic-resolution grids, per-sample rotary
    coordinates and attention masked to the valid patches (rows are padded
    to a shared N; the valid patches come first, in merge-block order)."""
    dtype = (transformer.torch_dtype(compute_dtype)
             if isinstance(compute_dtype, str) else compute_dtype)
    x = torch.einsum('bnp,pd->bnd', patches.to(dtype),
                     params['patch_embed']['w'].to(dtype))
    n_pad = patches.shape[1]
    patch_mask = None
    if grid_hw is None:
        freqs = _vision_pos_freqs(vcfg, patches.device)[None]
    else:
        freqs = _vision_pos_freqs_dynamic(vcfg, grid_hw, n_pad)
        patch_mask = (torch.arange(n_pad, device=patches.device)[None]
                      < (grid_hw[:, 0] * grid_hw[:, 1])[:, None])
    sin, cos = torch.sin(freqs), torch.cos(freqs)     # (B|1, N, hd/2)
    blocks = params['blocks']
    for li in range(vcfg.depth):
        lp = {name: {k: leaf[li] for k, leaf in sub.items()}
              for name, sub in blocks.items()}
        x = _vision_block(vcfg, lp, x, sin, cos, patch_mask)
    return merger(params['merger'], x, vcfg.spatial_merge_size,
                  lambda t, p: layer_norm(t, p['w'], p['b'], eps=1e-6))


def mrope_positions(input_ids: torch.Tensor, image_token_id: int,
                    llm_grid_h, llm_grid_w) -> torch.Tensor:
    """(B, L) ids -> (3, B, L) int64 m-rope (t, h, w) position streams for
    right-padded rows with at most one contiguous image span
    (modeling_qwen2_vl.py get_rope_index).  ``llm_grid_h`` / ``llm_grid_w``
    are ints (a static grid) or (B,) tensors (dynamic resolution).  Text
    after the span continues from the span's start plus its larger side
    (``idx - n_img + max(gh, gw)``); a row without an image counts 0..L-1
    on all three streams."""
    b, l = input_ids.shape
    dev = input_ids.device
    is_img = input_ids == image_token_id
    idx = torch.arange(l, device=dev)[None, :]
    has_img = is_img.any(dim=-1, keepdim=True)
    # argmax returns the first maximal index: the span's first token
    start = torch.argmax(is_img.to(torch.int32), dim=-1, keepdim=True)
    start = torch.where(has_img, start, torch.full_like(start, l))
    gh = torch.as_tensor(llm_grid_h, device=dev).reshape(-1, 1).long()
    gw = torch.as_tensor(llm_grid_w, device=dev).reshape(-1, 1).long()
    n_img = gh * gw
    gmax = torch.maximum(gh, gw)
    end = start + n_img
    k = idx - start
    after = idx - n_img + gmax
    gw1 = torch.clamp(gw, min=1)
    before = idx < start
    inside = idx < end
    t_pos = torch.where(before, idx, torch.where(inside, start, after))
    h_pos = torch.where(before, idx,
                        torch.where(inside, start + k // gw1, after))
    w_pos = torch.where(before, idx,
                        torch.where(inside, start + k % gw1, after))
    return torch.stack([t_pos.expand(b, l), h_pos.expand(b, l),
                        w_pos.expand(b, l)]).long()


def default_positions(cfg, input_ids: torch.Tensor,
                      image_grid_thw: torch.Tensor | None) -> torch.Tensor:
    """The m-rope streams of ``input_ids``: per-row grids from
    ``image_grid_thw`` (B, 3), else the fixed grid."""
    m = cfg.vision.spatial_merge_size
    if image_grid_thw is not None:
        return mrope_positions(input_ids, cfg.image_token_id,
                               image_grid_thw[:, 1] // m,
                               image_grid_thw[:, 2] // m)
    g = cfg.vision.grid_side // m
    return mrope_positions(input_ids, cfg.image_token_id, g, g)


def forward_with_tower(tower_forward, params: dict, cfg,
                       input_ids: torch.Tensor,
                       attention_mask: torch.Tensor | None = None,
                       pixel_values: torch.Tensor | None = None,
                       positions: torch.Tensor | None = None, cache=None,
                       cache_offset: int = 0, need_logits: bool = True,
                       image_grid_thw: torch.Tensor | None = None
                       ) -> ModelOutput:
    """The Qwen2-VL-class forward over ``tower_forward`` (this module's or
    Qwen2.5-VL's ``vision_forward``): the tower's merged patch features
    over the <image> slots, m-rope positions unless given, the decoder."""
    lm = params['language_model']
    dtype = transformer.torch_dtype(cfg.text.compute_dtype)
    embeds = lm['embedding'][input_ids].to(dtype)
    if pixel_values is not None:
        grid_hw = (image_grid_thw[:, 1:] if image_grid_thw is not None
                   else None)
        image_embeds = tower_forward(params['visual'], cfg.vision,
                                     pixel_values, compute_dtype=dtype,
                                     grid_hw=grid_hw)
        embeds = merge_image_embeds(embeds, image_embeds, input_ids,
                                    cfg.image_token_id)
    if positions is None:
        positions = default_positions(cfg, input_ids, image_grid_thw)
    return transformer.forward(lm, cfg.text, input_ids,
                               attention_mask=attention_mask,
                               positions=positions, cache=cache,
                               cache_offset=cache_offset,
                               need_logits=need_logits,
                               inputs_embeds=embeds)


def forward(params: dict, cfg: Qwen2VLConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            pixel_values: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, cache=None,
            cache_offset: int = 0, need_logits: bool = True,
            image_grid_thw: torch.Tensor | None = None) -> ModelOutput:
    """``pixel_values``: (B, N, patch_dim) pre-extracted patches (one image
    a row), merged over the <image> slots.  ``image_grid_thw`` (B, 3):
    dynamic-resolution grids (reference process_qwen2vl.py smart_resize);
    rows are padded to a shared N and the valid patches come first."""
    return forward_with_tower(vision_forward, params, cfg, input_ids,
                              attention_mask=attention_mask,
                              pixel_values=pixel_values, positions=positions,
                              cache=cache, cache_offset=cache_offset,
                              need_logits=need_logits,
                              image_grid_thw=image_grid_thw)


def logprobs_of(out: ModelOutput, params: dict, cfg,
                input_ids: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """Per-token logp of input_ids[t+1] from a forward's hidden states,
    with the chunked vocab projection of ``ops/logprobs.py``."""
    lm = params['language_model']
    hidden = out.last_hidden_state
    head = (lm['embedding'].T if cfg.text.tie_word_embeddings
            else lm['lm_head']).to(hidden.dtype)
    return hidden_to_token_logprobs(
        hidden[:, :-1], head, input_ids[:, 1:], chunk_size=chunk_size,
        softcap=cfg.text.final_logit_softcap,
        true_vocab=cfg.text.true_vocab_size)


def token_logprobs(params: dict, cfg: Qwen2VLConfig,
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


def decode_forward(params: dict, cfg, input_ids: torch.Tensor,
                   **kw) -> ModelOutput:
    """Text-only decode step over the m-rope trunk: the image features
    live in the KV cache from the prefill, and scalar-stream positions
    reduce m-rope to plain rope (``generate``'s ``position_offset``
    continues them from the m-rope maximum)."""
    return transformer.forward(params['language_model'], cfg.text,
                               input_ids, **kw)


class PatchProcessor:
    """Host-side image -> Qwen2-VL patch matrix (N, patch_dim) at the fixed
    operating point: CLIP-style resize, crop and normalize, then the
    processor-order patch extraction (Qwen2.5-VL's is the same)."""

    def __init__(self, vcfg):
        self.vcfg = vcfg
        self.inner = ImageProcessor(ImageProcessorConfig(
            size=vcfg.image_size, mean=CLIP_MEAN, std=CLIP_STD))

    def __call__(self, image) -> np.ndarray:
        return qwen2vl_patchify(self.inner(image), self.vcfg)


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 4 * 28 * 28,
                 max_pixels: int = 16384 * 28 * 28) -> tuple[int, int]:
    """Dynamic-resolution target size (reference process_qwen2vl.py:71):
    both sides divisible by ``factor``, the pixel count within
    [min_pixels, max_pixels], the aspect ratio kept as closely as
    possible."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError('absolute aspect ratio must be smaller than 200, '
                         f'got {max(height, width) / min(height, width)}')
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = int(math.floor(height / beta / factor)) * factor
        w_bar = int(math.floor(width / beta / factor)) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = int(math.ceil(height * beta / factor)) * factor
        w_bar = int(math.ceil(width * beta / factor)) * factor
    return h_bar, w_bar


class DynamicPatchProcessor:
    """Host-side dynamic-resolution image -> padded patch matrix and grid.

    ``smart_resize`` picks each image's grid; the patches come in
    merge-block order, right-padded with zeros to the shared
    ``max_patches`` so that batches keep one shape.  Returns
    ``{'pixel_values': (N_pad, patch_dim), 'image_grid_thw': (3,),
    'num_tokens': int}``; ``num_tokens`` is the post-merger token count the
    dataset expands ``<image>`` to (host-side: the collator drops it)."""

    dynamic = True

    def __init__(self, vcfg, min_pixels: int | None = None,
                 max_pixels: int | None = None):
        self.vcfg = vcfg
        self.factor = vcfg.patch_size * vcfg.spatial_merge_size
        self.min_pixels = min_pixels or 4 * self.factor ** 2
        self.max_pixels = max_pixels or 256 * self.factor ** 2
        self.max_patches = self.max_pixels // vcfg.patch_size ** 2
        self.mean = np.asarray(CLIP_MEAN, np.float32)
        self.std = np.asarray(CLIP_STD, np.float32)

    @property
    def num_patches(self) -> int:
        """The most post-merger tokens an image can take (bucket sizing)."""
        return self.max_patches // self.vcfg.spatial_merge_size ** 2

    def __call__(self, image) -> dict[str, Any]:
        arr = ImageProcessor._to_array(image)           # (H, W, 3) uint8
        h, w = arr.shape[:2]
        h_bar, w_bar = smart_resize(h, w, self.factor, self.min_pixels,
                                    self.max_pixels)
        if (h_bar, w_bar) != (h, w):
            from PIL import Image as PILImage  # noqa: PLC0415

            arr = np.asarray(PILImage.fromarray(arr).resize(
                (w_bar, h_bar), PILImage.BICUBIC))
        x = arr.astype(np.float32) / 255.0
        x = ((x - self.mean) / self.std).transpose(2, 0, 1)   # (C, H, W)
        patches = qwen2vl_patchify(x, self.vcfg)              # (gh*gw, pd)
        gh, gw = h_bar // self.vcfg.patch_size, w_bar // self.vcfg.patch_size
        out = np.zeros((self.max_patches, patches.shape[1]), np.float32)
        out[:patches.shape[0]] = patches
        return {
            'pixel_values': out,
            'image_grid_thw': np.array([1, gh, gw], np.int32),
            'num_tokens': gh * gw // self.vcfg.spatial_merge_size ** 2,
        }
