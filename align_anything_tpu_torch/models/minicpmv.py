"""MiniCPM-V (the MiniCPM-V-2.6 class): the port of
``align_anything_tpu/models/minicpmv.py``.

- ``vpm``: the SigLIP tower of ``models/idefics2.py`` (``vision_forward``
  over fixed square images, ``vision_forward_packed`` over NaViT-packed
  patch rows with ``tgt_sizes``), reused, not copied.
- ``resampler``: one cross-attention block whose ``query_num`` learned,
  LayerNormed queries attend to the kv-projected, LayerNormed patch
  features; the keys add the 2-D sincos table at each patch's
  ``(idx // w, idx % w)``, the values do not; padded patches are masked
  with the finite fill ``-2.3819763e38``, so a crop with no patch at all
  (``tgt_sizes`` (0, 0)) gets a uniform softmax, never a NaN; then
  ``out_proj``, ``ln_post`` and the (E, E) ``proj``.
- ``llm``: a Qwen2 trunk, the decoder of ``models/transformer.py``, which
  runs the flash-attention kernel in training; the crops' query tokens are
  merged over its image-token span (``multimodal.merge_image_embeds``).

Numerics as JAX's: the pixels are cast to the compute dtype, the tower's
fp32 params promote them back to fp32, and the resampler computes in the
features' dtype (so in fp32 under bf16); only the merge casts to the text
dtype.  The resampler's attention (64 queries over a crop's patches) is
plain PyTorch, as JAX's is an einsum.  The tower's layers take the trunk's
remat policy when gradients are recorded, as Idefics2's do.

Three crop layouts (``encode_image_crops``): fixed ``(B, 3, H, W)``;
packed ``(B, L, 3*p*p)`` with ``tgt_sizes`` (B, 2); slice mode
``(B, M, L, 3*p*p)`` with ``tgt_sizes`` (B, M, 2), the source crop then
the grid's slices of ``data/image.py`` ``MiniCPMVSliceProcessor``, run as
B*M crops.  Every crop, padded ones too, pays the tower, as in JAX.

``forward`` takes ``cache`` / ``cache_offset``, so it is both the prefill
and the decode step of ``generate`` (``media={'tgt_sizes': ...}``).

The tree keeps JAX's keys: ``llm`` (the decoder's tree), ``vpm`` nested by
module path in torch's Linear layout, ``resampler`` with ``kv_proj``
stored (kv_dim, E).  The loader and writer are ``models/hf_loader.py``
``load_minicpmv_params`` / ``save_minicpmv_params`` (the openbmb key
layout).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from align_anything_tpu_torch.models import idefics2, transformer
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.models.idefics2 import (
    Idefics2VisionCfg, _layer_norm)
from align_anything_tpu_torch.models.multimodal import merge_image_embeds
from align_anything_tpu_torch.models.transformer import ModelOutput
from align_anything_tpu_torch.ops.logprobs import hidden_to_token_logprobs
from align_anything_tpu_torch.utils.tools import default_device

# the fill of a padded patch's logit (JAX ``minicpmv.py:161``): finite, so
# a crop whose patches are all padded softmaxes to uniform, not NaN
MASK_FILL = -2.3819763e38


@dataclasses.dataclass(frozen=True)
class ResamplerCfg:
    num_queries: int = 64
    num_heads: int = 28              # embed_dim / 128 for Qwen2-7B
    kv_dim: int = 1152               # SigLIP width
    embed_dim: int = 3584            # LLM hidden
    max_size: int = 70               # sincos table side (patches)
    eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class MiniCPMVConfig:
    text: ModelConfig
    vision: Idefics2VisionCfg
    resampler: ResamplerCfg
    image_token_id: int = 128244
    slice_mode: bool = True

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

    def replace(self, **kw) -> 'MiniCPMVConfig':
        """Text fields go to ``text``, the rest to this config."""
        text_fields = {f.name for f in dataclasses.fields(ModelConfig)}
        text_kw = {k: v for k, v in kw.items() if k in text_fields}
        own_kw = {k: v for k, v in kw.items() if k not in text_fields}
        return dataclasses.replace(self, text=self.text.replace(**text_kw),
                                   **own_kw)


def sincos_2d(embed_dim: int, h: int, w: int) -> np.ndarray:
    """(h*w, embed_dim) 2-D sincos table, float32 from float64: the first
    half over the h coordinate, the second over w, each half [sin | cos]
    (openbmb ``get_2d_sincos_pos_embed``)."""
    def one_d(d, pos):
        omega = 1.0 / 10000.0 ** (np.arange(d // 2, dtype=np.float64)
                                  / (d // 2))
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(h, dtype=np.float32)[:, None].repeat(w, 1)
    gw = np.arange(w, dtype=np.float32)[None, :].repeat(h, 0)
    return np.concatenate([one_d(embed_dim // 2, gh),
                           one_d(embed_dim // 2, gw)],
                          axis=1).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _sincos_table(embed_dim: int, side: int,
                  device: torch.device) -> torch.Tensor:
    """``sincos_2d`` as a (side, side, E) tensor on ``device``, built once."""
    return torch.from_numpy(sincos_2d(embed_dim, side, side).reshape(
        side, side, embed_dim)).to(device)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_resampler(rcfg: ResamplerCfg, generator: torch.Generator,
                   device: torch.device | str | None = None) -> dict:
    """Random fp32 resampler with JAX's keys and shapes (the numbers
    differ) on ``device`` (``generator`` must live there too)."""
    device = default_device(device)
    e, kv = rcfg.embed_dim, rcfg.kv_dim

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def ones(n):
        return torch.ones((n,), device=device)

    def zeros(n):
        return torch.zeros((n,), device=device)

    return {
        'query': randn(rcfg.num_queries, e) * 0.02,
        'kv_proj': {'w': randn(kv, e) / math.sqrt(kv)},
        'attn': {
            'in_proj_w': randn(3 * e, e) / math.sqrt(e),
            'in_proj_b': zeros(3 * e),
            'out_proj_w': randn(e, e) / math.sqrt(e),
            'out_proj_b': zeros(e),
        },
        'ln_q': {'w': ones(e), 'b': zeros(e)},
        'ln_kv': {'w': ones(e), 'b': zeros(e)},
        'ln_post': {'w': ones(e), 'b': zeros(e)},
        'proj': randn(e, e) / math.sqrt(e),
    }


def init_siglip(vcfg: Idefics2VisionCfg, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random fp32 SigLIP tower in the tree ``idefics2.vision_forward``
    reads (JAX ``minicpmv._init_siglip``'s keys and shapes)."""
    device = default_device(device)
    d, f, p = vcfg.hidden_size, vcfg.intermediate_size, vcfg.patch_size

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def linear(n_out, n_in):
        return {'weight': randn(n_out, n_in) / math.sqrt(n_in),
                'bias': torch.zeros((n_out,), device=device)}

    def norm():
        return {'weight': torch.ones((d,), device=device),
                'bias': torch.zeros((d,), device=device)}

    layers = {str(i): {
        'layer_norm1': norm(), 'layer_norm2': norm(),
        'self_attn': {nm: linear(d, d) for nm in
                      ('q_proj', 'k_proj', 'v_proj', 'out_proj')},
        'mlp': {'fc1': linear(f, d), 'fc2': linear(d, f)},
    } for i in range(vcfg.num_hidden_layers)}
    return {
        'embeddings': {
            'patch_embedding': {
                'weight': randn(d, 3, p, p) / math.sqrt(3 * p * p),
                'bias': torch.zeros((d,), device=device)},
            'position_embedding': {
                'weight': randn(vcfg.patches_per_side ** 2, d) * 0.02},
        },
        'encoder': {'layers': layers},
        'post_layernorm': norm(),
    }


def init_params(cfg: MiniCPMVConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random fp32 tree (``llm``, ``vpm``, ``resampler``) with JAX's keys
    and shapes (the numbers differ) on ``device`` (default: the first CUDA
    device; ``generator`` must live there too)."""
    device = default_device(device)
    return {
        'llm': transformer.init_params(cfg.text, generator, device=device),
        'vpm': init_siglip(cfg.vision, generator, device=device),
        'resampler': init_resampler(cfg.resampler, generator, device=device),
    }


# ---------------------------------------------------------------------------
# the resampler and the crops
# ---------------------------------------------------------------------------

def _ln(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return _layer_norm({'weight': p['w'], 'bias': p['b']}, x, eps)


def resampler_forward(rp: dict, rcfg: ResamplerCfg, feats: torch.Tensor,
                      tgt_hw: torch.Tensor | None = None) -> torch.Tensor:
    """feats (B, N, kv_dim) -> (B, num_queries, embed_dim), in the dtype
    of ``feats``.  ``tgt_hw`` (B, 2): each crop's (h, w) patch grid, its
    patches first in the row; None: a square grid of all N patches.  A
    position past the sincos table reads its last row or column, as JAX's
    gather clamps."""
    e, h = rcfg.embed_dim, rcfg.num_heads
    hd = e // h
    b, n, _ = feats.shape
    dtype = feats.dtype
    x = _ln(rp['ln_kv'], feats @ rp['kv_proj']['w'].to(dtype), rcfg.eps)
    q = _ln(rp['ln_q'], rp['query'].to(dtype), rcfg.eps)      # (Q, E)
    side = rcfg.max_size
    table = _sincos_table(e, side, x.device)
    if tgt_hw is None:
        grid = int(round(math.sqrt(n)))
        pos = table[:grid, :grid].reshape(1, n, e)
        mask = None
    else:
        tgt = tgt_hw.long()
        idx = torch.arange(n, device=x.device)[None]
        gw = tgt[:, 1:2].clamp_min(1)
        pos = table[(idx // gw).clamp(max=side - 1),
                    (idx % gw).clamp(max=side - 1)]           # (B, N, E)
        mask = idx < tgt[:, :1] * tgt[:, 1:2]                 # (B, N)
    k_in = x + pos.to(dtype)
    at = rp['attn']
    wq, wk, wv = at['in_proj_w'].to(dtype).chunk(3, 0)
    bq, bk, bv = at['in_proj_b'].to(dtype).chunk(3, 0)
    nq = rcfg.num_queries
    qh = (q @ wq.T + bq).reshape(nq, h, hd)
    kh = (k_in @ wk.T + bk).reshape(b, n, h, hd)
    vh = (x @ wv.T + bv).reshape(b, n, h, hd)
    logits = torch.einsum('qhd,bnhd->bhqn', qh.float(),
                          kh.float()) * hd ** -0.5
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits,
                             torch.full((), MASK_FILL, device=x.device))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum('bhqn,bnhd->bqhd', probs, vh).reshape(b, nq, e)
    out = out @ at['out_proj_w'].to(dtype).T + at['out_proj_b'].to(dtype)
    out = _ln(rp['ln_post'], out, rcfg.eps)
    return out @ rp['proj'].to(dtype)


def encode_image_crops(params: dict, cfg: MiniCPMVConfig,
                       pixel_values: torch.Tensor,
                       tgt_sizes: torch.Tensor | None, dtype: torch.dtype,
                       remat: str = 'none') -> torch.Tensor:
    """The tower and the resampler over any crop layout (see the module
    docstring): (B, n_crops * num_queries, E) merge-ready embeddings, each
    row's crops in order."""
    crops_per_row = None
    if (pixel_values.ndim == 4 and tgt_sizes is not None
            and tgt_sizes.ndim == 3):
        b, crops_per_row = pixel_values.shape[:2]
        pixel_values = pixel_values.reshape(
            (b * crops_per_row,) + tuple(pixel_values.shape[2:]))
        tgt_sizes = tgt_sizes.reshape(-1, 2)
    if pixel_values.ndim == 3 and tgt_sizes is not None:
        feats = idefics2.vision_forward_packed(
            params['vpm'], cfg.vision, pixel_values.to(dtype), tgt_sizes,
            remat)
    else:
        feats = idefics2.vision_forward(params['vpm'], cfg.vision,
                                        pixel_values.to(dtype), remat)
    embeds = resampler_forward(params['resampler'], cfg.resampler, feats,
                               tgt_hw=tgt_sizes)
    if crops_per_row is not None:
        q, e = embeds.shape[1:]
        embeds = embeds.reshape(-1, crops_per_row * q, e)
    return embeds


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: MiniCPMVConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            pixel_values: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, cache=None,
            cache_offset: int = 0, need_logits: bool = True,
            tgt_sizes: torch.Tensor | None = None) -> ModelOutput:
    """The trunk over the text embeddings with each crop's query tokens
    merged over the image tokens, crop-major (a row holds ``n_valid *
    num_queries`` image tokens, so its padded crops are never read);
    text-only without ``pixel_values`` (the decode step)."""
    lm = params['llm']
    dtype = transformer.torch_dtype(cfg.text.compute_dtype)
    embeds = lm['embedding'][input_ids].to(dtype)
    if pixel_values is not None:
        image_embeds = encode_image_crops(params, cfg, pixel_values,
                                          tgt_sizes, dtype, cfg.text.remat)
        embeds = merge_image_embeds(embeds, image_embeds, input_ids,
                                    cfg.image_token_id)
    return transformer.forward(lm, cfg.text, input_ids,
                               attention_mask=attention_mask,
                               positions=positions, cache=cache,
                               cache_offset=cache_offset,
                               need_logits=need_logits,
                               inputs_embeds=embeds)


def token_logprobs(params: dict, cfg: MiniCPMVConfig,
                   input_ids: torch.Tensor,
                   attention_mask: torch.Tensor | None = None,
                   pixel_values: torch.Tensor | None = None,
                   chunk_size: int = 256, **mm_kw: Any) -> torch.Tensor:
    """(B, L-1) log-probs of each next token; ``mm_kw`` carries the
    batch's ``tgt_sizes`` to ``forward``."""
    out = forward(params, cfg, input_ids, attention_mask=attention_mask,
                  pixel_values=pixel_values, need_logits=False, **mm_kw)
    lm = params['llm']
    hidden = out.last_hidden_state
    head = (lm['embedding'].T if cfg.text.tie_word_embeddings
            else lm['lm_head']).to(hidden.dtype)
    return hidden_to_token_logprobs(
        hidden[:, :-1], head, input_ids[:, 1:], chunk_size=chunk_size,
        softcap=cfg.text.final_logit_softcap,
        true_vocab=cfg.text.true_vocab_size)


def decode_forward(params: dict, cfg: MiniCPMVConfig,
                   input_ids: torch.Tensor, **kw: Any) -> ModelOutput:
    """Text-only decode step over the ``llm`` trunk."""
    return transformer.forward(params['llm'], cfg.text, input_ids, **kw)
