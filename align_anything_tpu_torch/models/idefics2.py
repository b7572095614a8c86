"""Idefics2: the port of ``align_anything_tpu/models/idefics2.py``
(reference: models/idefics2.py wraps HF Idefics2ForConditionalGeneration).

- A SigLIP tower over fixed square images (``vision_forward``: the
  stride-14 conv) or over NaViT-packed patches (``vision_forward_packed``:
  each image's patch grid flattened row-major on the host, valid patches
  first; the bucketized position ids of ``navit_position_ids`` and a patch
  mask over the padded slots).
- The connector (``connector_forward``): a gated-MLP modality projection,
  then a perceiver resampler whose learned latents attend (GQA) to the
  context concatenated with the latents; padded patches are masked out of
  the keys, the latents always see each other.
- The latents merged over the ``<image>`` span
  (``multimodal.merge_image_embeds``) of a Mistral-class trunk, the
  decoder of ``models/transformer.py``, which runs the flash-attention
  kernel in training.

Numerics as JAX's: the tower and the connector compute in the dtype of
their params (JAX promotes the activations to the fp32 weights; so does
``_linear``), and only the latents are cast to the compute dtype before
the merge.  The tower's attention (head dim 72) and the perceiver's (96)
are plain PyTorch, as JAX's are ``xla_attention``: the flash kernel has no
D 72 or D 96 path.  The tower's attention runs in query chunks
(``ops/attention.py`` ``chunked_masked_attention``, a key mask: ``q_gate``
all ones): at 4900 slots its fp32 logits take 1.5 GB a row and layer at
once; chunked, a chunk's at a time, and its backward recomputes each
chunk.  The tower's layers take the trunk's remat policy
when gradients are recorded (JAX's tower has none); the result is the
same function.

``forward`` takes ``cache`` / ``cache_offset``, so it is both the prefill
and the decode step of ``generate`` (``media={'tgt_sizes': ...}``).
``token_logprobs`` takes the batch's ``tgt_sizes``, which JAX's does not
(ROADMAP §3 R35).

The tree keeps JAX's keys: ``language_model`` (the decoder's tree) and
``vision_model`` / ``connector`` nested by HF module path, in torch's
Linear layout (``x @ weight.T``), their layers keyed by index strings.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any

import torch
import torch.nn.functional as F

from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.models.multimodal import merge_image_embeds
from align_anything_tpu_torch.models.transformer import ModelOutput
from align_anything_tpu_torch.ops.attention import (
    chunked_masked_attention, xla_attention)
from align_anything_tpu_torch.ops.logprobs import hidden_to_token_logprobs
from align_anything_tpu_torch.ops.norms import layer_norm, rms_norm
from align_anything_tpu_torch.utils.tools import default_device


@dataclasses.dataclass(frozen=True)
class Idefics2VisionCfg:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 980
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class Idefics2PerceiverCfg:
    resampler_n_latents: int = 64
    resampler_depth: int = 3
    resampler_n_heads: int = 16
    resampler_head_dim: int = 96
    num_key_value_heads: int = 4
    rms_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class Idefics2Config:
    text: ModelConfig
    vision: Idefics2VisionCfg
    perceiver: Idefics2PerceiverCfg
    image_token_id: int = 32001

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

    def replace(self, **kw) -> 'Idefics2Config':
        """Text fields go to ``text``, the rest to this config."""
        text_fields = {f.name for f in dataclasses.fields(ModelConfig)}
        text_kw = {k: v for k, v in kw.items() if k in text_fields}
        own_kw = {k: v for k, v in kw.items() if k not in text_fields}
        return dataclasses.replace(self, text=self.text.replace(**text_kw),
                                   **own_kw)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` in the promoted dtype of ``x`` and the
    weight, as JAX promotes."""
    w = p['weight']
    dt = torch.promote_types(x.dtype, w.dtype)
    out = x.to(dt) @ w.to(dt).T
    if 'bias' in p:
        out = out + p['bias'].to(dt)
    return out


def _layer_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return layer_norm(x, p['weight'], p['bias'], eps=eps)


def _rms_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return rms_norm(x, p['weight'], eps=eps)


def _gated_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Idefics2MLP: silu-gated gate / up / down, no biases."""
    return _linear(p['down_proj'], F.silu(_linear(p['gate_proj'], x))
                   * _linear(p['up_proj'], x))


def patch_mask(tgt_hw: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) bool: the slots of each row's (h, w) patch grid (at least
    one slot a row)."""
    gh = tgt_hw[:, :1].long().clamp_min(1)
    gw = tgt_hw[:, 1:2].long().clamp_min(1)
    return torch.arange(n, device=tgt_hw.device)[None] < gh * gw


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

def _vision_layer(vcfg: Idefics2VisionCfg, lp: dict, x: torch.Tensor,
                  q_gate: torch.Tensor, k_invalid: torch.Tensor
                  ) -> torch.Tensor:
    """A pre-norm SigLIP layer (tanh GELU)."""
    b, n, _ = x.shape
    h = vcfg.num_attention_heads
    hd = vcfg.hidden_size // h
    eps = vcfg.layer_norm_eps
    y = _layer_norm(lp['layer_norm1'], x, eps)
    sa = lp['self_attn']
    q, k, v = (_linear(sa[name], y).reshape(b, n, h, hd)
               for name in ('q_proj', 'k_proj', 'v_proj'))
    attn = chunked_masked_attention(q, k, v, q_gate, k_invalid).reshape(
        b, n, -1)
    x = x + _linear(sa['out_proj'], attn)
    y = _layer_norm(lp['layer_norm2'], x, eps)
    y = _linear(lp['mlp']['fc2'], F.gelu(_linear(lp['mlp']['fc1'], y),
                                         approximate='tanh'))
    return x + y


def _vision_encoder(params: dict, vcfg: Idefics2VisionCfg, x: torch.Tensor,
                    mask: torch.Tensor | None = None,
                    remat: str = 'none') -> torch.Tensor:
    """The SigLIP encoder stack over embedded patches (B, N, D); ``mask``
    (B, N) hides padded patch slots from every layer's keys."""
    q_gate = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    k_invalid = (1.0 - mask.float() if mask is not None else
                 torch.zeros_like(q_gate))
    up_shape = (vcfg.hidden_size, vcfg.intermediate_size)
    layers = params['encoder']['layers']
    for i in range(vcfg.num_hidden_layers):
        x = transformer.layer_call(remat, up_shape, _vision_layer, vcfg,
                                   layers[str(i)], x, q_gate, k_invalid)
    return _layer_norm(params['post_layernorm'], x, vcfg.layer_norm_eps)


def vision_forward(params: dict, vcfg: Idefics2VisionCfg,
                   pixel_values: torch.Tensor,
                   remat: str = 'none') -> torch.Tensor:
    """(B, 3, H, W) fixed-square images -> (B, N, hidden) patch features
    (the full patch grid: identity position ids)."""
    emb = params['embeddings']
    w = emb['patch_embedding']['weight']
    dt = torch.promote_types(pixel_values.dtype, w.dtype)
    x = F.conv2d(pixel_values.to(dt), w.to(dt), stride=vcfg.patch_size)
    x = x + emb['patch_embedding']['bias'].to(dt)[None, :, None, None]
    b, d = x.shape[:2]
    x = x.reshape(b, d, -1).transpose(1, 2)               # (B, N, D)
    x = x + emb['position_embedding']['weight'][:x.shape[1]][None]
    return _vision_encoder(params, vcfg, x, remat=remat)


def navit_position_ids(tgt_hw: torch.Tensor, n: int,
                       side: int) -> torch.Tensor:
    """NaViT bucketized position ids for a packed row-major (h, w) patch
    grid: the fractional coordinate r / h bucketized over ``side`` uniform
    buckets, floor(r * side / h).  tgt_hw (B, 2) patch grids -> (B, n) ids
    into the square ``side ** 2`` position table."""
    idx = torch.arange(n, device=tgt_hw.device)[None]
    gh = tgt_hw[:, :1].long().clamp_min(1)
    gw = tgt_hw[:, 1:2].long().clamp_min(1)
    rows, cols = idx // gw, idx % gw
    return (rows * side) // gh * side + (cols * side) // gw


def vision_forward_packed(params: dict, vcfg: Idefics2VisionCfg,
                          patches: torch.Tensor, tgt_hw: torch.Tensor,
                          remat: str = 'none') -> torch.Tensor:
    """The tower over host-packed patches (B, L, 3*p*p): each row's (h, w)
    grid flattened row-major, valid patches first, every patch flattened
    channel-major as the conv's OIHW kernel, so ``patches @ W_flat.T`` is
    the stride-p conv; tgt_hw (B, 2) the grids.  Padded slots are masked
    out of every attention layer (the connector masks them too)."""
    emb = params['embeddings']
    w = emb['patch_embedding']['weight']
    x = _linear({'weight': w.reshape(w.shape[0], -1),
                 'bias': emb['patch_embedding']['bias']}, patches)
    n = x.shape[1]
    table = emb['position_embedding']['weight']
    side = int(round(math.sqrt(table.shape[0])))
    # a padded slot's id runs past the table; JAX's gather clamps it
    ids = navit_position_ids(tgt_hw, n, side).clamp(max=table.shape[0] - 1)
    x = x + table[ids]
    return _vision_encoder(params, vcfg, x, mask=patch_mask(tgt_hw, n),
                           remat=remat)


# ---------------------------------------------------------------------------
# the connector
# ---------------------------------------------------------------------------

def connector_forward(params: dict, pcfg: Idefics2PerceiverCfg,
                      features: torch.Tensor, eps_text: float,
                      patch_mask: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Patch features (B, N, vision_d) -> (B, n_latents, text_d): the
    gated-MLP modality projection, then the perceiver resampler (queries:
    the learned latents; keys and values: the context concatenated with
    the latents).  ``patch_mask`` (B, N) hides padded slots from the
    context keys; the latents always see each other.  ``eps_text`` is
    unused, as in JAX (the perceiver's norms take its own eps)."""
    x = _gated_mlp(params['modality_projection'], features)
    pr = params['perceiver_resampler']
    b = x.shape[0]
    eps = pcfg.rms_norm_eps
    n_lat = pcfg.resampler_n_latents
    key_mask = None
    if patch_mask is not None:
        key_mask = torch.cat(
            [patch_mask.to(torch.bool),
             torch.ones((b, n_lat), dtype=torch.bool, device=x.device)], 1)
    latents = pr['latents'][None].expand(b, *pr['latents'].shape)
    h, kh, hd = (pcfg.resampler_n_heads, pcfg.num_key_value_heads,
                 pcfg.resampler_head_dim)
    for i in range(pcfg.resampler_depth):
        lp = pr['layers'][str(i)]
        lat = _rms_norm(lp['input_latents_norm'], latents, eps)
        ctx = _rms_norm(lp['input_context_norm'], x, eps)
        both = torch.cat([ctx, lat], dim=1)
        sa = lp['self_attn']
        q = _linear(sa['q_proj'], lat).reshape(b, n_lat, h, hd)
        k = _linear(sa['k_proj'], both).reshape(b, -1, kh, hd)
        v = _linear(sa['v_proj'], both).reshape(b, -1, kh, hd)
        attn = xla_attention(q, k, v, attention_mask=key_mask,
                             causal=False).reshape(b, n_lat, -1)
        latents = latents + _linear(sa['o_proj'], attn)
        lat = _rms_norm(lp['post_attention_layernorm'], latents, eps)
        latents = latents + _gated_mlp(lp['mlp'], lat)
    return _rms_norm(pr['norm'], latents, eps)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: Idefics2Config, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            pixel_values: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, cache=None,
            cache_offset: int = 0, need_logits: bool = True,
            tgt_sizes: torch.Tensor | None = None) -> ModelOutput:
    """The trunk over the text embeddings with the image latents merged
    over the image tokens; text-only without ``pixel_values`` (the decode
    step).  ``pixel_values`` is (B, 3, H, W) fixed-square images or, with
    ``tgt_sizes`` (B, 2), (B, L, 3*p*p) NaViT-packed patches."""
    lm = params['language_model']
    dtype = transformer.torch_dtype(cfg.text.compute_dtype)
    embeds = lm['embedding'][input_ids].to(dtype)
    if pixel_values is not None:
        remat, mask = cfg.text.remat, None
        if pixel_values.ndim == 3 and tgt_sizes is not None:
            feats = vision_forward_packed(params['vision_model'], cfg.vision,
                                          pixel_values, tgt_sizes, remat)
            mask = patch_mask(tgt_sizes, feats.shape[1])
        else:
            feats = vision_forward(params['vision_model'], cfg.vision,
                                   pixel_values, remat)
        latents = connector_forward(params['connector'], cfg.perceiver,
                                    feats, cfg.text.norm_eps,
                                    patch_mask=mask)
        embeds = merge_image_embeds(embeds, latents.to(dtype), input_ids,
                                    cfg.image_token_id)
    return transformer.forward(lm, cfg.text, input_ids,
                               attention_mask=attention_mask,
                               positions=positions, cache=cache,
                               cache_offset=cache_offset,
                               need_logits=need_logits,
                               inputs_embeds=embeds)


def token_logprobs(params: dict, cfg: Idefics2Config,
                   input_ids: torch.Tensor,
                   attention_mask: torch.Tensor | None = None,
                   pixel_values: torch.Tensor | None = None,
                   chunk_size: int = 256, **mm_kw) -> torch.Tensor:
    """(B, L-1) log-probs of each next token; ``mm_kw`` carries the
    batch's ``tgt_sizes`` to ``forward`` (JAX's takes none and its DPO
    family fails: ROADMAP §3 R35)."""
    out = forward(params, cfg, input_ids, attention_mask=attention_mask,
                  pixel_values=pixel_values, need_logits=False, **mm_kw)
    lm = params['language_model']
    hidden = out.last_hidden_state
    head = (lm['embedding'].T if cfg.text.tie_word_embeddings
            else lm['lm_head']).to(hidden.dtype)
    return hidden_to_token_logprobs(
        hidden[:, :-1], head, input_ids[:, 1:], chunk_size=chunk_size,
        true_vocab=cfg.text.true_vocab_size)


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def _config_from_hf(hf: dict) -> Idefics2Config:
    """The Idefics2Config of an HF ``config.json`` dict, as JAX's loader
    reads it (the Mistral ``sliding_window`` is not read: ROADMAP §3
    R38)."""
    tc, vc, pc = (hf['text_config'], hf['vision_config'],
                  hf.get('perceiver_config', {}))
    text_cfg = ModelConfig(
        vocab_size=tc['vocab_size'], hidden_size=tc['hidden_size'],
        num_layers=tc['num_hidden_layers'],
        num_heads=tc['num_attention_heads'],
        num_kv_heads=tc.get('num_key_value_heads',
                            tc['num_attention_heads']),
        head_dim=tc['hidden_size'] // tc['num_attention_heads'],
        mlp_dim=tc['intermediate_size'],
        max_position_embeddings=tc.get('max_position_embeddings', 4096),
        rope_theta=tc.get('rope_theta', 10000.0),
        norm_eps=tc.get('rms_norm_eps', 1e-6),
        tie_word_embeddings=hf.get('tie_word_embeddings', False),
        bos_token_id=tc.get('bos_token_id', 1) or 1,
        eos_token_id=tc.get('eos_token_id', 2) or 2,
        pad_token_id=tc.get('pad_token_id') or 0,
    )
    vcfg = Idefics2VisionCfg(
        hidden_size=vc['hidden_size'],
        intermediate_size=vc['intermediate_size'],
        num_hidden_layers=vc['num_hidden_layers'],
        num_attention_heads=vc['num_attention_heads'],
        image_size=vc.get('image_size', 980),
        patch_size=vc.get('patch_size', 14),
        layer_norm_eps=vc.get('layer_norm_eps', 1e-6))
    pcfg = Idefics2PerceiverCfg(
        resampler_n_latents=pc.get('resampler_n_latents', 64),
        resampler_depth=pc.get('resampler_depth', 3),
        resampler_n_heads=pc.get('resampler_n_heads', 16),
        resampler_head_dim=pc.get('resampler_head_dim', 96),
        num_key_value_heads=pc.get('num_key_value_heads', 4),
        rms_norm_eps=pc.get('rms_norm_eps', 1e-6))
    return Idefics2Config(text=text_cfg, vision=vcfg, perceiver=pcfg,
                          image_token_id=hf.get('image_token_id', 32001))


def load_idefics2_params(path: str, dtype: torch.dtype = torch.float32,
                         device: torch.device | str | None = None
                         ) -> tuple[dict, Idefics2Config]:
    """Load an HF Idefics2 checkpoint directory into (params,
    Idefics2Config), every leaf on ``device`` (default: the first CUDA
    device) in ``dtype``: ``model.text_model.*`` and ``lm_head.weight``
    become the decoder's tree, every other ``model.*`` tensor is nested by
    its module path as it is."""
    from align_anything_tpu_torch.models import hf_loader  # noqa: PLC0415

    device = default_device(device)
    with open(os.path.join(path, 'config.json')) as f:
        cfg = _config_from_hf(json.load(f))
    text_flat: dict[str, torch.Tensor] = {}
    tree: dict[str, Any] = {}
    for key, t in hf_loader._read_all_tensors(path).items():
        if key.startswith('model.text_model.'):
            text_flat['model.' + key[len('model.text_model.'):]] = t
        elif key == 'lm_head.weight':
            text_flat[key] = t
        elif key.startswith('model.'):
            node = tree
            *parents, leaf = key[len('model.'):].split('.')
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = t.to(device=device, dtype=dtype, copy=True)
    text = hf_loader._load_llama_like(
        hf_loader._OnDevice(text_flat, device, dtype), cfg.text)
    return {'language_model': text, 'vision_model': tree['vision_model'],
            'connector': tree['connector']}, cfg
