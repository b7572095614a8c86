"""Mllama (Llama-3.2-Vision): the port of
``align_anything_tpu/models/mllama.py`` (reference: models/mllama.py wraps
HF MllamaForConditionalGeneration).

- A two-stage tiled vision encoder: a local transformer over each row's
  tiles, then a tanh-gated global transformer, with gated positional and
  aspect-ratio tile embeddings and five intermediate layer taps
  concatenated into the output feature (modeling_mllama.py
  MllamaVisionModel).
- A Llama text trunk whose ``cross_attention_layers`` are tanh-gated
  CROSS-attention blocks (q/k RMSNorm, no rope) over the projected vision
  features (MllamaCrossAttentionDecoderLayer).  The image enters the text
  through these layers only, not by an embedding merge: ``<|image|>`` is
  one token, and the rows from it onward see the image's valid tiles.

The self-attention layers are ``transformer._decoder_layer``, so they run
the flash-attention kernel (``ops/flash_attention.py``) in training and the
cache paths of the decoder in generation.  The tower's attention (head dim
80, an additive bias) and the cross-attention are plain PyTorch, as JAX
computes them in plain ``jnp``.  The tower's attention runs in query
chunks (``ops/attention.py`` ``chunked_masked_attention``, whose bias
``q_gate`` x ``k_invalid`` is the both-invalid bias with both set to the
invalid mask): at 4 tiles of 1608 patches its fp32 logits would take
2.65 GB a row and layer at once; chunked, a chunk's at a time, and its
backward recomputes each chunk.  The result is the same function.

The tree keeps the JAX package's keys and its lists of per-layer dicts
(``vision_model.local_layers`` / ``global_layers``,
``language_model.layers``, where self and cross layers hold different
leaves).  The embedding has 8 rows past the vocab; the image token
(128256) indexes the first of them.

Oddities copied for checkpoint parity: the tower's bias is ``-inf`` only
where query AND key are both invalid (HF builds it as an outer product of
the inverted validity mask), so valid queries attend to the keys of
padding tiles and patches; so the patch axis padding to a multiple of 8
matters and is copied.

Generation: ``init_cache`` is the self-attention layers' (K, V) cache, and
the prefill ``forward(cache=...)`` adds the cross K/V, which stay fixed for
the whole generation, and the last prompt row's cross bias;
``decode_forward`` is the step (``generate(..., init_cache_fn=init_cache,
prefill_forward=forward, step_forward=decode_forward)``).
"""

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.models.transformer import ModelOutput
from align_anything_tpu_torch.ops.attention import chunked_masked_attention
from align_anything_tpu_torch.ops.logprobs import hidden_to_token_logprobs
from align_anything_tpu_torch.ops.norms import layer_norm
from align_anything_tpu_torch.ops.rope import rope_table
from align_anything_tpu_torch.utils.tools import default_device

FP32_MIN = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class MllamaVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_global_layers: int = 8
    num_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    max_num_tiles: int = 4
    max_aspect_ratio_id: int = 8
    intermediate_layers_indices: tuple[int, ...] = (3, 7, 15, 23, 30)
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        """Per-tile patch count incl. the class token."""
        return (self.image_size // self.patch_size) ** 2 + 1

    @property
    def output_dim(self) -> int:
        return self.hidden_size * (1 + len(self.intermediate_layers_indices))


@dataclasses.dataclass(frozen=True)
class MllamaConfig:
    text: ModelConfig
    vision: MllamaVisionConfig
    cross_attention_layers: tuple[int, ...]
    image_token_id: int = 128256

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

    def replace(self, **kw) -> 'MllamaConfig':
        text_fields = {f.name for f in dataclasses.fields(ModelConfig)}
        text_kw = {k: v for k, v in kw.items() if k in text_fields}
        own_kw = {k: v for k, v in kw.items() if k not in text_fields}
        return dataclasses.replace(self, text=self.text.replace(**text_kw),
                                   **own_kw)


def check_supported(cfg: MllamaConfig) -> None:
    """Raise for the text-decoder options the port does not run yet, and
    for MoE: the JAX trunk builds dense MLP leaves and its self layers then
    fail to find the router (``KeyError``), so the port refuses it."""
    transformer.check_supported(cfg.text)
    if cfg.text.num_experts:
        raise NotImplementedError('Mllama with an MoE text decoder '
                                  '(num_experts) fails in the JAX package')


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: MllamaConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random fp32 tree with the JAX package's keys and shapes (the numbers
    differ) on ``device`` (default: the first CUDA device; ``generator``
    must live there too)."""
    device = default_device(device)
    check_supported(cfg)
    vc, tc = cfg.vision, cfg.text
    d, p1, mt, a = (vc.hidden_size, vc.num_patches, vc.max_num_tiles,
                    vc.max_aspect_ratio_id)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def dense(*shape, fan_in):
        return randn(*shape) / math.sqrt(fan_in)

    def ones(*shape):
        return torch.ones(shape, device=device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def vision_layer(gated: bool) -> dict:
        f = vc.intermediate_size
        lp: dict[str, Any] = {
            'norm1': {'w': ones(d), 'b': zeros(d)},
            'q': {'w': dense(d, d, fan_in=d)},
            'k': {'w': dense(d, d, fan_in=d)},
            'v': {'w': dense(d, d, fan_in=d)},
            'o': {'w': dense(d, d, fan_in=d)},
            'norm2': {'w': ones(d), 'b': zeros(d)},
            'fc1': {'w': dense(d, f, fan_in=d), 'b': zeros(f)},
            'fc2': {'w': dense(f, d, fan_in=f), 'b': zeros(d)},
        }
        if gated:
            lp['gate_attn'] = torch.full((1,), math.pi / 4, device=device)
            lp['gate_ffn'] = torch.full((1,), math.pi / 4, device=device)
        return lp

    def text_layer(cross: bool) -> dict:
        e, h, kh, hd, f = (tc.hidden_size, tc.num_heads, tc.num_kv_heads,
                           tc.head_dim, tc.mlp_dim)
        lp: dict[str, Any] = {
            'attn_norm': {'w': ones(e)},
            'q': {'w': dense(e, h, hd, fan_in=e)},
            'k': {'w': dense(e, kh, hd, fan_in=e)},
            'v': {'w': dense(e, kh, hd, fan_in=e)},
            'o': {'w': dense(h, hd, e, fan_in=h * hd)},
            'mlp_norm': {'w': ones(e)},
            'gate': {'w': dense(e, f, fan_in=e)},
            'up': {'w': dense(e, f, fan_in=e)},
            'down': {'w': dense(f, e, fan_in=f)},
        }
        if cross:
            lp['q_norm'] = {'w': ones(hd)}
            lp['k_norm'] = {'w': ones(hd)}
            lp['attn_gate'] = zeros(1)
            lp['mlp_gate'] = zeros(1)
        return lp

    patch_dim = 3 * vc.patch_size ** 2
    vision = {
        'patch_embed': {'w': dense(patch_dim, d, fan_in=patch_dim)},
        'class_embedding': randn(d) * d ** -0.5,
        'pos_embed': {'gate': zeros(1),
                      'embedding': randn(p1, d) * d ** -0.5,
                      'tile': randn(a + 1, mt * p1 * d) * 0.02},
        'pre_tile': {'gate': zeros(1),
                     'embedding': randn(a + 1, mt * d) * 0.02},
        'post_tile': {'gate': zeros(1),
                      'embedding': randn(a + 1, mt * d) * 0.02},
        'ln_pre': {'w': ones(d), 'b': zeros(d)},
        'ln_post': {'w': ones(d), 'b': zeros(d)},
        'local_layers': [vision_layer(False) for _ in range(vc.num_layers)],
        'global_layers': [vision_layer(True)
                          for _ in range(vc.num_global_layers)],
    }
    lm = {
        # +8 extra embedding rows (HF MllamaTextModel: vocab_size + 8); the
        # image token (128256) indexes the first extra row
        'embedding': randn(tc.vocab_size + 8, tc.hidden_size) * 0.02,
        'layers': [text_layer(i in cfg.cross_attention_layers)
                   for i in range(tc.num_layers)],
        'final_norm': {'w': ones(tc.hidden_size)},
        'lm_head': dense(tc.hidden_size, tc.vocab_size,
                         fan_in=tc.hidden_size),
    }
    projector = {'w': dense(vc.output_dim, tc.hidden_size,
                            fan_in=vc.output_dim),
                 'b': zeros(tc.hidden_size)}
    return {'vision_model': vision, 'language_model': lm,
            'projector': projector}


# ---------------------------------------------------------------------------
# vision
# ---------------------------------------------------------------------------

def _vision_layer(vcfg: MllamaVisionConfig, lp: dict, x: torch.Tensor,
                  invalid: torch.Tensor) -> torch.Tensor:
    """A pre-norm tower layer (exact GELU); the global layers' attention
    and MLP outputs are scaled by tanh of their gates."""
    dtype = x.dtype
    gated = 'gate_attn' in lp
    b, s, d = x.shape
    h = layer_norm(x, lp['norm1']['w'], lp['norm1']['b'], eps=vcfg.norm_eps)
    q, k, v = (torch.einsum('bsd,de->bse', h, lp[n]['w'].to(dtype))
               .reshape(b, s, vcfg.num_heads, vcfg.head_dim)
               for n in ('q', 'k', 'v'))
    attn = chunked_masked_attention(q, k, v, invalid, invalid).reshape(
        b, s, d)
    attn = torch.einsum('bse,ed->bsd', attn, lp['o']['w'].to(dtype))
    if gated:
        attn = torch.tanh(lp['gate_attn'].to(dtype)) * attn
    x = x + attn
    h = layer_norm(x, lp['norm2']['w'], lp['norm2']['b'], eps=vcfg.norm_eps)
    up = (torch.einsum('bsd,df->bsf', h, lp['fc1']['w'].to(dtype))
          + lp['fc1']['b'].to(dtype))
    up = F.gelu(up)
    down = (torch.einsum('bsf,fd->bsd', up, lp['fc2']['w'].to(dtype))
            + lp['fc2']['b'].to(dtype))
    if gated:
        down = torch.tanh(lp['gate_ffn'].to(dtype)) * down
    return x + down


def vision_forward(params: dict, vcfg: MllamaVisionConfig,
                   pixel_values: torch.Tensor,
                   aspect_ratio_ids: torch.Tensor,
                   aspect_ratio_mask: torch.Tensor,
                   compute_dtype: str | torch.dtype = 'float32',
                   remat: str = 'none') -> torch.Tensor:
    """pixel_values (B, media, tiles, C, H, W); aspect_ratio_ids (B,
    media); aspect_ratio_mask (B, media, tiles) -> (B, media, tiles,
    num_patches, output_dim).  ``remat``: the layers under that policy
    when gradients are recorded."""
    vp = params
    dtype = (transformer.torch_dtype(compute_dtype)
             if isinstance(compute_dtype, str) else compute_dtype)
    b, media, mt, c, hh, ww = pixel_values.shape
    p = vcfg.patch_size
    gh, gw = hh // p, ww // p
    d = vcfg.hidden_size
    bm = b * media
    up_shape = (d, vcfg.intermediate_size)

    # the conv patch embedding as unfold + matmul (no bias)
    x = pixel_values.reshape(bm * mt, c, gh, p, gw, p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(bm * mt, gh * gw, c * p * p)
    x = torch.einsum('tnp,pd->tnd', x.to(dtype),
                     vp['patch_embed']['w'].to(dtype))

    ar_ids = aspect_ratio_ids.reshape(bm).long()
    # the pre-tile gated aspect-ratio embedding
    pre = vp['pre_tile']['embedding'][ar_ids].reshape(bm, mt, 1, d)
    x = x.reshape(bm, mt, gh * gw, d) \
        + (pre * torch.tanh(vp['pre_tile']['gate'])).to(dtype)

    # the class token
    cls = vp['class_embedding'].to(dtype).expand(bm, mt, 1, d)
    x = torch.cat([cls, x], dim=2)
    p1 = gh * gw + 1

    # the gated positional + tile-positional embedding
    g = torch.tanh(vp['pos_embed']['gate'])
    x = x + ((1 - g) * vp['pos_embed']['embedding']).to(dtype)
    tile_pos = vp['pos_embed']['tile'][ar_ids].reshape(bm, mt, p1, d)
    x = x + (g * tile_pos).to(dtype)

    x = layer_norm(x, vp['ln_pre']['w'], vp['ln_pre']['b'], eps=1e-5)

    # the patch axis padded to a multiple of 8 (HF does; the padded rows
    # reach valid queries' softmax through the outer-product bias)
    pad = (8 - p1 % 8) % 8
    pp = p1 + pad
    if pad:
        x = F.pad(x, (0, 0, 0, pad))

    # validity: the tile valid AND the patch < p1
    valid = (aspect_ratio_mask.reshape(bm, mt, 1).to(torch.bool)
             & (torch.arange(pp, device=x.device) < p1)[None, None])
    invalid = 1.0 - valid.reshape(bm, mt * pp).float()

    x = x.reshape(bm, mt * pp, d)
    taps = []
    for i, lp in enumerate(vp['local_layers']):
        x = transformer.layer_call(remat, up_shape, _vision_layer, vcfg,
                                   lp, x, invalid)
        if i in vcfg.intermediate_layers_indices:
            taps.append(x)

    x = layer_norm(x, vp['ln_post']['w'], vp['ln_post']['b'], eps=1e-5)

    # the post-tile embedding + the global transformer
    post = vp['post_tile']['embedding'][ar_ids].reshape(bm, mt, 1, d)
    x = x.reshape(bm, mt, pp, d) \
        + (post * torch.tanh(vp['post_tile']['gate'])).to(dtype)
    x = x.reshape(bm, mt * pp, d)
    for lp in vp['global_layers']:
        x = transformer.layer_call(remat, up_shape, _vision_layer, vcfg,
                                   lp, x, invalid)

    x = x.reshape(bm, mt, pp, d)[:, :, :p1]
    inter = torch.stack(taps, dim=-1)                     # (bm, S, d, K)
    inter = inter.reshape(bm, mt, pp, d * len(taps))[:, :, :p1]
    out = torch.cat([x, inter], dim=-1)
    return out.reshape(b, media, mt, p1, vcfg.output_dim)


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

def _head_rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * w.float()).to(dtype)


def _cross_kv(c: ModelConfig, lp: dict, cross_states: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The vision states projected to this layer's cross K/V (B, S, KH,
    D); computed once per generation (the vision sequence does not grow)
    and kept in the decode cache."""
    dtype = cross_states.dtype
    k = torch.einsum('bse,ehd->bshd', cross_states, lp['k']['w'].to(dtype))
    k = _head_rms(k, lp['k_norm']['w'], c.norm_eps)
    v = torch.einsum('bse,ehd->bshd', cross_states, lp['v']['w'].to(dtype))
    return k, v


def _cross_layer(c: ModelConfig, lp: dict, x: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, cross_bias: torch.Tensor,
                 full_row: torch.Tensor) -> torch.Tensor:
    """The tanh-gated cross-attention block
    (MllamaCrossAttentionDecoderLayer).  x (B, L, E); k, v (B, S, KH, D)
    from ``_cross_kv``; cross_bias (B, 1, L, S) additive; full_row (B, L,
    1) zeroes the MLP of rows that see no image."""
    dtype = x.dtype
    kh, h, d = c.num_kv_heads, c.num_heads, c.head_dim
    b, l = x.shape[:2]
    hidden = _head_rms(x.float(), lp['attn_norm']['w'], c.norm_eps).to(dtype)
    q = torch.einsum('ble,ehd->blhd', hidden, lp['q']['w'].to(dtype))
    q = _head_rms(q, lp['q_norm']['w'], c.norm_eps)
    qg = q.reshape(b, l, kh, h // kh, d)
    logits = torch.einsum('blkgd,bskd->bkgls', qg.float(), k.float()) \
        * d ** -0.5
    logits = logits + cross_bias[:, :, None]          # (B, KH, G, L, S)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    attn = torch.einsum('bkgls,bskd->blkgd', probs, v.to(dtype))
    attn = attn.reshape(b, l, h, d)
    out = torch.einsum('blhd,hde->ble', attn, lp['o']['w'].to(dtype))
    x = x + torch.tanh(lp['attn_gate'].to(dtype)) * out

    hidden = _head_rms(x.float(), lp['mlp_norm']['w'], c.norm_eps).to(dtype)
    gate = torch.einsum('ble,ef->blf', hidden, lp['gate']['w'].to(dtype))
    up = torch.einsum('ble,ef->blf', hidden, lp['up']['w'].to(dtype))
    down = torch.einsum('blf,fe->ble', F.silu(gate) * up,
                        lp['down']['w'].to(dtype))
    down = down * full_row.to(dtype)
    return x + torch.tanh(lp['mlp_gate'].to(dtype)) * down


def _cross_block(c: ModelConfig, lp: dict, x: torch.Tensor,
                 cross_states: torch.Tensor, cross_bias: torch.Tensor,
                 full_row: torch.Tensor) -> torch.Tensor:
    """``_cross_kv`` then ``_cross_layer``: one cross layer of a training
    or scoring pass, in one function for the remat policy."""
    k, v = _cross_kv(c, lp, cross_states)
    return _cross_layer(c, lp, x, k, v, cross_bias, full_row)


def prepare_cross_attention_mask(cross_attention_mask: torch.Tensor,
                                 num_vision_tokens: int
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L, media, tiles) 0/1 -> the additive bias (B, 1, L, S) over the
    flattened vision sequence and the full-row mask (B, L, 1)
    (modeling_mllama.py _prepare_cross_attention_mask)."""
    b, l = cross_attention_mask.shape[:2]
    m = cross_attention_mask.repeat_interleave(num_vision_tokens, dim=3)
    m = m.reshape(b, l, -1)
    bias = (1.0 - m.float()) * FP32_MIN
    full_row = (bias != FP32_MIN).any(-1)
    bias = bias * full_row[..., None]
    return bias[:, None], full_row[..., None].float()


def default_cross_attention_mask(cfg: MllamaConfig,
                                 input_ids: torch.Tensor,
                                 aspect_ratio_mask: torch.Tensor
                                 ) -> torch.Tensor:
    """HF processor semantics for one-image rows: every token from the
    ``<|image|>`` token onward attends to that image's valid tiles
    (processing_mllama.py get_cross_attention_token_mask): (B, L, media,
    tiles) int32 from ``aspect_ratio_mask`` (B, media, tiles)."""
    l = input_ids.shape[1]
    is_img = input_ids == cfg.image_token_id
    has = is_img.any(-1)
    start = torch.argmax(is_img.to(torch.int32), dim=-1)
    attend = ((torch.arange(l, device=input_ids.device)[None]
               >= start[:, None]) & has[:, None])           # (B, L)
    return (attend[:, :, None, None]
            & (aspect_ratio_mask[:, None] > 0)).to(torch.int32)


def image_features(params: dict, cfg: MllamaConfig,
                   pixel_values: torch.Tensor,
                   aspect_ratio_ids: torch.Tensor,
                   aspect_ratio_mask: torch.Tensor,
                   dtype: torch.dtype, remat: str = 'none') -> torch.Tensor:
    """The projected tower output, flattened to the cross states (B,
    media * tiles * num_patches, hidden)."""
    feats = vision_forward(params['vision_model'], cfg.vision, pixel_values,
                           aspect_ratio_ids, aspect_ratio_mask,
                           compute_dtype=dtype, remat=remat)
    proj = params['projector']
    feats = (torch.einsum('bmtpe,ef->bmtpf', feats, proj['w'].to(dtype))
             + proj['b'].to(dtype))
    return feats.reshape(pixel_values.shape[0], -1, cfg.text.hidden_size)


def _rope(c: ModelConfig, length: int, device) -> tuple:
    return rope_table(max(length, c.max_position_embeddings), c.head_dim,
                      theta=c.rope_theta, llama3=c.rope_llama3,
                      device=device)


def forward(params: dict, cfg: MllamaConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            pixel_values: torch.Tensor | None = None,
            aspect_ratio_ids: torch.Tensor | None = None,
            aspect_ratio_mask: torch.Tensor | None = None,
            cross_attention_mask: torch.Tensor | None = None,
            positions: torch.Tensor | None = None,
            cross_attention_states: torch.Tensor | None = None,
            cache: dict | None = None, cache_offset: int = 0,
            need_logits: bool = True) -> ModelOutput:
    """The full-sequence forward.  Text-only batches skip the cross layers
    (HF MllamaTextModel semantics).  ``pixel_values`` may come without the
    media axis (the collator's one-image rows, (B, tiles, C, H, W)).

    With ``cache`` (from ``init_cache``) this is a generation prefill: the
    self-attention K/V are written to the cache, and the returned cache
    adds the cross K/V and the last prompt row's cross bias and full-row
    mask for ``decode_forward``."""
    if cache is not None and not (isinstance(cache_offset, int)
                                  and cache_offset == 0):
        raise ValueError('decode goes through decode_forward; forward '
                         'only prefills (static cache_offset 0)')
    c = cfg.text
    check_supported(cfg)
    dtype = transformer.torch_dtype(c.compute_dtype)
    b, l = input_ids.shape
    dev = input_ids.device
    lm = params['language_model']
    remat = (c.remat if cache is None and c.remat != 'none'
             and torch.is_grad_enabled() else 'none')

    cross_states = cross_attention_states
    if pixel_values is not None and cross_states is None:
        if pixel_values.ndim == 5:
            pixel_values = pixel_values[:, None]
        if aspect_ratio_ids.ndim == 1:
            aspect_ratio_ids = aspect_ratio_ids[:, None]
        if aspect_ratio_mask.ndim == 2:
            aspect_ratio_mask = aspect_ratio_mask[:, None]
        if cross_attention_mask is None:
            cross_attention_mask = default_cross_attention_mask(
                cfg, input_ids, aspect_ratio_mask)
        cross_states = image_features(params, cfg, pixel_values,
                                      aspect_ratio_ids, aspect_ratio_mask,
                                      dtype, remat=remat)
    has_cross = cross_states is not None
    if has_cross:
        if cross_attention_mask is None:
            raise ValueError('cross_attention_mask is required with images')
        cross_bias, full_row = prepare_cross_attention_mask(
            cross_attention_mask, cfg.vision.num_patches)
    x = lm['embedding'][input_ids].to(dtype)

    if positions is None:
        if attention_mask is not None:
            positions = (torch.cumsum(attention_mask, -1) - 1).clamp_min(0)
        else:
            positions = torch.arange(l, device=dev).expand(b, l)
    positions = positions.to(torch.long)
    sin, cos = _rope(c, l, dev)
    up_shape = (c.hidden_size, c.mlp_dim)

    new_cross = {}
    for i, lp in enumerate(lm['layers']):
        if i in cfg.cross_attention_layers:
            if not has_cross:
                continue
            if cache is not None:
                k, v = _cross_kv(c, lp, cross_states)
                x = _cross_layer(c, lp, x, k, v, cross_bias, full_row)
                new_cross[str(i)] = (k, v)
            else:
                x = transformer.layer_call(remat, up_shape, _cross_block, c,
                                           lp, x, cross_states, cross_bias,
                                           full_row)
            continue
        if cache is not None:
            x = transformer._decoder_layer(c, lp, x, positions, sin, cos,
                                           attention_mask,
                                           cache['self'][str(i)], 0)[0]
        else:
            x = transformer.layer_call(
                remat, up_shape, transformer._decoder_layer, c, lp, x,
                positions, sin, cos, attention_mask, None, cache_offset)[0]

    new_cache = None
    if cache is not None:
        new_cache = {'self': cache['self'], 'cross': new_cross}
        if has_cross:
            # decode rows keep attending with the LAST prompt row's cross
            # mask (HF generation semantics; prompts are left-padded, so
            # the last row is the last real token)
            new_cache['cross_bias'] = cross_bias[:, :, -1:]
            new_cache['full_row'] = full_row[:, -1:]

    x = transformer._norm(c, lm['final_norm'], x)
    if not need_logits:
        return ModelOutput(logits=torch.zeros((b, 0, 0), device=dev),
                           last_hidden_state=x, cache=new_cache)
    return ModelOutput(logits=_logits(c, lm, x), last_hidden_state=x,
                       cache=new_cache)


def _logits(c: ModelConfig, lm: dict, x: torch.Tensor) -> torch.Tensor:
    logits = transformer._head_logits(c, lm, x)
    if c.true_vocab_size is not None and c.true_vocab_size != c.vocab_size:
        logits = logits[..., :c.true_vocab_size]
    return logits


def init_cache(cfg: MllamaConfig, batch_size: int, total: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str | None = None) -> dict:
    """The self-attention layers' zeroed (K, V) caches, (B, KH, total, D)
    each, on ``device`` (default: the first CUDA device); the prefill
    ``forward`` adds the cross entries, whose shapes depend on the batch's
    media."""
    device = default_device(device)
    c = cfg.text
    shape = (batch_size, c.num_kv_heads, total, c.head_dim)
    return {'self': {
        str(i): (torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
        for i in range(c.num_layers) if i not in cfg.cross_attention_layers
    }}


def decode_forward(params: dict, cfg: MllamaConfig,
                   input_ids: torch.Tensor,
                   attention_mask: torch.Tensor | None = None,
                   positions: torch.Tensor | None = None,
                   cache: dict | None = None, cache_offset=0
                   ) -> ModelOutput:
    """One token a row: the self layers write at ``cache_offset`` and
    attend over the cache; the cross layers reuse the prefill's vision K/V
    and the last prompt row's bias (a text-only generation carries no
    cross entries and skips those layers, as the full forward does)."""
    c = cfg.text
    dtype = transformer.torch_dtype(c.compute_dtype)
    lm = params['language_model']
    x = lm['embedding'][input_ids].to(dtype)
    sin, cos = _rope(c, attention_mask.shape[1], input_ids.device)
    for i, lp in enumerate(lm['layers']):
        if i in cfg.cross_attention_layers:
            if str(i) in cache['cross']:
                k, v = cache['cross'][str(i)]
                x = _cross_layer(c, lp, x, k, v, cache['cross_bias'],
                                 cache['full_row'])
            continue
        x = transformer._decoder_layer(c, lp, x, positions, sin, cos,
                                       attention_mask, cache['self'][str(i)],
                                       cache_offset)[0]
    x = transformer._norm(c, lm['final_norm'], x)
    return ModelOutput(logits=_logits(c, lm, x), last_hidden_state=x,
                       cache=cache)


def token_logprobs(params: dict, cfg: MllamaConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor | None = None,
                   pixel_values: torch.Tensor | None = None,
                   chunk_size: int = 256, **mm_kw) -> torch.Tensor:
    """(B, L-1) log-probs of each next token (the image tile metadata in
    ``mm_kw``)."""
    out = forward(params, cfg, input_ids, attention_mask=attention_mask,
                  pixel_values=pixel_values, need_logits=False, **mm_kw)
    hidden = out.last_hidden_state
    head = params['language_model']['lm_head'].to(hidden.dtype)
    return hidden_to_token_logprobs(
        hidden[:, :-1], head, input_ids[:, 1:], chunk_size=chunk_size,
        softcap=cfg.text.final_logit_softcap,
        true_vocab=cfg.text.true_vocab_size)
