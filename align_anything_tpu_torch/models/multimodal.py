"""LLaVA-class multimodal model: ViT tower + projector + decoder, the port
of ``align_anything_tpu/models/multimodal.py``.

Image patch features are projected into the text embedding space and
placed over the ``<image>`` placeholder tokens, then the decoder of
``models/transformer.py`` runs on the merged embeddings, so every text
loss and trainer works unchanged on multimodal batches.  The param tree
keeps the JAX package's keys: ``language_model``, ``vision_tower``,
``projector``.

LLaVA-Next AnyRes (``image_grid_pinpoints``): the ``[base + tiles]``
crops of each image are encoded, the ``image_newline`` row is appended,
and the host-computed ``select_idx`` (``data/image.py``
``AnyResProcessor``) gathers HF's packed feature order before the merge.
LLaVA-NeXT-Video (``spatial_pool_stride``): 5-D ``pixel_values`` (B, T,
C, H, W) go through the tower as B x T images, are average-pooled stride x
stride over the feature grid, projected and merged over ``video_token_id``; without a
stride every frame's full patch grid merges over ``image_token_id``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from align_anything_tpu_torch.models import transformer, vision
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.models.transformer import ModelOutput
from align_anything_tpu_torch.models.vision import ViTConfig
from align_anything_tpu_torch.ops.logprobs import hidden_to_token_logprobs
from align_anything_tpu_torch.utils.tools import default_device


@dataclasses.dataclass(frozen=True)
class MultimodalConfig:
    text: ModelConfig
    vision: ViTConfig
    image_token_id: int = 32000
    projector_layers: int = 2           # LLaVA-1.5 uses a 2-layer GELU MLP
    # LLaVA-Next AnyRes: ((h, w), ...) candidate resolutions.  When set,
    # pixel_values carry [base + tiles] crops and the host-computed
    # ``select_idx`` gathers the packed (unpadded + newline) feature
    # sequence: HF pack_image_features (modeling_llava_next.py:282-348)
    # with shapes that do not depend on the image
    image_grid_pinpoints: tuple | None = None
    # LLaVA-Next-Video: frames are average-pooled stride x stride in
    # feature space before projection (HF LlavaNextVideoPooler) and merged
    # over the <video> token
    video_token_id: int | None = None
    spatial_pool_stride: int | None = None

    # pass-throughs so trainers can treat this like ModelConfig
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

    def replace(self, **kw) -> 'MultimodalConfig':
        text_fields = {f.name for f in dataclasses.fields(ModelConfig)}
        text_kw = {k: v for k, v in kw.items() if k in text_fields}
        own_kw = {k: v for k, v in kw.items() if k not in text_fields}
        return dataclasses.replace(self, text=self.text.replace(**text_kw),
                                   **own_kw)


def check_supported(cfg: MultimodalConfig) -> None:
    """Raise for the config options the port does not run yet (those of
    the text decoder)."""
    transformer.check_supported(cfg.text)


def init_params(cfg: MultimodalConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random fp32 init with the JAX package's tree and shapes (the numbers
    differ), on ``device`` (default: the first CUDA device)."""
    device = default_device(device)
    check_supported(cfg)
    d_vis, d_text = cfg.vision.hidden_size, cfg.text.hidden_size
    proj: dict[str, Any] = {}
    dims = [d_vis] + [d_text] * cfg.projector_layers
    lm = transformer.init_params(cfg.text, generator, device=device)
    tower = vision.init_params(cfg.vision, generator, device=device)
    for i in range(cfg.projector_layers):
        proj[f'linear_{i}'] = {
            'w': torch.randn((dims[i], dims[i + 1]), generator=generator,
                             device=device) / math.sqrt(dims[i]),
            'b': torch.zeros((dims[i + 1],), device=device),
        }
    out = {'language_model': lm, 'vision_tower': tower, 'projector': proj}
    if cfg.image_grid_pinpoints is not None:
        out['image_newline'] = torch.randn(
            (d_text,), generator=generator, device=device) / math.sqrt(d_text)
    return out


def _project(params: dict, cfg: MultimodalConfig,
             x: torch.Tensor) -> torch.Tensor:
    """The projector MLP: tower features (B, N, D_vis) -> (B, N, E_text)."""
    for i in range(cfg.projector_layers):
        lp = params['projector'][f'linear_{i}']
        x = torch.einsum('bnd,de->bne', x, lp['w'].to(x.dtype))
        x = x + lp['b'].to(x.dtype)
        if i + 1 < cfg.projector_layers:
            x = F.gelu(x)
    return x


def project_image_features(params: dict, cfg: MultimodalConfig,
                           pixel_values: torch.Tensor) -> torch.Tensor:
    """(B_img, C, H, W) -> (B_img, N_patches, E_text)."""
    return _project(params, cfg, vision.forward(
        params['vision_tower'], cfg.vision, pixel_values,
        compute_dtype=cfg.text.compute_dtype))


def project_video_features(params: dict, cfg: MultimodalConfig,
                           pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, T_frames, C, H, W) -> (B, T * pooled_patches, E_text): the
    tower's features of every frame, average-pooled stride x stride
    over the feature grid (HF LlavaNextVideoPooler 'average'; a grid side
    that is not a multiple of the stride drops its last rows and columns),
    then projected."""
    b, t = pixel_values.shape[:2]
    feats = vision.forward(params['vision_tower'], cfg.vision,
                           pixel_values.flatten(0, 1),
                           compute_dtype=cfg.text.compute_dtype)
    s = cfg.spatial_pool_stride
    bt, p, d = feats.shape
    ph = math.isqrt(p)
    side = (ph // s) * s
    feats = feats.reshape(bt, ph, ph, d)[:, :side, :side]
    feats = feats.reshape(bt, side // s, s, side // s, s, d).mean((2, 4))
    x = _project(params, cfg, feats.reshape(bt, (side // s) ** 2, d))
    return x.reshape(b, t * x.shape[1], x.shape[2])


def anyres_image_embeds(params: dict, cfg: MultimodalConfig,
                        pixel_values: torch.Tensor,
                        select_idx: torch.Tensor) -> torch.Tensor:
    """LLaVA-Next AnyRes: ``pixel_values`` (B, T, C, H, W) the ``[base +
    tiles]`` crops of each row's image, ``select_idx`` (B, N) the packed
    order (grid flatten, centered unpad, a newline after each feature
    row); index ``T * P`` selects ``image_newline``, appended as the last
    feature row -> (B, N, E_text)."""
    b, t = pixel_values.shape[:2]
    feats = project_image_features(params, cfg, pixel_values.flatten(0, 1))
    p, e = feats.shape[1], feats.shape[2]
    feats = feats.reshape(b, t * p, e)
    newline = params['image_newline'].to(feats.dtype).expand(b, 1, e)
    feats = torch.cat([feats, newline], dim=1)
    return torch.gather(
        feats, 1, select_idx.long()[:, :, None].expand(-1, -1, e))


def merge_image_embeds(text_embeds: torch.Tensor, image_embeds: torch.Tensor,
                       input_ids: torch.Tensor,
                       image_token_id: int) -> torch.Tensor:
    """Place per-row image patch embeddings over the <image> token slots.

    text_embeds: (B, L, E); image_embeds: (B, N, E), one image per row
    (multi-image rows pack extra patches along N).  The k-th <image> token
    of a row receives the k-th patch embedding (LLaVA merge semantics): a
    gather and a where, not a boolean scatter, so the shapes do not depend
    on the data."""
    is_image = input_ids == image_token_id            # (B, L)
    # index of each image slot among the row's image tokens
    slot_idx = (torch.cumsum(is_image.to(torch.int64), dim=-1) - 1).clamp(
        0, image_embeds.shape[1] - 1)
    e = image_embeds.shape[-1]
    gathered = torch.take_along_dim(
        image_embeds, slot_idx[:, :, None].expand(-1, -1, e), dim=1)
    return torch.where(is_image[:, :, None], gathered.to(text_embeds.dtype),
                       text_embeds)


def forward(params: dict, cfg: MultimodalConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            pixel_values: torch.Tensor | None = None,
            positions: torch.Tensor | None = None,
            cache=None, cache_offset: int = 0,
            need_logits: bool = True,
            select_idx: torch.Tensor | None = None) -> ModelOutput:
    """The decoder over the text embeddings with the projected image
    features merged in; text-only without ``pixel_values``.

    ``pixel_values``: (B, C, H, W), one image a row; with ``select_idx``
    (B, N), the AnyRes crops (B, T, C, H, W); otherwise 5-D is a video
    (B, T_frames, C, H, W): pooled over ``video_token_id`` when the config
    has a ``spatial_pool_stride``, else every frame's patches over
    ``image_token_id`` (the dataset expands <video> to T_frames x
    num_patches image tokens)."""
    lm = params['language_model']
    dtype = transformer.torch_dtype(cfg.text.compute_dtype)
    embeds = lm['embedding'][input_ids].to(dtype)
    if pixel_values is not None:
        merge_token = cfg.image_token_id
        if select_idx is not None:
            image_embeds = anyres_image_embeds(params, cfg, pixel_values,
                                               select_idx)
        elif pixel_values.ndim == 5 and cfg.spatial_pool_stride is not None:
            image_embeds = project_video_features(params, cfg, pixel_values)
            merge_token = cfg.video_token_id or cfg.image_token_id
        elif pixel_values.ndim == 5:
            b, t = pixel_values.shape[:2]
            feats = project_image_features(params, cfg,
                                           pixel_values.flatten(0, 1))
            image_embeds = feats.reshape(b, t * feats.shape[1],
                                         feats.shape[2])
        else:
            image_embeds = project_image_features(params, cfg, pixel_values)
        embeds = merge_image_embeds(embeds, image_embeds, input_ids,
                                    merge_token)
    return transformer.forward(lm, cfg.text, input_ids,
                               attention_mask=attention_mask,
                               positions=positions, cache=cache,
                               cache_offset=cache_offset,
                               need_logits=need_logits,
                               inputs_embeds=embeds)


def decode_forward(params: dict, cfg: MultimodalConfig,
                   input_ids: torch.Tensor, **kw) -> ModelOutput:
    """Text-only step over the language trunk (decode loop: the image
    features already live in the KV cache from the prefill)."""
    return transformer.forward(params['language_model'], cfg.text, input_ids,
                               **kw)


def token_logprobs(params: dict, cfg: MultimodalConfig,
                   input_ids: torch.Tensor,
                   attention_mask: torch.Tensor | None = None,
                   pixel_values: torch.Tensor | None = None,
                   chunk_size: int = 256,
                   select_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Per-token logp of input_ids[t+1] given the prefix -> (B, L-1), with
    the chunked vocab projection of ``ops/logprobs.py``."""
    out = forward(params, cfg, input_ids, attention_mask=attention_mask,
                  pixel_values=pixel_values, need_logits=False,
                  select_idx=select_idx)
    lm = params['language_model']
    hidden = out.last_hidden_state
    head = (lm['embedding'].T if cfg.text.tie_word_embeddings
            else lm['lm_head']).to(hidden.dtype)
    return hidden_to_token_logprobs(
        hidden[:, :-1], head, input_ids[:, 1:], chunk_size=chunk_size,
        softcap=cfg.text.final_logit_softcap,
        true_vocab=cfg.text.true_vocab_size)
