"""LLaVA-class multimodal model: ViT tower + projector + decoder, the port
of ``align_anything_tpu/models/multimodal.py``.

Image patch features are projected into the text embedding space and
placed over the ``<image>`` placeholder tokens, then the decoder of
``models/transformer.py`` runs on the merged embeddings, so every text
loss and trainer works unchanged on multimodal batches.  The param tree
keeps the JAX package's keys: ``language_model``, ``vision_tower``,
``projector``.

Not ported yet (ROADMAP §1 item 12, LLaVA-Next and video): the AnyRes
branch (``image_grid_pinpoints``, ``select_idx``, ``image_newline``) and
both video branches (5-D ``pixel_values``).  Their config fields are kept;
the calls that would need them raise ``NotImplementedError``.
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

_LATER = ('is not ported yet (ROADMAP §1 item 12: LLaVA-Next AnyRes and '
          'video)')


@dataclasses.dataclass(frozen=True)
class MultimodalConfig:
    text: ModelConfig
    vision: ViTConfig
    image_token_id: int = 32000
    projector_layers: int = 2           # LLaVA-1.5 uses a 2-layer GELU MLP
    # LLaVA-Next AnyRes candidate resolutions ((h, w), ...): not ported
    image_grid_pinpoints: tuple | None = None
    # LLaVA-Next-Video pooled frames over the <video> token: not ported
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
    """Raise for the config options the port does not run yet."""
    if cfg.image_grid_pinpoints is not None:
        raise NotImplementedError(f'image_grid_pinpoints {_LATER}')
    if cfg.spatial_pool_stride is not None:
        raise NotImplementedError(f'spatial_pool_stride {_LATER}')
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
    return {'language_model': lm, 'vision_tower': tower, 'projector': proj}


def project_image_features(params: dict, cfg: MultimodalConfig,
                           pixel_values: torch.Tensor) -> torch.Tensor:
    """(B_img, C, H, W) -> (B_img, N_patches, E_text)."""
    x = vision.forward(params['vision_tower'], cfg.vision, pixel_values,
                       compute_dtype=cfg.text.compute_dtype)
    for i in range(cfg.projector_layers):
        lp = params['projector'][f'linear_{i}']
        x = torch.einsum('bnd,de->bne', x, lp['w'].to(x.dtype))
        x = x + lp['b'].to(x.dtype)
        if i + 1 < cfg.projector_layers:
            x = F.gelu(x)
    return x


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
    features merged in (``pixel_values`` (B, C, H, W), one image a row);
    text-only without ``pixel_values``."""
    lm = params['language_model']
    dtype = transformer.torch_dtype(cfg.text.compute_dtype)
    embeds = lm['embedding'][input_ids].to(dtype)
    if pixel_values is not None:
        if select_idx is not None:
            raise NotImplementedError(f'select_idx (AnyRes) {_LATER}')
        if pixel_values.ndim == 5:
            raise NotImplementedError(f'5-D pixel_values (video) {_LATER}')
        image_embeds = project_image_features(params, cfg, pixel_values)
        embeds = merge_image_embeds(embeds, image_embeds, input_ids,
                                    cfg.image_token_id)
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
