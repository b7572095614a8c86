"""Score (reward / cost / critic) model: decoder + linear score head, the
port of ``align_anything_tpu/models/score_model.py``.

One wrapper serves every family, as in JAX: the decoder's last hidden
state (``transformer.forward(..., need_logits=False)``: the LM head is never
applied) goes through an fp32 (E, D_score) head.  The JAX ``param_specs``
(sharding) has no counterpart on one device.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.utils.tools import default_device, last_true_index


@dataclasses.dataclass
class ScoreModelOutput:
    scores: torch.Tensor       # (B, L, D_score) per-token scores, fp32
    end_scores: torch.Tensor   # (B, D_score) score at the last real token
    end_index: torch.Tensor    # (B,) index of the last real token


def _fresh_head(hidden_size: int, generator: torch.Generator,
                score_dim: int, device: torch.device) -> torch.Tensor:
    return (torch.randn((hidden_size, score_dim), generator=generator,
                        device=device) / math.sqrt(hidden_size))


def init_params(config: ModelConfig, generator: torch.Generator,
                score_dim: int = 1,
                device: torch.device | str | None = None) -> dict:
    """The decoder's random init plus ``score_head: {'w': (E, score_dim)}``
    drawn from the same ``generator`` (which must live on ``device``)."""
    device = default_device(device)
    params = transformer.init_params(config, generator, device=device)
    params['score_head'] = {'w': _fresh_head(config.hidden_size, generator,
                                             score_dim, device)}
    return params


def forward(params: dict, config: ModelConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            positions: torch.Tensor | None = None) -> ScoreModelOutput:
    out = transformer.forward(params, config, input_ids,
                              attention_mask=attention_mask,
                              positions=positions, need_logits=False)
    scores = torch.einsum('ble,ed->bld', out.last_hidden_state.float(),
                          params['score_head']['w'].float())
    b, l = input_ids.shape
    if attention_mask is None:
        end_index = torch.full((b,), l - 1, dtype=torch.long,
                               device=input_ids.device)
    else:
        end_index = last_true_index(attention_mask.bool())
    end_scores = scores[torch.arange(b, device=scores.device), end_index]
    return ScoreModelOutput(scores=scores, end_scores=end_scores,
                            end_index=end_index)


def load_score_head(path: str | None, hidden_size: int,
                    generator: torch.Generator, score_dim: int = 1,
                    device: torch.device | str | None = None) -> torch.Tensor:
    """The score head from ``score_head.npy`` beside an HF slice if there is
    one, else a fresh init from ``generator``.

    This is the handoff between trainers: the RM and cost trainers save the
    head beside their ``slice_{step}`` export, and every consumer (PPO,
    rm_score) restores it through here."""
    device = default_device(device)
    if path:
        head_file = os.path.join(path, 'score_head.npy')
        if os.path.isdir(path) and os.path.exists(head_file):
            return torch.from_numpy(np.load(head_file).astype(
                np.float32)).to(device)
    return _fresh_head(hidden_size, generator, score_dim, device)
