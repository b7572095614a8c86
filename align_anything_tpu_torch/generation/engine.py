"""Batch generation: one prefill over left-padded prompts, then one token
per step for every row until each row hits EOS or the budget.

Port of ``align_anything_tpu/generation/engine.py``: the generic decoder,
and a vision-language model whose prefill takes the image
(``pixel_values`` with ``prefill_forward`` / ``step_forward``, as JAX's
TI2T PPO and GRPO call it); an m-rope model (Qwen2-VL) passes its prefill
streams and decode offset (``prefill_positions`` / ``position_offset``);
a family whose decode state is not the decoder's ``KVCache`` (Mllama: the
cross K/V beside the self-attention cache) passes ``init_cache_fn``.  The
continuous engine's tests hold it to this engine's tokens.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from align_anything_tpu_torch.generation.sampling import sample_token
from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.utils.tools import default_device


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    greedy: bool = False
    eos_token_id: int | None = None   # default: model config's
    pad_token_id: int | None = None


@torch.no_grad()
def generate(params: dict, model_cfg, gen_cfg: GenerationConfig,
             input_ids: torch.Tensor, attention_mask: torch.Tensor,
             generator: torch.Generator | None = None,
             pixel_values: torch.Tensor | None = None,
             prefill_forward=None, step_forward=None,
             prefill_positions: torch.Tensor | None = None,
             position_offset: torch.Tensor | None = None,
             media: dict | None = None, init_cache_fn=None
             ) -> dict[str, torch.Tensor]:
    """Generate completions for left-padded prompts (B, P).

    A multimodal model passes ``pixel_values`` and a ``prefill_forward``
    that takes them (``multimodal.forward``): the image features matter
    only in the prefill, whose keys and values the cache keeps, and each
    decode step runs ``step_forward`` (``multimodal.decode_forward``) over
    the text trunk.  Both default to ``transformer.forward``; the cache is
    built from ``model_cfg.text`` where the config has one.
    ``media`` holds other named inputs of the prefill alone (Qwen2-VL's
    ``image_grid_thw``, Mllama's ``aspect_ratio_ids`` /
    ``aspect_ratio_mask``).

    Families whose decode state is not the decoder's ``KVCache`` (Mllama's
    cross-attention K/V) pass ``init_cache_fn(model_cfg, b, total, dtype,
    device=...)`` returning their cache; the loop then carries whatever
    cache ``prefill_forward`` and each step return in ``out.cache``.

    m-rope models (Qwen2-VL class): ``prefill_positions`` (3, B, P)
    replace the cumsum positions of the prefill, and ``position_offset``
    (B,) shifts the decode positions so that the text continues from the
    m-rope maximum, not from the prompt's length (HF
    ``mrope_position_deltas``); the returned ``prompt_lens`` carry the
    shift, as JAX's do.

    Returns ``sequences`` (B, P+T) (prompt block + completions, pad after
    EOS), ``attention_mask``, ``completions`` (B, T), ``completion_mask``
    and ``prompt_lens``."""
    c = model_cfg
    eos = gen_cfg.eos_token_id if gen_cfg.eos_token_id is not None else c.eos_token_id
    pad = gen_cfg.pad_token_id if gen_cfg.pad_token_id is not None else c.pad_token_id
    b, p = input_ids.shape
    dev = input_ids.device
    t_max = gen_cfg.max_new_tokens
    total = p + t_max
    if step_forward is None:
        step_forward = transformer.forward
    if prefill_forward is None:
        prefill_forward = step_forward
    prefill_kwargs = dict(media or {})
    if pixel_values is not None:
        prefill_kwargs['pixel_values'] = pixel_values

    text_cfg = getattr(c, 'text', c)
    cache_dtype = transformer.torch_dtype(text_cfg.compute_dtype)
    if init_cache_fn is not None:
        cache = init_cache_fn(c, b, total, cache_dtype, device=dev)
    else:
        cache = transformer.init_cache(text_cfg, b, total, dtype=cache_dtype,
                                       device=dev)
    attention_mask = attention_mask.to(torch.long)
    full_mask = torch.zeros((b, total), dtype=torch.long, device=dev)
    full_mask[:, :p] = attention_mask
    prompt_positions = (torch.cumsum(attention_mask, -1) - 1).clamp_min(0)
    prompt_lens = attention_mask.sum(-1)

    out = prefill_forward(params, c, input_ids, attention_mask=full_mask,
                          positions=(prefill_positions
                                     if prefill_positions is not None
                                     else prompt_positions),
                          cache=cache, cache_offset=0, **prefill_kwargs)
    cache = out.cache
    if position_offset is not None:
        prompt_lens = prompt_lens + torch.as_tensor(position_offset,
                                                    device=dev)
    next_logits = out.logits[:, -1]
    seqs = torch.zeros((b, total), dtype=torch.long, device=dev)
    seqs[:, :p] = input_ids
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for t in range(t_max):
        tok = sample_token(next_logits, generator,
                           temperature=gen_cfg.temperature,
                           top_k=gen_cfg.top_k, top_p=gen_cfg.top_p,
                           greedy=gen_cfg.greedy)
        tok = torch.where(done, pad, tok)
        seqs[:, p + t] = tok
        # finished rows keep their mask slot closed so attention skips them
        full_mask[:, p + t] = (~done).to(torch.long)
        done = done | (tok == eos)
        step = step_forward(params, c, tok[:, None],
                            attention_mask=full_mask,
                            positions=(prompt_lens + t)[:, None],
                            cache=cache, cache_offset=p + t)
        cache = step.cache
        next_logits = step.logits[:, 0]
        if bool(done.all()):
            break

    completions = seqs[:, p:]
    completion_mask = (completions != pad).to(torch.long)
    return {
        'sequences': seqs,
        'attention_mask': torch.cat([attention_mask, completion_mask], -1),
        'completions': completions,
        'completion_mask': completion_mask,
        'prompt_lens': prompt_lens,
    }


class GenerationEngine:
    """Host-side wrapper: tokenization, prompt bucketing and decoding of
    the completions, on ``device`` (default: the first CUDA device)."""

    def __init__(self, model_cfg: ModelConfig, tokenizer,
                 prompt_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024),
                 device: torch.device | str | None = None):
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.prompt_buckets = prompt_buckets
        self.device = default_device(device)

    def _pad_prompts(self, prompts: list[list[int]]
                     ) -> tuple[np.ndarray, np.ndarray]:
        from align_anything_tpu_torch.utils.tools import (  # noqa: PLC0415
            bucket_length,
            left_padding,
        )

        max_len = max(len(p) for p in prompts)
        length = bucket_length(max_len, self.prompt_buckets)
        pad = self.tokenizer.pad_token_id
        ids = left_padding([np.asarray(p, np.int64) for p in prompts], pad,
                           total_length=length)
        mask = (ids != pad).astype(np.int64)
        return ids, mask

    def generate_ids(self, params: dict, input_ids, attention_mask,
                     gen_cfg: GenerationConfig,
                     generator: torch.Generator | None = None
                     ) -> dict[str, torch.Tensor]:
        return generate(params, self.model_cfg, gen_cfg,
                        torch.as_tensor(input_ids, device=self.device),
                        torch.as_tensor(attention_mask, device=self.device),
                        generator)

    def chat(self, params: dict, prompts: list[str],
             gen_cfg: GenerationConfig,
             generator: torch.Generator | None = None) -> list[str]:
        encoded = []
        for text in prompts:
            out = self.tokenizer(text, add_special_tokens=True)
            ids = out['input_ids'] if isinstance(out, dict) else out.input_ids
            if ids and ids[-1] == self.tokenizer.eos_token_id:
                ids = ids[:-1]
            encoded.append(ids)
        ids, mask = self._pad_prompts(encoded)
        result = self.generate_ids(params, ids, mask, gen_cfg, generator)
        completions = result['completions'].cpu().numpy()
        return [
            self.tokenizer.decode([t for t in row
                                   if t != self.tokenizer.pad_token_id],
                                  skip_special_tokens=True)
            for row in completions
        ]
