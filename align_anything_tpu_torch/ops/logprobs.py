"""Memory-efficient token log-probabilities (chunked vocab projection):
the port of ``align_anything_tpu/ops/logprobs.py``.

Every preference/RL loss needs the log-prob of the realized tokens, not the
full logits.  The (B, L, V) fp32 logits are never materialized: the vocab
projection runs over sequence chunks, each chunk's body under
``torch.utils.checkpoint``, so a (B, C, V) chunk of logits exists only
inside its body, in the forward and again in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from align_anything_tpu_torch.models import transformer
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.models.quantization import dequantize_weight
from align_anything_tpu_torch.utils.tools import gather_log_probabilities


def _chunk_logprobs(h_c: torch.Tensor, head: torch.Tensor,
                    y_c: torch.Tensor, softcap: float | None,
                    true_vocab: int | None) -> torch.Tensor:
    # products of the compute-dtype operands are exact in fp32: the JAX
    # einsum with preferred_element_type=float32
    logits = torch.einsum('bce,ev->bcv', h_c.float(), head.float())
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if true_vocab is not None and true_vocab != logits.shape[-1]:
        logits = logits[..., :true_vocab]
    return gather_log_probabilities(logits, y_c)


def hidden_to_token_logprobs(hidden: torch.Tensor, head: torch.Tensor,
                             labels: torch.Tensor, chunk_size: int = 256,
                             softcap: float | None = None,
                             true_vocab: int | None = None) -> torch.Tensor:
    """hidden: (B, L, E) positions predicting labels: (B, L) -> (B, L) fp32.

    ``head``: (E, V) projection.  L is padded to a multiple of
    ``chunk_size``; each chunk's logits are recomputed in the backward
    instead of saved."""
    b, l, _ = hidden.shape
    n_chunks = -(-l // chunk_size)
    pad = n_chunks * chunk_size - l
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
    out = []
    for i in range(n_chunks):
        sl = slice(i * chunk_size, (i + 1) * chunk_size)
        out.append(checkpoint(_chunk_logprobs, hidden[:, sl], head,
                              labels[:, sl], softcap, true_vocab,
                              use_reentrant=False))
    return torch.cat(out, dim=1)[:, :l]


def token_logprobs(params: dict, config: ModelConfig,
                   input_ids: torch.Tensor,
                   attention_mask: torch.Tensor | None = None,
                   chunk_size: int = 256) -> torch.Tensor:
    """Per-token logp of input_ids[t+1] given the prefix -> (B, L-1).

    ``gather_log_probabilities(forward(...).logits[:, :-1], ids[:, 1:])``
    without the (B, L, V) logits."""
    out = transformer.forward(params, config, input_ids,
                              attention_mask=attention_mask,
                              need_logits=False)
    hidden = out.last_hidden_state
    # a quantized head (QLoRA's frozen base) is dequantized, as the JAX
    # ``.astype`` does
    head = dequantize_weight(
        params['embedding'].T if config.tie_word_embeddings
        else params['lm_head'], hidden.dtype, stacked=False)
    return hidden_to_token_logprobs(
        hidden[:, :-1], head, input_ids[:, 1:], chunk_size=chunk_size,
        softcap=config.final_logit_softcap,
        true_vocab=config.true_vocab_size)
