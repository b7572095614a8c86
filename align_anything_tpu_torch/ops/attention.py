"""Attention ops: the port of ``align_anything_tpu/ops/attention.py``.

- ``xla_attention``: einsum attention with an explicit mask and fp32
  softmax, the plain reference (the JAX package's numerics reference).
- ``chunked_masked_attention``: full attention under an additive bias
  ``q_gate`` x ``k_invalid`` x fp32 min, in query chunks with a backward
  that recomputes each chunk (the vision towers' attention, whose fp32
  logits over thousands of patches would not fit at once).
- ``splash_attention`` / the ``'flash'`` and ``'splash'`` paths of
  ``causal_attention`` and ``windowed_causal_attention`` (Gemma3's
  interleaved layers): the hand-written kernel of ``ops/flash_attention.py``
  (``csrc/flash_attention.cu``), which replaces both TPU kernels, K1a (the
  library Pallas flash kernel) and K1b (splash).  On a CPU tensor it runs
  the kernel's plain version.

Layouts as in JAX: q (B, L, H, D); k, v (B, S, KH, D) with KH dividing H.
The TPU dispatch thresholds (flash from L >= 1024, splash at L % 512 == 0)
were v5e tuning: here every self-attention call the kernel supports goes
to it, at any L.
"""

# no ``from __future__ import annotations``: torch.library.custom_op reads
# the schema of ``chunked_masked_attention`` from the live annotations

import torch

from align_anything_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -2.3819763e38  # close to bf16 -inf without overflow
IMPLS = ('auto', 'flash', 'splash', 'xla', 'ring')
FP32_MIN = torch.finfo(torch.float32).min
# fp32 logits elements of one query chunk of chunked_masked_attention (1 GiB)
CHUNKED_ATTN_ELEMS = 1 << 28


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KH, D) -> (B, S, KH*n_rep, D) for grouped-query attention."""
    if n_rep == 1:
        return x
    b, s, kh, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(
        b, s, kh * n_rep, d)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  attention_mask: torch.Tensor | None = None,
                  causal: bool = True) -> torch.Tensor:
    """Masked multi-head attention in plain ops.

    q: (B, L, H, D); k, v: (B, S, KH, D); attention_mask: (B, S) over keys.
    Causal with queries at the last L of S key slots; fp32 softmax;
    probabilities rounded to q's dtype before PV.  Returns (B, L, H, D)."""
    b, l, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)
    logits = torch.einsum('blhd,bshd->bhls', q.float(), k.float()) * d ** -0.5
    mask = torch.ones((b, 1, l, s), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(l, device=q.device)[:, None] + (s - l)
        k_pos = torch.arange(s, device=q.device)[None, :]
        mask = mask & (k_pos <= q_pos)[None, None]
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, None, :].to(torch.bool)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum('bhls,bshd->blhd', probs, v.to(q.dtype))


def _masked_attend_chunk(q: torch.Tensor, kf: torch.Tensor, v: torch.Tensor,
                         q_gate: torch.Tensor,
                         k_invalid: torch.Tensor) -> torch.Tensor:
    """A chunk of queries of ``chunked_masked_attention``, as JAX computes
    Mllama's tower attention for all of them (``mllama.py:268-285``): fp32
    logits, the additive bias ``q_gate`` x ``k_invalid`` x fp32 min, fp32
    softmax, probabilities rounded to q's dtype before PV.  q (B, c, H,
    D); kf (B, S, H, D) fp32; v (B, S, H, D); q_gate (B, c), k_invalid
    (B, S) fp32."""
    d = q.shape[-1]
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), kf) * d ** -0.5
    bias = (q_gate[:, :, None] * k_invalid[:, None, :] * FP32_MIN)[:, None]
    probs = torch.softmax(logits + bias, dim=-1).to(q.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', probs, v)


def _chunk_rows(b: int, s: int, h: int) -> int:
    return max(8, min(s, CHUNKED_ATTN_ELEMS // max(b * h * s, 1)))


@torch.library.custom_op('aat_torch::chunked_masked_attention',
                         mutates_args=())
def chunked_masked_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_gate: torch.Tensor,
                             k_invalid: torch.Tensor) -> torch.Tensor:
    """Full (non-causal) attention over (B, S, H, D) q, k, v with the bias
    fp32 min where ``q_gate`` (B, S) and ``k_invalid`` (B, S), both fp32,
    are 1: a key mask with ``q_gate`` all ones (Idefics2's tower), HF's
    both-invalid outer product with ``q_gate = k_invalid`` (Mllama's).
    Runs in query chunks of ``CHUNKED_ATTN_ELEMS`` fp32 logits.  A custom
    op, so that a remat policy sees one op (it recomputes it) and not the
    chunks' matmuls; its backward recomputes each chunk."""
    b, s, h, _ = q.shape
    c = _chunk_rows(b, s, h)
    kf = k.float()
    return torch.cat([_masked_attend_chunk(q[:, i:i + c], kf, v,
                                           q_gate[:, i:i + c], k_invalid)
                      for i in range(0, s, c)], dim=1)


@chunked_masked_attention.register_fake
def _(q, k, v, q_gate, k_invalid):
    return torch.empty_like(q)


def _chunked_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _chunked_backward(ctx, dout):
    q, k, v, q_gate, k_invalid = ctx.saved_tensors
    b, s, h, _ = q.shape
    c = _chunk_rows(b, s, h)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        kk = k.detach().requires_grad_(True)
        vv = v.detach().requires_grad_(True)
        for i in range(0, s, c):
            qc = q[:, i:i + c].detach().requires_grad_(True)
            out = _masked_attend_chunk(qc, kk.float(), vv,
                                       q_gate[:, i:i + c], k_invalid)
            gq, gk, gv = torch.autograd.grad(out, (qc, kk, vv),
                                             dout[:, i:i + c])
            dq[:, i:i + c] = gq
            dk += gk.float()
            dv += gv.float()
    return dq, dk.to(k.dtype), dv.to(v.dtype), None, None


chunked_masked_attention.register_autograd(_chunked_backward,
                                           setup_context=_chunked_setup)


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     attention_mask: torch.Tensor | None = None,
                     window: int | None = None) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention through the
    kernel.  q: (B, L, H, D); k, v: (B, L, KH, D), read as they are (no GQA
    repeat).  ``attention_mask``: (B, L) padding over keys.  ``window``:
    keys ``window`` or more positions back are masked and their tiles
    skipped."""
    if q.shape[1] != k.shape[1]:
        raise ValueError('splash_attention is self-attention only '
                         f'(L {q.shape[1]} != S {k.shape[1]})')
    return flash_attention(q, k, v, attention_mask, causal=True,
                           window=window)


def resolved_impl_name(impl: str, q_len: int, kv_len: int) -> str:
    """Which path :func:`causal_attention` takes: 'flash' (the kernel,
    which stands for both TPU kernels), 'xla' or 'ring'.  Unlike the TPU
    dispatch it needs no head dim or causal flag: the kernel takes any
    self-attention call, and raises on the card for a head dim outside
    ``flash_attention.SUPPORTED_HEAD_DIMS``."""
    if impl not in IMPLS:
        raise ValueError(f'unknown attention impl {impl!r}')
    if impl == 'ring':
        return 'ring'
    if impl == 'xla' or q_len != kv_len:
        return 'xla'
    return 'flash'


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     attention_mask: torch.Tensor | None = None,
                     causal: bool = True, impl: str = 'auto',
                     window: int | None = None) -> torch.Tensor:
    """Dispatching attention entry point used by the models.

    q: (B, L, H, D); k, v: (B, S, KH, D) with KH dividing H (GQA).
    ``attention_mask``: (B, S) over key positions (padding mask).
    ``window``: causal self-attention that also masks keys ``window`` or
    more positions back.  'auto', 'flash' and 'splash' run the kernel (its
    plain version on a CPU tensor); 'xla' is the plain ``xla_attention``,
    or with a window JAX's masked fallback (``_windowed_masked``).  On a
    CUDA tensor a call the kernel cannot take raises."""
    name = resolved_impl_name(impl, q.shape[1], k.shape[1])
    if name == 'ring':
        raise NotImplementedError("impl='ring' (sequence-parallel ring "
                                  'attention) is not ported yet')
    if window is not None and not (causal and q.shape[1] == k.shape[1]):
        raise ValueError('a window needs causal self-attention')
    if name == 'xla':
        # impl='xla', or cross-attention (L != S): the JAX dispatcher sends
        # L != S to XLA as well, and the kernel is self-attention only
        if window is not None:
            return _windowed_masked(q, k, v, attention_mask, window)
        return xla_attention(q, k, v, attention_mask, causal)
    return flash_attention(q, k, v, attention_mask, causal=causal,
                           window=window)


def _windowed_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     attention_mask: torch.Tensor | None,
                     window: int) -> torch.Tensor:
    """JAX's masked fallback of ``windowed_causal_attention``
    (``ops/attention.py:281-291``) for a sliding layer: causal, keys fewer
    than ``window`` positions back, key padding, through the decoder's
    ``_masked_attention``."""
    # models/transformer.py imports this module
    from align_anything_tpu_torch.models.transformer import (  # noqa: PLC0415
        _masked_attention)

    l = q.shape[1]
    q_idx = torch.arange(l, device=q.device)[:, None]
    k_idx = torch.arange(l, device=q.device)[None, :]
    mask = ((k_idx <= q_idx) & ((q_idx - k_idx) < window))[None, None]
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, None, :].to(torch.bool)
    return _masked_attention(q, k.transpose(1, 2), v.transpose(1, 2), mask)


def windowed_causal_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              attention_mask: torch.Tensor | None,
                              window: int, layer_flag: int,
                              impl: str = 'auto') -> torch.Tensor:
    """Gemma3-class interleaved attention: ``layer_flag`` (1 = sliding
    layer, a Python int) selects windowed or full causal self-attention.
    The kernel takes both, the window skipping the key tiles behind it
    (JAX's two splash kernels under ``lax.cond``); with ``impl='xla'`` a
    sliding layer takes JAX's masked fallback."""
    return causal_attention(q, k, v, attention_mask, causal=True, impl=impl,
                            window=window if layer_flag > 0 else None)
