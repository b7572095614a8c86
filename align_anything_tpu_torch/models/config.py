"""Model architecture configs: the JAX package's ``ModelConfig`` (same
fields, same defaults), the OPT / Llama-3 / Qwen2 / Qwen3-MoE / tiny
makers, the JAX presets, and ``config_from_hf``.

One generic decoder covers the Llama-class text families, Gemma3's
interleaved sliding-window layers and the top-k routed mixture of experts
included.  ``models/transformer.py`` ``check_supported`` raises
``NotImplementedError`` for the switches the port does not run (pipeline
stages), and ``config_from_hf`` raises through it for a checkpoint that
needs one.

The MoE presets copy the JAX package's, not the published Qwen3-MoE
config: ``qwen3-moe-30b-a3b`` has 64 experts (transformers'
``Qwen3MoeConfig`` has 128), no q/k norm, and always renormalises the
top-k weights (ROADMAP R33).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    mlp_dim: int
    max_position_embeddings: int = 4096

    # architecture switches
    positional: str = 'rope'          # 'rope' | 'learned'
    norm: str = 'rmsnorm'             # 'rmsnorm' | 'layernorm'
    activation: str = 'silu'          # 'silu' (gated) | 'relu' | 'gelu'
    gated_mlp: bool = True
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    tie_word_embeddings: bool = False
    learned_pos_offset: int = 0       # OPT writes positions at offset 2
    rope_theta: float = 10000.0
    # Llama-3.1 rope scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = unscaled
    rope_llama3: tuple[float, float, float, int] | None = None
    norm_eps: float = 1e-6
    final_logit_softcap: float | None = None
    # Qwen2-VL m-rope: per-section (t, h, w) position streams
    mrope_section: tuple[int, ...] | None = None
    # query/key normalization before RoPE: 'rmsnorm' (shared (D,) weight,
    # Qwen3) | 'layernorm_ph' (per-head affine, Chameleon)
    qk_norm: str | None = None
    qk_norm_eps: float = 1e-6
    # Gemma-family extensions
    norm_plus_one: bool = False       # RMSNorm scales by (1 + w)
    sandwich_norms: bool = False      # post-attention & post-MLP norms
    embedding_scale: float | None = None  # x *= scale after embedding
    attn_scale: float | None = None   # attention scale override
    sliding_window: int | None = None
    rope_local_theta: float | None = None  # rope theta for sliding layers
    # per-layer attention type: 1 = sliding window, 0 = full (None = full)
    layer_is_sliding: tuple[int, ...] | None = None
    # MoE dispatch: 'dense' (every expert on every token, the top-k weights
    # select) | 'sparse' (tokens sorted by expert, one product per expert
    # over its rows); any other value runs dense, as in JAX
    moe_impl: str = 'dense'

    # mixture of experts (0 = dense; Qwen3-MoE-class when > 0)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    router_aux_coef: float = 0.0

    # runtime
    compute_dtype: str = 'bfloat16'
    attention_impl: str = 'auto'      # 'auto' | 'flash' | 'splash' | 'xla'
    remat: str = 'none'               # transformer.REMAT_POLICIES
    pp_stages: int = 1
    pp_microbatches: int = 0

    # tokens
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0

    # padded-embedding models: vocab_size is the padded size, logits are
    # sliced back to true_vocab_size
    true_vocab_size: int | None = None

    def replace(self, **kwargs) -> 'ModelConfig':
        return dataclasses.replace(self, **kwargs)


def opt_config(vocab_size: int = 50272, hidden: int = 768, layers: int = 12,
               heads: int = 12, mlp: int = 3072, max_pos: int = 2048,
               **kw) -> ModelConfig:
    """OPT family (reference models/opt.py wrapper; arch per HF OPTConfig)."""
    return ModelConfig(
        vocab_size=vocab_size, hidden_size=hidden, num_layers=layers,
        num_heads=heads, num_kv_heads=heads, head_dim=hidden // heads,
        mlp_dim=mlp, max_position_embeddings=max_pos,
        positional='learned', norm='layernorm', activation='relu',
        gated_mlp=False, qkv_bias=True, attn_out_bias=True, mlp_bias=True,
        tie_word_embeddings=True, learned_pos_offset=2, norm_eps=1e-5,
        bos_token_id=2, eos_token_id=2, pad_token_id=1, **kw,
    )


def llama_config(vocab_size: int = 128256, hidden: int = 4096, layers: int = 32,
                 heads: int = 32, kv_heads: int = 8, mlp: int = 14336,
                 max_pos: int = 8192, rope_theta: float = 500000.0,
                 **kw) -> ModelConfig:
    """Llama-3 family (Llama-3-8B geometry by default)."""
    return ModelConfig(
        vocab_size=vocab_size, hidden_size=hidden, num_layers=layers,
        num_heads=heads, num_kv_heads=kv_heads, head_dim=hidden // heads,
        mlp_dim=mlp, max_position_embeddings=max_pos, rope_theta=rope_theta,
        bos_token_id=128000, eos_token_id=128001, pad_token_id=128001, **kw,
    )


def qwen2_config(vocab_size: int = 151936, hidden: int = 3584, layers: int = 28,
                 heads: int = 28, kv_heads: int = 4, mlp: int = 18944,
                 max_pos: int = 32768, rope_theta: float = 1000000.0,
                 **kw) -> ModelConfig:
    """Qwen2/Qwen2.5 family (reference models/qwen2.py wrapper)."""
    return ModelConfig(
        vocab_size=vocab_size, hidden_size=hidden, num_layers=layers,
        num_heads=heads, num_kv_heads=kv_heads, head_dim=hidden // heads,
        mlp_dim=mlp, max_position_embeddings=max_pos, rope_theta=rope_theta,
        qkv_bias=True, bos_token_id=151643, eos_token_id=151645,
        pad_token_id=151643, **kw,
    )


def qwen3_moe_config(vocab_size: int = 151936, hidden: int = 2048,
                     layers: int = 24, heads: int = 32, kv_heads: int = 4,
                     mlp: int = 768, num_experts: int = 64, top_k: int = 8,
                     max_pos: int = 32768, **kw) -> ModelConfig:
    """Qwen3-MoE family as the JAX package defines it (reference
    models/qwen3_moe.py wrapper).  ``mlp`` is the per-expert intermediate
    size; the router's balancing loss is weighed by ``router_aux_coef``."""
    return ModelConfig(
        vocab_size=vocab_size, hidden_size=hidden, num_layers=layers,
        num_heads=heads, num_kv_heads=kv_heads, head_dim=hidden // heads,
        mlp_dim=mlp, max_position_embeddings=max_pos,
        rope_theta=1000000.0, num_experts=num_experts,
        num_experts_per_tok=top_k, router_aux_coef=0.001,
        bos_token_id=151643, eos_token_id=151645, pad_token_id=151643, **kw,
    )


def tiny_config(vocab_size: int = 512, hidden: int = 64, layers: int = 2,
                heads: int = 4, kv_heads: int = 2, mlp: int = 128,
                max_pos: int = 256, **kw) -> ModelConfig:
    """Tiny debug/test model (llama-style)."""
    return ModelConfig(
        vocab_size=vocab_size, hidden_size=hidden, num_layers=layers,
        num_heads=heads, num_kv_heads=kv_heads, head_dim=hidden // heads,
        mlp_dim=mlp, max_position_embeddings=max_pos, **kw,
    )


PRESETS = {
    'opt-125m': lambda: opt_config(),
    'opt-350m': lambda: opt_config(hidden=1024, layers=24, heads=16, mlp=4096),
    'opt-1.3b': lambda: opt_config(hidden=2048, layers=24, heads=32, mlp=8192),
    'llama-3-8b': lambda: llama_config(),
    'llama-3-1b': lambda: llama_config(hidden=2048, layers=16, heads=32,
                                       kv_heads=8, mlp=8192),
    'qwen2-7b': lambda: qwen2_config(),
    'qwen2-0.5b': lambda: qwen2_config(hidden=896, layers=24, heads=14,
                                       kv_heads=2, mlp=4864),
    'qwen3-moe-30b-a3b': lambda: qwen3_moe_config(),
    'tiny': lambda: tiny_config(),
    'tiny-moe': lambda: tiny_config(num_experts=4, num_experts_per_tok=2,
                                    router_aux_coef=0.01),
}


_HF_ARCH_MAP = {
    'OPTForCausalLM': 'opt',
    'LlamaForCausalLM': 'llama',
    'Qwen2ForCausalLM': 'qwen2',
    'Qwen3ForCausalLM': 'qwen3',
    'ChameleonForConditionalGeneration': 'chameleon',
    'ChameleonForCausalLM': 'chameleon',
    'Gemma3ForCausalLM': 'gemma3',
    # Emu3 (BAAI) any-to-any: the LM trunk is llama-architecture over a
    # text+visual-code vocabulary (reference vendors it wholesale at
    # models/modeling_emu3/mllm/modeling_emu3.py; here the HF text config
    # maps straight onto the generic decoder)
    'Emu3ForCausalLM': 'llama',
    'Emu3ForConditionalGeneration': 'emu3',
}


def config_from_hf(path: str) -> ModelConfig:
    """Build a ModelConfig from an HF-layout ``config.json`` directory.

    Replaces the reference's transformers AutoConfig dependency for the
    decoder families we implement natively
    (reference: models/model_registry.py:84-104).  The JAX function, then
    ``check_supported``: a config the port cannot run raises
    ``NotImplementedError``.
    """
    with open(os.path.join(path, 'config.json')) as f:
        hf: dict[str, Any] = json.load(f)
    arch = _HF_ARCH_MAP.get((hf.get('architectures') or ['?'])[0])
    if arch == 'emu3':
        # Emu3ForConditionalGeneration nests the LM trunk under text_config
        # (the vqmodel codec loads separately via emu3_vq.load_emu3_vq)
        hf = hf['text_config']
        arch = 'llama'
    if arch == 'opt':
        cfg = opt_config(
            vocab_size=hf['vocab_size'], hidden=hf['hidden_size'],
            layers=hf['num_hidden_layers'], heads=hf['num_attention_heads'],
            mlp=hf['ffn_dim'], max_pos=hf['max_position_embeddings'],
        )
    elif arch == 'gemma3':
        # Gemma3 text (HF Gemma3TextConfig): (1+w) RMSNorm, sandwich
        # norms, q/k RMSNorm, scaled embeddings, interleaved
        # sliding/full attention with separate rope frequencies
        head_dim = hf.get('head_dim', 256)
        layer_types = hf.get('layer_types') or []
        n_layers = hf['num_hidden_layers']
        if not layer_types:
            pattern = hf.get('sliding_window_pattern', 6)
            layer_types = ['full_attention' if (i + 1) % pattern == 0
                           else 'sliding_attention' for i in range(n_layers)]
        cfg = llama_config(
            vocab_size=hf['vocab_size'], hidden=hf['hidden_size'],
            layers=n_layers, heads=hf['num_attention_heads'],
            kv_heads=hf.get('num_key_value_heads',
                            hf['num_attention_heads']),
            mlp=hf['intermediate_size'],
            max_pos=hf['max_position_embeddings'],
            rope_theta=hf.get('rope_theta', 1_000_000.0),
        )
        cfg = cfg.replace(
            head_dim=head_dim,
            norm_eps=hf.get('rms_norm_eps', 1e-6),
            tie_word_embeddings=hf.get('tie_word_embeddings', True),
            activation='gelu',  # gelu_pytorch_tanh == jax.nn.gelu (tanh)
            qk_norm='rmsnorm',
            qk_norm_eps=hf.get('rms_norm_eps', 1e-6),
            norm_plus_one=True,
            sandwich_norms=True,
            embedding_scale=float(hf['hidden_size']) ** 0.5,
            attn_scale=float(hf.get('query_pre_attn_scalar',
                                    head_dim)) ** -0.5,
            sliding_window=hf.get('sliding_window', 4096),
            rope_local_theta=hf.get('rope_local_base_freq', 10_000.0),
            layer_is_sliding=tuple(
                1 if t == 'sliding_attention' else 0 for t in layer_types),
            final_logit_softcap=hf.get('final_logit_softcapping'),
        )
    elif arch in ('llama', 'qwen2', 'qwen3', 'chameleon'):
        maker = qwen2_config if arch == 'qwen2' else llama_config
        cfg = maker(
            vocab_size=hf['vocab_size'], hidden=hf['hidden_size'],
            layers=hf['num_hidden_layers'], heads=hf['num_attention_heads'],
            kv_heads=hf.get('num_key_value_heads', hf['num_attention_heads']),
            mlp=hf['intermediate_size'],
            max_pos=hf['max_position_embeddings'],
            rope_theta=hf.get('rope_theta', 10000.0),
        )
        cfg = cfg.replace(
            norm_eps=hf.get('rms_norm_eps', 1e-6),
            tie_word_embeddings=hf.get('tie_word_embeddings', False),
        )
        if hf.get('head_dim'):
            cfg = cfg.replace(head_dim=hf['head_dim'])
        rs = hf.get('rope_scaling') or {}
        if rs.get('rope_type', rs.get('type')) == 'llama3':
            # Llama-3.1 frequency-banded NTK scaling
            cfg = cfg.replace(rope_llama3=(
                float(rs['factor']), float(rs['low_freq_factor']),
                float(rs['high_freq_factor']),
                int(rs['original_max_position_embeddings'])))
        if arch == 'qwen3':
            # Qwen3 = llama + RMSNorm on q/k heads (no qkv bias)
            cfg = cfg.replace(qk_norm='rmsnorm',
                              qk_norm_eps=hf.get('rms_norm_eps', 1e-6))
        elif arch == 'chameleon':
            # Chameleon-7B = llama + per-head LayerNorm on q/k before RoPE
            # (reference models/chameleon.py wraps the HF class; the 30B
            # swin-norm layer order is not supported)
            if hf.get('swin_norm'):
                raise ValueError('Chameleon swin_norm checkpoints (30B) are '
                                 'not supported')
            cfg = cfg.replace(qk_norm='layernorm_ph', qk_norm_eps=1e-5)
    else:
        raise ValueError(f'unsupported HF architecture in {path}: '
                         f'{hf.get("architectures")}')
    eos = hf.get('eos_token_id', cfg.eos_token_id)
    if isinstance(eos, list):
        eos = eos[0]
    bos = hf.get('bos_token_id', cfg.bos_token_id) or cfg.bos_token_id
    # checkpoints without an explicit pad token reuse EOS; ids outside the
    # checkpoint's vocab (common in shrunken test configs that keep family
    # defaults) are clamped so they stay embeddable
    pad = hf.get('pad_token_id') if hf.get('pad_token_id') is not None else eos
    vocab = cfg.vocab_size
    eos, bos, pad = (t if t is not None and t < vocab else vocab - 1
                     for t in (eos, bos, pad))
    cfg = cfg.replace(bos_token_id=bos, eos_token_id=eos, pad_token_id=pad)
    # models/transformer.py imports this module
    from align_anything_tpu_torch.models.transformer import (  # noqa: PLC0415
        check_supported,
    )

    check_supported(cfg)
    return cfg
