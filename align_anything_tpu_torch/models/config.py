"""Model architecture configs: the JAX package's ``ModelConfig`` (same
fields, same defaults) and the Llama-3 and tiny presets.

One generic decoder covers the Llama-class text families.  The port runs
the dense, full-attention subset of the switches; ``models/transformer.py``
raises ``NotImplementedError`` for the rest (MoE, pipeline stages, remat,
m-rope, sliding-window layers).
"""

from __future__ import annotations

import dataclasses


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
    # Qwen2-VL m-rope sections (not ported yet)
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
    moe_impl: str = 'dense'

    # mixture of experts (0 = dense)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    router_aux_coef: float = 0.0

    # runtime
    compute_dtype: str = 'bfloat16'
    attention_impl: str = 'auto'      # 'auto' | 'flash' | 'splash' | 'xla'
    remat: str = 'none'               # 'none' | 'full' | 'dots_saveable'
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


def tiny_config(vocab_size: int = 512, hidden: int = 64, layers: int = 2,
                heads: int = 4, kv_heads: int = 2, mlp: int = 128,
                max_pos: int = 256, **kw) -> ModelConfig:
    """Tiny debug/test model (llama-style)."""
    return ModelConfig(
        vocab_size=vocab_size, hidden_size=hidden, num_layers=layers,
        num_heads=heads, num_kv_heads=kv_heads, head_dim=hidden // heads,
        mlp_dim=mlp, max_position_embeddings=max_pos, **kw,
    )
