"""HF checkpoint interop: safetensors <-> stacked-layer param trees.

The port of the decoder part of ``align_anything_tpu/models/hf_loader.py``:
``load_params`` reads an HF-layout directory (``config.json`` +
``*.safetensors`` [+ ``model.safetensors.index.json``]) of an OPT, Llama or
Qwen2 checkpoint (and the Llama-layout families ``config_from_hf`` maps
onto the same decoder) into the port's param tree, and ``save_params``
writes one back in HF layout.  Same tree, same layouts and the same HF
tensor names as the JAX module.

The safetensors files are read and written by this module's own small
codec (``read_safetensors`` / ``write_safetensors``: an 8-byte little-endian
header length, a JSON header of dtype, shape and byte offsets per tensor,
then the raw little-endian data), so the port needs no ``safetensors``
package.  Tensors are moved to the requested device one at a time and
laid out there.

Not ported: the multimodal loaders and savers (LLaVA, Qwen2-VL, audio,
MLlama, MiniCPM, Emu3's fused codec layout), which wait for the multimodal
slice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from align_anything_tpu_torch.models.config import ModelConfig, config_from_hf
from align_anything_tpu_torch.utils.tools import default_device

# ---------------------------------------------------------------------------
# safetensors codec
# ---------------------------------------------------------------------------

_DTYPES = {
    'F64': torch.float64, 'F32': torch.float32, 'F16': torch.float16,
    'BF16': torch.bfloat16, 'I64': torch.int64, 'I32': torch.int32,
    'I16': torch.int16, 'I8': torch.int8, 'U8': torch.uint8,
    'BOOL': torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """name -> CPU tensor of one ``.safetensors`` file.  The data is
    memory-mapped copy-on-write: a tensor is read from disk when it is
    first touched, and writing to it never reaches the file."""
    with open(path, 'rb') as f:
        n = int.from_bytes(f.read(8), 'little')
        header = json.loads(f.read(n))
    header.pop('__metadata__', None)
    if not header:
        return {}
    data = np.memmap(path, dtype=np.uint8, mode='c', offset=8 + n)
    out = {}
    for name, info in header.items():
        begin, end = info['data_offsets']
        dtype = _DTYPES[info['dtype']]
        if end == begin:
            out[name] = torch.empty(info['shape'], dtype=dtype)
            continue
        flat = torch.frombuffer(data, dtype=torch.uint8, count=end - begin,
                                offset=begin)
        out[name] = flat.view(dtype).reshape(info['shape'])
    return out


def write_safetensors(path: str, tensors: dict[str, torch.Tensor],
                      metadata: dict[str, str] | None = None,
                      dtype: torch.dtype | None = None) -> None:
    """Write ``tensors`` in the safetensors format, readable by the
    ``safetensors`` package.  Each tensor is cast to ``dtype`` (if given)
    and laid out on its own device, then copied to the host, one at a
    time."""
    header: dict[str, Any] = {}
    if metadata:
        header['__metadata__'] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        out_dtype = dtype or t.dtype
        nbytes = t.numel() * torch.empty((), dtype=out_dtype).element_size()
        header[name] = {'dtype': _NAMES[out_dtype], 'shape': list(t.shape),
                        'data_offsets': [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(',', ':')).encode()
    raw += b' ' * (-len(raw) % 8)        # the data starts 8-byte aligned
    with open(path, 'wb') as f:
        f.write(len(raw).to_bytes(8, 'little'))
        f.write(raw)
        for t in tensors.values():
            host = t.detach().to(dtype or t.dtype).contiguous().to('cpu')
            f.write(host.reshape(-1).view(torch.uint8).numpy().data)


def _read_all_tensors(path: str) -> dict[str, torch.Tensor]:
    index_path = os.path.join(path, 'model.safetensors.index.json')
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        files = sorted(set(index['weight_map'].values()))
    else:
        files = [f for f in sorted(os.listdir(path))
                 if f.endswith('.safetensors')]
    tensors: dict[str, torch.Tensor] = {}
    for fname in files:
        tensors.update(read_safetensors(os.path.join(path, fname)))
    return tensors


class _OnDevice:
    """The checkpoint's tensors, each copied to ``device`` in ``dtype`` when
    it is looked up (never a view of the file's mapping)."""

    def __init__(self, tensors: dict[str, torch.Tensor],
                 device: torch.device, dtype: torch.dtype):
        self.tensors, self.device, self.dtype = tensors, device, dtype

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.tensors[name].to(device=self.device, dtype=self.dtype,
                                     copy=True)

    def __iter__(self):
        return iter(self.tensors)


def _stack(tensors: _OnDevice, pattern: str, n: int,
           transform: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    return torch.stack([transform(tensors[pattern.format(i=i)])
                        for i in range(n)])


def _T(w: torch.Tensor) -> torch.Tensor:
    return w.T.contiguous()


def _same(w: torch.Tensor) -> torch.Tensor:
    return w


def _qkv_in(e: int, heads: int, d: int):
    """HF (heads*d, E) projection weight -> ours (E, heads, d)."""
    return lambda w: w.T.contiguous().reshape(e, heads, d)


def _o_in(e: int, heads: int, d: int):
    """HF (E, heads*d) out-proj -> ours (heads, d, E)."""
    return lambda w: w.T.reshape(heads, d, e).contiguous()


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def load_params(path: str, config: ModelConfig | None = None,
                dtype: torch.dtype = torch.float32,
                pad_vocab_multiple: int = 1,
                device: torch.device | str | None = None
                ) -> tuple[dict, ModelConfig]:
    """Load an HF checkpoint directory into (params, config), with every
    leaf on ``device`` (default: the first CUDA device) in ``dtype``.

    ``pad_vocab_multiple``: zero-pad the embedding (and lm_head) rows so the
    vocab dim is a multiple of it; logits are sliced back to the true vocab
    inside ``forward``.
    """
    device = default_device(device)
    if config is None:
        config = config_from_hf(path)
    raw = _read_all_tensors(path)
    if any(k.startswith(('model.text_model.', 'text_model.model.'))
           for k in raw):
        raise NotImplementedError('Emu3 checkpoints (the LM fused with its '
                                  'VQ codec) are not ported yet')
    tensors = _OnDevice(raw, device, dtype)
    is_opt = any(k.startswith('model.decoder.') for k in raw)
    params = (_load_opt if is_opt else _load_llama_like)(tensors, config)
    if pad_vocab_multiple > 1 and config.vocab_size % pad_vocab_multiple:
        true_vocab = config.vocab_size
        padded = -(-true_vocab // pad_vocab_multiple) * pad_vocab_multiple
        params['embedding'] = F.pad(params['embedding'],
                                    (0, 0, 0, padded - true_vocab))
        if 'lm_head' in params:
            params['lm_head'] = F.pad(params['lm_head'],
                                      (0, padded - true_vocab))
        config = config.replace(vocab_size=padded, true_vocab_size=true_vocab)
    return params, config


def _load_opt(t: _OnDevice, c: ModelConfig) -> dict:
    n, e, h, d = c.num_layers, c.hidden_size, c.num_heads, c.head_dim
    pre = 'model.decoder.layers.{i}.'
    heads = lambda x: x.reshape(h, d)  # noqa: E731
    layers = {
        'attn_norm': {
            'w': _stack(t, pre + 'self_attn_layer_norm.weight', n, _same),
            'b': _stack(t, pre + 'self_attn_layer_norm.bias', n, _same),
        },
        'q': {'w': _stack(t, pre + 'self_attn.q_proj.weight', n, _qkv_in(e, h, d)),
              'b': _stack(t, pre + 'self_attn.q_proj.bias', n, heads)},
        'k': {'w': _stack(t, pre + 'self_attn.k_proj.weight', n, _qkv_in(e, h, d)),
              'b': _stack(t, pre + 'self_attn.k_proj.bias', n, heads)},
        'v': {'w': _stack(t, pre + 'self_attn.v_proj.weight', n, _qkv_in(e, h, d)),
              'b': _stack(t, pre + 'self_attn.v_proj.bias', n, heads)},
        'o': {'w': _stack(t, pre + 'self_attn.out_proj.weight', n, _o_in(e, h, d)),
              'b': _stack(t, pre + 'self_attn.out_proj.bias', n, _same)},
        'mlp_norm': {
            'w': _stack(t, pre + 'final_layer_norm.weight', n, _same),
            'b': _stack(t, pre + 'final_layer_norm.bias', n, _same),
        },
        'up': {'w': _stack(t, pre + 'fc1.weight', n, _T),
               'b': _stack(t, pre + 'fc1.bias', n, _same)},
        'down': {'w': _stack(t, pre + 'fc2.weight', n, _T),
                 'b': _stack(t, pre + 'fc2.bias', n, _same)},
    }
    return {
        'embedding': t['model.decoder.embed_tokens.weight'],
        'pos_embedding': t['model.decoder.embed_positions.weight'],
        'layers': layers,
        'final_norm': {
            'w': t['model.decoder.final_layer_norm.weight'],
            'b': t['model.decoder.final_layer_norm.bias'],
        },
    }


def _load_llama_like(t: _OnDevice, c: ModelConfig) -> dict:
    n, e = c.num_layers, c.hidden_size
    h, kh, d = c.num_heads, c.num_kv_heads, c.head_dim
    pre = 'model.layers.{i}.'
    layers: dict[str, Any] = {
        'attn_norm': {'w': _stack(t, pre + 'input_layernorm.weight', n, _same)},
        'q': {'w': _stack(t, pre + 'self_attn.q_proj.weight', n, _qkv_in(e, h, d))},
        'k': {'w': _stack(t, pre + 'self_attn.k_proj.weight', n, _qkv_in(e, kh, d))},
        'v': {'w': _stack(t, pre + 'self_attn.v_proj.weight', n, _qkv_in(e, kh, d))},
        'o': {'w': _stack(t, pre + 'self_attn.o_proj.weight', n, _o_in(e, h, d))},
        # Gemma3 sandwich norms: the MLP's pre-norm is a separate tensor
        'mlp_norm': {'w': _stack(
            t, pre + ('pre_feedforward_layernorm.weight' if c.sandwich_norms
                      else 'post_attention_layernorm.weight'), n, _same)},
        'gate': {'w': _stack(t, pre + 'mlp.gate_proj.weight', n, _T)},
        'up': {'w': _stack(t, pre + 'mlp.up_proj.weight', n, _T)},
        'down': {'w': _stack(t, pre + 'mlp.down_proj.weight', n, _T)},
    }
    if c.sandwich_norms:
        layers['post_attn_norm'] = {'w': _stack(
            t, pre + 'post_attention_layernorm.weight', n, _same)}
        layers['post_mlp_norm'] = {'w': _stack(
            t, pre + 'post_feedforward_layernorm.weight', n, _same)}
    if c.qkv_bias:
        layers['q']['b'] = _stack(t, pre + 'self_attn.q_proj.bias', n,
                                  lambda x: x.reshape(h, d))
        layers['k']['b'] = _stack(t, pre + 'self_attn.k_proj.bias', n,
                                  lambda x: x.reshape(kh, d))
        layers['v']['b'] = _stack(t, pre + 'self_attn.v_proj.bias', n,
                                  lambda x: x.reshape(kh, d))
    if c.qk_norm == 'rmsnorm':  # Qwen3: (head_dim,) per layer
        layers['q_norm'] = {'w': _stack(t, pre + 'self_attn.q_norm.weight',
                                        n, _same)}
        layers['k_norm'] = {'w': _stack(t, pre + 'self_attn.k_norm.weight',
                                        n, _same)}
    elif c.qk_norm == 'layernorm_ph':  # Chameleon: (heads, head_dim)
        layers['q_norm'] = {
            'w': _stack(t, pre + 'self_attn.q_norm.weight', n,
                        lambda x: x.reshape(h, d)),
            'b': _stack(t, pre + 'self_attn.q_norm.bias', n,
                        lambda x: x.reshape(h, d))}
        layers['k_norm'] = {
            'w': _stack(t, pre + 'self_attn.k_norm.weight', n,
                        lambda x: x.reshape(kh, d)),
            'b': _stack(t, pre + 'self_attn.k_norm.bias', n,
                        lambda x: x.reshape(kh, d))}
    params: dict[str, Any] = {
        'embedding': t['model.embed_tokens.weight'],
        'layers': layers,
        'final_norm': {'w': t['model.norm.weight']},
    }
    if not c.tie_word_embeddings:
        params['lm_head'] = _T(t['lm_head.weight'])
    return params


# ---------------------------------------------------------------------------
# save (HF layout)
# ---------------------------------------------------------------------------

def save_params(path: str, params: dict, config: ModelConfig,
                hf_config_extra: dict | None = None,
                dtype: torch.dtype = torch.float32) -> None:
    """Write params back as a single HF-layout safetensors checkpoint, every
    tensor in ``dtype`` (float32, as the JAX module writes, by default)."""
    os.makedirs(path, exist_ok=True)
    if config.true_vocab_size is not None and config.true_vocab_size != config.vocab_size:
        params = dict(params)
        params['embedding'] = params['embedding'][:config.true_vocab_size]
        if 'lm_head' in params:
            params['lm_head'] = params['lm_head'][:, :config.true_vocab_size]
        config = config.replace(vocab_size=config.true_vocab_size,
                                true_vocab_size=None)
    is_opt = config.positional == 'learned'
    tensors = (_dump_opt if is_opt else _dump_llama_like)(params, config)
    write_safetensors(os.path.join(path, 'model.safetensors'), tensors,
                      metadata={'format': 'pt'}, dtype=dtype)
    hf_cfg = _to_hf_config(config)
    hf_cfg['torch_dtype'] = str(dtype).removeprefix('torch.')
    hf_cfg.update(hf_config_extra or {})
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(hf_cfg, f, indent=2)


def _to_hf_config(c: ModelConfig) -> dict:
    if c.positional == 'learned':
        return {
            'architectures': ['OPTForCausalLM'], 'model_type': 'opt',
            'vocab_size': c.vocab_size, 'hidden_size': c.hidden_size,
            'num_hidden_layers': c.num_layers,
            'num_attention_heads': c.num_heads, 'ffn_dim': c.mlp_dim,
            'max_position_embeddings': c.max_position_embeddings,
            'word_embed_proj_dim': c.hidden_size,
            'do_layer_norm_before': True, 'activation_function': 'relu',
            'bos_token_id': c.bos_token_id, 'eos_token_id': c.eos_token_id,
            'pad_token_id': c.pad_token_id, 'torch_dtype': 'float32',
        }
    if c.qk_norm == 'rmsnorm':
        arch, model_type = 'Qwen3ForCausalLM', 'qwen3'
    elif c.qk_norm == 'layernorm_ph':
        arch, model_type = 'ChameleonForConditionalGeneration', 'chameleon'
    elif c.qkv_bias:
        arch, model_type = 'Qwen2ForCausalLM', 'qwen2'
    else:
        arch, model_type = 'LlamaForCausalLM', 'llama'
    out = {
        'architectures': [arch],
        'model_type': model_type,
        'head_dim': c.head_dim,
        'vocab_size': c.vocab_size, 'hidden_size': c.hidden_size,
        'num_hidden_layers': c.num_layers, 'num_attention_heads': c.num_heads,
        'num_key_value_heads': c.num_kv_heads,
        'intermediate_size': c.mlp_dim,
        'max_position_embeddings': c.max_position_embeddings,
        'rope_theta': c.rope_theta, 'rms_norm_eps': c.norm_eps,
        'tie_word_embeddings': c.tie_word_embeddings,
        'hidden_act': 'silu',
        'bos_token_id': c.bos_token_id, 'eos_token_id': c.eos_token_id,
        'pad_token_id': c.pad_token_id, 'torch_dtype': 'float32',
    }
    if c.rope_llama3 is not None:
        factor, low, high, orig = c.rope_llama3
        out['rope_scaling'] = {
            'rope_type': 'llama3', 'factor': factor,
            'low_freq_factor': low, 'high_freq_factor': high,
            'original_max_position_embeddings': orig,
        }
    return out


def _unstack(stacked: torch.Tensor, pattern: str,
             transform: Callable[[torch.Tensor], torch.Tensor]) -> dict:
    return {pattern.format(i=i): transform(stacked[i])
            for i in range(stacked.shape[0])}


def _dump_opt(p: dict, c: ModelConfig) -> dict:
    e, h, d = c.hidden_size, c.num_heads, c.head_dim
    lp = p['layers']
    pre = 'model.decoder.layers.{i}.'
    out: dict[str, torch.Tensor] = {
        'model.decoder.embed_tokens.weight': p['embedding'],
        'model.decoder.embed_positions.weight': p['pos_embedding'],
        'model.decoder.final_layer_norm.weight': p['final_norm']['w'],
        'model.decoder.final_layer_norm.bias': p['final_norm']['b'],
        'lm_head.weight': p['embedding'],
    }
    qkv_out = lambda w: w.reshape(e, h * d).T  # noqa: E731
    o_out = lambda w: w.reshape(h * d, e).T  # noqa: E731
    flat = lambda x: x.reshape(-1)  # noqa: E731
    out.update(_unstack(lp['attn_norm']['w'], pre + 'self_attn_layer_norm.weight', _same))
    out.update(_unstack(lp['attn_norm']['b'], pre + 'self_attn_layer_norm.bias', _same))
    for name in ('q', 'k', 'v'):
        out.update(_unstack(lp[name]['w'], pre + f'self_attn.{name}_proj.weight', qkv_out))
        out.update(_unstack(lp[name]['b'], pre + f'self_attn.{name}_proj.bias', flat))
    out.update(_unstack(lp['o']['w'], pre + 'self_attn.out_proj.weight', o_out))
    out.update(_unstack(lp['o']['b'], pre + 'self_attn.out_proj.bias', _same))
    out.update(_unstack(lp['mlp_norm']['w'], pre + 'final_layer_norm.weight', _same))
    out.update(_unstack(lp['mlp_norm']['b'], pre + 'final_layer_norm.bias', _same))
    out.update(_unstack(lp['up']['w'], pre + 'fc1.weight', lambda w: w.T))
    out.update(_unstack(lp['up']['b'], pre + 'fc1.bias', _same))
    out.update(_unstack(lp['down']['w'], pre + 'fc2.weight', lambda w: w.T))
    out.update(_unstack(lp['down']['b'], pre + 'fc2.bias', _same))
    return out


def _dump_llama_like(p: dict, c: ModelConfig) -> dict:
    e, h, kh, d = c.hidden_size, c.num_heads, c.num_kv_heads, c.head_dim
    lp = p['layers']
    pre = 'model.layers.{i}.'
    out: dict[str, torch.Tensor] = {
        'model.embed_tokens.weight': p['embedding'],
        'model.norm.weight': p['final_norm']['w'],
    }
    if c.tie_word_embeddings:
        out['lm_head.weight'] = p['embedding']
    else:
        out['lm_head.weight'] = p['lm_head'].T
    qkv_out = lambda heads: (lambda w: w.reshape(e, heads * d).T)  # noqa: E731
    out.update(_unstack(lp['attn_norm']['w'], pre + 'input_layernorm.weight', _same))
    out.update(_unstack(lp['q']['w'], pre + 'self_attn.q_proj.weight', qkv_out(h)))
    out.update(_unstack(lp['k']['w'], pre + 'self_attn.k_proj.weight', qkv_out(kh)))
    out.update(_unstack(lp['v']['w'], pre + 'self_attn.v_proj.weight', qkv_out(kh)))
    out.update(_unstack(lp['o']['w'], pre + 'self_attn.o_proj.weight',
                        lambda w: w.reshape(h * d, e).T))
    out.update(_unstack(lp['mlp_norm']['w'], pre + 'post_attention_layernorm.weight',
                        _same))
    out.update(_unstack(lp['gate']['w'], pre + 'mlp.gate_proj.weight', lambda w: w.T))
    out.update(_unstack(lp['up']['w'], pre + 'mlp.up_proj.weight', lambda w: w.T))
    out.update(_unstack(lp['down']['w'], pre + 'mlp.down_proj.weight', lambda w: w.T))
    if c.qkv_bias:
        for name in ('q', 'k', 'v'):
            out.update(_unstack(lp[name]['b'], pre + f'self_attn.{name}_proj.bias',
                                lambda x: x.reshape(-1)))
    if c.qk_norm == 'rmsnorm':
        for name in ('q', 'k'):
            out.update(_unstack(lp[f'{name}_norm']['w'],
                                pre + f'self_attn.{name}_norm.weight', _same))
    elif c.qk_norm == 'layernorm_ph':
        for name in ('q', 'k'):
            out.update(_unstack(lp[f'{name}_norm']['w'],
                                pre + f'self_attn.{name}_norm.weight', _same))
            out.update(_unstack(lp[f'{name}_norm']['b'],
                                pre + f'self_attn.{name}_norm.bias', _same))
    return out
