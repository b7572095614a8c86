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

``load_multimodal_params`` / ``save_multimodal_params`` do the same for a
LLaVA-1.5 checkpoint (``LlavaForConditionalGeneration``: a Llama-layout
language model, a CLIP vision tower and the projector).  Not ported yet
(ROADMAP §1 item 12): LLaVA-Next and LLaVA-Next-Video checkpoints, and the
other multimodal families (Qwen2-VL, audio, MLlama, MiniCPM, Emu3's fused
codec layout).
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


def load_multimodal_params(path: str, dtype: torch.dtype = torch.float32,
                           device: torch.device | str | None = None):
    """Load an HF LLaVA-layout checkpoint into (params, MultimodalConfig),
    every leaf on ``device`` (default: the first CUDA device) in ``dtype``.

    Handles both the ``model.language_model.*`` (transformers >= 4.52) and
    the ``language_model.model.*`` (older) prefixes; the vision tower is
    CLIP-style."""
    from align_anything_tpu_torch.models.multimodal import (  # noqa: PLC0415
        MultimodalConfig,
    )
    from align_anything_tpu_torch.models.vision import ViTConfig  # noqa: PLC0415

    device = default_device(device)
    with open(os.path.join(path, 'config.json')) as f:
        hf = json.load(f)
    if hf.get('model_type') in ('llava_next', 'llava_next_video'):
        raise NotImplementedError(
            f"{hf['model_type']} checkpoints are not ported yet (ROADMAP §1 "
            'item 12: LLaVA-Next AnyRes and video)')
    tc, vc = hf['text_config'], hf['vision_config']
    text_cfg = ModelConfig(
        vocab_size=tc['vocab_size'], hidden_size=tc['hidden_size'],
        num_layers=tc['num_hidden_layers'],
        num_heads=tc['num_attention_heads'],
        num_kv_heads=tc.get('num_key_value_heads', tc['num_attention_heads']),
        head_dim=tc['hidden_size'] // tc['num_attention_heads'],
        mlp_dim=tc['intermediate_size'],
        max_position_embeddings=tc.get('max_position_embeddings', 4096),
        rope_theta=tc.get('rope_theta', 10000.0),
        norm_eps=tc.get('rms_norm_eps', 1e-6),
        qkv_bias=tc.get('model_type') == 'qwen2',
        tie_word_embeddings=hf.get('tie_word_embeddings',
                                   tc.get('tie_word_embeddings', False)),
        bos_token_id=tc.get('bos_token_id', 1) or 1,
        eos_token_id=tc.get('eos_token_id', 2) or 2,
        pad_token_id=hf.get('pad_token_id') or tc.get('pad_token_id')
        or tc.get('eos_token_id', 2),
    )
    vision_cfg = ViTConfig(
        image_size=vc['image_size'], patch_size=vc['patch_size'],
        hidden_size=vc['hidden_size'], num_layers=vc['num_hidden_layers'],
        num_heads=vc['num_attention_heads'], mlp_dim=vc['intermediate_size'],
        activation=vc.get('hidden_act', 'quick_gelu'),
        feature_layer=hf.get('vision_feature_layer', -2),
        feature_select=('default'
                        if hf.get('vision_feature_select_strategy',
                                  'default') == 'default' else 'full'),
    )

    raw = _read_all_tensors(path)
    # normalize the prefixes to language_model.* / vision_tower.* /
    # multi_modal_projector.*
    norm: dict[str, torch.Tensor] = {}
    for k, v in raw.items():
        k = k.removeprefix('model.')
        norm[k.replace('language_model.model.', 'language_model.')] = v
    lm_raw = {}
    for k, v in norm.items():
        if k == 'language_model.lm_head.weight':
            lm_raw['lm_head.weight'] = v
        elif k.startswith('language_model.'):
            lm_raw['model.' + k.removeprefix('language_model.')] = v
    if 'lm_head.weight' in norm:
        lm_raw['lm_head.weight'] = norm['lm_head.weight']
    lm_params = _load_llama_like(_OnDevice(lm_raw, device, dtype), text_cfg)

    vt = _OnDevice({k.removeprefix('vision_tower.vision_model.'): v
                    for k, v in norm.items()
                    if k.startswith('vision_tower.')}, device, dtype)
    c = vision_cfg
    d, h, hd, n = c.hidden_size, c.num_heads, c.head_dim, c.num_layers
    pre = 'encoder.layers.{i}.'
    heads = lambda x: x.reshape(h, hd)  # noqa: E731
    tower: dict[str, Any] = {
        # conv (D, C, P, P) -> (C*P*P, D)
        'patch_embed': {
            'w': vt['embeddings.patch_embedding.weight'].reshape(d, -1).T
            .contiguous(),
            'b': (vt['embeddings.patch_embedding.bias']
                  if 'embeddings.patch_embedding.bias' in vt.tensors
                  else torch.zeros(d, device=device, dtype=dtype)),
        },
        'pos_embed': vt['embeddings.position_embedding.weight'],
        'pre_norm': {'w': vt['pre_layrnorm.weight'],
                     'b': vt['pre_layrnorm.bias']},
        'layers': {
            'norm1': {'w': _stack(vt, pre + 'layer_norm1.weight', n, _same),
                      'b': _stack(vt, pre + 'layer_norm1.bias', n, _same)},
            **{nm: {'w': _stack(vt, pre + f'self_attn.{nm}_proj.weight', n,
                                _qkv_in(d, h, hd)),
                    'b': _stack(vt, pre + f'self_attn.{nm}_proj.bias', n,
                                heads)}
               for nm in ('q', 'k', 'v')},
            'o': {'w': _stack(vt, pre + 'self_attn.out_proj.weight', n,
                              _o_in(d, h, hd)),
                  'b': _stack(vt, pre + 'self_attn.out_proj.bias', n, _same)},
            'norm2': {'w': _stack(vt, pre + 'layer_norm2.weight', n, _same),
                      'b': _stack(vt, pre + 'layer_norm2.bias', n, _same)},
            'up': {'w': _stack(vt, pre + 'mlp.fc1.weight', n, _T),
                   'b': _stack(vt, pre + 'mlp.fc1.bias', n, _same)},
            'down': {'w': _stack(vt, pre + 'mlp.fc2.weight', n, _T),
                     'b': _stack(vt, pre + 'mlp.fc2.bias', n, _same)},
        },
        'post_norm': {'w': vt['post_layernorm.weight'],
                      'b': vt['post_layernorm.bias']},
    }
    if 'embeddings.class_embedding' in vt.tensors:
        tower['class_token'] = vt['embeddings.class_embedding']

    pt = _OnDevice(norm, device, dtype)
    proj: dict[str, Any] = {}
    i = 0
    while f'multi_modal_projector.linear_{i + 1}.weight' in norm:
        proj[f'linear_{i}'] = {
            'w': _T(pt[f'multi_modal_projector.linear_{i + 1}.weight']),
            'b': pt[f'multi_modal_projector.linear_{i + 1}.bias'],
        }
        i += 1
    cfg = MultimodalConfig(text=text_cfg, vision=vision_cfg,
                           image_token_id=hf.get('image_token_index', 32000),
                           projector_layers=max(i, 1))
    return ({'language_model': lm_params, 'vision_tower': tower,
             'projector': proj}, cfg)


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


def save_multimodal_params(path: str, params: dict, cfg,
                           dtype: torch.dtype = torch.float32) -> None:
    """Write a LLaVA-layout multimodal checkpoint in HF format, every tensor
    in ``dtype``: the inverse of ``load_multimodal_params``, with the tensor
    names of transformers' ``LlavaForConditionalGeneration`` (the older
    ``language_model.model.*`` prefix, as the JAX module writes)."""
    from align_anything_tpu_torch.models.multimodal import check_supported  # noqa: PLC0415

    check_supported(cfg)
    os.makedirs(path, exist_ok=True)
    tc = cfg.text
    lm_params = params['language_model']
    if tc.true_vocab_size is not None and tc.true_vocab_size != tc.vocab_size:
        lm_params = dict(lm_params)
        lm_params['embedding'] = lm_params['embedding'][:tc.true_vocab_size]
        if 'lm_head' in lm_params:
            lm_params['lm_head'] = lm_params['lm_head'][:, :tc.true_vocab_size]
        tc = tc.replace(vocab_size=tc.true_vocab_size, true_vocab_size=None)
    out: dict[str, torch.Tensor] = {
        ('language_model.lm_head.weight' if k == 'lm_head.weight'
         else 'language_model.' + k): v
        for k, v in _dump_llama_like(lm_params, tc).items()
    }

    vc = cfg.vision
    d, h, hd = vc.hidden_size, vc.num_heads, vc.head_dim
    vt = params['vision_tower']
    vpre = 'vision_tower.vision_model.'
    # (C*P*P, D) -> conv (D, C, P, P)
    out[vpre + 'embeddings.patch_embedding.weight'] = \
        vt['patch_embed']['w'].T.reshape(d, -1, vc.patch_size, vc.patch_size)
    out[vpre + 'embeddings.position_embedding.weight'] = vt['pos_embed']
    out[vpre + 'pre_layrnorm.weight'] = vt['pre_norm']['w']
    out[vpre + 'pre_layrnorm.bias'] = vt['pre_norm']['b']
    out[vpre + 'post_layernorm.weight'] = vt['post_norm']['w']
    out[vpre + 'post_layernorm.bias'] = vt['post_norm']['b']
    if 'class_token' in vt:
        out[vpre + 'embeddings.class_embedding'] = vt['class_token']
    lp = vt['layers']
    lpre = vpre + 'encoder.layers.{i}.'
    flat = lambda x: x.reshape(-1)  # noqa: E731
    for nm, hf_nm in (('norm1', 'layer_norm1'), ('norm2', 'layer_norm2')):
        out.update(_unstack(lp[nm]['w'], lpre + f'{hf_nm}.weight', _same))
        out.update(_unstack(lp[nm]['b'], lpre + f'{hf_nm}.bias', _same))
    for nm in ('q', 'k', 'v'):
        out.update(_unstack(lp[nm]['w'], lpre + f'self_attn.{nm}_proj.weight',
                            lambda w: w.reshape(d, h * hd).T))
        out.update(_unstack(lp[nm]['b'], lpre + f'self_attn.{nm}_proj.bias',
                            flat))
    out.update(_unstack(lp['o']['w'], lpre + 'self_attn.out_proj.weight',
                        lambda w: w.reshape(h * hd, d).T))
    out.update(_unstack(lp['o']['b'], lpre + 'self_attn.out_proj.bias', _same))
    out.update(_unstack(lp['up']['w'], lpre + 'mlp.fc1.weight', lambda w: w.T))
    out.update(_unstack(lp['up']['b'], lpre + 'mlp.fc1.bias', _same))
    out.update(_unstack(lp['down']['w'], lpre + 'mlp.fc2.weight',
                        lambda w: w.T))
    out.update(_unstack(lp['down']['b'], lpre + 'mlp.fc2.bias', _same))
    for i in range(cfg.projector_layers):
        lin = params['projector'][f'linear_{i}']
        out[f'multi_modal_projector.linear_{i + 1}.weight'] = lin['w'].T
        out[f'multi_modal_projector.linear_{i + 1}.bias'] = lin['b']
    write_safetensors(os.path.join(path, 'model.safetensors'), out,
                      metadata={'format': 'pt'}, dtype=dtype)

    torch_dtype = str(dtype).removeprefix('torch.')
    text_hf = _to_hf_config(tc)
    text_hf['torch_dtype'] = torch_dtype
    hf_cfg = {
        'architectures': ['LlavaForConditionalGeneration'],
        'model_type': 'llava',
        'image_token_index': cfg.image_token_id,
        'vision_feature_layer': vc.feature_layer,
        'vision_feature_select_strategy':
            'default' if vc.feature_select == 'default' else 'full',
        'tie_word_embeddings': tc.tie_word_embeddings,
        'torch_dtype': torch_dtype,
        'text_config': text_hf,
        'vision_config': {
            'model_type': 'clip_vision_model',
            'image_size': vc.image_size, 'patch_size': vc.patch_size,
            'hidden_size': vc.hidden_size,
            'num_hidden_layers': vc.num_layers,
            'num_attention_heads': vc.num_heads,
            'intermediate_size': vc.mlp_dim,
            'hidden_act': vc.activation,
        },
    }
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
