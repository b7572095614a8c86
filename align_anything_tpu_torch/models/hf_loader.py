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
LLaVA-class checkpoint: LLaVA-1.5 (``LlavaForConditionalGeneration``: a
Llama-layout language model, a CLIP vision tower and the projector),
LLaVA-Next (``LlavaNextForConditionalGeneration``: AnyRes pinpoints and
``image_newline``) and LLaVA-NeXT-Video
(``LlavaNextVideoForConditionalGeneration``: the video token and the
average-pool stride too).  ``load_qwen2_vl_params`` /
``save_qwen2_vl_params`` and ``load_qwen2_5_vl_params`` /
``save_qwen2_5_vl_params`` do it for Qwen2-VL and Qwen2.5-VL (the m-rope
trunk's ``mrope_section`` from ``rope_scaling``; the tower under
``visual``), ``load_audio_params`` / ``save_audio_params`` for
Qwen2-Audio (the Whisper-style tower under ``audio_tower``),
``load_mllama_params`` / ``save_mllama_params`` for Mllama
(Llama-3.2-Vision: the tiled tower under ``vision_model``, the trunk with
its cross-attention layers, lists of per-layer dicts), and
``load_minicpmv_params`` / ``save_minicpmv_params`` for MiniCPM-V (the
openbmb layout: the Qwen2 trunk under ``llm``, the SigLIP tower under
``vpm``, the ``resampler``).
Idefics2's loader is ``models/idefics2.py`` ``load_idefics2_params`` (over
this module's codec).  Not ported yet (ROADMAP §1 item 12): the other
multimodal families (MiniCPM-o, Emu3's fused codec layout).
"""

from __future__ import annotations

import json
import os
import warnings
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


def _reversed(w: torch.Tensor) -> torch.Tensor:
    """numpy's ``.T``: all dims reversed (a 3-D MoE expert leaf too, where
    ``torch.Tensor.T`` takes 2-D only)."""
    return w.permute(*range(w.ndim - 1, -1, -1))


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


def _text_config(hf: dict, qkv_bias: bool) -> ModelConfig:
    """The Llama-layout trunk of a LLaVA or Qwen2-Audio ``config.json``
    (its ``text_config``; ``head_dim = hidden // heads``)."""
    tc = hf['text_config']
    return ModelConfig(
        vocab_size=tc['vocab_size'], hidden_size=tc['hidden_size'],
        num_layers=tc['num_hidden_layers'],
        num_heads=tc['num_attention_heads'],
        num_kv_heads=tc.get('num_key_value_heads', tc['num_attention_heads']),
        head_dim=tc['hidden_size'] // tc['num_attention_heads'],
        mlp_dim=tc['intermediate_size'],
        max_position_embeddings=tc.get('max_position_embeddings', 4096),
        rope_theta=tc.get('rope_theta', 10000.0),
        norm_eps=tc.get('rms_norm_eps', 1e-6),
        qkv_bias=qkv_bias,
        tie_word_embeddings=hf.get('tie_word_embeddings',
                                   tc.get('tie_word_embeddings', False)),
        bos_token_id=tc.get('bos_token_id', 1) or 1,
        eos_token_id=tc.get('eos_token_id', 2) or 2,
        pad_token_id=hf.get('pad_token_id') or tc.get('pad_token_id')
        or tc.get('eos_token_id', 2),
    )


def _prefixed_trunk(path: str, text_cfg: ModelConfig, device, dtype
                    ) -> tuple[dict, dict[str, torch.Tensor]]:
    """(the trunk's params, every tensor by its normalized name) of a
    checkpoint whose trunk lives under ``language_model.``: the
    ``model.language_model.*`` (transformers >= 4.52) and the
    ``language_model.model.*`` (older) prefixes both become
    ``language_model.*``, and the other modules lose a leading
    ``model.``."""
    norm: dict[str, torch.Tensor] = {}
    for k, v in _read_all_tensors(path).items():
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
    return _load_llama_like(_OnDevice(lm_raw, device, dtype), text_cfg), norm


LLAVA_MODEL_TYPES = ('llava', 'llava_next', 'llava_next_video')


def load_multimodal_params(path: str, dtype: torch.dtype = torch.float32,
                           device: torch.device | str | None = None):
    """Load an HF LLaVA-layout checkpoint (``model_type`` one of
    ``LLAVA_MODEL_TYPES``) into (params, MultimodalConfig), every leaf on
    ``device`` (default: the first CUDA device) in ``dtype``.

    Handles both the ``model.language_model.*`` (transformers >= 4.52) and
    the ``language_model.model.*`` (older) prefixes; the vision tower is
    CLIP-style.  With ``image_grid_pinpoints`` (LLaVA-Next) the tree holds
    ``image_newline``; a ``llava_next_video`` config brings its
    ``video_token_index`` and ``spatial_pool_stride`` (average pooling
    only)."""
    from align_anything_tpu_torch.models.multimodal import (  # noqa: PLC0415
        MultimodalConfig,
    )
    from align_anything_tpu_torch.models.vision import ViTConfig  # noqa: PLC0415

    device = default_device(device)
    with open(os.path.join(path, 'config.json')) as f:
        hf = json.load(f)
    model_type = hf.get('model_type')
    if model_type not in LLAVA_MODEL_TYPES:
        raise NotImplementedError(
            f'{model_type!r}: this loader reads the LLaVA family '
            f'{LLAVA_MODEL_TYPES}; the other vision-LM families load through '
            'their own loaders, or are not ported yet (ROADMAP §1 item 12)')
    pinpoints = (tuple(tuple(p) for p in hf['image_grid_pinpoints'])
                 if hf.get('image_grid_pinpoints') else None)
    pool_stride = None
    if model_type == 'llava_next_video':
        if hf.get('spatial_pool_mode', 'average') != 'average':
            raise ValueError('only average spatial pooling is supported '
                             f"(got {hf.get('spatial_pool_mode')!r})")
        pool_stride = int(hf.get('spatial_pool_stride', 2))
    vc = hf['vision_config']
    text_cfg = _text_config(hf, qkv_bias=hf['text_config'].get(
        'model_type') == 'qwen2')
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

    lm_params, norm = _prefixed_trunk(path, text_cfg, device, dtype)

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
                           projector_layers=max(i, 1),
                           image_grid_pinpoints=pinpoints,
                           video_token_id=hf.get('video_token_index'),
                           spatial_pool_stride=pool_stride)
    params = {'language_model': lm_params, 'vision_tower': tower,
              'projector': proj}
    if pinpoints is not None:
        params['image_newline'] = pt['image_newline']
    return params, cfg


def _qwen_vl_text_config(hf: dict, default_theta: float,
                         head_dim_key: bool) -> ModelConfig:
    """The m-rope Qwen2 trunk of a Qwen2-VL / Qwen2.5-VL ``config.json``:
    the ``text_config`` (or the top level of older files) and the
    ``mrope_section`` of its ``rope_scaling``."""
    tc = hf.get('text_config') or hf
    rope_scaling = tc.get('rope_scaling') or hf.get('rope_scaling') or {}
    mrope = tuple(rope_scaling.get('mrope_section') or (16, 24, 24))
    head_dim = tc['hidden_size'] // tc['num_attention_heads']
    if head_dim_key:
        head_dim = tc.get('head_dim') or head_dim
    return ModelConfig(
        vocab_size=tc['vocab_size'], hidden_size=tc['hidden_size'],
        num_layers=tc['num_hidden_layers'],
        num_heads=tc['num_attention_heads'],
        num_kv_heads=tc.get('num_key_value_heads', tc['num_attention_heads']),
        head_dim=head_dim, mlp_dim=tc['intermediate_size'],
        max_position_embeddings=tc.get('max_position_embeddings', 4096),
        rope_theta=tc.get('rope_theta', default_theta),
        norm_eps=tc.get('rms_norm_eps', 1e-6),
        qkv_bias=True, mrope_section=mrope,
        tie_word_embeddings=hf.get('tie_word_embeddings',
                                   tc.get('tie_word_embeddings', False)),
        bos_token_id=tc.get('bos_token_id', 1) or 1,
        eos_token_id=tc.get('eos_token_id', 2) or 2,
        pad_token_id=hf.get('pad_token_id') or tc.get('pad_token_id')
        or tc.get('eos_token_id', 2),
    )


def _qwen_vl_tensors(path: str, text_cfg: ModelConfig, device, dtype
                     ) -> tuple[dict, _OnDevice]:
    """(the trunk's params, the tower's tensors by their name under
    ``visual.``): the trunk lives at ``model.*`` (older files) or
    ``model.language_model.*`` (transformers >= 4.52), the tower at
    ``[model.]visual.*``."""
    norm: dict[str, torch.Tensor] = {}
    for k, v in _read_all_tensors(path).items():
        norm[k.removeprefix('model.').removeprefix('language_model.')] = v
    lm_raw = {'model.' + k: v for k, v in norm.items()
              if not k.startswith('visual.') and k != 'lm_head.weight'}
    if 'lm_head.weight' in norm:
        lm_raw['lm_head.weight'] = norm['lm_head.weight']
    lm_params = _load_llama_like(_OnDevice(lm_raw, device, dtype), text_cfg)
    vt = _OnDevice({k.removeprefix('visual.'): v for k, v in norm.items()
                    if k.startswith('visual.')}, device, dtype)
    return lm_params, vt


def _patch_embed_in(vt: _OnDevice, d: int) -> torch.Tensor:
    """conv3d (D, C, T, P, P) -> (C*T*P*P, D)."""
    return vt['patch_embed.proj.weight'].reshape(d, -1).T.contiguous()


def load_qwen2_vl_params(path: str, dtype: torch.dtype = torch.float32,
                         image_size: int = 224,
                         device: torch.device | str | None = None):
    """Load an HF Qwen2-VL checkpoint into (params, Qwen2VLConfig), every
    leaf on ``device`` (default: the first CUDA device) in ``dtype``: the
    2-D-rotary ViT with its PatchMerger under ``visual`` and the m-rope
    Qwen2 trunk under ``language_model``.  ``image_size`` is the
    fixed-resolution operating point (dynamic resolution ignores it)."""
    from align_anything_tpu_torch.models.qwen2_vl import (  # noqa: PLC0415
        Qwen2VLConfig,
        Qwen2VLVisionConfig,
    )

    device = default_device(device)
    with open(os.path.join(path, 'config.json')) as f:
        hf = json.load(f)
    text_cfg = _qwen_vl_text_config(hf, 10000.0, head_dim_key=False)
    vc = hf['vision_config']
    vision_cfg = Qwen2VLVisionConfig(
        depth=vc['depth'], embed_dim=vc['embed_dim'],
        num_heads=vc['num_heads'], patch_size=vc['patch_size'],
        spatial_merge_size=vc.get('spatial_merge_size', 2),
        temporal_patch_size=vc.get('temporal_patch_size', 2),
        mlp_ratio=vc.get('mlp_ratio', 4.0), image_size=image_size)
    cfg = Qwen2VLConfig(text=text_cfg, vision=vision_cfg,
                        image_token_id=hf.get('image_token_id')
                        or hf.get('image_token_index', 151655))
    lm_params, vt = _qwen_vl_tensors(path, text_cfg, device, dtype)
    n, pre = vision_cfg.depth, 'blocks.{i}.'

    def pair(name, w_fn=_T):
        return {'w': _stack(vt, pre + f'{name}.weight', n, w_fn),
                'b': _stack(vt, pre + f'{name}.bias', n, _same)}

    visual = {
        'patch_embed': {'w': _patch_embed_in(vt, vision_cfg.embed_dim)},
        'blocks': {
            'norm1': pair('norm1', _same), 'norm2': pair('norm2', _same),
            'qkv': pair('attn.qkv'), 'proj': pair('attn.proj'),
            'fc1': pair('mlp.fc1'), 'fc2': pair('mlp.fc2'),
        },
        'merger': {
            'ln_q': {'w': vt['merger.ln_q.weight'],
                     'b': vt['merger.ln_q.bias']},
            'mlp0': {'w': _T(vt['merger.mlp.0.weight']),
                     'b': vt['merger.mlp.0.bias']},
            'mlp2': {'w': _T(vt['merger.mlp.2.weight']),
                     'b': vt['merger.mlp.2.bias']},
        },
    }
    return {'language_model': lm_params, 'visual': visual}, cfg


def load_qwen2_5_vl_params(path: str, dtype: torch.dtype = torch.float32,
                           image_size: int = 224,
                           device: torch.device | str | None = None):
    """Load an HF Qwen2.5-VL checkpoint into (params, Qwen25VLConfig), every
    leaf on ``device`` (default: the first CUDA device) in ``dtype``: the
    window-attention RMSNorm / SwiGLU ViT and the m-rope Qwen2 trunk."""
    from align_anything_tpu_torch.models.qwen2_5_vl import (  # noqa: PLC0415
        Qwen25VLConfig,
        Qwen25VLVisionConfig,
    )

    device = default_device(device)
    with open(os.path.join(path, 'config.json')) as f:
        hf = json.load(f)
    text_cfg = _qwen_vl_text_config(hf, 1000000.0, head_dim_key=True)
    vc = hf['vision_config']
    vision_cfg = Qwen25VLVisionConfig(
        depth=vc['depth'], embed_dim=vc['hidden_size'],
        num_heads=vc['num_heads'], patch_size=vc['patch_size'],
        spatial_merge_size=vc.get('spatial_merge_size', 2),
        temporal_patch_size=vc.get('temporal_patch_size', 2),
        intermediate_size=vc['intermediate_size'],
        window_size=vc.get('window_size', 112),
        fullatt_block_indexes=tuple(vc.get('fullatt_block_indexes')
                                    or (7, 15, 23, 31)),
        image_size=image_size)
    cfg = Qwen25VLConfig(
        text=text_cfg, vision=vision_cfg,
        image_token_id=hf.get('image_token_id')
        or hf.get('image_token_index', 151655),
        video_token_id=hf.get('video_token_id', 151656))
    lm_params, vt = _qwen_vl_tensors(path, text_cfg, device, dtype)
    n, pre = vision_cfg.depth, 'blocks.{i}.'

    def pair(name):
        return {'w': _stack(vt, pre + f'{name}.weight', n, _T),
                'b': _stack(vt, pre + f'{name}.bias', n, _same)}

    visual = {
        'patch_embed': {'w': _patch_embed_in(vt, vision_cfg.embed_dim)},
        'blocks': {
            'norm1': {'w': _stack(vt, pre + 'norm1.weight', n, _same)},
            'norm2': {'w': _stack(vt, pre + 'norm2.weight', n, _same)},
            'qkv': pair('attn.qkv'), 'proj': pair('attn.proj'),
            'gate': pair('mlp.gate_proj'), 'up': pair('mlp.up_proj'),
            'down': pair('mlp.down_proj'),
        },
        'merger': {
            'ln_q': {'w': vt['merger.ln_q.weight']},
            'mlp0': {'w': _T(vt['merger.mlp.0.weight']),
                     'b': vt['merger.mlp.0.bias']},
            'mlp2': {'w': _T(vt['merger.mlp.2.weight']),
                     'b': vt['merger.mlp.2.bias']},
        },
    }
    return {'language_model': lm_params, 'visual': visual}, cfg


def load_audio_params(path: str, dtype: torch.dtype = torch.float32,
                      device: torch.device | str | None = None):
    """Load an HF Qwen2-Audio-layout checkpoint into (params,
    AudioLMConfig), every leaf on ``device`` (default: the first CUDA
    device) in ``dtype``.

    The Whisper-style tower (conv1 / conv2, the pre-norm encoder layers,
    the final ``layer_norm``), the one-linear projector and the Qwen2 trunk
    (``qkv_bias``, ``head_dim = hidden // heads``, ``rms_norm_eps`` of the
    ``text_config``), under either trunk prefix.  Whisper's attention has
    no key bias: it loads as zero rows, which ``save_audio_params`` drops
    again."""
    from align_anything_tpu_torch.models.audio import (  # noqa: PLC0415
        AudioEncoderConfig,
        AudioLMConfig,
    )

    device = default_device(device)
    with open(os.path.join(path, 'config.json')) as f:
        hf = json.load(f)
    ac = hf['audio_config']
    text_cfg = _text_config(hf, qkv_bias=True)
    d = ac['d_model']
    audio_cfg = AudioEncoderConfig(
        n_mels=ac['num_mel_bins'], hidden_size=d,
        num_layers=ac['encoder_layers'],
        num_heads=ac['encoder_attention_heads'],
        mlp_dim=ac['encoder_ffn_dim'],
        max_frames=2 * ac['max_source_positions'])
    cfg = AudioLMConfig(text=text_cfg, audio=audio_cfg,
                        audio_token_id=hf.get('audio_token_index', 151646))

    lm_params, norm = _prefixed_trunk(path, text_cfg, device, dtype)
    at = _OnDevice({k.removeprefix('audio_tower.'): v
                    for k, v in norm.items()
                    if k.startswith('audio_tower.')}, device, dtype)
    h, hd, n = audio_cfg.num_heads, audio_cfg.head_dim, audio_cfg.num_layers
    pre = 'layers.{i}.'
    heads = lambda x: x.reshape(h, hd)  # noqa: E731
    conv_in = lambda w: w.permute(2, 1, 0).contiguous()  # noqa: E731
    encoder: dict[str, Any] = {
        # torch conv (C_out, C_in, K) -> ours (K, C_in, C_out)
        'conv1': {'w': conv_in(at['conv1.weight']), 'b': at['conv1.bias']},
        'conv2': {'w': conv_in(at['conv2.weight']), 'b': at['conv2.bias']},
        'pos_embed': at['embed_positions.weight'],
        'post_norm': {'w': at['layer_norm.weight'],
                      'b': at['layer_norm.bias']},
        'layers': {
            'norm1': {'w': _stack(at, pre + 'self_attn_layer_norm.weight', n,
                                  _same),
                      'b': _stack(at, pre + 'self_attn_layer_norm.bias', n,
                                  _same)},
            'q': {'w': _stack(at, pre + 'self_attn.q_proj.weight', n,
                              _qkv_in(d, h, hd)),
                  'b': _stack(at, pre + 'self_attn.q_proj.bias', n, heads)},
            # Whisper attention has no key bias
            'k': {'w': _stack(at, pre + 'self_attn.k_proj.weight', n,
                              _qkv_in(d, h, hd)),
                  'b': torch.zeros((n, h, hd), device=device, dtype=dtype)},
            'v': {'w': _stack(at, pre + 'self_attn.v_proj.weight', n,
                              _qkv_in(d, h, hd)),
                  'b': _stack(at, pre + 'self_attn.v_proj.bias', n, heads)},
            'o': {'w': _stack(at, pre + 'self_attn.out_proj.weight', n,
                              _o_in(d, h, hd)),
                  'b': _stack(at, pre + 'self_attn.out_proj.bias', n, _same)},
            'norm2': {'w': _stack(at, pre + 'final_layer_norm.weight', n,
                                  _same),
                      'b': _stack(at, pre + 'final_layer_norm.bias', n,
                                  _same)},
            'up': {'w': _stack(at, pre + 'fc1.weight', n, _T),
                   'b': _stack(at, pre + 'fc1.bias', n, _same)},
            'down': {'w': _stack(at, pre + 'fc2.weight', n, _T),
                     'b': _stack(at, pre + 'fc2.bias', n, _same)},
        },
    }
    pt = _OnDevice(norm, device, dtype)
    projector = {'w': _T(pt['multi_modal_projector.linear.weight']),
                 'b': pt['multi_modal_projector.linear.bias']}
    return {'language_model': lm_params, 'audio_tower': encoder,
            'projector': projector}, cfg


# ---------------------------------------------------------------------------
# save (HF layout)
# ---------------------------------------------------------------------------

def save_params(path: str, params: dict, config: ModelConfig,
                hf_config_extra: dict | None = None,
                dtype: torch.dtype = torch.float32) -> None:
    """Write params back as a single HF-layout safetensors checkpoint, every
    tensor in ``dtype`` (float32, as the JAX module writes, by default).
    An MoE tree is written as JAX writes it and does not load back
    (``_dump_llama_like``)."""
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
    ``language_model.model.*`` prefix, as the JAX module writes), or of
    ``LlavaNextForConditionalGeneration`` (pinpoints: ``image_newline``
    too) or ``LlavaNextVideoForConditionalGeneration`` (a pool stride)."""
    from align_anything_tpu_torch.models.multimodal import check_supported  # noqa: PLC0415

    check_supported(cfg)
    os.makedirs(path, exist_ok=True)
    out, tc = _language_model_out(params, cfg.text)

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
    anyres = cfg.image_grid_pinpoints is not None
    if anyres:
        out['image_newline'] = params['image_newline']
    write_safetensors(os.path.join(path, 'model.safetensors'), out,
                      metadata={'format': 'pt'}, dtype=dtype)

    torch_dtype = str(dtype).removeprefix('torch.')
    text_hf = _to_hf_config(tc)
    text_hf['torch_dtype'] = torch_dtype
    video = cfg.spatial_pool_stride is not None
    if video:
        arch, model_type = ('LlavaNextVideoForConditionalGeneration',
                            'llava_next_video')
    elif anyres:
        arch, model_type = 'LlavaNextForConditionalGeneration', 'llava_next'
    else:
        arch, model_type = 'LlavaForConditionalGeneration', 'llava'
    hf_cfg = {
        'architectures': [arch],
        'model_type': model_type,
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
    if anyres:
        hf_cfg['image_grid_pinpoints'] = [
            list(p) for p in cfg.image_grid_pinpoints]
    if video:
        hf_cfg['video_token_index'] = cfg.video_token_id
        hf_cfg['spatial_pool_mode'] = 'average'
        hf_cfg['spatial_pool_stride'] = cfg.spatial_pool_stride
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(hf_cfg, f, indent=2)


def _trunk_out(params: dict, tc: ModelConfig
                 ) -> tuple[dict[str, torch.Tensor], ModelConfig]:
    """The trunk's tensors under their decoder names (``model.*``,
    ``lm_head.weight``, as JAX's Qwen-VL writers write them), the vocab
    cut back to its true size, and the config that goes with them."""
    lm_params = params['language_model']
    if tc.true_vocab_size is not None and tc.true_vocab_size != tc.vocab_size:
        lm_params = dict(lm_params)
        lm_params['embedding'] = lm_params['embedding'][:tc.true_vocab_size]
        if 'lm_head' in lm_params:
            lm_params['lm_head'] = lm_params['lm_head'][:, :tc.true_vocab_size]
        tc = tc.replace(vocab_size=tc.true_vocab_size, true_vocab_size=None)
    return dict(_dump_llama_like(lm_params, tc)), tc


def _language_model_out(params: dict, tc: ModelConfig
                        ) -> tuple[dict[str, torch.Tensor], ModelConfig]:
    """``_trunk_out`` under the names of the LLaVA and Qwen2-Audio
    checkpoints: ``language_model.model.*`` and
    ``language_model.lm_head.weight``."""
    out, tc = _trunk_out(params, tc)
    return {('language_model.lm_head.weight' if k == 'lm_head.weight'
             else 'language_model.' + k): v for k, v in out.items()}, tc


def _qwen_vl_write(path: str, out: dict, tc: ModelConfig, hf_cfg: dict,
                   dtype: torch.dtype, text_extra: dict | None = None
                   ) -> None:
    """Write the tensors (contiguous, in ``dtype``) and ``config.json``:
    ``hf_cfg`` with the m-rope trunk as its ``text_config`` (updated by
    ``text_extra``)."""
    write_safetensors(os.path.join(path, 'model.safetensors'), out,
                      metadata={'format': 'pt'}, dtype=dtype)
    torch_dtype = str(dtype).removeprefix('torch.')
    text_hf = _to_hf_config(tc)
    text_hf['rope_scaling'] = {'type': 'mrope',
                               'mrope_section': list(tc.mrope_section)}
    text_hf['torch_dtype'] = torch_dtype
    text_hf.update(text_extra or {})
    hf_cfg.update(tie_word_embeddings=tc.tie_word_embeddings,
                  torch_dtype=torch_dtype, text_config=text_hf)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(hf_cfg, f, indent=2)


def _patch_embed_out(w: torch.Tensor, vc) -> torch.Tensor:
    """(C*T*P*P, D) -> conv3d (D, C, T, P, P)."""
    return w.T.reshape(vc.embed_dim, 3, vc.temporal_patch_size,
                       vc.patch_size, vc.patch_size)


def save_qwen2_vl_params(path: str, params: dict, cfg,
                         dtype: torch.dtype = torch.float32) -> None:
    """Write a Qwen2-VL checkpoint in HF format, every tensor in ``dtype``:
    the inverse of ``load_qwen2_vl_params``, with the tensor names and
    ``config.json`` of JAX's ``save_qwen2_vl_params``
    (``Qwen2VLForConditionalGeneration``)."""
    from align_anything_tpu_torch.models.qwen2_vl import check_supported  # noqa: PLC0415

    check_supported(cfg)
    os.makedirs(path, exist_ok=True)
    vc = cfg.vision
    out, tc = _trunk_out(params, cfg.text)
    vt, pre = params['visual'], 'visual.blocks.{i}.'
    out['visual.patch_embed.proj.weight'] = _patch_embed_out(
        vt['patch_embed']['w'], vc)
    bl = vt['blocks']
    for ours, theirs in (('norm1', 'norm1'), ('norm2', 'norm2'),
                         ('qkv', 'attn.qkv'), ('proj', 'attn.proj'),
                         ('fc1', 'mlp.fc1'), ('fc2', 'mlp.fc2')):
        w_fn = _same if ours.startswith('norm') else (lambda w: w.T)
        out.update(_unstack(bl[ours]['w'], pre + f'{theirs}.weight', w_fn))
        out.update(_unstack(bl[ours]['b'], pre + f'{theirs}.bias', _same))
    mg = vt['merger']
    out['visual.merger.ln_q.weight'] = mg['ln_q']['w']
    out['visual.merger.ln_q.bias'] = mg['ln_q']['b']
    for i, key in ((0, 'mlp0'), (2, 'mlp2')):
        out[f'visual.merger.mlp.{i}.weight'] = mg[key]['w'].T
        out[f'visual.merger.mlp.{i}.bias'] = mg[key]['b']
    _qwen_vl_write(path, out, tc, {
        'architectures': ['Qwen2VLForConditionalGeneration'],
        'model_type': 'qwen2_vl',
        'image_token_id': cfg.image_token_id,
        'vision_config': {
            'model_type': 'qwen2_vl',
            'depth': vc.depth, 'embed_dim': vc.embed_dim,
            'num_heads': vc.num_heads, 'patch_size': vc.patch_size,
            'spatial_merge_size': vc.spatial_merge_size,
            'temporal_patch_size': vc.temporal_patch_size,
            'mlp_ratio': vc.mlp_ratio, 'in_channels': 3,
            'hidden_size': tc.hidden_size,
        },
    }, dtype)


def save_qwen2_5_vl_params(path: str, params: dict, cfg,
                           dtype: torch.dtype = torch.float32) -> None:
    """Write a Qwen2.5-VL checkpoint in HF format, every tensor in
    ``dtype``: the inverse of ``load_qwen2_5_vl_params``, with the names
    and ``config.json`` of JAX's ``save_qwen2_5_vl_params``."""
    from align_anything_tpu_torch.models.qwen2_vl import check_supported  # noqa: PLC0415

    check_supported(cfg)
    os.makedirs(path, exist_ok=True)
    vc = cfg.vision
    out, tc = _trunk_out(params, cfg.text)
    vt, pre = params['visual'], 'visual.blocks.{i}.'
    out['visual.patch_embed.proj.weight'] = _patch_embed_out(
        vt['patch_embed']['w'], vc)
    bl = vt['blocks']
    for nm in ('norm1', 'norm2'):
        out.update(_unstack(bl[nm]['w'], pre + f'{nm}.weight', _same))
    for ours, theirs in (('qkv', 'attn.qkv'), ('proj', 'attn.proj'),
                         ('gate', 'mlp.gate_proj'), ('up', 'mlp.up_proj'),
                         ('down', 'mlp.down_proj')):
        out.update(_unstack(bl[ours]['w'], pre + f'{theirs}.weight',
                            lambda w: w.T))
        out.update(_unstack(bl[ours]['b'], pre + f'{theirs}.bias', _same))
    mg = vt['merger']
    out['visual.merger.ln_q.weight'] = mg['ln_q']['w']
    for i, key in ((0, 'mlp0'), (2, 'mlp2')):
        out[f'visual.merger.mlp.{i}.weight'] = mg[key]['w'].T
        out[f'visual.merger.mlp.{i}.bias'] = mg[key]['b']
    _qwen_vl_write(path, out, tc, {
        'architectures': ['Qwen2_5_VLForConditionalGeneration'],
        'model_type': 'qwen2_5_vl',
        'image_token_id': cfg.image_token_id,
        'video_token_id': cfg.video_token_id,
        'vision_config': {
            'model_type': 'qwen2_5_vl',
            'depth': vc.depth, 'hidden_size': vc.embed_dim,
            'num_heads': vc.num_heads, 'patch_size': vc.patch_size,
            'spatial_merge_size': vc.spatial_merge_size,
            'temporal_patch_size': vc.temporal_patch_size,
            'intermediate_size': vc.intermediate_size,
            'window_size': vc.window_size,
            'fullatt_block_indexes': list(vc.fullatt_block_indexes),
            'out_hidden_size': tc.hidden_size, 'in_channels': 3,
            'hidden_act': 'silu',
        },
    }, dtype, text_extra={'model_type': 'qwen2_5_vl_text'})


def save_audio_params(path: str, params: dict, cfg,
                      dtype: torch.dtype = torch.float32) -> None:
    """Write a Qwen2-Audio checkpoint in HF format, every tensor in
    ``dtype``: the inverse of ``load_audio_params``, with the tensor names
    and ``config.json`` of JAX's ``save_audio_params``
    (``Qwen2AudioForConditionalGeneration``; the zero key-bias rows that
    Whisper's attention lacks are dropped).  An OPT-class trunk (learned
    positions) is refused, as in JAX."""
    from align_anything_tpu_torch.models.audio import check_supported  # noqa: PLC0415

    if cfg.text.positional == 'learned':
        raise ValueError('Qwen2-Audio HF export requires a llama/qwen-class '
                         'text trunk (rope); got an OPT-class config')
    check_supported(cfg)
    os.makedirs(path, exist_ok=True)
    ac = cfg.audio
    out, tc = _language_model_out(params, cfg.text)
    enc = params['audio_tower']
    d, h, hd = ac.hidden_size, ac.num_heads, ac.head_dim
    conv_out = lambda w: w.permute(2, 1, 0)  # noqa: E731
    out['audio_tower.conv1.weight'] = conv_out(enc['conv1']['w'])
    out['audio_tower.conv1.bias'] = enc['conv1']['b']
    out['audio_tower.conv2.weight'] = conv_out(enc['conv2']['w'])
    out['audio_tower.conv2.bias'] = enc['conv2']['b']
    out['audio_tower.embed_positions.weight'] = enc['pos_embed']
    out['audio_tower.layer_norm.weight'] = enc['post_norm']['w']
    out['audio_tower.layer_norm.bias'] = enc['post_norm']['b']
    lp, pre = enc['layers'], 'audio_tower.layers.{i}.'
    qkv_out = lambda w: w.reshape(d, h * hd).T  # noqa: E731
    flat = lambda x: x.reshape(-1)  # noqa: E731
    for nm, hf_nm in (('norm1', 'self_attn_layer_norm'),
                      ('norm2', 'final_layer_norm'), ('up', 'fc1'),
                      ('down', 'fc2')):
        w_fn = _same if nm.startswith('norm') else (lambda w: w.T)
        out.update(_unstack(lp[nm]['w'], pre + f'{hf_nm}.weight', w_fn))
        out.update(_unstack(lp[nm]['b'], pre + f'{hf_nm}.bias', _same))
    for nm in ('q', 'k', 'v'):
        out.update(_unstack(lp[nm]['w'], pre + f'self_attn.{nm}_proj.weight',
                            qkv_out))
    for nm in ('q', 'v'):   # k has no bias in Whisper attention
        out.update(_unstack(lp[nm]['b'], pre + f'self_attn.{nm}_proj.bias',
                            flat))
    out.update(_unstack(lp['o']['w'], pre + 'self_attn.out_proj.weight',
                        lambda w: w.reshape(h * hd, d).T))
    out.update(_unstack(lp['o']['b'], pre + 'self_attn.out_proj.bias',
                        _same))
    out['multi_modal_projector.linear.weight'] = params['projector']['w'].T
    out['multi_modal_projector.linear.bias'] = params['projector']['b']
    write_safetensors(os.path.join(path, 'model.safetensors'), out,
                      metadata={'format': 'pt'}, dtype=dtype)

    torch_dtype = str(dtype).removeprefix('torch.')
    text_hf = _to_hf_config(tc)
    text_hf['torch_dtype'] = torch_dtype
    hf_cfg = {
        'architectures': ['Qwen2AudioForConditionalGeneration'],
        'model_type': 'qwen2_audio',
        'audio_token_index': cfg.audio_token_id,
        'tie_word_embeddings': tc.tie_word_embeddings,
        'torch_dtype': torch_dtype,
        'text_config': text_hf,
        'audio_config': {
            'model_type': 'qwen2_audio_encoder',
            'd_model': ac.hidden_size, 'encoder_layers': ac.num_layers,
            'encoder_attention_heads': ac.num_heads,
            'encoder_ffn_dim': ac.mlp_dim, 'num_mel_bins': ac.n_mels,
            'max_source_positions': ac.max_frames // 2,
        },
    }
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(hf_cfg, f, indent=2)


def _mllama_tensors(path: str) -> dict[str, torch.Tensor]:
    """An Mllama checkpoint's tensors under one set of names:
    ``language_model.*`` (the trunk), ``lm_head.weight``,
    ``vision_model.*`` and ``multi_modal_projector.*``, from the older
    layout (``language_model.model.*``, ``language_model.lm_head.weight``)
    or the newer (``model.language_model.*``, ``lm_head.weight``,
    ``model.vision_model.*``, transformers >= 4.52)."""
    out: dict[str, torch.Tensor] = {}
    for k, v in _read_all_tensors(path).items():
        k = k.removeprefix('model.')
        if k in ('language_model.lm_head.weight', 'lm_head.weight'):
            k = 'lm_head.weight'
        out[k.replace('language_model.model.', 'language_model.')] = v
    return out


def load_mllama_params(path: str, dtype: torch.dtype = torch.float32,
                       device: torch.device | str | None = None):
    """Load an HF Mllama (Llama-3.2-Vision) checkpoint into (params,
    MllamaConfig), every leaf on ``device`` (default: the first CUDA
    device) in ``dtype``: the tiled two-stage vision encoder under
    ``vision_model``, the Llama trunk with its interleaved cross-attention
    layers under ``language_model`` (lists of per-layer dicts, as JAX's
    ``load_mllama_params`` builds them) and the projector."""
    from align_anything_tpu_torch.models.mllama import (  # noqa: PLC0415
        MllamaConfig,
        MllamaVisionConfig,
    )

    device = default_device(device)
    with open(os.path.join(path, 'config.json')) as f:
        hf = json.load(f)
    tc, vc = hf['text_config'], hf['vision_config']
    rs = tc.get('rope_scaling') or {}
    llama3 = None
    if rs.get('rope_type', rs.get('type')) == 'llama3':
        llama3 = (float(rs['factor']), float(rs['low_freq_factor']),
                  float(rs['high_freq_factor']),
                  int(rs['original_max_position_embeddings']))
    eos = tc.get('eos_token_id')
    text_cfg = ModelConfig(
        vocab_size=tc['vocab_size'], hidden_size=tc['hidden_size'],
        num_layers=tc['num_hidden_layers'],
        num_heads=tc['num_attention_heads'],
        num_kv_heads=tc.get('num_key_value_heads', tc['num_attention_heads']),
        head_dim=tc['hidden_size'] // tc['num_attention_heads'],
        mlp_dim=tc['intermediate_size'],
        max_position_embeddings=tc.get('max_position_embeddings', 4096),
        rope_theta=tc.get('rope_theta', 500000.0), rope_llama3=llama3,
        norm_eps=tc.get('rms_norm_eps', 1e-5),
        bos_token_id=tc.get('bos_token_id', 1) or 1,
        eos_token_id=(eos[0] if isinstance(eos, list) else eos or 2),
        pad_token_id=hf.get('pad_token_id') or tc.get('pad_token_id') or 0,
    )
    ar = vc.get('supported_aspect_ratios') or [[1, 1]]
    vision_cfg = MllamaVisionConfig(
        hidden_size=vc['hidden_size'],
        intermediate_size=vc['intermediate_size'],
        num_layers=vc['num_hidden_layers'],
        num_global_layers=vc['num_global_layers'],
        num_heads=vc['attention_heads'],
        image_size=vc['image_size'], patch_size=vc['patch_size'],
        max_num_tiles=vc.get('max_num_tiles', 4),
        max_aspect_ratio_id=len(ar),
        intermediate_layers_indices=tuple(vc['intermediate_layers_indices']),
        norm_eps=vc.get('norm_eps', 1e-5))
    cfg = MllamaConfig(
        text=text_cfg, vision=vision_cfg,
        cross_attention_layers=tuple(tc['cross_attention_layers']),
        image_token_id=hf.get('image_token_index', 128256))

    t = _OnDevice(_mllama_tensors(path), device, dtype)
    e, h, kh, d = (text_cfg.hidden_size, text_cfg.num_heads,
                   text_cfg.num_kv_heads, text_cfg.head_dim)

    def text_layer(i: int) -> dict:
        p = f'language_model.layers.{i}.'
        cross = i in cfg.cross_attention_layers
        a = p + ('cross_attn.' if cross else 'self_attn.')
        lp: dict[str, Any] = {
            'attn_norm': {'w': t[p + 'input_layernorm.weight']},
            'q': {'w': _qkv_in(e, h, d)(t[a + 'q_proj.weight'])},
            'k': {'w': _qkv_in(e, kh, d)(t[a + 'k_proj.weight'])},
            'v': {'w': _qkv_in(e, kh, d)(t[a + 'v_proj.weight'])},
            'o': {'w': _o_in(e, h, d)(t[a + 'o_proj.weight'])},
            'mlp_norm': {'w': t[p + 'post_attention_layernorm.weight']},
            'gate': {'w': _T(t[p + 'mlp.gate_proj.weight'])},
            'up': {'w': _T(t[p + 'mlp.up_proj.weight'])},
            'down': {'w': _T(t[p + 'mlp.down_proj.weight'])},
        }
        if cross:
            lp['q_norm'] = {'w': t[a + 'q_norm.weight']}
            lp['k_norm'] = {'w': t[a + 'k_norm.weight']}
            lp['attn_gate'] = t[p + 'cross_attn_attn_gate']
            lp['mlp_gate'] = t[p + 'cross_attn_mlp_gate']
        return lp

    language_model = {
        'embedding': t['language_model.embed_tokens.weight'],
        'layers': [text_layer(i) for i in range(text_cfg.num_layers)],
        'final_norm': {'w': t['language_model.norm.weight']},
        'lm_head': _T(t['lm_head.weight']),
    }

    def vision_layer(prefix: str, i: int, gated: bool) -> dict:
        p = f'vision_model.{prefix}.layers.{i}.'
        lp: dict[str, Any] = {
            'norm1': {'w': t[p + 'input_layernorm.weight'],
                      'b': t[p + 'input_layernorm.bias']},
            'q': {'w': _T(t[p + 'self_attn.q_proj.weight'])},
            'k': {'w': _T(t[p + 'self_attn.k_proj.weight'])},
            'v': {'w': _T(t[p + 'self_attn.v_proj.weight'])},
            'o': {'w': _T(t[p + 'self_attn.o_proj.weight'])},
            'norm2': {'w': t[p + 'post_attention_layernorm.weight'],
                      'b': t[p + 'post_attention_layernorm.bias']},
            'fc1': {'w': _T(t[p + 'mlp.fc1.weight']),
                    'b': t[p + 'mlp.fc1.bias']},
            'fc2': {'w': _T(t[p + 'mlp.fc2.weight']),
                    'b': t[p + 'mlp.fc2.bias']},
        }
        if gated:
            lp['gate_attn'] = t[p + 'gate_attn']
            lp['gate_ffn'] = t[p + 'gate_ffn']
        return lp

    v = 'vision_model.'
    vision_model = {
        'patch_embed': {'w': t[v + 'patch_embedding.weight'].reshape(
            vision_cfg.hidden_size, -1).T.contiguous()},
        'class_embedding': t[v + 'class_embedding'],
        'pos_embed': {
            'gate': t[v + 'gated_positional_embedding.gate'],
            'embedding': t[v + 'gated_positional_embedding.embedding'],
            'tile': t[v + 'gated_positional_embedding.tile_embedding.weight'],
        },
        'pre_tile': {
            'gate': t[v + 'pre_tile_positional_embedding.gate'],
            'embedding': t[v + 'pre_tile_positional_embedding.embedding.'
                           'weight'],
        },
        'post_tile': {
            'gate': t[v + 'post_tile_positional_embedding.gate'],
            'embedding': t[v + 'post_tile_positional_embedding.embedding.'
                           'weight'],
        },
        'ln_pre': {'w': t[v + 'layernorm_pre.weight'],
                   'b': t[v + 'layernorm_pre.bias']},
        'ln_post': {'w': t[v + 'layernorm_post.weight'],
                    'b': t[v + 'layernorm_post.bias']},
        'local_layers': [vision_layer('transformer', i, False)
                         for i in range(vision_cfg.num_layers)],
        'global_layers': [vision_layer('global_transformer', i, True)
                          for i in range(vision_cfg.num_global_layers)],
    }
    projector = {'w': _T(t['multi_modal_projector.weight']),
                 'b': t['multi_modal_projector.bias']}
    return {'vision_model': vision_model, 'language_model': language_model,
            'projector': projector}, cfg


def save_mllama_params(path: str, params: dict, cfg,
                       dtype: torch.dtype = torch.float32) -> None:
    """Write an Mllama checkpoint in HF format, every tensor in ``dtype``:
    the inverse of ``load_mllama_params``, with the tensor names (the older
    layout: ``language_model.model.*``, ``language_model.lm_head.weight``)
    and ``config.json`` of JAX's ``save_mllama_params``
    (``MllamaForConditionalGeneration``)."""
    from align_anything_tpu_torch.models.mllama import check_supported  # noqa: PLC0415

    check_supported(cfg)
    os.makedirs(path, exist_ok=True)
    tc, vc = cfg.text, cfg.vision
    e, h, kh, d = tc.hidden_size, tc.num_heads, tc.num_kv_heads, tc.head_dim
    out: dict[str, torch.Tensor] = {}

    lm = params['language_model']
    out['language_model.model.embed_tokens.weight'] = lm['embedding']
    out['language_model.model.norm.weight'] = lm['final_norm']['w']
    out['language_model.lm_head.weight'] = lm['lm_head'].T
    for i, lp in enumerate(lm['layers']):
        p = f'language_model.model.layers.{i}.'
        cross = i in cfg.cross_attention_layers
        a = p + ('cross_attn.' if cross else 'self_attn.')
        out[p + 'input_layernorm.weight'] = lp['attn_norm']['w']
        out[p + 'post_attention_layernorm.weight'] = lp['mlp_norm']['w']
        out[a + 'q_proj.weight'] = lp['q']['w'].reshape(e, h * d).T
        out[a + 'k_proj.weight'] = lp['k']['w'].reshape(e, kh * d).T
        out[a + 'v_proj.weight'] = lp['v']['w'].reshape(e, kh * d).T
        out[a + 'o_proj.weight'] = lp['o']['w'].reshape(h * d, e).T
        out[p + 'mlp.gate_proj.weight'] = lp['gate']['w'].T
        out[p + 'mlp.up_proj.weight'] = lp['up']['w'].T
        out[p + 'mlp.down_proj.weight'] = lp['down']['w'].T
        if cross:
            out[a + 'q_norm.weight'] = lp['q_norm']['w']
            out[a + 'k_norm.weight'] = lp['k_norm']['w']
            out[p + 'cross_attn_attn_gate'] = lp['attn_gate']
            out[p + 'cross_attn_mlp_gate'] = lp['mlp_gate']

    vp, v = params['vision_model'], 'vision_model.'
    out[v + 'patch_embedding.weight'] = vp['patch_embed']['w'].T.reshape(
        vc.hidden_size, 3, vc.patch_size, vc.patch_size)
    out[v + 'class_embedding'] = vp['class_embedding']
    out[v + 'gated_positional_embedding.gate'] = vp['pos_embed']['gate']
    out[v + 'gated_positional_embedding.embedding'] = \
        vp['pos_embed']['embedding']
    out[v + 'gated_positional_embedding.tile_embedding.weight'] = \
        vp['pos_embed']['tile']
    for nm in ('pre_tile', 'post_tile'):
        out[v + f'{nm}_positional_embedding.gate'] = vp[nm]['gate']
        out[v + f'{nm}_positional_embedding.embedding.weight'] = \
            vp[nm]['embedding']
    for nm, theirs in (('ln_pre', 'layernorm_pre'),
                       ('ln_post', 'layernorm_post')):
        out[v + f'{theirs}.weight'] = vp[nm]['w']
        out[v + f'{theirs}.bias'] = vp[nm]['b']
    for prefix, layers in (('transformer', vp['local_layers']),
                           ('global_transformer', vp['global_layers'])):
        for i, lp in enumerate(layers):
            p = v + f'{prefix}.layers.{i}.'
            out[p + 'input_layernorm.weight'] = lp['norm1']['w']
            out[p + 'input_layernorm.bias'] = lp['norm1']['b']
            out[p + 'post_attention_layernorm.weight'] = lp['norm2']['w']
            out[p + 'post_attention_layernorm.bias'] = lp['norm2']['b']
            for nm in ('q', 'k', 'v', 'o'):
                out[p + f'self_attn.{nm}_proj.weight'] = lp[nm]['w'].T
            out[p + 'mlp.fc1.weight'] = lp['fc1']['w'].T
            out[p + 'mlp.fc1.bias'] = lp['fc1']['b']
            out[p + 'mlp.fc2.weight'] = lp['fc2']['w'].T
            out[p + 'mlp.fc2.bias'] = lp['fc2']['b']
            if 'gate_attn' in lp:
                out[p + 'gate_attn'] = lp['gate_attn']
                out[p + 'gate_ffn'] = lp['gate_ffn']
    out['multi_modal_projector.weight'] = params['projector']['w'].T
    out['multi_modal_projector.bias'] = params['projector']['b']
    write_safetensors(os.path.join(path, 'model.safetensors'), out,
                      metadata={'format': 'pt'}, dtype=dtype)

    text_hf = {
        'model_type': 'mllama_text_model',
        'vocab_size': tc.vocab_size, 'hidden_size': tc.hidden_size,
        'num_hidden_layers': tc.num_layers,
        'num_attention_heads': tc.num_heads,
        'num_key_value_heads': tc.num_kv_heads,
        'intermediate_size': tc.mlp_dim,
        'max_position_embeddings': tc.max_position_embeddings,
        'rope_theta': tc.rope_theta, 'rms_norm_eps': tc.norm_eps,
        'cross_attention_layers': list(cfg.cross_attention_layers),
        'bos_token_id': tc.bos_token_id, 'eos_token_id': tc.eos_token_id,
        'pad_token_id': tc.pad_token_id,
    }
    if tc.rope_llama3 is not None:
        factor, low, high, orig = tc.rope_llama3
        text_hf['rope_scaling'] = {
            'rope_type': 'llama3', 'factor': factor,
            'low_freq_factor': low, 'high_freq_factor': high,
            'original_max_position_embeddings': orig}
    else:
        text_hf['rope_scaling'] = {'rope_type': 'default'}
    ar = [(a, b) for a in range(1, vc.max_num_tiles + 1)
          for b in range(1, vc.max_num_tiles + 1)
          if a * b <= vc.max_num_tiles]
    hf_cfg = {
        'architectures': ['MllamaForConditionalGeneration'],
        'model_type': 'mllama',
        'image_token_index': cfg.image_token_id,
        'torch_dtype': str(dtype).removeprefix('torch.'),
        'text_config': text_hf,
        'vision_config': {
            'model_type': 'mllama_vision_model',
            'hidden_size': vc.hidden_size,
            'intermediate_size': vc.intermediate_size,
            'num_hidden_layers': vc.num_layers,
            'num_global_layers': vc.num_global_layers,
            'attention_heads': vc.num_heads,
            'image_size': vc.image_size, 'patch_size': vc.patch_size,
            'max_num_tiles': vc.max_num_tiles,
            'supported_aspect_ratios': [list(x) for x in ar],
            'intermediate_layers_indices':
                list(vc.intermediate_layers_indices),
            'vision_output_dim': vc.output_dim,
            'norm_eps': vc.norm_eps, 'num_channels': 3,
        },
    }
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(hf_cfg, f, indent=2)


def _minicpmv_config(hf: dict):
    """The MiniCPMVConfig of a MiniCPM-V ``config.json`` dict, as JAX's
    loader reads it: the Qwen2 trunk at the top level (``qkv_bias``,
    ``head_dim = hidden // heads``), the SigLIP tower under
    ``vision_config``, the resampler's heads ``resampler_num_heads`` or
    ``hidden // 128``, the image token ``image_token_id`` or
    ``unk_token_id`` or 128244."""
    from align_anything_tpu_torch.models.idefics2 import Idefics2VisionCfg  # noqa: PLC0415
    from align_anything_tpu_torch.models.minicpmv import (  # noqa: PLC0415
        MiniCPMVConfig, ResamplerCfg)

    text_cfg = ModelConfig(
        vocab_size=hf['vocab_size'], hidden_size=hf['hidden_size'],
        num_layers=hf['num_hidden_layers'],
        num_heads=hf['num_attention_heads'],
        num_kv_heads=hf.get('num_key_value_heads',
                            hf['num_attention_heads']),
        head_dim=hf['hidden_size'] // hf['num_attention_heads'],
        mlp_dim=hf['intermediate_size'],
        max_position_embeddings=hf.get('max_position_embeddings', 4096),
        rope_theta=hf.get('rope_theta', 1000000.0),
        norm_eps=hf.get('rms_norm_eps', 1e-6),
        qkv_bias=True,
        tie_word_embeddings=hf.get('tie_word_embeddings', False),
        bos_token_id=hf.get('bos_token_id', 1) or 1,
        eos_token_id=hf.get('eos_token_id', 2) or 2,
        pad_token_id=hf.get('pad_token_id') or hf.get('eos_token_id', 2),
    )
    vc = hf.get('vision_config') or {}
    vision_cfg = Idefics2VisionCfg(
        hidden_size=vc.get('hidden_size', 1152),
        intermediate_size=vc.get('intermediate_size', 4304),
        num_hidden_layers=vc.get('num_hidden_layers', 27),
        num_attention_heads=vc.get('num_attention_heads', 16),
        image_size=vc.get('image_size', 448),
        patch_size=vc.get('patch_size', 14))
    resampler_cfg = ResamplerCfg(
        num_queries=hf.get('query_num', 64),
        num_heads=hf.get('resampler_num_heads')
        or max(1, hf['hidden_size'] // 128),
        kv_dim=vision_cfg.hidden_size, embed_dim=hf['hidden_size'])
    return MiniCPMVConfig(
        text=text_cfg, vision=vision_cfg, resampler=resampler_cfg,
        image_token_id=hf.get('image_token_id')
        or hf.get('unk_token_id', 128244),
        slice_mode=hf.get('slice_mode', True))


# the resampler's leaves by openbmb name, beside their place in the tree
# (``kv_proj.weight`` is stored transposed, (kv_dim, E))
_RESAMPLER_KEYS = (
    ('query', ('query',)),
    ('attn.in_proj_weight', ('attn', 'in_proj_w')),
    ('attn.in_proj_bias', ('attn', 'in_proj_b')),
    ('attn.out_proj.weight', ('attn', 'out_proj_w')),
    ('attn.out_proj.bias', ('attn', 'out_proj_b')),
    ('ln_q.weight', ('ln_q', 'w')), ('ln_q.bias', ('ln_q', 'b')),
    ('ln_kv.weight', ('ln_kv', 'w')), ('ln_kv.bias', ('ln_kv', 'b')),
    ('ln_post.weight', ('ln_post', 'w')), ('ln_post.bias', ('ln_post', 'b')),
    ('proj', ('proj',)),
)


def load_minicpmv_params(path: str, dtype: torch.dtype = torch.float32,
                         device: torch.device | str | None = None):
    """Load a MiniCPM-V-2.6-layout checkpoint (openbmb key layout) into
    (params, MiniCPMVConfig), every leaf on ``device`` (default: the first
    CUDA device) in ``dtype``: ``llm.*`` becomes the decoder's tree,
    ``vpm.*`` is nested by its module path, ``resampler.*`` takes JAX's
    keys with ``kv_proj`` transposed."""
    device = default_device(device)
    with open(os.path.join(path, 'config.json')) as f:
        cfg = _minicpmv_config(json.load(f))
    llm: dict[str, torch.Tensor] = {}
    vpm: dict[str, Any] = {}
    rs: dict[str, torch.Tensor] = {}
    for key, t in _read_all_tensors(path).items():
        if key.startswith('llm.'):
            llm[key[len('llm.'):]] = t
        elif key.startswith('vpm.'):
            node = vpm
            *parents, leaf = key[len('vpm.'):].split('.')
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = t.to(device=device, dtype=dtype, copy=True)
        elif key.startswith('resampler.'):
            rs[key[len('resampler.'):]] = t
    on = _OnDevice(rs, device, dtype)
    resampler: dict[str, Any] = {'kv_proj': {'w': _T(on['kv_proj.weight'])}}
    for name, where in _RESAMPLER_KEYS:
        node = resampler
        for part in where[:-1]:
            node = node.setdefault(part, {})
        node[where[-1]] = on[name]
    text = _load_llama_like(_OnDevice(llm, device, dtype), cfg.text)
    return {'llm': text, 'vpm': vpm, 'resampler': resampler}, cfg


def save_minicpmv_params(path: str, params: dict, cfg) -> None:
    """Write a MiniCPM-V checkpoint in the openbmb key layout, every
    tensor fp32 and contiguous: the inverse of ``load_minicpmv_params``,
    with the tensor names and ``config.json`` of JAX's
    ``save_minicpmv_params``."""
    os.makedirs(path, exist_ok=True)
    tc, vc = cfg.text, cfg.vision
    out: dict[str, torch.Tensor] = {
        'llm.' + k: v for k, v in _dump_llama_like(params['llm'], tc).items()}

    def flatten(prefix: str, tree) -> None:
        if isinstance(tree, dict):
            for k, v in tree.items():
                flatten(f'{prefix}.{k}', v)
        else:
            out[prefix] = tree

    flatten('vpm', params['vpm'])
    rs = params['resampler']
    out['resampler.kv_proj.weight'] = rs['kv_proj']['w'].T
    for name, where in _RESAMPLER_KEYS:
        node = rs
        for part in where:
            node = node[part]
        out['resampler.' + name] = node
    write_safetensors(os.path.join(path, 'model.safetensors'), out,
                      metadata={'format': 'pt'}, dtype=torch.float32)
    hf_cfg = {
        'architectures': ['MiniCPMV'],
        'model_type': 'minicpmv',
        'auto_map': {'AutoModelForCausalLM': 'modeling_minicpmv.MiniCPMV'},
        'vocab_size': tc.vocab_size, 'hidden_size': tc.hidden_size,
        'num_hidden_layers': tc.num_layers,
        'num_attention_heads': tc.num_heads,
        'num_key_value_heads': tc.num_kv_heads,
        'intermediate_size': tc.mlp_dim,
        'max_position_embeddings': tc.max_position_embeddings,
        'rope_theta': tc.rope_theta, 'rms_norm_eps': tc.norm_eps,
        'tie_word_embeddings': tc.tie_word_embeddings,
        'bos_token_id': tc.bos_token_id, 'eos_token_id': tc.eos_token_id,
        'pad_token_id': tc.pad_token_id,
        'query_num': cfg.resampler.num_queries,
        'resampler_num_heads': cfg.resampler.num_heads,
        'image_token_id': cfg.image_token_id,
        'slice_mode': cfg.slice_mode,
        'vision_config': {
            'model_type': 'siglip_vision_model',
            'hidden_size': vc.hidden_size,
            'intermediate_size': vc.intermediate_size,
            'num_hidden_layers': vc.num_hidden_layers,
            'num_attention_heads': vc.num_attention_heads,
            'image_size': vc.image_size, 'patch_size': vc.patch_size,
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
    """The HF tensors of a Llama-class decoder tree.  An MoE tree's come out
    as JAX writes them: each layer's expert stacks under the dense MLP
    names with every dim reversed and no router, beside a config without
    experts, so the export does not load back (ROADMAP R34); a warning
    says so."""
    if c.num_experts:
        warnings.warn(f'an MoE language model (num_experts={c.num_experts})'
                      ' is written as the JAX package writes it, without the'
                      ' router or the experts in config.json, and does not '
                      'load back (ROADMAP R34)', stacklevel=3)
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
    out.update(_unstack(lp['gate']['w'], pre + 'mlp.gate_proj.weight', _reversed))
    out.update(_unstack(lp['up']['w'], pre + 'mlp.up_proj.weight', _reversed))
    out.update(_unstack(lp['down']['w'], pre + 'mlp.down_proj.weight', _reversed))
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
