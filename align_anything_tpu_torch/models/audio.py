"""Qwen2-Audio-class audio-language model, the port of
``align_anything_tpu/models/audio.py`` (reference: models/qwen2_audio.py
wrapping HF Qwen2AudioForConditionalGeneration).

A Whisper-style encoder over the log-mel frontend of ``ops/audio.py``:
two 1-D convolutions (stride 1, then stride 2) with tanh-approximate GELU,
learned frame positions, the pre-norm encoder layers of
``models/vision.py``, a 2x average pool over time, the final layer norm
and a one-linear projector into the text embedding space.  The audio
embeddings are merged over the ``audio_token_id`` placeholders exactly
like image patches (``multimodal.merge_image_embeds``), then the decoder
of ``models/transformer.py`` runs.  The param tree keeps the JAX
package's keys: ``language_model``, ``audio_tower`` (``conv1`` /
``conv2`` as (K, C_in, C_out), ``pos_embed`` of ``max_frames // 2`` rows,
``layers``, ``post_norm``) and ``projector``.

As in JAX, every clip is padded (or cut) to ``max_frames`` mel frames and
all ``num_audio_tokens`` tokens are kept: no frame mask.  The tower's
attention is full self-attention through ``ops/attention.causal_attention
(..., causal=False)``: the flash-attention kernel on the card (at
Qwen2-Audio's widths L 1500, H 20, D 64), its plain version on a CPU
tensor.  JAX's ``param_specs`` (the mesh) is not ported: one device.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from align_anything_tpu_torch.models import transformer, vision
from align_anything_tpu_torch.models.config import ModelConfig
from align_anything_tpu_torch.models.multimodal import merge_image_embeds
from align_anything_tpu_torch.models.transformer import ModelOutput
from align_anything_tpu_torch.models.vision import ViTConfig
from align_anything_tpu_torch.ops.audio import log_mel_spectrogram
from align_anything_tpu_torch.ops.logprobs import hidden_to_token_logprobs
from align_anything_tpu_torch.ops.norms import layer_norm
from align_anything_tpu_torch.utils.tools import default_device


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    n_mels: int = 128
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    mlp_dim: int = 1024
    max_frames: int = 3000          # 30 s at hop 160 / 16 kHz
    norm_eps: float = 1e-5
    pool_stride: int = 2            # post-encoder avg pool

    @property
    def num_audio_tokens(self) -> int:
        # conv2 stride 2, then avg pool
        return self.max_frames // 2 // self.pool_stride

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def _encoder_vitcfg(self) -> ViTConfig:
        # the generic pre-norm encoder block (only eps/act are read)
        return ViTConfig(hidden_size=self.hidden_size,
                         num_layers=self.num_layers, num_heads=self.num_heads,
                         mlp_dim=self.mlp_dim, norm_eps=self.norm_eps,
                         activation='gelu')


@dataclasses.dataclass(frozen=True)
class AudioLMConfig:
    text: ModelConfig
    audio: AudioEncoderConfig
    audio_token_id: int = 32001

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

    def replace(self, **kw) -> 'AudioLMConfig':
        text_fields = {f.name for f in dataclasses.fields(ModelConfig)}
        text_kw = {k: v for k, v in kw.items() if k in text_fields}
        own_kw = {k: v for k, v in kw.items() if k not in text_fields}
        return dataclasses.replace(self, text=self.text.replace(**text_kw),
                                   **own_kw)


def check_supported(cfg: AudioLMConfig) -> None:
    """Raise for the config options the port does not run yet (those of
    the text decoder)."""
    transformer.check_supported(cfg.text)


def init_params(cfg: AudioLMConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random fp32 init with the JAX package's tree and shapes (the numbers
    differ), on ``device`` (default: the first CUDA device; ``generator``
    must live there too)."""
    device = default_device(device)
    check_supported(cfg)
    a = cfg.audio
    d = a.hidden_size

    def dense(*shape, fan_in):
        return torch.randn(shape, generator=generator,
                           device=device) / math.sqrt(fan_in)

    lm = transformer.init_params(cfg.text, generator, device=device)
    encoder = vision.init_params(
        dataclasses.replace(a._encoder_vitcfg(), image_size=1, patch_size=1,
                            use_class_token=False), generator, device=device)
    # the patch path gives way to the audio convs and frame positions
    encoder.pop('patch_embed')
    encoder.pop('pre_norm')
    encoder['conv1'] = {'w': dense(3, a.n_mels, d, fan_in=3 * a.n_mels),
                        'b': torch.zeros((d,), device=device)}
    encoder['conv2'] = {'w': dense(3, d, d, fan_in=3 * d),
                        'b': torch.zeros((d,), device=device)}
    encoder['pos_embed'] = torch.randn(
        (a.max_frames // 2, d), generator=generator, device=device) * 0.02
    return {
        'language_model': lm,
        'audio_tower': encoder,
        'projector': {
            'w': dense(d, cfg.text.hidden_size, fan_in=d),
            'b': torch.zeros((cfg.text.hidden_size,), device=device),
        },
    }


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """x (B, T, C_in), w (K, C_in, C_out) -> (B, T', C_out).

    Symmetric padding 1 (k = 3), as torch ``Conv1d(padding=1)``, so that
    the stride-2 windows center on even frames as in Whisper and
    Qwen2-Audio (JAX pads explicitly too: XLA's 'SAME' pads right-heavy
    at stride 2 and would shift the features by one frame)."""
    out = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, stride=stride,
                   padding=1)
    return out.transpose(1, 2)


def frontend(cfg: AudioLMConfig, audio_values: torch.Tensor) -> torch.Tensor:
    """Waveforms (B, T) -> (B, max_frames, n_mels) log-mel frames in the
    compute dtype: the frame axis zero-padded or cut to ``max_frames``."""
    a = cfg.audio
    mel = log_mel_spectrogram(audio_values, n_mels=a.n_mels)  # (B, M, F)
    f = mel.shape[-1]
    mel = (F.pad(mel, (0, a.max_frames - f)) if f < a.max_frames
           else mel[..., :a.max_frames])
    return mel.transpose(1, 2).to(transformer.torch_dtype(
        cfg.text.compute_dtype))


def encode_audio(params: dict, cfg: AudioLMConfig,
                 audio_values: torch.Tensor) -> torch.Tensor:
    """Waveforms (B, T) -> audio tokens (B, num_audio_tokens, E_text)."""
    a = cfg.audio
    enc = params['audio_tower']
    x = frontend(cfg, audio_values)
    dtype = x.dtype
    for name, stride in (('conv1', 1), ('conv2', 2)):
        x = F.gelu(_conv1d(x, enc[name]['w'].to(dtype),
                           enc[name]['b'].to(dtype), stride),
                   approximate='tanh')
    x = x + enc['pos_embed'].to(dtype)[None, :x.shape[1]]
    vit_cfg = a._encoder_vitcfg()
    layers = enc['layers']
    for li in range(a.num_layers):
        lp = {name: {k: leaf[li] for k, leaf in sub.items()}
              for name, sub in layers.items()}
        x = vision._encoder_layer(vit_cfg, lp, x)
    # average pool over time, THEN the final layer norm (HF
    # Qwen2AudioEncoder's order, modeling_qwen2_audio.py:436-439)
    b, t, d = x.shape
    s = a.pool_stride
    x = x[:, :t - t % s].reshape(b, t // s, s, d).mean(dim=2)
    x = layer_norm(x, enc['post_norm']['w'], enc['post_norm']['b'])
    proj = params['projector']
    return torch.einsum('bnd,de->bne', x, proj['w'].to(dtype)) \
        + proj['b'].to(dtype)


def forward(params: dict, cfg: AudioLMConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            audio_values: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, cache=None,
            cache_offset: int = 0, need_logits: bool = True) -> ModelOutput:
    """The decoder over the text embeddings with the audio tokens merged
    over ``audio_token_id``; text-only without ``audio_values``."""
    lm = params['language_model']
    embeds = lm['embedding'][input_ids].to(
        transformer.torch_dtype(cfg.text.compute_dtype))
    if audio_values is not None:
        embeds = merge_image_embeds(embeds,
                                    encode_audio(params, cfg, audio_values),
                                    input_ids, cfg.audio_token_id)
    return transformer.forward(lm, cfg.text, input_ids,
                               attention_mask=attention_mask,
                               positions=positions, cache=cache,
                               cache_offset=cache_offset,
                               need_logits=need_logits,
                               inputs_embeds=embeds)


def decode_forward(params: dict, cfg: AudioLMConfig,
                   input_ids: torch.Tensor, **kw) -> ModelOutput:
    """Text-only step over the language trunk (decode loop: the audio
    tokens already live in the KV cache from the prefill)."""
    return transformer.forward(params['language_model'], cfg.text, input_ids,
                               **kw)


def token_logprobs(params: dict, cfg: AudioLMConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor | None = None,
                   audio_values: torch.Tensor | None = None,
                   chunk_size: int = 256) -> torch.Tensor:
    """Per-token logp of input_ids[t+1] given the prefix -> (B, L-1), with
    the chunked vocab projection of ``ops/logprobs.py``."""
    out = forward(params, cfg, input_ids, attention_mask=attention_mask,
                  audio_values=audio_values, need_logits=False)
    lm = params['language_model']
    hidden = out.last_hidden_state
    head = (lm['embedding'].T if cfg.text.tie_word_embeddings
            else lm['lm_head']).to(hidden.dtype)
    return hidden_to_token_logprobs(
        hidden[:, :-1], head, input_ids[:, 1:], chunk_size=chunk_size,
        softcap=cfg.text.final_logit_softcap,
        true_vocab=cfg.text.true_vocab_size)
