"""Text-audio-to-text SFT, the port of
``align_anything_tpu/trainers/text_audio_to_text/sft.py`` (reference:
trainers/text_audio_to_text/sft.py).

Launch:
    python -m align_anything_tpu_torch.trainers.text_audio_to_text.sft \\
        --model_name_or_path <Qwen2-Audio dir | text dir | preset> \\
        --train_datasets <path> --train_template AA_TA2T \\
        --output_dir ./output/ta2t_sft

The Qwen2-Audio-class model of ``models/audio.py``: the log-mel frontend
runs on the device inside the step, the audio tokens merge over the
<audio> placeholders, then the same cross-entropy as text SFT.  Two
starting points, as in JAX:

- a Qwen2-Audio checkpoint (a ``config.json`` with an ``audio_config``):
  ``load_audio_params``; the config takes the run's compute dtype and no
  remat;
- anything else (a text checkpoint or a preset): the text trunk through
  ``load_model`` (compute dtype and remat) and a fresh encoder sized by
  ``n_mels``, ``audio_hidden_size``, ``audio_layers``, ``audio_heads``,
  ``audio_mlp_dim`` and ``audio_max_frames``; the audio token is
  ``audio_token_id``, else the last id of the vocabulary.

Every clip is padded to ``waveform_len`` samples (30 s by default) and
keeps all ``num_audio_tokens`` tokens, with no frame mask, as in JAX
(ROADMAP §3 R28 says what transformers does instead).  The freeze flags
of the YAMLs (``freeze_audio_tower: True``) name the tree's
``audio_tower``: the tower is frozen, so its backward never runs.
``save`` writes the train state and the Qwen2-Audio-layout HF slice.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from align_anything_tpu_torch import checkpoint as ckpt_lib
from align_anything_tpu_torch.data.audio import TA2TSupervisedDataset
from align_anything_tpu_torch.losses import cross_entropy_loss
from align_anything_tpu_torch.models import audio
from align_anything_tpu_torch.models.audio import (
    AudioEncoderConfig,
    AudioLMConfig,
)
from align_anything_tpu_torch.models.hf_loader import load_audio_params
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.sft import SupervisedTrainer


def _is_audio_checkpoint(path) -> bool:
    """Whether ``path`` is a directory whose ``config.json`` has an
    ``audio_config`` (a Qwen2-Audio checkpoint)."""
    cfg_file = os.path.join(path or '', 'config.json')
    if not (path and os.path.isdir(path) and os.path.exists(cfg_file)):
        return False
    with open(cfg_file) as f:
        return 'audio_config' in json.load(f)


class TA2TTrainerMixin:
    """The audio LM and the audio datasets of the TA2T trainers, over a
    text trainer's engine; ``DATASET_CLS`` is the audio dataset."""

    def load_audio_lm(self) -> dict:
        """The audio LM's params (fp32, on the trainer's device) from
        ``model_name_or_path``; sets ``model_cfg`` and ``tokenizer``."""
        path = self.cfgs.model_cfgs.model_name_or_path
        tc = self.cfgs.train_cfgs
        if _is_audio_checkpoint(path):
            params, cfg = load_audio_params(path, device=self.device)
            self.model_cfg = cfg.replace(
                compute_dtype='bfloat16' if tc.bf16 in (True, None)
                else 'float32')
            audio.check_supported(self.model_cfg)
        else:
            text_params, text_cfg = self.load_model(path, self.next_rng)
            self.model_cfg = AudioLMConfig(
                text=text_cfg,
                audio=AudioEncoderConfig(
                    n_mels=int(tc.n_mels or 128),
                    hidden_size=int(tc.audio_hidden_size or 256),
                    num_layers=int(tc.audio_layers or 4),
                    num_heads=int(tc.audio_heads or 4),
                    mlp_dim=int(tc.audio_mlp_dim or 1024),
                    max_frames=int(tc.audio_max_frames or 3000)),
                audio_token_id=int(tc.audio_token_id
                                   or text_cfg.vocab_size - 1))
            params = audio.init_params(self.model_cfg, self.next_rng(),
                                       device=self.device)
            params['language_model'] = text_params
        self.tokenizer = self.load_tokenizer_for(path, self.model_cfg)
        return params

    def init_models(self) -> None:
        self.params = self.trainable(self.load_audio_lm())

    def make_dataset(self, dataset_cls, path, template, max_len, **kw):
        return dataset_cls(
            path, template, self.tokenizer,
            audio_token_id=self.model_cfg.audio_token_id,
            num_audio_tokens=self.model_cfg.audio.num_audio_tokens,
            waveform_len=int(self.cfgs.train_cfgs.waveform_len or 480000),
            max_length=max_len, **kw)

    def init_datasets(self) -> None:
        dc = self.cfgs.data_cfgs
        template = self.make_chat_template(dc.train_template, self.tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        dataset = self.make_dataset(
            self.DATASET_CLS, dc.train_datasets, template, max_len,
            split=dc.train_split, size=dc.train_size,
            data_files=dc.train_data_files)
        # one device: the global batch is the per-device batch
        batch_size = int(self.cfgs.train_cfgs.per_device_train_batch_size
                         or 1)
        self.train_iterator = self.make_iterator(
            dataset, batch_size,
            dataset.get_collator(buckets=self.padding_buckets()))
        self.eval_iterator = None

    def save_train_state_only(self, state, tag: int | None = None) -> None:
        """The train-state checkpoint of ``state`` and no HF slice, as
        JAX's TA2T DPO, RM, PPO and GRPO save."""
        out = self.cfgs.logger_cfgs.output_dir
        if out and self.cfgs.train_cfgs.save_checkpoint:
            ckpt_lib.save_train_state(
                out, tag if tag is not None else self.global_step, state,
                keep=self.cfgs.logger_cfgs.save_total_limit, wait=False)


class TA2TSupervisedTrainer(TA2TTrainerMixin, SupervisedTrainer):
    DATASET_CLS = TA2TSupervisedDataset

    def loss_fn(self, params: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
        out = audio.forward(params, self.model_cfg, batch['input_ids'],
                            attention_mask=batch['attention_mask'],
                            audio_values=batch.get('audio_values'))
        loss = cross_entropy_loss(out.logits, batch['labels'])['loss']
        return loss, {'train/loss': loss.detach()}


def main():
    trainer_main(TA2TSupervisedTrainer, task='text_audio_to_text/sft')


if __name__ == '__main__':
    sys.exit(main())
