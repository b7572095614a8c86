"""Batch reward-score inference over a dataset, the port of
``align_anything_tpu/trainers/text_to_text/rm_score.py`` (reference:
trainers/text_to_text/rm_score.py:78-204).

Launch:
    python -m align_anything_tpu_torch.trainers.text_to_text.rm_score \\
        --model_name_or_path <slice dir> --train_datasets <path> \\
        --train_template Alpaca --output_dir ./output/scores

Loads a score model (the trunk and ``score_head.npy``; a fresh head where
there is none), runs the supervised dataset through it under
``torch.no_grad()``, and writes ``{text, score}`` rows to
``output_dir/scores.jsonl``.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from align_anything_tpu_torch.data import SupervisedDataset
from align_anything_tpu_torch.models import score_model
from align_anything_tpu_torch.trainers.base import TrainerBase
from align_anything_tpu_torch.trainers.cli import trainer_main
from align_anything_tpu_torch.trainers.text_to_text.ppo import (
    load_score_model_params,
)
from align_anything_tpu_torch.utils.logger import is_main_process


class RMScoreTrainer(TrainerBase):
    """A 'trainer' whose ``train()`` is a scoring sweep (the reference keeps
    the same launch surface for this utility)."""

    def init_models(self) -> None:
        path = self.cfgs.model_cfgs.model_name_or_path
        params, self.model_cfg = self.load_model(path, self.next_rng)
        params.update(load_score_model_params(
            path if path and os.path.isdir(path) else None,
            self.model_cfg.hidden_size, self.next_rng(), self.device))
        self.tokenizer = self.load_tokenizer_for(path, self.model_cfg)
        self.params = self.shard_model_params(params, self.model_cfg)

    def init_datasets(self) -> None:
        dc = self.cfgs.data_cfgs
        template = self.make_chat_template(dc.train_template, self.tokenizer)
        max_len = int(self.cfgs.model_cfgs.model_max_length or 2048)
        self.dataset = SupervisedDataset(
            dc.train_datasets, template, self.tokenizer, max_length=max_len,
            split=dc.train_split, size=dc.train_size,
            data_files=dc.train_data_files)
        # one device: the global batch is the per-device batch
        bs = int(self.cfgs.train_cfgs.per_device_eval_batch_size or 1)
        self.train_iterator = self.make_iterator(
            self.dataset, bs,
            self.dataset.get_collator(buckets=self.padding_buckets()),
            shuffle=False)

    def init_engines(self) -> None:
        pass

    @torch.no_grad()
    def score(self, batch: dict) -> torch.Tensor:
        """(B,) end scores of a supervised batch."""
        batch = self.put_batch(batch)
        return score_model.forward(
            self.params, self.model_cfg, batch['input_ids'],
            attention_mask=batch['attention_mask']).end_scores.squeeze(-1)

    def train(self) -> None:
        out_dir = self.cfgs.logger_cfgs.output_dir or '.'
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, 'scores.jsonl')
        pad = self.tokenizer.pad_token_id
        n = 0
        with open(out_path, 'w') as f:
            for batch in self.train_iterator.epoch_batches(0):
                scores = self.score(batch).cpu().tolist()
                if not is_main_process():
                    continue
                for ids, score in zip(batch['input_ids'], scores):
                    text = self.tokenizer.decode(
                        [t for t in ids if t != pad], skip_special_tokens=True)
                    f.write(json.dumps({'text': text,
                                        'score': float(score)}) + '\n')
                    n += 1
        self.logger.print(f'wrote {n} scores to {out_path}')

    def save(self, tag: int | None = None) -> None:
        pass


def main():
    trainer_main(RMScoreTrainer, task='text_to_text/rm')


if __name__ == '__main__':
    sys.exit(main())
