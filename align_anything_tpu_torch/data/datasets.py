"""Text datasets + collators with static-shape (bucketized) padding: the
port of ``align_anything_tpu/data/datasets.py``.

The same Supervised / Preference / Unmatched archetypes and label-masking
semantics as the JAX module; collators pad to fixed length buckets (the
JAX module's reason was XLA's recompile per shape; here a bucket keeps the
flash kernel's shapes and the allocator's blocks few).

Batch contract (numpy, moved to the device by the trainer's ``put_batch``):
- supervised: input_ids (B, L), labels (B, L) with prompt/pad = -100,
  attention_mask (B, L).
- preference: input_ids (2B, L) better-rows-then-worse-rows,
  attention_mask, response_mask (2B, L-1) over next-token positions of the
  response (the reference's ``meta_info.response_lens`` slice,
  dpo.py:122-142), divergence_mask (2B, L-1) for KTO/ORPO/SimPO
  (kto.py:115-126 divergence slicing), seq_lengths (2B,), sample_weight (B,)
  zeroing degenerate pairs (kto.py:116 skip).
- prompt_only: left-padded input_ids/attention_mask (B, L), and ``meta``
  (a list, one dict per row, which ``put_batch`` drops).

``load_raw_dataset`` reads a local ``.json`` / ``.jsonl`` with the standard
library and imports HF ``datasets`` only for hub names and ``data_files``.
Left out: ``DummyDataset`` (no ported trainer uses it) and the SPOC
Chores episode layout (``data/chores.py``, the multimodal slice).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from align_anything_tpu_torch.data.chat_template import ChatTemplate
from align_anything_tpu_torch.utils.tools import bucket_length

IGNORE_INDEX = -100
DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def _read_json_rows(path: str) -> list[dict]:
    """Rows of a local ``.json`` (a list of objects, or one object per
    line) or ``.jsonl`` file, as HF ``load_dataset('json', ...)`` reads
    them: every row gets every column, in the order the columns first
    appear, with ``None`` where a row lacks one."""
    with open(path, encoding='utf-8') as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith('['):
        rows = json.loads(stripped)
    else:
        rows = [json.loads(line) for line in text.splitlines()
                if line.strip()]
    columns: dict[str, None] = {}
    for row in rows:
        columns.update(dict.fromkeys(row))
    return [{c: row.get(c) for c in columns} for row in rows]


def load_raw_dataset(path: str, split: str | None = None,
                     size: int | None = None,
                     data_files: Any = None, name: str | None = None,
                     optional_args: Sequence[str] = ()) -> list[dict]:
    """Load rows: a local json/jsonl path with the standard library, else
    through HF datasets (reference: datasets/text_to_text/supervised.py:
    71-87)."""
    if path.endswith(('.json', '.jsonl')) and os.path.exists(path):
        data = _read_json_rows(path)
    else:
        from datasets import load_dataset  # noqa: PLC0415

        kwargs = {}
        if name:
            kwargs['name'] = name
        if data_files:
            kwargs['data_files'] = data_files
        data = load_dataset(path, *optional_args, split=split or 'train',
                            **kwargs)
    if size is not None:
        size = min(int(size), len(data))
        data = data[:size] if isinstance(data, list) else data.select(
            range(size))
    return list(data)


def _encode(tokenizer, text: str) -> list[int]:
    out = tokenizer(text, add_special_tokens=True)
    ids = out['input_ids'] if isinstance(out, dict) else out.input_ids
    return list(ids)


def _common_prefix_len(a: list[int], b: list[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class SupervisedDataset:
    """Full-conversation LM dataset with prompt tokens masked to -100
    (reference: datasets/text_to_text/supervised.py:52-126)."""

    def __init__(self, path: str, template: ChatTemplate, tokenizer,
                 max_length: int = 2048, split: str | None = None,
                 size: int | None = None, data_files: Any = None,
                 name: str | None = None, optional_args: Sequence[str] = (),
                 raw_data: list[dict] | None = None):
        self.template = template
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.raw = (raw_data if raw_data is not None else
                    load_raw_dataset(path, split, size, data_files, name,
                                     optional_args))

    def __len__(self) -> int:
        return len(self.raw)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, full_text, _mm = self.template.format_supervised_sample(
            self.raw[idx])
        return self.tokenize_pair(prompt_text, full_text)

    def tokenize_pair(self, prompt_text: str, full_text: str) -> dict[str, Any]:
        full_ids = _encode(self.tokenizer, full_text)[:self.max_length]
        prompt_ids = _encode(self.tokenizer, prompt_text)
        # robust prompt-length: common prefix (tokenizers may append eos)
        prompt_len = min(_common_prefix_len(prompt_ids, full_ids),
                         len(full_ids) - 1)
        labels = [IGNORE_INDEX] * prompt_len + full_ids[prompt_len:]
        return {'input_ids': full_ids, 'labels': labels,
                'prompt_len': prompt_len}

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> 'SupervisedCollator':
        return SupervisedCollator(self.tokenizer.pad_token_id, buckets, pad_to)


class SupervisedCollator:
    def __init__(self, pad_token_id: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 pad_to: int | None = None):
        self.pad_token_id = pad_token_id
        self.buckets = buckets
        self.pad_to = pad_to

    def __call__(self, samples: list[dict]) -> dict[str, np.ndarray]:
        max_len = max(len(s['input_ids']) for s in samples)
        length = self.pad_to or bucket_length(max_len, self.buckets)
        b = len(samples)
        input_ids = np.full((b, length), self.pad_token_id, np.int32)
        labels = np.full((b, length), IGNORE_INDEX, np.int32)
        mask = np.zeros((b, length), np.int32)
        for i, s in enumerate(samples):
            ids = np.asarray(s['input_ids'][:length], np.int32)
            lab = np.asarray(s['labels'][:length], np.int32)
            input_ids[i, :len(ids)] = ids
            labels[i, :len(lab)] = lab
            mask[i, :len(ids)] = 1
        return {'input_ids': input_ids, 'labels': labels,
                'attention_mask': mask}


class UnmatchedSupervisedDataset(SupervisedDataset):
    """Prompts paired with responses from *other* rows — KTO's KL batch
    (reference: datasets/text_to_text/supervised.py:166; kto.py:62-80)."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        rng = np.random.default_rng(seed)
        self.response_perm = rng.permutation(len(self.raw))

    def __getitem__(self, idx: int) -> dict[str, Any]:
        other = int(self.response_perm[idx])
        prompt_text, full_text, _mm = (
            self.template.format_unmatched_supervised_sample(
                self.raw[idx], self.raw[other]))
        return self.tokenize_pair(prompt_text, full_text)


class PreferenceDataset:
    """Better/worse pairs for RM/DPO/KTO/ORPO/SimPO
    (reference: datasets/text_to_text/preference.py:179-201)."""

    def __init__(self, path: str, template: ChatTemplate, tokenizer,
                 max_length: int = 2048, split: str | None = None,
                 size: int | None = None, data_files: Any = None,
                 name: str | None = None, optional_args: Sequence[str] = (),
                 raw_data: list[dict] | None = None):
        self.template = template
        self.tokenizer = tokenizer
        self.max_length = max_length
        raw = (raw_data if raw_data is not None else
               load_raw_dataset(path, split, size, data_files, name,
                                optional_args))
        # filtering hooks: drop equal pairs, then invalid rows
        # (reference: datasets/text_to_text/preference.py:98-114)
        self.raw = [s for s in raw
                    if not template.check_equal(s)
                    and template.check_validation(s)]

    def __len__(self) -> int:
        return len(self.raw)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, better_text, worse_text, _mm = (
            self.template.format_preference_with_prompt(self.raw[idx]))
        better_ids = _encode(self.tokenizer, better_text)[:self.max_length]
        worse_ids = _encode(self.tokenizer, worse_text)[:self.max_length]
        prompt_ids = _encode(self.tokenizer, prompt_text)
        better_prompt_len = min(_common_prefix_len(prompt_ids, better_ids),
                                len(better_ids) - 1)
        worse_prompt_len = min(_common_prefix_len(prompt_ids, worse_ids),
                               len(worse_ids) - 1)
        return {
            'better_input_ids': better_ids,
            'worse_input_ids': worse_ids,
            'better_prompt_len': better_prompt_len,
            'worse_prompt_len': worse_prompt_len,
            'is_equal': better_ids == worse_ids,
        }

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> 'PreferenceCollator':
        return PreferenceCollator(self.tokenizer.pad_token_id, buckets, pad_to)


class PreferenceCollator:
    def __init__(self, pad_token_id: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 pad_to: int | None = None):
        self.pad_token_id = pad_token_id
        self.buckets = buckets
        self.pad_to = pad_to

    def __call__(self, samples: list[dict]) -> dict[str, np.ndarray]:
        b = len(samples)
        max_len = max(max(len(s['better_input_ids']), len(s['worse_input_ids']))
                      for s in samples)
        length = self.pad_to or bucket_length(max_len, self.buckets)

        input_ids = np.full((2 * b, length), self.pad_token_id, np.int32)
        mask = np.zeros((2 * b, length), np.int32)
        response_mask = np.zeros((2 * b, length - 1), np.float32)
        divergence_mask = np.zeros((2 * b, length - 1), np.float32)
        seq_lengths = np.zeros((2 * b,), np.float32)
        sample_weight = np.zeros((b,), np.float32)

        for i, s in enumerate(samples):
            for j, (ids_key, plen_key) in enumerate(
                    (('better_input_ids', 'better_prompt_len'),
                     ('worse_input_ids', 'worse_prompt_len'))):
                row = i + j * b
                ids = np.asarray(s[ids_key][:length], np.int32)
                n = len(ids)
                input_ids[row, :n] = ids
                mask[row, :n] = 1
                seq_lengths[row] = n
                # response next-token positions: the reference gathers
                # logits[-response_len:][:-1] vs ids[-response_len:][1:],
                # i.e. logp entries [prompt_len, n-1) (dpo.py:122-142)
                plen = min(s[plen_key], n - 1)
                response_mask[row, plen:n - 1] = 1.0
            # divergence slice for KTO/ORPO/SimPO (kto.py:115-126)
            b_ids = np.asarray(s['better_input_ids'][:length])
            w_ids = np.asarray(s['worse_input_ids'][:length])
            m = min(len(b_ids), len(w_ids))
            neq = np.nonzero(b_ids[:m] != w_ids[:m])[0]
            if len(b_ids) == len(w_ids) and len(neq) == 0:
                sample_weight[i] = 0.0  # degenerate pair: skipped
                continue
            sample_weight[i] = 1.0
            diverge = int(neq[0]) if len(neq) else m
            divergence_mask[i, max(diverge - 1, 0):len(b_ids) - 1] = 1.0
            divergence_mask[i + b, max(diverge - 1, 0):len(w_ids) - 1] = 1.0

        return {
            'input_ids': input_ids, 'attention_mask': mask,
            'response_mask': response_mask,
            'divergence_mask': divergence_mask,
            'seq_lengths': seq_lengths,
            'sample_weight': sample_weight,
        }


class PromptOnlyDataset:
    """Deduplicated prompts, left-padded for generation
    (reference: datasets/text_to_text/prompt_only.py:64)."""

    def __init__(self, path: str, template: ChatTemplate, tokenizer,
                 max_length: int = 2048, split: str | None = None,
                 size: int | None = None, data_files: Any = None,
                 name: str | None = None, optional_args: Sequence[str] = (),
                 raw_data: list[dict] | None = None):
        self.template = template
        self.tokenizer = tokenizer
        self.max_length = max_length
        raw = (raw_data if raw_data is not None else
               load_raw_dataset(path, split, size, data_files, name,
                                optional_args))
        seen: set[str] = set()
        self.samples: list[dict] = []
        for s in raw:
            prompt_text, mm = self.template.format_prompt_only_sample(s)
            if prompt_text in seen:
                continue
            seen.add(prompt_text)
            self.samples.append({'prompt_text': prompt_text, 'meta': mm})

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        s = self.samples[idx]
        ids = _encode(self.tokenizer, s['prompt_text'])[:self.max_length]
        # generation prompts must not end with EOS
        if ids and ids[-1] == self.tokenizer.eos_token_id:
            ids = ids[:-1]
        return {'input_ids': ids, 'meta': s['meta']}

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> 'PromptOnlyCollator':
        return PromptOnlyCollator(self.tokenizer.pad_token_id, buckets, pad_to)


class PromptOnlyCollator:
    def __init__(self, pad_token_id: int,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 pad_to: int | None = None):
        self.pad_token_id = pad_token_id
        self.buckets = buckets
        self.pad_to = pad_to

    def __call__(self, samples: list[dict]) -> dict[str, Any]:
        max_len = max(len(s['input_ids']) for s in samples)
        length = self.pad_to or bucket_length(max_len, self.buckets)
        b = len(samples)
        input_ids = np.full((b, length), self.pad_token_id, np.int32)
        mask = np.zeros((b, length), np.int32)
        for i, s in enumerate(samples):
            ids = np.asarray(s['input_ids'][-length:], np.int32)
            input_ids[i, length - len(ids):] = ids
            mask[i, length - len(ids):] = 1
        return {'input_ids': input_ids, 'attention_mask': mask,
                'meta': [s.get('meta', {}) for s in samples]}


class DataIterator:
    """Shuffling epoch iterator with host-sharding for multi-process runs.

    Replaces torch DataLoader + DistributedSampler
    (reference: trainers/base/supervised_trainer.py:79-232): deterministic
    per-epoch permutation from a seed, so resume = fast-forward by batch
    count with identical order.  The port's trainers run one process
    (``process_index=0``, ``process_count=1``).
    """

    def __init__(self, dataset, batch_size: int, collator: Callable,
                 seed: int = 0, shuffle: bool = True, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1):
        if batch_size % process_count:
            raise ValueError('batch_size must divide evenly across processes')
        self.dataset = dataset
        self.batch_size = batch_size
        self.collator = collator
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        if drop_last and len(dataset) < batch_size:
            import warnings  # noqa: PLC0415

            warnings.warn(
                f'dataset has {len(dataset)} samples but the global batch '
                f'size is {batch_size} with drop_last=True — every epoch '
                'will be empty', stacklevel=2)

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def epoch_batches(self, epoch: int) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(order)
        per_proc = self.batch_size // self.process_count
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            local = idx[self.process_index * per_proc:
                        (self.process_index + 1) * per_proc]
            yield self.collator([self.dataset[int(i)] for i in local])

    def __iter__(self) -> Iterator[dict]:
        it = self.epoch_batches(self.epoch)
        self.epoch += 1
        return it
