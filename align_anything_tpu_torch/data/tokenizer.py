"""Tokenizer loading + a hermetic test tokenizer: the port of
``align_anything_tpu/data/tokenizer.py``, unchanged.

``transformers`` is imported only inside ``load_tokenizer``.

Production path: HF tokenizers from a local checkpoint dir (pure
Python/Rust, no CUDA — same dependency the reference uses through
``load_pretrained_models``, models/pretrained_model.py:214-236).

Test path: ``HashTokenizer`` — a deterministic, network-free word-level
tokenizer so dataset/collator/trainer tests never need downloaded assets.
"""

from __future__ import annotations

import re
from typing import Protocol


class Tokenizer(Protocol):
    pad_token_id: int
    eos_token_id: int
    bos_token_id: int | None

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]: ...
    def decode(self, ids: list[int], skip_special_tokens: bool = True) -> str: ...


def load_tokenizer(model_name_or_path: str, model_max_length: int | None = None,
                   padding_side: str = 'right'):
    from transformers import AutoTokenizer  # noqa: PLC0415

    kwargs = {'padding_side': padding_side}
    if model_max_length is not None:
        kwargs['model_max_length'] = model_max_length
    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, **kwargs)
    if tokenizer.pad_token_id is None:
        tokenizer.pad_token = tokenizer.eos_token
    return tokenizer


class HashTokenizer:
    """Deterministic word-level tokenizer over a fixed vocab (tests only).

    ids: 0=pad, 1=bos, 2=eos, 3=unk, 4.. = hashed words.  Decoding returns
    the remembered word for ids seen by this instance.
    """

    def __init__(self, vocab_size: int = 512, add_bos: bool = True,
                 add_eos: bool = True):
        self.vocab_size = vocab_size
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.unk_token_id = 3
        self.add_bos = add_bos
        self.add_eos = add_eos
        self._id_to_word: dict[int, str] = {}
        self.eos_token = '</s>'
        self.pad_token = '<pad>'

    def _word_id(self, word: str) -> int:
        # stable non-cryptographic hash (Python's hash() is salted per run)
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        wid = 4 + (h % (self.vocab_size - 4))
        self._id_to_word.setdefault(wid, word)
        return wid

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        words = re.findall(r'\S+|\n', text)
        ids = [self._word_id(w) for w in words]
        if add_special_tokens and self.add_bos:
            ids = [self.bos_token_id] + ids
        if add_special_tokens and self.add_eos:
            ids = ids + [self.eos_token_id]
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True, **_):
        ids = self.encode(text, add_special_tokens=add_special_tokens)
        return {'input_ids': ids, 'attention_mask': [1] * len(ids)}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        words = []
        for i in ids:
            i = int(i)
            if i in (self.pad_token_id, self.bos_token_id, self.eos_token_id):
                if not skip_special_tokens:
                    words.append({0: '<pad>', 1: '<s>', 2: '</s>'}[i])
                continue
            words.append(self._id_to_word.get(i, '<unk>'))
        return ' '.join(words)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]
