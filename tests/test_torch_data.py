"""The port's data layer (``align_anything_tpu_torch/data``) against the JAX
package's: the cases of ``tests/test_data.py`` (the prompt-only dataset,
not ported, aside) through the port, and the same rows through both give
equal numpy batches, key for key, and the same iterator order for a seed.
Batches are compared exactly (integer ids and 0/1 masks)."""

import json

import numpy as np
import pytest

pytest.importorskip('torch')

from align_anything_tpu import data as jdata  # noqa: E402
from align_anything_tpu_torch import data as tdata  # noqa: E402
from align_anything_tpu_torch.data import (  # noqa: E402
    IGNORE_INDEX,
    ChatTemplate,
    DataIterator,
    HashTokenizer,
    PreferenceDataset,
    SupervisedDataset,
    UnmatchedSupervisedDataset,
    get_template_class,
)

ALPACA_ROWS = [
    {'instruction': 'Add the numbers', 'input': '2 and 3', 'output': 'The answer is 5'},
    {'instruction': 'Name a color', 'input': '', 'output': 'blue'},
]

SAFE_RLHF_ROWS = [
    {'prompt': 'How do I bake bread', 'response_0': 'Mix flour and water then bake',
     'response_1': 'I cannot help', 'better_response_id': 0},
    {'prompt': 'Tell me a joke', 'response_0': 'No', 'response_1': 'Why did the chicken',
     'better_response_id': 1},
    {'prompt': 'Degenerate', 'response_0': 'same', 'response_1': 'same',
     'better_response_id': 0},
]


@pytest.fixture()
def tok():
    return HashTokenizer(vocab_size=512)


def test_template_registry():
    t = get_template_class('Alpaca')
    conv, info = t.format_supervised_sample(ALPACA_ROWS[0])
    assert conv[0]['role'] == 'user' and conv[1]['role'] == 'assistant'
    assert 'Add the numbers 2 and 3' == conv[0]['content']
    with pytest.raises(ValueError, match='not registered'):
        get_template_class('NoSuchTemplate')


def test_text_templates_match_jax():
    """The port registers the JAX package's text templates, each formatting
    a row to the same conversation."""
    from align_anything_tpu.data import formatters as jf
    from align_anything_tpu_torch.data import formatters as tf

    text = {n for n, c in jdata.TEMPLATE_REGISTRY.items()
            if c.__module__ == jf.__name__}
    # the image-text templates (data/multimodal_formatters.py) are held to
    # JAX's in tests/test_torch_image_data.py
    assert {n for n, c in tdata.TEMPLATE_REGISTRY.items()
            if c.__module__ == tf.__name__} == text
    ct, jct = ChatTemplate(template='PKUSafeRLHF'), jdata.ChatTemplate(
        template='PKUSafeRLHF')
    for row in SAFE_RLHF_ROWS:
        assert ct.format_preference_with_prompt(row) == \
            jct.format_preference_with_prompt(row)


def test_chat_template_default_format():
    ct = ChatTemplate(template='Alpaca')
    prompt, full, _ = ct.format_supervised_sample(ALPACA_ROWS[0])
    assert full.startswith(prompt)
    assert 'USER:' in prompt and 'ASSISTANT:' in full


def test_supervised_dataset_masks_prompt(tok):
    ct = ChatTemplate(template='Alpaca')
    ds = SupervisedDataset('unused', ct, tok, raw_data=ALPACA_ROWS)
    item = ds[0]
    labels = np.asarray(item['labels'])
    assert (labels[:item['prompt_len']] == IGNORE_INDEX).all()
    assert (labels[item['prompt_len']:] != IGNORE_INDEX).any()
    assert item['input_ids'][:item['prompt_len']] == \
        tok.encode(ct.format_supervised_sample(ALPACA_ROWS[0])[0])[:item['prompt_len']]


def test_supervised_collator_buckets(tok):
    ct = ChatTemplate(template='Alpaca')
    ds = SupervisedDataset('unused', ct, tok, raw_data=ALPACA_ROWS)
    batch = ds.get_collator(buckets=(16, 32))([ds[0], ds[1]])
    assert batch['input_ids'].shape == (2, 16)
    assert batch['attention_mask'].sum(1).tolist() == [
        len(ds[0]['input_ids']), len(ds[1]['input_ids'])]
    assert (batch['labels'][batch['attention_mask'] == 0] == IGNORE_INDEX).all()


def test_preference_dataset_and_collator(tok):
    ct = ChatTemplate(template='PKUSafeRLHF')
    ds = PreferenceDataset('unused', ct, tok, raw_data=SAFE_RLHF_ROWS)
    assert len(ds) == 2          # the raw-equal "Degenerate" row is dropped
    degenerate = {'better_input_ids': ds[0]['better_input_ids'],
                  'worse_input_ids': ds[0]['better_input_ids'],
                  'better_prompt_len': ds[0]['better_prompt_len'],
                  'worse_prompt_len': ds[0]['better_prompt_len'],
                  'is_equal': True}
    batch = ds.get_collator(buckets=(32,))([ds[0], ds[1], degenerate])
    b = 3
    assert batch['input_ids'].shape == (2 * b, 32)
    item = ds[0]
    np.testing.assert_array_equal(
        batch['input_ids'][0, :item['better_prompt_len']],
        batch['input_ids'][b, :item['worse_prompt_len']])
    n = len(item['better_input_ids'])
    rm = batch['response_mask'][0]
    assert rm[:item['better_prompt_len']].sum() == 0
    assert rm[item['better_prompt_len']:n - 1].all()
    assert rm[n - 1:].sum() == 0
    assert batch['sample_weight'].tolist() == [1.0, 1.0, 0.0]


def test_unmatched_dataset_mixes_rows(tok):
    ct = ChatTemplate(template='PKUSafeRLHF')
    ds = UnmatchedSupervisedDataset('unused', ct, tok, raw_data=SAFE_RLHF_ROWS,
                                    seed=1)
    items = [ds[i] for i in range(3)]
    assert all(len(i['input_ids']) > i['prompt_len'] for i in items)
    jds = jdata.UnmatchedSupervisedDataset(
        'unused', jdata.ChatTemplate(template='PKUSafeRLHF'), tok,
        raw_data=SAFE_RLHF_ROWS, seed=1)
    assert items == [jds[i] for i in range(3)]


def test_data_iterator_determinism(tok):
    ct = ChatTemplate(template='Alpaca')
    rows = [dict(ALPACA_ROWS[0], input=str(i)) for i in range(8)]
    ds = SupervisedDataset('unused', ct, tok, raw_data=rows)
    col = ds.get_collator(buckets=(16,))
    it1 = DataIterator(ds, 4, col, seed=7)
    it2 = DataIterator(ds, 4, col, seed=7)
    b1, b2 = list(it1.epoch_batches(0)), list(it2.epoch_batches(0))
    assert len(b1) == 2
    np.testing.assert_array_equal(b1[0]['input_ids'], b2[0]['input_ids'])
    b3 = list(it1.epoch_batches(1))
    assert not all(np.array_equal(a['input_ids'], b['input_ids'])
                   for a, b in zip(b1, b3))


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps']
    pick = lambda k: ' '.join(words[j] for j in rng.integers(0, 5, size=k))  # noqa: E731
    return ([{'prompt': pick(int(rng.integers(1, 9))),
              'response_0': pick(int(rng.integers(1, 30))),
              'response_1': pick(int(rng.integers(1, 30))),
              'better_response_id': int(rng.integers(0, 2))}
             for _ in range(n)],
            [{'instruction': pick(int(rng.integers(1, 9))),
              'input': pick(int(rng.integers(0, 4))),
              'output': pick(int(rng.integers(1, 30)))} for _ in range(n)])


@pytest.mark.parametrize('kind,seed', [('preference', 0), ('preference', 1),
                                       ('supervised', 0), ('supervised', 1)])
def test_batches_match_jax(tok, kind, seed):
    """Every batch of two epochs, every key, equal to the JAX package's, at
    buckets (16, 32, 64) that several batches straddle."""
    pref, sft = _rows(24, seed)
    rows, template = ((pref, 'PKUSafeRLHF') if kind == 'preference'
                      else (sft, 'Alpaca'))
    cls = 'PreferenceDataset' if kind == 'preference' else 'SupervisedDataset'
    its = []
    for mod in (tdata, jdata):
        ds = getattr(mod, cls)('unused', mod.ChatTemplate(template=template),
                               tok, max_length=48, raw_data=rows)
        its.append(mod.DataIterator(ds, 4, ds.get_collator(
            buckets=(16, 32, 64)), seed=seed + 3))
    for epoch in (0, 1):
        got = list(its[0].epoch_batches(epoch))
        want = list(its[1].epoch_batches(epoch))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in g:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_json_passthrough(tmp_path, tok):
    rows = [{'instruction': 'a', 'input': 'b', 'output': 'c'}]
    p = tmp_path / 'data.jsonl'
    with open(p, 'w') as f:
        for r in rows:
            f.write(json.dumps(r) + '\n')
    ct = ChatTemplate(template='Alpaca')
    ds = SupervisedDataset(str(p), ct, tok)
    assert len(ds) == 1 and ds[0]['input_ids']


@pytest.mark.parametrize('layout', ['jsonl', 'json_list'])
def test_raw_rows_match_hf_datasets(tmp_path, monkeypatch, layout):
    """A local file read with the standard library gives the rows HF
    ``datasets`` gives (the JAX ``load_raw_dataset``): a column missing from
    some rows is ``None`` there, columns in first-seen order, ``size``
    cuts."""
    pytest.importorskip('datasets')
    monkeypatch.setenv('HF_DATASETS_CACHE', str(tmp_path / 'cache'))
    rows = [{'prompt': 'p0', 'response_0': 'a', 'response_1': 'b',
             'better_response_id': 0},
            {'prompt': 'p1', 'response_0': 'c', 'response_1': 'd',
             'better_response_id': 1, 'note': 'extra'},
            {'response_0': 'e', 'response_1': 'f', 'prompt': 'p2',
             'better_response_id': 0}]
    p = tmp_path / ('rows.jsonl' if layout == 'jsonl' else 'rows.json')
    with open(p, 'w') as f:
        if layout == 'jsonl':
            f.write(''.join(json.dumps(r) + '\n' for r in rows))
        else:
            json.dump(rows, f)
    got = tdata.load_raw_dataset(str(p))
    want = jdata.load_raw_dataset(str(p))
    assert got == want
    assert [list(r) for r in got] == [list(r) for r in want]
    assert got[0]['note'] is None and got[1]['note'] == 'extra'
    assert tdata.load_raw_dataset(str(p), size=2) == \
        jdata.load_raw_dataset(str(p), size=2)
