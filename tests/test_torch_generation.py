"""The PyTorch port's generation engines against the JAX package's, on the
same int4-COMPUTE tiny model (weights through
``align_anything_tpu_torch/models/bridge.py``), float32 compute on the CPU.

Greedy token lists must be equal: the two packages' logits agree to
about 1e-3 relative or better (tests/test_torch_model.py), inside the gap
between the top two tokens at these seeds.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.generation import (  # noqa: E402
    ContinuousBatchingEngine,
    GenerationConfig,
    generate,
)
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.config import tiny_config  # noqa: E402

from test_torch_int4_matmul import np_tree  # noqa: E402

PROMPTS = [[5, 6, 7], [9, 10, 11, 12], [20]]


@pytest.fixture(scope='module')
def jx():
    jax = pytest.importorskip('jax')
    from align_anything_tpu.generation import continuous as jcont
    from align_anything_tpu.generation import engine as jeng
    from align_anything_tpu.models import config as jc
    from align_anything_tpu.models import quantization as jq
    from align_anything_tpu.models import transformer as jt

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, cont=jcont,
                                 eng=jeng, c=jc, q=jq, t=jt)


@pytest.fixture(scope='module')
def model(jx):
    """The int4-COMPUTE tiny model of tests/test_continuous_batching.py's
    int4 case, for both packages."""
    args = dict(vocab_size=128, hidden=256, layers=2, heads=4, kv_heads=2,
                mlp=256)
    jcfg = jx.c.tiny_config(**args).replace(compute_dtype='float32',
                                            attention_impl='xla')
    params = jx.q.quantize_decoder_int4(
        jx.t.init_params(jcfg, jx.jax.random.PRNGKey(3)), compute=True)
    tcfg = tiny_config(**args).replace(compute_dtype='float32',
                                       attention_impl='xla')
    return params, from_jax_tree(np_tree(params), device='cpu'), jcfg, tcfg


def _jax_engine(jx, jparams, jcfg, prompts, gen_kw, max_len=64,
                buckets=(8,)):
    gen = jx.eng.GenerationConfig(**gen_kw)
    eng = jx.cont.ContinuousBatchingEngine(jcfg, num_slots=2, max_len=max_len,
                                           prompt_buckets=buckets)
    return eng.generate(jparams, prompts, gen, jx.jax.random.PRNGKey(2),
                        chunk_steps=4)


def _torch_engine(tparams, tcfg, prompts, gen_kw, max_len=64, buckets=(8,),
                  **kw):
    eng = ContinuousBatchingEngine(tcfg, num_slots=2, max_len=max_len,
                                   prompt_buckets=buckets)
    out = eng.generate(tparams, prompts, GenerationConfig(**gen_kw),
                       torch.Generator().manual_seed(2), chunk_steps=4, **kw)
    return out, eng


GREEDY = dict(max_new_tokens=8, greedy=True, eos_token_id=-1)


def test_continuous_matches_jax_and_batch_engine(jx, model):
    jparams, tparams, jcfg, tcfg = model
    ref = _jax_engine(jx, jparams, jcfg, PROMPTS, GREEDY)
    out, eng = _torch_engine(tparams, tcfg, PROMPTS, GREEDY)
    assert out == ref
    assert [len(o) for o in out] == [8, 8, 8]
    # the third request waited for a slot and entered mid-run
    assert eng.stats['admit_step'][2] > 0

    # the port's own batch engine over left-padded prompts
    p = max(len(x) for x in PROMPTS)
    ids = np.zeros((len(PROMPTS), p), np.int64)
    mask = np.zeros_like(ids)
    for i, x in enumerate(PROMPTS):
        ids[i, p - len(x):] = x
        mask[i, p - len(x):] = 1
    batch = generate(tparams, tcfg, GenerationConfig(**GREEDY),
                     torch.from_numpy(ids), torch.from_numpy(mask))
    assert batch['completions'].tolist() == out


def test_eos_and_max_len_stops_match_jax(jx, model):
    """An EOS hit ends a request with EOS kept; a request that reaches
    max_len stops there, short of its budget."""
    jparams, tparams, jcfg, tcfg = model
    free = _jax_engine(jx, jparams, jcfg, PROMPTS, GREEDY)
    eos = free[1][3]          # request 1's fourth greedy token
    kw = dict(GREEDY, eos_token_id=eos)
    ref = _jax_engine(jx, jparams, jcfg, PROMPTS, kw)
    out, _ = _torch_engine(tparams, tcfg, PROMPTS, kw)
    assert out == ref
    assert out[1] == free[1][:4]

    kw = dict(GREEDY, max_new_tokens=12)
    ref = _jax_engine(jx, jparams, jcfg, PROMPTS, kw, max_len=12,
                      buckets=(4,))
    out, _ = _torch_engine(tparams, tcfg, PROMPTS, kw, max_len=12,
                           buckets=(4,))
    assert out == ref
    assert [len(o) for o in out] == [12 - len(p) for p in PROMPTS]


def test_serving_mode_callbacks(model):
    """request_feed / on_tokens / on_finish / should_stop, with arrivals
    while earlier requests decode, per-request budgets and temperatures."""
    _, tparams, _, tcfg = model
    solo, _ = _torch_engine(tparams, tcfg, PROMPTS, GREEDY)
    arrivals = [[(0, {'input_ids': PROMPTS[0], 'temperature': 0.0})],
                [],
                [(1, {'input_ids': PROMPTS[1], 'max_new_tokens': 3,
                      'temperature': 0.0}),
                 (2, {'input_ids': PROMPTS[2], 'temperature': 1.5})]]
    calls = {'feed': 0}
    streamed: dict[int, list[int]] = {}
    finished: dict[int, list[int]] = {}

    def feed():
        calls['feed'] += 1
        return arrivals.pop(0) if arrivals else []

    out, eng = _torch_engine(
        tparams, tcfg, [], dict(GREEDY, greedy=False, temperature=1.0),
        request_feed=feed,
        on_tokens=lambda rid, toks: streamed.setdefault(rid, []).extend(toks),
        on_finish=lambda rid, toks: finished.__setitem__(rid, toks),
        should_stop=lambda: len(finished) == 3, idle_sleep=0.0)
    assert out == []
    assert sorted(finished) == [0, 1, 2]
    assert finished[0] == solo[0]                # temperature 0: greedy
    assert finished[1] == solo[1][:3]            # its own budget
    assert len(finished[2]) == 8
    assert all(0 <= t < tcfg.vocab_size for t in finished[2])
    assert streamed == finished
    assert calls['feed'] >= 3
    # serving mode keeps no per-request state once a request finishes
    assert eng.stats['admit_step'] == {} and eng.stats['finish_step'] == {}


@pytest.mark.parametrize('top_k,top_p', [(3, 1.0), (0, 0.8), (5, 0.5)])
def test_sampling_filters_match_jax(top_k, top_p):
    """top-k / top-p keep the same tokens as the JAX filters, and draws
    land only on kept tokens (the random bits differ by design)."""
    pytest.importorskip('jax')
    from align_anything_tpu.generation import sampling as js

    from align_anything_tpu_torch.generation import sampling as ts

    logits = np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
    ref = np.asarray(js._apply_top_p(js._apply_top_k(logits, top_k), top_p))
    got = ts._apply_top_p(ts._apply_top_k(torch.from_numpy(logits), top_k),
                          top_p).numpy()
    np.testing.assert_array_equal(got, ref)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = ts.sample_token(torch.from_numpy(logits), gen, top_k=top_k,
                              top_p=top_p)
        assert (ref[np.arange(4), tok.numpy()] > js.NEG_INF).all()


def test_sampling_distribution_and_greedy():
    from align_anything_tpu_torch.generation.sampling import sample_token

    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    assert sample_token(logits, None, greedy=True).tolist() == [0]
    assert sample_token(logits, None, temperature=0.0).tolist() == [0]
    gen = torch.Generator().manual_seed(1)
    draws = sample_token(logits.expand(20000, 4), gen, temperature=2.0)
    freq = torch.bincount(draws, minlength=4).float() / 20000
    want = torch.softmax(logits[0] / 2.0, -1)
    assert float((freq - want).abs().max()) < 0.015


def test_generation_engine_chat(model):
    """The host wrapper: tokenize, left-pad to a bucket, decode."""
    from align_anything_tpu_torch.generation import GenerationEngine

    _, tparams, _, tcfg = model

    class Tokenizer:                     # one token per character
        pad_token_id, eos_token_id = 0, 1

        def __call__(self, text, add_special_tokens=True):
            return {'input_ids': [3 + ord(ch) % 100 for ch in text]}

        def decode(self, ids, skip_special_tokens=True):
            return ' '.join(str(i) for i in ids)

    eng = GenerationEngine(tcfg, Tokenizer(), prompt_buckets=(8,),
                           device='cpu')
    gen = GenerationConfig(max_new_tokens=5, greedy=True, eos_token_id=-1)
    texts = eng.chat(tparams, ['hello', 'hi'], gen)
    ids, mask = eng._pad_prompts([[3 + ord(c) % 100 for c in t]
                                  for t in ('hello', 'hi')])
    assert ids.shape == (2, 8) and mask[1].tolist() == [0] * 6 + [1, 1]
    ref = generate(tparams, tcfg, gen, torch.from_numpy(ids),
                   torch.from_numpy(mask))['completions']
    assert texts == [' '.join(str(i) for i in row if i != 0)
                     for row in ref.tolist()]
