"""The port's paged continuous engine against the JAX package's, on the
int4-COMPUTE tiny model of tests/test_torch_generation.py and on the
Gemma3-class tiny model of tests/test_continuous_batching.py (sliding and
full layers, two rope tables, sandwich norms, embedding and attention
scales), float32 compute on the CPU.

Greedy tokens must be equal, and so must each request's admission and
finish steps: the port dispatches as JAX's ``overlap=False`` does.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.generation import (  # noqa: E402
    ContinuousBatchingEngine,
    GenerationConfig,
)
from align_anything_tpu_torch.generation import continuous  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.config import tiny_config  # noqa: E402

from test_torch_int4_matmul import np_tree  # noqa: E402

PROMPTS = [[5, 6, 7], [9, 10, 11, 12, 13, 14], [20], [33, 34, 35, 36]]


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: the tiny models' ops are far too small to
    split, and the test workers run side by side on the box's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def int4_model(jx):
    """test_torch_generation.py's int4-COMPUTE tiny model."""
    args = dict(vocab_size=128, hidden=256, layers=2, heads=4, kv_heads=2,
                mlp=256)
    jcfg = jx.c.tiny_config(**args).replace(compute_dtype='float32',
                                            attention_impl='xla')
    params = jx.q.quantize_decoder_int4(
        jx.t.init_params(jcfg, jx.jax.random.PRNGKey(3)), compute=True)
    tcfg = tiny_config(**args).replace(compute_dtype='float32',
                                       attention_impl='xla')
    return params, from_jax_tree(np_tree(params), device='cpu'), jcfg, tcfg


GEMMA3 = dict(compute_dtype='float32', attention_impl='xla',
              sandwich_norms=True, embedding_scale=32.0 ** 0.5,
              attn_scale=0.17, sliding_window=6, layer_is_sliding=(1, 0),
              rope_local_theta=10_000.0, rope_theta=1_000_000.0)


def gemma3_model(jx):
    """test_continuous_batching.py's Gemma3-class tiny model (window 6)."""
    args = dict(vocab_size=128, hidden=32, layers=2, heads=4, kv_heads=2,
                mlp=64)
    jcfg = jx.c.tiny_config(**args).replace(**GEMMA3)
    params = jx.t.init_params(jcfg, jx.jax.random.PRNGKey(7))
    tcfg = tiny_config(**args).replace(**GEMMA3)
    return params, from_jax_tree(np_tree(params), device='cpu'), jcfg, tcfg


@pytest.fixture(scope='module', params=['int4', 'gemma3'])
def model(request, jx):
    return {'int4': int4_model, 'gemma3': gemma3_model}[request.param](jx)


def run_jax(jx, jparams, jcfg, requests, gen_kw, **eng_kw):
    eng = jx.cont.ContinuousBatchingEngine(jcfg, **eng_kw)
    out = eng.generate(jparams, requests, jx.eng.GenerationConfig(**gen_kw),
                       jx.jax.random.PRNGKey(2), chunk_steps=4,
                       overlap=False)
    return out, eng.stats


def run_port(tparams, tcfg, requests, gen_kw, **eng_kw):
    eng = ContinuousBatchingEngine(tcfg, **eng_kw)
    out = eng.generate(tparams, requests, GenerationConfig(**gen_kw),
                       torch.Generator().manual_seed(2), chunk_steps=4)
    return out, eng.stats


def same_schedule(got: dict, want: dict) -> bool:
    return all(got[k] == want[k]
               for k in ('admit_step', 'finish_step', 'total_steps'))


@pytest.mark.parametrize('max_len,new', [(64, 12), (32, 40)])
def test_paged_matches_jax_and_dense(jx, model, max_len, new):
    """Paged against JAX's paged engine and the port's dense engine; at
    max_len 32 every request runs into max_len, past the last page of its
    table (the page index JAX clamps without a word)."""
    jparams, tparams, jcfg, tcfg = model
    gen = dict(max_new_tokens=new, greedy=True, eos_token_id=-1)
    kw = dict(num_slots=2, page_size=8, max_len=max_len,
              prompt_buckets=(8, 16))
    ref, ref_stats = run_jax(jx, jparams, jcfg, PROMPTS, gen,
                             cache_mode='paged', **kw)
    out, stats = run_port(tparams, tcfg, PROMPTS, gen, cache_mode='paged',
                          **kw)
    assert out == ref
    assert same_schedule(stats, ref_stats)
    dense, dense_stats = run_port(tparams, tcfg, PROMPTS, gen, **kw)
    assert dense == out
    assert same_schedule(dense_stats, stats)
    if max_len == 32:
        # each stops at max_len, or earlier at a greedy pad token (R5)
        assert all(len(o) + len(p) <= 32 for o, p in zip(out, PROMPTS))
        assert sum(len(o) + len(p) == 32 for o, p in zip(out, PROMPTS)) >= 3
    else:
        assert all(len(o) == new for o in out)


def test_page_pool_reuse_matches_jax(jx, model):
    """A pool of 9 pages (8 free, 3 a request) serves 6 requests two at a
    time: freed pages are reused, and admission waits for them at the
    chunk boundaries JAX waits at."""
    jparams, tparams, jcfg, tcfg = model
    prompts = [[i + 3, i + 4, i + 5] for i in range(6)]
    gen = dict(max_new_tokens=8, greedy=True, eos_token_id=-1)
    kw = dict(num_slots=4, page_size=8, max_len=32, num_pages=9,
              prompt_buckets=(8,), cache_mode='paged')
    ref, ref_stats = run_jax(jx, jparams, jcfg, prompts, gen, **kw)
    out, stats = run_port(tparams, tcfg, prompts, gen, **kw)
    assert out == ref and all(len(o) == 8 for o in out)
    assert same_schedule(stats, ref_stats)
    # never more than two live at once though there are four slots
    steps = range(stats['total_steps'])
    live = max(sum(stats['admit_step'][r] <= s < stats['finish_step'][r]
                   for r in range(6)) for s in steps)
    assert live == 2


def test_paged_helpers_match_jax(jx):
    """The page gather, the token scatter (a finished slot's write goes to
    the sink page; a length one page past the table clamps) and the
    windowed paged attention against JAX's, on the JAX pool's packed rows."""
    rng = np.random.default_rng(0)
    kh, p, ps, d, s, mp, h = 2, 7, 4, 8, 3, 3, 4
    pages = rng.normal(size=(kh, p, ps, d)).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0]], np.int32)
    lengths = np.array([5, 12, 3], np.int32)      # 12 // 4 = 3 = mp
    live = np.array([True, False, True])
    new = rng.normal(size=(s, kh, d)).astype(np.float32)
    jp = jx.jnp.asarray(pages.reshape(kh, p, ps * d))
    want = jx.cont._scatter_token(jp, jx.jnp.asarray(tables),
                                  jx.jnp.asarray(lengths),
                                  jx.jnp.asarray(new), ps,
                                  jx.jnp.asarray(live))
    got = torch.from_numpy(pages.copy())
    t_tables = torch.from_numpy(tables).long()
    t_len = torch.from_numpy(lengths).long()
    continuous._scatter_token(got, t_tables, t_len, torch.from_numpy(new),
                              torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(kh, p, ps, d))
    k = continuous._gather_pages(got, t_tables)
    jk = jx.cont._gather_pages(want, jx.jnp.asarray(tables), ps, d)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    q = rng.normal(size=(s, h, d)).astype(np.float32)
    for window in (None, 2):
        ref = jx.cont._paged_attention(
            jx.jnp.asarray(q), jk, jk, jx.jnp.asarray(lengths + 1),
            window=window, sliding=True if window else None)
        out = continuous._paged_attention(torch.from_numpy(q)[:, None], k, k,
                                          t_len + 1, window)[:, 0]
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_reference_faults_r22_r23(jx):
    """Two faults of JAX's engine that the port copies (ROADMAP §3).  R22:
    a prompt longer than the largest bucket is cut to it without a word,
    so it decodes as its first 8 tokens.  R23: a request whose page need
    exceeds the whole pool is never admitted and blocks the queue behind
    it: the call returns every request empty."""
    jparams, tparams, jcfg, tcfg = gemma3_model(jx)
    gen = dict(max_new_tokens=6, greedy=True, eos_token_id=-1)
    long = list(range(10, 22))
    kw = dict(num_slots=2, page_size=8, max_len=64, prompt_buckets=(8,),
              cache_mode='paged')
    for run, params, cfg in ((run_jax, jparams, jcfg),
                             (run_port, tparams, tcfg)):
        args = (jx,) if run is run_jax else ()
        cut, _ = run(*args, params, cfg, [long, long[:8]], gen, **kw)
        assert cut[0] == cut[1] and len(cut[0]) == 6
        # 1 + ceil(40 / 8) + 1 = 7 pages needed, 3 free
        big = {'input_ids': [5, 6, 7], 'max_new_tokens': 40}
        stuck, _ = run(*args, params, cfg, [big, [8, 9]], gen,
                       **dict(kw, num_pages=4))
        assert stuck == [[], []]
