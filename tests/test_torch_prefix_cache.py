"""The prefix cache: the decoder's multi-token cache write at a static
offset, and the continuous engine's ``register_prefix`` in dense and paged
mode, against the JAX package on the models of tests/test_torch_paged.py,
float32 compute on the CPU.  Tokens must be equal; logits and caches agree
within 1e-5 of their largest magnitude."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.generation import (  # noqa: E402
    ContinuousBatchingEngine,
    GenerationConfig,
)
from align_anything_tpu_torch.models import transformer  # noqa: E402

from test_torch_paged import (  # noqa: E402,F401
    gemma3_model,
    jx,
    model,
    one_thread,
    run_port,
)

TOL = 1e-5
PS = 8
GEN = dict(max_new_tokens=10, greedy=True, eos_token_id=-1)
KW = dict(num_slots=2, page_size=PS, max_len=64, prompt_buckets=(8, 16, 32))


def close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


def prompts_with(prefix):
    return [prefix + [5, 6, 7], prefix + [9, 10, 11, 12, 13], [20, 21, 22],
            prefix + [33]]


def test_offset_write_matches_jax(jx):
    """Prefill [0, 16), then write 8 tokens at the static offset 16 (the
    second row right-padded after 5), attending over the whole cache in
    slot space: logits and both caches against JAX's, on the Gemma3-class
    model (a sliding and a full layer).  The int4 model's logits differ
    from JAX's by the kernels' bf16 operands (about 1e-3,
    tests/test_torch_model.py); its tokens are held below."""
    jparams, tparams, jcfg, tcfg = gemma3_model(jx)
    rng = np.random.default_rng(0)
    b, off, n, s = 2, 16, 8, 32
    ids = rng.integers(2, 120, size=(b, off + n))
    mask = np.zeros((b, s), np.int64)
    mask[:, :off + n] = 1
    mask[1, off + 5:] = 0
    pos = np.cumsum(mask, -1)[:, :off + n] - 1
    jcache = jx.t.init_cache(jcfg, b, s, dtype=jx.jnp.float32)
    jout = jx.t.forward(jparams, jcfg, jx.jnp.asarray(ids[:, :off]),
                        attention_mask=jx.jnp.asarray(mask[:, :off]),
                        positions=jx.jnp.asarray(pos[:, :off]), cache=jcache,
                        cache_offset=0)
    jout = jx.t.forward(jparams, jcfg, jx.jnp.asarray(ids[:, off:]),
                        attention_mask=jx.jnp.asarray(mask),
                        positions=jx.jnp.asarray(pos[:, off:]),
                        cache=jout.cache, cache_offset=off)
    cache = transformer.init_cache(tcfg, b, s, dtype=torch.float32,
                                   device='cpu')
    t = torch.from_numpy
    transformer.forward(tparams, tcfg, t(ids[:, :off]),
                        attention_mask=t(mask[:, :off]),
                        positions=t(pos[:, :off]), cache=cache, cache_offset=0)
    out = transformer.forward(tparams, tcfg, t(ids[:, off:]),
                              attention_mask=t(mask), positions=t(pos[:, off:]),
                              cache=cache, cache_offset=off)
    close(out.logits[0].numpy(), np.asarray(jout.logits)[0])
    close(out.logits[1, :5].numpy(), np.asarray(jout.logits)[1, :5])
    shape = cache.k.shape
    close(cache.k.numpy(), np.asarray(jout.cache.k).reshape(shape))
    close(cache.v.numpy(), np.asarray(jout.cache.v).reshape(shape))
    with pytest.raises(ValueError, match='past the cache'):
        transformer.forward(tparams, tcfg, t(ids[:, off:]),
                            attention_mask=t(mask), positions=t(pos[:, off:]),
                            cache=cache, cache_offset=s - 4)


@pytest.mark.parametrize('cache_mode', ['dense', 'paged'])
def test_prefix_matches_uncached_and_jax(jx, model, cache_mode):
    """Requests that start with a registered 19-token prefix decode the
    uncached tokens and JAX's prefix-cached tokens; a request without it
    takes the plain path; a second call on the same engine decodes the
    same tokens (the prefix K/V are written into each call's pool)."""
    jparams, tparams, jcfg, tcfg = model
    prefix = np.random.default_rng(8).integers(30, 120, size=2 * PS + 3
                                               ).tolist()
    prompts = prompts_with(prefix)
    kw = dict(KW, cache_mode=cache_mode)
    plain, _ = run_port(tparams, tcfg, prompts, GEN, **kw)
    eng = ContinuousBatchingEngine(tcfg, **kw)
    eng.register_prefix(tparams, prefix)
    # dense: all but one token (no 128-lane pack); paged: whole pages
    assert eng._prefix['len'] == (18 if cache_mode == 'dense' else 2 * PS)
    gen = GenerationConfig(**GEN)
    out = eng.generate(tparams, prompts, gen, torch.Generator().manual_seed(4),
                       chunk_steps=4)
    assert out == plain and all(len(o) == 10 for o in out)
    again = eng.generate(tparams, prompts, gen,
                         torch.Generator().manual_seed(5), chunk_steps=4)
    assert again == out

    jeng = jx.cont.ContinuousBatchingEngine(jcfg, **kw)
    jeng.register_prefix(jparams, prefix)
    ref = jeng.generate(jparams, prompts, jx.eng.GenerationConfig(**GEN),
                        jx.jax.random.PRNGKey(4), chunk_steps=4,
                        overlap=False)
    assert out == ref
    if cache_mode == 'paged':
        assert eng._prefix['len'] == jeng._prefix['len']
        assert eng._prefix['pages'] == jeng._prefix['pages'] == [1, 2]
        assert eng.stats['admit_step'] == jeng.stats['admit_step']
        assert eng.stats['finish_step'] == jeng.stats['finish_step']


def test_prefix_refusals_match_jax(jx, model):
    """A prefix too short to leave a tail raises in both packages, as does
    a paged prefix that would fill the pool."""
    jparams, tparams, jcfg, tcfg = model
    for mode, prefix in (('dense', [7]), ('paged', list(range(10, 10 + PS)))):
        for eng, params in ((ContinuousBatchingEngine(
                tcfg, **dict(KW, cache_mode=mode)), tparams),
                (jx.cont.ContinuousBatchingEngine(
                    jcfg, **dict(KW, cache_mode=mode)), jparams)):
            with pytest.raises(ValueError, match='too short'):
                eng.register_prefix(params, prefix)
    long = list(range(10, 10 + 4 * PS + 1))       # 4 pages
    for eng, params in (
            (ContinuousBatchingEngine(tcfg, **dict(
                KW, num_pages=6, cache_mode='paged')), tparams),
            (jx.cont.ContinuousBatchingEngine(jcfg, **dict(
                KW, num_pages=6, cache_mode='paged')), jparams)):
        with pytest.raises(ValueError, match='whole page pool'):
            eng.register_prefix(params, long)
