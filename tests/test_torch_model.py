"""The PyTorch port's norms, rope and decoder forward against the JAX
package, on the same weights (``align_anything_tpu_torch/models/bridge.py``)
and inputs made from a seed with numpy.

Everything runs in float32 on the CPU, where the port's int4 wrapper runs
its kernel's plain version and the JAX one its Pallas kernel in interpret
mode.  Tolerances: 1e-6 for the elementwise ops (float32 rounding of
identical formulas); for the decoder's logits 1e-4 x max|logit| with fp
weights (the same math summed in another order over two layers) and 1e-2 x
max|logit| with int4-COMPUTE weights: the int4 kernel rounds its input
activations to bf16, so a last-bit float32 difference upstream can move one
activation by a whole bf16 step (2^-8 relative), which reaches the logits
at about 1e-3 relative.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.models import transformer as tt  # noqa: E402
from align_anything_tpu_torch.generation import GenerationEngine  # noqa: E402
from align_anything_tpu_torch.models import bridge  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.config import tiny_config  # noqa: E402
from align_anything_tpu_torch.ops import norms as tn  # noqa: E402
from align_anything_tpu_torch.ops import rope as tr  # noqa: E402

from test_torch_int4_matmul import np_tree  # noqa: E402

LOGIT_TOL = {'fp': 1e-4, 'int4': 1e-2}


@pytest.fixture(scope='module')
def jx():
    jax = pytest.importorskip('jax')
    from align_anything_tpu.models import config as jc
    from align_anything_tpu.models import quantization as jq
    from align_anything_tpu.models import transformer as jt
    from align_anything_tpu.ops import norms as jn
    from align_anything_tpu.ops import rope as jr

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, c=jc, q=jq, t=jt,
                                 n=jn, r=jr)


# config variants beyond the int4 serving model: the decoder options the
# port runs (OPT-, Qwen3-, Chameleon- and Gemma-style switches)
VARIANTS = {
    'fp': {},
    'int4': {},
    'opt': dict(positional='learned', norm='layernorm', activation='relu',
                gated_mlp=False, qkv_bias=True, attn_out_bias=True,
                mlp_bias=True, tie_word_embeddings=True,
                learned_pos_offset=2, norm_eps=1e-5),
    'qwen3': dict(qk_norm='rmsnorm'),
    'chameleon': dict(qk_norm='layernorm_ph', qk_norm_eps=1e-5),
    'gemma': dict(activation='gelu', norm_plus_one=True, sandwich_norms=True,
                  embedding_scale=16.0, attn_scale=0.1, qk_norm='rmsnorm',
                  final_logit_softcap=30.0, tie_word_embeddings=True,
                  true_vocab_size=120),
}


def _cfgs(jx, **kw):
    args = dict(vocab_size=128, hidden=256, layers=2, heads=4, kv_heads=2,
                mlp=256)
    jcfg = jx.c.tiny_config(**args).replace(compute_dtype='float32', **kw)
    return jcfg, tiny_config(**args).replace(compute_dtype='float32', **kw)


def _perturb(tree, rng, path=''):
    """Random biases and norm weights (init sets them to 0 and 1)."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, f'{path}/{k}') for k, v in tree.items()}
    if path.endswith('/b') or 'norm' in path:
        return tree + rng.normal(size=tree.shape).astype(np.float32) * 0.1
    return tree


@pytest.fixture(scope='module', params=list(VARIANTS))
def model(request, jx):
    """(JAX params, port params, JAX config, port config, logit tolerance)
    of the tiny model: fp, int4-COMPUTE with fused qkv / gate_up, or an fp
    config variant with random biases and norm weights."""
    jcfg, tcfg = _cfgs(jx, **VARIANTS[request.param])
    params = jx.t.init_params(jcfg, jx.jax.random.PRNGKey(0))
    if request.param == 'int4':
        params = jx.q.quantize_decoder_int4(params, compute=True, fuse=True)
    elif request.param != 'fp':
        params = jx.jax.tree.map(
            jx.jnp.asarray,
            _perturb(np_tree(params), np.random.default_rng(9)))
    return (params, from_jax_tree(np_tree(params), device='cpu'), jcfg, tcfg,
            LOGIT_TOL.get(request.param, LOGIT_TOL['fp']))


def _close(got, ref, tol):
    got = got.detach().float().numpy() if hasattr(got, 'detach') else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * max(np.max(np.abs(ref)), 1.0), err


def test_rms_and_layer_norm_match_jax(jx):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    X, W, B = (torch.from_numpy(a) for a in (x, w, b))
    _close(tn.rms_norm(X, W, eps=1e-6), jx.n.rms_norm(x, w, eps=1e-6), 1e-6)
    _close(tn.layer_norm(X, W, B, eps=1e-5),
           jx.n.layer_norm(x, w, b, eps=1e-5), 1e-6)


@pytest.mark.parametrize('llama3', [None, (8.0, 1.0, 4.0, 64)])
def test_rope_table_and_apply_match_jax(jx, llama3):
    sin, cos = tr.rope_table(256, 64, theta=500000.0, llama3=llama3,
                             device='cpu')
    jsin, jcos = jx.r.rope_table(256, 64, theta=500000.0, llama3=llama3)
    _close(sin, jsin, 1e-6)
    _close(cos, jcos, 1e-6)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 256, size=(2, 7))
    got = tr.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), sin, cos)
    _close(got, jx.r.apply_rope(x, pos, jsin, jcos), 1e-6)


def test_forward_no_cache_matches_jax(jx, model):
    jparams, tparams, jcfg, tcfg, tol = model
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 128, size=(2, 9))
    mask = np.ones_like(ids)
    mask[1, :3] = 0                       # left padding
    ref = jx.t.forward(jparams, jcfg, ids, attention_mask=mask).logits
    got = tt.forward(tparams, tcfg, torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask)).logits
    # the left-pad queries see no key: the port's attention (the flash
    # kernel's semantics) gives them zeros, JAX's xla_attention the mean of
    # v, by design; they are compared on the real rows only
    real = mask.astype(bool)
    _close(got[torch.from_numpy(real)], np.asarray(ref)[real], tol)


def test_prefill_and_decode_match_jax(jx, model):
    """Prefill with a cache at offset 0, then 4 one-token decode steps at
    an offset, as the batch engine drives them."""
    jparams, tparams, jcfg, tcfg, tol = model
    rng = np.random.default_rng(3)
    b, p, steps, total = 2, 6, 4, 16
    ids = rng.integers(3, 128, size=(b, p))
    mask = np.zeros((b, total), np.int64)
    mask[:, :p] = 1
    mask[0, :2] = 0                       # left padding
    pos = np.clip(np.cumsum(mask[:, :p], -1) - 1, 0, None)

    jcache = jx.t.init_cache(jcfg, b, total, dtype=jx.jnp.float32)
    jout = jx.t.forward(jparams, jcfg, ids, attention_mask=mask,
                        positions=pos, cache=jcache, cache_offset=0)
    tcache = tt.init_cache(tcfg, b, total, dtype=torch.float32,
                           device='cpu')
    tout = tt.forward(tparams, tcfg, torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask),
                      positions=torch.from_numpy(pos), cache=tcache,
                      cache_offset=0)
    _close(tout.logits, jout.logits, tol)

    jcache = jout.cache
    lens = mask[:, :p].sum(-1)
    for t in range(steps):
        tok = rng.integers(3, 128, size=(b, 1))
        mask[:, p + t] = 1
        step_pos = (lens + t)[:, None]
        jout = jx.t.forward(jparams, jcfg, tok, attention_mask=mask,
                            positions=step_pos, cache=jcache,
                            cache_offset=p + t)
        jcache = jout.cache
        tout = tt.forward(tparams, tcfg, torch.from_numpy(tok),
                          attention_mask=torch.from_numpy(mask),
                          positions=torch.from_numpy(step_pos), cache=tcache,
                          cache_offset=p + t)
        _close(tout.logits, jout.logits, tol)


def test_per_row_decode_offsets_match_uniform(jx, model):
    """Decode at per-row offsets (the continuous engine's per-slot
    lengths) equals decoding each row alone at its own offset."""
    _, tparams, _, tcfg, tol = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 128, size=n).tolist() for n in (5, 2)]
    total = 12
    cache = tt.init_cache(tcfg, 2, total, dtype=torch.float32,
                          device='cpu')
    singles = []
    for row, ids in enumerate(prompts):
        ids_t = torch.tensor([ids])
        pos_t = torch.arange(len(ids))[None]
        one = tt.init_cache(tcfg, 1, total, dtype=torch.float32,
                            device='cpu')
        tt.forward(tparams, tcfg, ids_t, positions=pos_t, cache=one,
                   cache_offset=0)
        singles.append(one)
        cache.k[:, row] = one.k[:, 0]
        cache.v[:, row] = one.v[:, 0]
    offs = torch.tensor([len(p) for p in prompts])
    tok = torch.tensor([[7], [9]])
    got = tt.forward(tparams, tcfg, tok, positions=offs[:, None], cache=cache,
                     cache_offset=offs).logits
    for row in range(2):
        ref = tt.forward(tparams, tcfg, tok[row:row + 1],
                         positions=offs[row:row + 1, None],
                         cache=singles[row],
                         cache_offset=int(offs[row])).logits
        _close(got[row:row + 1], ref.numpy(), tol)


@pytest.mark.parametrize('option', [
    dict(num_experts=4), dict(pp_stages=2), dict(remat='no_such_policy'),
    dict(mrope_section=(8, 12, 12)), dict(num_experts=8, moe_impl='sparse'),
])
def test_unported_options_raise(option):
    cfg = tiny_config().replace(**option)
    with pytest.raises(NotImplementedError):
        tt.init_params(cfg, torch.Generator().manual_seed(0), device='cpu')


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_init_params_tree_matches_jax(jx, variant):
    jcfg, tcfg = _cfgs(jx, **VARIANTS[variant])
    ref = np_tree(jx.t.init_params(jcfg, jx.jax.random.PRNGKey(0)))
    got = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                         device='cpu')

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)
    assert shapes(got) == shapes(ref)


def test_bridge_keeps_bf16_bits(jx):
    a = jx.jnp.asarray(np.random.default_rng(6).normal(size=(3, 5)),
                       jx.jnp.bfloat16)
    t = from_jax_tree({'w': np.asarray(a)}, device='cpu')['w']
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(),
        np.asarray(a).view(np.int16))


ENTRY_POINTS = {
    'init_cache': lambda: tt.init_cache(tiny_config(), 1, 8).k,
    'init_params': lambda: tt.init_params(tiny_config(), torch.Generator(
        'cuda' if torch.cuda.is_available() else 'cpu'))['embedding'],
    'rope_table': lambda: tr.rope_table(8, 16)[0],
    'tensor_from_numpy': lambda: bridge.tensor_from_numpy(np.zeros(3)),
    'from_jax_tree': lambda: bridge.from_jax_tree({'w': np.zeros(3)})['w'],
    'trainable_from_jax_tree': lambda: bridge.trainable_from_jax_tree(
        {'w': np.zeros(3)})[0]['w'],
    'GenerationEngine': lambda: torch.zeros(
        1, device=GenerationEngine(tiny_config(), None).device),
}


@pytest.mark.parametrize('name', list(ENTRY_POINTS))
def test_entry_points_run_on_the_card_by_default(name):
    """With no device given an entry point runs on the first CUDA device,
    and without one it raises and says to pass device='cpu': there is no
    quiet CPU default."""
    if torch.cuda.is_available():
        assert ENTRY_POINTS[name]().device == torch.device('cuda', 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ENTRY_POINTS[name]()
