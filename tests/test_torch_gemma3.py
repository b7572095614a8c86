"""Gemma3's interleaved sliding-window attention in the port against the
JAX package, on the CPU in fp32.

The model is the Gemma3-class config of ``tests/test_continuous_batching.py``
(window 6, layer flags (1, 0): a sliding layer, then a full one; the local
and global rope tables; sandwich norms, embedding scale, attention scale),
and that config with the rest of Gemma3's switches (q/k RMSNorm, (1 + w)
norms, tanh GELU, tied embeddings).  Sequences are at least three windows
long.  Weights are JAX's, crossed through ``models/bridge.py`` with random
norm weights.  JAX runs its masked path of ``windowed_causal_attention``
(its splash kernels run only on a TPU); the port runs the kernel's plain
version (``ops/flash_attention.py``), as it does on any CPU tensor.

Tolerances: 1e-5 of the largest value for logits, gradients, losses and
metrics (fp32 math summed in another order); greedy tokens and configs
exactly.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.generation import (  # noqa: E402
    ContinuousBatchingEngine,
    GenerationConfig,
    generate,
)
from align_anything_tpu_torch.models import config as tconfig  # noqa: E402
from align_anything_tpu_torch.models import hf_loader as th  # noqa: E402
from align_anything_tpu_torch.models import transformer as tt  # noqa: E402
from align_anything_tpu_torch.models.bridge import (  # noqa: E402
    from_jax_tree,
    trainable_from_jax_tree,
)
from align_anything_tpu_torch.ops import attention as ta  # noqa: E402
from align_anything_tpu_torch.trainers.optimizer import (  # noqa: E402
    make_optimizer,
    param_leaves,
)
from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: E402
    DPOStep,
)

from test_torch_int4_matmul import np_tree  # noqa: E402
from test_torch_model import _perturb  # noqa: E402

TOL = 1e-5
WINDOW = 6
ARGS = dict(vocab_size=128, hidden=32, layers=2, heads=4, kv_heads=2,
            mlp=64)
# tests/test_continuous_batching.py:107's Gemma3-class switches
CLASS = dict(compute_dtype='float32', sandwich_norms=True,
             embedding_scale=32.0 ** 0.5, attn_scale=0.17,
             sliding_window=WINDOW, layer_is_sliding=(1, 0),
             rope_local_theta=10_000.0, rope_theta=1_000_000.0)
VARIANTS = {
    'class': {},
    'gemma3': dict(qk_norm='rmsnorm', norm_plus_one=True, activation='gelu',
                   tie_word_embeddings=True),
}
SEQ = 3 * WINDOW + 6
PROMPTS = [list(range(5, 5 + 3 * WINDOW)),
           list(range(30, 30 + 3 * WINDOW + 3)),
           list(range(60, 60 + 3 * WINDOW + 6))]
GREEDY = dict(max_new_tokens=14, greedy=True, eos_token_id=-1)
# google/gemma-3-1b-pt's published config.json
GEMMA3_1B = {
    'architectures': ['Gemma3ForCausalLM'], 'attention_bias': False,
    'attention_dropout': 0.0, 'attn_logit_softcapping': None,
    'bos_token_id': 2, 'cache_implementation': 'hybrid', 'eos_token_id': 1,
    'final_logit_softcapping': None, 'head_dim': 256,
    'hidden_activation': 'gelu_pytorch_tanh', 'hidden_size': 1152,
    'initializer_range': 0.02, 'intermediate_size': 6912,
    'max_position_embeddings': 32768, 'model_type': 'gemma3_text',
    'num_attention_heads': 4, 'num_hidden_layers': 26,
    'num_key_value_heads': 1, 'pad_token_id': 0,
    'query_pre_attn_scalar': 256, 'rms_norm_eps': 1e-06,
    'rope_local_base_freq': 10000, 'rope_scaling': None,
    'rope_theta': 1000000, 'sliding_window': 512,
    'sliding_window_pattern': 6, 'torch_dtype': 'bfloat16',
    'use_cache': True, 'vocab_size': 262144}


@pytest.fixture(scope='module')
def jx():
    jax = pytest.importorskip('jax')
    import optax

    from align_anything_tpu.generation import continuous as jcont
    from align_anything_tpu.generation import engine as jeng
    from align_anything_tpu.losses import dpo_loss
    from align_anything_tpu.models import config as jc
    from align_anything_tpu.models import hf_loader as jh
    from align_anything_tpu.models import transformer as jt
    from align_anything_tpu.ops import attention as ja
    from align_anything_tpu.ops.logprobs import token_logprobs
    from align_anything_tpu.trainers import optimizer as jopt

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, optax=optax, cont=jcont, eng=jeng, c=jc,
        h=jh, t=jt, a=ja, dpo_loss=dpo_loss, token_logprobs=token_logprobs,
        opt=jopt)


def _cfgs(jx, variant):
    kw = {**CLASS, **VARIANTS[variant]}
    return (jx.c.tiny_config(**ARGS).replace(**kw),
            tconfig.tiny_config(**ARGS).replace(**kw))


@pytest.fixture(scope='module', params=list(VARIANTS))
def model(request, jx):
    """(JAX params, their numpy tree, JAX config, port config)."""
    jcfg, tcfg = _cfgs(jx, request.param)
    tree = _perturb(np_tree(jx.t.init_params(jcfg, jx.jax.random.PRNGKey(7))),
                    np.random.default_rng(3))
    return jx.jax.tree.map(jx.jnp.asarray, tree), tree, jcfg, tcfg


def _right_padded(seed=0, rows=4):
    """Rows of SEQ tokens; every other row ends 2-5 tokens early."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, ARGS['vocab_size'], size=(rows, SEQ))
    mask = np.ones((rows, SEQ), np.int32)
    for r in range(1, rows, 2):
        mask[r, SEQ - int(rng.integers(2, 6)):] = 0
    return ids, mask


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if hasattr(got, 'detach') else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(float(np.max(np.abs(want))), 1.0), err


def test_check_supported_takes_gemma3():
    cfg = tconfig.tiny_config(**ARGS).replace(**CLASS)
    tt.check_supported(cfg)
    for remat in tt.REMAT_POLICIES:
        tt.check_supported(cfg.replace(remat=remat))
    assert len(tt.REMAT_POLICIES) == 10
    for option in (dict(num_experts=4), dict(pp_stages=2),
                   dict(mrope_section=(2, 3, 3))):
        with pytest.raises(NotImplementedError):
            tt.check_supported(cfg.replace(**option))


@pytest.mark.parametrize('flag', [1, 0])
@pytest.mark.parametrize('impl', ['auto', 'xla'])
def test_windowed_attention_matches_jax(jx, flag, impl):
    """The port's ``windowed_causal_attention`` (the kernel's plain
    version, or with 'xla' JAX's masked fallback) against JAX's masked
    path, forward and gradients, with key padding."""
    rng = np.random.default_rng(flag)
    b, l, h, kh, d = 2, 4 * WINDOW, 4, 2, 16
    q, k, v, dout = (rng.normal(size=s).astype(np.float32) for s in (
        (b, l, h, d), (b, l, kh, d), (b, l, kh, d), (b, l, h, d)))
    mask = np.ones((b, l), np.int32)
    mask[1, l - 5:] = 0

    def jfn(q_, k_, v_):
        out = jx.a.windowed_causal_attention(
            q_, k_, v_, jx.jnp.asarray(mask), WINDOW, jx.jnp.int32(flag),
            impl=impl)
        return (out * dout).sum(), out

    (_, jout), jgrads = jx.jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                              has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ta.windowed_causal_attention(tq, tk, tv, torch.from_numpy(mask),
                                       WINDOW, flag, impl=impl)
    (out * torch.from_numpy(dout)).sum().backward()
    _close(out, jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want)


def test_forward_matches_jax(jx, model):
    jparams, tree, jcfg, tcfg = model
    ids, mask = _right_padded()
    want = np.asarray(jx.t.forward(jparams, jcfg, jx.jnp.asarray(ids),
                                   attention_mask=jx.jnp.asarray(mask)).logits)
    with torch.no_grad():
        got = tt.forward(from_jax_tree(tree, device='cpu'), tcfg,
                         torch.from_numpy(ids),
                         attention_mask=torch.from_numpy(mask)).logits
    keep = mask.astype(bool)
    _close(got.numpy()[keep], want[keep])
    # the window matters: full attention everywhere gives other logits
    with torch.no_grad():
        full = tt.forward(from_jax_tree(tree, device='cpu'),
                          tcfg.replace(layer_is_sliding=(0, 0)),
                          torch.from_numpy(ids),
                          attention_mask=torch.from_numpy(mask)).logits
    assert float((full - got).abs().max()) > 1e-3


def test_gradients_match_jax(jx, model):
    jparams, tree, jcfg, tcfg = model
    ids, mask = _right_padded(seed=1)
    weight = np.random.default_rng(2).normal(
        size=(*ids.shape, ARGS['vocab_size'])).astype(np.float32) \
        * mask[..., None]

    def jloss(p):
        logits = jx.t.forward(p, jcfg, jx.jnp.asarray(ids),
                              attention_mask=jx.jnp.asarray(mask)).logits
        return (logits * weight).sum()

    jgrads = np_tree(jx.jax.grad(jloss)(jparams))
    params, _ = trainable_from_jax_tree(tree, device='cpu')
    logits = tt.forward(params, tcfg, torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask)).logits
    (logits * torch.from_numpy(weight)).sum().backward()
    got, want = _flat(params), _flat(jgrads)
    assert set(got) == set(want)
    for path, leaf in got.items():
        _close(leaf.grad, want[path])


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items()
                for p, leaf in _flat(v, f'{prefix}/{k}').items()}
    return {prefix: tree}


def test_dpo_step_matches_jax(jx, model):
    """Three DPO steps: loss, metrics and grad norm per step, and the
    params after them."""
    jparams, tree, jcfg, tcfg = model
    ids, mask = _right_padded(seed=4)
    rmask = ((np.arange(SEQ - 1)[None] >= SEQ // 2)
             & (mask[:, 1:] == 1)).astype(np.float32)
    opt = dict(lr_scheduler_type='cosine', total_steps=3,
               lr_warmup_ratio=0.34, weight_decay=0.01, max_grad_norm=1.0)
    tx, schedule = jx.opt.make_optimizer(1e-4, **opt)

    def loss_fn(p):
        logp = jx.token_logprobs(p, jcfg, jx.jnp.asarray(ids),
                                 attention_mask=jx.jnp.asarray(mask))
        ref = jx.jax.lax.stop_gradient(jx.token_logprobs(
            jparams, jcfg, jx.jnp.asarray(ids),
            attention_mask=jx.jnp.asarray(mask)))
        out = jx.dpo_loss(logp, ref, jx.jnp.asarray(ids),
                          jx.jnp.asarray(rmask), scale_coeff=0.1)
        return out['loss'], out['reward_margin'].mean()

    p, opt_state, want = jparams, tx.init(jparams), []
    for _ in range(3):
        (loss, margin), grads = jx.jax.value_and_grad(loss_fn,
                                                      has_aux=True)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        p = jx.optax.apply_updates(p, updates)
        want.append((float(loss), float(margin),
                     float(jx.optax.global_norm(grads))))

    params, ref = trainable_from_jax_tree(tree, device='cpu')
    trainer = DPOStep(tcfg, *make_optimizer(1e-4, **opt), scale_coeff=0.1)
    state = trainer.init_state(params)
    batch = {'input_ids': torch.from_numpy(ids),
             'attention_mask': torch.from_numpy(mask),
             'response_mask': torch.from_numpy(rmask)}
    for step in range(3):
        state, m = trainer.step(state, ref, batch)
        got = (float(m['train/loss']), float(m['train/reward_margin']),
               float(m['train/grad_norm']))
        np.testing.assert_allclose(got, want[step], rtol=TOL, atol=TOL)
    assert abs(want[0][0] - np.log(2)) < 1e-6
    final = _flat(np_tree(p))
    for path, leaf in _flat(state.params).items():
        _close(leaf, final[path])


def _left_padded(prompts):
    p = max(len(x) for x in prompts)
    ids = np.zeros((len(prompts), p), np.int32)
    mask = np.zeros_like(ids)
    for i, x in enumerate(prompts):
        ids[i, p - len(x):] = x
        mask[i, p - len(x):] = 1
    return ids, mask


def test_generate_matches_jax(jx, model):
    """The batch engine: a left-padded prefill longer than three windows,
    then 14 decode steps whose window slides over the prompt."""
    jparams, tree, jcfg, tcfg = model
    ids, mask = _left_padded(PROMPTS)
    want = np.asarray(jx.eng.generate(
        jparams, jcfg, jx.eng.GenerationConfig(**GREEDY),
        jx.jnp.asarray(ids), jx.jnp.asarray(mask),
        jx.jax.random.PRNGKey(1))['completions'])
    got = generate(from_jax_tree(tree, device='cpu'), tcfg,
                   GenerationConfig(**GREEDY), torch.from_numpy(ids).long(),
                   torch.from_numpy(mask).long())['completions']
    assert got.tolist() == want.tolist()
    # the window matters: decoding with full attention gives other tokens
    full = generate(from_jax_tree(tree, device='cpu'),
                    tcfg.replace(layer_is_sliding=(0, 0)),
                    GenerationConfig(**GREEDY), torch.from_numpy(ids).long(),
                    torch.from_numpy(mask).long())['completions']
    assert full.tolist() != got.tolist()


def test_continuous_engine_matches_jax(jx, model):
    """The continuous engine (two slots, so the third request enters mid-
    run) against JAX's dense continuous engine and the port's batch
    engine."""
    jparams, tree, jcfg, tcfg = model
    jeng = jx.cont.ContinuousBatchingEngine(jcfg, num_slots=2, max_len=64,
                                            prompt_buckets=(32,),
                                            cache_mode='dense')
    want = jeng.generate(jparams, PROMPTS, jx.eng.GenerationConfig(**GREEDY),
                         jx.jax.random.PRNGKey(2), chunk_steps=4)
    params = from_jax_tree(tree, device='cpu')
    eng = ContinuousBatchingEngine(tcfg, num_slots=2, max_len=64,
                                   prompt_buckets=(32,))
    got = eng.generate(params, PROMPTS, GenerationConfig(**GREEDY),
                       chunk_steps=4)
    assert got == want
    assert [len(o) for o in got] == [GREEDY['max_new_tokens']] * 3
    assert eng.stats['admit_step'][2] > 0
    ids, mask = _left_padded(PROMPTS)
    batch = generate(params, tcfg, GenerationConfig(**GREEDY),
                     torch.from_numpy(ids).long(),
                     torch.from_numpy(mask).long())['completions']
    assert batch.tolist() == got


def test_config_from_hf_matches_jax(jx, tmp_path):
    """Gemma-3-1B's published config.json maps as in JAX and runs."""
    with open(tmp_path / 'config.json', 'w') as f:
        json.dump(GEMMA3_1B, f)
    got = tconfig.config_from_hf(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jx.c.config_from_hf(str(tmp_path)))
    assert got.layer_is_sliding == tuple(
        0 if (i + 1) % 6 == 0 else 1 for i in range(26))
    assert (got.sliding_window, got.head_dim, got.num_kv_heads,
            got.rope_local_theta) == (512, 256, 1, 10000)


@pytest.fixture(scope='module')
def hf_gemma3(tmp_path_factory):
    """A tiny Gemma3 checkpoint written by ``transformers``: a sliding
    layer, then a full one, window 8."""
    transformers = pytest.importorskip('transformers')
    torch.manual_seed(0)
    cfg = transformers.Gemma3TextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=64, sliding_window=8,
        layer_types=['sliding_attention', 'full_attention'])
    d = tmp_path_factory.mktemp('gemma3')
    transformers.Gemma3ForCausalLM(cfg).eval().save_pretrained(
        d, safe_serialization=True)
    return str(d)


def test_loader_reads_gemma3_as_jax(jx, hf_gemma3):
    params, cfg = th.load_params(hf_gemma3, device='cpu')
    jparams, jcfg = jx.h.load_params(hf_gemma3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got, want = _flat(params), _flat(np_tree(jparams))
    assert set(got) == set(want)
    for path in got:
        np.testing.assert_array_equal(got[path].numpy(), want[path],
                                      err_msg=path)
    cfg = cfg.replace(compute_dtype='float32')
    ids = np.random.default_rng(5).integers(3, 99, size=(2, 30))
    with torch.no_grad():
        logits = tt.forward(params, cfg, torch.from_numpy(ids)).logits
    _close(logits, jx.t.forward(jparams, jcfg.replace(compute_dtype='float32'),
                                jx.jnp.asarray(ids)).logits)


def test_r21_both_writers_export_gemma3_alike(jx, hf_gemma3, tmp_path):
    """ROADMAP R21: JAX's writer has no Gemma3 branch, and the port's
    writes what it writes: the same config.json (Qwen3's architecture, SiLU,
    no window, no local rope theta) and the same tensor names (the MLP's
    pre-norm as ``post_attention_layernorm``, the sandwich norms' others
    dropped).  The export reloads as another model."""
    params, cfg = th.load_params(hf_gemma3, device='cpu')
    jparams, _ = jx.h.load_params(hf_gemma3)
    th.save_params(str(tmp_path / 'port'), params, cfg)
    jx.h.save_params(str(tmp_path / 'jax'), jparams, cfg)
    configs = []
    for name in ('port', 'jax'):
        with open(tmp_path / name / 'config.json') as f:
            configs.append(json.load(f))
    assert configs[0] == configs[1]
    assert configs[0]['architectures'] == ['Qwen3ForCausalLM']
    assert configs[0]['hidden_act'] == 'silu'
    assert 'sliding_window' not in configs[0]
    names = [set(th.read_safetensors(
        os.path.join(tmp_path, name, 'model.safetensors')))
        for name in ('port', 'jax')]
    assert names[0] == names[1]
    assert not any('feedforward_layernorm' in n for n in names[0])
    back = tconfig.config_from_hf(str(tmp_path / 'port'))
    assert back.sliding_window is None and not back.sandwich_norms
