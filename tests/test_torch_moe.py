"""The port's mixture-of-experts decoder against the JAX package's, on the
CPU at ``tiny-moe``'s widths (hidden 64, 2 layers, 4 experts of 128, top 2)
in float32: the param tree, the forward's logits and aux loss with the
dense and the sparse dispatch, the gradients, top-k ties, the remat
policies, the int8 and int4 trees and the forward over them, the R31
refusal, greedy ids from both engines, one SFT step with
``train/router_aux_loss``, the HF export (R34), the train state's resume,
QLoRA, and the multimodal families over an MoE trunk.

The JAX weights (norms perturbed, so every leaf matters) reach the port
through ``models/bridge.py``; the inputs are seeded numpy arrays.
Tolerances: logits within 1e-4 of max|logit| (the same fp32 math summed
in another order), the aux loss to 1e-5, each gradient leaf within 1e-4 of
its own max, 1e-2 of max|logit| over int4-COMPUTE weights (the int4
kernel's bf16 activations, ``tests/test_torch_model.py``), quantized trees
and exports bit for bit, greedy ids equal, trainer metrics and params to
1e-5 (``tests/test_torch_trainers.py``).
"""

import dataclasses
import json
import math
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('yaml')

from align_anything_tpu_torch.generation import (  # noqa: E402
    ContinuousBatchingEngine,
    GenerationConfig,
    generate,
)
from align_anything_tpu_torch.models import config as tc  # noqa: E402
from align_anything_tpu_torch.models import hf_loader as th  # noqa: E402
from align_anything_tpu_torch.models import quantization as tq  # noqa: E402
from align_anything_tpu_torch.models import transformer as tt  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: E402
    DPOTrainer,
)
from align_anything_tpu_torch.trainers.text_to_text.sft import (  # noqa: E402
    SupervisedTrainer,
)
from align_anything_tpu_torch.utils.tools import tree_map  # noqa: E402

from test_torch_int4_matmul import np_tree  # noqa: E402

LOGIT_TOL = 1e-4
INT4_TOL = 1e-2
AUX_TOL = 1e-5
GRAD_TOL = 1e-4
TRAIN_TOL = 1e-5
IMPLS = ('dense', 'sparse')


@pytest.fixture(scope='module')
def jx():
    jax = pytest.importorskip('jax')
    from align_anything_tpu.models import config as jc
    from align_anything_tpu.models import quantization as jq
    from align_anything_tpu.models import transformer as jt

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, c=jc, q=jq, t=jt)


def _cfgs(jx, **kw):
    """(JAX, port) ``tiny-moe`` configs in float32."""
    j = jx.c.PRESETS['tiny-moe']().replace(compute_dtype='float32', **kw)
    t = tc.PRESETS['tiny-moe']().replace(compute_dtype='float32', **kw)
    return j, t


@pytest.fixture(scope='module')
def tree(jx):
    """``tiny-moe``'s JAX init as numpy, norm weights perturbed."""
    rng = np.random.default_rng(9)
    params = np_tree(_jinit(jx, jx.t, _cfgs(jx)[0], 0))

    def perturb(t, path=''):
        if isinstance(t, dict):
            return {k: perturb(v, f'{path}/{k}') for k, v in t.items()}
        if 'norm' in path:
            return t + rng.normal(size=t.shape).astype(np.float32) * 0.1
        return t

    return perturb(params)


def _inputs(b=2, l=12, seed=0, vocab=512):
    """Seeded ids and a right-padded mask (row 1 three tokens short)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(b, l)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, -3:] = 0
    return ids, mask


def _close(got, want, tol):
    got = got.detach().float().numpy() if hasattr(got, 'detach') else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(float(np.max(np.abs(want))), 1.0), err


def _jinit(jx, module, cfg, seed):
    """``module.init_params(cfg, PRNGKey(seed))`` compiled once."""
    return jx.jax.jit(module.init_params, static_argnums=0)(
        cfg, jx.jax.random.PRNGKey(seed))


def _jforward(jx):
    """JAX's ``forward`` compiled once a config (op-by-op dispatch compiles
    every primitive on its first use, several times slower here)."""
    return jx.jax.jit(jx.t.forward, static_argnums=1)


def _run_both(jx, jparams, impl, ids, mask):
    """JAX's forward and the port's over the same numpy tree."""
    jcfg, tcfg = _cfgs(jx, moe_impl=impl)
    tparams = from_jax_tree(np_tree(jparams), device='cpu')
    want = _jforward(jx)(jx.jax.tree.map(jx.jnp.asarray, jparams), jcfg,
                         jx.jnp.asarray(ids),
                         attention_mask=jx.jnp.asarray(mask))
    got = tt.forward(tparams, tcfg, torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask).long())
    return got, want


# ---------------------------------------------------------------------------
# the tree and the forward
# ---------------------------------------------------------------------------

def test_presets_and_tree_match_jax(jx):
    """Both MoE presets equal JAX's field for field; ``init_params`` builds
    JAX's tree and shapes (router (n, E, X), up / gate (n, X, E, F), down
    (n, X, F, E)); qwen3-moe-30b-a3b holds about 8.10 B parameters."""
    for name in ('tiny-moe', 'qwen3-moe-30b-a3b'):
        assert dataclasses.asdict(tc.PRESETS[name]()) == dataclasses.asdict(
            jx.c.PRESETS[name]())
    jcfg, tcfg = _cfgs(jx)
    want = jx.jax.eval_shape(lambda k: jx.t.init_params(jcfg, k),
                             jx.jax.random.PRNGKey(0))
    got = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                         device='cpu')

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)

    assert shapes(got) == shapes(want)
    lay = got['layers']
    assert lay['router']['w'].shape == (2, 64, 4)
    assert lay['up']['w'].shape == lay['gate']['w'].shape == (2, 4, 64, 128)
    assert lay['down']['w'].shape == (2, 4, 128, 64)
    full = jx.jax.eval_shape(
        lambda k: jx.t.init_params(jx.c.PRESETS['qwen3-moe-30b-a3b'](), k),
        jx.jax.random.PRNGKey(0))
    n = sum(math.prod(a.shape) for a in jx.jax.tree.leaves(full))
    assert round(n / 1e9, 2) == 8.10


@pytest.mark.parametrize('impl', IMPLS)
def test_forward_and_aux_match_jax(jx, tree, impl):
    """Logits and the aux loss (the per-layer switch loss, its mean over
    layers, pads included: R32) of each dispatch; the two dispatches agree
    with each other too."""
    ids, mask = _inputs()
    got, want = _run_both(jx, tree, impl, ids, mask)
    _close(got.logits, want.logits, LOGIT_TOL)
    assert abs(float(got.aux_loss) - float(want.aux_loss)) <= AUX_TOL
    other = 'sparse' if impl == 'dense' else 'dense'
    alt = tt.forward(from_jax_tree(tree, device='cpu'),
                     _cfgs(jx, moe_impl=other)[1], torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask))
    _close(alt.logits, got.logits.detach().numpy(), LOGIT_TOL)
    assert float(alt.aux_loss) == float(got.aux_loss)
    # an unknown moe_impl runs the dense dispatch, as in JAX
    odd = tt.forward(from_jax_tree(tree, device='cpu'),
                     _cfgs(jx, moe_impl='grouped')[1], torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask))
    dense = got if impl == 'dense' else alt
    assert torch.equal(odd.logits, dense.logits)
    # without logits the hidden state and the aux loss still come back
    bare = tt.forward(from_jax_tree(tree, device='cpu'),
                      _cfgs(jx, moe_impl=impl)[1], torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask),
                      need_logits=False)
    assert float(bare.aux_loss) == float(got.aux_loss)
    # a dense model has none
    dense_cfg = tc.tiny_config(vocab_size=64, hidden=16, layers=1, heads=2,
                               kv_heads=1, mlp=32)
    assert tt.forward(tt.init_params(dense_cfg, torch.Generator(),
                                     device='cpu'), dense_cfg,
                      torch.from_numpy(ids) % 64).aux_loss is None


def _loss_j(jx, cfg, ids, mask, probe):
    def loss(p):
        out = jx.t.forward(p, cfg, ids, attention_mask=mask)
        return (out.logits * probe).sum() + 10.0 * out.aux_loss
    return loss


def _probe(ids):
    """The seeded cotangent of the logits."""
    return np.random.default_rng(5).normal(
        size=(ids.shape[0], ids.shape[1], 512)).astype(np.float32)


def _grads(jx, tree, impl, remat='none'):
    """The port's params, each with the gradient of sum(logits * probe) +
    10 * aux."""
    ids, mask = _inputs()
    _, tcfg = _cfgs(jx, moe_impl=impl, remat=remat)
    tparams = tree_map(lambda t: t.requires_grad_(True),
                       from_jax_tree(tree, device='cpu'))
    out = tt.forward(tparams, tcfg, torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask).long())
    ((out.logits * torch.from_numpy(_probe(ids))).sum()
     + 10.0 * out.aux_loss).backward()
    return tparams


def _grad_tree(t):
    if isinstance(t, dict):
        return {k: _grad_tree(v) for k, v in t.items()}
    return t.grad.numpy()


@pytest.fixture(scope='module')
def jax_grads(jx, tree):
    """impl -> JAX's gradient tree of sum(logits * probe) + 10 * aux."""
    ids, mask = _inputs()
    probe = _probe(ids)
    out = {}
    for impl in IMPLS:
        jcfg, _ = _cfgs(jx, moe_impl=impl)
        out[impl] = np_tree(jx.jax.jit(jx.jax.grad(_loss_j(
            jx, jcfg, jx.jnp.asarray(ids), jx.jnp.asarray(mask),
            jx.jnp.asarray(probe))))(jx.jax.tree.map(jx.jnp.asarray, tree)))
    return out


def _assert_grads(got, want, path=''):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_grads(got[k], want[k], f'{path}/{k}')
        return
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want)))
    assert err <= GRAD_TOL * scale, (path, err, scale)


@pytest.mark.parametrize('impl', IMPLS)
def test_gradients_match_jax(jx, tree, jax_grads, impl):
    """The gradient of every leaf, router and experts included, through
    the top-k weights into the router and through the aux loss."""
    tparams = _grads(jx, tree, impl)
    got = _grad_tree(tparams)
    want = jax_grads[impl]
    _assert_grads(got, want)
    for name in ('router', 'up', 'gate', 'down'):
        assert np.abs(got['layers'][name]['w']).max() > 0, name


@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('remat', tt.REMAT_POLICIES[1:])
def test_remat_policies_keep_gradients(jx, tree, jax_grads, impl, remat):
    """Every remat policy on the MoE layers (``full`` and ``dots_mlp_lean``
    among them) gives the gradients of the run without remat, and JAX's."""
    tparams = _grads(jx, tree, impl, remat=remat)
    _assert_grads(_grad_tree(tparams), jax_grads[impl])


def test_remat_saves_what_jax_saves(jx, tree, monkeypatch):
    """Under the dots policies an MoE layer keeps JAX's residuals: the
    router's output always; the up and gate outputs under
    ``dots_saveable`` and ``dots_nb`` but not ``dots_mlp_lean``; the
    per-expert down output under ``dots_saveable`` and ``dots_mlp_lean``
    but not ``dots_nb`` (its product batches over the experts).  JAX's
    side is ``saved_residuals`` of one checkpointed layer; the port's is
    what its policy marks to save, by the weight operand's shape."""
    from jax._src.ad_checkpoint import saved_residuals

    jnp = jx.jnp
    ids, mask = _inputs()
    b, l = ids.shape
    jcfg, tcfg = _cfgs(jx)
    e, x_, f = 64, 4, 128
    lp_j = jx.jax.tree.map(lambda a: jnp.asarray(a[0]), tree['layers'])
    h = np.random.default_rng(3).normal(size=(b, l, e)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(l), (b, l))
    sin, cos = jx.t.rope_table(64, 16)

    # JAX's down product keeps its batch dim (the experts) first and its
    # output dim before the tokens
    kinds_j = {(b, l, x_): 'router', (b, l, x_, f): 'up_gate',
               (x_, e, b, l): 'down'}
    kinds_t = {(e, x_): 'router', (e, x_ * f): 'up_gate',
               (x_, f, e): 'down'}
    for remat in ('dots_saveable', 'dots_nb', 'dots_mlp_lean', 'full'):
        c = jcfg.replace(remat=remat)

        def layer(lp, x, c=c):
            return jx.t._decoder_layer(c, lp, x, pos, sin, cos,
                                       jnp.asarray(mask), None, None)[0].sum()

        saved = saved_residuals(
            jx.jax.checkpoint(layer, policy=jx.t._remat_policy(c)), lp_j,
            jnp.asarray(h))
        want = {kinds_j[tuple(a.shape)] for a, _ in saved
                if tuple(a.shape) in kinds_j}
        got = set()
        real = tt._policy_saves

        def spy(policy, up_shape, op, args):
            keep = real(policy, up_shape, op, args)
            if keep and (op in tt._MATMULS or op in tt._BATCHED_MATMULS):
                shape = tuple(tt._weight_operand(op, args).shape)
                if shape[0] == 1:      # einsum's batch of one
                    shape = shape[1:]
                if shape in kinds_t:
                    got.add(kinds_t[shape])
            return keep

        monkeypatch.setattr(tt, '_policy_saves', spy)
        tparams = from_jax_tree(tree, device='cpu')
        for leaf in tparams['layers'].values():
            for v in leaf.values():
                v.requires_grad_(True)
        out = tt.forward(tparams, tcfg.replace(remat=remat),
                         torch.from_numpy(ids).long(),
                         attention_mask=torch.from_numpy(mask).long())
        out.logits.sum().backward()
        monkeypatch.setattr(tt, '_policy_saves', real)
        assert got == want, (remat, got, want)
    assert want == set()           # 'full' saves nothing


@pytest.mark.parametrize('impl', IMPLS)
def test_top_k_ties_take_the_lower_expert(jx, tree, impl):
    """Tied router probabilities pick the lower expert first, as
    ``jax.lax.top_k`` does: a zero router (every expert ties: experts 0
    and 1 for every token) and a router whose columns repeat in pairs
    (bf16 logits, ties in every token); the forward over the zero router
    matches JAX."""
    jnp = jx.jnp
    zero = {**tree, 'layers': {**tree['layers'], 'router': {
        'w': np.zeros_like(tree['layers']['router']['w'])}}}
    ids, mask = _inputs(seed=4)
    got, want = _run_both(jx, zero, impl, ids, mask)
    _close(got.logits, want.logits, LOGIT_TOL)
    assert abs(float(got.aux_loss) - float(want.aux_loss)) <= AUX_TOL
    _, tcfg = _cfgs(jx, moe_impl=impl)
    h = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 5, 64)).astype(np.float32))
    lp = {'router': {'w': torch.zeros(64, 4)}}
    _, idx, _, _ = tt._route(tcfg, lp, h)
    assert (idx == torch.tensor([0, 1])).all()
    # pairs of equal columns: (0, 2) and (1, 3) tie in bf16 and in fp32
    rng = np.random.default_rng(7)
    half = rng.normal(size=(64, 2)).astype(np.float32)
    router = np.concatenate([half, half], axis=1)
    hb = rng.normal(size=(3, 16, 64)).astype(np.float32)
    top = jx.jax.lax.top_k(jx.jax.nn.softmax(jnp.einsum(
        'ble,ex->blx', jnp.asarray(hb, jnp.bfloat16),
        jnp.asarray(router, jnp.bfloat16)).astype(jnp.float32), axis=-1),
        2)[1]
    _, idx, _, _ = tt._route(tcfg, {'router': {'w': torch.from_numpy(
        router)}}, torch.from_numpy(hb).bfloat16())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(top))
    assert set(np.unique(np.asarray(top)[..., 0] % 2 == np.asarray(top)[
        ..., 1] % 2).tolist()) == {True}   # each token picked a tied pair


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def _flat(t, prefix=''):
    """Path -> numpy leaf of a JAX or port tree; a quantized leaf gives its
    values, its scales and its class name."""
    if isinstance(t, dict):
        return {p: v for k, s in t.items()
                for p, v in _flat(s, f'{prefix}/{k}').items()}
    if hasattr(t, 'values') and hasattr(t, 'scales'):
        return {**_flat(t.values, f'{prefix}.values'),
                **_flat(t.scales, f'{prefix}.scales'),
                f'{prefix}.kind': type(t).__name__}
    return {prefix: t.detach().numpy() if hasattr(t, 'detach')
            else np.asarray(t)}


@pytest.mark.parametrize('bits', [8, 4])
def test_quantized_trees_match_jax(jx, tree, bits):
    """``quantize_decoder_int8`` quantizes the experts on axis 2 and the
    router on axis 1; ``quantize_decoder_int4(compute=True)`` keeps the
    experts fp and quantizes the router: both trees equal JAX's bit for
    bit, and the forward over them (experts and router dequantized where
    they are read; int8 with both dispatches) matches JAX's."""
    jparams = jx.jax.tree.map(jx.jnp.asarray, tree)
    tparams = from_jax_tree(tree, device='cpu')
    if bits == 8:
        jqp = jx.q.quantize_decoder_int8(jparams, num_experts=4)
        tqp = tq.quantize_decoder_int8(tparams, num_experts=4)
        tol = LOGIT_TOL
    else:
        jqp = jx.q.quantize_decoder_int4(jparams, num_experts=4, compute=True)
        tqp = tq.quantize_decoder_int4(tparams, num_experts=4, compute=True)
        tol = INT4_TOL
    want = _flat(jqp)
    got = _flat(tqp)
    assert set(got) == set(want)
    for path, leaf in want.items():
        if path.endswith('.kind'):
            assert got[path] == leaf, path
            continue
        g = got[path]
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, path
        assert g.tobytes() == leaf.tobytes(), path
    kinds = {p.split('/')[2]: v for p, v in got.items()
             if p.endswith('.kind') and p.startswith('/layers/')}
    assert kinds['router'] == f'Int{bits}Weight'
    experts = {'up', 'gate', 'down'}
    if bits == 8:
        assert {kinds[k] for k in experts} == {'Int8Weight'}
        assert got['/layers/up/w.scales'].shape == (2, 4, 1, 128)
    else:
        assert not experts & set(kinds)
        assert isinstance(tqp['layers']['up']['w'], torch.Tensor)
    ids, mask = _inputs(seed=2)
    # int8's experts are quantized, so both dispatches read them; int4's
    # stay fp (the dispatch then reads what the fp tree's tests cover)
    for impl in (IMPLS if bits == 8 else ('dense',)):
        jcfg, tcfg = _cfgs(jx, moe_impl=impl)
        w = _jforward(jx)(jqp, jcfg, jx.jnp.asarray(ids),
                          attention_mask=jx.jnp.asarray(mask))
        g = tt.forward(tqp, tcfg, torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask).long())
        _close(g.logits, w.logits, tol)
        # int4: the router sees the int4 kernel's bf16-rounded activations
        assert abs(float(g.aux_loss) - float(w.aux_loss)) <= (
            AUX_TOL if bits == 8 else tol * float(w.aux_loss))


def test_r31_int4_fuse_refuses_moe(jx, tree):
    """ROADMAP R31: ``quantize_decoder_int4(fuse=True)`` on an MoE tree
    fails in JAX (``AttributeError``: the fp gate / up leaves have no
    ``values``); the port raises a ``ValueError`` that names R31.  A dense
    tree still fuses."""
    with pytest.raises(AttributeError):
        jx.q.quantize_decoder_int4(jx.jax.tree.map(jx.jnp.asarray, tree),
                                   num_experts=4, fuse=True)
    with pytest.raises(ValueError, match='R31'):
        tq.quantize_decoder_int4(from_jax_tree(tree, device='cpu'),
                                 num_experts=4, fuse=True)
    dense = tt.init_params(tc.tiny_config(), torch.Generator().manual_seed(0),
                           device='cpu')
    fused = tq.quantize_decoder_int4(dense, fuse=True)
    assert {'qkv', 'gate_up'} <= set(fused['layers'])


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

PROMPTS = [[5, 6, 7], [9, 10, 11, 12], [20], [30, 31]]
GREEDY = dict(max_new_tokens=8, greedy=True, eos_token_id=-1)


@pytest.mark.parametrize('impl', IMPLS)
def test_greedy_ids_match_jax(jx, tree, impl):
    """Greedy ids of 4 prompts (8 new tokens) from the port's continuous
    engine, dense and paged cache (2 slots: requests wait and enter
    mid-run), and from its ``generate`` over left-padded prompts, equal
    JAX's ``generate``."""
    from align_anything_tpu.generation import engine as jeng

    jcfg, tcfg = _cfgs(jx, moe_impl=impl)
    p = max(len(x) for x in PROMPTS)
    ids = np.zeros((len(PROMPTS), p), np.int32)
    mask = np.zeros_like(ids)
    for i, x in enumerate(PROMPTS):
        ids[i, p - len(x):] = x
        mask[i, p - len(x):] = 1
    want = jeng.generate(jx.jax.tree.map(jx.jnp.asarray, tree), jcfg,
                         jeng.GenerationConfig(**GREEDY), jx.jnp.asarray(ids),
                         jx.jnp.asarray(mask), jx.jax.random.PRNGKey(0))
    want = np.asarray(want['sequences'])[:, p:].tolist()
    tparams = from_jax_tree(tree, device='cpu')
    batch = generate(tparams, tcfg, GenerationConfig(**GREEDY),
                     torch.from_numpy(ids).long(),
                     torch.from_numpy(mask).long())
    assert batch['completions'].tolist() == want
    for mode in ('dense', 'paged'):
        eng = ContinuousBatchingEngine(tcfg, num_slots=2, max_len=32,
                                       prompt_buckets=(8,), cache_mode=mode)
        out = eng.generate(tparams, PROMPTS, GenerationConfig(**GREEDY),
                           torch.Generator().manual_seed(2), chunk_steps=4)
        assert out == want, mode
        assert eng.stats['admit_step'][2] > 0


# ---------------------------------------------------------------------------
# trainers, export and resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def sft_rows(tmp_path_factory):
    d = tmp_path_factory.mktemp('moe_rows')
    rng = np.random.default_rng(0)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps', 'zeta']

    def pick(k):
        return ' '.join(words[j] for j in rng.integers(0, 6, size=k))

    with open(d / 'sft.jsonl', 'w') as f:
        for _ in range(16):
            f.write(json.dumps({'instruction': f'say {pick(2)}',
                                'input': pick(1),
                                'output': pick(int(rng.integers(1, 8)))})
                    + '\n')
    with open(d / 'pref.jsonl', 'w') as f:
        for _ in range(8):
            f.write(json.dumps({
                'prompt': f'pick {pick(int(rng.integers(1, 4)))}',
                'response_0': pick(int(rng.integers(1, 8))),
                'response_1': pick(int(rng.integers(1, 8))),
                'better_response_id': int(rng.integers(0, 2))}) + '\n')
    return d


def _argv(rows, out, per_device, data='sft', template='Alpaca', extra=()):
    return ['--model_name_or_path', 'tiny-moe',
            '--train_datasets', str(rows / f'{data}.jsonl'),
            '--train_template', template, '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[32]', '--save_checkpoint', 'False',
            '--per_device_train_batch_size', str(per_device), *extra]


def _port_init_from(monkeypatch, jparams):
    """The port's trainers init the preset with JAX's weights (a preset's
    random init differs between the packages)."""
    monkeypatch.setattr(tt, 'init_params', lambda cfg, gen, device=None:
                        from_jax_tree(np_tree(jparams), device='cpu'))


def test_sft_step_matches_jax(jx, sft_rows, tmp_path, monkeypatch):
    """One SFT step of 8 rows on ``tiny-moe`` (router_aux_coef 0.01):
    ``train/loss``, ``train/router_aux_loss`` and every param after the
    step (the gradients, through AdamW) equal JAX's ``SupervisedTrainer``;
    the loss that trains is the cross-entropy plus 0.01 x the aux loss."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_to_text import sft as jsft

    # JAX's trainer inits the preset op by op, a compile for each leaf
    # shape; compiled once, the init costs one compile (the port starts
    # from whatever params JAX's trainer holds)
    monkeypatch.setattr(jx.t, 'init_params',
                        jx.jax.jit(jx.t.init_params, static_argnums=0))
    cfgs, pc = jcli.parse_cfgs('text_to_text/sft',
                               _argv(sft_rows, tmp_path / 'jax', 1))
    jtrainer = jsft.SupervisedTrainer(cfgs=cfgs, parallel_cfgs=pc)
    start = np_tree(jtrainer.state.params)
    jbatch = next(iter(jtrainer.train_iterator.epoch_batches(0)))
    want = {k: float(v) for k, v in jtrainer.train_step(jbatch).items()}
    _port_init_from(monkeypatch, start)
    cfgs, pc = tcli.parse_cfgs('text_to_text/sft',
                               _argv(sft_rows, tmp_path / 'port', 8))
    trainer = SupervisedTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    assert trainer.model_cfg.num_experts == 4
    batch = next(iter(trainer.train_iterator.epoch_batches(0)))
    for key in jbatch:
        np.testing.assert_array_equal(batch[key], jbatch[key], err_msg=key)
    with torch.no_grad():
        out = tt.forward(trainer.state.params, trainer.model_cfg,
                         torch.from_numpy(batch['input_ids']).long(),
                         attention_mask=torch.from_numpy(
                             batch['attention_mask']).long())
    got = trainer.train_step(batch)
    assert {'train/loss', 'train/router_aux_loss'} <= set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL, err_msg=key)
    assert got['train/router_aux_loss'] == pytest.approx(float(out.aux_loss))
    want_p = _flat(jtrainer.state.params)
    got_p = _flat(trainer.state.params)
    assert set(got_p) == set(want_p)
    for path, leaf in got_p.items():
        np.testing.assert_allclose(leaf, want_p[path], rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL, err_msg=path)
        assert not np.array_equal(leaf, _flat(start)[path]), path


def test_dpo_step_on_moe(jx, sft_rows, tmp_path, monkeypatch):
    """DPO reaches MoE through ``forward``: its step-1 loss is ln 2 (policy
    = reference) and every leaf of the policy, router and experts
    included, moves; the aux loss is not part of DPO's loss, as in JAX."""
    jparams = np_tree(_jinit(jx, jx.t, _cfgs(jx)[0], 1))
    _port_init_from(monkeypatch, jparams)
    cfgs, pc = tcli.parse_cfgs('text_to_text/dpo', _argv(
        sft_rows, tmp_path, 8, data='pref', template='PKUSafeRLHF'))
    trainer = DPOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    batch = next(iter(trainer.train_iterator.epoch_batches(0)))
    got = trainer.train_step(batch)
    assert abs(got['train/loss'] - math.log(2)) <= 1e-6
    assert 'train/router_aux_loss' not in got
    for path, leaf in _flat(trainer.state.params).items():
        assert not np.array_equal(leaf, _flat(jparams)[path]), path


def test_export_matches_jax_and_does_not_load_back(jx, tree, tmp_path):
    """ROADMAP R34: ``save_params`` on an MoE tree writes what JAX writes:
    the same tensor names and shapes, each tensor bit for bit what JAX's
    ``_dump_llama_like`` hands its writer (the experts under the dense MLP
    names with every dim reversed, no router), and the same
    ``config.json`` (a Llama config without experts).  JAX's file holds
    its transposed leaves in memory order (R8); the port's holds them in
    their own order, as for a dense model.  The port warns at export, and
    neither loader reads the export back."""
    from safetensors.numpy import load_file

    from align_anything_tpu.models import hf_loader as jh

    jcfg, tcfg = _cfgs(jx)
    jh.save_params(str(tmp_path / 'jax'), tree, jcfg)
    with pytest.warns(UserWarning, match='R34'):
        th.save_params(str(tmp_path / 'port'), from_jax_tree(
            tree, device='cpu'), tcfg)
    want = {k: np.ascontiguousarray(v, np.float32)
            for k, v in jh._dump_llama_like(tree, jcfg).items()}
    on_disk = load_file(str(tmp_path / 'jax' / 'model.safetensors'))
    got = load_file(str(tmp_path / 'port' / 'model.safetensors'))
    assert set(got) == set(want) == set(on_disk)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape
        assert on_disk[name].shape == arr.shape
        assert got[name].tobytes() == arr.tobytes(), name
    assert want['model.layers.0.mlp.up_proj.weight'].shape == (128, 64, 4)
    assert not any('router' in k for k in got)
    with open(tmp_path / 'jax' / 'config.json') as f:
        jcfg_json = json.load(f)
    with open(tmp_path / 'port' / 'config.json') as f:
        assert json.load(f) == jcfg_json
    assert 'num_experts' not in jcfg_json
    # both loaders read a dense config over expert-shaped MLP tensors, and
    # a forward over what they read fails
    jback, jc_back = jh.load_params(str(tmp_path / 'jax'))
    assert jc_back.num_experts == 0
    with pytest.raises(ValueError):
        jx.t.forward(jback, jc_back, jx.jnp.ones((1, 4), jx.jnp.int32))
    tback, tc_back = th.load_params(str(tmp_path / 'port'), device='cpu')
    assert tc_back.num_experts == 0
    with pytest.raises(RuntimeError):
        tt.forward(tback, tc_back, torch.ones((1, 4), dtype=torch.long))


def test_train_state_resumes_moe(jx, sft_rows, tmp_path, monkeypatch):
    """The train state of an MoE SFT run (``checkpoint.py``) saves after
    step 1 and resumes: the resumed trainer holds the saved step and
    params, router and experts included, bit for bit."""
    jparams = np_tree(_jinit(jx, jx.t, _cfgs(jx)[0], 2))
    _port_init_from(monkeypatch, jparams)
    extra = ('--save_checkpoint', 'True', '--save_interval', '1')
    cfgs, pc = tcli.parse_cfgs('text_to_text/sft', _argv(
        sft_rows, tmp_path / 'run', 8, extra=extra))
    first = SupervisedTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    first.train_step(next(iter(first.train_iterator.epoch_batches(0))))
    from align_anything_tpu_torch import checkpoint as tck

    with pytest.warns(UserWarning, match='R34'):
        first.save(tag=1)
    tck.wait_for_saves()
    cfgs, pc = tcli.parse_cfgs('text_to_text/sft', _argv(
        sft_rows, tmp_path / 'run', 8, extra=('--load_checkpoint', 'True')))
    resumed = SupervisedTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    assert resumed.state.step == first.state.step == 1
    want, got = _flat(first.state.params), _flat(resumed.state.params)
    assert set(got) == set(want)
    assert all(np.array_equal(got[p], want[p]) for p in want)


@pytest.mark.parametrize('bits', [4, 8])
def test_qlora_on_moe(jx, sft_rows, tmp_path, monkeypatch, bits):
    """QLoRA on an MoE tree does what JAX's does: the base quantized as
    ``quantize_decoder_int{bits}`` quantizes it (int4: experts fp, router
    int4; int8: experts and router int8), adapters on q and v train, and
    the forward over the attached tree matches JAX's; adapters on the
    experts raise (JAX fails to reshape them, ``TypeError``)."""
    from align_anything_tpu.models import lora as jl

    jparams = np_tree(_jinit(jx, jx.t, _cfgs(jx)[0], 3))
    _port_init_from(monkeypatch, jparams)
    qlora = ('--use_lora', 'True', '--use_bnb', 'True',
             '--load_in_4bit', str(bits == 4))
    cfgs, pc = tcli.parse_cfgs('text_to_text/sft', _argv(
        sft_rows, tmp_path, 8, extra=qlora))
    trainer = SupervisedTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    base = trainer.base_params['layers']
    kind = tq.Int4Weight if bits == 4 else tq.Int8Weight
    assert isinstance(base['router']['w'], kind)
    assert isinstance(base['up']['w'], torch.Tensor if bits == 4 else kind)
    m = trainer.train_step(next(iter(trainer.train_iterator.epoch_batches(0))))
    assert np.isfinite(m['train/loss']) and 'train/router_aux_loss' in m
    jcfg, tcfg = _cfgs(jx)
    jp = jx.jax.tree.map(jx.jnp.asarray, jparams)
    jbase = (jx.q.quantize_decoder_int4(jp, num_experts=4) if bits == 4
             else jx.q.quantize_decoder_int8(jp, num_experts=4))
    adapters = np_tree(jl.init_lora_params(jcfg, jx.jax.random.PRNGKey(4),
                                           r=4))
    adapters['q_proj']['b'] = adapters['q_proj']['a'].transpose(0, 2, 1)[
        :, :, :64] * 0.1
    ids, mask = _inputs(seed=8)
    want = _jforward(jx)(jl.attach_lora(jbase, jx.jax.tree.map(
        jx.jnp.asarray, adapters), jcfg, 4, 16.0), jcfg, jx.jnp.asarray(ids),
        attention_mask=jx.jnp.asarray(mask))
    from align_anything_tpu_torch.models import lora as tl

    tbase = (tq.quantize_decoder_int4 if bits == 4 else
             tq.quantize_decoder_int8)(from_jax_tree(jparams, device='cpu'),
                                       num_experts=4)
    got = tt.forward(tl.attach_lora(tbase, from_jax_tree(
        adapters, device='cpu'), tcfg, 4, 16.0), tcfg,
        torch.from_numpy(ids).long(),
        attention_mask=torch.from_numpy(mask).long())
    _close(got.logits, want.logits, LOGIT_TOL)
    with pytest.raises(TypeError):
        jl.attach_lora(jbase, jl.init_lora_params(
            jcfg, jx.jax.random.PRNGKey(5), r=4, target_modules=('up_proj',)),
            jcfg, 4, 16.0)['layers']['up']['w'].astype(jx.jnp.float32)
    with pytest.raises(ValueError, match='MoE'):
        tl.init_lora_params(tcfg, torch.Generator().manual_seed(0), r=4,
                            target_modules=('up_proj',), device='cpu')


# ---------------------------------------------------------------------------
# the multimodal families over an MoE trunk
# ---------------------------------------------------------------------------

MOE = dict(num_experts=4, num_experts_per_tok=2, router_aux_coef=0.01)


_FAMILY_PARAMS: dict = {}


def _family_params(jx, family, module, cfg):
    """A tree of JAX's ``init_params`` shapes for ``family`` (traced, not
    compiled: the dispatch does not change the tree), filled from a seed as
    JAX's init fills it: norm weights 1, biases 0, every other leaf normal
    with a standard deviation of at most fan-in^-1/2."""
    if family not in _FAMILY_PARAMS:
        rng = np.random.default_rng(12)
        shapes = jx.jax.eval_shape(
            lambda k: module.init_params(cfg.replace(moe_impl='dense'), k),
            jx.jax.random.PRNGKey(0))

        def fill(path, a):
            names = jx.jax.tree_util.keystr(path)
            if names.endswith("['b']"):
                return np.zeros(a.shape, a.dtype)
            if 'norm' in names or 'ln_' in names:
                return np.ones(a.shape, a.dtype)
            std = min(0.15, a.shape[-2] ** -0.5) if len(a.shape) > 1 else 0.15
            return (rng.normal(size=a.shape) * std).astype(a.dtype)

        _FAMILY_PARAMS[family] = jx.jax.tree_util.tree_map_with_path(
            fill, shapes)
    return _FAMILY_PARAMS[family]


def _family_case(jx, family, impl):
    """(JAX config, port config, params (numpy, ``_family_params``), media,
    ids, mask, (JAX forward, port forward)) of a tiny model of ``family``
    over an MoE trunk."""
    from align_anything_tpu.models.config import ModelConfig as JText

    text = dict(vocab_size=128, hidden_size=48, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=12, mlp_dim=64,
                max_position_embeddings=256, compute_dtype='float32',
                moe_impl=impl, **MOE)
    rng = np.random.default_rng(11)
    if family == 'audio':
        from align_anything_tpu.models import audio as ja

        from align_anything_tpu_torch.models import audio as ta
        enc = dict(n_mels=16, hidden_size=32, num_layers=1, num_heads=2,
                   mlp_dim=64, max_frames=16)
        jcfg = ja.AudioLMConfig(text=JText(**text),
                                audio=ja.AudioEncoderConfig(**enc),
                                audio_token_id=120)
        tcfg = ta.AudioLMConfig(text=tc.ModelConfig(**text),
                                audio=ta.AudioEncoderConfig(**enc),
                                audio_token_id=120)
        params = _family_params(jx, family, ja, jcfg)
        tokens = tcfg.audio.num_audio_tokens
        ids = rng.integers(3, 100, size=(2, tokens + 6)).astype(np.int32)
        ids[:, 1:1 + tokens] = 120
        waves = rng.normal(size=(2, 16 * 160)).astype(np.float32) * 0.1
        media = {'audio_values': waves}
        fwd = (ja.forward, ta.forward)
    else:
        mod = 'qwen2_vl' if family == 'qwen2_vl' else 'qwen2_5_vl'
        jm = __import__(f'align_anything_tpu.models.{mod}', fromlist=['_'])
        tm = __import__(f'align_anything_tpu_torch.models.{mod}',
                        fromlist=['_'])
        from align_anything_tpu.models import qwen2_vl as jq2
        text['mrope_section'] = (2, 2, 2)
        if family == 'qwen2_vl':
            vis = dict(depth=1, embed_dim=32, num_heads=4, image_size=56)
            jv, tv = jm.Qwen2VLVisionConfig(**vis), tm.Qwen2VLVisionConfig(
                **vis)
            jcls, tcls = jm.Qwen2VLConfig, tm.Qwen2VLConfig
        else:
            vis = dict(depth=2, embed_dim=32, num_heads=4,
                       intermediate_size=48, window_size=56,
                       fullatt_block_indexes=(1,), image_size=56)
            jv, tv = jm.Qwen25VLVisionConfig(**vis), \
                tm.Qwen25VLVisionConfig(**vis)
            jcls, tcls = jm.Qwen25VLConfig, tm.Qwen25VLConfig
        jcfg = jcls(text=JText(**text), vision=jv, image_token_id=110)
        tcfg = tcls(text=tc.ModelConfig(**text), vision=tv,
                    image_token_id=110)
        params = _family_params(jx, family, jm, jcfg)
        ids = rng.integers(3, 100, size=(2, 12)).astype(np.int32)
        ids[:, 2], ids[:, 3:7], ids[:, 7] = 101, 110, 102
        px = np.stack([jq2.qwen2vl_patchify(rng.normal(
            size=(3, 56, 56)).astype(np.float32), jv) for _ in range(2)])
        media = {'pixel_values': px}
        fwd = (jm.forward, tm.forward)
    mask = np.ones_like(ids)
    mask[1, -2:] = 0
    params = jx.jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32), params)
    return jcfg, tcfg, params, media, ids, mask, fwd


@pytest.fixture(scope='module')
def family_refs(jx):
    """family -> JAX's logits and aux loss over its MoE trunk with the
    dense dispatch, compiled once (op-by-op dispatch compiles every
    primitive)."""
    out = {}

    def ref(family):
        if family not in out:
            jcfg, _, params, media, ids, mask, (jf, _) = _family_case(
                jx, family, 'dense')
            want = jx.jax.jit(jf, static_argnums=1)(
                jx.jax.tree.map(jx.jnp.asarray, params), jcfg,
                jx.jnp.asarray(ids), attention_mask=jx.jnp.asarray(mask),
                **{k: jx.jnp.asarray(v) for k, v in media.items()})
            out[family] = (np.asarray(want.logits), float(want.aux_loss))
        return out[family]

    return ref


@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('family', ['qwen2_vl', 'qwen2_5_vl', 'audio'])
def test_families_run_an_moe_trunk(jx, family_refs, family, impl):
    """Qwen2-VL, Qwen2.5-VL and Qwen2-Audio over an MoE trunk run in JAX,
    so they run in the port: logits under the mask (1e-4 of max|logit|)
    and the aux loss (1e-5) with media equal JAX's, each dispatch of the
    port against JAX's dense one (``test_forward_and_aux_match_jax`` holds
    the sparse dispatch to JAX's own)."""
    _, tcfg, params, media, ids, mask, (_, tf) = _family_case(
        jx, family, impl)
    want_logits, want_aux = family_refs(family)
    got = tf(from_jax_tree(params, device='cpu'), tcfg,
             torch.from_numpy(ids).long(),
             attention_mask=torch.from_numpy(mask).long(),
             **{k: torch.from_numpy(v) for k, v in media.items()})
    real = mask.astype(bool)
    _close(got.logits.detach().numpy()[real], want_logits[real], LOGIT_TOL)
    assert abs(float(got.aux_loss) - want_aux) <= AUX_TOL


def test_mllama_refuses_an_moe_trunk(jx):
    """Mllama's trunk builds dense MLP leaves: JAX's forward over an MoE
    text config fails (the self layers find no router), so the port
    raises at init and at forward."""
    from align_anything_tpu.models import mllama as jm
    from align_anything_tpu.models.config import ModelConfig as JText

    from align_anything_tpu_torch.models import mllama as tm

    text = dict(vocab_size=136, hidden_size=32, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=8, mlp_dim=64,
                compute_dtype='float32', **MOE)
    vis = dict(hidden_size=32, intermediate_size=64, num_layers=1,
               num_global_layers=1, num_heads=4, image_size=28,
               max_num_tiles=2, max_aspect_ratio_id=3,
               intermediate_layers_indices=(0,))
    jcfg = jm.MllamaConfig(text=JText(**text),
                           vision=jm.MllamaVisionConfig(**vis),
                           cross_attention_layers=(1,), image_token_id=128)
    tcfg = tm.MllamaConfig(text=tc.ModelConfig(**text),
                           vision=tm.MllamaVisionConfig(**vis),
                           cross_attention_layers=(1,), image_token_id=128)
    # the tree's shapes only: the forward fails before it reads a value
    jparams = jx.jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jx.jax.eval_shape(lambda k: jm.init_params(jcfg, k),
                          jx.jax.random.PRNGKey(0)))
    assert 'router' not in jparams['language_model']['layers'][0]
    ids = np.array([[1, 5, 6, 7]], np.int32)
    with pytest.raises(KeyError):             # traced only: it fails there
        jx.jax.eval_shape(lambda p: jm.forward(p, jcfg, jx.jnp.asarray(ids)),
                          jparams)
    with pytest.raises(NotImplementedError, match='MoE'):
        tm.init_params(tcfg, torch.Generator().manual_seed(0), device='cpu')
    with pytest.raises(NotImplementedError, match='MoE'):
        tm.forward(from_jax_tree(jx.jax.tree.map(np.asarray, jparams),
                                 device='cpu'), tcfg,
                   torch.from_numpy(ids).long())


def test_export_warns_only_for_moe(tmp_path):
    """A dense export writes no R34 warning."""
    import warnings

    cfg = tc.tiny_config(vocab_size=64, hidden=16, layers=1, heads=2,
                         kv_heads=1, mlp=32)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        th.save_params(str(tmp_path / 'dense'), params, cfg)
    assert os.path.exists(tmp_path / 'dense' / 'model.safetensors')
