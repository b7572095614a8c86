"""The DPO train step of the port against the JAX package's, and the
port's remat policies against each other, at a tiny Llama config in fp32
on the CPU.

The JAX side is ``token_logprobs`` + ``dpo_loss`` + ``make_optimizer``
under ``jax.value_and_grad``, as the JAX ``DPOTrainer``'s step; the port's
``DPOStep`` gets the same weights through ``models/bridge.py``.
Tolerances: 1e-5 for losses, metrics and the params after three updates
(fp32 math summed in another order; lr 1e-4 keeps Adam's normalized steps
from amplifying that), and 1e-6 relative between the ten remat policies (the
same ops, recomputed).
"""

import copy
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.models import transformer as tt  # noqa: E402
from align_anything_tpu_torch.models.bridge import (  # noqa: E402
    trainable_from_jax_tree,
)
from align_anything_tpu_torch.models.config import tiny_config  # noqa: E402
from align_anything_tpu_torch.ops import flash_attention as tf  # noqa: E402
from align_anything_tpu_torch.trainers.optimizer import (  # noqa: E402
    make_optimizer,
    param_leaves,
)
from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: E402
    DPOStep,
)
from align_anything_tpu_torch.utils.tools import tree_map  # noqa: E402

from test_torch_int4_matmul import np_tree  # noqa: E402

CFG = dict(vocab_size=128, hidden=128, layers=2, heads=2, kv_heads=1,
           mlp=256)                               # head dim 64, GQA 2
B_PAIRS, SEQ = 2, 40
OPT = dict(lr_scheduler_type='cosine', total_steps=3, lr_warmup_ratio=0.34,
           weight_decay=0.01, max_grad_norm=1.0)
LR = 1e-4
METRIC_KEYS = ('train/loss', 'train/reward', 'train/better_sample_reward',
               'train/worse_sample_reward', 'train/reward_accuracy',
               'train/reward_margin', 'train/lr')


@pytest.fixture(scope='module')
def jx():
    jax = pytest.importorskip('jax')
    import optax

    from align_anything_tpu.losses import dpo_loss
    from align_anything_tpu.models import config as jc
    from align_anything_tpu.models import transformer as jt
    from align_anything_tpu.ops.logprobs import token_logprobs
    from align_anything_tpu.trainers import optimizer as jopt

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, optax=optax, c=jc,
                                 t=jt, dpo_loss=dpo_loss,
                                 token_logprobs=token_logprobs, opt=jopt)


def _batch(seed=0):
    """Better rows above worse; the worse rows end 5-9 tokens early; the
    response is the second half."""
    rng = np.random.default_rng(seed)
    b = 2 * B_PAIRS
    ids = rng.integers(3, CFG['vocab_size'], size=(b, SEQ))
    mask = np.ones((b, SEQ), np.int32)
    for r in range(B_PAIRS, b):
        mask[r, SEQ - int(rng.integers(5, 10)):] = 0
    rmask = ((np.arange(SEQ - 1)[None] >= SEQ // 2)
             & (mask[:, 1:] == 1)).astype(np.float32)
    return {'input_ids': ids, 'attention_mask': mask, 'response_mask': rmask}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_steps(jx, params, batch, n):
    cfg = jx.c.tiny_config(**CFG).replace(compute_dtype='float32')
    tx, schedule = jx.opt.make_optimizer(LR, **OPT)
    ref = params

    def loss_fn(p):
        logp = jx.token_logprobs(p, cfg, batch['input_ids'],
                                 attention_mask=batch['attention_mask'])
        ref_logp = jx.jax.lax.stop_gradient(jx.token_logprobs(
            ref, cfg, batch['input_ids'],
            attention_mask=batch['attention_mask']))
        out = jx.dpo_loss(logp, ref_logp, batch['input_ids'],
                          batch['response_mask'], scale_coeff=0.1)
        return out['loss'], {
            'train/loss': out['loss'],
            'train/reward': out['reward'].mean(),
            'train/better_sample_reward': out['better_sample_reward'].mean(),
            'train/worse_sample_reward': out['worse_sample_reward'].mean(),
            'train/reward_accuracy': out['reward_accuracy'],
            'train/reward_margin': out['reward_margin'].mean()}

    state, out = tx.init(params), []
    for step in range(n):
        (_, metrics), grads = jx.jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, state = tx.update(grads, state, params)
        params = jx.optax.apply_updates(params, updates)
        metrics['train/lr'] = schedule(step)
        metrics['train/grad_norm'] = jx.optax.global_norm(grads)
        out.append({k: float(v) for k, v in metrics.items()})
    return params, out


def test_dpo_steps_match_jax(jx):
    jcfg = jx.c.tiny_config(**CFG).replace(compute_dtype='float32')
    jparams = jx.t.init_params(jcfg, jx.jax.random.PRNGKey(0))
    batch = _batch()
    jfinal, jmetrics = _jax_steps(jx, jparams, batch, 3)

    cfg = tiny_config(**CFG).replace(compute_dtype='float32')
    params, ref = trainable_from_jax_tree(np_tree(jparams), device='cpu')
    tx, schedule = make_optimizer(LR, **OPT)
    trainer = DPOStep(cfg, tx, schedule, scale_coeff=0.1)
    state = trainer.init_state(params)
    tb = _torch_batch(batch)
    for step in range(3):
        state, metrics = trainer.step(state, ref, tb)
        for key in METRIC_KEYS + ('train/grad_norm',):
            np.testing.assert_allclose(float(metrics[key]),
                                       jmetrics[step][key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)
    assert state.step == 3
    # policy == reference at step 1: the DPO loss is exactly ln 2
    assert abs(jmetrics[0]['train/loss'] - math.log(2)) < 1e-6
    assert float(jmetrics[0]['train/loss']) != jmetrics[2]['train/loss']
    want, got = _flat(np_tree(jfinal)), _flat(state.params)
    assert set(want) == set(got)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                   rtol=1e-5, atol=1e-5, err_msg=path)


def _flat(tree, prefix=''):
    """path -> leaf (JAX rebuilds dicts in sorted key order)."""
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items()
                for p, leaf in _flat(v, f'{prefix}/{k}').items()}
    return {prefix: tree}


def test_trainable_from_jax_tree(jx):
    jcfg = jx.c.tiny_config(**CFG)
    tree = np_tree(jx.t.init_params(jcfg, jx.jax.random.PRNGKey(1)))
    params, ref = trainable_from_jax_tree(tree, device='cpu')
    for p, r, a in zip(param_leaves(params), param_leaves(ref),
                       param_leaves(tree)):
        assert p.dtype == torch.float32 and p.requires_grad and p.is_leaf
        assert not r.requires_grad and r.data_ptr() != p.data_ptr()
        np.testing.assert_array_equal(p.detach().numpy(), a)
        np.testing.assert_array_equal(r.numpy(), a)


def test_init_state_needs_trainable_leaves():
    """The train state takes the leaves as they are: a frozen one raises
    rather than being quietly marked, or quietly never updated."""
    cfg = tiny_config(**CFG).replace(compute_dtype='float32')
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device='cpu')
    trainer = DPOStep(cfg, *make_optimizer(LR, **OPT))
    with pytest.raises(ValueError, match='requires_grad'):
        trainer.init_state(params)
    assert not any(t.requires_grad for t in param_leaves(params))
    state = trainer.init_state(tree_map(lambda t: t.requires_grad_(True),
                                        params))
    assert state.step == 0 and state.params is not None


def _loss_and_grads(remat, monkeypatch):
    """One DPO loss + backward under ``remat``; also counts the attention
    forward calls (the plain version stands for the kernel here)."""
    calls = {'fwd': 0}
    plain = tf.flash_attention_fwd_reference

    def counted(*args, **kwargs):
        calls['fwd'] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tf, 'flash_attention_fwd_reference', counted)
    cfg = tiny_config(**CFG).replace(compute_dtype='float32', remat=remat)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device='cpu')
    ref = copy.deepcopy(params)
    tx, schedule = make_optimizer(LR, **OPT)
    trainer = DPOStep(cfg, tx, schedule)
    # perturb the policy so that the loss has a gradient beyond ln 2's
    with torch.no_grad():
        params['layers']['q']['w'].mul_(1.1)
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    loss, _ = trainer.loss_fn(params, ref, _torch_batch(_batch(1)))
    with_ref = calls['fwd']
    loss.backward()
    return (float(loss.detach()),
            [p.grad.clone() for p in param_leaves(params)],
            with_ref, calls['fwd'] - with_ref)


# the remat policies that keep the kernel's (out, lse): the others re-run
# the attention forward in the backward
KEEP_FLASH = ('save_flash', 'dots_flash', 'dots_saveable_flash',
              'dots_mlp_lean_flash')


@pytest.mark.parametrize('remat', ['none', 'full', 'dots_saveable',
                                   'dots_nb', 'dots_flash', 'save_flash',
                                   'save_attn', 'dots_saveable_flash',
                                   'dots_mlp_lean', 'dots_mlp_lean_flash'])
def test_remat_policies_keep_the_numbers(remat, monkeypatch):
    """Remat changes memory and time, never the numbers; 'full',
    'dots_saveable' and the other policies without the kernel's names
    re-run the attention forward in the backward (as in JAX, where the
    flash residuals are anonymous to dots_saveable), those with them keep
    its (out, lse)."""
    base_loss, base_grads, base_fwd, base_re = _loss_and_grads('none',
                                                               monkeypatch)
    loss, grads, fwd, re = _loss_and_grads(remat, monkeypatch)
    layers = CFG['layers']
    assert (base_fwd, base_re) == (2 * layers, 0)     # policy + reference
    assert fwd == 2 * layers
    assert re == (0 if remat in KEEP_FLASH + ('none',) else layers)
    assert abs(loss - base_loss) <= 1e-6 * abs(base_loss)
    for g, b in zip(grads, base_grads):
        assert float((g - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-12)


def _saved_ops(remat, impl, monkeypatch):
    """What ``remat`` keeps in one forward of the policy under remat, by
    kind, per layer: the policy's own decisions (``_policy_saves``), read
    as the forward runs.  Under a non-reentrant checkpoint the saved
    outputs live in the checkpoint's cache, where saved-tensor hooks do not
    reach (they see the checkpoint's inputs only)."""
    kinds = {'matmul_nb': 0, 'matmul_batched': 0, 'flash': 0, 'attn_out': 0}
    decide = tt._policy_saves

    def counted(remat_, up_shape, op, args):
        saves = decide(remat_, up_shape, op, args)
        if saves:
            if op is torch.ops.aat_torch.flash_attention_fwd.default:
                kinds['flash'] += 1
            elif op is torch.ops.aat_torch.checkpoint_name.default:
                kinds['attn_out'] += 1
            elif tt._no_batch_dims(op, args):
                kinds['matmul_nb'] += 1
            else:
                kinds['matmul_batched'] += 1
        return saves

    monkeypatch.setattr(tt, '_policy_saves', counted)
    cfg = tiny_config(**CFG).replace(compute_dtype='float32', remat=remat,
                                     attention_impl=impl)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device='cpu')
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    tt.forward(params, cfg, torch.from_numpy(_batch(0)['input_ids']))
    return {k: v // CFG['layers'] for k, v in kinds.items() if v}


# per layer: the seven weight matmuls (q, k, v, o, gate, up, down) run as
# ``bmm`` over a batch of one; the plain attention's two (impl 'xla')
# batch over B x heads; the kernel's forward is one custom op
SAVES = {
    'none': ({}, {}),
    'full': ({}, {}),
    'dots_saveable': ({'matmul_nb': 7}, {'matmul_nb': 7,
                                         'matmul_batched': 2}),
    'dots_nb': ({'matmul_nb': 7}, {'matmul_nb': 7}),
    'dots_flash': ({'matmul_nb': 7, 'flash': 1}, {'matmul_nb': 7}),
    'save_flash': ({'flash': 1, 'attn_out': 1}, {'attn_out': 1}),
    'save_attn': ({'attn_out': 1}, {'attn_out': 1}),
    'dots_saveable_flash': ({'matmul_nb': 7, 'flash': 1},
                            {'matmul_nb': 7, 'matmul_batched': 2}),
    # minus the up and gate projections, whose weight is (hidden, mlp_dim)
    'dots_mlp_lean': ({'matmul_nb': 5}, {'matmul_nb': 5,
                                         'matmul_batched': 2}),
    'dots_mlp_lean_flash': ({'matmul_nb': 5, 'flash': 1},
                            {'matmul_nb': 5, 'matmul_batched': 2}),
}


@pytest.mark.parametrize('remat', sorted(SAVES))
def test_remat_policy_saves(remat, monkeypatch):
    """Each policy keeps what JAX's keeps: through the kernel and through
    the plain attention."""
    assert set(SAVES) == set(tt.REMAT_POLICIES)
    kernel, plain = SAVES[remat]
    assert _saved_ops(remat, 'auto', monkeypatch) == kernel
    assert _saved_ops(remat, 'xla', monkeypatch) == plain
