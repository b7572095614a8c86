"""The port's log-prob gather, chunked log-probs, preference losses and
optimizer against the JAX package, on inputs made from a seed with numpy.

All fp32 on the CPU.  Tolerances: 1e-6 for the gather and the losses (the
same fp32 formulas) and for the schedules (1e-6 of the peak rate: optax
evaluates them in fp32, the port in Python floats); 1e-5 for the chunked
vocab projection and its gradients (fp32 matmuls summed in another order);
1e-6 for the parameters after three optimizer updates.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch import losses as tl  # noqa: E402
from align_anything_tpu_torch.ops import logprobs as tlp  # noqa: E402
from align_anything_tpu_torch.trainers import optimizer as topt  # noqa: E402
from align_anything_tpu_torch.utils.tools import (  # noqa: E402
    gather_log_probabilities,
)


@pytest.fixture(scope='module')
def jx():
    jax = pytest.importorskip('jax')
    import optax

    from align_anything_tpu import losses as jl
    from align_anything_tpu.ops import logprobs as jlp
    from align_anything_tpu.trainers import optimizer as jopt
    from align_anything_tpu.utils import tools as jt

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, optax=optax, l=jl,
                                 lp=jlp, opt=jopt, t=jt)


def _close(got, ref, tol):
    got = got.detach().numpy() if hasattr(got, 'detach') else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


def test_gather_log_probabilities_matches_jax(jx):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 7))
    labels[0, 0], labels[1, 3] = -1, 57      # out of vocab
    labels[1, 5] = -60
    ref = jx.t.gather_log_probabilities(logits, labels)
    got = gather_log_probabilities(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    assert got.dtype == torch.float32
    _close(got, ref, 1e-6)


@pytest.mark.parametrize('softcap,true_vocab', [(None, None), (30.0, 90)])
def test_hidden_to_token_logprobs_matches_jax(jx, softcap, true_vocab):
    """L = 300 is not a multiple of the 256 chunk (padding); values and the
    gradients with respect to hidden and head."""
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 300, 32)).astype(np.float32)
    head = (rng.standard_normal((32, 100)) * 0.5).astype(np.float32)
    labels = rng.integers(0, true_vocab or 100, size=(2, 300))
    w = rng.standard_normal((2, 300)).astype(np.float32)

    def jfn(h, hd):
        return jx.lp.hidden_to_token_logprobs(h, hd, labels, softcap=softcap,
                                              true_vocab=true_vocab)

    ref = jfn(hidden, head)
    jgrads = jx.jax.grad(lambda h, hd: (jfn(h, hd) * w).sum(),
                         argnums=(0, 1))(hidden, head)
    th = torch.from_numpy(hidden).requires_grad_(True)
    thd = torch.from_numpy(head).requires_grad_(True)
    got = tlp.hidden_to_token_logprobs(th, thd, torch.from_numpy(labels),
                                       softcap=softcap, true_vocab=true_vocab)
    assert got.shape == (2, 300)
    _close(got, ref, 1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    _close(th.grad, jgrads[0], 1e-5)
    _close(thd.grad, jgrads[1], 1e-5)


def _pref_inputs(b=3, t=7, seed=2):
    rng = np.random.default_rng(seed)
    logp = -np.abs(rng.standard_normal((2 * b, t))).astype(np.float32)
    ref_logp = -np.abs(rng.standard_normal((2 * b, t))).astype(np.float32)
    mask = (rng.random((2 * b, t)) > 0.3).astype(np.float32)
    mask[:, 0] = 1
    ids = rng.integers(0, 50, size=(2 * b, t + 1))
    lengths = mask.sum(-1) + 1
    weight = np.array([1, 0, 1], np.float32)
    logits = rng.standard_normal((2 * b, t + 1, 50)).astype(np.float32)
    return dict(logp=logp, ref_logp=ref_logp, mask=mask, ids=ids,
                lengths=lengths, weight=weight, logits=logits)


def _calls(lib, a):
    """name -> thunk calling ``lib``'s loss on the arrays ``a``."""
    return {
        'sequence_logprobs': lambda: {'out': lib.sequence_logprobs(
            a['logits'], a['ids'], a['mask'])},
        'bradley_terry': lambda: lib.bradley_terry_loss(
            a['logp'][:, 0], a['ref_logp'][:, 0], regularization=0.1),
        'dpo': lambda: lib.dpo_loss(a['logp'], a['ref_logp'], a['ids'],
                                    a['mask'], scale_coeff=0.1),
        'kto': lambda: lib.kto_loss(a['logp'], a['ref_logp'], a['mask'],
                                    a['kl'], 0.1, 1.0, 1.3),
        'kto_weighted': lambda: lib.kto_loss(
            a['logp'], a['ref_logp'], a['mask'], a['kl'], 0.1, 1.0, 1.3,
            sample_weight=a['weight']),
        'unmatched_kl': lambda: {'out': lib.unmatched_kl_estimate(
            a['logp'], a['ref_logp'], a['mask'])},
        'orpo': lambda: lib.orpo_loss(a['logp'], a['ids'], a['mask'],
                                      a['lengths'], 0.2),
        'orpo_weighted': lambda: lib.orpo_loss(
            a['logp'], a['ids'], a['mask'], a['lengths'], 0.2,
            sample_weight=a['weight']),
        'simpo': lambda: lib.simpo_loss(a['logp'], a['mask'], a['lengths'],
                                        2.0, 0.5),
        'simpo_weighted': lambda: lib.simpo_loss(
            a['logp'], a['mask'], a['lengths'], 2.0, 0.5,
            sample_weight=a['weight']),
    }


@pytest.mark.parametrize('name', list(_calls(None, {})))
def test_preference_losses_match_jax(jx, name):
    a = _pref_inputs()
    ja = {k: jx.jnp.asarray(v) for k, v in a.items()}
    ta = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    ja['kl'] = jx.l.unmatched_kl_estimate(ja['logp'], ja['ref_logp'],
                                          ja['mask'])
    ta['kl'] = tl.unmatched_kl_estimate(ta['logp'], ta['ref_logp'],
                                        ta['mask'])
    ref = _calls(jx.l, ja)[name]()
    got = _calls(tl, ta)[name]()
    assert set(got) == set(ref)
    for key in ref:
        _close(got[key], ref[key], 1e-6)


def test_dpo_gradient_flows_only_through_the_policy():
    a = _pref_inputs()
    logp = torch.from_numpy(a['logp']).requires_grad_(True)
    out = tl.dpo_loss(logp, torch.from_numpy(a['ref_logp']),
                      torch.from_numpy(a['ids']), torch.from_numpy(a['mask']),
                      scale_coeff=0.1)
    out['loss'].backward()
    assert logp.grad is not None and float(logp.grad.abs().sum()) > 0
    assert not out['reward'].requires_grad


@pytest.mark.parametrize('kind,warmup', [('constant', 0.0), ('linear', 0.0),
                                         ('cosine', 0.0), ('linear', 0.3),
                                         ('cosine', 0.25)])
def test_schedules_match_optax(jx, kind, warmup):
    ref = jx.opt.make_schedule(3e-4, kind, 20, warmup)
    got = topt.make_schedule(3e-4, kind, 20, warmup)
    for t in range(0, 24):
        # optax evaluates in fp32: 1e-6 of the peak rate
        np.testing.assert_allclose(got(t), float(ref(t)), rtol=1e-6,
                                   atol=1e-6 * 3e-4)


@pytest.mark.parametrize('max_grad_norm', [0.0, 0.5])
def test_optimizer_matches_optax(jx, max_grad_norm):
    """Three updates with warmup + cosine, weight decay and (at 0.5) a clip
    that bites, from the same gradients."""
    rng = np.random.default_rng(3)
    params = {'a': rng.standard_normal((4, 5)).astype(np.float32),
              'b': {'w': rng.standard_normal((7,)).astype(np.float32)}}
    grads = [{'a': rng.standard_normal((4, 5)).astype(np.float32) * 0.3,
              'b': {'w': rng.standard_normal((7,)).astype(np.float32)}}
             for _ in range(3)]
    kw = dict(lr_scheduler_type='cosine', total_steps=4, lr_warmup_ratio=0.25,
              weight_decay=0.1, adam_betas=(0.9, 0.95), adam_epsilon=1e-8,
              max_grad_norm=max_grad_norm)
    jtx, _ = jx.opt.make_optimizer(1e-2, **kw)
    jp = jx.jax.tree.map(jx.jnp.asarray, params)
    state = jtx.init(jp)
    for g in grads:
        updates, state = jtx.update(g, state, jp)
        jp = jx.optax.apply_updates(jp, updates)

    ttx, schedule = topt.make_optimizer(1e-2, **kw)
    tp = {'a': torch.from_numpy(params['a']).requires_grad_(True),
          'b': {'w': torch.from_numpy(params['b']['w']).requires_grad_(True)}}
    opt = ttx.init(tp)
    for step, g in enumerate(grads):
        tp['a'].grad = torch.from_numpy(g['a'].copy())
        tp['b']['w'].grad = torch.from_numpy(g['b']['w'].copy())
        norm = ttx.apply_(opt, step)
        ref_norm = float(jx.optax.global_norm(g))
        np.testing.assert_allclose(float(norm), ref_norm, rtol=1e-6)
    assert schedule(0) == 0.0              # optax: update t uses schedule(t)
    _close(tp['a'], jp['a'], 1e-6)
    _close(tp['b']['w'], jp['b']['w'], 1e-6)


@pytest.mark.parametrize('option', [dict(frozen_labels={})])
def test_optimizer_options_not_ported_raise(option):
    """Every option of the JAX ``make_optimizer`` is ported now
    (``frozen_labels`` with the multimodal slice; its parity is in
    ``tests/test_torch_ti2t_trainers.py``): the optimizer builds, and a
    label tree that does not match the params raises when it is applied."""
    tx, _ = topt.make_optimizer(1e-3, **option)
    with pytest.raises(ValueError, match='frozen_labels'):
        tx.init({'a': torch.zeros(2)})


@pytest.mark.parametrize('max_grad_norm', [0.0, 0.5])
def test_gradient_accumulation_matches_multisteps(jx, max_grad_norm):
    """``gradient_accumulation_steps=2`` over four micro-steps against
    ``optax.MultiSteps`` around the whole chain: the params can move only on
    the second and fourth call, by clip + AdamW on the mean of two
    gradients, at ``schedule(update count)``; to 1e-6 (fp32)."""
    rng = np.random.default_rng(5)
    params = {'a': rng.standard_normal((4, 5)).astype(np.float32),
              'b': {'w': rng.standard_normal((7,)).astype(np.float32)}}
    grads = [{'a': rng.standard_normal((4, 5)).astype(np.float32) * 0.3,
              'b': {'w': rng.standard_normal((7,)).astype(np.float32)}}
             for _ in range(4)]
    kw = dict(lr_scheduler_type='linear', total_steps=4, lr_warmup_ratio=0.25,
              weight_decay=0.1, adam_betas=(0.9, 0.95), adam_epsilon=1e-8,
              max_grad_norm=max_grad_norm, gradient_accumulation_steps=2)
    jtx, _ = jx.opt.make_optimizer(1e-2, **kw)
    jp = jx.jax.tree.map(jx.jnp.asarray, params)
    state = jtx.init(jp)
    ttx, _ = topt.make_optimizer(1e-2, **kw)
    assert isinstance(ttx, topt.MultiSteps)
    tp = {'a': torch.from_numpy(params['a'].copy()).requires_grad_(True),
          'b': {'w': torch.from_numpy(params['b']['w'].copy())
                .requires_grad_(True)}}
    opt = ttx.init(tp)
    for step, g in enumerate(grads):
        updates, state = jtx.update(g, state, jp)
        jp = jx.optax.apply_updates(jp, updates)
        tp['a'].grad = torch.from_numpy(g['a'].copy())
        tp['b']['w'].grad = torch.from_numpy(g['b']['w'].copy())
        before = tp['a'].detach().clone()
        ttx.apply_(opt, step)
        if step % 2 == 0:                  # between updates: no move
            assert torch.equal(before, tp['a'].detach())
        _close(tp['a'], jp['a'], 1e-6)
        _close(tp['b']['w'], jp['b']['w'], 1e-6)
    # update 0 ran at schedule(0) = 0 (warmup); update 1 moved the params
    assert not np.allclose(tp['a'].detach().numpy(), params['a'])
    assert (opt.updates, opt.mini_step) == (2, 0)
