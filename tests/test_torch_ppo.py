"""The port's PPO-family pieces against the JAX package's, on inputs made
from a seed with numpy, fp32 on the CPU: every function of
``losses/ppo.py`` (the advantage estimators among them), the new helpers
of ``utils/tools.py``, ``models/score_model.py`` and the prompt-only
dataset and collator.

Tolerances: 1e-6 for the losses, estimators and helpers (the same fp32
formulas; GAE's reversed loop and the JAX reversed scan add in the same
order); 1e-5 for the score model (fp32 matmuls summed in another order),
compared under the attention mask only: a left-pad query row sees no key,
and the port's attention (the flash kernel's plain version on the CPU)
gives it zeros where the JAX package's XLA path at L < 1024 averages V
over the masked keys; no real token reads those rows.  Integer outputs
(indices, token ids, masks) exactly.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch import losses as tl  # noqa: E402
from align_anything_tpu_torch.data import datasets as tds  # noqa: E402
from align_anything_tpu_torch.data.chat_template import (  # noqa: E402
    ChatTemplate,
)
from align_anything_tpu_torch.data.tokenizer import (  # noqa: E402
    HashTokenizer,
)
from align_anything_tpu_torch.models import score_model as tsm  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.config import tiny_config  # noqa: E402
from align_anything_tpu_torch.utils import tools as tt  # noqa: E402

from test_torch_int4_matmul import np_tree  # noqa: E402

TOL = 1e-6
MODEL_TOL = 1e-5
B, L, START = 4, 12, 5
CFG = dict(vocab_size=128, hidden=64, layers=2, heads=4, kv_heads=2,
           mlp=128)


@pytest.fixture(scope='module')
def jx():
    jax = pytest.importorskip('jax')

    from align_anything_tpu.data import datasets as jds
    from align_anything_tpu.data.chat_template import ChatTemplate as JTpl
    from align_anything_tpu.data.tokenizer import HashTokenizer as JHash
    from align_anything_tpu.losses import ppo as jl
    from align_anything_tpu.models import config as jc
    from align_anything_tpu.models import score_model as jsm
    from align_anything_tpu.utils import tools as jt

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, l=jl, t=jt, c=jc,
                                 sm=jsm, ds=jds, Tpl=JTpl, Hash=JHash)


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if hasattr(got, 'detach') else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rollout(seed=0, b=B, length=L):
    """(B, L) values, rewards, log-probs, ref log-probs and a sequence
    mask whose rows end at different places (one row's completion is a
    single token, one row runs to the end)."""
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((b, length)).astype(np.float32)
    rewards = rng.standard_normal((b, length)).astype(np.float32)
    logp = (-rng.random((b, length)) * 3).astype(np.float32)
    ref = (logp + rng.standard_normal((b, length)) * 0.1).astype(np.float32)
    ends = [START + 1, length, *rng.integers(START + 2, length, b - 2)]
    mask = np.zeros((b, length), np.float32)
    for r, e in enumerate(ends):
        mask[r, :e] = 1.0
    return values, rewards, logp, ref, mask


@pytest.mark.parametrize('gamma,lam', [(1.0, 0.95), (0.9, 1.0)])
def test_gae_matches_jax(jx, gamma, lam):
    values, rewards, _, _, mask = _rollout(0)
    adv, ret = jx.l.gae_advantages(values, rewards, mask, START, gamma, lam)
    tadv, tret = tl.gae_advantages(_t(values), _t(rewards), _t(mask), START,
                                   gamma, lam)
    assert tadv.shape == (B, L - START)
    _close(tadv, adv)
    _close(tret, ret)


def test_ppo_actor_and_critic_losses_match_jax(jx):
    rng = np.random.default_rng(1)
    values, rewards, logp, old, mask = _rollout(1)
    adv = rng.standard_normal((B, L)).astype(np.float32)
    # ratios beyond both clip edges
    logp = old + rng.uniform(-0.6, 0.6, (B, L)).astype(np.float32)
    _close(tl.ppo_actor_loss(_t(logp), _t(old), _t(adv), _t(mask), 0.2),
           jx.l.ppo_actor_loss(logp, old, adv, mask, 0.2))
    old_v = values + rng.uniform(-8, 8, (B, L)).astype(np.float32)
    _close(tl.ppo_critic_loss(_t(values), _t(old_v), _t(rewards), _t(mask),
                              5.0),
           jx.l.ppo_critic_loss(values, old_v, rewards, mask, 5.0))
    # gradients with respect to log-probs and values
    jg = jx.jax.grad(lambda lp, v: jx.l.ppo_actor_loss(lp, old, adv, mask,
                                                       0.2)
                     + jx.l.ppo_critic_loss(v, old_v, rewards, mask, 5.0),
                     argnums=(0, 1))(logp, values)
    tlp = _t(logp).requires_grad_(True)
    tv = _t(values).requires_grad_(True)
    (tl.ppo_actor_loss(tlp, _t(old), _t(adv), _t(mask), 0.2)
     + tl.ppo_critic_loss(tv, _t(old_v), _t(rewards), _t(mask), 5.0)
     ).backward()
    _close(tlp.grad, jg[0])
    _close(tv.grad, jg[1])


def test_kl_regularization_matches_jax(jx):
    """The reward lands on each row's last real token; clipped to +-5 so
    that the clip binds."""
    rng = np.random.default_rng(2)
    _, _, logp, ref, mask = _rollout(2)
    reward = (rng.standard_normal(B) * 4).astype(np.float32)
    want = jx.l.add_kl_divergence_regularization(reward, logp, ref, mask,
                                                 0.05, 5.0)
    got = tl.add_kl_divergence_regularization(_t(reward), _t(logp), _t(ref),
                                              _t(mask), 0.05, 5.0)
    _close(got, want)
    assert float(np.abs(np.asarray(want)).max()) == 5.0


@pytest.mark.parametrize('gamma', [1.0, 0.8])
def test_cumulative_returns_match_jax(jx, gamma):
    _, rewards, _, _, mask = _rollout(3)
    _close(tl.cumulative_returns(_t(rewards), _t(mask), START, gamma),
           jx.l.cumulative_returns(rewards, mask, START, gamma))


@pytest.mark.parametrize('estimator', ['rloo', 'reinforce_baseline',
                                       'group_norm'])
def test_group_relative_rewards_match_jax(jx, estimator):
    _, rewards, _, _, _ = _rollout(4, b=6)
    _close(tl.group_relative_rewards(_t(rewards), 3, estimator),
           jx.l.group_relative_rewards(rewards, 3, estimator), 1e-5)


def test_group_relative_rewards_unknown_raises():
    with pytest.raises(ValueError, match='unknown group estimator'):
        tl.group_relative_rewards(torch.zeros(4, 3), 2, 'median')


def _advantages(l, estimator, values, logp, ref, reward, mask, n):
    """PPOTrainer.rl_step's estimator switch, written once for either
    package's losses."""
    shaped = l.add_kl_divergence_regularization(reward, logp, ref, mask,
                                                0.02, 50.0)
    if estimator == 'gae':
        return l.gae_advantages(values, shaped, mask, START, 1.0, 0.95)
    if estimator != 'reinforce':
        shaped = l.group_relative_rewards(shaped, n, estimator)
    returns = l.cumulative_returns(shaped, mask, START, 1.0) * mask[:, START:]
    return returns, returns


@pytest.mark.parametrize('estimator', ['gae', 'reinforce', 'rloo',
                                       'reinforce_baseline', 'group_norm'])
def test_advantage_estimators_match_jax(jx, estimator):
    """Every estimator of the PPO trainers, from KL shaping to
    (advantages, returns), over 3 prompts x 2 samples."""
    values, _, logp, ref, mask = _rollout(5, b=6)
    reward = np.random.default_rng(5).standard_normal(6).astype(np.float32)
    want = _advantages(jx.l, estimator, values, logp, ref, reward, mask, 2)
    got = _advantages(tl, estimator, _t(values), _t(logp), _t(ref),
                      _t(reward), _t(mask), 2)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_grpo_matches_jax(jx):
    rng = np.random.default_rng(6)
    rewards = rng.standard_normal(8).astype(np.float32)
    _close(tl.grpo_group_advantages(_t(rewards), 4),
           jx.l.grpo_group_advantages(rewards, 4))
    logp = (-rng.random((8, 6)) * 2).astype(np.float32)
    ref = (logp + rng.standard_normal((8, 6)) * 0.2).astype(np.float32)
    adv = rng.standard_normal(8).astype(np.float32)
    cmask = (rng.random((8, 6)) > 0.3).astype(np.float32)
    want = jx.l.grpo_loss(logp, ref, adv, cmask, 0.04)
    jgrad = jx.jax.grad(lambda x: jx.l.grpo_loss(x, ref, adv, cmask,
                                                 0.04)['loss'])(logp)
    tlp = _t(logp).requires_grad_(True)
    got = tl.grpo_loss(tlp, _t(ref), _t(adv), _t(cmask), 0.04)
    got['loss'].backward()
    _close(got['loss'], want['loss'])
    _close(got['kl'], want['kl'])
    _close(tlp.grad, jgrad)


# ---------------------------------------------------------------------------
# utils/tools.py
# ---------------------------------------------------------------------------

def test_masked_means_and_true_indices_match_jax(jx):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 9)).astype(np.float32)
    mask = rng.random((4, 9)) > 0.5
    mask[1] = False                    # an all-masked row contributes 0
    mask[2, -1] = True
    m = mask.astype(np.float32)
    _close(tt.masked_mean(_t(x), _t(m)), jx.t.masked_mean(x, m))
    _close(tt.masked_mean(_t(x)), jx.t.masked_mean(x))
    _close(tt.masked_mean_global(_t(x), _t(m)),
           jx.t.masked_mean_global(x, m))
    for fn in ('first_true_index', 'last_true_index'):
        got = getattr(tt, fn)(_t(mask))
        want = getattr(jx.t, fn)(mask)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), fn)
    np.testing.assert_array_equal(
        tt.first_true_index(_t(mask), dim=0).numpy(),
        np.asarray(jx.t.first_true_index(mask, axis=0)))


def test_host_helpers_match_jax(jx):
    seqs = [np.arange(n, dtype=np.int32) + 1 for n in (3, 7, 1)]
    for total in (None, 5):
        np.testing.assert_array_equal(
            tt.right_padding(seqs, -1, total_length=total),
            jx.t.right_padding(seqs, -1, total_length=total))
    texts = ['USER: hi ASSISTANT: yo', 'USER: a b ASSISTANT: c ASSISTANT: d']
    assert tt.split_prompt_response(texts, 'ASSISTANT:') == \
        jx.t.split_prompt_response(texts, 'ASSISTANT:')


def _word_level_tokenizer(corpus):
    transformers = pytest.importorskip('transformers')
    tokenizers = pytest.importorskip('tokenizers')

    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(unk_token='<unk>'))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.train_from_iterator(corpus, tokenizers.trainers.WordLevelTrainer(
        special_tokens=['<unk>', '<pad>', '</s>']))
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token='<unk>', pad_token='<pad>',
        eos_token='</s>')


def test_batch_retokenize_matches_jax(jx):
    """Across two word-level tokenizers with different vocabularies (the
    reward model's own tokenizer), and between two HashTokenizers."""
    corpus = ['name a red thing', 'name a blue thing', 'gold green 1 2 3']
    src = _word_level_tokenizer(corpus)
    dest = _word_level_tokenizer([s.upper() for s in corpus]
                                 + ['extra vocab', 'name a red thing'])
    assert not tt.is_same_tokenizer(src, dest)
    assert tt.is_same_tokenizer(src, src)
    assert tt.is_same_tokenizer(src, _word_level_tokenizer(corpus))
    assert not jx.t.is_same_tokenizer(src, dest)
    pad = src.pad_token_id
    ids = tt.right_padding(
        [np.asarray(src('name a red thing')['input_ids'] + [src.eos_token_id]),
         np.asarray(src('gold 1 2 3 blue')['input_ids'])], pad,
        total_length=7)
    got = tt.batch_retokenize(ids, src, dest, total_length=9)
    want = jx.t.batch_retokenize(ids, src, dest, total_length=9)
    assert set(got) == set(want) == {'input_ids', 'attention_mask'}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])

    tsrc, tdest = HashTokenizer(256), HashTokenizer(512, add_bos=False)
    jsrc, jdest = jx.Hash(256), jx.Hash(512, add_bos=False)
    assert tt.is_same_tokenizer(tsrc, tdest)      # no vocab to compare
    texts = ['one two three', 'four five']
    tids = tt.right_padding([tsrc.encode(s) for s in texts], 0)
    jids = jx.t.right_padding([jsrc.encode(s) for s in texts], 0)
    np.testing.assert_array_equal(tids, jids)
    got = tt.batch_retokenize(tids, tsrc, tdest, total_length=8)
    want = jx.t.batch_retokenize(jids, jsrc, jdest, total_length=8)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# models/score_model.py
# ---------------------------------------------------------------------------

def _padded_batch(seed, b=4, length=24):
    """Rows 0-1 left-padded (a prompt block), rows 2-3 right-padded, one of
    each by a single pad."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, CFG['vocab_size'], size=(b, length))
    mask = np.ones((b, length), np.int32)
    mask[0, :7] = 0
    mask[1, :1] = 0
    mask[2, length - 9:] = 0
    mask[3, length - 1:] = 0
    ids[mask == 0] = 0
    return ids, mask


def test_score_model_forward_matches_jax(jx):
    jcfg = jx.c.tiny_config(**CFG).replace(compute_dtype='float32')
    cfg = tiny_config(**CFG).replace(compute_dtype='float32')
    jparams = jx.sm.init_params(jcfg, jx.jax.random.PRNGKey(0))
    params = from_jax_tree(np_tree(jparams), device='cpu')
    ids, mask = _padded_batch(8)
    # compiled: the eager op-by-op trace took most of the test's time
    fwd = jx.jax.jit(jx.sm.forward, static_argnums=1)
    want = fwd(jparams, jcfg, ids, attention_mask=mask)
    got = tsm.forward(params, cfg, _t(ids), attention_mask=_t(mask))
    assert got.scores.shape == (4, 24, 1) and got.scores.dtype == torch.float32
    assert bool(torch.isfinite(got.scores).all())
    keep = mask.astype(bool)
    _close(got.scores.numpy()[keep], np.asarray(want.scores)[keep],
           MODEL_TOL)
    _close(got.end_scores, want.end_scores, MODEL_TOL)
    np.testing.assert_array_equal(got.end_index.numpy(),
                                  np.asarray(want.end_index))
    assert got.end_index.tolist() == [23, 23, 14, 22]
    # no mask: the last position
    want = fwd(jparams, jcfg, ids[:, :10])
    got = tsm.forward(params, cfg, _t(ids[:, :10]))
    _close(got.end_scores, want.end_scores, MODEL_TOL)
    assert got.end_index.tolist() == [9] * 4


def test_score_model_init_params():
    cfg = tiny_config(**CFG)
    params = tsm.init_params(cfg, torch.Generator().manual_seed(0),
                             score_dim=2, device='cpu')
    assert params['score_head']['w'].shape == (64, 2)
    assert params['score_head']['w'].dtype == torch.float32
    assert 'lm_head' in params and 'layers' in params


def test_load_score_head_round_trip(jx, tmp_path):
    """``score_head.npy`` beside a slice is read back as it was written, by
    both packages; without it (or without a path) the head is fresh."""
    head = np.random.default_rng(9).standard_normal((64, 1)).astype(
        np.float32)
    np.save(tmp_path / 'score_head.npy', head)
    got = tsm.load_score_head(str(tmp_path), 64,
                              torch.Generator().manual_seed(0), device='cpu')
    want = jx.sm.load_score_head(str(tmp_path), 64,
                                 jx.jax.random.PRNGKey(0))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), head)
    np.testing.assert_array_equal(np.asarray(want), head)
    for path in (None, str(tmp_path / 'missing')):
        fresh = tsm.load_score_head(path, 64,
                                    torch.Generator().manual_seed(0),
                                    score_dim=3, device='cpu')
        assert fresh.shape == (64, 3)
        assert 0.05 < float(fresh.std()) < 0.25         # 1 / sqrt(64)


# ---------------------------------------------------------------------------
# data: the prompt-only set
# ---------------------------------------------------------------------------

def test_prompt_only_data_matches_jax(jx):
    """Deduplicated prompts, EOS stripped, left-padded to the bucket (and
    truncated from the left when longer)."""
    rng = np.random.default_rng(10)
    words = ['red', 'blue', 'green', 'gold', 'tea']
    rows = [{'prompt': ' '.join(words[int(i)] for i in
                                rng.integers(0, 5, int(rng.integers(1, 12)))),
             'response_0': 'a', 'response_1': 'b', 'better_response_id': 0}
            for _ in range(9)]
    rows.append(dict(rows[2]))                        # a duplicate
    tok, jtok = HashTokenizer(256), jx.Hash(256)
    ds = tds.PromptOnlyDataset('', ChatTemplate(tok, 'PKUSafeRLHF'), tok,
                               raw_data=rows)
    jds = jx.ds.PromptOnlyDataset('', jx.Tpl(jtok, 'PKUSafeRLHF'), jtok,
                                  raw_data=rows)
    assert len(ds) == len(jds) == 9
    for i in range(len(ds)):
        assert ds[i]['input_ids'] == jds[i]['input_ids']
        assert ds[i]['input_ids'][-1] != tok.eos_token_id
    for buckets in ((16, 32), (8,)):
        got = ds.get_collator(buckets=buckets)([ds[i] for i in range(5)])
        want = jds.get_collator(buckets=buckets)([jds[i] for i in range(5)])
        for k in ('input_ids', 'attention_mask'):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert got['meta'] == want['meta']
        assert (got['attention_mask'][:, -1] == 1).all()   # left padded
