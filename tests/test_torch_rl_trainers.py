"""The port's reward-model and PPO trainers against the JAX package's,
driven the same way: configs parsed from the same command-line overrides,
a tiny Llama checkpoint on disk (built with ``transformers``), local
``.jsonl`` rows, fp32, on the CPU.

Global batch: the JAX trainers multiply every per-device batch size
(prompts, micro-batch, PTX, eval) by ``jax.device_count()``, 8 here
(``tests/conftest.py``); the port runs one device, so its runs take 8x the
JAX per-device sizes and both see the same batches in the same order.

The rollout is fixed: JAX's sampler and the port's cannot draw the same
tokens, so both trainers' ``generate`` (and the continuous engine's
``generate``) are patched to return one block built with numpy from a
seed: the collator's left-padded prompts of differing lengths, then
completions of differing lengths, each ending in EOS and then pad.
Greedy generation parity is held in ``tests/test_torch_generation.py``.

Heads: the RM trainers draw a fresh score head, from each package's own
generator, so both get the same numpy head before their first step; the
PPO reward and critic heads come from ``score_head.npy`` beside the
reward checkpoint, as in a real run.

Tolerances: metrics and parameters to 1e-5 (rtol and atol), as
``tests/test_torch_trainers.py`` (fp32 math summed in another order;
learning rates of 1e-4 make each Adam update 10x that); leaves that only
weight decay moves to 1e-6 relative (the same product, rounded once
more or less).  Round 1's ``train/kl_divergence`` is exactly 0 in the
port (actor and reference are equal fp32 trees through the same ops, one
CPU thread).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
pytest.importorskip('yaml')

from align_anything_tpu_torch import generation as tgen  # noqa: E402
from align_anything_tpu_torch.generation import continuous as tcont  # noqa: E402
from align_anything_tpu_torch.models.hf_loader import load_params  # noqa: E402
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_to_text import (  # noqa: E402
    cost_model as tcost,
    multi_ppo as tmulti,
    ppo as tppo,
    rm as trm,
    rm_score as tscore,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DEVICES = 8
TOL = 1e-5
DECAY_RTOL = 1e-6
NEW_TOKENS = 6
PAD, BOS, EOS = 0, 1, 2
WORDS = ['alpha', 'beta', 'gamma', 'delta', 'eps', 'zeta', 'eta', 'theta']


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return make_assets(tmp_path_factory.mktemp('rl_assets'))


def make_assets(d, layers: int = 2):
    """The tiny Llama checkpoint (``layers`` layers), the reward model
    beside it and the ``.jsonl`` rows, under the directory ``d``."""
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=layers, num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False,
        pad_token_id=PAD, bos_token_id=BOS, eos_token_id=EOS)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(
        d / 'model', safe_serialization=True)
    # the reward model: the same trunk with a trained-looking head beside it
    shutil.copytree(d / 'model', d / 'reward')
    rng = np.random.default_rng(0)
    np.save(d / 'reward' / 'score_head.npy',
            rng.standard_normal((64, 1)).astype(np.float32))

    def pick(k):
        return ' '.join(WORDS[j] for j in rng.integers(0, len(WORDS), size=k))

    with open(d / 'pref.jsonl', 'w') as f:
        for _ in range(32):
            f.write(json.dumps({
                'prompt': f'pick {pick(int(rng.integers(1, 4)))}',
                'response_0': pick(int(rng.integers(1, 8))),
                'response_1': pick(int(rng.integers(1, 8))),
                'better_response_id': int(rng.integers(0, 2))}) + '\n')
    # prompts of 1-9 words: left padding of differing lengths
    with open(d / 'prompts.jsonl', 'w') as f:
        for i in range(24):
            f.write(json.dumps({
                'prompt': f'{pick(int(rng.integers(1, 10)))} {i}',
                'response_0': 'a', 'response_1': 'b',
                'better_response_id': 0}) + '\n')
    with open(d / 'sft.jsonl', 'w') as f:
        for _ in range(16):
            f.write(json.dumps({'instruction': f'say {pick(2)}',
                                'input': pick(1),
                                'output': pick(int(rng.integers(1, 8)))})
                    + '\n')
    return d


@pytest.fixture()
def one_thread():
    """One CPU thread: torch's threaded reductions may differ in the last
    place between two identical passes, and the actor-vs-reference KL of
    round 1 must be exactly 0."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _completions(n: int, vocab_hi: int, pad: int) -> np.ndarray:
    """(n, NEW_TOKENS) completions: lengths 1..NEW_TOKENS, the last token
    EOS, then pad; the other tokens drawn from [3, vocab_hi)."""
    rng = np.random.default_rng(0)
    out = np.full((n, NEW_TOKENS), pad, np.int64)
    lengths = rng.integers(1, NEW_TOKENS + 1, size=n)
    lengths[0], lengths[-1] = 1, NEW_TOKENS
    for i, k in enumerate(lengths):
        out[i, :k - 1] = rng.integers(3, vocab_hi, size=k - 1)
        out[i, k - 1] = EOS
    return out


def _block(input_ids, attention_mask, vocab_hi, pad):
    comp = _completions(len(input_ids), vocab_hi, pad)
    ids = np.concatenate([np.asarray(input_ids, np.int64), comp], axis=1)
    mask = np.concatenate([np.asarray(attention_mask, np.int64),
                           (comp != pad).astype(np.int64)], axis=1)
    return ids, mask, comp


def _fix_rollouts(monkeypatch, vocab_hi=256, pad=PAD):
    """Patch both packages' batch and continuous rollouts (and the batch
    ``generate`` of the generation eval) to the numpy block."""
    import jax.numpy as jnp
    from align_anything_tpu import generation as jgen
    from align_anything_tpu.generation import continuous as jcont
    from align_anything_tpu.trainers.text_to_text import ppo as jppo

    def jax_generate(params, model_cfg, gen_cfg, input_ids, attention_mask,
                     *args, **kwargs):
        ids, mask, comp = _block(input_ids, attention_mask, vocab_hi, pad)
        return {'sequences': jnp.asarray(ids, jnp.int32),
                'attention_mask': jnp.asarray(mask, jnp.int32),
                'completions': jnp.asarray(comp, jnp.int32)}

    def torch_generate(params, model_cfg, gen_cfg, input_ids, attention_mask,
                       *args, **kwargs):
        ids, mask, comp = _block(input_ids.cpu().numpy(),
                                 attention_mask.cpu().numpy(), vocab_hi, pad)
        dev = input_ids.device
        return {'sequences': torch.as_tensor(ids, device=dev),
                'attention_mask': torch.as_tensor(mask, device=dev),
                'completions': torch.as_tensor(comp, device=dev)}

    def engine_generate(self, params, requests, gen_cfg, *args, **kwargs):
        comp = _completions(len(requests), vocab_hi, pad)
        return [[int(t) for t in row if t != pad] for row in comp]

    monkeypatch.setattr(jppo, 'generate', jax_generate)
    monkeypatch.setattr(jgen, 'generate', jax_generate)
    monkeypatch.setattr(tppo, 'generate', torch_generate)
    monkeypatch.setattr(tgen, 'generate', torch_generate)
    monkeypatch.setattr(jcont.ContinuousBatchingEngine, 'generate',
                        engine_generate)
    monkeypatch.setattr(tcont.ContinuousBatchingEngine, 'generate',
                        engine_generate)


def _scaled(argv: list, keys: tuple) -> list:
    """``argv`` with each of ``keys``' values multiplied by JAX_DEVICES."""
    out = list(argv)
    for i in range(0, len(out), 2):
        if out[i][2:] in keys:
            out[i + 1] = str(int(out[i + 1]) * JAX_DEVICES)
    return out


def one_compile(jtrainer):
    """``jtrainer``, a JAX trainer, with the optimizer moments of each of
    its train states placed as their params are placed.  JAX's init
    replicates the moments and its step returns them sharded like the
    params, so the jitted step would compile again at the second update;
    placed so up front, it compiles once.  No value changes."""
    import dataclasses as dc

    import jax
    from align_anything_tpu.trainers.base import TrainState

    keystr = jax.tree_util.keystr
    for name, state in list(vars(jtrainer).items()):
        if not isinstance(state, TrainState):
            continue
        placed = [(keystr(p), x.shape, x.sharding) for p, x in
                  jax.tree_util.tree_flatten_with_path(state.params)[0]
                  if hasattr(x, 'sharding')]
        placed.sort(key=lambda e: -len(e[0]))     # the longest suffix first

        def place(path, x, placed=placed):
            key = keystr(path)
            for suffix, shape, sharding in placed:
                if key.endswith(suffix) and getattr(x, 'shape', None) == shape:
                    return jax.device_put(x, sharding)
            return x

        setattr(jtrainer, name, dc.replace(
            state, opt_state=jax.tree_util.tree_map_with_path(
                place, state.opt_state)))
    return jtrainer


def _both(jax_cls, port_cls, task, argv, scaled_keys):
    """(JAX trainer, port trainer) built from the same overrides; the
    port's ``--output_dir`` gets a ``port`` subdirectory."""
    from align_anything_tpu.trainers import cli as jcli

    cfgs, pc = jcli.parse_cfgs(task, argv)
    jtrainer = one_compile(jax_cls(cfgs=cfgs, parallel_cfgs=pc))
    argv = _scaled(argv, scaled_keys)
    i = argv.index('--output_dir') + 1
    argv[i] = os.path.join(argv[i], 'port')
    cfgs, pc = tcli.parse_cfgs(task, argv)
    return jtrainer, port_cls(cfgs=cfgs, parallel_cfgs=pc, device='cpu')


def _compare(got, want, tol=TOL):
    assert len(got) == len(want) > 0
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(w) <= set(g), set(w) - set(g)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=tol, atol=tol,
                                       err_msg=f'step {step + 1} {key}')


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items()
                for p, leaf in _leaves(v, f'{prefix}/{k}').items()}
    if hasattr(tree, 'detach'):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _compare_trees(got, want, tol=TOL):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=tol, atol=tol,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# reward and cost models
# ---------------------------------------------------------------------------

def _rm_argv(assets, out, extra=()):
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / 'pref.jsonl'),
            '--train_template', 'PKUSafeRLHF', '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[32]', '--save_checkpoint', 'False',
            '--per_device_train_batch_size', '1', *extra]


def _same_head(jtrainer, trainer, seed=1):
    import jax.numpy as jnp

    head = np.random.default_rng(seed).standard_normal((64, 1)).astype(
        np.float32) / 8
    jtrainer.state = dataclasses.replace(jtrainer.state, params=dict(
        jtrainer.state.params, score_head={'w': jnp.asarray(head)}))
    with torch.no_grad():
        trainer.state.params['score_head']['w'].copy_(torch.from_numpy(head))


def _steps(trainer, n=None):
    batches = list(trainer.train_iterator.epoch_batches(0))[:n]
    return [{k: float(v) for k, v in trainer.train_step(b).items()}
            for b in batches]


@pytest.mark.parametrize('weight_decay', ['0.0', '1.0'])
def test_rm_trainer_matches_jax(assets, tmp_path, weight_decay):
    """Every step (global batch 8), every metric; the exported
    slices and ``score_head.npy`` leaf for leaf.  The trunk's ``lm_head`` is
    never read: it gets a zero gradient, so at ``weight_decay > 0`` AdamW's
    decay alone moves it, by (1 - lr * wd) a step, in both packages."""
    from align_anything_tpu.trainers.text_to_text.rm import RMTrainer

    extra = ('--weight_decay', weight_decay)
    jtrainer, trainer = _both(
        RMTrainer, trm.RMTrainer, 'text_to_text/rm',
        _rm_argv(assets, tmp_path, extra),
        ('per_device_train_batch_size',))
    _same_head(jtrainer, trainer)
    lm_head = trainer.state.params['lm_head'].detach().clone().numpy()
    want, got = _steps(jtrainer), _steps(trainer)
    n = len(got)
    assert n >= 3          # 32 rows less the pairs with equal responses
    _compare(got, want)
    assert got[0]['train/loss'] != got[-1]['train/loss']

    jtrainer.save(tag=n)
    trainer.save(tag=n)
    jslice, slice_ = tmp_path / f'slice_{n}', tmp_path / 'port' / f'slice_{n}'
    params, _ = load_params(str(slice_), device='cpu')
    assert 'score_head' not in params and 'lm_head' in params
    # the port's export against the JAX trainer's params, not against its
    # export: the JAX save_params writes transposed leaves in their memory
    # order (ROADMAP R8)
    jparams = {k: v for k, v in jtrainer.state.params.items()
               if k != 'score_head'}
    _compare_trees(params, jparams)
    np.testing.assert_allclose(np.load(slice_ / 'score_head.npy'),
                               np.load(jslice / 'score_head.npy'),
                               rtol=TOL, atol=TOL)
    decay = (1 - 1e-4 * float(weight_decay)) ** n
    for head in (params['lm_head'].numpy(), np.asarray(jparams['lm_head'])):
        np.testing.assert_allclose(head, lm_head * decay, rtol=DECAY_RTOL)
    if float(weight_decay):
        assert not np.allclose(params['lm_head'].numpy(), lm_head,
                               rtol=1e-4, atol=0)


def test_cost_model_trainer_matches_jax(assets, tmp_path):
    """The reversed comparison: 2 steps, every metric, and eval accuracy."""
    from align_anything_tpu.trainers.text_to_text.cost_model import (
        CostModelTrainer,
    )

    extra = ('--eval_datasets', str(assets / 'pref.jsonl'),
             '--per_device_eval_batch_size', '2')
    jtrainer, trainer = _both(
        CostModelTrainer, tcost.CostModelTrainer, 'text_to_text/rm',
        _rm_argv(assets, tmp_path, extra),
        ('per_device_train_batch_size', 'per_device_eval_batch_size'))
    _same_head(jtrainer, trainer)
    want, got = _steps(jtrainer, 2), _steps(trainer, 2)
    _compare(got, want)
    _compare([trainer.eval()], [jtrainer.eval()])


def test_rm_score_matches_jax(assets, tmp_path):
    """``scores.jsonl`` over 16 supervised rows from the reward checkpoint
    and its ``score_head.npy``: the same texts, the same scores."""
    from align_anything_tpu.trainers.text_to_text.rm_score import (
        RMScoreTrainer,
    )

    def argv(out):
        return ['--model_name_or_path', str(assets / 'reward'),
                '--train_datasets', str(assets / 'sft.jsonl'),
                '--train_template', 'Alpaca', '--output_dir', str(out),
                '--bf16', 'False', '--padding_buckets', '[32]',
                '--per_device_eval_batch_size', '1']

    from align_anything_tpu.trainers import cli as jcli

    cfgs, pc = jcli.parse_cfgs('text_to_text/rm', argv(tmp_path / 'jax'))
    RMScoreTrainer(cfgs=cfgs, parallel_cfgs=pc).train()
    trainer = tcli.trainer_main(
        tscore.RMScoreTrainer, 'text_to_text/rm',
        _scaled(argv(tmp_path / 'port'), ('per_device_eval_batch_size',)),
        device='cpu')
    assert trainer.global_step == 0
    rows = [[json.loads(line) for line in open(tmp_path / d / 'scores.jsonl')]
            for d in ('port', 'jax')]
    assert len(rows[0]) == len(rows[1]) == 16
    assert [r['text'] for r in rows[0]] == [r['text'] for r in rows[1]]
    np.testing.assert_allclose([r['score'] for r in rows[0]],
                               [r['score'] for r in rows[1]],
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

PPO_SCALED = ('per_device_prompt_batch_size', 'per_device_train_batch_size',
              'per_device_eval_batch_size')


def _ppo_argv(assets, out, actor='model', reward='reward', extra=()):
    return ['--actor_model_name_or_path', str(assets / actor),
            '--reward_model_name_or_path', str(assets / reward),
            '--train_datasets', str(assets / 'prompts.jsonl'),
            '--train_template', 'PKUSafeRLHF', '--output_dir', str(out),
            '--epochs', '1', '--max_new_tokens', str(NEW_TOKENS),
            '--bf16', 'False', '--padding_buckets', '[16]',
            '--save_checkpoint', 'False', '--actor_lr', '1e-4',
            '--critic_lr', '1e-4', '--critic_weight_decay', '0.01',
            '--per_device_prompt_batch_size', '2',
            '--per_device_train_batch_size', '1', *extra]


def _ppo_round(jtrainer, trainer):
    """One round (16 prompts, 2 micro-batches of 8) through each trainer's
    ``train_step``, on the same prompt batch."""
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    np.testing.assert_array_equal(batch['input_ids'], jbatch['input_ids'])
    lengths = batch['attention_mask'].sum(-1)
    assert batch['input_ids'].shape == (16, 16) and len(set(lengths)) > 3
    if trainer.ptx_iterator is not None:
        for t in (jtrainer, trainer):
            t._ptx_cycle = iter(t.ptx_iterator.epoch_batches(0))
    want = jtrainer.train_step(jbatch)
    got = trainer.train_step(batch)
    return got, {k: float(v) for k, v in want.items()}


@pytest.mark.parametrize('case', ['batch', 'continuous', 'batch_ptx_eval'])
def test_ppo_round_matches_jax(assets, tmp_path, monkeypatch, one_thread,
                               case):
    """One PPO round against JAX's: every metric, and the actor and critic
    leaves after the update.  Round 1's KL is 0.  ``batch_ptx_eval`` adds
    a PTX step after each RL step and the generation eval (its table and
    ``eval/reward``)."""
    from align_anything_tpu.trainers.text_to_text.ppo import PPOTrainer

    _fix_rollouts(monkeypatch)
    extra = {'batch': (),
             'continuous': ('--rollout_backend', 'continuous',
                            '--rollout_num_slots', '4'),
             'batch_ptx_eval': ('--ptx_datasets', str(assets / 'sft.jsonl'),
                                '--ptx_template', 'Alpaca',
                                '--eval_datasets',
                                str(assets / 'prompts.jsonl'),
                                '--eval_size', '8',
                                '--per_device_eval_batch_size', '1')}[case]
    jtrainer, trainer = _both(PPOTrainer, tppo.PPOTrainer, 'text_to_text/ppo',
                              _ppo_argv(assets, tmp_path, extra=extra),
                              PPO_SCALED)
    assert trainer.rollout_backend == case.split('_')[0]
    actor0 = {p: v.copy()
              for p, v in _leaves(trainer.actor_state.params).items()}
    got, want = _ppo_round(jtrainer, trainer)
    assert got['train/kl_divergence'] == 0.0
    assert abs(want['train/kl_divergence']) <= TOL
    _compare([got], [want])
    assert got['perf/generated_tokens'] > 0
    _compare_trees(trainer.actor_state.params, jtrainer.actor_state.params)
    _compare_trees(trainer.critic_state.params, jtrainer.critic_state.params)
    moved = max(float(np.abs(v - actor0[p]).max())
                for p, v in _leaves(trainer.actor_state.params).items())
    assert 5e-5 < moved < 1e-3
    assert trainer.actor_state.step == jtrainer.actor_state.step
    if case == 'batch_ptx_eval':
        assert 'train/ptx_loss' in got
        _compare([trainer.eval()], [jtrainer.eval()])


def test_ppo_distinct_reward_tokenizer(assets, tmp_path, monkeypatch,
                                       one_thread):
    """A reward model with its own tokenizer: rollouts are re-tokenized on
    the host before reward scoring (``batch_retokenize``), in both
    packages alike."""
    from align_anything_tpu.trainers.text_to_text.ppo import PPOTrainer

    from test_torch_ppo import _word_level_tokenizer

    corpus = [' '.join(WORDS), 'pick a red thing', '1 2 3 4 5 6 7 8 9 0']
    tok_a = _word_level_tokenizer(corpus)
    tok_b = _word_level_tokenizer([s.upper() for s in corpus]
                                  + ['extra vocab'])
    for name, tok in (('actor_tok', tok_a), ('reward_tok', tok_b)):
        cfg = transformers.Qwen2Config(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, tie_word_embeddings=True,
            pad_token_id=tok.pad_token_id, eos_token_id=tok.eos_token_id)
        torch.manual_seed(1)
        transformers.Qwen2ForCausalLM(cfg).eval().save_pretrained(
            assets / name, safe_serialization=True)
        tok.save_pretrained(assets / name)
    np.save(assets / 'reward_tok' / 'score_head.npy',
            np.random.default_rng(2).standard_normal((32, 1)).astype(
                np.float32))
    assert (tok_a.pad_token_id, tok_a.eos_token_id) == (PAD + 1, EOS)
    _fix_rollouts(monkeypatch, vocab_hi=len(tok_a), pad=tok_a.pad_token_id)
    jtrainer, trainer = _both(
        PPOTrainer, tppo.PPOTrainer, 'text_to_text/ppo',
        _ppo_argv(assets, tmp_path, 'actor_tok', 'reward_tok'), PPO_SCALED)
    assert trainer.reward_tokenizer is not trainer.tokenizer
    assert jtrainer.reward_tokenizer is not jtrainer.tokenizer
    got, want = _ppo_round(jtrainer, trainer)
    assert got['train/kl_divergence'] == 0.0
    _compare([got], [want])


def _estimator_env(monkeypatch, n_samples: int, estimator: str) -> None:
    """Neither key is in ppo.yaml, and a command-line override adds no key
    (ROADMAP R9): the environment overrides are what reaches them, in both
    packages."""
    monkeypatch.setenv('ENV_PREFIX__TRAIN_CFGS__N_SAMPLES_PER_PROMPT',
                       str(n_samples))
    monkeypatch.setenv('ENV_PREFIX__TRAIN_CFGS__ADVANTAGE_ESTIMATOR',
                       estimator)


def test_multi_ppo_rloo_matches_jax(assets, tmp_path, monkeypatch,
                                    one_thread):
    """``n_samples_per_prompt`` 2 with the RLOO estimator: 8 prompts
    repeated to 16 rows, each micro-batch of 8 rows 4 groups of 2."""
    from align_anything_tpu.trainers.text_to_text.multi_ppo import (
        MultiPPOTrainer,
    )

    _fix_rollouts(monkeypatch)
    _estimator_env(monkeypatch, 2, 'rloo')
    argv = _ppo_argv(assets, tmp_path)
    argv[argv.index('--per_device_prompt_batch_size') + 1] = '1'
    jtrainer, trainer = _both(MultiPPOTrainer, tmulti.MultiPPOTrainer,
                              'text_to_text/ppo', argv, PPO_SCALED)
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    assert batch['input_ids'].shape[0] == 8
    rollout = trainer.rollout(batch)
    assert rollout['input_ids'].shape[0] == 16
    assert torch.equal(rollout['input_ids'][0, :16], rollout['input_ids'][1, :16])
    got = trainer.train_step(batch)
    want = {k: float(v) for k, v in jtrainer.train_step(jbatch).items()}
    assert got['train/kl_divergence'] == 0.0
    _compare([got], [want])
    _compare_trees(trainer.actor_state.params, jtrainer.actor_state.params)


def test_ppo_trainer_main_saves_the_actor(assets, tmp_path, monkeypatch):
    """``trainer_main(PPOTrainer, ...)`` runs the round (24 prompts, one
    round of 16) and exports the actor's slice, which reads back equal to
    the trained params; with ``--use_lora`` it runs its round over the
    adapters, as JAX does (``tests/test_torch_lora.py`` holds it to JAX)."""
    _fix_rollouts(monkeypatch)
    argv = _scaled(_ppo_argv(assets, tmp_path), PPO_SCALED)
    trainer = tcli.trainer_main(tppo.PPOTrainer, 'text_to_text/ppo', argv,
                                device='cpu')
    assert trainer.global_step == 1
    back, _ = load_params(str(tmp_path / 'slice_1'), device='cpu')
    _compare_trees(back, trainer.actor_state.params, 0)
    lora = tcli.trainer_main(tppo.PPOTrainer, 'text_to_text/ppo',
                             argv + ['--use_lora', 'True'], device='cpu')
    assert lora.global_step == 1
    assert set(lora.actor_state.params) == {'q_proj', 'v_proj'}


def test_ppo_config_checks(assets, tmp_path, monkeypatch):
    """An estimator that needs groups without them, an unknown estimator
    and an unknown rollout backend raise when the trainer is built."""
    argv = _scaled(_ppo_argv(assets, tmp_path), PPO_SCALED)
    _estimator_env(monkeypatch, 1, 'rloo')
    cfgs, pc = tcli.parse_cfgs('text_to_text/ppo', argv)
    with pytest.raises(ValueError, match='n_samples_per_prompt'):
        tppo.PPOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    _estimator_env(monkeypatch, 2, 'median')
    cfgs, pc = tcli.parse_cfgs('text_to_text/ppo', argv)
    with pytest.raises(ValueError, match='unknown advantage_estimator'):
        tppo.PPOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    monkeypatch.delenv('ENV_PREFIX__TRAIN_CFGS__ADVANTAGE_ESTIMATOR')
    cfgs, pc = tcli.parse_cfgs('text_to_text/ppo',
                               argv + ['--rollout_backend', 'vllm'])
    with pytest.raises(ValueError, match='unknown rollout_backend'):
        tppo.PPOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')


def test_rl_trainers_default_to_the_card(assets, tmp_path, monkeypatch):
    """No device given: the trainer takes the first CUDA device, and
    raises where there is none: the RM trainer, KTO, GRPO, Safe-RLHF and
    the two PPO variants."""
    from align_anything_tpu_torch.trainers.text_to_text import (
        grpo,
        kto,
        ppo_remote_rm,
        ppo_vllm,
        saferlhf,
    )

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    ppo_argv = _ppo_argv(assets, tmp_path)
    cases = (
        (trm.RMTrainer, 'rm', _rm_argv(assets, tmp_path)),
        (kto.KTOTrainer, 'kto', _rm_argv(assets, tmp_path)),
        (grpo.GRPOTrainer, 'grpo', ppo_argv),
        (saferlhf.SafeRLHFTrainer, 'saferlhf', ppo_argv),
        (ppo_remote_rm.PPORemoteRMTrainer, 'ppo', ppo_argv),
        (ppo_vllm.PPOVLLMTrainer, 'ppo', ppo_argv))
    for cls, task, argv in cases:
        cfgs, pc = tcli.parse_cfgs(f'text_to_text/{task}', argv)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            cls(cfgs=cfgs, parallel_cfgs=pc)
