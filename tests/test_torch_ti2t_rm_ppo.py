"""The port's TI2T reward and cost models and TI2T PPO
(``align_anything_tpu_torch/trainers/text_image_to_text/{rm,cost_model,
ppo}.py``) against the JAX package's, driven the same way:
configs parsed from the same command-line overrides, a tiny LLaVA
checkpoint on disk (two text layers, a two-layer tower; built with
``transformers``), AA_TI2T rows with PNG images, fp32, on the CPU.

Global batch: the JAX trainers multiply every per-device batch size by
``jax.device_count()``, 8 here (``tests/conftest.py``); the port runs one
device with 8x the per-device sizes, so both see the same batches.

The rollout is fixed, as in ``tests/test_torch_rl_trainers.py``: both
packages' TI2T ``generate`` return one numpy block (the collator's
left-padded image prompts, then completions of differing lengths ending
in EOS and pad, drawn below the image token).  The image-prefilled
``generate`` itself is held to JAX's in
``tests/test_torch_ti2t_generation.py``.

Heads: the RM trainers draw a fresh score head from each package's own
generator, so both get the same numpy head before their first step; the
RL trainers read ``score_head.npy`` beside the reward (and cost)
checkpoints.

Tolerances: metrics and parameters to 1e-5 (rtol and atol), as
``tests/test_torch_rl_trainers.py``.  Round 1's KL is exactly 0 in the
port (one CPU thread).  Frozen leaves are held bit-equal.

R13: the RL trainers' YAMLs set ``freeze_vision_tower``, but JAX freezes
nothing in TI2T PPO (nor in Safe-RLHF-V and GRPO,
``tests/test_torch_ti2t_rl.py``); both packages' towers move in a round,
and the port's moved leaves equal JAX's.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('transformers')
PIL = pytest.importorskip('PIL.Image')
pytest.importorskip('yaml')

from align_anything_tpu_torch.models.hf_loader import (  # noqa: E402
    load_multimodal_params,
)
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    cost_model as tcost,
    ppo as tppo,
    rm as trm,
)
from test_torch_rl_trainers import (  # noqa: E402,F401  (a fixture)
    NEW_TOKENS,
    PAD,
    TOL,
    _block,
    _both,
    _compare,
    _compare_trees,
    _leaves,
    _scaled,
    one_thread,
)
from test_torch_ti2t_trainers import IMAGE_TOKEN, make_assets  # noqa: E402

HIDDEN = 64


def make_rl_assets(d):
    """``make_assets``' LLaVA checkpoint (two text layers, two tower
    layers) and preference rows, plus 24 prompt rows of 1-9 words (left
    padding of differing lengths), each with its own PNG, and a reward
    and a cost model: the checkpoint with a head of its own beside it."""
    make_assets(d, layers=2, tower_layers=2)
    rng = np.random.default_rng(7)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps', 'zeta', 'eta']
    with open(d / 'prompts.jsonl', 'w') as f:
        for i in range(24):
            img = d / f'prompt{i}.png'
            PIL.fromarray(rng.integers(0, 256, size=(28, 36, 3)).astype(
                np.uint8)).save(img)
            question = ' '.join(words[j] for j in rng.integers(
                0, len(words), size=int(rng.integers(1, 10))))
            f.write(json.dumps({'question': f'{question} {i}',
                                'response_1': 'a', 'response_2': 'b',
                                'overall_response': 1,
                                'image': str(img)}) + '\n')
    for name, seed in (('reward', 1), ('cost', 2)):
        shutil.copytree(d / 'model', d / name)
        np.save(d / name / 'score_head.npy',
                np.random.default_rng(seed).standard_normal(
                    (HIDDEN, 1)).astype(np.float32))
    return d


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return make_rl_assets(tmp_path_factory.mktemp('ti2t_rl_assets'))


def fix_rollouts(monkeypatch):
    """Both packages' TI2T ``generate`` (PPO's and GRPO's) return the numpy
    block, with its completion mask; completions draw no image token."""
    import jax.numpy as jnp
    from align_anything_tpu.trainers.text_image_to_text import (
        grpo as jgrpo,
        ppo as jppo,
    )

    def block(input_ids, attention_mask):
        ids, mask, comp = _block(input_ids, attention_mask, IMAGE_TOKEN, PAD)
        return {'sequences': ids, 'attention_mask': mask,
                'completions': comp,
                'completion_mask': (comp != PAD).astype(np.int64)}

    def jax_generate(params, model_cfg, gen_cfg, input_ids, attention_mask,
                     *args, **kwargs):
        assert kwargs['pixel_values'].shape[0] == input_ids.shape[0]
        return {k: jnp.asarray(v, jnp.int32) for k, v in block(
            np.asarray(input_ids), np.asarray(attention_mask)).items()}

    def torch_generate(params, model_cfg, gen_cfg, input_ids, attention_mask,
                       *args, **kwargs):
        assert kwargs['pixel_values'].shape[0] == input_ids.shape[0]
        return {k: torch.as_tensor(v, device=input_ids.device)
                for k, v in block(input_ids.cpu().numpy(),
                                  attention_mask.cpu().numpy()).items()}

    for module, fn in ((jppo, jax_generate), (jgrpo, jax_generate),
                       (tppo, torch_generate)):
        monkeypatch.setattr(module, 'generate', fn)


def snapshot(params) -> dict:
    """path -> a copy of the leaf (the port's leaves are updated in place,
    and ``_leaves`` views them)."""
    return {p: np.array(v, copy=True) for p, v in _leaves(params).items()}


def module_moved(params, start) -> dict:
    """module -> whether any of its leaves differs from ``start``."""
    now = _leaves(params)
    return {m: any(not np.array_equal(v, start[p]) for p, v in now.items()
                   if p.startswith(f'/{m}/'))
            for m in ('language_model', 'vision_tower', 'projector')}


# ---------------------------------------------------------------------------
# the reward and cost models
# ---------------------------------------------------------------------------

def _rm_argv(assets, out):
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / 'pref.jsonl'),
            '--train_template', 'AA_TI2T', '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[32]', '--save_checkpoint', 'False',
            '--per_device_train_batch_size', '1']


@pytest.mark.parametrize('algo', ['rm', 'cost_model'])
def test_ti2t_rm_matches_jax(assets, tmp_path, algo):
    """Two steps of 8 pairs: loss, accuracy, grad norm and every updated
    leaf against JAX's, the frozen tower bit-equal; the export reads back
    with the port's loader equal to the trained trunk, and
    ``score_head.npy`` equal to the trained head."""
    from align_anything_tpu.trainers.text_image_to_text import (
        cost_model as jcost,
        rm as jrm,
    )

    import jax.numpy as jnp

    jax_cls, port_cls = {
        'rm': (jrm.TI2TRMTrainer, trm.TI2TRMTrainer),
        'cost_model': (jcost.TI2TCostModelTrainer,
                       tcost.TI2TCostModelTrainer)}[algo]
    jtrainer, trainer = _both(jax_cls, port_cls, 'text_image_to_text/rm',
                             _rm_argv(assets, tmp_path),
                             ('per_device_train_batch_size',))
    head = np.random.default_rng(3).standard_normal((HIDDEN, 1)).astype(
        np.float32) / 8
    jtrainer.state = dataclasses.replace(jtrainer.state, params=dict(
        jtrainer.state.params, score_head={'w': jnp.asarray(head)}))
    with torch.no_grad():
        trainer.state.params['score_head']['w'].copy_(torch.from_numpy(head))
    start = snapshot(trainer.state.params)
    batches = list(trainer.train_iterator.epoch_batches(0))[:2]
    jbatches = list(jtrainer.train_iterator.epoch_batches(0))[:2]
    got = [trainer.train_step(b) for b in batches]
    want = [{k: float(v) for k, v in jtrainer.train_step(b).items()}
            for b in jbatches]
    _compare(got, want)
    assert got[0]['train/loss'] != got[1]['train/loss']
    _compare_trees(trainer.state.params, jtrainer.state.params)
    assert module_moved(trainer.state.params, start) == {
        'language_model': True, 'vision_tower': False, 'projector': True}

    trainer.save(tag=2)
    slice_dir = tmp_path / 'port' / 'slice_2'
    back, cfg = load_multimodal_params(str(slice_dir), device='cpu')
    assert cfg.image_token_id == IMAGE_TOKEN
    _compare_trees(back, {k: v for k, v in trainer.state.params.items()
                          if k != 'score_head'}, 0)
    np.testing.assert_array_equal(
        np.load(slice_dir / 'score_head.npy'),
        trainer.state.params['score_head']['w'].detach().numpy())


# ---------------------------------------------------------------------------
# PPO and Safe-RLHF-V
# ---------------------------------------------------------------------------

PPO_SCALED = ('per_device_prompt_batch_size', 'per_device_train_batch_size')


def _ppo_argv(assets, out, extra=()):
    return ['--actor_model_name_or_path', str(assets / 'model'),
            '--reward_model_name_or_path', str(assets / 'reward'),
            '--train_datasets', str(assets / 'prompts.jsonl'),
            '--train_template', 'AA_TI2T', '--output_dir', str(out),
            '--epochs', '1', '--max_new_tokens', str(NEW_TOKENS),
            '--bf16', 'False', '--padding_buckets', '[32]',
            '--save_checkpoint', 'False', '--actor_lr', '1e-4',
            '--critic_lr', '1e-4', '--critic_weight_decay', '0.01',
            '--per_device_prompt_batch_size', '2',
            '--per_device_train_batch_size', '1', *extra]


def _round(jtrainer, trainer):
    """One round (16 image prompts, 2 micro-batches of 8) through each
    trainer's ``train_step`` on the same prompt batch."""
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    np.testing.assert_array_equal(batch['input_ids'], jbatch['input_ids'])
    for m, jm in zip(batch['meta'], jbatch['meta']):
        np.testing.assert_array_equal(m['pixel_values'], jm['pixel_values'])
    lengths = batch['attention_mask'].sum(-1)
    assert batch['input_ids'].shape == (16, 32) and len(set(lengths)) > 3
    assert ((batch['input_ids'] == IMAGE_TOKEN).sum(-1) == 4).all()
    want = jtrainer.train_step(jbatch)
    got = trainer.train_step(batch)
    return got, {k: float(v) for k, v in want.items()}


def _tower_moves_in_both(trainer, jtrainer, names, start, jstart):
    """R13: the YAML freezes the tower, and it trains in both packages."""
    assert trainer.cfgs.train_cfgs.freeze_vision_tower is True
    for name in names:
        for t, s in ((getattr(trainer, name).params, start[name]),
                     (getattr(jtrainer, name).params, jstart[name])):
            assert module_moved(t, s) == {'language_model': True,
                                          'vision_tower': True,
                                          'projector': True}, name


def test_ti2t_ppo_round_matches_jax(assets, tmp_path, monkeypatch,
                                    one_thread, capsys):
    """One TI2T PPO round against JAX's on the same sequences: every
    metric, the actor and critic after the two micro-batch updates; round
    1's KL exactly 0; both towers train in both packages (R13), and the
    port says so at start-up."""
    from align_anything_tpu.trainers.text_image_to_text.ppo import (
        TI2TPPOTrainer,
    )

    fix_rollouts(monkeypatch)
    jtrainer, trainer = _both(TI2TPPOTrainer, tppo.TI2TPPOTrainer,
                             'text_image_to_text/ppo',
                             _ppo_argv(assets, tmp_path), PPO_SCALED)
    assert 'R13' in capsys.readouterr().out
    names = ('actor_state', 'critic_state')
    start = {n: snapshot(getattr(trainer, n).params) for n in names}
    jstart = {n: snapshot(getattr(jtrainer, n).params) for n in names}
    got, want = _round(jtrainer, trainer)
    assert got['train/kl_divergence'] == 0.0
    assert abs(want['train/kl_divergence']) <= TOL
    _compare([got], [want])
    assert got['perf/generated_tokens'] > 0
    for name in names:
        _compare_trees(getattr(trainer, name).params,
                       getattr(jtrainer, name).params)
    _tower_moves_in_both(trainer, jtrainer, names, start, jstart)


def test_ti2t_ppo_trainer_main_saves_the_actor(assets, tmp_path,
                                               monkeypatch):
    """``trainer_main(TI2TPPOTrainer, ...)``: one round of 16 of the 24
    prompts; the LLaVA-layout export is the actor's and reads back equal
    to its trained params, but for the tower's patch-embedding bias: the
    tree holds one, the tower trains it (R13), and the LLaVA layout has no
    place for it, so it reads back as zeros, as JAX's exporter writes it
    (ROADMAP §3 R15)."""
    fix_rollouts(monkeypatch)
    trainer = tcli.trainer_main(
        tppo.TI2TPPOTrainer, 'text_image_to_text/ppo',
        _scaled(_ppo_argv(assets, tmp_path), PPO_SCALED), device='cpu')
    assert trainer.global_step == 1
    back, _ = load_multimodal_params(str(tmp_path / 'slice_1'), device='cpu')
    trained = snapshot(trainer.actor_state.params)
    bias = '/vision_tower/patch_embed/b'
    assert np.abs(trained[bias]).max() > 0
    np.testing.assert_array_equal(_leaves(back)[bias], 0)
    trained[bias] = np.zeros_like(trained[bias])
    got = _leaves(back)
    assert set(got) == set(trained)
    for path, leaf in trained.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)
