"""The port's Safe-RLHF trainer (``align_anything_tpu_torch/trainers/
text_to_text/saferlhf.py``) against the JAX package's, on the assets and
helpers of ``tests/test_torch_rl_trainers.py``: a tiny Llama checkpoint,
a reward model beside it, and a cost model with a head of its own, fp32,
on the CPU, with the rollout fixed by patching both packages' ``generate``
to one numpy block.

Global batch: the JAX trainer multiplies the prompt batch and the
micro-batch by ``jax.device_count()``, 8 here; the port takes 8x the JAX
per-device sizes, so a round of 16 prompts is two micro-batches of 8 in
both.

Tolerances: metrics and parameters to 1e-5 (rtol and atol), as
``tests/test_torch_rl_trainers.py``; ``train/log_lambda`` to 1e-6 (one
float64 SGD step on the host from float32 costs).  Round 1's KL is
exactly 0 in the port (one CPU thread).
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('transformers')
pytest.importorskip('yaml')

from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_to_text import (  # noqa: E402
    saferlhf as tsafe,
)
from test_torch_rl_trainers import (  # noqa: E402,F401  (a fixture)
    PPO_SCALED,
    REPO,
    TOL,
    _both,
    _compare,
    _compare_trees,
    _fix_rollouts,
    _ppo_argv,
    _ppo_round,
    _scaled,
    make_assets,
    one_thread,
)


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """``tests/test_torch_rl_trainers.py``'s assets with a one-layer model:
    the JAX trainer's compile time grows with the depth, and one layer
    holds the trainer's logic."""
    return make_assets(tmp_path_factory.mktemp('saferlhf_assets'), layers=1)


LAMBDA_TOL = 1e-6


@pytest.fixture(scope='module')
def cost_model(assets):
    """The reward checkpoint's trunk with another head, as the cost
    model."""
    d = assets / 'cost'
    if not d.exists():
        shutil.copytree(assets / 'model', d)
        np.save(d / 'score_head.npy',
                np.random.default_rng(5).standard_normal((64, 1)).astype(
                    np.float32))
    return d


def _argv(assets, cost_model, out, extra=()):
    return _ppo_argv(assets, out, extra=(
        '--cost_model_name_or_path', str(cost_model), *extra))


def _scaled_argv(assets, cost_model, out, extra=()):
    return _scaled(_argv(assets, cost_model, out, extra), PPO_SCALED)


@pytest.mark.parametrize('case', ['round', 'ptx'])
def test_saferlhf_round_matches_jax(assets, cost_model, tmp_path,
                                    monkeypatch, one_thread, case):
    """One round against JAX's: every reported metric (the last
    micro-batch's), the actor, reward critic and cost critic after the
    three updates per micro-batch, and the multiplier after its update.
    ``ptx`` runs the round as one micro-batch, followed by a PTX step."""
    from align_anything_tpu.trainers.text_to_text.saferlhf import (
        SafeRLHFTrainer,
    )

    _fix_rollouts(monkeypatch)
    # ptx: one micro-batch of 16 a round, so one PTX step of 16 rows
    extra = () if case == 'round' else (
        '--ptx_datasets', str(assets / 'sft.jsonl'),
        '--ptx_template', 'Alpaca', '--per_device_train_batch_size', '2')
    jtrainer, trainer = _both(
        SafeRLHFTrainer, tsafe.SafeRLHFTrainer, 'text_to_text/saferlhf',
        _argv(assets, cost_model, tmp_path, extra), PPO_SCALED)
    assert trainer.log_lambda == jtrainer.log_lambda == 0.0
    got, want = _ppo_round(jtrainer, trainer)
    assert got['train/kl_divergence'] == 0.0
    assert abs(want['train/kl_divergence']) <= TOL
    _compare([got], [want])
    assert got['train/cost'] != got['train/reward']
    np.testing.assert_allclose(got['train/log_lambda'],
                               want['train/log_lambda'], rtol=LAMBDA_TOL,
                               atol=LAMBDA_TOL)
    # the first multiplier update in closed form: log(1) + lambda_lr *
    # (episode cost - threshold 0) * exp(0)
    assert got['train/log_lambda'] == pytest.approx(
        0.04 * got['train/episode_cost'], abs=1e-12)
    assert len(trainer.episode_costs) == 16
    for name in ('actor_state', 'critic_state', 'cost_critic_state'):
        _compare_trees(getattr(trainer, name).params,
                       getattr(jtrainer, name).params)
        updates = 2 if case == 'round' else 1 + (name == 'actor_state')
        assert getattr(trainer, name).step == updates
    assert ('train/ptx_loss' in got) == (case == 'ptx')


def test_saferlhf_lambda_rules(assets, cost_model, tmp_path, monkeypatch):
    """``lambda_update_delay_steps`` holds the multiplier until
    ``global_step`` reaches it; ``lambda_max`` caps it; the episode-cost
    window keeps the last ``episode_cost_window_size`` costs."""
    _fix_rollouts(monkeypatch)
    argv = _scaled_argv(assets, cost_model, tmp_path, (
        '--lambda_update_delay_steps', '1', '--lambda_max', '1.5',
        '--lambda_lr', '100', '--threshold', '-10',
        '--episode_cost_window_size', '20'))
    cfgs, pc = tcli.parse_cfgs('text_to_text/saferlhf', argv)
    trainer = tsafe.SafeRLHFTrainer(cfgs=cfgs, parallel_cfgs=pc,
                                    device='cpu')
    batch = next(trainer.train_iterator.epoch_batches(0))
    m = trainer.train_step(batch)
    assert m['train/log_lambda'] == 0.0       # global_step 0 < delay 1
    trainer.global_step += 1
    m = trainer.train_step(batch)
    assert m['train/log_lambda'] == pytest.approx(np.log(1.5), abs=1e-12)
    assert len(trainer.episode_costs) == 20
    for key, value in m.items():
        assert np.isfinite(value), key


def test_saferlhf_trainer_main(assets, cost_model, tmp_path, monkeypatch):
    """``trainer_main(SafeRLHFTrainer, ...)``: one round of 16 of the 24
    prompts and the actor's export."""
    _fix_rollouts(monkeypatch)
    argv = _scaled_argv(assets, cost_model, tmp_path)
    trainer = tcli.trainer_main(tsafe.SafeRLHFTrainer, 'text_to_text/saferlhf',
                                argv, device='cpu')
    assert trainer.global_step == 1
    assert os.path.exists(tmp_path / 'slice_1' / 'model.safetensors')


def test_saferlhf_entry_point():
    """``python -m align_anything_tpu_torch.trainers.text_to_text.saferlhf``
    exists and parses its command line."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run(
        [sys.executable, '-m',
         'align_anything_tpu_torch.trainers.text_to_text.saferlhf', '--help'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'usage' in proc.stdout
