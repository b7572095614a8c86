"""The port's KTO trainer (``align_anything_tpu_torch/trainers/text_to_text/
kto.py``) against the JAX package's, driven the same way: configs parsed
from the same command-line overrides, a tiny Llama checkpoint on disk
(built with ``transformers``; one layer, since the JAX trainer's compile
time grows with the depth), local PKU-SafeRLHF-schema ``.jsonl`` rows, fp32,
on the CPU.

Global batch: the JAX trainer multiplies ``per_device_train_batch_size``
and ``per_device_kl_batch_size`` by ``jax.device_count()``, 8 here
(``tests/conftest.py``); the port runs one device, so its runs take 8x the
JAX per-device sizes and both see the same batches in the same order.

Tolerances: per-step metrics to 1e-5 (rtol and atol), as
``tests/test_torch_trainers.py`` holds DPO, ORPO and SimPO; the KL baseline
before any update exactly 0 in the port (policy and reference are equal
fp32 trees through the same ops on one CPU thread, and the estimate is
clamped at 0), and step 1's loss 0 to 1e-6 (``scale_better`` =
``scale_worse`` = 1: 0.5 - 0.5).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
pytest.importorskip('yaml')

from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_to_text import (  # noqa: E402
    kto as tkto,
)
from test_torch_rl_trainers import one_compile  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DEVICES = 8
TOL = 1e-5
STEPS = 3


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp('kto_assets')
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(
        d / 'model', safe_serialization=True)
    rng = np.random.default_rng(0)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps', 'zeta']

    def pick(k):
        return ' '.join(words[j] for j in rng.integers(0, 6, size=k))

    with open(d / 'pref.jsonl', 'w') as f:
        for _ in range(32):
            f.write(json.dumps({
                'prompt': f'pick {pick(int(rng.integers(1, 4)))}',
                'response_0': pick(int(rng.integers(1, 8))),
                'response_1': pick(int(rng.integers(1, 8))),
                'better_response_id': int(rng.integers(0, 2))}) + '\n')
    return d


@pytest.fixture()
def one_thread():
    """One CPU thread: torch's threaded reductions may differ in the last
    place between two identical passes, and the KL baseline of equal
    policy and reference must be exactly 0."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(assets, out, per_device, extra=()):
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / 'pref.jsonl'),
            '--train_template', 'PKUSafeRLHF', '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[32]', '--save_checkpoint', 'False',
            '--kl_steps', '2',
            '--per_device_kl_batch_size', str(per_device),
            '--per_device_train_batch_size', str(per_device), *extra]


def _run(trainer, steps):
    """``steps`` steps as the train loop takes them: ``global_step``
    counts the steps taken, so the KL refresh comes before step
    ``kl_steps + 1``."""
    out = []
    for batch in list(trainer.train_iterator.epoch_batches(0))[:steps]:
        out.append({k: float(v) for k, v in trainer.train_step(batch).items()})
        trainer.global_step += 1
    return out


def test_kto_steps_match_jax(assets, tmp_path, one_thread):
    """3 steps, every metric the JAX trainer reports, step for step, across
    the KL refresh before step 3; the baseline at build is 0 in both, the
    refreshed one positive and equal."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_to_text.kto import KTOTrainer

    cfgs, pc = jcli.parse_cfgs('text_to_text/kto',
                               _argv(assets, tmp_path / 'jax', 1))
    jtrainer = one_compile(KTOTrainer(cfgs=cfgs, parallel_cfgs=pc))
    cfgs, pc = tcli.parse_cfgs('text_to_text/kto',
                               _argv(assets, tmp_path / 'port', JAX_DEVICES))
    trainer = tkto.KTOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    assert trainer.kl == 0.0 and abs(jtrainer.kl) <= TOL
    assert trainer._kl_epoch == jtrainer._kl_epoch == 1
    want, got = _run(jtrainer, STEPS), _run(trainer, STEPS)
    assert len(got) == len(want) == STEPS
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(w) <= set(g), set(w) - set(g)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, atol=TOL,
                                       err_msg=f'step {step + 1} {key}')
    kl = [m['train/kl_baseline'] for m in got]
    assert kl[0] == kl[1] == 0.0 and kl[2] > 1e-4
    assert trainer._kl_epoch == jtrainer._kl_epoch == 2
    assert abs(got[0]['train/loss']) <= 1e-6
    assert got[0]['train/loss'] != got[-1]['train/loss']


def test_kto_trainer_main(assets, tmp_path, monkeypatch):
    """``trainer_main(KTOTrainer, ...)`` trains every step (32 pairs less
    the equal ones, 8 a step) with one refresh per ``kl_steps`` and exports
    the policy; an empty KL iterator (a KL batch larger than the data)
    leaves the baseline at 0 and training goes on."""
    from align_anything_tpu_torch.utils.logger import Logger

    steps = []
    monkeypatch.setattr(Logger, 'log', lambda self, metrics, step:
                        steps.append(dict(metrics)))
    calls = []
    refresh = tkto.KTOTrainer.refresh_kl

    def counting(self):
        calls.append(self.global_step)
        refresh(self)

    monkeypatch.setattr(tkto.KTOTrainer, 'refresh_kl', counting)
    trainer = tcli.trainer_main(
        tkto.KTOTrainer, 'text_to_text/kto',
        _argv(assets, tmp_path, JAX_DEVICES), device='cpu')
    n = trainer.global_step
    assert n == len(steps) >= 3
    assert calls == list(range(0, n, 2))
    assert all(np.isfinite(m['train/loss']) for m in steps)
    assert os.path.exists(tmp_path / f'slice_{n}' / 'model.safetensors')
    cfgs, pc = tcli.parse_cfgs('text_to_text/kto', _argv(
        assets, tmp_path / 'big', JAX_DEVICES,
        ('--per_device_kl_batch_size', '64')))
    big = tkto.KTOTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    assert big.kl == 0.0 and big._kl_epoch == 0


def test_kto_entry_point():
    """``python -m align_anything_tpu_torch.trainers.text_to_text.kto``
    exists and parses its command line (``--help`` exits before the
    trainer is built)."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run(
        [sys.executable, '-m',
         'align_anything_tpu_torch.trainers.text_to_text.kto', '--help'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'usage' in proc.stdout
