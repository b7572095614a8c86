"""The port's text-to-text trainers (``align_anything_tpu_torch/trainers``)
against the JAX package's, driven the same way: configs parsed from the
same command-line overrides, a tiny Llama checkpoint on disk (built with
``transformers``), local ``.jsonl`` rows, fp32, on the CPU.

Global batch: the JAX trainers multiply ``per_device_train_batch_size`` by
``jax.device_count()``, 8 here (``tests/conftest.py``); the port runs one
device, so its runs take 8x the JAX per-device batch and both step through
the same 8-row batches in the same order.

Tolerances: per-step metrics to 1e-5 (rtol and atol), as
``tests/test_torch_dpo.py`` holds the step (fp32 math summed in another
order; lr 1e-4 keeps Adam's normalized steps from amplifying it); the
step-1 DPO loss to ln 2 within 1e-6; a resumed run bit-equal to the
uninterrupted one.
"""

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
pytest.importorskip('yaml')

from align_anything_tpu_torch.models.hf_loader import load_params  # noqa: E402
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_to_text.dpo import (  # noqa: E402
    DPOTrainer,
)
from align_anything_tpu_torch.trainers.text_to_text.orpo import (  # noqa: E402
    ORPOTrainer,
)
from align_anything_tpu_torch.trainers.text_to_text.sft import (  # noqa: E402
    SupervisedTrainer,
)
from align_anything_tpu_torch.trainers.text_to_text.simpo import (  # noqa: E402
    SimPOTrainer,
)
from align_anything_tpu_torch.utils.logger import Logger  # noqa: E402
from test_torch_rl_trainers import one_compile  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DEVICES = 8
PER_DEVICE = 1
TOL = 1e-5
PORT = {'dpo': DPOTrainer, 'sft': SupervisedTrainer, 'orpo': ORPOTrainer,
        'simpo': SimPOTrainer}
DATA = {'dpo': ('pref', 'PKUSafeRLHF'), 'sft': ('sft', 'Alpaca'),
        'orpo': ('pref', 'PKUSafeRLHF'), 'simpo': ('pref', 'PKUSafeRLHF')}


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return make_assets(tmp_path_factory.mktemp('trainer_assets'))


def make_assets(d):
    """A tiny Llama checkpoint (``d/model``), preference rows
    (``d/pref.jsonl``) and SFT rows (``d/sft.jsonl``)."""
    os.makedirs(d, exist_ok=True)
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
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
    with open(d / 'sft.jsonl', 'w') as f:
        for _ in range(16):
            f.write(json.dumps({'instruction': f'say {pick(2)}',
                                'input': pick(1),
                                'output': pick(int(rng.integers(1, 8)))})
                    + '\n')
    return d


def _argv(assets, algo, out, per_device, extra=()):
    data, template = DATA[algo]
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / f'{data}.jsonl'),
            '--train_template', template, '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[32]', '--save_checkpoint', 'False',
            '--per_device_train_batch_size', str(per_device), *extra]


def _jax_metrics(assets, algo, out, extra=()):
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_to_text import dpo, orpo, sft, simpo

    cls = {'dpo': dpo.DPOTrainer, 'sft': sft.SupervisedTrainer,
           'orpo': orpo.ORPOTrainer, 'simpo': simpo.SimPOTrainer}[algo]
    cfgs, parallel_cfgs = jcli.parse_cfgs(
        f'text_to_text/{algo}', _argv(assets, algo, out, PER_DEVICE, extra))
    trainer = one_compile(cls(cfgs=cfgs, parallel_cfgs=parallel_cfgs))
    return [trainer.train_step(b)
            for b in trainer.train_iterator.epoch_batches(0)]


def _port(assets, algo, out, extra=()):
    cfgs, parallel_cfgs = tcli.parse_cfgs(
        f'text_to_text/{algo}',
        _argv(assets, algo, out, PER_DEVICE * JAX_DEVICES, extra))
    return PORT[algo](cfgs=cfgs, parallel_cfgs=parallel_cfgs, device='cpu')


def _port_metrics(assets, algo, out, extra=()):
    trainer = _port(assets, algo, out, extra)
    return [trainer.train_step(b)
            for b in trainer.train_iterator.epoch_batches(0)]


def _compare(got, want):
    assert len(got) == len(want) > 0
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(w) <= set(g), set(w) - set(g)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, atol=TOL,
                                       err_msg=f'step {step + 1} {key}')


@pytest.mark.parametrize('algo', ['dpo', 'sft', 'orpo', 'simpo'])
def test_trainer_steps_match_jax(assets, tmp_path, algo):
    """DPO: 4 steps (32 pairs, global batch 8); SFT, ORPO, SimPO: the first
    2 steps.  Every metric the JAX trainer reports, step for step."""
    steps = 4 if algo == 'dpo' else 2
    want = _jax_metrics(assets, algo, tmp_path / 'jax')[:steps]
    got = _port_metrics(assets, algo, tmp_path / 'port')[:steps]
    assert len(want) == steps
    _compare(got, want)
    assert got[0]['train/loss'] != got[-1]['train/loss']
    if algo == 'dpo':
        assert abs(got[0]['train/loss'] - math.log(2)) <= 1e-6
        assert abs(want[0]['train/loss'] - math.log(2)) <= 1e-6


def test_gradient_accumulation_matches_jax(assets, tmp_path):
    """``gradient_accumulation_steps 2`` over 4 micro-steps against the JAX
    trainer's ``optax.MultiSteps``: the loss moves only after micro-steps 2
    and 4, and ``train/lr`` reads ``schedule(micro-step)``, as in JAX."""
    extra = ('--gradient_accumulation_steps', '2', '--lr_scheduler_type',
             'linear')
    want = _jax_metrics(assets, 'dpo', tmp_path / 'jax', extra)
    got = _port_metrics(assets, 'dpo', tmp_path / 'port', extra)
    _compare(got, want)
    losses = [m['train/loss'] for m in got]
    assert losses[0] == losses[1]          # no update after micro-step 1
    assert losses[2] != losses[1]
    assert [m['train/lr'] for m in got] == pytest.approx(
        [1e-4 * (1 - t / 4) for t in range(4)])


def _run_logged(trainer, monkeypatch):
    steps = []
    monkeypatch.setattr(Logger, 'log', lambda self, metrics, step:
                        steps.append(dict(metrics)))
    trainer.train()
    return steps


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items()
                for p, leaf in _leaves(v, f'{prefix}/{k}').items()}
    return {prefix: tree.detach()}


@pytest.fixture()
def one_thread():
    """torch's multithreaded CPU reductions are not repeatable bit for bit
    (two identical runs differ in the last place); one thread is."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('algo', ['dpo', 'sft'])
def test_resume_is_bit_equal(assets, tmp_path, monkeypatch, one_thread,
                             algo):
    """2 steps, the train state saved, a new trainer with
    ``load_checkpoint True`` from it, 2 more steps: bit-equal to 4
    uninterrupted steps (the step-2 save of the uninterrupted run is the
    state after 2 steps), metrics and params."""
    per_device = 8 if algo == 'dpo' else 4
    base = ('--save_checkpoint', 'True', '--save_interval', '2',
            '--save_total_limit', '3')
    cfgs, pc = tcli.parse_cfgs(f'text_to_text/{algo}', _argv(
        assets, algo, tmp_path / 'full', per_device, base))
    full = PORT[algo](cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    full_steps = _run_logged(full, monkeypatch)
    assert len(full_steps) == 4
    os.makedirs(tmp_path / 'resumed' / 'checkpoints')
    shutil.copytree(tmp_path / 'full' / 'checkpoints' / 'step_2',
                    tmp_path / 'resumed' / 'checkpoints' / 'step_2')
    cfgs, pc = tcli.parse_cfgs(f'text_to_text/{algo}', _argv(
        assets, algo, tmp_path / 'resumed', per_device,
        ('--load_checkpoint', 'True')))
    resumed = PORT[algo](cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    assert resumed.global_step == 2 and resumed.state.step == 2
    resumed_steps = _run_logged(resumed, monkeypatch)
    keys = ('train/loss', 'train/grad_norm', 'train/lr')
    assert [[m[k] for k in keys] for m in resumed_steps] == \
        [[m[k] for k in keys] for m in full_steps[2:]]
    want, got = _leaves(full.state.params), _leaves(resumed.state.params)
    assert all(torch.equal(got[p], want[p]) for p in want)


def test_zero_steps_raise(assets, tmp_path):
    """A dataset smaller than the global batch would train no step."""
    with pytest.warns(UserWarning, match='every epoch'):
        trainer = _port(assets, 'sft', tmp_path,
                        ('--per_device_train_batch_size', '64'))
    with pytest.raises(ValueError, match='training would run 0 steps'):
        trainer.train()


def test_trainer_main_from_argv(assets, tmp_path, monkeypatch):
    """``trainer_main`` parses argv, trains every step, writes a
    ``torch.profiler`` trace of step index 3 (``maybe_trace``'s window
    starts there), and exports an HF slice that reads back equal to the
    trained params."""
    steps = []
    monkeypatch.setattr(Logger, 'log', lambda self, metrics, step:
                        steps.append(dict(metrics)))
    trainer = tcli.trainer_main(
        DPOTrainer, 'text_to_text/dpo',
        _argv(assets, 'dpo', tmp_path, 8,
              ('--profile_dir', str(tmp_path / 'trace'))), device='cpu')
    assert trainer.global_step == len(steps) == 4
    assert abs(steps[0]['train/loss'] - math.log(2)) <= 1e-6
    assert os.listdir(tmp_path / 'trace') == ['step_3.json']
    back, _ = load_params(str(tmp_path / 'slice_4'), device='cpu')
    want, got = _leaves(trainer.state.params), _leaves(back)
    assert set(got) == set(want)
    assert all(torch.equal(got[p], want[p]) for p in want)


@pytest.mark.parametrize('algo', ['dpo', 'sft', 'orpo', 'simpo', 'rm',
                                  'cost_model', 'rm_score', 'ppo',
                                  'multi_ppo'])
def test_module_entry_points(algo):
    """``python -m align_anything_tpu_torch.trainers.text_to_text.<algo>``
    exists and parses its command line (``--help`` exits before the
    trainer is built)."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run(
        [sys.executable, '-m',
         f'align_anything_tpu_torch.trainers.text_to_text.{algo}', '--help'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'usage' in proc.stdout
