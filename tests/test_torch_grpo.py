"""The port's GRPO trainer (``align_anything_tpu_torch/trainers/text_to_text/
grpo.py``) against the JAX package's, on the assets and helpers of
``tests/test_torch_rl_trainers.py``: a tiny Llama checkpoint, a reward model
beside it with ``score_head.npy``, local prompt rows, fp32, on the CPU.

Global batch: the JAX trainer multiplies ``per_device_prompt_batch_size``
(and the eval batch) by ``jax.device_count()``, 8 here; the port takes 8x
the JAX per-device sizes.

The rollout is fixed: both packages' ``generate`` are patched to return
one block built with numpy (the collator's left-padded prompts, each
repeated ``num_generations`` times, then completions of differing lengths
ending in EOS and pad), with its ``completion_mask``.

Tolerances: metrics and parameters to 1e-5 (rtol and atol), as
``tests/test_torch_rl_trainers.py``.  Round 1's ``train/kl`` is exactly 0
in the port (the policy's pass and the reference's are the same fp32 ops
on one CPU thread, one under autograd).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('transformers')
pytest.importorskip('yaml')

from align_anything_tpu_torch import generation as tgen  # noqa: E402
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_to_text import (  # noqa: E402
    grpo as tgrpo,
)
from test_torch_rl_trainers import (  # noqa: E402,F401  (a fixture)
    NEW_TOKENS,
    PAD,
    REPO,
    TOL,
    _block,
    _both,
    _compare,
    _compare_trees,
    _leaves,
    _scaled,
    make_assets,
    one_thread,
)


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """``tests/test_torch_rl_trainers.py``'s assets with a one-layer model:
    the JAX trainer's compile time grows with the depth, and one layer
    holds the trainer's logic."""
    return make_assets(tmp_path_factory.mktemp('grpo_assets'), layers=1)


GROUP = 2
SCALED = ('per_device_prompt_batch_size', 'per_device_eval_batch_size')


def _fix_generate(monkeypatch):
    """Both packages' ``generate`` (the trainer's and the generation
    eval's) return the numpy block with its completion mask."""
    import jax.numpy as jnp
    from align_anything_tpu import generation as jgen
    from align_anything_tpu.trainers.text_to_text import grpo as jgrpo

    def block(input_ids, attention_mask):
        ids, mask, comp = _block(input_ids, attention_mask, 256, PAD)
        return {'sequences': ids, 'attention_mask': mask,
                'completions': comp,
                'completion_mask': (comp != PAD).astype(np.int64)}

    def jax_generate(params, model_cfg, gen_cfg, input_ids, attention_mask,
                     *args, **kwargs):
        return {k: jnp.asarray(v, jnp.int32) for k, v in block(
            np.asarray(input_ids), np.asarray(attention_mask)).items()}

    def torch_generate(params, model_cfg, gen_cfg, input_ids, attention_mask,
                       *args, **kwargs):
        return {k: torch.as_tensor(v, device=input_ids.device)
                for k, v in block(input_ids.cpu().numpy(),
                                  attention_mask.cpu().numpy()).items()}

    for module, fn in ((jgrpo, jax_generate), (jgen, jax_generate),
                       (tgrpo, torch_generate), (tgen, torch_generate)):
        monkeypatch.setattr(module, 'generate', fn)


def _argv(assets, out, extra=()):
    return ['--actor_model_name_or_path', str(assets / 'model'),
            '--reward_model_name_or_path', str(assets / 'reward'),
            '--train_datasets', str(assets / 'prompts.jsonl'),
            '--train_template', 'PKUSafeRLHF', '--output_dir', str(out),
            '--epochs', '1', '--max_new_tokens', str(NEW_TOKENS),
            '--bf16', 'False', '--padding_buckets', '[16]',
            '--save_checkpoint', 'False', '--learning_rate', '1e-4',
            '--num_generations', str(GROUP),
            '--per_device_prompt_batch_size', '1', *extra]


def test_grpo_round_matches_jax(assets, tmp_path, monkeypatch, one_thread):
    """One round (8 prompts x 2 generations, one update over the 16 rows)
    against JAX's: every metric, the actor's leaves after the update, and
    the generation eval (its table and ``eval/reward``)."""
    from align_anything_tpu.trainers.text_to_text.grpo import GRPOTrainer

    _fix_generate(monkeypatch)
    extra = ('--eval_datasets', str(assets / 'prompts.jsonl'),
             '--eval_size', '8', '--per_device_eval_batch_size', '1')
    jtrainer, trainer = _both(GRPOTrainer, tgrpo.GRPOTrainer,
                              'text_to_text/grpo',
                              _argv(assets, tmp_path, extra), SCALED)
    actor0 = {p: v.copy()
              for p, v in _leaves(trainer.actor_state.params).items()}
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    np.testing.assert_array_equal(batch['input_ids'], jbatch['input_ids'])
    assert batch['input_ids'].shape == (8, 16)
    want = {k: float(v) for k, v in jtrainer.train_step(jbatch).items()}
    got = trainer.train_step(batch)
    assert got['train/kl'] == 0.0 and abs(want['train/kl']) <= TOL
    _compare([got], [want])
    assert got['perf/generated_tokens'] > 0
    assert trainer.actor_state.step == 1
    _compare_trees(trainer.actor_state.params, jtrainer.actor_state.params)
    moved = max(float(np.abs(v - actor0[p]).max())
                for p, v in _leaves(trainer.actor_state.params).items())
    assert 5e-5 < moved < 1e-3
    _compare([trainer.eval()], [jtrainer.eval()])


def test_grpo_trainer_main(assets, tmp_path, monkeypatch):
    """``trainer_main(GRPOTrainer, ...)`` runs every round (24 prompts, 8 a
    round) and exports the actor's slice, which reads back equal to the
    trained params; with ``--use_lora`` it trains the full actor, as JAX's
    GRPO does (ROADMAP R17)."""
    from align_anything_tpu_torch.models.hf_loader import load_params

    _fix_generate(monkeypatch)
    argv = _scaled(_argv(assets, tmp_path), SCALED)
    trainer = tcli.trainer_main(tgrpo.GRPOTrainer, 'text_to_text/grpo', argv,
                                device='cpu')
    assert trainer.global_step == 3
    back, _ = load_params(str(tmp_path / 'slice_3'), device='cpu')
    _compare_trees(back, trainer.actor_state.params, 0)
    lora = tcli.trainer_main(tgrpo.GRPOTrainer, 'text_to_text/grpo',
                             argv + ['--use_lora', 'True'], device='cpu')
    assert lora.global_step == 3 and not lora.use_lora
    _compare_trees(lora.actor_state.params, trainer.actor_state.params)


def test_grpo_entry_point():
    """``python -m align_anything_tpu_torch.trainers.text_to_text.grpo``
    exists and parses its command line."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run(
        [sys.executable, '-m',
         'align_anything_tpu_torch.trainers.text_to_text.grpo', '--help'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'usage' in proc.stdout
