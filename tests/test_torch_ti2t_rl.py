"""The port's Safe-RLHF-V and TI2T GRPO (``align_anything_tpu_torch/
trainers/text_image_to_text/{saferlhf,grpo}.py``) against the JAX
package's, on the assets and helpers of ``tests/test_torch_ti2t_rm_ppo.py``:
a tiny LLaVA checkpoint (two text layers, a two-layer tower), reward and
cost models beside it with ``score_head.npy``, AA_TI2T prompt rows with
PNG images, fp32, on the CPU, with both packages' TI2T ``generate``
patched to one numpy block.

Global batch: the JAX trainers multiply the prompt batch and the
micro-batch by ``jax.device_count()``, 8 here; the port takes 8x the JAX
per-device sizes.

Tolerances: metrics and parameters to 1e-5 (rtol and atol), as
``tests/test_torch_rl_trainers.py``; ``train/log_lambda`` to 1e-6 (one
float64 SGD step on the host from float32 costs).  Round 1's KL is
exactly 0 in the port (one CPU thread).

Safe-RLHF-V is also where the text trainer's cost scoring meets media:
its rollout hands the cost model and the cost critic the rollout's
``pixel_values``, as JAX's does (``trainers/text_to_text/saferlhf.py``
``rollout``).  R13: the towers of the trained models move in both
packages, as in TI2T PPO.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('transformers')
pytest.importorskip('PIL.Image')
pytest.importorskip('yaml')

from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    grpo as tgrpo,
    rm as trm,
    saferlhf as tsafe,
)
from test_torch_rl_trainers import (  # noqa: E402,F401  (a fixture)
    NEW_TOKENS,
    _both,
    _compare,
    _compare_trees,
    one_thread,
)
from test_torch_ti2t_rm_ppo import (  # noqa: E402
    PPO_SCALED,
    _ppo_argv,
    _round,
    _tower_moves_in_both,
    fix_rollouts,
    make_rl_assets,
    module_moved,
    snapshot,
)

LAMBDA_TOL = 1e-6
GROUP = 2


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return make_rl_assets(tmp_path_factory.mktemp('ti2t_rl_assets'))


def test_ti2t_saferlhf_round_matches_jax(assets, tmp_path, monkeypatch,
                                         one_thread):
    """One Safe-RLHF-V round against JAX's: every reported metric, the
    actor, reward critic and cost critic after their updates, the
    multiplier's first update in closed form; the cost scores are those of
    the rollout WITH its images (the media reach the cost model)."""
    from align_anything_tpu.trainers.text_image_to_text.saferlhf import (
        TI2TSafeRLHFTrainer,
    )

    fix_rollouts(monkeypatch)
    argv = _ppo_argv(assets, tmp_path, (
        '--cost_model_name_or_path', str(assets / 'cost')))
    jtrainer, trainer = _both(TI2TSafeRLHFTrainer, tsafe.TI2TSafeRLHFTrainer,
                             'text_image_to_text/saferlhf', argv, PPO_SCALED)
    names = ('actor_state', 'critic_state', 'cost_critic_state')
    start = {n: snapshot(getattr(trainer, n).params) for n in names}
    jstart = {n: snapshot(getattr(jtrainer, n).params) for n in names}
    seen = {}
    score_cost = tsafe.TI2TSafeRLHFTrainer.score_cost

    def recording(self, seq, mask, **media):
        seen.update(seq=seq, mask=mask, media=media)
        return score_cost(self, seq, mask, **media)

    monkeypatch.setattr(tsafe.TI2TSafeRLHFTrainer, 'score_cost', recording)
    got, want = _round(jtrainer, trainer)
    assert got['train/kl_divergence'] == 0.0
    _compare([got], [want])
    np.testing.assert_allclose(got['train/log_lambda'],
                               want['train/log_lambda'], rtol=LAMBDA_TOL,
                               atol=LAMBDA_TOL)
    assert got['train/log_lambda'] == pytest.approx(
        0.04 * got['train/episode_cost'], abs=1e-12)
    for name in names:
        _compare_trees(getattr(trainer, name).params,
                       getattr(jtrainer, name).params)
    _tower_moves_in_both(trainer, jtrainer, names, start, jstart)

    assert set(seen['media']) == {'pixel_values'}
    batch = {'input_ids': seen['seq'], 'attention_mask': seen['mask']}
    with torch.no_grad():
        with_images = trm.multimodal_end_scores(
            trainer.cost_params, trainer.cost_cfg,
            dict(batch, pixel_values=seen['media']['pixel_values']))
        without = trm.multimodal_end_scores(trainer.cost_params,
                                            trainer.cost_cfg, batch)
    costs = np.asarray(trainer.episode_costs, np.float32)
    np.testing.assert_array_equal(costs, with_images.numpy())
    assert not np.allclose(costs, without.numpy(), rtol=1e-3, atol=0)


def test_ti2t_grpo_step_matches_jax(assets, tmp_path, monkeypatch,
                                    one_thread, capsys):
    """One GRPO round (8 image prompts x 2 generations, one update over
    the 16 rows) against JAX's on the same sequences: every metric and the
    actor's leaves; step 1's KL exactly 0; the rows of a group share their
    prompt's pixels; the tower trains in both packages (R13)."""
    from align_anything_tpu.trainers.text_image_to_text.grpo import (
        TI2TGRPOTrainer,
    )

    fix_rollouts(monkeypatch)
    argv = ['--actor_model_name_or_path', str(assets / 'model'),
            '--reward_model_name_or_path', str(assets / 'reward'),
            '--train_datasets', str(assets / 'prompts.jsonl'),
            '--train_template', 'AA_TI2T', '--output_dir', str(tmp_path),
            '--epochs', '1', '--max_new_tokens', str(NEW_TOKENS),
            '--bf16', 'False', '--padding_buckets', '[32]',
            '--save_checkpoint', 'False', '--learning_rate', '1e-4',
            '--num_generations', str(GROUP),
            '--per_device_prompt_batch_size', '1']
    jtrainer, trainer = _both(TI2TGRPOTrainer, tgrpo.TI2TGRPOTrainer,
                             'text_image_to_text/grpo', argv,
                             ('per_device_prompt_batch_size',))
    assert 'R13' in capsys.readouterr().out
    assert trainer.cfgs.train_cfgs.freeze_vision_tower is True
    start = snapshot(trainer.actor_state.params)
    jstart = snapshot(jtrainer.actor_state.params)
    seen = {}
    step = trainer._step

    def recording(state, batch, p):
        seen.update(batch)
        return step(state, batch, p)

    trainer._step = recording
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    np.testing.assert_array_equal(batch['input_ids'], jbatch['input_ids'])
    got = trainer.train_step(batch)
    want = {k: float(v) for k, v in jtrainer.train_step(jbatch).items()}
    assert got['train/kl'] == 0.0
    _compare([got], [want])
    _compare_trees(trainer.actor_state.params, jtrainer.actor_state.params)
    pixels = seen['pixel_values']
    assert pixels.shape[0] == 16
    assert torch.equal(pixels[0], pixels[1])
    assert not torch.equal(pixels[1], pixels[2])
    for params, s in ((trainer.actor_state.params, start),
                      (jtrainer.actor_state.params, jstart)):
        assert module_moved(params, s) == {'language_model': True,
                                           'vision_tower': True,
                                           'projector': True}
