"""The port's text-video-to-text trainers
(``align_anything_tpu_torch/trainers/text_video_to_text/{sft,dpo,rm,ppo,
grpo}.py``) against the JAX package's, one-layer steps on a tiny
LLaVA-NeXT-Video checkpoint (``tests/test_torch_llava_next_video.py``
``make_tv2t_assets``), fp32 on the CPU, driven the same way: configs
parsed from the same command-line overrides, 8x the per-device batch in
the port (JAX runs 8 CPU devices).

Tolerances: the batches exactly; metrics and leaves to 1e-5 (rtol and
atol), as ``tests/test_torch_ti2t_rm_ppo.py``: the RL rollouts fixed to
one numpy block in both packages, one CPU thread for round 1's exact KL.

R1: the JAX SFT trainer needs ``MultimodalConfig.pp_stages`` patched to
1.  R26: DPO and RM expand <video> to the image token and say so at
start-up (``tests/test_torch_llava_next_video.py`` shows the video is
dropped).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('transformers')
pytest.importorskip('yaml')

from align_anything_tpu.models import multimodal as jmm  # noqa: E402
from align_anything_tpu_torch.trainers.text_video_to_text import (  # noqa: E402
    dpo as tdpo,
    grpo as tgrpo,
    ppo as tppo,
    rm as trm,
    sft as tsft,
)
from test_torch_llava_next_video import (  # noqa: E402
    HIDDEN,
    IMAGE_TOKEN,
    PATCHES,
    POOLED,
    VIDEO_TOKEN,
    _argv,
    _equal,
    _rl_argv,
    make_tv2t_assets,
)
from test_torch_rl_trainers import (  # noqa: E402,F401  (a fixture)
    _both,
    _compare,
    _compare_trees,
    _leaves,
    one_thread,
)
from test_torch_ti2t_rm_ppo import fix_rollouts  # noqa: E402


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return make_tv2t_assets(tmp_path_factory.mktemp('tv2t_assets'))


def _jax_trainer_cls(algo):
    from align_anything_tpu.trainers.text_video_to_text import (
        dpo,
        rm,
        sft,
    )

    return {'sft': sft.TV2TSupervisedTrainer, 'dpo': dpo.TV2TDPOTrainer,
            'rm': rm.TV2TRMTrainer}[algo]


PORT = {'sft': tsft.TV2TSupervisedTrainer, 'dpo': tdpo.TV2TDPOTrainer,
        'rm': trm.TV2TRMTrainer}


@pytest.mark.parametrize('algo', ['sft', 'dpo', 'rm'])
def test_tv2t_steps_match_jax(assets, tmp_path, monkeypatch, algo, capsys):
    """Two steps of 8 rows (pairs) against JAX's: the batches, every
    metric and every leaf; the tower (frozen by the YAMLs) bit-equal.
    SFT's rows hold n_frames x the pooled grid of the video token; DPO's
    and RM's n_frames x the full grid of the image token (R26, said at
    start-up)."""
    import jax.numpy as jnp_

    # R1: the JAX SFT engine reads model_cfg.pp_stages
    monkeypatch.setattr(jmm.MultimodalConfig, 'pp_stages', 1, raising=False)
    task = f'text_video_to_text/{algo}'
    jtrainer, trainer = _both(_jax_trainer_cls(algo), PORT[algo], task,
                             _argv(assets, tmp_path),
                             ('per_device_train_batch_size',))
    assert ('R26' in capsys.readouterr().out) == (algo != 'sft')
    if algo == 'rm':
        head = np.random.default_rng(3).standard_normal((HIDDEN, 1)).astype(
            np.float32) / 8
        jtrainer.state = dataclasses.replace(jtrainer.state, params=dict(
            jtrainer.state.params, score_head={'w': jnp_.asarray(head)}))
        with torch.no_grad():
            trainer.state.params['score_head']['w'].copy_(
                torch.from_numpy(head))
    batches = list(trainer.train_iterator.epoch_batches(0))[:2]
    jbatches = list(jtrainer.train_iterator.epoch_batches(0))[:2]
    for b, jb in zip(batches, jbatches):
        _equal(b, jb)
    token, per = ((VIDEO_TOKEN, POOLED) if algo == 'sft'
                  else (IMAGE_TOKEN, PATCHES))
    assert ((batches[0]['input_ids'] == token).sum(-1) == 2 * per).all()
    assert batches[0]['pixel_values'].shape[1:] == (2, 3, 32, 32)
    tower = {p: v.copy() for p, v in
             _leaves(trainer.state.params['vision_tower']).items()}
    got = [trainer.train_step(b) for b in batches]
    want = [{k: float(v) for k, v in jtrainer.train_step(b).items()}
            for b in jbatches]
    _compare(got, want)
    _compare_trees(trainer.state.params, jtrainer.state.params)
    for path, leaf in _leaves(trainer.state.params['vision_tower']).items():
        np.testing.assert_array_equal(leaf, tower[path])


def test_tv2t_ppo_round_matches_jax(assets, tmp_path, monkeypatch,
                                    one_thread):
    """One TV2T PPO round (8 video prompts, micro-batches of 8) against
    JAX's on the same sequences: 5-D pixels through the prefill, the
    scoring and the updates; every metric; the actor and critic after the
    round; round 1's KL exactly 0."""
    from align_anything_tpu.trainers.text_video_to_text.ppo import (
        TV2TPPOTrainer,
    )

    fix_rollouts(monkeypatch)
    argv = _rl_argv(assets, tmp_path, (
        '--n_frames', '2', '--padding_buckets', '[64]', '--actor_lr', '1e-4',
        '--critic_lr', '1e-4', '--per_device_train_batch_size', '1'))
    jtrainer, trainer = _both(
        TV2TPPOTrainer, tppo.TV2TPPOTrainer, 'text_video_to_text/ppo', argv,
        ('per_device_prompt_batch_size', 'per_device_train_batch_size'))
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    _equal(batch, jbatch)
    assert batch['meta'][0]['pixel_values'].shape == (2, 3, 32, 32)
    got = trainer.train_step(batch)
    want = {k: float(v) for k, v in jtrainer.train_step(jbatch).items()}
    assert got['train/kl_divergence'] == 0.0
    _compare([got], [want])
    for name in ('actor_state', 'critic_state'):
        _compare_trees(getattr(trainer, name).params,
                       getattr(jtrainer, name).params)


def test_tv2t_grpo_round_matches_jax(assets, tmp_path, monkeypatch,
                                     one_thread):
    """One TV2T GRPO round (8 video prompts x 2 generations) against
    JAX's on the same sequences.  Both read the task
    ``text_image_to_text/grpo``, whose YAML has no ``n_frames``: 8 frames
    a prompt."""
    from align_anything_tpu.trainers.text_video_to_text.grpo import (
        TV2TGRPOTrainer,
    )

    fix_rollouts(monkeypatch)
    argv = _rl_argv(assets, tmp_path, (
        '--padding_buckets', '[192]', '--learning_rate', '1e-4',
        '--num_generations', '2'))
    jtrainer, trainer = _both(TV2TGRPOTrainer, tgrpo.TV2TGRPOTrainer,
                             'text_image_to_text/grpo', argv,
                             ('per_device_prompt_batch_size',))
    batch = next(trainer.train_iterator.epoch_batches(0))
    jbatch = next(jtrainer.train_iterator.epoch_batches(0))
    _equal(batch, jbatch)
    assert batch['meta'][0]['pixel_values'].shape == (8, 3, 32, 32)
    got = trainer.train_step(batch)
    want = {k: float(v) for k, v in jtrainer.train_step(jbatch).items()}
    assert got['train/kl'] == 0.0
    _compare([got], [want])
    _compare_trees(trainer.actor_state.params, jtrainer.actor_state.params)


