"""The port's text-image-to-text trainers and frozen modules against the JAX
package's.

- ``freeze_labels`` and the optimizer with ``frozen_labels`` against
  ``optax.multi_transform`` (``'frozen'`` -> ``set_to_zero``): frozen
  leaves bit-equal, the trainable ones within 1e-6 after three steps with
  the clip active and weight decay on, the clip's norm over the trainable
  leaves only, and the same under gradient accumulation.
- TI2T SFT and TI2T DPO (``trainers/text_image_to_text/``) against the JAX
  trainers, driven the same way: configs parsed from the same command-line
  overrides, a one-layer LLaVA checkpoint on disk (built with
  ``transformers``), AA_TI2T rows with PNG images, fp32, on the CPU.  The
  JAX trainers run 8 CPU devices and multiply the per-device batch by 8;
  the port runs one device with 8x the per-device batch, so both see the
  same batches.  Per-step metrics to 1e-5 (rtol and atol), as
  ``tests/test_torch_trainers.py`` holds the text trainers; DPO's step 1
  at ln 2 to 1e-6.

The JAX TI2T SFT trainer cannot be built as it stands: its ``init_engines``
reads ``model_cfg.pp_stages``, which ``MultimodalConfig`` lacks (ROADMAP §3
R1).  The SFT comparison gives the JAX config class a ``pp_stages`` of 1
for the test's duration, which is what a text config holds.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
PIL = pytest.importorskip('PIL.Image')
pytest.importorskip('yaml')

from align_anything_tpu_torch.models.bridge import (  # noqa: E402
    trainable_from_jax_tree,
)
from align_anything_tpu_torch.trainers import base as tbase  # noqa: E402
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers import optimizer as topt  # noqa: E402
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    cost_model as tcost,
    dpo as tdpo,
    grpo as tgrpo,
    kto as tkto,
    orpo as torpo,
    ppo as tppo,
    rm as trm,
    saferlhf as tsafe,
    sft as tsft,
    simpo as tsimpo,
)
from align_anything_tpu_torch.utils.tools import param_leaves  # noqa: E402
from test_torch_rl_trainers import one_compile  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DEVICES = 8
TOL = 1e-5
IMAGE_TOKEN = 250


def make_assets(d, layers: int = 1, tower_layers: int = 2, rows: int = 16):
    """A tiny LLaVA checkpoint (``d / 'model'``), ``rows`` AA_TI2T
    preference rows (``pref.jsonl``) and supervised rows (``sft.jsonl``),
    each with its own 28x28 PNG."""
    torch.manual_seed(0)
    tc = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=layers, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=256,
        bos_token_id=1, eos_token_id=2, pad_token_id=0)
    vc = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=tower_layers,
        num_attention_heads=4, image_size=28, patch_size=14,
        hidden_act='quick_gelu')
    cfg = transformers.LlavaConfig(
        vision_config=vc, text_config=tc, image_token_index=IMAGE_TOKEN,
        vision_feature_layer=-2, vision_feature_select_strategy='default')
    transformers.LlavaForConditionalGeneration(cfg).eval().save_pretrained(
        d / 'model', safe_serialization=True)
    rng = np.random.default_rng(0)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps', 'zeta']

    def pick(k):
        return ' '.join(words[j] for j in rng.integers(0, 6, size=k))

    pref, sft = [], []
    for i in range(rows):
        img = d / f'img{i}.png'
        side = int(rng.integers(20, 40))
        PIL.fromarray(rng.integers(0, 256, size=(side, 28, 3)).astype(
            np.uint8)).save(img)
        pref.append({'question': f'what {pick(int(rng.integers(1, 4)))}',
                     'response_1': pick(int(rng.integers(1, 8))),
                     'response_2': pick(int(rng.integers(1, 8))),
                     'overall_response': int(rng.integers(1, 3)),
                     'image': str(img)})
        sft.append({'question': f'describe {pick(2)}',
                    'response': pick(int(rng.integers(1, 8))),
                    'image': str(img)})
    for name, data in (('pref', pref), ('sft', sft)):
        with open(d / f'{name}.jsonl', 'w') as f:
            f.writelines(json.dumps(r) + '\n' for r in data)
    return d


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return make_assets(tmp_path_factory.mktemp('ti2t_assets'))


def _argv(assets, algo, out, per_device, extra=()):
    data = 'sft' if algo == 'sft' else 'pref'
    kl = (('--per_device_kl_batch_size', str(per_device)) if algo == 'kto'
          else ())
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / f'{data}.jsonl'),
            '--train_template', 'AA_TI2T', '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[32]', '--save_checkpoint', 'False',
            '--per_device_train_batch_size', str(per_device), *kl, *extra]


PORT = {'sft': tsft.TI2TSupervisedTrainer, 'dpo': tdpo.TI2TDPOTrainer,
        'kto': tkto.TI2TKTOTrainer, 'orpo': torpo.TI2TORPOTrainer,
        'simpo': tsimpo.TI2TSimPOTrainer}
# KTO, ORPO and SimPO read the text tasks, as in JAX
TASK = {'sft': 'text_image_to_text/sft', 'dpo': 'text_image_to_text/dpo',
        'kto': 'text_to_text/kto', 'orpo': 'text_to_text/orpo',
        'simpo': 'text_to_text/simpo'}


def _port(assets, algo, out, extra=()):
    cfgs, pc = tcli.parse_cfgs(
        TASK[algo], _argv(assets, algo, out, JAX_DEVICES, extra))
    return PORT[algo](cfgs=cfgs, parallel_cfgs=pc, device='cpu')


def _jax(assets, algo, out, monkeypatch, extra=()):
    from align_anything_tpu.models import multimodal as jmm
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_image_to_text import (
        dpo,
        kto,
        orpo,
        sft,
        simpo,
    )

    # R1: the JAX SFT engine reads model_cfg.pp_stages (see the docstring)
    monkeypatch.setattr(jmm.MultimodalConfig, 'pp_stages', 1, raising=False)
    cls = {'sft': sft.TI2TSupervisedTrainer, 'dpo': dpo.TI2TDPOTrainer,
           'kto': kto.TI2TKTOTrainer, 'orpo': orpo.TI2TORPOTrainer,
           'simpo': simpo.TI2TSimPOTrainer}[algo]
    cfgs, pc = jcli.parse_cfgs(TASK[algo], _argv(assets, algo, out, 1, extra))
    return one_compile(cls(cfgs=cfgs, parallel_cfgs=pc))


def _steps(trainer, n):
    return [{k: float(v) for k, v in trainer.train_step(b).items()}
            for b in list(trainer.train_iterator.epoch_batches(0))[:n]]


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items()
                for p, leaf in _leaves(v, f'{prefix}/{k}').items()}
    return {prefix: np.array(tree.detach().cpu() if hasattr(tree, 'detach')
                             else tree)}


# ---------------------------------------------------------------------------
# freezing
# ---------------------------------------------------------------------------

def _mm_tree(seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {'language_model': {'embedding': r(8, 4),
                               'layers': {'q': {'w': r(2, 4, 2, 2)}}},
            'vision_tower': {'patch_embed': {'w': r(12, 4), 'b': r(4)},
                             'layers': {'up': {'w': r(2, 4, 6)}}},
            'projector': {'linear_0': {'w': r(4, 4), 'b': r(4)}}}


@pytest.mark.parametrize('mods', [(), ('vision_tower',),
                                  ('vision_tower', 'projector'),
                                  ('language_model',)])
def test_freeze_labels_match_jax(mods):
    from align_anything_tpu.trainers.optimizer import freeze_labels

    tree = _mm_tree()
    assert topt.freeze_labels(tree, mods) == freeze_labels(tree, mods)


def _optax_run(tree, grads, labels, accum, steps):
    import jax
    import jax.numpy as jnp
    import optax

    from align_anything_tpu.trainers.optimizer import make_optimizer

    tx, _ = make_optimizer(1e-2, weight_decay=0.1, max_grad_norm=1.0,
                           frozen_labels=labels,
                           gradient_accumulation_steps=accum)
    params = jax.tree.map(jnp.asarray, tree)
    state = tx.init(params)
    for g in grads[:steps]:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   params)
        params = optax.apply_updates(params, updates)
    return jax.tree.map(np.asarray, params)


def _torch_run(tree, grads, labels, accum, steps):
    tx, _ = topt.make_optimizer(1e-2, weight_decay=0.1, max_grad_norm=1.0,
                                frozen_labels=labels,
                                gradient_accumulation_steps=accum)
    params, _ = trainable_from_jax_tree(tree, device='cpu')
    state = tbase.init_train_state(params, tx)
    norms = []
    for g in grads[:steps]:
        state.optimizer.zero_grad(set_to_none=True)
        for t, gl, lab in zip(param_leaves(state.params), param_leaves(g),
                              param_leaves(labels)):
            if lab == 'train':
                t.grad = torch.from_numpy(gl.copy())
        norms.append(float(tx.apply_(state.optimizer, state.step)))
        state.step += 1
    return state, norms


@pytest.mark.parametrize('accum', [1, 2])
def test_frozen_optimizer_matches_optax(accum):
    """Three (accum 1) or four (accum 2) updates of AdamW with weight decay
    0.1 and a clip at 1.0 that every step triggers: frozen leaves bit-equal
    to the start, no AdamW state for them, the trainable ones within 1e-6
    of optax; the reported norm is the trainable leaves' norm only."""
    tree = _mm_tree()
    labels = topt.freeze_labels(tree, ('vision_tower',))
    grads = [_mm_tree(seed) for seed in range(1, 5)]
    steps = 3 if accum == 1 else 4
    want = _optax_run(tree, grads, labels, accum, steps)
    state, norms = _torch_run(tree, grads, labels, accum, steps)
    got = _leaves(state.params)
    flat_want = _leaves(want)
    flat_labels = _leaves(tree)
    for path, w in flat_want.items():
        if path.startswith('/vision_tower'):
            np.testing.assert_array_equal(got[path], flat_labels[path])
        else:
            np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=1e-6,
                                       err_msg=path)
            assert not np.array_equal(got[path], flat_labels[path]), path
    inner = (state.optimizer.inner if accum > 1 else state.optimizer)
    held = {id(p) for g in inner.param_groups for p in g['params']}
    frozen = param_leaves(state.params['vision_tower'])
    assert all(id(t) not in held and not t.requires_grad for t in frozen)
    assert all(id(t) not in inner.state for t in frozen)
    for g, n in zip(grads, norms):
        trainable = [v for k, v in _leaves(g).items()
                     if not k.startswith('/vision_tower')]
        want_norm = math.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                                  for v in trainable))
        assert n == pytest.approx(want_norm, rel=1e-6)
        assert n > 1.0          # the clip is active


def test_init_train_state_takes_frozen_leaves():
    """A leaf labelled frozen may lack ``requires_grad`` (and is set not to
    require it); one that is not labelled frozen still raises."""
    tree = _mm_tree()
    labels = topt.freeze_labels(tree, ('vision_tower',))
    tx, _ = topt.make_optimizer(1e-3, frozen_labels=labels)
    params, _ = trainable_from_jax_tree(tree, device='cpu')
    params['vision_tower']['patch_embed']['b'].requires_grad_(False)
    state = tbase.init_train_state(params, tx)
    assert not any(t.requires_grad
                   for t in param_leaves(state.params['vision_tower']))
    params, _ = trainable_from_jax_tree(tree, device='cpu')
    params['projector']['linear_0']['b'].requires_grad_(False)
    with pytest.raises(ValueError, match='requires_grad'):
        tbase.init_train_state(params, tx)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

def _compare(got, want):
    assert len(got) == len(want) > 0
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(w) <= set(g), set(w) - set(g)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, atol=TOL,
                                       err_msg=f'step {step + 1} {key}')


@pytest.mark.parametrize('algo', ['sft', 'dpo'])
def test_ti2t_steps_match_jax(assets, tmp_path, monkeypatch, algo):
    """Two steps of 8 rows (pairs), every metric the JAX trainer reports;
    the tower frozen (the YAML's default) stays bit-equal in the port; DPO's
    step 1 at ln 2."""
    want = _steps(_jax(assets, algo, tmp_path / 'jax', monkeypatch), 2)
    trainer = _port(assets, algo, tmp_path / 'port')
    tower = _leaves(trainer.state.params['vision_tower'])
    got = _steps(trainer, 2)
    _compare(got, want)
    assert got[0]['train/loss'] != got[1]['train/loss']
    for path, leaf in _leaves(trainer.state.params['vision_tower']).items():
        np.testing.assert_array_equal(leaf, tower[path])
    if algo == 'dpo':
        assert abs(got[0]['train/loss'] - math.log(2)) <= 1e-6
        assert abs(want[0]['train/loss'] - math.log(2)) <= 1e-6


@pytest.mark.parametrize('algo', ['kto', 'orpo', 'simpo'])
def test_ti2t_dpo_family_steps_match_jax(assets, tmp_path, monkeypatch, algo):
    """Two steps of 8 pairs of TI2T KTO (the KL baseline refreshed before
    step 2), ORPO and SimPO against JAX's: every metric (KTO's
    ``train/kl_baseline`` too), and the policy
    after the steps.  Their text YAMLs set no freeze flag, so the tower
    trains, in both packages; the reference-free two hold no reference."""
    extra = ('--kl_steps', '1') if algo == 'kto' else ()
    jtrainer = _jax(assets, algo, tmp_path / 'jax', monkeypatch, extra)
    trainer = _port(assets, algo, tmp_path / 'port', extra)
    assert trainer.frozen_modules() == ()
    assert (trainer.ref_params is None) == (algo != 'kto')
    tower = {p: v.copy()
             for p, v in _leaves(trainer.state.params['vision_tower']).items()}
    want = _steps(jtrainer, 2)
    got = _steps(trainer, 2)
    _compare(got, want)
    assert got[0]['train/loss'] != got[1]['train/loss']
    for path, leaf in _leaves(trainer.state.params).items():
        np.testing.assert_allclose(
            leaf, np.asarray(_leaves(jtrainer.state.params)[path]),
            rtol=TOL, atol=TOL, err_msg=path)
    moved = _leaves(trainer.state.params['vision_tower'])
    assert any(not np.array_equal(moved[p], tower[p]) for p in tower)
    if algo == 'kto':
        # before any update exactly 0; refreshed (and clamped at 0) after
        assert got[0]['train/kl_baseline'] == 0.0
        assert got[1]['train/kl_baseline'] >= 0.0


def test_ti2t_kto_kl_baseline_has_no_images(assets, tmp_path, monkeypatch):
    """R14, in both packages: the KL baseline's unmatched rows come from
    AA_TI2T's ``format_unmatched_supervised_sample``, which drops the
    image, so the KL batch holds neither ``pixel_values`` nor image tokens
    and the estimate is the policy's against the reference over text
    alone."""
    jtrainer = _jax(assets, 'kto', tmp_path / 'jax', monkeypatch)
    trainer = _port(assets, 'kto', tmp_path / 'port')
    for t in (jtrainer, trainer):
        batch = next(iter(t.kl_iterator.epoch_batches(0)))
        assert 'pixel_values' not in batch
        assert not (batch['input_ids'] == IMAGE_TOKEN).any()
        train = next(iter(t.train_iterator.epoch_batches(0)))
        assert 'pixel_values' in train
        assert (train['input_ids'] == IMAGE_TOKEN).sum() > 0
    np.testing.assert_array_equal(
        next(iter(trainer.kl_iterator.epoch_batches(0)))['input_ids'],
        next(iter(jtrainer.kl_iterator.epoch_batches(0)))['input_ids'])


@pytest.mark.parametrize('flags,frozen', [
    (('--freeze_vision_tower', 'False'), ()),
    (('--freeze_vision_tower', 'True', '--freeze_mm_proj', 'True'),
     ('vision_tower', 'projector')),
])
def test_ti2t_sft_freeze_flags(assets, tmp_path, flags, frozen):
    """One SFT step at lr 1e-2: the modules the flags freeze stay
    bit-equal, the others move (the tower too when it trains)."""
    trainer = _port(assets, 'sft', tmp_path,
                    ('--learning_rate', '1e-2', *flags))
    before = {k: _leaves(v) for k, v in trainer.state.params.items()}
    _steps(trainer, 1)
    for module, leaves in before.items():
        after = _leaves(trainer.state.params[module])
        moved = any(not np.array_equal(after[p], leaves[p]) for p in leaves)
        assert moved == (module not in frozen), module
        held = {id(p) for g in trainer.state.optimizer.param_groups
                for p in g['params']}
        assert all((id(t) in held) == (module not in frozen)
                   for t in param_leaves(trainer.state.params[module]))


def test_ti2t_dpo_trainer_main(assets, tmp_path):
    """``trainer_main(TI2TDPOTrainer, ...)`` trains every step, and its
    LLaVA-layout export loads back with the port's loader equal to the
    trained params (fp32) and with the frozen tower as loaded."""
    from align_anything_tpu_torch.models.hf_loader import (
        load_multimodal_params,
    )

    trainer = tcli.trainer_main(
        tdpo.TI2TDPOTrainer, 'text_image_to_text/dpo',
        _argv(assets, 'dpo', tmp_path, 4), device='cpu')
    assert trainer.global_step == 4
    back, cfg = load_multimodal_params(str(tmp_path / 'slice_4'),
                                       device='cpu')
    assert cfg.image_token_id == IMAGE_TOKEN
    want = _leaves(trainer.state.params)
    for path, leaf in _leaves(back).items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
    start, _ = load_multimodal_params(str(assets / 'model'), device='cpu')
    for path, leaf in _leaves(start['vision_tower']).items():
        np.testing.assert_array_equal(leaf, want['/vision_tower' + path])


def test_ti2t_dpo_reference_shares_only_frozen_modules(assets, tmp_path):
    """The reference holds the policy's own tensors for the frozen tower
    and copies of the rest; after a step the copies still hold the
    starting policy, while the policy's language model has moved."""
    trainer = _port(assets, 'dpo', tmp_path, ('--learning_rate', '1e-2'))
    ref, policy = trainer.ref_params, trainer.state.params
    start = {k: _leaves(v) for k, v in ref.items()}
    for module in ('vision_tower', 'language_model', 'projector'):
        shared = [a.data_ptr() == b.data_ptr() for a, b in zip(
            param_leaves(ref[module]), param_leaves(policy[module]))]
        assert all(shared) if module == 'vision_tower' else not any(shared)
    _steps(trainer, 1)
    for module, leaves in start.items():
        for path, leaf in _leaves(ref[module]).items():
            np.testing.assert_array_equal(leaf, leaves[path])
    moved = _leaves(policy['language_model'])
    assert any(not np.array_equal(moved[p], start['language_model'][p])
               for p in moved)


def test_build_optimizer_refuses_freeze_flags_without_params(assets,
                                                             tmp_path):
    """Freeze flags with no param tree to label raise rather than build an
    optimizer that would train the modules they name."""
    trainer = _port(assets, 'sft', tmp_path)
    assert trainer.frozen_modules() == ('vision_tower',)
    assert not hasattr(trainer, 'params')  # init_engines moved them
    with pytest.raises(ValueError, match='freeze flags'):
        trainer.build_optimizer(1)


def test_ti2t_trainers_default_to_the_card(assets, tmp_path, monkeypatch):
    """No device given: every TI2T trainer takes the first CUDA device, and
    raises where there is none."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model = str(assets / 'model')
    rl = ['--actor_model_name_or_path', model,
          '--reward_model_name_or_path', model,
          '--train_datasets', str(assets / 'pref.jsonl'),
          '--train_template', 'AA_TI2T', '--per_device_prompt_batch_size',
          '8']
    cases = [(cls, TASK[algo], _argv(assets, algo, tmp_path, 8))
             for algo, cls in PORT.items()]
    cases += [(trm.TI2TRMTrainer, 'text_image_to_text/rm',
               _argv(assets, 'dpo', tmp_path, 8)),
              (tcost.TI2TCostModelTrainer, 'text_image_to_text/rm',
               _argv(assets, 'dpo', tmp_path, 8)),
              (tppo.TI2TPPOTrainer, 'text_image_to_text/ppo', rl),
              (tgrpo.TI2TGRPOTrainer, 'text_image_to_text/grpo', rl),
              (tsafe.TI2TSafeRLHFTrainer, 'text_image_to_text/saferlhf', rl)]
    for cls, task, argv in cases:
        cfgs, pc = tcli.parse_cfgs(task, argv)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            cls(cfgs=cfgs, parallel_cfgs=pc)


def test_ti2t_loader_refuses_other_families(tmp_path):
    """A vision-LM ``model_type`` not ported yet raises and names the
    ROADMAP item; the LLaVA-only loader of the RM and RL trainers (JAX's
    ``load_multimodal_params``) refuses Qwen2-VL too."""
    (tmp_path / 'config.json').write_text(json.dumps(
        {'model_type': 'minicpmo'}))
    with pytest.raises(NotImplementedError, match='item 12'):
        tsft.load_vision_lm(str(tmp_path), device='cpu')
    (tmp_path / 'config.json').write_text(json.dumps(
        {'model_type': 'qwen2_vl'}))
    with pytest.raises(NotImplementedError, match='item 12'):
        tsft.load_llava_lm(str(tmp_path), device='cpu')


@pytest.mark.parametrize('algo', ['sft', 'dpo', 'rm', 'cost_model', 'ppo',
                                  'grpo', 'saferlhf', 'kto', 'orpo', 'simpo'])
def test_ti2t_entry_point(algo):
    """``python -m align_anything_tpu_torch.trainers.text_image_to_text.
    <algo>`` exists and parses its command line (``--help`` exits before
    the trainer is built)."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run(
        [sys.executable, '-m',
         f'align_anything_tpu_torch.trainers.text_image_to_text.{algo}',
         '--help'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'usage' in proc.stdout
