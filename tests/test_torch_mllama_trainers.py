"""The port's text-image-to-text trainers on an Mllama checkpoint against
the JAX package's, on the CPU: one step each of TI2T SFT, DPO, KTO, ORPO
and SimPO through the same command lines (their metrics, their batches and
every param after the step); ROADMAP §3 R30 in both packages; and
``trainer_main`` SFT with its export read back by both loaders.

The checkpoint is ``tests/test_torch_mllama.py``'s tiny transformers
Mllama (3 text layers, layer 1 cross; 2 local + 1 global tower layers),
its tree perturbed (transformers starts every gate at 0, which would keep
the image from the text and the tower from any gradient) and written by
JAX's writer.  Rows are AA_TI2T over PNG files of 28 x 28, 28 x 56 and
56 x 28 (1 and 2 tiles of 28 px; aspect-ratio ids 1, 2 and 3).  As in
``tests/test_torch_qwen2_vl_trainers.py``: the JAX trainers run 8 CPU
devices with a per-device batch of 1, the port one device with 8; metrics
and params to 1e-5; each JAX trainer is built once, and the JAX SFT
trainer gets a ``pp_stages`` of 1 on ``MllamaConfig`` (R1).  The TI2T
YAMLs' ``freeze_vision_tower: True`` names ``vision_tower``, which an
Mllama tree does not hold (its tower is ``vision_model``): the tower
trains in both packages (R30).
"""

import contextlib
import io
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
PIL = pytest.importorskip('PIL.Image')
pytest.importorskip('yaml')

from align_anything_tpu_torch.models import mllama as tm  # noqa: E402
from align_anything_tpu_torch.models.hf_loader import (  # noqa: E402
    load_mllama_params as tload,
)
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    dpo as tdpo,
    kto as tkto,
    orpo as torpo,
    sft as tsft,
    simpo as tsimpo,
)
from align_anything_tpu_torch.utils.tools import param_leaves  # noqa: E402
from test_torch_mllama import (  # noqa: E402
    IMG,
    leaves,
    perturbed,
    write_hf_mllama,
)
from test_torch_ti2t_trainers import _compare, _steps  # noqa: E402

JAX_DEVICES = 8
TOL = 1e-5
ROWS = 8
SIZES = ((28, 28), (28, 56), (56, 28))
PORT = {'sft': tsft.TI2TSupervisedTrainer, 'dpo': tdpo.TI2TDPOTrainer,
        'kto': tkto.TI2TKTOTrainer, 'orpo': torpo.TI2TORPOTrainer,
        'simpo': tsimpo.TI2TSimPOTrainer}
# KTO, ORPO and SimPO read the text tasks, as in JAX
TASK = {'sft': 'text_image_to_text/sft', 'dpo': 'text_image_to_text/dpo',
        'kto': 'text_to_text/kto', 'orpo': 'text_to_text/orpo',
        'simpo': 'text_to_text/simpo'}


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """The perturbed checkpoint (``model``), ``ROWS`` preference rows
    (``pref.jsonl``) and supervised rows (``sft.jsonl``), each with its
    own PNG of one of ``SIZES``."""
    from align_anything_tpu.models.hf_loader import (
        load_mllama_params as jload,
        save_mllama_params as jsave,
    )

    d = tmp_path_factory.mktemp('mllama_assets')
    hf = write_hf_mllama(d / 'hf')
    params, cfg = jload(str(hf))
    jsave(str(d / 'model'), perturbed(params), cfg)
    rng = np.random.default_rng(0)
    words = [f'w{i}' for i in range(12)]

    def pick(k):
        return ' '.join(words[j] for j in rng.integers(0, len(words), k))

    pref, sft = [], []
    for i in range(ROWS):
        img = d / f'img{i}.png'
        h, w = SIZES[i % len(SIZES)]
        PIL.fromarray(rng.integers(0, 256, size=(h, w, 3)).astype(
            np.uint8)).save(img)
        pref.append({'question': pick(int(rng.integers(1, 4))),
                     'response_1': pick(int(rng.integers(1, 8))),
                     'response_2': pick(int(rng.integers(1, 8))),
                     'overall_response': int(rng.integers(1, 3)),
                     'image': str(img)})
        sft.append({'question': pick(2),
                    'response': pick(int(rng.integers(1, 8))),
                    'image': str(img)})
    for name, data in (('pref', pref), ('sft', sft)):
        with open(d / f'{name}.jsonl', 'w') as f:
            f.writelines(json.dumps(r) + '\n' for r in data)
    return d


def _argv(assets, algo, out, per_device):
    data = 'sft' if algo == 'sft' else 'pref'
    kl = (('--per_device_kl_batch_size', str(per_device)) if algo == 'kto'
          else ())
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / f'{data}.jsonl'),
            '--train_template', 'AA_TI2T', '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[64]', '--save_checkpoint', 'False',
            '--per_device_train_batch_size', str(per_device), *kl]


@pytest.fixture(scope='module')
def runs(assets, tmp_path_factory):
    """algo -> one step of the JAX trainer and of the port's on the same
    rows (each JAX trainer built once in this file): both trainers, both
    first batches, both metrics, the port's params before the step and the
    port's start-up output."""
    from align_anything_tpu.models import mllama as jm
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_image_to_text import (
        dpo,
        kto,
        orpo,
        sft,
        simpo,
    )

    jcls = {'sft': sft.TI2TSupervisedTrainer, 'dpo': dpo.TI2TDPOTrainer,
            'kto': kto.TI2TKTOTrainer, 'orpo': orpo.TI2TORPOTrainer,
            'simpo': simpo.TI2TSimPOTrainer}
    cache = {}

    def run(algo):
        if algo in cache:
            return cache[algo]
        out = tmp_path_factory.mktemp(algo)
        with pytest.MonkeyPatch.context() as mp:
            # R1: the JAX SFT engine reads model_cfg.pp_stages
            mp.setattr(jm.MllamaConfig, 'pp_stages', 1, raising=False)
            cfgs, pc = jcli.parse_cfgs(TASK[algo],
                                       _argv(assets, algo, out / 'jax', 1))
            jtrainer = jcls[algo](cfgs=cfgs, parallel_cfgs=pc)
            jbatch = next(iter(jtrainer.train_iterator.epoch_batches(0)))
            jstart = {p: np.array(v) for p, v in leaves(
                jtrainer.state.params).items()}
            want = _steps(jtrainer, 1)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cfgs, pc = tcli.parse_cfgs(
                TASK[algo], _argv(assets, algo, out / 'port', JAX_DEVICES))
            trainer = PORT[algo](cfgs=cfgs, parallel_cfgs=pc, device='cpu')
        batch = next(iter(trainer.train_iterator.epoch_batches(0)))
        start = {p: v.copy() for p, v in leaves(trainer.state.params).items()}
        got = _steps(trainer, 1)
        cache[algo] = dict(trainer=trainer, jtrainer=jtrainer, batch=batch,
                           jbatch=jbatch, got=got, want=want, start=start,
                           jstart=jstart, printed=printed.getvalue())
        return cache[algo]

    return run


@pytest.mark.parametrize('algo', list(PORT))
def test_mllama_step_matches_jax(runs, algo):
    """One step of 8 rows (pairs): the same batch (one image token a row,
    the tile metadata), every metric JAX reports and every param after
    the step; DPO's and KTO's step 1 at the reference (DPO ln 2)."""
    r = runs(algo)
    trainer, jtrainer, got, want = (r['trainer'], r['jtrainer'], r['got'],
                                    r['want'])
    assert trainer.mm is tm
    for key in r['jbatch']:
        np.testing.assert_array_equal(r['batch'][key], r['jbatch'][key],
                                      err_msg=key)
    b = r['batch']
    rows = b['input_ids'].shape[0]
    assert ((b['input_ids'] == IMG).sum(-1) == 1).all()
    assert b['pixel_values'].shape == (rows, 1, 2, 3, 28, 28)
    assert set(b['aspect_ratio_ids'][:, 0].tolist()) == {1, 2, 3}
    assert (b['aspect_ratio_mask'].sum(-1)[:, 0]
            == np.where(b['aspect_ratio_ids'][:, 0] == 1, 1, 2)).all()
    if algo in ('dpo', 'kto'):
        # step 1: the policy is the reference.  The port's two passes
        # agree to the bit (no pair counted right); JAX's compiled passes
        # differ in the last place on some rows, so its accuracy counts
        # rows by the sign of that noise (the rewards are compared)
        assert 0.0 <= want[0].pop('train/reward_accuracy') <= 1.0
        assert got[0].pop('train/reward_accuracy') == 0.0
    if algo == 'dpo':
        assert abs(got[0]['train/loss'] - math.log(2)) <= 1e-6
    assert all(np.isfinite(v) for v in got[0].values())
    _compare(got, want)
    want_p = leaves(jtrainer.state.params)
    got_p = leaves(trainer.state.params)
    assert set(got_p) == set(want_p)
    for path, leaf in got_p.items():
        np.testing.assert_allclose(leaf, want_p[path], rtol=TOL, atol=TOL,
                                   err_msg=path)


def test_r30_freeze_flag_misses_the_tower(runs):
    """ROADMAP §3 R30, in both packages: the DPO YAML's
    ``freeze_vision_tower: True`` freezes nothing on an Mllama tree (it
    names ``vision_tower``; the tower is ``vision_model``): every leaf of
    the tower gets an optimizer state and moves, and the port's start-up
    prints one line that names the flag and the key."""
    r = runs('dpo')
    trainer, jtrainer = r['trainer'], r['jtrainer']
    assert "freeze_vision_tower: True names ('vision_tower',)" in r['printed']
    assert 'R30' in r['printed']
    for t in (trainer, jtrainer):
        assert t.cfgs.train_cfgs.freeze_vision_tower is True
        assert t.frozen_modules() == ('vision_tower',)
        assert set(t.state.params) == {'vision_model', 'language_model',
                                       'projector'}
    held = {id(p) for g in trainer.state.optimizer.param_groups
            for p in g['params']}
    assert all(id(t) in held
               for t in param_leaves(trainer.state.params['vision_model']))
    for before, tree in ((r['jstart'], jtrainer.state.params),
                         (r['start'], trainer.state.params)):
        after = leaves(tree['vision_model'], '/vision_model')
        assert all(not np.array_equal(after[p], before[p]) for p in after)


def test_mllama_sft_trainer_main_exports(assets, tmp_path):
    """``trainer_main(TI2TSupervisedTrainer, ...)`` on the Mllama
    checkpoint trains every step; its export (``slice_N``) reads back
    through the port's and JAX's loaders equal to the trained params."""
    from align_anything_tpu.models.hf_loader import (
        load_mllama_params as jload,
    )

    trainer = tcli.trainer_main(
        tsft.TI2TSupervisedTrainer, 'text_image_to_text/sft',
        _argv(assets, 'sft', tmp_path, 4), device='cpu')
    assert trainer.global_step == 2
    path = str(tmp_path / 'slice_2')
    back, cfg = tload(path, device='cpu')
    assert cfg.cross_attention_layers == (1,) and cfg.image_token_id == IMG
    want = leaves(trainer.state.params)
    for tree in (back, jload(path)[0]):
        got = leaves(tree)
        assert set(got) == set(want)
        for p, leaf in got.items():
            np.testing.assert_array_equal(leaf, want[p], err_msg=p)
