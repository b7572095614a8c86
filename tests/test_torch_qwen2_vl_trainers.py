"""The port's text-image-to-text trainers on Qwen2-VL and Qwen2.5-VL
checkpoints against the JAX package's, on the CPU: one or two steps of TI2T
SFT (the fixed 224 px grid and dynamic resolution) and TI2T DPO through the
same command lines, their metrics and updated params; TI2T KTO, ORPO and
SimPO on Qwen2-VL; ``trainer_main`` with its export; and ROADMAP §3 R27 in
both packages.

The checkpoints are tiny ``Qwen2VLForConditionalGeneration`` /
``Qwen2_5_VLForConditionalGeneration`` models saved by transformers (one
text layer, a two-block tower), the rows ``Qwen2-VL``-template (AA_TI2T
for KTO, whose KL rows need the unmatched format) over PNG files of three
sizes, so that a dynamic batch holds several grids.  The words are chosen
so that the hash tokenizer maps none onto the image token (ROADMAP R12).
As in ``tests/test_torch_ti2t_trainers.py``: the JAX trainers run 8 CPU
devices with a per-device batch of 1, the port one device with 8; metrics
and params to 1e-5; the JAX SFT trainer gets a ``pp_stages`` of 1 on the
config class (R1).  The YAMLs' ``freeze_vision_tower: True`` names
``vision_tower``, which a Qwen tree does not hold: the tower trains in
both packages (R27).
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

from align_anything_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from align_anything_tpu_torch.models import qwen2_5_vl as tq5  # noqa: E402
from align_anything_tpu_torch.models import qwen2_vl as tq  # noqa: E402
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    dpo as tdpo,
    kto as tkto,
    orpo as torpo,
    sft as tsft,
    simpo as tsimpo,
)
from align_anything_tpu_torch.utils.tools import param_leaves  # noqa: E402
from test_torch_qwen2_5_vl import hf_qwen2_5_vl_config  # noqa: E402
from test_torch_qwen2_vl import IMG, hf_qwen2_vl_config  # noqa: E402
from test_torch_rl_trainers import one_compile  # noqa: E402
from test_torch_ti2t_trainers import _compare, _leaves, _steps  # noqa: E402

JAX_DEVICES = 8
TOL = 1e-5
SIZES = ((56, 56), (56, 112), (84, 56))
DYNAMIC = ('--dynamic_resolution', 'True', '--min_pixels', str(4 * 784),
           '--max_pixels', str(32 * 784))


def _words(n: int) -> list[str]:
    """``n`` words that the 128-token hash tokenizer maps below the image
    token (no word lands on 120-122)."""
    tok = HashTokenizer(vocab_size=128)
    out, i = [], 0
    while len(out) < n:
        w = f'w{i}'
        if all(t < IMG for t in tok(w, add_special_tokens=False)
               ['input_ids']):
            out.append(w)
        i += 1
    return out


def make_qwen_assets(d, family: str, rows: int = 16):
    """A one-layer checkpoint of ``family`` (``d / 'model'``), ``rows``
    preference rows (``pref.jsonl``) and supervised rows (``sft.jsonl``),
    each with its own PNG of one of ``SIZES``."""
    torch.manual_seed(0)
    if family == 'qwen2_vl':
        hf = transformers.Qwen2VLForConditionalGeneration(
            hf_qwen2_vl_config(layers=1, depth=2))
    else:
        hf = transformers.Qwen2_5_VLForConditionalGeneration(
            hf_qwen2_5_vl_config(layers=1, depth=3))
    hf.eval().save_pretrained(d / 'model', safe_serialization=True)
    rng = np.random.default_rng(0)
    vocab = _words(12)

    def pick(k):
        return ' '.join(vocab[j] for j in rng.integers(0, len(vocab), k))

    pref, sft = [], []
    for i in range(rows):
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


@pytest.fixture(scope='module')
def qwen2_vl_assets(tmp_path_factory):
    return make_qwen_assets(tmp_path_factory.mktemp('qvl_assets'),
                            'qwen2_vl')


@pytest.fixture(scope='module')
def qwen2_5_vl_assets(tmp_path_factory):
    return make_qwen_assets(tmp_path_factory.mktemp('q25_assets'),
                            'qwen2_5_vl')


PORT = {'sft': tsft.TI2TSupervisedTrainer, 'dpo': tdpo.TI2TDPOTrainer,
        'kto': tkto.TI2TKTOTrainer, 'orpo': torpo.TI2TORPOTrainer,
        'simpo': tsimpo.TI2TSimPOTrainer}
TASK = {'sft': 'text_image_to_text/sft', 'dpo': 'text_image_to_text/dpo',
        'kto': 'text_to_text/kto', 'orpo': 'text_to_text/orpo',
        'simpo': 'text_to_text/simpo'}


def _argv(assets, algo, out, per_device, extra=()):
    data = 'sft' if algo == 'sft' else 'pref'
    template = 'AA_TI2T' if algo == 'kto' else 'Qwen2-VL'
    kl = (('--per_device_kl_batch_size', str(per_device)) if algo == 'kto'
          else ())
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / f'{data}.jsonl'),
            '--train_template', template, '--output_dir', str(out),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[128]', '--save_checkpoint', 'False',
            '--per_device_train_batch_size', str(per_device), *kl, *extra]


def _port(assets, algo, out, extra=()):
    cfgs, pc = tcli.parse_cfgs(
        TASK[algo], _argv(assets, algo, out, JAX_DEVICES, extra))
    return PORT[algo](cfgs=cfgs, parallel_cfgs=pc, device='cpu')


def _jax(assets, algo, out, monkeypatch, extra=()):
    from align_anything_tpu.models import qwen2_5_vl, qwen2_vl
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_image_to_text import (
        dpo,
        kto,
        orpo,
        sft,
        simpo,
    )

    # R1: the JAX SFT engine reads model_cfg.pp_stages
    for cls in (qwen2_vl.Qwen2VLConfig, qwen2_5_vl.Qwen25VLConfig):
        monkeypatch.setattr(cls, 'pp_stages', 1, raising=False)
    cls = {'sft': sft.TI2TSupervisedTrainer, 'dpo': dpo.TI2TDPOTrainer,
           'kto': kto.TI2TKTOTrainer, 'orpo': orpo.TI2TORPOTrainer,
           'simpo': simpo.TI2TSimPOTrainer}[algo]
    cfgs, pc = jcli.parse_cfgs(TASK[algo], _argv(assets, algo, out, 1, extra))
    return one_compile(cls(cfgs=cfgs, parallel_cfgs=pc))


def _params_match(trainer, jtrainer):
    want = _leaves(jtrainer.state.params)
    got = _leaves(trainer.state.params)
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf, np.asarray(want[path]), rtol=TOL,
                                   atol=TOL, err_msg=path)


def _pair_steps(assets, algo, tmp_path, monkeypatch, extra, n):
    jtrainer = _jax(assets, algo, tmp_path / 'jax', monkeypatch, extra)
    trainer = _port(assets, algo, tmp_path / 'port', extra)
    start = {p: v.copy() for p, v in _leaves(trainer.state.params).items()}
    got, _ = _run_pair(trainer, jtrainer, algo, n)
    return trainer, jtrainer, got, start


def _run_pair(trainer, jtrainer, algo, n):
    """``n`` steps of both trainers, their metrics and params compared;
    returns both metric lists."""
    want = _steps(jtrainer, n)
    got = _steps(trainer, n)
    if algo in ('dpo', 'kto'):
        # step 1: the policy is the reference.  The port's two passes agree
        # to the bit (every reward exactly 0, no pair counted right); JAX's
        # compiled passes differ in the last place on some rows, so its
        # accuracy counts rows by the sign of that noise (the rewards
        # themselves are compared, within 1e-5)
        assert 0.0 <= want[0].pop('train/reward_accuracy') <= 1.0
        assert got[0].pop('train/reward_accuracy') == 0.0
    _compare(got, want)
    _params_match(trainer, jtrainer)
    return got, want


CASES = {'sft': ('sft', ()), 'sft_dynamic': ('sft', DYNAMIC),
         'dpo': ('dpo', ()), 'dpo_dynamic': ('dpo', DYNAMIC)}


@pytest.fixture(scope='module')
def dpo_run(qwen2_vl_assets, tmp_path_factory):
    """The fixed-grid DPO pair of trainers, built once in this file (the
    steps test and R27's read it): both trainers before and after two
    steps, the port's start-up output, and each tower before the steps."""
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(printed):
        jtrainer = _jax(qwen2_vl_assets, 'dpo',
                        tmp_path_factory.mktemp('dpo_jax'), mp)
        trainer = _port(qwen2_vl_assets, 'dpo',
                        tmp_path_factory.mktemp('dpo_port'))
    jstart = {p: np.array(v) for p, v in _leaves(
        jtrainer.state.params['visual']).items()}
    start = {p: v.copy() for p, v in _leaves(trainer.state.params).items()}
    held = {id(p) for g in trainer.state.optimizer.param_groups
            for p in g['params']}
    tower_held = all(id(t) in held
                     for t in param_leaves(trainer.state.params['visual']))
    got, want = _run_pair(trainer, jtrainer, 'dpo', 2)
    return dict(trainer=trainer, jtrainer=jtrainer, got=got, want=want,
                start=start, jstart=jstart, tower_held=tower_held,
                printed=printed.getvalue())


@pytest.mark.parametrize('case', list(CASES))
def test_qwen2_vl_steps_match_jax(qwen2_vl_assets, tmp_path, monkeypatch,
                                  request, case):
    """Two steps of 8 rows (pairs): every metric JAX reports and every
    param after them; DPO's step 1 at ln 2; the dynamic batches carry
    ``image_grid_thw`` with several grids and each row's own token
    count; the tower moves (R27)."""
    algo, extra = CASES[case]
    if case == 'dpo':
        run = request.getfixturevalue('dpo_run')
        trainer, jtrainer, got, start = (run['trainer'], run['jtrainer'],
                                         run['got'], run['start'])
    else:
        trainer, jtrainer, got, start = _pair_steps(
            qwen2_vl_assets, algo, tmp_path, monkeypatch, extra, 2)
    assert trainer.mm is tq
    assert got[0]['train/loss'] != got[1]['train/loss']
    if algo == 'dpo':
        assert abs(got[0]['train/loss'] - math.log(2)) <= 1e-6
    batch = next(iter(trainer.train_iterator.epoch_batches(0)))
    jbatch = next(iter(jtrainer.train_iterator.epoch_batches(0)))
    for key in batch:
        np.testing.assert_array_equal(batch[key], jbatch[key], err_msg=key)
    if extra:
        grids = batch['image_grid_thw']
        assert len({tuple(g) for g in grids.tolist()}) == 3
        m = trainer.model_cfg.vision.spatial_merge_size
        assert (batch['input_ids'] == IMG).sum(-1).tolist() == [
            gh * gw // (m * m) for _, gh, gw in grids.tolist()]
        assert batch['pixel_values'].shape[1] == 128
    else:
        assert 'image_grid_thw' not in batch
        assert ((batch['input_ids'] == IMG).sum(-1) == 64).all()
    moved = _leaves(trainer.state.params['visual'])
    assert any(not np.array_equal(v, start['/visual' + p])
               for p, v in moved.items())


@pytest.mark.parametrize('algo', ['sft', 'dpo'])
def test_qwen2_5_vl_step_matches_jax(qwen2_5_vl_assets, tmp_path,
                                     monkeypatch, algo):
    """One dynamic-resolution step of Qwen2.5-VL (window and full blocks)
    through SFT and DPO: JAX's metrics and params."""
    trainer, _, got, _ = _pair_steps(qwen2_5_vl_assets, algo, tmp_path,
                                     monkeypatch, DYNAMIC, 1)
    assert trainer.mm is tq5
    if algo == 'dpo':
        assert abs(got[0]['train/loss'] - math.log(2)) <= 1e-6


@pytest.mark.parametrize('algo', ['kto', 'orpo', 'simpo'])
def test_qwen2_vl_dpo_family_step_matches_jax(qwen2_vl_assets, tmp_path,
                                              monkeypatch, algo):
    """One step of 8 pairs of TI2T KTO (its text-only KL rows), ORPO and
    SimPO on Qwen2-VL at the fixed grid: JAX's metrics and params."""
    trainer, _, got, _ = _pair_steps(qwen2_vl_assets, algo, tmp_path,
                                     monkeypatch, (), 1)
    assert trainer.mm is tq
    assert all(np.isfinite(v) for v in got[0].values())


def test_r27_freeze_flag_misses_the_tower(dpo_run):
    """ROADMAP §3 R27, in both packages: the DPO YAML's
    ``freeze_vision_tower: True`` freezes nothing on a Qwen2-VL tree (it
    names ``vision_tower``; the tower is ``visual``): every leaf of the
    tower and merger gets an optimizer state and moves, and the port's
    start-up prints one line that names the flag and the key.  The DPO
    trainers are the steps test's (``dpo_run``)."""
    trainer, jtrainer = dpo_run['trainer'], dpo_run['jtrainer']
    printed = dpo_run['printed']
    assert "freeze_vision_tower: True names ('vision_tower',)" in printed
    assert 'R27' in printed
    for t in (trainer, jtrainer):
        assert t.cfgs.train_cfgs.freeze_vision_tower is True
        assert t.frozen_modules() == ('vision_tower',)
        assert set(t.state.params) == {'language_model', 'visual'}
    assert dpo_run['tower_held']
    start = {p[len('/visual'):]: v for p, v in dpo_run['start'].items()
             if p.startswith('/visual')}
    for before, after in ((dpo_run['jstart'],
                           _leaves(jtrainer.state.params['visual'])),
                          (start, _leaves(trainer.state.params['visual']))):
        assert set(after) == set(before)
        assert all(not np.array_equal(after[p], before[p]) for p in before)


def test_qwen2_vl_dpo_trainer_main(qwen2_vl_assets, tmp_path):
    """``trainer_main(TI2TDPOTrainer, ...)`` at dynamic resolution trains
    every step; its Qwen2-VL export loads back equal to the trained
    params."""
    trainer = tcli.trainer_main(
        tdpo.TI2TDPOTrainer, 'text_image_to_text/dpo',
        _argv(qwen2_vl_assets, 'dpo', tmp_path, 4, DYNAMIC), device='cpu')
    assert trainer.global_step == 4
    back, cfg, module = tsft.load_vision_lm(str(tmp_path / 'slice_4'),
                                            device='cpu')
    assert module is tq and cfg.image_token_id == IMG
    want = _leaves(trainer.state.params)
    for path, leaf in _leaves(back).items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
