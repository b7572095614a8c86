"""The port's TI2T SFT and DPO trainers (and KTO, ORPO and SimPO, which
inherit DPO's log-probs) on a LLaVA-Next AnyRes checkpoint, against the
JAX package's: one-layer steps on a tiny
``LlavaNextForConditionalGeneration`` (``tests/test_torch_llava_next.py``'s
geometry), AA_TI2T rows with PNG images of random sizes, fp32 on the CPU,
8x the per-device batch in the port (JAX runs 8 CPU devices).

Tolerances: the batches (``select_idx`` too) exactly; metrics and leaves
to 1e-5 (rtol and atol), as ``tests/test_torch_ti2t_trainers.py``; DPO's
step 1 at ln 2 to 1e-6.  R1: the JAX SFT trainer needs
``MultimodalConfig.pp_stages`` patched to 1.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
PIL = pytest.importorskip('PIL.Image')
pytest.importorskip('yaml')

from align_anything_tpu.models import multimodal as jmm  # noqa: E402
from align_anything_tpu_torch.data import image as timage  # noqa: E402
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    dpo as tdpo,
    kto as tkto,
    orpo as torpo,
    rm as trm,
    sft as tsft,
    simpo as tsimpo,
)
from test_torch_llava_next import IMAGE_TOKEN, _hf_config  # noqa: E402
from test_torch_rl_trainers import one_compile  # noqa: E402
from test_torch_ti2t_trainers import (  # noqa: E402
    JAX_DEVICES,
    _compare,
    _leaves,
    _steps,
)

TOL = 1e-5


def make_anyres_assets(d, rows: int = 16):
    """A one-layer LLaVA-Next checkpoint (``d / 'model'``) and ``rows``
    AA_TI2T preference and supervised rows, each with its own PNG of a
    random size (so rows differ in their image-token counts)."""
    torch.manual_seed(0)
    transformers.LlavaNextForConditionalGeneration(
        _hf_config(layers=1)).eval().save_pretrained(
        d / 'model', safe_serialization=True)
    rng = np.random.default_rng(0)
    words = ['alpha', 'beta', 'gamma', 'delta', 'eps', 'zeta']

    def pick(k):
        return ' '.join(words[j] for j in rng.integers(0, 6, size=k))

    pref, sft = [], []
    for i in range(rows):
        img = d / f'img{i}.png'
        h, w = (int(x) for x in rng.integers(16, 90, size=2))
        PIL.fromarray(rng.integers(0, 256, size=(h, w, 3)).astype(
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
    return make_anyres_assets(tmp_path_factory.mktemp('anyres_assets'))


PORT = {'sft': tsft.TI2TSupervisedTrainer, 'dpo': tdpo.TI2TDPOTrainer,
        'kto': tkto.TI2TKTOTrainer, 'orpo': torpo.TI2TORPOTrainer,
        'simpo': tsimpo.TI2TSimPOTrainer}
TASK = {'sft': 'text_image_to_text/sft', 'dpo': 'text_image_to_text/dpo',
        'kto': 'text_to_text/kto', 'orpo': 'text_to_text/orpo',
        'simpo': 'text_to_text/simpo'}


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


def _pair(assets, algo, tmp_path, monkeypatch):
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_image_to_text import (
        dpo,
        kto,
        orpo,
        sft,
        simpo,
    )

    # R1: the JAX SFT engine reads model_cfg.pp_stages
    monkeypatch.setattr(jmm.MultimodalConfig, 'pp_stages', 1, raising=False)
    jcls = {'sft': sft.TI2TSupervisedTrainer, 'dpo': dpo.TI2TDPOTrainer,
            'kto': kto.TI2TKTOTrainer, 'orpo': orpo.TI2TORPOTrainer,
            'simpo': simpo.TI2TSimPOTrainer}[algo]
    cfgs, pc = jcli.parse_cfgs(TASK[algo],
                               _argv(assets, algo, tmp_path / 'jax', 1))
    jtrainer = one_compile(jcls(cfgs=cfgs, parallel_cfgs=pc))
    cfgs, pc = tcli.parse_cfgs(
        TASK[algo], _argv(assets, algo, tmp_path / 'port', JAX_DEVICES))
    return jtrainer, PORT[algo](cfgs=cfgs, parallel_cfgs=pc, device='cpu')


def _anyres_batch_checks(trainer, jtrainer):
    """The batches carry ``select_idx`` and equal JAX's; each row holds
    as many image tokens as its image's ``num_tokens`` (no text word
    hashes to the image token here)."""
    batch = next(iter(trainer.train_iterator.epoch_batches(0)))
    jbatch = next(iter(jtrainer.train_iterator.epoch_batches(0)))
    assert set(batch) == set(jbatch)
    for k in jbatch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    assert batch['pixel_values'].shape[1:] == (5, 3, 32, 32)
    counts = (batch['input_ids'] == IMAGE_TOKEN).sum(-1)
    n_sel = (batch['select_idx'] != 0).sum(-1) + 1   # index 0 is real
    np.testing.assert_array_equal(counts, n_sel)
    assert len(set(counts.tolist())) > 1


@pytest.mark.parametrize('algo', ['sft', 'dpo'])
def test_anyres_steps_match_jax(assets, tmp_path, monkeypatch, algo):
    """Two steps of 8 rows (pairs) on a LLaVA-Next checkpoint: the
    batches (``select_idx`` too) equal, every metric JAX reports, the
    tower frozen (the YAML's default) bit-equal; the language model,
    projector and ``image_newline`` move; DPO's step 1 at ln 2."""
    jtrainer, trainer = _pair(assets, algo, tmp_path, monkeypatch)
    assert isinstance(trainer.make_image_processor(), timage.AnyResProcessor)
    _anyres_batch_checks(trainer, jtrainer)
    start = {p: v.copy() for p, v in _leaves(trainer.state.params).items()}
    want = _steps(jtrainer, 2)
    got = _steps(trainer, 2)
    _compare(got, want)
    after = _leaves(trainer.state.params)
    for path, leaf in after.items():
        np.testing.assert_allclose(
            leaf, np.asarray(_leaves(jtrainer.state.params)[path]),
            rtol=TOL, atol=TOL, err_msg=path)
        moved = not np.array_equal(leaf, start[path])
        if path.startswith('/vision_tower'):
            assert not moved, path
    for module in ('/language_model', '/projector', '/image_newline'):
        assert any(not np.array_equal(v, start[p]) for p, v in after.items()
                   if p.startswith(module)), module
    if algo == 'dpo':
        assert abs(got[0]['train/loss'] - math.log(2)) <= 1e-6
        assert abs(want[0]['train/loss'] - math.log(2)) <= 1e-6


@pytest.mark.parametrize('algo', ['kto', 'orpo', 'simpo'])
def test_anyres_dpo_family_step_matches_jax(assets, tmp_path, monkeypatch,
                                            algo):
    """KTO, ORPO and SimPO inherit TI2T DPO's log-probs, ``select_idx``
    included: one step of 8 pairs against JAX's, every metric."""
    jtrainer, trainer = _pair(assets, algo, tmp_path, monkeypatch)
    batch = next(iter(trainer.train_iterator.epoch_batches(0)))
    assert batch['select_idx'].shape == (16, 24)
    _compare(_steps(trainer, 1), _steps(jtrainer, 1))


def test_anyres_rm_keeps_the_fixed_resolution(assets, tmp_path):
    """JAX's TI2T reward model builds the plain processor for any
    checkpoint (``rm.py:70``), and so does the port's: one crop an image,
    one image token a patch, no ``select_idx``."""
    cfgs, pc = tcli.parse_cfgs('text_image_to_text/rm',
                               _argv(assets, 'dpo', tmp_path, 8))
    trainer = trm.TI2TRMTrainer(cfgs=cfgs, parallel_cfgs=pc, device='cpu')
    batch = next(iter(trainer.train_iterator.epoch_batches(0)))
    assert 'select_idx' not in batch
    assert batch['pixel_values'].shape[1:] == (3, 32, 32)
    assert ((batch['input_ids'] == IMAGE_TOKEN).sum(-1) == 4).all()
    assert np.isfinite(trainer.train_step(batch)['train/loss'])
