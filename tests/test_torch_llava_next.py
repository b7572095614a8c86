"""The port's LLaVA-Next AnyRes path against the JAX package's, fp32 on the
CPU: ``data/image.py`` ``AnyResProcessor`` / ``select_best_resolution``,
the ``select_idx`` branch of ``models/multimodal.py`` ``forward`` and
``token_logprobs``, the ``llava_next`` loader and exporter
(``models/hf_loader.py``) and ``load_vision_lm``.  The trainers' steps on
a LLaVA-Next checkpoint are in ``tests/test_torch_llava_next_trainers.py``.

The checkpoint is a tiny ``LlavaNextForConditionalGeneration`` saved by
transformers (crops of 32 px, patches of 16: a 2 x 2 feature grid a crop;
pinpoints up to 2 x 2 tiles).  The same weights (each package's loader)
and inputs go through both; the port's attention runs the flash kernel's
plain version, JAX's ``attention_impl='xla'``.

Tolerances: crops within 1e-6 and ``select_idx`` / ``num_tokens`` equal;
logits and log-probs to 1e-5 of their max; the loaded and re-exported
trees exactly; against transformers' logits 3e-5 (``tests/
test_llava_next.py``).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
PIL = pytest.importorskip('PIL.Image')
pytest.importorskip('yaml')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.data import image as jimage  # noqa: E402
from align_anything_tpu.models import multimodal as jmm  # noqa: E402
from align_anything_tpu.models.hf_loader import (  # noqa: E402
    load_multimodal_params as jload,
)
from align_anything_tpu_torch.data import image as timage  # noqa: E402
from align_anything_tpu_torch.models import multimodal as tmm  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.hf_loader import (  # noqa: E402
    load_multimodal_params as tload,
    save_multimodal_params,
)
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    sft as tsft,
)
from test_torch_ti2t_trainers import _leaves  # noqa: E402

TOL = 1e-5
IMAGE_TOKEN = 250
PINPOINTS = [[32, 32], [32, 64], [64, 32], [64, 64]]
# (h, w) of test images: each pinpoint's best case, and unpadding along
# rows (wide) and columns (tall), with odd remainders
SIZES = [(20, 20), (30, 60), (60, 30), (70, 70), (48, 96), (100, 30),
         (40, 40), (33, 70), (90, 41)]


class _Vision:
    image_size = 32
    patch_size = 16


def _hf_config(layers=2, vocab=256):
    return transformers.LlavaNextConfig(
        vision_config=dict(image_size=32, patch_size=16, hidden_size=24,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=48, projection_dim=24),
        text_config=dict(model_type='llama', vocab_size=vocab,
                         hidden_size=32, intermediate_size=64,
                         num_hidden_layers=layers, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=256,
                         bos_token_id=1, eos_token_id=2, pad_token_id=0),
        image_grid_pinpoints=PINPOINTS, image_token_index=IMAGE_TOKEN,
        vision_feature_layer=-2, vision_feature_select_strategy='default')


@pytest.fixture(scope='module')
def lnext(tmp_path_factory):
    torch.manual_seed(0)
    hf = transformers.LlavaNextForConditionalGeneration(_hf_config()).eval()
    d = tmp_path_factory.mktemp('lnext')
    hf.save_pretrained(d, safe_serialization=True)
    return hf, d


def _img(h, w, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(h, w, 3)).astype(np.uint8)


# ---------------------------------------------------------------------------
# the processor
# ---------------------------------------------------------------------------

def test_best_resolution_matches_jax():
    pins = [tuple(p) for p in PINPOINTS]
    chosen = set()
    for h, w in SIZES + [(1, 1), (32, 64), (64, 64), (7, 300)]:
        got = timage.select_best_resolution((h, w), pins)
        assert got == jimage.select_best_resolution((h, w), pins)
        chosen.add(got)
    assert chosen == set(pins)


@pytest.mark.parametrize('hw', SIZES)
def test_anyres_processor_matches_jax(hw):
    """Crops within 1e-6 (zeros past the image's tiles), ``select_idx``
    and ``num_tokens`` equal, and the fixed shapes."""
    img = _img(*hw, seed=hw[0] * 1000 + hw[1])
    got = timage.AnyResProcessor(_Vision(), PINPOINTS)(img)
    want = jimage.AnyResProcessor(_Vision(), PINPOINTS)(img)
    assert set(got) == set(want) == {'pixel_values', 'select_idx',
                                     'num_tokens'}
    assert got['pixel_values'].shape == (5, 3, 32, 32)
    assert got['select_idx'].shape == (24,) and got['select_idx'].dtype \
        == np.int32
    np.testing.assert_allclose(got['pixel_values'], want['pixel_values'],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got['select_idx'], want['select_idx'])
    assert got['num_tokens'] == want['num_tokens']
    proc = timage.AnyResProcessor(_Vision(), PINPOINTS)
    assert (proc.num_crops, proc.max_tokens, proc.num_patches) == (5, 24, 24)


def test_anyres_collated_batch_matches_jax():
    """The dict branch of ``_stack_pixels`` through both collators:
    ``select_idx`` batched as int32, ``num_tokens`` dropped, a row
    without an image zeros; the preference collator repeats them for
    [better; worse]."""
    tproc = timage.AnyResProcessor(_Vision(), PINPOINTS)
    jproc = jimage.AnyResProcessor(_Vision(), PINPOINTS)
    imgs = [_img(30, 60, 1), None, _img(70, 70, 2)]
    rows = [{'input_ids': [1, 5, 6], 'labels': [-100, 5, 6],
             'pixel_values': None if im is None else tproc(im)}
            for im in imgs]
    jrows = [{'input_ids': [1, 5, 6], 'labels': [-100, 5, 6],
              'pixel_values': None if im is None else jproc(im)}
             for im in imgs]
    got = timage.TI2TSupervisedCollator(0, (8,))(rows)
    want = jimage.TI2TSupervisedCollator(0, (8,))(jrows)
    assert set(got) == set(want)
    assert 'num_tokens' not in got and got['select_idx'].dtype == np.int32
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not got['select_idx'][1].any()
    prefs = [{'better_input_ids': [1, 5, 6], 'worse_input_ids': [1, 7],
              'better_prompt_len': 1, 'worse_prompt_len': 1,
              'pixel_values': r['pixel_values']} for r in rows]
    jprefs = [dict(p, pixel_values=r['pixel_values'])
              for p, r in zip(prefs, jrows)]
    got = timage.TI2TPreferenceCollator(0, (8,))(prefs)
    want = jimage.TI2TPreferenceCollator(0, (8,))(jprefs)
    assert got['select_idx'].shape == (6, 24)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _jax_cfg(cfg):
    return cfg.replace(compute_dtype='float32', attention_impl='xla')


def _anyres_batch(sizes=((48, 96), (100, 30)), seed=1):
    """Two rows, one image each: [bos, 2 words, the image's tokens, 3
    words], right-padded to the longer row."""
    rng = np.random.default_rng(seed)
    proc = timage.AnyResProcessor(_Vision(), PINPOINTS)
    outs = [proc(_img(h, w, seed + i)) for i, (h, w) in enumerate(sizes)]
    lens = [1 + 2 + o['num_tokens'] + 3 for o in outs]
    length = max(lens)
    ids = np.zeros((len(outs), length), np.int32)
    mask = np.zeros_like(ids)
    for i, o in enumerate(outs):
        row = np.concatenate([[1], rng.integers(3, 200, 2),
                              np.full(o['num_tokens'], IMAGE_TOKEN),
                              rng.integers(3, 200, 3)])
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    px = np.stack([o['pixel_values'] for o in outs])
    sel = np.stack([o['select_idx'] for o in outs])
    assert len(set(lens)) == 2
    return ids, mask, px, sel


def test_loader_matches_jax(lnext):
    """The port's loader gives the JAX loader's tree (``image_newline``
    too) and config (the pinpoints as tuples)."""
    _, d = lnext
    tparams, tcfg = tload(str(d), device='cpu')
    jparams, jcfg = jload(str(d))
    assert set(tparams) == set(jparams) == {
        'language_model', 'vision_tower', 'projector', 'image_newline'}
    for path, leaf in _leaves(tparams).items():
        np.testing.assert_array_equal(leaf, _leaves(jparams)[path],
                                      err_msg=path)
    assert tcfg.image_grid_pinpoints == jcfg.image_grid_pinpoints == tuple(
        tuple(p) for p in PINPOINTS)
    assert (tcfg.image_token_id, tcfg.video_token_id,
            tcfg.spatial_pool_stride, tcfg.projector_layers) == (
        jcfg.image_token_id, jcfg.video_token_id, jcfg.spatial_pool_stride,
        jcfg.projector_layers) == (IMAGE_TOKEN, None, None, 2)
    assert dataclasses.asdict(tcfg.text) == dataclasses.asdict(jcfg.text)
    assert dataclasses.asdict(tcfg.vision) == dataclasses.asdict(jcfg.vision)


def test_init_tree_and_bridge_carry_image_newline(lnext):
    """``init_params`` with pinpoints has JAX's tree, ``image_newline``
    (E,) included, and ``from_jax_tree`` carries a JAX tree's newline
    across."""
    from align_anything_tpu.models.config import ModelConfig as JModelConfig
    from align_anything_tpu.models.vision import ViTConfig as JViTConfig
    from align_anything_tpu_torch.models.config import ModelConfig
    from align_anything_tpu_torch.models.vision import ViTConfig

    text = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                num_kv_heads=2, head_dim=8, mlp_dim=64)
    vit = dict(image_size=32, patch_size=16, hidden_size=24, num_layers=2,
               num_heads=4, mlp_dim=48)
    pins = tuple(tuple(p) for p in PINPOINTS)
    jc = jmm.MultimodalConfig(text=JModelConfig(**text),
                              vision=JViTConfig(**vit),
                              image_grid_pinpoints=pins)
    tc = tmm.MultimodalConfig(text=ModelConfig(**text), vision=ViTConfig(**vit),
                              image_grid_pinpoints=pins)
    want = jax.eval_shape(lambda k: jmm.init_params(jc, k),
                          jax.random.PRNGKey(0))
    got = tmm.init_params(tc, torch.Generator().manual_seed(0), device='cpu')
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(
        lambda a: tuple(a.shape), want)
    assert got['image_newline'].shape == (32,)
    jparams, _ = jload(str(lnext[1]))
    bridged = from_jax_tree(jax.tree.map(np.asarray, jparams), device='cpu')
    np.testing.assert_array_equal(bridged['image_newline'].numpy(),
                                  np.asarray(jparams['image_newline']))


def test_anyres_forward_and_logprobs_match_jax(lnext):
    """Two rows whose images unpad along rows and along columns, with
    differing token counts and right padding: logits, the last hidden
    state and ``token_logprobs(select_idx=)`` against JAX's."""
    _, d = lnext
    tparams, tcfg = tload(str(d), device='cpu')
    jparams, jcfg = jload(str(d))
    tcfg, jcfg = tcfg.replace(compute_dtype='float32'), _jax_cfg(jcfg)
    ids, mask, px, sel = _anyres_batch()
    t_in = dict(attention_mask=torch.from_numpy(mask),
                pixel_values=torch.from_numpy(px),
                select_idx=torch.from_numpy(sel))
    j_in = dict(attention_mask=jnp.asarray(mask), pixel_values=jnp.asarray(px),
                select_idx=jnp.asarray(sel))
    with torch.no_grad():
        got = tmm.forward(tparams, tcfg, torch.from_numpy(ids), **t_in)
        got_lp = tmm.token_logprobs(tparams, tcfg, torch.from_numpy(ids),
                                    **t_in)
    # compiled: the eager op-by-op trace took most of the test's time
    want = jax.jit(jmm.forward, static_argnums=1)(
        jparams, jcfg, jnp.asarray(ids), **j_in)
    want_lp = jax.jit(jmm.token_logprobs, static_argnums=1)(
        jparams, jcfg, jnp.asarray(ids), **j_in)
    for g, w in ((got.logits, want.logits),
                 (got.last_hidden_state, want.last_hidden_state),
                 (got_lp, want_lp)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()))
    # the image reaches the output: another image changes the logits
    with torch.no_grad():
        other = tmm.forward(tparams, tcfg, torch.from_numpy(ids), **dict(
            t_in, pixel_values=torch.from_numpy(px[::-1].copy())))
    assert not torch.allclose(other.logits, got.logits)


@pytest.mark.parametrize('hw', [(48, 96), (100, 30), (70, 70)])
def test_anyres_forward_matches_transformers(lnext, hw):
    """The port's processor and forward against HF's processor and
    ``LlavaNextForConditionalGeneration`` (unpadding in both directions
    and a square image)."""
    from transformers.models.llava_next.image_processing_llava_next import (
        LlavaNextImageProcessor,
    )

    hf, d = lnext
    params, cfg = tload(str(d), device='cpu')
    cfg = cfg.replace(compute_dtype='float32')
    img = _img(*hw, seed=5)
    mine = timage.AnyResProcessor(_Vision(), PINPOINTS)(img)
    rng = np.random.default_rng(2)
    ids = np.concatenate([[1], rng.integers(3, 200, 2),
                          np.full(mine['num_tokens'], IMAGE_TOKEN),
                          rng.integers(3, 200, 3)])[None].astype(np.int64)
    hf_in = LlavaNextImageProcessor(
        size={'shortest_edge': 32}, crop_size={'height': 32, 'width': 32},
        image_grid_pinpoints=PINPOINTS, do_center_crop=False)(
        images=[img], return_tensors='pt')
    with torch.no_grad():
        got = tmm.forward(params, cfg, torch.from_numpy(ids),
                          pixel_values=torch.from_numpy(
                              mine['pixel_values'])[None],
                          select_idx=torch.from_numpy(
                              mine['select_idx'])[None]).logits
        ref = hf(input_ids=torch.from_numpy(ids),
                 pixel_values=hf_in['pixel_values'],
                 image_sizes=hf_in['image_sizes']).logits
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-5, rtol=0)


def test_export_reads_back(lnext, tmp_path):
    """The port's ``llava_next`` export: JAX's loader and the port's read
    it back equal (``image_newline`` and the pinpoints too), and
    transformers loads it to the same logits, text-only and with an
    image."""
    from transformers.models.llava_next.image_processing_llava_next import (
        LlavaNextImageProcessor,
    )

    hf, d = lnext
    params, cfg = tload(str(d), device='cpu')
    save_multimodal_params(str(tmp_path), params, cfg)
    hf_cfg = json.loads((tmp_path / 'config.json').read_text())
    assert (hf_cfg['model_type'], hf_cfg['architectures']) == (
        'llava_next', ['LlavaNextForConditionalGeneration'])
    assert hf_cfg['image_grid_pinpoints'] == PINPOINTS
    assert 'video_token_index' not in hf_cfg
    jparams, jcfg = jload(str(tmp_path))
    back, cfg2 = tload(str(tmp_path), device='cpu')
    assert cfg2 == cfg and jcfg.image_grid_pinpoints == cfg.image_grid_pinpoints
    want = _leaves(params)
    for tree in (jparams, back):
        got = _leaves(tree)
        assert set(got) == set(want)
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    again = transformers.LlavaNextForConditionalGeneration.from_pretrained(
        str(tmp_path)).eval()
    img = _img(48, 96, seed=3)
    hf_in = LlavaNextImageProcessor(
        size={'shortest_edge': 32}, crop_size={'height': 32, 'width': 32},
        image_grid_pinpoints=PINPOINTS, do_center_crop=False)(
        images=[img], return_tensors='pt')
    n_tok = timage.AnyResProcessor(_Vision(), PINPOINTS)(img)['num_tokens']
    ids = torch.tensor([[1, 5, 6] + [IMAGE_TOKEN] * n_tok + [7, 8]])
    with torch.no_grad():
        for kw in ({}, {'pixel_values': hf_in['pixel_values'],
                        'image_sizes': hf_in['image_sizes']}):
            np.testing.assert_array_equal(
                again(input_ids=ids, **kw).logits.numpy(),
                hf(input_ids=ids, **kw).logits.numpy())


def test_load_vision_lm_takes_llava_next(lnext):
    _, d = lnext
    params, cfg, module = tsft.load_vision_lm(str(d), device='cpu')
    assert module is tmm and 'image_newline' in params
    assert cfg.image_grid_pinpoints is not None
