"""The port's MiniCPM-V against the JAX package's, on the CPU:
``models/minicpmv.py`` (``sincos_2d``, the resampler fixed, packed and
with a padded crop, ``encode_image_crops`` in its three layouts, logits,
log-probs with ``tgt_sizes``, gradients, the dtypes of JAX's promotion),
``data/image.py`` (the three slicing helpers and
``MiniCPMVSliceProcessor``), ``models/hf_loader.py`` (the loader and
writer), greedy ``generate`` with slice-mode media, the TI2T trainers
(SFT against JAX's; DPO, KTO, ORPO and SimPO against JAX's losses over
JAX's log-probs; the export and a resume) and ROADMAP §3
R40 and R41 in both packages.

The checkpoint is written by the port's writer (no transformers class
holds MiniCPM-V): the port's random init of a tiny config (a SigLIP tower
32 wide of 2 layers over 56 px images of 14 px patches, 16 slots; a
resampler of 4 queries over 4 heads; a Qwen2 trunk of 2 layers 32 wide;
vocab 128, the image token 120), every leaf moved by 0.05 x N(0, 1) from a
numpy seed so that no bias, norm or query sits at its init.  Both
packages' loaders read it; JAX's tree reaches the port through
``models/bridge.py``.  The trainers slice at ``scale_resolution`` 28 with
2 slices (``ENV_PREFIX__TRAIN_CFGS__*``, read by both packages): 9 slots
a crop, 3 crops a row, one or three of them used.

Tolerances: the processor, the helpers, ``sincos_2d``, the loaded trees
and the generated ids exactly; the resampler, the crops' embeddings,
logits and log-probs within 1e-4 of their max (fp32); every gradient leaf
within 1e-4 of its max and finite; the trainers' metrics and params to
1e-5, as the other trainer parity tests.
"""

import contextlib
import functools
import io
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')
PIL = pytest.importorskip('PIL.Image')
pytest.importorskip('yaml')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.data import image as jimage  # noqa: E402
from align_anything_tpu.generation import engine as jeng  # noqa: E402
from align_anything_tpu.models import hf_loader as jhf  # noqa: E402
from align_anything_tpu.models import minicpmv as jm  # noqa: E402
from align_anything_tpu_torch import checkpoint as tckpt  # noqa: E402
from align_anything_tpu_torch.data import image as timage  # noqa: E402
from align_anything_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from align_anything_tpu_torch.generation import (  # noqa: E402
    GenerationConfig,
    generate,
)
from align_anything_tpu_torch.models import hf_loader as thf  # noqa: E402
from align_anything_tpu_torch.models import minicpmv as tm  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.ops import attention as tattn  # noqa: E402
from align_anything_tpu_torch.trainers import cli as tcli  # noqa: E402
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    dpo as tdpo,
    kto as tkto,
    orpo as torpo,
    sft as tsft,
    simpo as tsimpo,
)
from align_anything_tpu_torch.utils.tools import param_leaves  # noqa: E402
from test_torch_mllama import leaves  # noqa: E402
from test_torch_rl_trainers import one_compile  # noqa: E402
from test_torch_ti2t_trainers import _compare, _steps  # noqa: E402

IMG = 120
REL = 1e-4
TOL = 1e-5
JAX_DEVICES = 8
ROWS = 8
Q = 4
# (h, w) of the trainers' images: 3 crops (a 2 x 1 grid), 3 crops (1 x 2),
# 1 crop (fits one)
SIZES = ((56, 84), (84, 42), (28, 28))
# the trainers' slicing, through the config overrides both packages read
SLICING = {'ENV_PREFIX__TRAIN_CFGS__SCALE_RESOLUTION': '28',
           'ENV_PREFIX__TRAIN_CFGS__MAX_SLICE_NUMS': '2'}
# slice-mode grids, 3 crops a row: 3, 1 and 2 of them used
SLICE_GRIDS = (((4, 4), (2, 4), (3, 2)), ((4, 2), (0, 0), (0, 0)),
               ((2, 2), (4, 3), (0, 0)))


def hf_config() -> dict:
    return {
        'model_type': 'minicpmv', 'vocab_size': 128, 'hidden_size': 32,
        'num_hidden_layers': 2, 'num_attention_heads': 4,
        'num_key_value_heads': 2, 'intermediate_size': 64,
        'max_position_embeddings': 256, 'rope_theta': 1000000.0,
        'rms_norm_eps': 1e-6, 'tie_word_embeddings': False,
        'bos_token_id': 1, 'eos_token_id': 2, 'pad_token_id': 0,
        'query_num': Q, 'resampler_num_heads': 4, 'image_token_id': IMG,
        'slice_mode': True,
        'vision_config': {'hidden_size': 32, 'intermediate_size': 64,
                          'num_hidden_layers': 2, 'num_attention_heads': 4,
                          'image_size': 56, 'patch_size': 14}}


def _words(n: int) -> list[str]:
    """``n`` words that the 128-token hash tokenizer maps off the image
    token (ROADMAP R12)."""
    tok = HashTokenizer(vocab_size=128)
    out, i = [], 0
    while len(out) < n:
        w = f'w{i}'
        if IMG not in tok(w, add_special_tokens=False)['input_ids']:
            out.append(w)
        i += 1
    return out


def _perturbed(tree, rng):
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng) for k, v in tree.items()}
    return tree + torch.from_numpy(
        0.05 * rng.standard_normal(tuple(tree.shape))).float()


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    """The checkpoint the port writes (``model``), ``ROWS`` preference rows
    (``pref.jsonl``) and supervised rows (``sft.jsonl``), each with its
    own PNG of one of ``SIZES``."""
    d = tmp_path_factory.mktemp('minicpmv_assets')
    cfg = thf._minicpmv_config(hf_config())
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            device='cpu')
    params = _perturbed(params, np.random.default_rng(1))
    thf.save_minicpmv_params(str(d / 'model'), params, cfg)
    rng = np.random.default_rng(0)
    words = _words(12)

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


@pytest.fixture(scope='module')
def mv(assets):
    """Both packages' params and fp32 configs of the checkpoint."""
    params, jcfg = jhf.load_minicpmv_params(str(assets / 'model'))
    tparams, tcfg = thf.load_minicpmv_params(str(assets / 'model'),
                                             device='cpu')
    return dict(params=params, jcfg=jcfg.replace(compute_dtype='float32',
                                                 attention_impl='xla'),
                tparams=tparams, tcfg=tcfg.replace(compute_dtype='float32'))


# JAX's functions compiled once each (the eager op-by-op trace is slow)
_jresample = jax.jit(jm.resampler_forward, static_argnums=1)
_jencode = jax.jit(jm.encode_image_crops, static_argnums=(1, 4))
_jforward = jax.jit(jm.forward, static_argnums=1)


def _close(got, want, rel=REL):
    got = np.asarray(got.detach() if hasattr(got, 'detach') else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale, (
        float(np.abs(got - want).max()), scale)


def _packed(seed=0, grids=((4, 2), (3, 4), (4, 4))):
    """Packed patch rows (B, 16, 3*14*14) of the given (h, w) grids, zero
    past each grid, and their ``tgt_sizes``."""
    rng = np.random.default_rng(seed)
    px = np.zeros((len(grids), 16, 3 * 14 * 14), np.float32)
    for i, (h, w) in enumerate(grids):
        px[i, :h * w] = rng.normal(size=(h * w, 3 * 14 * 14))
    return px, np.asarray(grids, np.int32)


def _slices(seed=0, grids=SLICE_GRIDS):
    """Slice-mode crops (B, M, 16, 3*14*14) and ``tgt_sizes`` (B, M, 2);
    a (0, 0) grid is a padded crop."""
    rng = np.random.default_rng(seed)
    b, m = len(grids), len(grids[0])
    px = np.zeros((b, m, 16, 3 * 14 * 14), np.float32)
    for i, row in enumerate(grids):
        for j, (h, w) in enumerate(row):
            px[i, j, :h * w] = rng.normal(size=(h * w, 3 * 14 * 14))
    return px, np.asarray(grids, np.int32)


def _ids(n_image=(Q, Q, Q)):
    """Rows of text around each row's image tokens, right-padded with 0."""
    rows = [[1, 5] + [IMG] * n_image[0] + [6, 7, 8, 9],
            [1] + [IMG] * n_image[1] + [10, 11],
            [1, 12] + [IMG] * n_image[2] + [13, 14, 15]]
    width = max(map(len, rows))
    ids = np.zeros((3, width), np.int64)
    mask = np.zeros((3, width), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return ids, mask


def _slice_tokens(grids=SLICE_GRIDS):
    return tuple(Q * sum(h * w > 0 for h, w in row) for row in grids)


def _media(layout: str, seed: int):
    """(port kwargs, JAX kwargs, image tokens a row) of a layout."""
    if layout == 'text':
        return {}, {}, (0, 0, 0)
    if layout == 'fixed':
        px = np.random.default_rng(seed).normal(
            size=(3, 3, 56, 56)).astype(np.float32)
        return ({'pixel_values': torch.from_numpy(px)},
                {'pixel_values': jnp.asarray(px)}, (Q, Q, Q))
    px, grids = (_packed(seed) if layout == 'packed' else _slices(seed))
    n = (Q, Q, Q) if layout == 'packed' else _slice_tokens()
    return ({'pixel_values': torch.from_numpy(px),
             'tgt_sizes': torch.from_numpy(grids)},
            {'pixel_values': jnp.asarray(px),
             'tgt_sizes': jnp.asarray(grids)}, n)


# ---------------------------------------------------------------------------
# the slicing and the processor
# ---------------------------------------------------------------------------

def test_sincos_and_slicing_helpers_match_jax():
    """``sincos_2d`` (float64 then float32) and the three slicing helpers
    over a spread of sizes, scales and slice counts, exactly."""
    for e, h, w in ((32, 4, 4), (64, 7, 3), (3584, 70, 70)):
        np.testing.assert_array_equal(tm.sincos_2d(e, h, w),
                                      jm.sincos_2d(e, h, w))
    sizes = ((448, 448), (100, 80), (1344, 448), (300, 2000), (37, 900),
             (2000, 2000), (14, 14), (975, 511))
    for wh in sizes:
        for scale, patch in ((448, 14), (56, 14), (28, 14)):
            for up in (False, True):
                assert (timage.find_best_resize(wh, scale, patch, up)
                        == jimage.find_best_resize(wh, scale, patch, up))
            for slices in (2, 4, 9):
                grid = timage.get_sliced_grid(wh, slices, scale)
                assert grid == jimage.get_sliced_grid(wh, slices, scale)
                if grid is not None:
                    assert (timage.get_refine_size(wh, grid, scale, patch)
                            == jimage.get_refine_size(wh, grid, scale, patch,
                                                      True))


@pytest.mark.parametrize('case', ['square', 'upscaled', 'panorama',
                                  'portrait', 'gridded', 'capped', 'cut'])
def test_slice_processor_matches_jax(mv, case):
    """``pixel_values``, ``tgt_sizes`` and ``num_tokens`` equal JAX's bit
    for bit: a square image, one small enough to be upscaled as one crop,
    a panorama, a portrait, a large gridded image, a grid past
    ``max_grid_side`` (resized down to it) and a crop past ``max_patches``
    (cut; ``tgt_sizes`` keeps the whole grid)."""
    (h, w), kw = {
        'square': ((112, 112), {}),
        'upscaled': ((30, 40), {}),
        'panorama': ((40, 300), {}),
        'portrait': ((300, 90), {}),
        'gridded': ((200, 250), {'max_slice_nums': 9}),
        'capped': ((40, 300), {'max_grid_side': 5}),
        'cut': ((10, 600), {}),
    }[case]
    kw = dict({'query_num': Q, 'scale_resolution': 56,
               'max_slice_nums': 4}, **kw)
    got_proc = timage.MiniCPMVSliceProcessor(mv['tcfg'].vision, **kw)
    want_proc = jimage.MiniCPMVSliceProcessor(mv['jcfg'].vision, **kw)
    img = PIL.fromarray(np.random.default_rng(len(case) * h + w).integers(
        0, 256, (h, w, 3)).astype(np.uint8))
    got, want = got_proc(img), want_proc(img)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    tgt = got['tgt_sizes']
    n_crops = int((tgt[:, 0] > 0).sum())
    assert got['num_tokens'] == n_crops * Q
    assert got['pixel_values'].shape == (got_proc.num_crops,
                                         got_proc.max_patches, 588)
    if case == 'upscaled':
        assert n_crops == 1
    if case in ('panorama', 'gridded'):
        assert n_crops > 2
    if case == 'capped':
        assert tgt[:n_crops].max() <= 5
    if case == 'cut':
        assert int(tgt[0, 0] * tgt[0, 1]) > got_proc.max_patches


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('layout', ['fixed', 'packed', 'padded'])
def test_resampler_matches_jax(mv, layout):
    """The resampler over a square grid of all slots, over packed grids,
    and with a crop of no patch at all (``tgt_sizes`` (0, 0): the finite
    fill gives a uniform softmax, finite in both)."""
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(3, 16, 32)).astype(np.float32)
    grids = {'fixed': None, 'packed': ((4, 2), (3, 4), (4, 4)),
             'padded': ((4, 2), (0, 0), (2, 2))}[layout]
    tgt = None if grids is None else np.asarray(grids, np.int32)
    got = tm.resampler_forward(
        mv['tparams']['resampler'], mv['tcfg'].resampler,
        torch.from_numpy(feats),
        None if tgt is None else torch.from_numpy(tgt))
    want = _jresample(
        mv['params']['resampler'], mv['jcfg'].resampler, jnp.asarray(feats),
        None if tgt is None else jnp.asarray(tgt))
    assert got.shape == (3, Q, 32)
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want)


@pytest.mark.parametrize('layout', ['fixed', 'packed', 'slice'])
def test_encode_image_crops_matches_jax(mv, layout):
    """The tower and resampler over fixed images, packed patch rows and
    slice-mode crops (padded crops included), within 1e-4; slice mode
    gives each row ``M * query_num`` tokens, crop-major."""
    kw, jkw, _ = _media(layout, 3)
    got = tm.encode_image_crops(mv['tparams'], mv['tcfg'],
                                kw['pixel_values'], kw.get('tgt_sizes'),
                                torch.float32)
    want = _jencode(mv['params'], mv['jcfg'], jkw['pixel_values'],
                    jkw.get('tgt_sizes'), jnp.float32)
    assert got.shape == ((3, 3 * Q, 32) if layout == 'slice' else (3, Q, 32))
    _close(got, want)


def test_dtypes_follow_jax_promotion(mv):
    """Under bf16 compute: the pixels are rounded to bf16, the tower's fp32
    params promote them back, the resampler computes in fp32 (JAX
    ``minicpmv.py:132``), and the merge casts to bf16 (JAX
    ``multimodal.py:183``); the embeddings equal JAX's bf16 run's."""
    kw, jkw, n = _media('slice', 4)
    px, tgt = kw['pixel_values'], kw['tgt_sizes']
    got = tm.encode_image_crops(mv['tparams'], mv['tcfg'], px, tgt,
                                torch.bfloat16)
    want = _jencode(mv['params'], mv['jcfg'], jkw['pixel_values'],
                    jkw['tgt_sizes'], jnp.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want)
    fp32 = tm.encode_image_crops(mv['tparams'], mv['tcfg'], px, tgt,
                                 torch.float32)
    assert not torch.equal(got, fp32)           # the pixels were rounded
    rounded = tm.encode_image_crops(mv['tparams'], mv['tcfg'],
                                    px.to(torch.bfloat16).float(), tgt,
                                    torch.float32)
    assert torch.equal(got, rounded)
    ids, mask = _ids(n)
    bf16 = mv['tcfg'].replace(compute_dtype='bfloat16')
    seen = {}
    real = tm.merge_image_embeds

    def merge(embeds, image_embeds, *a):
        seen['dtypes'] = (embeds.dtype, image_embeds.dtype)
        out = real(embeds, image_embeds, *a)
        seen['out'] = out.dtype
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, 'merge_image_embeds', merge)
        tm.forward(mv['tparams'], bf16, torch.from_numpy(ids),
                   attention_mask=torch.from_numpy(mask), **kw)
    assert seen == {'dtypes': (torch.bfloat16, torch.float32),
                    'out': torch.bfloat16}


@pytest.mark.parametrize('layout', ['text', 'fixed', 'packed', 'slice'])
def test_forward_logits_match_jax(mv, layout):
    """Logits text-only, with fixed images, packed patches and slice-mode
    crops (``tgt_sizes`` (B, M, 2), padded crops in the batch)."""
    kw, jkw, n = _media(layout, 8)
    ids, mask = _ids(n if layout != 'text' else (Q, Q, Q))
    if layout == 'text':
        ids = np.where(ids == IMG, 3, ids)
    got = tm.forward(mv['tparams'], mv['tcfg'], torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask), **kw)
    want = _jforward(mv['params'], mv['jcfg'], jnp.asarray(ids, jnp.int32),
                     attention_mask=jnp.asarray(mask, jnp.int32), **jkw)
    _close(got.logits, want.logits)


@functools.partial(jax.jit, static_argnums=1)
def _jax_logprobs(params, jcfg, ids, mask, px, grids):
    """JAX's ``token_logprobs`` with ``tgt_sizes`` (compiled: one trace
    instead of hundreds of eager ops)."""
    return jm.token_logprobs(params, jcfg, ids, attention_mask=mask,
                             pixel_values=px, tgt_sizes=grids)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


def test_logprobs_and_grads_match_jax(mv, monkeypatch):
    """``token_logprobs`` over slice-mode crops with ``tgt_sizes``, padded
    crops in the batch, against JAX's, and the gradient of their masked
    sum at every leaf (tower, resampler, trunk): finite, and within 1e-4
    of JAX's (the tower's key biases, whose gradient is zero in exact
    arithmetic, zero in both within 1e-4 of their layer's query-weight
    gradient); the tower's attention in two chunks of 8 queries, so that
    its backward adds dK / dV over chunks as at full size."""
    monkeypatch.setattr(tattn, 'CHUNKED_ATTN_ELEMS', 1)
    assert tattn._chunk_rows(9, 16, 4) == 8
    px, grids = _slices(10)
    ids, mask = _ids(_slice_tokens())
    args = (jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
            jnp.asarray(px), jnp.asarray(grids))
    want = _jax_logprobs(mv['params'], mv['jcfg'], *args)
    tparams = from_jax_tree(mv['params'], device='cpu')
    for t in param_leaves(tparams):
        t.requires_grad_(True)
    got = tm.token_logprobs(tparams, mv['tcfg'], torch.from_numpy(ids),
                            attention_mask=torch.from_numpy(mask),
                            pixel_values=torch.from_numpy(px),
                            tgt_sizes=torch.from_numpy(grids))
    _close(got, want)
    w = torch.from_numpy(mask[:, 1:]).float()
    (got * w).sum().backward()

    def loss(p):
        return (_jax_logprobs(p, mv['jcfg'], *args)
                * jnp.asarray(mask[:, 1:], jnp.float32)).sum()

    jgrads = leaves(jax.jit(jax.grad(loss))(mv['params']))
    tgrads = leaves(_grad_tree(tparams))
    assert set(tgrads) == set(jgrads)
    for p, g in jgrads.items():
        if p.endswith('/self_attn/k_proj/bias'):
            # zero in exact arithmetic (softmax is invariant to one shift
            # of a query's logits): both packages' rounding noise, held to
            # 1e-4 of the layer's largest attention gradient instead
            scale = float(np.abs(jgrads[p.replace('k_proj/bias',
                                                  'q_proj/weight')]).max())
            assert np.isfinite(tgrads[p]).all()
            assert max(float(np.abs(tgrads[p]).max()),
                       float(np.abs(g).max())) <= REL * scale, p
            continue
        _close(tgrads[p], g)
    # the padded crops' tower and resampler work reached the weights
    assert float(np.abs(tgrads['/resampler/query']).max()) > 0


def test_loader_and_writer_match_jax(assets, mv, tmp_path):
    """The port's loader reads the port-written checkpoint into JAX's tree
    bit for bit with JAX's configs; the port's writer writes the openbmb
    names and the ``config.json`` JAX's writer writes, and reads back
    bit-equal in both packages; JAX's writer over JAX's tree reads back
    bit-equal too (it makes every tensor contiguous before the write, so
    ROADMAP R8 does not reach it)."""
    got, want = leaves(mv['tparams']), leaves(mv['params'])
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    _, jcfg = jhf.load_minicpmv_params(str(assets / 'model'))
    _, tcfg = thf.load_minicpmv_params(str(assets / 'model'), device='cpu')
    assert tcfg.vision.__dict__ == jcfg.vision.__dict__
    assert tcfg.resampler.__dict__ == jcfg.resampler.__dict__
    assert (tcfg.image_token_id, tcfg.slice_mode) == (IMG, True) == (
        jcfg.image_token_id, jcfg.slice_mode)
    for f in ('vocab_size', 'hidden_size', 'num_layers', 'num_heads',
              'num_kv_heads', 'head_dim', 'mlp_dim', 'rope_theta',
              'norm_eps', 'qkv_bias', 'pad_token_id', 'eos_token_id',
              'bos_token_id', 'tie_word_embeddings'):
        assert getattr(tcfg.text, f) == getattr(jcfg.text, f), f
    thf.save_minicpmv_params(str(tmp_path / 'port'), mv['tparams'],
                             mv['tcfg'])
    jhf.save_minicpmv_params(str(tmp_path / 'jax'), mv['params'],
                             mv['jcfg'])
    names = [set(thf.read_safetensors(str(tmp_path / d / 'model.safetensors')))
             for d in ('port', 'jax')]
    assert names[0] == names[1]
    hf = [json.loads((tmp_path / d / 'config.json').read_text())
          for d in ('port', 'jax')]
    assert hf[0] == hf[1]
    for d in ('port', 'jax'):
        back_t, _ = thf.load_minicpmv_params(str(tmp_path / d), device='cpu')
        back_j, _ = jhf.load_minicpmv_params(str(tmp_path / d))
        for back in (leaves(back_t), leaves(back_j)):
            for p in want:
                np.testing.assert_array_equal(back[p], want[p],
                                              err_msg=f'{d} {p}')


def test_init_tree_matches_jax(mv):
    """``init_params`` (explicit generators) gives JAX's keys, shapes and
    fp32 dtype (JAX's traced by ``jax.eval_shape``, not run)."""
    def shapes(tree, prefix=''):
        if isinstance(tree, dict):
            return {p: s for k, v in tree.items()
                    for p, s in shapes(v, f'{prefix}/{k}').items()}
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).removeprefix('torch.'))}

    got = shapes(tm.init_params(mv['tcfg'], torch.Generator().manual_seed(0),
                                device='cpu'))
    want = shapes(jax.eval_shape(lambda k: jm.init_params(mv['jcfg'], k),
                                 jax.random.PRNGKey(0)))
    assert got == want


def test_generate_matches_jax(mv):
    """Greedy ``generate`` with slice-mode crops in the prefill
    (``media={'tgt_sizes': ...}``, a padded crop in each row) and
    ``forward`` as both the prefill and the decode step: JAX's ids."""
    grids = (((4, 3), (2, 4), (0, 0)), ((2, 4), (0, 0), (0, 0)))
    px, tgt = _slices(11, grids)
    ids = np.asarray([[0, 0, 0, 0, 1, 5] + [IMG] * 8 + [6, 7],
                      [1, 9, 3, 4, 5] + [IMG] * 4 + [10, 11, 12, 13, 14, 15,
                                                     16]])
    mask = (np.arange(16)[None] >= np.asarray([[4], [0]])).astype(np.int64)
    gen = dict(max_new_tokens=5, greedy=True, eos_token_id=-1)
    got = generate(mv['tparams'], mv['tcfg'], GenerationConfig(**gen),
                   torch.from_numpy(ids), torch.from_numpy(mask),
                   pixel_values=torch.from_numpy(px),
                   media={'tgt_sizes': torch.from_numpy(tgt)},
                   prefill_forward=tm.forward, step_forward=tm.forward)
    want = jeng.generate(
        mv['params'], mv['jcfg'], jeng.GenerationConfig(**gen),
        jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
        jax.random.PRNGKey(0), pixel_values=jnp.asarray(px),
        media={'tgt_sizes': jnp.asarray(tgt)},
        prefill_forward=jm.forward, step_forward=jm.forward)
    np.testing.assert_array_equal(got['sequences'].numpy(),
                                  np.asarray(want['sequences']))


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

PORT = {'sft': tsft.TI2TSupervisedTrainer, 'dpo': tdpo.TI2TDPOTrainer,
        'kto': tkto.TI2TKTOTrainer, 'orpo': torpo.TI2TORPOTrainer,
        'simpo': tsimpo.TI2TSimPOTrainer}
TASK = {'sft': 'text_image_to_text/sft', 'dpo': 'text_image_to_text/dpo',
        'kto': 'text_to_text/kto', 'orpo': 'text_to_text/orpo',
        'simpo': 'text_to_text/simpo'}


def _argv(assets, algo, per_device, out=None, extra=()):
    data = 'sft' if algo == 'sft' else 'pref'
    kl = (('--per_device_kl_batch_size', str(per_device)) if algo == 'kto'
          else ())
    return ['--model_name_or_path', str(assets / 'model'),
            '--train_datasets', str(assets / f'{data}.jsonl'),
            '--train_template', 'AA_TI2T',
            *(('--output_dir', str(out)) if out else ()),
            '--epochs', '1', '--learning_rate', '1e-4', '--bf16', 'False',
            '--padding_buckets', '[64]', '--save_checkpoint', 'False',
            '--per_device_train_batch_size', str(per_device), *kl, *extra]


@pytest.fixture
def slicing(monkeypatch):
    for k, v in SLICING.items():
        monkeypatch.setenv(k, v)


# DPO runs two steps of 4 pairs (step 2 is held to JAX's loss), the others
# one step of all 8 rows, as JAX's 8 devices take them
STEPS = {'dpo': 2}
PER_DEVICE = {'dpo': 4}


@pytest.fixture(scope='module')
def runs(assets):
    """algo -> the port's trainer on all ``ROWS`` rows (each built once in
    this file): its start-up output, its params before the steps and
    after each (numpy trees) and the metrics of its ``STEPS``."""
    cache = {}

    def run(algo):
        if algo not in cache:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed), \
                    pytest.MonkeyPatch.context() as mp:
                for k, v in SLICING.items():
                    mp.setenv(k, v)
                cfgs, pc = tcli.parse_cfgs(TASK[algo], _argv(
                    assets, algo, PER_DEVICE.get(algo, JAX_DEVICES)))
                trainer = PORT[algo](cfgs=cfgs, parallel_cfgs=pc,
                                     device='cpu')
            start = _np_tree(trainer.state.params)
            got, after = [], []
            for b in list(trainer.train_iterator.epoch_batches(0))[
                    :STEPS.get(algo, 1)]:
                got.append({k: float(v)
                            for k, v in trainer.train_step(b).items()})
                after.append(_np_tree(trainer.state.params))
            cache[algo] = dict(trainer=trainer, printed=printed.getvalue(),
                               start=start, got=got, after=after)
        return cache[algo]

    return run


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def test_sft_step_matches_jax(assets, mv, runs, slicing):
    """One SFT step of 8 rows: the same batch (slice-mode crops,
    ``tgt_sizes`` (8, 3, 2), 4 or 12 image tokens a row), every metric JAX
    reports and every param after the step; the tower trains in both
    (R40).  JAX's trainer is built with R1's ``pp_stages`` patched."""
    from align_anything_tpu.trainers import cli as jcli
    from align_anything_tpu.trainers.text_image_to_text import sft as jsft

    with pytest.MonkeyPatch.context() as mp:
        # R1: the JAX SFT engine reads model_cfg.pp_stages
        mp.setattr(jm.MiniCPMVConfig, 'pp_stages', 1, raising=False)
        # the specs from the loaded tree (the same all-replicated tower
        # specs; without it JAX draws a random tower op by op for them)
        mp.setattr(jm, 'param_specs', functools.partial(
            jm.param_specs, params=mv['params']))
        cfgs, pc = jcli.parse_cfgs(TASK['sft'], _argv(assets, 'sft', 1))
        jtrainer = one_compile(jsft.TI2TSupervisedTrainer(
            cfgs=cfgs, parallel_cfgs=pc))
        jbatch = next(iter(jtrainer.train_iterator.epoch_batches(0)))
        jstart = leaves(jtrainer.state.params['vpm'])
        want = _steps(jtrainer, 1)
    r = runs('sft')
    trainer = r['trainer']
    assert trainer.mm is tm
    batch = next(iter(trainer.train_iterator.epoch_batches(0)))
    assert set(batch) == set(jbatch)
    for key in jbatch:
        np.testing.assert_array_equal(batch[key], jbatch[key], err_msg=key)
    assert batch['pixel_values'].shape == (ROWS, 3, 9, 588)
    assert batch['tgt_sizes'].shape == (ROWS, 3, 2)
    n_crops = (batch['tgt_sizes'][..., 0] > 0).sum(-1)
    assert {int(c) for c in n_crops} == {1, 3}
    assert ((batch['input_ids'] == IMG).sum(-1) == Q * n_crops).all()
    _compare(r['got'], want)
    want_p, got_p = leaves(jtrainer.state.params), leaves(
        trainer.state.params)
    assert set(got_p) == set(want_p)
    for path, leaf in got_p.items():
        np.testing.assert_allclose(leaf, want_p[path], rtol=TOL, atol=TOL,
                                   err_msg=path)
    moved = leaves(jtrainer.state.params['vpm'])
    assert all(not np.array_equal(moved[p], jstart[p]) for p in jstart)


def test_dpo_steps_match_jax_loss(mv, runs):
    """Two DPO steps of 4 pairs: step 1 at ln 2 (the policy is the
    reference); step 2's loss and rewards equal JAX's DPO loss over JAX's
    log-probs (with ``tgt_sizes``) of the port's params after step 1
    against the loaded reference, within 1e-5 (JAX's DPO trainer fails
    at init on MiniCPM-V: R41)."""
    from align_anything_tpu.losses.preference import dpo_loss

    r = runs('dpo')
    trainer, got = r['trainer'], r['got']
    assert trainer.mm is tm
    assert abs(got[0]['train/loss'] - math.log(2)) <= 1e-6
    assert got[1]['train/loss'] != got[0]['train/loss']
    b = list(trainer.train_iterator.epoch_batches(0))[1]
    assert b['tgt_sizes'].shape[1:] == (3, 2)
    args = [jnp.asarray(b[k]) for k in ('input_ids', 'attention_mask',
                                        'pixel_values', 'tgt_sizes')]
    policy = jax.tree.map(jnp.asarray, r['after'][0])
    ref = jax.tree.map(jnp.asarray, mv['params'])
    lp = _jax_logprobs(policy, mv['jcfg'], *args)
    ref_lp = _jax_logprobs(ref, mv['jcfg'], *args)
    want = dpo_loss(lp, ref_lp, args[0], jnp.asarray(b['response_mask']),
                    scale_coeff=trainer.cfgs.train_cfgs.scale_coeff)
    assert abs(got[1]['train/loss'] - float(want['loss'])) <= TOL
    for key in ('reward', 'better_sample_reward', 'worse_sample_reward',
                'reward_margin'):
        assert abs(got[1][f'train/{key}']
                   - float(jnp.mean(want[key]))) <= TOL, key


@pytest.mark.parametrize('algo', ['kto', 'orpo', 'simpo'])
def test_dpo_family_step(assets, mv, runs, slicing, algo):
    """One step of TI2T KTO (its text-only KL rows, R14), ORPO and SimPO on
    the MiniCPM-V checkpoint: the step's loss and rewards equal JAX's
    trainer's ``preference_loss`` (``kto_loss`` / ``orpo_loss`` /
    ``simpo_loss`` as JAX's trainer wires them, from JAX's config) over
    JAX's log-probs (with ``tgt_sizes``) of the same batch and params,
    within 1e-5 (JAX's trainers fail at init on MiniCPM-V: R41); every
    module moved."""
    import importlib
    import types

    from align_anything_tpu.trainers import cli as jcli

    r = runs(algo)
    trainer, got = r['trainer'], r['got']
    assert trainer.mm is tm
    assert got and all(np.isfinite(v) for v in got[0].values())
    b = next(iter(trainer.train_iterator.epoch_batches(0)))
    assert b['tgt_sizes'].shape[1:] == (3, 2)
    args = [jnp.asarray(b[k]) for k in ('input_ids', 'attention_mask',
                                        'pixel_values', 'tgt_sizes')]

    def jax_lp(params):
        # in halves of the DPO test's 8 rows: rows are independent, and
        # one compile of JAX's log-probs serves the whole file
        params = jax.tree.map(jnp.asarray, params)
        return jnp.concatenate([
            _jax_logprobs(params, mv['jcfg'], *(a[i:i + 8] for a in args))
            for i in range(0, args[0].shape[0], 8)])

    lp = jax_lp(r['start'])
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    ref_lp = None
    if algo == 'kto':
        # step 1 runs before any refresh, on the start-up estimate over
        # the policy that is still the reference: JAX's estimate is 0
        assert abs(trainer.kl) <= TOL
        ref_lp = jax_lp(mv['params'])
        jbatch['kl_baseline'] = jnp.zeros((1,), jnp.float32)
    jcfgs, _ = jcli.parse_cfgs(TASK[algo], _argv(assets, algo, JAX_DEVICES))
    jcls = getattr(importlib.import_module(
        f'align_anything_tpu.trainers.text_to_text.{algo}'),
        {'kto': 'KTOTrainer', 'orpo': 'ORPOTrainer',
         'simpo': 'SimPOTrainer'}[algo])
    want = jcls.preference_loss(types.SimpleNamespace(cfgs=jcfgs), lp,
                                ref_lp, jbatch)
    assert abs(got[0]['train/loss'] - float(want['loss'])) <= TOL
    for key in ('reward', 'better_sample_reward', 'worse_sample_reward',
                'reward_margin'):
        assert abs(got[0][f'train/{key}']
                   - float(jnp.mean(want[key]))) <= TOL, key
    after, start = leaves(trainer.state.params), leaves(r['start'])
    for module in ('/llm', '/vpm', '/resampler'):
        assert any(not np.array_equal(after[p], start[p])
                   for p in after if p.startswith(module)), module


def test_export_and_resume(assets, tmp_path, slicing):
    """``trainer_main`` (the entry point's path) trains with an
    ``output_dir``: ``save_hf_slice`` sends the MiniCPM-V config to the new
    writer, and the slice reads back through both packages' loaders equal
    to the trained state; the train state saved after the step resumes
    bit for bit."""
    out = tmp_path / 'run'
    argv = _argv(assets, 'sft', 2, out, extra=(
        '--save_checkpoint', 'True', '--train_size', '2'))
    trainer = tcli.trainer_main(tsft.TI2TSupervisedTrainer,
                                TASK['sft'], argv, device='cpu')
    tckpt.wait_for_saves()
    path = out / f'slice_{trainer.global_step}'
    want = leaves(trainer.state.params)
    back, cfg = thf.load_minicpmv_params(str(path), device='cpu')
    jback, _ = jhf.load_minicpmv_params(str(path))
    assert cfg.resampler == trainer.model_cfg.resampler
    for tree in (leaves(back), leaves(jback)):
        assert set(tree) == set(want)
        for p, leaf in tree.items():
            np.testing.assert_array_equal(leaf, want[p], err_msg=p)
    cfgs, pc = tcli.parse_cfgs(TASK['sft'], _argv(
        assets, 'sft', 2, out, extra=('--load_checkpoint', 'True')))
    resumed = tsft.TI2TSupervisedTrainer(cfgs=cfgs, parallel_cfgs=pc,
                                         device='cpu')
    assert resumed.global_step == trainer.global_step >= 1
    got = leaves(resumed.state.params)
    assert all(np.array_equal(got[p], want[p]) for p in want)


# ---------------------------------------------------------------------------
# the reference's faults
# ---------------------------------------------------------------------------

def test_r40_freeze_flags_miss_the_tower(mv, runs):
    """R40: the TI2T YAMLs' ``freeze_vision_tower: True`` names
    ``vision_tower``, which a MiniCPM-V tree (``llm``, ``vpm``,
    ``resampler``) does not hold: JAX's labels freeze nothing, the port's
    start-up prints the line naming R40, and every tower leaf gets an
    optimizer state and moves (the SFT test shows JAX's tower moving)."""
    from align_anything_tpu.trainers.optimizer import freeze_labels

    labels = freeze_labels(mv['params'], ('vision_tower', 'projector'))
    assert set(jax.tree.leaves(labels)) == {'train'}
    r = runs('dpo')
    trainer = r['trainer']
    assert "freeze_vision_tower: True names ('vision_tower',)" in r['printed']
    assert 'R40' in r['printed']
    assert trainer.frozen_modules() == ('vision_tower',)
    held = {id(p) for g in trainer.state.optimizer.param_groups
            for p in g['params']}
    assert all(id(t) in held
               for t in param_leaves(trainer.state.params['vpm']))
    after = leaves(trainer.state.params['vpm'])
    start = leaves(r['start']['vpm'])
    assert all(not np.array_equal(after[p], start[p]) for p in after)


@pytest.mark.parametrize('algo', ['dpo', 'kto', 'orpo', 'simpo'])
def test_r41_jax_dpo_family_fails_at_init(assets, slicing, algo):
    """R41: JAX's TI2T DPO (whose ``init_datasets`` its KTO, ORPO and SimPO
    reach) reads ``model_cfg.vision.num_patches``, which MiniCPM-V's SigLIP
    config lacks: ``AttributeError`` before any step; the port's trainers
    build (the runs above)."""
    import importlib

    from align_anything_tpu.trainers import cli as jcli

    module = importlib.import_module(
        f'align_anything_tpu.trainers.text_image_to_text.{algo}')
    cls = getattr(module, PORT[algo].__name__)
    cfgs, pc = jcli.parse_cfgs(TASK[algo], _argv(assets, algo, 1))
    with pytest.raises(AttributeError, match='num_patches'):
        cls(cfgs=cfgs, parallel_cfgs=pc)
