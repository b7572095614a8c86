"""The port's Mllama (Llama-3.2-Vision) path against the JAX package's, on
the CPU: ``data/image.py`` ``MllamaTileProcessor`` and its collated batch,
``models/mllama.py`` (the tiled tower with its %8 patch padding and
both-invalid bias, its chunked attention and that attention's backward,
the cross-attention mask and full-row mask, the text-only and image
forwards, log-probs), the loader and writer (``models/hf_loader.py``)
through both packages' loaders, ``save_hf_slice``, the bridge of the
JAX tree and ``generate(init_cache_fn=...)``.

The checkpoint is a tiny ``MllamaForConditionalGeneration`` saved by
transformers (a tower 32 wide of 2 local and 1 global layers, taps at
layers 0 and 1, 28 px tiles of 4 patches + the class token, padded to 8,
2 tiles; a trunk of 3 layers, layer 1 cross; vocab 128, the image token
128, the first of the 8 extra embedding rows).  transformers initialises
every gate at 0, which would switch the cross layers and the tile
embeddings off: the JAX tree from JAX's loader is perturbed so that every
leaf matters, and goes to the port through ``models/bridge.py``.

Tolerances: host-side arrays, the loaded trees and the exports exactly;
the tower, logits, log-probs and gradients within 1e-4 of their max
(fp32); the chunked attention within 1e-6 of one chunk; generated ids
exactly.  The trainers are in ``tests/test_torch_mllama_trainers.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
PIL = pytest.importorskip('PIL.Image')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.data import image as jimage  # noqa: E402
from align_anything_tpu.generation import engine as jeng  # noqa: E402
from align_anything_tpu.models import mllama as jm  # noqa: E402
from align_anything_tpu.models.hf_loader import (  # noqa: E402
    load_mllama_params as jload,
    save_mllama_params as jsave,
)
from align_anything_tpu_torch.checkpoint import save_hf_slice  # noqa: E402
from align_anything_tpu_torch.data import image as timage  # noqa: E402
from align_anything_tpu_torch.generation import (  # noqa: E402
    GenerationConfig,
    generate,
)
from align_anything_tpu_torch.models import mllama as tm  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.hf_loader import (  # noqa: E402
    load_mllama_params as tload,
    save_mllama_params as tsave,
)
from align_anything_tpu_torch.ops import attention as tattn  # noqa: E402
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    sft as tsft,
)
from align_anything_tpu_torch.utils.tools import (  # noqa: E402
    param_leaves,
    tree_map,
)

REL = 1e-4
IMG = 128


def hf_mllama_config(text_layers=3, cross=(1,), local=2, global_=1,
                     taps=(0, 1)):
    return transformers.MllamaConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=local,
                           num_global_layers=global_, attention_heads=4,
                           image_size=28, patch_size=14, max_num_tiles=2,
                           supported_aspect_ratios=[[1, 1], [1, 2], [2, 1]],
                           intermediate_layers_indices=list(taps),
                           vision_output_dim=32 * (1 + len(taps))),
        text_config=dict(vocab_size=128, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=text_layers,
                         num_attention_heads=4, num_key_value_heads=2,
                         cross_attention_layers=list(cross),
                         max_position_embeddings=256, rope_theta=10000.0,
                         rope_scaling={'rope_type': 'default'},
                         pad_token_id=0, eos_token_id=2),
        image_token_index=IMG)


def write_hf_mllama(d, **kw):
    """A tiny transformers Mllama checkpoint in ``d``."""
    torch.manual_seed(0)
    transformers.MllamaForConditionalGeneration(
        hf_mllama_config(**kw)).eval().save_pretrained(
            d, safe_serialization=True)
    return d


def leaves(tree, prefix=''):
    """path -> numpy array of a tree of dicts and lists (either package)."""
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items()
                for p, a in leaves(v, f'{prefix}/{k}').items()}
    if isinstance(tree, list):
        return {p: a for i, v in enumerate(tree)
                for p, a in leaves(v, f'{prefix}/{i}').items()}
    return {prefix: np.array(tree.detach().cpu() if hasattr(tree, 'detach')
                             else tree)}


def perturbed(params, seed=0):
    """The JAX tree as numpy, every leaf moved by 0.05 x N(0, 1) (gates
    by 0.5): zero gates, biases and unit norms would hide a leaf the port
    reads wrong."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        s = 0.5 if a.shape == (1,) else 0.05
        return (a + s * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree.map(move, params)


@pytest.fixture(scope='module')
def mll(tmp_path_factory):
    d = write_hf_mllama(tmp_path_factory.mktemp('mllama'))
    jparams, jcfg0 = jload(str(d))
    params = perturbed(jparams)
    tparams, tcfg0 = tload(str(d), device='cpu')
    return {'dir': d, 'params': params,
            'jcfg': jcfg0.replace(compute_dtype='float32',
                                  attention_impl='xla'),
            'tcfg': tcfg0.replace(compute_dtype='float32'),
            'tparams': from_jax_tree(params, device='cpu'),
            'loaded': (jparams, jcfg0, tparams, tcfg0)}


def _close(got, want, rel=REL):
    got = got.detach().numpy() if hasattr(got, 'detach') else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(float(np.max(np.abs(want))), 1e-6), err


def _tiles(cfg, seed):
    """Two rows of one image: 2 valid tiles (ratio [1, 2], id 2), and 1
    valid tile (id 1) whose padding tile is zeros: the both-invalid bias
    and the %8 padding."""
    vc = cfg.vision
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((2, 1, vc.max_num_tiles, 3, vc.image_size,
                              vc.image_size)).astype(np.float32)
    px[1, 0, 1] = 0.0
    ar_ids = np.array([[2], [1]], np.int64)
    ar_mask = np.array([[[1, 1]], [[1, 0]]], np.int64)
    return px, ar_ids, ar_mask


def _both(arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def _rows(seed, lengths=(10, 10), image_at=(1, 3)):
    """Token rows with the image token at ``image_at`` (None: no image),
    right-padded to the longest with 0 and masked."""
    rng = np.random.default_rng(seed)
    n = max(lengths)
    ids = np.zeros((len(lengths), n), np.int64)
    mask = np.zeros_like(ids)
    for r, (length, at) in enumerate(zip(lengths, image_at)):
        ids[r, :length] = rng.integers(3, 120, length)
        if at is not None:
            ids[r, at] = IMG
        mask[r, :length] = 1
    return ids, mask


# ---------------------------------------------------------------------------
# the tile processor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('hw', [(28, 28), (40, 70), (70, 30), (10, 200),
                                (200, 200)])
def test_tile_processor_matches_jax(hw):
    """Every key of the processor's output equal to JAX's, at square,
    wide, tall, thin and large images (canvas, resize, pad, tiles, ids,
    mask)."""
    class V:
        image_size = 28
        max_num_tiles = 4

    img = np.random.default_rng(hw[0]).integers(
        0, 256, size=hw + (3,)).astype(np.uint8)
    got = timage.MllamaTileProcessor(V())(img)
    want = jimage.MllamaTileProcessor(V())(img)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    assert got['num_tokens'] == 1
    assert got['aspect_ratio_mask'].sum() == np.prod(
        timage.MllamaTileProcessor(V()).ratios[
            int(got['aspect_ratio_ids'][0]) - 1])


def test_collator_stacks_tile_metadata(mll, tmp_path):
    """The TI2T supervised collator over two images of different ratios:
    one image token a row and the tile metadata batched, as JAX's."""
    from align_anything_tpu_torch.data.tokenizer import HashTokenizer

    rng = np.random.default_rng(3)
    samples = []
    for i, hw in enumerate(((28, 56), (28, 28))):
        out = timage.MllamaTileProcessor(mll['tcfg'].vision)(
            rng.integers(0, 256, size=hw + (3,)).astype(np.uint8))
        ids = timage.expand_image_tokens(
            f'<image> w{i} w{i + 1}', HashTokenizer(vocab_size=128), IMG,
            out['num_tokens'])
        samples.append({'input_ids': ids, 'labels': ids, 'prompt_len': 1,
                        'pixel_values': out})
    got = timage.TI2TSupervisedCollator(0, (16,))(samples)
    want = jimage.TI2TSupervisedCollator(0, (16,))(samples)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got['input_ids'] == IMG).sum(-1).tolist() == [1, 1]
    assert got['pixel_values'].shape == (2, 1, 2, 3, 28, 28)
    assert got['aspect_ratio_ids'].tolist() == [[2], [1]]
    assert got['aspect_ratio_mask'].tolist() == [[[1, 1]], [[1, 0]]]


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

def test_vision_tower_matches_jax(mll):
    """The tower's output (the final states and both taps) over a row of
    two valid tiles and a row of one: valid queries attend to the padding
    tile's and padded patches' keys, as JAX's."""
    jcfg, tcfg = mll['jcfg'], mll['tcfg']
    (tpx, tid, tmask), (jpx, jid, jmask) = _both(_tiles(tcfg, seed=1))
    got = tm.vision_forward(mll['tparams']['vision_model'], tcfg.vision,
                            tpx, tid, tmask)
    # JAX's tower compiled (the eager op-by-op trace is slow)
    want = jax.jit(jm.vision_forward, static_argnums=1)(
        mll['params']['vision_model'], jcfg.vision, jpx, jid, jmask)
    assert got.shape == (2, 1, 2, 5, 96)
    _close(got, want)


def test_chunked_attention_matches_one_chunk(mll, monkeypatch):
    """The tower's attention (``ops/attention.py``
    ``chunked_masked_attention`` with the both-invalid bias) in chunks of 8
    queries (two chunks a row) and in one: the same output and the same
    gradients of q, k and v, which autograd of the plain expression also
    gives."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 4, 8)).astype(
        np.float32)).requires_grad_(True) for _ in range(3))
    invalid = torch.zeros(2, 16)
    invalid[0, 5:8] = invalid[0, 13:] = invalid[1, 8:] = 1.0
    dout = torch.from_numpy(rng.standard_normal((2, 16, 4, 8)).astype(
        np.float32))
    runs = {}
    for name, elems in (('chunked', 1), ('one', 1 << 28)):
        monkeypatch.setattr(tattn, 'CHUNKED_ATTN_ELEMS', elems)
        out = tattn.chunked_masked_attention(q, k, v, invalid, invalid)
        runs[name] = (out,) + torch.autograd.grad(out, (q, k, v), dout)
    assert tattn._chunk_rows(2, 16, 4) == 16
    monkeypatch.setattr(tattn, 'CHUNKED_ATTN_ELEMS', 1)
    assert tattn._chunk_rows(2, 16, 4) == 8
    plain = tattn._masked_attend_chunk(q, k.float(), v, invalid, invalid)
    runs['plain'] = (plain,) + torch.autograd.grad(plain, (q, k, v), dout)
    for name in ('chunked', 'plain'):
        for got, want in zip(runs[name], runs['one']):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_vision_tower_grads_match_jax(mll):
    """The gradient of a weighted sum of the tower's output with respect
    to every tower leaf, under the 'full' remat policy, against JAX's."""
    jcfg, tcfg = mll['jcfg'], mll['tcfg']
    (tpx, tid, tmask), (jpx, jid, jmask) = _both(_tiles(tcfg, seed=4))
    w = np.random.default_rng(5).standard_normal((2, 1, 2, 5, 96)).astype(
        np.float32)
    vp = tree_map(lambda t: t.clone().requires_grad_(True),
                  mll['tparams']['vision_model'])
    out = tm.vision_forward(vp, tcfg.vision, tpx, tid, tmask,
                            remat='full')
    (out * torch.from_numpy(w)).sum().backward()

    def loss(p):
        return (jm.vision_forward(p, jcfg.vision, jpx, jid, jmask)
                * jnp.asarray(w)).sum()

    want = leaves(jax.jit(jax.grad(loss))(mll['params']['vision_model']))
    got = leaves(tree_map(lambda t: t.grad, vp))
    assert set(got) == set(want)
    for path in want:
        _close(got[path], want[path])


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------

def test_cross_attention_mask_and_full_row(mll):
    """The default mask (from the image token onward, over the row's valid
    tiles; a row without one sees nothing), the bias and the full-row mask
    against JAX's."""
    ids, _ = _rows(6, lengths=(8, 8, 8), image_at=(2, 0, None))
    ar_mask = np.array([[[1, 1]], [[1, 0]], [[1, 1]]], np.int64)
    tcfg = mll['tcfg']
    got = tm.default_cross_attention_mask(tcfg, torch.from_numpy(ids),
                                          torch.from_numpy(ar_mask))
    want = np.zeros((3, 8, 1, 2), np.int32)
    want[0, 2:] = 1
    want[1, :, 0, 0] = 1
    np.testing.assert_array_equal(got.numpy(), want)
    bias, full_row = tm.prepare_cross_attention_mask(got, 5)
    jbias, jfull = jm.prepare_cross_attention_mask(jnp.asarray(want), 5)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
    np.testing.assert_array_equal(full_row.numpy(), np.asarray(jfull))
    assert full_row[:, :, 0].tolist() == [[0.0] * 2 + [1.0] * 6,
                                          [1.0] * 8, [0.0] * 8]


def test_text_only_forward_skips_cross_layers(mll, monkeypatch):
    """A batch without images: JAX's logits, and no cross layer runs."""
    ids, mask = _rows(7, lengths=(10, 7), image_at=(None, None))
    calls = []
    real = tm._cross_layer
    monkeypatch.setattr(tm, '_cross_layer',
                        lambda *a: calls.append(1) or real(*a))
    got = tm.forward(mll['tparams'], mll['tcfg'], torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask))
    want = jax.jit(jm.forward, static_argnums=1)(
        mll['params'], mll['jcfg'], jnp.asarray(ids),
        attention_mask=jnp.asarray(mask))
    assert not calls
    m = mask.astype(bool)
    _close(got.logits.numpy()[m], np.asarray(want.logits)[m])


@pytest.mark.parametrize('mask_from', ['tokens', 'explicit'])
def test_image_forward_and_logprobs_match_jax(mll, mask_from):
    """Logits and log-probs of image rows (the second with one valid tile)
    against JAX's, with the default cross mask and with an explicit one."""
    jcfg, tcfg = mll['jcfg'], mll['tcfg']
    ids, mask = _rows(8, lengths=(12, 9), image_at=(1, 2))
    media = _tiles(tcfg, seed=9)
    xmask = None
    if mask_from == 'explicit':
        xmask = np.zeros((2, 12, 1, 2), np.int64)
        xmask[0, 3:, 0, :] = 1
        xmask[1, 2:7, 0, 0] = 1
    tin, jin = _both(list(media) + ([xmask] if xmask is not None else []))
    names = ('pixel_values', 'aspect_ratio_ids', 'aspect_ratio_mask',
             'cross_attention_mask')
    tkw, jkw = dict(zip(names, tin)), dict(zip(names, jin))
    got = tm.forward(mll['tparams'], tcfg, torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask), **tkw)
    # JAX's forward and log-probs compiled (the eager trace is slow)
    want = jax.jit(jm.forward, static_argnums=1)(
        mll['params'], jcfg, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), **jkw)
    m = mask.astype(bool)
    _close(got.logits.numpy()[m], np.asarray(want.logits)[m])
    px = tkw.pop('pixel_values')
    jpx = jkw.pop('pixel_values')
    got = tm.token_logprobs(mll['tparams'], tcfg, torch.from_numpy(ids),
                            attention_mask=torch.from_numpy(mask),
                            pixel_values=px, **tkw)
    want = jax.jit(jm.token_logprobs, static_argnums=1)(
        mll['params'], jcfg, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), pixel_values=jpx, **jkw)
    m = mask[:, 1:].astype(bool)
    _close(got.numpy()[m], np.asarray(want)[m])


def test_training_forward_under_remat_matches_no_remat(mll):
    """The same loss and gradients with the image rows' layers (tower,
    cross and self) under the 'save_flash' policy and without remat."""
    tcfg = mll['tcfg']
    ids, mask = _rows(10, lengths=(12, 9), image_at=(1, 2))
    px, ar_ids, ar_mask = (torch.from_numpy(a) for a in _tiles(tcfg, 11))
    grads = {}
    for remat in ('none', 'save_flash'):
        p = tree_map(lambda t: t.clone().requires_grad_(True),
                     mll['tparams'])
        lp = tm.token_logprobs(p, tcfg.replace(remat=remat),
                               torch.from_numpy(ids),
                               attention_mask=torch.from_numpy(mask),
                               pixel_values=px, aspect_ratio_ids=ar_ids,
                               aspect_ratio_mask=ar_mask)
        (lp * torch.from_numpy(mask[:, 1:])).sum().backward()
        grads[remat] = leaves(tree_map(lambda t: t.grad, p))
    for path, g in grads['none'].items():
        np.testing.assert_allclose(grads['save_flash'][path], g, rtol=1e-5,
                                   atol=1e-6, err_msg=path)


# ---------------------------------------------------------------------------
# loader, writer, bridge
# ---------------------------------------------------------------------------

def test_loader_matches_jax(mll):
    """Both loaders read the transformers checkpoint into the same tree,
    leaf for leaf, and the same config."""
    jparams, jcfg, tparams, tcfg = mll['loaded']
    want, got = leaves(jparams), leaves(tparams)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert tcfg.cross_attention_layers == jcfg.cross_attention_layers == (1,)
    assert tcfg.image_token_id == jcfg.image_token_id == IMG
    assert tcfg.vision == tm.MllamaVisionConfig(
        **{f: getattr(jcfg.vision, f) for f in (
            'hidden_size', 'intermediate_size', 'num_layers',
            'num_global_layers', 'num_heads', 'image_size', 'patch_size',
            'max_num_tiles', 'max_aspect_ratio_id',
            'intermediate_layers_indices', 'norm_eps')})
    for f in ('vocab_size', 'hidden_size', 'num_layers', 'num_heads',
              'num_kv_heads', 'head_dim', 'mlp_dim', 'rope_theta',
              'rope_llama3', 'norm_eps', 'eos_token_id', 'pad_token_id'):
        assert getattr(tcfg.text, f) == getattr(jcfg.text, f), f
    assert tparams['language_model']['embedding'].shape == (136, 32)


def test_bridge_tree_matches_init(mll):
    """``from_jax_tree`` keeps the lists of per-layer dicts, and the
    port's ``init_params`` builds the same tree and shapes."""
    init = tm.init_params(mll['tcfg'], torch.Generator().manual_seed(0),
                          device='cpu')
    got = {p: a.shape for p, a in leaves(init).items()}
    want = {p: np.asarray(a).shape for p, a in leaves(mll['params']).items()}
    assert got == want
    assert isinstance(mll['tparams']['language_model']['layers'], list)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_export_reads_back_through_both_loaders(mll, tmp_path, dtype):
    """The port's writer read back by the port's and by JAX's loader, and
    JAX's writer read back by the port's: the same tree (the bf16 export
    equal to the tree rounded to bf16).  JAX's writer keeps each tensor
    contiguous, so ROADMAP R8 does not reach it."""
    torch_dtype = getattr(torch, dtype)
    tcfg = mll['loaded'][3]
    tsave(str(tmp_path / 'port'), mll['tparams'], tcfg, dtype=torch_dtype)
    want = {p: torch.from_numpy(a).to(torch_dtype).float().numpy()
            for p, a in leaves(mll['params']).items()}
    back, cfg = tload(str(tmp_path / 'port'), device='cpu')
    jback, _ = jload(str(tmp_path / 'port'))
    for tree in (back, jback):
        got = leaves(tree)
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)
    assert cfg == tcfg
    if dtype == 'float32':
        jsave(str(tmp_path / 'jax'), mll['params'], mll['loaded'][1])
        got = leaves(tload(str(tmp_path / 'jax'), device='cpu')[0])
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)


def test_save_hf_slice_writes_mllama(mll, tmp_path):
    path = save_hf_slice(str(tmp_path), 3, mll['tparams'], mll['tcfg'])
    params, cfg, module = tsft.load_vision_lm(path, device='cpu')
    assert module is tm and cfg.cross_attention_layers == (1,)
    got, want = leaves(params), leaves(mll['params'])
    for path_ in want:
        np.testing.assert_array_equal(got[path_], want[path_])


def test_entry_points_default_to_the_card(mll, monkeypatch):
    """The loader, ``load_vision_lm``, ``init_params`` and ``init_cache``
    run on the first CUDA device unless asked for the CPU: without one
    they raise."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (lambda: tload(str(mll['dir'])),
                 lambda: tsft.load_vision_lm(str(mll['dir'])),
                 lambda: tm.init_params(mll['tcfg'], torch.Generator()),
                 lambda: tm.init_cache(mll['tcfg'], 1, 8)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()


def test_load_vision_lm_takes_mllama(mll):
    params, cfg, module = tsft.load_vision_lm(str(mll['dir']), device='cpu')
    assert module is tm and isinstance(cfg, tm.MllamaConfig)
    assert set(params) == {'vision_model', 'language_model', 'projector'}
    assert all(t.device.type == 'cpu' for t in param_leaves(params))
    with pytest.raises(NotImplementedError, match='LLaVA family'):
        tsft.load_llava_lm(str(mll['dir']), device='cpu')


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _left_padded(prompts):
    p = max(len(x) for x in prompts)
    ids = np.zeros((len(prompts), p), np.int64)
    mask = np.zeros_like(ids)
    for i, x in enumerate(prompts):
        ids[i, p - len(x):] = x
        mask[i, p - len(x):] = 1
    return ids, mask


@pytest.mark.parametrize('media', ['image', 'text'])
def test_generate_with_init_cache_fn_matches_jax(mll, media):
    """Greedy ``generate`` with ``init_cache_fn=init_cache`` (the self
    cache, then the cross K/V from the prefill): JAX's ids, and each id
    the argmax of a no-cache forward over the grown sequence."""
    jcfg, tcfg = mll['jcfg'], mll['tcfg']
    if media == 'image':
        ids, mask = _left_padded([[IMG, 5, 6, 7, 8], [IMG, 9, 10]])
        arrays = _tiles(tcfg, seed=12)
        names = ('pixel_values', 'aspect_ratio_ids', 'aspect_ratio_mask')
        (tin, jin) = _both(arrays)
        tmedia, jmedia = dict(zip(names, tin)), dict(zip(names, jin))
    else:
        ids, mask = _left_padded([[5, 6, 7, 8], [11, 12]])
        tmedia, jmedia = {}, {}
    t = 6
    got = generate(mll['tparams'], tcfg,
                   GenerationConfig(max_new_tokens=t, greedy=True,
                                    eos_token_id=-1),
                   torch.from_numpy(ids), torch.from_numpy(mask),
                   media=tmedia, prefill_forward=tm.forward,
                   step_forward=tm.decode_forward,
                   init_cache_fn=tm.init_cache)
    want = jeng.generate(
        mll['params'], jcfg,
        jeng.GenerationConfig(max_new_tokens=t, greedy=True,
                              eos_token_id=-1),
        jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
        jax.random.PRNGKey(0), media=jmedia, prefill_forward=jm.forward,
        step_forward=jm.decode_forward, init_cache_fn=jm.init_cache)
    np.testing.assert_array_equal(got['sequences'].numpy(),
                                  np.asarray(want['sequences']))
    seqs, p = got['sequences'], ids.shape[1]
    full = torch.cat([torch.from_numpy(mask), torch.ones_like(seqs[:, p:])],
                     dim=1)
    for step in range(t):
        logits = tm.forward(mll['tparams'], tcfg, seqs[:, :p + step],
                            attention_mask=full[:, :p + step],
                            **tmedia).logits
        assert torch.equal(logits[:, -1].argmax(-1), seqs[:, p + step])
