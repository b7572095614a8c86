"""The port's Qwen2-VL path against the JAX package's, on the CPU:
``ops/rope.py`` ``apply_mrope``, m-rope in ``models/transformer.py`` (the
no-cache, prefill and remat paths), ``models/qwen2_vl.py`` (patchify, the
fixed and dynamic rotary tables, ``mrope_positions``, the tower, forward,
log-probs, both image processors and ``smart_resize``), the Qwen2-VL loader
and writer (``models/hf_loader.py``), ``save_hf_slice``, the bridge of the
JAX tree, the ``Qwen2-VL`` template, the image collator's dynamic-resolution
batch and ``generate``'s ``prefill_positions`` / ``position_offset``.

The checkpoint is a tiny ``Qwen2VLForConditionalGeneration`` saved by
transformers (a 2-block tower 32 wide, patches of 14 merged 2 x 2, the
fixed grid 56 px: 16 patches, 4 image tokens); the JAX tree from JAX's
loader, perturbed so that every bias and norm matters, goes to the port
through ``models/bridge.py``.

Tolerances: integers and host-side arrays exactly (patches, grids,
positions, rotary tables, processors); ``apply_mrope`` within 1e-6;
towers, logits and log-probs within 1e-4 of their max (fp32), compared on
the valid patch rows and under the attention mask.  Qwen2.5-VL is in
``tests/test_torch_qwen2_5_vl.py``, the trainers in
``tests/test_torch_qwen2_vl_trainers.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
PIL = pytest.importorskip('PIL.Image')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.data import image as jimage  # noqa: E402
from align_anything_tpu.data import multimodal_formatters as jfmt  # noqa: E402
from align_anything_tpu.generation import engine as jeng  # noqa: E402
from align_anything_tpu.models import qwen2_vl as jq  # noqa: E402
from align_anything_tpu.models.hf_loader import (  # noqa: E402
    load_qwen2_vl_params as jload,
    save_qwen2_vl_params as jsave,
)
from align_anything_tpu.ops import rope as jrope  # noqa: E402
from align_anything_tpu_torch.checkpoint import save_hf_slice  # noqa: E402
from align_anything_tpu_torch.data import image as timage  # noqa: E402
from align_anything_tpu_torch.data import (  # noqa: E402
    multimodal_formatters as tfmt,
)
from align_anything_tpu_torch.generation import (  # noqa: E402
    GenerationConfig,
    generate,
)
from align_anything_tpu_torch.models import qwen2_vl as tq  # noqa: E402
from align_anything_tpu_torch.models import transformer as ttr  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.hf_loader import (  # noqa: E402
    load_qwen2_vl_params as tload,
    save_qwen2_vl_params as tsave,
)
from align_anything_tpu_torch.ops import rope as trope  # noqa: E402
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    sft as tsft,
)
from test_torch_ti2t_trainers import _leaves  # noqa: E402

REL = 1e-4
IMG, VSTART, VEND = 120, 121, 122


def hf_qwen2_vl_config(layers=2, depth=2):
    return transformers.Qwen2VLConfig(
        vision_config=dict(depth=depth, embed_dim=32, num_heads=4,
                           hidden_size=48, patch_size=14,
                           spatial_merge_size=2, temporal_patch_size=2,
                           mlp_ratio=2.0, in_channels=3),
        text_config=dict(vocab_size=128, hidden_size=48,
                         intermediate_size=96, num_hidden_layers=layers,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=512,
                         tie_word_embeddings=True, bos_token_id=1,
                         eos_token_id=2, pad_token_id=0,
                         rope_scaling={'type': 'mrope',
                                       'mrope_section': [2, 2, 2]}),
        image_token_id=IMG, vision_start_token_id=VSTART,
        vision_end_token_id=VEND)


def perturbed(params, seed=0):
    """The JAX tree as numpy, every leaf moved by 0.05 x N(0, 1): zero
    biases and unit norms would hide a leaf the port reads wrong."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(
            np.float32), params)


@pytest.fixture(scope='module')
def qvl(tmp_path_factory):
    torch.manual_seed(0)
    hf = transformers.Qwen2VLForConditionalGeneration(
        hf_qwen2_vl_config()).eval()
    d = tmp_path_factory.mktemp('qvl')
    hf.save_pretrained(d, safe_serialization=True)
    jparams, jcfg0 = jload(str(d), image_size=56)
    params = perturbed(jparams)
    tparams, tcfg0 = tload(str(d), image_size=56, device='cpu')
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


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(h, w, 3)).astype(np.uint8)


# ---------------------------------------------------------------------------
# m-rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('streams', ['mixed', 'equal'])
def test_apply_mrope_matches_jax(streams):
    """(3, B, L) streams over a 3-section head: JAX's within 1e-6; with
    three equal streams the result is ``apply_rope``'s, to the bit."""
    rng = np.random.default_rng(0)
    b, l, h, d = 2, 9, 3, 16
    x = rng.normal(size=(b, l, h, d)).astype(np.float32)
    base = rng.integers(0, 40, size=(b, l))
    pos = (np.stack([base] * 3) if streams == 'equal'
           else rng.integers(0, 40, size=(3, b, l)))
    sections = (2, 3, 3)
    jsin, jcos = jrope.rope_table(64, d)
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), jsin, jcos,
                             sections)
    sin, cos = trope.rope_table(64, d, device='cpu')
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sin,
                            cos, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if streams == 'equal':
        plain = trope.apply_rope(torch.from_numpy(x),
                                 torch.from_numpy(base), sin, cos)
        assert torch.equal(got, plain)
    with pytest.raises(ValueError, match='sum'):
        trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sin,
                          cos, (2, 2, 2))


@pytest.mark.parametrize('remat', ttr.REMAT_POLICIES)
def test_mrope_positions_pass_through_remat(qvl, remat):
    """Each remat policy, with gradients on, gives the no-remat loss and
    gradients for (3, B, L) positions: ``torch.utils.checkpoint`` hands
    the 3-D positions to the layer unchanged."""
    cfg = qvl['tcfg'].text.replace(compute_dtype='float32')
    lm = qvl['tparams']['language_model']
    ids = torch.tensor([[5, 6, IMG, IMG, IMG, IMG, 7, 8, 9, 3]])
    pos = tq.mrope_positions(ids, IMG, 2, 2)

    def loss_and_grads(c):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in lm['layers']['q'].items()}
        params = {**lm, 'layers': {**lm['layers'], 'q': leaves}}
        out = ttr.forward(params, c, ids, positions=pos)
        loss = out.logits.square().mean()
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    want, want_g = loss_and_grads(cfg.replace(remat='none'))
    got, got_g = loss_and_grads(cfg.replace(remat=remat))
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    for g, w in zip(got_g, want_g):
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-7)


def test_check_supported_takes_mrope(qvl):
    ttr.check_supported(qvl['tcfg'].text)
    assert qvl['tcfg'].text.mrope_section == (2, 2, 2)


# ---------------------------------------------------------------------------
# patches, rotary tables, positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('hw', [(56, 56), (56, 112), (84, 28)])
def test_patchify_matches_jax(qvl, hw):
    img = np.random.default_rng(hw[1]).normal(size=(3, *hw)).astype(
        np.float32)
    got = tq.qwen2vl_patchify(img, qvl['tcfg'].vision)
    want = jq.qwen2vl_patchify(img, qvl['jcfg'].vision)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (hw[0] * hw[1] // 196, qvl['tcfg'].vision.patch_dim)


def test_rotary_tables_match_jax(qvl):
    """The fixed grid's table and the dynamic tables of three grids (one
    wide, one tall, one square) at a padded N, exactly; on the fixed grid
    the dynamic table inverts the merge-block order to the same (h, w)."""
    vt, vj = qvl['tcfg'].vision, qvl['jcfg'].vision
    np.testing.assert_array_equal(tq._vision_pos_freqs(vt, 'cpu').numpy(),
                                  jq._vision_pos_freqs(vj))
    grids = np.array([[4, 8], [6, 2], [4, 4]], np.int32)
    got = tq._vision_pos_freqs_dynamic(vt, torch.from_numpy(grids), 40)
    want = jq._vision_pos_freqs_dynamic(vj, jnp.asarray(grids), 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got[2, :16].numpy(),
                               jq._vision_pos_freqs(vj), rtol=1e-6)


MROPE_CASES = {
    # name: (rows of (text before, image span, text after, pads), grids)
    'fixed': ([(3, 4, 5, 0), (1, 4, 2, 5)], (2, 2)),
    'per_row': ([(2, 8, 3, 1), (4, 6, 1, 3), (1, 4, 8, 1)],
                (np.array([2, 3, 2]), np.array([4, 2, 2]))),
    'no_image': ([(6, 0, 4, 2), (2, 4, 1, 5)], (2, 2)),
}


@pytest.mark.parametrize('case', list(MROPE_CASES))
def test_mrope_positions_match_jax(case):
    """Right-padded rows with one image span, per-row grids, a row
    without an image: the three streams exactly; text after the span
    continues from start + max(gh, gw)."""
    rows, (gh, gw) = MROPE_CASES[case]
    length = max(sum(r) for r in rows)
    ids = np.zeros((len(rows), length), np.int32)
    rng = np.random.default_rng(1)
    for i, (pre, n_img, post, _) in enumerate(rows):
        ids[i, :pre] = rng.integers(3, 100, size=pre)
        ids[i, pre:pre + n_img] = IMG
        ids[i, pre + n_img:pre + n_img + post] = rng.integers(3, 100,
                                                              size=post)
    want = np.asarray(jq.mrope_positions(jnp.asarray(ids), IMG, gh, gw))
    got = tq.mrope_positions(
        torch.from_numpy(ids), IMG,
        torch.as_tensor(gh) if isinstance(gh, np.ndarray) else gh,
        torch.as_tensor(gw) if isinstance(gw, np.ndarray) else gw)
    assert got.dtype == torch.int64 and got.shape == (3, *ids.shape)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == 'no_image':
        assert (got[:, 0] == torch.arange(length)).all()


def test_mrope_positions_match_hf():
    """HF's ``get_rope_index`` on a vision_start / image / vision_end row."""
    torch.manual_seed(0)
    hf = transformers.Qwen2VLForConditionalGeneration(
        hf_qwen2_vl_config(layers=1, depth=1)).eval()
    ids = np.concatenate([np.arange(3)[None] + 10, [[VSTART]],
                          np.full((1, 8), IMG), [[VEND]],
                          np.arange(3)[None] + 20], 1).astype(np.int64)
    ref, _ = hf.model.get_rope_index(
        torch.tensor(ids), image_grid_thw=torch.tensor([[1, 4, 8]]),
        attention_mask=torch.ones_like(torch.tensor(ids)))
    got = tq.mrope_positions(torch.tensor(ids), IMG, 2, 4)
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('hw', [(300, 450), (10, 10), (2000, 2000),
                                (28, 5000), (57, 113)])
def test_smart_resize_matches_jax(hw):
    for kw in ({}, dict(min_pixels=4 * 784, max_pixels=64 * 784)):
        assert tq.smart_resize(*hw, **kw) == jq.smart_resize(*hw, **kw)


@pytest.mark.parametrize('hw', [(56, 56), (60, 100), (130, 40)])
def test_processors_match_jax(qvl, hw):
    """``PatchProcessor`` (the fixed grid) and ``DynamicPatchProcessor``
    (its grid, padded rows and token count) equal JAX's on PIL images."""
    img = PIL.fromarray(_image(*hw, seed=hw[0]))
    vt, vj = qvl['tcfg'].vision, qvl['jcfg'].vision
    np.testing.assert_array_equal(tq.PatchProcessor(vt)(img),
                                  jq.PatchProcessor(vj)(img))
    kw = dict(min_pixels=4 * 784, max_pixels=32 * 784)
    got = tq.DynamicPatchProcessor(vt, **kw)(img)
    want = jq.DynamicPatchProcessor(vj, **kw)(img)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['pixel_values'], want['pixel_values'])
    np.testing.assert_array_equal(got['image_grid_thw'],
                                  want['image_grid_thw'])
    assert got['num_tokens'] == want['num_tokens']
    assert got['pixel_values'].shape == (128, vt.patch_dim)


# ---------------------------------------------------------------------------
# the tower and the model
# ---------------------------------------------------------------------------

def _dynamic_inputs(vcfg, grids, n_pad, seed):
    """Patch rows of the given (gh, gw) grids, zero-padded to ``n_pad``."""
    rng = np.random.default_rng(seed)
    px = np.zeros((len(grids), n_pad, vcfg.patch_dim), np.float32)
    for i, (gh, gw) in enumerate(grids):
        img = rng.normal(size=(3, 14 * gh, 14 * gw)).astype(np.float32)
        px[i, :gh * gw] = jq.qwen2vl_patchify(img, vcfg)
    thw = np.array([[1, gh, gw] for gh, gw in grids], np.int32)
    return px, thw


@pytest.mark.parametrize('grid', ['fixed', 'dynamic'])
def test_vision_tower_matches_jax(qvl, grid):
    """The fixed grid; dynamic grids (4 x 8 and 6 x 2, padded to 40
    patches) compared on each row's valid merged tokens."""
    vt, vj = qvl['tcfg'].vision, qvl['jcfg'].vision
    p = qvl['params']['visual']
    if grid == 'fixed':
        rng = np.random.default_rng(0)
        px = np.stack([jq.qwen2vl_patchify(
            rng.normal(size=(3, 56, 56)).astype(np.float32), vj)
            for _ in range(2)])
        want = jq.vision_forward(p, vj, jnp.asarray(px))
        got = tq.vision_forward(qvl['tparams']['visual'], vt,
                                torch.from_numpy(px))
        _close(got, want)
        return
    px, thw = _dynamic_inputs(vj, [(4, 8), (6, 2)], 40, seed=1)
    want = np.asarray(jq.vision_forward(p, vj, jnp.asarray(px),
                                        grid_hw=jnp.asarray(thw[:, 1:])))
    got = tq.vision_forward(qvl['tparams']['visual'], vt,
                            torch.from_numpy(px),
                            grid_hw=torch.from_numpy(thw[:, 1:]))
    for row, n_tok in enumerate((8, 3)):
        _close(got[row, :n_tok], want[row, :n_tok])


def _rows(lengths, n_img, seed, vstart=True):
    """Right-padded rows: [text, vision_start, image tokens, vision_end,
    text], each row ``lengths[i]`` long."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), max(lengths)), np.int32)
    mask = np.zeros_like(ids)
    for i, (n, k) in enumerate(zip(lengths, n_img)):
        row = rng.integers(3, 100, size=n).astype(np.int32)
        row[2] = VSTART
        row[3:3 + k] = IMG
        row[3 + k] = VEND
        ids[i, :n], mask[i, :n] = row, 1
    return ids, mask


@pytest.mark.parametrize('grid', ['fixed', 'dynamic'])
def test_forward_and_logprobs_match_jax(qvl, grid):
    """Logits and ``token_logprobs`` (chunk 4) under the mask: the fixed
    grid (4 image tokens a row), and two dynamic grids in one batch (8 and
    3 image tokens, patch rows padded to 40)."""
    jcfg, tcfg = qvl['jcfg'], qvl['tcfg']
    rng = np.random.default_rng(2)
    if grid == 'fixed':
        ids, mask = _rows([14, 11], [4, 4], seed=3)
        px = np.stack([jq.qwen2vl_patchify(
            rng.normal(size=(3, 56, 56)).astype(np.float32), jcfg.vision)
            for _ in range(2)])
        extra_j, extra_t = {}, {}
    else:
        ids, mask = _rows([16, 12], [8, 3], seed=4)
        px, thw = _dynamic_inputs(jcfg.vision, [(4, 8), (6, 2)], 40, seed=5)
        extra_j = {'image_grid_thw': jnp.asarray(thw)}
        extra_t = {'image_grid_thw': torch.from_numpy(thw)}
    # compiled: the eager op-by-op trace took most of the test's time
    want = jax.jit(jq.forward, static_argnums=1)(
        qvl['params'], jcfg, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), pixel_values=jnp.asarray(px),
        **extra_j).logits
    got = tq.forward(qvl['tparams'], tcfg, torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask),
                     pixel_values=torch.from_numpy(px), **extra_t).logits
    real = mask.astype(bool)
    _close(got[torch.from_numpy(real)], np.asarray(want)[real])
    want_lp = jax.jit(jq.token_logprobs, static_argnums=1,
                      static_argnames='chunk_size')(
        qvl['params'], jcfg, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), pixel_values=jnp.asarray(px),
        chunk_size=4, **extra_j)
    got_lp = tq.token_logprobs(qvl['tparams'], tcfg, torch.from_numpy(ids),
                               attention_mask=torch.from_numpy(mask),
                               pixel_values=torch.from_numpy(px),
                               chunk_size=4, **extra_t)
    keep = torch.from_numpy(real[:, 1:])
    _close(got_lp[keep], np.asarray(want_lp)[real[:, 1:]])


def test_prefill_through_the_cache_matches_no_cache(qvl):
    """m-rope positions through the cache path (prefill at offset 0) give
    the no-cache logits, and a decode step with scalar-stream positions
    gives the logits of the longer no-cache pass."""
    tcfg = qvl['tcfg']
    ids, mask = _rows([12], [4], seed=6)
    px = np.random.default_rng(7).normal(
        size=(1, 16, tcfg.vision.patch_dim)).astype(np.float32)
    t_ids, t_px = torch.from_numpy(ids), torch.from_numpy(px)
    full = tq.forward(qvl['tparams'], tcfg, t_ids, pixel_values=t_px).logits
    cache = ttr.init_cache(tcfg.text, 1, 16, dtype=torch.float32,
                           device='cpu')
    full_mask = torch.zeros((1, 16), dtype=torch.long)
    full_mask[:, :12] = 1
    pos = tq.mrope_positions(t_ids, IMG, 2, 2)
    pre = tq.forward(qvl['tparams'], tcfg, t_ids, attention_mask=full_mask,
                     pixel_values=t_px, positions=pos, cache=cache)
    _close(pre.logits, full.numpy(), rel=1e-5)
    nxt = torch.tensor([[9]])
    full_mask[:, 12] = 1
    step = tq.decode_forward(qvl['tparams'], tcfg, nxt,
                             attention_mask=full_mask,
                             positions=pos.amax(dim=(0, 2))[:, None] + 1,
                             cache=cache, cache_offset=12)
    longer = tq.forward(qvl['tparams'], tcfg, torch.cat([t_ids, nxt], 1),
                        pixel_values=t_px).logits
    _close(step.logits[:, 0], longer[:, -1].numpy(), rel=1e-5)


# ---------------------------------------------------------------------------
# loader, writer, bridge, export
# ---------------------------------------------------------------------------

def test_loader_matches_jax(qvl):
    """The port's loader against JAX's on the same checkpoint: configs
    equal (the m-rope section from ``rope_scaling``), every leaf equal."""
    jparams, jcfg, tparams, tcfg = qvl['loaded']
    assert dataclasses.asdict(tcfg.text) == dataclasses.asdict(jcfg.text)
    assert dataclasses.asdict(tcfg.vision) == dataclasses.asdict(jcfg.vision)
    assert tcfg.image_token_id == jcfg.image_token_id == IMG
    want = _leaves(jax.tree.map(np.asarray, jparams))
    got = _leaves(tparams)
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)


def test_bridge_tree_matches_init(qvl):
    """``from_jax_tree`` of JAX's tree gives the keys and shapes of the
    port's own ``init_params``."""
    init = tq.init_params(qvl['tcfg'], torch.Generator().manual_seed(0),
                          device='cpu')
    bridged = qvl['tparams']
    shapes = {p: v.shape for p, v in _leaves(init).items()}
    assert shapes == {p: v.shape for p, v in _leaves(bridged).items()}
    # JAX's init traced for its shapes (``jax.eval_shape``), not run op by op
    want = jax.eval_shape(lambda k: jq.init_params(qvl['jcfg'], k),
                          jax.random.PRNGKey(0))
    assert shapes == {''.join(f'/{k.key}' for k in path): a.shape
                      for path, a in jax.tree_util.tree_flatten_with_path(
                          want)[0]}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_export_reads_back(qvl, tmp_path, dtype):
    """The port's writer read back by the port's and JAX's loaders equals
    the tree in memory (bf16: its bf16 rounding); transformers reloads
    the fp32 export to the logits of the checkpoint it came from.  JAX's
    writer makes each tensor contiguous before it writes, so ROADMAP R8
    does not reach it: its export reads back to the same tree."""
    tdt = getattr(torch, dtype)
    tsave(str(tmp_path / 'port'), qvl['tparams'], qvl['tcfg'], dtype=tdt)
    back, cfg = tload(str(tmp_path / 'port'), image_size=56, device='cpu')
    assert cfg == qvl['loaded'][3]
    want = _leaves(qvl['tparams'])
    for path, leaf in _leaves(back).items():
        np.testing.assert_array_equal(
            leaf, torch.from_numpy(want[path]).to(tdt).float().numpy(),
            err_msg=path)
    jback, _ = jload(str(tmp_path / 'port'), image_size=56)
    for path, leaf in _leaves(jax.tree.map(np.asarray, jback)).items():
        np.testing.assert_array_equal(leaf, _leaves(back)[path])
    if dtype == 'bfloat16':
        return
    jsave(str(tmp_path / 'jax'), qvl['params'], qvl['jcfg'])
    jax_export, _ = tload(str(tmp_path / 'jax'), image_size=56,
                          device='cpu')
    for path, leaf in _leaves(jax_export).items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
    hf = transformers.Qwen2VLForConditionalGeneration.from_pretrained(
        str(tmp_path / 'port')).eval()
    ids = np.array([[5, 9, 30, 40, 7]])
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids)).logits
    got = tq.forward(back, cfg.replace(compute_dtype='float32'),
                     torch.tensor(ids)).logits
    _close(got, ref.numpy(), rel=1e-5)


def test_save_hf_slice_writes_qwen2_vl(qvl, tmp_path):
    path = save_hf_slice(str(tmp_path), 3, qvl['tparams'], qvl['tcfg'])
    with open(f'{path}/config.json') as f:
        assert json.load(f)['model_type'] == 'qwen2_vl'
    params, module = tsft.load_vision_lm(path, device='cpu')[::2]
    assert module is tq
    want = _leaves(qvl['tparams'])
    for p, leaf in _leaves(params).items():
        np.testing.assert_array_equal(leaf, want[p])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('media', ['image', 'video', 'none'])
def test_qwen2_vl_template_matches_jax(media):
    row = {'question': 'what is here', 'response': 'a cat',
           'response_1': 'one', 'response_2': 'two', 'overall_response': 2}
    if media != 'none':
        row[media] = f'x.{media}'
    got, want = tfmt.Qwen2VL(), jfmt.Qwen2VL()
    assert got.format_supervised_sample(row) == \
        want.format_supervised_sample(row)
    assert got.format_preference_sample(row) == \
        want.format_preference_sample(row)


def test_collator_batches_mixed_grids(qvl, tmp_path):
    """Rows whose images take two grids: the batch holds
    ``image_grid_thw`` (B, 3) int32 and no ``num_tokens``, and each row's
    <image> expands to its own image's token count; the batch equals
    JAX's."""
    from align_anything_tpu.data.chat_template import ChatTemplate as JCT
    from align_anything_tpu.data.tokenizer import HashTokenizer as JHash
    from align_anything_tpu_torch.data import ChatTemplate, HashTokenizer

    rows = []
    for i, hw in enumerate([(56, 56), (56, 112), (112, 56)]):
        p = tmp_path / f'{i}.png'
        PIL.fromarray(_image(*hw, seed=i)).save(p)
        rows.append({'question': f'what {i}', 'response': 'a thing',
                     'image': str(p)})
    data = tmp_path / 'rows.jsonl'
    data.write_text(''.join(json.dumps(r) + '\n' for r in rows))
    kw = dict(min_pixels=4 * 784, max_pixels=32 * 784)
    # a vocab below the image token: no word hashes onto it (ROADMAP R12)
    tok, jtok = HashTokenizer(vocab_size=100), JHash(vocab_size=100)
    ds = timage.TI2TSupervisedDataset(
        str(data), ChatTemplate(tok, 'Qwen2-VL'), tok, image_token_id=IMG,
        num_patches=4,
        image_processor=tq.DynamicPatchProcessor(qvl['tcfg'].vision, **kw))
    jds = jimage.TI2TSupervisedDataset(
        str(data), JCT(jtok, 'Qwen2-VL'), jtok, image_token_id=IMG,
        num_patches=4,
        image_processor=jq.DynamicPatchProcessor(qvl['jcfg'].vision, **kw))
    batch = ds.get_collator(buckets=(64,))([ds[i] for i in range(3)])
    want = jds.get_collator(buckets=(64,))([jds[i] for i in range(3)])
    assert 'num_tokens' not in batch and set(batch) == set(want)
    assert batch['image_grid_thw'].dtype == np.int32
    assert batch['image_grid_thw'].tolist() == [[1, 4, 4], [1, 4, 8],
                                                [1, 8, 4]]
    assert (batch['input_ids'] == IMG).sum(-1).tolist() == [4, 8, 8]
    for k in batch:
        np.testing.assert_array_equal(batch[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('grid', ['fixed', 'dynamic'])
def test_generate_with_mrope_matches_jax(qvl, grid):
    """Greedy ``generate`` of two image prompts with ``prefill_positions``
    and ``position_offset`` computed as JAX's eval pipeline computes them
    (the fixed grid; or two dynamic grids, their ``image_grid_thw`` in
    ``media``): JAX's ids; each generated token is the argmax of a
    no-cache forward over the grown sequence."""
    jcfg, tcfg = qvl['jcfg'], qvl['tcfg']
    if grid == 'fixed':
        ids, mask = _rows([12, 12], [4, 4], seed=8)
        px = np.random.default_rng(9).normal(
            size=(2, 16, tcfg.vision.patch_dim)).astype(np.float32)
        gh = gw = 2
        media_t, media_j = {}, {}
    else:
        ids, mask = _rows([16, 16], [8, 3], seed=10)
        px, thw = _dynamic_inputs(jcfg.vision, [(4, 8), (6, 2)], 40, seed=11)
        gh, gw = thw[:, 1] // 2, thw[:, 2] // 2
        media_t = {'image_grid_thw': torch.from_numpy(thw)}
        media_j = {'image_grid_thw': jnp.asarray(thw)}
    p = ids.shape[1]
    pos3 = tq.mrope_positions(torch.from_numpy(ids), IMG,
                              torch.as_tensor(gh), torch.as_tensor(gw))
    offset = pos3.amax(dim=(0, 2)) + 1 - torch.from_numpy(mask).sum(-1)
    gen = GenerationConfig(max_new_tokens=6, greedy=True, eos_token_id=-1)
    got = generate(qvl['tparams'], tcfg, gen, torch.from_numpy(ids),
                   torch.from_numpy(mask), pixel_values=torch.from_numpy(px),
                   prefill_forward=tq.forward, step_forward=tq.decode_forward,
                   prefill_positions=pos3, position_offset=offset,
                   media=media_t)
    jpos3 = jq.mrope_positions(jnp.asarray(ids), IMG, gh, gw)
    want = jeng.generate(
        qvl['params'], jcfg,
        jeng.GenerationConfig(max_new_tokens=6, greedy=True,
                              eos_token_id=-1),
        jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0),
        pixel_values=jnp.asarray(px), media=media_j,
        prefill_forward=jq.forward, step_forward=jq.decode_forward,
        prefill_positions=jpos3,
        position_offset=jpos3.max(axis=(0, 2)) + 1 - jnp.asarray(mask).sum(
            -1))
    np.testing.assert_array_equal(got['sequences'].numpy(),
                                  np.asarray(want['sequences']))
    np.testing.assert_array_equal(got['prompt_lens'].numpy(),
                                  np.asarray(want['prompt_lens']))
    seqs = got['sequences']
    for t in range(6):
        logits = tq.forward(qvl['tparams'], tcfg, seqs[:, :p + t],
                            pixel_values=torch.from_numpy(px),
                            **media_t).logits
        assert torch.equal(logits[:, -1].argmax(-1), seqs[:, p + t])


def test_load_vision_lm_takes_qwen2_vl(qvl):
    params, cfg, module = tsft.load_vision_lm(str(qvl['dir']), device='cpu')
    assert module is tq and isinstance(cfg, tq.Qwen2VLConfig)
    assert set(params) == {'language_model', 'visual'}
    with pytest.raises(NotImplementedError, match='LLaVA family'):
        tsft.load_llava_lm(str(qvl['dir']), device='cpu')
