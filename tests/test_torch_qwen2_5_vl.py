"""The port's Qwen2.5-VL path (``models/qwen2_5_vl.py``) against the JAX
package's, on the CPU: the window / full pair masks, the RMSNorm / SwiGLU
tower with its window blocks and full blocks (the fixed grid and dynamic
grids), forward and log-probs over the m-rope trunk, the Qwen2.5-VL loader
and writer (``models/hf_loader.py``), ``save_hf_slice`` and
``load_vision_lm``.

The checkpoint is a tiny ``Qwen2_5_VLForConditionalGeneration`` saved by
transformers: a 4-block tower 32 wide with windows of 56 px (2 x 2 merged
tokens) and full attention at block 2, the fixed grid 112 px (8 x 8
patches: four windows); the JAX tree from JAX's loader, perturbed, goes to
the port through ``models/bridge.py``.  Tolerances as
``tests/test_torch_qwen2_vl.py``: masks and loaded leaves exactly, the
rest within 1e-4 of its max (fp32) on valid rows and under the mask.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')
pytest.importorskip('PIL.Image')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.models import qwen2_5_vl as jq5  # noqa: E402
from align_anything_tpu.models.hf_loader import (  # noqa: E402
    load_qwen2_5_vl_params as jload,
    save_qwen2_5_vl_params as jsave,
)
from align_anything_tpu_torch.checkpoint import save_hf_slice  # noqa: E402
from align_anything_tpu_torch.models import qwen2_5_vl as tq5  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.hf_loader import (  # noqa: E402
    load_qwen2_5_vl_params as tload,
    save_qwen2_5_vl_params as tsave,
)
from align_anything_tpu_torch.trainers.text_image_to_text import (  # noqa: E402
    sft as tsft,
)
from test_torch_qwen2_vl import (  # noqa: E402
    IMG,
    VEND,
    VSTART,
    _close,
    _dynamic_inputs,
    _rows,
    perturbed,
)
from test_torch_ti2t_trainers import _leaves  # noqa: E402


def hf_qwen2_5_vl_config(layers=2, depth=4):
    return transformers.Qwen2_5_VLConfig(
        vision_config=dict(depth=depth, hidden_size=32, num_heads=4,
                           intermediate_size=48, patch_size=14,
                           spatial_merge_size=2, temporal_patch_size=2,
                           window_size=56, fullatt_block_indexes=[2],
                           out_hidden_size=48, in_channels=3),
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


@pytest.fixture(scope='module')
def q25(tmp_path_factory):
    torch.manual_seed(0)
    hf = transformers.Qwen2_5_VLForConditionalGeneration(
        hf_qwen2_5_vl_config()).eval()
    d = tmp_path_factory.mktemp('q25')
    hf.save_pretrained(d, safe_serialization=True)
    jparams, jcfg0 = jload(str(d), image_size=112)
    params = perturbed(jparams, seed=1)
    tparams, tcfg0 = tload(str(d), image_size=112, device='cpu')
    return {'dir': d, 'params': params,
            'jcfg': jcfg0.replace(compute_dtype='float32',
                                  attention_impl='xla'),
            'tcfg': tcfg0.replace(compute_dtype='float32'),
            'tparams': from_jax_tree(params, device='cpu'),
            'loaded': (jparams, jcfg0, tparams, tcfg0)}


def test_window_masks_match_jax(q25):
    """Dynamic grids (8 x 8, 4 x 8, 8 x 2) padded to 64 patches: the
    window mask holds exactly JAX's same-window valid pairs, and the full
    mask every valid pair."""
    vt, vj = q25['tcfg'].vision, q25['jcfg'].vision
    grids = np.array([[8, 8], [4, 8], [8, 2]], np.int32)
    full, win = tq5.window_masks(vt, torch.from_numpy(grids), 64)
    mh, mw = jq5._merged_coords(vj, jnp.asarray(grids), 64)
    valid = np.arange(64)[None] < (grids[:, 0] * grids[:, 1])[:, None]
    wid = np.asarray((mh // vj.window_merge_side) * 65536
                     + (mw // vj.window_merge_side))
    want_full = valid[:, :, None] & valid[:, None, :]
    want_win = want_full & (wid[:, :, None] == wid[:, None, :])
    np.testing.assert_array_equal(full.numpy(), want_full)
    np.testing.assert_array_equal(win.numpy(), want_win)
    assert vt.window_merge_side == 2
    # four windows of 16 patches on the 8 x 8 grid, two on 4 x 8
    assert win[0].sum().item() == 4 * 16 * 16
    assert win[1].sum().item() == 2 * 16 * 16


@pytest.mark.parametrize('grid', ['fixed', 'dynamic'])
def test_vision_tower_matches_jax(q25, grid):
    """Window blocks 0, 1, 3 and the full block 2: the fixed grid (four
    windows); dynamic grids 8 x 4 and 4 x 8 padded to 48 patches, on each
    row's valid merged tokens."""
    vt, vj = q25['tcfg'].vision, q25['jcfg'].vision
    p = q25['params']['visual']
    rng = np.random.default_rng(0)
    if grid == 'fixed':
        px = np.stack([jq5.qwen2vl_patchify(
            rng.normal(size=(3, 112, 112)).astype(np.float32), vj)
            for _ in range(2)])
        want = jq5.vision_forward(p, vj, jnp.asarray(px))
        got = tq5.vision_forward(q25['tparams']['visual'], vt,
                                 torch.from_numpy(px))
        _close(got, want)
        return
    px, thw = _dynamic_inputs(vj, [(8, 4), (4, 8)], 48, seed=2)
    want = np.asarray(jq5.vision_forward(p, vj, jnp.asarray(px),
                                         grid_hw=jnp.asarray(thw[:, 1:])))
    got = tq5.vision_forward(q25['tparams']['visual'], vt,
                             torch.from_numpy(px),
                             grid_hw=torch.from_numpy(thw[:, 1:]))
    for row in range(2):
        _close(got[row, :8], want[row, :8])


@pytest.mark.parametrize('grid', ['fixed', 'dynamic'])
def test_forward_and_logprobs_match_jax(q25, grid):
    """Logits and ``token_logprobs`` (chunk 4) under the mask: the fixed
    grid (16 image tokens a row) and dynamic grids (8 and 4 tokens)."""
    jcfg, tcfg = q25['jcfg'], q25['tcfg']
    rng = np.random.default_rng(3)
    if grid == 'fixed':
        ids, mask = _rows([24, 21], [16, 16], seed=4)
        px = np.stack([jq5.qwen2vl_patchify(
            rng.normal(size=(3, 112, 112)).astype(np.float32), jcfg.vision)
            for _ in range(2)])
        extra_j, extra_t = {}, {}
    else:
        ids, mask = _rows([16, 12], [8, 4], seed=5)
        px, thw = _dynamic_inputs(jcfg.vision, [(8, 4), (4, 4)], 48, seed=6)
        extra_j = {'image_grid_thw': jnp.asarray(thw)}
        extra_t = {'image_grid_thw': torch.from_numpy(thw)}
    # compiled: the eager op-by-op trace took most of the test's time
    want = jax.jit(jq5.forward, static_argnums=1)(
        q25['params'], jcfg, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), pixel_values=jnp.asarray(px),
        **extra_j).logits
    got = tq5.forward(q25['tparams'], tcfg, torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask),
                      pixel_values=torch.from_numpy(px), **extra_t).logits
    real = mask.astype(bool)
    _close(got[torch.from_numpy(real)], np.asarray(want)[real])
    want_lp = jax.jit(jq5.token_logprobs, static_argnums=1,
                      static_argnames='chunk_size')(
        q25['params'], jcfg, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), pixel_values=jnp.asarray(px),
        chunk_size=4, **extra_j)
    got_lp = tq5.token_logprobs(q25['tparams'], tcfg, torch.from_numpy(ids),
                                attention_mask=torch.from_numpy(mask),
                                pixel_values=torch.from_numpy(px),
                                chunk_size=4, **extra_t)
    keep = real[:, 1:]
    _close(got_lp[torch.from_numpy(keep)], np.asarray(want_lp)[keep])


def test_loader_matches_jax(q25):
    jparams, jcfg, tparams, tcfg = q25['loaded']
    assert dataclasses.asdict(tcfg.text) == dataclasses.asdict(jcfg.text)
    assert dataclasses.asdict(tcfg.vision) == dataclasses.asdict(jcfg.vision)
    assert (tcfg.image_token_id, tcfg.video_token_id) == (
        jcfg.image_token_id, jcfg.video_token_id)
    want = _leaves(jax.tree.map(np.asarray, jparams))
    got = _leaves(tparams)
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)


def test_export_reads_back(q25, tmp_path):
    """The port's export read back by both loaders equals the tree in
    memory; JAX's export (contiguous tensors: R8 does not reach it) reads
    back to the same tree; transformers reloads the port's to the logits
    of the checkpoint it came from."""
    tsave(str(tmp_path / 'port'), q25['tparams'], q25['tcfg'])
    back, cfg = tload(str(tmp_path / 'port'), image_size=112, device='cpu')
    assert cfg == q25['loaded'][3]
    want = _leaves(q25['tparams'])
    for path, leaf in _leaves(back).items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
    jback, _ = jload(str(tmp_path / 'port'), image_size=112)
    for path, leaf in _leaves(jax.tree.map(np.asarray, jback)).items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
    jsave(str(tmp_path / 'jax'), q25['params'], q25['jcfg'])
    for path, leaf in _leaves(tload(str(tmp_path / 'jax'), image_size=112,
                                    device='cpu')[0]).items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
    hf = transformers.Qwen2_5_VLForConditionalGeneration.from_pretrained(
        str(tmp_path / 'port')).eval()
    ids = np.array([[5, 9, 30, 40, 7]])
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids)).logits
    got = tq5.forward(back, cfg.replace(compute_dtype='float32'),
                      torch.tensor(ids)).logits
    _close(got, ref.numpy(), rel=1e-5)


def test_save_hf_slice_and_load_vision_lm(q25, tmp_path):
    params, cfg, module = tsft.load_vision_lm(str(q25['dir']), device='cpu')
    assert module is tq5 and isinstance(cfg, tq5.Qwen25VLConfig)
    path = save_hf_slice(str(tmp_path), 2, q25['tparams'], q25['tcfg'])
    with open(f'{path}/config.json') as f:
        hf_cfg = json.load(f)
    assert hf_cfg['model_type'] == 'qwen2_5_vl'
    assert hf_cfg['text_config']['model_type'] == 'qwen2_5_vl_text'
    back, _, module = tsft.load_vision_lm(path, device='cpu')
    assert module is tq5
    want = _leaves(q25['tparams'])
    for p, leaf in _leaves(back).items():
        np.testing.assert_array_equal(leaf, want[p])
