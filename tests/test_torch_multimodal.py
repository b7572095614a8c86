"""The port's LLaVA-class model (``align_anything_tpu_torch/models/
multimodal.py``), its loader and exporter (``models/hf_loader.py``) and the
decoder's ``inputs_embeds`` against the JAX package's, fp32 on the CPU.

The same numpy weights (bridged) and inputs go through both; the port's
attention runs the flash kernel's plain version (the tower's in full mode),
JAX's ``attention_impl='xla'`` as ``tests/test_multimodal.py`` runs it.

Tolerances: logits and log-probs to 1e-5 relative to their max; the merge
and the loaded trees exactly; the DPO gradients per leaf to 1e-5 of the
leaf's max (1e-6 of the largest where the exact gradient is 0).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')
transformers = pytest.importorskip('transformers')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.models import multimodal as jmm  # noqa: E402
from align_anything_tpu.models import transformer as jtr  # noqa: E402
from align_anything_tpu.models.config import ModelConfig as JModelConfig  # noqa: E402
from align_anything_tpu.models.hf_loader import (  # noqa: E402
    load_multimodal_params as jload,
)
from align_anything_tpu.models.vision import ViTConfig as JViTConfig  # noqa: E402
from align_anything_tpu_torch.models import multimodal as tmm  # noqa: E402
from align_anything_tpu_torch.models import transformer as ttr  # noqa: E402
from align_anything_tpu_torch.models.bridge import (  # noqa: E402
    from_jax_tree,
    trainable_from_jax_tree,
)
from align_anything_tpu_torch.models.config import ModelConfig  # noqa: E402
from align_anything_tpu_torch.models.hf_loader import (  # noqa: E402
    load_multimodal_params as tload,
    save_multimodal_params,
)
from align_anything_tpu_torch.models.vision import ViTConfig  # noqa: E402

TOL = 1e-5
IMG = 60
TEXT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=8, mlp_dim=64,
            max_position_embeddings=128, compute_dtype='float32')
VIT = dict(image_size=28, patch_size=14, hidden_size=24, num_layers=3,
           num_heads=4, mlp_dim=48)


def _configs(**text_kw):
    jc = jmm.MultimodalConfig(
        text=JModelConfig(**{**TEXT, **text_kw}, attention_impl='xla'),
        vision=JViTConfig(**VIT), image_token_id=IMG)
    tc = tmm.MultimodalConfig(text=ModelConfig(**{**TEXT, **text_kw}),
                              vision=ViTConfig(**VIT), image_token_id=IMG)
    return jc, tc


def _params(jc, seed=0):
    params = jax.tree.map(np.asarray,
                          jmm.init_params(jc, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    # perturb the norms and biases too, so every leaf matters
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        params)


def _batch(b=2, n_img=1, seed=1):
    """Rows of [bos, image tokens..., text], right-padded: row 1 is two
    tokens shorter; each row has ``n_img`` images of 4 patches."""
    rng = np.random.default_rng(seed)
    l = 1 + 4 * n_img + 6
    ids = rng.integers(3, IMG, size=(b, l)).astype(np.int32)
    ids[:, 0] = 1
    ids[:, 1:1 + 4 * n_img] = IMG
    mask = np.ones((b, l), np.int32)
    mask[1, -2:] = 0
    ids[1, -2:] = 0
    px = rng.normal(size=(b * n_img, 3, 28, 28)).astype(np.float32)
    return ids, mask, px


def _close(got, want, tol=TOL):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def test_config_passthroughs_and_replace():
    jc, tc = _configs()
    for name in ('hidden_size', 'vocab_size', 'eos_token_id', 'pad_token_id',
                 'bos_token_id', 'true_vocab_size', 'compute_dtype',
                 'tie_word_embeddings', 'final_logit_softcap'):
        assert getattr(tc, name) == getattr(jc, name), name
    r = tc.replace(compute_dtype='bfloat16', remat='full',
                   image_token_id=7)
    assert (r.text.compute_dtype, r.text.remat, r.image_token_id) == (
        'bfloat16', 'full', 7)
    assert dataclasses.asdict(r.vision) == dataclasses.asdict(tc.vision)


def test_init_tree_matches_jax():
    jc, tc = _configs()
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jmm.init_params(jc, jax.random.PRNGKey(0)))
    got = jax.tree.map(lambda t: tuple(t.shape),
                       tmm.init_params(tc, torch.Generator().manual_seed(0),
                                       device='cpu'))
    assert got == want


def test_bridge_carries_the_tree():
    """``from_jax_tree`` / ``trainable_from_jax_tree`` keep the nested
    multimodal tree: the same keys and every leaf equal."""
    jc, _ = _configs()
    params = _params(jc)
    for tree in (from_jax_tree(params, device='cpu'),
                 trainable_from_jax_tree(params, device='cpu')[0]):
        assert jax.tree.structure(jax.tree.map(lambda t: 0, tree)) == \
            jax.tree.structure(jax.tree.map(lambda a: 0, params))
        for t, a in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
            np.testing.assert_array_equal(t.detach().numpy(), a)


@pytest.mark.parametrize('case', ['one', 'none', 'two', 'extra'])
def test_merge_image_embeds_matches_jax(case):
    """One image a row; rows with no image token; two images a row (8
    patches); more image tokens than patches (the slot index clips)."""
    rng = np.random.default_rng(2)
    b, l, e = 3, 12, 5
    n = 8 if case == 'two' else 4
    ids = rng.integers(0, IMG, size=(b, l)).astype(np.int32)
    if case == 'one':
        ids[:, 2:6] = IMG
    elif case == 'two':
        ids[:, 1:5] = IMG
        ids[:, 7:11] = IMG
    elif case == 'extra':
        ids[:, 1:7] = IMG
    ids[1] = np.where(ids[1] == IMG, 3, ids[1])          # a text-only row
    text = rng.normal(size=(b, l, e)).astype(np.float32)
    image = rng.normal(size=(b, n, e)).astype(np.float32)
    want = np.asarray(jmm.merge_image_embeds(
        jnp.asarray(text), jnp.asarray(image), jnp.asarray(ids), IMG))
    got = tmm.merge_image_embeds(torch.from_numpy(text),
                                 torch.from_numpy(image),
                                 torch.from_numpy(ids), IMG).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], text[1])


@pytest.mark.parametrize('with_pixels', [False, True])
def test_forward_and_logprobs_match_jax(with_pixels):
    """Logits of ``forward`` and ``token_logprobs`` (the chunked vocab
    projection, chunk 4 so several chunks run), text-only and with
    pixels."""
    jc, tc = _configs()
    params = _params(jc)
    tparams = from_jax_tree(params, device='cpu')
    ids, mask, px = _batch()
    kw_j = dict(attention_mask=jnp.asarray(mask))
    kw_t = dict(attention_mask=torch.from_numpy(mask))
    if with_pixels:
        kw_j['pixel_values'] = jnp.asarray(px)
        kw_t['pixel_values'] = torch.from_numpy(px)
    want = jmm.forward(params, jc, jnp.asarray(ids), **kw_j).logits
    got = tmm.forward(tparams, tc, torch.from_numpy(ids), **kw_t).logits
    real = mask.astype(bool)
    _close(got[torch.from_numpy(real)], np.asarray(want)[real])
    want_lp = jmm.token_logprobs(params, jc, jnp.asarray(ids), chunk_size=4,
                                 **kw_j)
    got_lp = tmm.token_logprobs(tparams, tc, torch.from_numpy(ids),
                                chunk_size=4, **kw_t)
    keep = real[:, 1:]
    _close(got_lp[torch.from_numpy(keep)], np.asarray(want_lp)[keep])


def test_pixels_change_the_output():
    jc, tc = _configs()
    tparams = from_jax_tree(_params(jc), device='cpu')
    ids, mask, px = _batch()
    a = tmm.forward(tparams, tc, torch.from_numpy(ids),
                    pixel_values=torch.from_numpy(px)).logits
    b = tmm.forward(tparams, tc, torch.from_numpy(ids),
                    pixel_values=torch.from_numpy(px[::-1].copy())).logits
    assert not torch.allclose(a, b)


def test_inputs_embeds_matches_jax():
    """``transformer.forward(inputs_embeds=...)``: embeddings from the
    caller replace the lookup, positions still come from the mask; equal
    to the lookup when given the looked-up rows."""
    jc, tc = _configs()
    lm = _params(jc)['language_model']
    tlm = from_jax_tree(lm, device='cpu')
    ids, mask, _ = _batch()
    emb = np.random.default_rng(4).normal(
        size=ids.shape + (TEXT['hidden_size'],)).astype(np.float32)
    want = jtr.forward(lm, jc.text, jnp.asarray(ids),
                       attention_mask=jnp.asarray(mask),
                       inputs_embeds=jnp.asarray(emb)).logits
    got = ttr.forward(tlm, tc.text, torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask),
                      inputs_embeds=torch.from_numpy(emb)).logits
    real = mask.astype(bool)
    _close(got[torch.from_numpy(real)], np.asarray(want)[real])
    looked_up = tlm['embedding'][torch.from_numpy(ids)]
    np.testing.assert_array_equal(
        ttr.forward(tlm, tc.text, torch.from_numpy(ids),
                    inputs_embeds=looked_up).logits.numpy(),
        ttr.forward(tlm, tc.text, torch.from_numpy(ids)).logits.numpy())


def test_decode_forward_is_the_language_model():
    jc, tc = _configs()
    tparams = from_jax_tree(_params(jc), device='cpu')
    ids, _, _ = _batch()
    np.testing.assert_array_equal(
        tmm.decode_forward(tparams, tc, torch.from_numpy(ids)).logits.numpy(),
        ttr.forward(tparams['language_model'], tc.text,
                    torch.from_numpy(ids)).logits.numpy())


def _dpo_loss_j(params, ref_lp, jc, ids, mask, px, resp):
    from align_anything_tpu.losses import dpo_loss

    lp = jmm.token_logprobs(params, jc, ids, attention_mask=mask,
                            pixel_values=px, chunk_size=4)
    return dpo_loss(lp, ref_lp, ids, resp, scale_coeff=0.1)['loss']


def test_dpo_gradient_matches_jax():
    """The DPO loss of a 2-pair batch with pixels, policy perturbed away
    from the reference: its gradient with respect to the projector and the
    language model (the trainable leaves with the tower frozen) against
    ``jax.grad``; the frozen tower gets no gradient in the port."""
    from align_anything_tpu_torch.losses import dpo_loss

    jc, tc = _configs()
    ref = _params(jc, seed=0)
    pol = _params(jc, seed=5)
    ids, mask, px = _batch(b=4, seed=6)
    resp = np.zeros((4, ids.shape[1] - 1), np.float32)
    resp[:, 6:] = mask[:, 7:]
    jref_lp = jmm.token_logprobs(ref, jc, jnp.asarray(ids),
                                 attention_mask=jnp.asarray(mask),
                                 pixel_values=jnp.asarray(px), chunk_size=4)

    def jloss(trainable):
        p = {**trainable, 'vision_tower': pol['vision_tower']}
        return _dpo_loss_j(p, jref_lp, jc, jnp.asarray(ids),
                           jnp.asarray(mask), jnp.asarray(px),
                           jnp.asarray(resp))

    trainable = {k: v for k, v in pol.items() if k != 'vision_tower'}
    want = jax.grad(jloss)(jax.tree.map(jnp.asarray, trainable))

    tpol, _ = trainable_from_jax_tree(pol, device='cpu')
    for t in jax.tree.leaves(tpol['vision_tower']):
        t.requires_grad_(False)
    tref = from_jax_tree(ref, device='cpu')
    kw = dict(attention_mask=torch.from_numpy(mask),
              pixel_values=torch.from_numpy(px), chunk_size=4)
    with torch.no_grad():
        ref_lp = tmm.token_logprobs(tref, tc, torch.from_numpy(ids), **kw)
    lp = tmm.token_logprobs(tpol, tc, torch.from_numpy(ids), **kw)
    loss = dpo_loss(lp, ref_lp, torch.from_numpy(ids),
                    torch.from_numpy(resp), scale_coeff=0.1)['loss']
    assert loss.item() == pytest.approx(
        float(jloss(jax.tree.map(jnp.asarray, trainable))), rel=1e-6)
    loss.backward()
    assert all(t.grad is None for t in jax.tree.leaves(tpol['vision_tower']))
    got = {k: jax.tree.map(
        lambda t: np.zeros(tuple(t.shape), np.float32) if t.grad is None
        else t.grad.numpy(), tpol[k]) for k in trainable}
    top = max(float(np.abs(np.asarray(x)).max())
              for x in jax.tree.leaves(want))
    assert top > 0
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=max(1e-5 * float(np.abs(w).max()), 1e-6 * top))


def test_unported_branches_raise():
    """LLaVA-Next AnyRes and video raise and name the ROADMAP item."""
    _, tc = _configs()
    tparams = from_jax_tree(_params(_configs()[0]), device='cpu')
    ids, _, px = _batch()
    with pytest.raises(NotImplementedError, match='item 12'):
        tmm.forward(tparams, tc, torch.from_numpy(ids),
                    pixel_values=torch.from_numpy(px),
                    select_idx=torch.zeros((2, 4), dtype=torch.long))
    with pytest.raises(NotImplementedError, match='item 12'):
        tmm.forward(tparams, tc, torch.from_numpy(ids),
                    pixel_values=torch.from_numpy(px)[:, None])
    with pytest.raises(NotImplementedError, match='item 12'):
        tmm.init_params(tc.replace(image_grid_pinpoints=((28, 28),)),
                        torch.Generator().manual_seed(0), device='cpu')


# ---------------------------------------------------------------------------
# HF interop
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def llava(tmp_path_factory):
    """A tiny ``LlavaForConditionalGeneration`` saved by transformers (as
    ``tests/test_multimodal.py`` builds one)."""
    torch.manual_seed(0)
    tc = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, bos_token_id=1, eos_token_id=2,
        pad_token_id=0)
    vc = transformers.CLIPVisionConfig(
        hidden_size=24, intermediate_size=48, num_hidden_layers=3,
        num_attention_heads=4, image_size=28, patch_size=14,
        hidden_act='quick_gelu')
    cfg = transformers.LlavaConfig(vision_config=vc, text_config=tc,
                                   image_token_index=32,
                                   vision_feature_layer=-2,
                                   vision_feature_select_strategy='default')
    model = transformers.LlavaForConditionalGeneration(cfg).eval()
    d = tmp_path_factory.mktemp('llava')
    model.save_pretrained(d, safe_serialization=True)
    return model, d


def _assert_trees_equal(got, want):
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, want))
    for t, a in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_load_matches_jax_loader(llava):
    """The port's loader gives the JAX loader's tree and config."""
    _, d = llava
    tparams, tcfg = tload(str(d), device='cpu')
    jparams, jcfg = jload(str(d))
    _assert_trees_equal(tparams, jparams)
    assert dataclasses.asdict(tcfg.text) == dataclasses.asdict(jcfg.text)
    assert dataclasses.asdict(tcfg.vision) == dataclasses.asdict(jcfg.vision)
    assert (tcfg.image_token_id, tcfg.projector_layers) == (
        jcfg.image_token_id, jcfg.projector_layers) == (32, 2)


def test_forward_matches_transformers(llava):
    """Text-only and with an image, against the HF model's logits (the
    tolerances of ``tests/test_multimodal.py``)."""
    model, d = llava
    params, cfg = tload(str(d), device='cpu')
    cfg = cfg.replace(compute_dtype='float32')
    ids = np.array([[1] + [32] * 4 + [5, 6, 7]])
    px = np.random.default_rng(0).normal(size=(1, 3, 28, 28)).astype(
        np.float32)
    with torch.no_grad():
        for kw in ({}, {'pixel_values': torch.from_numpy(px)}):
            ref = model(input_ids=torch.from_numpy(ids), **kw).logits
            got = tmm.forward(params, cfg, torch.from_numpy(ids), **kw).logits
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-4,
                                       rtol=1e-3)


def test_export_reads_back(llava, tmp_path):
    """The port's export reads back equal through the JAX loader and the
    port's, and transformers loads it to the same logits."""
    model, d = llava
    params, cfg = tload(str(d), device='cpu')
    save_multimodal_params(str(tmp_path), params, cfg)
    _assert_trees_equal(params, jload(str(tmp_path))[0])
    back, cfg2 = tload(str(tmp_path), device='cpu')
    _assert_trees_equal(back, jax.tree.map(lambda t: t.numpy(), params))
    assert cfg2 == cfg
    hf = json.loads((tmp_path / 'config.json').read_text())
    assert hf['model_type'] == 'llava'
    again = transformers.LlavaForConditionalGeneration.from_pretrained(
        str(tmp_path)).eval()
    ids = torch.tensor([[1] + [32] * 4 + [5, 6, 7]])
    px = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 3, 28, 28)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(
            again(input_ids=ids, pixel_values=px).logits.numpy(),
            model(input_ids=ids, pixel_values=px).logits.numpy())


def test_export_bf16(llava, tmp_path):
    """``dtype=torch.bfloat16`` writes bf16 tensors that load back as the
    params rounded to bf16."""
    _, d = llava
    params, cfg = tload(str(d), device='cpu')
    save_multimodal_params(str(tmp_path), params, cfg, dtype=torch.bfloat16)
    back, _ = tload(str(tmp_path), device='cpu')
    _assert_trees_equal(back, jax.tree.map(
        lambda t: t.to(torch.bfloat16).float().numpy(), params))
    hf = json.loads((tmp_path / 'config.json').read_text())
    assert hf['torch_dtype'] == 'bfloat16'


@pytest.mark.parametrize('model_type', ['llava_next', 'llava_next_video'])
def test_load_refuses_llava_next(tmp_path, model_type):
    (tmp_path / 'config.json').write_text(json.dumps(
        {'model_type': model_type, 'text_config': {}, 'vision_config': {}}))
    with pytest.raises(NotImplementedError, match='item 12'):
        tload(str(tmp_path), device='cpu')


def test_loader_defaults_to_the_card(llava, monkeypatch):
    _, d = llava
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tload(str(d))
