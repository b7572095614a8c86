"""The port's CLIP-style ViT tower (``align_anything_tpu_torch/models/
vision.py``) against the JAX package's ``models/vision.py``: the same
numpy weights (bridged) and pixels through both, fp32 on the CPU.  The
port's attention runs the flash kernel's plain version in full
(non-causal) mode, JAX's ``xla_attention(causal=False)``.

Tolerance: features to 1e-5 relative to their max (fp32 math in another
order through layer norms and softmax), patchify exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from align_anything_tpu.models import vision as jvision  # noqa: E402
from align_anything_tpu_torch.models import vision as tvision  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.ops import flash_attention as fa  # noqa: E402

TOL = 1e-5
BASE = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=3,
            num_heads=4, mlp_dim=64)


def _pair(seed=0, **kw):
    jcfg = jvision.ViTConfig(**{**BASE, **kw})
    params = jax.tree.map(np.asarray,
                          jvision.init_params(jcfg, jax.random.PRNGKey(seed)))
    # non-trivial norms and biases, so that every leaf matters
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        params)
    tcfg = tvision.ViTConfig(**dataclasses.asdict(jcfg))
    return jcfg, params, tcfg, from_jax_tree(params, device='cpu')


def _pixels(b=2, side=28, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, 3, side, side)).astype(np.float32)


def _close(got, want):
    got = got.detach().numpy() if hasattr(got, 'detach') else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize('activation', ['quick_gelu', 'gelu'])
@pytest.mark.parametrize('select', ['default', 'full'])
@pytest.mark.parametrize('pre_norm,post_norm', [(True, False), (False, True),
                                                (True, True), (False, False)])
def test_vit_forward_matches_jax(activation, select, pre_norm, post_norm):
    jcfg, params, tcfg, tparams = _pair(
        activation=activation, feature_select=select, use_pre_norm=pre_norm,
        apply_post_norm=post_norm)
    px = _pixels()
    want = jvision.forward(params, jcfg, jnp.asarray(px))
    got = tvision.forward(tparams, tcfg, torch.from_numpy(px))
    n = tcfg.num_patches + (select == 'full')
    assert tuple(got.shape) == (2, n, tcfg.hidden_size)
    _close(got, want)


@pytest.mark.parametrize('feature_layer,runs', [(-2, 2), (-1, 3), (1, 1),
                                                (3, 3)])
def test_vit_feature_layer(feature_layer, runs):
    """The loop runs the layers up to the tapped one (LLaVA's -2 runs all
    but the last); the features equal JAX's at each tap."""
    jcfg, params, tcfg, tparams = _pair(feature_layer=feature_layer)
    assert tcfg.layers_run == runs
    px = _pixels(b=1)
    _close(tvision.forward(tparams, tcfg, torch.from_numpy(px)),
           jvision.forward(params, jcfg, jnp.asarray(px)))


def test_vit_bf16_matches_jax():
    """bf16 compute: within bf16's own rounding of JAX's bf16 forward (2e-2
    of the max: ~8 bf16 ulps through 2 layers)."""
    jcfg, params, tcfg, tparams = _pair()
    px = _pixels()
    want = np.asarray(jvision.forward(params, jcfg, jnp.asarray(px),
                                      compute_dtype=jnp.bfloat16),
                      np.float32)
    got = tvision.forward(tparams, tcfg, torch.from_numpy(px),
                          compute_dtype='bfloat16')
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))


def test_patchify_matches_jax():
    px = _pixels(b=3, side=28)
    want = np.asarray(jvision.patchify(jnp.asarray(px), 7))
    got = tvision.patchify(torch.from_numpy(px), 7).numpy()
    np.testing.assert_array_equal(got, want)


def test_vit_init_tree_matches_jax():
    """Same tree, shapes and dtypes as the JAX init (the numbers differ)."""
    for use_cls in (True, False):
        kw = {**BASE, 'use_class_token': use_cls}
        want = jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype)),
            jvision.init_params(jvision.ViTConfig(**kw),
                                jax.random.PRNGKey(0)))
        got = tvision.init_params(tvision.ViTConfig(**kw),
                                  torch.Generator().manual_seed(0),
                                  device='cpu')
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).removeprefix('torch.')),
                           got)
        assert got == want


def test_vit_attention_is_full_flash(monkeypatch):
    """Every layer's attention goes to the flash kernel's path in full
    (non-causal) mode with no key mask: on the CPU its plain version."""
    calls = []
    ref = fa.flash_attention_fwd_reference

    def spy(q, k, v, mask, causal, window):
        calls.append((tuple(q.shape), mask is None, causal))
        return ref(q, k, v, mask, causal, window)

    monkeypatch.setattr(fa, 'flash_attention_fwd_reference', spy)
    _, _, tcfg, tparams = _pair()
    tvision.forward(tparams, tcfg, torch.from_numpy(_pixels()))
    assert calls == [((2, 17, 4, 8), True, False)] * tcfg.layers_run


def test_vit_gradient_matches_jax():
    """The gradient of a scalar of the features with respect to every tower
    leaf (the tower trains when ``freeze_vision_tower`` is off): through
    the plain version of the kernel's backward in full mode."""
    jcfg, params, tcfg, _ = _pair()
    px = _pixels()
    w = np.random.default_rng(3).normal(
        size=(2, tcfg.num_patches, tcfg.hidden_size)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jvision.forward(p, jcfg, jnp.asarray(px)) * w)

    want = jax.grad(jloss)(jax.tree.map(jnp.asarray, params))
    from align_anything_tpu_torch.models.bridge import trainable_from_jax_tree
    tparams, _ = trainable_from_jax_tree(params, device='cpu')
    loss = (tvision.forward(tparams, tcfg, torch.from_numpy(px))
            * torch.from_numpy(w)).sum()
    loss.backward()
    # leaves the features never read (the last layer, post_norm) get no
    # gradient in torch and zeros in JAX
    got = jax.tree.map(lambda t: np.zeros(tuple(t.shape), np.float32)
                       if t.grad is None else t.grad.numpy(), tparams)
    # each leaf to 1e-5 of its own max; the key bias's exact gradient is 0
    # (the softmax over keys ignores a shift shared by all keys), so both
    # read rounding noise there, held to 1e-6 of the largest gradient
    top = max(float(np.abs(np.asarray(x)).max()) for x in jax.tree.leaves(want))
    for g, wg in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        wg = np.asarray(wg)
        np.testing.assert_allclose(
            g, wg, rtol=0,
            atol=max(1e-5 * float(np.abs(wg).max()), 1e-6 * top))
    assert np.abs(np.asarray(want['layers']['k']['b'])).max() < 1e-6 * top
