"""The port's attention (``ops/attention.py``, ``ops/flash_attention.py``)
against the JAX package's, on inputs made from a seed with numpy.

On the CPU the port's kernel path runs the kernel's plain version
(``flash_attention_fwd_reference`` / ``_bwd_reference``).  It is held
against JAX ``xla_attention`` (K1a's library kernel has no interpret path
here, so ``xla_attention`` stands for it) and against JAX
``splash_attention`` in Pallas interpret mode (K1b), as
``tests/test_splash_attention.py`` runs it.  Tolerances: 1e-5 against the
fp32 XLA math (the same formulas summed in another order); 2e-2 against
splash, whose kernel keeps probabilities in bf16, on unpadded query rows
only (splash's segment ids let a pad query attend to pad keys, the port
masks keys only).

The ``cuda``-marked cases hold the CUDA kernels against their plain
versions on the card, row by row (``row_scaled_error``: bf16 2e-2 x the
row's max|plain|, 2.5x the one ulp, at most 2^-7 of the row's max, by
which two results that each round fp32 to bf16 once can differ; fp32
1e-4 x); they skip without a GPU.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.ops import attention as ta  # noqa: E402
from align_anything_tpu_torch.ops import flash_attention as tf  # noqa: E402

L, H, KH, D = 128, 4, 2, 64
WINDOW = 48


@pytest.fixture(scope='module')
def jx():
    jax = pytest.importorskip('jax')
    from align_anything_tpu.ops import attention as ja

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, a=ja)


def _inputs(b=2, l=L, h=H, kh=KH, d=D, pad=True, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, h, d)).astype(np.float32)
    k = rng.standard_normal((b, l, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, l, kh, d)).astype(np.float32)
    mask = np.ones((b, l), np.int32)
    if pad:
        mask[0, l - 16:] = 0            # right padding, as training batches
    return q, k, v, mask


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _close(got, ref, tol, rows=None):
    got = got.detach().float().numpy() if hasattr(got, 'detach') else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    if rows is not None:
        diff = diff[rows]
    assert diff.max() <= tol, diff.max()


row_scaled_error = tf.row_scaled_error


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('cross', [False, True])
def test_xla_attention_matches_jax(jx, causal, cross):
    q, k, v, mask = _inputs()
    if cross:                   # fewer queries than keys (S - L offset)
        q = q[:, -40:]
    ref = jx.a.xla_attention(q, k, v, attention_mask=mask, causal=causal)
    got = ta.xla_attention(*_t(q, k, v, mask), causal=causal)
    _close(got, ref, 1e-5)
    # causal_attention sends cross-attention (L != S) to xla_attention
    got = ta.causal_attention(*_t(q, k, v, mask), causal=causal)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('impl', ['auto', 'flash', 'splash', 'xla'])
def test_causal_attention_matches_jax_xla(jx, causal, impl):
    """Every impl of the port against the JAX XLA math: on right-padded
    inputs every query sees a key, so all rows compare."""
    q, k, v, mask = _inputs()
    ref = jx.a.xla_attention(q, k, v, attention_mask=mask, causal=causal)
    got = ta.causal_attention(*_t(q, k, v, mask), causal=causal, impl=impl)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize('window', [None, WINDOW])
@pytest.mark.parametrize('pad', [False, True])
def test_splash_matches_jax_splash_interpret(jx, window, pad):
    q, k, v, mask = _inputs(pad=pad)
    jmask = mask if pad else None
    ref = jx.a.splash_attention(q, k, v, attention_mask=jmask, window=window)
    tq, tk, tv, tm = _t(q, k, v, mask)
    got = ta.splash_attention(tq, tk, tv, tm if pad else None, window=window)
    _close(got, ref, 2e-2, rows=mask.astype(bool))
    if window is None:
        got = ta.causal_attention(tq, tk, tv, tm if pad else None,
                                  impl='splash')
        _close(got, ref, 2e-2, rows=mask.astype(bool))


def _loss_grads(fn, q, k, v, w):
    """Gradients of sum(out * w) with respect to q, k, v."""
    out = fn(q, k, v)
    return torch.autograd.grad((out.float() * w).sum(), (q, k, v))


@pytest.mark.parametrize('causal', [True, False])
def test_reference_backward_matches_jax_grad(jx, causal):
    """The autograd Function's backward (the plain version of the backward
    kernels: P recomputed from the saved lse) against jax.grad of JAX
    xla_attention, padding included."""
    q, k, v, mask = _inputs()
    w = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jx.a.xla_attention(q_, k_, v_, attention_mask=mask,
                                 causal=causal)
        return (out * w).sum()

    ref = jx.jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    tm, tw = _t(mask, w)
    got = _loss_grads(lambda a, b, c: tf.flash_attention(a, b, c, tm,
                                                         causal=causal),
                      tq, tk, tv, tw)
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)


def test_reference_backward_matches_jax_splash_window(jx):
    q, k, v, _ = _inputs(pad=False)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        return (jx.a.splash_attention(q_, k_, v_, window=WINDOW) * w).sum()

    ref = jx.jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    (tw,) = _t(w)
    got = _loss_grads(lambda a, b, c: ta.splash_attention(a, b, c,
                                                          window=WINDOW),
                      tq, tk, tv, tw)
    for g, r in zip(got, ref):
        # fp32 on both sides; 1e-3 of each row's scale leaves 10x room for
        # dq's row 0, which is zero by cancellation (one visible key)
        assert row_scaled_error(g, torch.from_numpy(np.asarray(r))) <= 1e-3


def test_reference_forward_residuals():
    """lse is log(sum exp(scores)) over the visible keys; a query that sees
    no key gets zeros, lse 0 and zero gradients."""
    q, k, v, mask = _inputs(l=64, pad=False)
    mask[1, :8] = 0                     # left padding: queries 0-7 see nothing
    tq, tk, tv = _t(q, k, v, grad=True)
    (tm,) = _t(mask)
    out, lse = (t.detach() for t in tf.flash_attention_fwd_reference(
        tq, tk, tv, tm, causal=True))
    s = np.einsum('blhd,bshd->bhls', q, np.repeat(k, H // KH, axis=2)) \
        * D ** -0.5
    vis = np.tril(np.ones((64, 64), bool))[None, None] \
        & mask.astype(bool)[:, None, None, :]
    s = np.where(vis, s, -np.inf)
    with np.errstate(invalid='ignore'):
        m = s.max(-1, keepdims=True)
        want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    seen = np.broadcast_to(vis.any(-1), want.shape)
    np.testing.assert_allclose(lse.numpy()[seen], want[seen], atol=1e-5)
    assert np.all(lse.numpy()[~seen] == 0)
    assert np.all(out.numpy()[1, :8] == 0)
    dq, dk, dv = _loss_grads(
        lambda a, b, c: tf.flash_attention(a, b, c, tm, causal=True),
        tq, tk, tv, torch.ones(q.shape))
    assert np.all(dq.numpy()[1, :8] == 0)
    # keys 0-7 of row 1 are padding: no query attends to them
    assert np.all(dk.numpy()[1, :8] == 0) and np.all(dv.numpy()[1, :8] == 0)


def _bf16(x):
    """float32 -> the nearest bf16 value (round to nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _numpy_flash(q, k, v, mask, causal, out, lse, dout):
    """The plain versions' bf16 arithmetic in numpy (float64 sums): P is
    rounded to bf16 before P V and before dV, dS before dK and dQ, each
    result once at the end.  The backward runs from the given out and lse.
    -> (out, lse, dq, dk, dv)."""
    b, l, h, d = q.shape
    g = h // k.shape[2]
    kr = np.repeat(k, g, axis=2).astype(np.float64)
    vr = np.repeat(v, g, axis=2).astype(np.float64)
    s = np.einsum('blhd,bshd->bhls', q.astype(np.float64), kr) * d ** -0.5
    vis = np.ones((l, l), bool)
    if causal:
        vis = np.tril(vis)
    vis = vis[None, None] & mask.astype(bool)[:, None, None, :]
    s = np.where(vis, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    denom = p.sum(-1, keepdims=True)
    o = np.einsum('bhls,bshd->blhd', _bf16(p), vr) / denom.transpose(0, 2, 1, 3)
    lse_np = (m + np.log(denom))[..., 0]
    p = np.where(vis, np.exp(s - lse.astype(np.float64)[..., None]), 0.0)
    do = dout.astype(np.float64)
    delta = (do * out.astype(np.float64)).sum(-1).transpose(0, 2, 1)[..., None]
    dv = np.einsum('bhls,blhd->bshd', _bf16(p), do)
    dp = np.einsum('blhd,bshd->bhls', do, vr)
    ds = _bf16(p * (dp - delta))
    dq = np.einsum('bhls,bshd->blhd', ds, kr) * d ** -0.5
    dk = np.einsum('bhls,blhd->bshd', ds, q.astype(np.float64)) * d ** -0.5
    fold = (lambda x: x.reshape(b, l, k.shape[2], g, d).sum(3))
    return (_bf16(o), lse_np, _bf16(dq), _bf16(fold(dk)), _bf16(fold(dv)))


@pytest.mark.parametrize('causal', [True, False])
def test_bf16_reference_rounds_where_the_kernel_rounds(jx, causal):
    """The bf16 plain forward and backward against the numpy formulation
    that rounds at the same places: at least 99 % of the elements
    bit-equal (the formulation without the rounding sites matches about
    60 %), the rest within 1e-2 of each row's max (two results that each
    round once differ by at most one bf16 ulp, 2^-8 of the row's max);
    lse 1e-4.  Against JAX xla_attention in bf16 (its probabilities
    normalized, then rounded; its gradients through bf16 autodiff): within
    1e-1 of each row's max (dq of early causal rows, which cancel, reads
    up to 6e-2)."""
    q, k, v, mask = (_bf16(a) if a.dtype == np.float32 else a
                     for a in _inputs())
    dout = _bf16(np.random.default_rng(7).standard_normal(q.shape))
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, dout))
    tm = torch.from_numpy(mask)
    out, lse = tf.flash_attention_fwd_reference(tq, tk, tv, tm, causal)
    grads = tf.flash_attention_bwd_reference(tq, tk, tv, tm, out, lse, tdo,
                                             causal)
    want = _numpy_flash(q, k, v, mask, causal, out.float().numpy(),
                        lse.numpy(), dout)
    for got, ref in zip((out, *grads), want[:1] + want[2:]):
        assert got.dtype == torch.bfloat16
        assert (got.float().numpy() == ref).mean() >= 0.99
        assert row_scaled_error(got, torch.from_numpy(ref)) <= 1e-2
    np.testing.assert_allclose(lse.numpy(), want[1], atol=1e-4)

    jnp = jx.jnp
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))

    def jloss(q_, k_, v_):
        o_ = jx.a.xla_attention(q_, k_, v_, attention_mask=mask,
                                causal=causal)
        return (o_.astype(jnp.float32) * dout).sum(), o_

    (_, jout), jgrads = jx.jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                              has_aux=True)(jq, jk, jv)
    for got, ref in zip((out, *grads), (jout, *jgrads)):
        ref = torch.from_numpy(np.asarray(ref, np.float32))
        assert row_scaled_error(got, ref) <= 1e-1


def test_dispatch_names_and_unported_impls():
    assert ta.resolved_impl_name('auto', 1024, 1024) == 'flash'
    assert ta.resolved_impl_name('splash', 1000, 1000) == 'flash'
    assert ta.resolved_impl_name('flash', 16, 40) == 'xla'
    assert ta.resolved_impl_name('xla', 1024, 1024) == 'xla'
    q, k, v, mask = _t(*_inputs(l=32))
    with pytest.raises(NotImplementedError):
        ta.causal_attention(q, k, v, mask, impl='ring')
    with pytest.raises(ValueError):
        ta.causal_attention(q, k, v, mask, impl='pallas')


def test_cuda_wrappers_reject_cpu_tensors():
    q, k, v, mask = _t(*_inputs(l=32))
    before = (tf.flash_attention_fwd_cuda.launches,
              tf.flash_attention_bwd_cuda.launches)
    with pytest.raises(ValueError, match='CUDA'):
        tf.flash_attention_fwd_cuda(q, k, v, mask)
    out, lse = tf.flash_attention_fwd_reference(q, k, v, mask)
    with pytest.raises(ValueError, match='CUDA'):
        tf.flash_attention_bwd_cuda(q, k, v, mask, out, lse, out)
    assert (tf.flash_attention_fwd_cuda.launches,
            tf.flash_attention_bwd_cuda.launches) == before


def test_row_scaled_error_sees_a_fault_in_late_rows():
    """A 10 % error in the causal output's second half of query rows: the
    error per row sees all of it, the error over the whole tensor (scaled
    by the early rows, row 0's being v[0]) sees under half of it."""
    q, k, v, mask = _t(*_inputs(b=1, l=512, pad=False))
    out, _ = tf.flash_attention_fwd_reference(q, k, v, mask, causal=True)
    bad = out.clone()
    bad[:, 256:] *= 1.1
    assert abs(row_scaled_error(bad, out) - 0.1) < 1e-5
    assert float((bad - out).abs().max() / out.abs().max()) < 0.05
    assert row_scaled_error(out.bfloat16(), out) <= 2 ** -8   # 1 bf16 ulp
    # a row of zeros is held to 1 % of the whole tensor's max
    tiny = out.clone()
    tiny[:, 300] = 0.0
    top = float(out.abs().max())
    noisy = tiny.clone()
    noisy[:, 300] = 1e-3 * top
    assert abs(row_scaled_error(noisy, tiny) - 0.1) < 1e-5
    zero = torch.zeros_like(out)
    assert row_scaled_error(zero, zero) == 0.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda_inputs(b, l, h, kh, d, dtype, pad, seed=0):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype)

    q, k, v = rnd(b, l, h, d), rnd(b, l, kh, d), rnd(b, l, kh, d)
    mask = None
    if pad:
        mask = torch.ones((b, l), dtype=torch.int32, device='cuda')
        mask[0, l - l // 5:] = 0
    return q, k, v, mask


CUDA_CASES = [
    # b, l, h, kh, d, causal, window, pad (row 0's last l // 5 keys)
    (2, 256, 4, 2, 64, True, None, True),
    (2, 200, 4, 4, 128, True, None, True),     # ragged L, no GQA
    (1, 192, 8, 2, 256, True, None, False),
    (2, 256, 4, 2, 64, False, None, True),     # full attention (K1a)
    (2, 256, 4, 1, 128, True, 48, False),      # window (K1b)
    # the edges of the 64-row tiles
    (2, 17, 4, 2, 64, True, None, True),       # L shorter than one tile
    (2, 17, 4, 2, 128, False, None, False),
    (2, 129, 4, 2, 128, True, None, True),     # L one past a tile
    (1, 1024, 4, 2, 64, True, 200, False),     # window not a tile multiple
    (2, 256, 8, 1, 64, True, None, True),      # G = 8
    (2, 320, 4, 2, 128, True, None, True),     # row 0's last tile all padding
]


@pytest.mark.cuda
@pytest.mark.parametrize('case', CUDA_CASES)
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_cuda_kernels_match_reference(case, dtype):
    b, l, h, kh, d, causal, window, pad = case
    dt = getattr(torch, dtype)
    q, k, v, mask = _cuda_inputs(b, l, h, kh, d, dt, pad)
    gen = torch.Generator(device='cuda').manual_seed(1)
    dout = torch.randn((b, l, h, d), generator=gen, device='cuda').to(dt)
    before = (tf.flash_attention_fwd_cuda.launches,
              tf.flash_attention_bwd_cuda.launches)
    out, lse = tf.flash_attention_fwd_cuda(q, k, v, mask, causal, window)
    grads = tf.flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout, causal,
                                        window)
    again = tf.flash_attention_bwd_cuda(q, k, v, mask, out, lse, dout, causal,
                                        window)
    rout, rlse = tf.flash_attention_fwd_reference(q, k, v, mask, causal,
                                                  window)
    rgrads = tf.flash_attention_bwd_reference(q, k, v, mask, out, lse, dout,
                                              causal, window)
    torch.cuda.synchronize()
    assert (tf.flash_attention_fwd_cuda.launches,
            tf.flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                      before[1] + 2)
    tol = 2e-2 if dtype == 'bfloat16' else 1e-4
    for got, ref in ((out, rout),) + tuple(zip(grads, rgrads)):
        assert row_scaled_error(got, ref) <= tol
    assert float((lse - rlse).abs().max()) <= 1e-3
    for g, a in zip(grads, again):                   # deterministic
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_cuda_causal_attention_launches_the_kernel():
    q, k, v, mask = _cuda_inputs(2, 128, 4, 2, 64, torch.bfloat16, True)
    q.requires_grad_(True)
    before = (tf.flash_attention_fwd_cuda.launches,
              tf.flash_attention_bwd_cuda.launches)
    out = ta.causal_attention(q, k, v, mask)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (tf.flash_attention_fwd_cuda.launches,
            tf.flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                      before[1] + 1)
    # a head dim the kernel does not take raises, it does not fall back
    q2, k2, v2, _ = _cuda_inputs(1, 64, 2, 2, 96, torch.bfloat16, False)
    with pytest.raises(ValueError, match='head dim'):
        ta.causal_attention(q2, k2, v2)
