"""The port's int8 quantization, its dequantization helpers and its
quantized forwards (``align_anything_tpu_torch/models/quantization.py``,
``models/transformer.py`` ``_wmm``, ``ops/logprobs.py``) against the JAX
package, on the same numpy weights and inputs (``models/bridge.py``).

Everything runs in float32 on the CPU.  Tolerances: int8 values equal, scales
to 1e-7 relative (the same fp32 formula); quantized bytes equal; dense
dequantizations to 1e-6; forwards and log-probs with quantized weights to
1e-4 x max|logit| (the same math summed in another order, as
``tests/test_torch_model.py`` holds fp weights); the int8-COMPUTE forward to
1e-3 x max|logit| (a last-bit difference in an activation can move its int8
code by one, 1/127 of that row's scale); the int8 product exactly; the
dequantize-on-read matmul and its gradient to 1e-5 of the dense einsum's
(the same products summed along another path).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.models import quantization as tq  # noqa: E402
from align_anything_tpu_torch.models import transformer as tt  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.models.config import tiny_config  # noqa: E402
from align_anything_tpu_torch.ops import logprobs as tl  # noqa: E402

LOGIT_TOL = 1e-4
COMPUTE_TOL = 1e-3


@pytest.fixture(scope='module')
def jx():
    jax = pytest.importorskip('jax')
    from align_anything_tpu.models import config as jc
    from align_anything_tpu.models import lora as jlora
    from align_anything_tpu.models import quantization as jq
    from align_anything_tpu.models import transformer as jt
    from align_anything_tpu.ops import logprobs as jl

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, c=jc, q=jq, t=jt,
                                 l=jl, lora=jlora)


def np_tree(tree):
    """JAX tree -> nested dicts of numpy arrays in ``models/bridge.py``'s
    flattened form (quantized and LoRA leaves tagged)."""
    name = type(tree).__name__
    if name == 'LoraWeight':
        return {'base': np_tree(tree.base), 'a': np.asarray(tree.a),
                'b': np.asarray(tree.b), 'scaling': tree.scaling}
    if name in ('Int4Weight', 'Int8Weight'):
        return {'values': np.asarray(tree.values),
                'scales': np.asarray(tree.scales), 'compute': tree.compute,
                'kind': 'int8' if name == 'Int8Weight' else 'int4'}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def cfgs(jx, **kw):
    """The same tiny fp32 decoder config in both packages."""
    args = dict(vocab_size=128, hidden=64, layers=2, heads=4, kv_heads=2,
                mlp=128)
    kw = dict(dict(compute_dtype='float32', tie_word_embeddings=False), **kw)
    return (jx.c.tiny_config(**args).replace(**kw),
            tiny_config(**args).replace(**kw))


def jax_params(jx, jcfg, seed=0):
    return jx.t.init_params(jcfg, jx.jax.random.PRNGKey(seed))


def _ids(vocab, shape=(2, 12), seed=0):
    return np.random.default_rng(seed).integers(3, vocab, size=shape)


def _logits_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize('shape,axes', [((6, 8), (0,)),
                                        ((2, 6, 4, 3), (1,)),
                                        ((2, 4, 3, 6), (1, 2))])
def test_quantize_int8_matches_jax(jx, shape, axes):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w[..., 0] = 0.0                      # an all-zero channel: the 1e-8 floor
    jw = jx.q.quantize_int8(jx.jnp.asarray(w), axes)
    tw = tq.quantize_int8(torch.from_numpy(w), axes)
    np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
    np.testing.assert_allclose(tw.scales.numpy(), np.asarray(jw.scales),
                               rtol=1e-7, atol=0)
    np.testing.assert_allclose(tw.dequantize(torch.float32).numpy(),
                               np.asarray(jw.astype(jx.jnp.float32)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('compute', [False, True])
def test_quantize_decoder_int8_matches_jax(jx, compute):
    """Every matmul weight and the head become Int8Weight leaves equal to
    JAX's, the rest stays fp, and the bytes agree with JAX's
    ``quantized_bytes``: under 1/2.5 of the fp tree's."""
    jcfg, _ = cfgs(jx)
    jp = jax_params(jx, jcfg)
    jq = jx.q.quantize_decoder_int8(jp, compute=compute)
    tp = tq.quantize_decoder_int8(from_jax_tree(np_tree(jp), device='cpu'),
                                  compute=compute)
    want = from_jax_tree(np_tree(jq), device='cpu')
    for name in ('q', 'k', 'v', 'o', 'up', 'gate', 'down'):
        got = tp['layers'][name]['w']
        assert isinstance(got, tq.Int8Weight) and got.compute is compute
        np.testing.assert_array_equal(got.values.numpy(),
                                      want['layers'][name]['w'].values.numpy())
    assert isinstance(tp['lm_head'], tq.Int8Weight)
    assert isinstance(tp['embedding'], torch.Tensor)
    assert tq.quantized_bytes(tp) == jx.q.quantized_bytes(jq)
    assert tq.quantized_bytes(tp) < jx.q.quantized_bytes(jp) / 2.5


@pytest.mark.parametrize('kind', ['int8', 'int4'])
def test_dequantize_decoder_matches_jax(jx, kind):
    """The export's dense view, stacked int4 leaves included (JAX
    dequantizes them per layer under ``vmap``)."""
    jcfg, _ = cfgs(jx)
    jp = jax_params(jx, jcfg)
    quant = {'int8': jx.q.quantize_decoder_int8,
             'int4': jx.q.quantize_decoder_int4}[kind]
    jq = quant(jp)
    want = jx.q.dequantize_decoder(jq)
    got = tq.dequantize_decoder(from_jax_tree(np_tree(jq), device='cpu'))
    for name in ('q', 'o', 'down'):
        np.testing.assert_allclose(got['layers'][name]['w'].numpy(),
                                   np.asarray(want['layers'][name]['w']),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got['lm_head'].numpy(),
                               np.asarray(want['lm_head']), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('compute', [False, True])
def test_int8_forward_matches_jax(jx, compute):
    """The decoder over an int8 tree (weight-only: dequantize on read;
    compute: the int8 product) against JAX's forward on the same tree."""
    jcfg, tcfg = cfgs(jx)
    jq = jx.q.quantize_decoder_int8(jax_params(jx, jcfg), compute=compute)
    tp = from_jax_tree(np_tree(jq), device='cpu')
    ids = _ids(128)
    want = jx.t.forward(jq, jcfg, jx.jnp.asarray(ids)).logits
    got = tt.forward(tp, tcfg, torch.from_numpy(ids)).logits
    _logits_close(got.numpy(), want, COMPUTE_TOL if compute else LOGIT_TOL)


def test_int8_compute_unit_matches_jax(jx):
    """``_wmm``'s int8-COMPUTE branch against JAX's on one einsum of each
    kind (one and two contracted axes)."""
    rng = np.random.default_rng(0)
    for eq, xs, ws, axes, n in (('ble,ehd->blhd', (2, 3, 8), (8, 4, 2), (0,), 1),
                                ('blhd,hde->ble', (2, 3, 4, 2), (4, 2, 8),
                                 (0, 1), 2)):
        x = rng.standard_normal(xs).astype(np.float32)
        w = rng.standard_normal(ws).astype(np.float32)
        jw = jx.q.quantize_int8(jx.jnp.asarray(w), axes, compute=True)
        want = np.asarray(jx.t._wmm(eq, jx.jnp.asarray(x), jw,
                                    jx.jnp.float32, n_contract=n))
        tw = from_jax_tree(np_tree(jw), device='cpu')
        got = tt._wmm(eq, torch.from_numpy(x), tw, torch.float32,
                      n_contract=n).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('m,k,n', [(3, 5, 7), (17, 16, 8), (40, 24, 13)])
def test_int8_product_is_exact(m, k, n):
    """The padded ``torch._int_mm`` route equals the int64 product at
    shapes the CUDA route would refuse (M <= 16, K or N not multiples of
    8)."""
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    got = tt.int8_product(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize('kind', ['int8', 'int4'])
def test_quantized_matmul_gradient(kind):
    """The dequantize-on-read matmul's gradient for x equals the einsum's
    over the dense weight; the weight gets none."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((2, 64, 4, 8)).astype(np.float32))
    leaf = (tq.quantize_int8(w, (1,)) if kind == 'int8'
            else tq.quantize_int4(w, (1,), group_size=32)).layer(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32))
    x1, x2 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y1 = tt._wmm('ble,ehd->blhd', x1, leaf, torch.float32)
    dense = leaf.dequantize(torch.float32)
    y2 = torch.einsum('ble,ehd->blhd', x2, dense)
    g = torch.from_numpy(rng.standard_normal(y2.shape).astype(np.float32))
    (y1 * g).sum().backward()
    (y2 * g).sum().backward()
    # the same products, which einsum may sum along another path
    np.testing.assert_allclose(y1.detach().numpy(), y2.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('kind', ['int8', 'int4'])
def test_token_logprobs_with_quantized_head(jx, kind):
    """``token_logprobs`` dequantizes a quantized ``lm_head`` as JAX's
    ``.astype`` does (QLoRA quantizes the head)."""
    jcfg, tcfg = cfgs(jx)
    quant = {'int8': jx.q.quantize_decoder_int8,
             'int4': jx.q.quantize_decoder_int4}[kind]
    jq = quant(jax_params(jx, jcfg))
    tp = from_jax_tree(np_tree(jq), device='cpu')
    ids = _ids(128)
    want = np.asarray(jx.l.token_logprobs(jq, jcfg, jx.jnp.asarray(ids)))
    got = tl.token_logprobs(tp, tcfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * float(np.abs(want).max()))
