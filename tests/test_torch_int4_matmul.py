"""The PyTorch port's int4 quantization and int4 matmul against the JAX
package.

Both sides get the same numpy arrays; the JAX Int4Weight goes through
``align_anything_tpu_torch/models/bridge.py``.  On the CPU the port's
wrapper runs the kernel's plain version, the JAX wrapper its Pallas kernel
in interpret mode; they differ only in summation order, hence the 1e-3
relative tolerance.  The CUDA kernel itself is held against the plain
version by the ``cuda``-marked cases, which run only where there is a card
(each decides that inside the test).  K2 cuts K into ranges of whole groups
(``split_plan``) and sums the ranges' fp32 partials in a fixed order; the
CPU cases check the plan, and the plain version summed over its ranges in
that order against the JAX kernel.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.models import quantization as tq  # noqa: E402
from align_anything_tpu_torch.models.bridge import from_jax_tree  # noqa: E402
from align_anything_tpu_torch.ops import int4_matmul as tk  # noqa: E402

TOL = 1e-3  # x max|ref|: same products, another summation order


@pytest.fixture(scope='module')
def jx():
    """The JAX package's quantization and kernel wrapper."""
    jax = pytest.importorskip('jax')
    from align_anything_tpu.models import quantization as jq
    from align_anything_tpu.ops import int4_matmul as jk

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, q=jq, k=jk)


def np_tree(tree):
    """JAX tree -> nested dicts of numpy arrays, Int4Weight flattened."""
    if hasattr(tree, 'values') and hasattr(tree, 'scales'):
        return {'values': np.asarray(tree.values),
                'scales': np.asarray(tree.scales), 'compute': tree.compute}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _pair(jx, m, k, n, gs, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jw = jx.q.quantize_int4(jx.jnp.asarray(w), (0,), group_size=gs,
                            compute=True)
    return x, jw, from_jax_tree(np_tree(jw), device='cpu')


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= TOL * np.max(np.abs(ref))


@pytest.mark.parametrize('m,k,n,gs', [
    (8, 512, 256, 64),
    (1, 2048, 512, 128),
    (16, 256, 128, 64),
    (32, 768, 384, 64),
])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_int4_matmul_matches_jax(jx, m, k, n, gs, dtype):
    x, jw, tw = _pair(jx, m, k, n, gs)
    ref = jx.k.int4_matmul(jx.jnp.asarray(x), jw, dtype=jx.jnp.dtype(dtype))
    assert ref is not None, 'JAX must take its kernel path at this shape'
    got = tk.int4_matmul(torch.from_numpy(x), tw, dtype=getattr(torch, dtype))
    assert got is not None and got.dtype == getattr(torch, dtype)
    _close(got.float(), np.asarray(ref.astype(jx.jnp.float32)))


def test_multi_dim_batch_and_out_dims(jx):
    # q-projection layout: out dims (heads, head_dim), batch dims (B, L)
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(1024, 8, 64)) * 0.05).astype(np.float32)
    x = rng.normal(size=(4, 3, 1024)).astype(np.float32)
    jw = jx.q.quantize_int4(jx.jnp.asarray(w), (0,), group_size=64,
                            compute=True)
    ref = jx.k.int4_matmul(jx.jnp.asarray(x), jw, dtype=jx.jnp.float32)
    got = tk.int4_matmul(torch.from_numpy(x),
                         from_jax_tree(np_tree(jw), device='cpu'),
                         dtype=torch.float32)
    assert got.shape == (4, 3, 8, 64)
    _close(got, ref)


def test_layer_indexed_matches_jax(jx):
    """The JAX layer-indexed kernel (scalar-prefetched layer of a stacked
    weight) is the port's kernel on the view ``values[li]``."""
    nl = 3
    per = [_pair(jx, 8, 512, 256, 64, seed=i)[1] for i in range(nl)]
    x = _pair(jx, 8, 512, 256, 64)[0]
    stacked = jx.q.Int4Weight(values=jx.jnp.stack([w.values for w in per]),
                              scales=jx.jnp.stack([w.scales for w in per]),
                              compute=True)
    tw = from_jax_tree(np_tree(stacked), device='cpu')
    for li in range(nl):
        ref = jx.k.int4_matmul(jx.jnp.asarray(x), stacked,
                               dtype=jx.jnp.float32,
                               layer_index=jx.jnp.int32(li))
        view = tw.layer(li)
        assert view.values.data_ptr() == (tw.values.data_ptr()
                                          + li * view.values.numel())
        got = tk.int4_matmul(torch.from_numpy(x), view, dtype=torch.float32)
        _close(got, ref)


@pytest.mark.parametrize('shape,axes', [
    ((256, 96), (0,)),             # lm_head-style, unstacked
    ((2, 128, 4, 16), (1,)),       # stacked q/k/v (n, e, h, d)
    ((2, 4, 16, 64), (1, 2)),      # stacked o (n, h, d, e): groups over h
    ((2, 48, 32), (1,)),           # K not a multiple of 64: one group
])
def test_quantize_int4_byte_identical(jx, shape, axes):
    w = (np.random.default_rng(4).normal(size=shape) * 0.1).astype(np.float32)
    jw = jx.q.quantize_int4(jx.jnp.asarray(w), axes, group_size=64)
    tw = tq.quantize_int4(torch.from_numpy(w), axes, group_size=64)
    np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
    np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    assert tw.values.dtype == torch.int8


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dequantize_matches_astype(jx, dtype):
    w = (np.random.default_rng(5).normal(size=(192, 8, 4)) * 0.1
         ).astype(np.float32)
    jw = jx.q.quantize_int4(jx.jnp.asarray(w), (0,), group_size=64)
    got = from_jax_tree(np_tree(jw), device='cpu').dequantize(
        getattr(torch, dtype))
    ref = np.asarray(jw.astype(jx.jnp.dtype(dtype)).astype(jx.jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize('fuse', [False, True])
def test_quantize_decoder_int4_byte_identical(jx, fuse):
    from align_anything_tpu.models import init_params
    from align_anything_tpu.models.config import tiny_config

    cfg = tiny_config(vocab_size=128, hidden=128, layers=2, heads=4,
                      kv_heads=2, mlp=256)
    params = init_params(cfg, jx.jax.random.PRNGKey(0))
    ref = np_tree(jx.q.quantize_decoder_int4(params, compute=True, fuse=fuse))
    got = tq.quantize_decoder_int4(
        from_jax_tree(np_tree(params), device='cpu'), compute=True, fuse=fuse)
    assert set(got['layers']) == set(ref['layers'])
    pairs = [(got['lm_head'], ref['lm_head'])] + [
        (got['layers'][k]['w'], ref['layers'][k]['w'])
        for k in ref['layers'] if isinstance(ref['layers'][k].get('w'), dict)]
    assert len(pairs) == (5 if fuse else 8)
    for tw, rw in pairs:
        assert tw.compute is rw['compute'] is True
        np.testing.assert_array_equal(tw.values.numpy(), rw['values'])
        np.testing.assert_array_equal(tw.scales.numpy(), rw['scales'])


def test_declines_where_the_dense_path_runs(jx):
    x, _, tw = _pair(jx, 4, 512, 256, 64)
    # grouping not over x's last dim (the per-head 'o' layout)
    assert tk.int4_matmul(torch.from_numpy(x[:, :256]), tw) is None
    # prefill-sized x goes to the dense matmul
    big = torch.zeros((tk.KERNEL_MAX_ROWS + 1, 512))
    assert tk.int4_matmul(big, tw) is None
    assert tk.int4_matmul(big[:tk.KERNEL_MAX_ROWS], tw) is not None


def test_cuda_wrapper_rejects_cpu_tensors(jx):
    x, _, tw = _pair(jx, 4, 512, 256, 64)
    with pytest.raises(ValueError, match='CUDA'):
        tk.int4_matmul_cuda(torch.from_numpy(x).bfloat16(), tw.values,
                            tw.scales.reshape(8, 256), torch.float32)
    assert tk.int4_matmul_cuda.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 3, 16, 17, 32, 33, 128])
@pytest.mark.parametrize('k,n', [(512, 256), (1024, 200), (768, 130)])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_kernel_matches_reference(m, k, n, dtype):
    """The hand-written kernel against its plain version on the card,
    ragged N (no 4-column vector loads) included."""
    _need_card()
    gen = torch.Generator(device='cuda').manual_seed(0)
    w = torch.randn((k, n), generator=gen, device='cuda') * 0.05
    qw = tq.quantize_int4(w, (0,), group_size=64, compute=True)
    x = torch.randn((m, k), generator=gen, device='cuda').bfloat16()
    vals, sc = qw.values, qw.scales.reshape(k // 64, n)
    out_dtype = getattr(torch, dtype)
    before = tk.int4_matmul_cuda.launches
    got = tk.int4_matmul_cuda(x, vals, sc, out_dtype).float()
    ref = tk.int4_matmul_reference(x, vals, sc, out_dtype).float()
    torch.cuda.synchronize()
    assert tk.int4_matmul_cuda.launches == before + 1
    tol = 1e-2 if dtype == 'bfloat16' else 1e-4
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


# (m, k, n, gs): the serving shapes at M 32 (Llama-3-8B widths), M 1 and
# 128, and small ones with odd group counts and ragged N
PLAN_SHAPES = [(32, 4096, 6144, 64), (32, 14336, 4096, 64),
               (32, 4096, 4096, 64), (32, 4096, 28672, 64),
               (32, 4096, 128256, 64), (1, 4096, 6144, 64),
               (128, 14336, 4096, 64), (8, 1280, 256, 64),
               (33, 800, 264, 40), (3, 480, 130, 24)]


@pytest.mark.parametrize('m,k,n,gs', PLAN_SHAPES)
@pytest.mark.parametrize('sm_count', [132, 3])
def test_split_plan_covers_k_once_in_whole_groups(m, k, n, gs, sm_count):
    groups = k // gs
    splits = tk.split_plan(m, k, n, gs // 2, sm_count)
    assert 1 <= splits <= groups
    ranges = tk.split_ranges(groups, splits)
    assert len(ranges) == splits
    assert all(lo < hi for lo, hi in ranges)       # no empty split
    # consecutive ranges of whole groups: K offsets lo * gs, hi * gs
    covered = [g for lo, hi in ranges for g in range(lo, hi)]
    assert covered == list(range(groups))


@pytest.mark.parametrize('m', [1, 32, 128])
def test_split_plan_keeps_the_head_whole(m):
    """The LM head (N 128256) fills the card without a split."""
    assert tk.split_plan(m, 4096, 128256, 32, 132) == 1


@pytest.mark.parametrize('k,n,splits', [
    (4096, 6144, 6),       # fused q/k/v: 48 column tiles
    (4096, 4096, 8),       # o
    (14336, 4096, 8),      # down
    (4096, 28672, 1),      # fused gate/up: 224 tiles
    (4096, 128256, 1),     # the head
])
def test_split_plan_at_the_decode_step(k, n, splits):
    """Llama-3-8B's decode step at 32 slots on 132 SMs: about two blocks
    per SM."""
    assert tk.split_plan(32, k, n, 32, 132) == splits


def _split_sum(x, values, scales, dtype, splits):
    """The plain version summed over the plan's group ranges in the
    kernel's order, s = 0 .. S-1, in fp32."""
    gs = 2 * values.shape[1]
    acc = torch.zeros((x.shape[0], values.shape[-1]))
    for lo, hi in tk.split_ranges(values.shape[0], splits):
        acc += tk.int4_matmul_reference(x[:, lo * gs:hi * gs], values[lo:hi],
                                        scales[lo:hi], torch.float32)
    return acc.to(dtype)


@pytest.mark.parametrize('m,k,n,gs,sm_count,splits', [
    (8, 1280, 256, 64, 3, 3),        # 20 groups in 6 + 7 + 7
    (32, 2048, 384, 128, 132, 16),   # one group per split
])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_split_sum_matches_jax(jx, m, k, n, gs, sm_count, splits, dtype):
    assert tk.split_plan(m, k, n, gs // 2, sm_count) == splits
    x, jw, tw = _pair(jx, m, k, n, gs, seed=7)
    ref = jx.k.int4_matmul(jx.jnp.asarray(x), jw, dtype=jx.jnp.dtype(dtype))
    assert ref is not None, 'JAX must take its kernel path at this shape'
    got = _split_sum(torch.from_numpy(x).bfloat16(), tw.values,
                     tw.scales.reshape(k // gs, n), getattr(torch, dtype),
                     splits)
    _close(got.float(), np.asarray(ref.astype(jx.jnp.float32)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def _card_operands(m, k, n, gs, seed=0):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device='cuda') * 0.05
    qw = tq.quantize_int4(w, (0,), group_size=gs, compute=True)
    x = torch.randn((m, k), generator=gen, device='cuda').bfloat16()
    return x, qw.values, qw.scales.reshape(k // gs, n)


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n,gs', [
    (1, 14336, 4096, 64),       # down's K
    (32, 14336, 4096, 64),
    (17, 1024, 512, 128),       # group 128
    (33, 800, 264, 40),         # half 20: not a multiple of 16
    (3, 480, 130, 24),          # half 12, ragged N
])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_kernel_group_sizes_and_long_k(m, k, n, gs, dtype):
    _need_card()
    x, vals, sc = _card_operands(m, k, n, gs)
    out_dtype = getattr(torch, dtype)
    got = tk.int4_matmul_cuda(x, vals, sc, out_dtype).float()
    ref = tk.int4_matmul_reference(x, vals, sc, out_dtype).float()
    torch.cuda.synchronize()
    tol = 1e-2 if dtype == 'bfloat16' else 1e-4
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n', [(32, 4096, 6144), (32, 14336, 4096),
                                   (17, 512, 256), (128, 4096, 4096)])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_kernel_repeats_bit_for_bit(m, k, n, dtype):
    """Split K is summed in a fixed order: two launches, the same bits."""
    _need_card()
    x, vals, sc = _card_operands(m, k, n, 64, seed=1)
    out_dtype = getattr(torch, dtype)
    first = tk.int4_matmul_cuda(x, vals, sc, out_dtype)
    second = tk.int4_matmul_cuda(x, vals, sc, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_k2_runs_on_tensor_cores():
    """Every instance of K2's kernel has HMMA in its SASS."""
    _need_card()
    counts = {name: n for name, n in tk.LIBRARY.tensor_core_counts().items()
              if 'k2_mma_kernel' in name}
    assert counts, 'no instance of k2_mma_kernel in the library'
    assert min(counts.values()) > 0, counts


@pytest.mark.cuda
def test_cuda_kernel_takes_x_off_16_byte_alignment():
    """x staged 16 bytes at a time: a view 2 bytes off alignment still
    gives the plain version's result."""
    _need_card()
    x, vals, sc = _card_operands(17, 512, 256, 64, seed=2)
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device='cuda')
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    got = tk.int4_matmul_cuda(shifted, vals, sc, torch.float32)
    ref = tk.int4_matmul_reference(x, vals, sc, torch.float32)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
