"""The port of ``scripts/bench/bench_int4_kernel_ab.py`` (the A/B variants
v1 and v2 of the int4 matmul) against the JAX script.

The JAX script is loaded into a fresh module whose ``pl.pallas_call`` runs
in interpret mode, so its Pallas kernels ``_kernel_v1`` and ``_kernel_v2``
run here on the CPU; no JAX file changes.  Both sides get the same numpy
arrays, rounded to bf16 the same way.

Tolerances:
- ``pack_v2``: byte-identical values and scales;
- v1 and v2, the port's plain versions against the JAX kernels, and the
  CUDA kernels against the plain versions (``cuda`` cases): at least 99 %
  of the bf16 outputs bit-equal and max|diff| <= 8e-3 x max|reference|,
  one bf16 ulp at the max.  Both sides sum the same bf16 products in fp32
  in other orders, so an output differs only where its sum lies next to a
  bf16 rounding boundary.  The share is what tells a wrong variant apart:
  v0's output against v1's reference is bit-equal on only about 60 %, and
  v2 without its correction on almost none (the negative controls);
- the bench's v0 equals ``ops/int4_matmul``'s plain version exactly;
- ``compare``'s relerr of v1 and v2 against v0: at most 2e-2, since
  they differ from v0 by the bf16 rounding of the scale (2^-9 relative)
  and of the output;
- the CUDA kernels' packed bf16x2 dequantization, emulated bit for bit in
  torch: equal, bit for bit, to the plain versions' dequantization;
- the plain versions summed over ``split_ranges`` in the kernel's order,
  v2's correction added once, against the JAX kernels: the ``agrees``
  check, as above.
"""

import functools
import importlib.util
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from align_anything_tpu_torch.models.quantization import (  # noqa: E402
    unpack_int4)
from align_anything_tpu_torch.ops import int4_matmul as tk  # noqa: E402
from align_anything_tpu_torch.scripts.bench import (  # noqa: E402
    bench_int4_kernel_ab as ab)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_136 = 0x43084308     # the bf16 pair {136, 136}
BF16_128 = 0x43004300     # {128, 128}
SHAPES = [(4, 256, 512, 64), (32, 1024, 256, 64), (8, 512, 384, 128)]


@pytest.fixture(scope='module')
def jab():
    """The JAX script in a fresh module, its Pallas calls in interpret
    mode."""
    jax = pytest.importorskip('jax')
    from jax.experimental import pallas as pl

    path = os.path.join(REPO, 'scripts', 'bench', 'bench_int4_kernel_ab.py')
    spec = importlib.util.spec_from_file_location('jax_int4_kernel_ab', path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)       # the script puts its own dirs on sys.path
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    mod.jnp = jax.numpy
    return mod


def _bf16_pair(a: np.ndarray, jnp):
    """The same fp32 array rounded to bf16 on both sides."""
    return torch.from_numpy(a).to(torch.bfloat16), \
        jnp.asarray(a).astype(jnp.bfloat16)


def _to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor (bf16 through fp32, exactly)."""
    dt = str(a.dtype)
    if dt == 'bfloat16':
        return torch.from_numpy(np.array(a.astype('float32'))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _operands(jab, m, k, n, gs, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    (xt, xj), (wt, wj) = _bf16_pair(x, jab.jnp), _bf16_pair(w, jab.jnp)
    g = k // gs
    qw = jab.quantize_int4(wj, (0,), gs, True)
    v0 = qw.values.reshape(g, gs // 2, n)
    s0 = qw.scales.reshape(g, n)
    v2, s2 = jab.pack_v2(wj, gs)
    return types.SimpleNamespace(
        x=xt, xj=xj, w=wt, wj=wj, gs=gs, gpc=jab._pick_gpc(g, gs),
        v0=v0, s0=s0, v2=v2, s2=s2, tv0=_to_torch(v0), ts0=_to_torch(s0),
        tv2=_to_torch(v2), ts2=_to_torch(s2))


def _assert_agrees(got, ref):
    share, diff, scale = ab.agreement(got, ref)
    assert share >= ab.MIN_BIT_EQUAL, (share, diff, scale)
    assert diff <= ab.MAX_DIFF * scale, (share, diff, scale)
    assert ab.agrees(got, ref)


@pytest.mark.parametrize('gs', [64, 128])
def test_pack_v2_byte_identical(jab, gs):
    rng = np.random.default_rng(gs)
    k, n = 4 * gs, 48
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    # group 0 of column 0: exact halves of the scale (round half to even)
    # and the +-7 ends; column 1: an all-zero group (the 1e-8 floor);
    # column 2: values below the floor
    w[:gs, 0] = np.resize([7.0, -7.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], gs)
    w[:gs, 1] = 0.0
    w[:gs, 2] = np.resize([1e-9, -3e-9, 5e-10], gs)
    wt, wj = _bf16_pair(w, jab.jnp)
    vals, sc = ab.pack_v2(wt, gs)
    jv, js = jab.pack_v2(wj, gs)
    assert vals.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(js))
    # the clip's ends are reached: low nibbles 1 and 15, high nibbles +-7
    low = vals.to(torch.int32) & 15
    high = vals.to(torch.int32) >> 4
    assert int(low.min()) == 1 and int(low.max()) == 15
    assert int(high.min()) == -7 and int(high.max()) == 7


def test_split_x_equal(jab):
    x = np.random.default_rng(3).normal(size=(5, 512)).astype(np.float32)
    for gs in (64, 128):
        got = ab.split_x(torch.from_numpy(x), gs)
        ref = jab.split_x(jab.jnp.asarray(x), gs)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize('m,k,n,gs', SHAPES)
def test_v1_matches_jax(jab, m, k, n, gs):
    o = _operands(jab, m, k, n, gs)
    ref = jab.run_variant(jab._kernel_v1, o.xj, o.v0, o.s0, o.gpc, gs)
    got = ab.int4_matmul_v1(o.x, o.tv0, o.ts0)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _assert_agrees(got, _to_torch(ref))


@pytest.mark.parametrize('m,k,n,gs', SHAPES)
def test_v2_matches_jax(jab, m, k, n, gs):
    o = _operands(jab, m, k, n, gs)
    ref = jab.run_v2(o.xj, o.v2, o.s2, o.gpc, gs)
    got = ab.int4_matmul_v2(o.x, o.tv2, o.ts2)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _assert_agrees(got, _to_torch(ref))


@pytest.mark.parametrize('m,k,n,gs', SHAPES)
def test_negative_controls_are_refused(jab, m, k, n, gs):
    """The check refuses K2's output as v1's, and v2 without its
    correction."""
    o = _operands(jab, m, k, n, gs)
    ref1 = _to_torch(jab.run_variant(jab._kernel_v1, o.xj, o.v0, o.s0,
                                     o.gpc, gs))
    assert not ab.agrees(ab.int4_matmul_v0(o.x, o.tv0, o.ts0), ref1)
    ref2 = _to_torch(jab.run_v2(o.xj, o.v2, o.s2, o.gpc, gs))
    bare = ab.int4_matmul_v2_reference(o.x, o.tv2, o.ts2,
                                       torch.zeros((m, n)))
    assert not ab.agrees(bare, ref2)


def test_v2_correction_matches_jax(jab):
    o = _operands(jab, 8, 512, 256, 64)
    xlo, _ = jab.split_x(o.xj, 64)
    xs = jab.jnp.sum(xlo.astype(jab.jnp.float32).reshape(8, 8, 32), axis=2)
    ref = -8.0 * jab.jnp.einsum('mg,gt->mt', xs, o.s2,
                                preferred_element_type=jab.jnp.float32)
    got = ab.v2_correction(o.x, o.ts2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_v2_nibbles_by_hand():
    """A byte whose high nibble is negative and whose low nibble is >= 8:
    q_low 5 is stored as 13, q_high -3 as 0xD; byte 0xDD = -35."""
    values = torch.full((1, 1, 1), -35, dtype=torch.int8)
    scales = torch.ones((1, 1))
    x = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    out = ab.int4_matmul_v2(x, values, scales)
    assert out.float().flatten().tolist() == [5.0, -3.0, 2.0]
    corr = ab.v2_correction(x, scales, 2)
    assert corr.flatten().tolist() == [-8.0, 0.0, -8.0]


@pytest.mark.parametrize('m,k,n', [(4, 256, 128), (32, 512, 384)])
def test_v0_from_the_bench_equals_ops(m, k, n):
    gen = torch.Generator().manual_seed(m)
    wts = ab.make_weights(k, n, gen)
    x = torch.randn((m, k), generator=gen, dtype=torch.bfloat16)
    got = ab.int4_matmul_v0(x, wts['values'], wts['scales'])
    ref = tk.int4_matmul_reference(x, wts['values'], wts['scales'],
                                   torch.bfloat16)
    assert torch.equal(got, ref)


def test_compare_on_the_cpu():
    gen = torch.Generator(device='cpu').manual_seed(0)
    wts = ab.make_weights(256, 128, gen)
    # K2's packing and v2's hold the same quantized weight
    v = wts['v2_values'].to(torch.int32)
    low, high = unpack_int4(wts['values'])
    assert torch.equal(torch.cat([low, high], 1),
                       torch.cat([(v & 15) - 8, v >> 4], 1))
    assert torch.equal(wts['scales'], wts['v2_scales'])
    x = torch.randn((4, 256), generator=gen, dtype=torch.bfloat16)
    out = ab.compare(x, wts)
    for tag in ('v0', 'v1', 'v2'):
        assert out[tag].shape == (4, 128) and out[tag].dtype == torch.bfloat16
        assert bool(torch.isfinite(out[tag].float()).all())
    assert set(out['relerr']) == {'v1', 'v2'}
    assert all(0 <= r <= 2e-2 for r in out['relerr'].values())


def test_entry_point_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the bench would run')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ab.main()


def test_cuda_wrappers_reject_cpu_tensors():
    gen = torch.Generator().manual_seed(1)
    wts = ab.make_weights(256, 128, gen)
    x = torch.randn((4, 256), generator=gen, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='CUDA'):
        ab.int4_matmul_v1_cuda(x, wts['values'], wts['scales'])
    with pytest.raises(ValueError, match='CUDA'):
        ab.int4_matmul_v2_cuda(x, wts['v2_values'], wts['v2_scales'],
                               torch.zeros((4, 128)))
    assert ab.int4_matmul_v1_cuda.launches == 0
    assert ab.int4_matmul_v2_cuda.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 3, 16, 17, 32, 33, 128])
@pytest.mark.parametrize('k,n,gs', [(1024, 512, 64), (768, 130, 64),
                                    (14336, 4096, 64), (800, 264, 40)])
def test_cuda_kernels_match_plain(m, k, n, gs):
    """v1 and v2 on the card against their plain versions: ragged N (no
    4-column vector loads), K cut into several splits (down's K 14336),
    and groups whose half is not a multiple of 16 (gs 40) included; two
    launches bit-equal; each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if k == 14336:
        assert tk.split_plan(m, k, n, gs // 2, sms) > 1
    gen = torch.Generator(device='cuda').manual_seed(m)
    wts = ab.make_weights(k, n, gen, gs)
    x = torch.randn((m, k), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    corr = ab.v2_correction(x, wts['v2_scales'], gs)
    cases = (
        (ab.int4_matmul_v1_cuda, (x, wts['values'], wts['scales']),
         ab.int4_matmul_v1_reference),
        (ab.int4_matmul_v2_cuda,
         (x, wts['v2_values'], wts['v2_scales'], corr),
         ab.int4_matmul_v2_reference))
    for kernel, args, plain in cases:
        before = kernel.launches
        got, again = kernel(*args), kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        assert torch.equal(got, again)
        _assert_agrees(got, ref)


@pytest.mark.cuda
def test_cuda_ab_variants_run_on_tensor_cores():
    """Every instance of v1's and v2's kernel, as of K2's, has HMMA in its
    SASS."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    counts = {}
    for name, n in tk.LIBRARY.tensor_core_counts().items():
        tag = tk.variant_of(name)
        if tag is not None:
            counts.setdefault(tag, []).append(n)
    assert sorted(counts) == ['v0', 'v1', 'v2'], counts
    assert min(min(n) for n in counts.values()) > 0, counts


@pytest.mark.cuda
def test_cuda_v2_nibbles_by_hand():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    values = torch.full((1, 1, 4), -35, dtype=torch.int8, device='cuda')
    scales = torch.ones((1, 4), device='cuda')
    x = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], device='cuda')
    out = ab.int4_matmul_v2(x, values, scales)
    torch.cuda.synchronize()
    assert out.float()[:, 0].tolist() == [5.0, -3.0, 2.0]


# ------------------------------------------- the kernels' arithmetic, emulated


def _bf16_halves(words: torch.Tensor) -> torch.Tensor:
    """32-bit words (held in int64) -> their two 16-bit halves as bf16,
    the low half first, along a new last dim."""
    halves = torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF], -1)
    return ((halves ^ 0x8000) - 0x8000).to(torch.int16).view(torch.bfloat16)


def _packed_dequant(values: torch.Tensor, scales: torch.Tensor,
                    variant: str) -> torch.Tensor:
    """The CUDA kernels' bf16x2 dequantization (``dequant_b`` in
    ``csrc/int4_matmul.cu``), emulated on bit patterns: values (G, gs/2, N)
    int8, gs/2 even; scales (G, N) fp32 -> (G*gs, N) bf16 in the plain
    versions' row order.

    A B register pairs packed rows (2t, 2t+1); one prmt puts byte jn of
    each in the low byte of a 16-bit half, the other bytes of the word
    being other columns' (here their complement, the worst case for the
    masks).  The low nibbles: (d & 0x000F000F) ^ 0x43084308 (v1; v2's
    unsigned nibble: | 0x43004300), the high ones the same of d >> 4 (both
    variants signed), then bf16 minus 136 (v2 low: 128), exact, then bf16
    times bf16(s).  Torch's bf16 operations on the CPU compute in fp32 and
    round once to nearest even; here that is sub.rn / mul.rn.bf16x2 bit for
    bit, since the difference and the product (a 4-bit integer times an
    8-bit significand) are exact in fp32."""
    v = values.to(torch.int64) & 0xFF
    a, b = v[:, 0::2], v[:, 1::2]
    d = a | ((~a & 0xFF) << 8) | (b << 16) | ((~b & 0xFF) << 24)
    mask = 0x000F000F
    low = ((d & mask) ^ BF16_136) if variant == 'v1' else \
        ((d & mask) | BF16_128)
    high = ((d >> 4) & mask) ^ BF16_136
    off = {'v1': 136.0, 'v2': 128.0}[variant]
    sb = scales.to(torch.bfloat16)[:, None, :]

    def rows(words, offset):
        q = _bf16_halves(words) - torch.tensor(offset, dtype=torch.bfloat16)
        w = q * sb[..., None]                        # (G, gs/4, N, 2)
        return w.permute(0, 1, 3, 2).reshape(w.shape[0], -1, w.shape[2])

    w = torch.cat([rows(low, off), rows(high, 136.0)], 1)
    return w.reshape(-1, w.shape[-1])


def _tie(base: torch.Tensor) -> torch.Tensor:
    """fp32 values exactly halfway between two neighbouring bf16 values."""
    bits = base.to(torch.bfloat16).view(torch.int16).to(torch.int32)
    return ((bits << 16) | 0x8000).view(torch.float32)


def _scale_sweep() -> torch.Tensor:
    rng = np.random.default_rng(11)
    floor = torch.tensor([1e-8], dtype=torch.float32) / 7.0
    realistic = torch.from_numpy(
        np.abs(rng.normal(size=24) * 0.02).astype(np.float32)) / 7.0
    wide = torch.from_numpy(
        (10.0 ** rng.uniform(-9, 37, size=24)).astype(np.float32))
    ties = _tie(torch.from_numpy(
        (10.0 ** rng.uniform(-8, 2, size=16)).astype(np.float32)))
    fixed = torch.tensor([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 0.0625,
                          3e37, 1e38, 3.3e38, -0.3], dtype=torch.float32)
    return torch.cat([floor, realistic, wide, ties, fixed])


@pytest.mark.parametrize('variant', ['v1', 'v2'])
def test_packed_dequant_is_the_plain_one_bit_for_bit(variant):
    """Tentpole arithmetic of the v1 / v2 kernels: all 256 byte values
    (in two row orders, so that each byte meets several neighbours in a
    register) against a sweep of scales: the floor 1e-8/7, realistic ones,
    ties of the bf16 rounding, values up to the overflow of q * bf16(s)."""
    scales = _scale_sweep()
    n = scales.numel()
    perm = torch.from_numpy(np.random.default_rng(5).permutation(256))
    order = torch.stack([torch.arange(256), perm])               # (2, 256)
    values = order.to(torch.uint8).view(torch.int8)[:, :, None].expand(
        2, 256, n).contiguous()
    sc = scales[None, :].expand(2, n).contiguous()
    plain = {'v1': ab.dequant_v1, 'v2': ab.dequant_v2}[variant]
    ref = plain(values, sc)
    got = _packed_dequant(values, sc, variant)
    assert got.shape == ref.shape == (1024, n)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    # the sweep reaches the ties and the overflow
    assert bool(torch.isinf(ref.float()).any())
    sb = scales.to(torch.bfloat16).to(torch.float32)
    assert bool((sb != scales).any())


def _split_sum(x, values, scales, variant, splits, corr=None,
               per_split=False):
    """The plain version summed over the plan's group ranges in the
    kernel's order, s = 0 .. S-1, in fp32; v2's correction added to the
    total (or, wrongly, to each split) before the bf16 cast."""
    gs = 2 * values.shape[1]
    dequant = {'v1': ab.dequant_v1, 'v2': ab.dequant_v2}[variant]
    acc = torch.zeros((x.shape[0], values.shape[-1]))
    for lo, hi in tk.split_ranges(values.shape[0], splits):
        acc += ab._matmul_bf16(x[:, lo * gs:hi * gs],
                               dequant(values[lo:hi], scales[lo:hi]))
        if per_split:
            acc += corr
    if corr is not None and not per_split:
        acc += corr
    return acc.to(torch.bfloat16)


@pytest.mark.parametrize('m,k,n,gs,sm_count,splits', [
    (8, 1280, 256, 64, 3, 3),        # 20 groups in 6 + 7 + 7
    (32, 2048, 384, 128, 132, 16),   # one group per split
])
@pytest.mark.parametrize('variant', ['v1', 'v2'])
def test_split_sum_matches_jax(jab, variant, m, k, n, gs, sm_count, splits):
    assert tk.split_plan(m, k, n, gs // 2, sm_count) == splits
    o = _operands(jab, m, k, n, gs, seed=7)
    if variant == 'v1':
        ref = jab.run_variant(jab._kernel_v1, o.xj, o.v0, o.s0, o.gpc, gs)
        got = _split_sum(o.x, o.tv0, o.ts0, 'v1', splits)
        _assert_agrees(got, _to_torch(ref))
        return
    ref = _to_torch(jab.run_v2(o.xj, o.v2, o.s2, o.gpc, gs))
    corr = ab.v2_correction(o.x, o.ts2, gs)
    _assert_agrees(_split_sum(o.x, o.tv2, o.ts2, 'v2', splits, corr), ref)
    # the correction added per split, not once, is refused
    assert not ab.agrees(_split_sum(o.x, o.tv2, o.ts2, 'v2', splits, corr,
                                    per_split=True), ref)
