"""A/B of the int4 matmul's unpack arithmetic on the H100: the Hopper port
of ``scripts/bench/bench_int4_kernel_ab.py``.

Three variants of the W4A16 matmul x (M, K) @ dequant(values, scales),
each an instance of K2's tensor-core kernel (``k2_mma_kernel`` in
``csrc/int4_matmul.cu``: split-K, bf16 ``mma.sync``) that differs from
the others only in how B's fragments are dequantized in registers:

  v0  K2 (``ops/int4_matmul.py``): sign-extended nibbles, w = bf16(q * s)
      with the fp32 scale s, in fp32
  v1  w = bf16(q * bf16(s)): the scale rounded to bf16 first; packed
      bf16x2 arithmetic, two weights per instruction, exact
  v2  offset-low packing (``pack_v2``): the low nibble stores q + 8, the
      high nibble is signed; w_low = bf16((q + 8) * bf16(s)), w_high =
      bf16(q * bf16(s)), in bf16x2 as v1; the correction -8 * sum_g
      xs[m, g] * s[g, n] (xs: the fp32 sum of x over the low half of
      group g; s fp32, unrounded) is computed in plain torch
      (``v2_correction``), as the JAX script's ``run_v2`` computes it in
      XLA, and added once to each fp32 total.

Each product sums bf16-rounded x against the dequantized weight in fp32 and
returns bf16.  The wrappers ``int4_matmul_v1`` / ``int4_matmul_v2`` launch
the kernel on a CUDA tensor and run its plain PyTorch version on a CPU
tensor.  v2's packing graduates into ``models/quantization.py`` only if it
wins on the card: the packing changes with the kernel.

    python -m align_anything_tpu_torch.scripts.bench.bench_int4_kernel_ab

runs on the card (it raises without one) at the JAX script's three shapes,
Llama-3-8B widths, M = 32: one JSON line per shape with ``relerr`` (the JAX
script's max|o - o0| / max|fp32 reference|) and the device times in us of
v0, v1 and v2 (v2 with its correction, as the JAX script times ``run_v2``,
and its kernel alone), of their plain versions and of
``torch._weight_int4pack_mm`` (a yardstick the port never calls), beside
the bound; then a summary line and the card's name and power limit.
"""

from __future__ import annotations

import json

import torch

from align_anything_tpu_torch.models.quantization import (Int4Weight,
                                                          quantize_int4,
                                                          unpack_int4)
from align_anything_tpu_torch.ops import int4_matmul as k2
from align_anything_tpu_torch.scripts.bench.timing_utils import (
    bound, gpu_name_and_power, int4_library_ms, l2_flush_buffer, time_ms)
from align_anything_tpu_torch.utils.tools import default_device

M = 32
GS = 64
# (name, K, N) of the JAX script's shapes: Llama-3-8B's fused q/k/v, down
# and fused gate/up projections
SHAPES = (('qkv', 4096, 6144), ('down', 14336, 4096),
          ('gate_up', 4096, 28672))
SEED = 0
# A kernel agrees with its plain version when at least this share of its
# bf16 outputs is bit-equal and the largest difference is at most
# MAX_DIFF x max|plain|, one bf16 ulp at the max.  Both sum the same
# bf16-rounded products in fp32, in other orders, so an output differs
# only where the sum lies next to a rounding boundary of bf16.  The share
# is what tells the variants apart: v0's output matches v1's plain
# version on only about 60 % of elements, and v2 without its correction
# on almost none.
MIN_BIT_EQUAL = 0.99
MAX_DIFF = 8e-3


# ---------------------------------------------------------------- packing


def pack_v2(w: torch.Tensor, group_size: int = GS
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """w (K, N) -> values (G, gs/2, N) int8 in the offset-low packing
    (byte = (q_high & 15) << 4 | (q_low + 8), group row r < gs/2 the low
    element, r + gs/2 the high one), scales (G, N) fp32; the quantization
    of ``quantize_int4``, byte for byte the JAX script's ``pack_v2``."""
    k, n = w.shape
    g = k // group_size
    wg = w.to(torch.float32).reshape(g, group_size, n)
    amax = wg.abs().amax(dim=1, keepdim=True)
    sc = amax.clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(wg / sc), -7, 7).to(torch.int32)
    half = group_size // 2
    low = q[:, :half] + 8                      # [1, 15]
    high = q[:, half:] & 15                    # two's-complement nibble
    byte = (high << 4) | low
    return byte.to(torch.uint8).view(torch.int8), sc[:, 0, :]


def split_x(x: torch.Tensor, gs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> the low and the high half of each group, each (M, K/2)."""
    m, k = x.shape
    xg = x.reshape(m, k // gs, gs)
    half = gs // 2
    return (xg[:, :, :half].reshape(m, k // 2),
            xg[:, :, half:].reshape(m, k // 2))


def v2_correction(x: torch.Tensor, scales: torch.Tensor,
                  group_size: int) -> torch.Tensor:
    """-8 * sum_g xs[m, g] * s[g, n], (M, N) fp32: xs the fp32 sum of
    bf16 x over the low half of group g, s the unrounded fp32 scales."""
    m = x.shape[0]
    g = scales.shape[0]
    xlo, _ = split_x(x.to(torch.bfloat16), group_size)
    xs = xlo.to(torch.float32).reshape(m, g, group_size // 2).sum(2)
    return -8.0 * (xs @ scales)


# ---------------------------------------------------------------- plain


def _matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16-rounded x @ bf16 w, summed in fp32 -> fp32."""
    return x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)


def _scaled(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """bf16(fp32(q) * fp32(bf16(s))) for q (G, gs, N) and s (G, N), as
    (G*gs, N) bf16."""
    sb = scales.to(torch.bfloat16).to(torch.float32)[:, None, :]
    w = (q.to(torch.float32) * sb).to(torch.bfloat16)
    return w.reshape(-1, w.shape[-1])


def dequant_v1(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """v1's weight: values (G, gs/2, N) int8 (K2's packing), scales (G, N)
    fp32 -> (K, N) bf16, w = bf16(q * bf16(s))."""
    low, high = unpack_int4(values)
    return _scaled(torch.cat([low, high], 1), scales)


def dequant_v2(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """v2's weight before the correction: values (G, gs/2, N) int8 in the
    offset-low packing -> (K, N) bf16, the low nibble unsigned (q + 8),
    the high nibble signed."""
    v = values.to(torch.int32)
    return _scaled(torch.cat([v & 15, v >> 4], 1), scales)


def int4_matmul_v1_reference(x: torch.Tensor, values: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the v1 kernel.  x (M, K); values
    (G, gs/2, N) int8 (K2's packing); scales (G, N) fp32 -> (M, N) bf16."""
    return _matmul_bf16(x, dequant_v1(values, scales)).to(torch.bfloat16)


def int4_matmul_v2_reference(x: torch.Tensor, values: torch.Tensor,
                             scales: torch.Tensor,
                             corr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the v2 kernel.  values (G, gs/2, N) int8 in
    the offset-low packing; corr (M, N) fp32, ``v2_correction``'s, added
    once to the fp32 total."""
    return (_matmul_bf16(x, dequant_v2(values, scales)) + corr
            ).to(torch.bfloat16)


# ---------------------------------------------------------------- kernels


def int4_matmul_v1_cuda(x: torch.Tensor, values: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """Launch the v1 kernel.  x (M, K) bf16; values (G, gs/2, N) int8;
    scales (G, N) fp32, all contiguous on one CUDA device -> (M, N) bf16.
    K is split as K2 splits it (``split_plan``), over a workspace allocated
    here; each call counts as one launch in
    ``int4_matmul_v1_cuda.launches``."""
    m, k, n, half, vec = k2.check_operands('int4_matmul_v1_cuda', x, values,
                                           scales)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or n == 0:
        return out
    x, splits, ws = k2.split_operands(x, m, k, n, half)
    k2.launch('int4_matmul_v1_launch', x.device, x.data_ptr(),
              values.data_ptr(), scales.data_ptr(), out.data_ptr(),
              None if ws is None else ws.data_ptr(), splits, m, k, n, half,
              vec)
    int4_matmul_v1_cuda.launches += 1
    return out


int4_matmul_v1_cuda.launches = 0


def int4_matmul_v2_cuda(x: torch.Tensor, values: torch.Tensor,
                        scales: torch.Tensor,
                        corr: torch.Tensor) -> torch.Tensor:
    """Launch the v2 kernel: as ``int4_matmul_v1_cuda``, values in the
    offset-low packing and corr (M, N) fp32 contiguous, added once to each
    fp32 total.  Counts each call in ``int4_matmul_v2_cuda.launches``."""
    m, k, n, half, vec = k2.check_operands('int4_matmul_v2_cuda', x, values,
                                           scales)
    if (corr.device != x.device or corr.dtype != torch.float32
            or tuple(corr.shape) != (m, n) or not corr.is_contiguous()):
        raise ValueError(f'int4_matmul_v2_cuda takes corr ({m}, {n}) fp32, '
                         f'contiguous, on {x.device} (got {tuple(corr.shape)}'
                         f' {corr.dtype} on {corr.device})')
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or n == 0:
        return out
    if corr.data_ptr() % 16:
        corr = corr.clone()               # read 4 columns at a time
    x, splits, ws = k2.split_operands(x, m, k, n, half)
    k2.launch('int4_matmul_v2_launch', x.device, x.data_ptr(),
              values.data_ptr(), scales.data_ptr(), corr.data_ptr(),
              out.data_ptr(), None if ws is None else ws.data_ptr(), splits,
              m, k, n, half, vec)
    int4_matmul_v2_cuda.launches += 1
    return out


int4_matmul_v2_cuda.launches = 0


def _on_device(x: torch.Tensor, cpu, cuda, *args) -> torch.Tensor:
    x = x.to(torch.bfloat16).contiguous()
    if x.device.type == 'cpu':
        return cpu(x, *args)
    if x.device.type == 'cuda':
        return cuda(x, *args)
    raise ValueError(f'unsupported device {x.device}')


def int4_matmul_v0(x: torch.Tensor, values: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """K2 through the port's own wrapper: the A/B's baseline, bf16 out."""
    out = k2.int4_matmul(x, Int4Weight(values, scales[:, None, :], True))
    if out is None:
        raise ValueError(f'K2 does not take {x.shape[0]} rows')
    return out


def int4_matmul_v1(x: torch.Tensor, values: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """v1: x (M, K); values (G, gs/2, N) int8; scales (G, N) fp32 ->
    (M, N) bf16, the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    return _on_device(x, int4_matmul_v1_reference, int4_matmul_v1_cuda,
                      values, scales)


def int4_matmul_v2(x: torch.Tensor, values: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """v2: as ``int4_matmul_v1`` on ``pack_v2``'s values and scales; the
    correction is computed here, outside the kernel."""
    corr = v2_correction(x, scales, 2 * values.shape[1])
    return _on_device(x, int4_matmul_v2_reference, int4_matmul_v2_cuda,
                      values, scales, corr)


# ---------------------------------------------------------------- the A/B


def agreement(got: torch.Tensor, ref: torch.Tensor
              ) -> tuple[float, float, float]:
    """(share of elements bit-equal, max|got - ref|, max|ref|) of two bf16
    outputs of one shape."""
    if got.shape != ref.shape:
        raise ValueError(f'shapes differ: {tuple(got.shape)}, '
                         f'{tuple(ref.shape)}')
    g, r = got.to(torch.float32), ref.to(torch.float32)
    if not bool(torch.isfinite(g).all()):
        return 0.0, float('inf'), float(r.abs().max())
    return (float((g == r).to(torch.float32).mean()),
            float((g - r).abs().max()), float(r.abs().max()))


def agrees(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """The kernel-against-plain check (``MIN_BIT_EQUAL``, ``MAX_DIFF``)."""
    share, diff, scale = agreement(got, ref)
    return share >= MIN_BIT_EQUAL and diff <= MAX_DIFF * scale


def make_weights(k: int, n: int, gen: torch.Generator, gs: int = GS
                 ) -> dict:
    """A (K, N) bf16 weight from ``gen`` (on its device), in K2's packing
    (``values``, ``scales``) and in v2's (``v2_values``, ``v2_scales``),
    groups of ``gs``."""
    w = torch.randn((k, n), generator=gen, device=gen.device,
                    dtype=torch.bfloat16) * 0.02
    qw = quantize_int4(w, (0,), group_size=gs, compute=True)
    v2_values, v2_scales = pack_v2(w, gs)
    return {'values': qw.values, 'scales': qw.scales.reshape(k // gs, n),
            'v2_values': v2_values, 'v2_scales': v2_scales}


def compare(x: torch.Tensor, wts: dict) -> dict:
    """v0, v1 and v2 on x and ``make_weights``'s weights, on their device,
    and relerr of v1 and v2 as the JAX script defines it: max|o - o0| /
    max|fp32 reference|, the reference x @ (q * s) in fp32, unrounded."""
    vals, sc = wts['values'], wts['scales']
    out = {'v0': int4_matmul_v0(x, vals, sc),
           'v1': int4_matmul_v1(x, vals, sc),
           'v2': int4_matmul_v2(x, wts['v2_values'], wts['v2_scales'])}
    ref = x.to(torch.float32) @ Int4Weight(vals, sc[:, None, :]).dequantize(
        torch.float32)
    scale = float(ref.abs().max())
    o0 = out['v0'].to(torch.float32)
    out['relerr'] = {
        tag: float((out[tag].to(torch.float32) - o0).abs().max())
        / (scale + 1e-9) for tag in ('v1', 'v2')}
    return out


def measure(x: torch.Tensor, wts: dict, flush: torch.Tensor) -> dict:
    """Device times (ms) on the card: v0, v1, v2, v2's kernel alone and
    the library call the median of 10 launches, the plain versions of 3,
    each after an L2 flush (the packed weights are larger than the L2);
    and the bound, packed values + scales + x + out at the memory rate,
    since 2*M*K*N at the bf16 tensor-core rate takes less."""
    if x.device.type != 'cuda':
        raise ValueError(f'measure times kernels on the card (got {x.device})')
    vals, sc = wts['values'], wts['scales']
    v2v, v2s = wts['v2_values'], wts['v2_scales']
    m, k = x.shape
    n = vals.shape[-1]
    g = k // (2 * vals.shape[1])
    kernels = {
        'v0': lambda: int4_matmul_v0(x, vals, sc),
        'v1': lambda: int4_matmul_v1(x, vals, sc),
        'v2': lambda: int4_matmul_v2(x, v2v, v2s)}
    plain = {
        'v0': lambda: k2.int4_matmul_reference(x, vals, sc, torch.bfloat16),
        'v1': lambda: int4_matmul_v1_reference(x, vals, sc),
        'v2': lambda: int4_matmul_v2_reference(
            x, v2v, v2s, v2_correction(x, v2s, 2 * vals.shape[1]))}
    ms = {tag: time_ms(fn, 10, flush) for tag, fn in kernels.items()}
    # v2's kernel alone, on a correction computed beforehand: what its
    # unpack costs, apart from the correction's torch kernels
    corr = v2_correction(x, v2s, 2 * vals.shape[1])
    ms['v2_kernel'] = time_ms(lambda: int4_matmul_v2_cuda(x, v2v, v2s, corr),
                              10, flush)
    ms.update({f'{tag}_plain': time_ms(fn, 3, flush)
               for tag, fn in plain.items()})
    ms['library'], ms['library_note'] = int4_library_ms(x, vals, sc, flush)
    ms['bound'], ms['bound_by'] = bound(
        2 * m * k * n, vals.numel() + g * n * 4 + m * k * 2 + m * n * 2,
        torch.bfloat16)
    return ms


def run(dev: torch.device) -> dict:
    """The A/B at every shape of ``SHAPES``: shape name -> relerr and
    times (ms) on the card."""
    flush = l2_flush_buffer(dev)
    results = {}
    for i, (name, k, n) in enumerate(SHAPES):
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        wts = make_weights(k, n, gen)
        x = torch.randn((M, k), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        out = compare(x, wts)
        if not all(bool(torch.isfinite(out[t].float()).all())
                   for t in ('v0', 'v1', 'v2')):
            raise AssertionError(f'non-finite output at {name}')
        results[name] = {'K': k, 'N': n, 'M': M,
                         'relerr': out['relerr'], **measure(x, wts, flush)}
        del wts, x, out
    return results


TIMED = ('v0', 'v1', 'v2', 'v2_kernel', 'v0_plain', 'v1_plain', 'v2_plain',
         'library', 'bound')


def sum_of_shapes(results: dict) -> dict:
    """Each time of ``TIMED`` (ms) summed over ``run``'s shapes; None
    where a shape has none (the library call did not take it)."""
    total = {}
    for tag in TIMED:
        times = [r[tag] for r in results.values()]
        total[tag] = None if None in times else sum(times)
    return total


def main() -> None:
    dev = default_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = gpu_name_and_power()
    results = run(dev)
    for name, r in results.items():
        us = {f'{tag}_us': None if r[tag] is None else r[tag] * 1e3
              for tag in TIMED}
        print(json.dumps({name: {
            'M': r['M'], 'K': r['K'], 'N': r['N'], **us,
            'relerr': r['relerr'], 'bound_by': r['bound_by'],
            'library_note': r['library_note']}}), flush=True)
    total = {tag: None if ms is None else ms * 1e3
             for tag, ms in sum_of_shapes(results).items()}
    print(json.dumps({'sum_of_shapes_us': total,
                      'fastest_first': sorted(('v0', 'v1', 'v2'),
                                              key=total.get),
                      'device': torch.cuda.get_device_name(dev)}),
          flush=True)
    print(smi, flush=True)


if __name__ == '__main__':
    main()
