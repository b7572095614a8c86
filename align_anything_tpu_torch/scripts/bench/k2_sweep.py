"""Where K2's time goes at the decode step's shapes, on the card.

    python -m align_anything_tpu_torch.scripts.bench.k2_sweep

builds edited copies of ``csrc/int4_matmul.cu`` into the gitignored build
directory (one nvcc each, all started together) and times K2 (``int4_matmul_launch``) at M = 32 and Llama-3-8B
widths (fused qkv, o, fused gate_up, down, the fp32-out head), device time
with the L2 flushed (``timing_utils.time_ms``):

- block shapes: the kernel as built for the port (4 warps, 4 k16-steps of
  bytes loaded ahead), 2 steps ahead, and 8 warps with 2 steps ahead, each
  with ``split_plan`` aiming at 2 and at 4 blocks per SM; one line per
  (build, target) with each shape's time, split count and error against
  ``int4_matmul_reference``, and the decode step (32 layers + the head);
- ablations of the port's build, each a copy of the source with one part
  taken out (wrong results, timing only): the dequantization (bytes go to
  the MMAs as they are), the MMAs (a cheap sum keeps the operands live),
  the staging of x, and all three (loads only).  The dequantization cut
  edits K2's own (v0's) arithmetic; the MMA and staging cuts edit the
  kernel body that v0 shares with the A/B variants v1 and v2, which the
  sweep does not time.

    python -m align_anything_tpu_torch.scripts.bench.k2_sweep \\
        --baseline OTHER/align_anything_tpu_torch/csrc/int4_matmul.cu

also builds ``int4_matmul.cu`` from another tree (a checkout of an earlier
commit, say), times it as the port's build is timed, before and after
the other builds, and says whether each of its outputs equals the port
build's bit for bit.

Then the card's name and power limit.  It raises without a card.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import torch

from align_anything_tpu_torch.models.quantization import quantize_int4
from align_anything_tpu_torch.ops import int4_matmul as k2
from align_anything_tpu_torch.ops._cuda_build import BUILD_DIR, CudaLibrary
from align_anything_tpu_torch.scripts.bench.timing_utils import (
    gpu_name_and_power, l2_flush_buffer, time_ms)
from align_anything_tpu_torch.utils.tools import default_device

M, GS = 32, 64
SHAPES = (('qkv', 4096, 6144), ('o', 4096, 4096), ('gate_up', 4096, 28672),
          ('down', 14336, 4096), ('head', 4096, 128256))
LAYERS = 32
_WARPS = 'constexpr int kWarps = 4;'
_AHEAD = 'constexpr int kAhead = 4;'
# name -> (edits of the source, warps): the build of the port first
BLOCKS = {'w4_ahead4': ((), 4),
          'w4_ahead2': (((_AHEAD, 'constexpr int kAhead = 2;'),), 4),
          'w8_ahead2': (((_WARPS, 'constexpr int kWarps = 8;'),
                         (_AHEAD, 'constexpr int kAhead = 2;')), 8)}
TARGETS = (2, 4)                  # blocks per SM that split_plan aims at
_DEQUANT = ('      blo[h] = pack_bf16(nibble(ra) * s, nibble(rb) * s);\n'
            '      bhi[h] = pack_bf16(nibble(ra >> 4) * s, '
            'nibble(rb >> 4) * s);\n')
_MMA = ('      mma_bf16(acc[mt][jn], alo[mt], blo);\n'
        '      mma_bf16(acc[mt][jn], ahi[mt], bhi);\n')
_STAGE = '    stage_x<MT, kTail>(xs, x, M, K, half, spg, m0, c0, nst);\n'
CUTS = {   # text in the source -> what takes its place in an ablation
    'dequant': (_DEQUANT, '      blo[h] = ra ^ __float_as_uint(s);\n'
                          '      bhi[h] = rb ^ (ra >> 4);\n'),
    'mma': (_MMA, '      acc[mt][jn][0] += __uint_as_float((blo[0] ^ alo[mt][0]'
                  ' ^ ahi[mt][1]) & 0x3fffffffu);\n'
                  '      acc[mt][jn][1] += __uint_as_float((blo[1] ^ bhi[0] ^ '
                  'bhi[1]) & 0x3fffffffu);\n'),
    'stage': (_STAGE, ''),
}
ABLATIONS = {'no_dequant': ('dequant',), 'no_mma': ('mma',),
             'no_stage': ('stage',), 'loads_only': ('dequant', 'mma', 'stage')}


def edited(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f'the source no longer has {old!r} once')
        src = src.replace(old, new)
    return src


def build_all(baseline: str | None) -> dict:
    """Every build -> tag -> its ``CudaLibrary``, loaded; the tag
    'baseline' for the source ``baseline``, where one is given."""
    src = k2.LIBRARY.source.read_text()
    sources = {tag: edited(src, edits) for tag, (edits, _) in BLOCKS.items()}
    sources.update({tag: edited(src, [CUTS[part] for part in parts])
                    for tag, parts in ABLATIONS.items()})
    if baseline is not None:
        with open(baseline) as f:
            sources['baseline'] = f.read()
    libs = {}
    for tag, text in sources.items():
        path = BUILD_DIR / 'k2_sweep' / f'{tag}.cu'
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        libs[tag] = CudaLibrary('int4_matmul', k2._bind)
        libs[tag].source = path
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs.values()))
    for tag, lib in libs.items():
        regs = [str(r.get('registers'))
                for r in lib.ptxas_resources().values()]
        print(f'build {tag}: registers of its instances {" ".join(regs)}',
              flush=True)
    return libs


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--baseline', help='int4_matmul.cu of another tree, '
                        'timed beside the port\'s build and compared with it '
                        'bit for bit')
    args = parser.parse_args(argv)
    dev = default_device()
    smi = gpu_name_and_power()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build_all(args.baseline)
    flush = l2_flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for name, k, n in SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev,
                        dtype=torch.bfloat16) * k ** -0.5
        qw = quantize_int4(w, (0,), group_size=GS, compute=True)
        x = torch.randn((M, k), generator=gen, device=dev, dtype=torch.bfloat16)
        dtype = torch.float32 if name == 'head' else torch.bfloat16
        vals, sc = qw.values, qw.scales.reshape(k // GS, n)
        cases.append((name, x, vals, sc, dtype,
                      k2.int4_matmul_reference(x, vals, sc, dtype).float()))
        del w, qw

    def run(lib, tile_n: int, target: int) -> tuple[float, str, list]:
        step, row, outs = 0.0, [], []
        for name, x, vals, sc, dtype, ref in cases:
            k, n = x.shape[1], vals.shape[-1]
            with mock.patch.object(k2, '_TILE_N', tile_n), \
                    mock.patch.object(k2, 'BLOCKS_PER_SM', target):
                splits = k2.split_plan(M, k, n, GS // 2, sms)
            out = torch.empty((M, n), dtype=dtype, device=dev)
            ws = (torch.empty((splits, M, n), dtype=torch.float32, device=dev)
                  if splits > 1 else None)

            def call():
                err = lib.int4_matmul_launch(
                    x.data_ptr(), vals.data_ptr(), sc.data_ptr(),
                    out.data_ptr(), None if ws is None else ws.data_ptr(),
                    splits, M, k, n, GS // 2, int(dtype == torch.float32), 1,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f'launch failed: CUDA error {err}')

            us = time_ms(call, 10, flush) * 1e3
            rel = float((out.float() - ref).abs().max() / ref.abs().max())
            step += us * (1 if name == 'head' else LAYERS)
            row.append(f'{name}={us:.2f}us(S{splits},err{rel:.1e})')
            outs.append(out)
        return step / 1e3, ' '.join(row), outs

    def baseline(when: str) -> list:
        step, row, outs = run(libs['baseline'].load(), 128, k2.BLOCKS_PER_SM)
        print(f'baseline ({when}): {row} decode_step_ms={step:.3f}',
              flush=True)
        return outs

    base_outs = [baseline('first')] if args.baseline is not None else []
    port_outs = None      # the port's build as shipped: the first block run
    for tag, (_, warps) in BLOCKS.items():
        for target in TARGETS:
            step, row, outs = run(libs[tag].load(), warps * 32, target)
            port_outs = outs if port_outs is None else port_outs
            print(f'block {tag} blocks_per_sm={target}: {row} '
                  f'decode_step_ms={step:.3f}', flush=True)
    for tag in ABLATIONS:
        step, row, _ = run(libs[tag].load(), 128, k2.BLOCKS_PER_SM)
        print(f'ablation {tag}: {row} decode_step_ms={step:.3f}', flush=True)
    if args.baseline is not None:
        base_outs.append(baseline('last'))
        same = all(torch.equal(a, b) for outs in base_outs
                   for a, b in zip(outs, port_outs))
        print(f'baseline outputs bit-equal to the port build\'s at every '
              f'shape, both runs: {same}', flush=True)
    print(smi, flush=True)


if __name__ == '__main__':
    main()
