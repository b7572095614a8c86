"""Device timing on the card, and the bound each time is read against (the
Hopper counterpart of ``scripts/bench/timing_utils.py``).

``time_ms`` times each launch with CUDA events after an L2 flush and takes
the median; ``bound`` is the least time the card could take for given
operations and bytes, from the H100 SXM's published peaks;
``int4_library_ms`` times PyTorch's own int4-weight GEMM, the yardstick of
the int4 matmul kernels (the port never calls it).
"""

from __future__ import annotations

import statistics
import subprocess

import torch

from align_anything_tpu_torch.models.quantization import unpack_int4
from align_anything_tpu_torch.ops.int4_matmul import int4_matmul_reference

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA
# cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# larger than the 50 MB L2, so zeroing it evicts every cached line
L2_FLUSH_BYTES = 256 * 2**20
# clock cycles the card spins before each timed launch (about 1 ms)
SPIN_CYCLES = 2_000_000


def gpu_name_and_power() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def l2_flush_buffer(dev: torch.device) -> torch.Tensor:
    return torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (decode finds its weights cold: they are 100x the L2).  The
    card spins for about a millisecond after the flush, so that ``fn``'s
    host work (Python, argument checks, the ctypes call) is enqueued before
    the start event runs and only device time is measured."""
    fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of the operations at
    the peak rate of ``dtype`` and the bytes at the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def int4pack(values: torch.Tensor, scales: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """PyTorch's own int4-weight GEMM operands for K2's (values, scales)
    (tinygemm layout: unsigned nibbles q + 8 with zero point 0, bf16
    scales), packed once, outside any timed region."""
    g, half, n = values.shape
    low, high = unpack_int4(values)
    w = (torch.cat([low, high], 1).reshape(g * 2 * half, n) + 8
         ).t().contiguous()
    packed = torch._convert_weight_to_int4pack(
        (w[:, ::2] << 4 | w[:, 1::2]).to(torch.uint8), 8)
    return packed, torch.stack([scales, torch.zeros_like(scales)], -1).to(
        torch.bfloat16).contiguous()


def int4_library_ms(x: torch.Tensor, values: torch.Tensor,
                    scales: torch.Tensor, flush: torch.Tensor
                    ) -> tuple[float | None, str]:
    """Time of ``torch._weight_int4pack_mm`` on K2's weight and x, or None
    and the reason where it does not take the shape."""
    gs = 2 * values.shape[1]
    try:
        packed, sz = int4pack(values, scales)
        out = torch._weight_int4pack_mm(x, packed, gs, sz)
        ref = int4_matmul_reference(x, values, scales, torch.float32)
        err = float((out.float() - ref).abs().max() / ref.abs().max())
        ms = time_ms(lambda: torch._weight_int4pack_mm(x, packed, gs, sz),
                     10, flush)
        return ms, f'rel_err_vs_plain={err:.2e}'
    except (RuntimeError, TypeError, AttributeError) as exc:
        return None, f'{type(exc).__name__}: {str(exc).splitlines()[0]}'
