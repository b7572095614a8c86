"""int4-COMPUTE matmul (W4A16): the Hopper port of the TPU kernel in
``align_anything_tpu/ops/int4_matmul.py``.

``int4_matmul`` takes x (..., K) and an ``Int4Weight`` whose groups run over
x's full last dim, and returns (..., *out_dims) in ``dtype``:

- on a CUDA tensor it launches the hand-written kernel in
  ``csrc/int4_matmul.cu`` (built by nvcc for sm_90a at first use), which
  cuts K into the ``split_plan`` ranges of whole groups, multiplies on the
  tensor cores and sums the ranges' fp32 partials in a fixed order;
- on a CPU tensor it runs ``int4_matmul_reference``, the kernel's plain
  PyTorch version, with the same rounding.

Both compute what the TPU kernel computes: x rounded to bf16, the weight
dequantized as (q * scale) in fp32 and rounded to bf16, the product summed
in fp32, the result cast to ``dtype``.

It returns None, and the caller dequantizes and runs a plain matmul, where
the JAX wrapper also declines: when the grouping does not run over x's last
dim (the 'o' projection of ``quantize_decoder_int4``, grouped over heads
only), and for prefill-sized inputs of more than ``KERNEL_MAX_ROWS`` rows,
where the weight read is amortized over many rows (chip_smoke.py's
phase 2 prints the crossover against the dense path on the H100).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from align_anything_tpu_torch.models.quantization import Int4Weight
from align_anything_tpu_torch.ops._cuda_build import CudaLibrary

# Largest row count (prod of x's leading dims) sent to the kernel.  Decode
# runs at M = number of slots (<= 128); larger M is prefill.
KERNEL_MAX_ROWS = 128

_MAX_GRID_Y = 65535
_TILE_N = 128          # columns per block in K2 (kTileN, csrc/int4_matmul.cu)
_TILE_M = 32           # rows per block in K2 (kTileM)
# split K until the grid holds about this many blocks per SM
BLOCKS_PER_SM = 2


def _bind(lib: ctypes.CDLL) -> None:
    """K2's entry point and those of the A/B variants V1 and V2
    (``scripts/bench/bench_int4_kernel_ab.py``), all in one library and
    one kernel body."""
    ptr, num = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in (
            (lib.int4_matmul_launch, [ptr] * 5 + [num] * 7 + [ptr]),
            (lib.int4_matmul_v1_launch, [ptr] * 5 + [num] * 6 + [ptr]),
            (lib.int4_matmul_v2_launch, [ptr] * 6 + [num] * 6 + [ptr])):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


# csrc/int4_matmul.cu, built by nvcc at first use (LIBRARY.build_log holds
# nvcc's and ptxas's output)
LIBRARY = CudaLibrary('int4_matmul', _bind)


def variant_of(kernel: str) -> str | None:
    """'v0' (K2), 'v1' or 'v2' for a (mangled) name of an instance of
    ``k2_mma_kernel``, whose first template argument is the variant; None
    for any other kernel."""
    for v in range(3):
        if f'k2_mma_kernelILi{v}E' in kernel:
            return f'v{v}'
    return None


def int4_matmul_reference(x: torch.Tensor, values: torch.Tensor,
                          scales: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  x (M, K); values (G, gs/2, N)
    int8; scales (G, N) fp32 -> (M, N) in ``dtype``."""
    w = Int4Weight(values, scales[:, None, :]).dequantize(torch.bfloat16)
    return (x.to(torch.bfloat16).to(torch.float32)
            @ w.to(torch.float32)).to(dtype)


def check_operands(caller: str, x: torch.Tensor, values: torch.Tensor,
                   scales: torch.Tensor) -> tuple[int, int, int, int, int]:
    """Raise unless x (M, K) bf16, values (G, gs/2, N) int8 and scales
    (G, N) fp32 are contiguous on one CUDA device and fit the kernel's
    grid; returns (M, K, N, gs/2, vec), ``vec`` set where a thread may load
    4 columns at once (N % 4 == 0, values / scales 4- / 16-byte aligned)."""
    g, half, n = values.shape
    m, k = x.shape
    dev = x.device
    if dev.type != 'cuda' or values.device != dev or scales.device != dev:
        raise ValueError(f'{caller} needs x, values and scales on one CUDA '
                         f'device (got {x.device}, {values.device}, '
                         f'{scales.device})')
    if (x.dtype != torch.bfloat16 or values.dtype != torch.int8
            or scales.dtype != torch.float32):
        raise ValueError(f'{caller} takes bf16 x, int8 values and fp32 '
                         f'scales (got {x.dtype}, {values.dtype}, '
                         f'{scales.dtype})')
    if k != g * 2 * half or tuple(scales.shape) != (g, n):
        raise ValueError(f'shape mismatch: x {tuple(x.shape)}, values '
                         f'{tuple(values.shape)}, scales {tuple(scales.shape)}')
    if not (x.is_contiguous() and values.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError(f'{caller} needs contiguous tensors')
    if -(-n // _TILE_N) > _MAX_GRID_Y:
        raise ValueError(f'N={n} exceeds the kernel grid')
    vec = int(n % 4 == 0 and values.data_ptr() % 4 == 0
              and scales.data_ptr() % 16 == 0)
    return m, k, n, half, vec


def split_plan(m: int, k: int, n: int, half: int, sm_count: int) -> int:
    """Number of ranges of whole groups that K2 cuts K into for x (m, k)
    and an (n)-column weight with groups of 2 * half: enough that the grid
    holds about ``BLOCKS_PER_SM`` blocks per SM, at least 1 and at most
    the number of groups."""
    groups = k // (2 * half)
    blocks = -(-m // _TILE_M) * -(-n // _TILE_N)
    want = math.floor(BLOCKS_PER_SM * sm_count / blocks + 0.5)
    return max(1, min(groups, want))


def split_ranges(groups: int, splits: int) -> list[tuple[int, int]]:
    """The group ranges [lo, hi) of a plan, as the kernel cuts them: split
    s takes groups [s * G // S, (s + 1) * G // S)."""
    return [(s * groups // splits, (s + 1) * groups // splits)
            for s in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(entry: str, dev: torch.device, *args) -> None:
    """Call ``entry`` of the built library with ``args`` and the current
    stream of ``dev``; raises if the launch failed."""
    fn = getattr(LIBRARY.load(), entry)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{entry} failed: CUDA error {err}')


def split_operands(x: torch.Tensor, m: int, k: int, n: int, half: int
                   ) -> tuple[torch.Tensor, int, torch.Tensor | None]:
    """x as the kernel stages it, 16 bytes at a time (a copy when x is not
    16-byte aligned), the number of splits of ``split_plan`` and the fp32
    workspace of the splits' partial sums, (S, M, N), or None for one
    split."""
    if x.data_ptr() % 16:
        x = x.clone()
    splits = split_plan(m, k, n, half, _sm_count(x.device.index or 0))
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    return x, splits, ws


def int4_matmul_cuda(x: torch.Tensor, values: torch.Tensor,
                     scales: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Launch the CUDA kernel.  x (M, K) bf16; values (G, gs/2, N) int8;
    scales (G, N) fp32, all contiguous on one CUDA device -> (M, N) in
    ``dtype`` (bf16 or fp32).  With more than one split the call also
    launches the fixed-order sum of the splits, over a workspace allocated
    here; it counts as one launch in ``int4_matmul_cuda.launches``."""
    m, k, n, half, vec = check_operands('int4_matmul_cuda', x, values, scales)
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'output dtype must be bf16 or fp32 (got {dtype})')
    out = torch.empty((m, n), dtype=dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    x, splits, ws = split_operands(x, m, k, n, half)
    launch('int4_matmul_launch', x.device, x.data_ptr(), values.data_ptr(),
           scales.data_ptr(), out.data_ptr(),
           None if ws is None else ws.data_ptr(), splits, m, k, n, half,
           int(dtype == torch.float32), vec)
    int4_matmul_cuda.launches += 1
    return out


int4_matmul_cuda.launches = 0


def int4_matmul(x: torch.Tensor, w, dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor | None:
    """x (..., K) x Int4Weight (layer-sliced; contraction over its dims
    0-1) -> (..., *out_dims) in ``dtype``, or None when the kernel does not
    apply (see the module docstring)."""
    vals, sc = w.values, w.scales
    if vals.ndim < 3:
        return None
    g, half = vals.shape[:2]
    k = g * 2 * half
    if x.shape[-1] != k:
        return None                       # grouping not over x's last dim
    out_dims = tuple(vals.shape[2:])
    n = math.prod(out_dims)
    m_dims = tuple(x.shape[:-1])
    m = math.prod(m_dims)
    if m > KERNEL_MAX_ROWS:
        return None                       # prefill-sized x: dense matmul
    x2 = x.reshape(m, k).to(torch.bfloat16).contiguous()
    v2 = vals.reshape(g, half, n)
    s2 = sc.reshape(g, n)
    if x.device.type == 'cpu':
        out = int4_matmul_reference(x2, v2, s2, dtype)
    elif x.device.type == 'cuda':
        out = int4_matmul_cuda(x2, v2, s2, dtype)
    else:
        raise ValueError(f'int4_matmul: unsupported device {x.device}')
    return out.reshape(m_dims + out_dims)
