"""Flash attention, forward and backward: the Hopper port of the TPU
kernels K1a (``_flash_named``, the library Pallas flash kernel) and K1b
(``splash_attention``) of ``align_anything_tpu/ops/attention.py``.

``flash_attention(q, k, v, attention_mask, causal, window)`` is the
differentiable entry point: q (B, L, H, D), k/v (B, L, KH, D) with KH
dividing H, in bf16 or fp32; it returns (B, L, H, D) in q's dtype.

- On a CUDA tensor the forward and backward launch the hand-written kernels
  of ``csrc/flash_attention.cu`` (nvcc, sm_90a, built at first use).  A
  call they cannot take (head dim, dtype, strides) raises.
- On a CPU tensor they run ``flash_attention_fwd_reference`` and
  ``flash_attention_bwd_reference``, the kernels' plain PyTorch versions:
  the same masks, the same (out, lse) residuals, and a backward that
  recomputes P from the saved lse, as the kernels do.

Both compute: scores (q . k) * D^-0.5 in fp32; key j is visible from query
i when it is not padding (``attention_mask[b, j]``) and, if ``causal``,
j <= i and, with a ``window``, i - j < window; softmax in fp32; out in q's
dtype and lse (B, H, L) in fp32.  Where K1a rounds, both round to q's
dtype (a no-op in fp32): the probabilities P before P V (forward) and
before dV, and dS before dK and dQ; sums stay fp32.  A query with no visible key gives zeros,
lse 0 and zero gradients (``xla_attention`` gives the mean of v there; such
rows do not occur in right-padded training batches).

The forward is the custom op ``aat_torch::flash_attention_fwd`` so that a
selective-checkpoint policy can name it: the ``save_flash`` remat policy of
``models/transformer.py`` keeps its (out, lse), as the JAX
``checkpoint_name('flash_out' / 'flash_lse')`` tags do, while
``dots_saveable`` re-runs it in the backward.
"""

# no ``from __future__ import annotations``: torch.library.custom_op reads
# the schema from the live annotations

import ctypes
import math
from typing import Optional

import torch

from align_anything_tpu_torch.ops._cuda_build import CudaLibrary

SUPPORTED_HEAD_DIMS = (64, 128, 256)
# bf16 at these head dims runs the tensor-core (wgmma) kernels; fp32 and
# bf16 at D 256 run the CUDA-core ones (csrc/flash_attention.cu
# ``on_tensor_cores``)
TENSOR_CORE_HEAD_DIMS = (64, 128)
_DTYPES = (torch.bfloat16, torch.float32)
_MAX_GRID = 65535
_MIN_TILE = 32         # smallest query / key tile of the kernels


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # causal, window, scale, is_fp32, stream
    tail = [i32, i32, ctypes.c_float, i32, ptr]
    fwd = lib.flash_attention_fwd_launch
    fwd.argtypes = [ptr] * 6 + [i32] * 5 + [i64] * 10 + tail
    fwd.restype = i32
    bwd = lib.flash_attention_bwd_launch
    bwd.argtypes = [ptr] * 11 + [i32] * 5 + [i64] * 10 + tail
    bwd.restype = i32
    info = lib.flash_attention_kernel_info
    info.argtypes = [i32] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
    info.restype = i32


# csrc/flash_attention.cu, built by nvcc at first use
LIBRARY = CudaLibrary('flash_attention', _bind)
KERNEL_NAMES = ('forward', 'delta', 'dk_dv', 'dq')


def kernel_info(d: int, dtype: torch.dtype) -> dict:
    """Registers, spill (local) bytes and shared memory of each of the four
    kernels at head dim ``d`` and ``dtype``, as the loaded library reports
    them."""
    lib = LIBRARY.load()
    out = {}
    for which, name in enumerate(KERNEL_NAMES):
        vals = [ctypes.c_int() for _ in range(3)]
        err = lib.flash_attention_kernel_info(
            which, d, int(dtype == torch.float32), *map(ctypes.byref, vals))
        if err:
            raise RuntimeError(
                f'flash_attention_kernel_info: CUDA error {err}')
        out[name] = {'registers': vals[0].value, 'spill_bytes': vals[1].value,
                     'smem_bytes': vals[2].value}
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _visible(l: int, attention_mask: torch.Tensor | None, causal: bool,
             window: int | None, device) -> torch.Tensor:
    """(B|1, 1, 1, L, L) bool: key j visible from query i."""
    i = torch.arange(l, device=device)[:, None]
    j = torch.arange(l, device=device)[None, :]
    vis = torch.ones((l, l), dtype=torch.bool, device=device)
    if causal:
        vis = vis & (j <= i)
    if window:
        vis = vis & ((i - j) < window)
    vis = vis[None, None, None]
    if attention_mask is not None:
        vis = vis & attention_mask.to(torch.bool)[:, None, None, None, :]
    return vis


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, KH, G, L, S) fp32 scores, scaled by D^-0.5; GQA grouped."""
    b, l, h, d = q.shape
    kh = k.shape[2]
    qg = q.float().reshape(b, l, kh, h // kh, d)
    return torch.einsum('blkgd,bskd->bkgls', qg, k.float()) * d ** -0.5


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded to ``dtype`` and back: the operand that K1a (and
    the kernels) feed to a product in the input type."""
    return x.to(dtype).float()


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  attention_mask: torch.Tensor | None = None,
                                  causal: bool = True,
                                  window: int | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel -> (out (B, L, H, D) in q's
    dtype, lse (B, H, L) fp32).  P is rounded to q's dtype before P V and
    the row sum taken in fp32, as in K1a."""
    b, l, h, d = q.shape
    s = _scores(q, k).masked_fill(
        ~_visible(l, attention_mask, causal, window, q.device), -math.inf)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    seen = denom > 0
    o = torch.einsum('bkgls,bskd->bkgld', _rounded(p, q.dtype), v.float())
    o = torch.where(seen, o / torch.where(seen, denom, torch.ones_like(denom)),
                    torch.zeros_like(o))
    lse = torch.where(seen, m + torch.log(torch.where(seen, denom, 1.0)),
                      torch.zeros_like(m))
    out = o.permute(0, 3, 1, 2, 4).reshape(b, l, h, d).to(q.dtype)
    return out, lse.reshape(b, h, l)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  attention_mask: torch.Tensor | None,
                                  out: torch.Tensor, lse: torch.Tensor,
                                  dout: torch.Tensor, causal: bool = True,
                                  window: int | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version of the backward kernels: P recomputed from the saved
    lse, delta = rowsum(dO * O), dS = P * (dP - delta) -> (dq, dk, dv) in
    q's dtype.  P (for dV) and dS (for dK, dQ) are rounded to q's dtype,
    as in K1a."""
    b, l, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    vis = _visible(l, attention_mask, causal, window, q.device)
    p = torch.where(vis, torch.exp(_scores(q, k)
                                   - lse.reshape(b, kh, g, l)[..., None]),
                    torch.zeros((), device=q.device))
    do = dout.float().reshape(b, l, kh, g, d)
    delta = (dout.float() * out.float()).sum(-1).reshape(b, l, kh, g)
    delta = delta.permute(0, 2, 3, 1)[..., None]          # (B, KH, G, L, 1)
    dv = torch.einsum('bkgls,blkgd->bskd', _rounded(p, q.dtype), do)
    dp = torch.einsum('blkgd,bskd->bkgls', do, v.float())
    ds = _rounded(p * (dp - delta), q.dtype)
    scale = d ** -0.5
    dq = torch.einsum('bkgls,bskd->blkgd', ds, k.float()).reshape(b, l, h, d)
    dk = torch.einsum('bkgls,blkgd->bskd', ds,
                      q.float().reshape(b, l, kh, g, d))
    return (dq * scale).to(q.dtype), (dk * scale).to(q.dtype), dv.to(q.dtype)


def row_scaled_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """How far a kernel's result ``got`` is from its plain version ``ref``:
    the max over rows (every index but the last, D) of max|got - ref| over
    the row's own max|ref|.  Under a causal mask row 0's output is v[0]
    while a late row averages hundreds of keys, so a limit scaled by the
    whole tensor's max would hide a late row's or a late key's fault.  A
    row's scale is floored at 1 % of the whole tensor's, so that a row that
    is zero by cancellation (a query that sees one key gets
    dq = p (dp - delta) k = 0) is not held to rounding noise."""
    ref = ref.float()
    diff = (got.float() - ref).abs().amax(-1)
    scale = ref.abs().amax(-1).clamp_min(1e-2 * float(ref.abs().max()))
    return float((diff / scale.clamp_min(1e-30)).max())


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check_inputs(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  attention_mask: torch.Tensor | None, causal: bool,
                  window: int | None) -> None:
    dev = q.device
    if dev.type != 'cuda' or k.device != dev or v.device != dev or (
            attention_mask is not None and attention_mask.device != dev):
        raise ValueError(f'{fn} needs q, k, v and the mask on one CUDA device '
                         f'(got {q.device}, {k.device}, {v.device})')
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f'{fn} takes bf16 or fp32 q, k, v of one dtype (got '
                         f'{q.dtype}, {k.dtype}, {v.dtype})')
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f'{fn}: q (B, L, H, D), k/v (B, L, KH, D) expected '
                         f'(got {tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)})')
    b, l, h, d = q.shape
    kb, s, kh, kd = k.shape
    if (kb, kd) != (b, d) or kh == 0 or h % kh:
        raise ValueError(f'{fn}: shape mismatch q {tuple(q.shape)}, '
                         f'k {tuple(k.shape)}')
    if s != l:
        raise ValueError(f'{fn} is self-attention only (L {l} != S {s})')
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f'{fn}: head dim {d} not in {SUPPORTED_HEAD_DIMS}')
    per16 = 16 // q.element_size()
    for name, t in (('q', q), ('k', k), ('v', v)):
        if (t.stride(-1) != 1 or any(st % per16 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f'{fn}: {name} needs a contiguous last dim, strides that are '
                f'multiples of {per16} elements and a 16-byte aligned start '
                f'(strides {t.stride()})')
    if attention_mask is not None and tuple(attention_mask.shape) != (b, l):
        raise ValueError(f'{fn}: attention_mask must be (B, L) = {(b, l)} '
                         f'(got {tuple(attention_mask.shape)})')
    if window is not None and (window < 1 or not causal):
        raise ValueError(f'{fn}: a window needs causal=True and window >= 1')
    if b > _MAX_GRID or -(-l // _MIN_TILE) > _MAX_GRID:
        raise ValueError(f'{fn}: B={b}, L={l} exceed the kernel grid')


def _mask_bytes(attention_mask: torch.Tensor | None) -> torch.Tensor | None:
    """(B, L) key mask as contiguous one-byte booleans."""
    if attention_mask is None:
        return None
    return attention_mask.to(torch.bool).contiguous()


def _geometry(q, k, v, mask_bytes, causal, window):
    b, l, h, d = q.shape
    return (b, l, h, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], l, int(causal), int(window or 0), d ** -0.5,
            int(q.dtype == torch.float32))


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             attention_mask: torch.Tensor | None = None,
                             causal: bool = True, window: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel -> (out (B, L, H, D) contiguous in q's
    dtype, lse (B, H, L) fp32).  Counts each launch in
    ``flash_attention_fwd_cuda.launches``."""
    _check_inputs('flash_attention_fwd_cuda', q, k, v, attention_mask, causal,
                  window)
    b, l, h, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    mask = _mask_bytes(attention_mask)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *_geometry(q, k, v, mask, causal, window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'flash attention forward launch failed: CUDA '
                           f'error {err}')
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             attention_mask: torch.Tensor | None,
                             out: torch.Tensor, lse: torch.Tensor,
                             dout: torch.Tensor, causal: bool = True,
                             window: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the three backward kernels (delta, dK/dV, dQ) -> (dq, dk, dv)
    contiguous in q's dtype.  ``out`` and ``dout`` are contiguous
    (B, L, H, D) in q's dtype, ``lse`` the forward's (B, H, L) fp32.
    Counts each call in ``flash_attention_bwd_cuda.launches``."""
    fn = 'flash_attention_bwd_cuda'
    _check_inputs(fn, q, k, v, attention_mask, causal, window)
    b, l, h, d = q.shape
    for name, t in (('out', out), ('dout', dout)):
        if (tuple(t.shape) != (b, l, h, d) or t.dtype != q.dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f'{fn}: {name} must be contiguous {(b, l, h, d)} '
                             f'{q.dtype} on {q.device}')
    if (tuple(lse.shape) != (b, h, l) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f'{fn}: lse must be contiguous {(b, h, l)} fp32')
    dq = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(tuple(k.shape), dtype=q.dtype, device=q.device)
    dv = torch.empty(tuple(k.shape), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    mask = _mask_bytes(attention_mask)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            *_geometry(q, k, v, mask, causal, window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'flash attention backward launch failed: CUDA '
                           f'error {err}')
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------

def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'flash attention: unsupported device {t.device}')
    return t.device.type


@torch.library.custom_op('aat_torch::flash_attention_fwd', mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        attention_mask: Optional[torch.Tensor], causal: bool,
                        window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the forward kernel on a CUDA tensor, its plain version
    on a CPU tensor.  ``window`` 0 means none."""
    if _device_kind(q) == 'cuda':
        return flash_attention_fwd_cuda(q, k, v, attention_mask, causal,
                                        window or None)
    return flash_attention_fwd_reference(q, k, v, attention_mask, causal,
                                         window or None)


@flash_attention_fwd.register_fake
def _(q, k, v, attention_mask, causal, window):
    b, l, h, d = q.shape
    return q.new_empty((b, l, h, d)), q.new_empty((b, h, l),
                                                  dtype=torch.float32)


def flash_attention_bwd(q, k, v, attention_mask, out, lse, dout, causal,
                        window):
    """(dq, dk, dv): the backward kernels on a CUDA tensor, their plain
    version on a CPU tensor."""
    fn = (flash_attention_bwd_cuda if _device_kind(q) == 'cuda'
          else flash_attention_bwd_reference)
    return fn(q, k, v, attention_mask, out, lse, dout, causal, window or None)


class FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, out, lse); the backward runs from them without a
    forward re-run."""

    @staticmethod
    def forward(ctx, q, k, v, attention_mask, causal, window):
        out, lse = torch.ops.aat_torch.flash_attention_fwd(
            q, k, v, attention_mask, causal, window)
        ctx.save_for_backward(q, k, v, attention_mask, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, attention_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, attention_mask, out, lse,
                                         dout.contiguous(), ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Differentiable self-attention through the kernels (see the module
    docstring).  q (B, L, H, D); k, v (B, L, KH, D); attention_mask (B, L)
    over keys."""
    return FlashAttention.apply(q, k, v, attention_mask, causal,
                                int(window or 0))
