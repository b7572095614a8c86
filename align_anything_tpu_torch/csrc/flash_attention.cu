// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of align_anything_tpu/ops/attention.py:
//   K1a  _flash_named (:73; fwd :87, bwd :99, via _flash_attention :111),
//        the library jax.experimental.pallas.ops.tpu.flash_attention: dense
//        causal or full self-attention, GQA by repeating the KV heads;
//   K1b  _splash_kernel / splash_attention (:186, :225), the library
//        splash_attention_kernel: block-sparse causal self-attention with
//        native GQA and an optional sliding window whose fully masked KV
//        blocks are skipped.
// One forward and one backward compute what both do:
//   q (B, L, H, D), k/v (B, L, KH, D) in bf16 or fp32, any row strides
//   (the last dim contiguous); query head h reads KV head h / (H / KH);
//   masks: a causal flag, an optional (B, L) key padding mask and an
//   optional window (keys with q - k >= window are masked; their tiles are
//   not visited).  Forward: out (B, L, H, D) in the input type and
//   lse (B, H, L) fp32.  Backward, from (q, k, v, out, lse) without a
//   forward re-run: a preprocess kernel (delta = rowsum(dO * O)), a dK/dV
//   kernel over key tiles that sums the H / KH query heads of its KV head
//   inside the block (no atomics, so the gradients repeat bit for bit), and
//   a dQ kernel over query tiles.  Four kernels in all.
// A query row with no visible key gives out = 0, lse = 0 and zero
// gradients.
//
// What bounds it on the H100: operations.  A visible (query, key) pair
// costs 4*D FLOPs forward (S = QK^T, O += PV) and 10*D backward (S, dP,
// dV, dK, dQ), against q/k/v/o bytes that are O(B*L*H*D): at L = 1024,
// D = 128, causal, the forward is 34 GFLOP for 84 MB, 35 us at 989
// TFLOP/s (bf16 tensor cores) against 25 us at 3.35 TB/s.
//
// bf16 at D 64 and D 128 (the training path) runs the tensor-core kernels
// (fwd_wgmma_kernel, dkdv_wgmma_kernel, dq_wgmma_kernel): one warpgroup
// (4 warps) per block multiplies 64-row tiles with wgmma.mma_async
// (sm_90a, bf16 x bf16 -> fp32).  wgmma rather than mma.sync: a first
// mma.sync version (one 16-row slab per warp, ldmatrix operands) was
// slower at every shape tried (PERF.md), every warp re-reading whole K/V
// tiles through ldmatrix; wgmma reads its shared-memory operands once per
// 64 rows and issues asynchronously.  Against the five limits of the first (CUDA-core)
// version:
//   1. products on CUDA cores in fp32 -> all five products (S, O += PV;
//      S^T / dP^T, dV += P^T dO, dK += dS^T Q; S, dP, dQ += dS K) are
//      wgmma on the tensor cores with fp32 accumulators;
//   2. tiles widened to fp32 in shared memory -> tiles stay bf16 in the
//      128-byte swizzled layout that wgmma's descriptors read without bank
//      conflicts; one tile serves as a K-major operand and, read
//      transposed, as an MN-major one (V for PV, dO and Q for dV and dK, K
//      for dQ);
//   3. synchronous loads -> K/V tiles (forward, dQ) and Q/dO/lse/delta
//      tiles (dK/dV) go through a 2-stage ring of cp.async.cg 16-byte
//      copies: tile j + 1 is in flight while tile j computes, one barrier
//      per tile (TMA and mbarriers are the next step);
//   4. P and dS through shared memory -> the accumulator layout of two
//      adjacent 8-column tiles is the register A-operand layout of one
//      16-deep slice, so P (forward), P^T and dS^T (dK/dV, which computes
//      S^T = K Q^T so that keys are its rows) and dS (dQ) are rounded to
//      bf16 in registers and fed straight to the next product;
//   5. masks on every tile -> each (64-row tile, key tile) pair that no
//      causal or window mask lets through is skipped, and each warp
//      evaluates per-element masks only on an edge: the causal diagonal,
//      the window's edge, a ragged end of L, or a key tile with padding
//      (from a block-wide vote); fully visible pairs skip them.
// Rounding follows K1a: P is rounded to bf16 before PV and before dV, dS
// before dK and dQ (jax 0.9.0 pallas/ops/tpu/flash_attention.py :471,
// :900, :918, :1258); accumulators, softmax statistics, lse and delta
// stay fp32; dK and dQ are scaled by D^-0.5 once, at the end.
//
// fp32 inputs (not on the training path) and bf16 at D 256 keep the
// CUDA-core kernels (fwd_kernel, dkdv_kernel, dq_kernel): tensor cores
// would need TF32 and lose fp32 precision, and at D 256 the fp32
// accumulators of a 64-row warpgroup tile (128 registers a thread for O,
// 256 for dK + dV) leave no room for the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;                       // threads: a 16 x 16 grid
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q; const void* k; const void* v;
  const unsigned char* mask;                  // (B, L) key padding, or null
  const void* out; const float* lse;          // forward results (backward)
  const void* dout;                           // (B, L, H, D) contiguous
  void* o_out; float* lse_out;                // forward outputs
  void* dq; void* dk; void* dv; float* delta; // backward outputs, scratch
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, mask_sb;
  int B, L, H, KH, causal, window;
  float scale;
};

// ===========================================================================
// CUDA-core kernels: fp32, and bf16 at D 256
// ===========================================================================
// Tile sizes (rows of a query tile BQ / key tile BK) per head dim, chosen
// so that each kernel's shared memory stays under the 227 KB a block may use.
template <int D> struct Tiles;
template <> struct Tiles<64>  { static constexpr int FQ = 64, FK = 64, BQ = 64, BK = 64; };
template <> struct Tiles<128> { static constexpr int FQ = 64, FK = 32, BQ = 64, BK = 64; };
template <> struct Tiles<256> { static constexpr int FQ = 32, FK = 32, BQ = 32, BK = 32; };

// bf16 is carried as its 16-bit pattern; fp32 as float.
struct bf16_t { unsigned short bits; };

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static constexpr int CH = 4;                // elements per 16-byte load
  __device__ static void load(float* dst, const float* src) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
  __device__ static void store4(float* dst, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  }
  __device__ static float to_f(float x) { return x; }
  __device__ static float dot(const float* a, const float* b) {   // 4 values
    const float4 x = *reinterpret_cast<const float4*>(a);
    const float4 y = *reinterpret_cast<const float4*>(b);
    return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, x.x * y.x)));
  }
};
template <> struct Cvt<bf16_t> {
  static constexpr int CH = 8;
  __device__ static float lo(unsigned w) { return __uint_as_float(w << 16); }
  __device__ static float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
  __device__ static void load(float* dst, const bf16_t* src) {
    const uint4 r = *reinterpret_cast<const uint4*>(src);
    reinterpret_cast<float4*>(dst)[0] = make_float4(lo(r.x), hi(r.x), lo(r.y), hi(r.y));
    reinterpret_cast<float4*>(dst)[1] = make_float4(lo(r.z), hi(r.z), lo(r.w), hi(r.w));
  }
  // round to nearest even, as __float2bfloat16_rn (inputs are finite)
  __device__ static unsigned rn(float x) {
    const unsigned u = __float_as_uint(x);
    return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
  }
  __device__ static void store4(bf16_t* dst, float a, float b, float c, float d) {
    uint2 u;
    u.x = rn(a) | (rn(b) << 16);
    u.y = rn(c) | (rn(d) << 16);
    *reinterpret_cast<uint2*>(dst) = u;
  }
  __device__ static float to_f(bf16_t x) { return __uint_as_float(unsigned(x.bits) << 16); }
  __device__ static float dot(const bf16_t* a, const bf16_t* b) {  // 8 values
    const uint4 x = *reinterpret_cast<const uint4*>(a);
    const uint4 y = *reinterpret_cast<const uint4*>(b);
    float s = lo(x.x) * lo(y.x);
    s = fmaf(hi(x.x), hi(y.x), s); s = fmaf(lo(x.y), lo(y.y), s); s = fmaf(hi(x.y), hi(y.y), s);
    s = fmaf(lo(x.z), lo(y.z), s); s = fmaf(hi(x.z), hi(y.z), s);
    s = fmaf(lo(x.w), lo(y.w), s); s = fmaf(hi(x.w), hi(y.w), s);
    return s;
  }
};

// rows x D elements (row stride in elements) -> shared fp32, row stride
// D + 4 (16-byte aligned rows, conflict-free column reads); rows >= valid
// are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int rows,
                                          int valid) {
  constexpr int CH = Cvt<T>::CH, NCH = D / CH, LD = D + 4;
  for (int idx = threadIdx.x; idx < rows * NCH; idx += NT) {
    const int r = idx / NCH, c = (idx % NCH) * CH;
    float* d = dst + r * LD + c;
    if (r < valid) {
      Cvt<T>::load(d, src + r * row_stride + c);
    } else {
#pragma unroll
      for (int e = 0; e < CH; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// acc[a][b] += sum_d A[ty + 16a][d] * B[tx + 16b][d]   (A B^T)
// A and B row-major in shared memory with row stride KD + 4.
template <int MA, int MB, int KD>
__device__ __forceinline__ void mm_nt(float (&acc)[MA][MB], const float* A,
                                      const float* B, int ty, int tx) {
  constexpr int LD = KD + 4;
#pragma unroll 2
  for (int d = 0; d < KD; d += 4) {
    float4 a[MA], b[MB];
#pragma unroll
    for (int i = 0; i < MA; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < MB; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < MA; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[a][4c + e] += sum_k A[ty + 16a][k] * B[k][4tx + 64c + e]   (A B)
// A row stride LDA, B row stride LDB; K a multiple of 4.
template <int MA, int NC, int K, int LDA, int LDB>
__device__ __forceinline__ void mm_nn(float (&acc)[MA][4 * NC], const float* A,
                                      const float* B, int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float a[MA][4];
#pragma unroll
    for (int i = 0; i < MA; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LDA + k);
      a[i][0] = t.x; a[i][1] = t.y; a[i][2] = t.z; a[i][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(
            B + (k + kk) * LDB + 4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < MA; ++i) {
          acc[i][4 * c + 0] = fmaf(a[i][kk], b.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(a[i][kk], b.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(a[i][kk], b.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(a[i][kk], b.w, acc[i][4 * c + 3]);
        }
      }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Is key kj visible from query qi?  kv_ok: the key exists and is not padding.
__device__ __forceinline__ bool visible(const Params& p, int qi, int kj, float kv_ok) {
  return kv_ok != 0.f && (!p.causal || kj <= qi) &&
         (p.window <= 0 || qi - kj < p.window);
}

// kv_ok[j] for the key tile at k0 (nk keys in range)
__device__ __forceinline__ void key_flags(float* kv_ok, const Params& p, int b,
                                          int k0, int nk, int bk) {
  for (int j = threadIdx.x; j < bk; j += NT)
    kv_ok[j] = (j < nk && (p.mask == nullptr ||
                           p.mask[b * p.mask_sb + k0 + j] != 0)) ? 1.f : 0.f;
}

// Key range [lo, hi) that queries [q0, q0 + nq) can see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int nq,
                                          int* lo, int* hi) {
  *lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  *hi = p.causal ? min(p.L, q0 + nq) : p.L;
}

// ---------------------------------------------------------------------------
// forward: grid (H, B, query tiles), the last query tile first (most work)
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(NT) fwd_kernel(const __grid_constant__ Params p) {
  constexpr int LD = D + 4, LP = BK + 4, MA = BQ / 16, MB = BK / 16, NC = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  float* kv_ok = Ps + BQ * LP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.x, b = blockIdx.y, L = p.L;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ, nq = min(BQ, L - q0);
  const int kh = h / (p.H / p.KH);
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  load_rows<T, D>(Qs, qp + q0 * p.q_sl, p.q_sl, BQ, nq);

  int k_lo, k_hi;
  key_range(p, q0, nq, &k_lo, &k_hi);
  const float sl2 = p.scale * LOG2E;           // scores in log2 units
  float o[MA][4 * NC], m[MA], l[MA];
#pragma unroll
  for (int i = 0; i < MA; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) o[i][c] = 0.f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    const int nk = min(BK, L - k0);
    __syncthreads();                           // last tile's readers are done
    load_rows<T, D>(Ks, kp + k0 * p.k_sl, p.k_sl, BK, nk);
    load_rows<T, D>(Vs, vp + k0 * p.v_sl, p.v_sl, BK, nk);
    key_flags(kv_ok, p, b, k0, nk, BK);
    __syncthreads();

    float s[MA][MB];
#pragma unroll
    for (int i = 0; i < MA; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j) s[i][j] = 0.f;
    mm_nt<MA, MB, D>(s, Qs, Ks, ty, tx);

#pragma unroll
    for (int i = 0; i < MA; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const bool ok = visible(p, qi, k0 + tx + 16 * j, kv_ok[tx + 16 * j]);
        s[i][j] = ok ? s[i][j] * sl2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
      const float alpha = exp2f(m[i] - m_use);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const float pv = exp2f(s[i][j] - m_use);
        l[i] += pv;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = pv;
      }
    }
    __syncthreads();
    mm_nn<MA, NC, BK, LP, LD>(o, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < MA; ++i) {
    const float ls = half_warp_sum(l[i]);
    const int qi = q0 + ty + 16 * i;
    if (qi < L) {
      const float inv = ls > 0.f ? 1.f / ls : 0.f;
      T* op = static_cast<T*>(p.o_out) + (((long long)b * L + qi) * p.H + h) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        Cvt<T>::store4(op + 4 * tx + 64 * c, o[i][4 * c] * inv,
                       o[i][4 * c + 1] * inv, o[i][4 * c + 2] * inv,
                       o[i][4 * c + 3] * inv);
      if (tx == 0)
        p.lse_out[((long long)b * p.H + h) * L + qi] =
            ls > 0.f ? (m[i] + log2f(ls)) * LN2 : 0.f;
    }
  }
}


// ---------------------------------------------------------------------------
// backward 1/3: delta[b, h, l] = sum_d dO * O; each lane reads 16 bytes at
// a time, D / CH lanes (at most 32) share one (b, l, h) row
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT) delta_kernel(const __grid_constant__ Params p) {
  constexpr int CH = Cvt<T>::CH, LPR = D / CH < 32 ? D / CH : 32, RPW = 32 / LPR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = ((long long)blockIdx.x * (NT / 32) + warp) * RPW + lane / LPR;
  const bool live = row < (long long)p.B * p.L * p.H;
  float acc = 0.f;
  if (live) {
    const T* o = static_cast<const T*>(p.out) + row * D;
    const T* g = static_cast<const T*>(p.dout) + row * D;
    for (int c = (lane % LPR) * CH; c < D; c += LPR * CH) acc += Cvt<T>::dot(o + c, g + c);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && lane % LPR == 0) {
    const long long h = row % p.H, bl = row / p.H;
    const long long l = bl % p.L, b = bl / p.L;
    p.delta[(b * p.H + h) * p.L + l] = acc;
  }
}

template <typename T, int D> constexpr int delta_rows_per_block() {
  return (NT / 32) * (32 / (D / Cvt<T>::CH < 32 ? D / Cvt<T>::CH : 32));
}

// ---------------------------------------------------------------------------
// backward 2/3: dK, dV.  grid (KH, B, key tiles), the first key tile first
// (under a causal mask it sees the most queries).  The block walks the
// G = H / KH query heads of its KV head and their query tiles in a fixed
// order, so each dK/dV element is one block's sum.
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(NT) dkdv_kernel(const __grid_constant__ Params p) {
  constexpr int LD = D + 4, LT = BQ + 4, MA = BQ / 16, MB = BK / 16, NC = D / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* PT = dOs + BQ * LD;                  // P^T  (key rows, query cols)
  float* dST = PT + BK * LT;                  // dS^T
  float* kv_ok = dST + BK * LT;
  float* lse_s = kv_ok + BK;                  // lse * log2(e) per query row
  float* dl_s = lse_s + BQ;                   // delta per query row
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kh = blockIdx.x, b = blockIdx.y, L = p.L, H = p.H;
  const int k0 = blockIdx.z * BK, nk = min(BK, L - k0);
  const int G = H / p.KH;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  load_rows<T, D>(Ks, kp + k0 * p.k_sl, p.k_sl, BK, nk);
  load_rows<T, D>(Vs, vp + k0 * p.v_sl, p.v_sl, BK, nk);
  key_flags(kv_ok, p, b, k0, nk, BK);

  // queries that can see a key of this tile: [q_lo, q_hi)
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(L, k0 + nk - 1 + p.window) : L;
  const float sl2 = p.scale * LOG2E;
  float dk[MB][4 * NC], dv[MB][4 * NC];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) { dk[i][c] = 0.f; dv[i][c] = 0.f; }

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* gp = static_cast<const T*>(p.dout) + ((long long)b * L * H + h) * D;
    const float* lse = p.lse + ((long long)b * H + h) * L;
    const float* dlt = p.delta + ((long long)b * H + h) * L;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      const int nq = min(BQ, L - q0);
      __syncthreads();
      load_rows<T, D>(Qs, qp + q0 * p.q_sl, p.q_sl, BQ, nq);
      load_rows<T, D>(dOs, gp + (long long)q0 * H * D, (long long)H * D, BQ, nq);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        lse_s[r] = r < nq ? lse[q0 + r] * LOG2E : 0.f;
        dl_s[r] = r < nq ? dlt[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[MA][MB], dp[MA][MB];
#pragma unroll
      for (int i = 0; i < MA; ++i)
#pragma unroll
        for (int j = 0; j < MB; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
      mm_nt<MA, MB, D>(s, Qs, Ks, ty, tx);
      mm_nt<MA, MB, D>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < MA; ++i) {
        const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
        for (int j = 0; j < MB; ++j) {
          const int c = tx + 16 * j;
          const bool ok = qi < L && visible(p, qi, k0 + c, kv_ok[c]);
          const float pv = ok ? exp2f(s[i][j] * sl2 - lse_s[r]) : 0.f;
          PT[c * LT + r] = pv;
          dST[c * LT + r] = pv * (dp[i][j] - dl_s[r]);
        }
      }
      __syncthreads();
      mm_nn<MB, NC, BQ, LT, LD>(dv, PT, dOs, ty, tx);
      mm_nn<MB, NC, BQ, LT, LD>(dk, dST, Qs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj < L) {
      const long long off = (((long long)b * L + kj) * p.KH + kh) * D;
      T* dkp = static_cast<T*>(p.dk) + off;
      T* dvp = static_cast<T*>(p.dv) + off;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float* a = &dk[i][4 * c];
        const float* w = &dv[i][4 * c];
        Cvt<T>::store4(dkp + 4 * tx + 64 * c, a[0] * p.scale, a[1] * p.scale,
                       a[2] * p.scale, a[3] * p.scale);
        Cvt<T>::store4(dvp + 4 * tx + 64 * c, w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3/3: dQ.  grid (H, B, query tiles), the last query tile first
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(NT) dq_kernel(const __grid_constant__ Params p) {
  constexpr int LD = D + 4, LP = BK + 4, MA = BQ / 16, MB = BK / 16, NC = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* kv_ok = dSs + BQ * LP;
  float* lse_s = kv_ok + BK;
  float* dl_s = lse_s + BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.x, b = blockIdx.y, L = p.L, H = p.H;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ, nq = min(BQ, L - q0);
  const int kh = h / (H / p.KH);
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* gp = static_cast<const T*>(p.dout) + ((long long)b * L * H + h) * D;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  load_rows<T, D>(Qs, qp + q0 * p.q_sl, p.q_sl, BQ, nq);
  load_rows<T, D>(dOs, gp + (long long)q0 * H * D, (long long)H * D, BQ, nq);
  const float* lse = p.lse + ((long long)b * H + h) * L;
  const float* dlt = p.delta + ((long long)b * H + h) * L;
  for (int r = threadIdx.x; r < BQ; r += NT) {
    lse_s[r] = r < nq ? lse[q0 + r] * LOG2E : 0.f;
    dl_s[r] = r < nq ? dlt[q0 + r] : 0.f;
  }

  int k_lo, k_hi;
  key_range(p, q0, nq, &k_lo, &k_hi);
  const float sl2 = p.scale * LOG2E;
  float acc[MA][4 * NC];
#pragma unroll
  for (int i = 0; i < MA; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    const int nk = min(BK, L - k0);
    __syncthreads();
    load_rows<T, D>(Ks, kp + k0 * p.k_sl, p.k_sl, BK, nk);
    load_rows<T, D>(Vs, vp + k0 * p.v_sl, p.v_sl, BK, nk);
    key_flags(kv_ok, p, b, k0, nk, BK);
    __syncthreads();

    float s[MA][MB], dp[MA][MB];
#pragma unroll
    for (int i = 0; i < MA; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
    mm_nt<MA, MB, D>(s, Qs, Ks, ty, tx);
    mm_nt<MA, MB, D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < MA; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(p, qi, k0 + c, kv_ok[c]);
        const float pv = ok ? exp2f(s[i][j] * sl2 - lse_s[r]) : 0.f;
        dSs[r * LP + c] = pv * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();
    mm_nn<MA, NC, BK, LP, LD>(acc, dSs, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < MA; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < L) {
      T* dqp = static_cast<T*>(p.dq) + (((long long)b * L + qi) * H + h) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        Cvt<T>::store4(dqp + 4 * tx + 64 * c, acc[i][4 * c] * p.scale,
                       acc[i][4 * c + 1] * p.scale, acc[i][4 * c + 2] * p.scale,
                       acc[i][4 * c + 3] * p.scale);
    }
  }
}


// ===========================================================================
// Tensor-core kernels: bf16, D 64 and 128
// ===========================================================================
// A block is one warpgroup (MW = 4 warps) that multiplies 64-row tiles
// with wgmma; warp w holds rows [16w, 16w + 16) of each 64-row tile.  Its
// accumulator fragments follow the mma.sync.m16n8k16 layout: lane =
// 4 * gr + t4 holds rows gr and gr + 8 at columns 2 * t4 and 2 * t4 + 1 of
// every 8-column n-tile (registers [0, 1] and [2, 3]).
constexpr int MW = 4, MT = 32 * MW;

// Per head dim, as measured on the H100 (chip_smoke.py phase 6 times the
// result): FMI 64-row m-tiles per forward block (a K/V tile read from L2
// serves 64 * FMI query rows), QBK key rows per dQ tile, and the blocks
// per SM that each kernel's registers must allow (__launch_bounds__: FMB
// forward, KMB dK/dV, QMB dQ).  At D 64 more resident warpgroups hide the
// latency of each one's product -> softmax -> product chain; at D 128
// shared memory allows 2-3 blocks per SM and the forward gains more from
// halving its K/V traffic.  Tiles are otherwise 64 x 64.
template <int D> struct WgTiles;
template <> struct WgTiles<64> {
  static constexpr int FMI = 1, FMB = 4, KMB = 3, QBK = 64, QMB = 4;
};
template <> struct WgTiles<128> {
  static constexpr int FMI = 2, FMB = 1, KMB = 1, QBK = 32, QMB = 2;
};

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16-byte (4-byte) async copy global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// two floats -> bf16x2 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 2^x on the special-function unit (results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment (m16n8k16 layout, which is also each warp's part of a
// wgmma A operand in registers) of the 16-deep slice kk of an accumulator
// s (n-tiles 2kk and 2kk + 1), rounded to bf16: no trip through shared
// memory.
template <int N>
__device__ __forceinline__ void acc_to_a(unsigned (&a)[4], const float (&s)[N][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

template <int MI, int N>
__device__ __forceinline__ void zero(float (&c)[MI][N][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int n = 0; n < N; ++n) c[mi][n][0] = c[mi][n][1] = c[mi][n][2] = c[mi][n][3] = 0.f;
}

template <int ROWS>
__device__ __forceinline__ void load_f32_async(float* dst, const float* src, int valid) {
  for (int i = threadIdx.x; i < ROWS; i += MT) {
    const bool ok = i < valid;
    cp_async4(smem_u32(dst + i), src + (ok ? i : 0), ok ? 4 : 0);
  }
}

// the key exists and is not padding
__device__ __forceinline__ bool key_ok(const Params& p, int b, int kj) {
  return kj < p.L && (p.mask == nullptr || p.mask[b * p.mask_sb + kj] != 0);
}

// causal and window masks of one (query, key) pair
__device__ __forceinline__ bool pair_ok(const Params& p, int qi, int kj) {
  return (!p.causal || kj <= qi) && (p.window <= 0 || qi - kj < p.window);
}

// RW rows from qw against keys [k0, k0 + BK): nothing visible
// under the causal mask or the window (the tile is skipped) ...
template <int RW, int BK>
__device__ __forceinline__ bool all_masked(const Params& p, int qw, int k0) {
  return qw >= p.L || (p.causal && k0 > qw + RW - 1) ||
         (p.window > 0 && qw - (k0 + BK - 1) >= p.window);
}
// ... or a pair on the diagonal or the window's edge (per-element masks)
template <int RW, int BK>
__device__ __forceinline__ bool on_edge(const Params& p, int qw, int k0) {
  return (p.causal && k0 + BK - 1 > qw) || (p.window > 0 && qw + RW - 1 - k0 >= p.window);
}

// ---------------------------------------------------------------------------
// wgmma: one warpgroup (the block's 4 warps) multiplies a 64-row tile.
// Operands in shared memory are read through matrix descriptors from
// tiles in the 128-byte swizzled layout: rows of 64 bf16 (128 bytes) whose
// 16-byte chunk c sits at chunk c ^ (row % 8); a tile of R rows and D
// columns is D / 64 column blocks of R x 128 bytes, each 1024-byte aligned.
// The same tile serves as a K-major operand (its rows are M or N) and as
// an MN-major one (its rows are K, read transposed).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulators are live across the asynchronous products: keep the
// compiler from touching them between the issue and the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(unsigned (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}
// shared-memory writes of this thread (cp.async included) become visible
// to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// matrix descriptor: start address, leading and stride byte offsets,
// 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand: the ROWS-row tile at `tile`, columns [16 kk, 16 kk + 16)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(unsigned tile, int kk) {
  return gmma_desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024);
}
// MN-major operand: rows [16 kk, 16 kk + 16) of the ROWS-row tile, all columns
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(unsigned tile, int kk) {
  return gmma_desc(tile + kk * 2048, ROWS * 128, 1024);
}

// ROWS x D bf16 rows (global row stride ld elements) -> the swizzled tile
// at shared address dst, by cp.async; rows >= valid are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_sw(unsigned dst, const bf16_t* src, long long ld,
                                             int valid) {
  constexpr int CPR = D / 8;
  static_assert(ROWS * CPR % MT == 0, "whole copies per thread");
#pragma unroll
  for (int u = 0; u < ROWS * CPR / MT; ++u) {
    const int i = threadIdx.x + u * MT, r = i / CPR, c = i % CPR;
    const bool ok = r < valid;
    cp_async16(dst + (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               src + (ok ? (long long)r * ld : 0) + c * 8, ok ? 16 : 0);
  }
}

// d[4][4] += A B^T: A (64 x 16) and B (32 x 16) K-major in shared
// memory (descriptors)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(1));
}

// d[8][4] += A B^T: A (64 x 16) and B (64 x 16) K-major in shared
// memory (descriptors)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// d[8][4] += A B: A (64 x 16, bf16) in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B (16 x 64) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const unsigned (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[16][4] += A B: A (64 x 16, bf16) in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B (16 x 128) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const unsigned (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int NS>
__device__ __forceinline__ void wgmma_ss(float (&d)[NS][4], uint64_t a, uint64_t b) {
  if constexpr (NS == 4) wgmma_ss_n32(d, a, b);
  else wgmma_ss_n64(d, a, b);
}
template <int ND>
__device__ __forceinline__ void wgmma_rs(float (&d)[ND][4], const unsigned (&a)[4], uint64_t b) {
  if constexpr (ND == 8) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// ---------------------------------------------------------------------------
// forward: grid (H, B, query tiles of 64 MI rows), the last query tile
// first.  The warpgroup takes its MI 64-row m-tiles one after the other
// against each key tile, so that a K/V tile read from L2 serves 64 MI rows.
// ---------------------------------------------------------------------------
template <int D, int MI>
__global__ void __launch_bounds__(MT, WgTiles<D>::FMB) fwd_wgmma_kernel(const __grid_constant__ Params p) {
  constexpr int BQ = 64 * MI, BK = 64, KD = D / 16, NS = BK / 8, ND = D / 8;
  constexpr int TQ = BQ * D * 2, TK = BK * D * 2;    // tile bytes
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  const unsigned Qs = base, Ks = base + TQ, Vs = Ks + 2 * TK;   // K, V: 2 stages
  unsigned char* kok = smem_raw + (Vs + 2 * TK - raw);           // 2 x BK
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, L = p.L;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ, nq = min(BQ, L - q0);
  const int kh = h / (p.H / p.KH);
  const bf16_t* qp = static_cast<const bf16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16_t* kp = static_cast<const bf16_t*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16_t* vp = static_cast<const bf16_t*>(p.v) + b * p.v_sb + kh * p.v_sh;

  int k_lo, k_hi;
  key_range(p, q0, nq, &k_lo, &k_hi);
  const int k_first = (k_lo / BK) * BK;
  load_tile_sw<D, BQ>(Qs, qp + q0 * p.q_sl, p.q_sl, nq);
  load_tile_sw<D, BK>(Ks, kp + k_first * p.k_sl, p.k_sl, min(BK, L - k_first));
  load_tile_sw<D, BK>(Vs, vp + k_first * p.v_sl, p.v_sl, min(BK, L - k_first));
  cp_async_commit();
  int pad = 0;                                       // my key of the tile is masked
  if (tid < BK) {
    const bool ok = key_ok(p, b, k_first + tid);
    kok[tid] = ok;
    pad = !ok;
  }

  const float sl2 = p.scale * LOG2E;                 // scores in log2 units
  float o[MI][ND][4], m[MI][2], l[MI][2];
  zero(o);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    m[mi][0] = m[mi][1] = -INFINITY;
    l[mi][0] = l[mi][1] = 0.f;
  }

  int st = 0;
  for (int k0 = k_first; k0 < k_hi; k0 += BK) {
    cp_async_wait_all();
    fence_async_smem();
    const bool tile_pad = __syncthreads_or(pad);     // also: stage st landed
    int ok_next = 1;
    if (k0 + BK < k_hi) {                            // tile j + 1 into the other stage
      const int kn = k0 + BK, nk = min(BK, L - kn);
      load_tile_sw<D, BK>(Ks + (st ^ 1) * TK, kp + (long long)kn * p.k_sl, p.k_sl, nk);
      load_tile_sw<D, BK>(Vs + (st ^ 1) * TK, vp + (long long)kn * p.v_sl, p.v_sl, nk);
      cp_async_commit();
      if (tid < BK) ok_next = key_ok(p, b, kn + tid);
    }
    const unsigned Kt = Ks + st * TK, Vt = Vs + st * TK;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int qm = q0 + 64 * mi, qw = qm + 16 * warp;   // m-tile, warp rows
      if (all_masked<64, BK>(p, qm, k0)) continue;        // uniform in the block
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      reg_fence(s);
      reg_fence(o[mi]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)                // S = Q K^T
        wgmma_ss(s, desc_k<BQ>(Qs + mi * 8192, kk), desc_k<BK>(Kt, kk));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      if (tile_pad || on_edge<16, BK>(p, qw, k0)) {
        const unsigned char* ok = kok + st * BK;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t4 + (e & 1);
            if (!(ok[c] && pair_ok(p, qw + gr + 8 * (e >> 1), k0 + c))) s[j][e] = -INFINITY;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {                  // online softmax, rows gr, gr + 8
        float mx = m[mi][r];
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mu = mx == -INFINITY ? 0.f : mx * sl2;   // no -inf - -inf
        const float alpha = exp2_fast(m[mi][r] * sl2 - mu);
        m[mi][r] = mx;
        l[mi][r] *= alpha;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[mi][n][2 * r] *= alpha;
          o[mi][n][2 * r + 1] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[j][e] = exp2_fast(fmaf(s[j][e], sl2, -mu));
            l[mi][r] += s[j][e];
          }
      }
      unsigned pa[BK / 16][4];                       // bf16(P) as A operands
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(pa[kk], s, kk);
      reg_fence(pa);
      reg_fence(o[mi]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)           // O += bf16(P) V
        wgmma_rs<ND>(o[mi], pa[kk], desc_mn<BK>(Vt, kk));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o[mi]);
    }
    if (tid < BK) kok[(st ^ 1) * BK + tid] = ok_next;
    pad = !ok_next;
    st ^= 1;
  }
  cp_async_wait_all();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float ls = l[mi][r];
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      const int qi = q0 + 64 * mi + 16 * warp + gr + 8 * r;
      if (qi < L) {
        const float inv = ls > 0.f ? 1.f / ls : 0.f;
        bf16_t* op = static_cast<bf16_t*>(p.o_out) + (((long long)b * L + qi) * p.H + h) * D;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<unsigned*>(op + 8 * n + 2 * t4) =
              pack_bf16(o[mi][n][2 * r] * inv, o[mi][n][2 * r + 1] * inv);
        if (t4 == 0)
          p.lse_out[((long long)b * p.H + h) * L + qi] =
              ls > 0.f ? (m[mi][r] * sl2 + log2f(ls)) * LN2 : 0.f;
      }
    }
}
template <int D> constexpr int fwd_wgmma_smem() {
  return 1024 + (64 * WgTiles<D>::FMI + 4 * 64) * D * 2 + 2 * 64;
}

// ---------------------------------------------------------------------------
// backward 2/3: dK, dV.  grid (KH, B, key tiles of 64), the first key tile
// first (under a causal mask it sees the most queries).  The block walks
// the G = H / KH query heads of its KV head and their 64-row query tiles
// in a fixed order, so each dK/dV element is one block's sum.  The
// warpgroup computes S^T = K Q^T and dP^T = V dO^T (keys are its 64 rows),
// so that P^T and dS^T come out as register A operands of dV += P^T dO
// and dK += dS^T Q.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(MT, WgTiles<D>::KMB) dkdv_wgmma_kernel(const __grid_constant__ Params p) {
  constexpr int BK = 64, BQ = 64, KD = D / 16, NQ = BQ / 8, ND = D / 8;
  constexpr int TK = BK * D * 2, TQ = BQ * D * 2;    // tile bytes
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  const unsigned Ks = base, Vs = base + TK, Qs = base + 2 * TK, dOs = Qs + 2 * TQ;  // Q, dO: 2 stages
  float* lse_s = reinterpret_cast<float*>(smem_raw + (dOs + 2 * TQ - raw));  // 2 stages
  float* dl_s = lse_s + 2 * BQ;                                                 // 2 stages
  unsigned char* kok = reinterpret_cast<unsigned char*>(dl_s + 2 * BQ);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int kh = blockIdx.x, b = blockIdx.y, L = p.L, H = p.H;
  const int k0 = blockIdx.z * BK, nk = min(BK, L - k0);
  const int kw = k0 + 16 * warp;                     // the warp's first key
  const int G = H / p.KH;
  const bf16_t* kp = static_cast<const bf16_t*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16_t* vp = static_cast<const bf16_t*>(p.v) + b * p.v_sb + kh * p.v_sh;

  // queries that can see a key of this tile: [q_lo, q_hi); iteration it
  // visits query head kh * G + it / nqt, query tile it % nqt
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(L, k0 + nk - 1 + p.window) : L;
  const int q_first = (q_lo / BQ) * BQ;
  const int nqt = (q_hi - q_first + BQ - 1) / BQ;    // query tiles per head
  const int n_it = G * nqt;
  auto issue = [&](int it, int s) {                  // Q, dO, lse, delta of it
    const int h = kh * G + it / nqt, q0 = q_first + (it % nqt) * BQ;
    const int nq = min(BQ, L - q0);
    const long long bh = (long long)b * H + h;
    load_tile_sw<D, BQ>(Qs + s * TQ, static_cast<const bf16_t*>(p.q) + b * p.q_sb +
                        h * p.q_sh + q0 * p.q_sl, p.q_sl, nq);
    load_tile_sw<D, BQ>(dOs + s * TQ, static_cast<const bf16_t*>(p.dout) +
                        (((long long)b * L + q0) * H + h) * D, (long long)H * D, nq);
    load_f32_async<BQ>(lse_s + s * BQ, p.lse + bh * L + q0, nq);
    load_f32_async<BQ>(dl_s + s * BQ, p.delta + bh * L + q0, nq);
  };
  load_tile_sw<D, BK>(Ks, kp + k0 * p.k_sl, p.k_sl, nk);
  load_tile_sw<D, BK>(Vs, vp + k0 * p.v_sl, p.v_sl, nk);
  if (n_it > 0) issue(0, 0);
  cp_async_commit();
  int pad = 0;
  if (tid < BK) {
    const bool ok = key_ok(p, b, k0 + tid);
    kok[tid] = ok;
    pad = !ok;
  }
  const bool tile_pad = __syncthreads_or(pad);

  const float sl2 = p.scale * LOG2E;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();                                 // stage st landed, st ^ 1 free
    if (it + 1 < n_it) {
      issue(it + 1, st ^ 1);
      cp_async_commit();
    }
    const int q0 = q_first + (it % nqt) * BQ;
    if ((p.causal && k0 > q0 + BQ - 1) || (p.window > 0 && q0 - (k0 + BK - 1) >= p.window))
      continue;                                      // nothing visible: uniform in the block
    const unsigned Qt = Qs + st * TQ, dOt = dOs + st * TQ;
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      wgmma_ss(s, desc_k<BK>(Ks, kk), desc_k<BQ>(Qt, kk));     // S^T = K Q^T
      wgmma_ss(dp, desc_k<BK>(Vs, kk), desc_k<BQ>(dOt, kk));   // dP^T = V dO^T
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);
    const bool edge = tile_pad || q0 + BQ > L || (p.causal && kw + 15 > q0) ||
                      (p.window > 0 && q0 + BQ - 1 - kw >= p.window);
    const float* ls = lse_s + st * BQ;
    const float* dls = dl_s + st * BQ;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c = 8 * j + 2 * t4;                  // this lane's query columns c, c + 1
      const float2 lq = *reinterpret_cast<const float2*>(ls + c);
      const float2 dq = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = c + (e & 1), key = kw + gr + 8 * (e >> 1);
        float pv = exp2_fast(fmaf(s[j][e], sl2, -((e & 1) ? lq.y : lq.x) * LOG2E));
        if (edge && !(q0 + qc < L && kok[key - k0] && pair_ok(p, q0 + qc, key))) pv = 0.f;
        s[j][e] = pv;                                // P^T
        dp[j][e] = pv * (dp[j][e] - ((e & 1) ? dq.y : dq.x));   // dS^T
      }
    }
    unsigned pa[BQ / 16][4], da[BQ / 16][4];         // bf16(P^T), bf16(dS^T)
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      acc_to_a(pa[kq], s, kq);
      acc_to_a(da[kq], dp, kq);
    }
    reg_fence(pa);
    reg_fence(da);
    reg_fence(dv);
    reg_fence(dk);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      wgmma_rs<ND>(dv, pa[kq], desc_mn<BQ>(dOt, kq));   // dV += bf16(P^T) dO
      wgmma_rs<ND>(dk, da[kq], desc_mn<BQ>(Qt, kq));    // dK += bf16(dS^T) Q
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dv);
    reg_fence(dk);
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kw + gr + 8 * r;
    if (kj < L) {
      const long long off = (((long long)b * L + kj) * p.KH + kh) * D;
      bf16_t* dkp = static_cast<bf16_t*>(p.dk) + off;
      bf16_t* dvp = static_cast<bf16_t*>(p.dv) + off;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<unsigned*>(dkp + 8 * n + 2 * t4) =
            pack_bf16(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
        *reinterpret_cast<unsigned*>(dvp + 8 * n + 2 * t4) =
            pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}
template <int D> constexpr int dkdv_wgmma_smem() { return 1024 + 6 * 64 * D * 2 + 4 * 64 * 4 + 64; }

// ---------------------------------------------------------------------------
// backward 3/3: dQ.  grid (H, B, query tiles of 64), the last query tile
// first.  S = Q K^T and dP = dO V^T, then dQ += dS K with dS from registers.
// ---------------------------------------------------------------------------
template <int D, int BK>
__global__ void __launch_bounds__(MT, WgTiles<D>::QMB) dq_wgmma_kernel(const __grid_constant__ Params p) {
  constexpr int BQ = 64, KD = D / 16, NS = BK / 8, ND = D / 8;
  constexpr int TQ = BQ * D * 2, TK = BK * D * 2;    // tile bytes
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  const unsigned Qs = base, dOs = base + TQ, Ks = base + 2 * TQ, Vs = Ks + 2 * TK;  // K, V: 2 stages
  unsigned char* kok = smem_raw + (Vs + 2 * TK - raw);           // 2 x BK
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, L = p.L, H = p.H;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ, nq = min(BQ, L - q0);
  const int qw = q0 + 16 * warp;
  const int kh = h / (H / p.KH);
  const bf16_t* qp = static_cast<const bf16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16_t* gp = static_cast<const bf16_t*>(p.dout) + ((long long)b * L * H + h) * D;
  const bf16_t* kp = static_cast<const bf16_t*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16_t* vp = static_cast<const bf16_t*>(p.v) + b * p.v_sb + kh * p.v_sh;

  int k_lo, k_hi;
  key_range(p, q0, nq, &k_lo, &k_hi);
  const int k_first = (k_lo / BK) * BK;
  load_tile_sw<D, BQ>(Qs, qp + q0 * p.q_sl, p.q_sl, nq);
  load_tile_sw<D, BQ>(dOs, gp + (long long)q0 * H * D, (long long)H * D, nq);
  load_tile_sw<D, BK>(Ks, kp + k_first * p.k_sl, p.k_sl, min(BK, L - k_first));
  load_tile_sw<D, BK>(Vs, vp + k_first * p.v_sl, p.v_sl, min(BK, L - k_first));
  cp_async_commit();
  float lse2[2], dl[2];                              // rows gr, gr + 8 of the warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + gr + 8 * r;
    const long long at = ((long long)b * H + h) * L + qi;
    lse2[r] = qi < L ? p.lse[at] * LOG2E : 0.f;
    dl[r] = qi < L ? p.delta[at] : 0.f;
  }
  int pad = 0;
  if (tid < BK) {
    const bool ok = key_ok(p, b, k_first + tid);
    kok[tid] = ok;
    pad = !ok;
  }

  const float sl2 = p.scale * LOG2E;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int st = 0;
  for (int k0 = k_first; k0 < k_hi; k0 += BK) {
    cp_async_wait_all();
    fence_async_smem();
    const bool tile_pad = __syncthreads_or(pad);
    int ok_next = 1;
    if (k0 + BK < k_hi) {
      const int kn = k0 + BK, nk = min(BK, L - kn);
      load_tile_sw<D, BK>(Ks + (st ^ 1) * TK, kp + (long long)kn * p.k_sl, p.k_sl, nk);
      load_tile_sw<D, BK>(Vs + (st ^ 1) * TK, vp + (long long)kn * p.v_sl, p.v_sl, nk);
      cp_async_commit();
      if (tid < BK) ok_next = key_ok(p, b, kn + tid);
    }
    if (!all_masked<BQ, BK>(p, q0, k0)) {            // uniform in the block
      const unsigned Kt = Ks + st * TK, Vt = Vs + st * TK;
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      reg_fence(s);
      reg_fence(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wgmma_ss(s, desc_k<BQ>(Qs, kk), desc_k<BK>(Kt, kk));    // S = Q K^T
        wgmma_ss(dp, desc_k<BQ>(dOs, kk), desc_k<BK>(Vt, kk));  // dP = dO V^T
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      reg_fence(dp);
      const bool edge = tile_pad || on_edge<16, BK>(p, qw, k0);
      const unsigned char* ok = kok + st * BK;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
          float pv = exp2_fast(fmaf(s[j][e], sl2, -lse2[r]));
          if (edge && !(ok[c] && pair_ok(p, qw + gr + 8 * r, k0 + c))) pv = 0.f;
          s[j][e] = pv * (dp[j][e] - dl[r]);         // dS
        }
      unsigned da[BK / 16][4];                       // bf16(dS)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(da[kk], s, kk);
      reg_fence(da);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)           // dQ += bf16(dS) K
        wgmma_rs<ND>(acc, da[kk], desc_mn<BK>(Kt, kk));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
    }
    if (tid < BK) kok[(st ^ 1) * BK + tid] = ok_next;
    pad = !ok_next;
    st ^= 1;
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + gr + 8 * r;
    if (qi < L) {
      bf16_t* dqp = static_cast<bf16_t*>(p.dq) + (((long long)b * L + qi) * H + h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<unsigned*>(dqp + 8 * n + 2 * t4) =
            pack_bf16(acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
    }
  }
}
template <int D> constexpr int dq_wgmma_smem() {
  using t = WgTiles<D>;
  return 1024 + (2 * 64 + 4 * t::QBK) * D * 2 + 2 * t::QBK;
}

// dynamic shared memory of each kernel, bytes
template <int D> constexpr int fwd_smem() {
  using t = Tiles<D>;
  return (t::FQ * (D + 4) + 2 * t::FK * (D + 4) + t::FQ * (t::FK + 4) + t::FK) * 4;
}
template <int D> constexpr int dkdv_smem() {
  using t = Tiles<D>;
  return (2 * t::BK * (D + 4) + 2 * t::BQ * (D + 4) + 2 * t::BK * (t::BQ + 4) +
          t::BK + 2 * t::BQ) * 4;
}
template <int D> constexpr int dq_smem() {
  using t = Tiles<D>;
  return (2 * t::BQ * (D + 4) + 2 * t::BK * (D + 4) + t::BQ * (t::BK + 4) +
          t::BK + 2 * t::BQ) * 4;
}
static_assert(dkdv_smem<128>() <= 232448 && dq_smem<128>() <= 232448, "smem");
static_assert(dkdv_smem<256>() <= 232448 && dq_smem<256>() <= 232448, "smem");
static_assert(fwd_smem<256>() <= 232448, "smem");

// two blocks per SM at D 128 (228 KB per SM, 1 KB of it reserved per block)
static_assert(2 * (fwd_wgmma_smem<128>() + 1024) <= 233472 &&
              2 * (dkdv_wgmma_smem<128>() + 1024) <= 233472 &&
              2 * (dq_wgmma_smem<128>() + 1024) <= 233472, "smem");

template <typename Kernel>
cudaError_t launch(Kernel kern, dim3 grid, int threads, int smem, cudaStream_t st,
                   const Params& p) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// bf16 at D 64 / 128 runs the tensor-core kernels
template <typename T, int D> constexpr bool on_tensor_cores() {
  return std::is_same<T, bf16_t>::value && D != 256;
}

template <typename T, int D>
cudaError_t run_fwd(const Params& p, cudaStream_t st) {
  using t = Tiles<D>;
  if constexpr (on_tensor_cores<T, D>())
    return launch(fwd_wgmma_kernel<D, WgTiles<D>::FMI>,
                  dim3(p.H, p.B, ceil_div(p.L, 64 * WgTiles<D>::FMI)), MT, fwd_wgmma_smem<D>(),
                  st, p);
  else
    return launch(fwd_kernel<T, D, t::FQ, t::FK>, dim3(p.H, p.B, ceil_div(p.L, t::FQ)), NT,
                  fwd_smem<D>(), st, p);
}

template <typename T, int D>
cudaError_t run_bwd(const Params& p, cudaStream_t st) {
  using t = Tiles<D>;
  const long long rows = (long long)p.B * p.L * p.H;
  constexpr int rpb = delta_rows_per_block<T, D>();
  delta_kernel<T, D><<<(unsigned)((rows + rpb - 1) / rpb), NT, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (on_tensor_cores<T, D>()) {
    e = launch(dkdv_wgmma_kernel<D>, dim3(p.KH, p.B, ceil_div(p.L, 64)), MT,
               dkdv_wgmma_smem<D>(), st, p);
    if (e != cudaSuccess) return e;
    return launch(dq_wgmma_kernel<D, WgTiles<D>::QBK>, dim3(p.H, p.B, ceil_div(p.L, 64)), MT,
                  dq_wgmma_smem<D>(), st, p);
  } else {
    e = launch(dkdv_kernel<T, D, t::BQ, t::BK>, dim3(p.KH, p.B, ceil_div(p.L, t::BK)), NT,
               dkdv_smem<D>(), st, p);
    if (e != cudaSuccess) return e;
    return launch(dq_kernel<T, D, t::BQ, t::BK>, dim3(p.H, p.B, ceil_div(p.L, t::BQ)), NT,
                  dq_smem<D>(), st, p);
  }
}

template <typename T> struct Fwd {
  template <int D> static cudaError_t run(const Params& p, cudaStream_t st) { return run_fwd<T, D>(p, st); }
};
template <typename T> struct Bwd {
  template <int D> static cudaError_t run(const Params& p, cudaStream_t st) { return run_bwd<T, D>(p, st); }
};

// Registers, spills and shared memory of the kernel a call at (T, D) runs:
// which = 0 forward, 1 delta, 2 dK/dV, 3 dQ.
template <typename T> struct Info {
  template <int D> static cudaError_t run(int which, cudaFuncAttributes* a, int* smem) {
    using t = Tiles<D>;
    *smem = 0;
    if (which == 1) return cudaFuncGetAttributes(a, delta_kernel<T, D>);
    if constexpr (on_tensor_cores<T, D>()) {
      switch (which) {
        case 0: *smem = fwd_wgmma_smem<D>();
                return cudaFuncGetAttributes(a, fwd_wgmma_kernel<D, WgTiles<D>::FMI>);
        case 2: *smem = dkdv_wgmma_smem<D>(); return cudaFuncGetAttributes(a, dkdv_wgmma_kernel<D>);
        case 3: *smem = dq_wgmma_smem<D>();
                return cudaFuncGetAttributes(a, dq_wgmma_kernel<D, WgTiles<D>::QBK>);
      }
    } else {
      switch (which) {
        case 0: *smem = fwd_smem<D>(); return cudaFuncGetAttributes(a, fwd_kernel<T, D, t::FQ, t::FK>);
        case 2: *smem = dkdv_smem<D>();
                return cudaFuncGetAttributes(a, dkdv_kernel<T, D, t::BQ, t::BK>);
        case 3: *smem = dq_smem<D>(); return cudaFuncGetAttributes(a, dq_kernel<T, D, t::BQ, t::BK>);
      }
    }
    return cudaErrorInvalidValue;
  }
};

template <template <typename> class Op, typename... A>
cudaError_t by_type_and_dim(int d, int is_fp32, A... args) {
  if (is_fp32) {
    if (d == 64) return Op<float>::template run<64>(args...);
    if (d == 128) return Op<float>::template run<128>(args...);
    if (d == 256) return Op<float>::template run<256>(args...);
  } else {
    if (d == 64) return Op<bf16_t>::template run<64>(args...);
    if (d == 128) return Op<bf16_t>::template run<128>(args...);
    if (d == 256) return Op<bf16_t>::template run<256>(args...);
  }
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, const void* mask,
                   int B, int L, int H, int KH,
                   long long q_sb, long long q_sl, long long q_sh,
                   long long k_sb, long long k_sl, long long k_sh,
                   long long v_sb, long long v_sl, long long v_sh,
                   long long mask_sb, int causal, int window, float scale) {
  Params p = {};
  p.q = q; p.k = k; p.v = v;
  p.mask = static_cast<const unsigned char*>(mask);
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.mask_sb = mask_sb;
  p.B = B; p.L = L; p.H = H; p.KH = KH;
  p.causal = causal; p.window = window; p.scale = scale;
  return p;
}

}  // namespace

// Forward: out (B, L, H, D) contiguous in the input type, lse (B, H, L)
// fp32.  Strides in elements; returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    void* lse, int B, int L, int H, int KH, int D,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long mask_sb, int causal, int window, float scale, int is_fp32,
    void* stream) {
  Params p = make_params(q, k, v, mask, B, L, H, KH, q_sb, q_sl, q_sh, k_sb,
                         k_sl, k_sh, v_sb, v_sl, v_sh, mask_sb, causal, window,
                         scale);
  p.o_out = out;
  p.lse_out = static_cast<float*>(lse);
  return (int)by_type_and_dim<Fwd>(D, is_fp32, p, static_cast<cudaStream_t>(stream));
}

// Backward: dq (B, L, H, D), dk/dv (B, L, KH, D) contiguous in the input
// type; out and dout contiguous (B, L, H, D); lse and the delta scratch
// (B, H, L) fp32.  Launches the three backward kernels.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* mask,
    const void* out, const void* lse, const void* dout, void* dq, void* dk,
    void* dv, void* delta, int B, int L, int H, int KH, int D,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long mask_sb, int causal, int window, float scale, int is_fp32,
    void* stream) {
  Params p = make_params(q, k, v, mask, B, L, H, KH, q_sb, q_sl, q_sh, k_sb,
                         k_sl, k_sh, v_sb, v_sl, v_sh, mask_sb, causal, window,
                         scale);
  p.out = out;
  p.lse = static_cast<const float*>(lse);
  p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.delta = static_cast<float*>(delta);
  return (int)by_type_and_dim<Bwd>(D, is_fp32, p, static_cast<cudaStream_t>(stream));
}

// Registers, local-memory (spill) bytes and dynamic shared memory of the
// kernel that a call at (D, dtype) runs: which = 0 forward, 1 delta,
// 2 dK/dV, 3 dQ.
extern "C" int flash_attention_kernel_info(int which, int D, int is_fp32,
                                           int* regs, int* local_bytes,
                                           int* smem_bytes) {
  cudaFuncAttributes a;
  int smem = 0;
  const cudaError_t e = by_type_and_dim<Info>(D, is_fp32, which, &a, &smem);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = smem + (int)a.sharedSizeBytes;
  return 0;
}
