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
// What bounds it on the H100: causal attention does 2*B*H*L^2*D FLOPs
// forward (4*D per visible (q, k) pair) and 2.5x that backward, against
// q/k/v/o bytes that are O(B*L*H*D): at L = 1024, D = 128 the forward is
// 34 GFLOP for 84 MB, about 35 us at 989 TFLOP/s (bf16 tensor cores)
// against 25 us at 3.35 TB/s, so it is bound by operations.  The design
// keeps S = QK^T and P out of device memory (online softmax over key
// tiles, fp32 accumulators in registers, tiles in shared memory) so that
// device memory sees each input once per tile pass.  This first version
// runs the products on CUDA cores in fp32 (exact for bf16 inputs), one
// 256-thread block per (query tile, head) for the forward and dQ and per
// (key tile, KV head) for dK/dV, each thread owning a 4x4-style register
// tile; tensor-core MMA (mma.sync / wgmma) and TMA are the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// backward 1/3: delta[b, h, l] = sum_d dO * O; one warp per (b, l, h) row
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT) delta_kernel(const __grid_constant__ Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (NT / 32) + warp;
  if (row >= (long long)p.B * p.L * p.H) return;
  const T* o = static_cast<const T*>(p.out) + row * D;
  const T* g = static_cast<const T*>(p.dout) + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(Cvt<T>::to_f(o[d]), Cvt<T>::to_f(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = row % p.H, bl = row / p.H;
    const long long l = bl % p.L, b = bl / p.L;
    p.delta[(b * p.H + h) * p.L + l] = acc;
  }
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

template <typename Kernel>
cudaError_t launch(Kernel kern, dim3 grid, int smem, cudaStream_t st, const Params& p) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, NT, smem, st>>>(p);
  return cudaGetLastError();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int D>
cudaError_t run_fwd(const Params& p, cudaStream_t st) {
  using t = Tiles<D>;
  return launch(fwd_kernel<T, D, t::FQ, t::FK>,
                dim3(p.H, p.B, ceil_div(p.L, t::FQ)), fwd_smem<D>(), st, p);
}

template <typename T, int D>
cudaError_t run_bwd(const Params& p, cudaStream_t st) {
  using t = Tiles<D>;
  const long long rows = (long long)p.B * p.L * p.H;
  delta_kernel<T, D><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch(dkdv_kernel<T, D, t::BQ, t::BK>,
             dim3(p.KH, p.B, ceil_div(p.L, t::BK)), dkdv_smem<D>(), st, p);
  if (e != cudaSuccess) return e;
  return launch(dq_kernel<T, D, t::BQ, t::BK>,
                dim3(p.H, p.B, ceil_div(p.L, t::BQ)), dq_smem<D>(), st, p);
}

template <typename T> struct Fwd {
  template <int D> static cudaError_t run(const Params& p, cudaStream_t st) { return run_fwd<T, D>(p, st); }
};
template <typename T> struct Bwd {
  template <int D> static cudaError_t run(const Params& p, cudaStream_t st) { return run_bwd<T, D>(p, st); }
};

template <template <typename> class Op>
cudaError_t by_type_and_dim(int d, int is_fp32, const Params& p, cudaStream_t st) {
  if (is_fp32) {
    if (d == 64) return Op<float>::template run<64>(p, st);
    if (d == 128) return Op<float>::template run<128>(p, st);
    if (d == 256) return Op<float>::template run<256>(p, st);
  } else {
    if (d == 64) return Op<bf16_t>::template run<64>(p, st);
    if (d == 128) return Op<bf16_t>::template run<128>(p, st);
    if (d == 256) return Op<bf16_t>::template run<256>(p, st);
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

// Registers, local-memory (spill) bytes and dynamic shared memory of one
// kernel: which = 0 forward, 1 delta, 2 dK/dV, 3 dQ.
extern "C" int flash_attention_kernel_info(int which, int D, int is_fp32,
                                           int* regs, int* local_bytes,
                                           int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaErrorInvalidValue;
  int smem = 0;
#define AAT_INFO(T, DD)                                                        \
  if (D == DD) {                                                               \
    using t = Tiles<DD>;                                                       \
    switch (which) {                                                           \
      case 0: e = cudaFuncGetAttributes(&a, fwd_kernel<T, DD, t::FQ, t::FK>);  \
              smem = fwd_smem<DD>(); break;                                    \
      case 1: e = cudaFuncGetAttributes(&a, delta_kernel<T, DD>); break;       \
      case 2: e = cudaFuncGetAttributes(&a, dkdv_kernel<T, DD, t::BQ, t::BK>); \
              smem = dkdv_smem<DD>(); break;                                   \
      case 3: e = cudaFuncGetAttributes(&a, dq_kernel<T, DD, t::BQ, t::BK>);   \
              smem = dq_smem<DD>(); break;                                     \
    }                                                                          \
  }
  if (is_fp32) {
    AAT_INFO(float, 64) AAT_INFO(float, 128) AAT_INFO(float, 256)
  } else {
    AAT_INFO(bf16_t, 64) AAT_INFO(bf16_t, 128) AAT_INFO(bf16_t, 256)
  }
#undef AAT_INFO
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = smem + (int)a.sharedSizeBytes;
  return 0;
}
