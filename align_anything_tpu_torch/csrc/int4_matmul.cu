// W4A16 matmul for Hopper (sm_90a): out (M, N) = x (M, K) @ dequant(values, scales).
//
// Replaces the Pallas TPU kernels ops/int4_matmul.py:_int4_matmul_2d and
// _int4_matmul_2d_indexed of the JAX package (the layer-indexed variant is
// this kernel called on the contiguous view values[li]).
//
// Semantics, identical to the TPU kernel's:
//   * x is bf16;
//   * values (G, gs/2, N) int8, split-half packed: packed row r of group g
//     holds weight row g*gs + r in its low nibble and row g*gs + r + gs/2 in
//     its high nibble, both signed 4-bit;
//   * scales (G, N) fp32; the dequantized weight is (q * scale) in fp32,
//     rounded to bf16;
//   * bf16 x bf16 products accumulate in fp32; the result is stored in the
//     caller's dtype (bf16 or fp32).
//
// What bounds it on the H100: at decode sizes (M <= 32) the call is bound by
// the weight bytes it reads, about 4.5 bits per weight with the fp32 scales
// (K*N/2 packed bytes + 4*K*N/gs scale bytes); the arithmetic is a few
// FLOPs per byte, far below the card's ratio.  The design therefore reads
// each packed byte from device memory exactly once per M-tile and never
// writes a dequantized weight:
//   * N is the contiguous dim of values and scales, so a warp covers 128
//     neighbouring columns and each thread loads one 32-bit word (4 columns)
//     per packed row: 128-byte coalesced rows;
//   * the 8 warps of a block split the packed rows (the K dim) between them
//     and are summed in shared memory at the end, so a block keeps 8 warps of
//     loads in flight over one 128-column tile;
//   * x is staged in shared memory chunk by chunk as fp32 pairs
//     (x[k], x[k + gs/2]) matching the two nibbles of a byte, so each byte
//     costs one broadcast 64-bit shared load per row of M and two FMAs per
//     nibble pair;
//   * M is tiled by up to 16 rows per block (grid x), and the M-tiles of one
//     column tile are neighbours in launch order so they share the packed
//     tile through L2.
// At M of 64 and more the CUDA-core FMAs, not the bytes, become the limit;
// tensor-core MMA (wgmma), TMA pipelining and split-K are later work.
//
// The kernel is templated on the per-element dequantization, so that the
// A/B variants of scripts/bench/bench_int4_kernel_ab.py (the Pallas kernels
// _kernel_v1 and _kernel_v2 behind run_variant and run_v2) run on the same
// skeleton and differ from K2 only in the unpack arithmetic:
//   * V0, K2 itself: sign-extended nibbles, w = bf16(q * s), s fp32;
//   * V1: w = bf16(q * bf16(s)), the scale rounded to bf16 first;
//   * V2: offset-low packing, the low nibble holds q + 8 and is read with one
//     AND, the high nibble is signed; w_low = bf16((q + 8) * bf16(s)),
//     w_high = bf16(q * bf16(s)), and the -8 correction, computed outside the
//     kernel as in run_v2, is added to the sum before the store.
// The TPU kernel of V2 takes x split into its low and high group halves
// (split_x), because Mosaic cannot shape-cast the lane dim; here the staged
// (x[k], x[k + gs/2]) pairs already line up with a byte's two nibbles, so V2
// takes x as it is.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (align_anything_tpu_torch/ops/int4_matmul.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;                   // columns per thread (one 32-bit word)
constexpr int kTileN = 32 * kCols;         // columns per block
constexpr int kChunk = 256;                // packed rows staged per pass

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

enum Variant { kV0 = 0, kV1 = 1, kV2 = 2 };

// The two dequantized weights of one packed byte (sign-extended to an int)
// with its group's fp32 scale s.  V0 and V1 sign-extend the low nibble; V2
// stores q + 8 there and reads it with one AND.  The high nibble is signed
// in all three.  V1 and V2 round s to bf16 here, once per byte and column,
// where the TPU kernels round a block of groups' scales once: rounding once
// per group instead, with the rounded scales carried across a warp's rows,
// took 196 registers for 127 at the 16-row M tile and ran up to 1.6x
// slower (PERF.md), so the conversion per byte is the cheaper one here.
template <int V>
__device__ __forceinline__ void dequant(int byte, float s, float& wl, float& wh) {
  const int lo = V == kV2 ? (byte & 15)
                          : static_cast<int>(static_cast<unsigned>(byte) << 28) >> 28;
  const float sv = V == kV0 ? s : bf16_round(s);
  wl = bf16_round((float)lo * sv);
  wh = bf16_round((float)(byte >> 4) * sv);
}

template <int V, int MT, typename OutT>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,   // (M, K)
                   const int8_t* __restrict__ values,     // (K/2, N)
                   const float* __restrict__ scales,      // (G, N)
                   const float* __restrict__ corr,        // (M, N), V2 only
                   OutT* __restrict__ out,                // (M, N)
                   int M, int K, int N, int half, int vec) {
  // one buffer, used first for the staged x pairs, then for the cross-warp sum
  constexpr int kSmem = cmax(kChunk * MT * 2, (kWarps / 2) * MT * kTileN);
  __shared__ __align__(16) float smem[kSmem];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * kTileN + lane * kCols;
  const int rows = K / 2;
  const int gs = 2 * half;
  const bool col_ok = n0 < N;

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  for (int p0 = 0; p0 < rows; p0 += kChunk) {
    // stage x[m0 + m][k_lo(p)], x[m0 + m][k_lo(p) + half] for the chunk's rows
    for (int i = threadIdx.x; i < kChunk * MT; i += kThreads) {
      const int m = i % MT;
      const int p = p0 + i / MT;
      float lo = 0.f, hi = 0.f;
      if (p < rows && m0 + m < M) {
        const int k = (p / half) * gs + (p % half);
        const __nv_bfloat16* xr = x + (size_t)(m0 + m) * K;
        lo = __bfloat162float(xr[k]);
        hi = __bfloat162float(xr[k + half]);
      }
      smem[2 * i] = lo;
      smem[2 * i + 1] = hi;
    }
    __syncthreads();

    const int pend = min(kChunk, rows - p0);
    if (col_ok) {
      const float2* xs = reinterpret_cast<const float2*>(smem);
#pragma unroll 2
      for (int pl = warp; pl < pend; pl += kWarps) {
        const int p = p0 + pl;
        const int g = p / half;
        int bytes[kCols];
        float s[kCols];
        if (vec) {
          const int word = *reinterpret_cast<const int*>(values + (size_t)p * N + n0);
          const float4 sv = *reinterpret_cast<const float4*>(scales + (size_t)g * N + n0);
#pragma unroll
          for (int j = 0; j < kCols; ++j)  // byte j, sign-extended
            bytes[j] = static_cast<int>(static_cast<unsigned>(word) << (24 - 8 * j)) >> 24;
          s[0] = sv.x; s[1] = sv.y; s[2] = sv.z; s[3] = sv.w;
        } else {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const bool ok = n0 + j < N;
            bytes[j] = ok ? (int)values[(size_t)p * N + n0 + j] : 0;
            s[j] = ok ? scales[(size_t)g * N + n0 + j] : 0.f;
          }
        }
        float wl[kCols], wh[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) dequant<V>(bytes[j], s[j], wl[j], wh[j]);
        const float2* xp = xs + pl * MT;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 xv = xp[m];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            acc[m][j] = fmaf(xv.x, wl[j], acc[m][j]);
            acc[m][j] = fmaf(xv.y, wh[j], acc[m][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // sum the warps' partial tiles: a fixed tree, so results are deterministic
  for (int active = kWarps / 2; active > 0; active >>= 1) {
    if (warp >= active && warp < 2 * active) {
      float* dst = smem + (size_t)(warp - active) * MT * kTileN + lane * kCols;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        *reinterpret_cast<float4*>(dst + m * kTileN) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
    __syncthreads();
    if (warp < active) {
      const float* src = smem + (size_t)warp * MT * kTileN + lane * kCols;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(src + m * kTileN);
        acc[m][0] += v.x;
        acc[m][1] += v.y;
        acc[m][2] += v.z;
        acc[m][3] += v.w;
      }
    }
    __syncthreads();
  }

  if (warp == 0 && col_ok) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m >= M) break;
      OutT* o = out + (size_t)(m0 + m) * N + n0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (n0 + j < N) {
          if constexpr (V == kV2)
            store_out(o + j, acc[m][j] + corr[(size_t)(m0 + m) * N + n0 + j]);
          else
            store_out(o + j, acc[m][j]);
        }
      }
    }
  }
}

template <int V, int MT, typename OutT>
void launch(const void* x, const void* values, const void* scales, const void* corr,
            void* out, int M, int K, int N, int half, int vec, cudaStream_t stream) {
  const dim3 grid((M + MT - 1) / MT, (N + kTileN - 1) / kTileN);
  int4_matmul_kernel<V, MT, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(values),
      static_cast<const float*>(scales), static_cast<const float*>(corr),
      static_cast<OutT*>(out), M, K, N, half, vec);
}

template <int V, typename OutT>
void dispatch(const void* x, const void* values, const void* scales, const void* corr,
              void* out, int M, int K, int N, int half, int vec, cudaStream_t stream) {
  // the smallest power-of-two M tile that covers M, at most 16 rows
  if (M >= 9) launch<V, 16, OutT>(x, values, scales, corr, out, M, K, N, half, vec, stream);
  else if (M >= 5) launch<V, 8, OutT>(x, values, scales, corr, out, M, K, N, half, vec, stream);
  else if (M >= 3) launch<V, 4, OutT>(x, values, scales, corr, out, M, K, N, half, vec, stream);
  else if (M == 2) launch<V, 2, OutT>(x, values, scales, corr, out, M, K, N, half, vec, stream);
  else launch<V, 1, OutT>(x, values, scales, corr, out, M, K, N, half, vec, stream);
}

}  // namespace

extern "C" {

// x (M, K) bf16, values (K/2, N) int8, scales (K/(2*half), N) fp32, out (M, N)
// fp32 when out_f32 else bf16; all contiguous.  vec: N % 4 == 0 and values /
// scales 4- / 16-byte aligned, so a thread may load 4 columns at once.
// Returns cudaGetLastError() after the launch (0 = launched).
int int4_matmul_launch(const void* x, const void* values, const void* scales,
                       void* out, int M, int K, int N, int half, int out_f32,
                       int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    dispatch<kV0, float>(x, values, scales, nullptr, out, M, K, N, half, vec, s);
  else
    dispatch<kV0, __nv_bfloat16>(x, values, scales, nullptr, out, M, K, N, half, vec, s);
  return static_cast<int>(cudaGetLastError());
}

// The A/B variant V1: arguments as int4_matmul_launch, out bf16.
int int4_matmul_v1_launch(const void* x, const void* values, const void* scales,
                          void* out, int M, int K, int N, int half, int vec,
                          void* stream) {
  dispatch<kV1, __nv_bfloat16>(x, values, scales, nullptr, out, M, K, N, half, vec,
                               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The A/B variant V2: values in the offset-low packing, corr (M, N) fp32
// contiguous (the -8 correction, added to each sum), out bf16.
int int4_matmul_v2_launch(const void* x, const void* values, const void* scales,
                          const void* corr, void* out, int M, int K, int N,
                          int half, int vec, void* stream) {
  dispatch<kV2, __nv_bfloat16>(x, values, scales, corr, out, M, K, N, half, vec,
                               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
