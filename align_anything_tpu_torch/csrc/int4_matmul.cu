// K2, the W4A16 matmul for Hopper (sm_90a): out (M, N) = x (M, K) @
// dequant(values, scales), and the A/B variants V1 and V2 of it.
//
// K2 replaces the Pallas TPU kernels _int4_matmul_2d and
// _int4_matmul_2d_indexed of align_anything_tpu/ops/int4_matmul.py (the
// layer-indexed one is this kernel called on the contiguous view
// values[li]).  Semantics, identical to the TPU kernel's:
//   * x is bf16;
//   * values (G, gs/2, N) int8, split-half packed: packed row r of group g
//     holds weight row g*gs + r in its low nibble and row g*gs + r + gs/2 in
//     its high nibble, both signed 4-bit;
//   * scales (G, N) fp32; the dequantized weight is (q * scale) in fp32,
//     rounded to bf16;
//   * bf16 x bf16 products accumulate in fp32; the result is stored in the
//     caller's dtype (bf16 or fp32).
//
// What bounds it on the H100: at decode sizes (M <= 32) the bytes it must
// read, about 4.5 bits per weight with the fp32 scales (K*N/2 packed bytes
// + 4*K*N/gs scale bytes).  2*M*K*N products at M 32 are 128 FLOPs per
// packed byte, below the 295 per byte at which the bf16 tensor cores would
// be the limit.  K2's first, CUDA-core kernel was held far from that bound
// by occupancy (64 to 96 blocks for 132 SMs at the layer shapes) and by
// fp32 FMAs, with each weight dequantized once per 16-row M tile.  So K2
//   * cuts K into S ranges of whole groups, a third grid dimension (S from
//     split_plan in ops/int4_matmul.py: about two blocks per SM).  With
//     S > 1 each split writes fp32 partial sums to a workspace (S, M, N)
//     that the wrapper allocates, and split_sum_kernel adds them in the
//     order s = 0 .. S-1 and casts: two launches give the same bits, and
//     no atomic touches the output.  With S = 1 the kernel stores the
//     output itself;
//   * multiplies on the tensor cores, mma.sync m16n8k16 bf16 -> fp32.  A is
//     x, staged in shared memory as bf16 per chunk of kSteps k16-steps and
//     read with ldmatrix; rows >= M are zero.  B is built in registers: a
//     thread loads one 32-bit word (4 neighbouring columns) from each of
//     the four packed rows its fragment needs (2t, 2t+1, 2t+8, 2t+9 of a
//     16-row step), and each nibble is sign-extended, scaled in fp32 and
//     rounded to bf16 exactly as dequant<kV0> does.  The low nibbles of
//     packed rows r..r+15 of group g meet x[:, g*gs + r ..], the high
//     nibbles x[:, g*gs + gs/2 + r ..], so each byte is unpacked once and
//     feeds two MMAs.  The n index i of a warp's n8 tile j stands for
//     column 4*(i*kWarps + warp) + j of the block's tile, so a thread's
//     bytes are one word, its outputs two runs of 4 columns, and each load
//     of a warp touches every sector of the 128-byte lines it reads (the
//     other warps of the block read the rest of those lines, from L1);
//   * takes M <= 16 as one m16 tile and M 17-32 as two m16 tiles in one
//     block, which share every B fragment: a weight is dequantized once per
//     32 rows.  Larger M is tiled over the grid, 32 rows per block;
//   * masks ragged N and M at load and store.  A group whose half is not a
//     multiple of 16 runs the same loop with each k16 step's tail masked to
//     zero on both operands (kTail); the serving path's groups of 64 and
//     128 never do.
// There is no cp.async, TMA or wgmma yet.  Loads are plain and run one
// batch ahead: the bytes of the next kAhead k16-steps are in flight while
// the MMAs of the current kAhead run, the first batch of a chunk while its
// x is being staged.  What bounds it now (scripts/bench/k2_sweep.py on an
// H100): those loads, which alone take 2.5x the bytes' time at the fused
// gate/up shape (few bytes in flight per warp, 4-byte loads), then the
// dequantization (4 ALU operations per weight); the MMAs cost nothing
// measurable.
//
// V1 and V2, the A/B variants of scripts/bench/bench_int4_kernel_ab.py, run
// K2's earlier CUDA-core kernel (int4_matmul_kernel below, K2 before its
// tensor-core redesign), kept unchanged for the A/B.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (align_anything_tpu_torch/ops/int4_matmul.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The CUDA-core kernel, the A/B variants' skeleton.  N is the contiguous
// dim, so a warp covers 128 neighbouring columns and each thread loads one
// 32-bit word (4 columns) per packed row; the 8 warps of a block split the
// packed rows and are summed in shared memory at the end; x is staged as
// fp32 pairs (x[k], x[k + gs/2]) matching a byte's two nibbles; M is tiled
// by up to 16 rows per block.  The kernel is templated on the per-element
// dequantization:
//   * V0: sign-extended nibbles, w = bf16(q * s), s fp32 (K2's arithmetic,
//     which the tensor-core kernel repeats; no longer instantiated);
//   * V1: w = bf16(q * bf16(s)), the scale rounded to bf16 first;
//   * V2: offset-low packing, the low nibble holds q + 8 and is read with one
//     AND, the high nibble is signed; w_low = bf16((q + 8) * bf16(s)),
//     w_high = bf16(q * bf16(s)), and the -8 correction, computed outside the
//     kernel as in run_v2, is added to the sum before the store.
// The TPU kernel of V2 takes x split into its low and high group halves
// (split_x), because Mosaic cannot shape-cast the lane dim; here the staged
// (x[k], x[k + gs/2]) pairs already line up with a byte's two nibbles, so V2
// takes x as it is.

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

// ---------------------------------------------------------------------------
// K2: split-K over whole groups, bf16 mma.sync on B fragments dequantized in
// registers (see the note at the top).

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = 4;                      // n8 tiles per warp: one 32-bit word a row
constexpr int kTileN = kWarps * 8 * kNT;    // columns per block
constexpr int kTileM = 32;                  // rows per block: at most two m16 tiles
constexpr int kSteps = 16;                  // k16 steps of x staged per pass
constexpr int kAhead = 4;                   // steps whose bytes are loaded before use
// bf16 per staged row of x: a step's low and high k16 slices side by side,
// +16 bytes so that ldmatrix's 8 rows fall in distinct banks
constexpr int kXStride = kSteps * 32 + 8;

// fp32 value of the signed nibble in the low 4 bits of v: 2^23 + (nibble ^ 8)
// as a float, less 2^23 + 8 (exact)
__device__ __forceinline__ float nibble(uint32_t v) {
  return __int_as_float(static_cast<int>((v & 0xFu) ^ 0x4B000008u)) - 8388616.f;
}

// bf16(a) in the low half, bf16(b) in the high half (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage x's rows m0 .. m0 + 16*MT - 1 for the nst k16-steps from step c0:
// xs[r][j*32 + 0..15] = x[m0 + r][g*gs + rr*16 + 0..15] (the low slice of
// step c0 + j = (group g, step rr of the group)) and xs[r][j*32 + 16..31]
// the same columns + gs/2 (the high slice); zero outside M and, with kTail,
// past the group's half.  Without kTail a thread keeps one 16-byte piece
// position of a row (step j, slice, half of the slice) and copies it for
// every kThreads/64-th row, kBatch rows' loads in flight at a time.
template <int MT, bool kTail>
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, const __nv_bfloat16* __restrict__ x,
                                        int M, int K, int half, int spg, int m0, int c0,
                                        int nst) {
  constexpr int kRows = 16 * MT;
  if constexpr (!kTail) {
    constexpr int kPieces = kSteps * 4;          // 16-byte pieces per staged row
    static_assert(kThreads % kPieces == 0, "a thread keeps one piece position");
    constexpr int kRowStep = kThreads / kPieces;
    constexpr int kPasses = kRows / kRowStep;    // rows per thread
    constexpr int kBatch = kPasses < 8 ? kPasses : 8;
    const int pc = threadIdx.x % kPieces, r0 = threadIdx.x / kPieces;
    const int j = pc >> 2, part = (pc >> 1) & 1, e = (pc & 1) * 8;
    const int st = c0 + j, g = st / spg, rr = st - g * spg;
    const __nv_bfloat16* src = x + (size_t)g * 2 * half + part * half + rr * 16 + e;
    __nv_bfloat16* dst = xs + j * 32 + part * 16 + e;
#pragma unroll
    for (int p0 = 0; p0 < kPasses; p0 += kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        const int r = r0 + (p0 + p) * kRowStep;
        v[p] = make_uint4(0u, 0u, 0u, 0u);
        if (j < nst && m0 + r < M)
          v[p] = *reinterpret_cast<const uint4*>(src + (size_t)(m0 + r) * K);
      }
#pragma unroll
      for (int p = 0; p < kBatch; ++p)
        *reinterpret_cast<uint4*>(dst + (r0 + (p0 + p) * kRowStep) * kXStride) = v[p];
    }
  } else {
    const int elems = nst * 32;
    for (int i = threadIdx.x; i < kRows * elems; i += kThreads) {
      const int r = i / elems, c = i - r * elems;
      const int j = c >> 5, part = (c >> 4) & 1, e = c & 15;
      const int st = c0 + j, g = st / spg, rr = st - g * spg;
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (m0 + r < M && rr * 16 + e < half)
        v = x[(size_t)(m0 + r) * K + (size_t)g * 2 * half + part * half + rr * 16 + e];
      xs[r * kXStride + c] = v;
    }
  }
}

// The packed bytes of one k16 step (group g, step rr of the group) that this
// thread's B fragments need: w[i] = the word at columns col .. col + 3 of
// packed row rr*16 + {2t, 2t+1, 2t+8, 2t+9}[i] of the group; s = the
// group's scales of those columns.  Zero where masked.
template <bool kTail, bool kVec>
__device__ __forceinline__ void load_step(uint32_t (&w)[4], float (&s)[kNT],
                                          const int8_t* __restrict__ values,
                                          const float* __restrict__ scales, int N, int half,
                                          int g, int rr, int col, int tig) {
  const int r0 = rr * 16;
  const size_t prow = (size_t)g * half + r0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 2 * tig + (i & 1) + (i >> 1) * 8;
    const bool row_ok = !kTail || r0 + r < half;
    const int8_t* src = values + (prow + r) * N + col;
    uint32_t v = 0u;
    if constexpr (kVec) {
      if (row_ok && col < N) v = __ldg(reinterpret_cast<const unsigned int*>(src));
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (row_ok && col + b < N)
          v |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * b);
    }
    w[i] = v;
  }
  const float* srow = scales + (size_t)g * N + col;
  if constexpr (kVec) {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < N) f = __ldg(reinterpret_cast<const float4*>(srow));
    s[0] = f.x; s[1] = f.y; s[2] = f.z; s[3] = f.w;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) s[b] = col + b < N ? __ldg(srow + b) : 0.f;
  }
}

// One k16 step: A from the staged x (step j of the chunk), B from the
// loaded bytes, both slices into every accumulator tile.
template <int MT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][kNT][4],
                                         const uint32_t (&w)[4],
                                         const float (&s)[kNT], const __nv_bfloat16* xs,
                                         int j, int lane) {
  uint32_t alo[MT][4], ahi[MT][4];
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = j * 32 + (lane >> 4) * 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const __nv_bfloat16* p = xs + (mt * 16 + arow) * kXStride + acol;
    ldmatrix_x4(alo[mt], p);
    ldmatrix_x4(ahi[mt], p + 16);
  }
#pragma unroll
  for (int jn = 0; jn < kNT; ++jn) {
    const int sh = 8 * jn;  // byte jn of each word: tile jn's column
    uint32_t blo[2], bhi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows (2t, 2t+1), then (2t+8, 2t+9)
      const uint32_t ra = w[2 * h] >> sh, rb = w[2 * h + 1] >> sh;
      blo[h] = pack_bf16(nibble(ra) * s[jn], nibble(rb) * s[jn]);
      bhi[h] = pack_bf16(nibble(ra >> 4) * s[jn], nibble(rb >> 4) * s[jn]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][jn], alo[mt], blo);
      mma_bf16(acc[mt][jn], ahi[mt], bhi);
    }
  }
}

// Store the 4 neighbouring values v of one row at columns c .. c + 3
// (masked to N).
template <bool kVec, typename T>
__device__ __forceinline__ void store4(T* row, int c, int N, const float (&v)[4]) {
  if constexpr (kVec) {
    if (c >= N) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(row + c) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                      *reinterpret_cast<const uint32_t*>(&hi));
    }
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (c + b < N) store_out(row + c + b, v[b]);
  }
}

template <int MT, bool kTail, bool kVec, typename OutT>
__global__ void __launch_bounds__(kThreads)
k2_mma_kernel(const __nv_bfloat16* __restrict__ x,   // (M, K)
              const int8_t* __restrict__ values,     // (K/2, N)
              const float* __restrict__ scales,      // (G, N)
              OutT* __restrict__ out,                // (M, N), when ws is null
              float* __restrict__ ws,                // (S, M, N) or null
              int M, int K, int N, int half) {
  __shared__ __align__(16) __nv_bfloat16 xs[16 * MT * kXStride];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kTileM;
  const int groups = K / (2 * half);
  const int spg = (half + 15) / 16;  // k16 steps per group
  // this split's groups [g_lo, g_hi), as split_ranges in ops/int4_matmul.py
  const int g_lo = (int)((long long)blockIdx.z * groups / gridDim.z);
  const int g_hi = (int)((long long)(blockIdx.z + 1) * groups / gridDim.z);
  const int st_hi = g_hi * spg;
  // n index i of a warp's n8 tile j stands for the column n0 + 4*(i*kWarps
  // + warp) + j: a thread's bytes are one word, and the warps of a block
  // share every 128-byte line of the packed rows, each load touching all of
  // its sectors
  const int n0 = blockIdx.y * kTileN;
  const int col = n0 + 4 * (gid * kWarps + warp);  // the columns of this thread's bytes

  float acc[MT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][jn][e] = 0.f;

  // the bytes of kAhead steps are loaded one batch ahead of the MMAs that
  // use them; the first batch of a chunk while its x is being staged
  uint32_t w[2][kAhead][4];
  float s[2][kAhead][kNT];
  int g = g_lo, rr = 0;  // the next step to load
  for (int c0 = g_lo * spg; c0 < st_hi; c0 += kSteps) {
    const int nst = min(kSteps, st_hi - c0);
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (u < nst) {
        load_step<kTail, kVec>(w[0][u], s[0][u], values, scales, N, half, g, rr, col, tig);
        if (++rr == spg) { rr = 0; ++g; }
      }
    __syncthreads();  // every warp is done with the previous chunk's x
    stage_x<MT, kTail>(xs, x, M, K, half, spg, m0, c0, nst);
    __syncthreads();
    for (int j0 = 0; j0 < nst; j0 += 2 * kAhead) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {  // batch j0 + b*kAhead in buffer b
        const int jb = j0 + b * kAhead;
        if (jb >= nst) break;
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          if (jb + kAhead + u < nst) {
            load_step<kTail, kVec>(w[b ^ 1][u], s[b ^ 1][u], values, scales, N, half, g, rr,
                                   col, tig);
            if (++rr == spg) { rr = 0; ++g; }
          }
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          if (jb + u < nst) mma_step<MT>(acc, w[b][u], s[b][u], xs, jb + u, lane);
      }
    }
  }

  // thread (gid, tig) holds rows gid, gid + 8 of each m16 tile: c0/c2 of
  // tile jn at n index 2*tig, c1/c3 at 2*tig + 1
  const int c_even = n0 + 4 * (2 * tig * kWarps + warp);
  const int c_odd = c_even + 4 * kWarps;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mt * 16 + gid + h * 8;
      if (m >= M) continue;
      float even[kNT], odd[kNT];
#pragma unroll
      for (int jn = 0; jn < kNT; ++jn) {
        even[jn] = acc[mt][jn][2 * h];
        odd[jn] = acc[mt][jn][2 * h + 1];
      }
      if (ws != nullptr) {
        float* row = ws + ((size_t)blockIdx.z * M + m) * N;
        store4<kVec>(row, c_even, N, even);
        store4<kVec>(row, c_odd, N, odd);
      } else {
        store4<kVec>(out + (size_t)m * N, c_even, N, even);
        store4<kVec>(out + (size_t)m * N, c_odd, N, odd);
      }
    }
  }
}

template <int MT, bool kTail, bool kVec, typename OutT>
void launch(const void* x, const void* values, const void* scales, void* out, float* ws,
            int splits, int M, int K, int N, int half, cudaStream_t stream) {
  const dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN, splits);
  k2_mma_kernel<MT, kTail, kVec, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(values),
      static_cast<const float*>(scales), static_cast<OutT*>(out), ws, M, K, N, half);
}

template <int MT, typename OutT>
void dispatch_tail(const void* x, const void* values, const void* scales, void* out,
                   float* ws, int splits, int M, int K, int N, int half, int vec,
                   cudaStream_t stream) {
  const bool tail = half % 16 != 0;
  if (tail && vec)
    launch<MT, true, true, OutT>(x, values, scales, out, ws, splits, M, K, N, half, stream);
  else if (tail)
    launch<MT, true, false, OutT>(x, values, scales, out, ws, splits, M, K, N, half, stream);
  else if (vec)
    launch<MT, false, true, OutT>(x, values, scales, out, ws, splits, M, K, N, half, stream);
  else
    launch<MT, false, false, OutT>(x, values, scales, out, ws, splits, M, K, N, half, stream);
}

// out = the sum of the S partial sums ws (S, M*N), taken in the order
// s = 0 .. S-1 for every element, so that two launches give the same bits
template <typename OutT>
__global__ void split_sum_kernel(const float* __restrict__ ws, OutT* __restrict__ out,
                                 int splits, long long mn) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = ws[i];
    for (int s = 1; s < splits; ++s) acc += ws[s * mn + i];
    store_out(out + i, acc);
  }
}

template <typename OutT>
void k2(const void* x, const void* values, const void* scales, void* out, void* ws,
        int splits, int M, int K, int N, int half, int vec, cudaStream_t stream) {
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  if (M <= 16)
    dispatch_tail<1, OutT>(x, values, scales, out, w, splits, M, K, N, half, vec, stream);
  else
    dispatch_tail<2, OutT>(x, values, scales, out, w, splits, M, K, N, half, vec, stream);
  if (splits > 1) {
    constexpr int kSumThreads = 256;
    const long long mn = (long long)M * N;
    const long long blocks = (mn + kSumThreads - 1) / kSumThreads;
    split_sum_kernel<OutT><<<(int)(blocks < 4096 ? blocks : 4096), kSumThreads, 0, stream>>>(
        w, static_cast<OutT*>(out), splits, mn);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// K2.  x (M, K) bf16, values (K/2, N) int8, scales (K/(2*half), N) fp32,
// out (M, N) fp32 when out_f32 else bf16; all contiguous, x 16-byte
// aligned.  vec: N % 4 == 0 and values / scales 4- / 16-byte aligned, so a
// thread may load 4 columns at once.  splits: K is cut into that many
// ranges of whole groups (split s takes groups [s*G/S, (s+1)*G/S)); with
// splits > 1, ws is an fp32 workspace of splits * M * N floats for the
// partial sums, else unused.  Returns cudaGetLastError() after the
// launches (0 = launched).
int int4_matmul_launch(const void* x, const void* values, const void* scales,
                       void* out, void* ws, int splits, int M, int K, int N,
                       int half, int out_f32, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    tc::k2<float>(x, values, scales, out, ws, splits, M, K, N, half, vec, s);
  else
    tc::k2<__nv_bfloat16>(x, values, scales, out, ws, splits, M, K, N, half, vec, s);
  return static_cast<int>(cudaGetLastError());
}

// The A/B variant V1 (the CUDA-core kernel, no split): x, values, scales
// and vec as int4_matmul_launch takes them, out bf16.
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
