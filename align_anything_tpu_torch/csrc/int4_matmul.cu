// K2, the W4A16 matmul for Hopper (sm_90a): out (M, N) = x (M, K) @
// dequant(values, scales), and the A/B variants V1 and V2 of it: one kernel
// body, k2_mma_kernel, templated on the variant.
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
// V1 and V2 replace the Pallas kernels of scripts/bench/bench_int4_kernel_ab.py
// (_kernel_v1 behind run_variant, _kernel_v2 behind run_v2) and differ from
// K2 only in how B's fragments are built from a loaded word and scale
// (dequant_b); their output is bf16:
//   * V1: w = bf16(q * bf16(s)), the scale rounded to bf16 first;
//   * V2: the offset-low packing, whose low nibble holds q + 8 (unsigned)
//     and whose high nibble is signed; w = bf16(u * bf16(s)) for the stored
//     nibble u, and the -8 correction (M, N) fp32, computed outside the
//     kernel as run_v2 computes it, is added once to each fp32 total before
//     the cast: at the store with one split, in split_sum_kernel with more.
// V1 and V2 are held to their plain versions bit for bit on at least 99 %
// of the bf16 outputs.  The tensor cores' fp32 sum along a chain of MMAs
// drifts from a sum rounded to nearest at every addition, and over the 896
// MMAs of a split of down's K 14336 at M 128 (2 splits) the drift moved
// 1.1 % of the outputs across a bf16 rounding boundary (H100).  So V1 and
// V2 start a fresh MMA sum for every chunk of kSteps k16-steps and add it
// to a second fp32 accumulator with round-to-nearest adds (16 * MT FADDs
// per chunk, 16 * MT more registers).  K2, held to 1e-2 of max|plain|,
// keeps its single accumulator.
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
//     rounded to bf16 (V1 and V2: in bf16x2, see dequant_b).  The low nibbles of
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
// dequantization (K2: about 4.5 ALU operations per weight; V1 and V2: 2);
// the MMAs cost nothing measurable.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (align_anything_tpu_torch/ops/int4_matmul.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K2: split-K over whole groups, bf16 mma.sync on B fragments dequantized in
// registers (see the note at the top).

namespace tc {

enum Variant { kV0 = 0, kV1 = 1, kV2 = 2 };

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

// a - b and a * b on bf16 pairs, each rounded to nearest even; the explicit
// .rn keeps the compiler from contracting the two into one fma
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// B's fragments of n8 tile jn for one k16 step, from the words w of
// load_step and the scale s of tile jn's column: blo[h] from the low
// nibbles, bhi[h] from the high ones of byte jn of packed rows (2t, 2t+1)
// (h 0), then (2t+8, 2t+9) (h 1), the lower row in the low half.
//   * V0: each nibble to fp32 (nibble), times s, rounded to bf16 in pairs.
//   * V1, V2: in bf16x2, two weights per instruction.  One prmt gathers
//     byte jn of the two rows into the low bytes of the two halves; with
//     n a signed nibble, (d & 0x000F000F) ^ 0x43084308 is the bf16 pair
//     128 + (n ^ 8) = 136 + q (one lop3), and subtracting 136 gives q
//     exactly, since every integer up to 256 fits bf16's 8-bit
//     significand; V2's low nibble, q + 8 unsigned, takes | 0x43004300
//     and 128 instead.  One multiply by {bf16(s), bf16(s)} then rounds
//     q * bf16(s), exact before rounding (a 4-bit integer times an 8-bit
//     significand), to nearest: the plain versions' bf16(fp32(q) *
//     fp32(bf16(s))) bit for bit.  bf16(s) is converted once per tile and
//     step: 4 conversions per 32 weights of a thread.
template <int V>
__device__ __forceinline__ void dequant_b(uint32_t (&blo)[2], uint32_t (&bhi)[2],
                                          const uint32_t (&w)[4], float s, int jn) {
  if constexpr (V == kV0) {
    const int sh = 8 * jn;  // byte jn of each word: tile jn's column
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t ra = w[2 * h] >> sh, rb = w[2 * h + 1] >> sh;
      blo[h] = pack_bf16(nibble(ra) * s, nibble(rb) * s);
      bhi[h] = pack_bf16(nibble(ra >> 4) * s, nibble(rb >> 4) * s);
    }
  } else {
    constexpr uint32_t kMask = 0x000F000Fu;
    constexpr uint32_t k136 = 0x43084308u;  // {136, 136} in bf16
    constexpr uint32_t k128 = 0x43004300u;  // {128, 128}
    const uint32_t sb = pack_bf16(s, s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t d = __byte_perm(w[2 * h], w[2 * h + 1], jn | (jn + 4) << 8);
      const uint32_t lo = V == kV1 ? sub_bf16x2((d & kMask) ^ k136, k136)
                                   : sub_bf16x2((d & kMask) | k128, k128);
      const uint32_t hi = sub_bf16x2(((d >> 4) & kMask) ^ k136, k136);
      blo[h] = mul_bf16x2(lo, sb);
      bhi[h] = mul_bf16x2(hi, sb);
    }
  }
}

// One k16 step: A from the staged x (step j of the chunk), B from the
// loaded bytes, both slices into every accumulator tile.
template <int V, int MT>
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
    uint32_t blo[2], bhi[2];
    dequant_b<V>(blo, bhi, w, s[jn], jn);
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

// v[b] += row[c + b] for the 4 columns c .. c + 3 (masked to N)
template <bool kVec>
__device__ __forceinline__ void add4(float (&v)[4], const float* __restrict__ row, int c,
                                     int N) {
  if constexpr (kVec) {
    if (c >= N) return;
    const float4 f = *reinterpret_cast<const float4*>(row + c);
    v[0] += f.x; v[1] += f.y; v[2] += f.z; v[3] += f.w;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (c + b < N) v[b] += row[c + b];
  }
}

template <int V, int MT, bool kTail, bool kVec, typename OutT>
__global__ void __launch_bounds__(kThreads)
k2_mma_kernel(const __nv_bfloat16* __restrict__ x,   // (M, K)
              const int8_t* __restrict__ values,     // (K/2, N)
              const float* __restrict__ scales,      // (G, N)
              const float* __restrict__ corr,        // (M, N), V2 only
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

  // V1 and V2 add acc, the MMAs' sum of one chunk, into tot after every
  // chunk, each addition rounded to nearest (see the note at the top); K2
  // keeps one accumulator
  float acc[MT][kNT][4], tot[MT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][jn][e] = tot[mt][jn][e] = 0.f;

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
          if (jb + u < nst) mma_step<V, MT>(acc, w[b][u], s[b][u], xs, jb + u, lane);
      }
    }
    if constexpr (V != kV0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[mt][jn][e] = __fadd_rn(tot[mt][jn][e], acc[mt][jn][e]);
            acc[mt][jn][e] = 0.f;
          }
    }
  }
  const float (&sum)[MT][kNT][4] = V == kV0 ? acc : tot;

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
        even[jn] = sum[mt][jn][2 * h];
        odd[jn] = sum[mt][jn][2 * h + 1];
      }
      if (ws != nullptr) {
        float* row = ws + ((size_t)blockIdx.z * M + m) * N;
        store4<kVec>(row, c_even, N, even);
        store4<kVec>(row, c_odd, N, odd);
      } else {
        if constexpr (V == kV2) {  // the -8 correction, once, to the fp32 total
          add4<kVec>(even, corr + (size_t)m * N, c_even, N);
          add4<kVec>(odd, corr + (size_t)m * N, c_odd, N);
        }
        store4<kVec>(out + (size_t)m * N, c_even, N, even);
        store4<kVec>(out + (size_t)m * N, c_odd, N, odd);
      }
    }
  }
}

template <int V, int MT, bool kTail, bool kVec, typename OutT>
void launch(const void* x, const void* values, const void* scales, const void* corr,
            void* out, float* ws, int splits, int M, int K, int N, int half,
            cudaStream_t stream) {
  const dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN, splits);
  k2_mma_kernel<V, MT, kTail, kVec, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(values),
      static_cast<const float*>(scales), static_cast<const float*>(corr),
      static_cast<OutT*>(out), ws, M, K, N, half);
}

template <int V, int MT, typename OutT>
void dispatch_tail(const void* x, const void* values, const void* scales, const void* corr,
                   void* out, float* ws, int splits, int M, int K, int N, int half, int vec,
                   cudaStream_t stream) {
  const bool tail = half % 16 != 0;
  if (tail && vec)
    launch<V, MT, true, true, OutT>(x, values, scales, corr, out, ws, splits, M, K, N, half,
                                    stream);
  else if (tail)
    launch<V, MT, true, false, OutT>(x, values, scales, corr, out, ws, splits, M, K, N, half,
                                     stream);
  else if (vec)
    launch<V, MT, false, true, OutT>(x, values, scales, corr, out, ws, splits, M, K, N, half,
                                     stream);
  else
    launch<V, MT, false, false, OutT>(x, values, scales, corr, out, ws, splits, M, K, N, half,
                                      stream);
}

// out = the sum of the S partial sums ws (S, M*N), taken in the order
// s = 0 .. S-1 for every element, so that two launches give the same bits,
// plus corr (M*N) once where it is given (V2's correction)
template <typename OutT>
__global__ void split_sum_kernel(const float* __restrict__ ws, const float* __restrict__ corr,
                                 OutT* __restrict__ out, int splits, long long mn) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = ws[i];
    for (int s = 1; s < splits; ++s) acc += ws[s * mn + i];
    if (corr != nullptr) acc += corr[i];
    store_out(out + i, acc);
  }
}

template <int V, typename OutT>
void k2(const void* x, const void* values, const void* scales, const void* corr, void* out,
        void* ws, int splits, int M, int K, int N, int half, int vec, cudaStream_t stream) {
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  if (M <= 16)
    dispatch_tail<V, 1, OutT>(x, values, scales, corr, out, w, splits, M, K, N, half, vec,
                              stream);
  else
    dispatch_tail<V, 2, OutT>(x, values, scales, corr, out, w, splits, M, K, N, half, vec,
                              stream);
  if (splits > 1) {
    constexpr int kSumThreads = 256;
    const long long mn = (long long)M * N;
    const long long blocks = (mn + kSumThreads - 1) / kSumThreads;
    split_sum_kernel<OutT><<<(int)(blocks < 4096 ? blocks : 4096), kSumThreads, 0, stream>>>(
        w, V == kV2 ? static_cast<const float*>(corr) : nullptr, static_cast<OutT*>(out),
        splits, mn);
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
    tc::k2<tc::kV0, float>(x, values, scales, nullptr, out, ws, splits, M, K, N, half, vec, s);
  else
    tc::k2<tc::kV0, __nv_bfloat16>(x, values, scales, nullptr, out, ws, splits, M, K, N, half,
                                   vec, s);
  return static_cast<int>(cudaGetLastError());
}

// The A/B variant V1: x, values, scales, ws, splits and vec as
// int4_matmul_launch takes them, out bf16.
int int4_matmul_v1_launch(const void* x, const void* values, const void* scales,
                          void* out, void* ws, int splits, int M, int K, int N,
                          int half, int vec, void* stream) {
  tc::k2<tc::kV1, __nv_bfloat16>(x, values, scales, nullptr, out, ws, splits, M, K, N, half,
                                 vec, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The A/B variant V2: values in the offset-low packing; corr (M, N) fp32,
// contiguous and, with vec, 16-byte aligned: the -8 correction, added once
// to each fp32 total.  The rest as V1.
int int4_matmul_v2_launch(const void* x, const void* values, const void* scales,
                          const void* corr, void* out, void* ws, int splits, int M,
                          int K, int N, int half, int vec, void* stream) {
  tc::k2<tc::kV2, __nv_bfloat16>(x, values, scales, corr, out, ws, splits, M, K, N, half,
                                 vec, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
