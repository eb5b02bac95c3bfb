// Matmul with nibble-packed 4-bit signed log2 weights for Hopper (sm_90a) —
// replaces the Pallas kernel repro/kernels/log2_matmul.py::log2_matmul
// (_kernel).
//
// What it computes:  out (M, N) f32 = x (M, K) @ W (K, N), with x fp32 or
// bf16 and W decoded from w_packed (K, N/2) uint8, two codes per byte, the
// even column in the low nibble: W[k, n] = P[k, n] * scale, where
// P = sign(c) * 2^(1-|c|) for a code c in -8..7 (|c| in 1..8) and P = 0 for
// c = 0 (log2_decode.cuh, the decode tcn_block uses too).  The scale is read
// from device memory, so the host never waits on it.
//
// The bit contract.  Every P is a power of two (or 0), exact in bf16: its
// bits are sign << 15 | (128 - |c|) << 7, the top half of log2_decode's
// fp32 value at scale 1, kept in a 16-entry table.  A product of a value
// with a power of two is exact, so
// the kernel multiplies by P and applies the scale once, in the epilogue:
//   out = scale * sum_k x[m, k] * P[k, n].
// An fp32 x is split exactly into three bf16 parts, x = hi + mid + lo (hi
// keeps the top 16 bits of x, mid the top 16 of x - hi, lo what is left,
// which fits in 8 significant bits; exact for finite x above 2^-102 in
// magnitude), and each part goes through the tensor cores in bf16 with an
// fp32 accumulator: every product is exact and only the sums round.  A
// bf16 x is one part.  The result keeps fp32 accuracy (the tests hold it
// to the reference at rtol 1e-4, atol 1e-3); the identity decodes bit for
// bit (1 * P is exact and __fmul_rn(P, scale) is log2_decode's product).
// TF32 is never used.  A non-finite x gives NaN in its row.
//
// Two paths, chosen by the wrapper from M.
//
// Tile path (M above the decode path's rows).  One CTA of 8 warps per
// 64x64 output tile (256x2048x2048 makes 128 CTAs on the 132 SMs).  K is
// walked in steps of 64 through a double-buffered shared-memory ring: the
// next step's x and packed bytes are loaded from global memory into
// registers before the MMAs of the current step are issued, and after them
// split (x) or decoded (W: nibble to bf16 bits through a 16-entry table)
// straight into the other buffer, so one barrier per step separates the
// two.  (cp.async would copy the raw bytes to shared memory and leave the
// split and the decode a second pass there; here both happen in the
// registers the load fills.)  Warps w and w+4 compute the same 32x32
// sub-tile over the two 32-k halves of each step with mma.sync.aligned.
// m16n8k16 bf16 -> fp32, fragments loaded by ldmatrix from rows padded to
// 144 bytes (conflict free); the halves are added once at the end.  The
// work is 3 x 2MKN bf16 operations on the tensor cores: at 256x2048x2048,
// 6.4 GFLOP, about 6.5 us at the card's bf16 peak against 32 us for 2MKN at
// the fp32 peak.  What bounds this mma.sync design is shared memory (each
// mma reads 256 bytes of fragments, the card serves 128 a cycle an SM) and
// the split and decode arithmetic; a wgmma/TMA pipeline is later work.
//
// Decode path (few rows: the decode shapes).  Bytes bound it: the packed
// W is read once.  A CTA of 8 warps covers 16 columns and all of K: lane l
// of warp w owns the rows w*32 + l + 256i (one 8-byte load a row: 16
// codes) and reads its rows of x (up to 4) straight from global memory,
// coalesced across the lanes.  Codes decode to fp32 powers of two through
// a 16-entry table and are summed in fp32, k ascending: each x * P is
// exact, so fmaf rounds only the sum.  The lanes' sums are folded by a
// fixed shuffle butterfly and the 8 warps' sums added in warp order.  One
// launch, no atomics, so the result is bit-identical from run to run.
#include <cstdint>
#include <cuda_runtime.h>

#include "log2_decode.cuh"

namespace {

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

template <bool kBf16>
__device__ __forceinline__ float load_x(const void* x, long i) {
  if (kBf16) {
    uint32_t bits = __ldg(static_cast<const unsigned short*>(x) + i);
    return __uint_as_float(bits << 16);  // bf16 -> fp32 is exact
  }
  return __ldg(static_cast<const float*>(x) + i);
}

// ---------------------------------------------------------------------------
// tile path
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 64, kThreads = 256;
constexpr int kLd = kBK + 8;  // bf16 per smem row: 144 bytes, ldmatrix conflict free

struct TileSmem {
  uint16_t a[2][3][kBM][kLd];  // bf16 parts of x: [buffer][part][m][k]
  uint16_t b[2][kBN][kLd];     // P as bf16: [buffer][n][k]
};
constexpr int kTileSmem = static_cast<int>(sizeof(TileSmem));

// x = hi + mid + lo exactly, each a bf16 (the top 16 bits of what is left);
// returns the three parts of two values, packed in pairs (v0 low, v1 high)
__device__ __forceinline__ void split3x2(float v0, float v1, uint32_t& hi,
                                         uint32_t& mid, uint32_t& lo) {
  const uint32_t a0 = __float_as_uint(v0), b0 = __float_as_uint(v1);
  const float ra = __fsub_rn(v0, __uint_as_float(a0 & 0xFFFF0000u));
  const float rb = __fsub_rn(v1, __uint_as_float(b0 & 0xFFFF0000u));
  const uint32_t a1 = __float_as_uint(ra), b1 = __float_as_uint(rb);
  const uint32_t a2 = __float_as_uint(__fsub_rn(ra, __uint_as_float(a1 & 0xFFFF0000u)));
  const uint32_t b2 = __float_as_uint(__fsub_rn(rb, __uint_as_float(b1 & 0xFFFF0000u)));
  hi = __byte_perm(a0, b0, 0x7632);  // high halves of a and b
  mid = __byte_perm(a1, b1, 0x7632);
  lo = __byte_perm(a2, b2, 0x7632);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One K step's operands in registers: x (16 fp32 or 32 bf16 values a
// thread) and two 4-byte groups of packed codes (rows 2*kp and 2*kp+1).
struct Stage {
  uint32_t xv[16];
  uint32_t w0, w1;
};

// Thread mapping of a K step (64 rows x 64 k of x, 64 k x 32 bytes of W).
// x, fp32: 4 runs of 4 values, run e = tid + 256*i covers row e/16, k
// 4*(e%16)..+3.  x, bf16: 2 runs of 8 values, run e covers row e/8, k
// 8*(e%8)..+7.  W: thread tid covers k rows 2*(tid/8) and +1, bytes
// 4*(tid%8)..+3 of the tile (columns 8*(tid%8)..+7), so a warp's load
// reads 4 whole 32-byte rows.
template <bool kBf16>
__device__ __forceinline__ void load_stage(Stage& s, const void* x,
                                           const uint8_t* w, int M, int K,
                                           int nbytes, int row0, int col0,
                                           int k0, bool xvec, bool wvec) {
  const int tid = threadIdx.x;
  constexpr int kRuns = kBf16 ? 2 : 4, kLen = kBf16 ? 8 : 4;
#pragma unroll
  for (int i = 0; i < kRuns; ++i) {
    const int e = tid + kThreads * i;
    const int r = e / (kBK / kLen), kk = (e % (kBK / kLen)) * kLen;
    const int gm = row0 + r, gk = k0 + kk;
    const long off = static_cast<long>(gm) * K + gk;
    if (xvec) {  // K is a multiple of kLen and x is 16-byte aligned
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K) {
        v = kBf16 ? __ldg(reinterpret_cast<const uint4*>(
                        static_cast<const unsigned short*>(x) + off))
                  : __ldg(reinterpret_cast<const uint4*>(
                        static_cast<const float*>(x) + off));
      }
      s.xv[4 * i] = v.x;
      s.xv[4 * i + 1] = v.y;
      s.xv[4 * i + 2] = v.z;
      s.xv[4 * i + 3] = v.w;
    } else if (kBf16) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t lo = 0, hi = 0;
        if (gm < M && gk + j < K)
          lo = __ldg(static_cast<const unsigned short*>(x) + off + j);
        if (gm < M && gk + j + 1 < K)
          hi = __ldg(static_cast<const unsigned short*>(x) + off + j + 1);
        s.xv[4 * i + j / 2] = lo | (hi << 16);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s.xv[4 * i + j] =
            (gm < M && gk + j < K)
                ? __float_as_uint(__ldg(static_cast<const float*>(x) + off + j))
                : 0u;
    }
  }
  const int kp = tid / 8, bg = tid % 8;
  const int gb = col0 / 2 + 4 * bg;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gk = k0 + 2 * kp + h;
    uint32_t word = 0;  // code 0 decodes to 0
    if (gk < K) {
      const uint8_t* p = w + static_cast<long>(gk) * nbytes + gb;
      if (wvec) {  // nbytes % 4 == 0: the 4 bytes are in the row, aligned
        if (gb < nbytes) word = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gb + j < nbytes) word |= static_cast<uint32_t>(__ldg(p + j)) << (8 * j);
      }
    }
    (h ? s.w1 : s.w0) = word;
  }
}

template <bool kBf16>
__device__ __forceinline__ void store_stage(const Stage& s, TileSmem& sm,
                                            const uint16_t* lut, int buf) {
  const int tid = threadIdx.x;
  if (kBf16) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + kThreads * i;
      const int r = e / 8, kk = (e % 8) * 8;
      *reinterpret_cast<uint4*>(&sm.a[buf][0][r][kk]) =
          make_uint4(s.xv[4 * i], s.xv[4 * i + 1], s.xv[4 * i + 2],
                     s.xv[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + kThreads * i;
      const int r = e / 16, kk = (e % 16) * 4;
      uint32_t h[2], m[2], l[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        split3x2(__uint_as_float(s.xv[4 * i + 2 * j]),
                 __uint_as_float(s.xv[4 * i + 2 * j + 1]), h[j], m[j], l[j]);
      *reinterpret_cast<uint2*>(&sm.a[buf][0][r][kk]) = make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2*>(&sm.a[buf][1][r][kk]) = make_uint2(m[0], m[1]);
      *reinterpret_cast<uint2*>(&sm.a[buf][2][r][kk]) = make_uint2(l[0], l[1]);
    }
  }
  // codes: column 8*bg + j is nibble j of the 4-byte group (even column in
  // the low nibble); one 32-bit store holds rows 2*kp and 2*kp+1.  Lanes
  // of one kp visit the columns in rotated order, so a store's 32 lanes
  // hit 32 banks.
  const int kp = tid / 8, bg = tid % 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = (i + bg) & 7;
    const uint32_t p0 = lut[(s.w0 >> (4 * j)) & 0xFu];
    const uint32_t p1 = lut[(s.w1 >> (4 * j)) & 0xFu];
    *reinterpret_cast<uint32_t*>(&sm.b[buf][8 * bg + j][2 * kp]) = p0 | (p1 << 16);
  }
}

// One 64-k step of a warp's 32x32 sub-tile over its k half kh.
template <int kParts>
__device__ __forceinline__ void mma_step(const TileSmem& sm, int buf, int kh,
                                         int wm, int wn, int lane,
                                         float (&acc)[2][4][4]) {
#pragma unroll
  for (int k16 = 0; k16 < 2; ++k16) {
    const int kk = kh * 32 + k16 * 16;
    uint32_t bf[2][4];  // n8 tiles 2j, 2j+1: {b0, b1} each
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ldmatrix_x4(bf[j], &sm.b[buf][wn * 32 + j * 16 + (lane / 16) * 8 + lane % 8]
                              [kk + ((lane / 8) % 2) * 8]);
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t af[4];
        ldmatrix_x4(af, &sm.a[buf][p][wm * 32 + mi * 16 + lane % 16]
                              [kk + (lane / 16) * 8]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af, bf[ni / 2][2 * (ni % 2)],
                   bf[ni / 2][2 * (ni % 2) + 1]);
      }
    }
  }
}

// 8 warps: warp w computes the 32x32 sub-tile (w%4)/2, (w%4)%2 over the
// k half w/4 of every 64-k step; the two halves are added at the end.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const void* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ scale_p, float* __restrict__ out, int M,
            int K, int N, int xvec, int wvec) {
  constexpr int kParts = kBf16 ? 1 : 3;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(tile_smem);
  __shared__ uint16_t lut[16];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp % 4) / 2, wn = warp % 2, kh = warp / 4;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int nbytes = N / 2;
  // P of code tid: at scale 1 an exact power of two (or 0), so its top 16
  // bits are P in bf16
  if (tid < 16) lut[tid] = static_cast<uint16_t>(__float_as_uint(log2_decode(tid, 0, 1.0f)) >> 16);
  float acc[2][4][4] = {};
  const int nk = (K + kBK - 1) / kBK;
  const bool halves = K > kBK / 2;  // else the second k half is all zeros
  // Two register stages: step kt+2 is loaded while step kt multiplies and
  // step kt+1 is split/decoded, so a load has two steps' work to land.
  Stage sa, sb;
  load_stage<kBf16>(sa, x, w, M, K, nbytes, row0, col0, 0, xvec, wvec);
  if (nk > 1)
    load_stage<kBf16>(sb, x, w, M, K, nbytes, row0, col0, kBK, xvec, wvec);
  __syncthreads();  // the table
  store_stage<kBf16>(sa, sm, lut, 0);
  __syncthreads();
  // buffer kt&1 holds step kt, `next` step kt+1; `spare` takes step kt+2
  auto step = [&](Stage& next, Stage& spare, int kt) {
    if (kt + 2 < nk)
      load_stage<kBf16>(spare, x, w, M, K, nbytes, row0, col0, (kt + 2) * kBK,
                        xvec, wvec);
    if (kh == 0 || halves) mma_step<kParts>(sm, kt & 1, kh, wm, wn, lane, acc);
    if (kt + 1 < nk) store_stage<kBf16>(next, sm, lut, (kt + 1) & 1);
    __syncthreads();
  };
  for (int kt = 0; kt < nk; kt += 2) {
    step(sb, sa, kt);
    if (kt + 1 < nk) step(sa, sb, kt + 1);
  }
  // the second k half's sums go through shared memory (the ring is free:
  // the loop ended on a barrier), then the first half adds them
  float* red = reinterpret_cast<float*>(tile_smem);  // [4 sub-tiles][32 lanes][32]
  float* mine = red + ((warp % 4) * 32 + lane) * 32;
  if (!halves && kh == 1) return;
  if (halves && kh == 1) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float4*>(mine + (mi * 4 + ni) * 4) =
            make_float4(acc[mi][ni][0], acc[mi][ni][1], acc[mi][ni][2], acc[mi][ni][3]);
  }
  if (halves) {
    __syncthreads();
    if (kh == 1) return;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float4 o = *reinterpret_cast<const float4*>(mine + (mi * 4 + ni) * 4);
        acc[mi][ni][0] = __fadd_rn(acc[mi][ni][0], o.x);
        acc[mi][ni][1] = __fadd_rn(acc[mi][ni][1], o.y);
        acc[mi][ni][2] = __fadd_rn(acc[mi][ni][2], o.z);
        acc[mi][ni][3] = __fadd_rn(acc[mi][ni][3], o.w);
      }
  }
  const float scale = __ldg(scale_p);
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = row0 + wm * 32 + mi * 16 + g + 8 * h;
      if (gm >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int gn = col0 + wn * 32 + ni * 8 + 2 * t4;  // even; N is even
        if (gn < N)
          *reinterpret_cast<float2*>(out + static_cast<long>(gm) * N + gn) =
              make_float2(__fmul_rn(acc[mi][ni][2 * h], scale),
                          __fmul_rn(acc[mi][ni][2 * h + 1], scale));
      }
    }
}

// ---------------------------------------------------------------------------
// decode path
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 8, kDecThreads = 32 * kDecWarps;
constexpr int kDecCols = 16;  // columns per CTA: 8 packed bytes a row

// 8 packed bytes (16 codes) of one row; bytes past the row's end are code 0
__device__ __forceinline__ uint2 load_row8(const uint8_t* p, bool aligned,
                                           int avail) {
  if (aligned && avail >= 8) return __ldg(reinterpret_cast<const uint2*>(p));
  uint32_t word[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < avail) word[j / 4] |= static_cast<uint32_t>(__ldg(p + j)) << (8 * (j % 4));
  return make_uint2(word[0], word[1]);
}

// Sum a value set over the lanes whose ids differ in bit `bit`, keeping
// half of the set: the lane with the bit clear keeps the first half.  An
// fp32 sum of two values does not depend on their order, so both lanes of
// a pair agree.
template <int kN>
__device__ __forceinline__ void fold(float (&v)[kN], int lane, int bit) {
  const bool upper = (lane >> bit) & 1;
#pragma unroll
  for (int j = 0; j < kN / 2; ++j) {
    const float send = upper ? v[j] : v[j + kN / 2];
    const float keep = upper ? v[j + kN / 2] : v[j];
    v[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 1 << bit));
  }
}

// Rows m0..m0+kMT-1 of x (fewer at the edge) times all of P for the CTA's
// 16 columns.  Lane l of warp w owns rows w*32 + l + 256i, summed in order;
// the 32 lanes' 16 column sums are folded in a fixed butterfly (bits 0..4
// of the lane id), then the 8 warps' sums are added in warp order.
template <bool kBf16, int kMT>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const void* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale_p, float* __restrict__ out,
              int M, int K, int N, int wvec) {
  constexpr int kBatch = kMT == 1 ? 16 : 8;  // rows whose loads fly together
  __shared__ float lut[16];
  __shared__ float wsum[kDecWarps][kMT][kDecCols];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * kMT, mt = min(kMT, M - m0);
  const int nbytes = N / 2;
  const int byte0 = blockIdx.x * (kDecCols / 2);
  const int avail = nbytes - byte0;
  if (tid < 16) lut[tid] = log2_decode(tid, 0, 1.0f);  // P of code tid
  __syncthreads();
  float acc[kMT][kDecCols] = {};
  for (int k0 = tid; k0 < K; k0 += kDecThreads * kBatch) {
    uint2 v[kBatch];
    float xv[kBatch][kMT];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int k = k0 + b * kDecThreads;
      v[b] = k < K ? load_row8(w + static_cast<long>(k) * nbytes + byte0, wvec, avail)
                   : make_uint2(0, 0);
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        xv[b][m] = (k < K && m < mt)
                       ? load_x<kBf16>(x, static_cast<long>(m0 + m) * K + k)
                       : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int j = 0; j < kDecCols; ++j) {
        const uint32_t word = j < 8 ? v[b].x : v[b].y;
        const float p = lut[(word >> (4 * (j % 8))) & 0xFu];
#pragma unroll
        for (int m = 0; m < kMT; ++m) acc[m][j] = fmaf(xv[b][m], p, acc[m][j]);  // x*p exact
      }
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    float v16[16], v8[8], v4[4], v2[2];
#pragma unroll
    for (int j = 0; j < 16; ++j) v16[j] = acc[m][j];
    fold(v16, lane, 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) v8[j] = v16[j];
    fold(v8, lane, 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) v4[j] = v8[j];
    fold(v4, lane, 2);
#pragma unroll
    for (int j = 0; j < 2; ++j) v2[j] = v4[j];
    fold(v2, lane, 3);
    // lanes l and l^16 hold the same column, 8*b0 + 4*b1 + 2*b2 + b3 for
    // the lane bits b0..b3; the last fold adds the two halves of the warp
    const float sum = __fadd_rn(v2[0], __shfl_xor_sync(0xffffffffu, v2[0], 16));
    if (lane < 16) {
      const int col = ((lane & 1) << 3) | ((lane & 2) << 1) | ((lane & 4) >> 1) |
                      ((lane & 8) >> 3);
      wsum[warp][m][col] = sum;
    }
  }
  __syncthreads();
  if (tid < kMT * kDecCols) {
    const int m = tid / kDecCols, c = tid % kDecCols;
    const int col = blockIdx.x * kDecCols + c;
    if (m < mt && col < N) {
      float s = wsum[0][m][c];
#pragma unroll
      for (int q = 1; q < kDecWarps; ++q) s = __fadd_rn(s, wsum[q][m][c]);
      out[static_cast<long>(m0 + m) * N + col] = __fmul_rn(s, __ldg(scale_p));
    }
  }
}

template <bool kBf16, int kMT>
cudaError_t launch_decode(const void* x, const uint8_t* w, const float* scale,
                          float* out, int M, int K, int N, int wvec,
                          cudaStream_t s) {
  dim3 grid((N + kDecCols - 1) / kDecCols, (M + kMT - 1) / kMT);
  decode_kernel<kBf16, kMT><<<grid, kDecThreads, 0, s>>>(x, w, scale, out, M, K,
                                                         N, wvec);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t decode_rows(const void* x, const uint8_t* w, const float* scale,
                        float* out, int M, int K, int N, int wvec,
                        cudaStream_t s) {
  if (M == 1) return launch_decode<kBf16, 1>(x, w, scale, out, M, K, N, wvec, s);
  if (M == 2) return launch_decode<kBf16, 2>(x, w, scale, out, M, K, N, wvec, s);
  return launch_decode<kBf16, 4>(x, w, scale, out, M, K, N, wvec, s);
}

template <bool kBf16>
cudaError_t launch_tile(const void* x, const uint8_t* w, const float* scale,
                        float* out, int M, int K, int N, int xvec, int wvec,
                        cudaStream_t s) {
  static bool granted = false;  // dynamic shared memory above 48 KB
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
    if (err != cudaSuccess) return err;
    granted = true;
  }
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  tile_kernel<kBf16><<<grid, kThreads, kTileSmem, s>>>(x, w, scale, out, M, K,
                                                      N, xvec, wvec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile path.  x (M, K) fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1), w_packed
// (K, N/2) uint8, scale () fp32 on the device -> out (M, N) fp32.  N is
// even; ceil(N/64) <= 65535.  Returns cudaGetLastError().
int log2_matmul(const void* x, const uint8_t* w_packed, const float* scale,
                float* out, int M, int K, int N, int x_bf16, void* stream) {
  const int xlen = x_bf16 ? 8 : 4;
  const int xvec = (K % xlen == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int wvec = ((N / 2) % 4 == 0) && (reinterpret_cast<uintptr_t>(w_packed) % 4 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? launch_tile<true>(x, w_packed, scale, out, M, K, N, xvec, wvec, s)
             : launch_tile<false>(x, w_packed, scale, out, M, K, N, xvec, wvec, s);
  return static_cast<int>(err);
}

// Decode path (M <= 4 is fastest; any M works, 4 rows a CTA): x (M, K),
// w_packed, scale -> out as for the tile path, in one launch.  Returns
// cudaGetLastError().
int log2_matmul_decode(const void* x, const uint8_t* w_packed,
                       const float* scale, float* out, int M, int K, int N,
                       int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wvec = ((N / 2) % 8 == 0) && (reinterpret_cast<uintptr_t>(w_packed) % 8 == 0);
  const cudaError_t err =
      x_bf16 ? decode_rows<true>(x, w_packed, scale, out, M, K, N, wvec, s)
             : decode_rows<false>(x, w_packed, scale, out, M, K, N, wvec, s);
  return static_cast<int>(err);
}

const char* log2_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
