// Matmul with nibble-packed 4-bit signed log2 weights for Hopper (sm_90a) —
// replaces the Pallas kernel repro/kernels/log2_matmul.py::log2_matmul
// (_kernel).
//
// What it computes:  out (M, N) f32 = x (M, K) @ W (K, N), with x fp32 or
// bf16 (upcast exactly to fp32, as the TPU kernel's body does) and W decoded
// in the kernel from w_packed (K, N/2) uint8, two codes per byte, the even
// column in the low nibble: W[k, n] = sign(c) * 2^(1-|c|) * scale, 0 for c=0
// (log2_decode.cuh, the decode tcn_block uses).  The scale is read from
// device memory, so the host never waits on it.
//
// Design.  One block of 256 threads per 64x64 output tile.  The K axis is
// walked in steps of 16: each step stages a 64x16 tile of x (transposed, so
// a warp reads one broadcast value per row) and a 16x64 tile of decoded W in
// shared memory, then every thread accumulates a 4x4 micro-tile (rows
// ty + 16*i, columns tx + 16*j) with fp32 FMA, k in ascending order.  Ragged
// M, N and K are masked in the loads and the store instead of padded: a
// packed byte is read only when its index is below N/2, so an N that is not
// a multiple of the tile never reads past the last byte.  No tensor cores
// and no TF32: the sums are full fp32, the reference's semantics.
//
// Bound on this card.  2*M*K*N flops against M*K*4 (or 2) + K*N/2 + M*N*4
// bytes: at the benchmark's 256x2048x2048 it is ~60 flops per byte, above
// the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so the fp32 rate bounds
// it; at decode shapes (M=1..16) the packed weights dominate and bytes bound
// it.  This simple tiling re-decodes each W tile once per 64 rows of x and
// reads operands through shared memory without double buffering; an MMA
// path (decode to bf16/tf32 fragments) and a split-K decode path for small
// M are later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "log2_decode.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

template <bool kBf16>
__device__ __forceinline__ float load_x(const void* x, long i) {
  if (kBf16) {
    uint32_t bits = __ldg(static_cast<const unsigned short*>(x) + i);
    return __uint_as_float(bits << 16);  // bf16 -> fp32 is exact
  }
  return __ldg(static_cast<const float*>(x) + i);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
log2_matmul_kernel(const void* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale_p, float* __restrict__ out,
                   int M, int K, int N) {
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int nbytes = N / 2;  // packed bytes per row of W
  const float scale = __ldg(scale_p);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile: 64 rows x 16 k, four values a thread, k fastest (coalesced)
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      int e = tid + i * kThreads;
      int r = e / kBK, c = e % kBK;
      int gm = row0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K)
                     ? load_x<kBf16>(x, static_cast<long>(gm) * K + gk)
                     : 0.0f;
    }
    // W tile: 16 k x 32 bytes, two bytes a thread, each decoded to 2 columns
#pragma unroll
    for (int i = 0; i < kBK * (kBN / 2) / kThreads; ++i) {
      int e = tid + i * kThreads;
      int r = e / (kBN / 2), cb = e % (kBN / 2);
      int gk = k0 + r, gb = col0 / 2 + cb;
      uint8_t byte = (gk < K && gb < nbytes)
                         ? __ldg(w + static_cast<long>(gk) * nbytes + gb)
                         : 0;  // code 0 decodes to 0
      ws[r][2 * cb] = log2_decode(byte, 0, scale);
      ws[r][2 * cb + 1] = log2_decode(byte, 1, scale);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = row0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = col0 + tx + 16 * j;
      if (gn < N) out[static_cast<long>(gm) * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x (M, K) fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1), w_packed (K, N/2) uint8,
// scale () fp32 on the device -> out (M, N) fp32.  N is even.  Returns
// cudaGetLastError().
int log2_matmul(const void* x, const uint8_t* w_packed, const float* scale,
                float* out, int M, int K, int N, int x_bf16, void* stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    log2_matmul_kernel<true><<<grid, kThreads, 0, s>>>(x, w_packed, scale, out, M, K, N);
  else
    log2_matmul_kernel<false><<<grid, kThreads, 0, s>>>(x, w_packed, scale, out, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

const char* log2_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
