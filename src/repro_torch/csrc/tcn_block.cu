// Fused TCN residual block for Hopper (sm_90a) — replaces the Pallas kernel
// repro/kernels/tcn_block.py::tcn_block_pallas (_block_kernel).
//
// What it computes, per slot s and chunk position t (n = (k-1)*d):
//   mid[s,t] = qa(relu(sum_j strip1[s, t+j*d] @ W1[j] + b1))
//   h[s,t]   = qa(relu(sum_j [hist2|mid][s, t+j*d] @ W2[j] + b2 + res))
//   res      = strip1[s, n+t] @ down_w[0] + down_b, or strip1[s, n+t]
// qa is the u4 activation fake-quant when `quantize`; weights are fp32 or
// nibble-packed log2 codes decoded in the kernel (log2_decode.cuh).
//
// Design.  The TPU kernel held a slot's whole strip in VMEM; the FSL embed's
// strip1 alone is (384+784)x32x4 B ~ 150 KB per slot, and conv2 reads mid up
// to (k-1)*d rows back, so here mid goes through global memory: launch 1
// writes mid for all T, launch 2 reads [hist2 | mid].  One thread per output
// element (s, t, c_out); consecutive threads take consecutive c_out, so a
// warp reads one activation row as a broadcast and the weights coalesced,
// all through L1/L2.
//
// Bound on this card.  Per output position the block does
// 2*k*(Cin+C)*C (+2*Cin*C for the down projection) flops; its unique traffic
// is the two history strips ((k-1)*d rows of Cin and of C) plus a strip row
// in and h and mid out per position.  For the FSL embed (T=784) that is
// ~57-75 flops per byte, above the fp32 ridge of ~20 flops/byte (67 TFLOP/s
// over 3.35 TB/s), so the fp32 rate bounds it; for a serve chunk (T=16) the
// histories dominate at large d and bytes bound it.  This simple design
// issues a separate multiply and add per term (2 instructions where an FMA
// would be 1), reads every tap through L1, uses no tensor cores and leaves
// most of the card idle at serve shapes; tiling the taps through shared
// memory, an MMA path and fusing the blocks of a chunk are later work.
//
// Fixed summation order: taps j = 0..k-1 outside, input channels in order
// inside, one separately rounded multiply and add per term (__fmul_rn /
// __fadd_rn are never contracted into FMA).  No output depends on T or S,
// which is what keeps chunk-size invariance and park/resume bit-exact, and
// it is the order kernels/ref.py repeats on the CPU.
#include <cstdint>
#include <cuda_runtime.h>

#include "log2_decode.cuh"

namespace {

constexpr int kThreads = 256;

// W[row, co] of a (rows, C) weight matrix, fp32 or packed (rows, C/2) bytes.
__device__ __forceinline__ float load_w(const void* w, int packed, float scale,
                                        long row, int C, int co) {
  if (!packed) return __ldg(static_cast<const float*>(w) + row * C + co);
  const uint8_t* codes = static_cast<const uint8_t*>(w);
  return log2_decode(__ldg(codes + row * (C / 2) + (co >> 1)), co & 1, scale);
}

__global__ void conv1_kernel(const float* __restrict__ strip1, const void* w1,
                             const float* w1_scale, int w1_packed,
                             const float* __restrict__ b1, float* __restrict__ mid,
                             int S, int L1, int T, int Cin, int C, int k, int d,
                             int quantize, float act_scale) {
  long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long total = static_cast<long>(S) * T * C;
  if (idx >= total) return;
  int co = static_cast<int>(idx % C);
  long st = idx / C;
  int t = static_cast<int>(st % T);
  long s = st / T;
  float scale = w1_packed ? __ldg(w1_scale) : 0.0f;
  const float* x = strip1 + s * L1 * Cin;
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float* xr = x + static_cast<long>(t + j * d) * Cin;
    for (int ci = 0; ci < Cin; ++ci) {
      float w = load_w(w1, w1_packed, scale, static_cast<long>(j) * Cin + ci, C, co);
      acc = __fadd_rn(acc, __fmul_rn(__ldg(xr + ci), w));
    }
  }
  float y = relu_f(__fadd_rn(acc, __ldg(b1 + co)));
  mid[idx] = quantize ? fake_quant_u4(y, act_scale) : y;
}

__global__ void conv2_kernel(const float* __restrict__ strip1,
                             const float* __restrict__ hist2,
                             const float* __restrict__ mid, const void* w2,
                             const float* w2_scale, int w2_packed,
                             const float* __restrict__ b2, const void* dw,
                             const float* dw_scale, int dw_packed,
                             const float* __restrict__ db, float* __restrict__ h,
                             int S, int L1, int n, int T, int Cin, int C, int k,
                             int d, int quantize, float act_scale) {
  long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long total = static_cast<long>(S) * T * C;
  if (idx >= total) return;
  int co = static_cast<int>(idx % C);
  long st = idx / C;
  int t = static_cast<int>(st % T);
  long s = st / T;
  float scale2 = w2_packed ? __ldg(w2_scale) : 0.0f;
  float acc = 0.0f;
  for (int j = 0; j < k; ++j) {
    int r = t + j * d;  // row of strip2 = [hist2 (n rows) | mid (T rows)]
    const float* row = r < n ? hist2 + (s * n + r) * C
                             : mid + (s * T + (r - n)) * C;
    for (int c = 0; c < C; ++c) {
      float w = load_w(w2, w2_packed, scale2, static_cast<long>(j) * C + c, C, co);
      acc = __fadd_rn(acc, __fmul_rn(__ldg(row + c), w));
    }
  }
  float y2 = __fadd_rn(acc, __ldg(b2 + co));
  const float* xc = strip1 + (s * L1 + n + t) * Cin;
  float res;
  if (dw != nullptr) {
    float scaled = dw_packed ? __ldg(dw_scale) : 0.0f;
    float r = 0.0f;
    for (int ci = 0; ci < Cin; ++ci)
      r = __fadd_rn(r, __fmul_rn(__ldg(xc + ci), load_w(dw, dw_packed, scaled, ci, C, co)));
    res = __fadd_rn(r, __ldg(db + co));
  } else {
    res = __ldg(xc + co);  // identity residual: Cin == C
  }
  float out = relu_f(__fadd_rn(y2, res));
  h[idx] = quantize ? fake_quant_u4(out, act_scale) : out;
}

int blocks_for(long total) { return static_cast<int>((total + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Launch 1: mid (S, T, C) from strip1 (S, L1, Cin).  Returns cudaGetLastError().
int tcn_block_conv1(const float* strip1, const void* w1, const float* w1_scale,
                    int w1_packed, const float* b1, float* mid, int S, int L1,
                    int T, int Cin, int C, int k, int d, int quantize,
                    float act_scale, void* stream) {
  long total = static_cast<long>(S) * T * C;
  conv1_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      strip1, w1, w1_scale, w1_packed, b1, mid, S, L1, T, Cin, C, k, d,
      quantize, act_scale);
  return static_cast<int>(cudaGetLastError());
}

// Launch 2: h (S, T, C) from [hist2 | mid] and the residual.  dw == nullptr
// means an identity residual.  Returns cudaGetLastError().
int tcn_block_conv2(const float* strip1, const float* hist2, const float* mid,
                    const void* w2, const float* w2_scale, int w2_packed,
                    const float* b2, const void* dw, const float* dw_scale,
                    int dw_packed, const float* db, float* h, int S, int L1,
                    int n, int T, int Cin, int C, int k, int d, int quantize,
                    float act_scale, void* stream) {
  long total = static_cast<long>(S) * T * C;
  conv2_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      strip1, hist2, mid, w2, w2_scale, w2_packed, b2, dw, dw_scale, dw_packed,
      db, h, S, L1, n, T, Cin, C, k, d, quantize, act_scale);
  return static_cast<int>(cudaGetLastError());
}

const char* tcn_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
