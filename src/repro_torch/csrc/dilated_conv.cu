// Causal dilated conv1d for Hopper (sm_90a) — replaces the Pallas kernel
// repro/kernels/dilated_conv.py::dilated_causal_conv (_kernel).
//
// What it computes, per batch row b, time t and output channel co:
//   out[b, t, co] = sum_j sum_ci x[b, t + j*d - (K-1)*d, ci] * w[j, ci, co]
//                   + bias[co]
// with x rows before t = 0 reading zero (causal left padding).  Layouts are
// the reference's: x (B, T, Cin) channel-last, w (K, Cin, Cout), out
// (B, T, Cout), all fp32.
//
// Design.  The TPU kernel held a batch row's whole left-padded strip in VMEM
// (T + (K-1)*d rows); at the raw-audio preset that is 28,288 rows, far above
// a Hopper block's 227 KB of shared memory, so here T is tiled.  One block
// of 256 threads owns 64 time rows x 32 output channels of one batch row.
// It walks the taps j = 0..K-1 and, inside, the input channels in chunks of
// 32: each step stages the tap's 64 input rows (rows t0 + r + j*d - (K-1)*d,
// zero where that is negative, so the padded input is never materialized)
// and the matching 32x32 weight tile in shared memory, then each thread
// accumulates 8 outputs (rows ty + 8*i, channel tx) with fp32 FMA.  Any T
// (also T < (K-1)*d), any Cout (masked, no tile padding) and any d work.
// The summation order is fixed (taps outside, channels in order inside), so
// out[:, :t0] is bit-identical whatever x[:, t0:] holds.
//
// Bound on this card.  2*B*T*K*Cin*Cout flops against B*T*(Cin+Cout)*4 bytes
// (+ the weights): at TCN widths (Cin = Cout = 24, K = 7) that is ~84 flops
// per byte, above the fp32 ridge (~20), so the fp32 rate bounds it.  At
// Cin = 1 (block 0's conv1 and 1x1 down projection) bytes bound it.  This
// simple design re-reads each input row K times (once per tap, through L2),
// uses no tensor cores and, with Cout = 24, leaves a quarter of its threads
// idle; staging the union of the taps' rows once per tile and an MMA path
// are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kTT = 64, kCO = 32, kCI = 32, kThreads = 256;
constexpr int kRows = kTT / (kThreads / kCO);  // outputs per thread: 8

__global__ void __launch_bounds__(kThreads)
dilated_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int T, int Cin, int Cout, int K, int d) {
  __shared__ float xs[kTT][kCI + 1];
  __shared__ float ws[kCI][kCO];
  const int tid = threadIdx.x;
  const int tx = tid % kCO, ty = tid / kCO;
  const int t0 = blockIdx.x * kTT, co0 = blockIdx.y * kCO;
  const long b = blockIdx.z;
  const float* xb = x + b * T * Cin;
  float acc[kRows] = {};
  for (int j = 0; j < K; ++j) {
    const int shift = (K - 1 - j) * d;  // tap j reads x[t - shift]
    for (int ci0 = 0; ci0 < Cin; ci0 += kCI) {
      for (int e = tid; e < kTT * kCI; e += kThreads) {
        int r = e / kCI, c = e % kCI;
        int src = t0 + r - shift, ci = ci0 + c;
        xs[r][c] = (src >= 0 && src < T && ci < Cin)
                       ? __ldg(xb + static_cast<long>(src) * Cin + ci)
                       : 0.0f;
      }
      for (int e = tid; e < kCI * kCO; e += kThreads) {
        int r = e / kCO, c = e % kCO;
        int ci = ci0 + r, co = co0 + c;
        ws[r][c] = (ci < Cin && co < Cout)
                       ? __ldg(w + (static_cast<long>(j) * Cin + ci) * Cout + co)
                       : 0.0f;
      }
      __syncthreads();
      const int nc = min(kCI, Cin - ci0);
      for (int c = 0; c < nc; ++c) {
        float wv = ws[c][tx];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i] = fmaf(xs[ty + 8 * i][c], wv, acc[i]);
      }
      __syncthreads();
    }
  }
  const int co = co0 + tx;
  if (co >= Cout) return;
  const float bv = __ldg(bias + co);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    int t = t0 + ty + 8 * i;
    if (t < T) out[(b * T + t) * Cout + co] = acc[i] + bv;
  }
}

}  // namespace

extern "C" {

// x (B, T, Cin), w (K, Cin, Cout), bias (Cout,) -> out (B, T, Cout), fp32.
// Returns cudaGetLastError().
int dilated_conv(const float* x, const float* w, const float* bias, float* out,
                 int B, int T, int Cin, int Cout, int K, int d, void* stream) {
  dim3 grid((T + kTT - 1) / kTT, (Cout + kCO - 1) / kCO, B);
  dilated_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, T, Cin, Cout, K, d);
  return static_cast<int>(cudaGetLastError());
}

const char* dilated_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
