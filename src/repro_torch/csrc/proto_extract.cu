// Fused prototypical parameter extraction for Hopper (sm_90a) — replaces the
// Pallas kernel repro/kernels/proto_extract.py::proto_extract (_kernel).
//
// Eq. 3 + 6 in one pass:  W = onehot @ emb  (class-wise shot sums) and
// b = -(sum_v W^2) * 1/(2k), the square-and-reduce done on chip right after
// the sums, so W never makes a round trip through device memory for b.
//
// Design.  One block per way, threads over V.  Each thread sums its column
// over the Nk shots in shot order, reading the one-hot row as given (no
// label gather on the host, so it computes what the TPU kernel computes),
// then the block reduces W^2 through shared memory in a fixed tree order.
//
// Bound on this card.  At the main path's shapes (N=5, Nk<=25, V=64) the
// inputs are a few KB: the kernel is bound by launch latency, far from both
// the memory and the fp32 rate.  Nothing here is worth tiling until N or V
// grow by orders of magnitude.
#include <cuda_runtime.h>

namespace {

__global__ void proto_extract_kernel(const float* __restrict__ emb,
                                     const float* __restrict__ onehot,
                                     float* __restrict__ W, float* __restrict__ b,
                                     int Nk, int V, float inv_2k) {
  extern __shared__ float red[];
  const long n = blockIdx.x;
  const float* oh = onehot + n * Nk;
  float sq = 0.0f;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    float acc = 0.0f;
    for (int i = 0; i < Nk; ++i)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(oh + i), __ldg(emb + static_cast<long>(i) * V + v)));
    W[n * V + v] = acc;
    sq = __fadd_rn(sq, __fmul_rn(acc, acc));
  }
  red[threadIdx.x] = sq;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + stride]);
    __syncthreads();
  }
  if (threadIdx.x == 0) b[n] = __fmul_rn(-red[0], inv_2k);
}

}  // namespace

extern "C" {

// emb (Nk, V), onehot (N, Nk) -> W (N, V), b (N,).  `threads` is a power of
// two in [32, 1024].  Returns cudaGetLastError().
int proto_extract(const float* emb, const float* onehot, float* W, float* b,
                  int N, int Nk, int V, float inv_2k, int threads, void* stream) {
  proto_extract_kernel<<<N, threads, threads * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(
      emb, onehot, W, b, Nk, V, inv_2k);
  return static_cast<int>(cudaGetLastError());
}

const char* proto_extract_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
