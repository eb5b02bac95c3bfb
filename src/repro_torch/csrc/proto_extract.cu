// Fused prototypical parameter extraction for Hopper (sm_90a) — replaces the
// Pallas kernel repro/kernels/proto_extract.py::proto_extract (_kernel).
//
// Eq. 3 + 6 in one pass:  W = onehot @ emb  (class-wise shot sums) and
// b = -(sum_v W^2) * 1/(2k), the square-and-reduce done on chip right after
// the sums, so W never makes a round trip through device memory for b.
//
// Two entries, one kernel template.  The one-hot entry reads the (N, Nk)
// fp32 dispatch matrix as given (the op's contract: W = onehot @ emb, what
// the TPU kernel computes).  The label entry reads the (Nk,) int32 or int64
// label vector: shot i counts for way n where labels[i] == n, and a label
// outside [0, N) counts for no way.  On finite embeddings that is bit for
// bit the one-hot entry on one_hot(labels, N).T (0 * e adds an exact zero
// there, +0 here), so `adapt` needs no one-hot, cast or transpose launch
// before the kernel.
//
// What bounds it.  The main path's shapes are a few KB to 160 KB: (N=5,
// Nk=25, V=64) in FSL and training, (5, 5, 1,024) and (5, 5, 8,192) in
// `adapt` over the front-end bundles.  Bytes over 3.35 TB/s take 2-100 ns,
// so the kernel is bound by latency: the launch, the memory round trips and
// the barriers.  The design spends as few of each as the order of the sums
// allows.
//
// Design.
//  * Grid (C, N): way n's columns are split over C CTAs that form one
//    thread-block cluster along V, C = min(8, ceil(V / 1,024)): C = 1 at
//    V <= 1,024, C = 8 at V = 8,192, so each CTA has at most ~1,024 columns
//    and the wide shapes fill 40 SMs instead of 5.  A CTA walks its columns
//    in tiles of kTileCols, one column a thread.
//  * All loads in flight, then the sums.  A CTA copies its (shots x tile)
//    slab of emb into shared memory with cp.async (16 bytes a copy when
//    V % 4 == 0 and emb is 16-byte aligned, 4 bytes otherwise), loads the
//    way's one-hot row or labels beside it, and waits once.  A slab larger
//    than the 44 KB budget goes in chunks of shots, one wait each.  A few KB
//    do not pay for a TMA tensor map, its descriptor and its mbarrier.
//  * Each column is then summed over the shots in shot order, one rounded
//    multiply and add per shot (__fmul_rn/__fadd_rn, never contracted), as
//    kernels/ref.proto_extract_ref sums: W is bit for bit the plain
//    version's.  (Reading several shots from the slab before adding them
//    was tried: it made neither entry faster on the H100.)
//  * b in a fixed order, one barrier a level: each thread squares and sums
//    its own columns in column order, the warp sums through a shuffle tree,
//    the CTA sums its warps in warp order through shared memory, and the
//    cluster's rank 0 sums the CTAs' partials in rank order: each rank
//    stores its partial into rank 0's shared memory (distributed shared
//    memory) before one cluster.sync().  The order depends on the shape
//    alone, so b repeats bit for bit from call to call; it is not the plain
//    version's order and is held to it at rtol 1e-5, atol 1e-6.  A remote
//    store needs every CTA of the cluster running: a relaxed cluster arrive
//    at the kernel's start, waited on just before the store, guarantees that
//    while the loads are in flight.
//  * No fallback: a launch the card refuses (a cluster it cannot place
//    included) returns its error, and the wrapper raises.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileCols = 1024;    // columns a CTA sums at once: a thread each
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kSlabFloats = 11264; // 44 KB of shared memory for a slab

// The one-hot entry: shot i weighs onehot[n, i] in way n's sum.
struct OneHot {
  const float* onehot;
  __device__ float weight(long n, int Nk, int i) const {
    return __ldg(onehot + n * Nk + i);
  }
  __device__ static float add(float acc, float w, float e) {
    return __fadd_rn(acc, __fmul_rn(w, e));
  }
};

// The label entry: shot i counts for way n where labels[i] == n.
template <typename L>
struct Labels {
  const L* labels;
  __device__ float weight(long n, int, int i) const {
    return __ldg(labels + i) == static_cast<L>(n) ? 1.0f : 0.0f;
  }
  // adding +0 for another way's shot leaves acc as it is (acc is never
  // -0: it starts at +0), so only the add waits on acc
  __device__ static float add(float acc, float w, float e) {
    return __fadd_rn(acc, w != 0.0f ? e : 0.0f);
  }
};

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of a (rows, width) block of emb (row stride V) into the
// slab (row stride `stride`), VEC floats a copy, spread over the CTA's
// threads: every copy in flight, one division a thread.
template <int VEC>
__device__ __forceinline__ void copy_slab(float* slab, const float* src,
                                          int rows, int width, int stride,
                                          long V) {
  const int w = width / VEC, step = blockDim.x;
  const int dr = step / w, dc = step - dr * w;
  int r = threadIdx.x / w, c = threadIdx.x - r * w;
  while (r < rows) {
    if (VEC == 4)
      cp_async_16(slab + r * stride + 4 * c, src + r * V + 4 * c);
    else
      cp_async_4(slab + r * stride + c, src + r * V + c);
    c += dc;
    r += dr;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

// grid (C, N), cluster (C, 1, 1) when C > 1; blockDim.x threads, a multiple
// of 32 in [32, kTileCols] and at least a tile's width; dynamic shared
// memory: kc * (stride + 1) floats.
// `cols` (a multiple of 4) columns a CTA, `stride` = min(cols, kTileCols)
// floats a slab row, `kc` shots a slab chunk.
template <bool VEC4, class Sel>
__global__ void __launch_bounds__(kTileCols)
proto_extract_kernel(const float* __restrict__ emb, Sel sel,
                     float* __restrict__ W, float* __restrict__ b, int Nk,
                     int V, int cols, int stride, int kc, float inv_2k) {
  extern __shared__ float smem[];
  float* slab = smem;                 // (kc, stride)
  float* wts = smem + kc * stride;    // (kc,) the shots' weights for way n
  __shared__ float warp_sums[kTileCols / 32];
  __shared__ float rank_sums[kMaxCluster];

  const bool clustered = gridDim.x > 1;
  if (clustered) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const long n = blockIdx.y;
  const int c_begin = blockIdx.x * cols;
  const int c_end = min(V, c_begin + cols);

  float sq = 0.0f;
  for (int t0 = c_begin; t0 < c_end; t0 += kTileCols) {
    const int width = min(kTileCols, c_end - t0);
    float acc = 0.0f;  // column t0 + tid, when tid < width
    for (int i0 = 0; i0 < Nk; i0 += kc) {
      const int rows = min(kc, Nk - i0);
      if (i0 > 0) __syncthreads();  // the last chunk's sums are done
      copy_slab<VEC4 ? 4 : 1>(slab, emb + static_cast<long>(i0) * V + t0,
                              rows, width, stride, V);
      for (int r = tid; r < rows; r += nthreads) wts[r] = sel.weight(n, Nk, i0 + r);
      cp_async_wait_all();
      __syncthreads();
      if (tid < width)
        for (int r = 0; r < rows; ++r)
          acc = Sel::add(acc, wts[r], slab[r * stride + tid]);
    }
    if (tid < width) {
      W[n * V + t0 + tid] = acc;
      sq = __fadd_rn(sq, __fmul_rn(acc, acc));
    }
    if (t0 + kTileCols < c_end) __syncthreads();  // the slab is reused
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, off));
  if ((tid & 31) == 0) warp_sums[tid >> 5] = sq;
  __syncthreads();
  float part = 0.0f;
  if (tid == 0)
    for (int w = 0; w < nthreads / 32; ++w) part = __fadd_rn(part, warp_sums[w]);
  if (!clustered) {
    if (tid == 0) b[n] = __fmul_rn(-part, inv_2k);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid == 0) cluster.map_shared_rank(rank_sums, 0)[rank] = part;
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float total = 0.0f;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
      total = __fadd_rn(total, rank_sums[r]);
    b[n] = __fmul_rn(-total, inv_2k);
  }
}

template <bool VEC4, class Sel>
int launch(const float* emb, Sel sel, float* W, float* b, int N, int Nk,
           int V, float inv_2k, cudaStream_t stream) {
  // C CTAs a way, each with a few hundred to ~1,024 columns (a multiple of 4)
  const int C = std::min(kMaxCluster, (V + kTileCols - 1) / kTileCols);
  const int cols = ((V + C - 1) / C + 3) / 4 * 4;
  const int stride = std::min(cols, kTileCols);
  const int threads = (stride + 31) / 32 * 32;
  const int kc = std::max(1, std::min(Nk, kSlabFloats / (stride + 1)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, N, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(kc) * (stride + 1) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, proto_extract_kernel<VEC4, Sel>, emb, sel, W, b, Nk, V, cols,
      stride, kc, inv_2k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <class Sel>
int dispatch(const float* emb, Sel sel, float* W, float* b, int N, int Nk,
             int V, float inv_2k, void* stream) {
  const bool vec4 = V % 4 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  return vec4 ? launch<true>(emb, sel, W, b, N, Nk, V, inv_2k, s)
              : launch<false>(emb, sel, W, b, N, Nk, V, inv_2k, s);
}

}  // namespace

extern "C" {

// emb (Nk, V), onehot (N, Nk) -> W (N, V), b (N,).  N <= 65,535.  Returns
// the launch's error, else cudaGetLastError().
int proto_extract(const float* emb, const float* onehot, float* W, float* b,
                  int N, int Nk, int V, float inv_2k, void* stream) {
  return dispatch(emb, OneHot{onehot}, W, b, N, Nk, V, inv_2k, stream);
}

// emb (Nk, V), labels (Nk,) of `label_bytes` 4 (int32) or 8 (int64) -> W
// (N, V), b (N,).  N <= 65,535.  Returns as proto_extract does.
int proto_extract_labels(const float* emb, const void* labels, int label_bytes,
                         float* W, float* b, int N, int Nk, int V,
                         float inv_2k, void* stream) {
  if (label_bytes == 8)
    return dispatch(emb, Labels<long long>{static_cast<const long long*>(labels)},
                    W, b, N, Nk, V, inv_2k, stream);
  if (label_bytes == 4)
    return dispatch(emb, Labels<int>{static_cast<const int*>(labels)}, W, b,
                    N, Nk, V, inv_2k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* proto_extract_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
