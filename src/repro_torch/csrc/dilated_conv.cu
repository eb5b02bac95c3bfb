// Causal dilated conv1d for Hopper (sm_90a) — replaces the Pallas kernel
// repro/kernels/dilated_conv.py::dilated_causal_conv (_kernel).
//
// What it computes, per batch row b, time t and output channel co:
//   out[b, t, co] = sum_ci sum_j x[b, t + j*d - (K-1)*d, ci] * w[j, ci, co]
//                   + bias[co]
// with x rows before t = 0 reading zero (causal left padding).  Layouts are
// the reference's: x (B, T, Cin) channel-last, w (K, Cin, Cout), out
// (B, T, Cout), all fp32.
//
// Bound on this card.  2*B*T*K*Cin*Cout flops against B*T*(Cin+Cout)*4
// bytes (+ the weights): at TCN widths (Cin = Cout = 24, K = 7) that is ~84
// flops per byte, above the fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so
// the fp32 rate bounds it.  At Cin = 1 (block 0's conv1 and 1x1 down
// projection) bytes bound it.  The tensor cores are out of reach: the
// weights are arbitrary fp32, TF32 is ruled out (it keeps 10 mantissa
// bits), and an exact bf16 split of both operands would take at least six
// bf16 products per term to keep fp32 accuracy.  So this is full-fp32 FMA
// on the CUDA cores, and the design keeps those busy.
//
// Design.  The TPU kernel held a batch row's whole left-padded strip in
// VMEM (T + (K-1)*d rows: 28,288 at the raw-audio preset, far above a
// Hopper block's 227 KB), so here T is tiled, with dilation-strided
// columns as in tcn_block.cu: column c = s*d + v (v < d) holds the 8
// positions s*8d + v + i*d, i = 0..7.  The K taps of those 8 outputs read
// the K + 7 rows s*8d + v + m*d, m = -(K-1)..7, so a column's rows are
// staged once and every tap reuses them: the union of the taps' rows, at
// every dilation, in (K+7)/8 of the tile's own rows.  One CTA of 4 warps
// owns 32 columns (256 positions) of one batch row and a tile of 24 or 32
// output channels (6 or 8 a warp, chosen from Cout so that Cout = 24 and
// Cout = 32 idle no thread): lane = column, each thread an 8 x 6 (8 x 8)
// register tile.  Per input channel a thread loads its column's K+7 rows
// (x staged as [ci][row][column], consecutive lanes on consecutive words)
// and its channels' weights per tap (one warp reads the same address: a
// broadcast), then does 8*6*K FMAs: at K = 7, 336 FMAs per 35 shared
// loads.  Rows, weights and biases are staged with cp.async, all copies in
// flight at once (rows outside [0, T) zero-filled).  Input channels are
// staged in chunks of at most 12 when the grid is large (the audio
// forward's 504 CTAs then fit on the card at once, ~34 KB each) and all at
// once when it is small.  Outputs go through shared memory so each
// position's channels leave in one coalesced run.
//
// Summation order, fixed per output: input channels in order outside, taps
// j = 0..K-1 inside, one FMA each, then the bias.  An output never depends
// on rows after its own position, on T, or on the tile it lands in, so
// out[:, :t0] is bit-identical whatever x[:, t0:] holds, and runs repeat
// bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;      // columns per CTA: one per lane
constexpr int kPos = 8;        // positions per column (strided by d)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCiChunk = 12;   // input channels staged at once in a large grid
constexpr int kMaxSmem = 232448;

// 4-byte asynchronous copy global -> shared; src_bytes 0 writes zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// first position of column c: s*8d + v for c = s*d + v
__device__ __forceinline__ int col_base(int c, int d) {
  const int s = c / d;
  return s * kPos * d + (c - s * d);
}

// Shared memory, in floats: [x staging | epilogue], the weights, the
// biases, then the 32 column bases (ints).
__host__ __device__ inline int region_floats(int cic, int K, int cot) {
  const int xs = cic * ((K + kPos - 1) * kCols + 1);
  const int os = kPos * kCols * (cot + 4);
  return ((xs > os ? xs : os) + 3) / 4 * 4;
}

__host__ __device__ inline int smem_bytes(int cic, int K, int cot) {
  return 4 * (region_floats(cic, K, cot) + K * cic * cot + cot + kCols);
}

// kK: the taps (0: any K, read at run time); kCoW: output channels a warp
// handles per thread (the CTA's tile is 4 * kCoW).
template <int kK, int kCoW>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, int T,
            int Cin, int Cout, int K_rt, int d, int cic, int ncols) {
  // epilogue rows padded to 16 bytes: float4 reads, 2-way conflicts at most
  constexpr int kCoT = kCoW * kWarps, kOutLd = kCoT + 4;
  const int K = kK ? kK : K_rt;
  const int nrows = K + kPos - 1;
  const int sx = nrows * kCols + 1;  // floats per staged input channel
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // [ci][row][column], channel stride sx
  float* os = smem;  // epilogue, after the last chunk: [i][column][co]
  float* ws = smem + region_floats(cic, K, kCoT);  // [j][ci][co]
  float* bs = ws + K * cic * kCoT;                  // [co]
  int* base = reinterpret_cast<int*>(bs + kCoT);
  const int tid = threadIdx.x, lane = tid % 32, cg = tid / 32;
  const long b = blockIdx.z;
  const int co0 = blockIdx.y * kCoT;
  const int nco = min(kCoT, Cout - co0);
  const int c_first = blockIdx.x * kCols;
  if (col_base(c_first, d) >= T) return;  // the whole tile is past T
  if (tid < kCols) {
    const int c = c_first + tid;
    base[tid] = c < ncols ? col_base(c, d) : T;  // T: nothing to load or store
  } else if (tid < kCols + kCoT) {
    const int co = tid - kCols;
    cp_async4(bs + co, co < nco ? bias + co0 + co : bias, co < nco ? 4 : 0);
  }
  const float* xb = x + b * T * Cin;
  const bool active = cg * kCoW < nco;  // warp-uniform
  float acc[kPos][kCoW] = {};
  for (int ci0 = 0; ci0 < Cin; ci0 += cic) {
    const int nc = min(cic, Cin - ci0);
    __syncthreads();  // bases written; the previous chunk's reads done
    // x rows, element e = (row*32 + column)*nc + ci, and the weights,
    // element (j*nc + ci)*kCoT + co, both stepped without a division
    {
      const int total = nrows * kCols * nc;
      int rc = tid / nc, ci = tid % nc;
      const int drc = kThreads / nc, dci = kThreads % nc;
#pragma unroll 4
      for (int e = tid; e < total; e += kThreads) {
        const int cb = base[rc % kCols];
        const int q = cb + (rc / kCols - (K - 1)) * d;
        const bool in = q >= 0 && q < T && cb < T;
        cp_async4(xs + ci * sx + rc,
                  in ? xb + static_cast<long>(q) * Cin + ci0 + ci : xb, in ? 4 : 0);
        ci += dci;
        rc += drc;
        if (ci >= nc) {
          ci -= nc;
          ++rc;
        }
      }
    }
    {
      int jc = tid / kCoT, co = tid % kCoT;
      constexpr int djc = kThreads / kCoT, dco = kThreads % kCoT;
      for (int e = tid; e < K * nc * kCoT; e += kThreads) {
        const int j = jc / nc, ci = jc - j * nc;
        const bool in = co < nco;
        cp_async4(ws + e,
                  in ? w + (static_cast<long>(j) * Cin + ci0 + ci) * Cout + co0 + co : w,
                  in ? 4 : 0);
        co += dco;
        jc += djc;
        if (co >= kCoT) {
          co -= kCoT;
          ++jc;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    for (int ci = 0; ci < nc; ++ci) {
      const float* xc = xs + ci * sx + lane;
      const float* wc = ws + ci * kCoT + cg * kCoW;
      if constexpr (kK > 0) {
        float xr[kK + kPos - 1];
#pragma unroll
        for (int r = 0; r < kK + kPos - 1; ++r) xr[r] = xc[r * kCols];
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          const float2* wp = reinterpret_cast<const float2*>(wc + j * nc * kCoT);
          float wv[kCoW];
#pragma unroll
          for (int o = 0; o < kCoW / 2; ++o) {
            const float2 pair = wp[o];
            wv[2 * o] = pair.x;
            wv[2 * o + 1] = pair.y;
          }
#pragma unroll
          for (int i = 0; i < kPos; ++i)
#pragma unroll
            for (int o = 0; o < kCoW; ++o)
              acc[i][o] = fmaf(xr[i + j], wv[o], acc[i][o]);
        }
      } else {
        for (int j = 0; j < K; ++j) {
          const float2* wp = reinterpret_cast<const float2*>(wc + j * nc * kCoT);
          float wv[kCoW];
#pragma unroll
          for (int o = 0; o < kCoW / 2; ++o) {
            const float2 pair = wp[o];
            wv[2 * o] = pair.x;
            wv[2 * o + 1] = pair.y;
          }
#pragma unroll
          for (int i = 0; i < kPos; ++i) {
            const float xv = xc[(i + j) * kCols];
#pragma unroll
            for (int o = 0; o < kCoW; ++o) acc[i][o] = fmaf(xv, wv[o], acc[i][o]);
          }
        }
      }
    }
  }
  __syncthreads();  // every read of xs done before the epilogue reuses it
  if (active) {
#pragma unroll
    for (int i = 0; i < kPos; ++i)
#pragma unroll
      for (int o = 0; o < kCoW; o += 2)
        *reinterpret_cast<float2*>(os + (i * kCols + lane) * kOutLd + cg * kCoW + o) =
            make_float2(acc[i][o], acc[i][o + 1]);
  }
  __syncthreads();
  // element e = (i*32 + column)*n + q, stepped without a division, of
  // n = nco/4 groups of 4 channels when every row and tile is a multiple
  // of 4 (float4 loads and stores), else of n = nco single channels
  float* ob = out + b * T * Cout + co0;
  const bool vec = Cout % 4 == 0 && nco % 4 == 0;
  const int n = vec ? nco / 4 : nco, width = vec ? 4 : 1;
  int ic = tid / n, q = tid % n;
  const int dic = kThreads / n, dq = kThreads % n;
#pragma unroll 4
  for (int e = tid; e < kPos * kCols * n; e += kThreads) {
    const int cb = base[ic % kCols];
    const int p = cb + (ic / kCols) * d;
    if (cb < T && p < T) {
      const int co = q * width;
      float* dst = ob + static_cast<long>(p) * Cout + co;
      const float* src = os + ic * kOutLd + co;
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        const float4 bv = *reinterpret_cast<const float4*>(bs + co);
        *reinterpret_cast<float4*>(dst) =
            make_float4(__fadd_rn(v.x, bv.x), __fadd_rn(v.y, bv.y),
                        __fadd_rn(v.z, bv.z), __fadd_rn(v.w, bv.w));
      } else {
        *dst = __fadd_rn(*src, bs[co]);
      }
    }
    q += dq;
    ic += dic;
    if (q >= n) {
      q -= n;
      ++ic;
    }
  }
}

template <int kK, int kCoW>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, int B, int T, int Cin, int Cout, int K, int d,
                   int ncols, cudaStream_t s) {
  constexpr int kCoT = kCoW * kWarps;
  static int granted = 0;  // dynamic shared memory allowed so far
  dim3 grid((ncols + kCols - 1) / kCols, (Cout + kCoT - 1) / kCoT, B);
  // chunks of at most 12 input channels when the grid fills the card
  // several times over (more CTAs resident), else all channels at once
  const long ctas = static_cast<long>(grid.x) * grid.y * grid.z;
  const int chunks = ctas >= 264 ? (Cin + kCiChunk - 1) / kCiChunk : 1;
  int cic = (Cin + chunks - 1) / chunks;
  while (cic > 1 && smem_bytes(cic, K, kCoT) > kMaxSmem) --cic;
  const int bytes = smem_bytes(cic, K, kCoT);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_kernel<kK, kCoW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    granted = bytes;
  }
  conv_kernel<kK, kCoW><<<grid, kThreads, bytes, s>>>(x, w, bias, out, T, Cin,
                                                      Cout, K, d, cic, ncols);
  return cudaGetLastError();
}

template <int kCoW>
cudaError_t launch_k(const float* x, const float* w, const float* bias,
                     float* out, int B, int T, int Cin, int Cout, int K, int d,
                     int ncols, cudaStream_t s) {
  switch (K) {
    case 7: return launch<7, kCoW>(x, w, bias, out, B, T, Cin, Cout, K, d, ncols, s);
    case 3: return launch<3, kCoW>(x, w, bias, out, B, T, Cin, Cout, K, d, ncols, s);
    case 1: return launch<1, kCoW>(x, w, bias, out, B, T, Cin, Cout, K, d, ncols, s);
    default: return launch<0, kCoW>(x, w, bias, out, B, T, Cin, Cout, K, d, ncols, s);
  }
}

}  // namespace

extern "C" {

// x (B, T, Cin), w (K, Cin, Cout), bias (Cout,) -> out (B, T, Cout), fp32.
// Returns cudaGetLastError() (cudaErrorInvalidValue when K is too large
// for one channel's rows in shared memory).
int dilated_conv(const float* x, const float* w, const float* bias, float* out,
                 int B, int T, int Cin, int Cout, int K, int d, void* stream) {
  const int w8 = kPos * d;
  const int ncols = (T + w8 - 1) / w8 * d;  // columns of ceil(T/8d) blocks
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 24-channel tiles where they waste fewer threads than 32-channel ones
  const int idle24 = (Cout + 23) / 24 * 24 - Cout, idle32 = (Cout + 31) / 32 * 32 - Cout;
  const cudaError_t err =
      idle24 <= idle32 ? launch_k<6>(x, w, bias, out, B, T, Cin, Cout, K, d, ncols, s)
                       : launch_k<8>(x, w, bias, out, B, T, Cin, Cout, K, d, ncols, s);
  return static_cast<int>(err);
}

const char* dilated_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
