// Fused TCN residual blocks for Hopper (sm_90a) — replaces the Pallas kernel
// repro/kernels/tcn_block.py::tcn_block_pallas (body _block_kernel).
//
// What a block computes, per slot s and chunk position t (n = (k-1)*d):
//   mid[s,t] = qa(relu(sum_j strip1[s, t+j*d] @ W1[j] + b1))
//   h[s,t]   = qa(relu(sum_j [hist2|mid][s, t+j*d] @ W2[j] + b2 + res))
//   res      = strip1[s, n+t] @ down_w[0] + down_b, or strip1[s, n+t]
// qa is the u4 activation fake-quant when `quantize`; weights are fp32 or
// nibble-packed log2 codes, decoded once per CTA into shared memory
// (log2_decode.cuh).
//
// Two entry points, one for each way the main path runs the block.
//
// tcn_chunk — the serve path: ONE launch advances the whole TCN body of a
// slot grid over a chunk (every block, in order).  One CTA per slot keeps the
// block input, `mid` and the block output (T x C each) in shared memory
// between blocks and stages each block's decoded weights there.  History taps
// are read in place from the rings in the reference's circular layout: strip
// row r < n is ring[(t + r) mod n], rows r >= n are chunk rows already in
// shared memory, so no time-ordered copy of a ring is ever built; each conv
// stages only the (k-1)*min(d, T) history rows its taps touch.  Rings and t
// are updated in place: only the chunk's new rows are written (position
// t + u lands on row (t + u) mod n, for the last min(L, n) of the L valid
// rows), after the CTA's last read of that ring, and t += L; L = 0 freezes
// the slot.  (The wrapper's functional call clones the rings first.)
//   Bound on this card: at serve shapes (S=64, T=16) the whole 12-block audio
//   tick needs ~13 MB in place and ~0.19 GFLOP, a few microseconds either
//   way.  What bounds it is latency: one CTA per slot (64 of 132 SMs) walks
//   24 convs in order, each output a dependent chain of k*Cin rounded adds,
//   with a global load of the history rows and a __syncthreads between
//   phases.  So a tick makes one launch, gathers and concatenates no ring,
//   and moves only the rows its taps touch; short chunks give each thread
//   one output so that T*C threads (up to 512) share the latency.  Shared
//   memory bounds the chunk length: the wrapper raises for a T that does
//   not fit.
//
// tcn_block_conv1 / tcn_block_conv2 — long sequences (FSL episodes at
// T=784, audio enrollment at S=25, T=16,000): the strip entry, two launches
// per block because conv2 reads `mid` up to (k-1)*d rows back, across tiles,
// so `mid` goes through global memory between them.  A CTA takes 64 output
// positions of one slot and all C outputs, as a dilation-strided tile:
// positions a*d + v for R consecutive a and V consecutive v (V = min(d, 8),
// R*V = 64), so the k taps of the tile's outputs overlap and it stages only
// (R+k-1)*V rows (at most 112 once there are 8 rows of a, where 64
// consecutive positions at d >= 64 need 448).  The rows and the decoded
// weights go to shared memory once, by cp.async, and each thread keeps a
// 2-row x 4-channel register tile.
//   Bound on this card: 57-75 flops per byte at these shapes, above the fp32
//   ridge (~20 flops/byte), so the fp32 rate bounds it.
//
// Fixed summation order (both entries): taps j = 0..k-1 outside, input
// channels in order inside, one separately rounded multiply and add per term
// (__fmul_rn / __fadd_rn are never contracted into an FMA); no tensor cores
// (TF32 is forbidden and fp32 has no exact MMA path).  No output depends on
// T, S or the tiling, which keeps chunk-size invariance, park/resume and
// fused == per-step exact, and kernels/ref.py repeats the order on the CPU.
// The price: two instructions per term where an FMA is one, so the CUDA
// cores reach at most half their 67 TFLOP/s fp32 rate (33.5 TFLOP/s).
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "log2_decode.cuh"

namespace {

constexpr int kMaxBlocks = 16;      // blocks one tcn_chunk launch walks
constexpr int kChunkThreads = 512;
constexpr int kChunkTileFrom = 32;  // chunks this long get the register tile
constexpr int kChunkShortCO = 1;    // output channels per thread below that
constexpr int kTile = 64;           // strip entry: outputs per CTA (x C)
constexpr int kStripV = 8;          // strip entry: tile columns once d >= 8
constexpr int kStripRT = 2;         // strip entry: rows per thread
constexpr int kStripThreadsPerGroup = kTile / kStripRT;  // x C/4 per CTA
constexpr int kMaxSmem = 232448;    // shared memory one block may use

// One block of a tcn_chunk launch; the layout is mirrored by ctypes in
// kernels/tcn_block.py (_BlockDesc).
struct BlockDesc {
  float* ring1;  // read, then the new rows written, in place
  float* ring2;
  const void* w1;
  const float* w1_scale;
  const void* w2;
  const float* w2_scale;
  const void* dw;  // nullptr: identity residual
  const float* dw_scale;
  const float* b1;
  const float* b2;
  const float* db;
  int n, d, cin, c;
  int w1_packed, w2_packed, dw_packed, pad;
};

struct ChunkArgs {
  BlockDesc blk[kMaxBlocks];
  int* t;  // read, then advanced by the length, in place
  const float* x;
  const int* lengths;
  float* h;
  int n_blocks, T, k, quantize, ld, m_max, w_floats;
  float act_scale;
};

// Row stride of staged activations: odd, so the rows a warp reads at once
// fall in different banks.
__host__ __device__ __forceinline__ int odd_ld(int c) { return c | 1; }
__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A (rows, C) weight matrix, fp32 (copied) or packed (rows, C/2) bytes
// (decoded), into shared memory.
__device__ void stage_weight(float* dst, const void* w, const float* scale,
                             int packed, int rows, int C) {
  const int total = rows * C;
  if (!packed) {
    const float* src = static_cast<const float*>(w);
    for (int i = threadIdx.x; i < total; i += blockDim.x) cp_async4(dst + i, src + i);
    return;
  }
  const uint8_t* codes = static_cast<const uint8_t*>(w);
  const float sc = __ldg(scale);
  // C is even, so element i sits in byte i/2, nibble i&1; eight elements
  // per 32-bit load (the codes are 4-byte aligned), then the tail by bytes
  const int words = total / 8;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(codes) + i);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[8 * i + e] = log2_decode(static_cast<uint8_t>(v >> (8 * (e / 2))), e & 1, sc);
  }
  for (int i = 8 * words + threadIdx.x; i < total; i += blockDim.x)
    dst[i] = log2_decode(__ldg(codes + i / 2), i & 1, sc);
}

__device__ void stage_vec(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
}

// CO consecutive floats of shared memory (CO = 1 or 4; 16-byte aligned
// for 4).
template <int CO>
__device__ __forceinline__ void load_vec(float (&v)[CO], const float* p) {
  if constexpr (CO == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int q = 0; q < CO; ++q) v[q] = p[q];
  }
}

// Register-tiled conv over staged rows: row(j, u) points at the tap-j input
// row of output row u.  Each thread takes RT rows x CO output channels; per
// output the sum runs taps outside, channels in order inside, one rounded
// multiply and one rounded add per term.  Input channels go in batches of
// kB: a batch's products are formed together, and the next batch's
// operands are loaded while its adds run, so the chain of dependent adds
// does not wait on shared memory.  epi(u, co, acc) writes.
template <int RT, int CO, class Rows, class Epi>
__device__ __forceinline__ void conv_rows(const Rows& row,
                                          const float* __restrict__ w, int cin,
                                          int C, int k, int rows,
                                          const Epi& epi) {
  constexpr int kB = RT * CO >= 8 ? 4 : 8 / (RT * CO);
  const int groups = C / CO;
  const int items = ((rows + RT - 1) / RT) * groups;
  const int full = cin / kB * kB;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int co = (item % groups) * CO;
    const int u0 = (item / groups) * RT;
    float acc[RT][CO];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int q = 0; q < CO; ++q) acc[i][q] = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float* a[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = row(j, min(u0 + i, rows - 1));
      const float* wp = w + j * cin * C + co;
      float xv[kB][RT], wv[kB][CO];
      auto load = [&](int c0) {
#pragma unroll
        for (int e = 0; e < kB; ++e) {
          load_vec<CO>(wv[e], wp + e * C);
#pragma unroll
          for (int i = 0; i < RT; ++i) xv[e][i] = a[i][c0 + e];
        }
        wp += kB * C;
      };
      if (full > 0) load(0);
      for (int c0 = 0; c0 < full; c0 += kB) {
        float p[kB][RT][CO];
#pragma unroll
        for (int e = 0; e < kB; ++e)
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int q = 0; q < CO; ++q) p[e][i][q] = __fmul_rn(xv[e][i], wv[e][q]);
        if (c0 + kB < full) load(c0 + kB);
#pragma unroll
        for (int e = 0; e < kB; ++e)
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int q = 0; q < CO; ++q) acc[i][q] = __fadd_rn(acc[i][q], p[e][i][q]);
      }
      for (int ci = full; ci < cin; ++ci, wp += C) {
        float wr[CO];
        load_vec<CO>(wr, wp);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float x = a[i][ci];
#pragma unroll
          for (int q = 0; q < CO; ++q) acc[i][q] = __fadd_rn(acc[i][q], __fmul_rn(x, wr[q]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
      if (u0 + i < rows) epi(u0 + i, co, acc[i]);
  }
}

// Tap rows of a strip staged as a whole: row (j, u) is staged row j*m + u.
struct StagedRows {
  const float* stg;
  int ld, m;
  __device__ const float* operator()(int j, int u) const {
    return stg + (j * m + u) * ld;
  }
};

// Tap rows of [history | chunk] in the chunk kernel: strip row r = j*d + u
// is staged history row (r/d)*m + r%d when r < n (only the history rows
// the taps touch are staged), else chunk row r - n.
struct ChunkRows {
  const float* hist;
  const float* chunk;
  int ld, m, d, n;
  __device__ const float* operator()(int j, int u) const {
    const int r = j * d + u;
    if (r >= n) return chunk + (r - n) * ld;
    return hist + ((r / d) * m + r % d) * ld;
  }
};

// Rows of a strip into shared memory: staged row q (stride ld) <- src(q), a
// global row of cw floats, by cp.async, or zeros where src(q) is null;
// consecutive threads take consecutive elements.
template <class Src>
__device__ void stage_rows(float* dst, int ld, int n_rows, int cw, const Src& src) {
  const int total = n_rows * cw;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int q = i / cw, c = i - q * cw;
    const float* g = src(q);
    if (g != nullptr) cp_async4(dst + q * ld + c, g + c);
    else dst[q * ld + c] = 0.0f;
  }
}

__device__ __forceinline__ float act(float y, int quantize, float act_scale) {
  return quantize ? fake_quant_u4(y, act_scale) : y;
}

// Output rows of the chunk kernel: row u of a shared-memory buffer.
struct SmemOut {
  float* base;
  int ld;
  __device__ float* operator()(int u) const { return base + u * ld; }
};

// conv1's epilogue: mid = qa(relu(acc + b1)), into out(u) (none if null).
template <class Out>
struct Conv1Epi {
  const float* b1;
  Out out;
  int quantize;
  float act_scale;
  template <int CO>
  __device__ void operator()(int u, int co, const float (&acc)[CO]) const {
    float* o = out(u);
    if (o == nullptr) return;
#pragma unroll
    for (int q = 0; q < CO; ++q)
      o[co + q] = act(relu_f(__fadd_rn(acc[q], b1[co + q])), quantize, act_scale);
  }
};

// conv2's epilogue: h = qa(relu((acc + b2) + res)), res the 1x1 down
// projection of the block input row xin[u] (summed from 0 in channel order,
// then + db) or that row itself.
template <class Out>
struct Conv2Epi {
  const float* b2;
  const float* dw;  // smem (cin, C), nullptr for the identity
  const float* db;
  const float* xin;
  Out out;
  int ld_in, cin, C, quantize;
  float act_scale;
  template <int CO>
  __device__ void operator()(int u, int co, const float (&acc)[CO]) const {
    float* o = out(u);
    if (o == nullptr) return;
    const float* xr = xin + u * ld_in;
    float r[CO];
    if (dw != nullptr) {
#pragma unroll
      for (int q = 0; q < CO; ++q) r[q] = 0.0f;
      for (int ci = 0; ci < cin; ++ci) {
        float dv[CO];
        load_vec<CO>(dv, dw + ci * C + co);
        const float x = xr[ci];
#pragma unroll
        for (int q = 0; q < CO; ++q) r[q] = __fadd_rn(r[q], __fmul_rn(x, dv[q]));
      }
#pragma unroll
      for (int q = 0; q < CO; ++q) r[q] = __fadd_rn(r[q], db[co + q]);
    } else {
#pragma unroll
      for (int q = 0; q < CO; ++q) r[q] = xr[co + q];
    }
#pragma unroll
    for (int q = 0; q < CO; ++q)
      o[co + q] = act(relu_f(__fadd_rn(__fadd_rn(acc[q], b2[co + q]), r[q])),
                      quantize, act_scale);
  }
};

// ---------------------------------------------------------------------------
// tcn_chunk
// ---------------------------------------------------------------------------

// History rows a conv's taps touch, read in place: staged row q is strip
// row r = (q/m)*d + q%m < n, which lives in ring row (t + r) mod n.
struct RingRows {
  const float* ring;
  int base, m, d, n, cw;
  __device__ const float* operator()(int q) const {
    int r = base + (q / m) * d + q % m;
    if (r >= n) r -= n;
    return ring + static_cast<long>(r) * cw;
  }
};

// The chunk's new ring rows, in place: positions t + u for u in
// [max(0, L - n), L) land on rows (t + u) mod n, all distinct.
__device__ void write_ring(float* ring, int n, int cw, int base, int L,
                           const float* chunk, int ld) {
  const int lane = threadIdx.x & 31;
  for (int u = max(L - n, 0) + (threadIdx.x >> 5); u < L; u += blockDim.x >> 5) {
    float* o = ring + static_cast<long>((base + u) % n) * cw;
    for (int c = lane; c < cw; c += 32) o[c] = chunk[u * ld + c];
  }
}

template <int RT, int CO>
__global__ void __launch_bounds__(kChunkThreads)
    chunk_kernel(const __grid_constant__ ChunkArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = blockIdx.x;
  const int T = a.T, k = a.k, ld = a.ld;
  float* W = smem;
  float* hist = W + a.w_floats;
  float* in = hist + (k - 1) * a.m_max * ld;
  float* mid = in + T * ld;
  float* out = mid + T * ld;
  const int tpos = a.t[s];
  const int L = min(max(a.lengths[s], 0), T);

  const int cin0 = a.blk[0].cin;
  const float* xs = a.x + static_cast<long>(s) * T * cin0;
  for (int i = threadIdx.x; i < T * cin0; i += blockDim.x) {
    const int u = i / cin0;
    in[u * ld + i - u * cin0] = xs[i];
  }

  for (int b = 0; b < a.n_blocks; ++b) {
    const BlockDesc& B = a.blk[b];
    const int n = B.n, d = B.d, cin = B.cin, C = B.c;
    const int m = min(d, T), base = tpos % n;
    float* w1 = W;
    float* w2 = w1 + k * cin * C;
    float* dwm = w2 + k * C * C;
    float* b1 = dwm + (B.dw != nullptr ? cin * C : 0);
    float* b2 = b1 + C;
    float* db = b2 + C;
    float* ring1 = B.ring1 + static_cast<long>(s) * n * cin;
    float* ring2 = B.ring2 + static_cast<long>(s) * n * C;

    // conv1 over [ring1 history | block input]
    stage_weight(w1, B.w1, B.w1_scale, B.w1_packed, k * cin, C);
    stage_weight(w2, B.w2, B.w2_scale, B.w2_packed, k * C, C);
    if (B.dw != nullptr) {
      stage_weight(dwm, B.dw, B.dw_scale, B.dw_packed, cin, C);
      stage_vec(db, B.db, C);
    }
    stage_vec(b1, B.b1, C);
    stage_vec(b2, B.b2, C);
    stage_rows(hist, ld, (k - 1) * m, cin, RingRows{ring1, base, m, d, n, cin});
    cp_async_wait();
    __syncthreads();
    write_ring(ring1, n, cin, base, L, in, ld);
    conv_rows<RT, CO>(ChunkRows{hist, in, ld, m, d, n}, w1, cin, C, k, T,
                      Conv1Epi<SmemOut>{b1, {mid, ld}, a.quantize, a.act_scale});
    __syncthreads();

    // conv2 over [ring2 history | mid], plus the residual
    stage_rows(hist, ld, (k - 1) * m, C, RingRows{ring2, base, m, d, n, C});
    cp_async_wait();
    __syncthreads();
    write_ring(ring2, n, C, base, L, mid, ld);
    conv_rows<RT, CO>(ChunkRows{hist, mid, ld, m, d, n}, w2, C, C, k, T,
                      Conv2Epi<SmemOut>{b2, B.dw != nullptr ? dwm : nullptr, db,
                                        in, {out, ld}, ld, cin, C, a.quantize,
                                        a.act_scale});
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }

  const int cl = a.blk[a.n_blocks - 1].c;
  float* hs = a.h + static_cast<long>(s) * T * cl;
  for (int i = threadIdx.x; i < T * cl; i += blockDim.x) {
    const int u = i / cl;
    hs[i] = in[u * ld + i - u * cl];
  }
  if (threadIdx.x == 0) a.t[s] = tpos + L;
}

// Shared-memory floats of a tcn_chunk launch; kernels/tcn_block.py
// (chunk_smem_bytes) computes the same and the entry checks they agree.
void chunk_layout(const BlockDesc* blk, int n_blocks, int T, int k, int* ld,
                  int* m_max, int* w_floats, long* total) {
  int cmax = 1, dmax = 1, w = 0;
  for (int b = 0; b < n_blocks; ++b) {
    const BlockDesc& B = blk[b];
    cmax = std::max(cmax, std::max(B.cin, B.c));
    dmax = std::max(dmax, B.d);
    w = std::max(w, k * B.cin * B.c + k * B.c * B.c +
                        (B.dw != nullptr ? B.cin * B.c : 0) + 3 * B.c);
  }
  *ld = odd_ld(cmax);
  *m_max = std::min(dmax, T);
  *w_floats = round4(w);
  *total = *w_floats + static_cast<long>((k - 1) * *m_max + 3 * T) * *ld;
}

// ---------------------------------------------------------------------------
// strip entry (tcn_block_conv1 / tcn_block_conv2)
// ---------------------------------------------------------------------------

// A dilation-strided tile of the strip entry.  Output position t = a*d + v
// sits at (a, v); a tile takes rows a0..a0+R-1 and columns v0..v0+V-1
// (R*V <= kTile), local output u = (a - a0)*V + (v - v0).  Its tap j is
// position t + j*d, i.e. local row u + j*V: the tile stages (R+k-1)*V rows
// (112 at k=7, V=8, R=8) where a tile of consecutive positions stages
// (k-1)*d + kTile, up to k*kTile once d >= kTile.
struct StripTile {
  int a0, v0, R, V, d, T;
  __device__ StripTile(int tile, int n_v, int R_, int V_, int d_, int T_)
      : a0(tile / n_v * R_), v0(tile % n_v * V_), R(R_), V(V_), d(d_), T(T_) {}
  // position of local row q (staged rows run past R*V for the taps)
  __device__ long pos(int q) const {
    return static_cast<long>(a0 + q / V) * d + v0 + q % V;
  }
  // output position of local output u, or -1 outside [0, T) or the tile
  __device__ long out(int u) const {
    const long t = pos(u);
    return (v0 + u % V < d && t < T) ? t : -1;
  }
};

// Global rows of a tile's staged strip: staged row q is row off + pos(q) of
// [a (na rows) | b (nb rows)], null past its end.
struct TileRows {
  const float* a;
  const float* b;
  long na, nb, off;
  int cw;
  StripTile tile;
  __device__ const float* operator()(int q) const {
    const long r = off + tile.pos(q);
    if (r < na) return a + r * cw;
    if (r < na + nb) return b + (r - na) * cw;
    return nullptr;
  }
};

// The residual's input rows: local row u is strip1 row n + out(u).
struct ResidualRows {
  const float* strip1;
  long n;
  int cw;
  StripTile tile;
  __device__ const float* operator()(int u) const {
    const long t = tile.out(u);
    return t < 0 ? nullptr : strip1 + (n + t) * cw;
  }
};

// Output rows of the strip entry: (S, T, C) row out(u) of the slot.
struct TileOut {
  float* base;
  int C;
  StripTile tile;
  __device__ float* operator()(int u) const {
    const long t = tile.out(u);
    return t < 0 ? nullptr : base + t * C;
  }
};

__global__ void strip_conv1_kernel(const float* __restrict__ strip1,
                                   const void* w1, const float* w1_scale,
                                   int w1_packed, const float* __restrict__ b1,
                                   float* __restrict__ mid, int L1, int T,
                                   int cin, int C, int k, int d, int n_v, int R,
                                   int V, int quantize, float act_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = blockIdx.y;
  const StripTile tile(blockIdx.x, n_v, R, V, d, T);
  const int ld = odd_ld(cin);
  float* w = smem;
  float* bias = w + k * cin * C;
  float* stg = smem + round4(k * cin * C + C);
  stage_weight(w, w1, w1_scale, w1_packed, k * cin, C);
  stage_vec(bias, b1, C);
  stage_rows(stg, ld, (R + k - 1) * V, cin,
             TileRows{strip1 + static_cast<long>(s) * L1 * cin, nullptr, L1, 0,
                      0, cin, tile});
  cp_async_wait();
  __syncthreads();
  conv_rows<kStripRT, 4>(
      StagedRows{stg, ld, V}, w, cin, C, k, R * V,
      Conv1Epi<TileOut>{bias, {mid + static_cast<long>(s) * T * C, C, tile},
                        quantize, act_scale});
}

__global__ void strip_conv2_kernel(const float* __restrict__ strip1,
                                   const float* __restrict__ hist2,
                                   const float* __restrict__ mid, const void* w2,
                                   const float* w2_scale, int w2_packed,
                                   const float* __restrict__ b2, const void* dw,
                                   const float* dw_scale, int dw_packed,
                                   const float* __restrict__ db,
                                   float* __restrict__ h, int L1, int n, int T,
                                   int cin, int C, int k, int d, int n_v, int R,
                                   int V, int quantize, float act_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = blockIdx.y;
  const StripTile tile(blockIdx.x, n_v, R, V, d, T);
  const int ld = odd_ld(C), ldi = odd_ld(cin), n_rows = (R + k - 1) * V;
  const int dwn = dw != nullptr ? cin * C : 0;
  float* w = smem;
  float* dwm = w + k * C * C;
  float* bias = dwm + dwn;
  float* dbias = bias + C;
  float* stg = smem + round4(k * C * C + dwn + 2 * C);
  float* xin = stg + n_rows * ld;
  stage_weight(w, w2, w2_scale, w2_packed, k * C, C);
  stage_vec(bias, b2, C);
  if (dw != nullptr) {
    stage_weight(dwm, dw, dw_scale, dw_packed, cin, C);
    stage_vec(dbias, db, C);
  }
  // strip2 = [hist2 (n rows) | mid (T rows)], and the residual's rows
  stage_rows(stg, ld, n_rows, C,
             TileRows{hist2 + static_cast<long>(s) * n * C,
                      mid + static_cast<long>(s) * T * C, n, T, 0, C, tile});
  stage_rows(xin, ldi, R * V, cin,
             ResidualRows{strip1 + static_cast<long>(s) * L1 * cin, n, cin, tile});
  cp_async_wait();
  __syncthreads();
  conv_rows<kStripRT, 4>(
      StagedRows{stg, ld, V}, w, C, C, k, R * V,
      Conv2Epi<TileOut>{bias, dw != nullptr ? dwm : nullptr, dbias, xin,
                        {h + static_cast<long>(s) * T * C, C, tile}, ldi, cin, C,
                        quantize, act_scale});
}

// The strip tiling for dilation d over T positions: V columns x R rows of
// the (a = t / d, v = t mod d) grid, at most kTile outputs; n_v column tiles
// (only the min(d, T) columns that hold a position) by n_a row tiles.
struct StripPlan {
  int R, V, n_v, n_a;
  StripPlan(int d, int T) {
    const int cols = std::min(d, T), rows_of_a = (T + d - 1) / d;
    R = std::min(kTile / std::min(cols, kStripV), rows_of_a);
    V = std::min(cols, kTile / R);
    n_v = (cols + V - 1) / V;
    n_a = (rows_of_a + R - 1) / R;
  }
};

long strip_smem1(int cin, int C, int k, const StripPlan& p) {
  return 4L * (round4(k * cin * C + C) + (p.R + k - 1) * p.V * odd_ld(cin));
}

long strip_smem2(int cin, int C, int k, bool down, const StripPlan& p) {
  return 4L * (round4(k * C * C + (down ? cin * C : 0) + 2 * C) +
               (p.R + k - 1) * p.V * odd_ld(C) + p.R * p.V * odd_ld(cin));
}

bool strip_ok(int C, long smem) {
  return C % 4 == 0 && kStripThreadsPerGroup * (C / 4) <= 1024 && smem <= kMaxSmem;
}

template <class Kernel>
void allow_smem(Kernel kernel) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

}  // namespace

extern "C" {

// Strip entry, launch 1: mid (S, T, C) from strip1 (S, L1, Cin).
// Returns cudaGetLastError().
int tcn_block_conv1(const float* strip1, const void* w1, const float* w1_scale,
                    int w1_packed, const float* b1, float* mid, int S, int L1,
                    int T, int Cin, int C, int k, int d, int quantize,
                    float act_scale, void* stream) {
  const StripPlan p(d, T);
  const long smem = strip_smem1(Cin, C, k, p);
  if (!strip_ok(C, smem)) return static_cast<int>(cudaErrorInvalidValue);
  allow_smem(strip_conv1_kernel);
  strip_conv1_kernel<<<dim3(p.n_v * p.n_a, S), kStripThreadsPerGroup * (C / 4),
                       smem, static_cast<cudaStream_t>(stream)>>>(
      strip1, w1, w1_scale, w1_packed, b1, mid, L1, T, Cin, C, k, d, p.n_v, p.R,
      p.V, quantize, act_scale);
  return static_cast<int>(cudaGetLastError());
}

// Strip entry, launch 2: h (S, T, C) from [hist2 | mid] and the residual.
// dw == nullptr means an identity residual.  Returns cudaGetLastError().
int tcn_block_conv2(const float* strip1, const float* hist2, const float* mid,
                    const void* w2, const float* w2_scale, int w2_packed,
                    const float* b2, const void* dw, const float* dw_scale,
                    int dw_packed, const float* db, float* h, int S, int L1,
                    int n, int T, int Cin, int C, int k, int d, int quantize,
                    float act_scale, void* stream) {
  const StripPlan p(d, T);
  const long smem = strip_smem2(Cin, C, k, dw != nullptr, p);
  if (!strip_ok(C, smem)) return static_cast<int>(cudaErrorInvalidValue);
  allow_smem(strip_conv2_kernel);
  strip_conv2_kernel<<<dim3(p.n_v * p.n_a, S), kStripThreadsPerGroup * (C / 4),
                       smem, static_cast<cudaStream_t>(stream)>>>(
      strip1, hist2, mid, w2, w2_scale, w2_packed, b2, dw, dw_scale, dw_packed,
      db, h, L1, n, T, Cin, C, k, d, p.n_v, p.R, p.V, quantize, act_scale);
  return static_cast<int>(cudaGetLastError());
}

// Chunk entry: the whole TCN body of S slots over a T-row chunk in one
// launch, rings and t updated in place.  block_descs: host array of
// n_blocks BlockDesc (rings, weights); t, lengths: (S,) int32 on the
// device, t += lengths; x (S, T, Cin of block 0); h (S, T, C of the last
// block).  smem_bytes must equal the layout computed here
// (kernels/tcn_block.py's chunk_smem_bytes) and fit the card.  Returns
// cudaGetLastError().
int tcn_chunk(const void* block_descs, int n_blocks, int* t, const float* x,
              const int* lengths, float* h, int S, int T, int k, int quantize,
              float act_scale, int smem_bytes, void* stream) {
  const BlockDesc* blocks = static_cast<const BlockDesc*>(block_descs);
  if (n_blocks < 1 || n_blocks > kMaxBlocks || S < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ChunkArgs a;
  for (int b = 0; b < n_blocks; ++b) {
    if (blocks[b].c % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    a.blk[b] = blocks[b];
  }
  long total;
  chunk_layout(blocks, n_blocks, T, k, &a.ld, &a.m_max, &a.w_floats, &total);
  if (4 * total != smem_bytes || 4 * total > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  a.t = t;
  a.x = x;
  a.lengths = lengths;
  a.h = h;
  a.n_blocks = n_blocks;
  a.T = T;
  a.k = k;
  a.quantize = quantize;
  a.act_scale = act_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // short chunks: one output per thread, for more threads; long ones: a
  // 2-row x 4-channel register tile per thread
  if (T >= kChunkTileFrom) {
    allow_smem(chunk_kernel<2, 4>);
    chunk_kernel<2, 4><<<S, kChunkThreads, smem_bytes, st>>>(a);
  } else {
    allow_smem(chunk_kernel<1, kChunkShortCO>);
    chunk_kernel<1, kChunkShortCO><<<S, kChunkThreads, smem_bytes, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tcn_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
