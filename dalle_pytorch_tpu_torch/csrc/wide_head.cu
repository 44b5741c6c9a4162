// Attention kernels for head dims above 256 (sm_90a): the flash-decode
// family and the flash-attention forward and backward at any D, beside the
// tuned kernels of flash_decode.cu and flash_attention.cu, which stop at 256
// (their register and shared-memory budgets are sized for D <= 256).
//
// Replace, at D > 256, the TPU kernels of the JAX package:
//   * `dalle_pytorch_tpu/ops/pallas_decode.py`: `_decode_kernel` (plain and
//     int8 arms), `_sparse_decode_kernel`, `_paged_decode_kernel` and
//     `_sparse_paged_decode_kernel` -- one decode kernel here, with runtime
//     flags for the int8 cache (a template type), the block bitmap and the
//     page table (null pointers when off);
//   * `dalle_pytorch_tpu/ops/pallas_attention.py`: `_fwd_kernel` (forward),
//     `_dq_kernel` and `_dkv_kernel` (backward), in their all / causal /
//     static-mask arms.
// The functions are those of flash_decode.cu and flash_attention.cu (see
// their headers); D is a runtime argument with no upper limit.
//
// Design: column groups. A block owns at most kDecCols (decode) or kCols
// (attention) output columns. It forms the full scores (and, backward, the
// full dO . V^T) by looping over all of D -- lanes over channels in decode,
// chunks of kChunk staged channels in attention -- and accumulates only its
// own columns of o, dq, dk or dv. Registers and shared memory are then
// bounded for every D, at the cost of recomputing the scores once per
// column group (ceil(D / 256) groups in decode, ceil(D / 64) in attention).
// Simple and correct first, on CUDA cores in fp32 whatever the input type:
//   * decode: a block per (row, head) x 4 query rows x column group, keys
//     in tiles of 32 (a lane per key in the softmax, a warp per key in the
//     dot product); only keys some row of the block may see are read, a
//     dead page's table entry is never followed, and a value no row sees
//     is never loaded, so stale or poisoned bytes reach no result. The
//     bitmap and page table only choose which keys are read and where from:
//     an all-ones bitmap and the paged layout run the same sums in the same
//     order as the plain contiguous cache (bit-identical outputs);
//   * attention forward: a block per (32-row query tile, head, batch row,
//     64-column group) loops over 64-key tiles (the mask layout's and the
//     plain versions' tile) with an online softmax in base 2; in bfloat16
//     P is rounded to bf16 before P . V, as the tensor-core kernels do;
//   * attention backward: two passes, dq by query tile and dk/dv by key
//     tile, each recomputing p = exp(s - lse) and dS = p (dP - delta)
//     scale; in bfloat16 P and dS are rounded once before their second
//     products. No atomics: every output is bit-identical run to run.
// What bounds it: the same work as the D <= 256 kernels (bytes in decode,
// operations in attention), here times the column groups' recomputation
// and on CUDA cores; the tensor cores and a split-K decode are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;  // a masked attention score (finite, as the reference's)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// P and dS as the second products take them: rounded to bf16 for bf16 inputs
__device__ __forceinline__ float operand(float x, const float*) { return x; }
__device__ __forceinline__ float operand(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ------------------------------------------------------------------ decode

constexpr int kDecRows = 4;    // query rows a block holds
constexpr int kDecKeys = 32;   // keys a tile: one lane each in the softmax
constexpr int kDecCols = kThreads;  // output columns a block owns, one a thread

// out[b,h,i,:] = softmax_j(q[b,h,i] . k[b,h,j] * scale) @ v[b,h,j] over
// j <= lengths[b] - n + i (lengths clipped to [0, S]) and, with a bitmap,
// bitmap[b, j / block_k] != 0; with a page table key j of row b is at pool
// page page_table[b, j / page_size], offset j % page_size. Grid (B * H,
// ceil(n / kDecRows), ceil(D / kDecCols)).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
wide_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                   const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                   const int* __restrict__ lengths, const int* __restrict__ bitmap,
                   const int* __restrict__ page_table, T* __restrict__ out, int H, int n, int S,
                   int D, int n_blocks, int block_k, int page_size, int n_pool, float sm_scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  __shared__ size_t row_s[kDecKeys];      // the key's row in k / v (and the scales)
  __shared__ int live_s[kDecKeys];        // some row of the block may see the key: it is read
  __shared__ int seen_s[kDecKeys];        // some row sees it: its value is read
  __shared__ float p_s[kDecRows][kDecKeys];  // scores, then p (int8: times the value's scale)
  __shared__ float corr_s[kDecRows], m_s[kDecRows], l_s[kDecRows];

  const int bh = blockIdx.x, row0 = blockIdx.y * kDecRows;
  const int col = blockIdx.z * kDecCols + threadIdx.x;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(max(lengths[b], 0), S);
  const int nrows = min(kDecRows, n - row0);
  const int key1 = len - n + row0 + nrows;  // keys [0, key1): the last row's
  const int* live_b = bitmap ? bitmap + (size_t)b * n_blocks : nullptr;
  const int* table_b = page_table ? page_table + (size_t)b * (S / page_size) : nullptr;
  const T* qb = q + ((size_t)bh * n + row0) * D;
  if (threadIdx.x < kDecRows) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[kDecRows];
#pragma unroll
  for (int r = 0; r < kDecRows; ++r) acc[r] = 0.f;

  const int n_tiles = key1 > 0 ? (key1 + kDecKeys - 1) / kDecKeys : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * kDecKeys;
    if (live_b) {  // a tile with no live block is skipped (block-uniform)
      const int last = min(key0 + kDecKeys, key1) - 1;
      bool any = false;
      for (int blk = key0 / block_k; blk <= last / block_k && !any; ++blk) any = live_b[blk] != 0;
      if (!any) continue;
    }
    __syncthreads();  // the previous tile's shared state is consumed
    if (threadIdx.x < kDecKeys) {
      const int pos = key0 + threadIdx.x;
      const bool live = pos < key1 && (live_b == nullptr || live_b[pos / block_k] != 0);
      size_t row = 0;
      if (live) {
        if (table_b) {
          const int pi = pos / page_size;
          const int page = table_b[pi];
          if (page < 0 || page >= n_pool) __trap();  // a corrupt table faults loudly
          row = ((size_t)page * H + h) * page_size + (pos - pi * page_size);
        } else {
          row = (size_t)bh * S + pos;
        }
      }
      live_s[threadIdx.x] = live;
      row_s[threadIdx.x] = row;
    }
    __syncthreads();
    // scores: a warp per key, lanes over channels, a butterfly sum
    for (int jj = warp; jj < kDecKeys; jj += kWarps) {
      if (!live_s[jj]) {  // warp-uniform
        if (lane < kDecRows) p_s[lane][jj] = -INFINITY;
        if (lane == 0) seen_s[jj] = 0;
        continue;
      }
      const KV* kr = k + row_s[jj] * D;
      float dot[kDecRows];
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) dot[r] = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float kv = to_float(kr[c]);
#pragma unroll
        for (int r = 0; r < kDecRows; ++r)
          if (r < nrows) dot[r] = fmaf(to_float(qb[(size_t)r * D + c]) * sm_scale, kv, dot[r]);
      }
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) dot[r] = warp_sum(dot[r]);
      if (lane == 0) {
        const float ksc = QUANT ? k_scale[row_s[jj]] : 1.f;
        int seen = 0;
#pragma unroll
        for (int r = 0; r < kDecRows; ++r) {
          const bool vis = r < nrows && key0 + jj <= len - n + row0 + r;
          p_s[r][jj] = vis ? (QUANT ? dot[r] * ksc : dot[r]) : -INFINITY;
          seen |= vis;
        }
        seen_s[jj] = seen;
      }
    }
    __syncthreads();
    // the online softmax, a warp per query row and a lane per key
    if (warp < kDecRows) {
      const int r = warp;
      const float s = p_s[r][lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      float p = 0.f, corr = 1.f;
      if (m_new > -INFINITY) {  // warp-uniform: the row has seen a key
        corr = expf(m_old - m_new);  // 0 on the row's first visible key
        p = expf(s - m_new);         // 0 where unseen
      }
      const float psum = warp_sum(p);
      if (QUANT && p > 0.f) p *= v_scale[row_s[lane]];
      __syncwarp();
      p_s[r][lane] = p;
      if (lane == 0) {
        l_s[r] = fmaf(l_s[r], corr, psum);
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();
    // P . V for this thread's column; values no row sees are never loaded
    if (col < D) {
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) acc[r] *= corr_s[r];
      for (int jj = 0; jj < kDecKeys; ++jj) {
        if (!seen_s[jj]) continue;
        const float vv = to_float(v[row_s[jj] * D + col]);
#pragma unroll
        for (int r = 0; r < kDecRows; ++r) acc[r] = fmaf(p_s[r][jj], vv, acc[r]);
      }
    }
  }
  __syncthreads();
  if (col < D) {
    for (int r = 0; r < nrows; ++r) {
      const float l = l_s[r];
      store(out + ((size_t)bh * n + row0 + r) * D + col, l > 0.f ? acc[r] / l : 0.f);
    }
  }
}

struct DecodeArgs {
  const void *q, *k, *v, *k_scale, *v_scale, *lengths, *bitmap, *page_table;
  void* out;
  int B, H, n, S, D, n_blocks, block_k, page_size, n_pool;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename KV>
cudaError_t launch_decode(const DecodeArgs& a) {
  const dim3 grid(a.B * a.H, (a.n + kDecRows - 1) / kDecRows, (a.D + kDecCols - 1) / kDecCols);
  wide_decode_kernel<T, KV><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.bitmap),
      static_cast<const int*>(a.page_table), static_cast<T*>(a.out), a.H, a.n, a.S, a.D,
      a.n_blocks, a.block_k, a.page_size, a.n_pool, a.sm_scale);
  return cudaGetLastError();
}

// --------------------------------------------------------------- attention

constexpr int kBM = 32;     // query rows (forward, dq) or keys (dk/dv) a block owns
constexpr int kBN = 64;     // the tile looped over: keys (forward, dq) or query rows (dk/dv)
constexpr int kChunk = 32;  // channels staged at a time for the scores
constexpr int kCols = 64;   // output columns a block owns
constexpr int kPer = kThreads / kBM;  // threads a row of the owned tile (8)
constexpr int kPad = kChunk + 1;
enum { kModeAll = 0, kModeCausal = 1, kModeMask = 2 };

struct AttnArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  const unsigned char* mask;
  const int* layout;
  void *o, *lse_out, *dq, *dk, *dv;
  int B, H, nq, nk, D, mode;
  float scale;
  cudaStream_t stream;
};

__device__ __forceinline__ bool visible(const AttnArgs& a, int i, int j) {
  if (i >= a.nq || j >= a.nk) return false;
  if (a.mode == kModeCausal) return j <= i;
  if (a.mode == kModeMask) return a.mask[(size_t)i * a.nk + j] != 0;
  return true;
}

// rows [r0, r0 + R) x channels [c0, c0 + kChunk) of x [rows, D] -> dst
// [R][kPad] as fp32, zeros outside
template <typename T, int R>
__device__ __forceinline__ void stage_chunk(float* dst, const T* x, int r0, int rows, int c0, int D) {
  for (int e = threadIdx.x; e < R * kChunk; e += kThreads) {
    const int r = e / kChunk, c = e % kChunk;
    const bool in = r0 + r < rows && c0 + c < D;
    dst[r * kPad + c] = in ? to_float(x[(size_t)(r0 + r) * D + c0 + c]) : 0.f;
  }
}

// rows [r0, r0 + R) x the block's columns [g0, g0 + kCols) -> dst [R][kCols]
template <typename T, int R>
__device__ __forceinline__ void stage_cols(float* dst, const T* x, int r0, int rows, int g0, int D) {
  for (int e = threadIdx.x; e < R * kCols; e += kThreads) {
    const int r = e / kCols, c = e % kCols;
    const bool in = r0 + r < rows && g0 + c < D;
    dst[e] = in ? to_float(x[(size_t)(r0 + r) * D + g0 + c]) : 0.f;
  }
}

// the block's tile of x . y^T over all of D: a [kBM] x [kBN] product, this
// thread's row `me` against columns (t % kPer) + kPer u; x rows [x0, x0 +
// kBM) of nx, y rows [y0, y0 + kBN) of ny. Two products at once when x2/y2
// are given (the backward's S and dP).
template <typename T, bool TWO>
__device__ __forceinline__ void tile_dots(float (&s)[kBN / kPer], float (&s2)[kBN / kPer],
                                          float* xs, float* ys, float* xs2, float* ys2,
                                          const T* x, const T* y, const T* x2, const T* y2,
                                          int x0, int nx, int y0, int ny, int D) {
  const int me = threadIdx.x / kPer, sub = threadIdx.x % kPer;
#pragma unroll
  for (int u = 0; u < kBN / kPer; ++u) s[u] = s2[u] = 0.f;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    __syncthreads();
    stage_chunk<T, kBM>(xs, x, x0, nx, c0, D);
    stage_chunk<T, kBN>(ys, y, y0, ny, c0, D);
    if (TWO) {
      stage_chunk<T, kBM>(xs2, x2, x0, nx, c0, D);
      stage_chunk<T, kBN>(ys2, y2, y0, ny, c0, D);
    }
    __syncthreads();
    for (int c = 0; c < kChunk; ++c) {
      const float xv = xs[me * kPad + c];
      const float xv2 = TWO ? xs2[me * kPad + c] : 0.f;
#pragma unroll
      for (int u = 0; u < kBN / kPer; ++u) {
        const int j = sub + kPer * u;
        s[u] = fmaf(xv, ys[j * kPad + c], s[u]);
        if (TWO) s2[u] = fmaf(xv2, ys2[j * kPad + c], s2[u]);
      }
    }
  }
}

// the row's reduction over its kPer threads (consecutive lanes)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kPer / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kPer / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// forward: grid (ceil(nq / kBM), B * H, ceil(D / kCols))
template <typename T>
__global__ void __launch_bounds__(kThreads) wide_fwd_kernel(AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kBM][kPad]
  float* ks = qs + kBM * kPad;       // [kBN][kPad]
  float* ps = ks + kBN * kPad;       // [kBM][kBN + 1]
  float* vs = ps + kBM * (kBN + 1);  // [kBN][kCols]
  constexpr int U = kBN / kPer, W = kCols / kPer;
  const int row0 = blockIdx.x * kBM, bh = blockIdx.y, g0 = blockIdx.z * kCols;
  const int me = threadIdx.x / kPer, sub = threadIdx.x % kPer, i = row0 + me;
  const size_t base_q = (size_t)bh * a.nq * a.D, base_k = (size_t)bh * a.nk * a.D;
  const T* q = static_cast<const T*>(a.q) + base_q;
  const T* k = static_cast<const T*>(a.k) + base_k;
  const T* v = static_cast<const T*>(a.v) + base_k;
  const float scale2 = a.scale * kLog2e;  // fl(scale log2(e)), as the plain version forms it
  const int n_kt = (a.nk + kBN - 1) / kBN;
  int kt_end = n_kt;
  if (a.mode == kModeCausal) kt_end = min(n_kt, (min(row0 + kBM, a.nq) - 1) / kBN + 1);
  float m = -INFINITY, l = 0.f, acc[W], s[U], unused[U];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0.f;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (a.mode == kModeMask && a.layout[(row0 / 64) * n_kt + kt] == 0) continue;  // block-uniform
    tile_dots<T, false>(s, unused, qs, ks, nullptr, nullptr, q, k, nullptr, nullptr, row0, a.nq,
                        kt * kBN, a.nk, a.D);
    float x[U], tmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = kt * kBN + sub + kPer * u;
      x[u] = j >= a.nk ? -INFINITY : visible(a, i, j) ? s[u] * scale2 : kMasked;
      tmax = fmaxf(tmax, x[u]);
    }
    const float m_new = fmaxf(m, group_max(tmax));
    const float corr = exp2f(m - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = exp2f(x[u] - m_new);
      psum += p;
      ps[me * (kBN + 1) + sub + kPer * u] = operand(p, q);
    }
    l = fmaf(l, corr, group_sum(psum));
    m = m_new;
    stage_cols<T, kBN>(vs, v, kt * kBN, a.nk, g0, a.D);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] *= corr;
    for (int j = 0; j < kBN; ++j) {
      const float p = ps[me * (kBN + 1) + j];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = fmaf(p, vs[j * kCols + sub + kPer * w], acc[w]);
    }
  }
  if (i >= a.nq) return;
  T* o = static_cast<T*>(a.o) + base_q + (size_t)i * a.D;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int c = g0 + sub + kPer * w;
    if (c < a.D) store(o + c, acc[w] / l);
  }
  if (blockIdx.z == 0 && sub == 0)
    static_cast<float*>(a.lse_out)[(size_t)bh * a.nq + i] = (m + log2f(l)) * kLn2;
}

// dq: grid (ceil(nq / kBM), B * H, ceil(D / kCols)); a block per query tile
template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dq_kernel(AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kBM][kPad]
  float* ks = qs + kBM * kPad;        // [kBN][kPad]
  float* dos = ks + kBN * kPad;       // [kBM][kPad]
  float* vs = dos + kBM * kPad;       // [kBN][kPad]
  float* dss = vs + kBN * kPad;       // [kBM][kBN + 1]
  float* kg = dss + kBM * (kBN + 1);  // [kBN][kCols]
  constexpr int U = kBN / kPer, W = kCols / kPer;
  const int row0 = blockIdx.x * kBM, bh = blockIdx.y, g0 = blockIdx.z * kCols;
  const int me = threadIdx.x / kPer, sub = threadIdx.x % kPer, i = row0 + me;
  const size_t base_q = (size_t)bh * a.nq * a.D, base_k = (size_t)bh * a.nk * a.D;
  const T* q = static_cast<const T*>(a.q) + base_q;
  const T* dout = static_cast<const T*>(a.dout) + base_q;
  const T* k = static_cast<const T*>(a.k) + base_k;
  const T* v = static_cast<const T*>(a.v) + base_k;
  const float lse = i < a.nq ? static_cast<const float*>(a.lse)[(size_t)bh * a.nq + i] : 0.f;
  const float delta = i < a.nq ? static_cast<const float*>(a.delta)[(size_t)bh * a.nq + i] : 0.f;
  const int n_kt = (a.nk + kBN - 1) / kBN;
  int kt_end = n_kt;
  if (a.mode == kModeCausal) kt_end = min(n_kt, (min(row0 + kBM, a.nq) - 1) / kBN + 1);
  float acc[W], s[U], dp[U];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0.f;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (a.mode == kModeMask && a.layout[(row0 / 64) * n_kt + kt] == 0) continue;
    tile_dots<T, true>(s, dp, qs, ks, dos, vs, q, k, dout, v, row0, a.nq, kt * kBN, a.nk, a.D);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = kt * kBN + sub + kPer * u;
      const float p = visible(a, i, j) ? expf(s[u] * a.scale - lse) : 0.f;
      dss[me * (kBN + 1) + sub + kPer * u] = operand(p * (dp[u] - delta) * a.scale, q);
    }
    stage_cols<T, kBN>(kg, k, kt * kBN, a.nk, g0, a.D);
    __syncthreads();
    for (int j = 0; j < kBN; ++j) {
      const float ds = dss[me * (kBN + 1) + j];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = fmaf(ds, kg[j * kCols + sub + kPer * w], acc[w]);
    }
  }
  if (i >= a.nq) return;
  T* dq = static_cast<T*>(a.dq) + base_q + (size_t)i * a.D;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int c = g0 + sub + kPer * w;
    if (c < a.D) store(dq + c, acc[w]);
  }
}

// dk, dv: grid (ceil(nk / kBM), B * H, ceil(D / kCols)); a block per key
// tile loops over the query tiles that may see it
template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dkv_kernel(AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [kBM][kPad] (this block's keys)
  float* qs = ks + kBM * kPad;         // [kBN][kPad]
  float* vs = qs + kBN * kPad;         // [kBM][kPad]
  float* dos = vs + kBM * kPad;        // [kBN][kPad]
  float* pss = dos + kBN * kPad;       // [kBM][kBN + 1]
  float* dss = pss + kBM * (kBN + 1);  // [kBM][kBN + 1]
  float* qg = dss + kBM * (kBN + 1);   // [kBN][kCols]
  float* dog = qg + kBN * kCols;       // [kBN][kCols]
  constexpr int U = kBN / kPer, W = kCols / kPer;
  const int key0 = blockIdx.x * kBM, bh = blockIdx.y, g0 = blockIdx.z * kCols;
  const int me = threadIdx.x / kPer, sub = threadIdx.x % kPer, j = key0 + me;
  const size_t base_q = (size_t)bh * a.nq * a.D, base_k = (size_t)bh * a.nk * a.D;
  const T* q = static_cast<const T*>(a.q) + base_q;
  const T* dout = static_cast<const T*>(a.dout) + base_q;
  const T* k = static_cast<const T*>(a.k) + base_k;
  const T* v = static_cast<const T*>(a.v) + base_k;
  const float* lse = static_cast<const float*>(a.lse) + (size_t)bh * a.nq;
  const float* delta = static_cast<const float*>(a.delta) + (size_t)bh * a.nq;
  const int n_qt = (a.nq + kBN - 1) / kBN, n_kt64 = (a.nk + 63) / 64;
  const int qt_begin = a.mode == kModeCausal ? key0 / kBN : 0;
  float dk[W], dv[W], s[U], dp[U];
#pragma unroll
  for (int w = 0; w < W; ++w) dk[w] = dv[w] = 0.f;
  for (int qt = qt_begin; qt < n_qt; ++qt) {
    if (a.mode == kModeMask && a.layout[qt * n_kt64 + key0 / 64] == 0) continue;
    tile_dots<T, true>(s, dp, ks, qs, vs, dos, k, q, v, dout, key0, a.nk, qt * kBN, a.nq, a.D);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = qt * kBN + sub + kPer * u;
      const bool vis = visible(a, i, j);
      const float p = vis ? expf(s[u] * a.scale - lse[i]) : 0.f;
      const float ds = vis ? p * (dp[u] - delta[i]) * a.scale : 0.f;
      pss[me * (kBN + 1) + sub + kPer * u] = operand(p, q);
      dss[me * (kBN + 1) + sub + kPer * u] = operand(ds, q);
    }
    stage_cols<T, kBN>(qg, q, qt * kBN, a.nq, g0, a.D);
    stage_cols<T, kBN>(dog, dout, qt * kBN, a.nq, g0, a.D);
    __syncthreads();
    for (int i = 0; i < kBN; ++i) {
      const float p = pss[me * (kBN + 1) + i], ds = dss[me * (kBN + 1) + i];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        dv[w] = fmaf(p, dog[i * kCols + sub + kPer * w], dv[w]);
        dk[w] = fmaf(ds, qg[i * kCols + sub + kPer * w], dk[w]);
      }
    }
  }
  if (j >= a.nk) return;
  T* dk_out = static_cast<T*>(a.dk) + base_k + (size_t)j * a.D;
  T* dv_out = static_cast<T*>(a.dv) + base_k + (size_t)j * a.D;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int c = g0 + sub + kPer * w;
    if (c < a.D) {
      store(dk_out + c, dk[w]);
      store(dv_out + c, dv[w]);
    }
  }
}

constexpr int kFwdSmem = 4 * (kBM * kPad + kBN * kPad + kBM * (kBN + 1) + kBN * kCols);
constexpr int kDqSmem = 4 * (2 * kBM * kPad + 2 * kBN * kPad + kBM * (kBN + 1) + kBN * kCols);
constexpr int kDkvSmem =
    4 * (2 * kBM * kPad + 2 * kBN * kPad + 2 * kBM * (kBN + 1) + 2 * kBN * kCols);

template <typename K>
cudaError_t launch_attn(K kernel, int smem, dim3 grid, const AttnArgs& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, a.stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_fwd(const AttnArgs& a) {
  const dim3 grid((a.nq + kBM - 1) / kBM, a.B * a.H, (a.D + kCols - 1) / kCols);
  return launch_attn(wide_fwd_kernel<T>, kFwdSmem, grid, a);
}

template <typename T>
cudaError_t attention_bwd(const AttnArgs& a) {
  const int groups = (a.D + kCols - 1) / kCols;
  cudaError_t err = launch_attn(wide_dq_kernel<T>, kDqSmem,
                                dim3((a.nq + kBM - 1) / kBM, a.B * a.H, groups), a);
  if (err != cudaSuccess) return err;
  return launch_attn(wide_dkv_kernel<T>, kDkvSmem,
                     dim3((a.nk + kBM - 1) / kBM, a.B * a.H, groups), a);
}

bool attn_args_ok(const AttnArgs& a) {
  return a.B > 0 && a.H > 0 && a.nq > 0 && a.nk > 0 && a.D > 0 && a.mode >= 0 && a.mode <= 2 &&
         (a.mode != kModeMask || (a.mask != nullptr && a.layout != nullptr)) &&
         (long long)a.B * a.H <= 65535 && (a.D + kCols - 1) / kCols <= 65535;
}

}  // namespace

// The decode family at any D: q/out [B,H,n,D] of `dtype` (0 = float32, 1 =
// bfloat16); k/v [B,H,S,D] of that dtype, or int8 with `quantized` = 1 and
// k_scale / v_scale [B,H,S] float32; with `page_table` [B, S / page_size]
// int32 of pool pages in [0, n_pool), k/v (and the scales) are pools
// [n_pool, H, page_size, D] (an entry out of range traps); `bitmap` [B,
// n_blocks] int32 over blocks of `block_k` positions (one per page-table
// entry when paged), or null; lengths [B] int32. Contiguous. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int wide_decode_launch(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale, const void* lengths,
                                  const void* bitmap, const void* page_table, void* out, int B,
                                  int H, int n, int S, int D, int n_blocks, int block_k,
                                  int page_size, int n_pool, int dtype, int quantized,
                                  float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 2147483647LL || (n + kDecRows - 1) / kDecRows > 65535 ||
      (D + kDecCols - 1) / kDecCols > 65535)
    return (int)cudaErrorInvalidValue;
  if (quantized && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (bitmap != nullptr && (block_k <= 0 || n_blocks < (S + block_k - 1) / block_k))
    return (int)cudaErrorInvalidValue;
  if (page_table != nullptr && (page_size <= 0 || S % page_size != 0 || n_pool <= 0))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k, v, k_scale, v_scale, lengths, bitmap, page_table, out,
                     B, H, n, S, D, n_blocks, block_k, page_size > 0 ? page_size : 1, n_pool,
                     sm_scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return (int)(quantized ? launch_decode<float, int8_t>(a) : launch_decode<float, float>(a));
  if (dtype == 1)
    return (int)(quantized ? launch_decode<__nv_bfloat16, int8_t>(a)
                           : launch_decode<__nv_bfloat16, __nv_bfloat16>(a));
  return (int)cudaErrorInvalidValue;
}

// The flash-attention forward at any D: q [B,H,nq,D], k/v [B,H,nk,D] of
// `dtype`; mask [nq, nk] bool and layout [ceil(nq/64), ceil(nk/64)] int32
// for mode 2 (else null); o [B,H,nq,D] of `dtype`, lse [B,H,nq] float32.
extern "C" int wide_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                  const void* layout, void* o, void* lse, int B, int H, int nq,
                                  int nk, int D, int dtype, int mode, float scale, void* stream) {
  AttnArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse_out = lse;
  a.mask = static_cast<const unsigned char*>(mask);
  a.layout = static_cast<const int*>(layout);
  a.B = B; a.H = H; a.nq = nq; a.nk = nk; a.D = D; a.mode = mode; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!attn_args_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)attention_fwd<float>(a);
  if (dtype == 1) return (int)attention_fwd<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

// The backward at any D: dq, dk and dv of `dtype` from q, k, v, dout of
// `dtype` and the forward's lse and delta = rowsum(dout * o), float32
// [B,H,nq]; two launches (dq, then dk/dv), no workspace.
extern "C" int wide_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* mask,
                                  const void* layout, void* dq, void* dk, void* dv, int B, int H,
                                  int nq, int nk, int D, int dtype, int mode, float scale,
                                  void* stream) {
  AttnArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.mask = static_cast<const unsigned char*>(mask);
  a.layout = static_cast<const int*>(layout);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.nq = nq; a.nk = nk; a.D = D; a.mode = mode; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!attn_args_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)attention_bwd<float>(a);
  if (dtype == 1) return (int)attention_bwd<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
