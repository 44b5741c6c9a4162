// Attention kernels for head dims above 256 (sm_90a): the flash-decode
// family and the flash-attention forward and backward at any D, beside the
// tuned kernels of flash_decode.cu and flash_attention.cu, which stop at 256
// (their register and shared-memory budgets are sized for D <= 256).
//
// Replace, at D > 256, the TPU kernels of the JAX package:
//   * `dalle_pytorch_tpu/ops/pallas_decode.py`: `_decode_kernel` (plain and
//     int8 arms), `_sparse_decode_kernel`, `_paged_decode_kernel` and
//     `_sparse_paged_decode_kernel` -- two decode kernels here (the split-K
//     step and the 4-row kernel), each with runtime flags for the block
//     bitmap and the page table (null pointers when off) and the int8
//     cache as a template type (bf16 q at n > 4 runs the tensor-core tile
//     kernel of wide_decode_tile.cu instead);
//   * `dalle_pytorch_tpu/ops/pallas_attention.py`: `_fwd_kernel` (forward),
//     `_dq_kernel` and `_dkv_kernel` (backward), in their all / causal /
//     static-mask arms.
// The functions are those of flash_decode.cu and flash_attention.cu (see
// their headers); D is a runtime argument with no upper limit.
//
// Decode at the step (n <= 4 query rows, D <= kSplitMaxD = 1024) runs
// `wide_split_kernel`: split-K over spans of 128 key positions, bound by
// the bytes of live K/V it reads (2 B H len D elt), which it reads once:
//   * one block per (batch row x head, span); span boundaries depend on
//     key positions only, so every variant sums in the same order; blocks
//     past a row's last visible key exit at once; each span writes (m, l,
//     acc[D]) in fp32 to a workspace, and the last block of a (b, h) to
//     arrive merges the spans in span order (a self-resetting arrival
//     counter: one launch, no memset, no host sync), as flash_decode.cu;
//   * a block owns every output column (no column groups), so K is read
//     once, not once per group; its 4 x D accumulators are spread over the
//     block's 128 threads, 4 columns a chunk, at most 2 chunks a thread;
//   * K and V arrive by cp.async (16-byte chunks where D * elt allows) in
//     tiles of up to 16 keys, sized so a stage's K and V rows stay within
//     32 KB (16 keys at D = 320 and 512 in bf16, 8 at 1024), in a ring of 3
//     stages; rows stay in their storage type and widen in registers with
//     vector shared loads; keys no row may see are zero-filled by the copy
//     itself, and a dead page's table entry is never followed;
//   * scores: a group of 8 lanes per key (8 channels a lane, a butterfly
//     sum), so every warp computes; one warp per query row runs the online
//     softmax of the tile (a lane per key, expf); then every thread adds P V
//     for its own columns. One code path for every variant.
// bf16 q at n > 4 rows runs wide_decode_tile.cu's tensor-core tile kernel;
// `wide_decode_kernel` (below) keeps what is left: fp32 q at n > 4, and the
// step (n <= 4) above D = 1024.
//
// Design of the rest: column groups. A block owns at most kDecCols
// (decode) or kCols (fp32 attention) or `cols` (bf16 attention, 128-256:
// the wrapper's plan) output columns. It
// forms the full scores (and, backward, the full dO . V^T) by looping over
// all of D -- lanes over channels in decode, chunks of staged channels in
// attention -- and accumulates only its own columns of o, dq, dk or dv.
// Registers and shared memory are then bounded for every D, at the cost of
// recomputing the scores once per column group (ceil(D / 256) groups in
// decode, ceil(D / 64) in fp32 attention, ceil(D / 256) in the bf16
// forward and ceil(D / 128) in the bf16 backward).
//
// bfloat16 attention runs on tensor cores (the second half of this file):
// mma.sync with fp32 accumulators, 64-row tiles, operands staged as 64 x 64
// tiles through a cp.async ring. The rest on CUDA cores in fp32:
//   * decode at n > 4 with fp32 q, or n <= 4 above D = 1024
//     (`wide_decode_kernel`): a block per (row, head) x 4 query
//     rows x column group, keys in tiles of 32 (a lane per key in the
//     softmax, a warp per key in the dot product), K and V read from
//     device memory unstaged; only keys some row of the block may see are read, a
//     dead page's table entry is never followed, and a value no row sees
//     is never loaded, so stale or poisoned bytes reach no result. The
//     bitmap and page table only choose which keys are read and where from:
//     an all-ones bitmap and the paged layout run the same sums in the same
//     order as the plain contiguous cache (bit-identical outputs);
//   * fp32 attention forward: a block per (32-row query tile, head, batch
//     row, 64-column group) loops over 64-key tiles (the mask layout's and
//     the plain versions' tile) with an online softmax in base 2;
//   * fp32 attention backward: two passes, dq by query tile and dk/dv by
//     key tile, each recomputing p = exp(s - lse) and dS = p (dP - delta)
//     scale. No atomics: every output is bit-identical run to run.
// What bounds it: the same work as the D <= 256 kernels (bytes in decode,
// operations in attention), here times the column groups' recomputation in
// all but the split-K step; decode and fp32 attention run on CUDA cores.

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

// ------------------------------------------------------- decode, split-K

// The step (n <= kSplitRows query rows) at D in (256, kSplitMaxD]: split-K
// over spans of kSplitSpan key positions, as flash_decode.cu does at D <=
// 256, redesigned for wide rows. One block per (batch row x head, span);
// blocks past a row's last visible key exit at once. No column groups: a
// block owns every output column, so each live K/V byte is read once.
constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitRows = 4;          // query rows a block holds (ops/flash_decode.py DECODE_ROWS)
constexpr int kSplitSpan = 128;        // key positions a block (ops/flash_decode.py DECODE_SPAN)
constexpr int kSplitStages = 3;        // cp.async ring depth
constexpr int kSplitStageBytes = 32768;  // K + V bytes of one tile, at most
constexpr int kSplitGroups = 16;       // key groups of 8 lanes: at most 16 keys a tile
constexpr int kSplitMaxD = 1024;       // accumulators: 4 rows x 2 chunks of 4 columns a thread
constexpr int kSplitChunks = kSplitMaxD / 4 / kSplitThreads;
constexpr int kSplitTableCache = kSplitSpan + 1;  // a span's page-table entries (pages >= 1 position)

// bytes of a staged K or V row: D rounded up to 8 channels (the score's
// 8-channel loads), then to 16 bytes (cp.async chunks); the tail is zero
__host__ __device__ inline int split_row_stride(int D, int elt) {
  return ((D + 7) / 8 * 8 * elt + 15) / 16 * 16;
}
// keys a tile: the largest power of two up to kSplitGroups whose K and V
// rows fit kSplitStageBytes (16 at D = 320 and 512 in bf16, 8 at 1024)
__host__ __device__ inline int split_tile_keys(int D, int elt) {
  int keys = kSplitGroups;
  while (keys > 1 && 2 * keys * split_row_stride(D, elt) > kSplitStageBytes) keys /= 2;
  return keys;
}
__host__ __device__ inline int split_stage_bytes(int D, int elt) {
  const int keys = split_tile_keys(D, elt);
  return 2 * keys * split_row_stride(D, elt) + (elt == 1 ? 2 * keys * 4 : 0);
}
// dynamic shared bytes: the ring, then q [ROWS][D rounded to 8] fp32
__host__ __device__ inline int split_smem_bytes(int D, int elt, int rows) {
  return kSplitStages * split_stage_bytes(D, elt) + rows * ((D + 7) / 8 * 8) * 4;
}

__device__ __forceinline__ uint32_t split_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `unit` bytes global -> shared, zero-filled when !ok (cp.async with a source
// size of 0 reads nothing); below 4 bytes a plain copy of one element
__device__ __forceinline__ void split_copy(void* dst, const void* src, bool ok, int unit) {
  const uint32_t d = split_smem_addr(dst);
  if (unit == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
  } else if (unit == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 8 : 0));
  } else if (unit == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
  } else if (unit == 2) {
    *static_cast<uint16_t*>(dst) = ok ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
  } else {
    *static_cast<uint8_t*>(dst) = ok ? *static_cast<const uint8_t*>(src) : (uint8_t)0;
  }
}
__device__ __forceinline__ void split_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void split_wait() {  // all but the kSplitStages - 2 newest groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kSplitStages - 2) : "memory");
}

// N adjacent elements of type KV at p (aligned to N * sizeof(KV) bytes) as fp32
template <typename KV, int N>
__device__ __forceinline__ void split_load(float (&out)[N], const unsigned char* p) {
  constexpr int BYTES = N * (int)sizeof(KV);
  if constexpr (sizeof(KV) == 1) {  // int8: 4 values a char4 (no local copy to index)
    static_assert(N == 4 || N == 8, "int8 vector");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const char4 c = reinterpret_cast<const char4*>(p)[i];
      out[4 * i] = c.x;
      out[4 * i + 1] = c.y;
      out[4 * i + 2] = c.z;
      out[4 * i + 3] = c.w;
    }
  } else if constexpr (BYTES >= 16) {
    uint4 raw[BYTES / 16];
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) raw[i] = reinterpret_cast<const uint4*>(p)[i];
    const KV* e = reinterpret_cast<const KV*>(raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else {
    static_assert(BYTES == 4, "vector");
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  }
}

// The function of wide_decode_kernel at n <= kSplitRows (ROWS = 1 at the
// step n = 1, else kSplitRows). Grid (B * H, spans). Per key tile: scores
// by groups of 8 lanes (a key each, 8 channels a lane, a butterfly sum),
// the online softmax of each row by one warp (a lane per key), then P V by
// every thread over its own output columns; one softmax state per row, in
// shared memory. Each span writes (m, l, acc[D]) to the workspace unless it
// is its row's only live span; the last span block of a (b, h) to arrive
// merges the spans in span order.
template <typename T, typename KV, int ROWS>
__global__ void __launch_bounds__(kSplitThreads, 1)
wide_split_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                  const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                  const int* __restrict__ lengths, const int* __restrict__ bitmap,
                  const int* __restrict__ page_table, T* __restrict__ out, float* __restrict__ ws,
                  int* __restrict__ counters, int H, int n, int S, int D, int n_blocks,
                  int block_k, int page_size, int n_pool, float sm_scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int ELT = (int)sizeof(KV);
  extern __shared__ __align__(16) unsigned char split_smem[];  // the file's other kernels' smem is float
  unsigned char* smem = split_smem;
  __shared__ float p_s[kSplitRows][kSplitGroups];  // scores, then p (int8: times v_scale)
  __shared__ float m_s[kSplitRows], l_s[kSplitRows], corr_s[kSplitRows];
  __shared__ int table_s[kSplitTableCache];
  __shared__ int last_block;

  const int bh = blockIdx.x, split = blockIdx.y, n_spans = gridDim.y;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(max(lengths[b], 0), S);
  const int nrows = min(ROWS, n);
  // keys [key0, key1) of this block: the span's, up to the last one the last row sees
  const int n_live = max(1, (len - n + nrows + kSplitSpan - 1) / kSplitSpan);
  if (split >= n_live) return;  // block-uniform, before any barrier
  const int key0 = split * kSplitSpan, key1 = min(len - n + nrows, key0 + kSplitSpan);
  const size_t bhs = (size_t)bh;
  const int* live_b = bitmap ? bitmap + (size_t)b * n_blocks : nullptr;
  const int* table_b = page_table ? page_table + (size_t)b * (S / page_size) : nullptr;

  const int LDB = split_row_stride(D, ELT), BN = split_tile_keys(D, ELT);
  const int STAGE = split_stage_bytes(D, ELT);
  const int DQ = (D + 7) / 8 * 8;
  float* q_s = reinterpret_cast<float*>(smem + kSplitStages * STAGE);  // [ROWS][DQ], times the scale
  if (D * ELT < LDB) {  // the row tails stay zero (the copies never write them)
    for (int i = threadIdx.x; i < kSplitStages * STAGE / 16; i += kSplitThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }
  for (int i = threadIdx.x; i < ROWS * DQ; i += kSplitThreads) {
    const int r = i / DQ, c = i - r * DQ;
    q_s[i] = r < nrows && c < D ? to_float(q[(bhs * n + r) * D + c]) * sm_scale : 0.f;
  }
  const int page0 = page_table ? key0 / page_size : 0;
  if (page_table && key1 > key0) {
    const int pages = min((key1 - 1) / page_size + 1 - page0, kSplitTableCache);
    for (int i = threadIdx.x; i < pages; i += kSplitThreads) table_s[i] = table_b[page0 + i];
  }
  if (threadIdx.x < kSplitRows) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();

  const int t_begin = key0 / BN, t_end = key1 > key0 ? (key1 - 1) / BN + 1 : t_begin;
  // with a bitmap: the first tile at or after t with a live key below key1
  auto next_tile = [&](int t) {
    if (live_b) {
      for (; t < t_end; ++t) {
        const int last = min(t * BN + BN, key1) - 1;
        bool any = false;
        for (int blk = (t * BN) / block_k; blk <= last / block_k && !any; ++blk)
          any = live_b[blk] != 0;
        if (any) break;
      }
    }
    return t;
  };
  // the row of k/v (and of the scales) holding key `pos`, or -1 where no
  // row of the block sees it
  auto src_row = [&](int pos) -> long long {
    if (pos < key0 || pos >= key1 || (live_b && live_b[pos / block_k] == 0)) return -1;
    if (page_table) {
      const int pi = pos / page_size;
      const int page = pi - page0 < kSplitTableCache ? table_s[pi - page0] : table_b[pi];
      if (page < 0 || page >= n_pool) __trap();  // a corrupt table faults loudly
      return ((long long)page * H + h) * page_size + (pos - pi * page_size);
    }
    return (long long)bhs * S + pos;
  };
  // copies: the K and V rows of a tile, D * elt bytes each in chunks of
  // `unit` bytes (16 where the row allows, else 8 or 4, else one element);
  // keys no row sees are zero-filled
  const int row_bytes = D * ELT;
  const int unit = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : ELT;
  const int cpr = row_bytes / unit;
  const char* kbytes = reinterpret_cast<const char*>(k);
  const char* vbytes = reinterpret_cast<const char*>(v);
  auto fetch = [&](int t, int st) {
    unsigned char* ks = smem + st * STAGE;
    unsigned char* vs = ks + BN * LDB;
    for (int i = threadIdx.x; i < BN * cpr; i += kSplitThreads) {
      const int j = i / cpr, c = i - j * cpr;
      const long long row = src_row(t * BN + j);
      const size_t off = (row < 0 ? 0 : row * row_bytes) + c * unit;
      split_copy(ks + j * LDB + c * unit, kbytes + off, row >= 0, unit);
      split_copy(vs + j * LDB + c * unit, vbytes + off, row >= 0, unit);
    }
    if (QUANT) {
      float* sc = reinterpret_cast<float*>(vs + BN * LDB);
      for (int j = threadIdx.x; j < BN; j += kSplitThreads) {
        const long long row = src_row(t * BN + j);
        split_copy(sc + j, k_scale + (row < 0 ? 0 : row), row >= 0, 4);
        split_copy(sc + BN + j, v_scale + (row < 0 ? 0 : row), row >= 0, 4);
      }
    }
  };

  float acc[ROWS][kSplitChunks][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int u = 0; u < kSplitChunks; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][u][e] = 0.f;
  const int grp = warp * 4 + lane / 8, sub = lane % 8;  // this lane's key of a tile, its channel chunks
  const int n8 = DQ / 8, n4 = DQ / 4;

  // key tile t, landed in stage st, into the rows' softmax states and acc
  auto compute = [&](int t, int st) {
    const unsigned char* kt = smem + st * STAGE;
    const unsigned char* vt = kt + BN * LDB;
    const float* sc = reinterpret_cast<const float*>(vt + BN * LDB);
    // scores: key grp, 8 channels a lane, summed over the group's 8 lanes
    float dot[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dot[r] = 0.f;
    if (grp < BN) {
      for (int c8 = sub; c8 < n8; c8 += 8) {
        float kv[8];
        split_load<KV, 8>(kv, kt + grp * LDB + c8 * 8 * ELT);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 qa = *reinterpret_cast<const float4*>(q_s + r * DQ + c8 * 8);
          const float4 qb = *reinterpret_cast<const float4*>(q_s + r * DQ + c8 * 8 + 4);
          float x = dot[r];
          x = fmaf(qa.x, kv[0], x); x = fmaf(qa.y, kv[1], x);
          x = fmaf(qa.z, kv[2], x); x = fmaf(qa.w, kv[3], x);
          x = fmaf(qb.x, kv[4], x); x = fmaf(qb.y, kv[5], x);
          x = fmaf(qb.z, kv[6], x); x = fmaf(qb.w, kv[7], x);
          dot[r] = x;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
    if (grp < BN && sub == 0) {
      const int pos = t * BN + grp;
      const bool live = pos < key1 && (live_b == nullptr || live_b[pos / block_k] != 0);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const bool vis = live && r < nrows && pos <= len - n + r;
        p_s[r][grp] = vis ? (QUANT ? dot[r] * sc[grp] : dot[r]) : -INFINITY;
      }
    }
    __syncthreads();
    // the online softmax, a warp per query row and a lane per key
    if (warp < nrows) {
      const int r = warp;
      const float s = lane < BN ? p_s[r][lane] : -INFINITY;
      float tmax = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet: add nothing
      const float corr = expf(m_old - m_use);
      float p = expf(s - m_use);  // 0 where unseen
      float psum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (QUANT && lane < BN) p *= sc[BN + lane];
      if (lane < BN) p_s[r][lane] = p;
      if (lane == 0) {
        l_s[r] = fmaf(l_s[r], corr, psum);
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();
    // P V over this thread's columns (chunks of 4): keys no row sees are
    // zeros in the ring, and their p is 0
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float corr = r < nrows ? corr_s[r] : 1.f;
#pragma unroll
      for (int u = 0; u < kSplitChunks; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][u][e] *= corr;
    }
    for (int j = 0; j < BN; ++j) {
#pragma unroll
      for (int u = 0; u < kSplitChunks; ++u) {
        const int ch = threadIdx.x + u * kSplitThreads;
        if (ch >= n4) break;
        float vv[4];
        split_load<KV, 4>(vv, vt + j * LDB + ch * 4 * ELT);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float p = r < nrows ? p_s[r][j] : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][u][e] = fmaf(p, vv[e], acc[r][u][e]);
        }
      }
    }
  };

  // the ring: kSplitStages - 1 tiles in flight ahead of the one computing
  int fetch_t = next_tile(t_begin), comp_t = fetch_t;
#pragma unroll
  for (int st = 0; st < kSplitStages - 1; ++st) {
    if (fetch_t < t_end) {
      fetch(fetch_t, st);
      fetch_t = next_tile(fetch_t + 1);
    }
    split_commit();
  }
  for (int it = 0; comp_t < t_end; ++it) {
    split_wait();     // this thread's copies of tile `it` landed
    __syncthreads();  // everyone's; and stage it - 1 and p_s are consumed
    if (fetch_t < t_end) {
      fetch(fetch_t, (it + kSplitStages - 1) % kSplitStages);
      fetch_t = next_tile(fetch_t + 1);
    }
    split_commit();
    compute(comp_t, it % kSplitStages);
    comp_t = next_tile(comp_t + 1);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // m_s and l_s are final

  const bool direct = n_live == 1;  // this block writes the output itself
  float* ws_acc = ws;                                                 // [B*H][spans][rows][D]
  float* ws_ml = ws + (size_t)gridDim.x * n_spans * kSplitRows * D;  // [B*H][spans][rows][2]
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nrows) break;
    const float l = l_s[r];
    const size_t part = (bhs * n_spans + split) * kSplitRows + r;
#pragma unroll
    for (int u = 0; u < kSplitChunks; ++u) {
      const int ch = threadIdx.x + u * kSplitThreads;
      if (ch >= n4) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = ch * 4 + e;
        if (c >= D) break;
        if (direct)
          store(out + (bhs * n + r) * D + c, l > 0.f ? acc[r][u][e] / l : 0.f);
        else
          ws_acc[part * D + c] = acc[r][u][e];
      }
    }
    if (!direct && threadIdx.x == 0) {
      ws_ml[part * 2] = m_s[r];
      ws_ml[part * 2 + 1] = l;
    }
  }
  if (direct) return;

  // the last span block of this (b, h) to arrive merges the spans in span
  // order, each thread its elements, as flash_decode.cu does: per chunk of 8
  // spans it loads every (m, l, acc) at once, rescales its running sums to
  // the chunk's new maximum, then adds the spans' terms e^(m - M) in order
  // (a span with no visible key has m = -inf, l = acc = 0: no term)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last_block = atomicAdd(counters + bh, 1) == n_live - 1;
    if (last_block) atomicExch(counters + bh, 0);  // ready for the next call
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  constexpr int kChunk = 8;
  const size_t part0 = bhs * n_spans * kSplitRows;  // (span sp, row r) at part0 + sp * rows + r
  for (int i = threadIdx.x; i < nrows * D; i += kSplitThreads) {
    const int r = i / D, c = i - r * D;
    float mx = -INFINITY, sum_l = 0.f, sum_a = 0.f;
    for (int sp0 = 0; sp0 < n_live; sp0 += kChunk) {
      float ms[kChunk], ls[kChunk], as[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const size_t part = part0 + (size_t)(sp0 + u) * kSplitRows + r;
        const bool in = sp0 + u < n_live;
        ms[u] = in ? __ldcg(ws_ml + part * 2) : -INFINITY;
        ls[u] = in ? __ldcg(ws_ml + part * 2 + 1) : 0.f;
        as[u] = in ? __ldcg(ws_acc + part * D + c) : 0.f;
      }
      float m_new = mx;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) m_new = fmaxf(m_new, ms[u]);
      if (m_new == -INFINITY) continue;  // no visible key yet
      const float corr = expf(mx - m_new);  // 0 while mx is -inf
      sum_l *= corr;
      sum_a *= corr;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float w = expf(ms[u] - m_new);  // 0 for a span with no visible key
        sum_l = fmaf(ls[u], w, sum_l);
        sum_a = fmaf(as[u], w, sum_a);
      }
      mx = m_new;
    }
    store(out + (bhs * n + r) * D + c, sum_l > 0.f ? sum_a / sum_l : 0.f);
  }
}

template <typename T, typename KV>
cudaError_t launch_split(const DecodeArgs& a, void* ws, void* counters) {
  auto kernel = a.n == 1 ? wide_split_kernel<T, KV, 1> : wide_split_kernel<T, KV, kSplitRows>;
  const int smem = split_smem_bytes(a.D, (int)sizeof(KV), a.n == 1 ? 1 : kSplitRows);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kSplitSpan - 1) / kSplitSpan);
  kernel<<<grid, kSplitThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.bitmap),
      static_cast<const int*>(a.page_table), static_cast<T*>(a.out), static_cast<float*>(ws),
      static_cast<int*>(counters), a.H, a.n, a.S, a.D, a.n_blocks, a.block_k, a.page_size,
      a.n_pool, a.sm_scale);
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
  float* dq_acc;  // bf16 backward: the fp32 dq workspace [B,H,nq,D]
  int B, H, nq, nk, D, mode;
  int cols;      // bf16: output columns a block owns (an instance of the tensor-core kernels)
  bool resident;  // bf16: the block keeps its most re-read operand in shared memory
  int smem;       // bf16: dynamic shared bytes a block takes (the wrapper's plan)
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
      ps[me * (kBN + 1) + sub + kPer * u] = p;
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
      dss[me * (kBN + 1) + sub + kPer * u] = p * (dp[u] - delta) * a.scale;
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
      pss[me * (kBN + 1) + sub + kPer * u] = p;
      dss[me * (kBN + 1) + sub + kPer * u] = ds;
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


// float32: the CUDA-core kernels above (the bf16 inputs take the
// tensor-core kernels below; these have only float instances)
cudaError_t attention_fwd_fp32(const AttnArgs& a) {
  const dim3 grid((a.nq + kBM - 1) / kBM, a.B * a.H, (a.D + kCols - 1) / kCols);
  return launch_attn(wide_fwd_kernel<float>, kFwdSmem, grid, a);
}

cudaError_t attention_bwd_fp32(const AttnArgs& a) {
  const int groups = (a.D + kCols - 1) / kCols;
  cudaError_t err = launch_attn(wide_dq_kernel<float>, kDqSmem,
                                dim3((a.nq + kBM - 1) / kBM, a.B * a.H, groups), a);
  if (err != cudaSuccess) return err;
  return launch_attn(wide_dkv_kernel<float>, kDkvSmem,
                     dim3((a.nk + kBM - 1) / kBM, a.B * a.H, groups), a);
}

// ---------------------------------------------------------------------------
// bfloat16 attention on tensor cores: bf16 operands, fp32 accumulators,
// mma.sync.m16n8k16 with operands read by ldmatrix, as the fused backward
// and the tile arm of flash_attention.cu / flash_decode_tile.cu do. A
// streamed operand is staged as [64 rows][64 channels] tiles (rows padded
// to 72 bf16, so the 8 rows of an 8x8 ldmatrix hit 8 distinct 16-byte
// bank groups) by cp.async into a ring of slots: one slot an "item",
// items consumed in a fixed order, the next ones in flight while one
// computes, one __syncthreads an item; a resident one as [64 rows][D's
// chunks x 64 + 8], loaded once. A tile's rows past the sequence
// and channels past D are zero-filled, so no byte outside the tensors is
// read and 0 x NaN never meets a tensor core. D is a multiple of 8 (the
// wrapper pads other D with zero channels).
//
// What bounds them: operations (4 D flops per visible pair forward, 10 D
// backward, at D = 320 / 512 about 0.07 / 0.11 ms forward and 0.17 / 0.27
// ms backward at the card's bf16 peak for the training shapes). The
// column groups add recomputed scores: ceil(D / cols) times 2 D flops a
// pair forward and 4 D backward. What holds them on the card is the
// copies from L2 into shared memory (without them both ran ~1.6-1.8x
// faster), so each keeps the operand its loop re-reads most resident in
// shared memory where that fits (`RES`): the forward its 64 x D query
// tile while two blocks still fit an SM (D <= 576), the backward its 64 x
// D key and value tiles while its block fits (D <= 640). Above that the
// ring brings those operands too, chunk by chunk, so shared memory stays
// bounded and every D runs.
//
// Forward (`wide_fwd_mma_kernel<COLS, RES>`, COLS = 192 or 256
// output columns a block): a block of 4 warps per (column group, head,
// batch row, 64-row query tile), 16 query rows a warp, loops over the live
// 64-key tiles. Per key tile: S = Q K^T over all of D from ceil(D/64)
// items (a K chunk, with its Q chunk unless Q is resident), then the
// online softmax of flash_attention.cu's tensor-core forward (base 2, P =
// 2^(fl(s fl(scale log2 e)) - m), rounded to bf16 into A fragments in
// registers), then O += P V from items of the group's 64-column V tiles.
// The accumulator is COLS / 2 registers a thread. o and lse are the
// fwd_wgmma_kernel's function and rounding; the plain version with
// p_dtype = bf16 matches both. (A block of 8 warps forming S once, each
// warpgroup over half of D's chunks, ran slower on the card: PERF.md.)
//
// Backward (`wide_bwd_mma_kernel<COLS, RES>`, COLS = 128): one fused
// pass, as bwd_mma_kernel: a block of 8 warps per (column group, head,
// batch row, 64-key tile) loops over the query tiles that see its keys.
// Warp w owns keys 16 (w % 4) and queries 32 (w / 4) of each query tile,
// so S^T and dP^T are 16 x 32 a warp (32 registers) beside dK and dV for
// the group's columns (COLS registers). Per query tile: S^T = K Q^T and
// dP^T = V dO^T over all of D from ceil(D/64) items (Q and dO chunks, with
// K and V chunks unless resident); P^T = exp(fl(fl(s scale) - lse)) and
// dS^T = P^T (dP^T - delta) scale, each rounded to bf16 once; dS^T also
// to shared memory; then the group's Q and dO columns for dV += P^T dO and
// dK += dS^T Q; then dQ += dS K from the block's keys at the group's
// columns (resident), added into the fp32 workspace with float4 atomics.
// At the end the two warps that share keys sum their dK and dV through
// shared memory in a fixed order: dk and dv are bit-identical run to run,
// dq's last bits follow the atomics' order.

typedef __nv_bfloat16 bf16;
constexpr int kT = 64;                  // tile rows (queries or keys) and chunk channels
constexpr int kLdt = kT + 8;            // a staged tile's row stride
constexpr int kTileElems = kT * kLdt;   // bf16 elements of a staged tile
constexpr int kFwdThreads = 128, kBwdThreads = 256;
constexpr int kFwdStages = 3, kFwdResStages = 4, kBwdStages = 3;
constexpr float kNeg = -1e30f;

// a resident operand's row stride: D's 64-channel chunks + 8 (bf16). The
// shared memory a block takes, and whether it keeps an operand resident,
// are the wrapper's plan (`ops/wide_head.py:mma_smem`, `mma_resident`):
// the forward a resident query tile and a ring of 4 one-tile slots, or a
// ring of 3 two-tile slots; the backward resident key and value tiles and
// a ring of 3 two-tile slots, or a ring of 3 four-tile slots and the keys
// at the group's columns, then dS^T, lse and delta.
__host__ __device__ constexpr int resident_ld(int D) { return (D + kT - 1) / kT * kT + 8; }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, zero-filled when !ok (then nothing is read)
__device__ __forceinline__ void cp_async16(bf16* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + 64) x channels [c0, c0 + W) of a row-major [n, D]
// bf16 matrix -> dst (row stride ld), asynchronously; zeros where a row is
// past n or a channel past D
template <int THREADS, int W>
__device__ __forceinline__ void stage_tile(bf16* dst, int ld, const bf16* __restrict__ src, int row0,
                                           int n, int c0, int D) {
  constexpr int PIECES = W / 8;
  for (int i = threadIdx.x; i < kT * PIECES; i += THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * 8;
    const bool ok = row0 + r < n && c0 + c < D;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)(row0 + r) * D + c0 + c : src, ok);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// whether every (query, key) pair of a 64 x 64 tile is visible, so its
// scores need no mask (the static-mask arm's layout marks tiles live or
// empty, never full)
__device__ __forceinline__ bool tile_full(int mode, int q0, int k0, int nq, int nk) {
  return mode != kModeMask && q0 + kT <= nq && k0 + kT <= nk && (mode == kModeAll || k0 + kT - 1 <= q0);
}

__device__ __forceinline__ bool visible_at(int i, int j, int nq, int nk, int mode,
                                           const uint8_t* __restrict__ mask) {
  if (i >= nq || j >= nk) return false;
  if (mode == kModeCausal) return j <= i;
  if (mode == kModeMask) return mask[(size_t)i * nk + j] != 0;
  return true;
}

// One 64-key tile of the online softmax for this thread's rows r and r + 8
// (flash_attention.cu's, unchanged): s[nb][e] is the score of row r + 8
// (e / 2), key c0 + 8 nb + e % 2; in base 2 with x = fl(s scale_log2), s
// becomes P = 2^(x - m_new) in place, m and l are updated and corr is the
// factor the output accumulator takes
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int r, int c0, int nq, int nk,
                                             int mode, const uint8_t* __restrict__ mask,
                                             float scale_log2) {
  float tmax[2] = {kNeg, kNeg};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(s[nb][e], scale_log2);
      if (MASKED && !visible_at(r + 8 * (e / 2), c0 + 8 * nb + (e % 2), nq, nk, mode, mask)) x = kNeg;
      s[nb][e] = x;
      tmax[e / 2] = fmaxf(tmax[e / 2], x);
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m_new = fmaxf(m[hh], quad_max(tmax[hh]));
    corr[hh] = ex2(m[hh] - m_new);
    m[hh] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nb][e] = ex2(__fsub_rn(s[nb][e], m[e / 2]));
      psum[e / 2] += s[nb][e];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + quad_sum(psum[hh]);
}

// the first live key tile at or after kt (the static-mask arm skips the
// tiles its layout marks empty) of query tile qt
__device__ __forceinline__ int live_key_tile(int kt, int kend, int mode, const int* __restrict__ layout,
                                             int qt, int ktiles) {
  if (mode == kModeMask)
    while (kt < kend && layout[qt * ktiles + kt] == 0) ++kt;
  return kt;
}
// the first live query tile at or after qt of key tile kt
__device__ __forceinline__ int live_query_tile(int qt, int qtiles, int mode,
                                               const int* __restrict__ layout, int kt, int ktiles) {
  if (mode == kModeMask)
    while (qt < qtiles && layout[qt * ktiles + kt] == 0) ++qt;
  return qt;
}

// the S-phase product of one 64-channel chunk: c[nb] += A B^T for this
// warp's 16 rows of `a` (from row ar, row stride lda) against the 8 NB
// columns of rows [br, br + 8 NB) of `b` (stride ldb), both K-major
template <int NB>
__device__ __forceinline__ void chunk_product(float (&c)[NB][4], const bf16* a, int lda, int ar,
                                              const bf16* b, int ldb, int br, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, a + (ar + (lane & 15)) * lda + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (br + np * 16 + (lane & 7) + (lane >> 4) * 8) * ldb + kc * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * np], af, bf[0], bf[1]);
      mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// c[8 j + nb] += A . T where A is 16 x 16 KS fragments (a[kc], over rows
// [kr, kr + 16 KS) of `t`) and t a [rows][ld] row-major tile whose 64
// columns from column 0 are this product's output columns
template <int KS, int NBT>
__device__ __forceinline__ void panel_product(float (&c)[NBT][4], int nb0, const uint32_t (&a)[KS][4],
                                              const bf16* t, int ld, int kr, int lane) {
#pragma unroll
  for (int kc = 0; kc < KS; ++kc)
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      uint32_t bf[4];
      ldsm_x4_t(bf, t + (kr + kc * 16 + (lane & 15)) * ld + nd * 16 + (lane >> 4) * 8);
      mma_bf16(c[nb0 + 2 * nd], a[kc], bf[0], bf[1]);
      mma_bf16(c[nb0 + 2 * nd + 1], a[kc], bf[2], bf[3]);
    }
}

// dst[0 .. 4) += x in global memory (16-byte aligned), one vector atomic
__device__ __forceinline__ void red_add4(float* dst, float4 x) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(dst), x);
#else
  atomicAdd(dst, x.x);
  atomicAdd(dst + 1, x.y);
  atomicAdd(dst + 2, x.z);
  atomicAdd(dst + 3, x.w);
#endif
}

// The item ring: item i lands in slot i % STAGES. next() waits for the
// next item, lets every thread pass the barrier (so the slot computed
// before is free), issues the item STAGES - 1 ahead into that slot through
// `issue(slot)` (which commits one cp.async group, empty past the end) and
// returns the landed slot's first tile.
template <int STAGES, int TILES>
struct Ring {
  bf16* base;
  int use = 0, fill = STAGES - 1;
  __device__ __forceinline__ bf16* slot(int s) const { return base + s * TILES * kTileElems; }
  template <typename Issue>
  __device__ __forceinline__ const bf16* next(Issue& issue) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(slot(fill));
    fill = fill + 1 == STAGES ? 0 : fill + 1;
    const bf16* landed = slot(use);
    use = use + 1 == STAGES ? 0 : use + 1;
    return landed;
  }
};

// grid (groups * B * H, ceil(nq / 64)): x = bh * groups + group, so the
// groups of one query tile run side by side and share its reads in L2;
// the query tile is reversed, so the causal tiles with the most keys start
// first. RES: the query tile over all of D stays in shared memory, and
// the ring brings one K chunk or V tile an item; else the ring brings
// (Q, K) chunk pairs and V tile pairs.
template <int COLS, bool RES>
__global__ void __launch_bounds__(kFwdThreads, 2)
wide_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                    const int* __restrict__ layout, bf16* __restrict__ o, float* __restrict__ lse,
                    int nq, int nk, int D, int groups, int mode, float scale) {
  constexpr int NB = COLS / 8, VT = COLS / 64;
  constexpr int NV = RES ? VT : (VT + 1) / 2;  // V items a key tile
  extern __shared__ float4 smem4[];
  bf16* qres = reinterpret_cast<bf16*>(smem4);  // RES: [64][ldq]
  const int ldq = resident_ld(D);
  Ring<RES ? kFwdResStages : kFwdStages, RES ? 1 : 2> ring{qres + (RES ? kT * ldq : 0)};
  const int group = blockIdx.x % groups, c0 = group * COLS;
  const size_t bh = blockIdx.x / groups;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * kT;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, r0 = (threadIdx.x / 32) * 16;
  const int chunks = (D + kT - 1) / kT, per_tile = chunks + NV;
  const int ktiles = (nk + kT - 1) / kT;
  const int kend = mode == kModeCausal ? min(ktiles, (q0 + kT - 1) / kT + 1) : ktiles;
  const bf16* qb = q + bh * nq * D;
  const bf16* kb = k + bh * nk * D;
  const bf16* vb = v + bh * nk * D;

  if (RES)
    for (int c = 0; c < chunks; ++c) stage_tile<kFwdThreads, kT>(qres + c * kT, ldq, qb, q0, nq, c * kT, D);
  cp_async_commit();  // (empty unless RES) completes before the first item

  // the issuing cursor: (key tile, item) of the next item to fetch
  int ikt = live_key_tile(0, kend, mode, layout, qt, ktiles), item = 0;
  auto issue = [&](bf16* dst) {
    if (ikt < kend) {
      const int key0 = ikt * kT;
      if (item < chunks) {  // channels [64 item, + 64): K, and Q unless resident
        stage_tile<kFwdThreads, kT>(dst, kLdt, kb, key0, nk, item * kT, D);
        if (!RES) stage_tile<kFwdThreads, kT>(dst + kTileElems, kLdt, qb, q0, nq, item * kT, D);
      } else {  // one (RES) or two 64-column V tiles of the group's columns
#pragma unroll
        for (int j = 0; j < (RES ? 1 : 2); ++j) {
          const int tile = (RES ? 1 : 2) * (item - chunks) + j;
          if (tile < VT && c0 + tile * kT < D)
            stage_tile<kFwdThreads, kT>(dst + j * kTileElems, kLdt, vb, key0, nk, c0 + tile * kT, D);
        }
      }
      if (++item == per_tile) {
        item = 0;
        ikt = live_key_tile(ikt + 1, kend, mode, layout, qt, ktiles);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < (RES ? kFwdResStages : kFwdStages) - 1; ++s) issue(ring.slot(s));

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int kt = live_key_tile(0, kend, mode, layout, qt, ktiles); kt < kend;
       kt = live_key_tile(kt + 1, kend, mode, layout, qt, ktiles)) {
    // S = Q K^T over all of D: this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const bf16* st = ring.next(issue);
      if (RES)
        chunk_product<8>(s, qres + c * kT, ldq, r0, st, kLdt, 0, lane);
      else
        chunk_product<8>(s, st + kTileElems, kLdt, r0, st, kLdt, 0, lane);
    }
    float corr[2];
    const int k0 = kt * kT;
    if (tile_full(mode, q0, k0, nq, nk))
      softmax_tile<false>(s, m, l, corr, q0 + r0 + g, k0 + 2 * t, nq, nk, mode, mask, scale * kLog2e);
    else
      softmax_tile<true>(s, m, l, corr, q0 + r0 + g, k0 + 2 * t, nq, nk, mode, mask, scale * kLog2e);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] *= corr[e / 2];
    // P as the A fragments of its four 16-key steps, rounded to bf16
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
    // O += P V over the group's columns
#pragma unroll
    for (int vi = 0; vi < NV; ++vi) {
      const bf16* st = ring.next(issue);
#pragma unroll
      for (int j = 0; j < (RES ? 1 : 2); ++j) {
        const int tile = (RES ? 1 : 2) * vi + j;
        if (tile < VT && c0 + tile * kT < D)  // columns past D: nothing to add
          panel_product<4>(acc, 8 * (tile < VT ? tile : 0), pa, st + j * kTileElems, kLdt, 0, lane);
      }
    }
  }

  // o = acc / l in bf16 for the group's columns below D; lse (group 0)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + g + 8 * hh;
    if (row >= nq) continue;
    const float safe_l = fmaxf(l[hh], 1e-30f);
    bf16* orow = o + (bh * nq + row) * D + c0 + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      if (c0 + nb * 8 < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) =
            __floats2bfloat162_rn(acc[nb][2 * hh] / safe_l, acc[nb][2 * hh + 1] / safe_l);
    if (group == 0 && t == 0) lse[bh * nq + row] = m[hh] * kLn2 + logf(safe_l);
  }
}

// grid (groups * B * H, ceil(nk / 64)): x = bh * groups + group; key tile
// 0, which the most causal query tiles see, is scheduled first. RES: the
// block's key and value tiles over all of D stay in shared memory, and the
// ring brings (Q, dO) chunk pairs, then one (Q, dO) pair of the group's
// 64-column tiles an item; else it brings (K, V, Q, dO) chunks, then the
// group's Q and dO columns in one item, and the block's keys at the
// group's columns are resident for dQ.
template <int COLS, bool RES>
__global__ void __launch_bounds__(kBwdThreads, 1)
wide_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const uint8_t* __restrict__ mask, const int* __restrict__ layout,
                    float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv, int nq,
                    int nk, int D, int groups, int mode, float scale) {
  constexpr int NB = COLS / 8, CT = COLS / 64;
  constexpr int NP = RES ? CT : 1;  // items of the group's Q and dO columns
  constexpr int DQB = COLS / 16;    // dq column blocks of 8 a warp: half the group's columns
  extern __shared__ float4 smem4[];
  bf16* base = reinterpret_cast<bf16*>(smem4);
  const int ld = resident_ld(D);
  bf16* kres = base;          // RES: [64][ld] keys, then [64][ld] values
  bf16* vres = base + kT * ld;
  Ring<kBwdStages, RES ? 2 : 4> ring{RES ? base + 2 * kT * ld : base};
  const int group = blockIdx.x % groups, c0 = group * COLS;
  // the block's keys at the group's columns, for dQ: [64][ldg] from column kgc
  bf16* kg = RES ? kres : ring.slot(kBwdStages);
  const int ldg = RES ? ld : COLS + 8, kgc = RES ? c0 : 0;
  bf16* dsts = RES ? ring.slot(kBwdStages) : kg + kT * ldg;  // dS^T [key][query], stride kLdt
  float* lse_s = reinterpret_cast<float*>(dsts + kTileElems);  // [64]
  float* delta_s = lse_s + kT;                                   // [64]

  const size_t bh = blockIdx.x / groups;
  const int kt = blockIdx.y, k0 = kt * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kr = (warp % 4) * 16;  // this warp's 16 keys of the tile
  const int qh = (warp / 4) * 32;  // and its 32 queries of each query tile
  const int chunks = (D + kT - 1) / kT;
  const int ktiles = (nk + kT - 1) / kT, qtiles = (nq + kT - 1) / kT;
  const bf16* qb = q + bh * nq * D;
  const bf16* db = dout + bh * nq * D;
  const bf16* kb = k + bh * nk * D;
  const bf16* vb = v + bh * nk * D;

  // causal: the first query tile whose rows reach key k0 (none when nk > nq
  // puts the whole key tile past the last query)
  const int qt_first = live_query_tile(mode == kModeCausal ? k0 / kT : 0, qtiles, mode, layout, kt, ktiles);
  if (qt_first < qtiles) {
    if (RES) {
      for (int c = 0; c < chunks; ++c) {
        stage_tile<kBwdThreads, kT>(kres + c * kT, ld, kb, k0, nk, c * kT, D);
        stage_tile<kBwdThreads, kT>(vres + c * kT, ld, vb, k0, nk, c * kT, D);
      }
    } else {
#pragma unroll
      for (int j = 0; j < CT; ++j) stage_tile<kBwdThreads, kT>(kg + j * kT, ldg, kb, k0, nk, c0 + j * kT, D);
    }
  }
  cp_async_commit();

  int iqt = qt_first, item = 0;
  auto issue = [&](bf16* dst) {
    if (iqt < qtiles) {
      const int qr0 = iqt * kT;
      if (item < chunks) {  // channels [64 item, + 64): Q, dO (tiles 0, 1), and K, V (2, 3) unless resident
        const int c = item * kT;
        stage_tile<kBwdThreads, kT>(dst, kLdt, qb, qr0, nq, c, D);
        stage_tile<kBwdThreads, kT>(dst + kTileElems, kLdt, db, qr0, nq, c, D);
        if (!RES) {
          stage_tile<kBwdThreads, kT>(dst + 2 * kTileElems, kLdt, kb, k0, nk, c, D);
          stage_tile<kBwdThreads, kT>(dst + 3 * kTileElems, kLdt, vb, k0, nk, c, D);
        }
      } else {  // the group's columns of Q (tile 0; RES: tile j of the group) and dO (tile 1)
#pragma unroll
        for (int j = 0; j < (RES ? 1 : CT); ++j) {
          const int col = c0 + (RES ? item - chunks : j) * kT;
          if (col < D) {
            stage_tile<kBwdThreads, kT>(dst + 2 * j * kTileElems, kLdt, qb, qr0, nq, col, D);
            stage_tile<kBwdThreads, kT>(dst + (2 * j + 1) * kTileElems, kLdt, db, qr0, nq, col, D);
          }
        }
      }
      if (++item == chunks + NP) {
        item = 0;
        iqt = live_query_tile(iqt + 1, qtiles, mode, layout, kt, ktiles);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kBwdStages - 1; ++s) issue(ring.slot(s));

  float dk_acc[NB][4], dv_acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;

  for (int qt = qt_first; qt < qtiles; qt = live_query_tile(qt + 1, qtiles, mode, layout, kt, ktiles)) {
    const int q0 = qt * kT;
    // lse and delta of the tile's rows (their last readers passed the
    // previous tile's barriers; the first readers come after this tile's)
    if (threadIdx.x < 2 * kT) {
      const int r = threadIdx.x % kT;
      const bool ok = q0 + r < nq;
      if (threadIdx.x < kT)
        lse_s[r] = ok ? lse[bh * nq + q0 + r] : 0.f;
      else
        delta_s[r] = ok ? delta[bh * nq + q0 + r] : 0.f;
    }
    // S^T = K Q^T and dP^T = V dO^T over all of D: 16 keys x 32 queries a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const bf16* st = ring.next(issue);
      const bf16* ka = RES ? kres + c * kT : st + 2 * kTileElems;
      const bf16* va = RES ? vres + c * kT : st + 3 * kTileElems;
      chunk_product<4>(s, ka, RES ? ld : kLdt, kr, st, kLdt, qh, lane);
      chunk_product<4>(dp, va, RES ? ld : kLdt, kr, st + kTileElems, kLdt, qh, lane);
    }

    // P^T and dS^T rounded to bf16 once, as A fragments over this warp's
    // two 16-query steps (a[kc][(nb & 1) * 2 + hh]); dS^T also to shared memory
    const bool full = tile_full(mode, q0, k0, nq, nk);
    uint32_t pa[2][4], dsa[2][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int ql = qh + nb * 8 + 2 * t;
      const float lq[2] = {lse_s[ql], lse_s[ql + 1]}, de[2] = {delta_s[ql], delta_s[ql + 1]};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int kl = kr + g + 8 * hh;
        float p[2], ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          p[j] = expf(__fsub_rn(__fmul_rn(s[nb][2 * hh + j], scale), lq[j]));
          if (!full && !visible_at(q0 + ql + j, k0 + kl, nq, nk, mode, mask)) p[j] = 0.f;
          ds[j] = p[j] * (dp[nb][2 * hh + j] - de[j]) * scale;
        }
        pa[nb >> 1][(nb & 1) * 2 + hh] = pack_bf16(p[0], p[1]);
        const uint32_t d2 = pack_bf16(ds[0], ds[1]);
        dsa[nb >> 1][(nb & 1) * 2 + hh] = d2;
        *reinterpret_cast<uint32_t*>(dsts + kl * kLdt + ql) = d2;
      }
    }

    // dV += P^T dO and dK += dS^T Q over this warp's 32 queries, the
    // group's columns (the first item's barrier also completes dS^T)
#pragma unroll
    for (int pi = 0; pi < NP; ++pi) {
      const bf16* st = ring.next(issue);
#pragma unroll
      for (int j = 0; j < (RES ? 1 : CT); ++j) {
        const int tile = RES ? pi : j;
        if (c0 + tile * kT >= D) continue;
        panel_product<2>(dv_acc, 8 * tile, pa, st + (2 * j + 1) * kTileElems, kLdt, qh, lane);
        panel_product<2>(dk_acc, 8 * tile, dsa, st + 2 * j * kTileElems, kLdt, qh, lane);
      }
    }

    // dQ += dS K over the 64 keys: warp w's 16 query rows 16 (w % 4), half
    // (w / 4) of the group's columns, added into the fp32 workspace
    {
      const int qr = (warp % 4) * 16, ch = (warp / 4) * (COLS / 2);
      float acc[DQB][4];
#pragma unroll
      for (int nb = 0; nb < DQB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t a[4];
        ldsm_x4_t(a, dsts + (kc * 16 + (lane & 7) + (lane >> 4) * 8) * kLdt + qr + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int nd = 0; nd < DQB / 2; ++nd) {
          if (c0 + ch + nd * 16 >= D) continue;
          uint32_t bf[4];
          ldsm_x4_t(bf, kg + (kc * 16 + (lane & 15)) * ldg + kgc + ch + nd * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * nd], a, bf[0], bf[1]);
          mma_bf16(acc[2 * nd + 1], a, bf[2], bf[3]);
        }
      }
      // lanes t and t ^ 1 swap halves so that each adds 4 adjacent columns:
      // even t row g, columns 2t .. 2t + 3; odd t row g + 8, 2t - 2 .. 2t + 1
      const int odd = t & 1;
      const int r = q0 + qr + g + 8 * odd;
      float* row = dq_acc + (bh * nq + r) * D + c0 + ch + 2 * (t - odd);
#pragma unroll
      for (int nb = 0; nb < DQB; ++nb) {
        const float send0 = odd ? acc[nb][0] : acc[nb][2];
        const float send1 = odd ? acc[nb][1] : acc[nb][3];
        const float got0 = __shfl_xor_sync(0xffffffffu, send0, 1);
        const float got1 = __shfl_xor_sync(0xffffffffu, send1, 1);
        const float4 x = odd ? make_float4(got0, got1, acc[nb][2], acc[nb][3])
                             : make_float4(acc[nb][0], acc[nb][1], got0, got1);
        if (r < nq && c0 + ch + nb * 8 < D) red_add4(row + nb * 8, x);
      }
    }
  }

  // warps w and w + 4 hold the same keys: w + 4 hands its dK and dV over
  // through shared memory no longer read (the resident tiles, or the
  // ring: 64 KB either way), w adds them in a fixed order and stores
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(RES ? kres : ring.base);
  const int lt = threadIdx.x % 128;
  if (warp >= 4) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(nb * 4 + e) * 128 + lt] = dk_acc[nb][e];
        red[(NB * 4 + nb * 4 + e) * 128 + lt] = dv_acc[nb][e];
      }
  }
  __syncthreads();
  if (warp >= 4) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int c = k0 + kr + g + 8 * hh;
    if (c >= nk) continue;
    bf16* krow = dk + (bh * nk + c) * D + c0 + 2 * t;
    bf16* vrow = dv + (bh * nk + c) * D + c0 + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (c0 + nb * 8 >= D) continue;
      const int i0 = (nb * 4 + 2 * hh) * 128 + lt, i1 = i0 + 128, v0 = i0 + NB * 4 * 128;
      *reinterpret_cast<__nv_bfloat162*>(krow + nb * 8) = __floats2bfloat162_rn(
          dk_acc[nb][2 * hh] + red[i0], dk_acc[nb][2 * hh + 1] + red[i1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + nb * 8) = __floats2bfloat162_rn(
          dv_acc[nb][2 * hh] + red[v0], dv_acc[nb][2 * hh + 1] + red[v0 + 128]);
    }
  }
}

// the fp32 dq workspace -> dq in bfloat16, 4 values a thread
__global__ void wide_dq_convert_kernel(const float4* __restrict__ src,
                                       __nv_bfloat162* __restrict__ dst, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 x = src[i];
    dst[2 * i] = __floats2bfloat162_rn(x.x, x.y);
    dst[2 * i + 1] = __floats2bfloat162_rn(x.z, x.w);
  }
}

template <typename K>
cudaError_t launch_mma(K kernel, int threads, int smem, dim3 grid, cudaStream_t stream,
                       const AttnArgs& a, int groups) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      a.mask, a.layout, static_cast<bf16*>(a.o), static_cast<float*>(a.lse_out), a.nq, a.nk, a.D,
      groups, a.mode, a.scale);
  return cudaGetLastError();
}

int mma_groups(const AttnArgs& a) { return (a.D + a.cols - 1) / a.cols; }

template <int COLS>
cudaError_t launch_fwd_mma(const AttnArgs& a, int groups) {
  const dim3 grid(groups * a.B * a.H, (a.nq + kT - 1) / kT);
  return a.resident ? launch_mma(wide_fwd_mma_kernel<COLS, true>, kFwdThreads, a.smem, grid, a.stream, a,
                                 groups)
                    : launch_mma(wide_fwd_mma_kernel<COLS, false>, kFwdThreads, a.smem, grid, a.stream, a,
                                 groups);
}

cudaError_t attention_fwd_bf16(const AttnArgs& a) {
  const int groups = mma_groups(a);
  switch (a.cols) {
    case 192: return launch_fwd_mma<192>(a, groups);
    case 256: return launch_fwd_mma<256>(a, groups);
    default: return cudaErrorInvalidValue;
  }
}

template <int COLS, bool RES>
cudaError_t launch_bwd_mma(const AttnArgs& a, int groups) {
  auto kernel = wide_bwd_mma_kernel<COLS, RES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(groups * a.B * a.H, (a.nk + kT - 1) / kT), kBwdThreads, a.smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.mask, a.layout, a.dq_acc, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.nq, a.nk, a.D, groups, a.mode, a.scale);
  return cudaGetLastError();
}


// zero the dq workspace, the fused kernel, dq's conversion to bf16
cudaError_t attention_bwd_bf16(const AttnArgs& a) {
  const size_t n = (size_t)a.B * a.H * a.nq * a.D;
  cudaError_t err = cudaMemsetAsync(a.dq_acc, 0, n * sizeof(float), a.stream);
  if (err != cudaSuccess) return err;
  const int groups = mma_groups(a);
  if (a.cols != 128) return cudaErrorInvalidValue;
  err = a.resident ? launch_bwd_mma<128, true>(a, groups) : launch_bwd_mma<128, false>(a, groups);
  if (err != cudaSuccess) return err;
  const size_t n4 = n / 4;  // D is a multiple of 8
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  wide_dq_convert_kernel<<<blocks, 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(a.dq_acc), static_cast<__nv_bfloat162*>(a.dq), n4);
  return cudaGetLastError();
}

bool attn_args_ok(const AttnArgs& a) {
  return a.B > 0 && a.H > 0 && a.nq > 0 && a.nk > 0 && a.D > 0 && a.mode >= 0 && a.mode <= 2 &&
         (a.mode != kModeMask || (a.mask != nullptr && a.layout != nullptr)) &&
         (long long)a.B * a.H <= 65535 && (a.D + kCols - 1) / kCols <= 65535 &&
         (a.nq + kT - 1) / kT <= 65535 && (a.nk + kT - 1) / kT <= 65535;
}

// the bf16 arm's extra conditions: D a multiple of 8, an instance's
// column count, every group holding columns below D
bool mma_args_ok(const AttnArgs& a) {
  return a.D % 8 == 0 && a.cols > 0 && a.cols % 64 == 0 && a.smem > 0 &&
         (long long)mma_groups(a) * a.B * a.H <= 2147483647LL;
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

// Floats of the split-K workspace wide_split_launch needs at (B, H, S, D).
extern "C" long long wide_split_workspace_floats(int B, int H, int S, int D) {
  return (long long)B * H * ((S + kSplitSpan - 1) / kSplitSpan) * kSplitRows * (D + 2);
}

// The decode step at n <= 4 query rows and 256 < D <= 1024 on the split-K
// kernel: arguments as wide_decode_launch, plus `workspace` of
// wide_split_workspace_floats() floats and `counters`, B*H int32 that are
// zero before the first call and that every call leaves zero (shared with
// flash_decode.cu's split-K calls: calls must not run concurrently).
extern "C" int wide_split_launch(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale, const void* lengths,
                                 const void* bitmap, const void* page_table, void* out, int B,
                                 int H, int n, int S, int D, int n_blocks, int block_k,
                                 int page_size, int n_pool, int dtype, int quantized,
                                 float sm_scale, void* stream, void* workspace, void* counters) {
  if (B <= 0 || H <= 0 || n <= 0 || n > kSplitRows || S <= 0 || D <= 0 || D > kSplitMaxD)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 2147483647LL || (S + kSplitSpan - 1) / kSplitSpan > 65535 ||
      workspace == nullptr || counters == nullptr)
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
    return (int)(quantized ? launch_split<float, int8_t>(a, workspace, counters)
                           : launch_split<float, float>(a, workspace, counters));
  if (dtype == 1)
    return (int)(quantized ? launch_split<__nv_bfloat16, int8_t>(a, workspace, counters)
                           : launch_split<__nv_bfloat16, __nv_bfloat16>(a, workspace, counters));
  return (int)cudaErrorInvalidValue;
}

// The flash-attention forward at any D: q [B,H,nq,D], k/v [B,H,nk,D] of
// `dtype`; mask [nq, nk] bool and layout [ceil(nq/64), ceil(nk/64)] int32
// for mode 2 (else null); o [B,H,nq,D] of `dtype`, lse [B,H,nq] float32.
// bfloat16 (D a multiple of 8) runs `wide_fwd_mma_kernel<cols, resident>`
// (cols = 192 or 256 output columns a block) with `smem` dynamic shared
// bytes a block; float32 ignores `cols`, `resident` and `smem`.
extern "C" int wide_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                  const void* layout, void* o, void* lse, int B, int H, int nq,
                                  int nk, int D, int dtype, int mode, int cols, int resident,
                                  int smem, float scale, void* stream) {
  AttnArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse_out = lse;
  a.mask = static_cast<const unsigned char*>(mask);
  a.layout = static_cast<const int*>(layout);
  a.B = B; a.H = H; a.nq = nq; a.nk = nk; a.D = D; a.mode = mode; a.cols = cols; a.scale = scale;
  a.resident = resident != 0; a.smem = smem;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!attn_args_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)attention_fwd_fp32(a);
  if (dtype == 1) return mma_args_ok(a) ? (int)attention_fwd_bf16(a) : (int)cudaErrorInvalidValue;
  return (int)cudaErrorInvalidValue;
}

// The backward at any D: dq, dk and dv of `dtype` from q, k, v, dout of
// `dtype` and the forward's lse and delta = rowsum(dout * o), float32
// [B,H,nq]. bfloat16 (D a multiple of 8): `dq_acc`, a float32 [B,H,nq,D]
// workspace, is zeroed, `wide_bwd_mma_kernel<cols, resident>` (cols = 128,
// `smem` dynamic shared bytes a block) adds dq into it and a last kernel
// converts it into dq. float32: two launches (dq, then dk/dv), no
// workspace.
extern "C" int wide_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* mask,
                                  const void* layout, void* dq, void* dk, void* dv, void* dq_acc,
                                  int B, int H, int nq, int nk, int D, int dtype, int mode,
                                  int cols, int resident, int smem, float scale, void* stream) {
  AttnArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.mask = static_cast<const unsigned char*>(mask);
  a.layout = static_cast<const int*>(layout);
  a.dq = dq; a.dk = dk; a.dv = dv; a.dq_acc = static_cast<float*>(dq_acc);
  a.B = B; a.H = H; a.nq = nq; a.nk = nk; a.D = D; a.mode = mode; a.cols = cols; a.scale = scale;
  a.resident = resident != 0; a.smem = smem;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!attn_args_ok(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)attention_bwd_fp32(a);
  if (dtype == 1 && a.dq_acc != nullptr && mma_args_ok(a)) return (int)attention_bwd_bf16(a);
  return (int)cudaErrorInvalidValue;
}
