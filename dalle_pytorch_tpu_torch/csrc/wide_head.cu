// Attention kernels for head dims above 256 (sm_90a): the flash-decode
// family and the flash-attention forward and backward at any D, beside the
// tuned kernels of flash_decode.cu and flash_attention.cu, which stop at 256
// (their register and shared-memory budgets are sized for D <= 256).
//
// Replace, at D > 256, the TPU kernels of the JAX package:
//   * `dalle_pytorch_tpu/ops/pallas_decode.py`: `_decode_kernel` (plain and
//     int8 arms), `_sparse_decode_kernel`, `_paged_decode_kernel` and
//     `_sparse_paged_decode_kernel` -- two decode kernels here (the
//     split-K step and the fp32 multi-row kernel), each with runtime flags
//     for the block bitmap and the page table (null pointers when off) and
//     the int8 cache as a template type (bf16 q at n > 4 runs the
//     tensor-core tile kernel of wide_decode_tile.cu);
//   * `dalle_pytorch_tpu/ops/pallas_attention.py`: `_fwd_kernel` (forward),
//     `_dq_kernel` and `_dkv_kernel` (backward), in their all / causal /
//     static-mask arms.
// The functions are those of flash_decode.cu and flash_attention.cu (see
// their headers); D is a runtime argument with no upper limit.
//
// Decode at the step (n <= 4 query rows, any D) runs `wide_split_kernel`:
// split-K over spans of 128 key positions, bound by the bytes of live K/V
// it reads (2 B H len D elt), which it reads once up to D = 4096:
//   * one block per (batch row x head, span, column group); span
//     boundaries depend on key positions only, so every variant sums in the
//     same order; blocks past a row's last visible key exit at once; each
//     span writes (m, l, acc[D]) in fp32 to a workspace, and the last block
//     of a (b, h, group) to arrive merges the spans in span order (a
//     self-resetting arrival counter: one launch, no memset, no host sync),
//     as flash_decode.cu;
//   * a block owns every output column up to D = 4096 (no column groups),
//     so K is read once, not once per group: its 4 x D accumulators are
//     spread over the block's 128 threads, 4 columns a chunk, 2 chunks a
//     thread up to D = 1024 and 8 above; above 4096, groups of 4096
//     columns, each forming the whole scores from K in 4096-channel pieces
//     (a third instance, `PIECES`, so the others carry no branch for it);
//   * K and V arrive by cp.async (16-byte chunks where D * elt allows) in
//     tiles of up to 16 keys, sized so a stage's K and V rows stay within
//     32 KB (16 keys at D = 320 and 512 in bf16, 8 at 1024, 4 at 1032, 1 at
//     4096 in fp32), in a ring of 3 stages; rows stay in their storage type
//     and widen in registers with vector shared loads; keys no row may see
//     (and, in pieces, the channels past a piece) are zero-filled by the
//     copy itself, and a dead page's table entry is never followed;
//   * scores: 128 / keys lanes a key (8 channels a lane at a time, a
//     butterfly sum, across warps through shared memory above 32 lanes), so
//     every lane computes at any width; one warp per query row runs the
//     online softmax of the tile (a lane per key, expf); then every thread
//     adds P V for its own columns. One code path for every variant: the
//     bitmap and page table only choose which keys are read and where from,
//     so an all-ones bitmap and the paged layout run the same sums in the
//     same order as the plain contiguous cache (bit-identical outputs).
// bf16 q at n > 4 rows runs wide_decode_tile.cu's tensor-core tile kernel,
// fp32 q at n > 4 `wide_decode_fma_kernel` (below, with the fp32 forward).
//
// Design of the rest: column groups. A block owns at most `cols` (bf16
// attention, 128-256, and the fp32 forward, multi-row decode and backward,
// 192-320: the wrapper's plan) output columns. It forms the full scores
// (and, backward, the full dO . V^T) by looping over all of D in staged
// chunks of channels, and accumulates only its own columns of o, dq, dk
// or dv. Registers and shared memory are then bounded for every D, at the
// cost of recomputing the scores once per column group (ceil(D / 256)
// groups in the bf16 forward, ceil(D / 128) in the bf16 backward and
// ceil(D / 320) in fp32).
//
// bfloat16 attention runs on tensor cores (the second half of this file):
// mma.sync with fp32 accumulators, 64-row tiles, operands staged as 64 x 64
// tiles through a cp.async ring. The rest on CUDA cores in fp32:
//   * fp32 attention forward and fp32 decode at n > 4
//     (`wide_fwd_fma_kernel`, `wide_decode_fma_kernel`): a block per (64
//     query rows, head and batch row, group of up to 320 columns) over the
//     live 64-key tiles, S formed once per group as 4 x 4 register
//     micro-tiles on all eight warps from a cp.async ring, then the online
//     softmax and O += P V (see the section);
//   * fp32 attention backward (`wide_dq_fma_kernel`, `wide_dkv_fma_kernel`):
//     two passes, dq by 64-row query tile and dk/dv by 32-key tile, each
//     forming S and dP once per column group of up to 320 columns with
//     register micro-tiles read as float4 from a cp.async ring, then p =
//     exp(s scale - lse) and dS = p (dP - delta) scale (see the section).
//     No atomics: every output is bit-identical run to run.
// What bounds it: the same work as the D <= 256 kernels (bytes at the
// decode step, operations in the multi-row decode and attention), here
// times the column groups' recomputation in all but the split-K step up to
// D = 4096; the fp32 kernels run on CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;  // a masked attention score (finite, as the reference's)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ------------------------------------------------------------------ decode

struct DecodeArgs {
  const void *q, *k, *v, *k_scale, *v_scale, *lengths, *bitmap, *page_table;
  void* out;
  int B, H, n, S, D, n_blocks, block_k, page_size, n_pool;
  float sm_scale;
  cudaStream_t stream;
};

// The step (n <= kSplitRows query rows) at D > 256: split-K over spans of
// kSplitSpan key positions, as flash_decode.cu does at D <= 256,
// redesigned for wide rows. One block per (batch row x head, span, column
// group); blocks past a row's last visible key exit at once. A block owns
// CHUNKS x 4 columns a thread (`split_chunks`: 2 up to 1024 channels, 8
// above, so 512 or 4096 columns a block); up to 4096 channels that is every
// output column, so each live K/V byte is read once; above, column groups
// of 4096 (`split_groups`), each forming the whole scores (the only place
// the scores are recomputed).
constexpr int kSplitThreads = 128;
constexpr int kSplitRows = 4;          // query rows a block holds (ops/flash_decode.py DECODE_ROWS)
constexpr int kSplitSpan = 128;        // key positions a block (ops/flash_decode.py DECODE_SPAN)
constexpr int kSplitStages = 3;        // cp.async ring depth
constexpr int kSplitStageBytes = 32768;  // K + V bytes of one tile, at most
constexpr int kSplitKeys = 16;         // keys a tile, at most (each scored by 128 / keys lanes)
constexpr int kSplitWideChunks = 8;    // the chunks above 1024 channels
constexpr int kSplitTableCache = kSplitSpan + 1;  // a span's page-table entries (pages >= 1 position)

// chunks of 4 columns a thread: 2 up to 1024 channels, else kSplitWideChunks
__host__ __device__ inline int split_chunks(int D) { return D <= 1024 ? 2 : kSplitWideChunks; }
__host__ __device__ inline int split_group_cols(int D) { return split_chunks(D) * 4 * kSplitThreads; }
// column groups a (row, head, span): one up to 4096 channels
__host__ __device__ inline int split_groups(int D) { return (D + split_group_cols(D) - 1) / split_group_cols(D); }
// channels of a staged K or V piece: all of D in one group, a group's above
__host__ __device__ inline int split_piece(int D) { return split_groups(D) == 1 ? D : split_group_cols(D); }
// bytes of a staged K or V row of `W` channels: W rounded up to 8 channels
// (the score's 8-channel loads), then to 16 bytes (cp.async chunks); the
// tail is zero
__host__ __device__ inline int split_row_stride(int W, int elt) {
  return ((W + 7) / 8 * 8 * elt + 15) / 16 * 16;
}
// keys a tile: the largest power of two up to kSplitKeys whose K and V
// rows fit kSplitStageBytes (16 at D = 320 and 512 in bf16, 8 at 1024, 4
// at 1032, 1 at 4096 in fp32)
__host__ __device__ inline int split_tile_keys(int W, int elt) {
  int keys = kSplitKeys;
  while (keys > 1 && 2 * keys * split_row_stride(W, elt) > kSplitStageBytes) keys /= 2;
  return keys;
}
__host__ __device__ inline int split_stage_bytes(int W, int elt) {
  const int keys = split_tile_keys(W, elt);
  return 2 * keys * split_row_stride(W, elt) + (elt == 1 ? 2 * keys * 4 : 0);
}
// dynamic shared bytes: the ring, then q [rows][piece rounded to 8] fp32
__host__ __device__ inline int split_smem_bytes(int D, int elt, int rows) {
  const int W = split_piece(D);
  return kSplitStages * split_stage_bytes(W, elt) + rows * ((W + 7) / 8 * 8) * 4;
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

template <int N>
struct Lanes {
  static constexpr int value = N;
};

// dot[r] += q_s[r] . this lane's 8-channel octets of its key's staged row
// (L lanes a key, octet sub, sub + L, ... below n8): q and K widened to fp32
template <typename KV, int ROWS, int L>
__device__ __forceinline__ void split_dots(float (&dot)[ROWS], const unsigned char* krow,
                                           const float* q_s, int dq, int sub, int n8) {
  constexpr int ELT = (int)sizeof(KV);
  for (int c8 = sub; c8 < n8; c8 += L) {
    float kv[8];
    split_load<KV, 8>(kv, krow + c8 * 8 * ELT);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + r * dq + c8 * 8);
      const float4 qb = *reinterpret_cast<const float4*>(q_s + r * dq + c8 * 8 + 4);
      float y = dot[r];
      y = fmaf(qa.x, kv[0], y); y = fmaf(qa.y, kv[1], y);
      y = fmaf(qa.z, kv[2], y); y = fmaf(qa.w, kv[3], y);
      y = fmaf(qb.x, kv[4], y); y = fmaf(qb.y, kv[5], y);
      y = fmaf(qb.z, kv[6], y); y = fmaf(qb.w, kv[7], y);
      dot[r] = y;
    }
  }
}

// a key's L lanes summed: a butterfly within the warp, then slot
// threadIdx / min(L, 32) of part_s holds a lane group's or a warp's sum
template <int ROWS, int L>
__device__ __forceinline__ void split_sum(float (&dot)[ROWS], float (&part_s)[kSplitRows][kSplitKeys],
                                          int lane) {
  constexpr int LW = L < 32 ? L : 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int o = LW / 2; o > 0; o >>= 1) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
  if (lane % LW == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) part_s[r][threadIdx.x / LW] = dot[r];
  }
}

// out[b,h,i,:] = softmax_j(q[b,h,i] . k[b,h,j] * scale) @ v[b,h,j] over
// j <= lengths[b] - n + i (lengths clipped to [0, S]) and, with a bitmap,
// bitmap[b, j / block_k] != 0; with a page table key j of row b is at pool
// page page_table[b, j / page_size], offset j % page_size. ROWS = 1 at the
// step n = 1, else kSplitRows; PIECES: more than one column group (D >
// 4096). Grid (B * H, spans, split_groups(D)).
// Per key tile of up to kSplitKeys keys: scores by 128 / keys lanes a key
// (8 channels a lane at a time, summed by a butterfly and, above 32 lanes a
// key, across warps through shared memory), so every lane scores whatever
// the tile's width; the online softmax of each row by one warp (a lane per
// key); then P V by every thread over its own output columns of the
// block's group. One softmax state per row, in shared memory. The ring's
// items: one a key tile (its K and V rows, all of D) in one group; with
// column groups, a tile's K in split_groups(D) pieces of 4096 channels
// (the scores summed over them, q's piece restaged for each), then the V
// columns of the block's group. Each span writes (m, l, acc[D]) to the
// workspace unless it is its row's only live span; the last span block of
// a (b, h, group) to arrive merges the spans in span order.
template <typename T, typename KV, int ROWS, int CHUNKS, bool PIECES>
__global__ void __launch_bounds__(kSplitThreads, 1)
wide_split_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                  const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                  const int* __restrict__ lengths, const int* __restrict__ bitmap,
                  const int* __restrict__ page_table, T* __restrict__ out, float* __restrict__ ws,
                  int* __restrict__ counters, int H, int n, int S, int D, int n_blocks,
                  int block_k, int page_size, int n_pool, float sm_scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int ELT = (int)sizeof(KV);
  constexpr int GC = CHUNKS * 4 * kSplitThreads;  // columns a block owns, at most
  extern __shared__ __align__(16) unsigned char split_smem[];  // the file's other kernels' smem is float
  unsigned char* smem = split_smem;
  __shared__ float part_s[kSplitRows][kSplitKeys];  // scores: a key's partial sums (a slot a lane group)
  __shared__ float p_s[kSplitRows][kSplitKeys];     // p of a tile's keys (int8: times v_scale)
  __shared__ float m_s[kSplitRows], l_s[kSplitRows], corr_s[kSplitRows];
  __shared__ int table_s[kSplitTableCache];
  __shared__ int last_block;

  const int bh = blockIdx.x, split = blockIdx.y, n_spans = gridDim.y;
  const int G = PIECES ? gridDim.z : 1, group = PIECES ? blockIdx.z : 0;
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

  // a staged row holds W channels: all of D (one group) or a 4096-channel piece
  const int W = PIECES ? GC : D;
  const int col0 = group * GC, GW = min(D - col0, GC);  // this block's output columns
  const int n_items = PIECES ? G + 1 : 1;  // a key tile's items: K pieces, then V
  const int LDB = split_row_stride(W, ELT), BN = split_tile_keys(W, ELT);
  const int STAGE = split_stage_bytes(W, ELT);
  const int DQ = (W + 7) / 8 * 8;
  const int L = kSplitThreads / BN;  // lanes a key
  float* q_s = reinterpret_cast<float*>(smem + kSplitStages * STAGE);  // [ROWS][DQ], times the scale
  // q's channels [c0, c0 + w) into q_s (zero past them)
  auto stage_q = [&](int c0, int w) {
    for (int i = threadIdx.x; i < ROWS * DQ; i += kSplitThreads) {
      const int r = i / DQ, c = i - r * DQ;
      q_s[i] = r < nrows && c < w ? to_float(q[(bhs * n + r) * D + c0 + c]) * sm_scale : 0.f;
    }
  };
  if (!PIECES) {
    stage_q(0, D);
    if (D * ELT < LDB) {  // the row tails stay zero (the copies never write them)
      for (int i = threadIdx.x; i < kSplitStages * STAGE / 16; i += kSplitThreads)
        reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    }
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
  // copies: each staged row in chunks of `unit` bytes (16 where D's rows
  // allow, else 8 or 4, else one element), the keys no row sees zero-filled
  // by the copy itself; in one group a row's D * elt bytes (its tail zeroed
  // once, above), with pieces a row's LDB bytes, the channels past the
  // piece zero-filled by the copy too
  const int row_bytes = D * ELT;
  const int unit = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : ELT;
  const int cpr = (PIECES ? LDB : row_bytes) / unit;
  const char* kbytes = reinterpret_cast<const char*>(k);
  const char* vbytes = reinterpret_cast<const char*>(v);
  struct Item {
    int t, p;  // a key tile, and its item: K piece p < G (all of K and V at G = 1), or V (p = G)
  };
  // item x's rows: K's channels [kc0, kc0 + kw) (all of D at G = 1, piece
  // p above) and V's of the block's group, each where the item brings it
  auto fetch = [&](Item x, int st) {
    unsigned char* ks = smem + st * STAGE;
    unsigned char* vs = ks + BN * LDB;
    const bool kpart = !PIECES || x.p < G, vpart = !PIECES || x.p == G;
    if constexpr (!PIECES) {
      for (int i = threadIdx.x; i < BN * cpr; i += kSplitThreads) {
        const int j = i / cpr, c = i - j * cpr;
        const long long row = src_row(x.t * BN + j);
        const size_t off = (row < 0 ? 0 : row * row_bytes) + c * unit;
        split_copy(ks + j * LDB + c * unit, kbytes + off, row >= 0, unit);
        split_copy(vs + j * LDB + c * unit, vbytes + off, row >= 0, unit);
      }
    } else {
      const int kc0 = x.p * W, kwb = min(W, D - kc0) * ELT, vwb = GW * ELT;
      for (int i = threadIdx.x; i < BN * cpr; i += kSplitThreads) {
        const int j = i / cpr, c = i - j * cpr;
        const long long row = src_row(x.t * BN + j);
        const long long off = row * row_bytes + c * unit;
        if (kpart) {
          const bool ok = row >= 0 && c * unit < kwb;
          split_copy(ks + j * LDB + c * unit, kbytes + (ok ? off + (long long)kc0 * ELT : 0), ok, unit);
        }
        if (vpart) {
          const bool ok = row >= 0 && c * unit < vwb;
          split_copy(vs + j * LDB + c * unit, vbytes + (ok ? off + (long long)col0 * ELT : 0), ok, unit);
        }
      }
    }
    if (QUANT && kpart) {
      float* sc = reinterpret_cast<float*>(vs + BN * LDB);
      for (int j = threadIdx.x; j < BN; j += kSplitThreads) {
        const long long row = src_row(x.t * BN + j);
        split_copy(sc + j, k_scale + (row < 0 ? 0 : row), row >= 0, 4);
        split_copy(sc + BN + j, v_scale + (row < 0 ? 0 : row), row >= 0, 4);
      }
    }
  };

  float acc[ROWS][CHUNKS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][u][e] = 0.f;
  const int key = threadIdx.x / L, sub = threadIdx.x % L;  // this lane's key of a tile, its channel octets
  const int n4 = (GW + 7) / 8 * 2;  // 4-column chunks of the block's group
  float dot[ROWS];

  // item x, landed in stage st, into the scores, the rows' softmax states and acc
  auto compute = [&](Item x, int st) {
    const unsigned char* kt = smem + st * STAGE;
    const unsigned char* vt = kt + BN * LDB;
    const float* sc = reinterpret_cast<const float*>(vt + BN * LDB);
    const bool kpart = !PIECES || x.p < G, vpart = !PIECES || x.p == G;
    if (kpart) {
      const int kw = PIECES ? min(W, D - x.p * W) : D;
      if (PIECES) {  // q's piece (the previous item's reads of q_s are done: the ring's barrier)
        stage_q(x.p * W, kw);
        __syncthreads();
      }
      if (x.p == 0) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) dot[r] = 0.f;
      }
      // scores: this lane's octets of its key (the stride, L, a constant in
      // each case), then the key's lanes summed once its last piece is in
      const unsigned char* krow = kt + key * LDB;
      const int n8 = (kw + 7) / 8;
      const bool last = !PIECES || x.p == G - 1;
      auto score = [&](auto lanes) {
        constexpr int LK = decltype(lanes)::value;
        split_dots<KV, ROWS, LK>(dot, krow, q_s, DQ, sub, n8);
        if (last) split_sum<ROWS, LK>(dot, part_s, lane);
      };
      switch (L) {  // block-uniform
        case 8: score(Lanes<8>{}); break;
        case 16: score(Lanes<16>{}); break;
        case 32: score(Lanes<32>{}); break;
        case 64: score(Lanes<64>{}); break;
        default: score(Lanes<128>{});
      }
      if (!last) return;  // the scores go on in the next piece
      __syncthreads();
      // the online softmax, a warp per query row and a lane per key (its
      // L / 32 slots summed in order above 32 lanes a key)
      if (warp < nrows) {
        const int r = warp, parts = L > 32 ? L / 32 : 1;
        const int pos = x.t * BN + lane;
        float s = -INFINITY;
        if (lane < BN) {
          s = part_s[r][lane * parts];
          for (int i = 1; i < parts; ++i) s += part_s[r][lane * parts + i];
          const bool vis = pos < key1 && (live_b == nullptr || live_b[pos / block_k] != 0) &&
                           pos <= len - n + r;
          s = vis ? (QUANT ? s * sc[lane] : s) : -INFINITY;
        }
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
      if (!vpart) return;  // V arrives in the next item
    }
    // P V over this thread's columns of the group (chunks of 4): keys no
    // row sees are zeros in the ring, and their p is 0
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float corr = r < nrows ? corr_s[r] : 1.f;
#pragma unroll
      for (int u = 0; u < CHUNKS; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][u][e] *= corr;
    }
    for (int j = 0; j < BN; ++j) {
#pragma unroll
      for (int u = 0; u < CHUNKS; ++u) {
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

  // the ring: kSplitStages - 1 items in flight ahead of the one computing
  auto advance = [&](Item x) { return ++x.p < n_items ? x : Item{next_tile(x.t + 1), 0}; };
  Item fetch_x{next_tile(t_begin), 0}, comp_x = fetch_x;
#pragma unroll
  for (int st = 0; st < kSplitStages - 1; ++st) {
    if (fetch_x.t < t_end) {
      fetch(fetch_x, st);
      fetch_x = advance(fetch_x);
    }
    split_commit();
  }
  for (int it = 0; comp_x.t < t_end; ++it) {
    split_wait();     // this thread's copies of item `it` landed
    __syncthreads();  // everyone's; and stage it - 1, p_s and q_s are consumed
    if (fetch_x.t < t_end) {
      fetch(fetch_x, (it + kSplitStages - 1) % kSplitStages);
      fetch_x = advance(fetch_x);
    }
    split_commit();
    compute(comp_x, it % kSplitStages);
    comp_x = advance(comp_x);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // m_s and l_s are final

  const bool direct = n_live == 1;  // this block writes the output itself
  float* ws_acc = ws;  // [B*H][spans][rows][D]
  float* ws_ml = ws + (size_t)gridDim.x * n_spans * kSplitRows * D;  // [B*H][groups][spans][rows][2]
  const size_t ml0 = (bhs * G + group) * n_spans * kSplitRows;  // (span sp, row r) at ml0 + sp * rows + r
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nrows) break;
    const float l = l_s[r];
    const size_t part = (bhs * n_spans + split) * kSplitRows + r;
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const int ch = threadIdx.x + u * kSplitThreads;
      if (ch >= n4) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = ch * 4 + e;
        if (c >= GW) break;
        if (direct)
          store(out + (bhs * n + r) * D + col0 + c, l > 0.f ? acc[r][u][e] / l : 0.f);
        else
          ws_acc[part * D + col0 + c] = acc[r][u][e];
      }
    }
    if (!direct && threadIdx.x == 0) {
      ws_ml[(ml0 + split * kSplitRows + r) * 2] = m_s[r];
      ws_ml[(ml0 + split * kSplitRows + r) * 2 + 1] = l;
    }
  }
  if (direct) return;

  // the last span block of this (b, h, group) to arrive merges the spans in
  // span order, each thread its elements, as flash_decode.cu does: per
  // chunk of 8 spans it loads every (m, l, acc) at once, rescales its
  // running sums to the chunk's new maximum, then adds the spans' terms
  // e^(m - M) in order (a span with no visible key has m = -inf, l = acc =
  // 0: no term)
  __threadfence();
  __syncthreads();
  int* counter = counters + bhs * G + group;
  if (threadIdx.x == 0) {
    last_block = atomicAdd(counter, 1) == n_live - 1;
    if (last_block) atomicExch(counter, 0);  // ready for the next call
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  constexpr int kChunk = 8;
  const size_t part0 = bhs * n_spans * kSplitRows;  // (span sp, row r) at part0 + sp * rows + r
  for (int i = threadIdx.x; i < nrows * GW; i += kSplitThreads) {
    const int r = i / GW, c = col0 + i - r * GW;
    float mx = -INFINITY, sum_l = 0.f, sum_a = 0.f;
    for (int sp0 = 0; sp0 < n_live; sp0 += kChunk) {
      float ms[kChunk], ls[kChunk], as[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const size_t part = part0 + (size_t)(sp0 + u) * kSplitRows + r;
        const size_t ml = ml0 + (size_t)(sp0 + u) * kSplitRows + r;
        const bool in = sp0 + u < n_live;
        ms[u] = in ? __ldcg(ws_ml + ml * 2) : -INFINITY;
        ls[u] = in ? __ldcg(ws_ml + ml * 2 + 1) : 0.f;
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

template <typename T, typename KV, int CHUNKS, bool PIECES>
cudaError_t launch_split_chunks(const DecodeArgs& a, void* ws, void* counters) {
  auto kernel = a.n == 1 ? wide_split_kernel<T, KV, 1, CHUNKS, PIECES>
                         : wide_split_kernel<T, KV, kSplitRows, CHUNKS, PIECES>;
  const int smem = split_smem_bytes(a.D, (int)sizeof(KV), a.n == 1 ? 1 : kSplitRows);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kSplitSpan - 1) / kSplitSpan, split_groups(a.D));
  kernel<<<grid, kSplitThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.bitmap),
      static_cast<const int*>(a.page_table), static_cast<T*>(a.out), static_cast<float*>(ws),
      static_cast<int*>(counters), a.H, a.n, a.S, a.D, a.n_blocks, a.block_k, a.page_size,
      a.n_pool, a.sm_scale);
  return cudaGetLastError();
}

// the instance of D: 2 chunks up to 1024 channels, 8 above, in pieces
// above 4096 (three instances a type pair and row count)
template <typename T, typename KV>
cudaError_t launch_split(const DecodeArgs& a, void* ws, void* counters) {
  if (split_chunks(a.D) == 2) return launch_split_chunks<T, KV, 2, false>(a, ws, counters);
  return split_groups(a.D) == 1 ? launch_split_chunks<T, KV, kSplitWideChunks, false>(a, ws, counters)
                                : launch_split_chunks<T, KV, kSplitWideChunks, true>(a, ws, counters);
}

// --------------------------------------------------------------- attention

enum { kModeAll = 0, kModeCausal = 1, kModeMask = 2 };

struct AttnArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  const unsigned char* mask;
  const int* layout;
  void *o, *lse_out, *dq, *dk, *dv;
  float* dq_acc;  // bf16 backward: the fp32 dq workspace [B,H,nq,D]
  int B, H, nq, nk, D, mode;
  int cols;      // output columns a block owns (an instance)
  bool resident;  // bf16: the block keeps its most re-read operand in shared memory
  int smem;       // dynamic shared bytes a block takes (the wrapper's plan)
  int unit;       // fp32: bytes of a copy piece (set by attention_fwd_fp32 / attention_bwd_fp32)
  float scale;
  cudaStream_t stream;
};

__device__ __forceinline__ bool visible(const AttnArgs& a, int i, int j) {
  if (i >= a.nq || j >= a.nk) return false;
  if (a.mode == kModeCausal) return j <= i;
  if (a.mode == kModeMask) return a.mask[(size_t)i * a.nk + j] != 0;
  return true;
}

// ------------------------------------------- float32 backward, CUDA cores
//
// Two passes, as the TPU kernels `_dq_kernel` and `_dkv_kernel`, each
// forming S = Q K^T and dP = dO V^T over all of D once per column group
// (one group up to D = 320, two at D = 512: `ops/wide_head.py:
// wide_fp32_plan`), with fp32 products on CUDA cores:
//   * `wide_dq_fma_kernel<COLS>`: a block per (64 query rows, head and
//     batch row, group of COLS output columns) loops over the live 64-key
//     tiles (a causal block stops at the diagonal, a masked layout's dead
//     tiles are skipped block-uniformly). Per key tile: warps 0-3 form S
//     and warps 4-7 dP, a 4 x 8 micro-tile a thread; p = exp(s scale -
//     lse) and dS = p (dP - delta) scale into shared memory; then every
//     thread adds dS K into dQ for the group's columns, 4 rows x COLS / 16
//     columns a thread in registers (80 at COLS 320);
//   * `wide_dkv_fma_kernel<COLS>`: a block per (32 keys, head and batch
//     row, group) loops over the query tiles that may see its keys. Per
//     query tile: warps 0-3 form S^T and warps 4-7 dP^T (4 keys x 4
//     queries a thread); P and dS into shared memory; then warps 0-3 add
//     P^T dO into dV and warps 4-7 dS^T Q into dK for the group's columns,
//     4 keys x COLS / 16 columns a thread.
// What holds these loops is shared memory, not the FMA units: a warp's
// float4 load takes four of its cycles even where lanes share addresses,
// so a micro-tile of R x C reading float4 along the sum does 4 R C / (R +
// C) FMAs a load. Splitting S from dP (and dV from dK) over the warps
// gives each thread one product's tile at the registers two took: 8 FMAs
// a load for S^T and dP^T (2 x 4 of both products gave 5.3) and 10.7 for
// S and dP (8); a column item's float4 of P or dS serves 16 columns of dQ
// (12.8 FMAs a load) or 8 of dK and dV (10.7).
// Every operand streams through a ring of kFmaStages slots by cp.async, a
// slot eight sub-tiles of 64 rows x 32 channels (rows padded to 36
// floats): an S/dP item brings 64 channels of each of the four operands,
// a column item up to 256 of the group's channels of K (dq) or 128 of Q
// and of dO (dk/dv). The next item is in flight while one computes, one
// __syncthreads an item. A piece past D or past the rows is zero-filled
// by the copy itself (16-byte pieces where D and the pointers allow, else
// 8 or 4), so ragged edges need no branch in the products and any D runs
// in the same launch. Reads are conflict-free: a warp spans 4 rows of one
// operand (stride 36 or 72 floats) and 8 of the other.
// No atomics: dq, dk and dv are each written once, by one thread, and
// come out bit-identical run to run.
// What bounds them: operations, 10 D flops a visible pair at the card's
// fp32 rate (2.5 ms at D = 320 for the training shapes); they do 14 D
// (one group) and 4 D more for each further group, and re-read Q, dO, K
// and V from L2 for every 64 x 64 tile pair (about 400 KB at D = 320).
// Summation order is the only difference from the plain version
// (flash_attention_bwd_plain).

constexpr int kFmaChunk = 32;                // channels of a staged sub-tile
constexpr int kFmaLd = kFmaChunk + 4;        // its row stride in floats
constexpr int kFmaSub = 64 * kFmaLd;         // floats of a sub-tile (64 rows)
constexpr int kFmaSlot = 8 * kFmaSub;        // floats of a ring slot: eight sub-tiles
constexpr int kFmaStages = 2;
constexpr int kFmaLdp = 64 + 8;              // row stride of the P and dS tiles
constexpr int kFmaKeys = 32;                 // keys of a dk/dv block
// dynamic shared bytes of either pass (ops/wide_head.py FMA_SMEM): the ring,
// then dS and P [64 rows each] (dq) or P and dS [32 keys each] (dk/dv)
constexpr int kFmaSmem = 4 * (kFmaStages * kFmaSlot + 2 * 64 * kFmaLdp);

__device__ __forceinline__ void cp_async_piece(float* dst, const float* src, bool ok, int unit) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (unit == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
  } else if (unit == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 8 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
  }
}
__device__ __forceinline__ void fma_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void fma_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// rows [r0, r0 + R) x channels [c0, c0 + kFmaChunk) of x [rows, D] into a
// sub-tile slot, in pieces of `unit` bytes, zeros past `rows` and D
template <int R>
__device__ __forceinline__ void fetch_sub(float* dst, const float* x, int r0, int rows, int c0, int D,
                                          int unit) {
  if (unit == 16) {  // block-uniform: 8 pieces a row, R * 8 / kThreads a thread
#pragma unroll
    for (int k = 0; k < R * 8 / kThreads; ++k) {
      const int e = threadIdx.x + k * kThreads, r = e >> 3, c = (e & 7) << 2;
      const bool ok = r0 + r < rows && c0 + c < D;
      cp_async_piece(dst + r * kFmaLd + c, ok ? x + (size_t)(r0 + r) * D + c0 + c : x, ok, 16);
    }
    return;
  }
  const int fl = unit / 4, per_row = kFmaChunk / fl;
  for (int e = threadIdx.x; e < R * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * fl;
    const bool ok = r0 + r < rows && c0 + c < D;
    cp_async_piece(dst + r * kFmaLd + c, ok ? x + (size_t)(r0 + r) * D + c0 + c : x, ok, unit);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float x) {
  x = fmaf(a.x, b.x, x);
  x = fmaf(a.y, b.y, x);
  x = fmaf(a.z, b.z, x);
  return fmaf(a.w, b.w, x);
}
__device__ __forceinline__ float comp4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
// acc[0..3] += w * x
__device__ __forceinline__ void axpy4(float* acc, float w, const float4& x) {
  acc[0] = fmaf(w, x.x, acc[0]);
  acc[1] = fmaf(w, x.y, acc[1]);
  acc[2] = fmaf(w, x.z, acc[2]);
  acc[3] = fmaf(w, x.w, acc[3]);
}

// The ring: items 0, 1, ... of a block, each filling one slot of SLOT
// floats, `fetch(item, slot)` issuing its copies and `compute(item, slot)`
// consuming it; an item is an (outer tile, step) pair that `next`
// advances, `done` ends.
template <int SLOT = kFmaSlot, typename Item, typename Next, typename Done, typename Fetch,
          typename Compute>
__device__ __forceinline__ void run_ring(float* ring, Item first, Next next, Done done, Fetch fetch,
                                         Compute compute) {
  Item f = first, c = first;
#pragma unroll 1
  for (int st = 0; st < kFmaStages - 1; ++st) {
    if (!done(f)) {
      fetch(f, ring + st * SLOT);
      f = next(f);
    }
    fma_commit();
  }
#pragma unroll 1
  for (int it = 0; !done(c); ++it) {
    fma_wait<kFmaStages - 2>();  // this thread's copies of item `it` landed
    __syncthreads();             // everyone's; and item it - 1's slot is consumed
    if (!done(f)) {
      fetch(f, ring + ((it + kFmaStages - 1) % kFmaStages) * SLOT);
      f = next(f);
    }
    fma_commit();
    compute(c, ring + (it % kFmaStages) * SLOT);
    c = next(c);
  }
  fma_wait<0>();
}

struct FmaItem {
  int tile, step;  // a key tile (dq) or query tile (dk/dv), and the item within it
};

// dq: grid (ceil(nq / 64), B * H, groups), the query tiles with the most
// keys first
template <int COLS>
__global__ void __launch_bounds__(kThreads, 1) wide_dq_fma_kernel(AttnArgs a) {
  constexpr int NG = COLS / 64, NU = (COLS + 255) / 256;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* ds_s = smem + kFmaStages * kFmaSlot;  // [64 rows][kFmaLdp]
  float* p_s = ds_s + 64 * kFmaLdp;            // [64 rows][kFmaLdp]
  // S/dP: warps 0-3 form S, 4-7 dP, a thread rows ty + 16 i x keys sx + 8 j;
  // dQ: every thread rows ty + 16 i x columns 4 tx .. 4 tx + 3 of each 64
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, role = warp / 4;
  const int ty = 4 * (warp % 4) + lane / 8, tx = 8 * (warp / 4) + lane % 8, sx = lane % 8;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * 64, bh = blockIdx.y, g0 = blockIdx.z * COLS;
  const int D = a.D, unit = a.unit;
  const size_t base_q = (size_t)bh * a.nq * D, base_k = (size_t)bh * a.nk * D;
  const float* q = static_cast<const float*>(a.q) + base_q;
  const float* dout = static_cast<const float*>(a.dout) + base_q;
  const float* k = static_cast<const float*>(a.k) + base_k;
  const float* v = static_cast<const float*>(a.v) + base_k;
  float lse[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    lse[i] = r < a.nq ? static_cast<const float*>(a.lse)[(size_t)bh * a.nq + r] : 0.f;
    delta[i] = r < a.nq ? static_cast<const float*>(a.delta)[(size_t)bh * a.nq + r] : 0.f;
  }
  const int n_kt = (a.nk + 63) / 64;
  const int kt_end = a.mode == kModeCausal ? min(n_kt, (min(row0 + 64, a.nq) - 1) / 64 + 1) : n_kt;
  const int n_s = (D + 2 * kFmaChunk - 1) / (2 * kFmaChunk);  // S/dP items a key tile
  const int n_g = (min(COLS, D - g0) + 255) / 256;           // the group's live column items
  auto live = [&](int kt) {
    if (a.mode == kModeMask)
      while (kt < kt_end && a.layout[(row0 / 64) * n_kt + kt] == 0) ++kt;
    return kt;
  };
  auto next = [&](FmaItem x) {
    return ++x.step < n_s + n_g ? x : FmaItem{live(x.tile + 1), 0};
  };
  auto done = [&](FmaItem x) { return x.tile >= kt_end; };
  // an S/dP item: 64 channels of Q, dO, K and V, two sub-tiles each; a
  // column item: up to 256 of the group's channels of K
  auto fetch = [&](FmaItem x, float* slot) {
    const int key0 = x.tile * 64;
    if (x.step < n_s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = (2 * x.step + h) * kFmaChunk;
        fetch_sub<64>(slot + h * kFmaSub, q, row0, a.nq, c0, D, unit);
        fetch_sub<64>(slot + (2 + h) * kFmaSub, dout, row0, a.nq, c0, D, unit);
        fetch_sub<64>(slot + (4 + h) * kFmaSub, k, key0, a.nk, c0, D, unit);
        fetch_sub<64>(slot + (6 + h) * kFmaSub, v, key0, a.nk, c0, D, unit);
      }
    } else {
      const int u = x.step - n_s, subs = min(8, (COLS - 256 * u) / kFmaChunk);
      for (int h = 0; h < subs; ++h)
        fetch_sub<64>(slot + h * kFmaSub, k, key0, a.nk, g0 + 256 * u + h * kFmaChunk, D, unit);
    }
  };

  float sc[4][8], acc[4][4 * NG];  // sc: S (role 0) or dP (role 1)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;

  auto compute = [&](FmaItem x, const float* slot) {
    if (x.step < n_s) {
      if (x.step == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
      }
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const float* xs = slot + (2 * role + h) * kFmaSub;      // Q or dO
        const float* ys = slot + (4 + 2 * role + h) * kFmaSub;  // K or V
#pragma unroll
        for (int c = 0; c < kFmaChunk; c += 4) {
          float4 xa[4], yb[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) xa[i] = ld4(xs + (ty + 16 * i) * kFmaLd + c);
#pragma unroll
          for (int j = 0; j < 8; ++j) yb[j] = ld4(ys + (sx + 8 * j) * kFmaLd + c);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[i][j] = dot4(xa[i], yb[j], sc[i][j]);
        }
      }
      if (x.step == n_s - 1) {  // the scores are whole: P, then dS into shared memory
        if (role == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int row = row0 + ty + 16 * i, key = x.tile * 64 + sx + 8 * j;
              p_s[(ty + 16 * i) * kFmaLdp + sx + 8 * j] =
                  visible(a, row, key) ? expf(sc[i][j] * a.scale - lse[i]) : 0.f;
            }
        }
        __syncthreads();  // block-uniform: every thread computes the same item
        if (role == 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int at = (ty + 16 * i) * kFmaLdp + sx + 8 * j;
              ds_s[at] = p_s[at] * (sc[i][j] - delta[i]) * a.scale;
            }
        }
      }
      return;
    }
    // dQ += dS K over the item's columns: this thread's 4 of each 64 (tx),
    // float4 f of the item from sub-tile 2 f + tx / 8
    const int u = x.step - n_s;
    const float* kc = slot + (tx / 8) * kFmaSub + 4 * (tx % 8);
#pragma unroll
    for (int uu = 0; uu < NU; ++uu) {
      if (uu != u) continue;
#pragma unroll 2
      for (int key = 0; key < 64; key += 4) {
        float4 w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = ld4(ds_s + (ty + 16 * i) * kFmaLdp + key);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            if (256 * uu + 64 * f >= COLS) continue;
            const float4 kv = ld4(kc + 2 * f * kFmaSub + (key + kk) * kFmaLd);
#pragma unroll
            for (int i = 0; i < 4; ++i) axpy4(&acc[i][4 * (4 * uu + f)], comp4(w[i], kk), kv);
          }
      }
    }
  };
  run_ring(ring, FmaItem{live(0), 0}, next, done, fetch, compute);

  float* dq = static_cast<float*>(a.dq) + base_q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= a.nq) continue;
#pragma unroll
    for (int m = 0; m < NG; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = g0 + 64 * m + 4 * tx + c;
        if (col < D) dq[(size_t)r * D + col] = acc[i][4 * m + c];
      }
  }
}

// dk, dv: grid (ceil(nk / kFmaKeys), B * H, groups); a block per 32 keys
// loops over the 64-row query tiles that may see them. Warps 0-3 form S^T
// and then dV, warps 4-7 dP^T and then dK, a thread keys kg + 8 i x
// queries tx + 16 j, then those keys x columns 4 tx .. 4 tx + 3 of each 64
template <int COLS>
__global__ void __launch_bounds__(kThreads, 1) wide_dkv_fma_kernel(AttnArgs a) {
  constexpr int NG = COLS / 64, NU = (COLS + 127) / 128;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* p_s = smem + kFmaStages * kFmaSlot;  // [kFmaKeys keys][kFmaLdp]
  float* ds_s = p_s + kFmaKeys * kFmaLdp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, role = warp / 4, wr = warp % 4;
  const int kg = 4 * (wr % 2) + lane / 8, tx = 8 * (wr / 2) + lane % 8;
  const int key0 = blockIdx.x * kFmaKeys, bh = blockIdx.y, g0 = blockIdx.z * COLS;
  const int D = a.D, unit = a.unit;
  const size_t base_q = (size_t)bh * a.nq * D, base_k = (size_t)bh * a.nk * D;
  const float* q = static_cast<const float*>(a.q) + base_q;
  const float* dout = static_cast<const float*>(a.dout) + base_q;
  const float* k = static_cast<const float*>(a.k) + base_k;
  const float* v = static_cast<const float*>(a.v) + base_k;
  const float* lse = static_cast<const float*>(a.lse) + (size_t)bh * a.nq;
  const float* delta = static_cast<const float*>(a.delta) + (size_t)bh * a.nq;
  const int n_qt = (a.nq + 63) / 64, n_kt64 = (a.nk + 63) / 64;
  const int n_s = (D + 2 * kFmaChunk - 1) / (2 * kFmaChunk);
  const int n_g = (min(COLS, D - g0) + 127) / 128;
  auto live = [&](int qt) {
    if (a.mode == kModeMask)
      while (qt < n_qt && a.layout[qt * n_kt64 + key0 / 64] == 0) ++qt;
    return qt;
  };
  auto next = [&](FmaItem x) {
    return ++x.step < n_s + n_g ? x : FmaItem{live(x.tile + 1), 0};
  };
  auto done = [&](FmaItem x) { return x.tile >= n_qt; };
  // an S/dP item: 64 channels of K, V, Q and dO, two sub-tiles each; a
  // column item: up to 128 of the group's channels of Q (sub-tiles 0-3)
  // and of dO (4-7)
  auto fetch = [&](FmaItem x, float* slot) {
    const int q0 = x.tile * 64;
    if (x.step < n_s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = (2 * x.step + h) * kFmaChunk;
        fetch_sub<kFmaKeys>(slot + h * kFmaSub, k, key0, a.nk, c0, D, unit);
        fetch_sub<kFmaKeys>(slot + (2 + h) * kFmaSub, v, key0, a.nk, c0, D, unit);
        fetch_sub<64>(slot + (4 + h) * kFmaSub, q, q0, a.nq, c0, D, unit);
        fetch_sub<64>(slot + (6 + h) * kFmaSub, dout, q0, a.nq, c0, D, unit);
      }
    } else {
      const int u = x.step - n_s, subs = min(4, (COLS - 128 * u) / kFmaChunk);
      for (int h = 0; h < subs; ++h) {
        const int c0 = g0 + 128 * u + h * kFmaChunk;
        fetch_sub<64>(slot + h * kFmaSub, q, q0, a.nq, c0, D, unit);
        fetch_sub<64>(slot + (4 + h) * kFmaSub, dout, q0, a.nq, c0, D, unit);
      }
    }
  };

  float sc[4][4], acc[4][4 * NG];  // S^T or dP^T; dV (role 0) or dK (role 1)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;

  auto compute = [&](FmaItem x, const float* slot) {
    if (x.step < n_s) {
      if (x.step == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      }
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const float* xs = slot + (2 * role + h) * kFmaSub;      // K or V
        const float* ys = slot + (4 + 2 * role + h) * kFmaSub;  // Q or dO
#pragma unroll
        for (int c = 0; c < kFmaChunk; c += 4) {
          float4 xa[4], yb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xa[i] = ld4(xs + (kg + 8 * i) * kFmaLd + c);
            yb[i] = ld4(ys + (tx + 16 * i) * kFmaLd + c);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = dot4(yb[j], xa[i], sc[i][j]);
        }
      }
      if (x.step == n_s - 1) {  // the scores are whole: P, then dS into shared memory
        if (role == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int key = key0 + kg + 8 * i, row = x.tile * 64 + tx + 16 * j;
              p_s[(kg + 8 * i) * kFmaLdp + tx + 16 * j] =
                  visible(a, row, key) ? expf(sc[i][j] * a.scale - lse[row]) : 0.f;
            }
        }
        __syncthreads();  // block-uniform: every thread computes the same item
        if (role == 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = x.tile * 64 + tx + 16 * j;
            const float dl = row < a.nq ? delta[row] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int at = (kg + 8 * i) * kFmaLdp + tx + 16 * j;
              ds_s[at] = p_s[at] * (sc[i][j] - dl) * a.scale;
            }
          }
        }
      }
      return;
    }
    // dV += P^T dO (role 0) or dK += dS^T Q (role 1) over the item's
    // columns: this thread's 4 of each 64 (tx), float4 f of the item from
    // sub-tile 2 f + tx / 8 of its operand
    const int u = x.step - n_s;
    const float* w_s = role == 0 ? p_s : ds_s;
    const float* oc = slot + (role == 0 ? 4 : 0) * kFmaSub + (tx / 8) * kFmaSub + 4 * (tx % 8);
#pragma unroll
    for (int uu = 0; uu < NU; ++uu) {
      if (uu != u) continue;
#pragma unroll 2
      for (int r = 0; r < 64; r += 4) {
        float4 w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = ld4(w_s + (kg + 8 * i) * kFmaLdp + r);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            if (128 * uu + 64 * f >= COLS) continue;
            const float4 ov = ld4(oc + 2 * f * kFmaSub + (r + rr) * kFmaLd);
#pragma unroll
            for (int i = 0; i < 4; ++i) axpy4(&acc[i][4 * (2 * uu + f)], comp4(w[i], rr), ov);
          }
      }
    }
  };
  const int qt_begin = a.mode == kModeCausal ? key0 / 64 : 0;
  run_ring(ring, FmaItem{live(qt_begin), 0}, next, done, fetch, compute);

  float* out = static_cast<float*>(role == 0 ? a.dv : a.dk) + base_k;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + kg + 8 * i;
    if (key >= a.nk) continue;
#pragma unroll
    for (int m = 0; m < NG; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = g0 + 64 * m + 4 * tx + c;
        if (col < D) out[(size_t)key * D + col] = acc[i][4 * m + c];
      }
  }
}

constexpr int kMaxDevices = 64;

// the widest copy piece (16, 8, 4, 2 or 1 bytes, at least `least`) that
// divides a row's bytes and every pointer or-ed into `ptrs`; 0 if none
int piece_unit(uintptr_t ptrs, long long row_bytes, int least) {
  for (int unit = 16; unit >= least; unit /= 2)
    if (row_bytes % unit == 0 && ptrs % unit == 0) return unit;
  return 0;
}

// cudaFuncAttributeMaxDynamicSharedMemorySize of `kernel`, set once per
// device (`capped` is the caller's, one per kernel instance)
template <typename K>
cudaError_t cap_smem_once(K kernel, int smem, bool (&capped)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && capped[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) capped[dev] = true;
  return err;
}

// the two passes of one column width
template <int COLS>
cudaError_t launch_bwd_fma(const AttnArgs& a) {
  static bool capped[2][kMaxDevices] = {};
  const int groups = (a.D + COLS - 1) / COLS;
  void (*const passes[2])(AttnArgs) = {wide_dq_fma_kernel<COLS>, wide_dkv_fma_kernel<COLS>};
  const dim3 grids[2] = {dim3((a.nq + 63) / 64, a.B * a.H, groups),
                         dim3((a.nk + kFmaKeys - 1) / kFmaKeys, a.B * a.H, groups)};
  for (int p = 0; p < 2; ++p) {
    cudaError_t err = cap_smem_once(passes[p], kFmaSmem, capped[p]);
    if (err != cudaSuccess) return err;
    passes[p]<<<grids[p], kThreads, kFmaSmem, a.stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// float32 backward: the wrapper's plan passes the column width (`cols`)
// and the shared bytes (`smem`, checked against kFmaSmem)
cudaError_t attention_bwd_fp32(AttnArgs a) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  a.unit = piece_unit(ptrs, (long long)a.D * 4, 4);  // the widest copy piece D and the pointers allow
  if (a.unit == 0 || a.smem != kFmaSmem) return cudaErrorInvalidValue;
  switch (a.cols) {
    case 192: return launch_bwd_fma<192>(a);
    case 256: return launch_bwd_fma<256>(a);
    case 320: return launch_bwd_fma<320>(a);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------- float32 forward and multi-row decode, CUDA cores
//
// Two kernels on the backward's machinery (run_ring, fetch_sub, 64 x 32
// sub-tiles in 2-slot rings), each the online softmax of a block of 64
// query rows over the live 64-key tiles, forming S = Q K^T once per column
// group (one group up to D = 320, two at 512: `ops/wide_head.py:
// wide_fp32_plan`), fp32 products on CUDA cores, no TF32:
//   * `wide_fwd_fma_kernel<COLS>` replaces `_fwd_kernel`
//     (`dalle_pytorch_tpu/ops/pallas_attention.py:129`): o and lse of the
//     flash-attention forward, all / causal (top-left) / static mask;
//   * `wide_decode_fma_kernel<KV, COLS>` replaces the decode kernels
//     (`dalle_pytorch_tpu/ops/pallas_decode.py` `_decode_kernel` and its int8
//     arm, `_sparse_decode_kernel`, `_paged_decode_kernel`,
//     `_sparse_paged_decode_kernel`) for fp32 q at n > 4 rows: the function
//     of wide_split_kernel, over keys j <= len - n + i, cut by the bitmap,
//     read through the page table.
// A block is 256 threads in a 16 x 16 grid per (column group, head and
// batch row, 64 query rows); a thread owns rows ty + 16 i (i < 4), keys tx +
// 16 j of S (j < 4) and columns 4 tx .. 4 tx + 3 of each 64 of the group.
// The query tiles with the most key tiles launch first (grid y reversed). A
// causal block stops at the diagonal, the decode at its last row's bound;
// a masked layout's or a bitmap's dead tiles are skipped block-uniformly.
// Per key tile, items through the ring:
//   * S items: 128 channels of Q (sub-tiles 0-3 of a slot) and of K (4-7);
//     S += Q K^T as a 4 x 4 micro-tile a thread on all eight warps, Q and K
//     read as float4 (8 FMAs a load; every thread forms S alone, as there is
//     no dP beside it);
//   * after the last S item, each row's online softmax over the 16 lanes of
//     its half-warp, P into shared memory, O rescaled in registers;
//   * column items: up to 256 of the group's channels of V, O += P V with a
//     float4 of P serving 16 columns (12.8-13.3 FMAs a load); O is COLS / 4
//     registers a thread.
// Arithmetic: the forward's of the kernel it replaced and the plain version
// (base 2, x = s fl(scale log2 e) for a visible pair, kMasked for a masked
// one inside a live tile, -inf past nk, lse = (m + log2 l) ln 2); the
// decode's that of the fp32 tile arm (flash_decode_tile_f32.cu) and the
// reference: q times the scale in fp32 before the product (as Q is read),
// P = e^(S - m) by expf, fp32 P into P V, an int8 cache dequantized (k_int8
// * k_scale, v_int8 * v_scale into the slot's fp32 sub-tiles: cp.async
// cannot convert, so int8 rows land in a raw area of the slot first), a
// row with no visible key written as zeros. Only keys some row of the
// block may see are copied; every other K or V row, and every channel past
// D, is zero-filled by the copy itself, and a dead page's table entry is
// never followed. Tile boundaries depend on key positions only and every
// variant runs one code path: an all-ones bitmap gives the plain
// variant's bits, the paged kernel the contiguous kernel's on the gathered
// view. No atomics: every output is written once, by one thread, and is
// bit-identical run to run. `flash_decode_tile_f32_plain` with 64-key tiles
// is the decode's model on the CPU.
// What bounds them: operations, 4 D flops a visible pair (1.00 ms at D =
// 320 for the training shapes at the card's fp32 rate); they do that at one
// group and 2 D more for each further group, read Q, K and V from L2 once
// per 64 x 64 tile pair, and are held by shared-memory loads (see the
// backward's note: 8 and 13 FMAs a float4 load against the 16 that would
// feed the FMA units).

constexpr int kFwdFmaSmem = 4 * (kFmaStages * kFmaSlot + 64 * kFmaLdp);  // the ring, then P
// an int8 decode slot adds a raw area: 64 rows of up to 256 int8 channels
// (rows 288 bytes apart: the dequantizing reads are conflict-free), then
// the rows' scales
constexpr int kRawLd = 288;
constexpr int kRawFloats = (64 * kRawLd + 64 * 4) / 4;
constexpr int kDecTableCache = 128;  // page-table entries a paged block stages in shared memory
__host__ __device__ constexpr int decode_fma_slot(bool quant) { return kFmaSlot + (quant ? kRawFloats : 0); }
// dynamic shared bytes of the decode (ops/wide_head.py fma_smem)
__host__ __device__ constexpr int decode_fma_smem(bool quant) {
  return 4 * (kFmaStages * decode_fma_slot(quant) + 64 * kFmaLdp);
}

// reductions over the 16 lanes of a half-warp (the threads of one ty)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// S += Q K^T over `subs` 32-channel sub-tiles of an S item's slot (Q in
// sub-tiles 0-3, K in 4-7): rows ty + 16 i against keys tx + 16 j; with
// SCALE_Q each Q element times `qs` as it is read, as the reference scales q
template <bool SCALE_Q>
__device__ __forceinline__ void s_product(float (&sc)[4][4], const float* slot, int subs, int ty, int tx,
                                          float qs) {
#pragma unroll 1
  for (int h = 0; h < subs; ++h) {
    const float* xs = slot + h * kFmaSub;
    const float* ys = slot + (4 + h) * kFmaSub;
#pragma unroll
    for (int c = 0; c < kFmaChunk; c += 4) {
      float4 xa[4], yb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xa[i] = ld4(xs + (ty + 16 * i) * kFmaLd + c);
        if (SCALE_Q) {
          xa[i].x *= qs;
          xa[i].y *= qs;
          xa[i].z *= qs;
          xa[i].w *= qs;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) yb[j] = ld4(ys + (tx + 16 * j) * kFmaLd + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dot4(xa[i], yb[j], sc[i][j]);
    }
  }
}

// O += P V over column item u (V sub-tiles 0-7 of the slot: the group's
// channels from 256 u): rows ty + 16 i, columns 4 tx .. 4 tx + 3 of each 64,
// float4 f of the item from sub-tile 2 f + tx / 8
template <int COLS>
__device__ __forceinline__ void pv_product(float (&acc)[4][COLS / 16], const float* p_s, const float* slot,
                                           int u, int ty, int tx) {
  constexpr int NU = (COLS + 255) / 256;
  const float* vc = slot + (tx / 8) * kFmaSub + 4 * (tx % 8);
#pragma unroll
  for (int uu = 0; uu < NU; ++uu) {
    if (uu != u) continue;
#pragma unroll 2
    for (int key = 0; key < 64; key += 4) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = ld4(p_s + (ty + 16 * i) * kFmaLdp + key);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (256 * uu + 64 * f >= COLS) continue;
          const float4 vv = ld4(vc + 2 * f * kFmaSub + (key + kk) * kFmaLd);
#pragma unroll
          for (int i = 0; i < 4; ++i) axpy4(&acc[i][4 * (4 * uu + f)], comp4(w[i], kk), vv);
        }
    }
  }
}

// 32-channel sub-tiles an item holds from channel c0: S items at most 4,
// column items at most 8 (COLS - 256 u channels of the group)
__device__ __forceinline__ int s_subs(int D, int c0) { return min(4, (D - c0 + kFmaChunk - 1) / kFmaChunk); }
template <int COLS>
__device__ __forceinline__ int v_subs(int u) { return min(8, (COLS - 256 * u) / kFmaChunk); }

// forward: grid (groups * B * H, ceil(nq / 64))
template <int COLS>
__global__ void __launch_bounds__(kThreads, 1) wide_fwd_fma_kernel(AttnArgs a) {
  constexpr int NC = COLS / 16;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* p_s = smem + kFmaStages * kFmaSlot;  // [64 rows][kFmaLdp]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int D = a.D, unit = a.unit, groups = (D + COLS - 1) / COLS;
  const int bh = blockIdx.x / groups, g0 = (blockIdx.x % groups) * COLS;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const size_t base_q = (size_t)bh * a.nq * D, base_k = (size_t)bh * a.nk * D;
  const float* q = static_cast<const float*>(a.q) + base_q;
  const float* k = static_cast<const float*>(a.k) + base_k;
  const float* v = static_cast<const float*>(a.v) + base_k;
  const float scale2 = a.scale * kLog2e;  // fl(scale log2(e)), as the plain version forms it
  const int n_kt = (a.nk + 63) / 64;
  const int kt_end = a.mode == kModeCausal ? min(n_kt, (min(row0 + 64, a.nq) - 1) / 64 + 1) : n_kt;
  const int n_s = (D + 127) / 128;                  // S items a key tile
  const int n_g = (min(COLS, D - g0) + 255) / 256;  // the group's live column items
  auto live = [&](int kt) {
    if (a.mode == kModeMask)
      while (kt < kt_end && a.layout[(row0 / 64) * n_kt + kt] == 0) ++kt;
    return kt;
  };
  auto next = [&](FmaItem x) { return ++x.step < n_s + n_g ? x : FmaItem{live(x.tile + 1), 0}; };
  auto done = [&](FmaItem x) { return x.tile >= kt_end; };
  auto fetch = [&](FmaItem x, float* slot) {
    const int key0 = x.tile * 64;
    if (x.step < n_s) {
      const int c0 = 128 * x.step, subs = s_subs(D, c0);
      for (int h = 0; h < subs; ++h) {
        fetch_sub<64>(slot + h * kFmaSub, q, row0, a.nq, c0 + h * kFmaChunk, D, unit);
        fetch_sub<64>(slot + (4 + h) * kFmaSub, k, key0, a.nk, c0 + h * kFmaChunk, D, unit);
      }
    } else {
      const int u = x.step - n_s, subs = v_subs<COLS>(u);
      for (int h = 0; h < subs; ++h)
        fetch_sub<64>(slot + h * kFmaSub, v, key0, a.nk, g0 + 256 * u + h * kFmaChunk, D, unit);
    }
  };

  float m[4], l[4], sc[4][4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  auto compute = [&](FmaItem x, const float* slot) {
    if (x.step >= n_s) {
      pv_product<COLS>(acc, p_s, slot, x.step - n_s, ty, tx);
      return;
    }
    if (x.step == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }
    s_product<false>(sc, slot, s_subs(D, 128 * x.step), ty, tx, 1.f);
    if (x.step < n_s - 1) return;
    // the scores are whole: the online softmax in base 2, P into shared
    // memory (read by the column items, after the ring's next barrier)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = x.tile * 64 + tx + 16 * j;
        sc[i][j] = key >= a.nk ? -INFINITY : visible(a, row, key) ? sc[i][j] * scale2 : kMasked;
        tmax = fmaxf(tmax, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(tmax));  // finite: a live tile holds a key below nk
      const float corr = exp2f(m[i] - m_new);            // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(sc[i][j] - m_new);
        psum += p;
        p_s[(ty + 16 * i) * kFmaLdp + tx + 16 * j] = p;
      }
      l[i] = fmaf(l[i], corr, half_sum(psum));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
  };
  run_ring(ring, FmaItem{live(0), 0}, next, done, fetch, compute);

  float* o = static_cast<float*>(a.o) + base_q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= a.nq) continue;
#pragma unroll
    for (int mm = 0; mm < COLS / 64; ++mm)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = g0 + 64 * mm + 4 * tx + c;
        if (col < D) o[(size_t)r * D + col] = acc[i][4 * mm + c] / l[i];
      }
    if (g0 == 0 && tx == 0)
      static_cast<float*>(a.lse_out)[(size_t)bh * a.nq + r] = (m[i] + log2f(l[i])) * kLn2;
  }
}

// decode: grid (groups * B * H, ceil(n / 64)); q_unit and kv_unit are the
// bytes of a copy piece of q and of the cache
template <typename KV, int COLS>
__global__ void __launch_bounds__(kThreads, 1)
wide_decode_fma_kernel(const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                       const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                       const int* __restrict__ lengths, const int* __restrict__ bitmap,
                       const int* __restrict__ page_table, float* __restrict__ out, int H, int n, int S,
                       int D, int n_blocks, int block_k, int page_size, int n_pool, int q_unit,
                       int kv_unit, float sm_scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int ELT = (int)sizeof(KV), NC = COLS / 16;
  extern __shared__ __align__(16) float smem[];
  __shared__ int table_s[kDecTableCache];
  float* ring = smem;
  float* p_s = smem + kFmaStages * decode_fma_slot(QUANT);  // [64 rows][kFmaLdp]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int groups = (D + COLS - 1) / COLS;
  const int bh = blockIdx.x / groups, g0 = (blockIdx.x % groups) * COLS;
  const int b = bh / H, h = bh % H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int len = min(max(lengths[b], 0), S);
  const int key1 = max(len - n + min(row0 + 64, n), 0);  // keys [0, key1): the last row's
  const int* live_b = bitmap ? bitmap + (size_t)b * n_blocks : nullptr;
  const int* table_b = page_table ? page_table + (size_t)b * (S / page_size) : nullptr;
  const float* qb = q + (size_t)bh * n * D;
  // the table entries of the block's pages, read once (an entry is only
  // checked and followed where a live key is copied from its page)
  if (table_b && key1 > 0) {
    const int pages = min((key1 - 1) / page_size + 1, kDecTableCache);
    for (int i = threadIdx.x; i < pages; i += kThreads) table_s[i] = table_b[i];
  }
  __syncthreads();

  const int t_end = (key1 + 63) / 64;
  const int n_s = (D + 127) / 128;
  const int n_g = (min(COLS, D - g0) + 255) / 256;
  // with a bitmap: the first tile at or after t with a live key below key1
  auto live = [&](int t) {
    if (live_b) {
      for (; t < t_end; ++t) {
        const int last = min(t * 64 + 64, key1) - 1;
        bool any = false;
        for (int blk = t * 64 / block_k; blk <= last / block_k && !any; ++blk) any = live_b[blk] != 0;
        if (any) break;
      }
    }
    return t;
  };
  auto next = [&](FmaItem x) { return ++x.step < n_s + n_g ? x : FmaItem{live(x.tile + 1), 0}; };
  auto done = [&](FmaItem x) { return x.tile >= t_end; };
  // the row of k/v (and of the scales) holding key `pos`, or -1 where no
  // row of the block sees it
  auto src_row = [&](int pos) -> long long {
    if (pos >= key1 || (live_b && live_b[pos / block_k] == 0)) return -1;
    if (table_b) {
      const int pi = pos / page_size;
      const int page = pi < kDecTableCache ? table_s[pi] : table_b[pi];
      if (page < 0 || page >= n_pool) __trap();  // a corrupt table faults loudly
      return ((long long)page * H + h) * page_size + (pos - pi * page_size);
    }
    return (long long)bh * S + pos;
  };
  // K or V channels [c0, c0 + 32 subs) of key tile t: fp32 into the slot's
  // sub-tiles from sub0, int8 into its raw rows (and the rows' scales), in
  // pieces of kv_unit bytes; zeros for keys no row sees and past D
  auto fetch_kv = [&](const KV* x, const float* scale, int t, int c0, int subs, float* slot, int sub0) {
    unsigned char* raw = reinterpret_cast<unsigned char*>(slot + kFmaSlot);
    const char* xb = reinterpret_cast<const char*>(x);
    auto piece = [&](long long row, int hh, int j, int off) {  // `off` bytes into sub-tile hh's row
      const int c = c0 + hh * kFmaChunk + off / ELT;
      const bool ok = row >= 0 && c < D;
      void* dst = QUANT ? static_cast<void*>(raw + j * kRawLd + hh * kFmaChunk + off)
                        : static_cast<void*>(reinterpret_cast<unsigned char*>(
                              slot + (sub0 + hh) * kFmaSub + j * kFmaLd) + off);
      split_copy(dst, ok ? xb + (row * D + c) * ELT : xb, ok, kv_unit);
    };
    if (kv_unit == 16) {  // block-uniform: a thread's rows found once an item
      constexpr int PPS = kFmaChunk * ELT / 16;     // pieces a sub-tile row: 8 fp32, 2 int8
      constexpr int RPP = kThreads / PPS;           // rows a pass: 32, or 128 (two sub-tiles)
      constexpr int NR = RPP >= 64 ? 1 : 64 / RPP;  // rows a thread
      constexpr int HS = RPP > 64 ? RPP / 64 : 1;   // sub-tiles a pass
      const int j0 = (threadIdx.x / PPS) % 64, off = (threadIdx.x % PPS) * 16;
      const int h0 = (threadIdx.x / PPS) / 64;
      long long rows[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) rows[r] = src_row(t * 64 + j0 + r * RPP);
      for (int hh = h0; hh < subs; hh += HS)
#pragma unroll
        for (int r = 0; r < NR; ++r) piece(rows[r], hh, j0 + r * RPP, off);
    } else {
      const int pps = kFmaChunk * ELT / kv_unit;
      for (int e = threadIdx.x; e < 64 * pps * subs; e += kThreads) {
        const int hh = e / (64 * pps), j = (e / pps) % 64;
        piece(src_row(t * 64 + j), hh, j, (e % pps) * kv_unit);
      }
    }
    if (QUANT) {
      float* sc = reinterpret_cast<float*>(raw + 64 * kRawLd);
      for (int j = threadIdx.x; j < 64; j += kThreads) {
        const long long row = src_row(t * 64 + j);
        split_copy(sc + j, scale + (row < 0 ? 0 : row), row >= 0, 4);
      }
    }
  };
  auto fetch = [&](FmaItem x, float* slot) {
    if (x.step < n_s) {
      const int c0 = 128 * x.step, subs = s_subs(D, c0);
      for (int hh = 0; hh < subs; ++hh)
        fetch_sub<64>(slot + hh * kFmaSub, qb, row0, n, c0 + hh * kFmaChunk, D, q_unit);
      fetch_kv(k, k_scale, x.tile, c0, subs, slot, 4);
    } else {
      const int u = x.step - n_s;
      fetch_kv(v, v_scale, x.tile, g0 + 256 * u, v_subs<COLS>(u), slot, 0);
    }
  };
  // int8: the slot's raw rows of `subs` sub-tiles times their scales into
  // its fp32 sub-tiles from sub0 (keys no row sees: zero rows, zero scales)
  auto dequantize = [&](float* slot, int subs, int sub0) {
    const unsigned char* raw = reinterpret_cast<const unsigned char*>(slot + kFmaSlot);
    const float* sc = reinterpret_cast<const float*>(raw + 64 * kRawLd);
    for (int e = threadIdx.x; e < 64 * 8 * subs; e += kThreads) {
      const int hh = e / 512, j = (e / 8) % 64, c = 4 * (e % 8);
      const char4 r = *reinterpret_cast<const char4*>(raw + j * kRawLd + hh * kFmaChunk + c);
      const float s = sc[j];
      *reinterpret_cast<float4*>(slot + (sub0 + hh) * kFmaSub + j * kFmaLd + c) =
          make_float4(r.x * s, r.y * s, r.z * s, r.w * s);
    }
    __syncthreads();  // block-uniform: every thread computes the same item
  };

  float m[4], l[4], sc[4][4], acc[4][NC];
  int bound[4];  // this thread's rows' last visible key (rows past n see nothing)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    const int r = row0 + ty + 16 * i;
    bound[i] = r < n ? len - n + r : -1;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  auto compute = [&](FmaItem x, float* slot) {
    if (x.step >= n_s) {
      const int u = x.step - n_s;
      if (QUANT) dequantize(slot, v_subs<COLS>(u), 0);
      pv_product<COLS>(acc, p_s, slot, u, ty, tx);
      return;
    }
    const int subs = s_subs(D, 128 * x.step);
    if (QUANT) dequantize(slot, subs, 4);
    if (x.step == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }
    s_product<true>(sc, slot, subs, ty, tx, sm_scale);
    if (x.step < n_s - 1) return;
    // the scores are whole: the online softmax in base e, P into shared memory
    bool key_live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pos = x.tile * 64 + tx + 16 * j;
      key_live[j] = pos < key1 && (live_b == nullptr || live_b[pos / block_k] != 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!(key_live[j] && x.tile * 64 + tx + 16 * j <= bound[i])) sc[i][j] = -INFINITY;
        tmax = fmaxf(tmax, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(tmax));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet: add nothing
      const float corr = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_use);  // 0 where unseen
        psum += p;
        p_s[(ty + 16 * i) * kFmaLdp + tx + 16 * j] = p;
      }
      l[i] = fmaf(l[i], corr, half_sum(psum));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
  };
  run_ring<decode_fma_slot(QUANT)>(ring, FmaItem{live(0), 0}, next, done, fetch, compute);

  // O / l for this thread's rows; a row with no visible key is zeros
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
    float* o = out + ((size_t)bh * n + r) * D;
#pragma unroll
    for (int mm = 0; mm < COLS / 64; ++mm)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = g0 + 64 * mm + 4 * tx + c;
        if (col < D) o[col] = l[i] > 0.f ? acc[i][4 * mm + c] / l[i] : 0.f;
      }
  }
}

template <int COLS>
cudaError_t launch_fwd_fma(const AttnArgs& a) {
  static bool capped[kMaxDevices] = {};
  const long long blocks = (long long)((a.D + COLS - 1) / COLS) * a.B * a.H;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err = cap_smem_once(wide_fwd_fma_kernel<COLS>, kFwdFmaSmem, capped);
  if (err != cudaSuccess) return err;
  wide_fwd_fma_kernel<COLS><<<dim3((unsigned)blocks, (a.nq + 63) / 64), kThreads, kFwdFmaSmem, a.stream>>>(a);
  return cudaGetLastError();
}

// float32 forward: the wrapper's plan passes the column width (`cols`) and
// the shared bytes (`smem`, checked against kFwdFmaSmem)
cudaError_t attention_fwd_fp32(AttnArgs a) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  a.unit = piece_unit(ptrs, (long long)a.D * 4, 4);
  if (a.unit == 0 || a.smem != kFwdFmaSmem) return cudaErrorInvalidValue;
  switch (a.cols) {
    case 192: return launch_fwd_fma<192>(a);
    case 256: return launch_fwd_fma<256>(a);
    case 320: return launch_fwd_fma<320>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV, int COLS>
cudaError_t launch_decode_fma(const DecodeArgs& a, int q_unit, int kv_unit) {
  static bool capped[kMaxDevices] = {};
  constexpr int smem = decode_fma_smem(sizeof(KV) == 1);
  const long long blocks = (long long)((a.D + COLS - 1) / COLS) * a.B * a.H;
  if (blocks > 2147483647LL || (a.n + 63) / 64 > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cap_smem_once(wide_decode_fma_kernel<KV, COLS>, smem, capped);
  if (err != cudaSuccess) return err;
  wide_decode_fma_kernel<KV, COLS><<<dim3((unsigned)blocks, (a.n + 63) / 64), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.bitmap),
      static_cast<const int*>(a.page_table), static_cast<float*>(a.out), a.H, a.n, a.S, a.D,
      a.n_blocks, a.block_k, a.page_size, a.n_pool, q_unit, kv_unit, a.sm_scale);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t decode_fma_cols(const DecodeArgs& a, int cols, int q_unit, int kv_unit) {
  switch (cols) {
    case 192: return launch_decode_fma<KV, 192>(a, q_unit, kv_unit);
    case 256: return launch_decode_fma<KV, 256>(a, q_unit, kv_unit);
    case 320: return launch_decode_fma<KV, 320>(a, q_unit, kv_unit);
    default: return cudaErrorInvalidValue;
  }
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
         (long long)a.B * a.H <= 65535 && (a.D + 63) / 64 <= 65535 &&  // groups of >= 64 columns
         (a.nq + kT - 1) / kT <= 65535 && (a.nk + kT - 1) / kT <= 65535;
}

// the bf16 arm's extra conditions: D a multiple of 8, an instance's
// column count, every group holding columns below D
bool mma_args_ok(const AttnArgs& a) {
  return a.D % 8 == 0 && a.cols > 0 && a.cols % 64 == 0 && a.smem > 0 &&
         (long long)mma_groups(a) * a.B * a.H <= 2147483647LL;
}

}  // namespace

// The multi-row decode of fp32 q (n > 4 rows) at any D on
// `wide_decode_fma_kernel<KV, cols>`: arguments as wide_split_launch (q,
// out and a cache that is not int8 float32), plus `cols` (192, 256 or 320
// output columns a block) and `smem` (its dynamic shared bytes), both from
// `ops/wide_head.py:wide_fp32_plan(D, "decode", quantized)`. Any alignment
// of the elements' own size.
extern "C" int wide_decode_fma_launch(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale, const void* lengths,
                                      const void* bitmap, const void* page_table, void* out, int B,
                                      int H, int n, int S, int D, int n_blocks, int block_k,
                                      int page_size, int n_pool, int quantized, int cols, int smem,
                                      float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || S <= 0 || D <= 0 || smem != decode_fma_smem(quantized != 0))
    return (int)cudaErrorInvalidValue;
  if (quantized && (k_scale == nullptr || v_scale == nullptr || reinterpret_cast<uintptr_t>(k_scale) % 4 ||
                    reinterpret_cast<uintptr_t>(v_scale) % 4))
    return (int)cudaErrorInvalidValue;
  if (bitmap != nullptr && (block_k <= 0 || n_blocks < (S + block_k - 1) / block_k))
    return (int)cudaErrorInvalidValue;
  if (page_table != nullptr && (page_size <= 0 || S % page_size != 0 || n_pool <= 0))
    return (int)cudaErrorInvalidValue;
  const int q_unit = piece_unit(reinterpret_cast<uintptr_t>(q), (long long)D * 4, 4);
  const int kv_unit = piece_unit(reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v),
                                 (long long)D * (quantized ? 1 : 4), quantized ? 1 : 4);
  if (q_unit == 0 || kv_unit == 0) return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k, v, k_scale, v_scale, lengths, bitmap, page_table, out,
                     B, H, n, S, D, n_blocks, block_k, page_size > 0 ? page_size : 1, n_pool,
                     sm_scale, static_cast<cudaStream_t>(stream)};
  return (int)(quantized ? decode_fma_cols<int8_t>(a, cols, q_unit, kv_unit)
                         : decode_fma_cols<float>(a, cols, q_unit, kv_unit));
}

// Floats of the split-K workspace wide_split_launch needs at (B, H, S, D):
// each span's rows' accumulators, then each column group's (m, l).
extern "C" long long wide_split_workspace_floats(int B, int H, int S, int D) {
  const long long spans = (S + kSplitSpan - 1) / kSplitSpan;
  return (long long)B * H * spans * kSplitRows * ((long long)D + 2 * split_groups(D));
}

// The decode family's step (n <= 4 query rows) at any D > 256 on the
// split-K kernel: q/out [B,H,n,D] of `dtype` (0 = float32, 1 = bfloat16);
// k/v [B,H,S,D] of that dtype, or int8 with `quantized` = 1 and k_scale /
// v_scale [B,H,S] float32; with `page_table` [B, S / page_size] int32 of
// pool pages in [0, n_pool), k/v (and the scales) are pools [n_pool, H,
// page_size, D] (an entry out of range traps); `bitmap` [B, n_blocks]
// int32 over blocks of `block_k` positions (one per page-table entry when
// paged), or null; lengths [B] int32. Contiguous. `chunks` and `smem` are
// the plan's (`ops/wide_head.py:wide_split_plan`; a launch whose numbers
// differ from this file's is refused),
// `workspace` holds wide_split_workspace_floats() floats and `counters`
// B*H*groups int32 that are zero before the first call and that every call
// leaves zero (shared with flash_decode.cu's split-K calls: calls must not
// run concurrently). Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int wide_split_launch(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale, const void* lengths,
                                 const void* bitmap, const void* page_table, void* out, int B,
                                 int H, int n, int S, int D, int n_blocks, int block_k,
                                 int page_size, int n_pool, int dtype, int quantized, int chunks,
                                 int smem, float sm_scale, void* stream, void* workspace,
                                 void* counters) {
  if (B <= 0 || H <= 0 || n <= 0 || n > kSplitRows || S <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const int elt = quantized ? 1 : dtype == 0 ? 4 : 2;
  if (chunks != split_chunks(D) || smem != split_smem_bytes(D, elt, n == 1 ? 1 : kSplitRows))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 2147483647LL || (S + kSplitSpan - 1) / kSplitSpan > 65535 ||
      split_groups(D) > 65535 || workspace == nullptr || counters == nullptr)
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
// bytes a block; float32 (any D) `wide_fwd_fma_kernel<cols>` (cols = 192,
// 256 or 320, `smem` its shared bytes, both from `ops/wide_head.py:
// wide_fp32_plan`); `resident` unused.
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
// converts it into dq. float32 (any D): two launches,
// `wide_dq_fma_kernel<cols>` then `wide_dkv_fma_kernel<cols>` (cols = 192,
// 256 or 320 output columns a block, `smem` their shared bytes, both from
// `ops/wide_head.py:wide_fp32_bwd_plan`), no workspace; `resident` unused.
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
