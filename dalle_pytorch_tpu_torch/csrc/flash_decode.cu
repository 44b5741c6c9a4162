// Flash-decode attention for Hopper (sm_90a): cached attention of a query
// chunk over a KV cache with per-row live lengths, in variants of one
// kernel body: a contiguous cache or a paged pool read through a page
// table, each plain, int8 and block-sparse.
//
// Replaces the TPU kernels of `dalle_pytorch_tpu/ops/pallas_decode.py`:
//   * `_decode_kernel`, plain arm (`flash_decode_attention`);
//   * `_decode_kernel`, int8 arm (`quantized=True`: K/V int8 with fp32
//     per-(position, head) scales, dequantized in the kernel);
//   * `_sparse_decode_kernel` (`block_sparse_flash_decode_attention`): a
//     per-(row, KV block) bitmap of blocks that may be read, with its int8
//     arm;
//   * `_paged_decode_kernel` (`paged_flash_decode_attention`, both arms):
//     K/V (and int8 scales) in a pool [P, H, page, D] shared by all rows,
//     row b's key j at pool page page_table[b, j / page], offset j % page;
//   * `_sparse_paged_decode_kernel` (`block_sparse_paged_flash_decode_
//     attention`, both arms): the paged kernel with a bitmap of one bit per
//     page-table entry; a dead page's table entry is never followed.
//
//   out[b,h,i,:] = softmax_j(q[b,h,i] . k[b,h,j] * scale) @ v[b,h,j]
//                  over j <= lengths[b] - n + i,  lengths clipped to [0, S],
//                  and (block-sparse) bitmap[b, j / block_k] != 0
//   (paged: k[b,h,j] = k_pages[page_table[b, j / page], h, j % page], S =
//   n_pages * page, block_k = page)
//
// D is any head dim up to 256, a runtime argument: the kernel has
// instances for at most 64, 128 and 256 channels (DMAX); the channels past
// D are zero in shared memory and in q, so they add nothing. fp32
// accumulation whatever the input type; output in q's type; int8 K/V read
// as k_int8 * k_scale[b,h,j] in fp32 (the scale applied in registers, to
// the int8 dot product and to p). A query row with no visible key is
// written as zeros.
//
// What bounds it: at decode (n = 1) every cache element is used once, so
// the kernel is bound by the bytes of live K/V it reads, 2*B*H*len*D*elt
// per call (elt = 1 for int8, plus 8 bytes of scales per position). It
// takes n <= kRows query rows (calls of more rows run the tile arms,
// flash_decode_tile.cu for bf16 q and flash_decode_tile_f32.cu for fp32).
// At the flagship step
// (B*H = 64 rows of 258-1281 keys) one block per (row, head) leaves most
// SMs idle and each block's tiles in series, so the design spreads the
// cache over blocks and keeps every warp and the copy engine busy:
//   * split-K over the cache (flash-decoding): each (batch row, head) runs
//     one block per span of kSpan = 128
//     key positions (measured against 64, 256 and 512; a whole number of
//     tiles, and of pages for pages of 16-128). Span
//     boundaries depend on key positions only, never on S, the layout or
//     the bitmap, so the paged and contiguous variants sum in the same
//     order. Blocks past a row's last visible key exit at once. Each span
//     writes (m, l, acc[D]) in fp32 to a workspace; the last block of a
//     (b, h) to arrive (an atomic counter it resets itself: one launch a
//     call, no memset, no host sync) merges the spans in span order. A
//     span with no visible key writes m = -inf, l = 0 and adds no term. A
//     row whose keys all lie in one span is written by its one block;
//   * every warp computes: a tile's keys are split across the 4 warps, and
//     within a warp each key goes to a group of DMAX / 8 lanes holding 8
//     channels each (at D <= 64, 4 keys a step), so a score is a butterfly
//     sum over the group; each warp keeps its own online softmax (m, l) per
//     query row and each lane its keys' P . V terms; the groups' and then
//     the warps' states merge in a fixed order at the end of the span;
//   * K and V stay in their storage type in shared memory (bf16, fp32 or
//     int8) and widen in registers (one 16-byte shared load per key and
//     lane in bf16); nothing dequantized is ever written;
//   * tiles arrive by cp.async (16-byte chunks where the row's D * elt
//     allows, else 8 or 4, else a plain element copy) into a ring of
//     kStages stages, so the next tiles are in flight while one computes,
//     with one barrier a tile; a warp copies whole key rows, lanes over
//     (row, chunk). The paged variants read the block's page-table entries
//     once into shared memory and copy each key row from its page (a pool
//     page of one head is a contiguous slab); an entry is checked (out of
//     range traps) and followed only where a live key is copied, so a dead
//     page's entry is never followed. Only keys some row of the block can
//     see are copied: the tail of a live page past the length, dead blocks
//     and pages past a row's last are never read;
//   * scores of keys a row may not see are set by select, and a value no
//     row sees enters P . V as 0 (never 0 * value): stale or poisoned bytes
//     in shared memory never reach a result;
//   * the softmax is one code path for every variant with explicit fmaf /
//     expf, so an all-ones bitmap gives the plain variant's bits and the
//     paged kernel gives the contiguous kernel's bits on the gathered view.
// Not done: tensor cores here (a step is 4 D flops per key read, far below
// the card's ridge; the multi-row bf16 calls, where every key serves many
// rows, are flash_decode_tile.cu's) and TMA bulk copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;            // query rows a call may have (ops/flash_decode.py DECODE_ROWS)
constexpr int kSpan = 128;          // cache positions per split-K block (ops/flash_decode.py DECODE_SPAN)
constexpr int kStages = 3;          // cp.async ring depth
constexpr int kStageBytes = 32768;  // K + V bytes of one tile, at most
constexpr int kTableCache = 128;    // page-table entries a paged block stages in shared memory

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// keys per tile of an instance: 64, or fewer where a tile's K and V would
// pass kStageBytes (bf16 at 256 channels: 32; fp32 at 128: 32, at 256: 16)
template <typename KV, int DMAX>
__host__ __device__ constexpr int tile_keys() {
  return kStageBytes / (2 * DMAX * (int)sizeof(KV)) >= 64
             ? 64
             : kStageBytes / (2 * DMAX * (int)sizeof(KV));
}

template <typename KV, int DMAX>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * tile_keys<KV, DMAX>() * DMAX * (int)sizeof(KV) +
         (sizeof(KV) == 1 ? 2 * tile_keys<KV, DMAX>() * (int)sizeof(float) : 0);
}

template <typename KV, int DMAX>
__host__ __device__ constexpr int smem_bytes() {
  // the ring, reused at the end for the warps' merge ([warps][rows][DMAX + 2] fp32)
  return kStages * stage_bytes<KV, DMAX>() > kWarps * kRows * (DMAX + 2) * 4
             ? kStages * stage_bytes<KV, DMAX>()
             : kWarps * kRows * (DMAX + 2) * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N adjacent elements of type KV at p (aligned to N * sizeof(KV) bytes) as fp32
template <typename KV, int N>
__device__ __forceinline__ void load_vec(float (&out)[N], const KV* p) {
  constexpr int BYTES = N * (int)sizeof(KV);
  if constexpr (BYTES >= 16) {
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
  } else if constexpr (BYTES == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else {
    static_assert(BYTES == 2, "lane vector");
    const uint16_t raw = *reinterpret_cast<const uint16_t*>(p);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  }
}

// T: q/out type; KV: cache type (T, or int8_t with scales); DMAX: channels
// of the instance (D <= DMAX at run time); SPARSE: read the block bitmap;
// PAGED: k/v/scales are pools read through page_table [B, S / page_size];
// ROWS: the query rows a block holds in registers (1 at the step n = 1,
// else kRows). Grid (B * H, spans). At most 128 registers a thread at 64
// channels (4 blocks an SM);
// wider instances hold 2 blocks an SM by shared memory or registers.
template <typename T, typename KV, int DMAX, bool SPARSE, bool PAGED, int ROWS>
__global__ void __launch_bounds__(kThreads, DMAX > 64 ? 2 : 4)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ lengths,
                    const int* __restrict__ bitmap, const int* __restrict__ page_table,
                    T* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                    int H, int n, int S, int D, int n_blocks, int block_k, int page_size,
                    int n_pool, float sm_scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int BN = tile_keys<KV, DMAX>();
  constexpr int KPW = BN / kWarps;   // keys of a tile per warp
  constexpr int VPL = 8;             // channels per lane
  constexpr int LG = DMAX / VPL;     // lanes per key (8, 16, 32)
  constexpr int KS = 32 / LG;        // keys a warp takes at once (4, 2, 1), one per lane group
  constexpr int STEPS = KPW / KS;    // of this warp's keys in a tile
  constexpr int TILE = BN * DMAX;    // elements of a K or V tile
  constexpr int STAGE = stage_bytes<KV, DMAX>();
  static_assert(KPW % KS == 0 && STEPS <= 32 && DMAX % 64 == 0 && kSpan % BN == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  __shared__ int table_s[PAGED ? kTableCache : 1];  // entries from page key0 / page_size on

  const int bh = blockIdx.x, split = blockIdx.y, n_spans = gridDim.y;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LG, c0 = (lane % LG) * VPL;  // this lane's key of a step, its channels
  const int len = min(max(lengths[b], 0), S);
  const int nrows = min(ROWS, n);
  // keys [key0, key1) of this block: up to the last one any of its rows sees
  int key0 = 0, key1 = len - n + nrows;
  int n_live = 1;  // spans of this (b, h) holding keys its rows may see
  if (n_spans > 1) {
    n_live = max(1, (key1 + kSpan - 1) / kSpan);
    if (split >= n_live) return;  // block-uniform, before any barrier
    key0 = split * kSpan;
    key1 = min(key1, key0 + kSpan);
  }
  const size_t bhs = (size_t)bh;
  const int* live_b = SPARSE ? bitmap + (size_t)b * n_blocks : nullptr;
  const int* table_b = PAGED ? page_table + (size_t)b * (S / page_size) : nullptr;

  float qr[ROWS][VPL];
  int bound[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    bound[r] = len - n + r;
#pragma unroll
    for (int e = 0; e < VPL; ++e) {
      const int c = c0 + e;
      qr[r][e] = r < nrows && c < D ? to_float(q[(bhs * n + r) * D + c]) * sm_scale : 0.f;
    }
  }
  if (D < DMAX) {  // the channels past D stay zero (cp.async never writes them)
    for (int i = threadIdx.x; i < kStages * STAGE / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }
  // the table entries of this block's pages, read once (an entry is only
  // checked and followed where a live key is copied from its page)
  const int page0 = PAGED ? key0 / page_size : 0;
  if (PAGED && key1 > key0) {
    const int pages = min((key1 - 1) / page_size + 1 - page0, kTableCache);
    for (int i = threadIdx.x; i < pages; i += kThreads) table_s[i] = table_b[page0 + i];
  }
  if (D < DMAX || PAGED) __syncthreads();

  const int t_begin = key0 / BN;
  const int t_end = key1 > key0 ? (key1 - 1) / BN + 1 : t_begin;
  // SPARSE: whether any key of tile t in [key0, key1) lies in a live block
  auto next_tile = [&](int t) {
    if (SPARSE) {
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

  // copies: a row of D * elt bytes in chunks of `unit` bytes (16 where the
  // row allows, else 8 or 4, else one element by a plain copy); a warp
  // copies `rps` rows at once, lane (row, chunk) = (lane / cpr, lane % cpr)
  const int row_bytes = D * (int)sizeof(KV);
  const int width = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : 0;
  const int unit = width ? width : (int)sizeof(KV);
  const int cpr = row_bytes / unit;
  const int rps = cpr < 32 ? 32 / cpr : 1;
  const int lane_row = cpr < 32 ? lane / cpr : 0, lane_chunk = cpr < 32 ? lane % cpr : lane;
  const int chunk_step = cpr < 32 ? cpr : 32;
  // the visible keys of tile t -> stage st
  auto fetch = [&](int t, int st) {
    unsigned char* stage = smem + st * STAGE;
    const uint32_t kd0 = smem_addr(stage), vd0 = kd0 + TILE * (int)sizeof(KV);
    const uint32_t sd0 = vd0 + TILE * (int)sizeof(KV);
    for (int jw = warp * rps; jw < BN; jw += kWarps * rps) {
      if (t * BN + jw >= key1) break;  // warp-uniform: keys ascend
      const int j = jw + lane_row, pos = t * BN + j;
      if (lane_row >= rps || j >= BN || pos >= key1) continue;
      if (SPARSE && live_b[pos / block_k] == 0) continue;
      size_t row;
      if (PAGED) {
        const int pi = pos / page_size;
        const int page = pi - page0 < kTableCache ? table_s[pi - page0] : table_b[pi];
        if (page < 0 || page >= n_pool) __trap();  // a corrupt table faults loudly
        row = ((size_t)page * H + h) * page_size + (pos - pi * page_size);
      } else {
        row = bhs * S + pos;
      }
      const char* ks = reinterpret_cast<const char*>(k) + row * row_bytes;
      const char* vs = reinterpret_cast<const char*>(v) + row * row_bytes;
      const uint32_t kd = kd0 + j * DMAX * (int)sizeof(KV), vd = vd0 + j * DMAX * (int)sizeof(KV);
      for (int c = lane_chunk; c < cpr; c += chunk_step) {
        const int o = c * unit;
        if (width == 16) {
          cp_async16(kd + o, ks + o);
          cp_async16(vd + o, vs + o);
        } else if (width == 8) {
          cp_async8(kd + o, ks + o);
          cp_async8(vd + o, vs + o);
        } else if (width == 4) {
          cp_async4(kd + o, ks + o);
          cp_async4(vd + o, vs + o);
        } else {  // D * elt not a multiple of 4 bytes: element c by a plain copy
          KV* kt = reinterpret_cast<KV*>(stage) + j * DMAX;
          kt[c] = k[row * D + c];
          kt[TILE + c] = v[row * D + c];
        }
      }
      if (QUANT && lane_chunk == 0) {
        cp_async4(sd0 + 4 * j, k_scale + row);
        cp_async4(sd0 + 4 * (BN + j), v_scale + row);
      }
    }
  };

  float m[ROWS], l[ROWS], acc[ROWS][VPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VPL; ++e) acc[r][e] = 0.f;
  }

  // this warp's KPW keys of tile t, from stage st, into its softmax state.
  // A step takes KS keys, one per group of LG lanes (8 channels a lane), so
  // a score is a sum over LG lanes; each lane keeps p and its P . V terms
  // for its own keys, and the groups' accumulators are summed once, after
  // the span. Branch-free over keys: a score is set by select, and a value
  // no row sees enters P . V as 0 (its p is 0 too), so bytes of keys never
  // copied reach no result.
  auto compute = [&](int t, int st) {
    const KV* kt = reinterpret_cast<const KV*>(smem + st * STAGE);
    const KV* vt = kt + TILE;
    const float* ksc = reinterpret_cast<const float*>(vt + TILE);
    const int j0 = warp * KPW + grp, base = t * BN + j0;  // this lane's key at step 0
    if (t * BN + warp * KPW >= key1) return;  // warp-uniform
    bool live[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      live[i] = base + i * KS < key1;
      if (SPARSE && live[i]) live[i] = live_b[(base + i * KS) / block_k] != 0;
    }
    float s[ROWS][STEPS];
    uint32_t seen[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      seen[r] = 0u;
#pragma unroll
      for (int i = 0; i < STEPS; ++i) s[r][i] = 0.f;
      if (r >= nrows) continue;  // block-uniform
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        float kv[VPL];
        load_vec<KV, VPL>(kv, kt + (j0 + i * KS) * DMAX + c0);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VPL; ++e) dot = fmaf(qr[r][e], kv[e], dot);
        s[r][i] = dot;
      }
#pragma unroll
      for (int o = LG / 2; o > 0; o >>= 1)  // within each lane group, all steps at once
#pragma unroll
        for (int i = 0; i < STEPS; ++i) s[r][i] += __shfl_xor_sync(0xffffffffu, s[r][i], o);
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const bool vis = live[i] && base + i * KS <= bound[r];
        const float dot = QUANT ? s[r][i] * ksc[j0 + i * KS] : s[r][i];
        s[r][i] = vis ? dot : -INFINITY;
        seen[r] |= (uint32_t)vis << i;
      }
    }
    uint32_t any = 0u;  // steps whose key some row sees, for this lane
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      any |= seen[r];
      if (!__any_sync(0xffffffffu, seen[r] != 0u)) {  // nothing this row sees here
#pragma unroll
        for (int i = 0; i < STEPS; ++i) s[r][i] = 0.f;
        continue;
      }
      float tmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < STEPS; ++i) tmax = fmaxf(tmax, s[r][i]);
#pragma unroll
      for (int o = 16; o >= LG; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[r], tmax);
      const float corr = expf(m[r] - m_new);  // 0 on the row's first visible key
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        s[r][i] = expf(s[r][i] - m_new);  // 0 where unseen
        psum += s[r][i];
      }
#pragma unroll
      for (int o = 16; o >= LG; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[r] = fmaf(l[r], corr, psum);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < VPL; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      float vv[VPL];
      load_vec<KV, VPL>(vv, vt + (j0 + i * KS) * DMAX + c0);
      const bool vis = any >> i & 1u;
      const float vsc = QUANT && vis ? ksc[BN + j0 + i * KS] : 1.f;
#pragma unroll
      for (int e = 0; e < VPL; ++e) vv[e] = vis ? vv[e] : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= nrows) break;
        const float p = QUANT ? s[r][i] * vsc : s[r][i];
#pragma unroll
        for (int e = 0; e < VPL; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  };

  // the ring: kStages - 1 tiles in flight ahead of the one computing
  int fetch_t = next_tile(t_begin), comp_t = fetch_t;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (fetch_t < t_end) {
      fetch(fetch_t, st);
      fetch_t = next_tile(fetch_t + 1);
    }
    cp_async_commit();
  }
  for (int it = 0; comp_t < t_end; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile `it` landed
    __syncthreads();               // everyone's; and stage it - 1 is consumed
    if (fetch_t < t_end) {
      fetch(fetch_t, (it + kStages - 1) % kStages);
      fetch_t = next_tile(fetch_t + 1);
    }
    cp_async_commit();
    compute(comp_t, it % kStages);
    comp_t = next_tile(comp_t + 1);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the merge

  // the warps' states -> shared memory, merged in warp order per (row, channel)
  float* mrg = reinterpret_cast<float*>(smem);  // [warp][row][DMAX]
  float* mrg_ml = mrg + kWarps * kRows * DMAX;  // [warp][row][2]
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nrows) break;
#pragma unroll
    for (int o = 16; o >= LG; o >>= 1)  // the lane groups' sums, in a fixed order
#pragma unroll
      for (int e = 0; e < VPL; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    if (lane < LG)
#pragma unroll
      for (int e = 0; e < VPL; ++e) mrg[(warp * kRows + r) * DMAX + c0 + e] = acc[r][e];
    if (lane == 0) {
      mrg_ml[(warp * kRows + r) * 2] = m[r];
      mrg_ml[(warp * kRows + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  const bool direct = n_live == 1;  // this block writes the output itself
  float* ws_acc = ws;                                           // [B*H][spans][rows][D]
  float* ws_ml = ws + (size_t)gridDim.x * n_spans * kRows * D;  // [B*H][spans][rows][2]
  for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mrg_ml[(w * kRows + r) * 2]);
    float sum_l = 0.f, sum_a = 0.f;
    if (mx > -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = mrg_ml[(w * kRows + r) * 2];
        if (mw > -INFINITY) {
          const float f = expf(mw - mx);
          sum_l = fmaf(mrg_ml[(w * kRows + r) * 2 + 1], f, sum_l);
          sum_a = fmaf(mrg[(w * kRows + r) * DMAX + c], f, sum_a);
        }
      }
    }
    if (direct) {
      store(out + (bhs * n + r) * D + c, sum_l > 0.f ? sum_a / sum_l : 0.f);
    } else {
      const size_t part = (bhs * n_spans + split) * kRows + r;
      ws_acc[part * D + c] = sum_a;
      if (c == 0) {
        ws_ml[part * 2] = mx;
        ws_ml[part * 2 + 1] = sum_l;
      }
    }
  }
  if (direct) return;

  // the last span block of this (b, h) to arrive merges the spans in span
  // order, each thread its elements: per chunk of 8 spans it loads every
  // (m, l, acc) at once (one trip to L2 a chunk), rescales its running sums
  // to the chunk's new maximum M, then adds the spans' terms e^(m - M) in
  // order (a span with no visible key has m = -inf, l = acc = 0: no term)
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
  const size_t part0 = bhs * n_spans * kRows;  // (span sp, row r) at part0 + sp * kRows + r
  for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    float mx = -INFINITY, sum_l = 0.f, sum_a = 0.f;
    for (int sp0 = 0; sp0 < n_live; sp0 += kChunk) {
      float ms[kChunk], ls[kChunk], as[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const size_t part = part0 + (size_t)(sp0 + u) * kRows + r;
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

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *lengths, *bitmap, *page_table;
  void *out, *ws, *counters;
  int B, H, n, S, D, n_blocks, block_k, page_size, n_pool;
  float sm_scale;
  cudaStream_t stream;
};

// spans of the grid: one per kSpan cache positions
int grid_spans(int S) { return (S + kSpan - 1) / kSpan; }

template <typename T, typename KV, int DMAX, bool SPARSE, bool PAGED>
cudaError_t launch(const Args& a) {
  auto kernel = a.n == 1 ? flash_decode_kernel<T, KV, DMAX, SPARSE, PAGED, 1>
                         : flash_decode_kernel<T, KV, DMAX, SPARSE, PAGED, kRows>;
  constexpr int smem = smem_bytes<KV, DMAX>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, grid_spans(a.S));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.bitmap),
      static_cast<const int*>(a.page_table), static_cast<T*>(a.out), static_cast<float*>(a.ws),
      static_cast<int*>(a.counters), a.H, a.n, a.S, a.D, a.n_blocks, a.block_k, a.page_size,
      a.n_pool, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, typename KV, bool SPARSE, bool PAGED>
cudaError_t dispatch_d(const Args& a) {
  if (a.D <= 64) return launch<T, KV, 64, SPARSE, PAGED>(a);
  if (a.D <= 128) return launch<T, KV, 128, SPARSE, PAGED>(a);
  return launch<T, KV, 256, SPARSE, PAGED>(a);
}

template <typename T, typename KV>
cudaError_t dispatch_layout(const Args& a) {
  const bool sparse = a.bitmap != nullptr, paged = a.page_table != nullptr;
  if (paged)
    return sparse ? dispatch_d<T, KV, true, true>(a) : dispatch_d<T, KV, false, true>(a);
  return sparse ? dispatch_d<T, KV, true, false>(a) : dispatch_d<T, KV, false, false>(a);
}

cudaError_t dispatch(const Args& a, int dtype, int quantized) {
  if (a.D <= 0 || a.D > 256) return cudaErrorInvalidValue;
  if (quantized && (a.k_scale == nullptr || a.v_scale == nullptr)) return cudaErrorInvalidValue;
  if (a.n > kRows) return cudaErrorInvalidValue;  // more rows run a tile arm
  if (grid_spans(a.S) > 1 && (a.ws == nullptr || a.counters == nullptr))
    return cudaErrorInvalidValue;
  if ((long long)a.B * a.H > 2147483647LL || grid_spans(a.S) > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return quantized ? dispatch_layout<float, int8_t>(a) : dispatch_layout<float, float>(a);
  if (dtype == 1)
    return quantized ? dispatch_layout<__nv_bfloat16, int8_t>(a)
                     : dispatch_layout<__nv_bfloat16, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Floats of the split-K workspace a call needs (0: none).
extern "C" long long flash_decode_workspace_floats(int B, int H, int S, int D) {
  const int spans = grid_spans(S);
  return spans > 1 ? (long long)B * H * spans * kRows * (D + 2) : 0;
}

// q [B,H,n,D] and out [B,H,n,D] of `dtype` (0 = float32, 1 = bfloat16),
// n <= 4, D <= 256; k/v [B,H,S,D] of that dtype, or int8 with `quantized` = 1 and
// k_scale / v_scale [B,H,S] float32; lengths [B] int32; bitmap [B,
// n_blocks] int32 over blocks of `block_k` positions, or null for none.
// Contiguous, 16-byte aligned. `workspace` holds
// flash_decode_workspace_floats() floats (the split-K partial states) and
// `counters` B*H int32 that are zero before the first call and that every
// call leaves zero (both may be null when the workspace size is 0); calls
// sharing `counters` must not run concurrently. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* lengths, const void* bitmap, void* out,
                                   int B, int H, int n, int S, int D, int dtype,
                                   int quantized, int n_blocks, int block_k,
                                   float sm_scale, void* stream, void* workspace,
                                   void* counters) {
  if (B <= 0 || H <= 0 || n <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (bitmap != nullptr && (block_k <= 0 || n_blocks < (S + block_k - 1) / block_k))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, lengths, bitmap, nullptr, out, workspace, counters,
               B, H, n, S, D, n_blocks, block_k, 1, 0, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, dtype, quantized);
}

// The paged variants: k_pages/v_pages [P, H, page_size, D] of `dtype`, or
// int8 with `quantized` = 1 and k_scale / v_scale [P, H, page_size]
// float32; page_table [B, n_pages] int32 of pool pages in [0, P) (an entry
// out of range traps); lengths [B] int32, clipped to [0, n_pages *
// page_size]; bitmap [B, n_pages] int32, one bit per table entry, or null.
// q/out, alignment, workspace, counters and return as
// flash_decode_launch (S = n_pages * page_size).
extern "C" int paged_flash_decode_launch(const void* q, const void* k_pages,
                                         const void* v_pages, const void* k_scale,
                                         const void* v_scale, const void* lengths,
                                         const void* page_table, const void* bitmap, void* out,
                                         int B, int H, int n, int P, int page_size,
                                         int n_pages, int D, int dtype, int quantized,
                                         float sm_scale, void* stream, void* workspace,
                                         void* counters) {
  if (B <= 0 || H <= 0 || n <= 0 || P <= 0 || page_size <= 0 || n_pages <= 0 ||
      page_table == nullptr)
    return (int)cudaErrorInvalidValue;
  // table positions are indexed in int
  if ((long long)n_pages * page_size > INT32_MAX) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, lengths, bitmap, page_table, out,
               workspace, counters, B, H, n, n_pages * page_size, D, n_pages, page_size,
               page_size, P, sm_scale, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, dtype, quantized);
}
