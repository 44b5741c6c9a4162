// Flash decode's multi-row arm above head dim 256 for Hopper (sm_90a):
// cached attention of a bf16 query chunk of n > 4 rows (the prefill chunk,
// the resume forward of a model whose heads are wider than 256) over a KV
// cache with per-row live lengths, on bf16 tensor cores. The step (n <= 4)
// runs wide_head.cu's split-K kernel; fp32 queries keep wide_head.cu's
// CUDA-core kernels; D <= 256 runs flash_decode_tile.cu.
//
// Replaces, at n > 4 with bf16 q and D > 256, the TPU kernels of
// `dalle_pytorch_tpu/ops/pallas_decode.py`:
//   * `_decode_kernel` (:76), plain and int8 arms (`flash_decode_attention`);
//   * `_sparse_decode_kernel` (:292, `block_sparse_flash_decode_attention`);
//   * `_paged_decode_kernel` (:446, `paged_flash_decode_attention`);
//   * `_sparse_paged_decode_kernel` (:552,
//     `block_sparse_paged_flash_decode_attention`), each with its int8 arm.
//
//   out[b,h,i,:] = softmax_j(q[b,h,i] . k[b,h,j] * scale) @ v[b,h,j]
//                  over j <= lengths[b] - n + i,  lengths clipped to [0, S],
//                  and (block-sparse) bitmap[b, j / block_k] != 0
//   (paged: k[b,h,j] = k_pages[page_table[b, j / page], h, j % page], S =
//   n_pages * page, block_k = page). A row with no visible key is zeros.
//
// What bounds it: every visible (row, key) pair costs 4 D flops and every
// key serves up to n rows, so at the resume forward (n = 1280 over 1281
// slots, D = 320) it is bound by operations (~67 GFLOP against ~105 MB of
// q, K, V and out). The kernel it replaces (wide_head.cu's 4-row
// `wide_decode_kernel`) held 4 query rows a block on CUDA cores and read K
// and V unstaged, so every K/V row crossed from L2 once per 4 query rows
// and per 256-column group (640 times at n = 1280, D = 320). The design
// joins two kernels of the port:
//   * from wide_head.cu's `wide_fwd_mma_kernel`: one block of 4 warps per
//     (column group, batch row x head, tile of 64 query rows), 16 rows a
//     warp, owning COLS = 192 output columns (the wrapper's plan,
//     `ops/wide_head.py:wide_tile_plan`); per 64-key tile, S = Q K^T over
//     all of D from 64-channel items through a cp.async ring of padded
//     64 x 72 bf16 tiles, with Q resident in shared memory while two blocks
//     still fit an SM (else streamed, one Q chunk beside each K chunk),
//     then O += P V from items of the group's 64-column V tiles; the
//     products are mma.sync.m16n8k16 on bf16 operands read by ldmatrix (V
//     through .trans), fp32 accumulators. A K/V row crosses from L2 once
//     per 64 query rows and column group (40 times at n = 1280, D = 320);
//   * from flash_decode_tile.cu, the cache: per-row causal bounds len - n
//     + i (S != n); the query tiles with the most key tiles launched first
//     (the slowest grid index, reversed); only keys some row of the block
//     sees are copied, tiles of dead blocks are never read, and every K
//     and V row no row of the block may see is zero-filled by the copy
//     itself (cp.async with a source size of 0), since a tensor core
//     computes 0 x NaN = NaN; page-table entries staged in shared memory,
//     an entry out of range trapping, a dead page's entry never followed;
//     int8 K/V tiles widened to bf16 in shared memory (exact), S's column
//     j times k_scale[j] and P's column j times v_scale[j] before the split;
//   * the copies cost issue slots beside the tensor cores, not bytes: a key
//     tile's 64 source rows (page table, bitmap) are found once into shared
//     memory, and a 16-byte copy path serves every D whose rows split into
//     16-byte pieces (a multiple of 8 channels in bf16, 16 in int8); the
//     causal select is a branch around the diagonal tiles only
//     (scripts/torch_wide_head_probe.py --ablate-tile, PERF.md);
//   * the arithmetic of flash_decode_tile.cu: S scaled in fp32 after the
//     product, P = 2^(x - m) in base 2 by ex2.approx, and P carried into
//     P V as the bf16 pair hi = bf16(P), lo = bf16(P - hi), two products
//     into one fp32 accumulator (P to ~16 bits, as the reference's fp32 P;
//     one bf16 P moved a resumed row's token across a top-k threshold).
//     `flash_decode_tile_plain` (ops/flash_decode.py) is this arithmetic
//     at any D; the only difference is the fp32 summation order of S over
//     the channel chunks;
//   * D is a runtime argument with no upper limit (the ring streams Q when
//     it is not resident); the channels past D are zero-filled in shared
//     memory by the copies, so no caller pads the cache. The bitmap and
//     the page table are runtime arguments (null when off): every variant
//     runs one code path, and tile boundaries depend on key positions only,
//     so an all-ones bitmap gives the plain variant's bits and the paged
//     layout gives the contiguous kernel's bits on the gathered view.
// Registers: a warp's O is 16 x COLS fp32 (COLS / 2 registers a thread)
// beside P's pair of A fragments (32); two blocks an SM cap a thread at
// 255 registers. At COLS = 256 (the forward's widest group) two of the four
// instances spilled (8 and 20 bytes, ptxas on the card), so a block owns
// 192 columns and D = 512 takes three groups (S formed three times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kT = 64;                 // query rows of a block, keys of a tile, channels of a chunk
constexpr int kLdt = kT + 8;           // a staged bf16 tile's row stride (conflict-free ldmatrix)
constexpr int kTileElems = kT * kLdt;  // bf16 elements of a staged tile (int8 tiles use its first 4 KB)
constexpr int kThreads = 128;          // 4 warps of 16 query rows
constexpr int kStages = 3, kResStages = 4;  // ring depth: Q streamed, Q resident
constexpr int kTableCache = 128;       // page-table entries a paged block stages in shared memory
constexpr int kStaticSmem = kTableCache * 4 + 2 * 64 * 8;  // table_s and rows_s (ops/wide_head.py)
constexpr int kSmemLimit = 232448;     // shared bytes a block may take (227 KB), static included
constexpr int kCols = 192;             // output columns a block owns (ops/wide_head.py TILE_COLS)
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory (the wrapper's `wide_tile_smem`): the resident Q
// tile [64][ldq] (ldq = D's 64-channel chunks + 8), the ring of STAGES
// slots of TILES staged tiles (1 with Q resident: a K chunk or a V tile; 2
// streamed: a K chunk and its Q chunk, or two V tiles), and for int8 the
// TILES bf16 tiles widened from the landed slot and the k and v scales of
// two key tiles.
__host__ __device__ constexpr int resident_ld(int D) { return (D + kT - 1) / kT * kT + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `unit` bytes global -> shared, zero-filled when !ok (cp.async with a source
// size of 0 reads nothing); below 4 bytes a plain copy of one element
__device__ __forceinline__ void copy_chunk(void* dst, const void* src, bool ok, int unit) {
  const uint32_t d = smem_addr(dst);
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
// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));  // the ring's barrier orders the reads after it
}

// the largest copy unit (16, 8, 4 bytes, else one element) that divides a
// row of `row_bytes`: 64-channel chunks then never straddle D
__device__ __forceinline__ int copy_unit(int row_bytes, int elt) {
  return row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : elt;
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

// Fragment layouts (PTX ISA, mma.m16n8k16): g = lane / 4, t = lane % 4;
//   A 16x16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8:  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8:  c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
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

__device__ __forceinline__ float ex2(float x) {  // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S += A B^T over one 64-channel chunk: this warp's 16 rows of `a` (from
// row ar, stride lda) against the 64 keys of the staged K tile `b`
__device__ __forceinline__ void chunk_product(float (&c)[8][4], const bf16* a, int lda, int ar,
                                              const bf16* b, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, a + (ar + (lane & 15)) * lda + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLdt + kc * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * np], af, bf[0], bf[1]);
      mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// O[:, 64 vt .. + 64) += P V_t: P as the pair (hi, lo) of A fragments over
// the tile's 64 keys, V_t a staged 64-key x 64-column tile
template <int NB>
__device__ __forceinline__ void pv_product(float (&acc)[NB][4], int vt, const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4], const bf16* t, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      uint32_t bf[4];
      ldsm_x4_t(bf, t + (kc * 16 + (lane & 15)) * kLdt + nd * 16 + (lane >> 4) * 8);
      float(&c0)[4] = acc[8 * vt + 2 * nd];
      float(&c1)[4] = acc[8 * vt + 2 * nd + 1];
      mma_bf16(c0, hi[kc], bf[0], bf[1]);
      mma_bf16(c1, hi[kc], bf[2], bf[3]);
      mma_bf16(c0, lo[kc], bf[0], bf[1]);
      mma_bf16(c1, lo[kc], bf[2], bf[3]);
    }
}

// an int8 tile (64 rows of 64 bytes at `raw`) widened to a bf16 tile
// (exact: an int8 value is a bf16 value)
__device__ __forceinline__ void widen(bf16* dst, const int8_t* raw) {
  for (int i = threadIdx.x; i < kT * kT / 8; i += kThreads) {
    const int j = i / (kT / 8), c = (i % (kT / 8)) * 8;
    const uint2 w8 = *reinterpret_cast<const uint2*>(raw + j * kT + c);
    const int8_t* e = reinterpret_cast<const int8_t*>(&w8);
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = pack_bf16((float)e[2 * u], (float)e[2 * u + 1]);
    *reinterpret_cast<uint4*>(dst + j * kLdt + c) = make_uint4(w[0], w[1], w[2], w[3]);
  }
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
  __device__ __forceinline__ bf16* next(Issue& issue) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(slot(fill));
    fill = fill + 1 == STAGES ? 0 : fill + 1;
    bf16* landed = slot(use);
    use = use + 1 == STAGES ? 0 : use + 1;
    return landed;
  }
};

// KV: cache type (bf16, or int8_t with scales); COLS: output columns a
// block owns (kCols); RES: the 64 x D query tile resident in shared memory. Grid
// (groups * B * H, ceil(n / 64)): x = bh * groups + group, so the groups
// of one query tile run side by side and share its K/V reads in L2; the
// query tile is reversed, so the tiles with the most keys start first.
// `bitmap` [B, n_blocks] (n_blocks >= ceil(S / block_k)) and `page_table`
// [B, S / page_size] are null when off.
template <typename KV, int COLS, bool RES>
__global__ void __launch_bounds__(kThreads, 2)
wide_decode_tile_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ lengths,
                        const int* __restrict__ bitmap, const int* __restrict__ page_table,
                        bf16* __restrict__ out, int H, int n, int S, int D, int groups,
                        int n_blocks, int block_k, int page_size, int n_pool, float sm_scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int ELT = (int)sizeof(KV);
  constexpr int NB = COLS / 8;                  // 8-column tiles of O
  constexpr int VT = COLS / kT;                 // 64-column V tiles of the group
  constexpr int TILES = RES ? 1 : 2;            // staged tiles a ring slot holds
  constexpr int STAGES = RES ? kResStages : kStages;
  constexpr int NV = RES ? VT : (VT + 1) / 2;   // V items a key tile
  extern __shared__ float4 smem4[];
  __shared__ int table_s[kTableCache];
  __shared__ long long rows_s[2][kT];

  const int group = blockIdx.x % groups, c0 = group * COLS;
  const int bh = blockIdx.x / groups, b = bh / H, h = bh % H;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kT;  // the query tiles with the most keys first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int len = min(max(lengths[b], 0), S);
  const int key1 = max(len - n + min(row0 + kT, n), 0);  // keys [0, key1) some row sees
  const int chunks = (D + kT - 1) / kT, per_tile = chunks + NV;
  const int ldq = resident_ld(D);
  // this warp's rows [wrow0, wrow0 + 16): the first one's bound, and the
  // keys [0, wkey1) some real row of the warp sees; this thread's rows
  // wrow0 + g and + 8 (accumulator layout)
  const int wrow0 = row0 + 16 * warp;
  const int wbound0 = len - n + wrow0;
  const int wkey1 = wrow0 < n ? max(len - n + min(wrow0 + 16, n), 0) : 0;
  const int bound_lo = wbound0 + g;
  const size_t bhs = (size_t)bh;
  const int* live_b = bitmap ? bitmap + (size_t)b * n_blocks : nullptr;
  const int* table_b = page_table ? page_table + (size_t)b * (S / page_size) : nullptr;

  bf16* qres = reinterpret_cast<bf16*>(smem4);  // RES: [64][ldq]
  Ring<STAGES, TILES> ring{qres + (RES ? kT * ldq : 0)};
  bf16* work = ring.slot(STAGES);  // int8: TILES widened tiles
  float* scales = reinterpret_cast<float*>(work + (QUANT ? TILES * kTileElems : 0));  // int8: [2][2][64]

  // the table entries of the block's pages, read once (an entry is only
  // checked and followed where a live key is copied from its page)
  if (table_b && key1 > 0) {
    const int pages = min((key1 - 1) / page_size + 1, kTableCache);
    for (int i = threadIdx.x; i < pages; i += kThreads) table_s[i] = table_b[i];
  }
  __syncthreads();  // table_s

  const int t_end = (key1 + kT - 1) / kT;
  // the first key tile at or after t with a live key below key1
  auto next_tile = [&](int t) {
    if (live_b) {
      for (; t < t_end; ++t) {
        const int last = min(t * kT + kT, key1) - 1;
        bool any = false;
        for (int blk = (t * kT) / block_k; blk <= last / block_k && !any; ++blk)
          any = live_b[blk] != 0;
        if (any) break;
      }
    }
    return t;
  };
  // rows_s[buf][j]: the row of k/v (and of the scales) holding key j of
  // key tile t, or -1 where no row of the block sees it
  auto find_rows = [&](int t, int buf) {
    if (threadIdx.x >= kT) return;
    const int pos = t * kT + threadIdx.x;
    long long row = -1;
    if (t < t_end && pos < key1 && !(live_b && live_b[pos / block_k] == 0)) {
      if (table_b) {
        const int pi = pos / page_size;
        const int page = pi < kTableCache ? table_s[pi] : table_b[pi];
        if (page < 0 || page >= n_pool) __trap();  // a corrupt table faults loudly
        row = ((long long)page * H + h) * page_size + (pos - pi * page_size);
      } else {
        row = (long long)bhs * S + pos;
      }
    }
    rows_s[buf][threadIdx.x] = row;
  };
  int ikt = next_tile(0), item = 0, ik = 0;  // the issuing cursor: key tile, item, ordinal
  find_rows(ikt, 0);

  // copies in pieces of the largest unit that divides a row (a power of
  // two per row: 2^lg), consecutive threads on consecutive pieces of a row
  const int q_unit = copy_unit(D * 2, 2), q_lg = 31 - __clz(kT * 2 / q_unit);
  const int kv_unit = copy_unit(D * ELT, ELT), kv_lg = 31 - __clz(kT * ELT / kv_unit);
  const bf16* qb = q + (bhs * n + row0) * D;
  // rows [row0, row0 + 64) x channels [ch0, ch0 + 64) of q -> dst (row
  // stride ld); zeros past n and past D
  auto stage_q = [&](bf16* dst, int ld, int ch0) {
    if (q_unit == 16) {  // the common case: a thread's piece of 8 channels is the same in every pass
      const int r0_ = threadIdx.x / 8, c = (threadIdx.x % 8) * 8;
      const bool in_d = ch0 + c < D;
#pragma unroll
      for (int pass = 0; pass < kT * 8 / kThreads; ++pass) {
        const int r = r0_ + pass * (kThreads / 8);
        const bool ok = in_d && row0 + r < n;
        cp_async16(dst + r * ld + c, ok ? qb + (size_t)r * D + ch0 + c : q, ok);
      }
      return;
    }
#pragma unroll 1
    for (int i = threadIdx.x; i < kT << q_lg; i += kThreads) {
      const int r = i >> q_lg, c = (i & ((1 << q_lg) - 1)) * (q_unit / 2);
      const bool ok = row0 + r < n && ch0 + c < D;
      copy_chunk(dst + r * ld + c, ok ? qb + (size_t)r * D + ch0 + c : q, ok, q_unit);
    }
  };
  // keys of the issuing tile (rows `rows`) x channels [ch0, ch0 + 64) of k
  // or v -> dst, in the storage type (bf16 rows of stride kLdt, int8 rows
  // of 64 bytes); zeros where no row of the block sees the key and past D
  auto stage_kv = [&](void* dst, const KV* src, const long long* rows, int ch0) {
    const int ld_bytes = QUANT ? kT : kLdt * 2;
    if (kv_unit == 16) {  // the common case: a thread's 16-byte piece is the same in every pass
      constexpr int PPR = kT * ELT / 16, ROWS = kThreads / PPR;  // pieces a row, rows a pass
      const int j0 = threadIdx.x / PPR, cb = (threadIdx.x % PPR) * 16;
      const bool in_d = ch0 * ELT + cb < D * ELT;
      const char* from = reinterpret_cast<const char*>(src) + ch0 * ELT + cb;
      char* to = static_cast<char*>(dst) + j0 * ld_bytes + cb;
#pragma unroll
      for (int pass = 0; pass < kT / ROWS; ++pass) {
        const long long row = rows[j0 + pass * ROWS];
        const bool ok = in_d && row >= 0;
        cp_async16(to + pass * ROWS * ld_bytes, ok ? from + row * (D * ELT) : from, ok);
      }
      return;
    }
#pragma unroll 1  // unrolled, the int8 instance with Q streamed spilled
    for (int i = threadIdx.x; i < kT << kv_lg; i += kThreads) {
      const int j = i >> kv_lg, cb = (i & ((1 << kv_lg) - 1)) * kv_unit;  // cb: byte offset in the chunk
      const long long row = rows[j];
      const bool ok = row >= 0 && ch0 * ELT + cb < D * ELT;
      const char* from = reinterpret_cast<const char*>(src) + (ok ? row * D * ELT + ch0 * ELT + cb : 0);
      copy_chunk(static_cast<char*>(dst) + j * ld_bytes + cb, from, ok, kv_unit);
    }
  };
  if (RES) {
    for (int c = 0; c < chunks; ++c) stage_q(qres + c * kT, ldq, c * kT);
  }
  cp_async_commit();  // (empty unless RES) completes before the first item
  __syncthreads();    // rows_s of the first tile

  // issue the next item into `dst`. The rows of the tile after the
  // issuing one are found when its last item is issued, into the other
  // buffer: a barrier (the ring's) passes before they are read, and every
  // read of that buffer's previous tile was issued a barrier earlier (a
  // tile has more items than the ring issues ahead)
  auto issue = [&](bf16* dst) {
    if (ikt < t_end) {
      const long long* rows = rows_s[ik & 1];
      if (item < chunks) {  // channels [64 item, + 64): K, and Q unless resident
        stage_kv(dst, k, rows, item * kT);
        if (!RES) stage_q(dst + kTileElems, kLdt, item * kT);
        if (QUANT && item == 0) {
          float* sc = scales + (ik & 1) * 2 * kT;
          const int j = threadIdx.x % kT;
          const long long row = rows[j];
          const float* from = threadIdx.x < kT ? k_scale : v_scale;
          copy_chunk(sc + (threadIdx.x / kT) * kT + j, from + (row < 0 ? 0 : row), row >= 0, 4);
        }
      } else {  // one (RES) or two 64-column V tiles of the group's columns
#pragma unroll
        for (int j = 0; j < TILES; ++j) {
          const int tile = TILES * (item - chunks) + j;
          if (tile < VT && c0 + tile * kT < D) stage_kv(dst + j * kTileElems, v, rows, c0 + tile * kT);
        }
      }
      if (++item == per_tile) {
        item = 0;
        ++ik;
        ikt = next_tile(ikt + 1);
        find_rows(ikt, ik & 1);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(ring.slot(s));

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  const float scale_log2 = sm_scale * kLog2e;
  const int r0 = 16 * warp;

  int kn = 0;  // the key tile's ordinal
  for (int kt = next_tile(0); kt < t_end; kt = next_tile(kt + 1), ++kn) {
    const int key0 = kt * kT;
    const bool active = key0 < wkey1;  // some row of this warp sees the tile (warp-uniform)
    // S = Q K^T over all of D: this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      bf16* st = ring.next(issue);
      const bf16* kt_tile = st;
      if (QUANT) {
        widen(work, reinterpret_cast<const int8_t*>(st));
        __syncthreads();
        kt_tile = work;
      }
      if (active) {
        if (RES)
          chunk_product(s, qres + c * kT, ldq, r0, kt_tile, lane);
        else
          chunk_product(s, st + kTileElems, kLdt, r0, kt_tile, lane);
      }
    }
    uint32_t hi[4][4], lo[4][4];
    if (active) {
      const float* ksc = scales + (kn & 1) * 2 * kT;  // int8: the tile's k, then v scales
      // which keys of the tile the bitmap leaves live (bit c: key key0 + c)
      uint64_t live = ~0ull;
      if (live_b) {
        const int p0 = key0 + lane, p1 = p0 + 32;
        const bool l0 = p0 < S && live_b[p0 / block_k] != 0;
        const bool l1 = p1 < S && live_b[p1 / block_k] != 0;
        live = (uint64_t)__ballot_sync(0xffffffffu, l0) |
               (uint64_t)__ballot_sync(0xffffffffu, l1) << 32;
      }
      // wholly visible to every row of the warp: no select (a branch around
      // the whole tile, so the tiles below the diagonal run no select code)
      const bool full = key0 + kT - 1 <= wbound0 && live == ~0ull;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nb][e] *= QUANT ? ksc[8 * nb + 2 * t4 + (e % 2)] * scale_log2 : scale_log2;
      if (!full) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * nb + 2 * t4 + (e % 2);
            if (!(key0 + c <= bound_lo + 8 * (e / 2) && (live >> c & 1ull))) s[nb][e] = -INFINITY;
          }
      }
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmax[e / 2] = fmaxf(tmax[e / 2], s[nb][e]);
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(tmax[r]));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet: add nothing
        corr[r] = ex2(m[r] - m_use);
        m[r] = m_new;
        tmax[r] = m_use;
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nb][e] = ex2(s[nb][e] - tmax[e / 2]);
          psum[e / 2] += s[nb][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], quad_sum(psum[r]));
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] *= corr[e / 2];
      // P (int8: times v_scale) as the A fragments of P V, the pair hi =
      // bf16(P), lo = bf16(P - hi); fragment u of keys 16 kc..: S tile
      // 2 kc + u / 2, elements 2 (u % 2) and + 1
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 16 * kc + 8 * (u / 2) + 2 * t4 + e;
            const float x = s[2 * kc + u / 2][2 * (u % 2) + e];
            p[e] = QUANT ? x * ksc[kT + c] : x;
          }
          hi[kc][u] = pack_bf16(p[0], p[1]);
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi[kc][u]);
          lo[kc][u] = pack_bf16(p[0] - __low2float(hv), p[1] - __high2float(hv));
        }
    }
    // O += P V over the group's columns
#pragma unroll
    for (int vi = 0; vi < NV; ++vi) {
      bf16* st = ring.next(issue);
      const bf16* vt_tiles = st;
      if (QUANT) {
#pragma unroll
        for (int j = 0; j < TILES; ++j)
          if (TILES * vi + j < VT && c0 + (TILES * vi + j) * kT < D)
            widen(work + j * kTileElems, reinterpret_cast<const int8_t*>(st + j * kTileElems));
        __syncthreads();
        vt_tiles = work;
      }
      if (active) {
#pragma unroll
        for (int j = 0; j < TILES; ++j) {
          const int tile = TILES * vi + j;
          if (tile < VT && c0 + tile * kT < D)  // columns past D: nothing to add
            pv_product(acc, tile < VT ? tile : 0, hi, lo, vt_tiles + j * kTileElems, lane);
        }
      }
    }
  }
  cp_async_wait<0>();

  // O / l for this thread's rows in the group's columns below D; a row
  // with no visible key is zeros
  const int dcols = min(D - c0, COLS);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + g + 8 * r;
    if (row >= n) continue;
    const float lr = l[r];
    bf16* o = out + (bhs * n + row) * D + c0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * nb + 2 * t4 + e;
        if (c < dcols) o[c] = __float2bfloat16(lr > 0.f ? acc[nb][2 * r + e] / lr : 0.f);
      }
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *lengths, *bitmap, *page_table;
  void* out;
  int B, H, n, S, D, groups, n_blocks, block_k, page_size, n_pool, smem;
  float sm_scale;
  cudaStream_t stream;
};

template <typename KV, int COLS, bool RES>
cudaError_t launch(const Args& a) {
  auto kernel = wide_decode_tile_kernel<KV, COLS, RES>;
  // the dynamic shared memory cap, raised once per instance and device to
  // the most a block may take beside the kernel's static shared memory
  // (each launch passes its own bytes, within that)
  static int cap[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    const int bytes = kSmemLimit - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    cap[dev] = bytes;
  }
  if (a.smem > cap[dev]) return cudaErrorInvalidValue;
  const dim3 grid(a.groups * a.B * a.H, (a.n + kT - 1) / kT);
  kernel<<<grid, kThreads, a.smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.bitmap),
      static_cast<const int*>(a.page_table), static_cast<bf16*>(a.out), a.H, a.n, a.S, a.D,
      a.groups, a.n_blocks, a.block_k, a.page_size, a.n_pool, a.sm_scale);
  return cudaGetLastError();
}

template <typename KV, int COLS>
cudaError_t launch_res(const Args& a, bool resident) {
  return resident ? launch<KV, COLS, true>(a) : launch<KV, COLS, false>(a);
}

template <typename KV>
cudaError_t launch_cols(const Args& a, int cols, bool resident) {
  if (cols == kCols) return launch_res<KV, kCols>(a, resident);
  return cudaErrorInvalidValue;
}

// the dynamic shared bytes of a launch (ops/wide_head.py wide_tile_smem)
long long smem_bytes(int D, bool resident, bool quant) {
  const int tiles = resident ? 1 : 2, stages = resident ? kResStages : kStages;
  long long bytes = 2LL * (resident ? kT * resident_ld(D) : 0) + 2LL * stages * tiles * kTileElems;
  if (quant) bytes += 2LL * tiles * kTileElems + 2 * 2 * kT * 4;
  return bytes;
}

}  // namespace

// q/out [B,H,n,D] bfloat16 (any D, any n >= 1; the wrapper sends n > 4 at
// D > 256); k/v [B,H,S,D] bfloat16, or int8 with `quantized` = 1 and
// k_scale / v_scale [B,H,S] float32; with `page_table` [B, S / page_size]
// int32 of pool pages in [0, n_pool), k/v (and the scales) are pools
// [n_pool, H, page_size, D] (an entry out of range traps); `bitmap` [B,
// n_blocks] int32 over blocks of `block_k` positions (one per page-table
// entry when paged), or null; lengths [B] int32. Contiguous, 16-byte
// aligned. The plan (ops/wide_head.py:wide_tile_plan): `cols` (192)
// output columns a block, Q `resident` or streamed, `smem` dynamic shared
// bytes (checked against the plan's own). Launches on `stream` and returns
// cudaGetLastError() (0 = launched) or an argument error.
extern "C" int wide_decode_tile_launch(const void* q, const void* k, const void* v,
                                       const void* k_scale, const void* v_scale,
                                       const void* lengths, const void* bitmap,
                                       const void* page_table, void* out, int B, int H, int n,
                                       int S, int D, int n_blocks, int block_k, int page_size,
                                       int n_pool, int quantized, int cols, int resident, int smem,
                                       float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || S <= 0 || D <= 0 || cols != kCols)
    return (int)cudaErrorInvalidValue;
  const int groups = (D + cols - 1) / cols;
  if ((long long)groups * B * H > 2147483647LL || (n + kT - 1) / kT > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem != smem_bytes(D, resident != 0, quantized != 0) || smem + kStaticSmem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (quantized && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (bitmap != nullptr && (block_k <= 0 || n_blocks < (S + block_k - 1) / block_k))
    return (int)cudaErrorInvalidValue;
  if (page_table != nullptr && (page_size <= 0 || S % page_size != 0 || n_pool <= 0))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, lengths, bitmap, page_table, out,
               B, H, n, S, D, groups, n_blocks, block_k, page_size > 0 ? page_size : 1, n_pool, smem,
               sm_scale, static_cast<cudaStream_t>(stream)};
  return (int)(quantized ? launch_cols<int8_t>(a, cols, resident != 0)
                         : launch_cols<bf16>(a, cols, resident != 0));
}
