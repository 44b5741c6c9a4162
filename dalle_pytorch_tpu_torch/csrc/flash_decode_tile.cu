// Flash decode's tile arm for Hopper (sm_90a): cached attention of a query
// chunk of n > 4 rows (the prefill chunk, the resume forward) over a KV
// cache with per-row live lengths, on bf16 tensor cores. The step (n = 1)
// and n = 2-4 stay with flash_decode.cu's split-K instances; fp32 queries
// at n > 4 run flash_decode_tile_f32.cu (fp32 arithmetic on CUDA cores).
//
// Replaces, at n > 4 with bf16 q and D <= 256, the TPU kernels of
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
// slots, D = 64) it is bound by operations (~13 GFLOP against ~21 MB of
// K/V), and at the prefill chunk (n = 257) by bytes and latency: each block
// sees at most 5 key tiles, so the time goes to loading K/V and Q and to
// the pipeline's fill. The multi-row arm it replaces ran on CUDA cores with
// 4 query rows a block, so every K/V tile crossed from L2 to shared memory
// once per 4 rows. The design, FlashAttention-2's forward over a cache:
//   * one block per (batch row x head, tile of 128 query rows), eight warps
//     of 16 rows each (two blocks an SM at D <= 64); the block loops over
//     64-key tiles from key 0 up to the last key its last row sees (len - n
//     + row0 + 127), so a K/V tile crosses from L2 to shared memory once
//     per 128 rows: at n = 1280 that traffic, not the tensor cores, is what
//     64-row blocks of four warps were held by (scripts/
//     torch_decode_tile_probe.py --ablate). No split-K and no workspace.
//     The query tiles with the most key tiles are launched first (the
//     slowest grid index, reversed);
//   * S = Q K^T and O += P V on bf16 tensor cores (mma.sync.m16n8k16, fp32
//     accumulators), operands by ldmatrix from padded row-major tiles (V
//     through .trans, so no transposed copy exists); Q's fragments stay in
//     registers at 128 channels and are read from shared memory at 64 and
//     256 (at 64 two blocks an SM cap a thread at 128 registers);
//   * tiles arrive by cp.async (16-byte chunks where the row's D * elt
//     allows, else 8 or 4, else a plain element copy) into a two-stage ring
//     (the next tile in flight while one computes), rows read through the
//     page table in the paged variants (entries staged in shared memory;
//     an entry out of range traps; a dead page's entry is never followed).
//     Only keys some row of the block sees are copied: tiles past the last
//     row's bound and tiles of dead blocks are never read;
//   * every K and V row of a tile that no row of the block may see (the
//     tail of the last tile, the tail of a live page past the length, the
//     rows of dead blocks) is zero-filled in shared memory by the copy
//     itself (cp.async with a source size of 0): a tensor core computes
//     0 x NaN = NaN, so masking P alone would let stale or poisoned bytes
//     reach the result;
//   * the scale multiplies S in fp32 after the product (q stays bf16 as
//     given); P is formed in base 2, 2^(s * scale * log2(e) - m) by
//     ex2.approx, as the flash-attention forward does, and enters P V as a
//     pair of bf16 operands, hi = bf16(P) and lo = bf16(P - hi), two
//     products into one fp32 accumulator: P carries ~16 bits into P V, as
//     the reference's fp32 P does (one bf16 P, 8 bits, moved a resumed
//     row's logits across a top-k threshold; ROADMAP Queue 3). The softmax
//     state (m, l) and O stay fp32. The causal (and
//     bitmap) select runs only on tiles a warp's bounds cut: wholly visible
//     tiles skip it. A row whose maximum is still -inf takes 0 in its
//     place, so it adds nothing and is written as zeros;
//   * int8 K/V: an int8 value is exact in bf16, so each landed tile is
//     widened to bf16 in shared memory, S's column j is multiplied by
//     k_scale[j] and P's column j by v_scale[j] before P is split (the
//     scales of rows no row sees are zero-filled with them);
//   * D is a runtime argument up to 256, with instances for at most 64,
//     128 and 256 channels; the channels past D are zero in shared memory.
//     At 256 the output columns are split over two blocks (128 each, S
//     computed by both) so a warp's O is 16 x 128 fp32.
// Tile boundaries depend on key positions only, never on S, the layout or
// the bitmap, and every variant runs one code path, so an all-ones bitmap
// gives the plain variant's bits and the paged kernel gives the contiguous
// kernel's bits on the gathered view. `flash_decode_tile_plain`
// (ops/flash_decode.py) is this arithmetic on the CPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;          // 16 query rows each: a K/V tile serves 128 rows
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 16 * kWarps;   // query rows of a block
constexpr int kBN = 64;          // keys of a tile (ops/flash_decode.py DECODE_TILE)
constexpr int kStages = 2;       // cp.async ring depth
constexpr int kTableCache = 128; // page-table entries a paged block stages in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// the output columns a block computes: all of them up to 128 channels, half
// at 256 (two blocks per query tile)
template <int DMAX>
__host__ __device__ constexpr int out_cols() { return DMAX > 128 ? 128 : DMAX; }

// blocks an SM must hold: two at DMAX 64 (the register cap: 128 a thread),
// one above
template <int DMAX>
__host__ __device__ constexpr int min_blocks() { return DMAX == 64 ? 2 : 1; }

// shared memory: the Q tile (bf16, row stride DMAX + 8), the ring of K/V
// tiles in their storage type (bf16 rows padded as Q's for ldmatrix; int8
// rows unpadded, then their fp32 scales) and, for int8, one bf16 tile of K
// and of V widened from the ring
template <typename KV, int DMAX>
struct Layout {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int DC = out_cols<DMAX>();
  static constexpr int LDK = DMAX + 8;  // bf16 row strides: conflict-free ldmatrix
  static constexpr int LDV = DC + 8;
  static constexpr int RK = QUANT ? DMAX : LDK;  // staged row strides, in elements
  static constexpr int RV = QUANT ? DC : LDV;
  static constexpr int Q_BYTES = kBM * LDK * 2;
  static constexpr int STAGE = kBN * (RK + RV) * (int)sizeof(KV) + (QUANT ? 2 * kBN * 4 : 0);
  static constexpr int WORK = QUANT ? kBN * (LDK + LDV) * 2 : 0;
  static constexpr int TOTAL = Q_BYTES + kStages * STAGE + WORK;
};

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
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// KV: cache type (bf16, or int8_t with scales); DMAX: channels of the
// instance (D <= DMAX at run time); SPARSE: read the block bitmap; PAGED:
// k/v/scales are pools read through page_table [B, S / page_size]. Grid
// (B * H * DMAX / out_cols, query tiles), the query tile reversed.
template <typename KV, int DMAX, bool SPARSE, bool PAGED>
__global__ void __launch_bounds__(kThreads, min_blocks<DMAX>())
flash_decode_tile_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                         const KV* __restrict__ v, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, const int* __restrict__ lengths,
                         const int* __restrict__ bitmap, const int* __restrict__ page_table,
                         bf16* __restrict__ out, int H, int n, int S, int D, int block_k,
                         int page_size, int n_pool, float sm_scale) {
  using L = Layout<KV, DMAX>;
  constexpr bool QUANT = L::QUANT;
  constexpr int DC = L::DC, LDK = L::LDK, LDV = L::LDV, RK = L::RK, RV = L::RV;
  constexpr int GROUPS = DMAX / DC;
  // Q's fragments in registers at 128 channels; at 64 they are read from
  // shared memory, as at 256, to hold P's bf16 pair within the 128
  // registers two blocks an SM leave a thread
  constexpr bool QREG = DMAX == 128;
  constexpr int KSTEPS = DMAX / 16;   // k-steps of S = Q K^T
  constexpr int NT = kBN / 8;         // 8-key column tiles of S
  constexpr int OT = DC / 8;          // 8-column tiles of O
  constexpr int ELT = (int)sizeof(KV);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int table_s[PAGED ? kTableCache : 1];

  const int bh = blockIdx.x / GROUPS, grp = blockIdx.x % GROUPS;
  const int qtile = gridDim.y - 1 - blockIdx.y;  // the query tiles with the most keys first
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(max(lengths[b], 0), S);
  const int row0 = qtile * kBM;
  const int key1 = max(len - n + min(row0 + kBM, n), 0);  // keys [0, key1) some row sees
  const int col0 = grp * DC, dcols = min(D - col0, DC);  // this block's output columns
  // this warp's rows [wrow0, wrow0 + 16): the first one's bound, and the
  // keys [0, wkey1) some real row of the warp sees
  const int wrow0 = row0 + 16 * warp;
  const int wbound0 = len - n + wrow0;
  const int wkey1 = wrow0 < n ? max(len - n + min(wrow0 + 16, n), 0) : 0;
  // this thread's rows wrow0 + g and + 8 (accumulator layout)
  const int bound_lo = wbound0 + lane / 4;
  const size_t bhs = (size_t)bh;
  const int* live_b = SPARSE ? bitmap + (size_t)b * ((S + block_k - 1) / block_k) : nullptr;
  const int* table_b = PAGED ? page_table + (size_t)b * (S / page_size) : nullptr;

  bf16* q_s = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + L::Q_BYTES;
  bf16* work_k = reinterpret_cast<bf16*>(ring + kStages * L::STAGE);  // int8 only
  bf16* work_v = work_k + kBN * LDK;

  if (D < DMAX) {  // the channels past D stay zero (the copies never write them)
    for (int i = threadIdx.x; i < kStages * L::STAGE / 16; i += kThreads)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  }
  // the Q tile: rows past n and channels past D zero
  for (int i = threadIdx.x; i < kBM * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i - r * DMAX;
    q_s[r * LDK + c] = row0 + r < n && c < D ? q[(bhs * n + row0 + r) * D + c] : __float2bfloat16(0.f);
  }
  // the table entries of the block's pages, read once (an entry is only
  // checked and followed where a live key is copied from its page)
  if (PAGED && key1 > 0) {
    const int pages = min((key1 - 1) / page_size + 1, kTableCache);
    for (int i = threadIdx.x; i < pages; i += kThreads) table_s[i] = table_b[i];
  }
  __syncthreads();

  const bf16* q_w = q_s + (16 * warp + lane % 16) * LDK + (lane / 16) * 8;  // A fragments
  uint32_t qf[QREG ? KSTEPS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(qf[kk], q_w + kk * 16);
  }

  const int t_end = (key1 + kBN - 1) / kBN;
  // SPARSE: the first tile at or after t with a live key below key1
  auto next_tile = [&](int t) {
    if (SPARSE) {
      for (; t < t_end; ++t) {
        const int last = min(t * kBN + kBN, key1) - 1;
        bool any = false;
        for (int blk = (t * kBN) / block_k; blk <= last / block_k && !any; ++blk)
          any = live_b[blk] != 0;
        if (any) break;
      }
    }
    return t;
  };
  // the row of k/v (and of the scales) holding key `pos`, or -1 where no
  // row of the block sees it
  auto src_row = [&](int pos) -> long long {
    if (pos >= key1 || (SPARSE && live_b[pos / block_k] == 0)) return -1;
    if (PAGED) {
      const int pi = pos / page_size;
      const int page = pi < kTableCache ? table_s[pi] : table_b[pi];
      if (page < 0 || page >= n_pool) __trap();  // a corrupt table faults loudly
      return ((long long)page * H + h) * page_size + (pos - pi * page_size);
    }
    return (long long)bhs * S + pos;
  };

  // copies: a K row of D * elt bytes and a V row of this block's dcols
  // columns, in chunks of `unit` bytes (16 where the row allows, else 8 or
  // 4, else one element); threads over (row, chunk)
  const int row_bytes = D * ELT;
  const int unit = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : ELT;
  const int cpr_k = row_bytes / unit, cpr_v = dcols * ELT / unit;
  const char* kbytes = reinterpret_cast<const char*>(k);
  const char* vbytes = reinterpret_cast<const char*>(v) + (size_t)col0 * ELT;
  auto fetch = [&](int t, int st) {
    KV* ks = reinterpret_cast<KV*>(ring + st * L::STAGE);
    KV* vs = ks + kBN * RK;
    for (int i = threadIdx.x; i < kBN * cpr_k; i += kThreads) {
      const int j = i / cpr_k, c = i - j * cpr_k;
      const long long row = src_row(t * kBN + j);
      copy_chunk(reinterpret_cast<char*>(ks + j * RK) + c * unit,
                 kbytes + (row < 0 ? 0 : row * row_bytes) + c * unit, row >= 0, unit);
    }
    for (int i = threadIdx.x; i < kBN * cpr_v; i += kThreads) {
      const int j = i / cpr_v, c = i - j * cpr_v;
      const long long row = src_row(t * kBN + j);
      copy_chunk(reinterpret_cast<char*>(vs + j * RV) + c * unit,
                 vbytes + (row < 0 ? 0 : row * row_bytes) + c * unit, row >= 0, unit);
    }
    if (QUANT) {
      float* sc = reinterpret_cast<float*>(vs + kBN * RV);
      for (int j = threadIdx.x; j < kBN; j += kThreads) {
        const long long row = src_row(t * kBN + j);
        copy_chunk(sc + j, k_scale + (row < 0 ? 0 : row), row >= 0, 4);
        copy_chunk(sc + kBN + j, v_scale + (row < 0 ? 0 : row), row >= 0, 4);
      }
    }
  };
  // int8: the landed tile of stage st widened to bf16 (exact) in work_k/v
  auto widen = [&](int st) {
    const int8_t* ks = reinterpret_cast<const int8_t*>(ring + st * L::STAGE);
    const int8_t* vs = ks + kBN * RK;
    for (int i = threadIdx.x; i < kBN * (DMAX + DC) / 8; i += kThreads) {
      const bool is_k = i < kBN * DMAX / 8;
      const int cols = is_k ? DMAX : DC, e0 = (is_k ? i : i - kBN * DMAX / 8) * 8;
      const int j = e0 / cols, c = e0 - j * cols;
      const uint2 raw = *reinterpret_cast<const uint2*>((is_k ? ks : vs) + e0);
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = pack_bf16((float)e[2 * u], (float)e[2 * u + 1]);
      *reinterpret_cast<uint4*>((is_k ? work_k + j * LDK : work_v + j * LDV) + c) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ot][e] = 0.f;
  const float scale_log2 = sm_scale * kLog2e;

  // this warp's 16 rows against key tile t (K rows at kt, V rows at vt,
  // bf16; int8 scales at sc, else null)
  auto compute = [&](int t, const bf16* kt, const bf16* vt, const float* sc) {
    if (t * kBN >= wkey1) return;  // no row of this warp sees the tile (warp-uniform)
    float s[NT][4];
#pragma unroll
    for (int nb = 0; nb < NT; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk * 16 >= D) break;  // the channels past D are zero
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = qf[kk][u];
      } else {
        ldsm_x4(a, q_w + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (np * 16 + lane % 8 + (lane / 16) * 8) * LDK + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    // which keys of the tile the bitmap leaves live (bit c: key t*kBN + c)
    uint64_t live = ~0ull;
    if (SPARSE) {
      const int p0 = t * kBN + lane, p1 = p0 + 32;
      const bool l0 = p0 < S && live_b[p0 / block_k] != 0;
      const bool l1 = p1 < S && live_b[p1 / block_k] != 0;
      live = (uint64_t)__ballot_sync(0xffffffffu, l0) |
             (uint64_t)__ballot_sync(0xffffffffu, l1) << 32;
    }
    // wholly visible to every row of the warp: no select
    const bool full = t * kBN + kBN - 1 <= wbound0 && live == ~0ull;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NT; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nb + 2 * (lane % 4) + (e % 2);
        float x = s[nb][e] * (QUANT ? sc[c] * scale_log2 : scale_log2);
        if (!full && !(t * kBN + c <= bound_lo + 8 * (e / 2) && (live >> c & 1ull))) x = -INFINITY;
        s[nb][e] = x;
        tmax[e / 2] = fmaxf(tmax[e / 2], x);
      }
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
    for (int nb = 0; nb < NT; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = ex2(s[nb][e] - tmax[e / 2]);
        psum[e / 2] += s[nb][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], quad_sum(psum[r]));
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ot][e] *= corr[e / 2];
    // P (int8: times v_scale) as the A fragments of P V, in bf16 as a pair
    // hi = bf16(P), lo = bf16(P - hi), both multiplied into the same fp32
    // accumulator (P to ~16 bits, as the reference's fp32 P); fragment
    // a_u of keys 16 kp..: S tile 2 kp + u / 2, elements 2 (u % 2) and + 1
    uint32_t hi[kBN / 16][4], lo[kBN / 16][4];
#pragma unroll
    for (int kp = 0; kp < kBN / 16; ++kp)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 16 * kp + 8 * (u / 2) + 2 * (lane % 4) + e;
          const float x = s[2 * kp + u / 2][2 * (u % 2) + e];
          p[e] = QUANT ? x * sc[kBN + c] : x;
        }
        hi[kp][u] = pack_bf16(p[0], p[1]);
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[kp][u]);
        lo[kp][u] = pack_bf16(p[0] - __low2float(h), p[1] - __high2float(h));
      }
    // O += P V
#pragma unroll
    for (int kp = 0; kp < kBN / 16; ++kp) {
#pragma unroll
      for (int cp = 0; cp < OT / 2; ++cp) {
        if (cp * 16 >= dcols) break;
        uint32_t bv[4];
        ldsm_x4_t(bv, vt + (kp * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDV + cp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * cp], hi[kp], bv[0], bv[1]);
        mma_bf16(acc[2 * cp + 1], hi[kp], bv[2], bv[3]);
        mma_bf16(acc[2 * cp], lo[kp], bv[0], bv[1]);
        mma_bf16(acc[2 * cp + 1], lo[kp], bv[2], bv[3]);
      }
    }
  };

  // the ring: kStages - 1 tiles in flight ahead of the one computing
  int fetch_t = next_tile(0), comp_t = fetch_t;
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
    __syncthreads();               // everyone's; and stage it - 1 (and work_k/v) is consumed
    if (fetch_t < t_end) {
      fetch(fetch_t, (it + kStages - 1) % kStages);
      fetch_t = next_tile(fetch_t + 1);
    }
    cp_async_commit();
    const int st = it % kStages;
    if constexpr (QUANT) {
      widen(st);
      __syncthreads();
      const float* sc = reinterpret_cast<const float*>(ring + st * L::STAGE + kBN * (RK + RV));
      compute(comp_t, work_k, work_v, sc);
    } else {
      const bf16* kt = reinterpret_cast<const bf16*>(ring + st * L::STAGE);
      compute(comp_t, kt, kt + kBN * RK, nullptr);
    }
    comp_t = next_tile(comp_t + 1);
  }
  cp_async_wait<0>();

  // O / l for this thread's rows; a row with no visible key is zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + lane / 4 + 8 * r;
    if (row >= n) continue;
    const float lr = l[r];
    bf16* o = out + (bhs * n + row) * D + col0;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * ot + 2 * (lane % 4) + e;
        if (c < dcols) o[c] = __float2bfloat16(lr > 0.f ? acc[ot][2 * r + e] / lr : 0.f);
      }
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *lengths, *bitmap, *page_table;
  void* out;
  int B, H, n, S, D, block_k, page_size, n_pool;
  float sm_scale;
  cudaStream_t stream;
};

template <typename KV, int DMAX, bool SPARSE, bool PAGED>
cudaError_t launch(const Args& a) {
  auto kernel = flash_decode_tile_kernel<KV, DMAX, SPARSE, PAGED>;
  constexpr int smem = Layout<KV, DMAX>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H * (DMAX / out_cols<DMAX>()), (a.n + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.bitmap),
      static_cast<const int*>(a.page_table), static_cast<bf16*>(a.out), a.H, a.n, a.S, a.D,
      a.block_k, a.page_size, a.n_pool, a.sm_scale);
  return cudaGetLastError();
}

template <typename KV, bool SPARSE, bool PAGED>
cudaError_t dispatch_d(const Args& a) {
  if (a.D <= 64) return launch<KV, 64, SPARSE, PAGED>(a);
  if (a.D <= 128) return launch<KV, 128, SPARSE, PAGED>(a);
  return launch<KV, 256, SPARSE, PAGED>(a);
}

template <typename KV>
cudaError_t dispatch_layout(const Args& a) {
  const bool sparse = a.bitmap != nullptr, paged = a.page_table != nullptr;
  if (paged) return sparse ? dispatch_d<KV, true, true>(a) : dispatch_d<KV, false, true>(a);
  return sparse ? dispatch_d<KV, true, false>(a) : dispatch_d<KV, false, false>(a);
}

cudaError_t dispatch(const Args& a, int quantized) {
  if (a.D <= 0 || a.D > 256) return cudaErrorInvalidValue;
  if (quantized && (a.k_scale == nullptr || a.v_scale == nullptr)) return cudaErrorInvalidValue;
  if ((long long)a.B * a.H * 2 > 2147483647LL || (a.n + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  return quantized ? dispatch_layout<int8_t>(a) : dispatch_layout<bf16>(a);
}

}  // namespace

// q [B,H,n,D] and out [B,H,n,D] bfloat16, D <= 256; k/v [B,H,S,D]
// bfloat16, or int8 with `quantized` = 1 and k_scale / v_scale [B,H,S]
// float32; lengths [B] int32; bitmap [B, ceil(S / block_k)] int32 over
// blocks of `block_k` positions, or null for none. Contiguous, 16-byte
// aligned. Any n >= 1 (the wrapper sends n > 4). Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int flash_decode_tile_launch(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* lengths, const void* bitmap, void* out, int B,
                                        int H, int n, int S, int D, int quantized, int block_k,
                                        float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (bitmap != nullptr && block_k <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, lengths, bitmap, nullptr, out,
               B, H, n, S, D, block_k, 1, 0, sm_scale, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, quantized);
}

// The paged variants: k_pages/v_pages [P, H, page_size, D] bfloat16, or int8
// with `quantized` = 1 and k_scale / v_scale [P, H, page_size] float32;
// page_table [B, n_pages] int32 of pool pages in [0, P) (an entry out of
// range traps); lengths [B] int32, clipped to [0, n_pages * page_size];
// bitmap [B, n_pages] int32, one bit per table entry, or null. q/out,
// alignment and return as flash_decode_tile_launch.
extern "C" int paged_flash_decode_tile_launch(const void* q, const void* k_pages,
                                              const void* v_pages, const void* k_scale,
                                              const void* v_scale, const void* lengths,
                                              const void* page_table, const void* bitmap,
                                              void* out, int B, int H, int n, int P,
                                              int page_size, int n_pages, int D, int quantized,
                                              float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || P <= 0 || page_size <= 0 || n_pages <= 0 ||
      page_table == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((long long)n_pages * page_size > INT32_MAX) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, lengths, bitmap, page_table, out,
               B, H, n, n_pages * page_size, D, page_size, page_size, P, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, quantized);
}
