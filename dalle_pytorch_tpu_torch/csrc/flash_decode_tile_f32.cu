// Flash decode's fp32 tile arm for Hopper (sm_90a): cached attention of an
// fp32 query chunk of n > 4 rows (the prefill chunk and the resume forward
// of a model served in fp32) over a KV cache with per-row live lengths, in
// fp32 arithmetic on CUDA cores. bf16 queries at n > 4 run the tensor-core
// tile arm of flash_decode_tile.cu; n <= 4 runs flash_decode.cu's split-K
// instances.
//
// Replaces, at n > 4 with fp32 q and D <= 256, the TPU kernels of
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
// slots, D = 64) it is bound by operations at the card's fp32 rate (~13
// GFLOP against ~42 MB of fp32 K/V). The arm it replaces (flash_decode.cu's
// 4-row instance) read every K/V tile from L2 into shared memory once per 4
// query rows, 320 times over at n = 1280. The design, that of the CUDA-core
// fp32 flash-attention forward flash_attention.cu had before its TF32
// kernel, over a cache:
//   * one block per (batch row x head, tile of 64 query rows), 256 threads
//     in a 16 x 16 grid; the block loops over key tiles from key 0 up to
//     the last key its last row sees (len - n + row0 + 63), so a K/V tile
//     crosses from L2 to shared memory once per 64 rows. The query tiles
//     with the most key tiles are launched first (the slowest grid index,
//     reversed). No split-K and no workspace;
//   * S = Q K^T and O += P V in fp32 with register micro-tiles: each thread
//     owns 4 rows x (keys / 16) of S and 4 rows x D/16 columns of O, reading
//     Q, K, P and V rows from shared memory as float4 (rows padded to D + 4,
//     conflict-free); a row's softmax reduces over the 16 lanes of its
//     half-warp;
//   * the arithmetic is the reference's: q times the scale in fp32 before
//     the product, P = e^(S - m) by expf, P and V in fp32, the state (m, l)
//     and O fp32 -- so the fp32 decode limit (2e-5 of the largest output,
//     summation order only) holds. A row whose maximum is still -inf takes
//     0 in its place, so it adds nothing and is written as zeros;
//   * tiles arrive by cp.async (16-byte chunks where the row's D * elt
//     allows, else 8 or 4, else a plain element copy) into a two-stage ring
//     (the next tile in flight while one computes), rows read through the
//     page table in the paged variants (entries staged in shared memory;
//     an entry out of range traps; a dead page's entry is never followed).
//     Only keys some row of the block sees are copied: tiles past the last
//     row's bound and tiles of dead blocks are never read, and every other
//     K and V row that no row of the block may see is zero-filled by the
//     copy itself (a source size of 0), so stale or poisoned bytes never
//     reach a product;
//   * int8 K/V: each landed tile is dequantized into an fp32 work tile
//     (k_int8 * k_scale, v_int8 * v_scale, as the reference does), then the
//     same products run;
//   * D is a runtime argument up to 256, with instances for at most 64, 128
//     and 256 channels; the channels past D are zero in shared memory. Keys
//     a tile: 64, and 32 at 256 channels, where two stages of 64 fp32 keys
//     beside the Q tile pass the 227 KB a block may hold.
// Tile boundaries depend on key positions only, never on S, the layout or
// the bitmap, and every variant runs one code path, so an all-ones bitmap
// gives the plain variant's bits and the paged kernel gives the contiguous
// kernel's bits on the gathered view. `flash_decode_tile_f32_plain`
// (ops/flash_decode.py) is this arithmetic on the CPU.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16: tx over keys and output columns, ty over rows
constexpr int kBM = 64;           // query rows of a block (ops/flash_decode.py DECODE_TILE_F32_ROWS)
constexpr int kStages = 2;        // cp.async ring depth
constexpr int kTableCache = 128;  // page-table entries a paged block stages in shared memory

// keys of a tile (ops/flash_decode.py tile_f32_keys)
template <int DMAX>
__host__ __device__ constexpr int tile_keys() { return DMAX <= 128 ? 64 : 32; }

// shared memory: the Q tile and the P tile (fp32, Q rows padded to DMAX + 4,
// P rows to keys + 4), the ring of K/V tiles in their storage type (fp32
// rows padded as Q's; int8 rows of DMAX bytes, then their fp32 scales) and,
// for int8, one fp32 tile of K and of V dequantized from the ring
template <typename KV, int DMAX>
struct Layout {
  static constexpr bool QUANT = sizeof(KV) == 1;
  static constexpr int BN = tile_keys<DMAX>();
  static constexpr int LD = DMAX + 4;  // fp32 row stride
  static constexpr int LDP = BN + 4;
  static constexpr int RS = QUANT ? DMAX : LD;  // staged row stride, in elements
  static constexpr int Q_BYTES = kBM * LD * 4;
  static constexpr int P_BYTES = kBM * LDP * 4;
  static constexpr int STAGE = 2 * BN * RS * (int)sizeof(KV) + (QUANT ? 2 * BN * 4 : 0);
  static constexpr int WORK = QUANT ? 2 * BN * LD * 4 : 0;
  static constexpr int TOTAL = Q_BYTES + P_BYTES + kStages * STAGE + WORK;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// reductions over the 16 lanes of a half-warp (the threads of one ty)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// KV: cache type (float, or int8_t with scales); DMAX: channels of the
// instance (D <= DMAX at run time); SPARSE: read the block bitmap; PAGED:
// k/v/scales are pools read through page_table [B, S / page_size]. Grid
// (B * H, query tiles), the query tile reversed.
template <typename KV, int DMAX, bool SPARSE, bool PAGED>
__global__ void __launch_bounds__(kThreads, DMAX == 64 ? 2 : 1)
flash_decode_tile_f32_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                             const KV* __restrict__ v, const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale, const int* __restrict__ lengths,
                             const int* __restrict__ bitmap, const int* __restrict__ page_table,
                             float* __restrict__ out, int H, int n, int S, int D, int block_k,
                             int page_size, int n_pool, float sm_scale) {
  using L = Layout<KV, DMAX>;
  constexpr bool QUANT = L::QUANT;
  constexpr int BN = L::BN, LD = L::LD, LDP = L::LDP, RS = L::RS;
  constexpr int JN = BN / 16;    // keys of a tile per thread: tx + 16 j
  constexpr int DJ = DMAX / 16;  // output columns per thread: tx * DJ + j
  constexpr int ELT = (int)sizeof(KV);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int table_s[PAGED ? kTableCache : 1];

  const int bh = blockIdx.x;
  const int qtile = gridDim.y - 1 - blockIdx.y;  // the query tiles with the most keys first
  const int b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int len = min(max(lengths[b], 0), S);
  const int row0 = qtile * kBM;
  const int key1 = max(len - n + min(row0 + kBM, n), 0);  // keys [0, key1) some row sees
  const size_t bhs = (size_t)bh;
  const int* live_b = SPARSE ? bitmap + (size_t)b * ((S + block_k - 1) / block_k) : nullptr;
  const int* table_b = PAGED ? page_table + (size_t)b * (S / page_size) : nullptr;

  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + kBM * LD;
  unsigned char* ring = smem + L::Q_BYTES + L::P_BYTES;
  float* work_k = reinterpret_cast<float*>(ring + kStages * L::STAGE);  // int8 only
  float* work_v = work_k + BN * LD;

  if (D < DMAX) {  // the channels past D stay zero (the copies never write them)
    for (int i = threadIdx.x; i < kStages * L::STAGE / 16; i += kThreads)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  }
  // the Q tile times the scale, as the reference scales q: rows past n and
  // channels past D zero
  for (int i = threadIdx.x; i < kBM * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i - r * DMAX;
    q_s[r * LD + c] = row0 + r < n && c < D ? q[(bhs * n + row0 + r) * D + c] * sm_scale : 0.f;
  }
  // the table entries of the block's pages, read once (an entry is only
  // checked and followed where a live key is copied from its page)
  if (PAGED && key1 > 0) {
    const int pages = min((key1 - 1) / page_size + 1, kTableCache);
    for (int i = threadIdx.x; i < pages; i += kThreads) table_s[i] = table_b[i];
  }
  __syncthreads();

  const int t_end = (key1 + BN - 1) / BN;
  // SPARSE: the first tile at or after t with a live key below key1
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

  // copies: a K and a V row of D * elt bytes each, in chunks of `unit`
  // bytes (16 where the row allows, else 8 or 4, else one element);
  // threads over (row, chunk)
  const int row_bytes = D * ELT;
  const int unit = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : ELT;
  const int cpr = row_bytes / unit;
  const char* kbytes = reinterpret_cast<const char*>(k);
  const char* vbytes = reinterpret_cast<const char*>(v);
  auto fetch = [&](int t, int st) {
    KV* ks = reinterpret_cast<KV*>(ring + st * L::STAGE);
    KV* vs = ks + BN * RS;
    for (int i = threadIdx.x; i < BN * cpr; i += kThreads) {
      const int j = i / cpr, c = i - j * cpr;
      const long long row = src_row(t * BN + j);
      const size_t off = (row < 0 ? 0 : row * row_bytes) + c * unit;
      copy_chunk(reinterpret_cast<char*>(ks + j * RS) + c * unit, kbytes + off, row >= 0, unit);
      copy_chunk(reinterpret_cast<char*>(vs + j * RS) + c * unit, vbytes + off, row >= 0, unit);
    }
    if (QUANT) {
      float* sc = reinterpret_cast<float*>(vs + BN * RS);
      for (int j = threadIdx.x; j < BN; j += kThreads) {
        const long long row = src_row(t * BN + j);
        copy_chunk(sc + j, k_scale + (row < 0 ? 0 : row), row >= 0, 4);
        copy_chunk(sc + BN + j, v_scale + (row < 0 ? 0 : row), row >= 0, 4);
      }
    }
  };
  // int8: the landed tile of stage st dequantized to fp32 in work_k/v
  auto dequantize = [&](int st) {
    const int8_t* ks = reinterpret_cast<const int8_t*>(ring + st * L::STAGE);
    const int8_t* vs = ks + BN * RS;
    const float* sc = reinterpret_cast<const float*>(vs + BN * RS);
    for (int i = threadIdx.x; i < 2 * BN * DMAX / 4; i += kThreads) {
      const bool is_k = i < BN * DMAX / 4;
      const int e0 = (is_k ? i : i - BN * DMAX / 4) * 4;
      const int j = e0 / DMAX, c = e0 - j * DMAX;
      const char4 raw = *reinterpret_cast<const char4*>((is_k ? ks : vs) + e0);
      const float s = sc[is_k ? j : BN + j];
      *reinterpret_cast<float4*>((is_k ? work_k : work_v) + j * LD + c) =
          make_float4(raw.x * s, raw.y * s, raw.z * s, raw.w * s);
    }
  };

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  // this thread's rows row0 + ty + 16 i: their bounds (rows past n see nothing)
  int bound[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    bound[i] = r < n ? len - n + r : -1;
  }
  const int d_end = (D + 3) & ~3;  // the channels past D are zero: stop at the 4 holding D - 1

  // the block's rows against key tile t (K rows at kt, V rows at vt, fp32)
  auto compute = [&](int t, const float* kt, const float* vt) {
    float s[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < d_end; d += 4) {
      float4 av[4], bv[JN];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < JN; ++j) bv[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          float x = s[i][j];
          x = fmaf(av[i].x, bv[j].x, x);
          x = fmaf(av[i].y, bv[j].y, x);
          x = fmaf(av[i].z, bv[j].z, x);
          x = fmaf(av[i].w, bv[j].w, x);
          s[i][j] = x;
        }
    }
    bool live[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int pos = t * BN + tx + 16 * j;
      live[j] = !SPARSE || (pos < S && live_b[pos / block_k] != 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        if (!(live[j] && t * BN + tx + 16 * j <= bound[i])) s[i][j] = -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet: add nothing
      const float corr = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float p = expf(s[i][j] - m_use);  // 0 where unseen
        p_s[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = fmaf(l[i], corr, half_warp_sum(psum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a row of P is written and read by the same 16 lanes
#pragma unroll 2
    for (int c = 0; c < BN; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DJ];
#pragma unroll
        for (int u = 0; u < DJ / 4; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(vt + (c + cc) * LD + tx * DJ + 4 * u);
          vv[4 * u] = x.x; vv[4 * u + 1] = x.y; vv[4 * u + 2] = x.z; vv[4 * u + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pc = comp(pv[i], cc);
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
        }
      }
    }
  };

  // the ring: one tile in flight ahead of the one computing
  int fetch_t = next_tile(0), comp_t = fetch_t;
  if (fetch_t < t_end) {
    fetch(fetch_t, 0);
    fetch_t = next_tile(fetch_t + 1);
  }
  cp_async_commit();
  for (int it = 0; comp_t < t_end; ++it) {
    cp_async_wait_all();  // this thread's copies of tile `it` landed
    __syncthreads();      // everyone's; and stage it - 1 (and work_k/v, P) is consumed
    if (fetch_t < t_end) {
      fetch(fetch_t, (it + 1) % kStages);
      fetch_t = next_tile(fetch_t + 1);
    }
    cp_async_commit();
    const int st = it % kStages;
    if constexpr (QUANT) {
      dequantize(st);
      __syncthreads();
      compute(comp_t, work_k, work_v);
    } else {
      const float* kt = reinterpret_cast<const float*>(ring + st * L::STAGE);
      compute(comp_t, kt, kt + BN * RS);
    }
    comp_t = next_tile(comp_t + 1);
  }
  cp_async_wait_all();

  // O / l for this thread's rows; a row with no visible key is zeros
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
    const float lr = l[i];
    float* o = out + (bhs * n + r) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx * DJ + j;
      if (c < D) o[c] = lr > 0.f ? acc[i][j] / lr : 0.f;
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
  auto kernel = flash_decode_tile_f32_kernel<KV, DMAX, SPARSE, PAGED>;
  constexpr int smem = Layout<KV, DMAX>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.n + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.bitmap),
      static_cast<const int*>(a.page_table), static_cast<float*>(a.out), a.H, a.n, a.S, a.D,
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
  if ((long long)a.B * a.H > 2147483647LL || (a.n + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  return quantized ? dispatch_layout<int8_t>(a) : dispatch_layout<float>(a);
}

}  // namespace

// q [B,H,n,D] and out [B,H,n,D] float32, D <= 256; k/v [B,H,S,D] float32,
// or int8 with `quantized` = 1 and k_scale / v_scale [B,H,S] float32;
// lengths [B] int32; bitmap [B, ceil(S / block_k)] int32 over blocks of
// `block_k` positions, or null for none. Contiguous, 16-byte aligned. Any n
// >= 1 (the wrapper sends n > 4). Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_decode_tile_f32_launch(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* lengths, const void* bitmap, void* out,
                                            int B, int H, int n, int S, int D, int quantized,
                                            int block_k, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (bitmap != nullptr && block_k <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, lengths, bitmap, nullptr, out,
               B, H, n, S, D, block_k, 1, 0, sm_scale, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, quantized);
}

// The paged variants: k_pages/v_pages [P, H, page_size, D] float32, or int8
// with `quantized` = 1 and k_scale / v_scale [P, H, page_size] float32;
// page_table [B, n_pages] int32 of pool pages in [0, P) (an entry out of
// range traps); lengths [B] int32, clipped to [0, n_pages * page_size];
// bitmap [B, n_pages] int32, one bit per table entry, or null. q/out,
// alignment and return as flash_decode_tile_f32_launch.
extern "C" int paged_flash_decode_tile_f32_launch(const void* q, const void* k_pages,
                                                  const void* v_pages, const void* k_scale,
                                                  const void* v_scale, const void* lengths,
                                                  const void* page_table, const void* bitmap,
                                                  void* out, int B, int H, int n, int P,
                                                  int page_size, int n_pages, int D,
                                                  int quantized, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || P <= 0 || page_size <= 0 || n_pages <= 0 ||
      page_table == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((long long)n_pages * page_size > INT32_MAX) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, lengths, bitmap, page_table, out,
               B, H, n, n_pages * page_size, D, page_size, page_size, P, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, quantized);
}
