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
// D is any multiple of 16 up to 128 (an instance each; the lane split
// takes D / VEC chunks a row and ceil(D / 32) channels a lane, with no
// power of two assumed). fp32 accumulation whatever the input type;
// output in q's type; int8 K/V
// read as k_int8 * k_scale[b,h,j] in fp32. A query row with no visible key
// (which callers never produce) is written as zeros.
//
// What bounds it: at decode (n = 1) every cache element is used once, so
// the kernel is bound by the bytes of live K/V it reads, 2*B*H*len*D*elt
// per call (elt = 1 for int8, plus 8 bytes of scales per position); at the
// prefill chunk each K/V tile serves kWarps query rows.
// Design:
//   * one thread block per (query tile of kWarps rows, head, batch row);
//     the block reads lengths[b] itself and loops only over the KV tiles
//     its rows can see, so dead cache positions are neither loaded nor
//     computed (the Pallas kernel's length skip);
//   * each KV tile (kBlockN positions) is staged in shared memory as fp32
//     with 16-byte coalesced loads. The variants differ only in that load:
//     the int8 arm loads 16 int8 values per thread and multiplies by the
//     position's scale, so no dequantized copy of the cache is ever written
//     to device memory; the block-sparse arm skips a tile whose keys are
//     all dead (neither loaded nor computed) and, in a partly live tile,
//     stages zeros for the dead keys and masks their scores;
//   * the paged variants keep the same 64-key tiles and tile order: once
//     per tile the block resolves each key's pool row through the table
//     into shared memory (one table read per key, not per 16-byte load),
//     then loads as the contiguous kernel does. Keys past the block's last
//     visible position (the tail of a live page holds a previous owner's
//     bytes; pages past the row's last one are not the row's) and keys on
//     dead pages are staged as zeros, never loaded, and masked. So the
//     paged kernel on a pool gives the contiguous kernel's bits on the
//     gathered view, for any page size;
//   * one warp per query row keeps an fp32 online softmax (m, l) and an
//     fp32 accumulator, ceil(D/32) output channels per lane. The softmax
//     arithmetic is one code path for every variant (explicit fmaf), so an
//     all-ones bitmap reproduces the plain kernel bit for bit;
//   * no tensor cores yet. At n = 1 only one warp of four computes and
//     B*H = 64 blocks under-fill 132 SMs: split-K over the cache
//     (flash-decoding), TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // query rows per block, one warp each
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// T: q/out type; KV: cache type (T, or int8_t with scales); SPARSE: read
// the block bitmap; PAGED: k/v/scales are pools read through page_table
// [B, S / page_size] (S = the table's positions), pages of `page_size`
// positions, `n_pool` pages.
template <typename T, typename KV, int D, int BN, bool SPARSE, bool PAGED>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ lengths,
                    const int* __restrict__ bitmap, const int* __restrict__ page_table,
                    T* __restrict__ out, int H, int n, int S, int n_blocks, int block_k,
                    int page_size, int n_pool, float sm_scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int KSTRIDE = D + 1;           // padded: lanes read distinct banks
  constexpr int VEC = 16 / sizeof(KV);     // elements per 16-byte load
  constexpr int PER_LANE = (D + 31) / 32;  // output channels per lane
  constexpr int KEYS_PER_LANE = BN / 32;   // scores per lane per tile
  static_assert(D % 16 == 0 && BN % 32 == 0 && D % VEC == 0, "tile shape");

  __shared__ float ks[BN * KSTRIDE];
  __shared__ float vs[BN * D];
  __shared__ float qs[kWarps * D];
  __shared__ float ps[kWarps * BN];
  __shared__ bool key_live[SPARSE ? BN : 1];
  __shared__ int key_row[PAGED ? BN : 1];  // pool row of each key, -1 = not loaded

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = tile * kWarps + warp;
  const int len = min(max(lengths[b], 0), S);
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * n * D;
  const int* live_b = SPARSE ? bitmap + (size_t)b * n_blocks : nullptr;
  const int* table_b = PAGED ? page_table + (size_t)b * (S / page_size) : nullptr;

  for (int e = threadIdx.x; e < kWarps * D; e += kThreads) {
    const int r = tile * kWarps + e / D;
    qs[e] = r < n ? to_float(qb[(size_t)r * D + e % D]) * sm_scale : 0.f;
  }

  // last visible cache position of this warp's row and of the block's
  // widest row (the tile loop runs to the latter)
  const int bound = len - n + row;
  const int block_bound = len - n + min(tile * kWarps + kWarps, n) - 1;
  const int n_tiles = block_bound >= 0 ? block_bound / BN + 1 : 0;

  float m = -INFINITY, l = 0.f, acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int base = t * BN;
    if (SPARSE) {
      // skip the tile when no bitmap block covering its in-range keys is
      // live (the same decision in every thread of the block)
      const int last = min(base + BN - 1, block_bound);
      bool any = false;
      for (int blk = base / block_k; blk <= last / block_k; ++blk) any |= live_b[blk] != 0;
      if (!any) continue;
    }
    if (PAGED) {
      // key_row of the previous tile was read before its second barrier;
      // the barrier below publishes this tile's
      for (int j = threadIdx.x; j < BN; j += kThreads) {
        const int pos = base + j;
        int r = -1;
        if (pos <= block_bound && (!SPARSE || live_b[pos / block_k] != 0)) {
          const int page = table_b[pos / page_size];
          if (page < 0 || page >= n_pool) __trap();  // a corrupt table faults loudly
          r = (page * H + h) * page_size + pos % page_size;
        }
        key_row[j] = r;
      }
    }
    __syncthreads();  // previous tile consumed; q staged on the first pass
    for (int c = threadIdx.x; c < BN * (D / VEC); c += kThreads) {
      const int j = c / (D / VEC), d0 = (c % (D / VEC)) * VEC;
      const int pos = base + j;
      // the key's row in k/v [rows, D] and in the scales [rows]
      size_t kv_row = bh * S + pos;
      bool live = pos < S;
      if (PAGED) {
        live = key_row[j] >= 0;
        kv_row = (size_t)key_row[j];
      } else if (SPARSE) {
        live = live && live_b[pos / block_k] != 0;
      }
      if (SPARSE && d0 == 0) key_live[j] = live;
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = make_uint4(0, 0, 0, 0);
      float ksc = 0.f, vsc = 0.f;
      if (live) {
        kraw = *reinterpret_cast<const uint4*>(k + kv_row * D + d0);
        vraw = *reinterpret_cast<const uint4*>(v + kv_row * D + d0);
        if (QUANT) {
          ksc = k_scale[kv_row];
          vsc = v_scale[kv_row];
        }
      }
      const KV* kv = reinterpret_cast<const KV*>(&kraw);
      const KV* vv = reinterpret_cast<const KV*>(&vraw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * KSTRIDE + d0 + e] = QUANT ? to_float(kv[e]) * ksc : to_float(kv[e]);
        vs[j * D + d0 + e] = QUANT ? to_float(vv[e]) * vsc : to_float(vv[e]);
      }
    }
    __syncthreads();
    if (row < n && base <= bound) {  // warp-uniform
      const float* qrow = qs + warp * D;
      float s[KEYS_PER_LANE];
      float tmax = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < KEYS_PER_LANE; ++kk) {
        const int j = lane + 32 * kk;
        const float* krow = ks + j * KSTRIDE;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], krow[d], dot);
        bool visible = base + j <= bound;
        if (SPARSE) visible = visible && key_live[j];
        s[kk] = visible ? dot : -INFINITY;
        tmax = fmaxf(tmax, s[kk]);
      }
      // without a bitmap key `base` is visible, so m_new is finite; with
      // one, a row may see no live key in this tile and skips it. corr is
      // 0 on the row's first visible tile (m = -inf)
      const float m_new = fmaxf(m, warp_max(tmax));
      if (!SPARSE || m_new > -INFINITY) {  // warp-uniform
        const float corr = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int kk = 0; kk < KEYS_PER_LANE; ++kk) {
          const float p = expf(s[kk] - m_new);
          ps[warp * BN + lane + 32 * kk] = p;
          psum += p;
        }
        l = fmaf(l, corr, warp_sum(psum));
        __syncwarp();
        const int jmax = min(BN, bound - base + 1);
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) acc[i] *= corr;
        for (int j = 0; j < jmax; ++j) {
          const float p = ps[warp * BN + j];
#pragma unroll
          for (int i = 0; i < PER_LANE; ++i)
            if (lane + 32 * i < D) acc[i] = fmaf(p, vs[j * D + lane + 32 * i], acc[i]);
        }
        m = m_new;
        __syncwarp();  // ps is rewritten on the next tile
      }
    }
  }

  if (row < n) {
    T* orow = out + (bh * n + row) * D;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      if (lane + 32 * i < D) store(orow + lane + 32 * i, l > 0.f ? acc[i] / l : 0.f);
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *lengths, *bitmap, *page_table;
  void* out;
  int B, H, n, S, n_blocks, block_k, page_size, n_pool;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D, bool SPARSE, bool PAGED>
cudaError_t launch(const Args& a) {
  constexpr int BN = D > 64 ? 32 : 64;  // keeps static shared memory < 48 KB
  const dim3 grid((a.n + kWarps - 1) / kWarps, a.H, a.B);
  flash_decode_kernel<T, KV, D, BN, SPARSE, PAGED><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.bitmap),
      static_cast<const int*>(a.page_table), static_cast<T*>(a.out), a.H, a.n, a.S,
      a.n_blocks, a.block_k, a.page_size, a.n_pool, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, typename KV, bool SPARSE, bool PAGED>
cudaError_t dispatch_d(const Args& a, int D) {
  switch (D) {
    case 16: return launch<T, KV, 16, SPARSE, PAGED>(a);
    case 32: return launch<T, KV, 32, SPARSE, PAGED>(a);
    case 48: return launch<T, KV, 48, SPARSE, PAGED>(a);
    case 64: return launch<T, KV, 64, SPARSE, PAGED>(a);
    case 80: return launch<T, KV, 80, SPARSE, PAGED>(a);
    case 96: return launch<T, KV, 96, SPARSE, PAGED>(a);
    case 112: return launch<T, KV, 112, SPARSE, PAGED>(a);
    case 128: return launch<T, KV, 128, SPARSE, PAGED>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
cudaError_t dispatch_layout(const Args& a, int D) {
  const bool sparse = a.bitmap != nullptr, paged = a.page_table != nullptr;
  if (paged)
    return sparse ? dispatch_d<T, KV, true, true>(a, D) : dispatch_d<T, KV, false, true>(a, D);
  return sparse ? dispatch_d<T, KV, true, false>(a, D) : dispatch_d<T, KV, false, false>(a, D);
}

template <typename T>
cudaError_t dispatch_variant(const Args& a, int D, bool quantized) {
  return quantized ? dispatch_layout<T, int8_t>(a, D) : dispatch_layout<T, T>(a, D);
}

cudaError_t dispatch(const Args& a, int D, int dtype, int quantized) {
  if (quantized && (a.k_scale == nullptr || a.v_scale == nullptr)) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_variant<float>(a, D, quantized != 0);
  if (dtype == 1) return dispatch_variant<__nv_bfloat16>(a, D, quantized != 0);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,n,D] and out [B,H,n,D] of `dtype` (0 = float32, 1 = bfloat16);
// k/v [B,H,S,D] of that dtype, or int8 with `quantized` = 1 and k_scale /
// v_scale [B,H,S] float32; lengths [B] int32; bitmap [B, n_blocks] int32
// over blocks of `block_k` positions, or null for none. Contiguous,
// 16-byte aligned. Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* lengths, const void* bitmap, void* out,
                                         int B, int H, int n, int S, int D, int dtype,
                                         int quantized, int n_blocks, int block_k,
                                         float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || S <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (bitmap != nullptr && (block_k <= 0 || n_blocks < (S + block_k - 1) / block_k))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, lengths, bitmap, nullptr, out, B, H, n, S,
               n_blocks, block_k, 1, 0, sm_scale, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, D, dtype, quantized);
}

// The paged variants: k_pages/v_pages [P, H, page_size, D] of `dtype`, or
// int8 with `quantized` = 1 and k_scale / v_scale [P, H, page_size]
// float32; page_table [B, n_pages] int32 of pool pages in [0, P) (an entry
// out of range traps); lengths [B] int32, clipped to [0, n_pages *
// page_size]; bitmap [B, n_pages] int32, one bit per table entry, or null.
// q/out, alignment and return as flash_decode_launch.
extern "C" int paged_flash_decode_launch(const void* q, const void* k_pages,
                                         const void* v_pages, const void* k_scale,
                                         const void* v_scale, const void* lengths,
                                         const void* page_table, const void* bitmap, void* out,
                                         int B, int H, int n, int P, int page_size,
                                         int n_pages, int D, int dtype, int quantized,
                                         float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || P <= 0 || page_size <= 0 || n_pages <= 0 || B > 65535 ||
      H > 65535 || page_table == nullptr)
    return (int)cudaErrorInvalidValue;
  // pool rows and table positions are indexed in int
  if ((long long)P * H * page_size > INT32_MAX || (long long)n_pages * page_size > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, lengths, bitmap, page_table, out,
               B, H, n, n_pages * page_size, n_pages, page_size, page_size, P, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return (int)dispatch(a, D, dtype, quantized);
}
