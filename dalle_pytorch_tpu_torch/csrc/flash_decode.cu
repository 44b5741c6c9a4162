// Flash-decode attention for Hopper (sm_90a): cached attention of a query
// chunk over a fixed-shape KV cache with per-row live lengths, in three
// variants of one kernel body.
//
// Replaces the TPU kernels of `dalle_pytorch_tpu/ops/pallas_decode.py`:
//   * `_decode_kernel`, plain arm (`flash_decode_attention`);
//   * `_decode_kernel`, int8 arm (`quantized=True`: K/V int8 with fp32
//     per-(position, head) scales, dequantized in the kernel);
//   * `_sparse_decode_kernel` (`block_sparse_flash_decode_attention`): a
//     per-(row, KV block) bitmap of blocks that may be read, with its int8
//     arm.
//
//   out[b,h,i,:] = softmax_j(q[b,h,i] . k[b,h,j] * scale) @ v[b,h,j]
//                  over j <= lengths[b] - n + i,  lengths clipped to [0, S],
//                  and (block-sparse) bitmap[b, j / block_k] != 0
//
// fp32 accumulation whatever the input type; output in q's type; int8 K/V
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
// the block bitmap.
template <typename T, typename KV, int D, int BN, bool SPARSE>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ lengths,
                    const int* __restrict__ bitmap, T* __restrict__ out, int H, int n,
                    int S, int n_blocks, int block_k, float sm_scale) {
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

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = tile * kWarps + warp;
  const int len = min(max(lengths[b], 0), S);
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * n * D;
  const KV* kb = k + bh * S * D;
  const KV* vb = v + bh * S * D;
  const int* live_b = SPARSE ? bitmap + (size_t)b * n_blocks : nullptr;

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
    __syncthreads();  // previous tile consumed; q staged on the first pass
    for (int c = threadIdx.x; c < BN * (D / VEC); c += kThreads) {
      const int j = c / (D / VEC), d0 = (c % (D / VEC)) * VEC;
      const int pos = base + j;
      bool live = pos < S;
      if (SPARSE) {
        live = live && live_b[pos / block_k] != 0;
        if (d0 == 0) key_live[j] = live;
      }
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = make_uint4(0, 0, 0, 0);
      float ksc = 0.f, vsc = 0.f;
      if (live) {
        kraw = *reinterpret_cast<const uint4*>(kb + (size_t)pos * D + d0);
        vraw = *reinterpret_cast<const uint4*>(vb + (size_t)pos * D + d0);
        if (QUANT) {
          ksc = k_scale[bh * S + pos];
          vsc = v_scale[bh * S + pos];
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
  const void *q, *k, *v, *k_scale, *v_scale, *lengths, *bitmap;
  void* out;
  int B, H, n, S, n_blocks, block_k;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D, bool SPARSE>
cudaError_t launch(const Args& a) {
  constexpr int BN = D > 64 ? 32 : 64;  // keeps static shared memory < 48 KB
  const dim3 grid((a.n + kWarps - 1) / kWarps, a.H, a.B);
  flash_decode_kernel<T, KV, D, BN, SPARSE><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.lengths), static_cast<const int*>(a.bitmap),
      static_cast<T*>(a.out), a.H, a.n, a.S, a.n_blocks, a.block_k, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, typename KV, bool SPARSE>
cudaError_t dispatch_d(const Args& a, int D) {
  switch (D) {
    case 16: return launch<T, KV, 16, SPARSE>(a);
    case 32: return launch<T, KV, 32, SPARSE>(a);
    case 64: return launch<T, KV, 64, SPARSE>(a);
    case 128: return launch<T, KV, 128, SPARSE>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_variant(const Args& a, int D, bool quantized) {
  const bool sparse = a.bitmap != nullptr;
  if (quantized)
    return sparse ? dispatch_d<T, int8_t, true>(a, D) : dispatch_d<T, int8_t, false>(a, D);
  return sparse ? dispatch_d<T, T, true>(a, D) : dispatch_d<T, T, false>(a, D);
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
  if (quantized && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (bitmap != nullptr && (block_k <= 0 || n_blocks < (S + block_k - 1) / block_k))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, lengths, bitmap, out, B, H, n, S,
               n_blocks, block_k, sm_scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch_variant<float>(a, D, quantized != 0);
  if (dtype == 1) return (int)dispatch_variant<__nv_bfloat16>(a, D, quantized != 0);
  return (int)cudaErrorInvalidValue;
}
