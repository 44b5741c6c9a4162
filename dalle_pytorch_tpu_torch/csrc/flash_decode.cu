// Flash-decode attention for Hopper (sm_90a): cached attention of a query
// chunk over a fixed-shape KV cache with per-row live lengths.
//
// Replaces the TPU kernel `dalle_pytorch_tpu/ops/pallas_decode.py:
// _decode_kernel` (plain arm, reached through `flash_decode_attention`).
//
//   out[b,h,i,:] = softmax_j(q[b,h,i] . k[b,h,j] * scale) @ v[b,h,j]
//                  over j <= lengths[b] - n + i,  lengths clipped to [0, S]
//
// fp32 accumulation whatever the input type; output in the input type.
// A query row with no visible key (lengths[b] - n + i < 0, which callers
// never produce) is written as zeros.
//
// What bounds it: at decode (n = 1) every cache element is used once, so
// the kernel is bound by the bytes of live K/V it reads, 2*B*H*len*D*elt
// per call; at the prefill chunk each K/V tile serves kWarps query rows.
// Design:
//   * one thread block per (query tile of kWarps rows, head, batch row);
//     the block reads lengths[b] itself and loops only over the KV tiles
//     its rows can see, so dead cache positions are neither loaded nor
//     computed (the Pallas kernel's length skip);
//   * each KV tile (kBlockN positions) is staged in shared memory as fp32
//     with 16-byte coalesced loads, one tile order for every variant to
//     come (int8 dequant, paged, bitmap skip plug into the tile load);
//   * one warp per query row keeps an fp32 online softmax (m, l) and an
//     fp32 accumulator, ceil(D/32) output channels per lane;
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

template <typename T, int D, int BN>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int H, int n, int S, float sm_scale) {
  constexpr int KSTRIDE = D + 1;          // padded: lanes read distinct banks
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int PER_LANE = (D + 31) / 32; // output channels per lane
  constexpr int KEYS_PER_LANE = BN / 32;  // scores per lane per tile
  static_assert(D % 16 == 0 && BN % 32 == 0 && D % VEC == 0, "tile shape");

  __shared__ float ks[BN * KSTRIDE];
  __shared__ float vs[BN * D];
  __shared__ float qs[kWarps * D];
  __shared__ float ps[kWarps * BN];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = tile * kWarps + warp;
  const int len = min(max(lengths[b], 0), S);
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * n * D;
  const T* kb = k + bh * S * D;
  const T* vb = v + bh * S * D;

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
    __syncthreads();  // previous tile consumed; q staged on the first pass
    for (int c = threadIdx.x; c < BN * (D / VEC); c += kThreads) {
      const int j = c / (D / VEC), d0 = (c % (D / VEC)) * VEC;
      const int pos = base + j;
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = make_uint4(0, 0, 0, 0);
      if (pos < S) {
        kraw = *reinterpret_cast<const uint4*>(kb + (size_t)pos * D + d0);
        vraw = *reinterpret_cast<const uint4*>(vb + (size_t)pos * D + d0);
      }
      const T* kv = reinterpret_cast<const T*>(&kraw);
      const T* vv = reinterpret_cast<const T*>(&vraw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * KSTRIDE + d0 + e] = to_float(kv[e]);
        vs[j * D + d0 + e] = to_float(vv[e]);
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
        s[kk] = (base + j <= bound) ? dot : -INFINITY;
        tmax = fmaxf(tmax, s[kk]);
      }
      // key `base` is visible, so m_new is finite; corr is 0 on the
      // first visible tile (m = -inf)
      const float m_new = fmaxf(m, warp_max(tmax));
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KEYS_PER_LANE; ++kk) {
        const float p = expf(s[kk] - m_new);
        ps[warp * BN + lane + 32 * kk] = p;
        psum += p;
      }
      l = l * corr + warp_sum(psum);
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

  if (row < n) {
    T* orow = out + (bh * n + row) * D;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      if (lane + 32 * i < D) store(orow + lane + 32 * i, l > 0.f ? acc[i] / l : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   void* out, int B, int H, int n, int S, float sm_scale,
                   cudaStream_t stream) {
  constexpr int BN = D > 64 ? 32 : 64;  // keeps static shared memory < 48 KB
  const dim3 grid((n + kWarps - 1) / kWarps, H, B);
  flash_decode_kernel<T, D, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, n, S, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* lengths,
                       void* out, int B, int H, int n, int S, int D, float sm_scale,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, out, B, H, n, S, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, lengths, out, B, H, n, S, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, B, H, n, S, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, B, H, n, S, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,n,D], k/v [B,H,S,D] (contiguous, 16-byte aligned), lengths [B]
// int32, out [B,H,n,D]. dtype: 0 = float32, 1 = bfloat16. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int flash_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, int B, int H,
                                      int n, int S, int D, int dtype, float sm_scale,
                                      void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || S <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, lengths, out, B, H, n, S, D, sm_scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, lengths, out, B, H, n, S, D, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
