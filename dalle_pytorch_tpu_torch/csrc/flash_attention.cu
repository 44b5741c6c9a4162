// Flash attention for Hopper (sm_90a): the forward pass and the backward
// pass (dq, dk and dv), for training over a whole sequence.
//
// Replaces the TPU kernels of `dalle_pytorch_tpu/ops/pallas_attention.py`:
// `_fwd_kernel` (via `_flash_forward`), `_dq_kernel` and `_dkv_kernel`
// (via `_flash_backward`), the custom-VJP pair behind `flash_attention`.
//
//   s[i, j] = q[i] . k[j] * scale, kept where the arm allows (i, j):
//     mode 0: every key j < nk;
//     mode 1 (causal): j <= i in global indices (top-left convention,
//             also when nk != nq);
//     mode 2 (static mask): mask[i, j], with [ceil(nq/64), ceil(nk/64)]
//             tile layout; tiles whose layout entry is 0 are skipped;
//   forward:  o = softmax(s) v, lse = m + log(l)      (o in the input
//             type, lse fp32);
//   backward: p = exp(s - lse), ds = p * (do . v^T - delta) * scale,
//             dq = ds k, dk = ds^T q, dv = p^T do.
// delta = rowsum(do * o) in fp32 is computed outside (as the reference
// does). Masked scores take the finite value -1e30 in the forward, as in
// the Pallas kernel, so a row's first fully masked tile is wiped out by the
// first live one; every real row must see at least one key (the caller's
// mask check enforces it).
//
// What bounds it: at the training shapes (N = 1280, D = 64) the work is
// ~N^2/2 visible pairs per head, 4 D flops each in the forward (two
// products) and 10 D in the backward (five: S and dP once, then dV, dK,
// dQ), so both passes are bound by operations, not bytes. Design:
//   * forward: one thread block per (64-row tile, head, batch row),
//     looping over its own 64-wide key tiles, so Pallas's sequential grid
//     axis becomes an in-block loop and nothing crosses blocks; causal
//     blocks stop at the last live key tile, mask blocks skip the tiles the
//     layout marks empty; in bfloat16 on wgmma with TMA tiles (D = 64,
//     128, 256; the wrapper pads other D to the next), see the tensor-core
//     section;
//   * backward in bfloat16: one fused pass, FlashAttention-2's (second
//     half of this file): a block per (64-key tile, head, batch row) loops
//     over the query tiles that see its keys, computes S and dP once per
//     tile, accumulates dK and dV in registers and adds dQ into an fp32
//     workspace with atomics; operands by ldmatrix from padded row-major
//     tiles (no transposed copies), the next query tile loaded by cp.async
//     while the current one computes;
//   * bfloat16 inputs run on tensor cores (fp32 accumulators). P
//     (forward, dv) and dS (dq, dk) are rounded to bf16
//     before their second product, as FlashAttention does -- dS once, for
//     both dk and dq; the softmax state (m, l, lse) and every sum stay fp32;
//   * float32 inputs keep fp32 arithmetic on CUDA cores (256 threads,
//     each owning a 4 x 4 patch of the 64 x 64 score tile and a 4 x D/16
//     patch of the accumulator; tiles staged as fp32 with rows padded to
//     D + 4 so float4 reads are conflict-free); the online softmax reduces
//     over the 16 lanes of a half-warp; the backward is two passes, dq (by
//     query tile) and dk/dv (by key tile), each recomputing p;
//   * head dims: instances at D = 16, 32, 64, 128 and 256 (the wrapper
//     zero-pads any other D <= 256 to the next). At 256 the fp32 dq and
//     dk/dv kernels would pass the shared-memory limit with four staged
//     tiles, so K and V share one buffer in turn (dk/dv restages its key
//     tile for each query tile), and the fused bf16 backward splits the
//     output columns over two blocks (`bwd_out_cols`).
// Not done yet: wgmma and TMA in the backward.

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime, no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;     // query and key tile
constexpr int kThreads = 256;  // 16 x 16: tx over columns, ty over rows
constexpr int kPLD = kBlock + 4;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
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

// rows [row0, row0 + kBlock) of a row-major [n, D] float matrix -> shared
// memory, row stride D + 4, times `mul`; rows >= n are zero
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int row0,
                                           int n, float mul) {
  constexpr int CHUNKS = D / 4;
  constexpr int LD = D + 4;
  for (int c = threadIdx.x; c < kBlock * CHUNKS; c += kThreads) {
    const int r = c / CHUNKS, d0 = (c % CHUNKS) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) {
      v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + d0);
      v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * LD + d0) = v;
  }
}

// acc[i][j] += sum_d a[ty + 16 i][d] * b[tx + 16 j][d]  (both stride D + 4)
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(float (&out)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 t = reinterpret_cast<const float4*>(src)[k];
      out[4 * k] = t.x; out[4 * k + 1] = t.y; out[4 * k + 2] = t.z; out[4 * k + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    out[0] = t.x; out[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = src[k];
  }
}

// acc[i][j] += sum_c p[ty + 16 i][c] * m[c][tx * D/16 + j]
// (p stride kBlock + 4, m stride D + 4)
template <int D>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16], const float* p, const float* m,
                                         int ty, int tx) {
  constexpr int LD = D + 4, DJ = D / 16;
#pragma unroll 2
  for (int c = 0; c < kBlock; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kPLD + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float mv[DJ];
      load_vec<DJ>(mv, m + (c + cc) * LD + tx * DJ);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pc = comp(pv[i], cc);
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pc, mv[j], acc[i][j]);
      }
    }
  }
}

// whether (query row r, key c) is attended: bounds, then the arm
__device__ __forceinline__ bool visible(int r, int c, int nq, int nk, int mode,
                                        const uint8_t* __restrict__ mask) {
  if (r >= nq || c >= nk) return false;
  if (mode == 1) return c <= r;
  if (mode == 2) return mask[(size_t)r * nk + c] != 0;
  return true;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const uint8_t* __restrict__ mask, const int* __restrict__ layout,
           float* __restrict__ o, float* __restrict__ lse, int H, int nq, int nk, int mode,
           float scale) {
  constexpr int LD = D + 4, DJ = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBlock * LD;
  float* vs = ks + kBlock * LD;
  float* ps = vs + kBlock * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t bh = (size_t)b * H + h;
  const float* kb = k + bh * nk * D;
  const float* vb = v + bh * nk * D;
  const int q0 = qt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock;
  // causal: the last key tile any row of this tile sees
  const int kend = mode == 1 ? min(ktiles, (q0 + kBlock - 1) / kBlock + 1) : ktiles;

  stage_tile<D>(qs, q + bh * nq * D, q0, nq, scale);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < kend; ++kt) {
    if (mode == 2 && layout[qt * ktiles + kt] == 0) continue;  // block-uniform
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile is consumed (and q is staged)
    stage_tile<D>(ks, kb, k0, nk, 1.f);
    stage_tile<D>(vs, vb, k0, nk, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_dot<D>(s, qs, ks, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(r, k0 + tx + 16 * j, nq, nk, mode, mask)) s[i][j] = kNeg;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPLD + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a row of P is written and read by the same 16 lanes
    tile_acc<D>(acc, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= nq) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
    float* orow = o + (bh * nq + r) * D + tx * DJ;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[j] = acc[i][j] / safe_l;
    if (tx == 0) lse[bh * nq + r] = m[i] + logf(safe_l);
  }
}

// D > 128: four staged tiles pass the shared-memory limit, so K and V share
// one buffer in turn (V for dP, then K for S and dq += dS K) and the dk/dv
// kernel restages its key tile's K and V for each query tile
template <int D>
__host__ __device__ constexpr bool kv_shared() { return D > 128; }

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, const uint8_t* __restrict__ mask,
          const int* __restrict__ layout, float* __restrict__ dq, int H, int nq, int nk, int mode,
          float scale) {
  constexpr int LD = D + 4, DJ = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kBlock * LD;
  float* ks = dos + kBlock * LD;
  float* vs = kv_shared<D>() ? ks : ks + kBlock * LD;
  float* dss = vs + kBlock * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t bh = (size_t)b * H + h;
  const float* kb = k + bh * nk * D;
  const float* vb = v + bh * nk * D;
  const int q0 = qt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock;
  const int kend = mode == 1 ? min(ktiles, (q0 + kBlock - 1) / kBlock + 1) : ktiles;

  stage_tile<D>(qs, q + bh * nq * D, q0, nq, 1.f);
  stage_tile<D>(dos, dout + bh * nq * D, q0, nq, 1.f);
  float row_lse[4], row_delta[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    row_lse[i] = r < nq ? lse[bh * nq + r] : 0.f;
    row_delta[i] = r < nq ? delta[bh * nq + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < kend; ++kt) {
    if (mode == 2 && layout[qt * ktiles + kt] == 0) continue;
    const int k0 = kt * kBlock;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    __syncthreads();
    if constexpr (kv_shared<D>()) {
      stage_tile<D>(vs, vb, k0, nk, 1.f);
      __syncthreads();
      tile_dot<D>(dp, dos, vs, ty, tx);
      __syncthreads();
      stage_tile<D>(ks, kb, k0, nk, 1.f);
      __syncthreads();
      tile_dot<D>(s, qs, ks, ty, tx);
    } else {
      stage_tile<D>(ks, kb, k0, nk, 1.f);
      stage_tile<D>(vs, vb, k0, nk, 1.f);
      __syncthreads();
      tile_dot<D>(s, qs, ks, ty, tx);
      tile_dot<D>(dp, dos, vs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(r, k0 + tx + 16 * j, nq, nk, mode, mask)
                            ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dss[(ty + 16 * i) * kPLD + tx + 16 * j] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    }
    __syncwarp();
    tile_acc<D>(acc, dss, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= nq) continue;
    float* row = dq + (bh * nq + r) * D + tx * DJ;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[j] = acc[i][j];
  }
}

// here a thread's score patch is transposed: rows ty + 16 i are KEYS of
// this block's tile, columns tx + 16 j are QUERY rows of the streamed tile
template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, const uint8_t* __restrict__ mask,
           const int* __restrict__ layout, float* __restrict__ dk, float* __restrict__ dv, int H,
           int nq, int nk, int mode, float scale) {
  constexpr int LD = D + 4, DJ = D / 16;
  extern __shared__ float4 smem4[];
  constexpr bool SHARED = kv_shared<D>();  // K and V, and P^T and dS^T, share buffers
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = SHARED ? ks : ks + kBlock * LD;
  float* qs = vs + kBlock * LD;
  float* dos = qs + kBlock * LD;
  float* pts = dos + kBlock * LD;
  float* dsts = SHARED ? pts : pts + kBlock * kPLD;
  float* lse_s = dsts + kBlock * kPLD;
  float* delta_s = lse_s + kBlock;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t bh = (size_t)b * H + h;
  const float* qb = q + bh * nq * D;
  const float* db = dout + bh * nq * D;
  const int k0 = kt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock;
  const int qtiles = (nq + kBlock - 1) / kBlock;
  // causal: the first query tile whose rows reach key k0 (empty when
  // nk > nq puts the whole key tile past the last query)
  const int qbegin = mode == 1 ? k0 / kBlock : 0;

  const float* kb = k + bh * nk * D;
  const float* vb = v + bh * nk * D;
  if constexpr (!SHARED) {
    stage_tile<D>(ks, kb, k0, nk, 1.f);
    stage_tile<D>(vs, vb, k0, nk, 1.f);
  }
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qt = qbegin; qt < qtiles; ++qt) {
    if (mode == 2 && layout[qt * ktiles + kt] == 0) continue;
    const int q0 = qt * kBlock;
    __syncthreads();
    stage_tile<D>(qs, qb, q0, nq, 1.f);
    stage_tile<D>(dos, db, q0, nq, 1.f);
    for (int r = threadIdx.x; r < kBlock; r += kThreads) {
      lse_s[r] = q0 + r < nq ? lse[bh * nq + q0 + r] : 0.f;
      delta_s[r] = q0 + r < nq ? delta[bh * nq + q0 + r] : 0.f;
    }
    if constexpr (SHARED) stage_tile<D>(ks, kb, k0, nk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(s, ks, qs, ty, tx);
    if constexpr (SHARED) {
      __syncthreads();
      stage_tile<D>(vs, vb, k0, nk, 1.f);
      __syncthreads();
    }
    tile_dot<D>(dp, vs, dos, ty, tx);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = tx + 16 * j;
        // padded query rows (>= nq) are dropped here: their lse never
        // reaches dk/dv
        const float p = visible(q0 + rl, c, nq, nk, mode, mask)
                            ? expf(s[i][j] * scale - lse_s[rl]) : 0.f;
        ds[i][j] = p * (dp[i][j] - delta_s[rl]) * scale;
        pts[(ty + 16 * i) * kPLD + rl] = p;
        if constexpr (!SHARED) dsts[(ty + 16 * i) * kPLD + rl] = ds[i][j];
      }
    }
    __syncwarp();
    tile_acc<D>(dv_acc, pts, dos, ty, tx);
    if constexpr (SHARED) {  // dS^T replaces P^T (rows of one half-warp each)
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dsts[(ty + 16 * i) * kPLD + tx + 16 * j] = ds[i][j];
      __syncwarp();
    }
    tile_acc<D>(dk_acc, dsts, qs, ty, tx);
  }

  // every block writes its rows, zeros when no query tile was live
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= nk) continue;
    float* krow = dk + (bh * nk + c) * D + tx * DJ;
    float* vrow = dv + (bh * nk + c) * D + tx * DJ;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      krow[j] = dk_acc[i][j];
      vrow[j] = dv_acc[i][j];
    }
  }
}


// ---------------------------------------------------------------------------
// Tensor-core path for bfloat16 inputs: bf16 operands, fp32 accumulators.
// A block is one warpgroup (4 warps, 128 threads) owning a 64-row tile, 16
// rows per warp. The score / probability tile stays in the accumulator
// registers: its rows reduce over the 4 lanes of a quad, and it becomes the
// A operand of the second product in place, rounded to bf16 (P for o and
// dv, dS for dq and dk) -- the one rounding the CUDA-core path does not
// have. Fragment layouts (PTX ISA, mma.m16n8k16; a wgmma warp's 16 rows of
// its m64 tile are laid out the same): g = lane / 4, t = lane % 4;
//   A 16x16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8:  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8:  c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
//
// The bf16 forward, `fwd_wgmma_kernel`, at D = 64, 128 and 256 (the wrapper
// zero-pads other D to the next, so one kernel serves every head dim and
// no 32- or 64-byte swizzle is needed). S = Q K^T is D/16 wgmma.m64n64k16
// with Q and K K-major in shared memory; O += P V is 4 wgmma.m64nDk16
// (D = 256: two m64n128k16 a step, on the accumulator's two halves) with
// P from registers (the rounded accumulator, repacked as A fragments, as
// FlashAttention-3 does) and V read from shared memory as an MN-major
// operand (the transpose bit), so no transposed copy exists. Tiles are
// 64-column panels of 64 rows x 128 bytes in the 128-byte swizzle the
// descriptors name (D = 128: two panels), written by TMA: one thread asks
// for a tile, which completes on an mbarrier, so the others spend no
// instructions on loads (per-thread cp.async addressing was a large share
// of the instructions a tile step issues, which is what limits this
// kernel). The next live key tile's K and V arrive into a second stage while
// the current one computes (zero-filled past nk), one barrier a tile; the
// arm's mask is applied only where a tile needs it (the causal diagonal,
// tiles past nq or nk, every live tile of the static-mask arm, read from
// the mask itself); the query tile is the slowest grid index and
// reversed, so the causal blocks with the most key tiles start first. P is
// formed in base 2, 2^(fl(s scale log2(e)) - m) by ex2.approx: 8
// instructions an element fewer than expf, ~18% of the forward's time on
// the H100. That moves P's fp32 value by ~1e-6 against exp(fl(s scale) -
// m), so the rounding-matched plain version forms P in base 2 as well.
// (The backward keeps expf: its dv sums over the few rows an axial key
// sees, where one flip is a large share.)

constexpr int kMmaThreads = 128;
constexpr int kLDT = kBlock + 8;  // stride of a transposed [.][64] tile (the backward's dS^T)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
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

// 16 bytes (or 4) global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + 64) of a row-major [n, D] bf16 matrix -> shared memory
// with row stride D + 8, asynchronously (rows >= n are zero)
template <int D>
__device__ __forceinline__ void stage_rows_async(bf16* dst, const bf16* __restrict__ src, int row0,
                                                 int n) {
  constexpr int CH = D / 8, LD = D + 8;
  for (int c = threadIdx.x; c < kBlock * CH; c += kMmaThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const bool ok = row0 + r < n;
    cp_async16(smem_addr(dst + r * LD + d0), src + (size_t)(ok ? row0 + r : 0) * D + d0, ok);
  }
}

// whether every (query, key) pair of a 64 x 64 tile is visible, so its
// scores need no mask (the static-mask arm's layout marks tiles live or
// empty, never full)
__device__ __forceinline__ bool tile_full(int mode, int q0, int k0, int nq, int nk) {
  return mode != 2 && q0 + kBlock <= nq && k0 + kBlock <= nk &&
         (mode == 0 || k0 + kBlock - 1 <= q0);
}

// the first key tile at or after kt that the arm lets this query tile see
// (the static-mask arm skips the tiles its layout marks empty)
__device__ __forceinline__ int next_key_tile(int kt, int kend, int mode,
                                             const int* __restrict__ layout, int qt, int ktiles) {
  if (mode == 2)
    while (kt < kend && layout[qt * ktiles + kt] == 0) ++kt;
  return kt;
}

// the last key tile + 1 that any row of query tile q0 sees
__device__ __forceinline__ int key_tile_end(int mode, int q0, int nk) {
  const int ktiles = (nk + kBlock - 1) / kBlock;
  return mode == 1 ? min(ktiles, (q0 + kBlock - 1) / kBlock + 1) : ktiles;
}

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One 64-key tile of the online softmax for this thread's rows r and
// r + 8: s[nb][e] is the score of row r + 8 (e / 2), key c0 + 8 nb + e % 2
// (accumulator layout). In base 2: with x = fl(s scale_log2) (scale_log2 =
// scale log2(e)) and m the running row maximum of x, s becomes P =
// 2^(x - m_new) in place, unrounded; m and l are updated and corr is the
// factor the output accumulator takes. MASKED tiles are masked by the arm
// first; the others are wholly visible and skip it.
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
      if (MASKED && !visible(r + 8 * (e / 2), c0 + 8 * nb + (e % 2), nq, nk, mode, mask)) x = kNeg;
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

// P (this thread's part of a 16 x 64 tile, accumulator layout) as the A
// fragments of P V over its four 16-key steps, rounded to bf16
__device__ __forceinline__ void p_fragments(uint32_t (&pa)[4][4], const float (&p)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    pa[kc][0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    pa[kc][1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    pa[kc][2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[kc][3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
  }
}

template <int NB>
__device__ __forceinline__ void scale_rows(float (&acc)[NB][4], const float (&corr)[2]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] *= corr[e / 2];
}

// o = acc / max(l, 1e-30) in bf16 and lse = m ln(2) + log(that) (m in
// base 2) for this thread's rows r and r + 8 of the [nq, D] slab at o / lse
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], const float (&m)[2],
                                           const float (&l)[2], bf16* __restrict__ o,
                                           float* __restrict__ lse, int r, int nq, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r + 8 * hh;
    if (row >= nq) continue;
    const float safe_l = fmaxf(l[hh], 1e-30f);
    bf16* orow = o + (size_t)row * D + 2 * t;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) =
          __floats2bfloat162_rn(acc[nb][2 * hh] / safe_l, acc[nb][2 * hh + 1] / safe_l);
    if (t == 0) lse[row] = m[hh] * kLn2 + logf(safe_l);
  }
}

// --- wgmma (D = 64, 128, 256)
constexpr uint32_t kPanel = kBlock * 128;  // bytes of a 64-row x 64-column bf16 panel

// The wgmma kernel's tiles arrive by TMA: one thread asks for a whole
// 64 x 64 box of a [B*H, n, D] tensor map (128-byte swizzle, rows past n
// zero-filled) and the copy completes on an mbarrier that every thread
// waits on. A tile of D columns is D / 64 boxes, one per panel.

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// the barrier's next phase completes when `bytes` have arrived
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait for the phase of parity `phase` to complete; a copy that never
// lands traps (after 2^22 polls) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}

// rows [row0, row0 + 64) of batch-head bh of `map` -> the D / 64 panels at
// shared address `dst`, completing on `bar` (one thread calls this)
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row0, int bh) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst + p * kPanel),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(p * 64), "r"(row0), "r"(bh)
        : "memory");
}

// the wgmma descriptor of a 128-byte-swizzled operand at shared address
// `addr`: 8-row groups 1024 bytes apart (SBO), and `lbo` the stride of
// 64-column panels along M/N (an MN-major operand wider than one panel;
// unused for K-major)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the compiler may not move accesses of these registers across this point
// (wgmma writes them asynchronously, behind the compiler's back)
template <int NB>
__device__ __forceinline__ void fence_regs(float (&r)[NB][4]) {
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}

#define WG_ACC4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define WG_ACC32 WG_ACC4(0), WG_ACC4(1), WG_ACC4(2), WG_ACC4(3), WG_ACC4(4), WG_ACC4(5), \
                 WG_ACC4(6), WG_ACC4(7)
#define WG_REG32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"

// d (+)= A B^T, wgmma.m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REG32 "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, wgmma.m64n64k16 / m64n128k16: A from registers, B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REG32 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// (m64n128k16 on the 128 columns of d from column 8 O: O = 16 is the
// second half of a 256-column accumulator)
#define WG_ACC4_AT(i) "+f"(d[O + i][0]), "+f"(d[O + i][1]), "+f"(d[O + i][2]), "+f"(d[O + i][3])
template <int O = 0, int NB>
__device__ __forceinline__ void wgmma_rs128(float (&d)[NB][4], const uint32_t (&a)[4], uint64_t db) {
  static_assert(O + 16 <= NB, "accumulator columns");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REG32 ", "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC4_AT(0), WG_ACC4_AT(1), WG_ACC4_AT(2), WG_ACC4_AT(3), WG_ACC4_AT(4),
        WG_ACC4_AT(5), WG_ACC4_AT(6), WG_ACC4_AT(7), WG_ACC4_AT(8), WG_ACC4_AT(9),
        WG_ACC4_AT(10), WG_ACC4_AT(11), WG_ACC4_AT(12), WG_ACC4_AT(13), WG_ACC4_AT(14),
        WG_ACC4_AT(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
constexpr size_t fwd_wgmma_smem() { return 5 * kBlock * D * sizeof(bf16) + 1024; }  // + alignment

// at most 128 registers a thread, so 4 blocks share an SM at D = 64 (16
// warps to hide the latency of the serial S -> softmax -> P V chain); the
// D = 128 accumulator needs more, and its 81 KB of shared memory fits 2;
// D = 256 (128 accumulator registers a thread, 161 KB) runs one block an SM
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D >= 256 ? 1 : D == 128 ? 2 : 4)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ mask,
                 const int* __restrict__ layout, bf16* __restrict__ o, float* __restrict__ lse,
                 int nq, int nk, int mode, float scale) {
  static_assert(D == 64 || D == 128 || D == 256, "whole 64-column panels, 128-column products");
  constexpr int NBD = D / 8;
  constexpr uint32_t kTile = kBlock * D * sizeof(bf16);
  extern __shared__ float4 smem4[];
  const uint32_t qsm = (smem_addr(smem4) + 1023) & ~1023u;
  const uint32_t ksm0 = qsm + kTile, vsm0 = qsm + 3 * kTile;  // stage s at + s * kTile
  __shared__ __align__(8) uint64_t bars[3];  // Q, then one per stage
  const uint32_t qbar = smem_addr(&bars[0]), bar0 = qbar + 8;  // stage s's at bar0 + 8 s

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const int q0 = qt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock;
  const int kend = key_tile_end(mode, q0, nk);
  const bool leader = threadIdx.x == 0;
  auto fetch_kv = [&](int st, int tile) {  // by the leader
    mbar_expect(bar0 + 8 * st, 2 * kTile);
    tma_tile<D>(ksm0 + st * kTile, &kmap, bar0 + 8 * st, tile * kBlock, bh);
    tma_tile<D>(vsm0 + st * kTile, &vmap, bar0 + 8 * st, tile * kBlock, bh);
  };

  int kt = next_key_tile(0, kend, mode, layout, qt, ktiles);
  if (leader) {
    for (int i = 0; i < 3; ++i) mbar_init(qbar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (kt < kend) {
      mbar_expect(qbar, kTile);
      tma_tile<D>(qsm, &qmap, qbar, q0, bh);
      fetch_kv(0, kt);
    }
  }
  __syncthreads();  // the barriers are initialised
  if (kt < kend) mbar_wait(qbar, 0);

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, acc[NBD][4];
#pragma unroll
  for (int nb = 0; nb < NBD; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int it = 0; kt < kend; ++it) {
    const int st = it & 1;
    mbar_wait(bar0 + 8 * st, (it >> 1) & 1);  // this tile has landed
    __syncthreads();  // every warp is done with the other stage
    const int kn = next_key_tile(kt + 1, kend, mode, layout, qt, ktiles);
    if (leader && kn < kend) fetch_kv(st ^ 1, kn);  // in flight while this tile computes
    const uint32_t ksm = ksm0 + st * kTile, vsm = vsm0 + st * kTile;

    // S = Q K^T: D / 16 steps of 16 columns, 32 bytes into a panel each
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kPanel + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(qsm + off, 16), sw128_desc(ksm + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float corr[2];
    const int k0 = kt * kBlock;
    if (tile_full(mode, q0, k0, nq, nk))
      softmax_tile<false>(s, m, l, corr, q0 + r0 + g, k0 + 2 * t, nq, nk, mode, mask,
                          scale * kLog2e);
    else
      softmax_tile<true>(s, m, l, corr, q0 + r0 + g, k0 + 2 * t, nq, nk, mode, mask,
                         scale * kLog2e);
    scale_rows(acc, corr);
    uint32_t pa[4][4];
    p_fragments(pa, s);

    // O += P V: four steps of 16 keys, 2048 bytes (16 rows) apart; D = 256
    // as two 128-column products, the second from V's third panel on
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (D == 64) {
        wgmma_rs(acc, pa[kk], sw128_desc(vsm + kk * 2048, kPanel));
      } else {
        wgmma_rs128<0>(acc, pa[kk], sw128_desc(vsm + kk * 2048, kPanel));
        if constexpr (D == 256)
          wgmma_rs128<16>(acc, pa[kk], sw128_desc(vsm + 2 * kPanel + kk * 2048, kPanel));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    kt = kn;
  }
  store_rows<D>(acc, m, l, o + (size_t)bh * nq * D, lse + (size_t)bh * nq, q0 + r0 + g, nq, t);
}

// cuTensorMapEncodeTiled, found once through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the [bh, n, D] bf16 tensor at `base` as a map of 64 x 64 boxes, 128-byte
// swizzled, rows past n read as zeros
template <int D>
bool tile_map(CUtensorMap* map, const void* base, int bh, int n) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16), (cuuint64_t)n * D * sizeof(bf16)};
  const cuuint32_t box[3] = {64, kBlock, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// The fused bfloat16 backward: dq, dk and dv in one pass (FlashAttention-2's
// backward). One block of 4 warps per (64-key tile, head, batch row); the
// block loops over the query tiles that see its keys, each warp owning 16
// keys. Per query tile it computes S^T = K Q^T and dP^T = V dO^T once
// (16 keys x 64 queries a warp), P^T = exp(S^T scale - lse) and
// dS^T = P^T (dP^T - delta) scale in registers, rounds both to bf16 once,
// and runs the three second products from them:
//   dV += P^T dO and dK += dS^T Q  in fp32 registers (A from registers, B
//                                   by ldmatrix.trans of the row-major tile);
//   dQ += dS K                      dS^T goes through shared memory once
//                                   (bf16, the same rounded values), since
//                                   dq reduces over the keys the warps
//                                   split; each warp then owns 16 query rows
//                                   over all 64 keys and adds them into an
//                                   fp32 workspace with float4 atomics.
// A query tile is taken in two halves of 32 queries, so only half the
// score tile is live in registers beside dK and dV: 3 blocks fit an SM.
// Every operand is read with ldmatrix (x4, .trans where the reduction axis
// is the tile's row index) from row-major tiles padded by 8 bf16, so the 8
// rows of each 8x8 matrix hit 8 distinct 16-byte bank groups. The next
// query tile's Q, dO, lse and delta arrive by cp.async into the other of two
// stages while the current tile's products run. The arm's mask is applied
// only where a tile needs it: causal tiles crossing the diagonal, tiles past
// nq or nk, and every live tile of the static-mask arm (its layout marks
// tiles live or empty, not full). P is formed as the plain version forms
// it, exp(fl(fl(s scale) - lse)) with no contraction, not as exp2 with
// log2(e) folded in: that saves instructions but moves P's fp32 value by
// ~1e-6, enough to flip its bf16 rounding on ~1e-5 of the scores, and
// where a key is seen by few rows (the axial image keys, ~16) one flip
// is a 1e-3 share of its dv. dk and dv have no atomics and are
// bit-identical from run to run; dq's fp32 sum order follows the atomics'
// arrival and may differ in its last bits.

// dst[0 .. 4) += x in global memory (16-byte aligned), one vector atomic
// on sm_90
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

template <int D>
constexpr size_t bwd_mma_smem() {
  // K, V; two stages of Q and dO; dS^T; two stages of lse and delta
  return sizeof(bf16) * (6 * kBlock * (D + 8) + kBlock * kLDT) + sizeof(float) * 4 * kBlock;
}

// D = 256: dK and dV for 64 keys x 256 columns do not fit 4 warps'
// registers, so each block owns DO = 128 of the output columns (blockIdx.z
// picks which): it forms S and dP over all of D, as every column of dK =
// dS^T Q, dV = P^T dO and dQ = dS K needs them, then accumulates only its
// own columns. Two blocks per key tile recompute S and dP; the columns'
// sums are the unsplit kernel's.
template <int D>
__host__ __device__ constexpr int bwd_out_cols() { return D > 128 ? D / 2 : D; }

// at most 170 registers a thread, so 3 blocks share an SM; at D = 128 the
// shared memory (115 KB a block) fits only 2, so the registers may too; at
// D = 256 (208 KB) one
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D >= 256 ? 1 : D == 128 ? 2 : 3)
bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const uint8_t* __restrict__ mask, const int* __restrict__ layout,
               float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv, int nq,
               int nk, int mode, float scale) {
  constexpr int LD = D + 8, DO = bwd_out_cols<D>(), NBD = DO / 8, DC = D < 64 ? D : 64;
  extern __shared__ float4 smem4[];
  const int c0 = blockIdx.z * DO;  // this block's output columns [c0, c0 + DO)
  bf16* ks = reinterpret_cast<bf16*>(smem4);
  bf16* vs = ks + kBlock * LD;
  bf16* qs0 = vs + kBlock * LD;         // stage s at qs0 + s * 64 * LD
  bf16* dos0 = qs0 + 2 * kBlock * LD;
  bf16* dsts = dos0 + 2 * kBlock * LD;  // dS^T [key][query], stride 64 + 8
  float* lse_s0 = reinterpret_cast<float*>(dsts + kBlock * kLDT);  // [2][64]
  float* delta_s0 = lse_s0 + 2 * kBlock;

  // blockIdx.y is the key tile, the slowest grid index: causal key tile 0,
  // which the most query tiles see, is scheduled first
  const size_t bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;  // this warp's 16 keys, and its 16 dq rows
  const int k0 = kt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock;
  const int qtiles = (nq + kBlock - 1) / kBlock;
  const bf16* qb = q + bh * nq * D;
  const bf16* db = dout + bh * nq * D;
  const float* lb = lse + bh * nq;
  const float* deb = delta + bh * nq;

  auto next_live = [&](int qt) {
    if (mode == 2)
      while (qt < qtiles && layout[qt * ktiles + kt] == 0) ++qt;
    return qt;
  };
  auto stage_q = [&](int s, int qt) {
    const int q0 = qt * kBlock;
    stage_rows_async<D>(qs0 + s * kBlock * LD, qb, q0, nq);
    stage_rows_async<D>(dos0 + s * kBlock * LD, db, q0, nq);
    const int r = threadIdx.x % kBlock;  // 128 threads: lse by 0..63, delta by 64..127
    const bool ok = q0 + r < nq;
    if (threadIdx.x < kBlock)
      cp_async4(lse_s0 + s * kBlock + r, lb + (ok ? q0 + r : 0), ok);
    else
      cp_async4(delta_s0 + s * kBlock + r, deb + (ok ? q0 + r : 0), ok);
  };

  // causal: the first query tile whose rows reach key k0 (none when nk > nq
  // puts the whole key tile past the last query)
  int qt = next_live(mode == 1 ? k0 / kBlock : 0);
  if (qt < qtiles) {
    stage_rows_async<D>(ks, k + bh * nk * D, k0, nk);
    stage_rows_async<D>(vs, v + bh * nk * D, k0, nk);
    stage_q(0, qt);
  }
  cp_async_commit();

  float dk_acc[NBD][4], dv_acc[NBD][4];
#pragma unroll
  for (int nb = 0; nb < NBD; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;

  for (int it = 0; qt < qtiles; ++it) {
    const int st = it & 1;
    const int qn = next_live(qt + 1);
    if (qn < qtiles) {
      stage_q(st ^ 1, qn);  // that stage's last readers passed this tile's second barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed; the previous tile's dS^T reads are done
    const bf16* qs = qs0 + st * kBlock * LD;
    const bf16* dos = dos0 + st * kBlock * LD;
    const float* lse_s = lse_s0 + st * kBlock;
    const float* delta_s = delta_s0 + st * kBlock;
    const int q0 = qt * kBlock;

    // in two halves of 32 queries, so only half the score tile is live in
    // registers beside dK and dV
    const bool full = tile_full(mode, q0, k0, nq, nk);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qh = half * 32;
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t ak[4], av[4];
        const int arow = (r0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8;
        ldsm_x4(ak, ks + arow);
        ldsm_x4(av, vs + arow);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int brow =
              (qh + np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kc * 16 + ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldsm_x4(b, qs + brow);
          mma_bf16(s[2 * np], ak, b[0], b[1]);
          mma_bf16(s[2 * np + 1], ak, b[2], b[3]);
          ldsm_x4(b, dos + brow);
          mma_bf16(dp[2 * np], av, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], av, b[2], b[3]);
        }
      }

      // P^T and dS^T, rounded to bf16 once, as A fragments over this
      // half's two 16-query steps (a[kc][(nb & 1) * 2 + hh]); dS^T also to
      // shared memory
      uint32_t pa[2][4], dsa[2][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int ql = qh + nb * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + ql);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + ql);
        const float lq[2] = {l2.x, l2.y}, de[2] = {dl.x, dl.y};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int kl = r0 + g + 8 * hh;
          float p[2], ds[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            p[j] = expf(__fsub_rn(__fmul_rn(s[nb][2 * hh + j], scale), lq[j]));
            if (!full && !visible(q0 + ql + j, k0 + kl, nq, nk, mode, mask)) p[j] = 0.f;
            ds[j] = p[j] * (dp[nb][2 * hh + j] - de[j]) * scale;
          }
          pa[nb >> 1][(nb & 1) * 2 + hh] = pack_bf16(p[0], p[1]);
          const uint32_t d2 = pack_bf16(ds[0], ds[1]);
          dsa[nb >> 1][(nb & 1) * 2 + hh] = d2;
          *reinterpret_cast<uint32_t*>(dsts + kl * kLDT + ql) = d2;
        }
      }

      // dV += P^T dO, dK += dS^T Q (reduction over this half's queries)
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
#pragma unroll
        for (int nd = 0; nd < DO / 16; ++nd) {
          const int brow = (qh + kc * 16 + (lane & 15)) * LD + c0 + nd * 16 + (lane >> 4) * 8;
          uint32_t b[4];
          ldsm_x4_t(b, dos + brow);
          mma_bf16(dv_acc[2 * nd], pa[kc], b[0], b[1]);
          mma_bf16(dv_acc[2 * nd + 1], pa[kc], b[2], b[3]);
          ldsm_x4_t(b, qs + brow);
          mma_bf16(dk_acc[2 * nd], dsa[kc], b[0], b[1]);
          mma_bf16(dk_acc[2 * nd + 1], dsa[kc], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // dS^T is complete

    // dQ[r0 .. r0 + 16) += dS K over the 64 keys, in 64-column chunks of
    // this block's columns, added into the fp32 workspace
#pragma unroll
    for (int dcl = 0; dcl < DO / DC; ++dcl) {
      const int dc = c0 / DC + dcl;
      float acc[DC / 8][4];
#pragma unroll
      for (int nb = 0; nb < DC / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t a[4];
        ldsm_x4_t(a, dsts + (kc * 16 + (lane & 7) + (lane >> 4) * 8) * kLDT + r0 +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int nd = 0; nd < DC / 16; ++nd) {
          uint32_t b[4];
          ldsm_x4_t(b, ks + (kc * 16 + (lane & 15)) * LD + dc * DC + nd * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * nd], a, b[0], b[1]);
          mma_bf16(acc[2 * nd + 1], a, b[2], b[3]);
        }
      }
      // lanes t and t ^ 1 swap halves so that each adds 4 adjacent columns:
      // even t row g, columns 2t .. 2t + 3; odd t row g + 8, 2t - 2 .. 2t + 1
      const int odd = t & 1;
      const int r = q0 + r0 + g + 8 * odd;
      float* row = dq_acc + (bh * nq + r) * D + dc * DC + 2 * (t - odd);
#pragma unroll
      for (int nb = 0; nb < DC / 8; ++nb) {
        const float send0 = odd ? acc[nb][0] : acc[nb][2];
        const float send1 = odd ? acc[nb][1] : acc[nb][3];
        const float got0 = __shfl_xor_sync(0xffffffffu, send0, 1);
        const float got1 = __shfl_xor_sync(0xffffffffu, send1, 1);
        const float4 x = odd ? make_float4(got0, got1, acc[nb][2], acc[nb][3])
                             : make_float4(acc[nb][0], acc[nb][1], got0, got1);
        if (r < nq) red_add4(row + nb * 8, x);
      }
    }
    qt = qn;
  }

  // every block writes its keys' rows, zeros when no query tile was live
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int c = k0 + r0 + g + 8 * hh;
    if (c >= nk) continue;
    bf16* krow = dk + (bh * nk + c) * D + c0 + 2 * t;
    bf16* vrow = dv + (bh * nk + c) * D + c0 + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NBD; ++nb) {
      *reinterpret_cast<__nv_bfloat162*>(krow + nb * 8) =
          __floats2bfloat162_rn(dk_acc[nb][2 * hh], dk_acc[nb][2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + nb * 8) =
          __floats2bfloat162_rn(dv_acc[nb][2 * hh], dv_acc[nb][2 * hh + 1]);
    }
  }
}

// the fp32 dq workspace -> dq in bfloat16, 4 values a thread
__global__ void dq_convert_kernel(const float4* __restrict__ src, __nv_bfloat162* __restrict__ dst,
                                  size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 x = src[i];
    dst[2 * i] = __floats2bfloat162_rn(x.x, x.y);
    dst[2 * i + 1] = __floats2bfloat162_rn(x.z, x.w);
  }
}

template <int D>
constexpr size_t fwd_smem() { return sizeof(float) * (3 * kBlock * (D + 4) + kBlock * kPLD); }
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((kv_shared<D>() ? 3 : 4) * kBlock * (D + 4) + kBlock * kPLD);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((kv_shared<D>() ? 3 : 4) * kBlock * (D + 4) +
                          (kv_shared<D>() ? 1 : 2) * kBlock * kPLD + 2 * kBlock);
}

// dynamic shared memory above 48 KB must be opted into once per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *mask, *layout;
  void *o, *lse_out, *dq, *dk, *dv, *dq_acc;
  int B, H, nq, nk, mode;
  float scale;
  cudaStream_t stream;
};

enum Pass { kFwd, kBwd };

// float32 inputs: the CUDA-core kernels (the backward as two launches, dq
// and dk/dv)
template <int D>
cudaError_t run_cuda_cores(Pass pass, const Args& a) {
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* dout = static_cast<const float*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* delta = static_cast<const float*>(a.delta);
  const auto* mask = static_cast<const uint8_t*>(a.mask);
  const auto* layout = static_cast<const int*>(a.layout);
  const dim3 grid((a.nq + kBlock - 1) / kBlock, a.H, a.B);
  cudaError_t err;
  if (pass == kFwd) {
    if ((err = allow_smem(fwd_kernel<D>, fwd_smem<D>())) != cudaSuccess) return err;
    fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), a.stream>>>(
        q, k, v, mask, layout, static_cast<float*>(a.o), static_cast<float*>(a.lse_out), a.H,
        a.nq, a.nk, a.mode, a.scale);
    return cudaGetLastError();
  }
  if ((err = allow_smem(dq_kernel<D>, dq_smem<D>())) != cudaSuccess) return err;
  dq_kernel<D><<<grid, kThreads, dq_smem<D>(), a.stream>>>(
      q, k, v, dout, lse, delta, mask, layout, static_cast<float*>(a.dq), a.H, a.nq, a.nk,
      a.mode, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(dkv_kernel<D>, dkv_smem<D>())) != cudaSuccess) return err;
  const dim3 kgrid((a.nk + kBlock - 1) / kBlock, a.H, a.B);
  dkv_kernel<D><<<kgrid, kThreads, dkv_smem<D>(), a.stream>>>(
      q, k, v, dout, lse, delta, mask, layout, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.H, a.nq, a.nk, a.mode, a.scale);
  return cudaGetLastError();
}

// bfloat16 inputs: the tensor-core kernels (the backward as the fused
// kernel between zeroing the dq workspace and converting it)
template <int D>
cudaError_t run_tensor_cores(Pass pass, const Args& a) {
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* mask = static_cast<const uint8_t*>(a.mask);
  const auto* layout = static_cast<const int*>(a.layout);
  cudaError_t err;
  if (pass == kFwd) {
    // the query tile is the slowest grid index (reversed in the kernels)
    const dim3 grid(a.B * a.H, (a.nq + kBlock - 1) / kBlock);
    auto* o = static_cast<bf16*>(a.o);
    auto* lse = static_cast<float*>(a.lse_out);
    if constexpr (D % 64 == 0) {
      CUtensorMap maps[3];
      const int bh = a.B * a.H;
      if (!tile_map<D>(&maps[0], q, bh, a.nq) || !tile_map<D>(&maps[1], k, bh, a.nk) ||
          !tile_map<D>(&maps[2], v, bh, a.nk))
        return cudaErrorInvalidValue;
      if ((err = allow_smem(fwd_wgmma_kernel<D>, fwd_wgmma_smem<D>())) != cudaSuccess) return err;
      fwd_wgmma_kernel<D><<<grid, kMmaThreads, fwd_wgmma_smem<D>(), a.stream>>>(
          maps[0], maps[1], maps[2], mask, layout, o, lse, a.nq, a.nk, a.mode, a.scale);
    } else {
      return cudaErrorInvalidValue;  // the caller pads D = 16, 32 to 64
    }
    return cudaGetLastError();
  }
  const size_t n = (size_t)a.B * a.H * a.nq * D;
  auto* dq_acc = static_cast<float*>(a.dq_acc);
  if ((err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), a.stream)) != cudaSuccess) return err;
  if ((err = allow_smem(bwd_mma_kernel<D>, bwd_mma_smem<D>())) != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.nk + kBlock - 1) / kBlock, D / bwd_out_cols<D>());
  bwd_mma_kernel<D><<<grid, kMmaThreads, bwd_mma_smem<D>(), a.stream>>>(
      q, k, v, static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), mask, layout, dq_acc, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.nq, a.nk, a.mode, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n4 = n / 4;  // D is a multiple of 16
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  dq_convert_kernel<<<blocks, 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(dq_acc), static_cast<__nv_bfloat162*>(a.dq), n4);
  return cudaGetLastError();
}

template <int D>
cudaError_t run(Pass pass, int dtype, const Args& a) {
  return dtype == 1 ? run_tensor_cores<D>(pass, a) : run_cuda_cores<D>(pass, a);
}

int dispatch(Pass pass, int D, int dtype, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.nq <= 0 || a.nk <= 0 || a.B > 65535 || a.H > 65535 ||
      (size_t)a.B * a.H > 2147483647u || (a.nq + kBlock - 1) / kBlock > 65535 ||
      (a.nk + kBlock - 1) / kBlock > 65535 ||
      a.mode < 0 || a.mode > 2 || (a.mode == 2 && (a.mask == nullptr || a.layout == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (pass == kBwd && dtype == 1 && a.dq_acc == nullptr) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)run<16>(pass, dtype, a);
    case 32: return (int)run<32>(pass, dtype, a);
    case 64: return (int)run<64>(pass, dtype, a);
    case 128: return (int)run<128>(pass, dtype, a);
    case 256: return (int)run<256>(pass, dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous and 16-byte aligned: q/dout/o/dq [B,H,nq,D],
// k/v/dk/dv [B,H,nk,D] in `dtype` (0 = float32, 1 = bfloat16); lse/delta
// [B,H,nq] float32; mask [nq,nk] uint8 and layout [ceil(nq/64),
// ceil(nk/64)] int32 for mode 2 (else null). Each launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, const void* layout, void* o, void* lse,
                                   int B, int H, int nq, int nk, int D, int dtype, int mode,
                                   float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.layout = layout; a.o = o; a.lse_out = lse;
  a.B = B; a.H = H; a.nq = nq; a.nk = nk; a.mode = mode; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kFwd, D, dtype, a);
}

// The backward: dq, dk and dv. bfloat16 needs `dq_acc`, a float32
// [B,H,nq,D] workspace that this zeroes, the fused kernel accumulates into
// and a last kernel converts into dq; float32 ignores it.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* mask, const void* layout, void* dq, void* dk,
                                   void* dv, void* dq_acc, int B, int H, int nq, int nk, int D,
                                   int dtype, int mode, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.mask = mask;
  a.layout = layout; a.dq = dq; a.dk = dk; a.dv = dv; a.dq_acc = dq_acc;
  a.B = B; a.H = H; a.nq = nq; a.nk = nk; a.mode = mode; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kBwd, D, dtype, a);
}
