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
//     layout marks empty;
//   * backward in bfloat16: one fused pass, FlashAttention-2's (second
//     half of this file): a block per (64-key tile, head, batch row) loops
//     over the query tiles that see its keys, computes S and dP once per
//     tile, accumulates dK and dV in registers and adds dQ into an fp32
//     workspace with atomics; operands by ldmatrix from padded row-major
//     tiles (no transposed copies), the next query tile loaded by cp.async
//     while the current one computes;
//   * bfloat16 inputs run on tensor cores (`mma.sync.m16n8k16`, fp32
//     accumulators). P (forward, dv) and dS (dq, dk) are rounded to bf16
//     before their second product, as FlashAttention does -- dS once, for
//     both dk and dq; the softmax state (m, l, lse) and every sum stay fp32;
//   * float32 inputs keep fp32 arithmetic on CUDA cores (256 threads,
//     each owning a 4 x 4 patch of the 64 x 64 score tile and a 4 x D/16
//     patch of the accumulator; tiles staged as fp32 with rows padded to
//     D + 4 so float4 reads are conflict-free); the online softmax reduces
//     over the 16 lanes of a half-warp; the backward is two passes, dq (by
//     query tile) and dk/dv (by key tile), each recomputing p.
// Not done yet: wgmma, TMA, a pipelined forward.

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
  float* vs = ks + kBlock * LD;
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
    __syncthreads();
    stage_tile<D>(ks, kb, k0, nk, 1.f);
    stage_tile<D>(vs, vb, k0, nk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(s, qs, ks, ty, tx);
    tile_dot<D>(dp, dos, vs, ty, tx);
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
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kBlock * LD;
  float* qs = vs + kBlock * LD;
  float* dos = qs + kBlock * LD;
  float* pts = dos + kBlock * LD;
  float* dsts = pts + kBlock * kPLD;
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

  stage_tile<D>(ks, k + bh * nk * D, k0, nk, 1.f);
  stage_tile<D>(vs, v + bh * nk * D, k0, nk, 1.f);
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
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(s, ks, qs, ty, tx);
    tile_dot<D>(dp, vs, dos, ty, tx);
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
        pts[(ty + 16 * i) * kPLD + rl] = p;
        dsts[(ty + 16 * i) * kPLD + rl] = p * (dp[i][j] - delta_s[rl]) * scale;
      }
    }
    __syncwarp();
    tile_acc<D>(dv_acc, pts, dos, ty, tx);
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
// Tensor-core path for bfloat16 inputs, with the products on
// `mma.sync.m16n8k16` (bf16 operands, fp32 accumulators). The forward: a
// block of 4 warps owns a 64-row tile, 16 rows per warp; tiles are staged
// in shared memory as bf16 (row stride D + 8, and a transposed copy of V),
// and fragments are read with 32-bit loads that hit 32 distinct banks. The
// score / probability tile stays in the accumulator registers: its rows
// reduce over the 4 lanes of a quad, and it becomes the A operand of the
// second product in place, rounded to bf16 (P for o and dv, dS for dq and
// dk) -- the one rounding the CUDA-core path does not have.
// Fragment layouts (PTX ISA, m16n8k16): g = lane / 4, t = lane % 4;
//   A 16x16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8:  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8:  c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)

constexpr int kMmaThreads = 128;
constexpr int kLDT = kBlock + 8;  // stride of a transposed [D][64] tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of a row-major [n, D] bf16 matrix -> shared memory,
// row-major with stride D + 8 (rows >= n are zero)
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                           int n) {
  constexpr int CH = D / 8, LD = D + 8;
  for (int c = threadIdx.x; c < kBlock * CH; c += kMmaThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) raw = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + d0);
    *reinterpret_cast<uint4*>(dst + r * LD + d0) = raw;
  }
}

// the same rows transposed: dst[d][r], stride 64 + 8
template <int D>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* __restrict__ src, int row0,
                                           int n) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < kBlock * CH; c += kMmaThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) raw = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + d0);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(d0 + i) * kLDT + r] = e[i];
  }
}

// acc[nb] (16 x 8 each, nb < NB) += X[r0 .. r0+16) . Y[nb*8 .. nb*8+8)^T over
// the K-long rows of X (stride LDX) and Y (stride LDY)
template <int K, int NB, int LDX, int LDY>
__device__ __forceinline__ void mma_rows(float (&acc)[NB][4], const bf16* x, const bf16* y,
                                         int r0, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    const bf16* xa = x + (r0 + g) * LDX + kc * 16 + 2 * t;
    const uint32_t a[4] = {ld32(xa), ld32(xa + 8 * LDX), ld32(xa + 8), ld32(xa + 8 * LDX + 8)};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const bf16* yb = y + (nb * 8 + g) * LDY + kc * 16 + 2 * t;
      mma_bf16(acc[nb], a, ld32(yb), ld32(yb + 8));
    }
  }
}

// acc[nb] (16 x 8 each over D) += P . Y where P is a 16 x 64 tile held in
// accumulator layout (p[8][4]) and Y^T is staged as [D][64 + 8]
template <int D>
__device__ __forceinline__ void mma_p(float (&acc)[D / 8][4], const float (&p)[8][4],
                                      const bf16* yt, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < kBlock / 16; ++kc) {
    const uint32_t a[4] = {
        pack_bf16(p[2 * kc][0], p[2 * kc][1]), pack_bf16(p[2 * kc][2], p[2 * kc][3]),
        pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
        pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const bf16* yb = yt + (nb * 8 + g) * kLDT + kc * 16 + 2 * t;
      mma_bf16(acc[nb], a, ld32(yb), ld32(yb + 8));
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
               const int* __restrict__ layout, bf16* __restrict__ o, float* __restrict__ lse,
               int H, int nq, int nk, int mode, float scale) {
  constexpr int LD = D + 8, NBD = D / 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + kBlock * LD;
  bf16* vts = ks + kBlock * LD;  // [D][64 + 8]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const size_t bh = (size_t)b * H + h;
  const int q0 = qt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock;
  const int kend = mode == 1 ? min(ktiles, (q0 + kBlock - 1) / kBlock + 1) : ktiles;

  stage_rows<D>(qs, q + bh * nq * D, q0, nq);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, acc[NBD][4];
#pragma unroll
  for (int nb = 0; nb < NBD; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int kt = 0; kt < kend; ++kt) {
    if (mode == 2 && layout[qt * ktiles + kt] == 0) continue;  // block-uniform
    const int k0 = kt * kBlock;
    __syncthreads();
    stage_rows<D>(ks, k + bh * nk * D, k0, nk);
    stage_cols<D>(vts, v + bh * nk * D, k0, nk);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    mma_rows<D, 8, LD, LD>(s, qs, ks, r0, g, t);

    float tmax[2] = {kNeg, kNeg};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + r0 + g + 8 * (e / 2), c = k0 + nb * 8 + 2 * t + (e % 2);
        s[nb][e] = visible(r, c, nq, nk, mode, mask) ? s[nb][e] * scale : kNeg;
        tmax[e / 2] = fmaxf(tmax[e / 2], s[nb][e]);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(tmax[hh]));
      corr[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = expf(s[nb][e] - m[e / 2]);
        psum[e / 2] += s[nb][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + quad_sum(psum[hh]);
#pragma unroll
    for (int nb = 0; nb < NBD; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] *= corr[e / 2];
    mma_p<D>(acc, s, vts, g, t);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + r0 + g + 8 * hh;
    if (r >= nq) continue;
    const float safe_l = fmaxf(l[hh], 1e-30f);
    bf16* orow = o + (bh * nq + r) * D + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NBD; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) =
          __floats2bfloat162_rn(acc[nb][2 * hh] / safe_l, acc[nb][2 * hh + 1] / safe_l);
    if (t == 0) lse[bh * nq + r] = m[hh] + logf(safe_l);
  }
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

constexpr int kBwdThreads = 128;

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
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
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
  for (int c = threadIdx.x; c < kBlock * CH; c += kBwdThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * LD + d0, src + (size_t)(ok ? row0 + r : 0) * D + d0, ok);
  }
}

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

// at most 170 registers a thread, so 3 blocks share an SM; at D = 128 the
// shared memory (115 KB a block) fits only 2, so the registers may too
template <int D>
__global__ void __launch_bounds__(kBwdThreads, D == 128 ? 2 : 3)
bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const uint8_t* __restrict__ mask, const int* __restrict__ layout,
               float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv, int nq,
               int nk, int mode, float scale) {
  constexpr int LD = D + 8, NBD = D / 8, DC = D < 64 ? D : 64;
  extern __shared__ float4 smem4[];
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
    const bool full = mode != 2 && q0 + kBlock <= nq && k0 + kBlock <= nk &&
                      (mode == 0 || k0 + kBlock - 1 <= q0);
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
        for (int nd = 0; nd < D / 16; ++nd) {
          const int brow = (qh + kc * 16 + (lane & 15)) * LD + nd * 16 + (lane >> 4) * 8;
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

    // dQ[r0 .. r0 + 16) += dS K over the 64 keys, in 64-column chunks,
    // added into the fp32 workspace
#pragma unroll
    for (int dc = 0; dc < D / DC; ++dc) {
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
    bf16* krow = dk + (bh * nk + c) * D + 2 * t;
    bf16* vrow = dv + (bh * nk + c) * D + 2 * t;
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
constexpr size_t dq_smem() { return sizeof(float) * (4 * kBlock * (D + 4) + kBlock * kPLD); }
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kBlock * (D + 4) + 2 * kBlock * kPLD + 2 * kBlock);
}

template <int D>
constexpr size_t fwd_mma_smem() { return sizeof(bf16) * (2 * kBlock * (D + 8) + D * kLDT); }

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
    if ((err = allow_smem(fwd_mma_kernel<D>, fwd_mma_smem<D>())) != cudaSuccess) return err;
    const dim3 grid((a.nq + kBlock - 1) / kBlock, a.H, a.B);
    fwd_mma_kernel<D><<<grid, kMmaThreads, fwd_mma_smem<D>(), a.stream>>>(
        q, k, v, mask, layout, static_cast<bf16*>(a.o), static_cast<float*>(a.lse_out), a.H,
        a.nq, a.nk, a.mode, a.scale);
    return cudaGetLastError();
  }
  const size_t n = (size_t)a.B * a.H * a.nq * D;
  auto* dq_acc = static_cast<float*>(a.dq_acc);
  if ((err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), a.stream)) != cudaSuccess) return err;
  if ((err = allow_smem(bwd_mma_kernel<D>, bwd_mma_smem<D>())) != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.nk + kBlock - 1) / kBlock);
  bwd_mma_kernel<D><<<grid, kBwdThreads, bwd_mma_smem<D>(), a.stream>>>(
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
      (size_t)a.B * a.H > 2147483647u ||
      a.mode < 0 || a.mode > 2 || (a.mode == 2 && (a.mask == nullptr || a.layout == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (pass == kBwd && dtype == 1 && a.dq_acc == nullptr) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)run<16>(pass, dtype, a);
    case 32: return (int)run<32>(pass, dtype, a);
    case 64: return (int)run<64>(pass, dtype, a);
    case 128: return (int)run<128>(pass, dtype, a);
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
