// Flash attention for Hopper (sm_90a): the forward pass and its two
// backward passes (dq, and dk/dv), for training over a whole sequence.
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
//   dq:       p = exp(s - lse), ds = p * (do . v^T - delta) * scale,
//             dq = ds k;
//   dk/dv:    dv = p^T do, dk = ds^T q.
// delta = rowsum(do * o) in fp32 is computed outside (as the reference
// does). Masked scores take the finite value -1e30 in the forward, as in
// the Pallas kernel, so a row's first fully masked tile is wiped out by the
// first live one; every real row must see at least one key (the caller's
// mask check enforces it).
//
// What bounds it: at the training shapes (N = 1280, D = 64) the work is
// ~N^2/2 pairs of 4-8 D-long dot products per head, so the kernels are
// bound by operations, not bytes (K/V are re-read once per 64-row tile
// and stay in L2). Design, simple first:
//   * one thread block per (64-row tile, head, batch row); the block loops
//     over its own 64-wide tiles of the other operand, so Pallas's
//     sequential grid axis becomes an in-block loop and nothing crosses
//     blocks. Causal blocks stop at the last live key tile (forward, dq)
//     or start at the first live query tile (dk/dv); mask blocks skip the
//     tiles the layout marks empty;
//   * bfloat16 inputs run on tensor cores (`mma.sync.m16n8k16`, fp32
//     accumulators; 4 warps of 16 rows, see the second half of this
//     file). P (forward, dv) and dS (dq, dk) are rounded to bf16 before
//     their second product, as FlashAttention does; the softmax state
//     (m, l, lse) and every sum stay fp32;
//   * float32 inputs keep fp32 arithmetic on CUDA cores (256 threads,
//     each owning a 4 x 4 patch of the 64 x 64 score tile and a 4 x D/16
//     patch of the accumulator; tiles staged as fp32 with rows padded to
//     D + 4 so float4 reads are conflict-free); the online softmax reduces
//     over the 16 lanes of a half-warp.
// Not done yet: ldmatrix, cp.async/TMA double buffering, wgmma, a fused
// one-pass backward.

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
// Tensor-core path for bfloat16 inputs: the same three functions with the
// products on `mma.sync.m16n8k16` (bf16 operands, fp32 accumulators). A
// block of 4 warps owns a 64-row tile, 16 rows per warp; tiles are staged
// in shared memory as bf16 (row stride D + 8, and a transposed copy where
// the second product needs the key or query index as its reduction axis),
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const uint8_t* __restrict__ mask, const int* __restrict__ layout,
              bf16* __restrict__ dq, int H, int nq, int nk, int mode, float scale) {
  constexpr int LD = D + 8, NBD = D / 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* dos = qs + kBlock * LD;
  bf16* ks = dos + kBlock * LD;
  bf16* vs = ks + kBlock * LD;
  bf16* kts = vs + kBlock * LD;  // [D][64 + 8]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const size_t bh = (size_t)b * H + h;
  const int q0 = qt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock;
  const int kend = mode == 1 ? min(ktiles, (q0 + kBlock - 1) / kBlock + 1) : ktiles;

  stage_rows<D>(qs, q + bh * nq * D, q0, nq);
  stage_rows<D>(dos, dout + bh * nq * D, q0, nq);
  float row_lse[2], row_delta[2], acc[NBD][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + r0 + g + 8 * hh;
    row_lse[hh] = r < nq ? lse[bh * nq + r] : 0.f;
    row_delta[hh] = r < nq ? delta[bh * nq + r] : 0.f;
  }
#pragma unroll
  for (int nb = 0; nb < NBD; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int kt = 0; kt < kend; ++kt) {
    if (mode == 2 && layout[qt * ktiles + kt] == 0) continue;
    const int k0 = kt * kBlock;
    __syncthreads();
    stage_rows<D>(ks, k + bh * nk * D, k0, nk);
    stage_rows<D>(vs, v + bh * nk * D, k0, nk);
    stage_cols<D>(kts, k + bh * nk * D, k0, nk);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    mma_rows<D, 8, LD, LD>(s, qs, ks, r0, g, t);
    mma_rows<D, 8, LD, LD>(dp, dos, vs, r0, g, t);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + r0 + g + 8 * (e / 2), c = k0 + nb * 8 + 2 * t + (e % 2);
        const float p = visible(r, c, nq, nk, mode, mask)
                            ? expf(s[nb][e] * scale - row_lse[e / 2]) : 0.f;
        s[nb][e] = p * (dp[nb][e] - row_delta[e / 2]) * scale;  // dS
      }
    mma_p<D>(acc, s, kts, g, t);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + r0 + g + 8 * hh;
    if (r >= nq) continue;
    bf16* row = dq + (bh * nq + r) * D + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NBD; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(row + nb * 8) =
          __floats2bfloat162_rn(acc[nb][2 * hh], acc[nb][2 * hh + 1]);
  }
}

// each warp owns 16 KEYS of the block's tile; the score tile is transposed
// (rows keys, columns the streamed query tile's rows)
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const uint8_t* __restrict__ mask, const int* __restrict__ layout,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int nq, int nk, int mode,
               float scale) {
  constexpr int LD = D + 8, NBD = D / 8;
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);
  bf16* vs = ks + kBlock * LD;
  bf16* qs = vs + kBlock * LD;
  bf16* dos = qs + kBlock * LD;
  bf16* qts = dos + kBlock * LD;   // [D][64 + 8]
  bf16* dots = qts + D * kLDT;     // [D][64 + 8]
  float* lse_s = reinterpret_cast<float*>(dots + D * kLDT);
  float* delta_s = lse_s + kBlock;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const size_t bh = (size_t)b * H + h;
  const bf16* qb = q + bh * nq * D;
  const bf16* db = dout + bh * nq * D;
  const int k0 = kt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock;
  const int qtiles = (nq + kBlock - 1) / kBlock;
  const int qbegin = mode == 1 ? k0 / kBlock : 0;

  stage_rows<D>(ks, k + bh * nk * D, k0, nk);
  stage_rows<D>(vs, v + bh * nk * D, k0, nk);
  float dk_acc[NBD][4], dv_acc[NBD][4];
#pragma unroll
  for (int nb = 0; nb < NBD; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.f;

  for (int qt = qbegin; qt < qtiles; ++qt) {
    if (mode == 2 && layout[qt * ktiles + kt] == 0) continue;
    const int q0 = qt * kBlock;
    __syncthreads();
    stage_rows<D>(qs, qb, q0, nq);
    stage_rows<D>(dos, db, q0, nq);
    stage_cols<D>(qts, qb, q0, nq);
    stage_cols<D>(dots, db, q0, nq);
    for (int r = threadIdx.x; r < kBlock; r += kMmaThreads) {
      lse_s[r] = q0 + r < nq ? lse[bh * nq + q0 + r] : 0.f;
      delta_s[r] = q0 + r < nq ? delta[bh * nq + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    mma_rows<D, 8, LD, LD>(s, ks, qs, r0, g, t);
    mma_rows<D, 8, LD, LD>(dp, vs, dos, r0, g, t);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + r0 + g + 8 * (e / 2), rl = nb * 8 + 2 * t + (e % 2);
        // padded query rows (>= nq) are dropped here: their lse never
        // reaches dk/dv
        const float p = visible(q0 + rl, c, nq, nk, mode, mask)
                            ? expf(s[nb][e] * scale - lse_s[rl]) : 0.f;
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - delta_s[rl]) * scale;  // dS^T
      }
    mma_p<D>(dv_acc, s, dots, g, t);
    mma_p<D>(dk_acc, dp, qts, g, t);
  }

  // every block writes its rows, zeros when no query tile was live
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
template <int D>
constexpr size_t dq_mma_smem() { return sizeof(bf16) * (4 * kBlock * (D + 8) + D * kLDT); }
template <int D>
constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * (4 * kBlock * (D + 8) + 2 * D * kLDT) + sizeof(float) * 2 * kBlock;
}

// dynamic shared memory above 48 KB must be opted into once per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *mask, *layout;
  void *o, *lse_out, *dq, *dk, *dv;
  int B, H, nq, nk, mode;
  float scale;
  cudaStream_t stream;
};

enum Pass { kFwd, kDq, kDkv };

// float32 inputs: the CUDA-core kernels
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
  const dim3 grid(((pass == kDkv ? a.nk : a.nq) + kBlock - 1) / kBlock, a.H, a.B);
  cudaError_t err;
  if (pass == kFwd) {
    if ((err = allow_smem(fwd_kernel<D>, fwd_smem<D>())) != cudaSuccess) return err;
    fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), a.stream>>>(
        q, k, v, mask, layout, static_cast<float*>(a.o), static_cast<float*>(a.lse_out), a.H,
        a.nq, a.nk, a.mode, a.scale);
  } else if (pass == kDq) {
    if ((err = allow_smem(dq_kernel<D>, dq_smem<D>())) != cudaSuccess) return err;
    dq_kernel<D><<<grid, kThreads, dq_smem<D>(), a.stream>>>(
        q, k, v, dout, lse, delta, mask, layout, static_cast<float*>(a.dq), a.H, a.nq, a.nk,
        a.mode, a.scale);
  } else {
    if ((err = allow_smem(dkv_kernel<D>, dkv_smem<D>())) != cudaSuccess) return err;
    dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(), a.stream>>>(
        q, k, v, dout, lse, delta, mask, layout, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.H, a.nq, a.nk, a.mode, a.scale);
  }
  return cudaGetLastError();
}

// bfloat16 inputs: the tensor-core kernels
template <int D>
cudaError_t run_tensor_cores(Pass pass, const Args& a) {
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* dout = static_cast<const bf16*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* delta = static_cast<const float*>(a.delta);
  const auto* mask = static_cast<const uint8_t*>(a.mask);
  const auto* layout = static_cast<const int*>(a.layout);
  const dim3 grid(((pass == kDkv ? a.nk : a.nq) + kBlock - 1) / kBlock, a.H, a.B);
  cudaError_t err;
  if (pass == kFwd) {
    if ((err = allow_smem(fwd_mma_kernel<D>, fwd_mma_smem<D>())) != cudaSuccess) return err;
    fwd_mma_kernel<D><<<grid, kMmaThreads, fwd_mma_smem<D>(), a.stream>>>(
        q, k, v, mask, layout, static_cast<bf16*>(a.o), static_cast<float*>(a.lse_out), a.H,
        a.nq, a.nk, a.mode, a.scale);
  } else if (pass == kDq) {
    if ((err = allow_smem(dq_mma_kernel<D>, dq_mma_smem<D>())) != cudaSuccess) return err;
    dq_mma_kernel<D><<<grid, kMmaThreads, dq_mma_smem<D>(), a.stream>>>(
        q, k, v, dout, lse, delta, mask, layout, static_cast<bf16*>(a.dq), a.H, a.nq, a.nk,
        a.mode, a.scale);
  } else {
    if ((err = allow_smem(dkv_mma_kernel<D>, dkv_mma_smem<D>())) != cudaSuccess) return err;
    dkv_mma_kernel<D><<<grid, kMmaThreads, dkv_mma_smem<D>(), a.stream>>>(
        q, k, v, dout, lse, delta, mask, layout, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.H, a.nq, a.nk, a.mode, a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t run(Pass pass, int dtype, const Args& a) {
  return dtype == 1 ? run_tensor_cores<D>(pass, a) : run_cuda_cores<D>(pass, a);
}

int dispatch(Pass pass, int D, int dtype, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.nq <= 0 || a.nk <= 0 || a.B > 65535 || a.H > 65535 ||
      a.mode < 0 || a.mode > 2 || (a.mode == 2 && (a.mask == nullptr || a.layout == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
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

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  const void* mask, const void* layout, void* dq, int B, int H,
                                  int nq, int nk, int D, int dtype, int mode, float scale,
                                  void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.mask = mask;
  a.layout = layout; a.dq = dq;
  a.B = B; a.H = H; a.nq = nq; a.nk = nk; a.mode = mode; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kDq, D, dtype, a);
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* mask, const void* layout, void* dk, void* dv,
                                   int B, int H, int nq, int nk, int D, int dtype, int mode,
                                   float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.mask = mask;
  a.layout = layout; a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.nq = nq; a.nk = nk; a.mode = mode; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kDkv, D, dtype, a);
}
