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
//     layout marks empty; the query tiles with the most key tiles start
//     first; in bfloat16 on wgmma with TMA tiles (D = 64, 128, 256; the
//     wrapper pads other D to the next), see the tensor-core section;
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
//   * float32 inputs run on tensor cores too, every product in TF32 split
//     three ways so it keeps ~21 of fp32's 24 bits, P and dS split from
//     their fp32 values and never rounded (the section before the host
//     code): the forward as one pass (`fwd_tf32_kernel`), the backward as
//     two, dq (by query tile) and dk/dv (by key tile), each recomputing p;
//   * head dims: instances at D = 16, 32, 64, 128 and 256 (the wrapper
//     zero-pads any other D <= 256 to the next). At 256 the fused bf16
//     backward splits the output columns over two blocks (`bwd_out_cols`),
//     and the fp32 kernels stream D in 32-channel chunks.
// Not done yet: wgmma and TMA in the backward.

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime, no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;     // query and key tile
constexpr float kNeg = -1e30f;

// whether (query row r, key c) is attended: bounds, then the arm
__device__ __forceinline__ bool visible(int r, int c, int nq, int nk, int mode,
                                        const uint8_t* __restrict__ mask) {
  if (r >= nq || c >= nk) return false;
  if (mode == 1) return c <= r;
  if (mode == 2) return mask[(size_t)r * nk + c] != 0;
  return true;
}

// ---------------------------------------------------------------------------
// Tensor-core path for bfloat16 inputs: bf16 operands, fp32 accumulators.
// A block is one warpgroup (4 warps, 128 threads) owning a 64-row tile, 16
// rows per warp. The score / probability tile stays in the accumulator
// registers: its rows reduce over the 4 lanes of a quad, and it becomes the
// A operand of the second product in place, rounded to bf16 (P for o and
// dv, dS for dq and dk) -- the one rounding the float32 path does not
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

// ---------------------------------------------------------------------------
// float32 on tensor cores: the forward as one pass, as the TPU kernel
// `_fwd_kernel` does, and the backward as two, as `_dq_kernel` and
// `_dkv_kernel` do, every product on mma.sync
// (m16n8k8, TF32 operands, fp32 accumulators) with each fp32 operand x
// split into hi = rna(x) and lo = rna(x - hi), TF32 values both, and each
// product formed as lo.hi + hi.lo + hi.hi, small terms first (the
// arithmetic of CUTLASS's OpMultiplyAddFastF32, which SDPA's fp32 kernels
// run): a product keeps ~21 of fp32's 24 bits, and P and dS are split from
// their fp32 values, never rounded to bf16. p, dS and every sum stay fp32.
//   * `fwd_tf32_kernel<D>`: a block per (batch row and head, 64-query
//     tile), the tiles with the most keys first, loops over the live 64-key
//     tiles with the online softmax; o and lse written once (see its own
//     comment);
//   * `dq_tf32_kernel<D>`: a block per (batch row and head, 64-query tile),
//     the tiles with the most keys first, loops over the live 64-key
//     tiles; dq by query tile, written once;
//   * `dkv_tf32_kernel<D>`: a block per (batch row and head, 64-key tile)
//     loops over the query tiles that see its keys; dk and dv written once
//     (at D = 256 two blocks a key tile, each owning half of dK's and dV's
//     columns and forming S^T and dP^T itself: 128 accumulator registers a
//     thread beside the rest spilled).
// No atomics: o, lse, dq, dk and dv are bit-identical run to run. The
// backward's block is 8 warps: four groups of 16 rows (queries in the dq pass, keys in the dk/dv
// pass) times two roles. Role 0 forms S (S^T), role 1 dP (dP^T), each a
// 16 x 64 accumulator fragment a warp, over all of D; role 0 turns S into
// P = 2^(S scale log2(e) - lse log2(e)) in fp32 (ex2.approx of one FMA;
// the arm's mask only on tiles that need it: the causal diagonal, edges
// past nq or nk, every live static-mask tile) and hands it to its partner
// warp through shared memory, which forms dS = P (dP - delta) scale. Then
// the dq pass hands dS back, and each role adds dS K into its half of
// dQ's columns; in the dk/dv pass
// role 0 adds P^T dO into dV and role 1 dS^T Q into dK, over all columns.
// P and dS enter those products from registers: a thread's accumulator
// columns 2t, 2t + 1 of a k-step are taken as its A fragment's k = t, t +
// 4, so B is read at rows 2t and 2t + 1 (scalar loads, conflict-free at a
// row stride of 4 mod 8 floats). S and dP read both operands with
// ldmatrix (8 x 4 fp32 blocks: a 32-bit element a thread).
// Operands: the block's own 64 rows of its two fixed operands (Q and dO;
// K and V) stay in shared memory, loaded once; the streamed ones arrive by
// cp.async through a ring of STAGES slots, one item a slot: an S/dP item
// is a chunk (64 channels, 32 at D = 256) of both streamed operands (K
// and V; Q, dO, lse and delta), so S and dP accumulate over D in chunks
// and no buffer is shared or restaged; at D > 64 the second products need
// the streamed operand's other chunks again (K; Q and dO), which column
// items bring after the last S/dP item (its own chunk is still in its
// slot). The next item is in flight while one computes (at D <= 64 the
// next two); rows past nq or nk are zero-filled by the copy. A landed item
// is split into hi and lo once for the block (`split_slot`), so the warps
// split only their A operands. Two __syncthreads an item.
// What bounds it: operations. 14 D flops a visible pair (S and dP in both
// passes, then dQ, dV, dK; 18 D at D = 256, whose two dk/dv blocks each
// form S and dP), three TF32 products each: 42 D a pair on a
// 495 TF/s TF32 peak, against a bound of 10 D a pair (3 x 10 D at that
// peak with the split). Shared memory: 227 KB at D = 64 (3 stages), 224 KB
// at 128 and 256 (2): one block an SM.

constexpr int kTfThreads = 256;
constexpr int kMaxDevices = 64;

template <int D>
struct TfPlan {
  static constexpr int CH = D < 64 ? D : D > 128 ? 32 : 64;  // channels of a streamed chunk
  static constexpr int NC = D / CH;                    // chunks over D
  static constexpr int LDR = D + 4;                    // a resident tile's row stride (floats)
  static constexpr int LDC = CH + 4;                   // a chunk tile's
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int CHUNK = kBlock * LDC;           // floats of a chunk tile
  static constexpr int SLOT = 2 * CHUNK + 2 * kBlock;  // two chunk tiles, then lse and delta
  static constexpr int SPLIT = 4 * CHUNK;              // a slot's tiles split: two hi, two lo
  static constexpr int XCHG = 4 * 8 * 32 * 4;          // a 16 x 64 fragment for each row group
  // dk/dv blocks a key tile: at D = 256 two, each owning half of dK's and
  // dV's columns (their 128 accumulator registers a thread would spill)
  static constexpr int KV_SPLIT = D > 128 ? 2 : 1;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * kBlock * LDR + STAGES * SLOT + SPLIT + XCHG);
  // the forward: Q resident, the ring (deeper at D = 256, whose items are
  // 32-channel chunks), its split, and two fragments a row group (the S
  // halves of both roles)
  static constexpr int FWD_STAGES = D > 128 ? 4 : STAGES;
  static constexpr size_t FWD_SMEM =
      sizeof(float) * (kBlock * LDR + FWD_STAGES * SLOT + SPLIT + 2 * XCHG);
  static_assert(D % 16 == 0 && D <= 256 && SMEM <= 232448 && FWD_SMEM <= 232448,
                "an instance's shared memory");
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32: hi = rna(x), lo = rna(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b over one k-step of 8 from the split operands: the small terms lo.hi
// + hi.lo into `small`, first, and hi.hi into `big`
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// four 8 x 4 fp32 blocks; lanes 8i..8i+7 give the row addresses of block i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A landed slot's two chunk tiles split once for the whole block, into
// `buf`: hi of tile 0 and of tile 1, then lo of each (TF32 values in fp32
// registers' bits), so the products read both halves of a B operand and
// split only their A operands (four warps of a role read the same B).
template <int CHUNK>
__device__ __forceinline__ void split_slot(float* buf, const float* slot) {
  const float4* x4 = reinterpret_cast<const float4*>(slot);
  float4* hi = reinterpret_cast<float4*>(buf);
  float4* lo = reinterpret_cast<float4*>(buf + 2 * CHUNK);
#pragma unroll 4
  for (int i = threadIdx.x; i < CHUNK / 2; i += kTfThreads) {  // 2 CHUNK floats, 4 a step
    const float4 x = x4[i];
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                        __uint_as_float(h[3]));
    lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                        __uint_as_float(l[3]));
  }
}

// the two warps of row group `grp` (roles 0 and 1) meet
__device__ __forceinline__ void pair_sync(int grp) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + grp) : "memory");
}

// rows [row0, row0 + 64) x channels [c0, c0 + W) of a row-major [n, D]
// float matrix into shared memory at row stride LD, by cp.async in 16-byte
// pieces (rows >= n zero-filled)
template <int W, int LD, int D>
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src, int row0, int n,
                                          int c0) {
  constexpr int PER_ROW = W / 4;
#pragma unroll
  for (int e = threadIdx.x; e < kBlock * PER_ROW; e += kTfThreads) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 4;
    const bool ok = row0 + r < n;
    cp_async16(smem_addr(dst + r * LD + c), src + (size_t)(ok ? row0 + r : 0) * D + c0 + c, ok);
  }
}

// The tensor cores' fp32 accumulation drops the bits below the sum's
// last place (toward zero) at every mma, so a long chain of mma into one
// accumulator shrinks it by ~2^-24 a step: ~3e-5 after the 480 mma of a
// dV over 1280 queries. So each tile's (and each chunk's) partial sum runs
// in fresh accumulators, hi.hi in one (one mma a k-step) and the small
// terms in another (two a k-step, at ~2^-11 of the partial, so their
// dropped bits are that much smaller), and big + small is added into the
// running fp32 sum with ordinary (round-to-nearest) adds.

// s[nb] (+)= X Y^T for this warp: X's 16 rows, its split A fragments of
// k-step ks (channels 8 ks .. 8 ks + 7) given by `a_frag(ks, hi, lo)`; Y's
// 64 rows at y (a split chunk tile's hi, its lo LO floats on; stride LDY),
// over CH channels; s[nb] holds columns 8 nb .. 8 nb + 7 in the accumulator
// layout.
// FIRST: s is zero and takes the chunk's products directly; else the
// chunk's partial forms in fresh accumulators, GN column tiles at a time,
// and is added into s.
template <int CH, int LDY, int LO, bool FIRST, int GN, typename AFrag>
__device__ __forceinline__ void score_product_by(float (&s)[8][4], AFrag a_frag, const float* y, int lane) {
  constexpr int G = FIRST ? 8 : GN;  // column tiles a pass
  const float* yb = y + (((lane >> 4) << 3) + (lane & 7)) * LDY + ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int n0 = 0; n0 < 8; n0 += G) {
    float t[G][4], u[G][4];  // hi.hi and the small terms
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[i][e] = u[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < CH / 8; ++ks) {
      uint32_t ah[4], al[4];
      a_frag(ks, ah, al);
#pragma unroll
      for (int np = 0; np < G / 2; ++np) {
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, yb + (n0 / 2 + np) * 16 * LDY + ks * 8);
        ldsm_x4(bl, yb + LO + (n0 / 2 + np) * 16 * LDY + ks * 8);
        mma_3xtf32(t[2 * np], u[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(t[2 * np + 1], u[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float part = __fadd_rn(t[i][e], u[i][e]);
        s[n0 + i][e] = FIRST ? part : __fadd_rn(s[n0 + i][e], part);
      }
  }
}

// the A fragments of k-step ks of X's 16 rows at x (row stride LDX), read
// by ldmatrix and split into hi and lo
template <int LDX>
__device__ __forceinline__ void x_frag(const float* x, int ks, int lane, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  uint32_t a[4];
  ldsm_x4(a, x + (lane & 15) * LDX + (lane >> 4) * 4 + ks * 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
}

// score_product_by with X's 16 rows at x (row stride LDX), split as they
// are read
template <int CH, int LDX, int LDY, int LO, bool FIRST, int GN>
__device__ __forceinline__ void score_product(float (&s)[8][4], const float* x, const float* y,
                                              int lane) {
  score_product_by<CH, LDY, LO, FIRST, GN>(
      s, [&](int ks, uint32_t (&ah)[4], uint32_t (&al)[4]) { x_frag<LDX>(x, ks, lane, ah, al); }, y, lane);
}

// acc[off + nt] += F Y[:, 8 nt .. 8 nt + 8) for nt < NT: F a warp's 16 x
// 64 fragment (accumulator layout; its k-step kk is columns 8 kk .. 8 kk +
// 7, a thread's columns 2t and 2t + 1 taken as k = t and t + 4), its split
// A fragments of k-step kk given by `a_frag(kk, hi, lo)`; Y 64 rows at y (a
// split chunk tile's hi, its lo LO floats on; stride LDY).
// This tile's partial of each column tile forms in fresh accumulators,
// GN column tiles at a time, and is added into acc.
template <int NT, int LDY, int LO, int GN, int NACC, typename AFrag>
__device__ __forceinline__ void frag_product_by(float (&acc)[NACC][4], int off, AFrag a_frag,
                                                const float* y, int lane) {
  constexpr int G = NT < GN ? NT : GN;  // column tiles a pass
  const float* yb = y + 2 * (lane & 3) * LDY + (lane >> 2);
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += G) {
    float t[G][4], u[G][4];  // hi.hi and the small terms
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[i][e] = u[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      a_frag(kk, ah, al);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float* b = yb + 8 * kk * LDY + 8 * (n0 + i);
        const uint32_t bh0 = __float_as_uint(b[0]), bh1 = __float_as_uint(b[LDY]);
        const uint32_t bl0 = __float_as_uint(b[LO]), bl1 = __float_as_uint(b[LO + LDY]);
        mma_3xtf32(t[i], u[i], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[off + n0 + i][e] = __fadd_rn(acc[off + n0 + i][e], __fadd_rn(t[i][e], u[i][e]));
  }
}

// frag_product_by with F in this thread's registers, split as it is read
template <int NT, int LDY, int LO, int GN, int NACC>
__device__ __forceinline__ void frag_product(float (&acc)[NACC][4], int off, const float (&f)[8][4],
                                             const float* y, int lane) {
  frag_product_by<NT, LDY, LO, GN>(
      acc, off,
      [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
        split_tf32(f[kk][0], ah[0], al[0]);
        split_tf32(f[kk][2], ah[1], al[1]);
        split_tf32(f[kk][1], ah[2], al[2]);
        split_tf32(f[kk][3], ah[3], al[3]);
      },
      y, lane);
}

// the row group's 16 x 64 fragment through shared memory ([8][32 lanes]
// float4s a group: conflict-free)
__device__ __forceinline__ void put_frag(float* xchg, int grp, int lane, const float (&f)[8][4]) {
  float4* w = reinterpret_cast<float4*>(xchg) + grp * 8 * 32 + lane;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) w[nb * 32] = make_float4(f[nb][0], f[nb][1], f[nb][2], f[nb][3]);
}
__device__ __forceinline__ void get_frag(const float* xchg, int grp, int lane, float (&f)[8][4]) {
  const float4* w = reinterpret_cast<const float4*>(xchg) + grp * 8 * 32 + lane;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const float4 x = w[nb * 32];
    f[nb][0] = x.x; f[nb][1] = x.y; f[nb][2] = x.z; f[nb][3] = x.w;
  }
}

// dS = P (dP - delta) scale, as the plain version rounds it
__device__ __forceinline__ float ds_of(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

struct TfItem {
  int tile, step;  // a key tile (dq) or query tile (dk/dv), and the item within it
};

// The ring: items 0, 1, ... of a block, each filling one of STAGES slots
// of SLOT floats, `fetch(item, slot)` issuing its copies (cp.async issued
// before the call join the first item's group) and `compute(item, slot)`
// consuming it; `next` advances an item, `done` ends.
template <int STAGES, int SLOT, typename Next, typename Done, typename Fetch, typename Compute>
__device__ __forceinline__ void tf_ring(float* ring, TfItem first, Next next, Done done, Fetch fetch,
                                        Compute compute) {
  TfItem f = first, c = first;
#pragma unroll 1
  for (int st = 0; st < STAGES - 1; ++st) {
    if (!done(f)) {
      fetch(f, ring + st * SLOT);
      f = next(f);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int it = 0; !done(c); ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of item `it` landed
    __syncthreads();              // everyone's; and item it - 1's slot is consumed
    if (!done(f)) {
      fetch(f, ring + ((it + STAGES - 1) % STAGES) * SLOT);
      f = next(f);
    }
    cp_async_commit();
    compute(c, ring + (it % STAGES) * SLOT);
    c = next(c);
  }
  cp_async_wait<0>();
}

// dq: grid (B * H, ceil(nq / 64)), the query tile the slowest index and
// reversed, so the causal blocks with the most key tiles start first
template <int D>
__global__ void __launch_bounds__(kTfThreads, 1)
dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const uint8_t* __restrict__ mask, const int* __restrict__ layout,
               float* __restrict__ dq, int nq, int nk, int mode, float scale) {
  using P = TfPlan<D>;
  constexpr int CH = P::CH, NC = P::NC, LDR = P::LDR, LDC = P::LDC;
  constexpr int NT = CH / 16;   // a role's column tiles of a chunk: half its columns
  constexpr int NCOL = NC / 2;  // column items: K's chunks below the last, two a slot
  constexpr int GN = 4;         // column tiles of a fresh partial
  constexpr int LO = 2 * P::CHUNK;  // a split tile's lo, from its hi
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][LDR], resident
  float* dos = qs + kBlock * LDR;
  float* ring = dos + kBlock * LDR;
  float* buf = ring + P::STAGES * P::SLOT;  // the computing slot's tiles, split
  float* xchg = buf + P::SPLIT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, role = warp / 4, grp = warp % 4;
  const int g = lane / 4, t = lane % 4, r0 = 16 * grp;
  const size_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock;
  const int kend = key_tile_end(mode, q0, nk);
  const float* kb = k + bh * nk * D;
  const float* vb = v + bh * nk * D;

  copy_rows<D, LDR, D>(qs, q + bh * nq * D, q0, nq, 0);
  copy_rows<D, LDR, D>(dos, dout + bh * nq * D, q0, nq, 0);
  // P = 2^(s scale log2(e) - lse log2(e)): ex2.approx of one FMA (within
  // ~1e-6 relative of expf(s scale - lse), at a fifth of its instructions)
  const float scale_log2 = scale * kLog2e;
  float row_lse[2], row_delta[2];  // lse in base 2
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + r0 + g + 8 * hh;
    row_lse[hh] = r < nq ? lse[bh * nq + r] * kLog2e : 0.f;
    row_delta[hh] = r < nq ? delta[bh * nq + r] : 0.f;
  }

  auto next = [&](TfItem x) {
    return ++x.step < NC + NCOL ? x
                                : TfItem{next_key_tile(x.tile + 1, kend, mode, layout, qt, ktiles), 0};
  };
  auto done = [&](TfItem x) { return x.tile >= kend; };
  auto fetch = [&](TfItem x, float* slot) {
    const int key0 = x.tile * kBlock;
    if (x.step < NC) {  // chunk `step` of K and of V
      copy_rows<CH, LDC, D>(slot, kb, key0, nk, x.step * CH);
      copy_rows<CH, LDC, D>(slot + P::CHUNK, vb, key0, nk, x.step * CH);
    } else {  // K's chunks c and c + 1, below the last
      const int c = 2 * (x.step - NC);
      copy_rows<CH, LDC, D>(slot, kb, key0, nk, c * CH);
      if (c + 1 < NC - 1) copy_rows<CH, LDC, D>(slot + P::CHUNK, kb, key0, nk, (c + 1) * CH);
    }
  };

  float s[8][4], acc[NC * NT][4];  // s: S (role 0) or dP (role 1), then dS
#pragma unroll
  for (int i = 0; i < NC * NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const float* xs = (role == 0 ? qs : dos) + r0 * LDR;
  const int half = role * (CH / 2);  // this role's columns of each chunk

  auto compute = [&](TfItem x, const float* slot) {
    split_slot<P::CHUNK>(buf, slot);
    __syncthreads();  // block-uniform: every thread computes the same item
    if (x.step < NC) {
      if (x.step == 0) {
        score_product<CH, LDR, LDC, LO, true, GN>(s, xs, buf + role * P::CHUNK, lane);
      } else if constexpr (NC > 1) {
        score_product<CH, LDR, LDC, LO, false, GN>(s, xs + x.step * CH, buf + role * P::CHUNK, lane);
      }
      if (x.step < NC - 1) return;
      // the scores are whole: P (role 0), then dS (role 1), shared by the pair
      const int k0 = x.tile * kBlock;
      const bool full = tile_full(mode, q0, k0, nq, nk);
      if (role == 0) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(__fmaf_rn(s[nb][e], scale_log2, -row_lse[e / 2]));
            if (!full && !visible(q0 + r0 + g + 8 * (e / 2), k0 + 8 * nb + 2 * t + (e % 2), nq, nk,
                                  mode, mask))
              p = 0.f;
            s[nb][e] = p;
          }
        put_frag(xchg, grp, lane, s);
      }
      pair_sync(grp);
      if (role == 1) {
        const float4* pw = reinterpret_cast<const float4*>(xchg) + grp * 8 * 32 + lane;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float4 p = pw[nb * 32];
          s[nb][0] = ds_of(p.x, s[nb][0], row_delta[0], scale);
          s[nb][1] = ds_of(p.y, s[nb][1], row_delta[0], scale);
          s[nb][2] = ds_of(p.z, s[nb][2], row_delta[1], scale);
          s[nb][3] = ds_of(p.w, s[nb][3], row_delta[1], scale);
        }
        put_frag(xchg, grp, lane, s);
      }
      pair_sync(grp);
      if (role == 0) get_frag(xchg, grp, lane, s);
      // dQ += dS K over the last chunk, still in this slot
      frag_product<NT, LDC, LO, GN>(acc, (NC - 1) * NT, s, buf + half, lane);
      return;
    }
    const int c = 2 * (x.step - NC);
#pragma unroll
    for (int cc = 0; cc < NC - 1; ++cc) {
      if (cc == c) frag_product<NT, LDC, LO, GN>(acc, cc * NT, s, buf + half, lane);
      if (cc == c + 1) frag_product<NT, LDC, LO, GN>(acc, cc * NT, s, buf + P::CHUNK + half, lane);
    }
  };
  tf_ring<P::STAGES, P::SLOT>(ring, TfItem{next_key_tile(0, kend, mode, layout, qt, ktiles), 0}, next,
                              done, fetch, compute);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + r0 + g + 8 * hh;
    if (r >= nq) continue;
    float* row = dq + (bh * nq + r) * D + half + 2 * t;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(row + c * CH + 8 * nt) =
            make_float2(acc[c * NT + nt][2 * hh], acc[c * NT + nt][2 * hh + 1]);
  }
}

// dk, dv: grid (B * H, ceil(nk / 64), KV_SPLIT), the key tile the
// slowest index but one (causal key tile 0, which the most query tiles
// see, first); blockIdx.z picks the block's share of dK's and dV's
// columns (S^T and dP^T are formed over all of D by each). Here a warp's
// fragment is transposed: rows are keys, columns queries.
template <int D>
__global__ void __launch_bounds__(kTfThreads, 1)
dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const uint8_t* __restrict__ mask, const int* __restrict__ layout,
                float* __restrict__ dk, float* __restrict__ dv, int nq, int nk, int mode,
                float scale) {
  using P = TfPlan<D>;
  constexpr int CH = P::CH, NC = P::NC, LDR = P::LDR, LDC = P::LDC;
  constexpr int NT = CH / 8;                   // column tiles of a chunk: all its columns
  constexpr int NCO = NC / P::KV_SPLIT;        // chunks whose dK and dV columns this block owns
  constexpr int GN = NCO * NT >= 16 ? 2 : 4;   // column tiles of a fresh partial (2 beside 64
                                               // accumulator registers)
  constexpr int LO = 2 * P::CHUNK;             // a split tile's lo, from its hi
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [64][LDR], resident
  float* vs = ks + kBlock * LDR;
  float* ring = vs + kBlock * LDR;
  float* buf = ring + P::STAGES * P::SLOT;  // the computing slot's tiles, split
  float* xchg = buf + P::SPLIT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, role = warp / 4, grp = warp % 4;
  const int g = lane / 4, t = lane % 4, r0 = 16 * grp;
  const size_t bh = blockIdx.x;
  const int kt = blockIdx.y, k0 = kt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock, qtiles = (nq + kBlock - 1) / kBlock;
  // owned chunks [c0, c0 + NCO); the last S/dP item's chunk (NC - 1) is
  // taken from its own slot when owned, the others by column items
  const int c0 = blockIdx.z * NCO;
  const bool owns_last = c0 + NCO == NC;
  const int n_items = NC + NCO - (owns_last ? 1 : 0);
  const float* qb = q + bh * nq * D;
  const float* db = dout + bh * nq * D;
  const float* lb = lse + bh * nq;
  const float* deb = delta + bh * nq;

  copy_rows<D, LDR, D>(ks, k + bh * nk * D, k0, nk, 0);
  copy_rows<D, LDR, D>(vs, v + bh * nk * D, k0, nk, 0);

  auto live = [&](int qt) {
    if (mode == 2)
      while (qt < qtiles && layout[qt * ktiles + kt] == 0) ++qt;
    return qt;
  };
  auto next = [&](TfItem x) { return ++x.step < n_items ? x : TfItem{live(x.tile + 1), 0}; };
  auto done = [&](TfItem x) { return x.tile >= qtiles; };
  // an S/dP item: chunk `step` of Q and dO (the last also lse and delta); a
  // column item: owned chunk c0 + step - NC of Q and dO again
  auto fetch = [&](TfItem x, float* slot) {
    const int q0 = x.tile * kBlock, c = x.step < NC ? x.step : c0 + x.step - NC;
    copy_rows<CH, LDC, D>(slot, qb, q0, nq, c * CH);
    copy_rows<CH, LDC, D>(slot + P::CHUNK, db, q0, nq, c * CH);
    if (x.step == NC - 1 && threadIdx.x < 2 * kBlock) {
      const int r = threadIdx.x % kBlock;
      const bool ok = q0 + r < nq;
      cp_async4(slot + 2 * P::CHUNK + threadIdx.x, (threadIdx.x < kBlock ? lb : deb) + (ok ? q0 + r : 0),
                ok);
    }
  };

  float s[8][4], acc[NCO * NT][4];  // s: S^T (role 0, then P^T) or dP^T (role 1, then dS^T);
#pragma unroll                      // acc: dV (role 0) or dK (role 1), the owned columns
  for (int i = 0; i < NCO * NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const float* xs = (role == 0 ? ks : vs) + r0 * LDR;
  const float scale_log2 = scale * kLog2e;  // P in base 2, as the dq pass forms it
  // the second product's operand in a slot: dO (role 0) or Q (role 1)
  const int other = role == 0 ? P::CHUNK : 0;

  auto compute = [&](TfItem x, const float* slot) {
    split_slot<P::CHUNK>(buf, slot);
    __syncthreads();  // block-uniform: every thread computes the same item
    if (x.step < NC) {
      if (x.step == 0) {
        score_product<CH, LDR, LDC, LO, true, GN>(s, xs, buf + role * P::CHUNK, lane);
      } else if constexpr (NC > 1) {
        score_product<CH, LDR, LDC, LO, false, GN>(s, xs + x.step * CH, buf + role * P::CHUNK, lane);
      }
      if (x.step < NC - 1) return;
      // the scores are whole: P^T (role 0), then dS^T (role 1)
      const int q0 = x.tile * kBlock;
      const bool full = tile_full(mode, q0, k0, nq, nk);
      const float* lse_s = slot + 2 * P::CHUNK;
      const float* delta_s = lse_s + kBlock;
      if (role == 0) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * nb + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(__fmaf_rn(s[nb][e], scale_log2, -(e % 2 ? l2.y : l2.x) * kLog2e));
            // padded query rows (>= nq) are dropped here: their lse never reaches dk/dv
            if (!full && !visible(q0 + 8 * nb + 2 * t + (e % 2), k0 + r0 + g + 8 * (e / 2), nq, nk,
                                  mode, mask))
              p = 0.f;
            s[nb][e] = p;
          }
        }
        put_frag(xchg, grp, lane, s);
      }
      pair_sync(grp);
      if (role == 1) {
        const float4* pw = reinterpret_cast<const float4*>(xchg) + grp * 8 * 32 + lane;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * nb + 2 * t);
          const float4 p = pw[nb * 32];
          s[nb][0] = ds_of(p.x, s[nb][0], d2.x, scale);
          s[nb][1] = ds_of(p.y, s[nb][1], d2.y, scale);
          s[nb][2] = ds_of(p.z, s[nb][2], d2.x, scale);
          s[nb][3] = ds_of(p.w, s[nb][3], d2.y, scale);
        }
      }
      // dV += P^T dO (role 0), dK += dS^T Q (role 1) over the last chunk
      if (owns_last) frag_product<NT, LDC, LO, GN>(acc, (NCO - 1) * NT, s, buf + other, lane);
      return;
    }
    const int c = x.step - NC;  // the owned chunk's index among the block's
#pragma unroll
    for (int cc = 0; cc < NCO; ++cc)
      if (cc == c) frag_product<NT, LDC, LO, GN>(acc, cc * NT, s, buf + other, lane);
  };
  tf_ring<P::STAGES, P::SLOT>(ring, TfItem{live(mode == 1 ? k0 / kBlock : 0), 0}, next, done, fetch,
                              compute);

  // every block writes its keys' rows, zeros when no query tile was live
  float* out = (role == 0 ? dv : dk) + bh * nk * D + c0 * CH + 2 * t;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + r0 + g + 8 * hh;
    if (key >= nk) continue;
#pragma unroll
    for (int i = 0; i < NCO * NT; ++i)
      *reinterpret_cast<float2*>(out + (size_t)key * D + 8 * i) =
          make_float2(acc[i][2 * hh], acc[i][2 * hh + 1]);
  }
}

// The forward: o = softmax(S) V and lse, S = Q K^T scale, for a block's
// 64 query rows. Grid (B * H, ceil(nq / 64)), the query tile the slowest
// index and reversed, so the causal blocks with the most key tiles start
// first. 8 warps: four groups of 16 rows times two roles, as the backward's
// passes; here the roles split each product's work in halves:
//   * S = Q K^T: role r forms the partial over its half of each K chunk's
//     channels (a 16 x 64 fragment over D / 2 channels), the two halves
//     are traded through shared memory (one pair barrier a key tile) and
//     added, and both warps of the pair run the same online softmax on the
//     whole S (the same bits), so neither waits for the other's P;
//   * the softmax in base 2: m the running row maximum of fl(S scale
//     log2(e)), P = 2^(S scale log2(e) - m) by ex2.approx of one FMA, the
//     arm's mask only on tiles that need it (the causal diagonal, edges past
//     nq or nk, every live static-mask tile), masked P exactly 0; O and l
//     rescaled by 2^(m_old - m);
//   * O += P V: role r owns the same half of each V chunk's columns, so its
//     O is 16 x D / 2 (D / 4 accumulator registers a thread: 64 at D = 256);
//     where V takes several items (D > 64), P's A fragments are split into
//     hi and lo once a key tile, half by each warp of the pair, into shared
//     memory over the traded S halves, and read from there by every P V.
// Q stays resident, loaded once (at D <= 64 each warp splits its A
// fragments of S once into registers; above, as it reads them); K and V
// stream through the ring in 64-channel chunks (32 at
// D = 256), two chunks a slot (at D <= 64 K's and V's one chunk each
// share a slot): the K items first, then the V items, the next item (at D
// <= 64 two, at 256 three) in flight while one computes, each landed slot
// split into hi and lo once for the block (`split_slot`). Accumulation: the tensor cores truncate their
// fp32 sums at every mma, so each S half and each tile's P V partial forms
// in fresh accumulators (hi.hi in one, the small terms in another,
// `score_product` and `frag_product`), and the P V partial joins the
// running O by a rounding add after O is rescaled in fp32.
// What bounds it: operations, 4 D flops a visible pair, three TF32 products
// each (3 x 4 D a pair on the 495 TF/s TF32 peak); shared memory 225,792
// bytes at D = 64 (3 stages), 206,848 at 128 (2), 215,968 at 256 (4)
// (`TfPlan::FWD_SMEM`): one block an SM.
template <int D>
__global__ void __launch_bounds__(kTfThreads, 1)
fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                const int* __restrict__ layout, float* __restrict__ o, float* __restrict__ lse,
                int nq, int nk, int mode, float scale) {
  using P = TfPlan<D>;
  constexpr int CH = P::CH, NC = P::NC, LDR = P::LDR, LDC = P::LDC;
  constexpr int NT = CH / 16;                 // a role's column tiles of a chunk: half its columns
  constexpr int KI = NC == 1 ? 1 : NC / 2;    // the items of a key tile that bring K (two chunks a slot)
  constexpr int GN = 4;                       // column tiles of a fresh partial
  constexpr int LO = 2 * P::CHUNK;            // a split tile's lo, from its hi
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][LDR], resident
  float* ring = qs + kBlock * LDR;
  float* buf = ring + P::FWD_STAGES * P::SLOT;  // the computing slot's tiles, split
  float* xchg = buf + P::SPLIT;                 // each role's S halves, a fragment a row group

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, role = warp / 4, grp = warp % 4;
  const int g = lane / 4, t = lane % 4, r0 = 16 * grp;
  const size_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * kBlock;
  const int ktiles = (nk + kBlock - 1) / kBlock;
  const int kend = key_tile_end(mode, q0, nk);
  const float* kb = k + bh * nk * D;
  const float* vb = v + bh * nk * D;

  copy_rows<D, LDR, D>(qs, q + bh * nq * D, q0, nq, 0);
  const float scale_log2 = scale * kLog2e;

  auto next = [&](TfItem x) {
    return ++x.step < NC ? x : TfItem{next_key_tile(x.tile + 1, kend, mode, layout, qt, ktiles), 0};
  };
  auto done = [&](TfItem x) { return x.tile >= kend; };
  // item `step` of a key tile: K's chunks 2 step and 2 step + 1, then V's
  // (at NC = 1 K's and V's only chunk)
  auto fetch = [&](TfItem x, float* slot) {
    const int key0 = x.tile * kBlock;
    if constexpr (NC == 1) {
      copy_rows<CH, LDC, D>(slot, kb, key0, nk, 0);
      copy_rows<CH, LDC, D>(slot + P::CHUNK, vb, key0, nk, 0);
    } else {
      const float* src = x.step < KI ? kb : vb;
      const int c = 2 * (x.step < KI ? x.step : x.step - KI);
      copy_rows<CH, LDC, D>(slot, src, key0, nk, c * CH);
      copy_rows<CH, LDC, D>(slot + P::CHUNK, src, key0, nk, (c + 1) * CH);
    }
  };

  float s[8][4], acc[NC * NT][4];  // s: this role's half of S, then the whole S, then P
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows g and g + 8; m in base 2
#pragma unroll
  for (int i = 0; i < NC * NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const float* xs = qs + r0 * LDR;
  const int half = role * (CH / 2);  // this role's channels (S) and columns (O) of each chunk
  const float4* other = reinterpret_cast<const float4*>(xchg + (1 - role) * P::XCHG) + grp * 8 * 32 + lane;
  // at NC > 1, P's split A fragments over the pair's S halves (hi, lo)
  float4* p_hi = reinterpret_cast<float4*>(xchg) + grp * 8 * 32 + lane;
  float4* p_lo = reinterpret_cast<float4*>(xchg + P::XCHG) + grp * 8 * 32 + lane;

  // at NC = 1 this warp's A fragments of S (its 16 rows of Q over its CH / 2
  // channels) are split once, at the first item (Q has landed), and kept
  // in registers: D / 2 of them (32 at D = 64)
  constexpr int QKS = NC == 1 ? CH / 16 : 1;
  uint32_t qh[QKS][4], ql[QKS][4];
  bool q_split = false;

  auto compute = [&](TfItem x, const float* slot) {
    split_slot<P::CHUNK>(buf, slot);
    __syncthreads();  // block-uniform: every thread computes the same item
    if (x.step < KI) {
      if constexpr (NC == 1) {
        if (!q_split) {
#pragma unroll
          for (int ks = 0; ks < QKS; ++ks) x_frag<LDR>(xs + half, ks, lane, qh[ks], ql[ks]);
          q_split = true;
        }
        score_product_by<CH / 2, LDC, LO, true, GN>(
            s,
            [&](int ks, uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                ah[i] = qh[ks][i];
                al[i] = ql[ks][i];
              }
            },
            buf + half, lane);
      } else if (x.step == 0) {
        score_product<CH / 2, LDR, LDC, LO, true, GN>(s, xs + half, buf + half, lane);
      } else {
        score_product<CH / 2, LDR, LDC, LO, false, GN>(s, xs + 2 * x.step * CH + half, buf + half, lane);
      }
      if constexpr (NC > 1)
        score_product<CH / 2, LDR, LDC, LO, false, GN>(s, xs + (2 * x.step + 1) * CH + half,
                                                       buf + P::CHUNK + half, lane);
      if (x.step < KI - 1) return;
      // S whole: this role's half plus the partner's (one rounding add, the
      // same bits in both warps)
      put_frag(xchg + role * P::XCHG, grp, lane, s);
      pair_sync(grp);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float4 w = other[nb * 32];
        s[nb][0] = __fadd_rn(s[nb][0], w.x);
        s[nb][1] = __fadd_rn(s[nb][1], w.y);
        s[nb][2] = __fadd_rn(s[nb][2], w.z);
        s[nb][3] = __fadd_rn(s[nb][3], w.w);
      }
      // the online softmax of rows r0 + g and r0 + g + 8 over this key tile
      const int k0 = x.tile * kBlock;
      const bool full = tile_full(mode, q0, k0, nq, nk);
      float tmax[2] = {kNeg, kNeg};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full && !visible(q0 + r0 + g + 8 * (e / 2), k0 + 8 * nb + 2 * t + (e % 2), nq, nk, mode,
                                mask))
            s[nb][e] = -INFINITY;  // P = 2^-inf = 0
          tmax[e / 2] = fmaxf(tmax[e / 2], s[nb][e]);
        }
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], __fmul_rn(quad_max(tmax[hh]), scale_log2));
        corr[hh] = ex2(m[hh] - m_new);
        m[hh] = m_new;
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nb][e] = ex2(__fmaf_rn(s[nb][e], scale_log2, -m[e / 2]));
          psum[e / 2] += s[nb][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + quad_sum(psum[hh]);
      scale_rows(acc, corr);
      if constexpr (NC > 1) {
        // V arrives in the next items, for all of which P is split once:
        // once the partner has read this warp's S half (the pair barrier),
        // each warp writes the split A fragments of its half of P's
        // k-steps over the pair's two S halves, hi in role 0's, lo in role
        // 1's ([k-step][lane] float4s); the next item's barrier orders them
        // before any read
        pair_sync(grp);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk / 4 != role) continue;
          uint32_t h[4], o[4];
          split_tf32(s[kk][0], h[0], o[0]);
          split_tf32(s[kk][2], h[1], o[1]);
          split_tf32(s[kk][1], h[2], o[2]);
          split_tf32(s[kk][3], h[3], o[3]);
          p_hi[kk * 32] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                                      __uint_as_float(h[3]));
          p_lo[kk * 32] = make_float4(__uint_as_float(o[0]), __uint_as_float(o[1]), __uint_as_float(o[2]),
                                      __uint_as_float(o[3]));
        }
        return;
      }
    }
    // O += P V over this role's columns of the item's V chunks
    if constexpr (NC == 1) {
      frag_product<NT, LDC, LO, GN>(acc, 0, s, buf + P::CHUNK + half, lane);
    } else {
      auto p_split = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
        const float4 h = p_hi[kk * 32], o = p_lo[kk * 32];
        ah[0] = __float_as_uint(h.x); ah[1] = __float_as_uint(h.y);
        ah[2] = __float_as_uint(h.z); ah[3] = __float_as_uint(h.w);
        al[0] = __float_as_uint(o.x); al[1] = __float_as_uint(o.y);
        al[2] = __float_as_uint(o.z); al[3] = __float_as_uint(o.w);
      };
      const int c = 2 * (x.step - KI);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        if (cc == c) frag_product_by<NT, LDC, LO, GN>(acc, cc * NT, p_split, buf + half, lane);
        if (cc == c + 1) frag_product_by<NT, LDC, LO, GN>(acc, cc * NT, p_split, buf + P::CHUNK + half, lane);
      }
    }
  };
  tf_ring<P::FWD_STAGES, P::SLOT>(ring, TfItem{next_key_tile(0, kend, mode, layout, qt, ktiles), 0}, next,
                                  done, fetch, compute);

  // o = O / l, lse = m ln(2) + log(l) (m in base 2)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + r0 + g + 8 * hh;
    if (r >= nq) continue;
    const float safe_l = fmaxf(l[hh], 1e-30f);
    float* row = o + (bh * nq + r) * D + half + 2 * t;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(row + c * CH + 8 * nt) =
            make_float2(acc[c * NT + nt][2 * hh] / safe_l, acc[c * NT + nt][2 * hh + 1] / safe_l);
    if (role == 0 && t == 0) lse[bh * nq + r] = m[hh] * kLn2 + logf(safe_l);
  }
}

// dynamic shared memory above 48 KB is opted into once per kernel instance
// and device (`capped` is the caller's flag for that instance)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&capped)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && capped[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) capped[dev] = true;
  return err;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *mask, *layout;
  void *o, *lse_out, *dq, *dk, *dv, *dq_acc;
  int B, H, nq, nk, mode;
  float scale;
  cudaStream_t stream;
};

enum Pass { kFwd, kBwd };

// float32 inputs: the tensor-core forward; the backward as two tensor-core
// launches, dq and dk/dv
template <int D>
cudaError_t run_fp32(Pass pass, const Args& a) {
  static bool capped[3][kMaxDevices] = {};  // fwd_tf32_kernel, dq_tf32_kernel, dkv_tf32_kernel
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* dout = static_cast<const float*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* delta = static_cast<const float*>(a.delta);
  const auto* mask = static_cast<const uint8_t*>(a.mask);
  const auto* layout = static_cast<const int*>(a.layout);
  cudaError_t err;
  if (pass == kFwd) {
    constexpr size_t smem = TfPlan<D>::FWD_SMEM;
    if ((err = allow_smem(fwd_tf32_kernel<D>, smem, capped[0])) != cudaSuccess) return err;
    fwd_tf32_kernel<D><<<dim3(a.B * a.H, (a.nq + kBlock - 1) / kBlock), kTfThreads, smem, a.stream>>>(
        q, k, v, mask, layout, static_cast<float*>(a.o), static_cast<float*>(a.lse_out), a.nq, a.nk,
        a.mode, a.scale);
    return cudaGetLastError();
  }
  constexpr size_t smem = TfPlan<D>::SMEM;
  if ((err = allow_smem(dq_tf32_kernel<D>, smem, capped[1])) != cudaSuccess) return err;
  dq_tf32_kernel<D><<<dim3(a.B * a.H, (a.nq + kBlock - 1) / kBlock), kTfThreads, smem, a.stream>>>(
      q, k, v, dout, lse, delta, mask, layout, static_cast<float*>(a.dq), a.nq, a.nk, a.mode,
      a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(dkv_tf32_kernel<D>, smem, capped[2])) != cudaSuccess) return err;
  const dim3 kgrid(a.B * a.H, (a.nk + kBlock - 1) / kBlock, TfPlan<D>::KV_SPLIT);
  dkv_tf32_kernel<D><<<kgrid, kTfThreads, smem, a.stream>>>(
      q, k, v, dout, lse, delta, mask, layout, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.nq, a.nk, a.mode, a.scale);
  return cudaGetLastError();
}

// bfloat16 inputs: the tensor-core kernels (the backward as the fused
// kernel between zeroing the dq workspace and converting it)
template <int D>
cudaError_t run_tensor_cores(Pass pass, const Args& a) {
  static bool capped[2][kMaxDevices] = {};  // fwd_wgmma_kernel, bwd_mma_kernel
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
      if ((err = allow_smem(fwd_wgmma_kernel<D>, fwd_wgmma_smem<D>(), capped[0])) != cudaSuccess)
        return err;
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
  if ((err = allow_smem(bwd_mma_kernel<D>, bwd_mma_smem<D>(), capped[1])) != cudaSuccess) return err;
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
  return dtype == 1 ? run_tensor_cores<D>(pass, a) : run_fp32<D>(pass, a);
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
