// The attention backward shared by fused_qkv_attention (K1) and
// flash_attention (K3), bf16 and fp32, for sm_90a.
//
// The JAX package differentiates the XLA composition of the forward
// (jax.vjp of _xla_reference / xla_attention), which XLA compiles and fuses on a
// TPU. Here the same gradient is computed from the forward's saved row
// log-sum-exp, without an N x N buffer, in the formulation of FlashAttention-2:
// with P = exp(scale q k^T - lse) and dP = dO v^T per source,
//   dV = P^T dO,  dS = P o (dP - delta),  dQ = scale dS K,  dK = scale dS^T Q,
// where for one source lse is the forward's and delta = rowsum(dO o O) (a
// pre-pass, attn_bwd_delta). For J > 1 sources, whose outputs the forward summed,
// the dQ kernel takes each source's statistics in a first pass over its keys:
// an online softmax gives lse_j, and the same rescaling gives delta_j =
// rowsum(P_j o dP_j) = rowsum(dO o O_j) without O_j; it writes both for the
// dK/dV kernel.
//
// Bound on an H100: operations in bf16 (five products of 2 N M D flops per
// (group, head, source) against the bytes of q, k, v, dO and the grads; the
// dQ kernel recomputes the logits and dP that the dK/dV kernel also takes).
// The design keeps every sum in one block, so there are no floating-point
// atomics and two calls on the same inputs give the same bits:
//   attn_bwd_dq    one block per 64 q rows of a (group, head): loops over the J
//                  sources and their 64-key tiles, sums dQ in registers;
//   attn_bwd_dkdv  one block per 64 keys of a (group g', head): loops over the
//                  (source j, group g) pairs with perm[j][g] = g' (a list the
//                  wrapper builds in a fixed order) and over their q tiles,
//                  sums dK and dV in registers;
//   attn_bwd_wsum  the (D,) RMSNorm weight grads: the blocks' fp32 partials
//                  summed in a fixed order.
// Four warps a block, each owning 16 of the block's 64 rows; compiled for at
// least one block an SM (with no minimum ptxas trades a few spilled registers
// for occupancy). bf16 products are mma.sync m16n8k16 (fp32 accumulate) on
// operands in shared memory; the probabilities and dS are rounded to bf16 and
// staged in shared memory as the A operand. fp32 runs the same kernels with the products on the CUDA cores, in
// the same register layout (only the checks run it).
//
// K1's per-head RMSNorm of q and k is recomputed where a tile is loaded, with
// the forward's cast points and sums (attn_k1_sm90.cuh in bf16, attn_core.cuh
// in fp32); dQ and dK go back through it in the kernels' epilogues:
// dx = r (g - y mean(g y)) with y = x r, g = dn w, and the weight's grad
// sum(dn x_hat) from per-block partials.
#pragma once

#include <math.h>

#include "attn_k1_sm90.cuh"
#include "sm90_common.cuh"

namespace mdv2 {
namespace bwd {

constexpr int kThreads = 128;  // four warps
constexpr int kOwn = 64;       // rows a block owns: q rows (dQ) or keys (dK/dV)
constexpr int kKeys = 64;      // keys a dQ block takes a step
constexpr float kLog2e = 1.4426950408889634f;

// q rows a dK/dV block takes a step: 64, or 16 at the 144-wide head dim, whose
// dK and dV sums take 144 registers a thread
__host__ __device__ constexpr int q_step(int dv) { return dv <= 72 ? 64 : 16; }

// Row strides (elements) of the shared-memory tiles: bf16 rows 16 bytes longer
// than their width, so the 32-bit fragment loads of eight rows hit eight bank
// groups; fp32 rows of odd length (the CUDA-core products read down columns).
template <typename T>
__host__ __device__ constexpr int tile_ld(int width) {
  return sizeof(T) == 2 ? width + 8 : width + 1;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;  // the forward's output (delta's pre-pass, one source only)
  void* dq;
  void* dk;
  void* dv;
  // element strides: group, row, head (the head-dim stride is 1)
  long long q_gs, q_rs, q_hs, k_gs, k_rs, k_hs, v_gs, v_rs, v_hs;
  long long do_gs, do_rs, do_hs, o_gs, o_rs, o_hs;
  long long dq_gs, dq_rs, dq_hs, dk_gs, dk_rs, dk_hs, dv_gs, dv_rs, dv_hs;
  float* lse;        // (J, G, H, N): natural log-sum-exp of each source's scaled logits
  float* delta;      // (J, G, H, N); both the forward's / the pre-pass's, or J > 1 the dQ kernel's
  const int* perm;   // (J, G) source group of k/v, or nullptr for identity (J = 1)
  const int* inv_off;  // (G + 1): the pairs reading group g' are inv_src[inv_off[g']..]
  const int* inv_src;  // j * G + g, in a fixed order; nullptr with perm nullptr
  const float* q_w;    // (D,) fp32 RMSNorm weights, or nullptr for no norm
  const float* k_w;
  float* dqw_part;     // (dQ blocks, D) / (dK/dV blocks, D) fp32 partials, or nullptr
  float* dkw_part;
  float* dqw;          // (D,) fp32
  float* dkw;
  int G, H, N, M, D, J;
  float scale, eps;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (sizeof(T) == 4) return x;
  else return __float2bfloat16(x);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// p = exp(s * scale - lse): bf16 in base 2 on the MUFU (as the forward), fp32
// with expf; an lse of +inf (a row past the end) gives 0
template <typename T>
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  if constexpr (sizeof(T) == 2) return ex2(fmaf(s, scale * kLog2e, -lse * kLog2e));
  else return expf(s * scale - lse);
}

// One 64-key tile of the first pass (J > 1) for this thread's two rows: the
// online softmax's running max m of the scaled logits (base 2 in bf16), and the
// sums l of exp(s - m) and u of exp(s - m) dP, rescaled as m grows; keys from M
// on are masked. m is the row's (shuffled over its four threads), l and u this
// thread's share. The logits s are overwritten.
template <typename T, int NS>
__device__ __forceinline__ void online_stats(float (&x)[4 * NS], const float (&dp)[4 * NS],
                                             int k0, int M, float scale, float& ma, float& mb,
                                             float& la, float& lb, float& ua, float& ub,
                                             int tig) {
  const float f = sizeof(T) == 2 ? scale * kLog2e : scale;
  float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int c = k0 + n * 8 + 2 * tig;
    x[4 * n + 0] = c < M ? x[4 * n + 0] * f : -INFINITY;
    x[4 * n + 1] = c + 1 < M ? x[4 * n + 1] * f : -INFINITY;
    x[4 * n + 2] = c < M ? x[4 * n + 2] * f : -INFINITY;
    x[4 * n + 3] = c + 1 < M ? x[4 * n + 3] * f : -INFINITY;
    xa = fmaxf(xa, fmaxf(x[4 * n + 0], x[4 * n + 1]));
    xb = fmaxf(xb, fmaxf(x[4 * n + 2], x[4 * n + 3]));
  }
  xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, 1));
  xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, 2));
  xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, 1));
  xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, 2));
  // every tile holds a valid key, so the new maxima are finite
  const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
  float ca, cb;  // 0 on the first tile
  if constexpr (sizeof(T) == 2) { ca = ex2(ma - na); cb = ex2(mb - nb); }
  else { ca = expf(ma - na); cb = expf(mb - nb); }
  la *= ca; ua *= ca; lb *= cb; ub *= cb;
  ma = na; mb = nb;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = e < 2 ? na : nb;
      float pe;
      if constexpr (sizeof(T) == 2) pe = ex2(x[4 * n + e] - m);
      else pe = expf(x[4 * n + e] - m);
      if (e < 2) { la += pe; ua += pe * dp[4 * n + e]; }
      else { lb += pe; ub += pe * dp[4 * n + e]; }
    }
  }
}

// The end of the first pass for one row: l and u summed over the row's four
// threads; lse (natural units) and delta = u / l.
template <typename T>
__device__ __forceinline__ void finish_stats(float m, float l, float u, float& lse,
                                             float& delta) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  u += __shfl_xor_sync(0xffffffffu, u, 1);
  u += __shfl_xor_sync(0xffffffffu, u, 2);
  if constexpr (sizeof(T) == 2) lse = (m + log2f(l)) * 0.6931471805599453f;
  else lse = m + logf(l);
  delta = u / l;
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

// `nrows` rows of DP columns into shared memory (row stride ld): the first
// `rows` from src (row stride rs), D columns of them; the rest zero.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long rs, int rows,
                                          int nrows, int D, int tid) {
  if constexpr (sizeof(T) == 2) {  // 16-byte pieces; D is a multiple of 8
    constexpr int C = DP / 8;
    for (int i = tid; i < nrows * C; i += kThreads) {
      const int r = i / C, c = i - r * C;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c * 8 < D) x = *reinterpret_cast<const uint4*>(src + r * rs + c * 8);
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = x;
    }
  } else {
    for (int i = tid; i < nrows * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      dst[r * ld + c] = (r < rows && c < D) ? src[r * rs + c] : 0.0f;
    }
  }
}

// The forward's RMSNorm of `nrows` rows in place. bf16: one thread a row, its
// sum of squares in the order of the forward's q rows (even chunks, odd
// chunks, then their sum: attn_k1_sm90.cuh's two threads a row) or k rows
// (chunk by chunk: k1_tile_k); fp32: one warp a row as attn_core.cuh's.
template <typename T>
__device__ __forceinline__ void norm_rows(T* tile, int ld, int nrows, const float* w, int D,
                                          float eps, bool q_order, int tid) {
  if constexpr (sizeof(T) == 2) {
    for (int r = tid; r < nrows; r += kThreads) {
      bf16* row = tile + r * ld;
      float sq = 0.0f;
      if (q_order) {
        float s1 = 0.0f;
        for (int c = 0; c * 8 < D; c += 2)
          sq += k1::sum_sq(*reinterpret_cast<const uint4*>(row + c * 8));
        for (int c = 1; c * 8 < D; c += 2)
          s1 += k1::sum_sq(*reinterpret_cast<const uint4*>(row + c * 8));
        sq += s1;
      } else {
        for (int c = 0; c * 8 < D; ++c)
          sq += k1::sum_sq(*reinterpret_cast<const uint4*>(row + c * 8));
      }
      const float rinv = 1.0f / sqrtf(sq / (float)D + eps);
      for (int c = 0; c * 8 < D; ++c)
        k1::rms_chunk(*reinterpret_cast<uint4*>(row + c * 8), w + c * 8, rinv);
    }
  } else {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < nrows; r += kThreads / 32) {
      float* row = tile + r * ld;
      float sq = 0.0f;
      for (int d = lane; d < D; d += 32) sq += row[d] * row[d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      float rinv = 1.0f / sqrtf(sq / (float)D + eps);
      for (int d = lane; d < D; d += 32) row[d] = w[d] * (row[d] * rinv);
    }
  }
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B for one warp's 16 rows: A (16 x K) row-major at A (row stride
// lda), B (K x 8 NG); B_KMAJOR: B[k][n] at B + k ldb + n, else at B + n ldb + k.
// acc in the mma accumulator layout: for each 8-column group n, acc[4n..4n+3]
// are (row gid, columns 8n + 2 tig, + 1) and (row gid + 8, the same columns),
// gid = lane / 4, tig = lane % 4. K is a multiple of 16.
template <int NG, int K, bool B_KMAJOR, typename T>
__device__ __forceinline__ void warp_mm(float (&acc)[4 * NG], const T* A, int lda, const T* B,
                                        int ldb, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(A + gid * lda + kk + 2 * tig);
      a[1] = ld32(A + (gid + 8) * lda + kk + 2 * tig);
      a[2] = ld32(A + gid * lda + kk + 8 + 2 * tig);
      a[3] = ld32(A + (gid + 8) * lda + kk + 8 + 2 * tig);
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        uint32_t b0, b1;
        if constexpr (B_KMAJOR) {
          const bf16* p = B + (kk + 2 * tig) * ldb + n * 8 + gid;
          b0 = pack2(p[0], p[ldb]);
          b1 = pack2(p[8 * ldb], p[9 * ldb]);
        } else {
          const bf16* p = B + (n * 8 + gid) * ldb + kk + 2 * tig;
          b0 = ld32(p);
          b1 = ld32(p + 8);
        }
        mma_bf16(acc[4 * n], acc[4 * n + 1], acc[4 * n + 2], acc[4 * n + 3], a, b0, b1);
      }
    }
  } else {
    const float* a0 = A + gid * lda;
    const float* a1 = A + (gid + 8) * lda;
    for (int k = 0; k < K; ++k) {
      const float x0 = a0[k], x1 = a1[k];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const int c = n * 8 + 2 * tig;
        const float b0 = B_KMAJOR ? B[k * ldb + c] : B[c * ldb + k];
        const float b1 = B_KMAJOR ? B[k * ldb + c + 1] : B[(c + 1) * ldb + k];
        acc[4 * n + 0] = fmaf(x0, b0, acc[4 * n + 0]);
        acc[4 * n + 1] = fmaf(x0, b1, acc[4 * n + 1]);
        acc[4 * n + 2] = fmaf(x1, b0, acc[4 * n + 2]);
        acc[4 * n + 3] = fmaf(x1, b1, acc[4 * n + 3]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.0f;
}

// A warp's 16 x 8NG accumulator into shared memory as T (row stride ld), the
// A operand of the next product.
template <int NG, typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const float (&acc)[4 * NG], int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    const int c = n * 8 + 2 * tig;
    dst[gid * ld + c] = from_f<T>(acc[4 * n + 0]);
    dst[gid * ld + c + 1] = from_f<T>(acc[4 * n + 1]);
    dst[(gid + 8) * ld + c] = from_f<T>(acc[4 * n + 2]);
    dst[(gid + 8) * ld + c + 1] = from_f<T>(acc[4 * n + 3]);
  }
}

// ---------------------------------------------------------------------------
// epilogues
// ---------------------------------------------------------------------------

// A warp's 16 output rows (rows r0.. of the block; those below `rows` exist),
// times `mul`, to dst (row stride rs), D columns.
template <int NG, typename T>
__device__ __forceinline__ void store_rows(T* dst, long long rs, const float (&acc)[4 * NG],
                                           float mul, int r0, int rows, int D, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const int ra = r0 + gid, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    const int c = n * 8 + 2 * tig;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (c + e >= D) continue;
      if (ra < rows) dst[ra * rs + c + e] = from_f<T>(acc[4 * n + e] * mul);
      if (rb < rows) dst[rb * rs + c + e] = from_f<T>(acc[4 * n + 2 + e] * mul);
    }
  }
}

// The same rows, times `mul`, into the fp32 staging tile St (row stride lt).
template <int NG>
__device__ __forceinline__ void stage_f32(float* St, int lt, const float (&acc)[4 * NG],
                                          float mul, int r0, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    const int c = n * 8 + 2 * tig;
    St[(r0 + gid) * lt + c] = acc[4 * n + 0] * mul;
    St[(r0 + gid) * lt + c + 1] = acc[4 * n + 1] * mul;
    St[(r0 + gid + 8) * lt + c] = acc[4 * n + 2] * mul;
    St[(r0 + gid + 8) * lt + c + 1] = acc[4 * n + 3] * mul;
  }
}

// Back through the RMSNorm for the block's 64 rows: St holds dn, the grad of
// the normalised rows (fp32); x (row stride rs) the raw rows, `rows` of them
// valid. Writes dx = r (dn w - y mean(dn w y)), y = x r, to out, and leaves
// dn * x_hat (x_hat = y rounded to T, the forward's) in St for the weight's
// grad, zero past the valid rows. One warp a row; rsqrt's argument summed as
// attn_core.cuh sums it.
template <typename T>
__device__ __forceinline__ void rms_backward(float* St, int lt, const T* x, long long rs, int rows,
                                             const float* w, int D, float eps, T* out,
                                             long long ors, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < kOwn; r += kThreads / 32) {
    float* s = St + r * lt;
    if (r >= rows) {
      for (int d = lane; d < D; d += 32) s[d] = 0.0f;
      continue;
    }
    const T* xr = x + r * rs;
    float sq = 0.0f;
    for (int d = lane; d < D; d += 32) sq += to_f(xr[d]) * to_f(xr[d]);
    sq = warp_sum(sq);
    const float rinv = 1.0f / sqrtf(sq / (float)D + eps);
    float gy = 0.0f;
    for (int d = lane; d < D; d += 32) gy += s[d] * w[d] * (to_f(xr[d]) * rinv);
    gy = warp_sum(gy) / (float)D;
    for (int d = lane; d < D; d += 32) {
      const float y = to_f(xr[d]) * rinv;
      const float dn = s[d];
      out[r * ors + d] = from_f<T>(rinv * (dn * w[d] - y * gy));
      s[d] = dn * to_f(from_f<T>(y));
    }
  }
}

// St's column sums over the block's 64 rows (in order) into part[block][d].
__device__ __forceinline__ void column_sums(const float* St, int lt, int D, float* part,
                                            int tid) {
  for (int d = tid; d < D; d += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < kOwn; ++r) s += St[r * lt + d];
    part[(long long)blockIdx.x * D + d] = s;
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// delta = rowsum(dO o O), one warp a (group, row, head); one source.
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta(Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long idx = (long long)blockIdx.x * (kThreads / 32) + warp;
  if (idx >= (long long)p.G * p.N * p.H) return;
  const int h = (int)(idx % p.H);
  const int n = (int)((idx / p.H) % p.N);
  const int g = (int)(idx / ((long long)p.H * p.N));
  const T* o = reinterpret_cast<const T*>(p.out) + g * p.o_gs + n * p.o_rs + h * p.o_hs;
  const T* d = reinterpret_cast<const T*>(p.dout) + g * p.do_gs + n * p.do_rs + h * p.do_hs;
  float s = 0.0f;
  for (int c = lane; c < p.D; c += 32) s += to_f(o[c]) * to_f(d[c]);
  s = warp_sum(s);
  if (lane == 0) p.delta[((long long)g * p.H + h) * p.N + n] = s;
}

template <typename T, int DP, int DV>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(T) * ((size_t)(2 * kOwn + 2 * kKeys) * tile_ld<T>(DP) +
                      (size_t)kOwn * tile_ld<T>(kKeys)) +
         sizeof(float) * (size_t)kOwn * (DV + 1);
}

// dQ of 64 q rows of one (group, head), summed over the sources.
template <typename T, int DP, int DV>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dq(Params p) {
  constexpr int LD = tile_ld<T>(DP), LS = tile_ld<T>(kKeys), LT = DV + 1;
  constexpr int NS = kKeys / 8, NO = DV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // 64 q rows (normalised)
  T* dOs = Qs + kOwn * LD;                 // their dO
  T* Ks = dOs + kOwn * LD;                 // a key tile (normalised)
  T* Vs = Ks + kKeys * LD;                 // its values
  T* Ss = Vs + kKeys * LD;                 // dS, each warp its 16 rows
  float* St = reinterpret_cast<float*>(Ss + kOwn * LS);  // dQ for the norm epilogue

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nq = (p.N + kOwn - 1) / kOwn;
  const int qt = blockIdx.x % nq;
  const int h = (blockIdx.x / nq) % p.H;
  const int g = blockIdx.x / (nq * p.H);
  const int q0 = qt * kOwn;
  const T* qg = reinterpret_cast<const T*>(p.q) + g * p.q_gs + h * p.q_hs + q0 * p.q_rs;
  load_tile<T, DP>(Qs, LD, qg, p.q_rs, p.N - q0, kOwn, p.D, tid);
  load_tile<T, DP>(dOs, LD,
                   reinterpret_cast<const T*>(p.dout) + g * p.do_gs + h * p.do_hs +
                       q0 * p.do_rs,
                   p.do_rs, p.N - q0, kOwn, p.D, tid);
  __syncthreads();
  if (p.q_w != nullptr) {
    norm_rows<T>(Qs, LD, kOwn, p.q_w, p.D, p.eps, true, tid);
    __syncthreads();
  }
  const T* Qw = Qs + warp * 16 * LD;
  const T* dOw = dOs + warp * 16 * LD;
  T* Sw = Ss + warp * 16 * LS;
  const int ra = q0 + warp * 16 + gid, rb = ra + 8;  // this thread's rows
  const int nk = (p.M + kKeys - 1) / kKeys;
  const bool multi = p.J > 1;

  float dq[4 * NO];
  zero(dq);
  for (int j = 0; j < p.J; ++j) {
    const int gk = (p.perm != nullptr) ? p.perm[j * p.G + g] : g;
    const long long row0 = ((long long)j * p.G + g) * p.H * p.N + (long long)h * p.N;
    float la = INFINITY, lb = INFINITY, da = 0.0f, db = 0.0f;  // lse and delta of the rows
    if (!multi) {
      if (ra < p.N) { la = p.lse[row0 + ra]; da = p.delta[row0 + ra]; }
      if (rb < p.N) { lb = p.lse[row0 + rb]; db = p.delta[row0 + rb]; }
    }
    // with several sources a first pass takes lse_j and delta_j: running max m (of
    // the scaled logits, base 2 in bf16), sums l of exp(s - m) and u of exp(s - m) dP
    float ma = -INFINITY, mb = -INFINITY, sa = 0.0f, sb = 0.0f, ua = 0.0f, ub = 0.0f;
    for (int pass = multi ? 0 : 1; pass < 2; ++pass) {
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * kKeys;
        __syncthreads();  // every warp is done with the last tile
        load_tile<T, DP>(Ks, LD,
                         reinterpret_cast<const T*>(p.k) + gk * p.k_gs + h * p.k_hs +
                             k0 * p.k_rs,
                         p.k_rs, p.M - k0, kKeys, p.D, tid);
        load_tile<T, DP>(Vs, LD,
                         reinterpret_cast<const T*>(p.v) + gk * p.v_gs + h * p.v_hs +
                             k0 * p.v_rs,
                         p.v_rs, p.M - k0, kKeys, p.D, tid);
        __syncthreads();
        if (p.k_w != nullptr) {
          norm_rows<T>(Ks, LD, kKeys, p.k_w, p.D, p.eps, false, tid);
          __syncthreads();
        }
        float s[4 * NS], dp[4 * NS];
        zero(s);
        zero(dp);
        warp_mm<NS, DP, false>(s, Qw, LD, Ks, LD, lane);
        warp_mm<NS, DP, false>(dp, dOw, LD, Vs, LD, lane);
        if (pass == 0) {
          online_stats<T, NS>(s, dp, k0, p.M, p.scale, ma, mb, sa, sb, ua, ub, tig);
          continue;
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int c = k0 + n * 8 + 2 * tig;
          s[4 * n + 0] = c < p.M ? prob<T>(s[4 * n + 0], p.scale, la) : 0.0f;
          s[4 * n + 1] = c + 1 < p.M ? prob<T>(s[4 * n + 1], p.scale, la) : 0.0f;
          s[4 * n + 2] = c < p.M ? prob<T>(s[4 * n + 2], p.scale, lb) : 0.0f;
          s[4 * n + 3] = c + 1 < p.M ? prob<T>(s[4 * n + 3], p.scale, lb) : 0.0f;
        }
        if (p.M == 1) {  // one key: the softmax is constant, its grads exactly zero
          zero(s);
        } else {
#pragma unroll
          for (int n = 0; n < NS; ++n) {  // dS = P o (dP - delta)
            s[4 * n + 0] *= dp[4 * n + 0] - da;
            s[4 * n + 1] *= dp[4 * n + 1] - da;
            s[4 * n + 2] *= dp[4 * n + 2] - db;
            s[4 * n + 3] *= dp[4 * n + 3] - db;
          }
        }
        stage<NS>(Sw, LS, s, lane);
        __syncwarp();
        warp_mm<NO, kKeys, true>(dq, Sw, LS, Ks, LD, lane);
        __syncwarp();  // every lane has read Sw before the next step writes it
      }
      if (pass == 0) {  // the four threads of a row hold its strips of keys
        finish_stats<T>(ma, sa, ua, la, da);
        finish_stats<T>(mb, sb, ub, lb, db);
        if (tig == 0) {
          if (ra < p.N) { p.lse[row0 + ra] = la; p.delta[row0 + ra] = da; }
          if (rb < p.N) { p.lse[row0 + rb] = lb; p.delta[row0 + rb] = db; }
        }
      }
    }
  }

  T* dqg = reinterpret_cast<T*>(p.dq) + g * p.dq_gs + h * p.dq_hs + q0 * p.dq_rs;
  if (p.q_w == nullptr) {
    store_rows<NO, T>(dqg, p.dq_rs, dq, p.scale, warp * 16, p.N - q0, p.D, lane);
    return;
  }
  stage_f32<NO>(St, LT, dq, p.scale, warp * 16, lane);
  __syncthreads();
  rms_backward<T>(St, LT, qg, p.q_rs, p.N - q0, p.q_w, p.D, p.eps, dqg, p.dq_rs, tid);
  if (p.dqw_part != nullptr) {
    __syncthreads();
    column_sums(St, LT, p.D, p.dqw_part, tid);
  }
}

template <typename T, int DP, int DV>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  return sizeof(T) * ((size_t)(2 * kOwn + 2 * q_step(DV)) * tile_ld<T>(DP) +
                      (size_t)kOwn * tile_ld<T>(q_step(DV))) +
         sizeof(float) * ((size_t)2 * q_step(DV) + (size_t)kOwn * (DV + 1));
}

// dK and dV of 64 keys of one (group g', head), summed over the (source j,
// group g) pairs that read g' and over their q rows.
template <typename T, int DP, int DV>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dkdv(Params p) {
  constexpr int BQ = q_step(DV);
  constexpr int LD = tile_ld<T>(DP), LS = tile_ld<T>(BQ), LT = DV + 1;
  constexpr int NS = BQ / 8, NO = DV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // the block's 64 keys (normalised)
  T* Vs = Ks + kOwn * LD;                  // their values
  T* Qs = Vs + kOwn * LD;                  // a q tile (normalised)
  T* dOs = Qs + BQ * LD;                   // its dO
  T* Ps = dOs + BQ * LD;                   // P^T, then dS^T, each warp its 16 keys
  float* Ls = reinterpret_cast<float*>(Ps + kOwn * LS);  // the q tile's lse
  float* Ds = Ls + BQ;                                     // ... and delta
  float* St = Ds + BQ;                                     // dK for the norm epilogue

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tig = lane & 3;
  const int nk = (p.M + kOwn - 1) / kOwn;
  const int kt = blockIdx.x % nk;
  const int h = (blockIdx.x / nk) % p.H;
  const int g2 = blockIdx.x / (nk * p.H);
  const int k0 = kt * kOwn;
  const T* kg = reinterpret_cast<const T*>(p.k) + g2 * p.k_gs + h * p.k_hs + k0 * p.k_rs;
  load_tile<T, DP>(Ks, LD, kg, p.k_rs, p.M - k0, kOwn, p.D, tid);
  load_tile<T, DP>(Vs, LD,
                   reinterpret_cast<const T*>(p.v) + g2 * p.v_gs + h * p.v_hs + k0 * p.v_rs,
                   p.v_rs, p.M - k0, kOwn, p.D, tid);
  __syncthreads();
  if (p.k_w != nullptr) {
    norm_rows<T>(Ks, LD, kOwn, p.k_w, p.D, p.eps, false, tid);
    __syncthreads();
  }
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LS;

  float dk[4 * NO], dv[4 * NO];
  zero(dk);
  zero(dv);
  const int e0 = p.inv_off != nullptr ? p.inv_off[g2] : 0;
  const int e1 = p.inv_off != nullptr ? p.inv_off[g2 + 1] : 1;
  for (int e = e0; e < e1; ++e) {
    const int src = p.inv_src != nullptr ? p.inv_src[e] : g2;  // j * G + g
    const int g = src % p.G;
    const long long row0 = (long long)src * p.H * p.N + (long long)h * p.N;
    for (int q0 = 0; q0 < p.N; q0 += BQ) {
      __syncthreads();  // every warp is done with the last q tile
      load_tile<T, DP>(Qs, LD,
                       reinterpret_cast<const T*>(p.q) + g * p.q_gs + h * p.q_hs +
                           q0 * p.q_rs,
                       p.q_rs, p.N - q0, BQ, p.D, tid);
      load_tile<T, DP>(dOs, LD,
                       reinterpret_cast<const T*>(p.dout) + g * p.do_gs + h * p.do_hs +
                           q0 * p.do_rs,
                       p.do_rs, p.N - q0, BQ, p.D, tid);
      for (int i = tid; i < BQ; i += kThreads) {
        const bool in = q0 + i < p.N;
        Ls[i] = in ? p.lse[row0 + q0 + i] : INFINITY;
        Ds[i] = in ? p.delta[row0 + q0 + i] : 0.0f;
      }
      __syncthreads();
      if (p.q_w != nullptr) {
        norm_rows<T>(Qs, LD, BQ, p.q_w, p.D, p.eps, true, tid);
        __syncthreads();
      }
      float s[4 * NS], dp[4 * NS];
      zero(s);
      zero(dp);
      warp_mm<NS, DP, false>(s, Kw, LD, Qs, LD, lane);  // S^T: keys x q rows
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int c = n * 8 + 2 * tig;
        const float l0 = Ls[c], l1 = Ls[c + 1];
        s[4 * n + 0] = prob<T>(s[4 * n + 0], p.scale, l0);
        s[4 * n + 1] = prob<T>(s[4 * n + 1], p.scale, l1);
        s[4 * n + 2] = prob<T>(s[4 * n + 2], p.scale, l0);
        s[4 * n + 3] = prob<T>(s[4 * n + 3], p.scale, l1);
      }
      stage<NS>(Pw, LS, s, lane);
      __syncwarp();
      warp_mm<NO, BQ, true>(dv, Pw, LS, dOs, LD, lane);    // dV += P^T dO
      warp_mm<NS, DP, false>(dp, Vw, LD, dOs, LD, lane);   // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < NS; ++n) {  // dS^T = P^T o (dP^T - delta); zero with one key
        const int c = n * 8 + 2 * tig;
        const float d0 = Ds[c], d1 = Ds[c + 1];
        s[4 * n + 0] = p.M == 1 ? 0.0f : s[4 * n + 0] * (dp[4 * n + 0] - d0);
        s[4 * n + 1] = p.M == 1 ? 0.0f : s[4 * n + 1] * (dp[4 * n + 1] - d1);
        s[4 * n + 2] = p.M == 1 ? 0.0f : s[4 * n + 2] * (dp[4 * n + 2] - d0);
        s[4 * n + 3] = p.M == 1 ? 0.0f : s[4 * n + 3] * (dp[4 * n + 3] - d1);
      }
      __syncwarp();  // every lane has read P^T
      stage<NS>(Pw, LS, s, lane);
      __syncwarp();
      warp_mm<NO, BQ, true>(dk, Pw, LS, Qs, LD, lane);     // dK += dS^T Q
    }
  }

  const int rows = p.M - k0;
  store_rows<NO, T>(reinterpret_cast<T*>(p.dv) + g2 * p.dv_gs + h * p.dv_hs + k0 * p.dv_rs,
                    p.dv_rs, dv, 1.0f, warp * 16, rows, p.D, lane);
  T* dkg = reinterpret_cast<T*>(p.dk) + g2 * p.dk_gs + h * p.dk_hs + k0 * p.dk_rs;
  if (p.k_w == nullptr) {
    store_rows<NO, T>(dkg, p.dk_rs, dk, p.scale, warp * 16, rows, p.D, lane);
    return;
  }
  stage_f32<NO>(St, LT, dk, p.scale, warp * 16, lane);
  __syncthreads();
  rms_backward<T>(St, LT, kg, p.k_rs, rows, p.k_w, p.D, p.eps, dkg, p.dk_rs, tid);
  if (p.dkw_part != nullptr) {
    __syncthreads();
    column_sums(St, LT, p.D, p.dkw_part, tid);
  }
}

// out[d] = sum over the blocks of part[b][d], in a fixed order: thread t takes
// blocks t, t + 256, ..., then a tree over the threads. One block a column.
__global__ void __launch_bounds__(256) attn_bwd_wsum(const float* part, int blocks, int D,
                                                     float* out) {
  __shared__ float red[256];
  const int d = blockIdx.x, tid = threadIdx.x;
  float s = 0.0f;
  for (int b = tid; b < blocks; b += 256) s += part[(long long)b * D + d];
  red[tid] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[d] = red[0];
}

// ---------------------------------------------------------------------------
// launch: the whole backward of one call, in order on one stream
// ---------------------------------------------------------------------------

inline long long dq_blocks(const Params& p) {
  return (long long)p.G * p.H * ((p.N + kOwn - 1) / kOwn);
}
inline long long dkdv_blocks(const Params& p) {
  return (long long)p.G * p.H * ((p.M + kOwn - 1) / kOwn);
}

template <typename T, int DP, int DV>
inline int launch(const Params& p, cudaStream_t stream) {
  if (p.G <= 0 || p.H <= 0 || p.N <= 0 || p.M <= 0 || p.J <= 0 || p.D <= 0 || p.D > DV ||
      (sizeof(T) == 2 && p.D % 8 != 0) || (p.J > 1 && p.perm == nullptr) ||
      ((p.perm == nullptr) != (p.inv_off == nullptr)) || (p.J == 1 && p.out == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long nq = dq_blocks(p), nkv = dkdv_blocks(p);
  const long long rows = (long long)p.G * p.N * p.H;
  if (nq > 2147483647LL || nkv > 2147483647LL || rows > 2147483647LL * (kThreads / 32))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err;
  if (p.J == 1) {
    attn_bwd_delta<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0,
                        stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int smem_q = (int)dq_smem_bytes<T, DP, DV>();
  err = cudaFuncSetAttribute(attn_bwd_dq<T, DP, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq<T, DP, DV><<<(unsigned)nq, kThreads, smem_q, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int smem_kv = (int)dkdv_smem_bytes<T, DP, DV>();
  err = cudaFuncSetAttribute(attn_bwd_dkdv<T, DP, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv<T, DP, DV><<<(unsigned)nkv, kThreads, smem_kv, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (p.q_w != nullptr && p.dqw_part != nullptr) {
    attn_bwd_wsum<<<p.D, 256, 0, stream>>>(p.dqw_part, (int)nq, p.D, p.dqw);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (p.k_w != nullptr && p.dkw_part != nullptr) {
    attn_bwd_wsum<<<p.D, 256, 0, stream>>>(p.dkw_part, (int)nkv, p.D, p.dkw);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// Params from the wrappers' flat arrays (the C entries of fused_qkv_attention.cu
// and flash_attention.cu): ptrs q, k, v, dout, out, dq, dk, dv, lse, delta, perm,
// inv_off, inv_src, q_w, k_w, dqw_part, dkw_part, dqw, dkw; ints G, H, N, M, D,
// J, then the (group, row, head) strides of q, k, v, dout, out, dq, dk, dv;
// floats scale, eps.
inline Params params_of(const void* const* ptrs, const long long* ints, const float* floats) {
  Params p;
  p.q = ptrs[0]; p.k = ptrs[1]; p.v = ptrs[2]; p.dout = ptrs[3]; p.out = ptrs[4];
  p.dq = const_cast<void*>(ptrs[5]);
  p.dk = const_cast<void*>(ptrs[6]);
  p.dv = const_cast<void*>(ptrs[7]);
  p.lse = static_cast<float*>(const_cast<void*>(ptrs[8]));
  p.delta = static_cast<float*>(const_cast<void*>(ptrs[9]));
  p.perm = static_cast<const int*>(ptrs[10]);
  p.inv_off = static_cast<const int*>(ptrs[11]);
  p.inv_src = static_cast<const int*>(ptrs[12]);
  p.q_w = static_cast<const float*>(ptrs[13]);
  p.k_w = static_cast<const float*>(ptrs[14]);
  p.dqw_part = static_cast<float*>(const_cast<void*>(ptrs[15]));
  p.dkw_part = static_cast<float*>(const_cast<void*>(ptrs[16]));
  p.dqw = static_cast<float*>(const_cast<void*>(ptrs[17]));
  p.dkw = static_cast<float*>(const_cast<void*>(ptrs[18]));
  p.G = (int)ints[0]; p.H = (int)ints[1]; p.N = (int)ints[2]; p.M = (int)ints[3];
  p.D = (int)ints[4]; p.J = (int)ints[5];
  const long long* s = ints + 6;
  p.q_gs = s[0]; p.q_rs = s[1]; p.q_hs = s[2];
  p.k_gs = s[3]; p.k_rs = s[4]; p.k_hs = s[5];
  p.v_gs = s[6]; p.v_rs = s[7]; p.v_hs = s[8];
  p.do_gs = s[9]; p.do_rs = s[10]; p.do_hs = s[11];
  p.o_gs = s[12]; p.o_rs = s[13]; p.o_hs = s[14];
  p.dq_gs = s[15]; p.dq_rs = s[16]; p.dq_hs = s[17];
  p.dk_gs = s[18]; p.dk_rs = s[19]; p.dk_hs = s[20];
  p.dv_gs = s[21]; p.dv_rs = s[22]; p.dv_hs = s[23];
  p.scale = floats[0];
  p.eps = floats[1];
  return p;
}

}  // namespace bwd
}  // namespace mdv2
