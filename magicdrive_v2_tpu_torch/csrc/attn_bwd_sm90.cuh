// The attention backward shared by fused_qkv_attention (K1) and
// flash_attention (K3), bf16 and fp32, for sm_90a. It replaces no Pallas kernel:
// the JAX package differentiates the XLA composition of the forward (jax.vjp of
// _xla_reference / xla_attention). Here the same gradient comes from the
// forward's saved row log-sum-exp, without an N x N buffer, in the formulation of
// FlashAttention-2: with P = exp(scale q k^T - lse) and dP = dO v^T per source,
//   dV = P^T dO,  dS = P o (dP - delta),  dQ = scale dS K,  dK = scale dS^T Q,
// where for one source lse is the forward's and delta = rowsum(dO o O). For J > 1
// sources, whose outputs the forward summed, the dQ kernel takes each source's
// statistics in a first pass over its keys: an online softmax gives lse_j, and
// the same rescaling gives delta_j = rowsum(P_j o dP_j) = rowsum(dO o O_j) without
// O_j; it writes both for the dK/dV kernel. Every sum stays in one block, so there
// are no floating-point atomics and a rerun gives the same bits: the dQ kernel
// owns q rows; a dK/dV block owns keys and walks the (source j, group g) pairs
// with perm[j][g] = g' (a list the wrapper builds in a fixed order); the (D,)
// RMSNorm weight grads are the blocks' fp32 partials summed in a fixed order
// (attn_bwd_wsum). One key gives dS = 0 exactly. K1 and K3 share the kernels
// through strides (K3's k and v are strided views of one projection).
//
// Two bodies:
// - the Hopper body (namespace wg): bf16 at head dims up to 72, every K1 call and
//   K3's at 72, the model's training path;
// - the CUDA-core / mma.sync body (attn_bwd_dq, attn_bwd_dkdv, attn_bwd_delta):
//   fp32 (the checks) and bf16 at head dim 144 (K3's two calls a step in the
//   condition embedders, one key each). Four warps a block own 64 rows; bf16
//   products are mma.sync m16n8k16 on operands in shared memory.
//
// Bound on an H100 (stage-2 step, qkv (120, 350, 3, 16, 72)): the five products
// of 2 N M D flops a (group, head, source) take 0.17 ms at 989 TFLOP/s, the bytes
// of q, k, v, dO, O and the grads 0.20 ms at 3.35 TB/s; the two kernels take
// seven products and read q, k, v and dO twice. What the Hopper body does about
// what held PR 17's (one mma.sync body for every type) back:
// 1. mma.sync m16n8k16 -> wgmma: S = q k^T, dP = dO v^T, S^T = k q^T and dP^T =
//    v dO^T read both operands K-major from shared memory (m64n64k16); dQ += dS k,
//    dV += P^T dO and dK += dS^T q take P or dS from registers and read the B tile
//    MN-major (m64nDVk16), one warpgroup a 64-row tile;
// 2. transposed B operands gathered two bf16 at a time -> the same tiles read
//    MN-major through their descriptors;
// 3. synchronous copies between barriers -> a cp.async ring of 4 stages in the
//    no-swizzle core-matrix layout, 2 tiles ahead of the one computed; the last
//    RS product of a tile (dQ; dK/dV waits, see 6) runs on into the next tile's;
// 4. q and k normalised for every tile loaded, one thread a row -> once a call
//    by attn_bwd_tiles (K1's pre-pass, the forward's cast points and sum orders)
//    into tiles the kernels copy as they lie; the norm's backward runs in the
//    accumulator layout (a row's four threads, two shuffles), not one warp a row
//    through shared memory;
// 5. P and dS staged in shared memory -> packed from the accumulator registers
//    as the A operand, as the forward packs its probabilities;
// 6. one 128-thread block an SM -> one block an SM of three warpgroups (384
//    threads) that share each streamed tile (it feeds 192 rows). ptxas -v at
//    head dim 72: dQ 167, dK/dV 168 registers, no spill; at 32: 160 / 164; at 16:
//    149 / 150 (the cap at 384 threads is 168). dK/dV keeps its last product's
//    wait inside the tile: deferring it spilled;
// 7. with J = 2 the dQ kernel still takes S and dP twice (the first pass for lse_j
//    and delta_j), as the forward writes no statistics with several sources.
// delta for one source is taken by the dQ kernel from its dO and output tiles
// (no pre-pass). What bounds the body at N = 350, where each block walks 5 or 6
// tiles, is an open question (PERF.md section 7).
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
  // the Hopper body (bf16, head dims up to 72): K1's q and k normalised by the
  // pre-pass, as tiles (2, G, H, T, DP / 8, 64, 8) with T = ceil(N / 64), or
  // nullptr (no norm: q and k read in place); the launch plan's shared memory
  const void* tiles;
  int dq_smem, dkdv_smem;
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

// The forward's RMSNorm of `nrows` fp32 rows in place, one warp a row as
// attn_core.cuh's (bf16 with the norm runs the Hopper body's pre-pass).
template <typename T>
__device__ __forceinline__ void norm_rows(T* tile, int ld, int nrows, const float* w, int D,
                                          float eps, int tid) {
  if constexpr (sizeof(T) == 4) {
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
    norm_rows<T>(Qs, LD, kOwn, p.q_w, p.D, p.eps, tid);
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
          norm_rows<T>(Ks, LD, kKeys, p.k_w, p.D, p.eps, tid);
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
    norm_rows<T>(Ks, LD, kOwn, p.k_w, p.D, p.eps, tid);
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
        norm_rows<T>(Qs, LD, BQ, p.q_w, p.D, p.eps, tid);
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
// the Hopper body: bf16 at head dims up to 72 (padded width DP 16, 32 or 80,
// value width DV 16, 32 or 72)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kStages = 4;       // depth of the ring of streamed tiles
constexpr int kGroups = 3;       // warpgroups a block, each 64 resident rows
constexpr int kBlocksPerSM = 1;  // what 168 registers a thread leave room for
constexpr int kBlockThreads = kThreads * kGroups;
constexpr int kKSteps = kRows / 16;       // 16-deep k-steps of a product over 64 rows

// Shared memory of one block: its kGroups resident tiles of each kind (q, dO and,
// with one source, the output; or k and v) and the ring's pairs of streamed
// tiles; the dK/dV ring also holds each q tile's lse and delta. After the loop
// the norm epilogue's column sums (4 kGroups x DV floats) reuse the ring. The
// wrapper's plan (plan_backward_bf16 in ops/flash_fused.py) computes the same
// numbers and hands them in; the launch checks them.
__host__ __device__ constexpr size_t dq_smem_bytes(int dp) {
  return sizeof(bf16) * (size_t)(3 * kGroups + 2 * kStages) * kRows * dp;
}
__host__ __device__ constexpr size_t dkdv_smem_bytes(int dp) {
  return sizeof(bf16) * (size_t)(2 * kGroups + 2 * kStages) * kRows * dp +
         sizeof(float) * (size_t)2 * kStages * kRows;
}
// Blocks of one kernel: (group, head) pairs times their runs of kGroups tiles.
inline long long blocks_of(const Params& p, int rows) {
  const long long tiles = (rows + kRows - 1) / kRows;
  return (long long)p.G * p.H * ((tiles + kGroups - 1) / kGroups);
}

// Tile t (rows 64t..) of q (part 0) or k (part 1) of (group g, head h): from the
// pre-pass's normalised tiles, or in place from the strided rows; zero past the
// last tile.
template <int DP>
__device__ __forceinline__ void load_qk(bf16* dst, const Params& p, int part, int g, int h,
                                        int t, int tid) {
  if (p.tiles != nullptr) {
    const int T = (p.N + kRows - 1) / kRows;
    if (t < T) {
      copy_tile<DP, kBlockThreads>(dst,
                    reinterpret_cast<const bf16*>(p.tiles) +
                        ((((long long)part * p.G + g) * p.H + h) * T + t) * (kRows * DP),
                    tid);
    } else {
      for (int idx = tid; idx < kRows * DP / 8; idx += kBlockThreads)
        *reinterpret_cast<uint4*>(dst + idx * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else if (part == 0) {
    copy_rows<DP, kBlockThreads>(dst,
                                 reinterpret_cast<const bf16*>(p.q) + g * p.q_gs + h * p.q_hs +
                                     (long long)t * kRows * p.q_rs,
                                 p.q_rs, p.N - t * kRows, p.D, tid);
  } else {
    copy_rows<DP, kBlockThreads>(dst,
                                 reinterpret_cast<const bf16*>(p.k) + g * p.k_gs + h * p.k_hs +
                                     (long long)t * kRows * p.k_rs,
                                 p.k_rs, p.M - t * kRows, p.D, tid);
  }
}

// The A operand of a register-sourced product from a 64 x 64 accumulator (the
// accumulator layout of 16 columns is the A fragment layout), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[kKSteps][4], const float (&x)[32]) {
#pragma unroll
  for (int kt = 0; kt < kKSteps; ++kt) {
    a[kt][0] = pack_bf16(x[8 * kt + 0], x[8 * kt + 1]);
    a[kt][1] = pack_bf16(x[8 * kt + 2], x[8 * kt + 3]);
    a[kt][2] = pack_bf16(x[8 * kt + 4], x[8 * kt + 5]);
    a[kt][3] = pack_bf16(x[8 * kt + 6], x[8 * kt + 7]);
  }
}

// d = A B^T over DP (acc 0) with A and B K-major tiles (64 rows each): q k^T,
// dO v^T, k q^T, v dO^T. Not committed.
template <int DP>
__device__ __forceinline__ void product_ss(float (&d)[32], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss(d, a + kk * (2 * kChunkBytes >> 4), b + kk * (2 * kChunkBytes >> 4), kk);
}

// d += A B with A (64 x 64) in registers and B a tile read MN-major (its 64 rows
// along the reduction, DV of its columns along N): dS k, P^T dO, dS^T q. Not
// committed.
template <int NO>
__device__ __forceinline__ void product_rs(float (&d)[NO], const uint32_t (&a)[kKSteps][4],
                                           uint64_t b) {
#pragma unroll
  for (int kt = 0; kt < kKSteps; ++kt) wgmma_rs(d, a[kt], b + kt * (2 * kBlock8Bytes >> 4));
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A warp's 16 rows of a 64 x DV accumulator (rows r0 + gid and + 8, columns 8n +
// 2 tig and + 1), times `mul`, to dst (row stride rs) in pairs of bf16; rows from
// `rows` on and columns from D on are not written.
template <int NG>
__device__ __forceinline__ void store_pairs(bf16* dst, long long rs, const float (&acc)[4 * NG],
                                            float mul, int r0, int rows, int D, int lane) {
  const int ra = r0 + (lane >> 2), rb = ra + 8, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    const int c = n * 8 + 2 * tig;  // D is a multiple of 8: c and c + 1 are both in or out
    if (c >= D) continue;
    if (ra < rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + ra * rs + c) =
          __floats2bfloat162_rn(acc[4 * n + 0] * mul, acc[4 * n + 1] * mul);
    if (rb < rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + rb * rs + c) =
          __floats2bfloat162_rn(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// Back through K1's RMSNorm in the accumulator layout, for one warpgroup's 64
// rows (warpgroup wg, thread wtid of it): acc * mul is dn, the grad of the
// normalised rows; x (row stride rs) the raw rows, `rows` of them valid. Writes
// dx = r (dn w - y mean(dn w y)), y = x r, to out (row stride ors), and, with
// part, the block's column sums of dn x_hat (x_hat = y rounded to bf16, the
// forward's; zero past the valid rows) to part[blockIdx.x][d]: a thread's two
// rows, a tree over the warp's eight row pairs, then the block's 4 kGroups warps
// in order through `red` (4 kGroups x 8NG floats of shared memory). A row's four
// threads sum its squares and dn w y by two shuffles. Every thread of the block
// calls it.
template <int NG>
__device__ __forceinline__ void norm_backward(const float (&acc)[4 * NG], float mul,
                                              const bf16* x, long long rs, int rows,
                                              const float* w, int D, float eps, bf16* out,
                                              long long ors, float* part, float* red, int wg,
                                              int wtid) {
  const int warp = wtid >> 5, lane = wtid & 31, gid = lane >> 2, tig = lane & 3;
  float ws[2 * NG];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + gid + 8 * half;
    const bool in = r < rows;
    float2 xv[NG];
    float sq = 0.0f;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      const int c = n * 8 + 2 * tig;
      xv[n] = (in && c < D) ? ld_bf16x2(x + r * rs + c) : make_float2(0.0f, 0.0f);
      sq += xv[n].x * xv[n].x + xv[n].y * xv[n].y;
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float rinv = 1.0f / sqrtf(sq / (float)D + eps);
    float gy = 0.0f;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      const int c = n * 8 + 2 * tig;
      if (c < D)
        gy += acc[4 * n + 2 * half] * mul * w[c] * (xv[n].x * rinv) +
              acc[4 * n + 2 * half + 1] * mul * w[c + 1] * (xv[n].y * rinv);
    }
    gy += __shfl_xor_sync(0xffffffffu, gy, 1);
    gy += __shfl_xor_sync(0xffffffffu, gy, 2);
    gy /= (float)D;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      const int c = n * 8 + 2 * tig;
      const float dn0 = acc[4 * n + 2 * half] * mul, dn1 = acc[4 * n + 2 * half + 1] * mul;
      const float y0 = xv[n].x * rinv, y1 = xv[n].y * rinv;
      if (c < D && in)
        *reinterpret_cast<__nv_bfloat162*>(out + r * ors + c) = __floats2bfloat162_rn(
            rinv * (dn0 * w[c] - y0 * gy), rinv * (dn1 * w[c + 1] - y1 * gy));
      const float t0 = dn0 * __bfloat162float(__float2bfloat16(y0));
      const float t1 = dn1 * __bfloat162float(__float2bfloat16(y1));
      ws[2 * n] = half == 0 ? t0 : ws[2 * n] + t0;
      ws[2 * n + 1] = half == 0 ? t1 : ws[2 * n + 1] + t1;
    }
  }
  if (part == nullptr) return;
#pragma unroll
  for (int i = 0; i < 2 * NG; ++i) {
    ws[i] += __shfl_xor_sync(0xffffffffu, ws[i], 4);
    ws[i] += __shfl_xor_sync(0xffffffffu, ws[i], 8);
    ws[i] += __shfl_xor_sync(0xffffffffu, ws[i], 16);
  }
  float* mine = red + (wg * 4 + warp) * 8 * NG;
  if (gid == 0) {
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      mine[n * 8 + 2 * tig] = ws[2 * n];
      mine[n * 8 + 2 * tig + 1] = ws[2 * n + 1];
    }
  }
  __syncthreads();
  const int tid = wg * kThreads + wtid;
  for (int d = tid; d < D; d += kBlockThreads) {
    float s = red[d];
    for (int i = 1; i < 4 * kGroups; ++i) s += red[i * 8 * NG + d];
    part[(long long)blockIdx.x * D + d] = s;
  }
}

// rowsum(dO o O) of row r of two tiles in the tile layout (its four threads each
// take every fourth pair of columns; all four get the sum); zero rows give 0.
template <int DV>
__device__ __forceinline__ float tile_row_dot(const bf16* dO, const bf16* O, int r, int tig,
                                              int D) {
  float s = 0.0f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int at = n * kRows * 8 + r * 8 + 2 * tig;  // columns 8n + 2 tig, + 1
    if (n * 8 < D) {
      const float2 a = ld_bf16x2(dO + at), b = ld_bf16x2(O + at);
      s += a.x * b.x + a.y * b.y;
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// K1's pre-pass: one 64-row tile of q (blockIdx.y 0) or k (1) of one (group,
// head) from qkv (G, N, 3, H, D), normalised with the forward's cast points and
// sums (q: even chunks, then odd chunks, as k1_attention's two threads a row;
// k: chunk by chunk, as k1_tile_k), into the tiles (2, G, H, T, DP / 8, 64, 8);
// rows past N and columns past D zero. Thread r: row r.
template <int DP>
__global__ void __launch_bounds__(kRows) attn_bwd_tiles(const bf16* __restrict__ qkv,
                                                        bf16* __restrict__ tiles,
                                                        const float* __restrict__ q_w,
                                                        const float* __restrict__ k_w, int G,
                                                        int N, int H, int D, int T, float eps) {
  constexpr int CPR = DP / 8;
  const int part = blockIdx.y;
  const int r = threadIdx.x;
  const int t = blockIdx.x % T;
  const int h = (blockIdx.x / T) % H;
  const int g = blockIdx.x / (T * H);
  const int n = t * kRows + r;
  uint4 x[CPR];
  const bf16* src = qkv + (((long long)g * N + n) * 3 + part) * H * D + (long long)h * D;
#pragma unroll
  for (int c = 0; c < CPR; ++c)
    x[c] = (n < N && c * 8 < D) ? __ldg(reinterpret_cast<const uint4*>(src + c * 8))
                                : make_uint4(0u, 0u, 0u, 0u);
  const float* w = part == 0 ? q_w : k_w;
  float sq = 0.0f;
  if (part == 0) {
    float s1 = 0.0f;
#pragma unroll
    for (int c = 0; c < CPR; c += 2)
      if (c * 8 < D) sq += k1::sum_sq(x[c]);
#pragma unroll
    for (int c = 1; c < CPR; c += 2)
      if (c * 8 < D) s1 += k1::sum_sq(x[c]);
    sq += s1;
  } else {
#pragma unroll
    for (int c = 0; c < CPR; ++c) sq += k1::sum_sq(x[c]);
  }
  const float rinv = 1.0f / sqrtf(sq / (float)D + eps);
#pragma unroll
  for (int c = 0; c < CPR; ++c)
    if (c * 8 < D) k1::rms_chunk(x[c], w + c * 8, rinv);  // padding columns stay zero
  bf16* dst = tiles + ((((long long)part * G + g) * H + h) * T + t) * (kRows * DP) + r * 8;
#pragma unroll
  for (int c = 0; c < CPR; ++c) *reinterpret_cast<uint4*>(dst + c * kRows * 8) = x[c];
}

// dQ of kGroups q tiles (64 rows each, one warpgroup each) of one (group, head),
// summed over the sources. The q and dO tiles (and with one source the output's)
// stay; the k and v tiles of the (source, pass, key tile) sequence stream through
// the ring, kStages - 2 ahead, each feeding every warpgroup. Per key tile and
// warpgroup: S = q k^T and dP = dO v^T (wgmma, both operands from shared memory),
// then P and dS = P o (dP - delta) in registers, then dQ += dS k (wgmma, dS from
// registers, k read MN-major), which runs on into the next tile's S and dP (its k
// slot is refilled two tiles later). With J > 1 a first pass over a source's keys
// takes its lse and delta (S and dP only); with one source the block takes delta
// = rowsum(dO o O) from its tiles and writes it for the dK/dV kernel. A
// warpgroup past the last q tile computes on zero rows and writes nothing.
template <int DP, int DV>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSM) attn_bwd_dq_wg(Params p) {
  constexpr int TILE = kRows * DP;
  constexpr int NO = DV / 2;  // dQ registers a thread (m64nDV)
  constexpr int AHEAD = kStages - 2;  // tiles in flight beyond the one computed
  static_assert(AHEAD >= 1, "the dQ ring needs three stages");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // kGroups q tiles
  bf16* dOs = Qs + kGroups * TILE;               // their dO
  bf16* Os = dOs + kGroups * TILE;               // their output (one source)
  bf16* Ks = Os + kGroups * TILE;                // kStages k tiles
  bf16* Vs = Ks + kStages * TILE;                // kStages v tiles

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & (kThreads - 1);
  const int warp = wtid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nq = (p.N + kRows - 1) / kRows;
  const int runs = (nq + kGroups - 1) / kGroups;
  const int qb = blockIdx.x % runs;
  const int h = (blockIdx.x / runs) % p.H;
  const int g = blockIdx.x / (runs * p.H);
  const int q0 = (qb * kGroups + wg) * kRows;  // this warpgroup's rows
  const int nk = (p.M + kRows - 1) / kRows;
  const bool multi = p.J > 1;
  const int per_src = (multi ? 2 : 1) * nk;  // tiles of one source: its passes
  const int total = p.J * per_src;
  const bf16* vb = reinterpret_cast<const bf16*>(p.v) + h * p.v_hs;

  auto prefetch = [&](int i) {
    const int j = i / per_src, t = (i % per_src) % nk;
    const int gk = (p.perm != nullptr) ? __ldg(p.perm + j * p.G + g) : g;
    load_qk<DP>(Ks + (i % kStages) * TILE, p, 1, gk, h, t, tid);
    copy_rows<DP, kBlockThreads>(Vs + (i % kStages) * TILE,
                                 vb + gk * p.v_gs + (long long)t * kRows * p.v_rs, p.v_rs,
                                 p.M - t * kRows, p.D, tid);
  };
  // group 0: the q, dO (and output) tiles and tile 0; group s < AHEAD: tile s
#pragma unroll
  for (int w = 0; w < kGroups; ++w) {
    const int t = qb * kGroups + w;
    load_qk<DP>(Qs + w * TILE, p, 0, g, h, t, tid);
    copy_rows<DP, kBlockThreads>(dOs + w * TILE,
                                 reinterpret_cast<const bf16*>(p.dout) + g * p.do_gs +
                                     h * p.do_hs + (long long)t * kRows * p.do_rs,
                                 p.do_rs, p.N - t * kRows, p.D, tid);
    if (!multi)
      copy_rows<DP, kBlockThreads>(Os + w * TILE,
                                   reinterpret_cast<const bf16*>(p.out) + g * p.o_gs +
                                       h * p.o_hs + (long long)t * kRows * p.o_rs,
                                   p.o_rs, p.N - t * kRows, p.D, tid);
  }
  prefetch(0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < AHEAD; ++st) {
    if (st < total) prefetch(st);
    cp_async_commit();
  }
  const uint64_t q_desc = tile_desc(Qs + wg * TILE, kChunkBytes, kBlock8Bytes);
  const uint64_t do_desc = tile_desc(dOs + wg * TILE, kChunkBytes, kBlock8Bytes);
  const int ra = q0 + warp * 16 + gid, rb = ra + 8;  // this thread's rows

  float dq[NO];
  zero(dq);
  uint32_t a[kKSteps][4];  // dS as the A operand, read by a product still running
  float la = INFINITY, lb = INFINITY, da = 0.0f, db = 0.0f;  // lse and delta of the rows
  float ma = -INFINITY, mb = -INFINITY, sa = 0.0f, sb = 0.0f, ua = 0.0f, ub = 0.0f;
  for (int i = 0; i < total; ++i) {
    const int j = i / per_src, r = i % per_src, t = r % nk;
    const bool stats = multi && r < nk;  // the first pass over a source's keys
    const long long row0 = ((long long)j * p.G + g) * p.H * p.N + (long long)h * p.N;
    if (r == 0 && multi) {
      ma = -INFINITY; mb = -INFINITY;
      sa = 0.0f; sb = 0.0f; ua = 0.0f; ub = 0.0f;
    }
    cp_async_wait<AHEAD - 1>();  // tile i (and the resident tiles) have landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread, and every warp is past tile i - 2's dQ
    if (i + AHEAD < total) prefetch(i + AHEAD);  // into the slot of tile i - 2
    cp_async_commit();
    if (i == 0 && !multi) {  // one source: the forward's lse, and delta from the tiles
      la = ra < p.N ? p.lse[row0 + ra] : INFINITY;
      lb = rb < p.N ? p.lse[row0 + rb] : INFINITY;
      da = tile_row_dot<DV>(dOs + wg * TILE, Os + wg * TILE, warp * 16 + gid, tig, p.D);
      db = tile_row_dot<DV>(dOs + wg * TILE, Os + wg * TILE, warp * 16 + gid + 8, tig, p.D);
      if (tig == 0) {
        if (ra < p.N) p.delta[row0 + ra] = da;
        if (rb < p.N) p.delta[row0 + rb] = db;
      }
    }
    const bf16* K = Ks + (i % kStages) * TILE;
    const bf16* V = Vs + (i % kStages) * TILE;

    float s[32], dp[32];
    wgmma_fence();
    product_ss<DP>(s, q_desc, tile_desc(K, kChunkBytes, kBlock8Bytes));
    wgmma_commit();
    product_ss<DP>(dp, do_desc, tile_desc(V, kChunkBytes, kBlock8Bytes));
    wgmma_commit();
    const int k0 = t * kRows;
    if (stats) {
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      online_stats<bf16, 8>(s, dp, k0, p.M, p.scale, ma, mb, sa, sb, ua, ub, tig);
      if (t == nk - 1) {  // the four threads of a row hold its strips of keys
        finish_stats<bf16>(ma, sa, ua, la, da);
        finish_stats<bf16>(mb, sb, ub, lb, db);
        if (tig == 0) {
          if (ra < p.N) { p.lse[row0 + ra] = la; p.delta[row0 + ra] = da; }
          if (rb < p.N) { p.lse[row0 + rb] = lb; p.delta[row0 + rb] = db; }
        }
      }
      continue;
    }
    wgmma_wait<1>();  // S (and the last tile's dQ) are in; dP may still run
    fence_regs(s);
    fence_regs(a);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // P, zero for keys past M
      const int c = k0 + n * 8 + 2 * tig;
      s[4 * n + 0] = c < p.M ? prob<bf16>(s[4 * n + 0], p.scale, la) : 0.0f;
      s[4 * n + 1] = c + 1 < p.M ? prob<bf16>(s[4 * n + 1], p.scale, la) : 0.0f;
      s[4 * n + 2] = c < p.M ? prob<bf16>(s[4 * n + 2], p.scale, lb) : 0.0f;
      s[4 * n + 3] = c + 1 < p.M ? prob<bf16>(s[4 * n + 3], p.scale, lb) : 0.0f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    if (p.M == 1) {  // one key: the softmax is constant, its grads exactly zero
      zero(s);
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {  // dS = P o (dP - delta)
        s[4 * n + 0] *= dp[4 * n + 0] - da;
        s[4 * n + 1] *= dp[4 * n + 1] - da;
        s[4 * n + 2] *= dp[4 * n + 2] - db;
        s[4 * n + 3] *= dp[4 * n + 3] - db;
      }
    }
    pack_a(a, s);
    fence_regs(dq);
    wgmma_fence();
    product_rs(dq, a, tile_desc(K, kBlock8Bytes, kChunkBytes));
    wgmma_commit();  // waited for by the next tile's S, or after the loop
  }
  wgmma_wait<0>();
  fence_regs(a);
  fence_regs(dq);
  cp_async_wait<0>();

  bf16* dqg = reinterpret_cast<bf16*>(p.dq) + g * p.dq_gs + h * p.dq_hs + (long long)q0 * p.dq_rs;
  if (p.q_w == nullptr) {
    store_pairs<DV / 8>(dqg, p.dq_rs, dq, p.scale, warp * 16, p.N - q0, p.D, lane);
    return;
  }
  __syncthreads();  // every warp is done with the ring, whose start holds the sums
  norm_backward<DV / 8>(dq, p.scale,
                        reinterpret_cast<const bf16*>(p.q) + g * p.q_gs + h * p.q_hs +
                            (long long)q0 * p.q_rs,
                        p.q_rs, p.N - q0, p.q_w, p.D, p.eps, dqg, p.dq_rs, p.dqw_part,
                        reinterpret_cast<float*>(Ks), wg, wtid);
}

// dK and dV of kGroups key tiles (64 keys each, one warpgroup each) of one (group
// g', head), summed over the (source j, group g) pairs that read g' and over
// their q tiles. The k and v tiles stay; the q and dO tiles, with their lse and
// delta, stream through the ring, each feeding every warpgroup. Per q tile and
// warpgroup: S^T = k q^T and dP^T = v dO^T (wgmma from shared memory); P^T in
// registers, then dV += P^T dO (P^T from registers, dO read MN-major) runs while
// dS^T = P^T o (dP^T - delta) is formed, then dK += dS^T q. A warpgroup past the
// last key tile computes on zero rows and writes nothing.
template <int DP, int DV>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSM) attn_bwd_dkdv_wg(Params p) {
  constexpr int TILE = kRows * DP;
  constexpr int NO = DV / 2;  // dK and dV registers a thread, each
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // kGroups k tiles
  bf16* Vs = Ks + kGroups * TILE;                // their v
  bf16* Qs = Vs + kGroups * TILE;                // kStages q tiles
  bf16* dOs = Qs + kStages * TILE;               // kStages dO tiles
  float* Ls = reinterpret_cast<float*>(dOs + kStages * TILE);  // kStages x 64 lse
  float* Ds = Ls + kStages * kRows;                             // kStages x 64 delta

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & (kThreads - 1);
  const int warp = wtid >> 5, lane = tid & 31;
  const int tig = lane & 3;
  const int nkt = (p.M + kRows - 1) / kRows;
  const int runs = (nkt + kGroups - 1) / kGroups;
  const int kb = blockIdx.x % runs;
  const int h = (blockIdx.x / runs) % p.H;
  const int g2 = blockIdx.x / (runs * p.H);
  const int k0 = (kb * kGroups + wg) * kRows;  // this warpgroup's keys
  const int nq = (p.N + kRows - 1) / kRows;
  const int e0 = p.inv_off != nullptr ? p.inv_off[g2] : 0;
  const int e1 = p.inv_off != nullptr ? p.inv_off[g2 + 1] : 1;
  const int total = (e1 - e0) * nq;
  const bf16* dob = reinterpret_cast<const bf16*>(p.dout) + h * p.do_hs;

  auto prefetch = [&](int i) {
    const int e = e0 + i / nq, t = i % nq;
    const int src = p.inv_src != nullptr ? __ldg(p.inv_src + e) : g2;  // j * G + g
    const int g = src % p.G;
    const int slot = i % kStages;
    load_qk<DP>(Qs + slot * TILE, p, 0, g, h, t, tid);
    copy_rows<DP, kBlockThreads>(dOs + slot * TILE,
                                 dob + g * p.do_gs + (long long)t * kRows * p.do_rs, p.do_rs,
                                 p.N - t * kRows, p.D, tid);
    if (tid < 2 * kRows) {  // threads 0-63 the lse, 64-127 the delta of the q rows
      const int row = t * kRows + (tid & (kRows - 1));
      const long long at = (long long)src * p.H * p.N + (long long)h * p.N + row;
      float* dst = (tid < kRows ? Ls : Ds) + slot * kRows + (tid & (kRows - 1));
      if (row < p.N)
        cp_async_4(dst, (tid < kRows ? p.lse : p.delta) + at);
      else
        *dst = tid < kRows ? INFINITY : 0.0f;  // q rows past N: P = 0
    }
  };
#pragma unroll
  for (int w = 0; w < kGroups; ++w) {
    const int t = kb * kGroups + w;
    load_qk<DP>(Ks + w * TILE, p, 1, g2, h, t, tid);
    copy_rows<DP, kBlockThreads>(Vs + w * TILE,
                                 reinterpret_cast<const bf16*>(p.v) + g2 * p.v_gs +
                                     h * p.v_hs + (long long)t * kRows * p.v_rs,
                                 p.v_rs, p.M - t * kRows, p.D, tid);
  }
  if (total > 0) prefetch(0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < kStages - 1; ++st) {
    if (st < total) prefetch(st);
    cp_async_commit();
  }
  const uint64_t k_desc = tile_desc(Ks + wg * TILE, kChunkBytes, kBlock8Bytes);
  const uint64_t v_desc = tile_desc(Vs + wg * TILE, kChunkBytes, kBlock8Bytes);

  float dk[NO], dv[NO];
  zero(dk);
  zero(dv);
  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (i + kStages - 1 < total) prefetch(i + kStages - 1);
    cp_async_commit();
    const int slot = i % kStages;
    const bf16* Q = Qs + slot * TILE;
    const bf16* dO = dOs + slot * TILE;
    const float2* L = reinterpret_cast<const float2*>(Ls + slot * kRows);
    const float2* Dl = reinterpret_cast<const float2*>(Ds + slot * kRows);

    float s[32], dp[32];
    wgmma_fence();
    product_ss<DP>(s, k_desc, tile_desc(Q, kChunkBytes, kBlock8Bytes));  // S^T: keys x q rows
    wgmma_commit();
    product_ss<DP>(dp, v_desc, tile_desc(dO, kChunkBytes, kBlock8Bytes));  // dP^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // P^T; the columns are q rows
      const float2 l = L[n * 4 + tig];
      s[4 * n + 0] = prob<bf16>(s[4 * n + 0], p.scale, l.x);
      s[4 * n + 1] = prob<bf16>(s[4 * n + 1], p.scale, l.y);
      s[4 * n + 2] = prob<bf16>(s[4 * n + 2], p.scale, l.x);
      s[4 * n + 3] = prob<bf16>(s[4 * n + 3], p.scale, l.y);
    }
    uint32_t pa[kKSteps][4];
    pack_a(pa, s);
    fence_regs(dv);
    wgmma_fence();
    product_rs(dv, pa, tile_desc(dO, kBlock8Bytes, kChunkBytes));  // dV += P^T dO
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is in; dV's product may still run
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // dS^T = P^T o (dP^T - delta); zero with one key
      const float2 d = Dl[n * 4 + tig];
      s[4 * n + 0] = p.M == 1 ? 0.0f : s[4 * n + 0] * (dp[4 * n + 0] - d.x);
      s[4 * n + 1] = p.M == 1 ? 0.0f : s[4 * n + 1] * (dp[4 * n + 1] - d.y);
      s[4 * n + 2] = p.M == 1 ? 0.0f : s[4 * n + 2] * (dp[4 * n + 2] - d.x);
      s[4 * n + 3] = p.M == 1 ? 0.0f : s[4 * n + 3] * (dp[4 * n + 3] - d.y);
    }
    uint32_t sa[kKSteps][4];
    pack_a(sa, s);
    fence_regs(dk);
    wgmma_fence();
    product_rs(dk, sa, tile_desc(Q, kBlock8Bytes, kChunkBytes));  // dK += dS^T q
    wgmma_commit();
    wgmma_wait<0>();  // the q and dO slot is refilled after a later barrier
    fence_regs(pa);
    fence_regs(sa);
    fence_regs(dv);
    fence_regs(dk);
  }
  cp_async_wait<0>();

  const int rows = p.M - k0;
  store_pairs<DV / 8>(reinterpret_cast<bf16*>(p.dv) + g2 * p.dv_gs + h * p.dv_hs +
                          (long long)k0 * p.dv_rs,
                      p.dv_rs, dv, 1.0f, warp * 16, rows, p.D, lane);
  bf16* dkg = reinterpret_cast<bf16*>(p.dk) + g2 * p.dk_gs + h * p.dk_hs + (long long)k0 * p.dk_rs;
  if (p.k_w == nullptr) {
    store_pairs<DV / 8>(dkg, p.dk_rs, dk, p.scale, warp * 16, rows, p.D, lane);
    return;
  }
  __syncthreads();  // every warp is done with the ring, whose start holds the sums
  norm_backward<DV / 8>(dk, p.scale,
                        reinterpret_cast<const bf16*>(p.k) + g2 * p.k_gs + h * p.k_hs +
                            (long long)k0 * p.k_rs,
                        p.k_rs, rows, p.k_w, p.D, p.eps, dkg, p.dk_rs, p.dkw_part,
                        reinterpret_cast<float*>(Qs), wg, wtid);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// launch: the whole backward of one call, in order on one stream
// ---------------------------------------------------------------------------

inline long long dq_blocks(const Params& p) {
  return (long long)p.G * p.H * ((p.N + kOwn - 1) / kOwn);
}
inline long long dkdv_blocks(const Params& p) {
  return (long long)p.G * p.H * ((p.M + kOwn - 1) / kOwn);
}

// bf16 at value widths up to 72 runs the Hopper body (namespace wg), everything
// else (fp32; bf16 at head dim 144) the CUDA-core / mma.sync body above.
template <typename T, int DP, int DV>
inline int launch(const Params& p, cudaStream_t stream) {
  constexpr bool hopper = sizeof(T) == 2 && DV <= 72;
  if (p.G <= 0 || p.H <= 0 || p.N <= 0 || p.M <= 0 || p.J <= 0 || p.D <= 0 || p.D > DV ||
      (sizeof(T) == 2 && p.D % 8 != 0) || (p.J > 1 && p.perm == nullptr) ||
      ((p.perm == nullptr) != (p.inv_off == nullptr)) || (p.J == 1 && p.out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (hopper ? (p.dq_smem != (int)wg::dq_smem_bytes(DP) ||
                p.dkdv_smem != (int)wg::dkdv_smem_bytes(DP) ||
                (p.tiles != nullptr) != (p.q_w != nullptr) || (p.tiles != nullptr && p.M != p.N))
             : (p.tiles != nullptr || (sizeof(T) == 2 && p.q_w != nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long nq = hopper ? wg::blocks_of(p, p.N) : dq_blocks(p);
  const long long nkv = hopper ? wg::blocks_of(p, p.M) : dkdv_blocks(p);
  const int threads = hopper ? wg::kBlockThreads : kThreads;
  const long long rows = (long long)p.G * p.N * p.H;
  if (nq > 2147483647LL || nkv > 2147483647LL || rows > 2147483647LL * (kThreads / 32))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err;
  if constexpr (!hopper) {  // the Hopper body's dQ kernel takes delta itself
    if (p.J == 1) {
      attn_bwd_delta<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads,
                          0, stream>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  void (*dq_kernel)(Params);
  void (*dkdv_kernel)(Params);
  int smem_q, smem_kv;
  if constexpr (hopper) {
    dq_kernel = wg::attn_bwd_dq_wg<DP, DV>;
    dkdv_kernel = wg::attn_bwd_dkdv_wg<DP, DV>;
    smem_q = p.dq_smem;
    smem_kv = p.dkdv_smem;
  } else {
    dq_kernel = attn_bwd_dq<T, DP, DV>;
    dkdv_kernel = attn_bwd_dkdv<T, DP, DV>;
    smem_q = (int)dq_smem_bytes<T, DP, DV>();
    smem_kv = (int)dkdv_smem_bytes<T, DP, DV>();
  }
  err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<(unsigned)nq, threads, smem_q, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<<<(unsigned)nkv, threads, smem_kv, stream>>>(p);
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

// K1's pre-pass for the Hopper body: q and k of qkv, normalised, as tiles.
template <int DP>
inline int launch_tiles(const bf16* qkv, bf16* tiles, const float* q_w, const float* k_w, int G,
                        int N, int H, int D, int T, float eps, cudaStream_t stream) {
  const long long blocks = (long long)G * H * T;
  if (blocks <= 0 || blocks > 2147483647LL || q_w == nullptr || k_w == nullptr)
    return (int)cudaErrorInvalidValue;
  wg::attn_bwd_tiles<DP><<<dim3((unsigned)blocks, 2), kRows, 0, stream>>>(qkv, tiles, q_w, k_w,
                                                                          G, N, H, D, T, eps);
  return (int)cudaGetLastError();
}

// Params from the wrappers' flat arrays (the C entries of fused_qkv_attention.cu
// and flash_attention.cu): ptrs q, k, v, dout, out, dq, dk, dv, lse, delta, perm,
// inv_off, inv_src, q_w, k_w, dqw_part, dkw_part, dqw, dkw, tiles; ints G, H, N,
// M, D, J, then the (group, row, head) strides of q, k, v, dout, out, dq, dk, dv,
// then the plan's shared memory of the dQ and the dK/dV blocks (0 for the
// CUDA-core body); floats scale, eps.
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
  p.tiles = ptrs[19];
  p.dq_smem = (int)s[24];
  p.dkdv_smem = (int)s[25];
  p.scale = floats[0];
  p.eps = floats[1];
  return p;
}

}  // namespace bwd
}  // namespace mdv2
