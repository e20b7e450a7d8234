// Shared attention core for the fused-qkv attention and the generic flash
// attention kernels (sm_90a).
//
// One thread block computes one (group, head, 64-row q tile). Inside the block
// a loop runs over the J k/v sources and, inside that, over 64-row k tiles
// with an online softmax (running max, running sum, fp32 accumulator in
// registers). After a source's k loop the accumulator is divided by that
// source's softmax sum and added into a per-block fp32 output accumulator,
// which is written once at the end. q, k and v are read in place through
// element strides, so the same body serves the packed (G, N, 3, H, D) qkv
// buffer and separate BNHD q/k/v tensors.
//
// Two bodies:
//   attn_fwd_bf16<DP, MULTI>
//                 bf16 operands, tensor cores through mma.sync m16n8k16 (fp32
//                 accumulate), four warps of 16 q rows each. k/v tiles arrive
//                 through a two-stage cp.async ring, so the copy of the next
//                 tile overlaps the products of this one; fragments are read
//                 with ldmatrix (transposed for v). The head dim is zero-padded
//                 in shared memory to DP (a multiple of 16); the RMSNorm mean
//                 still divides by the true D.
//   attn_fwd_f32  fp32 operands on the CUDA cores: every product and sum in
//                 fp32, which is what allows a tight comparison with the plain
//                 PyTorch version on the card.
//
// Optional per-head RMSNorm of q and k rows, with these cast points: fp32
// normalise (mean over D), round to the operand type, multiply by the fp32
// weight, round back. Rows past the sequence end are zero-filled (v too: a
// zero probability times a non-finite stale value would poison p.v) and their
// logits are set to -inf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mdv2 {

typedef __nv_bfloat16 bf16;

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  // element strides: group, row, head (the head-dim stride is 1)
  long long q_gs, q_rs, q_hs;
  long long k_gs, k_rs, k_hs;
  long long v_gs, v_rs, v_hs;
  long long o_gs, o_rs, o_hs;
  const int* perm;    // (J, G) source group of k/v, or nullptr for identity
  const float* q_w;   // (D,) fp32 RMSNorm weight shared by the heads, or nullptr for no norm
  const float* k_w;
  int G, H, N, M, D, J;
  float scale;
  float eps;
};

constexpr int kMaxD = 144;  // largest head dim (the condition embedders' 1152 / 8)
constexpr int kBQ = 64;  // q rows per block (bf16 body)
constexpr int kBK = 64;  // k rows per tile

// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h2);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and receives, from matrix i, the elements
// (row l / 4, columns 2 * (l % 4), +1) in r[i] - transposed with ldsm_x4_trans.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// Copy a 64-row tile (rows row0.. of a matrix with `limit` rows, D columns)
// into shared memory with row stride `ss`, zero-filling rows past `limit` and
// columns in [D, DP). The copy is asynchronous (cp.async, 16 bytes a request):
// the caller commits the group and waits for it. D is a multiple of 8 and the
// source rows are 16-byte aligned (launch_attention refuses anything else).
template <int DP>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, int ss, const bf16* src,
                                               long long rs, int row0, int limit,
                                               int D, int tid) {
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < 64 * CPR; idx += 128) {
    int r = idx / CPR, c = idx - r * CPR;
    int d0 = c * 8;
    int row = row0 + r;
    if (row < limit && d0 < D)
      cp_async_16(dst + r * ss + d0, src + (long long)row * rs + d0);
    else
      *reinterpret_cast<uint4*>(dst + r * ss + d0) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Per-row RMSNorm of a 64-row tile in shared memory; two threads per row, each
// on every other pair of columns.
__device__ __forceinline__ void rms_rows_bf16(bf16* tile, int ss, const float* w,
                                              int D, float eps, int tid) {
  const int r = tid >> 1, p = tid & 1;
  bf16* row = tile + r * ss;
  float sq = 0.0f;
  __nv_bfloat162* row2 = reinterpret_cast<__nv_bfloat162*>(row);
  const int D2 = D >> 1;  // D is even
  for (int i = p; i < D2; i += 2) {
    const float2 x = __bfloat1622float2(row2[i]);
    sq += x.x * x.x + x.y * x.y;
  }
  sq += __shfl_xor_sync(0xffffffffu, sq, 1);
  const float rinv = 1.0f / sqrtf(sq / (float)D + eps);
  for (int i = p; i < D2; i += 2) {
    const float2 x = __bfloat1622float2(row2[i]);
    const float2 xn = __bfloat1622float2(__floats2bfloat162_rn(x.x * rinv, x.y * rinv));
    row2[i] = __floats2bfloat162_rn(w[2 * i] * xn.x, w[2 * i + 1] * xn.y);
  }
}

// MULTI: more than one k/v source (J > 1). A single source needs no second
// accumulator, which frees ND * 4 registers per thread.
//
// The k and v tiles of all sources form one sequence of J * ceil(M / 64) tiles
// that runs through a two-stage ring in shared memory: while a tile is being
// multiplied, the next one is in flight (cp.async). k and v tiles are both kept
// row-major; the p.v product reads v through ldmatrix.trans.
template <int DP, bool MULTI>
__global__ void __launch_bounds__(128) attn_fwd_bf16(AttnParams p) {
  constexpr int QS = DP + 8;    // row stride of every tile (elements)
  constexpr int KD = DP / 16;   // k-steps over the head dim
  constexpr int ND = DP / 8;    // n-tiles over the head dim
  constexpr int NK = kBK / 8;   // n-tiles over the keys of a tile
  constexpr int TILE = 64 * QS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Kbuf = Qs + TILE;        // two k tiles
  bf16* Vbuf = Kbuf + 2 * TILE;  // two v tiles

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: matrix and row of this lane
  const int nq = (p.N + kBQ - 1) / kBQ;
  const int bid = blockIdx.x;
  const int qt = bid % nq;
  const int h = (bid / nq) % p.H;
  const int g = bid / (nq * p.H);
  const int q0 = qt * kBQ;
  const int nt = (p.M + kBK - 1) / kBK;
  const int total = p.J * nt;

  const bf16* kall = reinterpret_cast<const bf16*>(p.k) + (long long)h * p.k_hs;
  const bf16* vall = reinterpret_cast<const bf16*>(p.v) + (long long)h * p.v_hs;

  // start the copy of tile i of the flattened (source, k tile) sequence
  auto prefetch = [&](int i) {
    const int j = i / nt, t = i - j * nt;
    const int gk = (p.perm != nullptr) ? p.perm[j * p.G + g] : g;
    bf16* kd = Kbuf + (i & 1) * TILE;
    bf16* vd = Vbuf + (i & 1) * TILE;
    load_rows_bf16<DP>(kd, QS, kall + (long long)gk * p.k_gs, p.k_rs, t * kBK, p.M, p.D,
                       tid);
    load_rows_bf16<DP>(vd, QS, vall + (long long)gk * p.v_gs, p.v_rs, t * kBK, p.M, p.D,
                       tid);
    cp_async_commit();
  };

  const bf16* qbase =
      reinterpret_cast<const bf16*>(p.q) + (long long)g * p.q_gs + (long long)h * p.q_hs;
  load_rows_bf16<DP>(Qs, QS, qbase, p.q_rs, q0, p.N, p.D, tid);
  cp_async_commit();
  prefetch(0);
  cp_async_wait<1>();  // the q tile has landed; tile 0 may still be in flight
  __syncthreads();
  if (p.q_w != nullptr) {
    rms_rows_bf16(Qs, QS, p.q_w, p.D, p.eps, tid);
    __syncthreads();
  }

  uint32_t qf[KD][4];
  {
    const int r0 = warp * 16 + gid;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = ld_u32(Qs + r0 * QS + kk * 16 + tig * 2);
      qf[kk][1] = ld_u32(Qs + (r0 + 8) * QS + kk * 16 + tig * 2);
      qf[kk][2] = ld_u32(Qs + r0 * QS + kk * 16 + tig * 2 + 8);
      qf[kk][3] = ld_u32(Qs + (r0 + 8) * QS + kk * 16 + tig * 2 + 8);
    }
  }

  float oacc[MULTI ? ND : 1][4];
#pragma unroll
  for (int i = 0; i < (MULTI ? ND : 1); ++i) {
    oacc[i][0] = 0.f; oacc[i][1] = 0.f; oacc[i][2] = 0.f; oacc[i][3] = 0.f;
  }
  bf16* obase =
      reinterpret_cast<bf16*>(p.out) + (long long)g * p.o_gs + (long long)h * p.o_hs;
  const int row_a = q0 + warp * 16 + gid, row_b = row_a + 8;
  const float sl2 = p.scale * 1.4426950408889634f;  // logits in base-2 units

  float o[ND][4];
  float m0, m1;  // running max of rows gid, gid + 8
  float l0, l1;  // this thread's share of the running sums

  for (int i = 0; i < total; ++i) {
    const int t = i % nt;
    const int k0 = t * kBK;
    if (t == 0) {  // a new source: fresh softmax state
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        o[dt][0] = 0.f; o[dt][1] = 0.f; o[dt][2] = 0.f; o[dt][3] = 0.f;
      }
      m0 = -INFINITY; m1 = -INFINITY;
      l0 = 0.f; l1 = 0.f;
    }
    // the ring slot of tile i + 1 was released by the barrier that ended
    // iteration i - 1
    if (i + 1 < total) {
      prefetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i is in shared memory for every thread
    bf16* Ks = Kbuf + (i & 1) * TILE;
    const bf16* Vs = Vbuf + (i & 1) * TILE;
    if (p.k_w != nullptr) {
      rms_rows_bf16(Ks, QS, p.k_w, p.D, p.eps, tid);
      __syncthreads();
    }

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = 0.f; s[n][1] = 0.f; s[n][2] = 0.f; s[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        // matrices: (keys of n-tile n, d 0-7), (n, d 8-15), (n + 1, d 0-7), (n + 1, d 8-15)
        uint32_t kb[4];
        ldsm_x4(kb, Ks + ((n + (lm >> 1)) * 8 + lr) * QS + kk * 16 + (lm & 1) * 8);
        mma_16816(s[n], qf[kk], kb[0], kb[1]);
        mma_16816(s[n + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale, mask the keys past the end, row maxima
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int c = k0 + n * 8 + tig * 2;
      const bool ok0 = c < p.M, ok1 = (c + 1) < p.M;
      s[n][0] = ok0 ? s[n][0] * sl2 : -INFINITY;
      s[n][1] = ok1 ? s[n][1] * sl2 : -INFINITY;
      s[n][2] = ok0 ? s[n][2] * sl2 : -INFINITY;
      s[n][3] = ok1 ? s[n][3] * sl2 : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one valid key, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);  // 0 on a source's first tile
    m0 = mn0; m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      o[dt][0] *= a0; o[dt][1] *= a0; o[dt][2] *= a1; o[dt][3] *= a1;
    }

    // o += p.v, the probabilities rounded to bf16 as the A operand
#pragma unroll
    for (int kt = 0; kt < kBK / 16; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      pa[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      pa[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      pa[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int dt = 0; dt < ND; dt += 2) {
        // transposed matrices: (keys 0-7, d-tile dt), (keys 8-15, dt),
        // (keys 0-7, dt + 1), (keys 8-15, dt + 1)
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vs + (kt * 16 + (lm & 1) * 8 + lr) * QS + (dt + (lm >> 1)) * 8);
        mma_16816(o[dt], pa, vb[0], vb[1]);
        mma_16816(o[dt + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with ring slot i & 1

    if (t != nt - 1) continue;
    // end of a source: its softmax sums over the four threads of a row
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.0f / l0, i1 = 1.0f / l1;
    if (MULTI) {
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        oacc[MULTI ? dt : 0][0] += o[dt][0] * i0;
        oacc[MULTI ? dt : 0][1] += o[dt][1] * i0;
        oacc[MULTI ? dt : 0][2] += o[dt][2] * i1;
        oacc[MULTI ? dt : 0][3] += o[dt][3] * i1;
      }
      if (i + 1 < total) continue;
    }
    // last (or only) source: write the block's rows once
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      const int d = dt * 8 + tig * 2;
      const float va0 = MULTI ? oacc[MULTI ? dt : 0][0] : o[dt][0] * i0;
      const float va1 = MULTI ? oacc[MULTI ? dt : 0][1] : o[dt][1] * i0;
      const float vb0 = MULTI ? oacc[MULTI ? dt : 0][2] : o[dt][2] * i1;
      const float vb1 = MULTI ? oacc[MULTI ? dt : 0][3] : o[dt][3] * i1;
      if (row_a < p.N) {
        if (d < p.D) obase[(long long)row_a * p.o_rs + d] = __float2bfloat16(va0);
        if (d + 1 < p.D) obase[(long long)row_a * p.o_rs + d + 1] = __float2bfloat16(va1);
      }
      if (row_b < p.N) {
        if (d < p.D) obase[(long long)row_b * p.o_rs + d] = __float2bfloat16(vb0);
        if (d + 1 < p.D) obase[(long long)row_b * p.o_rs + d + 1] = __float2bfloat16(vb1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 body (CUDA cores)
// ---------------------------------------------------------------------------

constexpr int kFQ = 32;        // q rows per block
constexpr int kFThreads = 256;

__device__ __forceinline__ void load_rows_f32(float* dst, int ss, const float* src,
                                              long long rs, int row0, int rows,
                                              int limit, int D, int tid) {
  for (int idx = tid; idx < rows * D; idx += kFThreads) {
    int r = idx / D, d = idx - r * D;
    int row = row0 + r;
    dst[r * ss + d] = (row < limit) ? src[(long long)row * rs + d] : 0.0f;
  }
}

__device__ __forceinline__ void rms_rows_f32(float* tile, int ss, int rows,
                                             const float* w, int D, float eps,
                                             int tid) {
  // one warp per row, rows strided over the block's warps
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += kFThreads / 32) {
    float* row = tile + r * ss;
    float sq = 0.0f;
    for (int d = lane; d < D; d += 32) sq += row[d] * row[d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    float rinv = 1.0f / sqrtf(sq / (float)D + eps);
    for (int d = lane; d < D; d += 32) row[d] = w[d] * (row[d] * rinv);
  }
}

inline size_t attn_f32_smem_bytes(int D) {
  const int DS = D | 1;  // odd row stride: no bank conflicts down a column
  return sizeof(float) * ((size_t)kFQ * DS * 3 + (size_t)kBK * DS * 2 +
                          (size_t)kFQ * (kBK + 1) + 3 * kFQ);
}

__global__ void __launch_bounds__(kFThreads) attn_fwd_f32(AttnParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  const int DS = D | 1;
  constexpr int SS = kBK + 1;
  float* Qs = reinterpret_cast<float*>(smem_raw);  // kFQ x DS
  float* Os = Qs + kFQ * DS;                       // kFQ x DS, this source
  float* Oa = Os + kFQ * DS;                       // kFQ x DS, summed over sources
  float* Ks = Oa + kFQ * DS;                       // kBK x DS
  float* Vs = Ks + kBK * DS;                       // kBK x DS
  float* Ss = Vs + kBK * DS;                       // kFQ x SS
  float* mrow = Ss + kFQ * SS;
  float* lrow = mrow + kFQ;
  float* arow = lrow + kFQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nq = (p.N + kFQ - 1) / kFQ;
  const int bid = blockIdx.x;
  const int qt = bid % nq;
  const int h = (bid / nq) % p.H;
  const int g = bid / (nq * p.H);
  const int q0 = qt * kFQ;

  const float* qbase =
      reinterpret_cast<const float*>(p.q) + (long long)g * p.q_gs + (long long)h * p.q_hs;
  load_rows_f32(Qs, DS, qbase, p.q_rs, q0, kFQ, p.N, D, tid);
  for (int idx = tid; idx < kFQ * DS; idx += kFThreads) Oa[idx] = 0.0f;
  __syncthreads();
  if (p.q_w != nullptr) {
    rms_rows_f32(Qs, DS, kFQ, p.q_w, D, p.eps, tid);
    __syncthreads();
  }

  for (int j = 0; j < p.J; ++j) {
    const int gk = (p.perm != nullptr) ? p.perm[j * p.G + g] : g;
    const float* kbase =
        reinterpret_cast<const float*>(p.k) + (long long)gk * p.k_gs + (long long)h * p.k_hs;
    const float* vbase =
        reinterpret_cast<const float*>(p.v) + (long long)gk * p.v_gs + (long long)h * p.v_hs;
    __syncthreads();
    for (int idx = tid; idx < kFQ * DS; idx += kFThreads) Os[idx] = 0.0f;
    if (tid < kFQ) {
      mrow[tid] = -INFINITY;
      lrow[tid] = 0.0f;
    }

    for (int k0 = 0; k0 < p.M; k0 += kBK) {
      __syncthreads();
      load_rows_f32(Ks, DS, kbase, p.k_rs, k0, kBK, p.M, D, tid);
      load_rows_f32(Vs, DS, vbase, p.v_rs, k0, kBK, p.M, D, tid);
      __syncthreads();
      if (p.k_w != nullptr) {
        rms_rows_f32(Ks, DS, kBK, p.k_w, D, p.eps, tid);
        __syncthreads();
      }
      // logits
      for (int idx = tid; idx < kFQ * kBK; idx += kFThreads) {
        const int r = idx / kBK, c = idx - r * kBK;
        const float* qr = Qs + r * DS;
        const float* kr = Ks + c * DS;
        float acc = 0.0f;
        for (int d = 0; d < D; ++d) acc += qr[d] * kr[d];
        Ss[r * SS + c] = (k0 + c < p.M) ? acc * p.scale : -INFINITY;
      }
      __syncthreads();
      // online softmax, one warp per row
      for (int r = warp; r < kFQ; r += kFThreads / 32) {
        float s0 = Ss[r * SS + lane], s1 = Ss[r * SS + lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mprev = mrow[r];
        const float mnew = fmaxf(mprev, mx);
        const float p0 = expf(s0 - mnew), p1 = expf(s1 - mnew);
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        Ss[r * SS + lane] = p0;
        Ss[r * SS + lane + 32] = p1;
        if (lane == 0) {
          const float alpha = expf(mprev - mnew);  // 0 on the first tile
          arow[r] = alpha;
          mrow[r] = mnew;
          lrow[r] = lrow[r] * alpha + sum;
        }
      }
      __syncthreads();
      // o = o * alpha + p.v
      for (int idx = tid; idx < kFQ * D; idx += kFThreads) {
        const int r = idx / D, d = idx - r * D;
        const float* pr = Ss + r * SS;
        float acc = Os[r * DS + d] * arow[r];
        for (int c = 0; c < kBK; ++c) acc += pr[c] * Vs[c * DS + d];
        Os[r * DS + d] = acc;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kFQ * D; idx += kFThreads) {
      const int r = idx / D, d = idx - r * D;
      Oa[r * DS + d] += Os[r * DS + d] / lrow[r];
    }
  }
  __syncthreads();
  float* obase =
      reinterpret_cast<float*>(p.out) + (long long)g * p.o_gs + (long long)h * p.o_hs;
  for (int idx = tid; idx < kFQ * D; idx += kFThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = q0 + r;
    if (row < p.N) obase[(long long)row * p.o_rs + d] = Oa[r * DS + d];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DP, bool MULTI>
inline int launch_bf16_as(const AttnParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 5 * 64 * (size_t)(DP + 8);  // q + two k + two v tiles
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bf16<DP, MULTI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((p.N + kBQ - 1) / kBQ) * p.H * p.G;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  attn_fwd_bf16<DP, MULTI><<<(unsigned)blocks, 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP>
inline int launch_bf16(const AttnParams& p, cudaStream_t stream) {
  return (p.J > 1) ? launch_bf16_as<DP, true>(p, stream)
                   : launch_bf16_as<DP, false>(p, stream);
}

// dtype: 0 = bf16, 1 = fp32. Returns a cudaError_t as int (0 = launched). The
// bf16 body takes head dims that are multiples of 8 and 16-byte aligned q/k/v
// rows; its shared-memory tiles are padded to 16 (the tiny configurations), 80
// (head_dim 72) or 144 columns (the condition embedders' 1152 / 8).
inline int launch_attention(const AttnParams& p, int dtype, cudaStream_t stream) {
  if (p.G <= 0 || p.H <= 0 || p.N <= 0 || p.M <= 0 || p.D <= 0 || p.J <= 0 || p.D > kMaxD)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const bool aligned =
        (p.D % 8 == 0) &&
        (((uintptr_t)p.q | (uintptr_t)p.k | (uintptr_t)p.v) % 16 == 0) &&
        ((p.q_gs | p.q_rs | p.q_hs | p.k_gs | p.k_rs | p.k_hs | p.v_gs | p.v_rs | p.v_hs) % 8 == 0);
    if (!aligned) return (int)cudaErrorInvalidValue;
    if (p.D <= 16) return launch_bf16<16>(p, stream);
    if (p.D <= 80) return launch_bf16<80>(p, stream);
    return launch_bf16<144>(p, stream);
  }
  if (dtype == 1) {
    const size_t smem = attn_f32_smem_bytes(p.D);
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)((p.N + kFQ - 1) / kFQ) * p.H * p.G;
    if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    attn_fwd_f32<<<(unsigned)blocks, kFThreads, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace mdv2
