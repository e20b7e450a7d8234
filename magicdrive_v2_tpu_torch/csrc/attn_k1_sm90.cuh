// The bf16 body of fused_qkv_attention (sm_90a), in two kernels.
//
// k1_tile_k, the pre-pass: reads the k rows of the packed (G, N, 3, H, D) qkv
// once, applies the per-head RMSNorm (cast points of the reference: fp32
// normalise over the true D, round to bf16, multiply by the fp32 weight, round
// back) and writes them into a scratch buffer of 64-row tiles,
// (G, H, T, DP / 8, 64, 8): inside a tile, chunk c (head-dim columns
// 8c..8c+7) of all 64 rows comes first, then chunk c + 1. Rows past N and
// columns past D are zero. So every k tile is one contiguous block that a
// linear cp.async copy lands in shared memory in the layout the products read
// (each 8-row x 8-column "core matrix" 128 contiguous bytes), and the norm of a
// k row is computed once, not once for every q tile that reads it.
//
// k1_attention: one block of 256 threads (two warpgroups) computes 128 q rows
// of one (group, head). q is copied from qkv into the same tile layout and
// normalised in shared memory once per block; k tiles come from the scratch,
// v tiles from qkv, 64 rows each, through a cp.async ring, each feeding all
// 128 rows. Inside the block a loop runs over the J k/v sources (group
// perm[j][g]) and, inside that, over the k tiles with an online softmax. Both
// products are wgmma (m64, fp32 accumulate): the logits q k^T with q and k
// read from shared memory through descriptors; the value product p v with the
// probabilities, rounded to bf16 unnormalised, as the A operand in registers
// and v read from shared memory as it lies (keys x head dim, MN-major).
// Running max and sum per row stay in registers. After a source the
// accumulator is divided by its softmax sum and, for J > 1, added into an
// fp32 sum over the sources; the output is rounded once at the end.
#pragma once

#include <math.h>

#include "sm90_common.cuh"

namespace mdv2 {
namespace k1 {

using mdv2::bf16;
using mdv2::kRows;
constexpr int kThreads = 256;

// Depth of the k/v ring and shared memory of k1_attention<DP, DV, MULTI>: two
// q tiles, the k and v rings and, with more than one source, the fp32 sum over
// the sources (DV / 2 values per thread; in registers it would cost 36 of
// them and halve the blocks an SM holds). The wrapper's launch plan
// (ops/flash_fused.py) computes the same numbers.
__host__ __device__ constexpr int ring_stages(bool multi) { return multi ? 2 : 3; }
__host__ __device__ constexpr size_t smem_bytes(int dp, int dv, bool multi) {
  return sizeof(bf16) * (size_t)(2 + 2 * ring_stages(multi)) * kRows * dp +
         (multi ? sizeof(float) * (size_t)(dv / 2) * kThreads : 0);
}

struct Params {
  const bf16* qkv;    // (G, N, 3, H, D)
  const bf16* tiles;  // the pre-pass's normalised k tiles (G, H, T, DP / 8, 64, 8)
  bf16* out;          // (G, N, H * D)
  const int* perm;    // (J, G) source group of k/v, or nullptr for identity
  const float* q_w;   // (D,) fp32 RMSNorm weight of q, or nullptr for no norm
  int G, H, N, D, J;
  int T;              // 64-row tiles per (group, head) in the scratch: 2 * q tiles
  int q_tiles;        // 128-row q tiles per (group, head)
  float scale;
  float eps;
};

// ---------------------------------------------------------------------------
// pre-pass
// ---------------------------------------------------------------------------

// RMSNorm of 8 bf16 values in place, given the row's 1 / rms: round x / rms
// to bf16, multiply by the fp32 weight, round back.
__device__ __forceinline__ void rms_chunk(uint4& x, const float* w, float rinv) {
  __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(x2[e]);
    const float2 xn = __bfloat1622float2(__floats2bfloat162_rn(f.x * rinv, f.y * rinv));
    x2[e] = __floats2bfloat162_rn(w[2 * e] * xn.x, w[2 * e + 1] * xn.y);
  }
}
__device__ __forceinline__ float sum_sq(const uint4& x) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
  float sq = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(x2[e]);
    sq += f.x * f.x + f.y * f.y;
  }
  return sq;
}

// Block: one 64-row k tile of one (group, head); thread r: row r of it.
template <int DP>
__global__ void __launch_bounds__(kRows) k1_tile_k(const bf16* __restrict__ qkv,
                                                   bf16* __restrict__ tiles,
                                                   const float* __restrict__ k_w, int G,
                                                   int N, int H, int D, int T, float eps) {
  constexpr int CPR = DP / 8;  // 16-byte chunks of a tile row
  const int r = threadIdx.x;
  const int t = blockIdx.x % T;
  const int h = (blockIdx.x / T) % H;
  const int g = blockIdx.x / (T * H);
  const int n = t * kRows + r;

  uint4 x[CPR];
  const bf16* src = qkv + (((long long)g * N + n) * 3 + 1) * H * D + (long long)h * D;
#pragma unroll
  for (int c = 0; c < CPR; ++c)
    x[c] = (n < N && c * 8 < D) ? __ldg(reinterpret_cast<const uint4*>(src + c * 8))
                                : make_uint4(0u, 0u, 0u, 0u);
  if (k_w != nullptr) {
    float sq = 0.0f;
#pragma unroll
    for (int c = 0; c < CPR; ++c) sq += sum_sq(x[c]);
    const float rinv = 1.0f / sqrtf(sq / (float)D + eps);
#pragma unroll
    for (int c = 0; c < CPR; ++c)
      if (c * 8 < D) rms_chunk(x[c], k_w + c * 8, rinv);  // padding columns stay zero
  }
  bf16* dst = tiles + (((long long)g * H + h) * T + t) * (kRows * DP) + r * 8;
#pragma unroll
  for (int c = 0; c < CPR; ++c) *reinterpret_cast<uint4*>(dst + c * kRows * 8) = x[c];
}

// ---------------------------------------------------------------------------
// attention
// ---------------------------------------------------------------------------

// Copy one tile (contiguous in the scratch) into shared memory.
template <int DP>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int tid) {
  constexpr int CHUNKS = kRows * DP / 8;
#pragma unroll
  for (int idx = tid; idx < CHUNKS; idx += kThreads) cp_async_16(dst + idx * 8, src + idx * 8);
}

// DP: padded head dim of the tiles (the depth of the logit product, a multiple
// of 16); DV: width of the value product (the head dim rounded up to 8).
// Warpgroup wg (threads 128wg..128wg+127) owns q rows 64wg..64wg+63 of the
// block; inside it, warp w holds rows 16w..16w+15 in the wgmma accumulator
// layout: for every 8-column group n, d[4n..4n+3] are (row gid, columns 8n +
// 2tig, +1) and (row gid + 8, the same columns), gid = lane / 4, tig = lane % 4.
template <int DP, int DV, bool MULTI>
__global__ void __launch_bounds__(kThreads, 2) k1_attention(Params p) {
  constexpr int TILE = kRows * DP;  // elements of one tile
  constexpr int KD = DP / 16;       // k-steps of the logit product
  constexpr int NS = kRows / 2;     // logit registers per thread (m64n64)
  constexpr int NO = DV / 2;        // output registers per thread (m64nDV)
  constexpr int STAGES = ring_stages(MULTI);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // two tiles: 128 q rows
  bf16* Ks = Qs + 2 * TILE;                      // STAGES k tiles
  bf16* Vs = Ks + STAGES * TILE;                 // STAGES v tiles
  float* Osum = reinterpret_cast<float*>(Vs + STAGES * TILE);  // MULTI: [NO][kThreads]

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bid = blockIdx.x;
  const int qt = bid % p.q_tiles;
  const int h = (bid / p.q_tiles) % p.H;
  const int g = bid / (p.q_tiles * p.H);
  const int nt = (p.N + kRows - 1) / kRows;  // k tiles of one source
  const int total = p.J * nt;
  const long long rs = 3LL * p.H * p.D;  // row stride of qkv
  const bf16* kt_base = p.tiles + (long long)h * p.T * TILE;

  // start the copy of tile i of the flattened (source, k tile) sequence
  auto prefetch = [&](int i) {
    const int j = i / nt, t = i - j * nt;
    const int gk = (p.perm != nullptr) ? p.perm[j * p.G + g] : g;
    copy_tile<DP>(Ks + (i % STAGES) * TILE, kt_base + ((long long)gk * p.H * p.T + t) * TILE,
                  tid);
    const int r0 = t * kRows;
    copy_rows<DP>(Vs + (i % STAGES) * TILE,
                  p.qkv + ((long long)gk * p.N + r0) * rs + 2LL * p.H * p.D + (long long)h * p.D,
                  rs, p.N - r0, p.D, tid);
  };

  // group 0: the q rows and tile 0; group s < STAGES - 1: tile s (or nothing)
  const int q0 = qt * 2 * kRows;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r0 = q0 + half * kRows;
    copy_rows<DP>(Qs + half * TILE, p.qkv + ((long long)g * p.N + r0) * rs + (long long)h * p.D,
                  rs, p.N - r0, p.D, tid);
  }
  prefetch(0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < STAGES - 1; ++st) {
    if (st < total) prefetch(st);
    cp_async_commit();
  }

  // RMSNorm of the 128 q rows, two threads a row, each on every other chunk
  cp_async_wait<STAGES - 2>();  // the q rows (and tile 0) have landed
  __syncthreads();
  if (p.q_w != nullptr) {
    const int row = tid >> 1;
    bf16* q = Qs + (row / kRows) * TILE + (row % kRows) * 8;
    float sq = 0.0f;
    for (int c = tid & 1; c * 8 < p.D; c += 2)
      sq += sum_sq(*reinterpret_cast<const uint4*>(q + c * kRows * 8));
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    const float rinv = 1.0f / sqrtf(sq / (float)p.D + p.eps);
    for (int c = tid & 1; c * 8 < p.D; c += 2)
      rms_chunk(*reinterpret_cast<uint4*>(q + c * kRows * 8), p.q_w + c * 8, rinv);
  }  // the loop's first barrier publishes the normalised rows

  // q of this warpgroup, A operand (K-major): k-step kk starts two chunks on
  const uint64_t q_desc = tile_desc(Qs + wg * TILE, kChunkBytes, kBlock8Bytes);

  const float sl2 = p.scale * 1.4426950408889634f;  // logits in base-2 units

  float o[NO];
  float m0, m1;  // running max of rows gid, gid + 8
  float l0, l1;  // this thread's share of the running sums

  for (int i = 0; i < total; ++i) {
    const int t = i % nt;
    if (t == 0) {  // a new source: fresh softmax state
#pragma unroll
      for (int e = 0; e < NO; ++e) o[e] = 0.f;
      m0 = -INFINITY; m1 = -INFINITY;
      l0 = 0.f; l1 = 0.f;
    }
    cp_async_wait<STAGES - 2>();  // tile i (and the q rows) have landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread, and every warp is done with tile i - 1
    if (i + STAGES - 1 < total) prefetch(i + STAGES - 1);  // into the slot of tile i - 1
    cp_async_commit();
    const bf16* K = Ks + (i % STAGES) * TILE;
    const bf16* V = Vs + (i % STAGES) * TILE;

    // s = q k^T: B is the k tile, K-major (keys along N)
    float s[NS];
    const uint64_t k_desc = tile_desc(K, kChunkBytes, kBlock8Bytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_ss(s, q_desc + kk * (2 * kChunkBytes >> 4), k_desc + kk * (2 * kChunkBytes >> 4),
               kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // mask the keys past the end (last tile of a source only); row maxima of the
    // raw logits (the scale is positive, so they are the maxima of the scaled ones)
    if ((t == nt - 1) && (p.N % kRows != 0)) {
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n) {
        const int c = t * kRows + n * 8 + tig * 2;
        if (c >= p.N) { s[4 * n + 0] = -INFINITY; s[4 * n + 2] = -INFINITY; }
        if (c + 1 >= p.N) { s[4 * n + 1] = -INFINITY; s[4 * n + 3] = -INFINITY; }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n + 0], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one valid key, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);  // 0 on a source's first tile
    m0 = mn0; m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n) {  // p = 2^(s * scale * log2(e) - max)
      s[4 * n + 0] = ex2(fmaf(s[4 * n + 0], sl2, -mn0));
      s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], sl2, -mn0));
      s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], sl2, -mn1));
      s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], sl2, -mn1));
      rs0 += s[4 * n + 0] + s[4 * n + 1];
      rs1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      o[4 * n + 0] *= a0; o[4 * n + 1] *= a0; o[4 * n + 2] *= a1; o[4 * n + 3] *= a1;
    }

    // o += p v: the probabilities, rounded to bf16, are the A operand in
    // registers (the accumulator layout of 16 keys is the A fragment layout);
    // B is the v tile, MN-major (head dim along N, keys along K)
    uint32_t pa[kRows / 16][4];
#pragma unroll
    for (int kt = 0; kt < kRows / 16; ++kt) {
      pa[kt][0] = pack_bf16(s[8 * kt + 0], s[8 * kt + 1]);
      pa[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      pa[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      pa[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }
    const uint64_t v_desc = tile_desc(V, kBlock8Bytes, kChunkBytes);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < kRows / 16; ++kt)
      wgmma_rs(o, pa[kt], v_desc + kt * (2 * kBlock8Bytes >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    if (t != nt - 1) continue;
    // end of a source: its softmax sums over the four threads of a row
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.0f / l0, i1 = 1.0f / l1;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      o[4 * n + 0] *= i0; o[4 * n + 1] *= i0; o[4 * n + 2] *= i1; o[4 * n + 3] *= i1;
    }
    if (MULTI) {  // the sum over the sources, in this thread's own column of Osum
      const bool first = i + 1 == nt;
#pragma unroll
      for (int e = 0; e < NO; ++e) {
        if (!first) o[e] += Osum[e * kThreads + tid];
        if (i + 1 < total) Osum[e * kThreads + tid] = o[e];
      }
      if (i + 1 < total) continue;
    }
    // last (or only) source: write this warp's rows once
    const int row_a = qt * 2 * kRows + wg * kRows + warp * 16 + gid, row_b = row_a + 8;
    bf16* obase = p.out + (long long)g * p.N * p.H * p.D + (long long)h * p.D;
    const long long rs = (long long)p.H * p.D;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      const int d = n * 8 + tig * 2;  // D is a multiple of 8: d and d + 1 are both in or out
      if (d >= p.D) continue;
      if (row_a < p.N)
        *reinterpret_cast<__nv_bfloat162*>(obase + row_a * rs + d) =
            __floats2bfloat162_rn(o[4 * n + 0], o[4 * n + 1]);
      if (row_b < p.N)
        *reinterpret_cast<__nv_bfloat162*>(obase + row_b * rs + d) =
            __floats2bfloat162_rn(o[4 * n + 2], o[4 * n + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch (the plan - padded width, tiles, grid, shared memory - comes from the
// wrapper; this checks it against the instantiations)
// ---------------------------------------------------------------------------

template <int DP>
inline int launch_tile_k(const bf16* qkv, bf16* tiles, const float* k_w, int G, int N, int H,
                         int D, int T, float eps, cudaStream_t stream) {
  const long long blocks = (long long)G * H * T;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  k1_tile_k<DP><<<(unsigned)blocks, kRows, 0, stream>>>(qkv, tiles, k_w, G, N, H, D, T, eps);
  return (int)cudaGetLastError();
}

template <int DP, int DV, bool MULTI>
inline int launch_attend_as(const Params& p, int blocks, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(k1_attention<DP, DV, MULTI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k1_attention<DP, DV, MULTI><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, int DV>
inline int launch_attend(const Params& p, int blocks, int smem, cudaStream_t stream) {
  if ((size_t)smem != smem_bytes(DP, DV, p.J > 1) || p.D > DV) return (int)cudaErrorInvalidValue;
  return (p.J > 1) ? launch_attend_as<DP, DV, true>(p, blocks, smem, stream)
                   : launch_attend_as<DP, DV, false>(p, blocks, smem, stream);
}

}  // namespace k1
}  // namespace mdv2
