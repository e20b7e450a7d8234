// The bf16 body of flash_attention (sm_90a): q (B, N, H, D) against k, v
// (B, M, H, D), read in place through their strides.
//
// A block of 256 threads (two warpgroups) computes 128-row q tiles of one
// (batch, head); warpgroup wg owns rows 64wg..64wg+63 of each. Both products
// are wgmma (m64, fp32 accumulate): the logits q k^T with q and k read from
// shared memory through descriptors (both K-major), the value product p v with
// the probabilities, rounded to bf16 unnormalised, as the A operand in
// registers and v read from shared memory as it lies (keys x head dim,
// MN-major). Running max and sum per row stay in registers; the output is
// divided by the sum and rounded once, then goes out through the warpgroup's
// q buffer, which the last logit product has read: rows staged in shared
// memory, then copied out 16 bytes a thread, a row by neighbouring threads
// (written straight from the accumulator layout, every store would cover
// 4-byte pieces of eight rows).
//
// Two kernels, chosen by the wrapper's launch plan (ops/flash_attention.py):
//   k3_resident  while the whole k/v sequence fits in shared memory (M <= 320
//                at head dim 72): the block copies it once and walks over a run
//                of consecutive q tiles of its (batch, head). After the k/v
//                copy the two warpgroups share no barrier: each walks over its
//                own halves of the q tiles, copying the next half in once the
//                output of the last one is out.
//   k3_stream    longer k/v: one q tile per block, k/v tiles through a
//                three-stage cp.async ring shared by both warpgroups.
//
// Tiles use the no-swizzle layout of sm90_common.cuh. q and k keep D columns
// (D / 8 chunks). Where D / 8 is odd (D = 72, 8), the logit product's last
// 16-deep step pairs chunk D / 8 - 1 with a chunk of zeros at the end of shared
// memory, reached through the descriptor's LBO, so no tile carries a padding
// chunk. v keeps DV columns, zero past D.
#pragma once

#include <math.h>

#include "sm90_common.cuh"

namespace mdv2 {
namespace k3 {

constexpr int kThreads = 256;
constexpr int kStages = 3;  // depth of k3_stream's k/v ring

// Blocks per SM the kernel is compiled for (its __launch_bounds__): two up to
// DV = 72, one for the 144-wide body, whose accumulator takes 72 registers.
__host__ __device__ constexpr int min_blocks(int dv) { return dv <= 72 ? 2 : 1; }

// Dynamic shared memory: two q halves, the k and v tiles (all kv_tiles of them
// resident, else the ring), the zero chunk where D / 8 is odd. The launch plan
// computes the same number.
__host__ __device__ constexpr size_t smem_bytes(int d, int dv, bool resident, int kv_tiles) {
  return sizeof(bf16) * kRows *
             (2 * (size_t)d + (size_t)(resident ? kv_tiles : kStages) * (d + dv)) +
         ((d / 8) % 2 ? kChunkBytes : 0);
}

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;  // (B, N, H, D)
  // element strides: batch, row, head (the head-dim stride is 1)
  long long q_bs, q_rs, q_hs;
  long long k_bs, k_rs, k_hs;
  long long v_bs, v_rs, v_hs;
  int B, H, N, M, D;
  int q_tiles;  // 128-row q tiles per (batch, head)
  int run;      // q tiles per block (k3_resident; 1 for k3_stream)
  float scale;
};

__device__ __forceinline__ void bar_sync_warpgroup(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// s = q k^T for one 64-row q half and one 64-key tile, both in shared memory.
template <int D>
__device__ __forceinline__ void logits(float (&s)[32], const bf16* Q, const bf16* K,
                                       const bf16* Z) {
  constexpr int C = D / 8;  // chunks
  const uint64_t qd = tile_desc(Q, kChunkBytes, kBlock8Bytes);
  const uint64_t kd = tile_desc(K, kChunkBytes, kBlock8Bytes);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C / 2; ++kk)
    wgmma_ss(s, qd + kk * (2 * kChunkBytes >> 4), kd + kk * (2 * kChunkBytes >> 4), kk);
  if (C % 2) {  // last step: chunk C - 1 and the zero chunk
    const bf16* ql = Q + (C - 1) * kRows * 8;
    const bf16* kl = K + (C - 1) * kRows * 8;
    wgmma_ss(s, tile_desc(ql, smem_u32(Z) - smem_u32(ql), kBlock8Bytes),
             tile_desc(kl, smem_u32(Z) - smem_u32(kl), kBlock8Bytes), C / 2);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// Online-softmax step over one 64-key tile (keys key0.., M in all) and o += p v.
// Accumulator layout of warp w of the warpgroup: for every 8-column group n,
// d[4n..4n+3] are (row gid, columns 8n + 2tig, +1) and (row gid + 8, the same
// columns), gid = lane / 4, tig = lane % 4.
template <int DV>
__device__ __forceinline__ void softmax_pv(float (&s)[32], float (&o)[DV / 2], float& m0,
                                           float& m1, float& l0, float& l1, const bf16* V,
                                           int key0, int M, float sl2, int tig) {
  // keys past the end masked; with a positive scale the maxima of the raw logits
  // are those of the scaled ones, and the scale goes into the exponent's FFMA
  const bool pos = sl2 > 0.f;
  if (!pos) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= sl2;
  }
  if (key0 + kRows > M) {
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n) {
      const int c = key0 + n * 8 + tig * 2;
      if (c >= M) { s[4 * n + 0] = -INFINITY; s[4 * n + 2] = -INFINITY; }
      if (c + 1 >= M) { s[4 * n + 1] = -INFINITY; s[4 * n + 3] = -INFINITY; }
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
  const float f = pos ? sl2 : 1.f;
  const float mn0 = fmaxf(m0, mx0 * f), mn1 = fmaxf(m1, mx1 * f);
  const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);  // 0 on the first tile
  m0 = mn0; m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < kRows / 8; ++n) {
    s[4 * n + 0] = ex2(fmaf(s[4 * n + 0], f, -mn0));
    s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], f, -mn0));
    s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], f, -mn1));
    s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], f, -mn1));
    rs0 += s[4 * n + 0] + s[4 * n + 1];
    rs1 += s[4 * n + 2] + s[4 * n + 3];
  }
  l0 = l0 * a0 + rs0;
  l1 = l1 * a1 + rs1;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    o[4 * n + 0] *= a0; o[4 * n + 1] *= a0; o[4 * n + 2] *= a1; o[4 * n + 3] *= a1;
  }

  // the accumulator layout of 16 keys is the A fragment layout
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
}

// Divide a warp's 16 rows by their softmax sums, round them to bf16 and put
// them into a row-major (64, D) tile in shared memory (conflict-free: a row is
// D / 2 banks on from the one above it, D / 2 = 4 mod 32 at D = 72).
template <int DV>
__device__ __forceinline__ void stage_rows(const float (&o)[DV / 2], float l0, float l1,
                                           bf16* tile, int r_a, int D, int tig) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.0f / l0, i1 = 1.0f / l1;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int d = n * 8 + tig * 2;
    if (d >= D) continue;
    *reinterpret_cast<__nv_bfloat162*>(tile + r_a * D + d) =
        __floats2bfloat162_rn(o[4 * n + 0] * i0, o[4 * n + 1] * i0);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r_a + 8) * D + d) =
        __floats2bfloat162_rn(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
  }
}

// Copy the staged (64, D) tile out to rows row0.. of the output (those below
// N), 16 bytes a thread: consecutive threads on consecutive chunks of a row.
template <int D>
__device__ __forceinline__ void store_rows(const bf16* tile, bf16* obase, long long ors, int row0,
                                           int N, int wtid) {
  constexpr int C = D / 8;
#pragma unroll
  for (int i = wtid; i < kRows * C; i += 128) {
    const int r = i / C, c = i - r * C;
    if (row0 + r < N)
      *reinterpret_cast<uint4*>(obase + (row0 + r) * ors + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * D + c * 8);
  }
}

template <int DV>
__device__ __forceinline__ void reset(float (&o)[DV / 2], float& m0, float& m1, float& l0,
                                      float& l1) {
#pragma unroll
  for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
  m0 = -INFINITY; m1 = -INFINITY;
  l0 = 0.f; l1 = 0.f;
}

// D: the head dim, also the width of the q and k tiles; DV: the width of the v
// tiles and of the value product (D rounded up to a wgmma width).
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, min_blocks(DV)) k3_resident(Params p) {
  constexpr int QT = kRows * D;   // elements of a q or k tile
  constexpr int VT = kRows * DV;  // elements of a v tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nt = (p.M + kRows - 1) / kRows;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // two q halves
  bf16* Ks = Qs + 2 * QT;                        // nt k tiles
  bf16* Vs = Ks + nt * QT;                       // nt v tiles
  bf16* Z = Vs + nt * VT;                        // the zero chunk (D / 8 odd)

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int runs = (p.q_tiles + p.run - 1) / p.run;
  const int r = blockIdx.x % runs;
  const int h = (blockIdx.x / runs) % p.H;
  const int b = blockIdx.x / (runs * p.H);
  const int qt0 = r * p.run;
  // this warpgroup's q tiles: those of the run whose half holds a row below N
  const int qt1 =
      min(min(qt0 + p.run, p.q_tiles), (p.N - wg * kRows + 2 * kRows - 1) / (2 * kRows));

  const bf16* kbase = p.k + (long long)b * p.k_bs + (long long)h * p.k_hs;
  const bf16* vbase = p.v + (long long)b * p.v_bs + (long long)h * p.v_hs;
  const bf16* qbase = p.q + (long long)b * p.q_bs + (long long)h * p.q_hs;
  bf16* obase = p.out + (long long)b * p.N * p.H * p.D + (long long)h * p.D;
  const long long ors = (long long)p.H * p.D;
  bf16* Qh = Qs + wg * QT;

  for (int t = 0; t < nt; ++t) {
    const long long row = (long long)t * kRows;
    copy_rows<D>(Ks + t * QT, kbase + row * p.k_rs, p.k_rs, p.M - t * kRows, p.D, tid);
    copy_rows<DV>(Vs + t * VT, vbase + row * p.v_rs, p.v_rs, p.M - t * kRows, p.D, tid);
  }
  int row0 = qt0 * 2 * kRows + wg * kRows;  // first row of this warpgroup's half
  copy_rows<D, 128>(Qh, qbase + (long long)row0 * p.q_rs, p.q_rs, p.N - row0, p.D, wtid);
  cp_async_commit();
  if ((D / 8) % 2)
    for (int i = tid; i < kRows; i += kThreads)
      reinterpret_cast<uint4*>(Z)[i] = make_uint4(0u, 0u, 0u, 0u);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // k, v, the zero chunk and both q halves are in shared memory

  const float sl2 = p.scale * 1.4426950408889634f;
  float o[DV / 2];
  float m0, m1, l0, l1;  // running max of rows gid, gid + 8; this thread's share of the sums
  for (int qt = qt0; qt < qt1; ++qt, row0 += 2 * kRows) {
    reset<DV>(o, m0, m1, l0, l1);
    for (int t = 0; t < nt; ++t) {
      float s[32];
      logits<D>(s, Qh, Ks + t * QT, Z);
      softmax_pv<DV>(s, o, m0, m1, l0, l1, Vs + t * VT, t * kRows, p.M, sl2, tig);
    }
    // the output goes out through the q half, which the last logits have read
    bar_sync_warpgroup(wg);
    stage_rows<DV>(o, l0, l1, Qh, warp * 16 + gid, p.D, tig);
    bar_sync_warpgroup(wg);
    store_rows<D>(Qh, obase, ors, row0, p.N, wtid);
    if (qt + 1 < qt1) {  // then the next q half comes in
      bar_sync_warpgroup(wg);
      const int next = row0 + 2 * kRows;
      copy_rows<D, 128>(Qh, qbase + (long long)next * p.q_rs, p.q_rs, p.N - next, p.D, wtid);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      bar_sync_warpgroup(wg);
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, min_blocks(DV)) k3_stream(Params p) {
  constexpr int QT = kRows * D;
  constexpr int VT = kRows * DV;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // two q halves
  bf16* Ks = Qs + 2 * QT;                        // kStages k tiles
  bf16* Vs = Ks + kStages * QT;                  // kStages v tiles
  bf16* Z = Vs + kStages * VT;                   // the zero chunk (D / 8 odd)

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt = blockIdx.x % p.q_tiles;
  const int h = (blockIdx.x / p.q_tiles) % p.H;
  const int b = blockIdx.x / (p.q_tiles * p.H);
  const int nt = (p.M + kRows - 1) / kRows;
  const int row0 = qt * 2 * kRows + wg * kRows;

  const bf16* kbase = p.k + (long long)b * p.k_bs + (long long)h * p.k_hs;
  const bf16* vbase = p.v + (long long)b * p.v_bs + (long long)h * p.v_hs;
  const bf16* qbase = p.q + (long long)b * p.q_bs + (long long)h * p.q_hs;
  bf16* Qh = Qs + wg * QT;

  auto prefetch = [&](int t) {  // k/v tile t into ring slot t % kStages
    const long long row = (long long)t * kRows;
    copy_rows<D>(Ks + (t % kStages) * QT, kbase + row * p.k_rs, p.k_rs, p.M - t * kRows, p.D,
                 tid);
    copy_rows<DV>(Vs + (t % kStages) * VT, vbase + row * p.v_rs, p.v_rs, p.M - t * kRows, p.D,
                  tid);
  };
  // group 0: the q halves and tile 0; group s < kStages - 1: tile s (or nothing)
  copy_rows<D, 128>(Qh, qbase + (long long)row0 * p.q_rs, p.q_rs, p.N - row0, p.D, wtid);
  prefetch(0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < kStages - 1; ++st) {
    if (st < nt) prefetch(st);
    cp_async_commit();
  }
  if ((D / 8) % 2)
    for (int i = tid; i < kRows; i += kThreads)
      reinterpret_cast<uint4*>(Z)[i] = make_uint4(0u, 0u, 0u, 0u);

  const float sl2 = p.scale * 1.4426950408889634f;
  float o[DV / 2];
  float m0, m1, l0, l1;
  reset<DV>(o, m0, m1, l0, l1);
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and the q halves) have landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread, and every warp is done with tile t - 1
    if (t + kStages - 1 < nt) prefetch(t + kStages - 1);  // into the slot of tile t - 1
    cp_async_commit();
    float s[32];
    logits<D>(s, Qh, Ks + (t % kStages) * QT, Z);
    softmax_pv<DV>(s, o, m0, m1, l0, l1, Vs + (t % kStages) * VT, t * kRows, p.M, sl2, tig);
  }
  // the output goes out through the q half, which the last logits have read
  bar_sync_warpgroup(wg);
  stage_rows<DV>(o, l0, l1, Qh, warp * 16 + gid, p.D, tig);
  bar_sync_warpgroup(wg);
  bf16* obase = p.out + (long long)b * p.N * p.H * p.D + (long long)h * p.D;
  store_rows<D>(Qh, obase, (long long)p.H * p.D, row0, p.N, wtid);
}

// ---------------------------------------------------------------------------
// launch (the plan - kernel, run, grid, shared memory - comes from the wrapper;
// this checks it against the instantiation)
// ---------------------------------------------------------------------------

template <int D, int DV>
inline int launch(const Params& p, bool resident, int blocks, int smem, cudaStream_t stream) {
  const int nt = (p.M + kRows - 1) / kRows;
  const long long runs = (p.q_tiles + p.run - 1) / p.run;
  if ((size_t)smem != smem_bytes(D, DV, resident, nt) || (!resident && p.run != 1) ||
      (long long)blocks != (long long)p.B * p.H * runs)
    return (int)cudaErrorInvalidValue;
  auto kernel = resident ? k3_resident<D, DV> : k3_stream<D, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace k3
}  // namespace mdv2
