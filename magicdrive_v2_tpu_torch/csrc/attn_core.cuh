// The fp32 attention body shared by fused_qkv_attention and flash_attention
// (their bf16 bodies are attn_k1_sm90.cuh and attn_k3_sm90.cuh).
//
// attn_fwd_f32: fp32 operands on the CUDA cores, every product and sum in
// fp32, which is what allows a tight comparison with the plain PyTorch version
// on the card. One thread block computes one (group, head, 32-row q tile).
// Inside the block a loop runs over the J k/v sources and, inside that, over
// 64-row k tiles with an online softmax (running max, running sum, fp32
// accumulator in shared memory). After a source's k loop the accumulator is
// divided by that source's softmax sum and added into a per-block output
// accumulator, which is written once at the end. q, k and v are read in place
// through element strides, so the same body serves the packed (G, N, 3, H, D)
// qkv buffer and separate BNHD q/k/v tensors.
//
// Optional per-head RMSNorm of q and k rows (fp32 normalise over D, multiply by
// the fp32 weight). Rows past the sequence end are zero-filled and their
// logits are set to -inf.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mdv2 {

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
constexpr int kBK = 64;  // k rows per tile

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

// Returns a cudaError_t as int (0 = launched).
inline int launch_attention_f32(const AttnParams& p, cudaStream_t stream) {
  if (p.G <= 0 || p.H <= 0 || p.N <= 0 || p.M <= 0 || p.D <= 0 || p.J <= 0 || p.D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const size_t smem = attn_f32_smem_bytes(p.D);
  cudaError_t err =
      cudaFuncSetAttribute(attn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((p.N + kFQ - 1) / kFQ) * p.H * p.G;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  attn_fwd_f32<<<(unsigned)blocks, kFThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace mdv2
