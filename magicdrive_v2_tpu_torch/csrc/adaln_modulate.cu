// adaln_modulate: LayerNorm (fp32 statistics, eps, no affine) followed by
// x_hat * (1 + scale) + shift with per-batch (B, C) shift and scale, for rows of
// a (B, N, C) tensor, in one pass.
//
// Replaces the Pallas kernel of the JAX package's ops/fused_adaln.py (_kernel,
// adaln_modulate). No padding of N to a row block and no restriction on C.
//
// Bound on an H100: bytes (one read and one write of x; shift and scale stay in
// L2). The design reads each row once with 16-byte loads into registers, one
// warp per row, takes mean and variance with warp shuffles in the two-pass
// mean((x - mean)^2) form, and writes the row once. A row must fit the
// registers of one warp (C <= 1280) and be a whole number of 16-byte chunks
// (C a multiple of 8 in bf16, of 4 in fp32); the launch refuses other widths.
//
// The backward (the JAX trainer differentiates the composition; no TPU kernel
// had one): for g = dout and g' = g (1 + scale),
//   dx = rstd (g' - mean(g') - x_hat mean(g' x_hat)),
//   dshift[b] = sum_n g,  dscale[b] = sum_n g x_hat.
// adaln_bwd_rows keeps the forward's layout (a warp a row, 16-byte pieces in
// registers, the statistics recomputed) and sums each block's 64 rows of g and
// g x_hat into per-warp fp32 rows in shared memory, then the four warps in
// order into a per-block partial; adaln_bwd_sum adds the partials of a batch
// in order. No atomics: two calls give the same bits. Bound: bytes (x and g
// read, dx written, the partials small).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float& o, float x) { o = x; }
__device__ __forceinline__ void from_f32(bf16& o, float x) { o = __float2bfloat16(x); }

template <typename T>
struct Chunk {
  static constexpr int N = 16 / sizeof(T);
  __device__ static void load(const T* p, float (&out)[N]) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  }
  __device__ static void store(T* p, const float (&in)[N]) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) from_f32(e[i], in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxFloatsPerLane = 40;  // rows up to 32 * 40 = 1280 elements

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
adaln_rows(const T* __restrict__ x, const T* __restrict__ shift,
               const T* __restrict__ scale, T* __restrict__ out, long long rows,
               int N, int C, float eps) {
  constexpr int E = Chunk<T>::N;
  constexpr int MAXCH = kMaxFloatsPerLane / E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;
  const int nch = C / E;
  const T* xr = x + row * C;
  float v[MAXCH][E];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXCH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
      Chunk<T>::load(xr + ch * E, v[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[i][e];
    }
  }
  const float mean = warp_sum(sum) / (float)C;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXCH; ++i) {
    if (lane + 32 * i < nch) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[i][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / (float)C + eps);
  const long long b = row / N;
  const T* sh = shift + b * C;
  const T* sc = scale + b * C;
  T* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < MAXCH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
      float s1[E], s2[E], o[E];
      Chunk<T>::load(sh + ch * E, s1);
      Chunk<T>::load(sc + ch * E, s2);
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = (v[i][e] - mean) * rstd * (1.0f + s2[e]) + s1[e];
      Chunk<T>::store(orow + ch * E, o);
    }
  }
}

constexpr int kBwdRows = 64;  // rows of one batch a backward block takes

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
adaln_bwd_rows(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ g,
               T* __restrict__ dx, float* __restrict__ part, int N, int C, float eps) {
  constexpr int E = Chunk<T>::N;
  constexpr int MAXCH = kMaxFloatsPerLane / E;
  extern __shared__ float acc[];  // [warp][2][C]: sum g, sum g x_hat
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrb = (N + kBwdRows - 1) / kBwdRows;
  const int b = blockIdx.x / nrb, rb = blockIdx.x % nrb;
  const int nch = C / E;
  float* a_g = acc + warp * 2 * C;
  float* a_gx = a_g + C;
  for (int c = lane; c < C; c += 32) {
    a_g[c] = 0.0f;
    a_gx[c] = 0.0f;
  }
  __syncwarp();  // each lane then adds into the columns of its own pieces
  const T* sc = scale + (long long)b * C;
  for (int n = rb * kBwdRows + warp; n < min(N, (rb + 1) * kBwdRows); n += kWarpsPerBlock) {
    const long long row = (long long)b * N + n;
    const T* xr = x + row * C;
    const T* gr = g + row * C;
    float v[MAXCH][E], gv[MAXCH][E];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXCH; ++i) {
      const int ch = lane + 32 * i;
      if (ch < nch) {
        Chunk<T>::load(xr + ch * E, v[i]);
        Chunk<T>::load(gr + ch * E, gv[i]);
#pragma unroll
        for (int e = 0; e < E; ++e) sum += v[i][e];
      }
    }
    const float mean = warp_sum(sum) / (float)C;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXCH; ++i) {
      if (lane + 32 * i < nch) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = v[i][e] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = 1.0f / sqrtf(warp_sum(sq) / (float)C + eps);
    float mg = 0.0f, mgx = 0.0f;  // sums of g' and g' x_hat
#pragma unroll
    for (int i = 0; i < MAXCH; ++i) {
      const int ch = lane + 32 * i;
      if (ch < nch) {
        float s2[E];
        Chunk<T>::load(sc + ch * E, s2);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = (v[i][e] - mean) * rstd;
          const float gp = gv[i][e] * (1.0f + s2[e]);
          a_g[ch * E + e] += gv[i][e];
          a_gx[ch * E + e] += gv[i][e] * xh;
          v[i][e] = xh;
          gv[i][e] = gp;
          mg += gp;
          mgx += gp * xh;
        }
      }
    }
    mg = warp_sum(mg) / (float)C;
    mgx = warp_sum(mgx) / (float)C;
    T* dr = dx + row * C;
#pragma unroll
    for (int i = 0; i < MAXCH; ++i) {
      const int ch = lane + 32 * i;
      if (ch < nch) {
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = rstd * (gv[i][e] - mg - v[i][e] * mgx);
        Chunk<T>::store(dr + ch * E, o);
      }
    }
  }
  __syncthreads();
  float* out = part + (long long)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += kWarpsPerBlock * 32) {
    float s = 0.0f;
    for (int w = 0; w < kWarpsPerBlock; ++w) s += acc[w * 2 * C + c];
    out[c] = s;
  }
}

// dshift[b][c], dscale[b][c]: the partials of batch b's row blocks, in order.
template <typename T>
__global__ void __launch_bounds__(256)
adaln_bwd_sum(const float* __restrict__ part, T* __restrict__ dshift, T* __restrict__ dscale,
              int B, int nrb, int C) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)B * C) return;
  const int b = (int)(i / C), c = (int)(i % C);
  float sg = 0.0f, sgx = 0.0f;
  for (int rb = 0; rb < nrb; ++rb) {
    const float* pr = part + ((long long)b * nrb + rb) * 2 * C;
    sg += pr[c];
    sgx += pr[C + c];
  }
  from_f32(dshift[i], sg);
  from_f32(dscale[i], sgx);
}

template <typename T>
int launch_backward(const void* x, const void* scale, const void* g, void* dx, void* dshift,
                    void* dscale, float* part, int B, int N, int C, float eps,
                    cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const long long nrb = (N + kBwdRows - 1) / kBwdRows;
  const long long blocks = (long long)B * nrb;
  if (blocks <= 0 || blocks > 2147483647LL || (long long)B * C > 2147483647LL * 256)
    return (int)cudaErrorInvalidConfiguration;
  const bool aligned =
      (C % E == 0) && (C <= 32 * kMaxFloatsPerLane) &&
      (((uintptr_t)x | (uintptr_t)scale | (uintptr_t)g | (uintptr_t)dx) % 16 == 0);
  if (!aligned) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * kWarpsPerBlock * C;  // <= 40 KB
  adaln_bwd_rows<T><<<(unsigned)blocks, kWarpsPerBlock * 32, smem, stream>>>(
      (const T*)x, (const T*)scale, (const T*)g, (T*)dx, part, N, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adaln_bwd_sum<T><<<(unsigned)(((long long)B * C + 255) / 256), 256, 0, stream>>>(
      part, (T*)dshift, (T*)dscale, B, (int)nrb, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* shift, const void* scale, void* out,
           long long rows, int N, int C, float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const bool aligned =
      (C % E == 0) && (C <= 32 * kMaxFloatsPerLane) &&
      (((uintptr_t)x | (uintptr_t)shift | (uintptr_t)scale | (uintptr_t)out) % 16 == 0);
  if (!aligned) return (int)cudaErrorInvalidValue;
  adaln_rows<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      (const T*)x, (const T*)shift, (const T*)scale, (T*)out, rows, N, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (rows, C) with rows = B * N; shift, scale: (B, C); all of one dtype
// (0 = bf16, 1 = fp32) and contiguous. Returns a cudaError_t as int.
extern "C" int mdv2_adaln_modulate(const void* x, const void* shift, const void* scale,
                                   void* out, long long rows, int N, int C, float eps,
                                   int dtype, void* stream) {
  if (rows <= 0 || N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<bf16>(x, shift, scale, out, rows, N, C, eps, s);
  if (dtype == 1) return launch<float>(x, shift, scale, out, rows, N, C, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: x, g (= dout), dx (B, N, C); scale, dshift, dscale (B, C); all of
// one dtype (0 = bf16, 1 = fp32) and contiguous; part: fp32 scratch of B *
// ceil(N / 64) * 2 * C. Returns a cudaError_t as int.
extern "C" int mdv2_adaln_modulate_backward(const void* x, const void* scale, const void* g,
                                            void* dx, void* dshift, void* dscale, float* part,
                                            int B, int N, int C, float eps, int dtype,
                                            void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_backward<bf16>(x, scale, g, dx, dshift, dscale, part, B, N, C, eps, s);
  if (dtype == 1)
    return launch_backward<float>(x, scale, g, dx, dshift, dscale, part, B, N, C, eps, s);
  return (int)cudaErrorInvalidValue;
}
