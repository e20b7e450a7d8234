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
