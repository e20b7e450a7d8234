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
// One launch of adaln_bwd_ring (below), on the grid that the wrapper's
// plan_adaln_backward (ops/fused_adaln.py) fixes from B, N and the SMs. Bound:
// bytes (x and g read, dx written once; the partials, 2 C floats a block, small).
// The statistics are recomputed from the rows; the column sums stay in
// registers and are added in a fixed order (rows of a warp, warps of a block,
// blocks of a batch), with no atomics on them: two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// The backward. A block takes rows_per_block consecutive rows of one batch; each
// of its kRingWarps warps walks every kRingWarps-th of them (rows n0 + w, n0 + w +
// kRingWarps, ...) and keeps its next row of x and g in flight in a ring of kRing
// slots of its own in shared memory, filled by one-dimensional TMA bulk copies
// that complete on one mbarrier a slot. A lane owns the columns of the pieces p =
// lane + 32 i (kPiece elements each) in every row it reads and keeps their
// partial sums of g and g x_hat in registers; 1 + scale of the batch sits in
// shared memory. The passes (mean, variance, the sums of g' and g' x_hat, dx)
// read the slot with 8-byte (bf16) or 16-byte (fp32) loads, neighbouring lanes on
// neighbouring addresses: no bank conflict. At the end the warps' sums meet in
// shared memory and are added in warp order, the block's partial goes to part,
// and the last block of a batch to finish adds the batch's partials in block
// order. Four warps, two slots and three blocks an SM (12 warps) ran fastest on
// an H100 of the shapes tried (PERF.md): more warps an SM or more slots were
// slower, and 1 + scale in registers (161 registers) allowed no fourth block.

constexpr int kRingWarps = 4;    // warps of a backward block
constexpr int kBlocksPerSm = 3;  // blocks an SM holds at once (the plan's waves)
constexpr int kRing = 2;         // slots of a warp's ring
constexpr int kPiece = 4;        // elements a lane reads at a time (8 bytes bf16, 16 fp32)
constexpr int kMaxPieces = kMaxFloatsPerLane / kPiece;  // a lane's pieces at C = 1280
constexpr int kBarBytes = 128;   // the mbarriers (8 bytes a slot), ahead of the slots
static_assert(kRingWarps * kRing * 8 <= kBarBytes, "the mbarriers outgrow their room");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One row of x and one of g into a slot (x, then g), completing on its barrier.
__device__ __forceinline__ void load_rows(uint32_t slot, uint32_t bar, const void* xr,
                                          const void* gr, uint32_t row_bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(2 * row_bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(slot),
      "l"(xr), "r"(row_bytes), "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(slot + row_bytes),
      "l"(gr), "r"(row_bytes), "r"(bar)
      : "memory");
}

template <typename T>
struct Piece;
template <>
struct Piece<bf16> {
  __device__ static void load(const bf16* p, float (&o)[kPiece]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
  __device__ static void store(bf16* p, const float (&v)[kPiece]) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};
template <>
struct Piece<float> {
  __device__ static void load(const float* p, float (&o)[kPiece]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  __device__ static void store(float* p, const float (&v)[kPiece]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// dx of the block's rows of batch b; the block's sums of g and g x_hat over them
// go to part[blockIdx.x] (alone in its batch: to dshift[b] and dscale[b]); the
// last block of a batch to finish (by count[b], zero at the launch) adds the
// batch's partials in block order and sets count[b] back to zero for the next.
template <typename T>
__global__ void __launch_bounds__(kRingWarps * 32, kBlocksPerSm)
adaln_bwd_ring(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ g,
               T* __restrict__ dx, T* __restrict__ dshift, T* __restrict__ dscale,
               float* __restrict__ part, unsigned* __restrict__ count, int N, int C,
               int rows_per_block, int blocks_per_batch, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_block;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / blocks_per_batch;
  const int n0 = (blockIdx.x % blocks_per_batch) * rows_per_block;
  const int rows = min(N - n0, rows_per_block);
  const int np = C / kPiece;
  const uint32_t row_bytes = (uint32_t)C * sizeof(T);
  // this warp's rows: n0 + warp + j * kRingWarps for j < cnt
  const int cnt = rows > warp ? (rows - warp + kRingWarps - 1) / kRingWarps : 0;
  const long long row0 = (long long)b * N + n0 + warp;
  const long long step = (long long)kRingWarps * C;
  const T* xw = x + row0 * C;
  const T* gw = g + row0 * C;
  T* slots = reinterpret_cast<T*>(smem + kBarBytes) + (size_t)warp * kRing * 2 * C;
  const uint32_t bar0 = smem_u32(smem) + warp * kRing * 8;
  const uint32_t slot0 = smem_u32(slots);
  // 1 + scale of the batch in fp32, behind the slots or the warps' sums
  const size_t slot_bytes = (size_t)kRingWarps * kRing * 2 * C * sizeof(T);
  const size_t sum_bytes = (size_t)kRingWarps * 2 * C * sizeof(float);
  float* sp = reinterpret_cast<float*>(smem + kBarBytes +
                                       (slot_bytes > sum_bytes ? slot_bytes : sum_bytes));
  const T* sc = scale + (long long)b * C;
  for (int c = threadIdx.x; c < C; c += kRingWarps * 32) sp[c] = 1.0f + to_f32(sc[c]);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingWarps * kRing; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(smem) + i * 8),
                   "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (lane == 0)
    for (int j = 0; j < min(kRing, cnt); ++j)
      load_rows(slot0 + j * 2 * row_bytes, bar0 + j * 8, xw + j * step, gw + j * step,
                row_bytes);
  float pg[kMaxPieces][kPiece], pgx[kMaxPieces][kPiece];
#pragma unroll
  for (int i = 0; i < kMaxPieces; ++i) {
#pragma unroll
    for (int e = 0; e < kPiece; ++e) {
      pg[i][e] = 0.0f;
      pgx[i][e] = 0.0f;
    }
  }
  for (int j = 0; j < cnt; ++j) {
    const int s = j % kRing;
    bar_wait(bar0 + s * 8, (uint32_t)(j / kRing) & 1u);
    const T* xs = slots + (size_t)s * 2 * C;
    const T* gs = xs + C;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxPieces; ++i) {
      const int p = lane + 32 * i;
      if (p < np) {
        float v[kPiece];
        Piece<T>::load(xs + p * kPiece, v);
#pragma unroll
        for (int e = 0; e < kPiece; ++e) sum += v[e];
      }
    }
    const float mean = warp_sum(sum) / (float)C;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxPieces; ++i) {
      const int p = lane + 32 * i;
      if (p < np) {
        float v[kPiece];
        Piece<T>::load(xs + p * kPiece, v);
#pragma unroll
        for (int e = 0; e < kPiece; ++e) {
          const float d = v[e] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = 1.0f / sqrtf(warp_sum(sq) / (float)C + eps);
    float mg = 0.0f, mgx = 0.0f;  // sums of g' and g' x_hat
#pragma unroll
    for (int i = 0; i < kMaxPieces; ++i) {
      const int p = lane + 32 * i;
      if (p < np) {
        float v[kPiece], gv[kPiece], s4[kPiece];
        Piece<T>::load(xs + p * kPiece, v);
        Piece<T>::load(gs + p * kPiece, gv);
        Piece<float>::load(sp + p * kPiece, s4);
#pragma unroll
        for (int e = 0; e < kPiece; ++e) {
          const float xh = (v[e] - mean) * rstd;
          const float gp = gv[e] * s4[e];
          pg[i][e] += gv[e];
          pgx[i][e] += gv[e] * xh;
          mg += gp;
          mgx += gp * xh;
        }
      }
    }
    mg = warp_sum(mg) / (float)C;
    mgx = warp_sum(mgx) / (float)C;
    T* dr = dx + (row0 + (long long)j * kRingWarps) * C;
#pragma unroll
    for (int i = 0; i < kMaxPieces; ++i) {
      const int p = lane + 32 * i;
      if (p < np) {
        float v[kPiece], gv[kPiece], o[kPiece], s4[kPiece];
        Piece<T>::load(xs + p * kPiece, v);
        Piece<T>::load(gs + p * kPiece, gv);
        Piece<float>::load(sp + p * kPiece, s4);
#pragma unroll
        for (int e = 0; e < kPiece; ++e) {
          const float xh = (v[e] - mean) * rstd;
          o[e] = rstd * (gv[e] * s4[e] - mg - xh * mgx);
        }
        Piece<T>::store(dr + p * kPiece, o);
      }
    }
    // every lane is done with slot s: it takes row j + kRing
    __syncwarp();
    if (lane == 0 && j + kRing < cnt) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_rows(slot0 + s * 2 * row_bytes, bar0 + s * 8, xw + (j + kRing) * step,
                gw + (j + kRing) * step, row_bytes);
    }
  }
  // the warps' sums, [warp][g, g x_hat][C], where the slots were (every copy landed)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + kBarBytes);
  float* mine = red + warp * 2 * C;
#pragma unroll
  for (int i = 0; i < kMaxPieces; ++i) {
    const int p = lane + 32 * i;
    if (p < np) {
      *reinterpret_cast<float4*>(mine + p * kPiece) =
          make_float4(pg[i][0], pg[i][1], pg[i][2], pg[i][3]);
      *reinterpret_cast<float4*>(mine + C + p * kPiece) =
          make_float4(pgx[i][0], pgx[i][1], pgx[i][2], pgx[i][3]);
    }
  }
  __syncthreads();
  T* const dsum[2] = {dshift + (long long)b * C, dscale + (long long)b * C};
  float* out = part + (long long)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += kRingWarps * 32) {
    float s = 0.0f;
    for (int w = 0; w < kRingWarps; ++w) s += red[w * 2 * C + c];
    if (blocks_per_batch == 1)
      from_f32(dsum[c >= C][c >= C ? c - C : c], s);
    else
      out[c] = s;
  }
  if (blocks_per_batch == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last_block = atomicAdd(count + b, 1u) == (unsigned)(blocks_per_batch - 1);
    if (last_block) count[b] = 0u;  // every block of the batch has counted
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const float* pb = part + (long long)b * blocks_per_batch * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += kRingWarps * 32) {
    float s = 0.0f;
    for (int k = 0; k < blocks_per_batch; ++k) s += __ldcg(pb + (long long)k * 2 * C + c);
    from_f32(dsum[c >= C][c >= C ? c - C : c], s);
  }
}

// Shared memory of a backward block for rows of C elements.
template <typename T>
size_t backward_smem(int C) {
  const size_t slots = (size_t)kRingWarps * kRing * 2 * C * sizeof(T);
  const size_t sums = (size_t)kRingWarps * 2 * C * sizeof(float);
  return kBarBytes + (slots > sums ? slots : sums) + C * sizeof(float);
}

// Allows adaln_bwd_ring<T> the shared memory of the widest row, once a device:
// the attribute is a limit, each launch asks for its own row's.
template <typename T>
cudaError_t allow_backward_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(adaln_bwd_ring<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)backward_smem<T>(32 * kMaxFloatsPerLane));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev].store(true);
  return err;
}

template <typename T>
int launch_backward(const void* x, const void* scale, const void* g, void* dx, void* dshift,
                    void* dscale, float* part, unsigned* count, int B, int N, int C,
                    int rows_per_block, int blocks_per_batch, float eps, cudaStream_t stream) {
  const long long blocks = (long long)B * blocks_per_batch;
  // every block takes at least one row, and the blocks of a batch cover its rows
  const bool planned = rows_per_block > 0 && blocks_per_batch > 0 &&
                       (long long)(blocks_per_batch - 1) * rows_per_block < N &&
                       (long long)blocks_per_batch * rows_per_block >= N;
  if (!planned || blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const bool aligned =
      (C * sizeof(T)) % 16 == 0 && C <= 32 * kMaxFloatsPerLane &&
      (((uintptr_t)x | (uintptr_t)scale | (uintptr_t)g | (uintptr_t)dx | (uintptr_t)dshift |
        (uintptr_t)dscale) % 16 == 0);
  if (!aligned) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_backward_smem<T>();
  if (err != cudaSuccess) return (int)err;
  adaln_bwd_ring<T><<<(unsigned)blocks, kRingWarps * 32, backward_smem<T>(C), stream>>>(
      (const T*)x, (const T*)scale, (const T*)g, (T*)dx, (T*)dshift, (T*)dscale, part, count,
      N, C, rows_per_block, blocks_per_batch, eps);
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
// one dtype (0 = bf16, 1 = fp32) and contiguous. Block k of batch b takes rows
// k * rows_per_block .. of it (blocks_per_batch blocks a batch: the plan of
// plan_adaln_backward). part: fp32 scratch of B * blocks_per_batch * 2 * C
// floats; count: B counters, zero at the launch and left zero by it (launches
// that share them must run in order, as on one stream). Returns a cudaError_t
// as int.
extern "C" int mdv2_adaln_modulate_backward(const void* x, const void* scale, const void* g,
                                            void* dx, void* dshift, void* dscale, float* part,
                                            unsigned* count, int B, int N, int C,
                                            int rows_per_block, int blocks_per_batch, float eps,
                                            int dtype, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_backward<bf16>(x, scale, g, dx, dshift, dscale, part, count, B, N, C,
                                 rows_per_block, blocks_per_batch, eps, s);
  if (dtype == 1)
    return launch_backward<float>(x, scale, g, dx, dshift, dscale, part, count, B, N, C,
                                  rows_per_block, blocks_per_batch, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's block shape, which plan_adaln_backward and the blocked plain
// version assume: warps a block and blocks an SM.
extern "C" void mdv2_adaln_backward_shape(int* warps, int* blocks_per_sm) {
  *warps = kRingWarps;
  *blocks_per_sm = kBlocksPerSm;
}
