// flash_attention: generic BNHD attention with separate q, k and v.
//
// Replaces the Pallas kernel of the JAX package's ops/flash_attention.py
// (_fa_kernel, _flash_attention_fwd_impl). q is (B, N, H, D), k and v are
// (B, M, H, D) with M != N allowed; keys past M are masked. No bias: biased
// calls are sent to the plain version by the dispatcher in ops/attention.py.
// q, k and v are read through their batch, row and head strides, so views of
// a packed kv projection need no copy; the TPU wrapper's transpose to
// (B*H, N, D) and its padding copies are not carried over.
//
// Bound on an H100, at the main path's condition cross-attention (q (60, 1350,
// 16, 72), M = 312): bytes. q, k, v and the output are 0.46 GB, 0.137 ms at
// 3.35 TB/s; the products are 116 GFLOP, 0.118 ms at 989 TFLOP/s. So q and the
// output are touched once and the k/v tiles are kept on the SM. bf16 runs the
// kernels of attn_k3_sm90.cuh; what they do about the three things that held
// the first bf16 body (64-row q tiles on four warps of mma.sync, a two-stage
// cp.async ring, one block per q tile) back:
// - legacy tensor-core path: a block holds 128 q rows, one warpgroup per
//   64-row half, and both products are wgmma (q and k read by descriptors, the
//   probabilities from registers, v as it lies), the only way to Hopper's
//   tensor-core rate;
// - k/v re-read from L2 by every q tile (1.9 GB into shared memory per launch
//   for 0.46 GB of device memory): while the k/v sequence fits in shared memory
//   (M <= 320 at head dim 72, 109 KB, two blocks an SM) a block copies it once
//   and walks over a run of consecutive q tiles of its (batch, head), which the
//   launch plan chooses; longer sequences stream through a three-stage
//   cp.async ring;
// - short loop, little overlap (5 k tiles a block): in the resident kernel the
//   two warpgroups share no barrier after the k/v copy, so one warpgroup's
//   q copy and output write overlap the products of the other warpgroup and of
//   the other block on the SM; the output goes out in whole 16-byte pieces of
//   rows, staged in the q buffer (written from the accumulator layout, the
//   stores took a fifth of the kernel's time).
// fp32 runs the CUDA-core body of attn_core.cuh (every product in fp32, for
// tight comparisons).
#include "attn_core.cuh"
#include "attn_k3_sm90.cuh"

// bf16: the plan (resident, run, blocks, smem) is the wrapper's.
extern "C" int mdv2_k3_attention(const void* q, const void* k, const void* v, void* out, int B,
                                 int N, int M, int H, int D, long long q_bs, long long q_rs,
                                 long long q_hs, long long k_bs, long long k_rs, long long k_hs,
                                 long long v_bs, long long v_rs, long long v_hs, float scale,
                                 int resident, int run, int blocks, int smem, void* stream) {
  using namespace mdv2::k3;
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0 || run <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = reinterpret_cast<const mdv2::bf16*>(q);
  p.k = reinterpret_cast<const mdv2::bf16*>(k);
  p.v = reinterpret_cast<const mdv2::bf16*>(v);
  p.out = reinterpret_cast<mdv2::bf16*>(out);
  p.q_bs = q_bs; p.q_rs = q_rs; p.q_hs = q_hs;
  p.k_bs = k_bs; p.k_rs = k_rs; p.k_hs = k_hs;
  p.v_bs = v_bs; p.v_rs = v_rs; p.v_hs = v_hs;
  p.B = B; p.H = H; p.N = N; p.M = M; p.D = D;
  p.q_tiles = (N + 2 * mdv2::kRows - 1) / (2 * mdv2::kRows);
  p.run = run;
  p.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch<8, 16>(p, resident != 0, blocks, smem, s);
    case 16: return launch<16, 16>(p, resident != 0, blocks, smem, s);
    case 72: return launch<72, 72>(p, resident != 0, blocks, smem, s);
    case 144: return launch<144, 144>(p, resident != 0, blocks, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

// fp32: the CUDA-core body.
extern "C" int mdv2_flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                        int B, int N, int M, int H, int D, long long q_bs,
                                        long long q_rs, long long q_hs, long long k_bs,
                                        long long k_rs, long long k_hs, long long v_bs,
                                        long long v_rs, long long v_hs, float scale,
                                        void* stream) {
  mdv2::AttnParams p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.q_gs = q_bs; p.q_rs = q_rs; p.q_hs = q_hs;
  p.k_gs = k_bs; p.k_rs = k_rs; p.k_hs = k_hs;
  p.v_gs = v_bs; p.v_rs = v_rs; p.v_hs = v_hs;
  p.o_gs = (long long)N * H * D;
  p.o_rs = (long long)H * D;
  p.o_hs = D;
  p.perm = nullptr;
  p.q_w = nullptr;
  p.k_w = nullptr;
  p.G = B; p.H = H; p.N = N; p.M = M; p.D = D; p.J = 1;
  p.scale = scale;
  p.eps = 0.0f;
  return mdv2::launch_attention_f32(p, reinterpret_cast<cudaStream_t>(stream));
}
