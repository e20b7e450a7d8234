// fused_qkv_attention: attention straight off the packed qkv projection.
//
// Replaces the three Pallas bodies of the JAX package's ops/flash_fused.py
// (_fused_fwd_impl, _fused_fwd_blocked, _fused_fwd_blocked_hsplit): they exist
// apart only because of the TPU's VMEM size and block-shape rules and compute
// one function, so one kernel stands for all three sequence-length regimes.
//
// qkv is (G, N, 3, H, D); the output is (G, N, H*D). kv_perm (J, G) makes the
// rows of group g attend to the k/v of group perm[j][g] for each source j: one
// softmax per source, outputs summed over j. On a TPU that sum revisits the
// output block along a sequential grid axis; here the loop over j lives inside
// the block and the output is written once.
//
// Bound on an H100: operations. 4*G*H*N^2*D*J FLOP against 2*(3+1)*G*N*H*D
// bytes is far above the card's ~295 FLOP per byte. bf16 runs the two kernels
// of attn_k1_sm90.cuh; what they do about the four things that held a
// one-kernel mma.sync body with 64-row q tiles back:
// - the k RMSNorm runs once per row, in a pre-pass, instead of once for every
//   q tile that reads the row (22 times at N = 1350), each time with a barrier
//   and a read-modify-write of shared memory between copy and product;
// - a block holds 128 q rows, so each k/v tile in shared memory feeds twice
//   the rows, and both products are wgmma (one warpgroup per 64-row half, q/k/v
//   read by descriptors, the probabilities from registers): mma.sync with
//   ldmatrix cannot reach Hopper's tensor-core rate;
// - with J > 1 the fp32 sum over the sources is kept in shared memory, not in
//   36 more registers a thread, so both bodies stay within 128 registers and
//   two blocks share an SM;
// - the exponentials (G*H*N^2*J, near the product bound at the MUFU rate) are
//   one FFMA and one ex2.approx each, and overlap the products of the other
//   warpgroups on the SM (not yet those of their own warpgroup).
// fp32 keeps the CUDA-core body of attn_core.cuh (every product in fp32, for
// tight comparisons).
#include "attn_core.cuh"
#include "attn_k1_sm90.cuh"

// The pre-pass: the k rows of qkv (G, N, 3, H, D) bf16, normalised, as tiles
// (G, H, T, DP / 8, 64, 8).
extern "C" int mdv2_k1_tile_k(const void* qkv, void* tiles, const float* k_w, int G, int N,
                              int H, int D, int dp, int T, float eps, void* stream) {
  using namespace mdv2::k1;
  if (G <= 0 || N <= 0 || H <= 0 || D <= 0 || D % 8 != 0 || D > dp || T * kRows < N)
    return (int)cudaErrorInvalidValue;
  const bf16* x = reinterpret_cast<const bf16*>(qkv);
  bf16* y = reinterpret_cast<bf16*>(tiles);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dp) {
    case 16: return launch_tile_k<16>(x, y, k_w, G, N, H, D, T, eps, s);
    case 32: return launch_tile_k<32>(x, y, k_w, G, N, H, D, T, eps, s);
    case 80: return launch_tile_k<80>(x, y, k_w, G, N, H, D, T, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The attention: q and v from qkv, k from the pre-pass's tiles; the plan (dp,
// q_tiles, blocks, smem) is the wrapper's.
extern "C" int mdv2_k1_attention(const void* qkv, const void* tiles, void* out, const int* perm,
                                 const float* q_w, int G, int N, int H, int D, int J,
                                 float scale, float eps, int dp, int q_tiles, int blocks,
                                 int smem, void* stream) {
  using namespace mdv2::k1;
  if (G <= 0 || N <= 0 || H <= 0 || J <= 0 || D % 8 != 0 || D > dp ||
      q_tiles * 2 * kRows < N || (long long)blocks != (long long)G * H * q_tiles)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.qkv = reinterpret_cast<const bf16*>(qkv);
  p.tiles = reinterpret_cast<const bf16*>(tiles);
  p.out = reinterpret_cast<bf16*>(out);
  p.perm = perm;
  p.q_w = q_w;
  p.G = G; p.H = H; p.N = N; p.D = D; p.J = J;
  p.T = 2 * q_tiles;
  p.q_tiles = q_tiles;
  p.scale = scale;
  p.eps = eps;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dp) {
    case 16: return launch_attend<16, 16>(p, blocks, smem, s);
    case 32: return launch_attend<32, 32>(p, blocks, smem, s);
    case 80: return launch_attend<80, 72>(p, blocks, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

// fp32: the CUDA-core body, q/k/v read in place from qkv by strides.
extern "C" int mdv2_fused_qkv_attention_f32(const void* qkv, void* out, const int* perm,
                                            const float* q_w, const float* k_w, int G, int N,
                                            int H, int D, int J, float scale, float eps,
                                            void* stream) {
  mdv2::AttnParams p;
  const float* base = reinterpret_cast<const float*>(qkv);
  const long long hd = (long long)H * D;
  p.q = base;
  p.k = base + hd;
  p.v = base + 2 * hd;
  p.out = out;
  p.q_gs = p.k_gs = p.v_gs = (long long)N * 3 * hd;
  p.q_rs = p.k_rs = p.v_rs = 3 * hd;
  p.q_hs = p.k_hs = p.v_hs = D;
  p.o_gs = (long long)N * hd;
  p.o_rs = hd;
  p.o_hs = D;
  p.perm = perm;
  p.q_w = q_w;
  p.k_w = k_w;
  p.G = G; p.H = H; p.N = N; p.M = N; p.D = D; p.J = J;
  p.scale = scale;
  p.eps = eps;
  return mdv2::launch_attention_f32(p, reinterpret_cast<cudaStream_t>(stream));
}
