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
//
// Under autograd the forward also writes the row log-sum-exp (fp32, (G, H, N))
// of a call with one source (with several, the backward's first pass takes each
// source's: the J > 1 body is at its 128 registers), and the backward is the
// kernels of attn_bwd_sm90.cuh (shared with flash_attention): in bf16 a pre-pass
// normalises q and k once, as the forward does, into tiles that the dQ and dK/dV
// kernels read with v from qkv (fp32 normalises where a tile is loaded); dq and
// dk go back through the norm in their epilogues, and the three grads land in
// one (G, N, 3, H, D) tensor; the k/v grads of a group sum over the (source,
// group) pairs that read it, listed by the wrapper, and the norm weights' grads
// come from per-block partials.
#include "attn_bwd_sm90.cuh"
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
// q_tiles, blocks, smem) is the wrapper's; lse may be null.
extern "C" int mdv2_k1_attention(const void* qkv, const void* tiles, void* out, const int* perm,
                                 const float* q_w, float* lse, int G, int N, int H, int D, int J,
                                 float scale, float eps, int dp, int q_tiles, int blocks,
                                 int smem, void* stream) {
  using namespace mdv2::k1;
  if (G <= 0 || N <= 0 || H <= 0 || J <= 0 || D % 8 != 0 || D > dp ||
      q_tiles * 2 * kRows < N || (long long)blocks != (long long)G * H * q_tiles ||
      (J > 1 && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.qkv = reinterpret_cast<const bf16*>(qkv);
  p.tiles = reinterpret_cast<const bf16*>(tiles);
  p.out = reinterpret_cast<bf16*>(out);
  p.perm = perm;
  p.q_w = q_w;
  p.lse = lse;
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

// fp32: the CUDA-core body, q/k/v read in place from qkv by strides; lse (G, H,
// N) with one source only.
extern "C" int mdv2_fused_qkv_attention_f32(const void* qkv, void* out, const int* perm,
                                            const float* q_w, const float* k_w, float* lse,
                                            int G, int N,
                                            int H, int D, int J, float scale, float eps,
                                            void* stream) {
  if (J > 1 && lse != nullptr) return (int)cudaErrorInvalidValue;
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
  p.lse = lse;
  p.G = G; p.H = H; p.N = N; p.M = N; p.D = D; p.J = J;
  p.scale = scale;
  p.eps = eps;
  return mdv2::launch_attention_f32(p, reinterpret_cast<cudaStream_t>(stream));
}

// The backward's pre-pass (bf16, with the norm): q and k of qkv (G, N, 3, H, D),
// normalised as the forward normalises them, as tiles (2, G, H, T, DP / 8, 64, 8).
extern "C" int mdv2_k1_backward_tiles(const void* qkv, void* tiles, const float* q_w,
                                      const float* k_w, int G, int N, int H, int D, int dp,
                                      int T, float eps, void* stream) {
  using namespace mdv2::bwd;
  if (G <= 0 || N <= 0 || H <= 0 || D <= 0 || D % 8 != 0 || D > dp || T * mdv2::kRows < N)
    return (int)cudaErrorInvalidValue;
  const mdv2::bf16* x = reinterpret_cast<const mdv2::bf16*>(qkv);
  mdv2::bf16* y = reinterpret_cast<mdv2::bf16*>(tiles);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dp) {
    case 16: return launch_tiles<16>(x, y, q_w, k_w, G, N, H, D, T, eps, s);
    case 32: return launch_tiles<32>(x, y, q_w, k_w, G, N, H, D, T, eps, s);
    case 80: return launch_tiles<80>(x, y, q_w, k_w, G, N, H, D, T, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward of one call (attn_bwd_sm90.cuh's params_of names the arrays);
// dtype 0 bf16 (head dims 8, 16, 24, 32, 72: the Hopper body), 1 fp32 (up to 144).
extern "C" int mdv2_k1_backward(const void* const* ptrs, const long long* ints,
                                const float* floats, int dtype, void* stream) {
  using namespace mdv2::bwd;
  const Params p = params_of(ptrs, ints, floats);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (p.D <= 16) return launch<mdv2::bf16, 16, 16>(p, s);
    if (p.D <= 32) return launch<mdv2::bf16, 32, 32>(p, s);
    return launch<mdv2::bf16, 80, 72>(p, s);
  }
  if (dtype == 1) {
    if (p.D <= 16) return launch<float, 16, 16>(p, s);
    if (p.D <= 32) return launch<float, 32, 32>(p, s);
    if (p.D <= 72) return launch<float, 80, 72>(p, s);
    return launch<float, 144, 144>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
