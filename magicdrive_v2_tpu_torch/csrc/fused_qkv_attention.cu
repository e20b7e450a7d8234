// fused_qkv_attention: attention straight off the packed qkv projection.
//
// Replaces the three Pallas bodies of the JAX package's ops/flash_fused.py
// (_fused_fwd_impl, _fused_fwd_blocked, _fused_fwd_blocked_hsplit): they exist
// apart only because of the TPU's VMEM size and block-shape rules and compute
// one function, so one kernel stands for all three sequence-length regimes.
//
// qkv is (G, N, 3, H, D), read in place by strides (no split, no transpose);
// the output is (G, N, H*D). kv_perm (J, G) makes block (g, h, q tile) read its
// k/v from group perm[j][g] for each source j: one softmax per source, outputs
// summed over j. On a TPU that sum revisits the output block along a
// sequential grid axis; here the loop over j lives inside the block and the
// output is written once.
//
// Bound on an H100: operations. 4*G*H*N^2*D*J FLOP against 2*(3+1)*G*N*H*D
// bytes is far above the card's ~295 FLOP per byte, so the design keeps the
// products on the tensor cores (mma.sync bf16, fp32 accumulate) and keeps
// logits, probabilities and the running softmax state in registers.
#include "attn_core.cuh"

extern "C" int mdv2_fused_qkv_attention(const void* qkv, void* out, const int* perm,
                                        const float* q_w, const float* k_w, int G,
                                        int N, int H, int D, int J, float scale,
                                        float eps, int dtype, void* stream) {
  mdv2::AttnParams p;
  const size_t esize = (dtype == 0) ? 2 : 4;
  const char* base = reinterpret_cast<const char*>(qkv);
  const long long hd = (long long)H * D;
  p.q = base;
  p.k = base + esize * hd;
  p.v = base + esize * 2 * hd;
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
  return mdv2::launch_attention(p, dtype, reinterpret_cast<cudaStream_t>(stream));
}
