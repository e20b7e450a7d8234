// flash_attention: generic BNHD attention with separate q, k and v.
//
// Replaces the Pallas kernel of the JAX package's ops/flash_attention.py
// (_fa_kernel, _flash_attention_fwd_impl). q is (B, N, H, D), k and v are
// (B, M, H, D) with M != N allowed; keys past M are masked. No bias: biased
// calls are sent to the plain version by the dispatcher in ops/attention.py.
//
// q, k and v are read through their batch, row and head strides, so views of
// a packed kv projection need no copy; the TPU wrapper's transpose to
// (B*H, N, D) and its padding copies are not carried over. The device code is
// the online-softmax core shared with fused_qkv_attention (attn_core.cuh),
// without the norm and the group permutation.
//
// Bound on an H100: operations for long key sequences (4*B*H*N*M*D FLOP); for
// the short condition sequences of the cross-attention the bytes of q and the
// output come close, so q and the output are touched exactly once.
#include "attn_core.cuh"

extern "C" int mdv2_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, int B, int N, int M, int H, int D,
                                    long long q_bs, long long q_rs, long long q_hs,
                                    long long k_bs, long long k_rs, long long k_hs,
                                    long long v_bs, long long v_rs, long long v_hs,
                                    float scale, int dtype, void* stream) {
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
  return mdv2::launch_attention(p, dtype, reinterpret_cast<cudaStream_t>(stream));
}
