"""PyTorch port, layer library: every ported module of models/layers/blocks.py
against its flax counterpart on the CPU, fp32, with weights carried across by
``from_jax_params`` + ``load_state_dict(strict=True)`` and every leaf random.

Tolerance: 2e-5 absolute on outputs of order 0.1-1 — two fp32 matmul
implementations (XLA at precision "highest", PyTorch's CPU GEMM) summing in
different orders.
"""
import numpy as np
import pytest
import torch

from test_torch_common import assert_close, j, load_into, random_params, t

import jax.numpy as jnp
from magicdrive_v2_tpu.models.layers import blocks as JB
from magicdrive_v2_tpu_torch.models.layers import blocks as TB

ATOL = 2e-5


def test_pure_functions_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 2
    assert_close(TB.approx_gelu(t(x)), JB.approx_gelu(j(x)), 1e-6)
    # tanh approximation, not erf
    assert abs(float(TB.approx_gelu(torch.tensor(1.0))) - 0.841192) < 1e-5
    assert_close(TB.layer_norm_fp32(t(x)), JB.layer_norm_fp32(j(x)), 1e-5)
    # eps 1e-6, no affine: a constant row maps to exactly 0
    assert float(TB.layer_norm_fp32(torch.full((1, 8), 3.0)).abs().max()) == 0.0
    sh, sc = rng.standard_normal((2, 3, 1, 32)).astype(np.float32)
    assert_close(TB.t2i_modulate(t(x), t(sh), t(sc)), JB.t2i_modulate(j(x), j(sh), j(sc)), 1e-6)
    w = (rng.standard_normal(32) * 0.1 + 1).astype(np.float32)
    assert_close(TB._rms_apply(t(x), t(w)), JB._rms_apply(j(x), j(w)), 1e-6)
    assert_close(TB.pos_embedding_2d(32, 4, 5, scale=0.7, base_size=4),
                 JB.pos_embedding_2d(32, 4, 5, scale=0.7, base_size=4), 1e-5)


def test_rms_apply_cast_points_in_bf16():
    """fp32 normalise -> round to bf16 -> fp32 weight multiply -> round back."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w = (rng.standard_normal(16) * 0.3 + 1).astype(np.float32)
    out = TB._rms_apply(t(x).bfloat16(), t(w))
    ref = JB._rms_apply(j(x).astype(jnp.bfloat16), j(w))
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    mod = TB.RMSNorm(16)
    mod.weight.data = t(w)
    np.testing.assert_array_equal(mod(t(x).bfloat16()).detach().float().numpy(),
                                  out.float().numpy())


def test_timestep_embedding_is_cos_then_sin():
    ts = np.array([0.0, 3.5, 999.0], np.float32)
    assert_close(TB.timestep_embedding(t(ts), 16), JB.timestep_embedding(j(ts), 16), 1e-5)
    emb = TB.timestep_embedding(torch.zeros(1), 8)
    assert emb[0, :4].tolist() == [1.0] * 4 and emb[0, 4:].tolist() == [0.0] * 4
    assert_close(TB.timestep_embedding(t(ts), 7), JB.timestep_embedding(j(ts), 7), 1e-5)


def test_mlp_and_rmsnorm_modules():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    jm = JB.Mlp(hidden_features=48, out_features=24)
    p = random_params(jm, j(x))
    tm = load_into(TB.Mlp(32, 48, 24), p)
    assert_close(tm(t(x)), jm.apply(p, j(x)), ATOL)
    jn = JB.RMSNorm(32)
    p = random_params(jn, j(x))
    tn = load_into(TB.RMSNorm(32), p)
    assert_close(tn(t(x)), jn.apply(p, j(x)), 1e-6)


def test_patch_embed_3d_with_padding():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 3, 7, 10)).astype(np.float32)  # H=7 pads to 8
    jm = JB.PatchEmbed3D(patch_size=(1, 2, 2), embed_dim=24)
    p = random_params(jm, j(x))
    tm = load_into(TB.PatchEmbed3D((1, 2, 2), 4, 24), p)
    assert_close(tm(t(x)), jm.apply(p, j(x)), ATOL)


def test_timestep_size_caption_embedders():
    rng = np.random.default_rng(4)
    ts = np.array([10.0, 700.5], np.float32)
    jm = JB.TimestepEmbedder(32)
    p = random_params(jm, j(ts))
    assert_close(load_into(TB.TimestepEmbedder(32), p)(t(ts)), jm.apply(p, j(ts)), ATOL)

    fps = np.array([[12.0]], np.float32)
    jm = JB.SizeEmbedder(32)
    p = random_params(jm, j(fps), 2)
    assert_close(load_into(TB.SizeEmbedder(32), p)(t(fps), 2), jm.apply(p, j(fps), 2), ATOL)

    cap = rng.standard_normal((2, 1, 5, 16)).astype(np.float32)
    drop = np.array([1, 0], np.int32)
    jm = JB.CaptionEmbedder(in_channels=16, hidden_size=32, token_num=8)
    p = random_params(jm, j(cap), j(drop))
    tm = load_into(TB.CaptionEmbedder(16, 32, token_num=8), p)
    assert_close(tm(t(cap), t(drop)), jm.apply(p, j(cap), j(drop)), ATOL)
    assert_close(tm(t(cap)), jm.apply(p, j(cap)), ATOL)


@pytest.mark.parametrize("qk_norm", [True, False])
def test_self_attention_spatial(qk_norm):
    """(B, N, C) without RoPE: the branch that runs the fused qkv kernel."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 20, 32)).astype(np.float32)
    jm = JB.SelfAttention(32, 4, qkv_bias=True, qk_norm=qk_norm)
    p = random_params(jm, j(x))
    tm = load_into(TB.SelfAttention(32, 4, qkv_bias=True, qk_norm=qk_norm), p)
    assert_close(tm(t(x)), jm.apply(p, j(x)), ATOL)


def test_self_attention_temporal_einsum_branch_and_mask():
    """(B, T, S, C) with RoPE over T; masked keys get -1e9 (not -inf), so a row
    whose keys are all masked stays finite and uniform."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 6, 32)).astype(np.float32)
    jm = JB.SelfAttention(32, 4, qkv_bias=True, qk_norm=True, use_rope=True)
    p = random_params(jm, j(x))
    tm = load_into(TB.SelfAttention(32, 4, qkv_bias=True, qk_norm=True, use_rope=True), p)
    assert_close(tm(t(x)), jm.apply(p, j(x)), ATOL)
    mask = np.array([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0]], bool)
    out = tm(t(x), kv_mask=t(mask))
    assert torch.isfinite(out).all()
    assert_close(out, jm.apply(p, j(x), kv_mask=j(mask)), ATOL)


def test_self_attention_rope_3d_branch_and_mask():
    """(B', T, D) with RoPE: the branch the condition embedders' temporal block
    calls; with a mask the call carries a bias and takes the plain attention."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 9, 32)).astype(np.float32)
    jm = JB.SelfAttention(32, 4, qkv_bias=True, qk_norm=True, use_rope=True)
    p = random_params(jm, j(x))
    tm = load_into(TB.SelfAttention(32, 4, qkv_bias=True, qk_norm=True, use_rope=True), p)
    assert_close(tm(t(x)), jm.apply(p, j(x)), ATOL)
    mask = np.ones((4, 9), bool)
    mask[:, 6:] = False
    assert_close(tm(t(x), kv_mask=t(mask)), jm.apply(p, j(x), kv_mask=j(mask)), ATOL)


NEIGHBORS = ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0))


@pytest.mark.parametrize("jax_kernel", [False, True], ids=["jax_xla", "jax_pallas_interpret"])
def test_cross_view_attention(monkeypatch, jax_kernel):
    """No qkv bias; q/k/v projected once per camera; per-neighbour softmax, summed;
    one shared proj plus (n_nbr - 1) * bias."""
    if jax_kernel:
        monkeypatch.setenv("MDV2_FUSED_ATTN", "1")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 12, 32)).astype(np.float32)
    jm = JB.CrossViewAttention(32, 4, qkv_bias=False, qk_norm=True)
    p = random_params(jm, j(x), NEIGHBORS)
    assert "qkv_bias" not in p["params"]
    tm = load_into(TB.CrossViewAttention(32, 4, qkv_bias=False, qk_norm=True), p)
    assert tm.qkv.bias is None
    out = tm(t(x), NEIGHBORS)
    assert_close(out, jm.apply(p, j(x), NEIGHBORS), ATOL)
    # the proj bias enters n_nbr = 2 times: zeroing it moves the output by 2 * bias
    bias = tm.proj.bias.detach().clone()
    tm.proj.bias.data.zero_()
    np.testing.assert_allclose((out - tm(t(x), NEIGHBORS)).detach().numpy(),
                               np.broadcast_to(2 * bias.numpy(), out.shape), atol=1e-6)


def test_cross_attention():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 30, 32)).astype(np.float32)
    cond = rng.standard_normal((2, 7, 32)).astype(np.float32)
    jm = JB.CrossAttention(32, 4)
    p = random_params(jm, j(x), j(cond))
    tm = load_into(TB.CrossAttention(32, 4), p)
    assert_close(tm(t(x), t(cond)), jm.apply(p, j(x), j(cond)), ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_t2i_final_layer_and_mask_select(masked):
    rng = np.random.default_rng(10)
    B, T, S, C = 2, 3, 4, 32
    x = rng.standard_normal((B, T * S, C)).astype(np.float32)
    tt = rng.standard_normal((B, C)).astype(np.float32)
    t0 = rng.standard_normal((B, C)).astype(np.float32)
    xm = np.array([[1, 0, 1], [0, 1, 1]], bool)
    jm = JB.T2IFinalLayer(C, 4, 8)
    p = random_params(jm, j(x), j(tt))
    tm = load_into(TB.T2IFinalLayer(C, 4, 8), p)
    if masked:
        assert_close(tm(t(x), t(tt), t(xm), t(t0), T, S),
                     jm.apply(p, j(x), j(tt), j(xm), j(t0), T, S), ATOL)
        y = rng.standard_normal((B, T * S, C)).astype(np.float32)
        assert_close(TB.t_mask_select(t(xm), t(x), t(y), T, S),
                     JB.t_mask_select(j(xm), j(x), j(y), T, S), 0.0)
    else:
        assert_close(tm(t(x), t(tt)), jm.apply(p, j(x), j(tt)), ATOL)


def _shared_kv(rng, cross, qk_norm=True, qkv_bias=True):
    x = rng.standard_normal((2, 10, 32)).astype(np.float32)
    args = (x, rng.standard_normal((2, 7, 32)).astype(np.float32)) if cross else (x,)
    return (JB.SharedKVAttention(32, 4, qkv_bias=qkv_bias, qk_norm=qk_norm),
            TB.SharedKVAttention(32, 4, qkv_bias=qkv_bias, qk_norm=qk_norm), args, {})


def _label(rng, dropped):
    labels = np.array([0, 4, 2, 6], np.int32)
    kw = {"force_drop_ids": np.array([1, 0, 0, 1], np.int32)} if dropped else {}
    prob = 0.1 if dropped else 0.0
    return (JB.LabelEmbedder(7, 32, dropout_prob=prob), TB.LabelEmbedder(7, 32, prob),
            (labels,), kw)


def _final(rng):
    x = rng.standard_normal((2, 12, 32)).astype(np.float32) * 3 + 0.5
    return JB.FinalLayer(32, 4, 8), TB.FinalLayer(32, 4, 8), (x,), {}


@pytest.mark.parametrize("case", [
    "shared_kv_self", "shared_kv_cond", "shared_kv_no_bias_no_norm", "label", "label_dropped",
    "final"])
def test_blocks_no_config_builds(case):
    """SharedKVAttention (q from x, k/v from cond through one qkv), LabelEmbedder
    (the null row chosen by force_drop_ids) and FinalLayer (LayerNorm + linear):
    weights through from_jax_params + load_state_dict(strict=True)."""
    rng = np.random.default_rng(11)
    jm, tm, args, kw = {
        "shared_kv_self": lambda: _shared_kv(rng, False),
        "shared_kv_cond": lambda: _shared_kv(rng, True),
        "shared_kv_no_bias_no_norm": lambda: _shared_kv(rng, True, False, False),
        "label": lambda: _label(rng, False),
        "label_dropped": lambda: _label(rng, True),
        "final": lambda: _final(rng)}[case]()
    p = random_params(jm, *map(j, args), **{k: j(v) for k, v in kw.items()})
    tm = load_into(tm, p)
    out = tm(*map(t, args), **{k: t(v) for k, v in kw.items()})
    assert_close(out, jm.apply(p, *map(j, args), **{k: j(v) for k, v in kw.items()}), ATOL)
    if case == "label_dropped":  # the null row: index num_classes of the table
        assert tm.embedding_table.weight.shape == (8, 32)
        np.testing.assert_array_equal(out[0].detach().numpy(),
                                      tm.embedding_table.weight[7].detach().numpy())
    if case == "shared_kv_self":  # without cond, k/v come from x
        assert_close(tm(t(args[0]), t(args[0])), out.detach().numpy(), 0.0)
