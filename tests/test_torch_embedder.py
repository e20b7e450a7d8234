"""PyTorch port, condition embedders: every module ``encode_conditions`` reaches
under the XL/2 preset, against its flax counterpart on the CPU, fp32, weights
through ``from_jax_params`` + ``load_state_dict(strict=True)``, every leaf random.

Tolerance 2e-5 absolute (two fp32 GEMM / convolution implementations); the
Fourier features of coordinates up to ~30 at frequency 8 lose a few more bits in
sin/cos argument reduction, stated where it applies.
"""
import numpy as np
import pytest

from test_torch_common import assert_close, j, load_into, random_params, t

from magicdrive_v2_tpu.models.magicdrive import embedder as JE
from magicdrive_v2_tpu_torch.models.magicdrive import embedder as TE

ATOL = 2e-5


def test_fourier_embed_and_cog_temp_down():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 4, 3)).astype(np.float32)
    for log in (True, False):
        assert_close(TE.fourier_embed(t(x), 4, True, log), JE.fourier_embed(j(x), 4, True, log),
                     2e-6)
    assert TE.fourier_out_dim(3, 4) == JE.fourier_out_dim(3, 4) == 27
    for T in (1, 2, 5, 8, 9, 17):
        y = rng.standard_normal((2, T, 3, 4)).astype(np.float32)
        assert_close(TE.cog_temp_down(t(y)), JE.cog_temp_down(j(y)), 1e-7)
    y = rng.standard_normal((2, 17, 3, 4)).astype(np.float32)
    valid = np.ones((2, 17), bool)
    valid[1, 9:] = False
    for factor in (-1, 4.5, 0):
        jd, td = JE.make_time_downsampler(factor), TE.make_time_downsampler(factor)
        assert_close(td(t(y)), jd(j(y)), 1e-6)
        assert_close(td(t(y), valid=t(valid)), jd(j(y), valid=j(valid)), 1e-6)
    assert TE.make_time_downsampler(4.5)(t(y)).shape[1] == 5
    assert_close(TE.normalizer("all-xyz", t(x)), JE.normalizer("all-xyz", j(x)), 1e-6)


@pytest.mark.parametrize("table", [True, False])
def test_temporal_transformer_block(table):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 9, 32)).astype(np.float32)
    jm = JE.TemporalTransformerBlock(32, num_heads=4, qk_norm=True,
                                     use_scale_shift_table=table)
    p = random_params(jm, j(x))
    tm = load_into(TE.TemporalTransformerBlock(32, num_heads=4, qk_norm=True,
                                               use_scale_shift_table=table), p)
    assert_close(tm(t(x)), jm.apply(p, j(x)), ATOL)
    mask = np.ones((6, 9), bool)
    mask[:3, 5:] = False
    assert_close(tm(t(x), kv_mask=t(mask)), jm.apply(p, j(x), kv_mask=j(mask)), ATOL)


def _box_inputs(rng, B, T, N, dim):
    return dict(
        bboxes=(rng.standard_normal((B, T, N, 8, 3)) * 10).astype(np.float32),
        classes=rng.integers(0, 10, (B, T, N)).astype(np.int32),
        null_mask=rng.integers(0, 2, (B, T, N)).astype(np.float32),
        mask=rng.integers(0, 2, (B, T, N)).astype(np.float32),
        box_latent=rng.standard_normal((B, T, N, dim)).astype(np.float32))


BOX_KW = dict(n_classes=10, class_token_dim=32, embedder_num_freq=4,
              proj_dims=(32, 16, 16, 32), mode="all-xyz", minmax_normalize=False,
              after_proj=True, sample_id=True)


def test_bbox_embedder_base():
    rng = np.random.default_rng(2)
    inp = _box_inputs(rng, 3, 1, 5, 32)
    args = [inp[k][:, 0] for k in ("bboxes", "classes", "null_mask", "mask", "box_latent")]
    kw = dict(BOX_KW, minmax_normalize=True)
    jm = JE.ContinuousBBoxWithTextEmbedding(**kw)
    p = random_params(jm, *[j(a) for a in args])
    tm = load_into(TE.ContinuousBBoxWithTextEmbedding(**kw), p)
    targs = [t(a) for a in args]
    targs[1] = targs[1].long()
    assert_close(tm(*targs), jm.apply(p, *[j(a) for a in args]), ATOL)


@pytest.mark.parametrize("with_valid", [False, True])
def test_bbox_temp_embedder(with_valid):
    rng = np.random.default_rng(3)
    B, T, N = 2, 9, 4
    inp = _box_inputs(rng, B, T, N, 32)
    kw = dict(BOX_KW, num_heads=4, qk_norm=True, use_scale_shift_table=True,
              time_downsample_factor=4.5)
    jm = JE.ContinuousBBoxWithTextTempEmbedding(**kw)
    names = ("bboxes", "classes", "null_mask", "mask", "box_latent")
    p = random_params(jm, *[j(inp[k]) for k in names])
    assert "temp" in p["params"] and "final_proj" in p["params"]
    tm = load_into(TE.ContinuousBBoxWithTextTempEmbedding(**kw), p)
    targs = [t(inp[k]) for k in names]
    targs[1] = targs[1].long()
    extra_j, extra_t = {}, {}
    if with_valid:
        valid = np.ones((B, T), bool)
        valid[1, 5:] = False
        extra_j, extra_t = dict(frame_valid=j(valid)), dict(frame_valid=t(valid))
    out = tm(*targs, **extra_t)
    assert out.shape == (B, 3, N, 32)
    # coordinates up to ~40 at Fourier frequency 8: sin/cos argument reduction
    # differs between the two libraries by a few ulp of the argument
    assert_close(out, jm.apply(p, *[j(inp[k]) for k in names], **extra_j), 1e-4)


def test_cam_embedder_and_mask():
    rng = np.random.default_rng(4)
    param = rng.standard_normal((5, 3, 7)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    jm = JE.CamEmbedder(input_dim=3, out_dim=32, num=7, after_proj=True)
    p = random_params(jm, j(param), j(mask))
    tm = load_into(TE.CamEmbedder(input_dim=3, out_dim=32, num=7, after_proj=True), p)
    assert_close(tm(t(param), t(mask)), jm.apply(p, j(param), j(mask)), ATOL)
    tok, emb = tm.embed_cam(t(param), t(mask))
    jtok, jemb = jm.apply(p, j(param), j(mask), method=JE.CamEmbedder.embed_cam)
    assert_close(emb, jemb, 1e-5)


@pytest.mark.parametrize("with_valid", [False, True])
def test_cam_embedder_temp(with_valid):
    rng = np.random.default_rng(5)
    b, T, S = 3, 9, 1
    param = rng.standard_normal((b * T * S, 4, 4)).astype(np.float32)  # 4 rows: last dropped
    mask = rng.integers(0, 2, (b * T * S,)).astype(np.float32)
    kw = dict(input_dim=3, out_dim=32, num=4, after_proj=True, num_heads=4, qk_norm=True,
              use_scale_shift_table=True, time_downsample_factor=4.5)
    jm = JE.CamEmbedderTemp(**kw)
    ekw_j, ekw_t = dict(T=T, S=S), dict(T=T, S=S)
    if with_valid:
        valid = np.ones((b, T), bool)
        valid[0, 5:] = False
        ekw_j["frame_valid"], ekw_t["frame_valid"] = j(valid), t(valid)
    p = random_params(jm, j(param), j(mask), T=T, S=S, method=JE.CamEmbedderTemp.embed_cam)
    tm = load_into(TE.CamEmbedderTemp(**kw), p)
    tok, _ = tm.embed_cam(t(param), t(mask), **ekw_t)
    jtok, _ = jm.apply(p, j(param), j(mask), method=JE.CamEmbedderTemp.embed_cam, **ekw_j)
    assert tok.shape == (b, 3, S, 32)
    assert_close(tok, jtok, ATOL)


def test_map_control_embedding():
    rng = np.random.default_rng(6)
    x = rng.random((2, 8, 40, 40)).astype(np.float32)
    kw = dict(conditioning_embedding_channels=16, conditioning_size=(8, 40, 40),
              block_out_channels=(4, 8, 12, 16))
    jm = JE.MapControlEmbedding(**kw)
    p = random_params(jm, j(x))
    tm = load_into(TE.MapControlEmbedding(**kw), p)
    out = tm(t(x))
    assert_close(out, jm.apply(p, j(x)), ATOL)


def test_causal_conv3d_and_cog_downsample():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 5, 7, 9)).astype(np.float32)
    for stride in (1, 2):
        jm = JE.CausalConv3d(10, (3, 3, 3), time_stride=stride)
        p = random_params(jm, j(x))
        tm = load_into(TE.CausalConv3d(6, 10, (3, 3, 3), time_stride=stride), p)
        assert_close(tm(t(x)), jm.apply(p, j(x)), ATOL)
    for compress in (True, False):
        jm = JE.CogDownsample3D(10, stride=1, compress_time=compress)
        p = random_params(jm, j(x))
        tm = load_into(TE.CogDownsample3D(6, 10, stride=1, compress_time=compress), p)
        assert_close(tm(t(x)), jm.apply(p, j(x)), ATOL)


@pytest.mark.parametrize("factor,T_in,T_out", [(4.5, 9, 3), (4, 9, 3), (1, 5, 5)])
def test_map_control_temp_embedding(factor, T_in, T_out):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 8, T_in, 6, 6)).astype(np.float32)
    jm = JE.MapControlTempEmbedding(16, factor)
    p = random_params(jm, j(x))
    tm = load_into(TE.MapControlTempEmbedding(16, factor), p)
    out = tm(t(x))
    assert out.shape[2] == T_out
    assert_close(out, jm.apply(p, j(x)), ATOL)
