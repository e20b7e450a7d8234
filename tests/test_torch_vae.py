"""PyTorch port, the CogVideoX VAE (``models/vae/cogvideox.py``) against the JAX
package's on the CPU, at the tiny size of the JAX package's VAE tests
(block_out_channels (8, 8, 8, 16), latent 4, one layer per block, 4 groups).

Weights: every flax leaf random (GroupNorm scales around 1), carried by
``from_jax_params`` and loaded with ``strict=True``. Inputs: numpy, seeded.
Tolerances (fp32): 2e-5 absolute on moments and frames of order 1 (the same
arithmetic in another summation order through ~20 convolutions); the bf16 case
is stated at its test. The JAX side runs under ``jax.jit`` (one compile per
program instead of one per operation).
"""
import importlib.util
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import assert_close, fill_tree, j, np_tree

from magicdrive_v2_tpu.models.vae.cogvideox import (AutoencoderKLCogVideoX as JVAE,
                                                    CogVAEConfig as JCfg,
                                                    DiagonalGaussian as JGauss,
                                                    VideoAutoencoderKLCogVideoX as JWrap)
from magicdrive_v2_tpu.utils.ckpt import export_torch_state_dict
from magicdrive_v2_tpu_torch.models.vae.cogvideox import (CogVAEConfig, DiagonalGaussian,
                                                          VideoAutoencoderKLCogVideoX)
from magicdrive_v2_tpu_torch.utils.ckpt import (from_jax_params, init_weights,
                                                load_state_dict_cast, load_torch_file,
                                                resolve_pretrained_dir)

TINY = dict(block_out_channels=(8, 8, 8, 16), latent_channels=4, layers_per_block=1,
            norm_num_groups=4)
TOL = 2e-5


def _vae_params(cfg, seed=0):
    module = JVAE(cfg)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 3, 1, 16, 16))))
    tree = fill_tree(shapes, seed, std=0.1)
    # GroupNorm scales around 1, so every layer passes its input on at full size
    return jax.tree_util.tree_map_with_path(
        lambda p, v: v + 1.0 if getattr(p[-1], "key", "") == "scale" else v, tree)


def _wrappers(params, dtype=torch.float32, **kw):
    """(JAX wrapper, port wrapper) over the same weights."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jw = JWrap(JCfg(**TINY, dtype=jdt), **kw)
    jw.params = params
    tw = VideoAutoencoderKLCogVideoX(CogVAEConfig(**TINY, dtype=dtype), device="cpu", **kw)
    load_state_dict_cast(tw.module, from_jax_params(np_tree(params)), strict=True)
    return jw, tw


def _write_safetensors(path, sd):
    """``sd`` as a .safetensors file, written by hand: an 8-byte little-endian
    header length, the JSON header (padded to 8 bytes), then each tensor's raw
    little-endian bytes (bf16 through its int16 view)."""
    kinds = {torch.float32: ("F32", torch.int32), torch.bfloat16: ("BF16", torch.int16)}
    header, blobs, pos = {"__metadata__": {"format": "pt"}}, [], 0
    for k, v in sd.items():
        kind, bits = kinds[v.dtype]
        blob = v.contiguous().view(bits).numpy().tobytes()
        header[k] = {"dtype": kind, "shape": list(v.shape), "data_offsets": [pos, pos + len(blob)]}
        blobs.append(blob)
        pos += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.fixture(scope="module")
def params():
    return _vae_params(JCfg(**TINY))


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_converter_equals_the_jax_exporter(params):
    ours, theirs = from_jax_params(np_tree(params)), export_torch_state_dict(params)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert "decoder.up_blocks.0.resnets.1.norm2.norm_layer.weight" in ours
    assert ours["encoder.down_blocks.0.downsamplers.0.conv.weight"].shape == (8, 8, 3, 3)
    assert ours["decoder.conv_in.conv.weight"].shape == (16, 4, 3, 3, 3)


@pytest.mark.parametrize("micro_frame_size", [None, 8])
def test_encoder_moments_match(params, micro_frame_size):
    """Full sequence, and 17 frames streamed through the encoder as 9 + 8."""
    jw, tw = _wrappers(params, micro_frame_size=micro_frame_size)
    x = _randn(1, 1, 3, 17, 16, 24)
    out = tw.encode_moments_seq(torch.from_numpy(x))
    assert out.shape == (1, 8, 5, 2, 3)
    assert_close(out, jax.jit(jw.encode_moments_seq)(j(x)), TOL)


def test_full_sequence_decode_matches(params):
    jw, tw = _wrappers(params)
    z = _randn(2, 1, 4, 3, 4, 5)
    out = tw.decode(torch.from_numpy(z), frame_batching=False)
    assert out.shape == (1, 3, 9, 32, 40)
    assert_close(out, jax.jit(lambda v: jw.decode(v, frame_batching=False))(j(z)), TOL)


def test_streaming_decode_matches_at_five_latent_frames(params):
    """T'=5 streams as 3 + 2 latent frames with the conv caches carried; per-chunk
    GroupNorm statistics make it differ from the full-sequence decode."""
    jw, tw = _wrappers(params)
    z = torch.from_numpy(_randn(3, 1, 4, 5, 4, 5))
    out = tw.decode(z)
    assert out.shape == (1, 3, 17, 32, 40)
    assert_close(out, jax.jit(jw.decode)(j(z.numpy())), TOL)
    assert float((out - tw.decode(z, frame_batching=False)).abs().max()) > 1e-3


def test_micro_batched_decode_keeps_views_apart(params):
    """Two different views one at a time: each view's caches start fresh, so each
    equals its own decode alone and the JAX decode (views are independent, so the
    JAX side decodes both in one program)."""
    jw, tw = _wrappers(params, micro_batch_size=1)
    z = torch.from_numpy(_randn(4, 2, 4, 5, 4, 5))
    out = tw.decode(z)
    assert_close(out, jax.jit(jw.decode)(j(z.numpy())), TOL)
    for v in range(2):
        np.testing.assert_array_equal(out[v:v + 1].numpy(), tw.decode(z[v:v + 1]).numpy())
    assert float((out[0] - out[1]).abs().max()) > 1e-2


def test_tiled_decode_and_encode_match(params):
    """2x2 tiles of 32 pixels (4 latents) at a stride of 3 latents: both blends
    and the crop of the short last tiles run."""
    tiling = dict(tile_sample_min_height=32, tile_sample_min_width=32,
                  tile_overlap_factor_height=1 / 4, tile_overlap_factor_width=1 / 4)
    jw, tw = _wrappers(params, tiling=tiling)
    z = _randn(5, 1, 4, 1, 5, 5)
    out = tw.decode(torch.from_numpy(z))
    assert out.shape == (1, 3, 1, 40, 40)
    assert_close(out, jax.jit(jw.decode)(j(z)), TOL)
    x = _randn(6, 1, 3, 1, 48, 48)
    moments = tw.encode_moments_seq(torch.from_numpy(x))
    tiled = tw._encode_dispatch(torch.from_numpy(x))  # above the tile size: tiles
    assert tiled.shape == moments.shape == (1, 8, 1, 6, 6)
    assert float((tiled - moments).abs().max()) > 1e-3
    assert_close(tiled, jax.jit(lambda v: jw.tiled_encode_moments(v, **tiling))(j(x)), TOL)


def test_diagonal_gaussian_sample_with_injected_noise(params):
    moments = _randn(7, 1, 8, 3, 4, 5)
    noise = _randn(8, 1, 4, 3, 4, 5)
    jd = JGauss(j(moments), axis=1)
    td = DiagonalGaussian(torch.from_numpy(moments), dim=1)
    assert_close(td.sample(noise=torch.from_numpy(noise)),
                 np.asarray(jd.mean) + np.asarray(jd.std) * noise, 1e-6)
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    a = td.sample(torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.numpy(), td.sample(torch.Generator().manual_seed(3)).numpy())
    # encode with an injected posterior draw, scaled
    _, tw = _wrappers(params)
    x = torch.from_numpy(_randn(9, 1, 3, 9, 16, 24))
    z = tw.encode(x, noise=torch.from_numpy(_randn(10, 1, 4, 3, 2, 3)))
    want = DiagonalGaussian(tw.encode_moments_seq(x)).sample(
        noise=torch.from_numpy(_randn(10, 1, 4, 3, 2, 3))) * tw.scaling_factor
    np.testing.assert_array_equal(z.numpy(), want.numpy())


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_load_pretrained_from_a_snapshot(params, tmp_path, fmt):
    """A diffusers-layout snapshot (config.json + weights) rebuilds the config and
    loads every parameter; the .safetensors file is stored in bf16."""
    _, tw = _wrappers(params)
    d = tmp_path / "vae"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(
        dict(TINY, block_out_channels=list(TINY["block_out_channels"]), scaling_factor=0.7,
             in_channels=3, out_channels=3, _class_name="AutoencoderKLCogVideoX")))
    sd = tw.module.state_dict()
    if fmt == "bin":
        torch.save(sd, d / "diffusion_pytorch_model.bin")
    else:
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
        _write_safetensors(d / "diffusion_pytorch_model.safetensors", sd)
    start = CogVAEConfig(**dict(TINY, block_out_channels=(8, 8, 8, 8)))
    vae = VideoAutoencoderKLCogVideoX(start, from_pretrained=str(tmp_path), subfolder="vae",
                                      device="cpu").load_pretrained()
    assert vae.cfg == CogVAEConfig(**TINY, scaling_factor=0.7)
    assert vae.scaling_factor == pytest.approx(0.7) and vae.out_channels == 4
    got = vae.module.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v.float().numpy(), err_msg=k)
    with pytest.raises(FileNotFoundError):
        VideoAutoencoderKLCogVideoX(start, from_pretrained=str(tmp_path / "nowhere"),
                                    device="cpu").load_pretrained()


def test_sharded_snapshots_and_wrapped_checkpoints(params, tmp_path):
    """An index of safetensors shards merges every shard; a torch file with a
    "state_dict" entry is unwrapped. Where the safetensors package is installed,
    it reads the hand-written shards to the same tensors."""
    sd = _wrappers(params)[1].module.state_dict()
    keys = sorted(sd)
    halves = {"a.safetensors": keys[::2], "b.safetensors": keys[1::2]}
    for name, ks in halves.items():
        _write_safetensors(tmp_path / name, {k: sd[k] for k in ks})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: n for n, ks in halves.items() for k in ks}}))
    cfg, merged = resolve_pretrained_dir(str(tmp_path))
    assert cfg is None and sorted(merged) == keys
    for k in keys:
        np.testing.assert_array_equal(merged[k].numpy(), sd[k].numpy(), err_msg=k)
    if importlib.util.find_spec("safetensors") is not None:
        from safetensors.torch import load_file
        theirs = load_file(str(tmp_path / "a.safetensors"))
        assert sorted(theirs) == keys[::2]
        for k in keys[::2]:
            assert torch.equal(theirs[k], merged[k]), k
    torch.save({"state_dict": {"w": torch.arange(3.0)}}, tmp_path / "ckpt.pt")
    np.testing.assert_array_equal(load_torch_file(str(tmp_path / "ckpt.pt"))["w"], [0, 1, 2])


def test_init_weights_fills_the_vae_seeded():
    """Seeded normal values everywhere; GroupNorm weights centre on 1."""
    a, b = (VideoAutoencoderKLCogVideoX(CogVAEConfig(**TINY), device="cpu") for _ in range(2))
    sa = init_weights(a.module, seed=4).state_dict()
    sb = init_weights(b.module, seed=4).state_dict()
    for k in sa:
        np.testing.assert_array_equal(sa[k].numpy(), sb[k].numpy(), err_msg=k)
    gn = sa["decoder.up_blocks.1.resnets.0.norm1.norm_layer.weight"]
    assert abs(float(gn.mean()) - 1) < 0.05 and float(gn.std()) > 0.005
    conv = sa["decoder.up_blocks.1.resnets.0.conv1.conv.weight"]
    assert abs(float(conv.std()) - 0.02) < 0.003 and abs(float(conv.mean())) < 0.003


def test_bf16_cast_points_match_the_jax_module(params):
    """Convolutions in bf16 from bf16 weights, GroupNorm in fp32 from fp32
    parameters rounded once, SiLU and residual adds in bf16, on both sides. Two
    bf16 decodes cannot agree to an ulp here: each rounds ~20 layers on its own
    (flax adds a conv's bias after rounding its output, torch before), and JAX's
    own eager and jitted bf16 decodes of this input differ by up to 0.047. So the
    limits are: rms(port - JAX) <= 2**-5 * rms(JAX) (measured ~2**-6), and the
    port's bf16 decode no further from the fp32 decode than JAX's bf16 decode is
    (rms, 1.25x headroom)."""
    jw, tw = _wrappers(params, dtype=torch.bfloat16)
    assert tw.module.decoder.conv_in.conv.weight.dtype == torch.bfloat16
    assert tw.module.decoder.mid_block.resnets[0].norm1.norm_layer.weight.dtype == torch.float32
    z = _randn(11, 1, 4, 5, 4, 5)
    out = tw.decode(torch.from_numpy(z).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jax.jit(jw.decode)(j(z).astype(jnp.bfloat16)).astype(jnp.float32))
    f32 = _wrappers(params)[1].decode(torch.from_numpy(z)).numpy()

    def rms(a):
        return float(np.sqrt((a ** 2).mean()))

    assert rms(out.float().numpy() - ref) <= 2 ** -5 * rms(ref)
    assert rms(out.float().numpy() - f32) <= 1.25 * rms(ref - f32)
