"""PyTorch port, the BrushNet inpainting models against the JAX package on the CPU,
fp32: the structured noise, the antialiased linear resize, the ShallowEncoder, the
converter for both BrushNet trees, and the BrushNet and SDE-BrushNet forwards at
the tiny flagship config (hidden 64, depth 2 / control depth 1, the JAX package's
tests/test_brushnet.py sizes: 9 frames of 32x40, latents 3x4x5), weights through
``from_jax_params`` + ``load_state_dict(strict=True)`` with every leaf random.

Tolerances: structured noise 1e-5 (two FFTs and a standardisation of unit-scale
values in fp32); resize 1e-6 (sums of at most a few hundred fp32 products of
weights <= 1); ShallowEncoder 2e-5 (four fp32 convolutions summed in another
order); model forwards 1e-4 as the base model's (fp32 rounding through ~20
blocks of GEMMs).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_common import assert_close, j, load_into, np_tree, random_params, t, tiny_configs

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.models.magicdrive import brushnet as JB
from magicdrive_v2_tpu.ops.structured_noise import _radial_mask as j_radial_mask
from magicdrive_v2_tpu.ops.structured_noise import generate_structured_noise as j_noise
from magicdrive_v2_tpu.ops.structured_noise import sample_cutoff_radius as j_cutoff
from magicdrive_v2_tpu.utils.ckpt import export_torch_state_dict
from magicdrive_v2_tpu_torch.models.magicdrive import brushnet as TB
from magicdrive_v2_tpu_torch.ops.resize import resize_linear_antialiased
from magicdrive_v2_tpu_torch.ops.structured_noise import _radial_mask as t_radial_mask
from magicdrive_v2_tpu_torch.ops.structured_noise import generate_structured_noise as t_noise
from magicdrive_v2_tpu_torch.ops.structured_noise import sample_cutoff_radius as t_cutoff
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params

ATOL = 1e-4
NF, HH, WW = 9, 32, 40
LAT = (3, 4, 5)


def brush_configs(sde, **replace):
    """(JAX, port) BrushNet configs of the tiny flagship (``replace`` as
    ``tiny_configs`` takes it)."""
    jcfg, tcfg = tiny_configs(**replace)
    jb = JB.BrushNetConfig(**{**dataclasses.asdict(jcfg), "sde_inpaint": sde,
                              "grad_checkpoint": False})
    return jb, TB.BrushNetConfig.from_base(tcfg, sde_inpaint=sde)


def inpaint_inputs(nc, seed=0, frame_valid=None, hw=(HH, WW)):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((1, 3 * nc, NF) + tuple(hw)).astype(np.float32)
    mi = rng.integers(0, 2, (1, nc, NF) + tuple(hw)).astype(np.float32)
    if frame_valid is not None:  # pad frames are zero (the JAX model's contract)
        xi[:, :, ~frame_valid[0]] = 0
        mi[:, :, ~frame_valid[0]] = 0
    return xi, mi


def tree(v, conv):
    if isinstance(v, dict):
        return {k: tree(x, conv) for k, x in v.items()}
    return conv(v) if isinstance(v, np.ndarray) else v


_MODELS = {}


def models(sde):
    """(JAX cfg, port cfg, JAX model, params, port model, batch), one per variant
    and test module."""
    if sde not in _MODELS:
        jcfg, tcfg = brush_configs(sde)
        batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=8, map_size=(8, 40, 40))
        batch["x_inpaint"], batch["mask_inpaint"] = inpaint_inputs(tcfg.nc)
        if sde:
            batch["t_inpaint"] = np.full((1,), 300.0, np.float32)
        jmodel = JB.MagicDriveSTDiT3BrushNet(jcfg)
        extra = {"rngs_key": jax.random.PRNGKey(0)} if sde else {}
        params = random_params(jmodel, **tree(batch, j), **extra)
        tmodel = load_into(TB.MagicDriveSTDiT3BrushNet(tcfg), params,
                           control_depth=tcfg.control_depth)
        _MODELS[sde] = (jcfg, tcfg, jmodel, params, tmodel, batch)
    return _MODELS[sde]


def input_noise(key, tcfg, b):
    """The standard normal draw the JAX model makes from ``rngs_key`` for a batch
    of b: shape (b*NC*C*T', H', W')."""
    shape = (b * tcfg.nc * tcfg.in_channels * LAT[0],) + LAT[1:]
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


@pytest.mark.parametrize("shape,r0,width", [((12, 5, 8, 10), 4.0, 2.0),
                                            ((3, 53, 100), 4.0, 2.0),
                                            ((2, 7, 16), 6.5, 0.5)])
def test_structured_noise_matches_jax(shape, r0, width):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
    n = rng.standard_normal(shape).astype(np.float32)
    ref = j_noise(j(x), cutoff_radius=r0, transition_width=width, input_noise=j(n))
    out = t_noise(t(x), cutoff_radius=r0, transition_width=width, input_noise=t(n))
    assert out.dtype == torch.float32
    assert_close(out, ref, 1e-5)
    # unit population std per slice (torch.std's default would be the sample std)
    np.testing.assert_allclose(out.std(dim=(-2, -1), correction=0).numpy(), 1.0, atol=1e-5)
    assert_close(t_radial_mask(shape[-2], shape[-1], r0, width),
                 j_radial_mask(shape[-2], shape[-1], r0, width), 1e-6)
    # a generator draws the input noise when none is given
    g = torch.Generator().manual_seed(0)
    drawn = t_noise(t(x), g, cutoff_radius=r0, transition_width=width)
    g.manual_seed(0)
    np.testing.assert_array_equal(drawn.numpy(), t_noise(
        t(x), cutoff_radius=r0, transition_width=width,
        input_noise=torch.randn(shape, generator=g)).numpy())


def test_sample_cutoff_radius_is_the_jax_rule():
    """r = r0 + Exp(lam) by inverting a uniform draw on [1e-8, 1): JAX's from its
    key, the port's from a generator."""
    key = jax.random.PRNGKey(3)
    u = float(jax.random.uniform(key, (), minval=1e-8, maxval=1.0))
    np.testing.assert_allclose(float(j_cutoff(key, 4.0, 0.1)), 4.0 - np.log(u) / 0.1,
                               rtol=1e-6)
    g = torch.Generator().manual_seed(3)
    r = float(t_cutoff(g, 4.0, 0.1))
    g.manual_seed(3)
    u = float(torch.rand((), generator=g)) * (1 - 1e-8) + 1e-8
    np.testing.assert_allclose(r, 4.0 - np.log(u) / 0.1, rtol=1e-6)
    assert r > 4.0


@pytest.mark.parametrize("src,dst", [((1, 1, 9, 32, 40), (1, 1, 3, 4, 5)),
                                     ((2, 1, 17, 64, 80), (2, 1, 5, 8, 10)),
                                     ((1, 2, 3, 4, 5), (1, 2, 9, 32, 40)),
                                     ((2, 5, 10, 3), (2, 2, 20, 3)),
                                     ((1, 1, 17, 424, 800), (1, 1, 5, 53, 100))])
def test_antialiased_resize_matches_jax_image_resize(src, dst):
    """Downsampling (the model's 4x in time, 8x in space), upsampling and both on
    one tensor, against jax.image.resize(..., "trilinear") (antialias on)."""
    x = np.random.default_rng(2).random(src).astype(np.float32)
    ref = jax.image.resize(j(x), dst, method="trilinear")
    assert_close(resize_linear_antialiased(t(x), dst), ref, 1e-6)
    if src == (1, 1, 9, 32, 40):  # the rule the port replaces torch's with
        plain = torch.nn.functional.interpolate(t(x), size=dst[2:], mode="trilinear")
        assert float((plain - t(np.asarray(ref))).abs().max()) > 0.05


def test_shallow_encoder_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, NF, HH, WW)).astype(np.float32)
    jenc = JB.ShallowEncoder(out_channels=16)
    params = random_params(jenc, j(x))
    tenc = load_into(TB.ShallowEncoder(out_channels=16), params)
    with torch.no_grad():
        out = tenc(t(x))
    assert out.shape == (2, 16) + LAT
    assert_close(out, jenc.apply(params, j(x)), 2e-5)


@pytest.mark.parametrize("sde", [False, True], ids=["brushnet", "sde"])
def test_from_jax_params_equals_export_for_brushnet_trees(sde):
    """The port's converter gives the JAX package's keys and arrays for both
    BrushNet trees, and they load strictly (done by ``models``)."""
    _, tcfg, _, params, tmodel, _ = models(sde)
    mine = from_jax_params(np_tree(params), tcfg.control_depth)
    theirs = export_torch_state_dict(np_tree(params), tcfg.control_depth)
    assert set(mine) == set(theirs) == set(tmodel.state_dict())
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    for name in ("brushnet_blocks_s.1.after_proj.weight", "brushnet_blocks_t.0.attn.qkv.weight",
                 "shallow_encoder.temporal_conv.weight", "x_brushnet_embedder.proj.weight",
                 "control_blocks_t.0.after_proj.bias", "base_blocks_s.1.cross_attn.q_linear.weight"):
        assert name in mine, name
    assert ("t_inpaint_block.1.weight" in mine) == ("t_combine_block.1.weight" in mine) == sde
    assert "brushnet_blocks_s.0.cross_attn.q_linear.weight" not in mine


@pytest.mark.parametrize("case", ["plain", "x_mask", "frame_valid", "cond_cache"])
@pytest.mark.parametrize("sde", [False, True], ids=["brushnet", "sde"])
def test_brushnet_forward_matches(sde, case):
    """Both variants: no frame mask; a frame mask (the t0 modulations, and for the
    SDE model the t0 path of its combined timestep); a clip padded with
    ``frame_valid`` (zero inpaint frames in the pad); conditions from
    ``encode_conditions`` passed as ``cond_cache``. The SDE noise is the draw the
    JAX model makes from its key, handed to the port."""
    jcfg, tcfg, jmodel, params, tmodel, batch = models(sde)
    jkw, tkw = {}, {}
    batch = dict(batch)
    if case == "x_mask":
        xm = np.array([[True, False, True]])
        jkw["x_mask"], tkw["x_mask"] = j(xm), t(xm)
    if case == "frame_valid":
        fv = np.ones((1, NF), bool)
        fv[:, 5:] = False
        batch["x_inpaint"], batch["mask_inpaint"] = inpaint_inputs(tcfg.nc, frame_valid=fv)
        jkw["frame_valid"], tkw["frame_valid"] = j(fv), t(fv)
    if sde:
        key = jax.random.PRNGKey(5)
        jkw["rngs_key"] = key
        tkw["inpaint_input_noise"] = t(input_noise(key, tcfg, 1))
    jb, tb = tree(batch, j), tree(batch, t)
    if case == "cond_cache":
        shape = tuple(batch["x"].shape)
        jkw["cond_cache"] = jmodel.apply(params, shape, jb["y"], jb["maps"], jb["bbox"],
                                         jb["cams"], jb["rel_pos"],
                                         method=JB.MagicDriveSTDiT3BrushNet.encode_conditions)
        with torch.no_grad():
            tkw["cond_cache"] = tmodel.encode_conditions(shape, tb["y"], tb["maps"], tb["bbox"],
                                                         tb["cams"], tb["rel_pos"])
    ref = jmodel.apply(params, **jb, **jkw)
    with torch.no_grad():
        out = tmodel(**tb, **tkw)
        assert out.dtype == torch.float32 and out.shape == batch["x"].shape
        assert_close(out, ref, ATOL)
        if case == "cond_cache":  # the cache changes nothing
            uncached = {k: v for k, v in tkw.items() if k != "cond_cache"}
            np.testing.assert_allclose(out.numpy(), tmodel(**tb, **uncached).numpy(),
                                       atol=1e-6)


@pytest.mark.parametrize("sde", [False, True], ids=["brushnet", "sde"])
def test_the_inpaint_branch_is_live(sde):
    """Another mask, other inpaint frames and (SDE) another inpaint timestep or
    noise each change the output; without inputs the SDE model has no noise."""
    _, tcfg, _, _, tmodel, batch = models(sde)
    tb = tree(batch, t)
    kw = {}
    if sde:
        kw["inpaint_input_noise"] = t(input_noise(jax.random.PRNGKey(5), tcfg, 1))
    with torch.no_grad():
        base = tmodel(**tb, **kw)
        changes = [dict(mask_inpaint=1 - tb["mask_inpaint"]),
                   dict(x_inpaint=-tb["x_inpaint"])]
        if sde:
            changes += [dict(t_inpaint=torch.full((1,), 800.0)),
                        dict(inpaint_input_noise=-kw["inpaint_input_noise"])]
        for change in changes:
            out = tmodel(**{**tb, **kw, **change})
            assert float((out - base).abs().max()) > 1e-4, sorted(change)
        if sde:
            with pytest.raises(ValueError, match="generator or input_noise"):
                tmodel(**tb)
            g = torch.Generator().manual_seed(0)
            drawn = tmodel(**tb, generator=g)
            g.manual_seed(0)
            noise = torch.randn((tcfg.nc * tcfg.in_channels * LAT[0],) + LAT[1:], generator=g)
            np.testing.assert_array_equal(drawn.numpy(),
                                          tmodel(**tb, inpaint_input_noise=noise).numpy())
