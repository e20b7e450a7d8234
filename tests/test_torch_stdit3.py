"""PyTorch port, the denoiser: MagicDriveSTDiT3 at the tiny flagship config
(hidden 64, 4 heads, depth 2 / control depth 1), 9 frames 64x80, against the JAX
model on the CPU in fp32, weights through ``from_jax_params`` +
``load_state_dict(strict=True)`` with every leaf random. The forward is also held
in the stage-1 image model's layout (``with_temp_block=False``,
``control_skip_temporal=True``: no temporal block at all) at 1 frame.

Tolerance 1e-4 absolute on outputs of order 0.1-1: fp32 rounding through ~10
blocks of GEMMs that the two libraries sum in different orders.
"""
import numpy as np
import pytest
import torch

from test_torch_common import (assert_close, j, load_into, np_tree, random_params, t,
                               tiny_configs)

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MVSTDiTBlock as JBlock
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.pipelines.magicdrive import synthetic_batch as jax_synthetic_batch
from magicdrive_v2_tpu.utils.ckpt import export_torch_state_dict
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MVSTDiTBlock as TBlock
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3 as TModel
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params

ATOL = 1e-4
NF, HH, WW = 9, 64, 80


def _to_torch(v):
    if isinstance(v, dict):
        return {k: _to_torch(x) for k, x in v.items()}
    return t(v) if isinstance(v, np.ndarray) else v


def _to_jax(v):
    if isinstance(v, dict):
        return {k: _to_jax(x) for k, x in v.items()}
    return j(v) if isinstance(v, np.ndarray) else v


# (with_temp_block, control_skip_temporal, frames) of the layouts held against JAX
LAYOUTS = {"temporal": (True, False, NF), "stage1": (False, True, 1)}


def build_setup(layout):
    temp, skip_t, nf = LAYOUTS[layout]
    jcfg, tcfg = tiny_configs(with_temp_block=temp, control_skip_temporal=skip_t)
    batch = synthetic_batch(tcfg, nf, HH, WW, l_txt=60)
    jmodel = JModel(jcfg)
    params = random_params(jmodel, **_to_jax(batch))
    tmodel = load_into(TModel(tcfg), params, control_depth=tcfg.control_depth)
    return jcfg, tcfg, jmodel, params, tmodel, batch


@pytest.fixture(scope="module")
def setup():
    return build_setup("temporal")


@pytest.fixture(scope="module")
def stage1_setup():
    return build_setup("stage1")


def test_stage1_tree_has_no_temporal_blocks(stage1_setup):
    """The no-temporal tree loads strictly (done by the fixture) with both lists of
    temporal blocks empty, and its keys are the JAX exporter's."""
    _, tcfg, _, params, tmodel, _ = stage1_setup
    names = set(tmodel.state_dict())
    assert len(tmodel.base_blocks_t) == len(tmodel.control_blocks_t) == 0
    assert not any(n.startswith(("base_blocks_t.", "control_blocks_t.")) for n in names)
    assert names == set(export_torch_state_dict(np_tree(params), tcfg.control_depth))


def test_synthetic_batch_equals_the_jax_package(setup):
    jcfg, tcfg, *_ = setup
    a = synthetic_batch(tcfg, NF, HH, WW, l_txt=60, seed=3)
    b = jax_synthetic_batch(jcfg, NF, HH, WW, l_txt=60, seed=3)

    def check(x, y):
        if isinstance(x, dict):
            assert set(x) == set(y)
            for k in x:
                check(x[k], y[k])
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, np.asarray(y))
        else:
            assert x == y
    check(a, b)


def test_from_jax_params_equals_export_torch_state_dict(setup):
    """The port's own copy of the conversion rules gives the JAX package's keys
    and arrays, and they load strictly (done by the fixture)."""
    _, tcfg, _, params, tmodel, _ = setup
    mine = from_jax_params(np_tree(params), tcfg.control_depth)
    theirs = export_torch_state_dict(np_tree(params), tcfg.control_depth)
    assert set(mine) == set(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    assert set(mine) == set(tmodel.state_dict())
    for name in ("base_blocks_s.1.attn.qkv.weight", "control_blocks_t.0.after_proj.bias",
                 "base_blocks_s.0.cross_view_attn.qkv.weight", "t_block.1.weight",
                 "bbox_embedder._class_tokens", "frame_embedder.attn.q_norm.weight",
                 "controlnet_cond_embedder_temp.conv_blocks.3.conv.weight"):
        assert name in mine, name
    assert "base_blocks_s.0.cross_view_attn.qkv.bias" not in mine


@pytest.mark.heavy  # ~35 s with a cold XLA compile cache
@pytest.mark.parametrize("layout,jax_kernels", [
    ("temporal", False), ("temporal", True), ("stage1", False), ("stage1", True)],
    ids=["jax_xla", "jax_pallas_interpret", "stage1-jax_xla", "stage1-jax_pallas_interpret"])
def test_forward_matches(request, monkeypatch, layout, jax_kernels):
    """Once against the JAX model's default composition and once with the JAX side
    forced through its three Pallas kernels (interpret mode); in the default layout
    (9 frames) and in stage 1's (no temporal blocks, 1 frame)."""
    fixture = "setup" if layout == "temporal" else "stage1_setup"
    jcfg, tcfg, jmodel, params, tmodel, batch = request.getfixturevalue(fixture)
    from magicdrive_v2_tpu.models.layers import blocks as JB
    from magicdrive_v2_tpu.models.magicdrive import stdit3 as JS
    calls = {"fused": 0, "adaln": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(JB, "fused_qkv_attention", counted("fused", JB.fused_qkv_attention))
    monkeypatch.setattr(JS, "adaln_modulate", counted("adaln", JS.adaln_modulate))
    if jax_kernels:
        monkeypatch.setenv("MDV2_FUSED_ATTN", "1")
        monkeypatch.setenv("MDV2_FUSED_ADALN", "1")
        monkeypatch.setenv("MDV2_ATTN_IMPL", "pallas")
    ref = jmodel.apply(params, **_to_jax(batch))
    # traced once per scanned layer group: the kernels are on the JAX path or not at all
    assert (calls["fused"] > 0 and calls["adaln"] > 0) == jax_kernels, calls
    with torch.no_grad():
        out = tmodel(**_to_torch(batch))
    assert out.dtype == torch.float32 and out.shape == batch["x"].shape
    assert_close(out, ref, ATOL)


def test_forward_with_x_mask_and_cond_cache(setup):
    jcfg, tcfg, jmodel, params, tmodel, batch = setup
    x_mask = np.array([[True, False, True]])
    jb, tb = _to_jax(batch), _to_torch(batch)
    ref = jmodel.apply(params, **jb, x_mask=j(x_mask))
    with torch.no_grad():
        out = tmodel(**tb, x_mask=t(x_mask))
        assert_close(out, ref, ATOL)
        # the masked output differs from the unmasked one (the t0 path is live)
        assert float((out - tmodel(**tb)).abs().max()) > 1e-3

        # cond_cache: encode_conditions once, then a forward that skips the embedders
        jcache = jmodel.apply(params, tuple(batch["x"].shape), jb["y"], jb["maps"],
                              jb["bbox"], jb["cams"], jb["rel_pos"],
                              method=JModel.encode_conditions)
        tcache = tmodel.encode_conditions(tuple(batch["x"].shape), tb["y"], tb["maps"],
                                          tb["bbox"], tb["cams"], tb["rel_pos"])
        assert_close(tcache[0], jcache[0], 2e-5)
        assert_close(tcache[1], jcache[1], 2e-5)
        out_c = tmodel(**tb, cond_cache=tcache)
        assert_close(out_c, jmodel.apply(params, **jb, cond_cache=jcache), ATOL)
        np.testing.assert_allclose(out_c.numpy(), tmodel(**tb).numpy(), atol=1e-6)


def test_frame_valid_padding_matches(setup):
    """A clip padded to the bucket length with ``frame_valid``: the biased temporal
    attention (plain path by contract) and the masked embedders agree with JAX."""
    jcfg, tcfg, jmodel, params, tmodel, batch = setup
    fv = np.ones((1, NF), bool)
    fv[:, 5:] = False
    ref = jmodel.apply(params, **_to_jax(batch), frame_valid=j(fv))
    with torch.no_grad():
        out = tmodel(**_to_torch(batch), frame_valid=t(fv))
    assert_close(out, ref, ATOL)


@pytest.mark.parametrize("kind", ["spatial", "temporal", "control"])
def test_block_matches(kind):
    """One MVSTDiTBlock of each kind, with the t/t0 select on."""
    rng = np.random.default_rng(11)
    b, NC, T, S, C, L = 1, 6, 3, 10, 32, 7
    x = rng.standard_normal((b * NC, T, S, C)).astype(np.float32)
    y = rng.standard_normal((b * NC, T, L, C)).astype(np.float32)
    tt = rng.standard_normal((b, 6 * C)).astype(np.float32)
    t0 = rng.standard_normal((b, 6 * C)).astype(np.float32)
    xm = np.tile(np.array([[True, False, True]]), (b * NC, 1))
    nbrs = ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0))
    kw = dict(temporal=kind == "temporal", is_control_block=kind == "control",
              skip_cross_view=kind == "control")
    jm = JBlock(hidden_size=C, num_heads=4, qk_norm=True, neighbors=nbrs,
                dtype=jnp.float32, **kw)
    p = random_params(jm, j(x), j(y), j(tt), j(xm), j(t0))
    tm = load_into(TBlock(C, 4, qk_norm=True, neighbors=nbrs, **kw), p)
    for mask_j, mask_t in ((None, None), (j(xm), t(xm))):
        ref = jm.apply(p, j(x), j(y), j(tt), mask_j, j(t0))
        with torch.no_grad():
            out = tm(t(x), t(y), t(tt), mask_t, t(t0))
        if kind == "control":
            assert_close(out[0], ref[0], 5e-5)
            assert_close(out[1], ref[1], 5e-5)
        else:
            assert_close(out, ref, 5e-5)


def test_nearest_resize_rule_matches_jax():
    """jax.image.resize(..., "nearest") picks floor((i + 0.5) * in / out): torch's
    "nearest-exact", not "nearest"."""
    rng = np.random.default_rng(12)
    for src, dst in (((3, 13, 25), (3, 8, 10)), ((5, 50, 50), (5, 53, 100)),
                     ((2, 7, 9), (3, 4, 5))):
        x = rng.standard_normal((1, 2) + src).astype(np.float32)
        ref = jax.image.resize(j(x), (1, 2) + dst, method="nearest")
        out = torch.nn.functional.interpolate(t(x), size=dst, mode="nearest-exact")
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    y = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    tm = TModel.__new__(TModel)
    ref = jax.image.resize(j(y), (2, 5, 4, 5), method="nearest")
    np.testing.assert_array_equal(TModel._resize_cond_time(tm, t(y), 5).numpy(), np.asarray(ref))
