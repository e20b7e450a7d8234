"""PyTorch port, sampling with the inpainting models against the JAX package on
the CPU, fp32: the BrushNet, SDE-BrushNet and RePaint schedulers, and two-step
``MagicDrivePipeline.sample`` latents of the tiny BrushNet and SDE-BrushNet
models (hidden 64, depth 2 / control depth 1, 9 frames of 32x40) under batched
and slice CFG, and ``sample_repaint`` of the tiny base model.

Randomness: z from the CPU torch generator both packages share (``torch_seed``);
what JAX draws from its keys (the SDE model's noise, RePaint's starting latent
and step noise) is drawn here with the same keys and handed to the port.

Tolerances: schedulers with linear toy velocity fields 1e-5 (as
tests/test_torch_scheduler.py); pipeline latents 3e-4 absolute (as the base
pipeline's: two Euler steps of guidance 2.0 over a model within 1e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_brushnet import brush_configs, inpaint_inputs
from test_torch_common import assert_close, j, load_into, random_params, t, tiny_configs

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.models.magicdrive.brushnet import MagicDriveSTDiT3BrushNet as JBrush
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.models.text_encoder.t5 import DummyTextEncoder as JDummy
from magicdrive_v2_tpu.models.vae.cogvideox import CogVAEConfig as JVAECfg
from magicdrive_v2_tpu.models.vae.cogvideox import VideoAutoencoderKLCogVideoX as JVAE
from magicdrive_v2_tpu.pipelines.magicdrive import MagicDrivePipeline as JPipeline
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu_torch.config.presets import rflow
from magicdrive_v2_tpu_torch.models.magicdrive.brushnet import MagicDriveSTDiT3BrushNet
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
from magicdrive_v2_tpu_torch.schedulers import rf as TR

NF, HH, WW, L_TXT, STEPS = 9, 32, 40, 12, 2
LATENT = (1, 96, 3, 4, 5)
KINDS = ("rflow-brushnet", "rflow-sdebrushnet", "rflow-brushnet-slice",
         "rflow-sdebrushnet-slice", "rflow-slice-repaint")


def jtree(v):
    if isinstance(v, dict):
        return {k: jtree(x) for k, x in v.items()}
    return j(v) if isinstance(v, np.ndarray) else v


def test_the_five_schedulers_are_registered_as_in_jax():
    for kind in KINDS:
        kw = dict(type=kind, num_sampling_steps=3)
        js, ts = JR.build_scheduler(kw), TR.build_scheduler(kw)
        assert type(ts).__name__ == type(js).__name__
        assert ts.slice_cfg == js.slice_cfg == kind.endswith(("slice", "repaint"))
        assert {f.name for f in dataclasses.fields(ts)} == {f.name for f in dataclasses.fields(js)}
    assert TR.build_scheduler(dict(type="rflow-sdebrushnet", inpaint_noise_scale=0.2)
                              ).inpaint_noise_scale == 0.2


@pytest.mark.parametrize("masked", [False, True])
def test_sde_training_losses_match_jax(masked):
    """Given t, t_inpaint and the noise; the toy model reads all four inputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 3, 5, 6)).astype(np.float32)
    n = rng.standard_normal(x.shape).astype(np.float32)
    tt, ti = np.array([120.0, 870.0], np.float32), np.array([300.0, 40.0], np.float32)
    mask = np.array([[True, False, True], [True, True, False]]) if masked else None

    def model(lib):
        def fn(x_t, t_, m, t_in):
            v = 0.3 * x_t + 0.001 * (t_ - t_in).reshape(-1, 1, 1, 1, 1)
            if m is not None:
                v = v * (1.0 + lib.asarray(m, dtype=lib.float32)[:, None, :, None, None])
            return v
        return fn

    hw = dict(height=None, width=None, num_frames=None)
    ref = JR.RFLOW_SDEBRUSHNET().training_losses(
        model(jnp), jax.random.PRNGKey(0), j(x), mask=None if mask is None else j(mask),
        noise=j(n), t=j(tt), t_inpaint=j(ti), **hw)
    out = TR.RFLOW_SDEBRUSHNET().training_losses(
        model(torch), t(x), mask=None if mask is None else t(mask), noise=t(n), t=t(tt),
        t_inpaint=t(ti), **hw)
    assert_close(out["loss"], ref["loss"], 1e-5)
    np.testing.assert_array_equal(out["t_inpaint"].numpy(), ti)
    # drawn from a generator: t, then t_inpaint, then the noise
    g = torch.Generator().manual_seed(3)
    drawn = TR.RFLOW_SDEBRUSHNET().training_losses(model(torch), t(x), generator=g, **hw)
    g.manual_seed(3)
    t_, ti_ = torch.rand((2,), generator=g) * 1000, torch.rand((2,), generator=g) * 1000
    np.testing.assert_array_equal(drawn["t"].numpy(), t_.numpy())
    np.testing.assert_array_equal(drawn["t_inpaint"].numpy(), ti_.numpy())


def jax_repaint_draws(key, shape, steps):
    """What the JAX ``sample_repaint`` draws from its key: z0, then each step's
    re-injection noise."""
    z_key, rest = jax.random.split(key)
    keys = jax.random.split(rest, steps)
    return (np.asarray(jax.random.normal(z_key, shape)),
            [np.asarray(jax.random.normal(k, shape)) for k in keys])


@pytest.mark.parametrize("imt", [0.0, 0.55])
def test_sample_repaint_matches_jax(imt):
    """Four steps; with ignore_mask_timestep 0.55 the last two steps do not
    re-inject. With 0 the known region ends as the reference exactly."""
    rng = np.random.default_rng(1)
    shape, steps = (1, 8, 3, 4, 5), 4
    ref_z = rng.standard_normal(shape).astype(np.float32)
    mask = (rng.random(shape) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(7)
    z0, noises = jax_repaint_draws(key, shape, steps)

    def predict(z, tt, x_mask):
        return -0.5 * z + 0.0007 * tt.reshape((-1,) + (1,) * (z.ndim - 1))

    hw = dict(height=np.full((1,), 424.0, np.float32), width=np.full((1,), 800.0, np.float32),
              num_frames=np.full((1,), 17.0, np.float32))
    kw = rflow(type="rflow-slice-repaint", num_sampling_steps=steps, ignore_mask_timestep=imt)
    ref = JR.build_scheduler(kw).sample_repaint(predict, j(ref_z), j(mask), rng=key,
                                                **{k: j(v) for k, v in hw.items()})
    sched = TR.build_scheduler(kw)
    out = sched.sample_repaint(predict, t(ref_z), t(mask), z0=t(z0),
                               noise_fn=lambda i, s: t(noises[i]),
                               **{k: t(v) for k, v in hw.items()})
    assert_close(out, ref, 1e-5)
    kept = mask == 1
    if imt == 0.0:
        np.testing.assert_array_equal(out.numpy()[kept], ref_z[kept])
    else:
        assert float(np.abs(out.numpy()[kept] - ref_z[kept]).max()) > 1e-3
    # from a generator: z0 first, then one draw a step
    g = torch.Generator().manual_seed(0)
    drawn = sched.sample_repaint(predict, t(ref_z), t(mask), generator=g,
                                 **{k: t(v) for k, v in hw.items()})
    g.manual_seed(0)
    draws = [torch.randn(shape, generator=g) for _ in range(steps + 1)]
    again = sched.sample_repaint(predict, t(ref_z), t(mask), z0=draws[0],
                                 noise_fn=lambda i, s: draws[i + 1],
                                 **{k: t(v) for k, v in hw.items()})
    np.testing.assert_array_equal(drawn.numpy(), again.numpy())


_PIPES = {}


def pipes(kind, hh=HH, pad=None):
    """(JAX pipeline, port pipeline, conditions) of the tiny model ``kind``:
    "brushnet", "sde" or "base", for images of hh x WW, with
    ``force_pad_h_for_sp_size=pad``; one per kind, size and pad and test module."""
    key = (kind, hh, pad)
    if key not in _PIPES:
        replace = dict(model_max_length=L_TXT)
        if pad:
            replace["force_pad_h_for_sp_size"] = pad
        if kind == "base":
            jcfg, tcfg = tiny_configs(**replace)
            jmodel, tcls = JModel(jcfg), MagicDriveSTDiT3
        else:
            jcfg, tcfg = brush_configs(kind == "sde", **replace)
            jmodel, tcls = JBrush(jcfg), MagicDriveSTDiT3BrushNet
        batch = synthetic_batch(tcfg, NF, hh, WW, l_txt=L_TXT, map_size=(8, 40, 40))
        extra = {}
        if kind != "base":
            batch["x_inpaint"], batch["mask_inpaint"] = inpaint_inputs(tcfg.nc, seed=4,
                                                                       hw=(hh, WW))
        if kind == "sde":
            batch["t_inpaint"] = np.full((1,), 200.0, np.float32)
            extra["rngs_key"] = jax.random.PRNGKey(0)
        params = random_params(jmodel, **jtree(batch), **extra)
        sched = rflow(num_sampling_steps=STEPS)
        jpipe = JPipeline(jmodel, params, JVAE(JVAECfg()), JDummy(model_max_length=L_TXT),
                          JR.build_scheduler(sched))
        tmodel = load_into(tcls(tcfg), params, control_depth=tcfg.control_depth)
        tpipe = MagicDrivePipeline(tcfg, TR.build_scheduler(sched), model=tmodel, device="cpu")
        cond = {k: v for k, v in batch.items() if k not in ("x", "timestep", "height", "width")}
        _PIPES[key] = (jpipe, tpipe, cond)
    return _PIPES[key]


def check_latents(kind, slice_cfg, hh=HH, pad=None):
    """Two Euler steps of the tiny ``kind`` model (``pipes``), t_inpaint 200 for the
    SDE model, against the JAX pipeline's latents; the mask reaches them; without
    a given draw the SDE noise comes from the sample's stream after z."""
    jpipe, tpipe, cond = pipes(kind, hh, pad)
    latent = LATENT[:3] + (hh // 8,) + LATENT[4:]
    sched = rflow(type=("rflow-sdebrushnet" if kind == "sde" else "rflow-brushnet")
                  + ("-slice" if slice_cfg else ""), num_sampling_steps=STEPS,
                  inpaint_noise_scale=0.2)
    jpipe.scheduler, tpipe.scheduler = JR.build_scheduler(sched), TR.build_scheduler(sched)
    jcond, tcond = jtree(cond), dict(cond)
    if kind == "sde":
        key = jax.random.PRNGKey(1024)
        jcond["rngs_key"] = key
        shape = tpipe.inpaint_noise_shape(latent, slice_cfg)
        assert shape == ((1 if slice_cfg else 2) * 6 * 16 * 3,) + latent[3:]
        tcond["inpaint_input_noise"] = np.asarray(jax.random.normal(key, shape))
    kw = dict(num_frames=NF, height=hh, width=WW, torch_seed=1027, decode=False)
    ref = jpipe.sample(jcond, **kw)
    out = tpipe.sample(tcond, **kw)
    assert out.shape == latent and torch.isfinite(out).all()
    assert_close(out, ref, 3e-4)
    # the mask reaches the result
    other = tpipe.sample({**tcond, "mask_inpaint": 1 - cond["mask_inpaint"]}, **kw)
    assert float((other - out).abs().max()) > 1e-4
    if kind == "sde":
        # without a given draw, the noise comes from the sample's stream after z
        g = torch.Generator().manual_seed(1027)
        z = torch.randn(latent, generator=g)
        noise = torch.randn(shape, generator=g)
        drawn = tpipe.sample(cond, **kw)
        again = tpipe.sample({**cond, "inpaint_input_noise": noise}, z=z,
                             **{k: v for k, v in kw.items() if k != "torch_seed"})
        np.testing.assert_array_equal(drawn.numpy(), again.numpy())
    return tpipe


@pytest.mark.parametrize("cfg_mode", ["batched", "slice"])
@pytest.mark.parametrize("kind", ["brushnet", "sde"])
def test_pipeline_latents_match_jax(kind, cfg_mode):
    """Two Euler steps, t_inpaint 200 for the SDE model. Its noise: the JAX model
    draws it from ``rngs_key`` for the batch it sees, the doubled batch under
    batched CFG and the same draw in both passes of slice CFG; the port takes
    that draw (``inpaint_input_noise``)."""
    check_latents(kind, cfg_mode == "slice")


def test_pipeline_sample_repaint_matches_jax():
    """The tiny base model with two-pass CFG, two steps, the JAX draws handed in;
    the known region ends as the reference."""
    jpipe, tpipe, cond = pipes("base")
    rng = np.random.default_rng(5)
    ref_z = rng.standard_normal(LATENT).astype(np.float32)
    mask = np.zeros(LATENT, np.float32)
    mask[..., :2, :] = 1.0
    kw = rflow(type="rflow-slice-repaint", num_sampling_steps=STEPS)
    key = jax.random.PRNGKey(1024)
    z0, noises = jax_repaint_draws(key, LATENT, STEPS)
    hw = dict(num_frames=NF, height=HH, width=WW)
    ref = jpipe.sample_repaint(jtree(cond), ref_z, mask, rng=key,
                               scheduler=JR.build_scheduler(kw), **hw)
    out = tpipe.sample_repaint(cond, ref_z, mask, scheduler=TR.build_scheduler(kw), z0=z0,
                               noise_fn=lambda i, s: noises[i], **hw)
    assert out.shape == LATENT
    assert_close(out, ref, 3e-4)
    np.testing.assert_array_equal(out.numpy()[mask == 1], ref_z[mask == 1])
    assert float(np.abs(out.numpy()[mask == 0] - ref_z[mask == 0]).max()) > 1e-2
    with pytest.raises(TypeError, match="RFLOW_SLICE_REPAINT"):
        tpipe.sample_repaint(cond, ref_z, mask, **hw)
