"""PyTorch port, rectified-flow scheduler against the JAX package's on the CPU.
fp32; the toy velocity fields are linear, so 1e-5 absolute covers the different
order of fp32 operations over a handful of Euler steps."""
import numpy as np
import pytest
import torch

from test_torch_common import j, t

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu_torch.config.presets import rflow
from magicdrive_v2_tpu_torch.schedulers import rf as TR


@pytest.mark.parametrize("cog_style", [True, False])
def test_timestep_transform(cog_style):
    ts = np.linspace(1.0, 1000.0, 7).astype(np.float32)[:, None] * np.ones((1, 3), np.float32)
    kw = dict(height=np.array([424.0, 224.0, 848.0], np.float32),
              width=np.array([800.0, 400.0, 1600.0], np.float32),
              num_frames=np.array([17.0, 1.0, 33.0], np.float32))
    ref = JR.timestep_transform(j(ts), **{k: j(v) for k, v in kw.items()}, scale=1.3,
                                num_timesteps=1000, cog_style=cog_style)
    out = TR.timestep_transform(t(ts), **{k: t(v) for k, v in kw.items()}, scale=1.3,
                                num_timesteps=1000, cog_style=cog_style)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-4)


def test_add_noise_and_prepare_timesteps():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    n = rng.standard_normal(x.shape).astype(np.float32)
    tt = np.array([100.0, 900.0], np.float32)
    np.testing.assert_allclose(TR.add_noise(t(x), t(n), t(tt)).numpy(),
                               np.asarray(JR.add_noise(j(x), j(n), j(tt))), atol=1e-6)
    for kw in (rflow(num_sampling_steps=5), dict(type="rflow", num_sampling_steps=4,
                                                 use_discrete_timesteps=True)):
        js, tsch = JR.build_scheduler(kw), TR.build_scheduler(kw)
        hw = dict(height=np.full((2,), 424.0, np.float32), width=np.full((2,), 800.0, np.float32),
                  num_frames=np.full((2,), 17.0, np.float32))
        jt, jd = js.prepare_timesteps(2, **{k: j(v) for k, v in hw.items()})
        tt_, td = tsch.prepare_timesteps(2, **{k: t(v) for k, v in hw.items()},
                                         device="cpu")
        np.testing.assert_allclose(tt_.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-7)
        if not torch.cuda.is_available():
            # the default device is the card: nothing is built on the CPU unasked
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tsch.prepare_timesteps(2, **{k: t(v) for k, v in hw.items()})
    assert TR.build_scheduler(dict(type="rflow-slice")).slice_cfg is True
    assert rflow() == dict(type="rflow", use_timestep_transform=True, cog_style_trans=True,
                           num_sampling_steps=30, cfg_scale=2.0)


def _toy(lib):
    def predict(z, tt, x_mask):
        v = -0.7 * z + 0.001 * tt.reshape((-1,) + (1,) * (z.ndim - 1))
        if x_mask is not None:
            m = x_mask[:, None, :, None, None]
            v = v + (0.3 * m if lib == "jax" else 0.3 * m.to(z.dtype))
        return v
    return predict


HW = dict(height=np.full((2,), 424.0, np.float32), width=np.full((2,), 800.0, np.float32),
          num_frames=np.full((2,), 17.0, np.float32))


def test_sample_unmasked():
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 4, 3, 5, 6)).astype(np.float32)
    kw = rflow(num_sampling_steps=6)
    ref = JR.build_scheduler(kw).sample(_toy("jax"), j(z), **{k: j(v) for k, v in HW.items()})
    out = TR.build_scheduler(kw).sample(_toy("torch"), t(z), **{k: t(v) for k, v in HW.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_sample_masked_with_injected_noise():
    """The masked branch re-noises frames at every step; the port takes the noise
    the JAX scheduler drew (same key split) through ``noise_fn``."""
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 4, 3, 5, 6)).astype(np.float32)
    mask = np.array([[1.0, 0.0, 0.6], [0.0, 1.0, 1.0]], np.float32)
    steps = 5
    kw = rflow(num_sampling_steps=steps)
    key = jax.random.PRNGKey(5)
    ref = JR.build_scheduler(kw).sample(_toy("jax"), j(z), mask=j(mask), rng=key,
                                        **{k: j(v) for k, v in HW.items()})
    keys = jax.random.split(key, steps)
    noises = [np.asarray(jax.random.normal(keys[i], z.shape, jnp.float32)) for i in range(steps)]
    out = TR.build_scheduler(kw).sample(_toy("torch"), t(z), mask=t(mask),
                                        noise_fn=lambda i, shape: t(noises[i]),
                                        **{k: t(v) for k, v in HW.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # frames with mask 0 stay pinned to the reference latents
    np.testing.assert_array_equal(out.numpy()[0, :, 1], z[0, :, 1])
    # without a noise_fn the noise comes from the generator, reproducibly
    g = lambda: torch.Generator().manual_seed(3)
    a = TR.build_scheduler(kw).sample(_toy("torch"), t(z), mask=t(mask), generator=g(),
                                      **{k: t(v) for k, v in HW.items()})
    b = TR.build_scheduler(kw).sample(_toy("torch"), t(z), mask=t(mask), generator=g(),
                                      **{k: t(v) for k, v in HW.items()})
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "frame_mask"])
def test_mean_flat(masked):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 3, 5, 6)).astype(np.float32)
    mask = np.array([[1.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32) if masked else None
    ref = JR.mean_flat(j(x), None if mask is None else j(mask))
    out = TR.mean_flat(t(x), None if mask is None else t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "frame_mask"])
def test_training_losses_with_t_and_noise_given(masked):
    """Same t and noise as JAX draws them, a toy velocity field: the same loss per
    sample, and the port's loss carries grads back into the model's output."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 3, 5, 6)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    tt = np.array([123.0, 870.0], np.float32)
    mask = np.array([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]], np.float32) if masked else None
    kw = rflow(sample_method="logit-normal")
    ref = JR.build_scheduler(kw).training_losses(
        _toy("jax"), jax.random.PRNGKey(0), j(x), mask=None if mask is None else j(mask),
        noise=j(noise), t=j(tt), **{k: j(v) for k, v in HW.items()})
    w = torch.ones((), requires_grad=True)
    toy = _toy("torch")
    out = TR.build_scheduler(kw).training_losses(
        lambda z, tt_, m: w * toy(z, tt_, m), t(x), mask=None if mask is None else t(mask),
        noise=t(noise), t=t(tt), **{k: t(v) for k, v in HW.items()})
    np.testing.assert_allclose(out["loss"].detach().numpy(), np.asarray(ref["loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(out["t"].numpy(), tt)
    out["loss"].mean().backward()
    assert w.grad is not None and float(w.grad.abs()) > 0


@pytest.mark.parametrize("method", ["uniform", "logit-normal", "discrete"])
def test_sample_t_draws_from_the_generator_then_shifts(method):
    """t from a torch.Generator (JAX draws from a key, so the draws differ): the
    distribution's formula on the generator's draws, then JAX's
    timestep_transform."""
    kw = rflow(sample_method=method, loc=0.3, scale=1.2)
    if method == "discrete":
        kw = rflow(use_discrete_timesteps=True)
    sched = TR.build_scheduler(kw)
    hw = {k: v[:2] for k, v in HW.items()}
    out = sched.sample_t(torch.Generator().manual_seed(5), 2, **{k: t(v) for k, v in hw.items()})
    g = torch.Generator().manual_seed(5)
    if method == "uniform":
        raw = torch.rand((2,), generator=g) * 1000
    elif method == "logit-normal":
        raw = torch.sigmoid(torch.randn((2,), generator=g) * 1.2 + 0.3) * 1000
    else:
        raw = torch.randint(0, 1000, (2,), generator=g).float()
    ref = JR.timestep_transform(j(raw.numpy()), **{k: j(v) for k, v in hw.items()},
                                num_timesteps=1000, cog_style=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-4)
    again = sched.sample_t(torch.Generator().manual_seed(5), 2,
                           **{k: t(v) for k, v in hw.items()})
    np.testing.assert_array_equal(out.numpy(), again.numpy())
    # the loss draws t first, then the noise, from the one generator
    x = torch.zeros(2, 4, 3, 5, 6)
    res = sched.training_losses(lambda z, tt_, m: z, x, generator=torch.Generator()
                                .manual_seed(5), **{k: t(v) for k, v in hw.items()})
    np.testing.assert_array_equal(res["t"].numpy(), out.numpy())
