"""Rectified-flow sampling and training loss (counterpart of the JAX package's
schedulers/rf.py), with the BrushNet, SDE-BrushNet and RePaint variants.

The scheduler is purely numerical: sampling receives a ``predict_fn(z, t, x_mask)
-> v`` that already folds in conditioning and classifier-free guidance, the loss a
``model_fn(x_t, t, x_mask) -> v``. Where JAX draws from a key, the port draws from
a ``torch.Generator`` or takes the values as arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..utils.misc import randn_rows, resolve_device


def mean_flat(tensor: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the non-batch dims; with a (b, T) frame mask, over the masked
    frames of a (b, C, T, H, W) tensor only."""
    if mask is None:
        return tensor.mean(dim=tuple(range(1, tensor.ndim)))
    assert tensor.ndim == 5 and tensor.shape[2] == mask.shape[1], (tensor.shape, mask.shape)
    b, c, t, h, w = tensor.shape
    flat = tensor.transpose(1, 2).reshape(b, t, c * h * w)
    mask = mask.to(flat.dtype)
    denom = mask.sum(dim=1) * flat.shape[-1]
    return (flat * mask[:, :, None]).sum(dim=(1, 2)) / denom


def _as_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def timestep_transform(t: torch.Tensor, *, height, width, num_frames,
                       base_resolution: float = 512 * 512,
                       base_num_frames: float = 1.0, scale: float = 1.0,
                       num_timesteps: float = 1.0, cog_style: bool = False) -> torch.Tensor:
    """Resolution/duration-dependent timestep shift."""
    height, width = _as_f32(height, t.device), _as_f32(width, t.device)
    num_frames = _as_f32(num_frames, t.device)
    t = t / num_timesteps
    ratio_space = torch.sqrt(height * width / base_resolution)
    if cog_style:
        frames = torch.floor(num_frames / 4) + torch.remainder(num_frames, 2)
    else:
        frames = torch.floor(num_frames / 17) * 5
    frames = torch.where(num_frames == 1, torch.ones_like(num_frames), frames)
    ratio_time = torch.sqrt(frames / base_num_frames)
    ratio = ratio_space * ratio_time * scale
    new_t = ratio * t / (1 + (ratio - 1) * t)
    return new_t * num_timesteps


def add_noise(x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor,
              num_timesteps: float = 1000.0) -> torch.Tensor:
    """x_t = (1 - t/T) x + (t/T) eps."""
    timepoints = 1.0 - t.float() / num_timesteps
    timepoints = timepoints.reshape((-1,) + (1,) * (x.ndim - 1))
    return timepoints * x + (1 - timepoints) * noise


@dataclasses.dataclass
class RFLOW:
    """Euler rectified-flow sampler."""

    num_sampling_steps: int = 10
    num_timesteps: int = 1000
    cfg_scale: float = 4.0
    use_discrete_timesteps: bool = False
    use_timestep_transform: bool = False
    transform_scale: float = 1.0
    cog_style_trans: bool = False
    sample_method: str = "uniform"
    loc: float = 0.0
    scale: float = 1.0
    slice_cfg: bool = False

    def prepare_timesteps(self, batch: int, *, height, width, num_frames,
                          device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
        """Return (timesteps, dts), each (num_steps, B), on ``device``."""
        device = resolve_device(device)
        ts = [(1.0 - i / self.num_sampling_steps) * self.num_timesteps
              for i in range(self.num_sampling_steps)]
        if self.use_discrete_timesteps:
            ts = [int(round(t)) for t in ts]
        ts = torch.tensor(ts, dtype=torch.float32, device=device)[:, None] \
            * torch.ones((1, batch), dtype=torch.float32, device=device)
        if self.use_timestep_transform:
            ts = timestep_transform(ts, height=height, width=width,
                                    num_frames=num_frames, scale=self.transform_scale,
                                    num_timesteps=self.num_timesteps,
                                    cog_style=self.cog_style_trans)
        dts = torch.cat([ts[:-1] - ts[1:], ts[-1:]], dim=0) / self.num_timesteps
        return ts, dts

    @torch.no_grad()
    def sample(self, predict_fn: Callable, z: torch.Tensor, *, height, width,
               num_frames, mask: Optional[torch.Tensor] = None,
               noise_fn: Optional[Callable] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Run the Euler loop. predict_fn(z, t, x_mask) -> CFG-combined velocity.

        mask: per-latent-frame float mask (B, T'); frames with mask*T >= t are
        denoised, the others stay pinned to the reference latents. The masked
        branch adds fresh noise at every step: ``noise_fn(step, shape)`` supplies
        it when given (a test can inject the noise another implementation drew),
        else it is drawn from ``generator``.
        """
        B = z.shape[0]
        ts, dts = self.prepare_timesteps(B, height=height, width=width,
                                         num_frames=num_frames, device=z.device)
        bshape = (-1,) + (1,) * (z.ndim - 1)
        if mask is None:
            for i in range(self.num_sampling_steps):
                v = predict_fn(z, ts[i], None)
                z = z + v * dts[i].reshape(bshape)
            return z

        if noise_fn is None:
            def noise_fn(step, shape):
                return torch.randn(shape, generator=generator, dtype=z.dtype,
                                   device=generator.device if generator is not None
                                   else z.device).to(z.device)
        mask = mask.to(z.device)
        noise_added = mask == 1
        mask_t = mask * self.num_timesteps
        for i in range(self.num_sampling_steps):
            t, dt = ts[i], dts[i]
            x0 = z
            noise = torch.as_tensor(noise_fn(i, tuple(x0.shape))).to(x0)
            x_noise = add_noise(x0, noise, t, self.num_timesteps)
            mask_t_upper = mask_t >= t[:, None]
            mask_add_noise = mask_t_upper & (~noise_added)
            z = torch.where(mask_add_noise[:, None, :, None, None], x_noise, x0)
            v = predict_fn(z, t, mask_t_upper)
            z_new = z + v * dt.reshape(bshape)
            z = torch.where(mask_t_upper[:, None, :, None, None], z_new, x0)
            noise_added = mask_t_upper
        return z


    # ---------------- training ----------------

    def sample_t(self, generator: Optional[torch.Generator], batch: int, *, height=None,
                 width=None, num_frames=None, device=None,
                 rows: Tuple[int, int] = (1, 0)) -> torch.Tensor:
        """Training timesteps (b,), fp32, drawn from ``generator`` (on its device)
        and moved to ``device``: discrete, uniform or logit-normal, then the
        resolution/duration shift when ``use_timestep_transform``. ``rows`` (dp,
        rank): drawn for dp * ``batch`` samples, and data-parallel rank ``rank``'s
        ``batch`` of them kept (before the shift, which reads this rank's sizes)."""
        gdev = generator.device if generator is not None else "cpu"
        n = batch * rows[0]
        if self.use_discrete_timesteps:
            t = torch.randint(0, self.num_timesteps, (n,), generator=generator,
                              device=gdev).float()
        elif self.sample_method == "uniform":
            t = torch.rand((n,), generator=generator, device=gdev) * self.num_timesteps
        elif self.sample_method == "logit-normal":
            t = torch.sigmoid(torch.randn((n,), generator=generator, device=gdev)
                              * self.scale + self.loc) * self.num_timesteps
        else:
            raise ValueError(self.sample_method)
        t = t[rows[1] * batch:(rows[1] + 1) * batch]
        t = t.to(device if device is not None else gdev)
        if self.use_timestep_transform:
            t = timestep_transform(t, height=height, width=width, num_frames=num_frames,
                                   scale=self.transform_scale,
                                   num_timesteps=self.num_timesteps,
                                   cog_style=self.cog_style_trans)
        return t

    def training_losses(self, model_fn: Callable, x_start: torch.Tensor, *, height,
                        width, num_frames, mask: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        t: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        rows: Tuple[int, int] = (1, 0)) -> Dict[str, torch.Tensor]:
        """Velocity-matching MSE per sample. ``t`` and ``noise`` are drawn from
        ``generator`` when not given, t first (as JAX splits t's key first), as
        data-parallel rank ``rows`` (dp, rank) draws them (``sample_t``,
        ``randn_rows``). With a (b, T') frame mask, unmasked frames enter the model
        at t = 0 (the clean latents) and leave the loss."""
        if t is None:
            t = self.sample_t(generator, x_start.shape[0], height=height, width=width,
                              num_frames=num_frames, device=x_start.device, rows=rows)
        t = t.to(x_start.device)
        if noise is None:
            noise = randn_rows(x_start.shape, generator, rows, dtype=x_start.dtype,
                               device=x_start.device)
        noise = noise.to(x_start.device, x_start.dtype)
        x_t = add_noise(x_start, noise, t, self.num_timesteps)
        if mask is not None:
            mask = mask.to(x_start.device)
            x_t0 = add_noise(x_start, noise, torch.zeros_like(t), self.num_timesteps)
            x_t = torch.where(mask.bool()[:, None, :, None, None], x_t, x_t0)
        velocity_pred = model_fn(x_t, t, mask)
        target = x_start - noise
        loss = mean_flat((velocity_pred.float() - target.float()) ** 2, mask=mask)
        return {"loss": loss, "t": t}


@dataclasses.dataclass
class RFLOW_SLICE(RFLOW):
    """Two-pass-CFG variant: numerics identical to RFLOW; the pipeline runs the
    conditional and unconditional passes one after the other."""
    slice_cfg: bool = True


@dataclasses.dataclass
class RFLOW_BRUSHNET(RFLOW):
    """BrushNet sampling and training: the inpaint inputs ride in the model's
    arguments; ``inpaint_noise_scale`` is the fixed inpaint timestep (over
    ``num_timesteps``) the apps give the SDE model at inference."""
    inpaint_noise_scale: float = 0.0


@dataclasses.dataclass
class RFLOW_SDEBRUSHNET(RFLOW_BRUSHNET):
    """SDE-BrushNet: the loss draws an inpaint timestep independent of t."""

    def training_losses(self, model_fn: Callable, x_start: torch.Tensor, *, height,
                        width, num_frames, mask: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        t: Optional[torch.Tensor] = None,
                        t_inpaint: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        rows: Tuple[int, int] = (1, 0)) -> Dict[str, torch.Tensor]:
        """As ``RFLOW.training_losses`` with ``model_fn(x_t, t, x_mask, t_inpaint)``;
        what is not given is drawn from ``generator`` in the order t, t_inpaint,
        noise (the order of the JAX package's key split)."""
        b = x_start.shape[0]
        hw = dict(height=height, width=width, num_frames=num_frames, device=x_start.device,
                  rows=rows)
        if t is None:
            t = self.sample_t(generator, b, **hw)
        if t_inpaint is None:
            t_inpaint = self.sample_t(generator, b, **hw)
        t, t_inpaint = t.to(x_start.device), t_inpaint.to(x_start.device)
        if noise is None:
            noise = randn_rows(x_start.shape, generator, rows, dtype=x_start.dtype,
                               device=x_start.device)
        noise = noise.to(x_start.device, x_start.dtype)
        x_t = add_noise(x_start, noise, t, self.num_timesteps)
        if mask is not None:
            mask = mask.to(x_start.device)
            x_t0 = add_noise(x_start, noise, torch.zeros_like(t), self.num_timesteps)
            x_t = torch.where(mask.bool()[:, None, :, None, None], x_t, x_t0)
        velocity_pred = model_fn(x_t, t, mask, t_inpaint)
        target = x_start - noise
        loss = mean_flat((velocity_pred.float() - target.float()) ** 2, mask=mask)
        return {"loss": loss, "t": t, "t_inpaint": t_inpaint}


@dataclasses.dataclass
class RFLOW_BRUSHNET_SLICE(RFLOW_BRUSHNET):
    """Two-pass-CFG BrushNet."""
    slice_cfg: bool = True


@dataclasses.dataclass
class RFLOW_SDEBRUSHNET_SLICE(RFLOW_SDEBRUSHNET):
    """Two-pass-CFG SDE-BrushNet."""
    slice_cfg: bool = True


@dataclasses.dataclass
class RFLOW_SLICE_REPAINT(RFLOW):
    """RePaint latent inpainting: after each Euler step, while t >=
    ``ignore_mask_timestep`` * T, the known region is replaced by the reference
    latents noised to the NEXT timestep (0 after the last step, so the known
    region ends as the reference exactly)."""
    slice_cfg: bool = True
    ignore_mask_timestep: float = 0.0

    @torch.no_grad()
    def sample_repaint(self, predict_fn: Callable, ref_z: torch.Tensor, mask: torch.Tensor,
                       *, height, width, num_frames, z0: Optional[torch.Tensor] = None,
                       noise_fn: Optional[Callable] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """ref_z: reference latents; mask: ref_z's shape, 1 = known region. The
        starting latent is ``z0``, else ``noise_fn(-1, shape)``; step i's
        re-injection noise is ``noise_fn(i, shape)``. Without ``noise_fn`` both
        are drawn from ``generator``, in that order. Every step draws, re-injecting
        or not.

        The JAX package hands the model an all-true frame mask, which selects
        the t modulations everywhere; the port passes none, which computes the
        same without the t0 half."""
        B = ref_z.shape[0]
        ts, dts = self.prepare_timesteps(B, height=height, width=width,
                                         num_frames=num_frames, device=ref_z.device)
        next_ts = torch.cat([ts[1:], torch.zeros_like(ts[-1:])], dim=0)
        if noise_fn is None:
            def noise_fn(step, shape):
                return torch.randn(shape, generator=generator,
                                   device=generator.device if generator is not None
                                   else ref_z.device)
        z = z0 if z0 is not None else noise_fn(-1, tuple(ref_z.shape))
        z = torch.as_tensor(z).to(ref_z)
        mask = mask.to(ref_z)
        bshape = (-1,) + (1,) * (z.ndim - 1)
        for i in range(self.num_sampling_steps):
            t, dt, next_t = ts[i], dts[i], next_ts[i]
            z = z + predict_fn(z, t, None) * dt.reshape(bshape)
            noise = torch.as_tensor(noise_fn(i, tuple(ref_z.shape))).to(ref_z)
            x_noise = add_noise(ref_z, noise, next_t, self.num_timesteps)
            reinject = t[0] >= self.ignore_mask_timestep * self.num_timesteps
            z = torch.where(reinject, x_noise * mask + z * (1 - mask), z)
        return z


SCHEDULERS = {"rflow": RFLOW, "rflow-slice": RFLOW_SLICE,
              "rflow-brushnet": RFLOW_BRUSHNET, "rflow-sdebrushnet": RFLOW_SDEBRUSHNET,
              "rflow-brushnet-slice": RFLOW_BRUSHNET_SLICE,
              "rflow-sdebrushnet-slice": RFLOW_SDEBRUSHNET_SLICE,
              "rflow-slice-repaint": RFLOW_SLICE_REPAINT}


def build_scheduler(cfg: dict):
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return SCHEDULERS[kind](**cfg)
