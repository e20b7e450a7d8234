"""Training step of the port (counterpart of the JAX package's training/trainer.py):
the rectified-flow loss through the model in its compute dtype, the backward,
global-norm clipping, AdamW and the EMA update, on one device.

Mixed precision as flax does it: the model holds fp32 master parameters; each
forward reads bf16 casts of them (``compute_params``) through
``torch.func.functional_call``, so the grads land in fp32 on the masters. The
step's t and noise come from a CPU ``torch.Generator`` seeded from (seed, step),
so a resumed run draws what an uninterrupted one would; tests may pass t and
noise in.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..models.magicdrive.stdit3 import MagicDriveSTDiT3, compute_params
from ..schedulers.rf import RFLOW
from ..utils.train_utils import ClippedAdamW, make_optimizer, trainable_mask, update_ema

_COND_KEYS = ("y", "maps", "bbox", "cams", "rel_pos", "fps", "drop_cond_mask",
              "drop_frame_mask")


@dataclasses.dataclass
class TrainState:
    step: int
    model: MagicDriveSTDiT3        # fp32 master parameters
    optimizer: ClippedAdamW
    ema: Optional[MagicDriveSTDiT3]  # fp32, or None without EMA


def combine_frame_mask(mask, frame_valid):
    """Merge the (b, T') frame mask with a padded clip's (b, T_img) pixel-frame
    validity: pad latent frames (latent i is pixel frame 4i) leave the loss. A row
    left with no frame falls back to all its valid frames."""
    if frame_valid is None:
        return mask
    lat_valid = frame_valid[:, ::4].float()
    if mask is None:
        return lat_valid
    combined = mask.float() * lat_valid
    has = combined.sum(dim=1, keepdim=True) > 0
    return torch.where(has, combined, lat_valid)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``: derived from (seed, step), never
    advanced across steps."""
    gen = torch.Generator()
    gen.manual_seed(int(np.random.default_rng((seed, step)).integers(1 << 62)))
    return gen


def training_loss(model: MagicDriveSTDiT3, scheduler: RFLOW, batch: Dict, *,
                  height: float, width: float, num_frames: int, dtype=torch.bfloat16,
                  generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None):
    """(mean loss, t) of one batch (already on the model's device) through the
    model in ``dtype``; autograd records down to the fp32 masters."""
    cond = {k: batch[k] for k in _COND_KEYS if k in batch}
    x = batch["x"]
    b = x.shape[0]
    frame_valid = batch.get("frame_valid")
    nf_valid = batch.get("num_frames_valid")
    mask = combine_frame_mask(batch.get("mask"), frame_valid)
    hw = dict(height=torch.full((b,), float(height)), width=torch.full((b,), float(width)),
              num_frames=torch.full((b,), float(num_frames)) if nf_valid is None
              else torch.as_tensor(nf_valid, dtype=torch.float32))
    params = compute_params(model, dtype)

    def model_fn(x_t, tt, x_mask):
        return functional_call(model, params, (x_t, tt), dict(
            **cond, height=float(height), width=float(width), x_mask=x_mask,
            frame_valid=frame_valid))

    out = scheduler.training_losses(model_fn, x, mask=mask, t=t, noise=noise,
                                    generator=generator, **hw)
    return out["loss"].mean(), out["t"]


def make_train_step(scheduler: RFLOW, *, height: float, width: float, num_frames: int,
                    dtype=torch.bfloat16, ema_decay: float = 0.99,
                    ema_mask: Optional[Dict[str, bool]] = None, seed: int = 0) -> Callable:
    """The step for one (height, width, num_frames) bucket:
    ``train_step(state, batch, t=None, noise=None) -> (state, metrics)``, batch on
    the model's device. Without t and noise both are drawn from
    ``step_generator(seed, state.step)``. Metrics: ``loss``, ``grad_norm`` (before
    the clip, trainable parameters only) and ``t_mean``, as 0-dim tensors. The JAX
    step's ``simulate_sp`` (the training-time H-pad) is not ported (ROADMAP.md
    queue A item 5)."""

    def train_step(state: TrainState, batch: Dict, t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        gen = None if t is not None and noise is not None \
            else step_generator(seed, state.step)
        state.optimizer.zero_grad()
        loss, t_used = training_loss(state.model, scheduler, batch, height=height,
                                     width=width, num_frames=num_frames, dtype=dtype,
                                     generator=gen, t=t, noise=noise)
        loss.backward()
        grad_norm = state.optimizer.step()
        if state.ema is not None:
            update_ema(state.ema, state.model, ema_decay, ema_mask)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm.detach(),
                       "t_mean": t_used.mean()}

    return train_step


def build_training_multibucket(model: MagicDriveSTDiT3, scheduler: RFLOW, cfg, *,
                               freeze_patterns=(), seed: int = 0):
    """Optimizer, state and a per-bucket step factory over ``model`` (fp32 masters
    on their device). Each (height, width, num_frames) bucket gets its own step,
    built once and cached: the bucket's statics feed ``timestep_transform``.

    Returns (state, get_step) with ``get_step(height, width, num_frames)``."""
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg.get("dtype", "bf16")]
    mask = trainable_mask(model.named_parameters(), freeze_patterns,
                          model.cfg.control_depth)
    opt = make_optimizer(
        model.named_parameters(), lr=cfg.get("lr", 8e-5),
        weight_decay=cfg.get("weight_decay", 1e-2), adam_eps=cfg.get("adam_eps", 1e-15),
        grad_clip=cfg.get("grad_clip", 1.0), warmup_steps=cfg.get("warmup_steps", 0),
        milestones=cfg.get("lr_milestones", ()), gamma=cfg.get("lr_gamma", 0.1),
        trainable=mask)
    ema = copy.deepcopy(model).requires_grad_(False) if cfg.get("ema", True) else None
    state = TrainState(step=0, model=model, optimizer=opt, ema=ema)
    ema_decay = cfg.get("ema_decay", 0.99)
    cache: Dict[tuple, Callable] = {}

    def get_step(height, width, num_frames):
        key = (float(height), float(width), int(num_frames))
        if key not in cache:
            cache[key] = make_train_step(scheduler, height=key[0], width=key[1],
                                         num_frames=key[2], dtype=dtype,
                                         ema_decay=ema_decay, ema_mask=mask, seed=seed)
        return cache[key]

    return state, get_step


def build_training(model, scheduler, cfg, *, height, width, num_frames,
                   freeze_patterns=(), seed: int = 0):
    """Single-bucket wrapper over ``build_training_multibucket``."""
    state, get_step = build_training_multibucket(model, scheduler, cfg,
                                                 freeze_patterns=freeze_patterns, seed=seed)
    return state, get_step(height, width, num_frames)
