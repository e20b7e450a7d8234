"""Training step of the port (counterpart of the JAX package's training/trainer.py):
the rectified-flow loss through the model in its compute dtype, the backward,
global-norm clipping, AdamW and the EMA update, on one device or on the (dp, sp)
mesh of a ``parallel.use_mesh`` context.

On the mesh each dp row (the sp ranks of one sp group) trains on its own rows
of the global batch, and the fp32 state is split over dp (``parallel/fsdp.py``,
``TrainState.sharding``). The ranks of an sp group run the step on the same rows
and the same draws; the model leaves each its share of the grads
(``parallel.comm``). After the backward, in this order: the grads are averaged
over dp (the split ones reduce-scattered inside the backward, the replicated
ones all-reduced after it), summed over the sp group (``reduce_sp_grads``; rank
(d, s) and rank (d, s') hold the same block d, so the two linear reductions
commute), and clipped by the global norm. Every rank then holds its block of one
process's grads on the global batch, and AdamW and the EMA update the blocks.
The step's draws are made for the global batch from (seed, step) on every rank,
and each dp row takes its rows, so no two rows share noise and dp ranks equal
one process on the global batch.

Mixed precision as flax does it: the model holds fp32 master parameters; each
forward reads bf16 casts of them (``compute_params``) through
``torch.func.functional_call``, so the grads land in fp32 on the masters. The
step's t and noise come from a CPU ``torch.Generator`` seeded from (seed, step),
so a resumed run draws what an uninterrupted one would; tests may pass t and
noise in. The BrushNet models train their branch only, over the frozen base
(``build_brushnet_training``), with the SDE variant's loss and its model's
training-time draws from a second generator of (seed, step).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from ..models.magicdrive.stdit3 import MagicDriveSTDiT3, compute_params
from ..parallel.comm import reduce_sp_grads
from ..parallel.fsdp import ParamSharding
from ..parallel.sharding import get_current_mesh
from ..schedulers.rf import RFLOW, RFLOW_SDEBRUSHNET
from ..utils.train_utils import ClippedAdamW, make_optimizer, trainable_mask, update_ema
from .lora import BRUSHNET_EXTRA_TRAINABLE, lora_trainable_mask

# the model's conditioning inputs in a batch; the BrushNet models' inpaint inputs
# ride along where a batch has them
_COND_KEYS = ("y", "maps", "bbox", "cams", "rel_pos", "fps", "drop_cond_mask",
              "drop_frame_mask", "x_inpaint", "mask_inpaint")


@dataclasses.dataclass
class TrainState:
    step: int
    model: MagicDriveSTDiT3        # fp32 master parameters (this rank's blocks under dp)
    optimizer: ClippedAdamW
    ema: Optional[MagicDriveSTDiT3]  # fp32, or None without EMA
    sharding: Optional[ParamSharding] = None  # the dp split of model and EMA


def _rows(x: torch.Tensor, dp: int, rank: int) -> torch.Tensor:
    """Data-parallel rank ``rank``'s rows of a draw made for the global batch."""
    n = x.shape[0] // dp
    return x[rank * n:(rank + 1) * n]


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


def step_generator(seed: int, step: int, stream: int = 0) -> torch.Generator:
    """The CPU generator of step ``step``: derived from (seed, step), never
    advanced across steps; ``stream`` 1 is a second, independent one (the SDE
    model's draws)."""
    gen = torch.Generator()
    key = (seed, step) if stream == 0 else (seed, step, stream)
    gen.manual_seed(int(np.random.default_rng(key).integers(1 << 62)))
    return gen


def training_loss(model: MagicDriveSTDiT3, scheduler: RFLOW, batch: Dict, *,
                  height: float, width: float, num_frames: int, dtype=torch.bfloat16,
                  generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  t_inpaint: Optional[torch.Tensor] = None,
                  model_kwargs: Optional[Dict] = None,
                  simulate_sp: Optional[int] = None,
                  sharding: Optional[ParamSharding] = None,
                  dp_rows: Tuple[int, int] = (1, 0)):
    """(mean loss, t) of one batch (already on the model's device) through the
    model in ``dtype``; autograd records down to the fp32 masters (this rank's
    blocks of them, gathered over dp, with a ``sharding``). A BrushNet
    batch carries ``x_inpaint`` and ``mask_inpaint`` too. For the SDE-BrushNet
    model (``cfg.sde_inpaint``) the scheduler must be an ``RFLOW_SDEBRUSHNET``:
    its loss draws an independent ``t_inpaint``, and the model runs with
    ``train=True`` and ``model_kwargs``, its randomness (a ``generator``, or
    ``cutoff_radius`` and ``inpaint_input_noise``). ``simulate_sp``: the model's
    training-time H pad (``MagicDriveSTDiT3._h_pad_size``). ``dp_rows`` (dp,
    rank): the batch is data-parallel rank ``rank``'s rows of a global batch of dp
    such; the scheduler and the SDE model draw for the global batch, in one
    process's order, and keep this rank's rows."""
    sde = getattr(model.cfg, "sde_inpaint", False)
    if sde != isinstance(scheduler, RFLOW_SDEBRUSHNET):
        raise ValueError(f"{type(scheduler).__name__} does not train a model with "
                         f"sde_inpaint={sde}")
    cond = {k: batch[k] for k in _COND_KEYS if k in batch}
    x = batch["x"]
    b = x.shape[0]
    frame_valid = batch.get("frame_valid")
    nf_valid = batch.get("num_frames_valid")
    mask = combine_frame_mask(batch.get("mask"), frame_valid)
    hw = dict(height=torch.full((b,), float(height)), width=torch.full((b,), float(width)),
              num_frames=torch.full((b,), float(num_frames)) if nf_valid is None
              else torch.as_tensor(nf_valid, dtype=torch.float32))
    params = (compute_params(model, dtype) if sharding is None
              else sharding.compute_params(model, dtype))

    def model_fn(x_t, tt, x_mask, *sde_t_inpaint):
        kw = dict(**cond, height=float(height), width=float(width), x_mask=x_mask,
                  frame_valid=frame_valid, simulate_sp=simulate_sp)
        if sde:
            kw.update(t_inpaint=sde_t_inpaint[0], num_timesteps=float(scheduler.num_timesteps),
                      train=True, dp_rows=dp_rows, **(model_kwargs or {}))
        return functional_call(model, params, (x_t, tt), kw)

    extra = dict(t_inpaint=t_inpaint) if sde else {}
    out = scheduler.training_losses(model_fn, x, mask=mask, t=t, noise=noise,
                                    generator=generator, rows=dp_rows, **extra, **hw)
    return out["loss"].mean(), out["t"]


def make_grad_step(scheduler: RFLOW, *, height: float, width: float, num_frames: int,
                   dtype=torch.bfloat16, seed: int = 0,
                   simulate_sp: Optional[int] = None) -> Callable:
    """The part of ``make_train_step``'s step before the update:
    ``grad_step(state, batch, **draws) -> metrics`` zeroes the grads, runs the loss
    and its backward, and under a mesh reduces the grads (dp mean, then the sp sum)
    and the metrics (``loss``, ``t_mean``, as 0-dim tensors). It leaves the grads
    of the parameters that require grad ready for the clip; ``state.step`` picks
    the draws and is not advanced. The measurement tools (``tools/perf_lab``,
    ``tools/plan_memory``) run it with the grad norm in place of the update.
    Arguments and draws as ``make_train_step``'s."""

    def grad_step(state: TrainState, batch: Dict, **draws) -> Dict[str, torch.Tensor]:
        sde = getattr(state.model.cfg, "sde_inpaint", False)
        loss_draws = ("t", "noise", "t_inpaint") if sde else ("t", "noise")
        model_draws = ("cutoff_radius", "inpaint_input_noise") if sde else ()
        unknown = set(draws) - set(loss_draws + model_draws)
        if unknown:
            raise TypeError(f"train_step got draws it does not make: {sorted(unknown)}")
        mesh = get_current_mesh()
        dp_rows = (1, 0) if mesh is None else (mesh.dp, mesh.dp_rank)
        if dp_rows[0] > 1:
            if state.sharding is None or state.sharding.group is not mesh.dp_group:
                raise ValueError(f"a step at dp={mesh.dp} needs the state split over that "
                                 f"mesh's dp group (parallel.fsdp.shard_for_training)")
            draws = {k: v if v is None or k == "cutoff_radius" else _rows(v, *dp_rows)
                     for k, v in draws.items()}
        gen = None if all(draws.get(k) is not None for k in loss_draws) \
            else step_generator(seed, state.step)
        model_kwargs = None
        if sde:
            model_kwargs = {k: draws.get(k) for k in model_draws}
            if any(v is None for v in model_kwargs.values()):
                model_kwargs["generator"] = step_generator(seed, state.step, 1)
        state.optimizer.zero_grad()
        loss, t_used = training_loss(
            state.model, scheduler, batch, height=height, width=width,
            num_frames=num_frames, dtype=dtype, generator=gen, model_kwargs=model_kwargs,
            simulate_sp=simulate_sp, sharding=state.sharding, dp_rows=dp_rows,
            **{k: draws.get(k) for k in loss_draws})
        loss.backward()  # the split parameters' grads: reduce-scattered over dp in here
        trainable = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
        metrics = {"loss": loss.detach(), "t_mean": t_used.mean()}
        if dp_rows[0] > 1:
            state.sharding.reduce_replicated_grads(trainable)
            for v in metrics.values():
                dist.all_reduce(v, group=mesh.dp_group)
                v.div_(mesh.dp)
        if mesh is not None and mesh.sp > 1:
            reduce_sp_grads([p for _, p in trainable], mesh.sp_group)
        return metrics

    return grad_step


def make_train_step(scheduler: RFLOW, *, height: float, width: float, num_frames: int,
                    dtype=torch.bfloat16, ema_decay: float = 0.99,
                    ema_mask: Optional[Dict[str, bool]] = None, seed: int = 0,
                    simulate_sp: Optional[int] = None) -> Callable:
    """The step for one (height, width, num_frames) bucket, of the base model and
    of the BrushNet variants (the JAX package's ``make_train_step`` and
    ``make_brushnet_train_step``): ``train_step(state, batch, **draws) -> (state,
    metrics)``, batch on the model's device; a BrushNet batch also carries
    x_inpaint (b, 3*NC, T_img, H, W) and mask_inpaint (b, NC, T_img, H, W).
    Metrics: ``loss``, ``grad_norm`` (before the clip, trainable parameters only)
    and ``t_mean``, as 0-dim tensors. The grads come from ``make_grad_step``; the
    clip, AdamW and the EMA follow.

    What ``draws`` does not hand in is drawn: ``t`` and ``noise`` (and, for the
    SDE-BrushNet model, ``t_inpaint``) from ``step_generator(seed, step)`` in the
    order t, t_inpaint, noise; the SDE model's ``cutoff_radius`` and
    ``inpaint_input_noise`` from ``step_generator(seed, step, 1)``, cutoff first
    (the JAX step splits its key into the loss's and the model's). All of them
    are drawn for the global batch, before the model splits anything, so they are
    the same on every rank of an sp group, and each dp row keeps its rows (draws
    handed in are the global batch's too). ``simulate_sp``: the training-time H
    pad of that sp size (the JAX step's; each value is a step of its own).

    Under a mesh (``parallel.use_mesh``) the grads of the parameters that require
    grad are averaged over dp (the state must be split over the mesh's dp:
    ``TrainState.sharding``), then summed over the sp group, before the clip; the
    loss and t_mean are the global batch's (averaged over dp)."""
    grad_step = make_grad_step(scheduler, height=height, width=width,
                               num_frames=num_frames, dtype=dtype, seed=seed,
                               simulate_sp=simulate_sp)

    def train_step(state: TrainState, batch: Dict, **draws):
        metrics = grad_step(state, batch, **draws)
        metrics["grad_norm"] = state.optimizer.step().detach()
        if state.ema is not None:
            update_ema(state.ema, state.model, ema_decay, ema_mask)
        state.step += 1
        return state, metrics

    return train_step


def build_training_multibucket(model: MagicDriveSTDiT3, scheduler: RFLOW, cfg, *,
                               freeze_patterns=(), seed: int = 0,
                               sharding: Optional[ParamSharding] = None):
    """Optimizer, state and a per-bucket step factory over ``model`` (fp32 masters
    on their device). Each (height, width, num_frames) bucket gets its own step,
    built once and cached: the bucket's statics feed ``timestep_transform``.
    ``sharding``: the model's split over dp (``parallel.fsdp.shard_for_training``,
    called on it first), which the moments and the EMA then share.

    Returns (state, get_step) with ``get_step(height, width, num_frames,
    simulate_sp=None)``, keyed on all four as the JAX package's."""
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg.get("dtype", "bf16")]
    mask = trainable_mask(model.named_parameters(), freeze_patterns)
    opt = make_optimizer(
        model.named_parameters(), lr=cfg.get("lr", 8e-5),
        weight_decay=cfg.get("weight_decay", 1e-2), adam_eps=cfg.get("adam_eps", 1e-15),
        grad_clip=cfg.get("grad_clip", 1.0), warmup_steps=cfg.get("warmup_steps", 0),
        milestones=cfg.get("lr_milestones", ()), gamma=cfg.get("lr_gamma", 0.1),
        trainable=mask, sharding=sharding)
    ema = copy.deepcopy(model).requires_grad_(False) if cfg.get("ema", True) else None
    state = TrainState(step=0, model=model, optimizer=opt, ema=ema, sharding=sharding)
    ema_decay = cfg.get("ema_decay", 0.99)
    cache: Dict[tuple, Callable] = {}

    def get_step(height, width, num_frames, simulate_sp=None):
        key = (float(height), float(width), int(num_frames),
               None if simulate_sp is None else int(simulate_sp))
        if key not in cache:
            cache[key] = make_train_step(scheduler, height=key[0], width=key[1],
                                         num_frames=key[2], dtype=dtype,
                                         ema_decay=ema_decay, ema_mask=mask, seed=seed,
                                         simulate_sp=key[3])
        return cache[key]

    return state, get_step


def build_training(model, scheduler, cfg, *, height, width, num_frames,
                   freeze_patterns=(), seed: int = 0):
    """Single-bucket wrapper over ``build_training_multibucket``."""
    state, get_step = build_training_multibucket(model, scheduler, cfg,
                                                 freeze_patterns=freeze_patterns, seed=seed)
    return state, get_step(height, width, num_frames)


def build_brushnet_training(model, scheduler: RFLOW, cfg, *, height, width, num_frames,
                            seed: int = 0, simulate_sp: Optional[int] = None,
                            sharding: Optional[ParamSharding] = None):
    """State and step of the BrushNet apps' training over ``model`` (a
    ``MagicDriveSTDiT3BrushNet``, fp32 masters on their device): only the branch
    trains (``lora_trainable_mask`` of ``BRUSHNET_EXTRA_TRAINABLE``; the frozen
    base stops requiring grad), AdamW (lr 5e-5 by default) with the clip, an EMA
    of every parameter (the frozen ones stay as they are), the SDE loss when the
    model is the SDE variant; ``simulate_sp`` as in ``make_train_step``,
    ``sharding`` (the frozen parameters split too) as in
    ``build_training_multibucket``. Returns (state, step)."""
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg.get("dtype", "bf16")]
    mask = lora_trainable_mask(model.named_parameters(), BRUSHNET_EXTRA_TRAINABLE)
    opt = make_optimizer(
        model.named_parameters(), lr=cfg.get("lr", 5e-5),
        weight_decay=cfg.get("weight_decay", 1e-2), adam_eps=cfg.get("adam_eps", 1e-15),
        grad_clip=cfg.get("grad_clip", 1.0), warmup_steps=cfg.get("warmup_steps", 0),
        trainable=mask, sharding=sharding)
    state = TrainState(step=0, model=model, optimizer=opt,
                       ema=copy.deepcopy(model).requires_grad_(False), sharding=sharding)
    step = make_train_step(
        scheduler, height=height, width=width, num_frames=num_frames, dtype=dtype,
        ema_decay=cfg.get("ema_decay", 0.99), ema_mask=mask, seed=seed,
        simulate_sp=simulate_sp)
    return state, step
