"""Training utilities of the port (counterpart of the JAX package's
utils/train_utils.py): the trainable mask, the warm-up / multi-step learning
rate, AdamW with global-norm clipping, EMA, frame-mask sampling, condition
dropout and in-training validation.

Semantics follow the JAX package's optax chain
``multi_transform({True: chain(clip_by_global_norm, adamw), False: set_to_zero})``:
frozen parameters get no update, no weight decay and no share of the clip norm;
the clip scales the grads by ``max / |g|`` only when ``|g| >= max``; AdamW has
eps outside the square root and its learning rate is the schedule at the update
count before the increment.
"""
from __future__ import annotations

import math
import os
import random as pyrandom
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .ckpt import scanned_group

# ---------------------------------------------------------------------------
# trainable-parameter mask
# ---------------------------------------------------------------------------

# never trained in the reference (torch buffers there, flax params in JAX). In the
# port they are buffers too, so no parameter carries these names; a parameter that
# did would stay frozen, as in the JAX package.
BUFFER_PATTERNS = ("base_token", "y_embedding", "class_tokens")


def flax_style_paths(names: Iterable[str]) -> Dict[str, str]:
    """{name: path}: every parameter name of one model in the '/'-joined form of
    the JAX package's parameter paths, which freeze patterns are written against.
    A block of a layer list becomes its scanned group (``base_blocks_s.3.attn`` ->
    ``ctrl_layers/base_s/attn`` below the control depth, ``plain_layers/...`` from
    there on; ``brush_ctrl_layers`` / ``brush_plain_layers`` in a BrushNet model),
    and '.' becomes '/'. The names tell the layout: the control depth is the
    length of ``control_blocks_s``, and a model with ``brushnet_blocks_*`` is a
    BrushNet model. Leaf and sub-module names stay the torch ones (``weight``,
    not ``kernel``; ``t_inpaint_block/1``, not ``t_inpaint_block_1``)."""
    names = list(names)
    control_depth = len({n.split(".")[1] for n in names if n.startswith("control_blocks_s.")})
    brushnet = any(n.startswith("brushnet_blocks_") for n in names)
    paths = {}
    for name in names:
        parts = name.split(".")
        if len(parts) > 1 and parts[1].isdigit():
            group = scanned_group(parts[0], int(parts[1]), control_depth, brushnet)
            if group is not None:
                parts = list(group) + parts[2:]
        paths[name] = "/".join(parts)
    return paths


def trainable_mask(named_params: Iterable[Tuple[str, torch.Tensor]],
                   freeze_patterns: Sequence[str] = ()) -> Dict[str, bool]:
    """{name: trainable} over every parameter of one model. False for the buffer
    patterns and for every parameter one of ``freeze_patterns`` is a substring
    of, matched against ``flax_style_paths`` (as the JAX package matches its
    '/'-joined paths)."""
    patterns = tuple(freeze_patterns) + BUFFER_PATTERNS
    paths = flax_style_paths(name for name, _ in named_params)
    return {name: not any(p in path for p in patterns) for name, path in paths.items()}


# ---------------------------------------------------------------------------
# learning rate, optimizer, EMA
# ---------------------------------------------------------------------------


def multistep_warmup_schedule(lr: float, warmup_steps: int = 0,
                              milestones: Sequence[int] = (), gamma: float = 0.1):
    """Linear warm-up to ``lr`` over ``warmup_steps`` updates, then ``gamma`` at
    each milestone. ``schedule(count)`` takes the update count before the
    increment: the first update uses ``schedule(0) = lr / warmup_steps``."""
    milestones = sorted(milestones)

    def schedule(count: int) -> float:
        warm = min(1.0, (count + 1) / max(warmup_steps, 1)) if warmup_steps else 1.0
        decay = 1.0
        for m in milestones:
            if count >= m:
                decay *= gamma
        return lr * warm * decay

    return schedule


class ClippedAdamW:
    """Global-norm clipping, then ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps
    outside the root, decoupled weight decay scaled by the learning rate, as optax
    ``adamw``; its fused implementation, which holds no full-size temporaries),
    over the trainable parameters only, with the scheduled learning rate.
    ``step()`` runs after the backward and returns the pre-clip global norm of the
    trainable grads.

    With a ``sharding`` (``parallel.fsdp.ParamSharding``) the parameters of the
    names it splits are this rank's blocks: the squares of their grads are summed
    over the dp group once (the sp ranks of a dp row hold the same block, so not
    over sp), the replicated ones' added as they are; AdamW then updates each
    block, so its moments are blocks too."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 trainable: Dict[str, bool], lr, weight_decay: float = 1e-2,
                 adam_eps: float = 1e-15, grad_clip: float = 1.0,
                 warmup_steps: int = 0, milestones: Sequence[int] = (),
                 gamma: float = 0.1, sharding=None):
        self.schedule = lr if callable(lr) else multistep_warmup_schedule(
            lr, warmup_steps, milestones, gamma)
        named = [(name, p) for name, p in named_params if trainable.get(name, False)]
        self.names = [name for name, _ in named]  # by index of the AdamW state
        self.params = [p for _, p in named]
        self.sharding = sharding
        self.split = [sharding is not None and sharding.dims[name] is not None
                      for name in self.names]
        self.grad_clip = grad_clip
        self.count = 0  # updates taken
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=(0.9, 0.999),
                                       eps=adam_eps, weight_decay=weight_decay,
                                       fused=True)

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def global_norm(self) -> torch.Tensor:
        """The norm of every trainable grad, the split ones' squares summed over dp."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            raise RuntimeError("no trainable parameter has a grad")
        if self.sharding is None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        import torch.distributed as dist

        def squares(split):
            gs = [p.grad for p, s in zip(self.params, self.split)
                  if s == split and p.grad is not None]
            return (torch.stack(torch._foreach_norm(gs)).square().sum() if gs
                    else torch.zeros((), device=grads[0].device))

        total = squares(True)
        dist.all_reduce(total, group=self.sharding.group)
        return (total + squares(False)).sqrt()

    def step(self) -> torch.Tensor:
        norm = self.global_norm()
        grads = [p.grad for p in self.params if p.grad is not None]
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        """``count`` and the AdamW state as ``torch.optim`` keys it (by parameter
        index); under a sharding each moment is this rank's block
        (``utils.ckpt`` gathers them into the one-process form)."""
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])


def make_optimizer(named_params: Iterable[Tuple[str, torch.Tensor]], lr,
                   weight_decay: float = 1e-2, adam_eps: float = 1e-15,
                   grad_clip: float = 1.0, warmup_steps: int = 0,
                   milestones: Sequence[int] = (), gamma: float = 0.1,
                   trainable: Optional[Dict[str, bool]] = None,
                   sharding=None) -> ClippedAdamW:
    """AdamW + warm-up (+ milestones) + clip over the parameters ``trainable``
    marks (all when None), split by ``sharding`` when given. Frozen parameters are
    also set not to require grad, so the backward computes none for them."""
    named_params = list(named_params)
    if trainable is None:
        trainable = {name: True for name, _ in named_params}
    for name, p in named_params:
        if not trainable.get(name, False):
            p.requires_grad_(False)
    return ClippedAdamW(named_params, trainable, lr, weight_decay, adam_eps, grad_clip,
                        warmup_steps, milestones, gamma, sharding)


@torch.no_grad()
def update_ema(ema_model: torch.nn.Module, model: torch.nn.Module, decay: float = 0.9999,
               mask: Optional[Dict[str, bool]] = None):
    """ema = decay * ema + (1 - decay) * param on the fp32 masters; parameters the
    mask marks False stay as they are."""
    own = dict(model.named_parameters())
    ema, src = [], []
    for name, e in ema_model.named_parameters():
        if mask is None or mask.get(name, False):
            ema.append(e)
            src.append(own[name].to(e.dtype))
    if ema:
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, src, alpha=1 - decay)


# ---------------------------------------------------------------------------
# MaskGenerator and condition dropout: host-side, from a random.Random
# ---------------------------------------------------------------------------

VALID_MASK_NAMES = [
    "identity", "quarter_random", "quarter_head", "quarter_tail", "quarter_head_tail",
    "image_random", "image_head", "image_tail", "image_head_tail", "random",
    "intepolate",
]


class MaskGenerator:
    """Per-sample latent-frame masks (True: denoised, False: a condition frame),
    drawn from ``rng`` exactly as the JAX package's generator draws them."""

    def __init__(self, mask_ratios: Dict[str, float], rng: Optional[pyrandom.Random] = None):
        mask_ratios = dict(mask_ratios)
        assert all(k in VALID_MASK_NAMES for k in mask_ratios)
        assert all(0 <= v <= 1 for v in mask_ratios.values())
        if "identity" not in mask_ratios:
            mask_ratios["identity"] = 1.0 - sum(mask_ratios.values())
        assert math.isclose(sum(mask_ratios.values()), 1.0, abs_tol=1e-6)
        self.mask_ratios = mask_ratios
        self.rng = rng or pyrandom.Random()

    def get_mask(self, num_frames: int) -> np.ndarray:
        r = self.rng
        u = r.random()
        acc, name = 0.0, "identity"
        for k, v in self.mask_ratios.items():
            acc += v
            if u < acc:
                name = k
                break

        cond_max = num_frames // 4
        mask = np.ones(num_frames, dtype=bool)
        if num_frames <= 1 or cond_max <= 1:
            return mask
        if name == "quarter_random":
            size = r.randint(1, cond_max)
            pos = r.randint(0, num_frames - size)
            mask[pos:pos + size] = False
        elif name == "image_random":
            pos = r.randint(0, num_frames - 1)
            mask[pos] = False
        elif name == "quarter_head":
            mask[:r.randint(1, cond_max)] = False
        elif name == "image_head":
            mask[:1] = False
        elif name == "quarter_tail":
            mask[-r.randint(1, cond_max):] = False
        elif name == "image_tail":
            mask[-1:] = False
        elif name == "quarter_head_tail":
            size = r.randint(1, cond_max)
            mask[:size] = False
            mask[-size:] = False
        elif name == "image_head_tail":
            mask[:1] = False
            mask[-1:] = False
        elif name == "intepolate":
            mask[r.randint(0, 1)::2] = False
        elif name == "random":
            ratio = r.uniform(0.1, 0.9)
            mask = np.array([r.random() > ratio for _ in range(num_frames)])
        if not mask.any():
            mask[-1] = True
        return mask

    def get_masks(self, batch_size: int, num_frames: int,
                  valid: Optional[np.ndarray] = None) -> np.ndarray:
        """(b, num_frames) masks. ``valid`` (b,) anchors each sample's mask to its
        true latent length inside a padded bucket (pad frames stay False)."""
        if valid is None:
            return np.stack([self.get_mask(num_frames) for _ in range(batch_size)])
        masks = np.zeros((batch_size, num_frames), bool)
        for i in range(batch_size):
            t = min(int(valid[i]), num_frames)
            masks[i, :t] = self.get_mask(t)
        return masks


def sample_condition_dropout(rng: pyrandom.Random, b: int, t: int,
                             drop_cond_ratio: float = 0.15,
                             drop_cond_ratio_t: float = 0.4
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(drop_cond (b,), drop_frame (b, t)), 0 = dropped: with p=drop_cond_ratio a
    sample's conditions drop; given a drop, each frame's drops with
    p=drop_cond_ratio_t."""
    drop_cond = np.ones(b, np.float32)
    drop_frame = np.ones((b, t), np.float32)
    for i in range(b):
        if rng.random() < drop_cond_ratio:
            drop_cond[i] = 0.0
            for j in range(t):
                if rng.random() < drop_cond_ratio_t:
                    drop_frame[i, j] = 0.0
    return drop_cond, drop_frame


# ---------------------------------------------------------------------------
# in-training validation
# ---------------------------------------------------------------------------


def run_validation(pipe, val_batches, *, num_frames: int, height: int, width: int,
                   out_dir: str, step: int, guidance_scale: float = 2.0,
                   weights=None):
    """Render fixed samples with fixed seeds (latents from seed 1024 + index) and
    save each 2x3 grid as PNG frames under ``out_dir``. ``pipe`` is a
    ``MagicDrivePipeline``; ``weights`` (e.g. the EMA module, or its state dict)
    is loaded into its model first, each entry cast to the pipeline's dtype for
    it."""
    from .ckpt import load_state_dict_cast
    from .inference_utils import concat_6_views, save_sample

    if weights is not None:
        load_state_dict_cast(pipe.model, weights if isinstance(weights, dict)
                             else weights.state_dict())
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for vi, batch in enumerate(val_batches):
        vids = pipe.sample(dict(batch), num_frames=num_frames, height=height, width=width,
                           guidance_scale=guidance_scale, torch_seed=1024 + vi)
        for bi in range(vids.shape[0]):
            paths.append(save_sample(concat_6_views(vids[bi]),
                                     os.path.join(out_dir, f"step{step}_val{vi}_{bi}")))
    return paths
