"""Training app of the port: config -> MagicDriveSTDiT3 with seeded random fp32
weights -> synthetic conditioning and latents -> per-bucket train steps (bf16 or
fp32 compute, AdamW, EMA) -> ``metrics.jsonl``, checkpoints, resume, in-training
validation with the EMA weights.

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.scripts.train_magicdrive \\
      configs/magicdrive/train/XXX.py --synthetic [--max-steps N] [--device cuda] \\
      [--cfg-options key=value ...]

One device, one process. Every random stream of a step is derived from (seed,
salt, step) and never advanced across steps, so a run resumed from
``global_step{N}`` (found under ``outputs`` with ``find_latest``) draws what an
uninterrupted run would: the synthetic batch from (seed, step), the frame masks
from salt 3, the condition dropout from salt 4, t and noise from (seed + 1, step).

Not ported yet: the dataset branch (a config with a ``dataset`` needs
``--synthetic``; ROADMAP.md queue A item 3), ``sp_size > 1`` and
``simulate_sp_size`` (queue A item 5), and TensorBoard scalars (the JAX app only
tries them; ``metrics.jsonl`` holds the same numbers).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import random as pyrandom
import time
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger("train")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic conditioning and latents instead of a dataset")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


class SyntheticLoader:
    """Stands in for the dataset loader: the same batch contract, random content.
    The batch of global step ``gi`` (read from ``step_holder`` when it is drawn)
    comes from a seed derived from (seed, gi). Captions are ``l_txt`` tokens long
    (64, as the JAX app draws them)."""

    def __init__(self, model_cfg, cfg, step_holder: Dict[str, int], l_txt: int = 64):
        self.model_cfg = model_cfg
        self.l_txt = l_txt
        self.buckets = [tuple(b) for b in cfg.get("synthetic_buckets", [(9, 224, 400)])]
        self.b = cfg.get("batch_size", 1)
        self.steps = cfg.get("synthetic_steps", 50)
        self.seed = cfg.get("seed", 42)
        self.step_holder = step_holder

    def __len__(self):
        return self.steps

    def __iter__(self):
        from ..pipelines.magicdrive import synthetic_batch
        for _ in range(self.steps):
            gi = self.step_holder["step"]
            t_img, h, w = self.buckets[gi % len(self.buckets)]
            batch = synthetic_batch(
                self.model_cfg, num_frames=t_img, height=h, width=w, l_txt=self.l_txt,
                b=self.b, map_size=(8, 200, 200),
                seed=int(np.random.default_rng((self.seed, gi)).integers(1 << 31)))
            batch["num_frames"] = t_img
            yield batch


def step_rng(seed: int, salt: int, step: int) -> pyrandom.Random:
    """The python generator of one host-side stream at ``step``: derived, never
    advanced."""
    return pyrandom.Random((seed + salt) * 1_000_003 + step)


def step_inputs(batch: dict, cfg, mask_gen, seed: int, step: int):
    """A loader's batch -> (the step's batch with its frame masks and condition
    dropout, (num_frames, height, width) of its bucket), drawn for ``step``."""
    from ..utils.train_utils import sample_condition_dropout
    batch = dict(batch)
    t_img = batch.pop("num_frames")
    h, w = float(batch.pop("height")), float(batch.pop("width"))
    batch.pop("timestep", None)
    b, lat_t = batch["x"].shape[0], batch["x"].shape[2]
    mask_gen.rng = step_rng(seed, 3, step)
    batch["mask"] = mask_gen.get_masks(b, lat_t).astype(np.float32)
    if cfg.get("drop_cond_ratio", 0.0) > 0:
        dc, df = sample_condition_dropout(step_rng(seed, 4, step), b, t_img,
                                          cfg.get("drop_cond_ratio", 0.0),
                                          cfg.get("drop_cond_ratio_t", 0.0))
        batch["drop_cond_mask"], batch["drop_frame_mask"] = dc, df
    return batch, (t_img, h, w)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Runs the app; returns the metrics lines it logged."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    import torch

    from ..config.config import Config, merge_dot_options
    from ..models.magicdrive.stdit3 import MagicDriveSTDiT3, build_model_config
    from ..schedulers.rf import build_scheduler
    from ..training.trainer import build_training_multibucket
    from ..utils.ckpt import find_latest, init_weights, load_checkpoint, save_checkpoint
    from ..utils.misc import resolve_device, to_device
    from ..utils.train_utils import MaskGenerator

    cfg = Config.fromfile(args.config)
    merge_dot_options(cfg, args.cfg_options)
    device = resolve_device(args.device)
    if not args.synthetic and "dataset" in cfg:
        raise NotImplementedError("dataset conditioning is not ported yet; pass --synthetic")
    if int(cfg.get("sp_size", 1) or 1) > 1:
        raise NotImplementedError("sp_size > 1: sequence-parallel training is not ported "
                                  "yet; set sp_size=1")
    if list(cfg.model.get("simulate_sp_size", ()) or cfg.get("simulate_sp_size", ())):
        raise NotImplementedError("simulate_sp_size (the training-time H-pad) is not "
                                  "ported yet (ROADMAP.md queue A item 5)")

    seed0 = int(cfg.get("seed", 42))
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg.get("dtype", "bf16")]
    model_cfg = build_model_config(
        cfg.model, vae_out_channels=cfg.get("vae_out_channels", 16),
        mv_order_map=cfg.get("mv_order_map"), dtype=dtype,
        grad_checkpoint=cfg.get("grad_checkpoint", True),
        remat_policy=cfg.get("remat_policy", "full"))
    with torch.device(device):
        model = MagicDriveSTDiT3(model_cfg)
    init_weights(model, seed=seed0)
    logger.info("model params: %d", sum(p.numel() for p in model.parameters()))
    scheduler = build_scheduler(cfg.scheduler)

    step_holder = {"step": 0}
    loader = SyntheticLoader(model_cfg, cfg, step_holder)
    state, get_step = build_training_multibucket(
        model, scheduler, cfg, freeze_patterns=tuple(cfg.get("freeze_patterns", ())),
        seed=seed0 + 1)

    exp_dir = cfg.get("outputs", "outputs/train")
    os.makedirs(exp_dir, exist_ok=True)
    start_step = 0
    latest = find_latest(exp_dir)
    if latest and cfg.get("resume", True):
        running = load_checkpoint(latest, model=state.model, ema=state.ema,
                                  optimizer=state.optimizer)
        start_step = state.step = int(running.get("step", 0))
        logger.info("resumed from %s at step %d", latest, start_step)

    mask_gen = MaskGenerator(dict(cfg.get("mask_ratios", {})))
    ckpt_every = cfg.get("ckpt_every", 1000)
    log_every = cfg.get("log_every", 10)
    record_time = cfg.get("record_time", False)
    report_every = cfg.get("report_every")
    metrics_path = os.path.join(exp_dir, "metrics.jsonl")
    val = {}
    logged = []
    t_start = time.time()

    def maybe_validate(cur_step, bucket):
        if not report_every or cur_step % report_every != 0:
            return
        from ..utils.train_utils import run_validation
        vt, vh, vw = cfg.get("validation_bucket", bucket)
        if not val:
            val["pipe"], val["batches"] = _validation_pipeline(cfg, model_cfg, vt, vh, vw,
                                                               device)
        paths = run_validation(val["pipe"], val["batches"], num_frames=vt, height=vh,
                               width=vw, out_dir=os.path.join(exp_dir, "validation"),
                               step=cur_step,
                               guidance_scale=cfg.get("val_guidance_scale", 2.0),
                               weights=state.ema if state.ema is not None else state.model)
        logger.info("validation at step %d: %s", cur_step, paths)

    def checkpoint(step, epoch):
        save_checkpoint(exp_dir, step, model=state.model, optimizer=state.optimizer,
                        ema=state.ema, running_states={"epoch": epoch})

    step = start_step
    step_holder["step"] = step
    for epoch in range(cfg.get("epochs", 1)):
        for batch in loader:
            if args.max_steps is not None and step - start_step >= args.max_steps:
                break
            batch, (t_img, h, w) = step_inputs(batch, cfg, mask_gen, seed0, step)
            step_fn = get_step(h, w, t_img)
            t_step = time.time()
            state, metrics = step_fn(state, to_device(batch, device))
            step += 1
            step_holder["step"] = step
            if step % log_every == 0:
                loss = float(metrics["loss"])
                line = {"step": step, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                        "elapsed_s": round(time.time() - t_start, 1)}
                if record_time:
                    line["step_s"] = round(time.time() - t_step, 3)
                logger.info("%s", line)
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(line) + "\n")
                logged.append(line)
                if not np.isfinite(loss):
                    raise FloatingPointError(f"NaN loss at step {step}")
            if step % ckpt_every == 0:
                checkpoint(step, epoch)
            maybe_validate(step, (t_img, int(h), int(w)))

    if step % ckpt_every:  # else the loop has just saved this step
        checkpoint(step, cfg.get("epochs", 1))
    logger.info("done at step %d", step)
    return logged


def _validation_pipeline(cfg, model_cfg, num_frames, height, width, device):
    """The validation renderer: a pipeline of its own (its model in the compute
    dtype; the EMA weights are loaded into it each time), the validation
    scheduler, ``t5-dummy`` text, a tiny seeded VAE decoder (synthetic mode has no
    VAE snapshot), and ``num_validation`` synthetic condition batches."""
    from ..models.vae.cogvideox import CogVAEConfig, VideoAutoencoderKLCogVideoX
    from ..pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
    from ..schedulers.rf import build_scheduler
    from ..utils.ckpt import init_weights

    vae = VideoAutoencoderKLCogVideoX(
        CogVAEConfig(block_out_channels=(8, 8, 8, 16), layers_per_block=1,
                     norm_num_groups=4, dtype=model_cfg.dtype), device=device)
    init_weights(vae.module, seed=0)
    pipe = MagicDrivePipeline(model_cfg, build_scheduler(dict(cfg.get("val_scheduler",
                                                                       cfg.scheduler))),
                              device=device, vae=vae)
    batches = []
    for vi in range(cfg.get("num_validation", 1)):
        vb = synthetic_batch(model_cfg, num_frames=num_frames, height=height, width=width,
                             l_txt=model_cfg.model_max_length, b=1, map_size=(8, 200, 200),
                             seed=1024 + vi)
        for k in ("x", "timestep", "height", "width"):
            vb.pop(k, None)
        batches.append(vb)
    return pipe, batches


if __name__ == "__main__":
    main()
