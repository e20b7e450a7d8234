"""BrushNet / SDE-BrushNet training app of the port (counterpart of the JAX
package's scripts/train_brushnet.py): config -> the BrushNet model over the
config's base model with seeded random fp32 weights -> synthetic batches with
pedestrian inpaint inputs -> train steps of the branch alone (the base frozen,
``only_train_extra_blocks``), AdamW, EMA -> one checkpoint of the parameters and
the EMA at the end.

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.scripts.train_brushnet \\
      configs/magicdrive/train/brushnet_smoke.py --synthetic [--sde] [--max-steps N] \\
      [--device cuda] [--cfg-options key=value ...]
  torchrun --nproc-per-node N -m magicdrive_v2_tpu_torch.scripts.train_brushnet ...

As in the JAX app the data is synthetic only (``--synthetic`` is accepted for the
same command line): the ``batch_size`` rows of dp row d at step s come from
``np.random.default_rng((seed + d, s))`` (the JAX app's ``seed + dp_offset``), the
conditioning of ``synthetic_batch`` (32 caption tokens, 8x80x80 maps)
from a seed drawn first, then standard-normal pixels ``x_inpaint`` and 0/1 masks
``mask_inpaint`` at the config's image size. ``--sde`` (or the config's
``sde_inpaint``) trains the SDE variant with ``RFLOW_SDEBRUSHNET``'s loss. The
steps draw t, t_inpaint and noise from (seed + 1, step), the SDE model's cutoff
and noise from a second stream of (seed + 1, step), for the global batch. One
JSON line a step; a loss that is not finite stops the run. No resume, as in the
JAX app. Under a launcher the N ranks form the (dp, sp) mesh of
``train_magicdrive`` (sp = min(sp_size, N), dp = N // sp; the state, the frozen
base included, split over dp; the grads averaged over dp and summed over sp;
rank 0 writes the checkpoint, gathered into the one-process format).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import List, Optional

import numpy as np

logger = logging.getLogger("train_brushnet")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic batches (the only data this app trains on)")
    p.add_argument("--sde", action="store_true", help="the SDE-BrushNet variant")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def make_batch(model_cfg, cfg, step: int, dp_row: int = 0) -> dict:
    """The synthetic rows of dp row ``dp_row`` at ``step`` as numpy arrays, drawn as
    the JAX app draws them."""
    from ..pipelines.magicdrive import synthetic_batch
    t_img, (height, width) = cfg.get("num_frames", 9), cfg.get("image_size", (64, 80))
    b, nc = cfg.get("batch_size", 1), model_cfg.nc
    rng = np.random.default_rng((cfg.get("seed", 0) + dp_row, step))
    batch = synthetic_batch(model_cfg, num_frames=t_img, height=height, width=width,
                            l_txt=32, b=b, map_size=(8, 80, 80),
                            seed=int(rng.integers(1 << 31)))
    for k in ("height", "width", "timestep"):
        batch.pop(k)
    batch["x_inpaint"] = rng.standard_normal(
        (b, 3 * nc, t_img, height, width)).astype(np.float32)
    batch["mask_inpaint"] = rng.integers(
        0, 2, (b, nc, t_img, height, width)).astype(np.float32)
    return batch


def brushnet_scheduler(cfg, sde: bool):
    """``RFLOW_SDEBRUSHNET`` (sde) or ``RFLOW_BRUSHNET`` with the config's scheduler
    arguments."""
    from ..schedulers.rf import RFLOW_BRUSHNET, RFLOW_SDEBRUSHNET
    kwargs = {k: v for k, v in dict(cfg.scheduler).items() if k != "type"}
    return (RFLOW_SDEBRUSHNET if sde else RFLOW_BRUSHNET)(**kwargs)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Runs the app; returns the metrics lines it logged (every rank)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from ..parallel.distributed import app_process_group

    with app_process_group(args.device) as device:
        return _main(args, device)


def _main(args, device) -> List[dict]:
    import torch

    from ..config.config import Config, merge_dot_options
    from ..models.magicdrive.brushnet import BrushNetConfig, MagicDriveSTDiT3BrushNet
    from ..models.magicdrive.stdit3 import build_model_config
    from ..parallel.distributed import startup_barrier, training_mesh
    from ..parallel.fsdp import shard_for_training
    from ..parallel.sharding import use_mesh
    from ..training.trainer import build_brushnet_training
    from ..utils.ckpt import init_weights, save_checkpoint
    from ..utils.misc import resolve_device, to_device

    cfg = Config.fromfile(args.config)
    merge_dot_options(cfg, args.cfg_options)
    device = resolve_device(device)
    mesh = training_mesh(cfg.get("sp_size", 1))
    dp, sp, dp_row = (1, 1, 0) if mesh is None else (mesh.dp, mesh.sp, mesh.dp_rank)
    logger.info("mesh: dp=%d sp=%d (rank %d: dp row %d)", dp, sp,
                mesh.rank if mesh is not None else 0, dp_row)
    startup_barrier(mesh)
    sde = args.sde or cfg.get("sde_inpaint", False)
    seed = cfg.get("seed", 0)
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg.get("dtype", "bf16")]
    base_cfg = build_model_config(
        cfg.model, vae_out_channels=cfg.get("vae_out_channels", 16),
        mv_order_map=cfg.get("mv_order_map"), dtype=dtype,
        enable_sequence_parallelism=sp > 1,
        grad_checkpoint=cfg.get("grad_checkpoint", True))
    model_cfg = BrushNetConfig.from_base(
        base_cfg, sde_inpaint=sde,
        brushnet_skip_cross_attn=cfg.get("brushnet_skip_cross_attn", True))
    with torch.device(device):
        model = MagicDriveSTDiT3BrushNet(model_cfg)
    init_weights(model, seed=seed)
    logger.info("params: %d, sde: %s, sp: %d", sum(p.numel() for p in model.parameters()),
                sde, sp)
    scheduler = brushnet_scheduler(cfg, sde)
    t_img, (height, width) = cfg.get("num_frames", 9), cfg.get("image_size", (64, 80))
    state, step_fn = build_brushnet_training(model, scheduler, cfg, height=float(height),
                                             width=float(width), num_frames=t_img,
                                             seed=seed + 1,
                                             sharding=shard_for_training(model, mesh))

    exp_dir = cfg.get("outputs", "outputs/train_brushnet")
    os.makedirs(exp_dir, exist_ok=True)
    steps = args.max_steps or cfg.get("synthetic_steps", 10)
    logged = []
    t0 = time.time()
    for step in range(1, steps + 1):
        batch = to_device(make_batch(model_cfg, cfg, step, dp_row), device)
        with use_mesh(mesh):
            state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        line = {"step": step, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                "elapsed_s": round(time.time() - t0, 1)}
        logger.info(json.dumps(line))
        logged.append(line)
        if not np.isfinite(loss):
            raise FloatingPointError(f"NaN loss at step {step}")
    save_checkpoint(exp_dir, steps, model=state.model, ema=state.ema,
                    sharding=state.sharding)
    logger.info("done")
    return logged


if __name__ == "__main__":
    main()
