"""BrushNet inpainting generation app of the port (counterpart of the JAX
package's scripts/inference_magicdrive_brushnet.py): config -> pipeline with the
BrushNet or SDE-BrushNet model -> optionally a reference torch checkpoint -> per
sample: synthetic conditioning (seed = sample index), synthetic pedestrian
frames and masks (numpy ``default_rng(sample index)``: frames first, then the
0/1 masks), CFG sampling, VAE decode, the 2x3 six-view grid saved as PNG frames.

The SDE variant (``--sde``, or an SDE model type in the config) takes the fixed
inpaint timestep ``inpaint_noise_scale * num_timesteps`` (``--inpaint-noise-scale``,
else the scheduler's, else 0.2). Seeds: one CPU generator per sample, seeded
1024 + sample index, draws the starting latents, then the normal draw the SDE
model's structured noise is made from.

Not ported: ``--ped-dir`` (the pedestrian renders are .mp4 files, and the port
has no video reader; it raises ``NotImplementedError``).

A config with ``sp_size`` > 1 runs sequence-parallel over that many processes
(``torchrun --nproc_per_node N``), as ``inference_magicdrive`` does.

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.scripts.inference_magicdrive_brushnet \\
      configs/magicdrive/inference/XXX_brushnet.py --synthetic [--sde] \\
      [--num-frames 17] [--num-samples 1] [--inpaint-noise-scale 0.2] \\
      [--ckpt-path FILE] [--device cuda] [--cfg-options key=value ...]
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger("inference_brushnet")

PED_VIDEO_MISSING = ("reads pedestrian renders from .mp4 files, and the port has no video "
                     "reader (imageio is not one of its dependencies); use --synthetic")


def synthetic_inpaint_inputs(seed: int, nc: int, num_frames: int, height: int, width: int):
    """(x_inpaint (1, 3*NC, T, H, W) standard normal, mask_inpaint (1, NC, T, H, W)
    of 0/1), float32, from numpy ``default_rng(seed)`` in that order."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 3 * nc, num_frames, height, width)).astype(np.float32)
    mask = rng.integers(0, 2, (1, nc, num_frames, height, width)).astype(np.float32)
    return x, mask


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic conditioning and pedestrian inputs (the only source)")
    p.add_argument("--sde", action="store_true", help="the SDE-BrushNet model")
    p.add_argument("--ped-dir", default=None, help="pedestrian renders: " + PED_VIDEO_MISSING)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--num-frames", type=int, default=None)
    p.add_argument("--inpaint-noise-scale", type=float, default=None)
    p.add_argument("--ckpt-path", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def set_model_type(cfg, brushnet: bool, sde: bool) -> str:
    """The config's model type after ``--brushnet`` / ``--sde`` (an SDE request
    turns any type into the SDE-BrushNet one, a BrushNet request a base type
    into the BrushNet one)."""
    model_type = str(cfg.model.get("type", ""))
    if sde and "SDE" not in model_type:
        cfg.model["type"] = model_type = "MagicDriveSTDiT3-XL/2-SDEBrushNet"
    elif brushnet and "BrushNet" not in model_type:
        cfg.model["type"] = model_type = "MagicDriveSTDiT3-XL/2-BrushNet"
    return model_type


def main(argv: Optional[List[str]] = None) -> List[Tuple[str, np.ndarray]]:
    """Runs the app; returns (path, frames) of every saved sample, the frames as
    the (T, 2H, 3W, 3) uint8 array that was written."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.ped_dir:
        raise NotImplementedError(f"--ped-dir {PED_VIDEO_MISSING}")
    from ..parallel.distributed import app_process_group

    with app_process_group(args.device) as device:
        return _main(args, device)


def _main(args, device) -> List[Tuple[str, np.ndarray]]:
    import torch

    from ..config.config import Config, merge_dot_options
    from ..parallel.distributed import is_main_process, startup_barrier
    from ..pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
    from ..utils.ckpt import load_reference_weights
    from ..utils.inference_utils import (concat_6_views, resolve_num_frames, save_sample,
                                         to_uint8_video)
    from ..utils.misc import torch_randn_stream

    cfg = Config.fromfile(args.config)
    merge_dot_options(cfg, args.cfg_options)
    set_model_type(cfg, brushnet=True, sde=args.sde)
    num_frames = resolve_num_frames(cfg, args.num_frames, "inference_brushnet")
    height, width = cfg.get("image_size", (224, 400))
    out_dir = cfg.get("outputs", "outputs/inference_brushnet")
    if is_main_process():  # the other ranks write nothing
        os.makedirs(out_dir, exist_ok=True)

    pipe = MagicDrivePipeline.from_config(cfg, device=device)
    startup_barrier(pipe.mesh)
    loaded = load_reference_weights(pipe.model, cfg, args.ckpt_path)
    if loaded:
        logger.info("loaded %s: %d missing, %d unused keys", loaded[0],
                    len(loaded[1].missing_keys), len(loaded[1].unexpected_keys))
    pipe.prepare_text_embedding()

    mc = pipe.model_cfg
    noise_scale = (args.inpaint_noise_scale if args.inpaint_noise_scale is not None
                   else cfg.scheduler.get("inpaint_noise_scale", 0.2))
    saved = []
    for ns in range(args.num_samples or cfg.get("num_sample", 1)):
        batch = synthetic_batch(mc, num_frames, height, width,
                                l_txt=pipe.text_encoder.model_max_length, seed=ns)
        batch["x_inpaint"], batch["mask_inpaint"] = synthetic_inpaint_inputs(
            ns, mc.nc, num_frames, height, width)
        draw = torch_randn_stream(1024 + ns)
        lat_t, lat_h, lat_w = pipe.vae.get_latent_size([num_frames, height, width])
        z = draw((1, mc.in_channels * mc.nc, lat_t, lat_h, lat_w))
        if mc.sde_inpaint:
            batch["t_inpaint"] = np.full((1,), noise_scale * pipe.scheduler.num_timesteps,
                                         np.float32)
            batch["inpaint_input_noise"] = draw(
                pipe.inpaint_noise_shape(tuple(z.shape), pipe.scheduler.slice_cfg))
        vids = pipe.sample(batch, num_frames=num_frames, height=height, width=width, z=z)
        for bi in range(vids.shape[0] if is_main_process() else 0):  # (b, NC, 3, T, H, W)
            grid = concat_6_views(vids[bi])
            path = save_sample(grid, os.path.join(out_dir, f"sample_{ns}_{bi}"))
            saved.append((path, to_uint8_video(grid)))
            logger.info("saved %s", path)
        del vids
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return saved


if __name__ == "__main__":
    main()
