"""RePaint latent-editing app of the port (counterpart of the JAX package's
scripts/inference_magicdrive_repaint.py): config -> pipeline with the base model
-> optionally a reference torch checkpoint -> per sample: synthetic conditioning
(seed = sample index), a synthetic reference video (numpy ``default_rng(sample
index)``, 0.2 x standard normal) VAE-encoded to latents, a pixel mask that keeps
the top half of every view, compressed to the latent grid
(``compress_time_for_mask``, then every 8th pixel), ``sample_repaint`` with
two-pass CFG (the known region re-injected after each step until
``ignore_mask_timestep``), VAE decode, the 2x3 six-view grid saved as PNG
frames.

Seeds: one CPU generator per sample, seeded 1024 + sample index, draws the VAE
posterior's noise, then the starting latents, then each step's re-injection
noise.

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.scripts.inference_magicdrive_repaint \\
      configs/magicdrive/inference/XXX_repaint.py --synthetic [--num-frames 17] \\
      [--num-samples 1] [--ignore-mask-timestep 0.0] [--ckpt-path FILE] \\
      [--device cuda] [--cfg-options key=value ...]
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger("inference_repaint")


def compress_time_for_mask(mask: np.ndarray) -> np.ndarray:
    """(..., T_img, H, W) pixel mask -> (..., T_lat, H, W) by the CogVideoX causal
    rule: frame 0 alone, then the maximum over each group of 4 frames (a latent
    frame is masked if any of its pixel frames is)."""
    first = mask[..., :1, :, :]
    rest = mask[..., 1:, :, :]
    t_rest = rest.shape[-3] // 4 * 4
    if not t_rest:
        return first
    rest = rest[..., :t_rest, :, :]
    rest = rest.reshape(rest.shape[:-3] + (t_rest // 4, 4) + rest.shape[-2:]).max(axis=-3)
    return np.concatenate([first, rest], axis=-3)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic conditioning and reference video (the only source)")
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--num-frames", type=int, default=None)
    p.add_argument("--ignore-mask-timestep", type=float, default=None)
    p.add_argument("--ckpt-path", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Tuple[str, np.ndarray]]:
    """Runs the app; returns (path, frames) of every saved sample, the frames as
    the (T, 2H, 3W, 3) uint8 array that was written."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    import torch

    from ..config.config import Config, merge_dot_options
    from ..pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
    from ..schedulers.rf import RFLOW_SLICE_REPAINT
    from ..utils.ckpt import load_reference_weights
    from ..utils.inference_utils import (concat_6_views, resolve_num_frames, save_sample,
                                         to_uint8_video)
    from ..utils.misc import torch_randn_stream

    cfg = Config.fromfile(args.config)
    merge_dot_options(cfg, args.cfg_options)
    num_frames = resolve_num_frames(cfg, args.num_frames, "inference_repaint")
    height, width = cfg.get("image_size", (224, 400))
    out_dir = cfg.get("outputs", "outputs/inference_repaint")
    os.makedirs(out_dir, exist_ok=True)
    imt = (args.ignore_mask_timestep if args.ignore_mask_timestep is not None
           else cfg.get("ignore_mask_timestep", 0.0))

    pipe = MagicDrivePipeline.from_config(cfg, device=args.device)
    loaded = load_reference_weights(pipe.model, cfg, args.ckpt_path)
    if loaded:
        logger.info("loaded %s: %d missing, %d unused keys", loaded[0],
                    len(loaded[1].missing_keys), len(loaded[1].unexpected_keys))
    pipe.prepare_text_embedding()
    # the config's scheduler settings, as the repaint scheduler
    names = {f.name for f in dataclasses.fields(RFLOW_SLICE_REPAINT)}
    sched = RFLOW_SLICE_REPAINT(**{f.name: getattr(pipe.scheduler, f.name)
                                   for f in dataclasses.fields(pipe.scheduler)
                                   if f.name in names and f.name != "slice_cfg"})
    sched = dataclasses.replace(sched, ignore_mask_timestep=imt)

    mc = pipe.model_cfg
    nc, C = mc.nc, mc.in_channels
    saved = []
    for ns in range(args.num_samples or cfg.get("num_sample", 1)):
        batch = synthetic_batch(mc, num_frames, height, width,
                                l_txt=pipe.text_encoder.model_max_length, seed=ns)
        draw = torch_randn_stream(1024 + ns)
        lat_t, lat_h, lat_w = pipe.vae.get_latent_size([num_frames, height, width])
        # the reference video to edit, encoded to latents (C-major over the views)
        ref_px = np.random.default_rng(ns).standard_normal(
            (nc, 3, num_frames, height, width)).astype(np.float32) * 0.2
        ref_lat = pipe.vae.encode(torch.from_numpy(ref_px).to(pipe.device, mc.dtype),
                                  noise=draw((nc, C, lat_t, lat_h, lat_w)))
        ref_z = ref_lat.float().reshape(1, nc, C, lat_t, lat_h, lat_w).transpose(1, 2)
        ref_z = ref_z.reshape(1, C * nc, lat_t, lat_h, lat_w)
        # 1 = the region kept from the reference: the top half of every view
        px_mask = np.zeros((1, nc, num_frames, height, width), np.float32)
        px_mask[..., :height // 2, :] = 1.0
        lat_mask = compress_time_for_mask(px_mask)[..., ::8, ::8][..., :lat_h, :lat_w]
        lat_mask = np.repeat(lat_mask[:, None], C, axis=1).reshape(1, C * nc, lat_t, lat_h,
                                                                    lat_w)
        z = pipe.sample_repaint(
            batch, ref_z, lat_mask, num_frames=num_frames, height=height, width=width,
            guidance_scale=cfg.scheduler.get("cfg_scale", 2.0), scheduler=sched,
            use_map0=bool(cfg.get("use_map0", False)), z0=draw(tuple(ref_z.shape)),
            noise_fn=lambda step, shape: draw(shape))
        vids = pipe.decode(z)
        for bi in range(vids.shape[0]):  # (b, NC, 3, T, H, W) in [-1, 1]
            grid = concat_6_views(vids[bi])
            path = save_sample(grid, os.path.join(out_dir, f"repaint_{ns}_{bi}"))
            saved.append((path, to_uint8_video(grid)))
            logger.info("saved %s", path)
        del vids
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return saved


if __name__ == "__main__":
    main()
