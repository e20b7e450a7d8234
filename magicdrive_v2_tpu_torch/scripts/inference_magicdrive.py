"""Generation app of the port: config -> pipeline (model, CogVideoX VAE, text
encoder, rflow scheduler) -> optionally a reference torch checkpoint -> per
sample: conditioning, seeded latents (seed 1024 + sample index: z first, then
the box latents, from one CPU generator), CFG sampling, VAE decode, the 2x3
six-view grid saved as PNG frames.

Conditioning: with ``--synthetic``, or when the config has no ``dataset``, random
conditions; else the clips ``validation_index`` of the config's
``dataset.data.val`` split (boxes, BEV map, camera and ego poses, the caption,
edited by ``force_daytime`` / ``force_rainy`` / ``force_night``). With
``num_frames = "full"`` every scene pads to one bucket (``full_bucket_t``, else the
split's longest scene) and the video is trimmed back to the scene's own length.

A config with ``sp_size`` > 1 runs sequence-parallel over that many processes,
one GPU each (``torchrun --nproc_per_node N``): every rank runs every forward
and rank 0 alone writes the frames.

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.scripts.inference_magicdrive \\
      configs/magicdrive/inference/XXX.py [--synthetic] [--num-frames 17] \\
      [--num-samples 1] [--device cuda] [--cfg-options key=value ...]
  torchrun --nproc_per_node 8 -m magicdrive_v2_tpu_torch.scripts.inference_magicdrive \\
      configs/magicdrive/inference/fullx848x1600_stdit3_CogVAE_boxTDS_wCT_xCE_wSST.py \\
      --synthetic --num-frames 17
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger("inference")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--num-frames", type=int, default=None,
                   help="override the clip length (e.g. 17)")
    p.add_argument("--ckpt-path", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Tuple[str, np.ndarray]]:
    """Runs the app; returns (path, frames) of every saved sample, the frames as
    the (T, 2H, 3W, 3) uint8 array that was written."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from ..parallel.distributed import app_process_group

    with app_process_group(args.device) as device:
        return _main(args, device)


def _main(args, device) -> List[Tuple[str, np.ndarray]]:
    import torch

    from ..config.config import Config, merge_dot_options
    from ..parallel.distributed import is_main_process, startup_barrier
    from ..pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
    from ..utils.ckpt import load_reference_weights
    from ..utils.inference_utils import (build_val_dataset, concat_6_views,
                                         dataset_model_batch, edit_prompt,
                                         full_bucket_length, resolve_num_frames, save_sample,
                                         to_uint8_video)
    from ..utils.misc import add_box_latent, torch_randn_stream

    cfg = Config.fromfile(args.config)
    merge_dot_options(cfg, args.cfg_options)
    synthetic = args.synthetic or "dataset" not in cfg
    full_length = cfg.get("num_frames") == "full" and args.num_frames is None
    dataset = None
    if synthetic:
        num_frames = resolve_num_frames(cfg, args.num_frames, "inference_magicdrive")
    else:
        dataset = build_val_dataset(cfg, args.num_frames or cfg.get("num_frames", 17))
        num_frames = (full_bucket_length(cfg, dataset) if full_length
                      else args.num_frames or int(cfg.get("num_frames", 17)))
        if full_length:
            logger.info("full-length generation: bucket max-T = %d frames", num_frames)
    height, width = cfg.get("image_size", (224, 400))
    out_dir = cfg.get("outputs", "outputs/inference")
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
    bbox_param = dict(cfg.model.get("bbox_embedder_param", {}))

    def get_batch(ns):
        """(conditions, negative prompts or None) of sample ``ns``."""
        if synthetic:
            return synthetic_batch(mc, num_frames, height, width,
                                   l_txt=pipe.text_encoder.model_max_length,
                                   caption_channels=mc.caption_channels, seed=ns), None
        batch = dataset_model_batch(dataset, cfg.validation_index[ns],
                                    num_frames if full_length else None)
        edited, neg = zip(*(edit_prompt(c, force_daytime=cfg.get("force_daytime", False),
                                        force_rainy=cfg.get("force_rainy", False),
                                        force_night=cfg.get("force_night", False))
                            for c in batch.pop("captions")))
        batch["y"] = pipe.text_encoder.encode(list(edited))["y"]
        return batch, ([n or "" for n in neg] if any(n is not None for n in neg) else None)

    n_samples = args.num_samples or cfg.get("num_sample", 1)
    if not synthetic:
        n_samples = len(cfg.get("validation_index", [0])[:args.num_samples or None])
    saved = []
    for ns in range(n_samples):
        batch, neg = get_batch(ns)
        t_valid = (int(batch["num_frames_valid"][0]) if "num_frames_valid" in batch
                   else num_frames)
        draw = torch_randn_stream(1024 + ns)
        lat_t, lat_h, lat_w = pipe.vae.get_latent_size([num_frames, height, width])
        z = draw((1, mc.in_channels * mc.nc, lat_t, lat_h, lat_w))
        if bbox_param.get("sample_id") and "box_latent" not in batch["bbox"]:
            dim = bbox_param.get("class_token_dim", 1152)
            batch["bbox"] = add_box_latent(batch["bbox"], 1, mc.nc, num_frames,
                                           lambda n: draw((n, dim)))
        vids = pipe.sample(batch, num_frames=num_frames, height=height, width=width,
                           guidance_scale=cfg.scheduler.get("cfg_scale", 2.0), z=z,
                           neg_prompts=neg)
        vids = vids[:, :, :, :t_valid]  # a padded scene back to its own length
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
