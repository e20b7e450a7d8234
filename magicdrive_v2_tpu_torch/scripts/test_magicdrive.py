"""W-CODA2024 Track2 benchmark generation app of the port (counterpart of the JAX
package's scripts/test_magicdrive.py; reference scripts/test_magicdrive.py).

Like ``inference_magicdrive``, plus the benchmark's submission plumbing:
- each generated view is back-transformed to the original nuScenes resolution
  (bicubic resize + zero pad, ``post.resize`` / ``post.padding``; e.g. 424x800 ->
  848x1600 + 52 rows on top -> 900x1600), then cut to ``post.cut_length`` frames;
- ``save_mode``: ``single-view`` (one frame directory per camera),
  ``all-in-one`` (the 2x3 grid) or ``image_filename`` (``<scene>/<camera>/NNNN.png``);
  frames are PNG files as ``save_sample`` writes them;
- ``use_map0``: classifier-free guidance against a zeroed map instead of the
  learned null map;
- seeds: two CPU generators seeded with the config's ``seed``, one streaming the
  starting latents across samples, the other the box latents;
- ``num_frames = "full"``: every scene pads to one bucket and is trimmed back;
- ``--brushnet`` / ``--sde`` (or a ``*-BrushNet`` model type): the inpainting
  models, with synthetic pedestrian frames and masks (numpy ``default_rng(sample
  index)``) and, for the SDE model, the inpaint timestep ``inpaint_noise_scale *
  num_timesteps`` and its noise's normal draw from a CPU generator seeded 1024 +
  sample index.

A config with ``sp_size`` > 1 (the 848x1600 ones) runs sequence-parallel over
that many processes (``torchrun --nproc_per_node N``): every rank samples, rank 0
alone back-transforms and writes.

Not ported: ``--ped-video-dir`` (pedestrian grid videos are .mp4 files, and the
port has no video reader; it raises ``NotImplementedError``).

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.scripts.test_magicdrive \\
      configs/magicdrive/test/XXX.py [--synthetic] [--save-mode all-in-one] \\
      [--num-frames 17] [--num-samples 1] [--ckpt-path FILE] [--device cuda] \\
      [--cfg-options key=value ...]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from .inference_magicdrive_brushnet import (PED_VIDEO_MISSING, set_model_type,
                                            synthetic_inpaint_inputs)

logger = logging.getLogger("test")

VIEW_NAMES = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
              "CAM_BACK", "CAM_BACK_LEFT")


def back_transform(vid: np.ndarray, resize_hw, padding) -> np.ndarray:
    """(C, T, H, W) in [-1, 1] -> each frame as uint8 resized bicubically to
    ``resize_hw`` by PIL, then zero-padded by ``padding`` (left, top, right,
    bottom); the result in [-1, 1]."""
    from PIL import Image
    C, T, H, W = vid.shape
    rh, rw = resize_hw
    left, top, right, bottom = padding
    out = np.zeros((C, T, rh + top + bottom, rw + left + right), vid.dtype)
    for t in range(T):
        frame = np.transpose(vid[:, t], (1, 2, 0))  # HWC
        img = Image.fromarray(((np.clip(frame, -1, 1) + 1) * 127.5).astype(np.uint8))
        img = img.resize((rw, rh), Image.BICUBIC)
        arr = np.asarray(img).astype(vid.dtype) / 127.5 - 1.0
        out[:, t, top:top + rh, left:left + rw] = np.transpose(arr, (2, 0, 1))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--num-frames", type=int, default=None)
    p.add_argument("--save-mode", default=None,
                   choices=["single-view", "all-in-one", "image_filename"])
    p.add_argument("--ckpt-path", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--brushnet", action="store_true", help="the BrushNet model")
    p.add_argument("--sde", action="store_true", help="the SDE-BrushNet model")
    p.add_argument("--ped-video-dir", default=None,
                   help="pedestrian grid videos: " + PED_VIDEO_MISSING)
    p.add_argument("--inpaint-noise-scale", type=float, default=None,
                   help="the SDE model's inpaint timestep over num_timesteps")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Tuple[str, np.ndarray]]:
    """Runs the app; returns (path, frames) of every saved video, the frames as the
    (T, H, W, 3) uint8 array that was written. Its last log line gives the run's
    host and device seconds by stage (``timings {json}``)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.ped_video_dir:
        raise NotImplementedError(f"--ped-video-dir {PED_VIDEO_MISSING}")
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
                                         dataset_model_batch, full_bucket_length,
                                         resolve_num_frames, save_sample, to_uint8_video)
    from ..utils.misc import add_box_latent, torch_randn_stream

    t_start = time.time()
    cfg = Config.fromfile(args.config)
    merge_dot_options(cfg, args.cfg_options)
    inpaint = "BrushNet" in set_model_type(cfg, args.brushnet, args.sde)
    save_mode = args.save_mode or cfg.get("save_mode", "single-view")
    use_back_trans = cfg.get("use_back_trans", True)
    post = cfg.get("post", Config(resize=(448, 800), padding=(0, 2, 0, 0)))
    cut_length = post.get("cut_length")
    synthetic = args.synthetic or "dataset" not in cfg
    full_length = cfg.get("num_frames") == "full" and args.num_frames is None and not synthetic
    dataset = None
    if full_length:
        dataset = build_val_dataset(cfg, "full")
        num_frames = full_bucket_length(cfg, dataset)
        logger.info("full-length generation: bucket max-T = %d frames", num_frames)
    else:
        num_frames = resolve_num_frames(cfg, args.num_frames, "test_magicdrive")
        if not synthetic:
            dataset = build_val_dataset(cfg, num_frames)
    height, width = cfg.get("image_size", (224, 400))
    out_dir = cfg.get("outputs", "outputs/test")
    if is_main_process():  # the other ranks write nothing
        os.makedirs(out_dir, exist_ok=True)

    pipe = MagicDrivePipeline.from_config(cfg, device=device)
    startup_barrier(pipe.mesh)
    loaded = load_reference_weights(pipe.model, cfg, args.ckpt_path)
    if loaded:
        logger.info("loaded %s: %d missing, %d unused keys", loaded[0],
                    len(loaded[1].missing_keys), len(loaded[1].unexpected_keys))
    pipe.prepare_text_embedding()
    timings = {"setup_s": time.time() - t_start, "load_s": 0.0, "text_s": 0.0,
               "sample_s": 0.0, "back_transform_s": 0.0, "write_s": 0.0}

    mc = pipe.model_cfg
    if synthetic:
        indices = list(range(args.num_samples or cfg.get("num_sample", 1)))
    else:
        indices = cfg.get("validation_index", [0])
        if indices == "all":
            indices = list(range(len(dataset)))
        indices = list(indices)[:args.num_samples or None]
    use_map0 = bool(cfg.get("use_map0", False))
    draw_z = torch_randn_stream(int(cfg.get("seed", 42)))
    draw_bl = torch_randn_stream(int(cfg.get("seed", 42)))
    bbox_param = dict(cfg.model.get("bbox_embedder_param", {}))
    noise_scale = (args.inpaint_noise_scale if args.inpaint_noise_scale is not None
                   else cfg.scheduler.get("inpaint_noise_scale", 0.2))
    saved = []
    for ns, index in enumerate(indices):
        t0 = time.time()
        if synthetic:
            batch = synthetic_batch(mc, num_frames, height, width,
                                    l_txt=pipe.text_encoder.model_max_length,
                                    caption_channels=mc.caption_channels, seed=ns)
            tag = f"synthetic_{ns}"
            timings["load_s"] += time.time() - t0
        else:
            batch = dataset_model_batch(dataset, index, num_frames if full_length else None)
            tag = f"scene_{index}"
            t1 = time.time()
            timings["load_s"] += t1 - t0
            batch["y"] = pipe.text_encoder.encode(batch.pop("captions"))["y"]
            timings["text_s"] += time.time() - t1
        t_valid = (int(batch["num_frames_valid"][0]) if "num_frames_valid" in batch
                   else num_frames)
        lat_t, lat_h, lat_w = pipe.vae.get_latent_size([num_frames, height, width])
        z = draw_z((1, mc.in_channels * mc.nc, lat_t, lat_h, lat_w))
        if inpaint:
            batch["x_inpaint"], batch["mask_inpaint"] = synthetic_inpaint_inputs(
                ns, mc.nc, num_frames, height, width)
            if mc.sde_inpaint:
                batch["t_inpaint"] = np.full(
                    (1,), noise_scale * pipe.scheduler.num_timesteps, np.float32)
                batch["inpaint_input_noise"] = torch_randn_stream(1024 + ns)(
                    pipe.inpaint_noise_shape(tuple(z.shape), pipe.scheduler.slice_cfg))
        if bbox_param.get("sample_id") and "box_latent" not in batch["bbox"]:
            dim = bbox_param.get("class_token_dim", 1152)
            batch["bbox"] = add_box_latent(batch["bbox"], 1, mc.nc, num_frames,
                                           lambda n: draw_bl((n, dim)))
        t1 = time.time()
        vids = pipe.sample(batch, num_frames=num_frames, height=height, width=width,
                           guidance_scale=cfg.scheduler.get("cfg_scale", 2.0), z=z,
                           use_map0=use_map0)
        vids = vids[:, :, :, :t_valid].cpu().numpy()  # (b, NC, 3, T, H, W)
        timings["sample_s"] += time.time() - t1
        for sample in (vids if is_main_process() else ()):
            if cut_length:
                sample = sample[:, :, :int(cut_length)]
            t1 = time.time()
            if use_back_trans:  # the views in parallel: PIL resizes without the GIL
                with ThreadPoolExecutor(len(sample)) as pool:
                    sample = np.stack(list(pool.map(
                        lambda v: back_transform(v, tuple(post.resize), tuple(post.padding)),
                        sample)))
            t2 = time.time()
            timings["back_transform_s"] += t2 - t1
            if save_mode == "all-in-one":
                outs = [(concat_6_views(sample), os.path.join(out_dir, tag), False)]
            elif save_mode == "single-view":
                outs = [(v, os.path.join(out_dir, f"{tag}_{VIEW_NAMES[vi]}"), False)
                        for vi, v in enumerate(sample)]
            else:  # image_filename: per-frame PNGs in a nuScenes-style layout
                outs = [(v, os.path.join(out_dir, tag, VIEW_NAMES[vi]), True)
                        for vi, v in enumerate(sample)]
            for video, path, force_image in outs:
                saved.append((save_sample(video, path, force_image=force_image),
                              to_uint8_video(video)))
            timings["write_s"] += time.time() - t2
        del vids
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if is_main_process():
            logger.info("sample %d saved (%s)", ns, save_mode)
    if is_main_process():
        logger.info("timings %s", json.dumps(timings))
    return saved


if __name__ == "__main__":
    main()
