"""Training app of the port: config -> MagicDriveSTDiT3 with seeded random fp32
weights -> conditioning and latents -> per-bucket train steps (bf16 or fp32
compute, AdamW, EMA) -> ``metrics.jsonl``, checkpoints, resume, in-training
validation with the EMA weights.

Data: with ``--synthetic``, or when the config has no ``dataset``, random
conditions and latents. Else the clips of the config's ``dataset.data.train``
split through the threaded loader (bucketed when the config has a
``bucket_config``; whole scenes of a "full" split pad to ``full_bucket_t``, else to
the split's longest), then the encode stage on the device: the model batch
(``clip_to_model_batch``, box latents from (seed + 13, step)), the VAE encode of
the pixel clips (posterior noise from a CPU generator seeded from (seed + 7,
step)), the text encoder on the captions, the latents in the model's layout
(B, C*NC, T', H', W'). The sampler's position goes into the checkpoint's running
states and is restored on resume; validation renders ``validation_index`` clips of
the ``dataset.data.val`` split.

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.scripts.train_magicdrive \\
      configs/magicdrive/train/XXX.py [--synthetic] [--max-steps N] [--device cuda] \\
      [--cfg-options key=value ...]

One device, one process. Every random stream of a step is derived from (seed,
salt, step) and never advanced across steps, so a run resumed from
``global_step{N}`` (found under ``outputs`` with ``find_latest``) draws what an
uninterrupted run would: the synthetic batch from (seed, step), the frame masks
from salt 3, the condition dropout from salt 4, t and noise from (seed + 1, step);
each dataset item from (seed, epoch, index).

Not ported yet: ``sp_size > 1`` and ``simulate_sp_size`` (ROADMAP.md queue A item
5), and TensorBoard scalars (the JAX app only tries them; ``metrics.jsonl`` holds
the same numbers). With ``record_time`` each metrics line also has the step's
seconds, the seconds it waited on the loader and those of the VAE encode.
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


def build_dataloader(cfg, seed: int):
    """(loader, sampler, dataset) over the config's ``dataset.data.train`` split.
    The config's ``num_frames`` and ``img_collate_param_train`` reach the dataset
    unless the split sets its own."""
    from ..datasets import max_full_clip_len, prepare_multirank_dataloader
    from ..registry import DATASETS, build_module

    if "train" not in cfg.dataset.get("data", {}):
        raise KeyError("the config's dataset has no data.train split")
    ds_cfg = dict(cfg.dataset.data.train)
    ds_cfg.setdefault("video_length", cfg.get("num_frames", 17))
    if "img_collate_param_train" in cfg:
        ds_cfg.setdefault("img_collate_param", dict(cfg.img_collate_param_train))
    ds_cfg.setdefault("seed", seed)
    dataset = build_module(ds_cfg, DATASETS)
    full_bucket_t = cfg.get("full_bucket_t")
    if full_bucket_t is None:
        try:
            full_bucket_t = max_full_clip_len(dataset)
            logger.info("full-length bucket max-T derived from dataset: %d", full_bucket_t)
        except ValueError:  # no "full" clips in this dataset
            full_bucket_t = None
    loader, sampler = prepare_multirank_dataloader(
        dataset, dp_total=1, dp_local=1, bucket_config=dict(cfg.get("bucket_config", {}))
        or None, batch_size=cfg.get("batch_size", 1), full_bucket_t=full_bucket_t,
        shuffle=True, seed=seed, num_workers=cfg.get("num_workers", 4))
    return loader, sampler, dataset


def encode_batch(raw: dict, vae, text_encoder, *, box_latent_dim: Optional[int], seed: int,
                 step: int, device, timing: Optional[dict] = None) -> dict:
    """One collated batch of clips -> the train step's batch for global step
    ``step``: the model batch with box latents from (seed + 13, step), the VAE
    latents of its pixel clips (posterior noise from (seed + 7, step)) in the model
    layout (B, C*NC, T', H', W') fp32 on ``device``, the captions' text
    embeddings. ``timing`` (a dict) gets the encode's seconds, synchronised."""
    import torch

    from ..datasets import clip_to_model_batch
    from ..training.trainer import step_generator
    mb = clip_to_model_batch(raw, box_latent_dim=box_latent_dim,
                             rng=np.random.default_rng((seed + 13, step)))
    t0 = time.time()
    x_px = torch.from_numpy(mb.pop("x")).to(device=device, dtype=vae.dtype)
    lat = vae.encode(x_px, generator=step_generator(seed + 7, step))
    del x_px
    bb = raw["pixel_values"].shape[0]
    C = lat.shape[1]
    x = lat.reshape(bb, lat.shape[0] // bb, C, *lat.shape[2:]).transpose(1, 2).reshape(
        bb, -1, *lat.shape[2:]).float()
    if timing is not None:
        if x.is_cuda:
            torch.cuda.synchronize()
        timing["encode_s"] = time.time() - t0
    batch = dict(mb)
    batch["x"] = x
    batch["y"] = text_encoder.encode(batch.pop("captions"))["y"]
    return batch


class EncodedLoader:
    """The dataset loader followed by ``encode_batch`` for the global step read from
    ``step_holder`` when each batch is drawn. ``timing`` holds the last batch's
    seconds waiting on the loader and encoding."""

    def __init__(self, raw_loader, vae, text_encoder, box_latent_dim, seed: int,
                 step_holder: Dict[str, int], device, record_time: bool = False):
        self.raw_loader = raw_loader
        self.vae, self.text_encoder = vae, text_encoder
        self.box_latent_dim = box_latent_dim
        self.seed = seed
        self.step_holder = step_holder
        self.device = device
        self.record_time = record_time
        self.timing: Dict[str, float] = {}

    def __len__(self):
        return len(self.raw_loader)

    def __iter__(self):
        it = iter(self.raw_loader)
        while True:
            t0 = time.time()
            raw = next(it, None)
            if raw is None:
                return
            self.timing = {"loader_wait_s": time.time() - t0}
            yield encode_batch(raw, self.vae, self.text_encoder,
                               box_latent_dim=self.box_latent_dim, seed=self.seed,
                               step=self.step_holder["step"], device=self.device,
                               timing=self.timing if self.record_time else None)


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
    # a padded full-length bucket anchors each sample's mask to its own latent length
    nfv = batch.get("num_frames_valid")
    lat_valid = None if nfv is None else (np.asarray(nfv).astype(int) - 1) // 4 + 1
    mask_gen.rng = step_rng(seed, 3, step)
    batch["mask"] = mask_gen.get_masks(b, lat_t, valid=lat_valid).astype(np.float32)
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
    from ..pipelines.magicdrive import build_text_encoder, build_vae
    from ..schedulers.rf import build_scheduler
    from ..training.trainer import build_training_multibucket
    from ..utils.ckpt import find_latest, init_weights, load_checkpoint, save_checkpoint
    from ..utils.misc import resolve_device, to_device
    from ..utils.train_utils import MaskGenerator

    cfg = Config.fromfile(args.config)
    merge_dot_options(cfg, args.cfg_options)
    device = resolve_device(args.device)
    synthetic = args.synthetic or "dataset" not in cfg
    if int(cfg.get("sp_size", 1) or 1) > 1:
        raise NotImplementedError("sp_size > 1: sequence-parallel training is not ported "
                                  "yet (ROADMAP.md queue A item 5); set sp_size=1")
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
    record_time = cfg.get("record_time", False)
    vae = text_encoder = sampler = dataset = None
    if synthetic:
        loader = SyntheticLoader(model_cfg, cfg, step_holder)
    else:
        raw_loader, sampler, dataset = build_dataloader(cfg, seed0)
        vae = build_vae(cfg, dtype, device, seed0 + 1)
        text_encoder = build_text_encoder(cfg, device)
        bbox_param = dict(model_cfg.bbox_embedder_param)
        loader = EncodedLoader(raw_loader, vae, text_encoder,
                               bbox_param.get("class_token_dim", 1152)
                               if bbox_param.get("sample_id") else None,
                               seed0, step_holder, device, record_time)
    state, get_step = build_training_multibucket(
        model, scheduler, cfg, freeze_patterns=tuple(cfg.get("freeze_patterns", ())),
        seed=seed0 + 1)

    exp_dir = cfg.get("outputs", "outputs/train")
    os.makedirs(exp_dir, exist_ok=True)
    start_step = 0
    # where the loop stands: the epoch and the batches of it consumed
    pos = {"epoch": 0, "epoch_step": 0}
    latest = find_latest(exp_dir)
    if latest and cfg.get("resume", True):
        running = load_checkpoint(latest, model=state.model, ema=state.ema,
                                  optimizer=state.optimizer)
        start_step = state.step = int(running.get("step", 0))
        pos.update(epoch=int(running.get("epoch", 0)),
                   epoch_step=int(running.get("epoch_step", 0)))
        if sampler is not None and "sampler" in running:
            sampler.load_state_dict(running["sampler"])
        logger.info("resumed from %s at step %d", latest, start_step)

    mask_gen = MaskGenerator(dict(cfg.get("mask_ratios", {})))
    ckpt_every = cfg.get("ckpt_every", 1000)  # 0: no checkpoint at all
    log_every = cfg.get("log_every", 10)
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
            val["pipe"], val["batches"] = _validation_pipeline(
                cfg, model_cfg, vt, vh, vw, device, vae=vae, text_encoder=text_encoder)
        paths = run_validation(val["pipe"], val["batches"], num_frames=vt, height=vh,
                               width=vw, out_dir=os.path.join(exp_dir, "validation"),
                               step=cur_step,
                               guidance_scale=cfg.get("val_guidance_scale", 2.0),
                               weights=state.ema if state.ema is not None else state.model)
        logger.info("validation at step %d: %s", cur_step, paths)

    def checkpoint(step):
        running = dict(pos)
        if sampler is not None:
            running["sampler"] = sampler.state_dict(pos["epoch_step"])
        save_checkpoint(exp_dir, step, model=state.model, optimizer=state.optimizer,
                        ema=state.ema, running_states=running)

    step = start_step
    step_holder["step"] = step

    def done():
        return args.max_steps is not None and step - start_step >= args.max_steps

    for epoch in range(pos["epoch"], cfg.get("epochs", 1)):
        if done():
            break
        pos["epoch"] = epoch
        if sampler is not None:
            sampler.set_epoch(epoch)
            dataset.set_epoch(epoch)
        for batch in loader:
            if done():
                break
            batch, (t_img, h, w) = step_inputs(batch, cfg, mask_gen, seed0, step)
            step_fn = get_step(h, w, t_img)
            t_step = time.time()
            state, metrics = step_fn(state, to_device(batch, device))
            step += 1
            pos["epoch_step"] += 1
            step_holder["step"] = step
            if step % log_every == 0:
                loss = float(metrics["loss"])
                line = {"step": step, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                        "elapsed_s": round(time.time() - t_start, 1)}
                if record_time:
                    line["step_s"] = round(time.time() - t_step, 3)
                    line.update({k: round(v, 3) for k, v in getattr(loader, "timing",
                                                                   {}).items()})
                logger.info("%s", line)
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(line) + "\n")
                logged.append(line)
                if not np.isfinite(loss):
                    raise FloatingPointError(f"NaN loss at step {step}")
            if ckpt_every > 0 and step % ckpt_every == 0:
                checkpoint(step)
            maybe_validate(step, (t_img, int(h), int(w)))
        else:  # the epoch ran to its end
            pos.update(epoch=epoch + 1, epoch_step=0)

    if ckpt_every > 0 and step % ckpt_every:  # else the loop has just saved this step
        checkpoint(step)
    logger.info("done at step %d", step)
    return logged


def _validation_pipeline(cfg, model_cfg, num_frames, height, width, device, vae=None,
                         text_encoder=None):
    """The validation renderer: a pipeline of its own (its model in the compute
    dtype; the EMA weights are loaded into it each time) with the validation
    scheduler. On data: the training VAE and text encoder, and the
    ``validation_index`` clips (at most ``num_validation``) of the
    ``dataset.data.val`` split, each padded to ``num_frames`` when shorter. Else
    ``t5-dummy`` text, a tiny seeded VAE decoder (synthetic mode has no VAE
    snapshot), and ``num_validation`` synthetic condition batches."""
    from ..models.vae.cogvideox import CogVAEConfig, VideoAutoencoderKLCogVideoX
    from ..pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
    from ..schedulers.rf import build_scheduler
    from ..utils.ckpt import init_weights

    scheduler = build_scheduler(dict(cfg.get("val_scheduler", cfg.scheduler)))
    if vae is not None:
        from ..datasets import clip_to_model_batch, collate_clips, pad_model_batch_to_t
        from ..utils.inference_utils import build_val_dataset
        pipe = MagicDrivePipeline(model_cfg, scheduler, text_encoder, device=device, vae=vae)
        val_ds = build_val_dataset(cfg, cfg.get("num_frames", num_frames))
        indices = cfg.get("validation_index", [0])
        if indices == "all":
            indices = list(range(len(val_ds)))
        bb = dict(model_cfg.bbox_embedder_param)
        box_dim = bb.get("class_token_dim", 1152) if bb.get("sample_id") else None
        seed = int(cfg.get("seed", 42))
        batches = []
        for vi, index in enumerate(list(indices)[:cfg.get("num_validation", 4)]):
            vb = clip_to_model_batch(collate_clips([val_ds[index]]), box_latent_dim=box_dim,
                                     rng=np.random.default_rng((seed + 17, vi)))
            if vb["num_frames"] != num_frames:
                vb = pad_model_batch_to_t(vb, num_frames)
            vb["y"] = text_encoder.encode(vb.pop("captions"))["y"]
            batches.append({k: vb[k] for k in ("y", "maps", "bbox", "cams", "rel_pos",
                                               "fps", "frame_valid", "num_frames_valid")
                            if k in vb})
        return pipe, batches
    vae = VideoAutoencoderKLCogVideoX(
        CogVAEConfig(block_out_channels=(8, 8, 8, 16), layers_per_block=1,
                     norm_num_groups=4, dtype=model_cfg.dtype), device=device)
    init_weights(vae.module, seed=0)
    pipe = MagicDrivePipeline(model_cfg, scheduler, device=device, vae=vae)
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
