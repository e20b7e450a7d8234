"""End-to-end generation pipeline of the port (counterpart of the JAX package's
pipelines/magicdrive.py): conditions -> CFG Euler sampling of the latents ->
CogVideoX VAE decode of each view. ``from_config`` builds it from an experiment
config.

Classifier-free guidance:
- "rflow": batched — cond and null conditions concatenated on the batch axis,
  one model call per step;
- "rflow-slice": two sequential model calls per step.

The step-independent conditioning is embedded once per sample
(``encode_conditions``) and reused by every Euler step.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config.presets import NUSCENES_CLASSES
from ..models.magicdrive.stdit3 import (MagicDriveSTDiT3, MagicDriveSTDiT3Config,
                                        build_model_config, cast_model)
from ..models.text_encoder.t5 import DummyTextEncoder
from ..models.vae.cogvideox import (CogVAEConfig, VideoAutoencoderKLCogVideoX,
                                    get_latent_size)
from ..registry import MODELS
from ..schedulers.rf import RFLOW, build_scheduler
from ..utils.ckpt import init_weights
from ..utils.inference_utils import add_null_condition, replace_with_null_condition
from ..utils.misc import resolve_device, to_device, torch_randn

logger = logging.getLogger(__name__)

_MODEL_KEYS = ("y", "maps", "bbox", "cams", "rel_pos", "fps", "frame_valid")


class MagicDrivePipeline:
    """Model + scheduler + text encoder + VAE on one device.

    ``device`` defaults to ``"cuda"`` and raises when no card is present; pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels. Without a
    ``vae`` the pipeline samples latents only (``decode=False``).
    """

    def __init__(self, model_cfg: MagicDriveSTDiT3Config, scheduler: RFLOW,
                 text_encoder=None, model: Optional[MagicDriveSTDiT3] = None,
                 device="cuda", vae: Optional[VideoAutoencoderKLCogVideoX] = None):
        self.device = resolve_device(device)
        self.vae = vae
        self.model_cfg = model_cfg
        if model is None:
            with torch.device(self.device):  # parameters are created on the device
                model = MagicDriveSTDiT3(model_cfg)
        self.model = cast_model(model, model_cfg.dtype).to(self.device).eval()
        self.scheduler = scheduler
        if text_encoder is None:
            text_encoder = DummyTextEncoder(model_max_length=model_cfg.model_max_length,
                                            output_dim=model_cfg.caption_channels,
                                            device=self.device)
        self.text_encoder = text_encoder

    @classmethod
    def from_config(cls, cfg, device="cuda") -> "MagicDrivePipeline":
        """Model, VAE, text encoder and scheduler from an experiment config (see
        configs/magicdrive/). Weights without a snapshot are random, seeded by the
        config's ``seed``; a configured VAE snapshot that is missing leaves the VAE
        random with a warning, one that is present but unreadable raises."""
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}.get(
            cfg.get("dtype", "bf16"), torch.bfloat16)
        seed = int(cfg.get("seed", 42))
        if int(cfg.get("sp_size", 1) or 1) > 1:
            raise NotImplementedError(
                "sp_size > 1: sequence-parallel sampling is not ported yet (ROADMAP.md "
                "queue A item 5); set sp_size=1")
        if "BrushNet" in str(cfg.get("model", {}).get("type", "")):
            raise NotImplementedError("BrushNet models are not ported yet (ROADMAP.md queue "
                                      "A item 4)")

        vae = build_vae(cfg, dtype, device, seed + 1)
        model_cfg = build_model_config(
            cfg.model, vae_out_channels=cfg.get("vae_out_channels", 16),
            mv_order_map=cfg.get("mv_order_map"), dtype=dtype)
        text_encoder = build_text_encoder(cfg, device)
        pipe = cls(model_cfg, build_scheduler(cfg.scheduler), text_encoder, device=device,
                   vae=vae)
        init_weights(pipe.model, seed=seed)
        return pipe

    # ------------------------------------------------------------------
    @property
    def uncond_cam(self):
        return self.model.camera_embedder.uncond_cam

    @property
    def uncond_rel_pos(self):
        return self.model.frame_embedder.uncond_cam

    def null_y(self, n: int) -> torch.Tensor:
        self.text_encoder.set_null_embedding(self.model.y_embedder.y_embedding)
        return self.text_encoder.null(n)

    @torch.no_grad()
    def prepare_text_embedding(self):
        """Set the box class tokens to the mean text embedding of each class name
        and the base token to the embedding of the empty caption, both from the
        text encoder."""
        classes = list(getattr(self.text_encoder, "class_names", None) or NUSCENES_CLASSES)

        def embed(text):
            ret = self.text_encoder.encode([text])
            y = self.model.encode_text(ret["y"].to(self.device))
            return y[0, :int(ret["mask"].sum())].float()

        tokens = self.model.bbox_embedder._class_tokens
        for i, name in enumerate(classes):
            tokens[i] = embed(name).mean(dim=0).to(tokens.dtype)
        self.model.base_token.copy_(embed("")[0])

    # ------------------------------------------------------------------
    def _build_predict_fn(self, model_args: Dict, guidance_scale: float,
                          slice_cfg: bool, z_shape=None, null_y=None,
                          use_map0: bool = False) -> Callable:
        """predict(z, t, x_mask) -> CFG-combined velocity. model_args hold the
        conditioning of the conditional half; z_shape (the latent shape) enables
        the per-sample condition cache."""
        model = self.model
        scale = guidance_scale
        if null_y is None:
            null_y = self.null_y(model_args["y"].shape[0])

        def cond_cache_for(args, shape):
            return model.encode_conditions(
                tuple(shape), args["y"], args["maps"], args.get("bbox"), args["cams"],
                args["rel_pos"], frame_valid=args.get("frame_valid"))

        def keep_in(pred, z_in):
            if pred.shape[1] == z_in.shape[1] * 2:  # learned-sigma half is dropped
                pred = pred.chunk(2, dim=1)[0]
            return pred

        if not slice_cfg:
            args2 = add_null_condition(model_args, self.uncond_cam, self.uncond_rel_pos,
                                       use_map0=use_map0)
            args2["y"] = torch.cat([model_args["y"], null_y.to(model_args["y"])], dim=0)
            cache2 = cond_cache_for(args2, (2 * z_shape[0],) + tuple(z_shape[1:])) \
                if z_shape is not None else None

            def predict(z, t, x_mask):
                z_in = torch.cat([z, z], dim=0)
                t_in = torch.cat([t, t], dim=0)
                xm = None if x_mask is None else torch.cat([x_mask, x_mask], 0)
                pred = keep_in(model(z_in, t_in, **args2, x_mask=xm, cond_cache=cache2), z_in)
                cond, uncond = pred.chunk(2, dim=0)
                return uncond + scale * (cond - uncond)

            return predict

        null_args = replace_with_null_condition(
            model_args, self.uncond_cam, self.uncond_rel_pos, null_y.to(model_args["y"]),
            ["y", "bbox", "cams", "rel_pos"] + (["maps"] if use_map0 else []))
        cache_c = cond_cache_for(model_args, z_shape) if z_shape is not None else None
        cache_n = cond_cache_for(null_args, z_shape) if z_shape is not None else None

        def predict(z, t, x_mask):
            def run(args, cache):
                return keep_in(model(z, t, **args, x_mask=x_mask, cond_cache=cache), z)
            all_pred = run(model_args, cache_c)
            null_pred = run(null_args, cache_n)
            return null_pred + scale * (all_pred - null_pred)

        return predict

    @torch.no_grad()
    def sample(self, batch: Dict, *, num_frames: int, height: int, width: int,
               generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
               guidance_scale: Optional[float] = None, decode: bool = True,
               torch_seed: Optional[int] = None, neg_prompts: Optional[list] = None,
               use_map0: bool = False, noise_fn: Optional[Callable] = None):
        """Generate one sample per batch row.

        batch: dict with y (b, 1, L, 4096) [or 'captions' strings], maps, bbox,
        cams, rel_pos, fps (numpy arrays or tensors). num_frames/height/width:
        the pixel-space target. The starting latent comes from ``z``, else from
        the CPU generator seeded with ``torch_seed``, else from ``generator``.
        Returns the decoded views (b, NC, 3, T, H, W), fp32; with
        ``decode=False`` the denoised latents (b, C*NC, T', H', W'), fp32.
        """
        if decode and self.vae is None:
            raise ValueError("sample(decode=True) needs a VAE: build the pipeline with "
                             "vae= or from_config, or pass decode=False")
        sched = self.scheduler
        guidance_scale = guidance_scale if guidance_scale is not None else sched.cfg_scale
        batch = dict(batch)
        if "y" not in batch and "captions" in batch:
            batch["y"] = self.text_encoder.encode(batch.pop("captions"))["y"]

        cfg = self.model_cfg
        nc = cfg.nc
        model_args = {k: to_device(batch[k], self.device) for k in _MODEL_KEYS
                      if k in batch}
        b = model_args["y"].shape[0]
        lat_t, lat_h, lat_w = (self.vae.get_latent_size if self.vae is not None
                               else get_latent_size)([num_frames, height, width])
        if z is None:
            z_shape = (b, cfg.in_channels * nc, lat_t, lat_h, lat_w)
            if torch_seed is not None or generator is None:
                z = torch_randn(z_shape, seed=torch_seed)
            else:
                z = torch.randn(z_shape, generator=generator, device=generator.device)
        z = torch.as_tensor(z, dtype=torch.float32).to(self.device)

        if neg_prompts is not None:
            ny = self.text_encoder.encode(list(neg_prompts))["y"].to(self.device)
            null_y = ny.expand((b,) + tuple(ny.shape[1:])) if ny.shape[0] != b else ny
        else:
            null_y = self.null_y(b)

        predict = self._build_predict_fn(
            {**model_args, "height": float(height), "width": float(width)},
            float(guidance_scale), sched.slice_cfg, z_shape=tuple(z.shape),
            null_y=null_y, use_map0=use_map0)
        nf_valid = batch.get("num_frames_valid")
        hw = dict(height=torch.full((b,), float(height)),
                  width=torch.full((b,), float(width)),
                  num_frames=torch.full((b,), float(num_frames)) if nf_valid is None
                  else torch.as_tensor(nf_valid, dtype=torch.float32))
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32).to(self.device)
        latents = sched.sample(predict, z, mask=mask, noise_fn=noise_fn,
                               generator=generator, **hw)
        return self.decode(latents) if decode else latents

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, C*NC, T', H', W') latents -> (b, NC, 3, T, H, W) fp32 video, every
        view decoded in the VAE's dtype."""
        b, _, t, h, w = latents.shape
        C, nc = self.model_cfg.in_channels, self.model_cfg.nc
        lat = latents.reshape(b, C, nc, t, h, w).transpose(1, 2).reshape(b * nc, C, t, h, w)
        vids = self.vae.decode(lat.to(self.vae.dtype))
        return vids.float().reshape(b, nc, *vids.shape[1:])


def build_vae(cfg, dtype, device, seed: int) -> VideoAutoencoderKLCogVideoX:
    """The config's VAE (``vae.type`` from the registry, default the CogVideoX VAE):
    a configured snapshot's weights, else (the snapshot absent) random weights
    seeded with ``seed`` and a warning; a snapshot that is present but unreadable
    raises."""
    vae_kw = dict(cfg.get("vae", {}))
    vae_cls = MODELS.get(vae_kw.pop("type", "VideoAutoencoderKLCogVideoX"))
    tiling_px = cfg.get("vae_tiling")  # N: tiled decode with N-pixel tiles
    if tiling_px and "tiling" not in vae_kw:
        vae_kw["tiling"] = dict(tile_sample_min_height=int(tiling_px),
                                tile_sample_min_width=int(tiling_px))
    vae = vae_cls(CogVAEConfig(dtype=dtype), device=device, **vae_kw)
    loaded = False
    if vae.from_pretrained:
        try:
            vae.load_pretrained()
            loaded = True
            logger.info("VAE: loaded pretrained weights from %s", vae.from_pretrained)
        except FileNotFoundError as e:  # absent; a malformed snapshot raises
            logger.warning(
                "VAE pretrained weights unavailable (%s) - USING RANDOM INIT; "
                "decoded videos will be noise. Point vae.from_pretrained at a local "
                "CogVideoX VAE snapshot.", e)
    if not loaded:
        init_weights(vae.module, seed=seed)
    return vae


def build_text_encoder(cfg, device):
    """The config's text encoder; a missing snapshot or package falls back to
    ``t5-dummy`` (a warning says so), a wrong type or argument raises."""
    te_cfg = dict(cfg.get("text_encoder", {"type": "t5-dummy"}))
    te_kind = te_cfg.pop("type", "t5-dummy")
    try:
        text_encoder = MODELS.get(te_kind)(**te_cfg, device=device)
    except (OSError, ImportError, ValueError) as e:
        # only a missing snapshot or package falls back; a wrong type or
        # argument (KeyError, TypeError) fails
        logger.warning("text encoder %r unavailable (%s); using t5-dummy", te_kind, e)
        text_encoder = MODELS.get("t5-dummy")(
            model_max_length=te_cfg.get("model_max_length", 300), device=device)
    return text_encoder


def synthetic_batch(model_cfg, num_frames: int, height: int, width: int,
                    l_box: int = 10, l_txt: int = 300, caption_channels: int = 4096,
                    b: int = 1, map_size=(8, 400, 400), seed: int = 0) -> Dict:
    """Shape-correct synthetic conditioning as numpy arrays, drawn in the same
    order from the same numpy generator as the JAX package's ``synthetic_batch``,
    so both packages get identical inputs."""
    rng = np.random.default_rng(seed)
    nc = model_cfg.nc
    vae_t = 1 if num_frames == 1 else (num_frames - 1) // 4 + 1
    x = rng.standard_normal((b, model_cfg.in_channels * nc, vae_t, height // 8,
                             width // 8), np.float32)
    bbox_param = dict(model_cfg.bbox_embedder_param)
    batch = dict(
        x=x,
        timestep=np.full((b,), 500.0, np.float32),
        y=rng.standard_normal((b, 1, l_txt, caption_channels), np.float32),
        maps=rng.random((b, num_frames) + tuple(map_size), np.float32),
        bbox=dict(
            bboxes=rng.standard_normal((b * nc, num_frames, l_box, 8, 3), np.float32) * 10,
            classes=rng.integers(0, bbox_param.get("n_classes", 10),
                                 (b * nc, num_frames, l_box)).astype(np.int32),
            masks=rng.integers(0, 2, (b * nc, num_frames, l_box)).astype(np.int32),
        ),
        cams=rng.standard_normal((b * nc, num_frames, 1, 3, 7), np.float32),
        rel_pos=np.broadcast_to(np.eye(4, dtype=np.float32),
                                (b * nc, num_frames, 1, 4, 4)).copy(),
        fps=np.full((b,), 12.0, np.float32),
        height=float(height),
        width=float(width),
    )
    if bbox_param.get("sample_id"):
        dim = bbox_param.get("class_token_dim", 1152)
        batch["bbox"]["box_latent"] = rng.standard_normal(
            (b * nc, num_frames, l_box, dim), np.float32)
    return batch
