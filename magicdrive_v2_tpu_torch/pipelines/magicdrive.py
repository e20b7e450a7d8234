"""End-to-end generation pipeline of the port, up to the denoised latents
(counterpart of the JAX package's pipelines/magicdrive.py; the VAE decode is not
ported yet, so ``sample(decode=True)`` raises).

Classifier-free guidance:
- "rflow": batched — cond and null conditions concatenated on the batch axis,
  one model call per step;
- "rflow-slice": two sequential model calls per step.

The step-independent conditioning is embedded once per sample
(``encode_conditions``) and reused by every Euler step.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.magicdrive.stdit3 import (MagicDriveSTDiT3, MagicDriveSTDiT3Config,
                                        cast_model)
from ..models.text_encoder.t5 import DummyTextEncoder
from ..models.vae.cogvideox import get_latent_size
from ..schedulers.rf import RFLOW
from ..utils.inference_utils import add_null_condition, replace_with_null_condition
from ..utils.misc import resolve_device, torch_randn

_MODEL_KEYS = ("y", "maps", "bbox", "cams", "rel_pos", "fps", "frame_valid")


def _to_device(v, device):
    if isinstance(v, dict):
        return {k: _to_device(x, device) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(v)
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return v


class MagicDrivePipeline:
    """Model + scheduler + text encoder on one device.

    ``device`` defaults to ``"cuda"`` and raises when no card is present; pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels.
    """

    def __init__(self, model_cfg: MagicDriveSTDiT3Config, scheduler: RFLOW,
                 text_encoder=None, model: Optional[MagicDriveSTDiT3] = None,
                 device="cuda"):
        self.device = resolve_device(device)
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
        Returns the denoised latents (b, C*NC, T', H', W'), fp32.
        """
        if decode:
            raise NotImplementedError(
                "sample(decode=True) needs the CogVideoX VAE decoder, which is the "
                "next slice of the port; call sample(..., decode=False) for latents")
        sched = self.scheduler
        guidance_scale = guidance_scale if guidance_scale is not None else sched.cfg_scale
        batch = dict(batch)
        if "y" not in batch and "captions" in batch:
            batch["y"] = self.text_encoder.encode(batch.pop("captions"))["y"]

        cfg = self.model_cfg
        nc = cfg.nc
        model_args = {k: _to_device(batch[k], self.device) for k in _MODEL_KEYS
                      if k in batch}
        b = model_args["y"].shape[0]
        lat_t, lat_h, lat_w = get_latent_size([num_frames, height, width])
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
        return sched.sample(predict, z, mask=mask, noise_fn=noise_fn,
                            generator=generator, **hw)


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
