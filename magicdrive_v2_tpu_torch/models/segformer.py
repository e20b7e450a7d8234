"""A local SegFormer snapshot as a per-pixel class map on a device: the semantic
segmentation behind the pedestrian pipeline's person masks and the BrushNet data's
human / vehicle masks.

The model is transformers' ``SegformerForSemanticSegmentation`` loaded from the
snapshot (nothing is downloaded). The input is prepared as transformers'
``SegformerImageProcessor`` (the class the reference calls) prepares it, from the
snapshot's ``preprocessor_config.json``: a PIL resize of the uint8 image to ``size``
on the host, then the rescale (in float64, stored as float32) and the normalisation
(in float32) on the device. That class itself needs torchvision under transformers 5,
which the port does not depend on, so it is not called. The logits are upsampled
bilinearly to the image and reduced by argmax on the device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.misc import resolve_device, to_host

# SegformerImageProcessor's defaults, for keys a snapshot leaves out
_DEFAULTS = dict(do_resize=True, size={"height": 512, "width": 512}, resample=2,
                 do_rescale=True, rescale_factor=1 / 255, do_normalize=True,
                 image_mean=[0.485, 0.456, 0.406], image_std=[0.229, 0.224, 0.225])


class SegformerClassMap:
    """``__call__(image_rgb)`` -> (H, W) int64 class ids on ``device`` for an RGB
    uint8 (H, W, 3) image."""

    def __init__(self, model_path: str, device="cuda"):
        from transformers import SegformerForSemanticSegmentation
        self.device = resolve_device(device)
        with open(os.path.join(model_path, "preprocessor_config.json")) as f:
            cfg = dict(_DEFAULTS, **json.load(f))
        size = cfg["size"]
        if isinstance(size, int):
            size = {"height": size, "width": size}
        self.size = (int(size["height"]), int(size["width"]))
        self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=self.device)
        self.mean = torch.tensor(cfg["image_mean"], **f32)
        self.std = torch.tensor(cfg["image_std"], **f32)
        self.model = SegformerForSemanticSegmentation.from_pretrained(model_path)
        self.model.to(self.device).eval()

    def pixel_values(self, image_rgb) -> torch.Tensor:
        """(1, 3, h, w) float32 model input of an RGB uint8 image."""
        image = np.asarray(to_host(image_rgb))
        if self.cfg["do_resize"]:
            from PIL import Image
            h, w = self.size
            image = np.asarray(Image.fromarray(np.ascontiguousarray(image)).resize(
                (w, h), resample=int(self.cfg["resample"])))
        x = torch.from_numpy(np.array(image)).to(self.device)
        if self.cfg["do_rescale"]:
            x = (x.to(torch.float64) * float(self.cfg["rescale_factor"])).to(torch.float32)
        if self.cfg["do_normalize"]:
            x = (x.to(torch.float32) - self.mean) / self.std
        return x.permute(2, 0, 1)[None].to(torch.float32).contiguous()

    def __call__(self, image_rgb) -> torch.Tensor:
        with torch.no_grad():
            logits = self.model(pixel_values=self.pixel_values(image_rgb)).logits
        up = torch.nn.functional.interpolate(logits, size=tuple(image_rgb.shape[:2]),
                                             mode="bilinear", align_corners=False)
        return up.argmax(dim=1)[0]
