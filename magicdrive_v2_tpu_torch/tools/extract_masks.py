"""Offline semantic-mask extraction for the BrushNet training data, on a device
(reference magicdrivedit/datasets/extract_masks.py:1-150: SegFormer cityscapes
inference -> per-camera ``human/`` and ``vehicle/`` binary PNG masks over
samples/ and sweeps/).

Backends: transformers' SegFormer (local weights, e.g. a snapshot of
nvidia/segformer-b5-finetuned-cityscapes-1024-1024; nothing is downloaded; see
``models/segformer.py``); mmsegmentation for the reference's original
checkpoint format, when that package is installed; and ``stub`` (brightness-banded
classes), which keeps the walk and the saving testable without weights. The class
map of each image is grouped on the backend's device; images and PNGs are read and
written on the host through PIL.

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.tools.extract_masks --data-root data/nuscenes \\
      --save-root data/nuscenes_masks --segformer-path /path/to/weights [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..utils.misc import resolve_device, to_tensor

CAMS = ["CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
        "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"]

# cityscapes trainIds (reference extract_masks.py:36-47)
GROUPS = {
    "human": [11, 12, 17, 18],    # person, rider, motorcycle, bicycle
    "vehicle": [13, 14, 15],      # car, truck, bus
}


class TransformersBackend:
    """SegFormer from a local transformers snapshot (``models/segformer.py``); returns
    the cityscapes trainId map (uint8, on ``device``)."""

    def __init__(self, model_path: str, device="cuda"):
        from ..models.segformer import SegformerClassMap
        self.classes = SegformerClassMap(model_path, device=device)
        self.device = self.classes.device

    def __call__(self, image_rgb: np.ndarray) -> torch.Tensor:
        return self.classes(image_rgb).to(torch.uint8)


class MmsegBackend:
    """The reference's mmsegmentation + SegFormer-repo checkpoint path."""

    def __init__(self, config: str, checkpoint: str, device="cuda"):
        from mmseg.apis import inference_segmentor, init_segmentor
        self.device = resolve_device(device)
        self.infer = inference_segmentor
        self.model = init_segmentor(config, checkpoint, device=str(self.device))

    def __call__(self, image_rgb: np.ndarray) -> torch.Tensor:
        seg = self.infer(self.model, image_rgb[:, :, ::-1])[0]
        return torch.as_tensor(np.asarray(seg)).to(self.device, torch.uint8)


class StubBackend:
    """Deterministic fake segmentation (brightness-banded classes) so the directory
    walk and mask grouping are testable without model weights; on ``device``."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def __call__(self, image_rgb) -> torch.Tensor:
        lum = to_tensor(image_rgb, self.device).to(torch.float64).sum(-1) / 3
        return (lum / 256.0 * 19).to(torch.uint8)


def extract(data_root: str, save_root: str, backend, subdirs=("samples", "sweeps"),
            ignore_existing: bool = False, limit: int = 0) -> int:
    """Masks of every JPEG / PNG under ``data_root/<subdir>/<camera>``: one PNG per
    group (255 where the class is in the group) under ``save_root/<group>/<subdir>/
    <camera>``. Returns the number of images."""
    from PIL import Image
    group_ids = {g: torch.tensor(ids, dtype=torch.uint8) for g, ids in GROUPS.items()}
    count = 0
    for sub in subdirs:
        for cam in CAMS:
            cam_dir = os.path.join(data_root, sub, cam)
            if not os.path.isdir(cam_dir):
                continue
            out_dirs = {g: os.path.join(save_root, g, sub, cam) for g in GROUPS}
            for d in out_dirs.values():
                os.makedirs(d, exist_ok=True)
            for name in sorted(os.listdir(cam_dir)):
                if not name.lower().endswith((".jpg", ".png")):
                    continue
                outs = {g: os.path.join(out_dirs[g], os.path.splitext(name)[0] + ".png")
                        for g in GROUPS}
                if ignore_existing and all(os.path.exists(p) for p in outs.values()):
                    continue
                with Image.open(os.path.join(cam_dir, name)) as im:
                    img = np.asarray(im.convert("RGB"))
                seg = backend(img)
                for g, ids in group_ids.items():
                    mask = torch.isin(seg, ids.to(seg.device)).to(torch.uint8) * 255
                    Image.fromarray(mask.cpu().numpy()).save(outs[g])
                count += 1
                if limit and count >= limit:
                    return count
                if count % 100 == 0:
                    print(f"{count} images")
    return count


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True)
    p.add_argument("--save-root", required=True)
    p.add_argument("--backend", choices=["transformers", "mmseg", "stub"],
                   default="transformers")
    p.add_argument("--segformer-path", default="./pretrained/segformer-b5-cityscapes",
                   help="transformers weights dir (nothing is downloaded: must be local)")
    p.add_argument("--config", default="third_party/SegFormer/local_configs/"
                   "segformer/B5/segformer.b5.1024x1024.city.160k.py")
    p.add_argument("--checkpoint", default="./pretrained/segformer.b5.1024x1024."
                   "city.160k.pth")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ignore-existing", action="store_true")
    p.add_argument("--limit", type=int, default=0)
    args = p.parse_args(argv)

    if args.backend == "transformers":
        try:
            backend = TransformersBackend(args.segformer_path, args.device)
        except (OSError, ValueError) as e:
            sys.exit(f"transformers SegFormer backend failed ({e}); pass "
                     f"--segformer-path to local weights or --backend stub")
    elif args.backend == "mmseg":
        backend = MmsegBackend(args.config, args.checkpoint, args.device)
    else:
        backend = StubBackend(args.device)
    n = extract(args.data_root, args.save_root, backend,
                ignore_existing=args.ignore_existing, limit=args.limit)
    print(f"done: {n} images -> {args.save_root}")
    return n


if __name__ == "__main__":
    main()
