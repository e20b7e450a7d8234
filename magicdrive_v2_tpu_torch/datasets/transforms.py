"""Host-side multi-view image transforms (numpy + PIL; the port's own copy of the
JAX package's datasets/transforms.py).

Equivalents of the reference mmdet3d pipeline stages actually used by the generation
configs (configs/dataset/Nuscenes.yaml pipeline; reference
magicdrivedit/mmdet_plugin/datasets/pipelines/transforms_3d.py):

- ImageAug3D (:24-122): resize / bottom-crop / flip / rotate with exact homography
  tracking in `img_aug_matrix` so box projections stay consistent.
- ImageNormalize (:1245): (x/255 - mean) / std, channel-first float32.
- ObjectNameFilter: keep boxes whose class is in `classes`.
- ReorderMultiViewImages (:675): reorder camera views to the model's view order.

Each transform is a callable ``t(data, rng=None)`` over a frame dict (see
datasets/bbox.py for the frame contract, plus "img": list of PIL images,
"ori_shape": (W, H)). ``rng`` is the item's ``np.random.Generator``; a transform that
draws at random (ImageAug3D, GlobalRotScaleTrans with ``is_train``) raises without
one, and draws from it in the JAX package's order.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from PIL import Image

__all__ = ["ImageAug3D", "ImageNormalize", "ObjectNameFilter",
           "ReorderMultiViewImages", "aug_homography"]


def _need_rng(rng, what: str) -> np.random.Generator:
    if rng is None:
        raise ValueError(f"{what} with is_train draws at random: pass rng=")
    return rng


def aug_homography(resize: float, crop: Tuple[int, int, int, int], flip: bool,
                   rotate_deg: float) -> np.ndarray:
    """Compose the 4x4 image-space augmentation homography exactly as the reference
    accumulates it (transforms_3d.py:64-94): scale -> crop translate -> flip about the
    crop center x -> rotate about the crop center."""
    rotation = np.eye(2) * resize
    translation = -np.asarray(crop[:2], np.float64)
    if flip:
        A = np.array([[-1.0, 0.0], [0.0, 1.0]])
        b = np.array([crop[2] - crop[0], 0.0])
        rotation = A @ rotation
        translation = A @ translation + b
    theta = rotate_deg / 180.0 * np.pi
    A = np.array([[np.cos(theta), np.sin(theta)],
                  [-np.sin(theta), np.cos(theta)]])
    b = np.array([crop[2] - crop[0], crop[3] - crop[1]]) / 2.0
    b = A @ (-b) + b
    rotation = A @ rotation
    translation = A @ translation + b
    out = np.eye(4)
    out[:2, :2] = rotation
    out[:2, 3] = translation
    return out.astype(np.float32)


class ImageAug3D:
    def __init__(self, final_dim: Sequence[int], resize_lim: Sequence[float],
                 bot_pct_lim: Sequence[float], rot_lim: Sequence[float],
                 rand_flip: bool, is_train: bool):
        self.final_dim = tuple(final_dim)
        self.resize_lim = tuple(resize_lim)
        self.bot_pct_lim = tuple(bot_pct_lim)
        self.rot_lim = tuple(rot_lim) if rot_lim else (0.0, 0.0)
        self.rand_flip = rand_flip
        self.is_train = is_train

    def sample_augmentation(self, ori_shape: Tuple[int, int],
                            rng: Optional[np.random.Generator] = None):
        W, H = ori_shape
        fH, fW = self.final_dim
        if self.is_train:
            rng = _need_rng(rng, "ImageAug3D")
            resize = float(rng.uniform(*self.resize_lim))
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - rng.uniform(*self.bot_pct_lim)) * newH) - fH
            crop_w = int(rng.uniform(0, max(0, newW - fW)))
            flip = bool(self.rand_flip and rng.integers(0, 2))
            rotate = float(rng.uniform(*self.rot_lim))
        else:
            resize = float(np.mean(self.resize_lim))
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - np.mean(self.bot_pct_lim)) * newH) - fH
            crop_w = int(max(0, newW - fW) / 2)
            flip, rotate = False, 0.0
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        return resize, (newW, newH), crop, flip, rotate

    def __call__(self, data: Dict[str, Any], rng=None) -> Dict[str, Any]:
        new_imgs, mats = [], []
        extra_keys = [k for k in ("human_img", "human_mask") if k in data]
        new_extra = {k: [] for k in extra_keys}
        for vi, img in enumerate(data["img"]):
            resize, resize_dims, crop, flip, rotate = self.sample_augmentation(
                data["ori_shape"], rng)

            def tf(im):
                im = im.resize(resize_dims)
                im = im.crop(crop)
                if flip:
                    im = im.transpose(method=Image.FLIP_LEFT_RIGHT)
                return im.rotate(rotate)

            new_imgs.append(tf(img))
            for k in extra_keys:
                new_extra[k].append(tf(data[k][vi]))
            mats.append(aug_homography(resize, crop, flip, rotate))
        data["img"] = new_imgs
        for k in extra_keys:
            data[k] = new_extra[k]
        data["img_aug_matrix"] = np.stack(mats)
        return data


class ImageNormalize:
    def __init__(self, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, data: Dict[str, Any], rng=None) -> Dict[str, Any]:
        imgs = []
        for img in data["img"]:
            arr = np.asarray(img, np.float32) / 255.0
            arr = (arr - self.mean) / self.std
            imgs.append(arr.transpose(2, 0, 1))  # HWC -> CHW
        data["img"] = np.stack(imgs)  # (NC, 3, H, W)
        if "human_img" in data:
            data["human_img"] = np.stack([
                ((np.asarray(i, np.float32) / 255.0 - self.mean) / self.std
                 ).transpose(2, 0, 1) for i in data["human_img"]])
        if "human_mask" in data:
            data["human_mask"] = np.stack([
                (np.asarray(m, np.float32) / 255.0)[None] for m in data["human_mask"]])
        return data


class ObjectNameFilter:
    def __init__(self, classes: Sequence[str]):
        self.classes = list(classes)

    def __call__(self, data: Dict[str, Any], rng=None) -> Dict[str, Any]:
        labels = np.asarray(data["labels"])
        keep = np.isin(labels, np.arange(len(self.classes)))
        data["boxes"] = np.asarray(data["boxes"])[keep]
        data["labels"] = labels[keep]
        if data.get("tokens") is not None:
            data["tokens"] = [t for t, k in zip(data["tokens"], keep) if k]
        return data


class ReorderMultiViewImages:
    """Reorder views from the annotation order to the model order (reference
    transforms_3d.py:675-770). Applies to images, matrices, and camera params."""

    PER_VIEW_KEYS = ("img", "human_img", "human_mask", "lidar2camera", "lidar2image",
                     "camera_intrinsics", "camera2lidar", "camera2ego",
                     "img_aug_matrix", "image_paths")

    def __init__(self, order: Sequence[int], safe: bool = True):
        self.order = list(order)
        self.safe = safe

    def __call__(self, data: Dict[str, Any], rng=None) -> Dict[str, Any]:
        for key in self.PER_VIEW_KEYS:
            if key not in data or data[key] is None:
                continue
            v = data[key]
            if isinstance(v, (list, tuple)):
                data[key] = [v[i] for i in self.order]
            else:
                data[key] = np.asarray(v)[self.order]
        return data


class GlobalRotScaleTrans:
    """3D augmentation on lidar boxes (reference transforms_3d.py GlobalRotScaleTrans).
    The generation configs run it with identity ranges (scale [1,1], rot [0,0],
    translate 0); implemented for the non-identity training case too."""

    def __init__(self, resize_lim=(1.0, 1.0), rot_lim=(0.0, 0.0), trans_lim=0.0,
                 is_train: bool = True):
        self.resize_lim = tuple(resize_lim or (1.0, 1.0))
        self.rot_lim = tuple(rot_lim or (0.0, 0.0))
        self.trans_lim = trans_lim or 0.0
        self.is_train = is_train

    def __call__(self, data: Dict[str, Any], rng=None) -> Dict[str, Any]:
        if not self.is_train:
            return data
        rng = _need_rng(rng, "GlobalRotScaleTrans")
        scale = float(rng.uniform(*self.resize_lim))
        theta = float(rng.uniform(*self.rot_lim))
        trans = rng.normal(scale=self.trans_lim, size=3) if self.trans_lim \
            else np.zeros(3)
        if scale == 1.0 and theta == 0.0 and not np.any(trans):
            return data
        boxes = np.asarray(data["boxes"], np.float32).copy()
        if len(boxes):
            c, s = np.cos(theta), np.sin(theta)
            rot = np.array([[c, s], [-s, c]], np.float32)
            boxes[:, :2] = boxes[:, :2] @ rot
            boxes[:, 6] += theta
            boxes[:, :6] *= scale
            boxes[:, :3] += trans.astype(np.float32)
            data["boxes"] = boxes
        return data


class Identity:
    """Stub for reference pipeline stages our loader already folds in (image/ann
    loading, DataContainer formatting)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data, rng=None):
        return data


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = [build_transform(t) if isinstance(t, dict) else t
                           for t in transforms]

    def __call__(self, data, rng=None):
        for t in self.transforms:
            data = t(data, rng=rng)
            if data is None:
                return None
        return data


def _reorder_from_names(order):
    """The reference's ReorderMultiViewImages takes camera names; our dataset already
    loads views in `view_order`, so a name list is the identity here."""
    if order and isinstance(order[0], str):
        return Identity()
    return ReorderMultiViewImages(order)


def build_transform(cfg: dict):
    """Instantiate one pipeline stage from a reference-schema dict (type=...)."""
    from .bev import LoadBEVSegmentation
    cfg = dict(cfg)
    kind = cfg.pop("type")
    table = {
        "ImageAug3D": ImageAug3D,
        "ImageHumanMaskAug3D": ImageAug3D,  # same homography; extra keys handled
        "ImageNormalize": ImageNormalize,
        "ObjectNameFilter": ObjectNameFilter,
        "GlobalRotScaleTrans": GlobalRotScaleTrans,
        "LoadBEVSegmentation": LoadBEVSegmentation,
        "ReorderMultiViewImages": lambda order, safe=True: _reorder_from_names(order),
        "ReorderMultiViewImagesHumanMasks": lambda order, safe=True:
            _reorder_from_names(order),
        # folded into the dataset loader / collate:
        "LoadMultiViewImageFromFiles": Identity,
        "LoadMultiViewHumanMaskFromFiles": Identity,
        "LoadAnnotations3D": Identity,
        "DefaultFormatBundle3D": Identity,
        "Collect3D": Identity,
    }
    if kind not in table:
        raise KeyError(f"unknown pipeline transform {kind!r}")
    return table[kind](**cfg)
