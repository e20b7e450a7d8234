"""Per-clip 3D-box preprocessing into fixed-width token arrays (the port's own copy
of the JAX package's datasets/bbox.py).

The reference's two bbox processors (reference
magicdrivedit/datasets/nuscenes_t_dataset.py:200-512) over plain numpy "frame" dicts:

    frame = {
        "boxes":   (N, >=7) float32 lidar boxes, bottom-center convention,
        "labels":  (N,) int,
        "tokens":  list[str] per-box instance ids (processor 2),
        "lidar2camera": (NC, 4, 4), "lidar2image": (NC, 4, 4),
        "img_aug_matrix": (NC, 4, 4),
    }

Processor 2 ("keep_all", token-aligned) is what the temporal bbox embedder consumes:
each instance id owns one token slot across all T frames, so the temporal
mini-transformer in ContinuousBBoxWithTextTempEmbedding sees per-instance trajectories.
Masks: 1 = visible, 0 = absent/off-view, -1 = dropped (non-keyframe bbox dropout).

The random draws (box dropout, added boxes) come from the ``rng`` the caller passes
(a ``random.Random``), in the JAX package's order; a draw without one raises.
"""
from __future__ import annotations

import random as pyrandom
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .geometry import (boxes_to_corners, ensure_canvas, ensure_positive_z,
                       trans_boxes_to_views)

__all__ = ["preprocess_bbox_keep_all", "preprocess_bbox", "pad_bboxes_to_maxlen",
           "CXYZ_CORNER_INDEX"]

# 'cxyz' mode keeps corners x1y1z1, x1y0z1, x1y1z0, x0y1z1 (reference :338-340)
CXYZ_CORNER_INDEX = [6, 5, 7, 2]


def _corners_for_mode(boxes: np.ndarray, bbox_mode: str) -> np.ndarray:
    corners = boxes_to_corners(boxes)
    if bbox_mode == "cxyz":
        return corners[:, CXYZ_CORNER_INDEX]
    if bbox_mode == "all-xyz":
        return corners
    raise NotImplementedError(f"Wrong mode {bbox_mode}")


def _view_visibility(frame: dict, use_3d_filter: bool,
                     canvas_size: Tuple[int, int]) -> List[np.ndarray]:
    """Per-camera visibility masks for one frame's boxes."""
    boxes = frame["boxes"]
    if use_3d_filter:
        coords_list = trans_boxes_to_views(boxes, frame["lidar2camera"], None, False)
        return [ensure_positive_z(c) for c in coords_list]
    coords_list = trans_boxes_to_views(boxes, frame["lidar2image"],
                                       frame.get("img_aug_matrix"), True)
    return [ensure_canvas(c, canvas_size) for c in coords_list]


def _need_rng(rng):
    if rng is None:
        raise ValueError("bbox dropout / addition draws at random: pass rng=")
    return rng


def _random_0_to_1(mask: np.ndarray, num: int, rng) -> np.ndarray:
    inds = np.where(mask == 0)[0].tolist()
    rng.shuffle(inds)
    mask = np.copy(mask)
    mask[inds[:num]] = 1
    return mask


def preprocess_bbox_keep_all(
        bbox_mode: str, canvas_size: Tuple[int, int], frames: Sequence[dict],
        is_train: bool = True, view_shared: bool = False, use_3d_filter: bool = True,
        bbox_add_ratio: float = 0, bbox_add_num: int = 0, bbox_drop_ratio: float = 0,
        keyframe_rate: int = 1, rng: Optional[pyrandom.Random] = None
) -> Optional[Dict[str, np.ndarray]]:
    """Token-aligned processor (reference `_preprocess_bbox_keep_all`, :200-359).

    Returns {"bboxes": (T, 1, max_len, P, 3), "classes": (T, 1, max_len) int32,
    "masks": (T, NC, max_len) float32 with values in {1, 0, -1}} or None if the clip
    has no boxes at all.
    """
    possible_tokens = sorted(set(t for f in frames for t in f.get("tokens", [])))
    max_len = len(possible_tokens)
    if max_len == 0:
        return None
    token_idx = {tok: i for i, tok in enumerate(possible_tokens)}

    T = len(frames)
    n_cam = len(frames[0]["lidar2image"])
    point_dim = 4 if bbox_mode == "cxyz" else 8
    bboxes_out = np.zeros((T, 1, max_len, point_dim, 3), np.float32)
    classes_out = -np.ones((T, 1, max_len), np.int32)
    mask_out = np.zeros((T, n_cam, max_len), np.float32)

    for ti, frame in enumerate(frames):
        boxes, labels = frame["boxes"], frame["labels"]
        tokens = frame.get("tokens", [])
        if len(boxes) == 0:
            continue
        drop_frame = (ti % keyframe_rate != 0 and is_train
                      and _need_rng(rng).random() < bbox_drop_ratio)
        if view_shared:
            vis = [np.ones(len(boxes), bool)] * n_cam
        else:
            vis = _view_visibility(frame, use_3d_filter, canvas_size)
            if bbox_add_ratio > 0 and is_train:
                vis = [_random_0_to_1(m, bbox_add_num, rng)
                       if _need_rng(rng).random() < bbox_add_ratio else m for m in vis]
        for ci, c_mask in enumerate(vis):
            for bi in np.where(c_mask)[0]:
                mask_out[ti, ci, token_idx[tokens[bi]]] = 1
        if drop_frame:
            mask_out[ti] = -mask_out[ti]
        corners = _corners_for_mode(boxes, bbox_mode)
        for box, cls, tok in zip(corners, labels, tokens):
            idx = token_idx[tok]
            bboxes_out[ti, 0, idx] = box
            classes_out[ti, 0, idx] = cls
    return {"bboxes": bboxes_out, "classes": classes_out, "masks": mask_out}


def preprocess_bbox(
        bbox_mode: str, canvas_size: Tuple[int, int], frames: Sequence[dict],
        is_train: bool = True, view_shared: bool = False, use_3d_filter: bool = True,
        bbox_add_ratio: float = 0, bbox_add_num: int = 0, bbox_drop_ratio: float = 0,
        keyframe_rate: int = 1, rng: Optional[pyrandom.Random] = None
) -> Optional[Dict[str, np.ndarray]]:
    """Per-frame padded processor (reference `_preprocess_bbox`, :362-481).

    Returns {"bboxes": (T, N_out, max_len, P, 3), "classes": int64, "masks": bool}
    where N_out = 1 when view_shared else NC; max_len is the per-clip max count.
    """
    T = len(frames)
    n_cam = len(frames[0]["lidar2image"])
    n_out = 1 if view_shared else n_cam

    per_frame: List[Optional[Tuple[np.ndarray, np.ndarray, List[np.ndarray]]]] = []
    max_len = 0
    point_dim = 4 if bbox_mode == "cxyz" else 8
    for ti, frame in enumerate(frames):
        boxes, labels = frame["boxes"], frame["labels"]
        if len(boxes) == 0:
            per_frame.append(None)
            continue
        if (ti % keyframe_rate != 0 and is_train
                and _need_rng(rng).random() < bbox_drop_ratio):
            per_frame.append(None)
            continue
        if view_shared:
            vis = [np.ones(len(boxes), bool)]
        else:
            vis = _view_visibility(frame, use_3d_filter, canvas_size)
            if bbox_add_ratio > 0 and is_train:
                vis = [_random_0_to_1(m, bbox_add_num, rng)
                       if _need_rng(rng).random() < bbox_add_ratio else m for m in vis]
        max_len = max(max_len, max(int(m.sum()) for m in vis))
        corners = _corners_for_mode(boxes, bbox_mode)
        per_frame.append((corners, np.asarray(labels), vis))

    if max_len == 0:
        return None

    bboxes_out = np.zeros((T, n_out, max_len, point_dim, 3), np.float32)
    classes_out = -np.ones((T, n_out, max_len), np.int64)
    masks_out = np.zeros((T, n_out, max_len), bool)
    for ti, item in enumerate(per_frame):
        if item is None:
            continue
        corners, labels, vis = item
        for vi, m in enumerate(vis):
            n = int(m.sum())
            bboxes_out[ti, vi, :n] = corners[m]
            classes_out[ti, vi, :n] = labels[m]
            masks_out[ti, vi, :n] = True
    return {"bboxes": bboxes_out, "classes": classes_out, "masks": masks_out}


def pad_bboxes_to_maxlen(bbox_shape: Sequence[int], max_len: int,
                         bboxes=None, classes=None, masks=None
                         ) -> Dict[str, np.ndarray]:
    """Pad a bbox dict to a common max_len (reference :484-512 and
    misc.collate_bboxes_to_maxlen). Used to align buckets across a batch."""
    B, n_out = bbox_shape[:2]
    ret_bboxes = np.zeros((B, n_out, max_len, *bbox_shape[3:]), np.float32)
    ret_classes = -np.ones((B, n_out, max_len), np.int64)
    ret_masks = np.zeros((B, n_out, max_len), np.float32)
    if bboxes is not None:
        n = bboxes.shape[2]
        ret_bboxes[:, :, :n] = bboxes
        ret_classes[:, :, :n] = classes
        if masks is not None:
            ret_masks[:, :, :n] = masks
        else:
            ret_masks[:, :, :n] = 1.0
    return {"bboxes": ret_bboxes, "classes": ret_classes, "masks": ret_masks}
