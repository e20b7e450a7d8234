"""Per-clip collation into static-shape numpy arrays + model-batch adapter (the
port's own copy of the JAX package's datasets/collate.py).

`collate_fn_single_clip` mirrors the reference collate (reference
magicdrivedit/datasets/nuscenes_t_dataset.py:574-733): stacks multi-view pixels, BEV
maps (+aux channels), camera params K|camera2lidar (3x7), ego rel-pose, and runs one of
the two bbox processors. `clip_to_model_batch` is the reference train script's
"move_data" stage (scripts/train_magicdrive.py:486-508): folds the camera dim into
batch and pads boxes across the batch to one static max_len, so every batch of a
bucket has one shape.
"""
from __future__ import annotations

import random as pyrandom
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .bbox import preprocess_bbox, preprocess_bbox_keep_all

__all__ = ["collate_fn_single_clip", "clip_to_model_batch", "collate_clips",
           "pad_clip_to_t", "pad_model_batch_to_t"]

_BBOX_PROCESSORS = {1: preprocess_bbox, 2: preprocess_bbox_keep_all}


def collate_fn_single_clip(
        frames: Sequence[dict], template: str = "{description}",
        frame_emb: Optional[str] = None, is_train: bool = True,
        bbox_mode: Optional[str] = None, bbox_view_shared: bool = False,
        bbox_drop_ratio: float = 0, bbox_add_ratio: float = 0, bbox_add_num: int = 3,
        keyframe_rate: int = 1, bbox_processor_type: int = 2,
        rng: Optional[pyrandom.Random] = None) -> Dict[str, Any]:
    """Collate T frame dicts of one clip into clip arrays.

    Returns dict with:
      pixel_values (T, NC, 3, H, W), bev_map_with_aux (T, C_map, h, w),
      camera_param (T, NC, 3, 7), frame_emb (T, 4, 4) or None,
      bboxes_3d_data {bboxes/classes/masks} or None, captions [str], height, width.
    """
    if bbox_add_ratio > 0:
        assert not bbox_view_shared, "You cannot add any box on view shared."
    pixel_values = np.stack([f["img"] for f in frames]).astype(np.float32)

    map_keys = ["gt_masks_bev"]
    if frames[0].get("gt_aux_bev") is not None:
        map_keys.append("gt_aux_bev")
        assert bbox_drop_ratio == 0, "map is not affected in bbox_drop"
    bev = np.stack([np.concatenate([np.asarray(f[k], np.float32) for k in map_keys],
                                   axis=0) for f in frames])

    camera_param = np.stack([np.concatenate([
        np.asarray(f["camera_intrinsics"], np.float32)[:, :3, :3],
        np.asarray(f["camera2lidar"], np.float32)[:, :3],
    ], axis=-1) for f in frames])

    ret: Dict[str, Any] = {
        "pixel_values": pixel_values,
        "bev_map_with_aux": bev,
        "camera_param": camera_param,
    }
    for k in ("human_img", "human_mask"):
        if k in frames[0]:
            ret[k + "s"] = np.stack([f[k] for f in frames]).astype(np.float32)

    if frame_emb == "next2top":
        ret["frame_emb"] = np.stack([np.asarray(f["next2top"], np.float32)
                                     for f in frames])
    else:
        assert frame_emb is None
        ret["frame_emb"] = None

    canvas_size = pixel_values.shape[-2:]
    if bbox_mode is not None:
        ret["bboxes_3d_data"] = _BBOX_PROCESSORS[int(bbox_processor_type)](
            bbox_mode, canvas_size, frames, is_train=is_train,
            view_shared=bbox_view_shared, bbox_add_ratio=bbox_add_ratio,
            bbox_add_num=bbox_add_num, bbox_drop_ratio=bbox_drop_ratio,
            keyframe_rate=keyframe_rate, rng=rng)

    ret["captions"] = [template.format(**f.get("metas", f)) for f in frames]
    ret["height"] = pixel_values.shape[-2]
    ret["width"] = pixel_values.shape[-1]
    return ret


def pad_clip_to_t(clip: Dict[str, Any], target_t: int) -> Dict[str, Any]:
    """Pad ONE collate_fn_single_clip output from its scene length T to
    `target_t` frames (bucket max-T), recording `num_frames_valid`.

    Full-length ("full") scenes are ragged (reference runs each length as its
    own eager torch graph, nuscenes_t_dataset.py:843-894); every scene in a full
    bucket pads to one max-T so the bucket has one shape.
    Per-frame tensors pad by repeating the last valid frame (pose/calibration
    stay physically plausible); boxes pad as null entries (masks 0, classes
    -1). Both lengths must be 8n+1 (micro-frame trim) so the VAE's causal
    temporal groups never mix pad into valid frames.
    """
    t = clip["pixel_values"].shape[0] if clip.get("pixel_values") is not None \
        else int(clip["pixel_values_shape"][0])
    out = dict(clip)
    out["num_frames_valid"] = t
    if target_t == t:
        return out
    if target_t < t:
        raise ValueError(f"scene length {t} exceeds full bucket max_t {target_t}")
    for v in (t, target_t):
        if v % 8 != 1:
            raise ValueError(f"full-length pad requires 8n+1 frames, got {v}")
    pad = target_t - t

    def rep_last(a):
        return np.concatenate(
            [a, np.tile(np.take(a, [-1], axis=0), (pad,) + (1,) * (a.ndim - 1))])

    for key in ("pixel_values", "bev_map_with_aux", "camera_param", "frame_emb",
                "human_imgs", "human_masks"):
        if clip.get(key) is not None:
            out[key] = rep_last(clip[key])
    if clip.get("pixel_values_shape") is not None:
        shp = np.array(clip["pixel_values_shape"])
        shp[0] = target_t
        out["pixel_values_shape"] = shp
    bb = clip.get("bboxes_3d_data")
    if bb is not None:
        padded = {}
        for k, v in bb.items():
            fill = -1 if k == "classes" else 0
            p = np.full((target_t,) + v.shape[1:], fill, v.dtype)
            p[:t] = v
            padded[k] = p  # masks stay 0 on pads -> null boxes
        out["bboxes_3d_data"] = padded
    out["captions"] = list(clip["captions"]) + [clip["captions"][-1]] * pad
    return out


def collate_clips(clips: Sequence[Dict[str, Any]],
                  bbox_max_len: Optional[int] = None) -> Dict[str, Any]:
    """Stack B clip dicts (same bucket => same T/H/W) into a batch dict, padding
    bboxes to a common max_len (reference misc.collate_bboxes_to_maxlen)."""
    lens = {c["pixel_values"].shape[0] for c in clips if "pixel_values" in c}
    if len(lens) > 1:
        raise ValueError(
            f"ragged clip lengths {sorted(lens)} in one batch — 'full' scenes "
            "must be padded to a bucket max-T first (pass full_bucket_t to "
            "prepare_dataloader / set cfg.full_bucket_t)")
    out: Dict[str, Any] = {}
    for key in ("pixel_values", "bev_map_with_aux", "camera_param", "frame_emb",
                "human_imgs", "human_masks", "pixel_values_shape"):
        if key in clips[0] and clips[0][key] is not None:
            out[key] = np.stack([c[key] for c in clips])
        elif key in clips[0]:
            out[key] = None
    # drop_ori_imgs items carry only the shape (reference ignore_ori_imgs)
    shp0 = (clips[0]["pixel_values"].shape
            if clips[0].get("pixel_values") is not None
            else tuple(int(s) for s in clips[0]["pixel_values_shape"]))
    bbox_dicts = [c.get("bboxes_3d_data") for c in clips]
    if any(b is not None for b in bbox_dicts):
        max_len = max(b["bboxes"].shape[2] for b in bbox_dicts if b is not None)
        if bbox_max_len is not None:
            max_len = max(max_len, bbox_max_len)
        padded = []
        t, nc = shp0[0], shp0[1]
        point_shape = next(b["bboxes"].shape[3:] for b in bbox_dicts
                           if b is not None)
        for b in bbox_dicts:
            p = {"bboxes": np.zeros((t, nc, max_len, *point_shape), np.float32),
                 "classes": -np.ones((t, nc, max_len), np.int64),
                 "masks": np.zeros((t, nc, max_len), np.float32)}
            if b is not None:
                n = b["bboxes"].shape[2]
                # n_out dims of size 1 (view-shared boxes / classes) broadcast to NC
                p["bboxes"][:, :, :n] = b["bboxes"]
                p["classes"][:, :, :n] = b["classes"]
                p["masks"][:, :, :n] = b["masks"]
            padded.append(p)
        out["bboxes_3d_data"] = {
            k: np.stack([p[k] for p in padded]) for k in ("bboxes", "classes", "masks")}
    else:
        out["bboxes_3d_data"] = None
    out["captions"] = [c["captions"] for c in clips]
    out["height"] = clips[0]["height"]
    out["width"] = clips[0]["width"]
    out["num_frames"] = shp0[0]
    out["fps"] = np.asarray([c.get("fps", 12) for c in clips], np.float32)
    if any("num_frames_valid" in c for c in clips):
        t = out["num_frames"]
        nfv = np.asarray([c.get("num_frames_valid", t) for c in clips],
                         np.float32)
        out["num_frames_valid"] = nfv
        out["frame_valid"] = (np.arange(t)[None] < nfv[:, None]).astype(
            np.float32)
    return out


def clip_to_model_batch(batch: Dict[str, Any],
                        box_latent_dim: Optional[int] = None,
                        rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
    """Reference move_data (train_magicdrive.py:486-508): fold NC into batch.

    When `box_latent_dim` is set (model's bbox embedder has sample_id=True), attach
    per-instance latents shared across views/time, like the reference's
    `add_box_latent(bbox, B, NC, T, model.sample_box_latent)`
    (train_magicdrive.py:500).

    Input: batch from `collate_clips`. Output keys match the model call contract:
      x (B, C*NC, T, H, W) pixels (pre-VAE), maps (B, T, C_map, h, w),
      bbox{bboxes,classes,masks} (B*NC, T, L, ...), cams (B*NC, T, 1, 3, 7),
      rel_pos (B*NC, T, 1, 4, 4), fps (B,), captions.
    """
    pix = batch["pixel_values"]  # (B, T, NC, 3, H, W)
    B, T, NC = pix.shape[:3]
    x = np.transpose(pix, (0, 2, 3, 1, 4, 5)).reshape(
        B * NC, pix.shape[3], T, *pix.shape[4:])
    out: Dict[str, Any] = {
        "x": x,  # (B*NC, 3, T, H, W) -> VAE encode -> latents
        "maps": batch["bev_map_with_aux"],
        "captions": [c[0] for c in batch["captions"]],  # first frame's caption
        "fps": batch["fps"],
        "height": float(batch["height"]),
        "width": float(batch["width"]),
        "num_frames": int(batch["num_frames"]),
    }
    for k in ("frame_valid", "num_frames_valid"):  # full-bucket pad validity
        if k in batch:
            out[k] = batch[k]
    cams = batch["camera_param"]  # (B, T, NC, 3, 7)
    out["cams"] = np.transpose(cams, (0, 2, 1, 3, 4)).reshape(
        B * NC, T, 1, 3, 7)
    if batch.get("frame_emb") is not None:
        rel = batch["frame_emb"]  # (B, T, 4, 4)
        out["rel_pos"] = np.repeat(rel[:, None], NC, axis=1).reshape(
            B * NC, T, 1, 4, 4)
    bbox = batch.get("bboxes_3d_data")
    if bbox is not None:
        out["bbox"] = {
            k: np.transpose(v, (0, 2, 1) + tuple(range(3, v.ndim))).reshape(
                B * NC, T, *v.shape[3:])
            for k, v in bbox.items()}  # (B, T, NC, ...) -> (B*NC, T, ...)
        if box_latent_dim is not None:
            from ..utils.misc import add_box_latent
            if rng is None:
                raise ValueError("box latents are drawn at random: pass rng=")
            out["bbox"] = add_box_latent(
                out["bbox"], B, NC, T,
                lambda n: rng.standard_normal((n, box_latent_dim), np.float32))
    return out


def pad_model_batch_to_t(batch: Dict[str, Any], target_t: int) -> Dict[str, Any]:
    """Pad a `clip_to_model_batch` output from its clip length T to `target_t`
    pixel frames so every full-length scene of a bucket has one shape (the
    reference runs each scene length eagerly instead,
    nuscenes_t_dataset.py:843-894).

    Per-frame conditioning (maps/cams/rel_pos) and pixels pad by repeating the
    last valid frame; boxes pad with null entries (masks=0). Adds
    `frame_valid` (B, target_t) and `num_frames_valid` (B,) — the model
    excludes pad frames from temporal mixing (stdit3 frame_valid) and
    timestep_transform uses the valid length. Clips are first snapped DOWN to
    the 8n+1 grid (the same micro-frame trim make_full_bucket_collate applies
    in training) so the cog temporal halvings stay pad-aligned; target_t
    itself must be 8n+1.
    """
    t = int(batch["num_frames"])
    t8 = (t - 1) // 8 * 8 + 1
    if t8 != t:  # micro-frame trim: drop the ragged tail frames
        out = dict(batch)
        if batch.get("x") is not None:
            out["x"] = batch["x"][:, :, :t8]
        for k, ax in (("maps", 1), ("cams", 1), ("rel_pos", 1)):
            if batch.get(k) is not None:
                out[k] = np.take(batch[k], range(t8), axis=ax)
        if batch.get("bbox") is not None:
            out["bbox"] = {k: v[:, :t8] for k, v in batch["bbox"].items()}
        out["num_frames"] = t8
        batch, t = out, t8
    if target_t == t:
        out = dict(batch)
        b = np.shape(batch["fps"])[0] if "fps" in batch else 1
        out["frame_valid"] = np.ones((b, t), np.float32)
        out["num_frames_valid"] = np.full((b,), float(t), np.float32)
        return out
    if target_t < t:
        raise ValueError(f"clip length {t} exceeds bucket max_t {target_t}")
    for v in (t, target_t):
        if v % 8 != 1:
            raise ValueError(f"full-length pad requires 8n+1 frames, got {v}")
    pad = target_t - t

    def rep_last(a, axis):
        last = np.take(a, [-1], axis=axis)
        reps = [1] * a.ndim
        reps[axis] = pad
        return np.concatenate([a, np.tile(last, reps)], axis=axis)

    out = dict(batch)
    if batch.get("x") is not None:
        out["x"] = rep_last(batch["x"], 2)  # (B*NC, 3, T, H, W)
    if batch.get("maps") is not None:
        out["maps"] = rep_last(batch["maps"], 1)
    if batch.get("cams") is not None:
        out["cams"] = rep_last(batch["cams"], 1)
    if batch.get("rel_pos") is not None:
        out["rel_pos"] = rep_last(batch["rel_pos"], 1)
    if batch.get("bbox") is not None:
        bbox = {}
        for k, v in batch["bbox"].items():
            padded = np.zeros((v.shape[0], target_t) + v.shape[2:], v.dtype)
            padded[:, :t] = v
            if k == "classes":
                padded[:, t:] = -1
            bbox[k] = padded  # masks stay 0 on pads -> null boxes
        out["bbox"] = bbox
    b = out["maps"].shape[0] if out.get("maps") is not None else 1
    fv = np.zeros((b, target_t), np.float32)
    fv[:, :t] = 1.0
    out["frame_valid"] = fv
    out["num_frames_valid"] = np.full((b,), float(t), np.float32)
    out["num_frames"] = target_t
    return out
