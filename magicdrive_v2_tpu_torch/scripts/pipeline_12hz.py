"""Two-pass SMPL pedestrian pipeline of the port (reference pipeline_12hz.py:21-458 +
pedestrian_processor.py:49-749).

Pass 1 (harvest): per scene, per camera, person masks + SMPL fits + instance-id depth
renders -> per-vertex colours harvested across the clip.
Smoothing: PoseProcessor densifies and smooths the sparse per-frame fits.
Inpaint: symmetry + KNN + mesh-median fill of unseen vertices.
Pass 2 (render): the textured bodies re-rendered per camera with real intrinsics into
RGB + mask PNG pairs, the BrushNet branch's training inputs.

Backends are pluggable (``magicdrive_v2_tpu_torch/pedestrian/processor.py``):
``--synthetic-backends`` uses the deterministic synthetic segmenter / fitter / body
(and, without ``--dataroot``, a synthetic 2-camera scene), so both passes run without
weights. Real backends: SegFormer through transformers (local weights,
``--segformer-path``), the SMPL body from its pickle (``--smpl-path``), HMR2 through the
``hmr2`` package (``--hmr2-checkpoint``). Everything runs on ``--device`` (default
``cuda``; ``cpu`` runs the same code on the host).

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.scripts.pipeline_12hz --synthetic-backends \\
      --save-root out/ [--device cpu]
  python3 -m magicdrive_v2_tpu_torch.scripts.pipeline_12hz \\
      --pkl-root data/nuscenes_mmdet3d-12Hz --dataroot data/nuscenes --scene-idx 0 \\
      --smpl-path basicModel_neutral_lbs_10_207_0_v1.0.0.pkl \\
      --segformer-path pretrained/segformer-b5-cityscapes --save-root out/
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle
from typing import Dict, Tuple

import numpy as np
import torch

from ..pedestrian import PoseProcessor, make_synthetic_processor
from ..pedestrian.processor import (PedestrianProcessor, SegformerSegmenter, SyntheticBody,
                                    SyntheticSmplFitter)
from ..utils.misc import to_host, to_tensor

logger = logging.getLogger("pipeline_12hz")

CAMS = ["CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
        "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"]
PED_LABEL = 6  # mmdet3d pedestrian class id (reference pipeline_12hz.py:176-177)


def project_box_to_bbox2d(box7: np.ndarray, lidar2img: np.ndarray):
    """3D box (x, y, z, dx, dy, dz, yaw) -> 2D bbox [x1, y1, x2, y2] or None if
    any corner is behind the camera. Matches the reference's nuScenes-Box
    convention of treating z as the box CENTER (pipeline_12hz.py:86-97)."""
    c, s = np.cos(box7[6]), np.sin(box7[6])
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    half = np.asarray(box7[3:6]) / 2.0
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], np.float64)
    corners = (signs * half) @ rot.T + np.asarray(box7[:3])
    hom = np.concatenate([corners, np.ones((8, 1))], axis=1)
    img = hom @ np.asarray(lidar2img)[:3].T
    if np.any(img[:, 2] <= 0):
        return None
    uv = img[:, :2] / img[:, 2:3]
    return np.array([uv[:, 0].min(), uv[:, 1].min(),
                     uv[:, 0].max(), uv[:, 1].max()])


# ---------------------------------------------------------------------------
# frame adapters: real infos pkl / synthetic scene
# ---------------------------------------------------------------------------


def quaternion_matrix(q) -> np.ndarray:
    """Rotation matrix of a quaternion (w, x, y, z), normalised first."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(np.asarray(q, np.float64))
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def frames_from_infos(infos, dataroot):
    """Adapt reference-schema 12Hz infos to pipeline frames. Each frame:
    {image(cam): path, lidar2img(cam), c2w(cam), K(cam), peds: [(box7, tok,
    center_world)]} (reference pipeline_12hz.py:124-266)."""
    frames = []
    for info in infos:
        L2E = np.eye(4)
        L2E[:3, :3] = quaternion_matrix(info["lidar2ego_rotation"])
        L2E[:3, 3] = np.asarray(info["lidar2ego_translation"])
        E2G = np.eye(4)
        if "ego2global_rotation" in info:
            E2G[:3, :3] = quaternion_matrix(info["ego2global_rotation"])
            E2G[:3, 3] = np.asarray(info["ego2global_translation"])
        L2W = E2G @ L2E

        frame = {"cams": {}, "peds": [], "timestamp": info.get("timestamp", 0)}
        for name, cam in info.get("cams", {}).items():
            if name not in CAMS:
                continue
            S2E = np.eye(4)
            S2E[:3, :3] = quaternion_matrix(cam["sensor2ego_rotation"])
            S2E[:3, 3] = np.asarray(cam["sensor2ego_translation"])
            C2W = E2G @ S2E
            K = np.asarray(cam.get("cam_intrinsic", cam.get("camera_intrinsics")))
            # lidar -> cam -> img
            view = np.linalg.inv(S2E) @ L2E
            K4 = np.eye(4)
            K4[:3, :3] = K
            raw = cam["data_path"]
            rel = raw.split("nuscenes/")[-1] if "nuscenes/" in raw else raw
            frame["cams"][name] = dict(image_path=os.path.join(dataroot, rel),
                                       lidar2img=(K4 @ view)[:3], c2w=C2W, K=K)
        ids = info.get("gt_box_ids")
        names = info.get("gt_names", [])
        for i, b in enumerate(info.get("gt_boxes", [])):
            if i < len(names) and "pedestrian" in str(names[i]):
                tok = ids[i] if ids is not None else f"ped{i}"
                center_world = (L2W @ np.append(np.asarray(b[:3]), 1.0))[:3]
                frame["peds"].append((np.asarray(b[:7], np.float64), tok, center_world))
        frames.append(frame)
    return frames


def build_synthetic_scene(processor: PedestrianProcessor, n_frames: int = 4, hw=(192, 256)):
    """Fully synthetic scene: one pedestrian walking in front of two cameras,
    GT images rendered with a known per-vertex texture. Exercises the full
    two-pass pipeline without nuScenes data."""
    H, W = hw
    K = np.array([[220.0, 0, W / 2], [0, 220.0, H / 2], [0, 0, 1]])
    tv = to_host(processor.body.v_template)
    gt_tex = (tv - tv.min(0)) / (np.ptp(tv, 0) + 1e-6)  # rgb = normalized xyz

    frames = []
    for f in range(n_frames):
        frame = {"cams": {}, "peds": [], "timestamp": f * 0.0833}
        pos_world = np.array([0.35 * (f - n_frames / 2) * 0.3, 0.1, 5.0])
        for ci, cam_name in enumerate(["CAM_FRONT", "CAM_FRONT_LEFT"]):
            c2w = np.eye(4)
            c2w[0, 3] = -0.6 * ci  # second camera shifted
            w2c = np.linalg.inv(c2w)
            pos_cam = (w2c @ np.append(pos_world, 1.0))[:3]
            # GT image: render the body with the GT texture at pos_cam
            smpl_out = dict(vertices=tv[None].copy(),
                            cam_t=np.array([pos_cam], np.float64),
                            pos_cam=pos_cam,
                            crop_info={"tform": np.array([[1.0, 0, 0], [0, 1.0, 0]])})
            img, _, _ = processor.render_colored_mesh(smpl_out, gt_tex, (H, W), intrinsics=K)
            K4 = np.eye(4)
            K4[:3, :3] = K
            frame["cams"][cam_name] = dict(image=to_host(img), lidar2img=(K4 @ w2c)[:3],
                                           c2w=c2w, K=K)
        box7 = np.array([pos_world[0], pos_world[1], pos_world[2],
                         0.7, 0.7, float(np.ptp(tv[:, 2])), 0.0])
        frame["peds"].append((box7, "ped0", pos_world.copy()))
        frames.append(frame)
    return frames, gt_tex


# ---------------------------------------------------------------------------
# the two passes (reference pipeline_12hz.py run(), :99-432)
# ---------------------------------------------------------------------------


def _read_image(cam):
    """The camera's BGR uint8 image: in memory, else decoded from its path (None when
    the file is missing or not an image, as the reference's reader returns)."""
    if "image" in cam:
        return cam["image"]
    from PIL import Image
    try:
        with Image.open(cam["image_path"]) as im:
            rgb = np.asarray(im.convert("RGB"))
    except OSError as e:
        logger.warning("cannot read %s: %s", cam["image_path"], e)
        return None
    return np.ascontiguousarray(rgb[:, :, ::-1])


def harvest_textures(processor: PedestrianProcessor, frames):
    """Pass 1: per (frame, camera) the SMPL fits of the visible pedestrians and their
    visibility-filtered colours summed per vertex. Returns (textures {tok: {"sum",
    "count"}}, fits {(frame, camera, tok): smpl}, their box centres, c2w and K per
    frame and camera)."""
    n_verts = len(processor.body.v_template)
    dev = processor.device
    scene_textures, smpl_cache, gt_center_cache, all_c2ws, all_K = {}, {}, {}, {}, {}
    logger.info("pass 1: harvesting textures from %d frames", len(frames))
    for f_idx, frame in enumerate(frames):
        all_c2ws[f_idx] = {n: c["c2w"] for n, c in frame["cams"].items()}
        all_K[f_idx] = {n: c["K"] for n, c in frame["cams"].items()}
        for cam_name, cam in frame["cams"].items():
            image = _read_image(cam)
            if image is None:
                continue
            H, W = image.shape[:2]
            ped_data = []
            for box7, tok, center_world in frame["peds"]:
                bbox = project_box_to_bbox2d(box7, cam["lidar2img"])
                if bbox is None:
                    continue
                cx1, cy1 = max(0, bbox[0]), max(0, bbox[1])
                cx2, cy2 = min(W, bbox[2]), min(H, bbox[3])
                if (cx2 - cx1) < 10 or (cy2 - cy1) < 20:
                    continue
                ped_data.append((bbox, tok, center_world))
            if not ped_data:
                continue
            image = to_tensor(image, dev)
            global_mask = processor.get_global_human_mask(image)

            smpl_outputs, ped_ids, valid = [], [], []
            for bbox, tok, center_world in ped_data:
                smpl = processor.estimate_smpl(image, bbox)
                if not processor.is_mesh_valid(smpl):
                    continue
                smpl_outputs.append(smpl)
                ped_ids.append(len(valid) + 1)
                valid.append((tok, smpl))
                smpl_cache[(f_idx, cam_name, tok)] = smpl
                gt_center_cache[(f_idx, cam_name, tok)] = center_world
            if not smpl_outputs:
                continue

            id_map, depth_map = processor.render_instance_id_map(smpl_outputs, ped_ids,
                                                                 (H, W))
            for i, (tok, smpl) in enumerate(valid):
                if tok not in scene_textures:
                    scene_textures[tok] = {
                        "sum": torch.zeros((n_verts, 3), dtype=torch.float32, device=dev),
                        "count": torch.zeros((n_verts, 1), dtype=torch.float32, device=dev)}
                cols, ws = processor.project_and_sample_vertices(
                    smpl, image, global_mask, id_map, depth_map, ped_ids[i])
                scene_textures[tok]["sum"] += cols
                scene_textures[tok]["count"] += ws
    return scene_textures, smpl_cache, gt_center_cache, all_c2ws, all_K


def smooth_poses(processor: PedestrianProcessor, smpl_cache, gt_center_cache, all_c2ws,
                 n_frames: int) -> Dict:
    """Each pedestrian's fits as a dense smooth sequence over the clip (reference
    :268-303), brought to the host for the per-frame geometry of pass 2."""
    dev = processor.device
    sparse = {}
    for (f_idx, cam_name, tok), smpl in smpl_cache.items():
        d = sparse.setdefault(tok, {"frame_indices": [], "pose": [], "betas": [],
                                    "cam": [], "tform": []})
        root = to_tensor(smpl["global_orient"], dev).reshape(1, 3, 3)
        body = to_tensor(smpl["smpl_pose"], dev).reshape(-1, 3, 3)
        full_pose = torch.cat([root, body], dim=0)
        pos_world = np.asarray(gt_center_cache[(f_idx, cam_name, tok)]).copy()
        pos_world[2] -= 0.1  # pelvis shift (reference :282)
        c2w_rot = to_tensor(all_c2ws[f_idx][cam_name][:3, :3], dev, torch.float64)
        # cam rot -> world rot, stored back in the fit's own dtype
        full_pose[0] = (c2w_rot @ full_pose[0].to(torch.float64)).to(full_pose.dtype)
        d["frame_indices"].append(f_idx)
        d["pose"].append(full_pose)
        d["betas"].append(to_tensor(smpl["betas"], dev).reshape(-1))
        d["cam"].append(pos_world)
        d["tform"].append(np.asarray(smpl["crop_info"]["tform"]))

    pose_proc = PoseProcessor(device=dev)
    smoothed = {}
    for tok, data in sparse.items():
        order = np.argsort(np.asarray(data["frame_indices"]), kind="stable")
        seq = {"frame_indices": np.asarray(data["frame_indices"])[order],
               "pose": torch.stack(data["pose"])[torch.as_tensor(order, device=dev)],
               "betas": torch.stack(data["betas"])[torch.as_tensor(order, device=dev)],
               "cam": np.asarray(data["cam"])[order],
               "tform": np.asarray(data["tform"])[order]}
        dense = pose_proc.process_sequence(seq, n_frames)
        if dense is not None:
            smoothed[tok] = {k: v if k == "valid_range" else to_host(v)
                             for k, v in dense.items()}
    return smoothed


def inpaint_textures(processor: PedestrianProcessor, scene_textures,
                     min_coverage: float) -> Dict[str, torch.Tensor]:
    """Each pedestrian seen on at least ``min_coverage`` of the vertices, its unseen
    vertices filled (reference :305-309)."""
    n_verts = len(processor.body.v_template)
    final_textures = {}
    for tok, data in scene_textures.items():
        if float((data["count"] > 0).sum()) / float(n_verts) < min_coverage:
            continue
        final_textures[tok] = processor.inpaint_missing_colors(data["sum"], data["count"])
    return final_textures


def render_frames(processor: PedestrianProcessor, frames, smoothed, final_textures,
                  all_c2ws, all_K, save_root) -> int:
    """Pass 2: every textured pedestrian re-rendered per (frame, camera) at its smoothed
    pose, z-merged on the device; one RGB + mask PNG pair per image with any.
    Returns the number of pairs written."""
    logger.info("pass 2: rendering %d textured pedestrians", len(final_textures))
    dev = processor.device
    host_textures = {tok: to_host(tex) for tok, tex in final_textures.items()}
    n_out = 0
    for f_idx, frame in enumerate(frames):
        for cam_name, cam in frame["cams"].items():
            image = _read_image(cam)
            if image is None:
                continue
            H, W = image.shape[:2]
            canvas = torch.zeros((H, W, 3), dtype=torch.uint8, device=dev)
            global_depth = torch.full((H, W), float("inf"), dtype=torch.float32, device=dev)
            mask_buf = torch.zeros((H, W), dtype=torch.uint8, device=dev)
            rendered_any = False

            for tok, texture in host_textures.items():
                if tok not in smoothed:
                    continue
                dense = smoothed[tok]
                min_f, max_f = dense["valid_range"]
                if f_idx < min_f or f_idx > max_f:
                    continue
                pose_world = dense["pose"][f_idx]
                betas = dense["betas"][f_idx]
                pos_world = dense["cam"][f_idx]
                C2W = all_c2ws[f_idx][cam_name]
                K = all_K[f_idx][cam_name]
                R_w2c = C2W[:3, :3].T
                pos_cam = R_w2c @ (pos_world - C2W[:3, 3])
                if pos_cam[2] < 0.5:
                    continue
                f_x = K[0, 0]
                u_img = f_x * pos_cam[0] / pos_cam[2] + K[0, 2]
                v_img = K[1, 1] * pos_cam[1] / pos_cam[2] + K[1, 2]
                bbox_size = (f_x * 2.0 / pos_cam[2]) / 0.8
                if (u_img + bbox_size / 2 < 0 or u_img - bbox_size / 2 > W or
                        v_img + bbox_size / 2 < 0 or v_img - bbox_size / 2 > H):
                    continue
                bbox_size = min(bbox_size, max(H, W) * 2.0)
                s = (256 - 1) / bbox_size
                tform = np.array([[s, 0, -(u_img - bbox_size / 2) * s],
                                  [0, s, -(v_img - bbox_size / 2) * s]])
                cam_t_crop = processor.convert_world_to_crop_cam(
                    pos_world, {"tform": tform}, K, C2W)
                depth_scale = pos_cam[2] / (cam_t_crop[2] + 1e-6)
                root_rot_cam = R_w2c @ pose_world[0]
                verts = processor.body.vertices(root_rot_cam, pose_world[1:], betas)
                r_data = dict(vertices=verts[None], cam_t=cam_t_crop[None],
                              pos_cam=pos_cam, crop_info={"tform": tform})
                render, mask, depth = processor.render_colored_mesh(
                    r_data, texture, (H, W), intrinsics=K)
                real_depth = depth.to(torch.float64) * float(depth_scale)
                update = mask & (real_depth > 0) & (real_depth < global_depth)
                canvas = torch.where(update[..., None], render, canvas)
                global_depth = torch.where(update, real_depth, global_depth).to(torch.float32)
                mask_buf = torch.where(update, 255, mask_buf)
                rendered_any = True

            if rendered_any:
                base = cam.get("image_path", f"frame{f_idx:04d}_{cam_name}.jpg")
                stem = os.path.splitext(os.path.basename(base))[0]
                _imwrite(os.path.join(save_root, stem + ".png"), to_host(canvas))
                _imwrite(os.path.join(save_root, stem + "_mask.png"), to_host(mask_buf))
                n_out += 1
    return n_out


def run_scene(processor: PedestrianProcessor, frames, save_root,
              min_coverage: float = 0.1) -> Tuple[int, Dict[str, np.ndarray]]:
    """Both passes over one scene. Returns (n_rendered_images, textures), each
    texture a (V, 3) float32 numpy array."""
    os.makedirs(save_root, exist_ok=True)
    scene_textures, smpl_cache, centers, all_c2ws, all_K = harvest_textures(processor,
                                                                           frames)
    smoothed = smooth_poses(processor, smpl_cache, centers, all_c2ws, len(frames))
    final_textures = inpaint_textures(processor, scene_textures, min_coverage)
    n_out = render_frames(processor, frames, smoothed, final_textures, all_c2ws, all_K,
                          save_root)
    return n_out, {tok: to_host(tex) for tok, tex in final_textures.items()}


def _imwrite(path, arr):
    """Write a BGR (H, W, 3) or grey (H, W) uint8 array as an image file."""
    from PIL import Image
    Image.fromarray(np.ascontiguousarray(arr[..., ::-1]) if arr.ndim == 3 else arr).save(path)


def group_scenes(infos):
    """Group infos into scenes by scene_token when present, else by >=0.6 s
    timestamp gaps (the reference aligns against the SDK's scene intervals,
    pipeline_12hz.py:34-82; converted infos carry timestamps in us)."""
    if infos and "scene_token" in infos[0]:
        scenes = {}
        for i in infos:
            scenes.setdefault(i["scene_token"], []).append(i)
        return [sorted(v, key=lambda x: x["timestamp"]) for v in scenes.values()]
    infos = sorted(infos, key=lambda x: x["timestamp"])
    scenes, cur = [], []
    for i in infos:
        if cur and (i["timestamp"] - cur[-1]["timestamp"]) > 0.6e6:
            scenes.append(cur)
            cur = []
        cur.append(i)
    if cur:
        scenes.append(cur)
    return scenes


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pkl-root", default="./data/nuscenes_mmdet3d-12Hz")
    p.add_argument("--dataroot", default=None)
    p.add_argument("--save-root", default="./outputs/pedestrian")
    p.add_argument("--scene-idx", type=int, default=0)
    p.add_argument("--splits", default="train,val")
    p.add_argument("--synthetic-backends", action="store_true",
                   help="synthetic segmenter/fitter/body; with no --dataroot, "
                        "also a synthetic scene")
    p.add_argument("--segformer-path", default=None,
                   help="local SegFormer weights for the real segmenter")
    p.add_argument("--smpl-path", default=None,
                   help="SMPL model pickle (basicModel_*_lbs_10_207_0_v1.0.0.pkl) for "
                        "the real body model")
    p.add_argument("--hmr2-checkpoint", default=None,
                   help="HMR2 checkpoint for the real fitter (needs the hmr2 package)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.synthetic_backends:
        processor = make_synthetic_processor(device=args.device)
        if args.segformer_path:
            processor.segmenter = SegformerSegmenter(args.segformer_path, device=args.device)
        if args.dataroot is None:
            frames, _ = build_synthetic_scene(processor)
            n, _ = run_scene(processor, frames, args.save_root)
            logger.info("synthetic scene: %d rendered image+mask pairs -> %s", n,
                        args.save_root)
            return n
    elif args.smpl_path:
        # real SMPL body (reference hmr2_model.smpl, pedestrian_processor.py:49+)
        # + HMR2 fitter when a checkpoint is given, SegFormer when weights given
        from ..pedestrian.smpl import make_real_processor
        processor = make_real_processor(args.smpl_path, segformer_path=args.segformer_path,
                                        hmr2_checkpoint=args.hmr2_checkpoint,
                                        device=args.device)
    else:
        if not args.segformer_path:
            raise SystemExit(
                "real backends need --segformer-path (SegFormer weights) and "
                "--smpl-path (SMPL pickle); run with --synthetic-backends to "
                "exercise the pipeline without them")
        body = SyntheticBody(device=args.device)  # placeholder until an SMPL pkl is given
        processor = PedestrianProcessor(
            segmenter=SegformerSegmenter(args.segformer_path, device=args.device),
            fitter=SyntheticSmplFitter(body), body=body, device=args.device)

    infos = []
    for split in args.splits.split(","):
        pkl = os.path.join(args.pkl_root,
                           f"nuscenes_interp_12Hz_infos_{split.strip()}_with_bid.pkl")
        if os.path.exists(pkl):
            with open(pkl, "rb") as f:
                d = pickle.load(f)
            infos.extend(d["infos"] if isinstance(d, dict) and "infos" in d else d)
    if not infos:
        raise SystemExit(f"no infos pkls under {args.pkl_root}")
    scenes = group_scenes(infos)
    frames = frames_from_infos(scenes[args.scene_idx], args.dataroot)
    n, _ = run_scene(processor, frames, args.save_root)
    logger.info("scene %d: %d rendered image+mask pairs -> %s", args.scene_idx, n,
                args.save_root)
    return n


if __name__ == "__main__":
    main()
