"""Host-side 3D geometry for the nuScenes data pipeline (pure numpy; the port's own
copy of the JAX package's datasets/geometry.py).

The reference's box/pose math without the mmdet3d/pyquaternion dependency stack:

- box corner extraction == LiDARInstance3DBoxes.corners
  (reference magicdrivedit/mmdet_plugin/core/bbox/structures/lidar_box3d.py:48-86)
- ego relative pose == obtain_next2top (reference
  magicdrivedit/datasets/nuscenes_t_dataset.py:37-91)
- box-to-view projection == trans_boxes_to_view(s) (reference
  magicdrivedit/datasets/utils.py:192-254)

Everything here runs on the host in the input pipeline; arrays go to the device only
after collation into static-shape batches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "quaternion_to_rotation_matrix", "shift_box_origin", "boxes_to_corners",
    "obtain_next2top", "trans_boxes_to_view", "trans_boxes_to_views",
    "ensure_canvas", "ensure_positive_z", "pose_to_matrix",
]

# mmdet3d corner ordering: (x0y0z0, x0y0z1, x0y1z1, x0y1z0, x1y0z0, x1y0z1, x1y1z1, x1y1z0)
# == np.unravel_index(arange(8), [2,2,2]) rows reordered by [0,1,3,2,4,5,7,6].
_CORNERS_NORM = np.stack(np.unravel_index(np.arange(8), [2] * 3), axis=1).astype(
    np.float64)[[0, 1, 3, 2, 4, 5, 7, 6]]


def quaternion_to_rotation_matrix(q: Sequence[float]) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix (pyquaternion convention)."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ], np.float64)


def pose_to_matrix(rotation_quat: Sequence[float],
                   translation: Sequence[float]) -> np.ndarray:
    """(quat wxyz, translation) -> 4x4 homogeneous transform."""
    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] = quaternion_to_rotation_matrix(rotation_quat)
    mat[:3, 3] = np.asarray(translation, np.float64)
    return mat


def shift_box_origin(boxes: np.ndarray, src_origin: Tuple[float, float, float]
                     ) -> np.ndarray:
    """Reinterpret box centers given at `src_origin` into the canonical
    bottom-center (0.5, 0.5, 0) convention (reference base_box3d.py:61-64)."""
    boxes = np.array(boxes, np.float32, copy=True)
    if boxes.size == 0:
        return boxes.reshape(0, boxes.shape[-1] if boxes.ndim == 2 else 7)
    dst = np.array((0.5, 0.5, 0.0), np.float32)
    src = np.asarray(src_origin, np.float32)
    boxes[:, :3] += boxes[:, 3:6] * (dst - src)
    return boxes


def boxes_to_corners(boxes: np.ndarray) -> np.ndarray:
    """(N, >=7) boxes (x, y, z_bottom, dx, dy, dz, yaw, ...) -> (N, 8, 3) corners.

    Matches LiDARInstance3DBoxes.corners exactly: unit-cube corners relative to
    (0.5, 0.5, 0), scaled by dims, rotated about +z by yaw, then translated.
    """
    boxes = np.asarray(boxes, np.float32)
    if boxes.shape[0] == 0:
        return np.zeros((0, 8, 3), np.float32)
    dims = boxes[:, 3:6].astype(np.float64)
    corners = dims[:, None, :] * (_CORNERS_NORM[None] - np.array([0.5, 0.5, 0.0]))
    yaw = boxes[:, 6].astype(np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    # per-box M = [[c, -s, 0], [s, c, 0], [0, 0, 1]]; corners @ M
    rot = np.zeros((len(boxes), 3, 3), np.float64)
    rot[:, 0, 0], rot[:, 0, 1] = c, -s
    rot[:, 1, 0], rot[:, 1, 1] = s, c
    rot[:, 2, 2] = 1.0
    corners = np.einsum("nij,njk->nik", corners, rot)
    corners += boxes[:, None, :3].astype(np.float64)
    return corners.astype(np.float32)


def obtain_next2top(first: dict, current: dict, epsilon: Optional[float] = 1e-6,
                    v2: bool = True) -> np.ndarray:
    """4x4 relative ego pose: current lidar frame -> first ("top") lidar frame
    inverse, i.e. A @ [p_lidar, 1] = p_next when v2 (reference
    nuscenes_t_dataset.py:37-91).

    `first`/`current` are info dicts with lidar2ego_{rotation,translation} and
    ego2global_{rotation,translation} (quaternion wxyz + 3-vector).
    """
    l2e_r_mat = quaternion_to_rotation_matrix(first["lidar2ego_rotation"])
    e2g_r_mat = quaternion_to_rotation_matrix(first["ego2global_rotation"])
    l2e_t = np.asarray(first["lidar2ego_translation"], np.float64)
    e2g_t = np.asarray(first["ego2global_translation"], np.float64)

    l2e_r_s_mat = quaternion_to_rotation_matrix(current["lidar2ego_rotation"])
    e2g_r_s_mat = quaternion_to_rotation_matrix(current["ego2global_rotation"])
    l2e_t_s = np.asarray(current["lidar2ego_translation"], np.float64)
    e2g_t_s = np.asarray(current["ego2global_translation"], np.float64)

    inv = np.linalg.inv
    R = (l2e_r_s_mat.T @ e2g_r_s_mat.T) @ (inv(e2g_r_mat).T @ inv(l2e_r_mat).T)
    T = (l2e_t_s @ e2g_r_s_mat.T + e2g_t_s) @ (inv(e2g_r_mat).T @ inv(l2e_r_mat).T)
    T -= e2g_t @ (inv(e2g_r_mat).T @ inv(l2e_r_mat).T) + l2e_t @ inv(l2e_r_mat).T
    next2lidar_rotation = R.T  # p @ R.T + T maps current-frame points into first frame
    next2lidar_translation = T

    if v2:  # inverse: maps first-frame ("top lidar") points into the current frame
        out = np.eye(4, dtype=np.float64)
        out[:3, :3] = next2lidar_rotation.T
        out[:3, 3] = -next2lidar_rotation.T @ next2lidar_translation
    else:
        out = np.eye(4, dtype=np.float64)
        out[:3, :3] = next2lidar_rotation
        out[:3, 3] = next2lidar_translation
    if epsilon is not None:
        out[np.abs(out) < epsilon] = 0.0
    return out.astype(np.float64)


def trans_boxes_to_view(boxes: np.ndarray, transform: np.ndarray,
                        aug_matrix: Optional[np.ndarray] = None,
                        proj: bool = True) -> Optional[np.ndarray]:
    """Project (N, >=7) lidar boxes into one camera view (reference
    datasets/utils.py:192-229).

    Returns (N, 8, 3): xy in pixels when `proj`, z normalized to +-1 keeping sign.
    NOTE the reference first re-interprets centers at origin (0.5, 0.5, 0.5)
    (box_center_shift), shifting boxes down by dz/2 before corner extraction.
    """
    boxes = np.asarray(boxes, np.float32)
    if boxes.shape[0] == 0:
        return None
    corners = boxes_to_corners(shift_box_origin(boxes, (0.5, 0.5, 0.5)))
    trans = np.asarray(transform, np.float64).reshape(4, 4)
    if aug_matrix is not None:
        trans = np.asarray(aug_matrix, np.float64).reshape(4, 4) @ trans
    coords = np.concatenate(
        [corners.reshape(-1, 3).astype(np.float64), np.ones((len(boxes) * 8, 1))], axis=-1)
    coords = coords @ trans.T
    if proj:
        z = np.clip(coords[:, 2], 1e-5, 1e5)
        coords[:, 0] /= z
        coords[:, 1] /= z
        coords[:, 2] /= np.abs(coords[:, 2])
    return coords[:, :3].reshape(-1, 8, 3).astype(np.float32)


def trans_boxes_to_views(boxes: np.ndarray, transforms: Sequence[np.ndarray],
                         aug_matrixes: Optional[Sequence[np.ndarray]] = None,
                         proj: bool = True) -> Optional[List[np.ndarray]]:
    if np.asarray(boxes).shape[0] == 0:
        return None
    out = []
    for idx in range(len(transforms)):
        aug = None if aug_matrixes is None else aug_matrixes[idx]
        out.append(trans_boxes_to_view(boxes, transforms[idx], aug, proj))
    return out


def ensure_canvas(coords: np.ndarray, canvas_size: Tuple[int, int]) -> np.ndarray:
    """Visibility by 2D canvas: any corner inside (h, w) with z>0 somewhere
    (reference nuscenes_t_dataset.py:132-149)."""
    h, w = canvas_size
    c_mask = np.any(coords[..., 2] > 0, axis=1)
    w_mask = np.any((coords[..., 0] > 0) & (coords[..., 0] < w), axis=1)
    h_mask = np.any((coords[..., 1] > 0) & (coords[..., 1] < h), axis=1)
    return c_mask & w_mask & h_mask


def ensure_positive_z(coords: np.ndarray) -> np.ndarray:
    return np.any(coords[..., 2] > 0, axis=1)
