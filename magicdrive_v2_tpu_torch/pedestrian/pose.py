"""SMPL pose-sequence processing of the pedestrian pipeline, in PyTorch on a device.

The reference fork's PoseProcessor (reference pedestrian_processor.py:750-995): sparse
per-frame HMR2 estimates become dense smooth sequences through
- the 6-D rotation representation (Zhou et al.) for averaging and filtering,
- a median-trend correction of "teleporting" glitches,
- linear interpolation of betas / cam / tform and per-joint SLERP of the 24 SMPL
  rotations,
- a moving average of the body pose (the root over a wider window).

All of it runs in float64 on ``device``. Where the reference calls host library
routines, the same definitions are written here as tensor code:
- a median filter with ``mode="nearest"``: a replicate pad, then the median of each
  window (the window is odd, so the median is one of its elements);
- linear interpolation with the ends held (``np.interp``): ``searchsorted``;
- SLERP as scipy's ``Slerp`` defines it: between keys i and i+1 the rotation vector
  of R_i^T R_{i+1}, scaled by alpha, composed on R_i, all through unit quaternions
  (scipy's conventions: (x, y, z, w), Shepperd's branch choice from a matrix, a
  matrix that is not orthogonal to 1e-12 first replaced by its nearest rotation);
- axis-angle input through ``smpl.rodrigues``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.misc import resolve_device, to_host, to_tensor
from .smpl import rodrigues

__all__ = ["PoseProcessor"]

_F64 = torch.float64


def _vector_norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def _median_nearest(x: torch.Tensor, window: int) -> torch.Tensor:
    """Median over ``window`` rows (odd) around each row of (n, c) ``x``, the ends
    padded with the first and last rows."""
    pad = window // 2
    xp = torch.cat([x[:1].expand(pad, -1), x, x[-1:].expand(pad, -1)])
    return xp.unfold(0, window, 1).median(dim=-1).values


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``np.interp`` of every column of (n, c) ``fp`` at ``x``: the end values held
    outside [xp[0], xp[-1]], a key's own value at a key."""
    n = xp.shape[0]
    j = torch.searchsorted(xp, x, right=True) - 1
    jc = j.clamp(0, n - 2)
    slope = (fp[jc + 1] - fp[jc]) / (xp[jc + 1] - xp[jc])[:, None]
    out = slope * (x - xp[jc])[:, None] + fp[jc]
    out = torch.where((xp[jc] == x)[:, None], fp[jc], out)
    out = torch.where((j < 0)[:, None], fp[0].expand_as(out), out)
    return torch.where((j >= n - 1)[:, None], fp[-1].expand_as(out), out)


# -- unit quaternions (x, y, z, w), scipy's Rotation conventions --------------------


def _quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    if bool((torch.linalg.det(m) <= 0).any()):
        raise ValueError("a rotation matrix has a non-positive determinant")
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    orthogonal = torch.isclose(m @ m.transpose(-1, -2), eye, rtol=1e-5,
                               atol=1e-12).all(-1).all(-1)
    if not bool(orthogonal.all()):
        u, _, vh = torch.linalg.svd(m)
        m = torch.where(orthogonal[..., None, None], m, u @ vh)
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    trace = m00 + m11 + m22
    choice = torch.stack([m00, m11, m22, trace], -1).argmax(-1)[..., None]
    cases = [
        (1 - trace + 2 * m00, m[..., 1, 0] + m[..., 0, 1], m[..., 2, 0] + m[..., 0, 2],
         m[..., 2, 1] - m[..., 1, 2]),
        (m[..., 1, 0] + m[..., 0, 1], 1 - trace + 2 * m11, m[..., 2, 1] + m[..., 1, 2],
         m[..., 0, 2] - m[..., 2, 0]),
        (m[..., 2, 0] + m[..., 0, 2], m[..., 2, 1] + m[..., 1, 2], 1 - trace + 2 * m22,
         m[..., 1, 0] - m[..., 0, 1]),
        (m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
         m[..., 1, 0] - m[..., 0, 1], 1 + trace),
    ]
    q = torch.stack(cases[3], -1)
    for i in range(3):
        q = torch.where(choice == i, torch.stack(cases[i], -1), q)
    return q / _vector_norm(q, keepdim=True)


def _quat_compose(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    cross = torch.linalg.cross(p[..., :3], q[..., :3], dim=-1)
    xyz = p[..., 3:] * q[..., :3] + q[..., 3:] * p[..., :3] + cross
    w = (p[..., 3] * q[..., 3] - p[..., 0] * q[..., 0] - p[..., 1] * q[..., 1]
         - p[..., 2] * q[..., 2])
    return torch.cat([xyz, w[..., None]], -1)


def _quat_as_rotvec(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    flip = (w < 0) | ((w == 0) & ((x < 0) | ((x == 0) & ((y < 0) | ((y == 0) & (z < 0))))))
    q = torch.where(flip[..., None], -q, q)
    angle = 2 * torch.atan2(_vector_norm(q[..., :3], keepdim=True), q[..., 3:])
    small = angle <= 1e-3
    angle2 = angle * angle
    small_scale = 2 + angle2 / 12 + 7 * angle2 * angle2 / 2880
    large_scale = angle / (torch.sin(angle / 2) + small.to(angle.dtype))
    return torch.where(small, small_scale, large_scale) * q[..., :3]


def _quat_from_rotvec(v: torch.Tensor) -> torch.Tensor:
    angle = _vector_norm(v, keepdim=True)
    small = angle <= 1e-3
    angle2 = angle * angle
    small_scale = 0.5 - angle2 / 48 + angle2 * angle2 / 3840
    large_scale = torch.sin(angle / 2) / (angle + small.to(angle.dtype))
    return torch.cat([v * torch.where(small, small_scale, large_scale), torch.cos(angle / 2)],
                     -1)


def _quat_as_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    x2, y2, z2, w2 = x * x, y * y, z * z, w * w
    xy, zw, xz, yw, yz, xw = x * y, z * w, x * z, y * w, y * z, x * w
    rows = [x2 - y2 - z2 + w2, 2 * (xy - zw), 2 * (xz + yw),
            2 * (xy + zw), -x2 + y2 - z2 + w2, 2 * (yz - xw),
            2 * (xz - yw), 2 * (yz + xw), -x2 - y2 + z2 + w2]
    return torch.stack(rows, -1).reshape(q.shape[:-1] + (3, 3))


def _slerp(times: torch.Tensor, mats: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """scipy's ``Slerp(times, R.from_matrix(mats))(at).as_matrix()`` for every joint
    at once: ``mats`` (n, J, 3, 3) at increasing ``times`` (n,), ``at`` (m,) inside
    [times[0], times[-1]]; returns (m, J, 3, 3)."""
    q = _quat_from_matrix(mats)
    inverse = torch.cat([-q[:-1, :, :3], q[:-1, :, 3:]], -1)
    rotvecs = _quat_as_rotvec(_quat_compose(inverse, q[1:]))
    ind = torch.searchsorted(times, at) - 1
    ind = torch.where(at == times[0], torch.zeros_like(ind), ind)
    alpha = (at - times[ind]) / (times[1:] - times[:-1])[ind]
    step = _quat_from_rotvec(rotvecs[ind] * alpha[:, None, None])
    return _quat_as_matrix(_quat_compose(q[:-1][ind], step))


class PoseProcessor:
    """Dense smooth SMPL sequences from sparse per-frame fits, on ``device``."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def _f64(self, x) -> torch.Tensor:
        return to_tensor(x, self.device, _F64)

    # -- rotation representation helpers (reference :754-772) --

    @staticmethod
    def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
        batch_dim = matrix.shape[:-2]
        m = matrix.reshape(-1, 3, 3)
        return torch.cat([m[:, :, 0], m[:, :, 1]], dim=1).reshape(*batch_dim, 6)

    @staticmethod
    def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
        batch_dim = d6.shape[:-1]
        d6 = d6.reshape(-1, 6)
        a1, a2 = d6[:, :3], d6[:, 3:]
        b1 = a1 / (_vector_norm(a1, keepdim=True) + 1e-8)
        b2 = a2 - (b1 * a2).sum(1, keepdim=True) * b1
        b2 = b2 / (_vector_norm(b2, keepdim=True) + 1e-8)
        b3 = torch.linalg.cross(b1, b2, dim=-1)
        return torch.stack((b1, b2, b3), dim=-1).reshape(*batch_dim, 3, 3)

    # -- outlier correction (reference :774-814) --

    def correct_outliers_with_trend(self, pose_mat, cam, window_size: int = 5,
                                    thresh_trans: float = 0.5, thresh_rot: float = 0.5):
        """Replace each cam / root rotation that lies more than a threshold from the
        median over ``window_size`` frames by that median."""
        pose_mat, cam = self._f64(pose_mat), self._f64(cam)
        n = len(cam)
        if n < 5:
            return pose_mat, cam
        if window_size % 2 == 0:
            window_size += 1
        cam_trend = _median_nearest(cam, window_size)
        root_6d = self.matrix_to_rotation_6d(pose_mat[:, 0:1]).reshape(n, 6)
        root_trend = _median_nearest(root_6d, window_size)
        bad_cam = _vector_norm(cam - cam_trend) > thresh_trans
        cam = torch.where(bad_cam[:, None], cam_trend, cam)
        bad_rot = _vector_norm(root_6d - root_trend) > thresh_rot
        pose_mat = pose_mat.clone()
        pose_mat[:, 0] = torch.where(bad_rot[:, None, None],
                                     self.rotation_6d_to_matrix(root_trend), pose_mat[:, 0])
        return pose_mat, cam

    # -- dense sequence construction (reference :816-995) --

    def process_sequence(self, sparse_data: Dict, total_frames: int,
                         full_cam2world=None, rot_window: int = 31,
                         body_window: int = 7) -> Optional[Dict]:
        """``sparse_data``: frame_indices (n,), pose (n, 72) axis-angle or (n, 24, 3,
        3), betas (n, nb), cam (n, 3), tform (n, 2, 3). Returns pose (T, 24, 3, 3),
        betas, cam, tform as float64 tensors on the device over ``total_frames``
        frames, and valid_range (first, last observed frame); None below 2
        detections."""
        indices = to_host(sparse_data["frame_indices"]).astype(np.int64)
        pose = self._f64(sparse_data["pose"])
        betas = self._f64(sparse_data["betas"])
        cam = self._f64(sparse_data["cam"])
        tform = self._f64(sparse_data["tform"])
        if len(indices) < 2:
            return None

        orig_min, orig_max = int(indices.min()), int(indices.max())
        if pose.ndim == 2 and pose.shape[1] == 72:
            pose_mat = rodrigues(pose.reshape(-1, 3), device=self.device).reshape(-1, 24, 3, 3)
        elif pose.ndim == 4 and pose.shape[-2:] == (3, 3):
            pose_mat = pose
        else:
            raise ValueError(f"Unknown pose shape: {tuple(pose.shape)}")

        order = np.argsort(indices, kind="stable")
        indices = indices[order]
        order_t = torch.as_tensor(order, device=self.device)
        pose_mat, betas, cam, tform = (pose_mat[order_t], betas[order_t], cam[order_t],
                                       tform[order_t])

        # repeated detections of one frame: their mean, the rotations' in 6-D
        uniq, inverse, counts = np.unique(indices, return_inverse=True, return_counts=True)
        if len(uniq) < len(indices):
            groups = torch.as_tensor(inverse[None, :] == np.arange(len(uniq))[:, None],
                                     dtype=_F64, device=self.device)
            n_per = torch.as_tensor(counts, dtype=_F64, device=self.device)

            def mean(x):
                return (groups @ x.reshape(len(indices), -1)).reshape(
                    (len(uniq),) + x.shape[1:]) / n_per.reshape((-1,) + (1,) * (x.ndim - 1))

            pose_mat = self.rotation_6d_to_matrix(mean(self.matrix_to_rotation_6d(pose_mat)))
            betas, cam, tform = mean(betas), mean(cam), mean(tform)
            indices = uniq

        pose_mat, cam = self.correct_outliers_with_trend(pose_mat, cam)

        keys = torch.as_tensor(indices, dtype=_F64, device=self.device)
        frames = torch.arange(total_frames, dtype=_F64, device=self.device)
        full_betas = _interp(frames, keys, betas)
        full_cam = _interp(frames, keys, cam)
        full_tform = _interp(frames, keys, tform.reshape(len(indices), -1)).reshape(
            (total_frames,) + tuple(tform.shape[1:]))

        # per-joint SLERP inside the observed span; the end rotations held outside
        full_pose = torch.zeros((total_frames, 24, 3, 3), dtype=_F64, device=self.device)
        first, last = int(indices[0]), int(indices[-1])
        full_pose[first:last + 1] = _slerp(keys, pose_mat, frames[first:last + 1])
        full_pose[:first] = pose_mat[0]
        full_pose[last + 1:] = pose_mat[-1]

        # moving average in 6-D against HMR's jitter; the root over a wider window
        # (reference :941-995)
        pose_6d = self.matrix_to_rotation_6d(full_pose)

        def smooth(x, window):
            if window <= 1 or total_frames < 3:
                return x
            # clamp to the sequence length, then force odd (an even window would
            # make the edge-padded 'valid' convolution one element too long)
            window = min(window, total_frames)
            if window % 2 == 0:
                window -= 1
            if window < 3:
                return x
            pad = window // 2
            xp = torch.cat([x[:1].expand(pad, -1), x, x[-1:].expand(pad, -1)])
            kernel = torch.full((window,), 1.0 / window, dtype=_F64, device=self.device)
            return xp.unfold(0, window, 1) @ kernel

        root = smooth(pose_6d[:, 0], min(rot_window, total_frames))
        body = smooth(pose_6d[:, 1:].reshape(total_frames, -1),
                      min(body_window, total_frames)).reshape(total_frames, 23, 6)
        full_pose = self.rotation_6d_to_matrix(torch.cat([root[:, None], body], dim=1))

        # optional world-frame alignment of the root with per-frame cam2world
        if full_cam2world is not None:
            c2w = self._f64(full_cam2world)
            r_t = c2w[:, :3, :3].transpose(1, 2)
            full_pose[:, 0] = r_t @ full_pose[:, 0]
            full_cam = (r_t @ (full_cam - c2w[:, :3, 3])[..., None])[..., 0]

        return {"pose": full_pose, "betas": full_betas, "cam": full_cam,
                "tform": full_tform, "valid_range": (orig_min, orig_max)}
