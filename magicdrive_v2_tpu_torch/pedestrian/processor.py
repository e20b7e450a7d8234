"""Pedestrian texture harvest and re-render (passes 1-2 of the 12 Hz pedestrian
pipeline), in PyTorch on a device.

The reference fork's headline feature (reference pedestrian_processor.py:49-749,
consumed by pipeline_12hz.py:99-432), per scene:

  pass 1: person masks + SMPL fits per (frame, camera) -> per-vertex colours
          harvested across the clip, filtered by visibility;
  pose smoothing: ``pedestrian/pose.py``;
  inpaint: symmetry, KNN and mesh-neighbourhood median fill of unseen vertices;
  pass 2: the textured body re-rendered per camera with real intrinsics into a
          z-merged buffer: RGB + mask pairs, the BrushNet branch's training inputs.

The neural stages are pluggable backends, so the geometry and texture logic runs and
is tested without checkpoints:

  Segmenter:  image_bgr -> bool person mask     (ref get_global_human_mask :107)
  SmplFitter: crop_256 -> smpl params           (ref estimate_smpl :132)
  BodyModel:  v_template/faces/vertices(...)    (ref hmr2_model.smpl)

Where the work is: per vertex (projections, visibility, colour sampling, KNN and
median fills) and per pixel (affine warps, the instance z-merge, masks) it runs as
tensor code on ``device``, in float64 where the reference computes in float64 and
in float32 where its inputs keep it there. Per instance (a 2x3 crop affine and its
inverse, intrinsics, one 3-D point) it stays numpy float64 on the host: a handful
of scalars, where a device would add a launch and a synchronisation per operation.
Images and the rasterizer's buffers are numpy at the boundary. Rendering uses the
native z-buffer vertex-colour rasterizer (``native/src/mdv2_native.cpp``
``mdv2_rasterize_mesh``), a host kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..native import rasterize_mesh
from ..utils.misc import resolve_device, to_host, to_tensor

F_HMR = 5000.0  # HMR crop camera focal length (reference :295)
C_HMR = 128.0   # crop principal point
CROP = 256      # crop resolution
KNN_ROWS = 1024  # query rows a chunk of the nearest-vertex searches

_F64 = torch.float64


# ---------------------------------------------------------------------------
# affine crop helpers
# ---------------------------------------------------------------------------


def crop_affine(center: np.ndarray, scale: float) -> np.ndarray:
    """2x3 affine mapping the full-image box (center, scale*200) to 256x256,
    matching the reference's cv2.getAffineTransform construction (:143-158)."""
    src_w = scale * 200.0
    s = (CROP - 1) / src_w
    # maps x_img -> (x_img - (cx - w/2)) * s
    t = np.array([
        [s, 0.0, -(center[0] - src_w / 2) * s],
        [0.0, s, -(center[1] - src_w / 2) * s],
    ], np.float64)
    return t


def invert_affine(t: np.ndarray) -> np.ndarray:
    a = np.eye(3)
    a[:2] = t
    inv = np.linalg.inv(a)
    return inv[:2]


def _affine_source(t, out_wh: Tuple[int, int], in_hw, device):
    """Per output pixel of the nearest-neighbour warp by ``t``: (inside, row, col) of
    its source pixel, the indices clamped into the image. The source coordinates are
    float64 and rounded half to even, as the reference's are."""
    w_out, h_out = out_wh
    (a, b, c), (d, e, f) = (tuple(float(v) for v in row)
                            for row in invert_affine(np.asarray(t, np.float64)))
    xs = torch.arange(w_out, dtype=_F64, device=device)[None, :]
    ys = torch.arange(h_out, dtype=_F64, device=device)[:, None]
    xi = torch.round(a * xs + b * ys + c).to(torch.int64)
    yi = torch.round(d * xs + e * ys + f).to(torch.int64)
    inside = (xi >= 0) & (xi < in_hw[1]) & (yi >= 0) & (yi < in_hw[0])
    return inside, yi.clamp(0, in_hw[0] - 1), xi.clamp(0, in_hw[1] - 1)


def warp_affine_nearest(img, t: np.ndarray, out_wh: Tuple[int, int], border,
                        device="cuda") -> torch.Tensor:
    """Nearest-neighbour affine warp of an HxW[xC] image, border-constant, on
    ``device``."""
    img = to_tensor(img, device)
    inside, yi, xi = _affine_source(t, out_wh, img.shape[:2], img.device)
    inside = inside.reshape(inside.shape + (1,) * (img.ndim - 2))
    return torch.where(inside, img[yi, xi], torch.full((), border, dtype=img.dtype,
                                                       device=img.device))


def _squared_distances(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(n, m) squared Euclidean distances of (n, 3) ``q`` to (m, 3) ``p``, summed
    coordinate by coordinate in one fixed order (the same digits on every device)."""
    acc = None
    for k in range(3):
        d = q[:, None, k] - p[None, :, k]
        acc = d * d if acc is None else acc + d * d
    return acc


def _nearest(queries: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) indices of the k nearest ``points`` of each query, nearest first, ties
    to the lower index; in chunks of KNN_ROWS queries."""
    out = []
    for s in range(0, len(queries), KNN_ROWS):
        d = _squared_distances(queries[s:s + KNN_ROWS], points)
        if k == 1:
            out.append(d.argmin(dim=1, keepdim=True))
        else:
            out.append(torch.sort(d, dim=1, stable=True).indices[:, :k])
    return torch.cat(out)


def _mesh_neighbours(faces: torch.Tensor, n_verts: int) -> torch.Tensor:
    """(V, D) table of each vertex's distinct neighbours over the faces (a vertex a
    face repeats is its own neighbour, as in the reference's sets), padded with -1."""
    pairs = ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))
    src = torch.cat([faces[:, i] for i, _ in pairs])
    dst = torch.cat([faces[:, j] for _, j in pairs])
    key = torch.unique(src * n_verts + dst)
    src, dst = key // n_verts, key % n_verts
    degree = torch.bincount(src, minlength=n_verts)
    table = torch.full((n_verts, int(degree.max())), -1, dtype=torch.int64,
                       device=faces.device)
    start = torch.cumsum(degree, 0) - degree
    table[src, torch.arange(len(src), device=faces.device) - start[src]] = dst
    return table


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class BodyModel(nn.Module):
    """Body mesh interface (the role of hmr2_model.smpl in the reference): buffers
    ``v_template`` (V, 3) and ``faces`` (F, 3) int64, and ``vertices(...)``."""
    v_template: torch.Tensor
    faces: torch.Tensor

    def vertices(self, global_orient, body_pose, betas) -> torch.Tensor:
        raise NotImplementedError


def _capsule_body(n_rings: int = 24, n_seg: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic x-symmetric humanoid-ish capsule (~1.7 m tall, origin at
    pelvis) for the synthetic backend. Symmetric across x so symmetry
    inpainting is exercised."""
    vs, faces = [], []
    heights = np.linspace(-0.85, 0.85, n_rings)
    for i, z in enumerate(heights):
        # torso bulge + head taper
        t = (z + 0.85) / 1.7
        r = 0.16 + 0.12 * np.sin(np.pi * min(t, 0.8) / 0.8) * (1.0 - 0.5 * (t > 0.85))
        for j in range(n_seg):
            a = 2 * np.pi * j / n_seg
            vs.append([r * np.cos(a), r * np.sin(a), z])
    for i in range(n_rings - 1):
        for j in range(n_seg):
            a = i * n_seg + j
            b = i * n_seg + (j + 1) % n_seg
            c = (i + 1) * n_seg + j
            d = (i + 1) * n_seg + (j + 1) % n_seg
            faces.append([a, b, c])
            faces.append([b, d, c])
    return np.asarray(vs, np.float32), np.asarray(faces, np.int32)


class SyntheticBody(BodyModel):
    """Parametric capsule body: betas[0] scales girth, global_orient rotates."""

    def __init__(self, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        v_template, faces = _capsule_body()
        self.register_buffer("v_template", torch.as_tensor(v_template, device=device))
        self.register_buffer("faces", torch.as_tensor(faces, dtype=torch.int64,
                                                      device=device))

    def vertices(self, global_orient, body_pose, betas) -> torch.Tensor:
        del body_pose
        dev = self.v_template.device
        v = self.v_template.clone()
        if betas is not None:
            betas = to_tensor(betas, dev).reshape(-1)
            if len(betas):
                v[:, :2] *= (1.0 + 0.1 * float(betas[0]))
        if global_orient is not None:
            rot = to_tensor(global_orient, dev, _F64).reshape(3, 3)
            v = v.to(_F64) @ rot.T
        return v.to(torch.float32)


class SyntheticSegmenter:
    """Person mask = pixels that differ from a flat background colour."""

    def __init__(self, background: int = 0, device="cuda"):
        self.background = background
        self.device = resolve_device(device)

    def __call__(self, image_bgr) -> torch.Tensor:
        image = to_tensor(image_bgr, self.device)
        return (image.to(torch.int32) != self.background).any(dim=-1)


class SyntheticSmplFitter:
    """Places the synthetic body at the depth implied by the bbox height in the
    crop camera (z = f * body_height / pixel_height), like HMR's weak
    perspective lift. Deterministic; on the body's device."""

    def __init__(self, body: BodyModel):
        self.body = body

    def fit(self, crop_bgr, bbox_px_height: float) -> Dict:
        del crop_bgr
        tv = self.body.v_template
        body_h = float(tv[:, 2].max() - tv[:, 2].min())
        # bbox height in crop pixels is ~CROP * bbox/longest-side; approximate
        z = F_HMR * body_h / max(CROP * 0.9, 1.0)
        f32 = dict(dtype=torch.float32, device=tv.device)
        return dict(
            vertices=tv[None].clone(),
            cam_t=torch.tensor([[0.0, 0.0, z]], **f32),
            smpl_pose=torch.eye(3, **f32).expand(1, 23, 3, 3).clone(),
            global_orient=torch.eye(3, **f32)[None, None].clone(),
            betas=torch.zeros((1, 10), **f32),
        )


class SegformerSegmenter:
    """Cityscapes SegFormer person masks (reference get_global_human_mask,
    pedestrian_processor.py:107-130; person class 11) from a local snapshot, on
    ``device`` (``models/segformer.py``)."""

    PERSON_CLASS = 11

    def __init__(self, model_path: str, device="cuda"):
        from ..models.segformer import SegformerClassMap
        self.classes = SegformerClassMap(model_path, device=device)
        self.device = self.classes.device

    def __call__(self, image_bgr) -> torch.Tensor:
        return self.classes(to_host(image_bgr)[:, :, ::-1]) == self.PERSON_CLASS


# ---------------------------------------------------------------------------
# processor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PedestrianProcessor:
    """Texture harvest + re-render (reference PedestrianProcessor) on ``device``."""
    segmenter: object
    fitter: object
    body: BodyModel
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.faces_host = to_host(self.body.faces).astype(np.int32)  # the rasterizer's
        self.neighbours = _mesh_neighbours(to_tensor(self.body.faces, self.device),
                                           len(self.body.v_template))
        self.symmetry_idx = self._symmetry_indices()

    def _symmetry_indices(self) -> torch.Tensor:
        """Nearest template vertex of each x-flipped vertex (reference :93-105)."""
        tv = to_tensor(self.body.v_template, self.device, _F64)
        flipped = tv.clone()
        flipped[:, 0] *= -1
        return _nearest(flipped, tv, 1)[:, 0]

    # -- pass 1 -------------------------------------------------------------

    def get_global_human_mask(self, image_bgr) -> torch.Tensor:
        return self.segmenter(image_bgr)

    def estimate_smpl(self, image_bgr, bbox: Sequence[float]) -> Dict:
        """Crop around bbox, run the fitter, return reference-shaped output
        (reference estimate_smpl :132-182)."""
        x1, y1, x2, y2 = np.asarray(bbox, np.float64)
        center = np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0])
        width, height = x2 - x1, y2 - y1
        scale = max(width, height) / 200.0
        tform = crop_affine(center, scale)
        crop = warp_affine_nearest(image_bgr, tform, (CROP, CROP), 0, device=self.device)
        out = self.fitter.fit(crop, height)
        out["crop_info"] = {"tform": tform}
        out["bbox_height"] = height
        return out

    def compute_vertices(self, smpl_params: Dict) -> torch.Tensor:
        return self.body.vertices(smpl_params["global_orient"], smpl_params["body_pose"],
                                  smpl_params["betas"])[None]

    def _project_crop(self, verts_cam: torch.Tensor) -> torch.Tensor:
        """(V, 3) camera-space -> (V, 3) crop-screen u, v, z."""
        z = verts_cam[:, 2]
        u = F_HMR * verts_cam[:, 0] / z + C_HMR
        v = F_HMR * verts_cam[:, 1] / z + C_HMR
        return torch.stack([u, v, z], dim=1)

    def _camera_vertices(self, smpl_out: Dict) -> torch.Tensor:
        return (to_tensor(smpl_out["vertices"], self.device)[0]
                + to_tensor(smpl_out["cam_t"], self.device)[0])

    def render_instance_id_map(self, smpl_outputs: List[Dict], ped_ids: Sequence[int],
                               image_shape) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-person crop depth render, warped back and z-merged into full-image
        id (int32) / depth (float32) maps for occlusion handling (reference
        :212-280)."""
        H, W = image_shape[:2]
        full_id = torch.zeros((H, W), dtype=torch.int32, device=self.device)
        full_depth = torch.full((H, W), float("inf"), dtype=torch.float32,
                                device=self.device)
        for smpl_out, pid in zip(smpl_outputs, ped_ids):
            screen = self._project_crop(self._camera_vertices(smpl_out))
            _, depth_crop, fid = rasterize_mesh(to_host(screen.to(torch.float32)),
                                                self.faces_host, None, CROP, CROP)
            tinv = invert_affine(np.asarray(smpl_out["crop_info"]["tform"]))
            inside, yi, xi = _affine_source(tinv, (W, H), (CROP, CROP), self.device)
            depth_crop = to_tensor(depth_crop, self.device)
            mask_crop = to_tensor(fid >= 0, self.device)
            update = inside & mask_crop[yi, xi] & (depth_crop[yi, xi] < full_depth)
            full_depth = torch.where(update, depth_crop[yi, xi], full_depth)
            full_id = torch.where(update, pid, full_id)
        return full_id, full_depth

    def project_and_sample_vertices(self, smpl_out: Dict, image_bgr, seg_mask, id_map,
                                    depth_map, current_id: int,
                                    depth_threshold: float = 0.05):
        """Project vertices to the full image; keep those that land on the person
        mask, are not occluded by another instance, and pass the self-occlusion
        depth test; bilinear-sample their colours weighted by bbox_height^2
        (reference :282-407). Returns (V, 3) colours and (V, 1) weights, float32."""
        dev = self.device
        image = to_tensor(image_bgr, dev)
        seg_mask, id_map, depth_map = (to_tensor(x, dev) for x in (seg_mask, id_map,
                                                                   depth_map))
        H, W = image.shape[:2]
        v_cam = self._camera_vertices(smpl_out)
        z = v_cam[:, 2]
        u = F_HMR * v_cam[:, 0] / z + C_HMR
        v = F_HMR * v_cam[:, 1] / z + C_HMR
        (a, b, c), (d, e, f) = (tuple(float(x) for x in row) for row in invert_affine(
            np.asarray(smpl_out["crop_info"]["tform"])))
        u64, v64 = u.to(_F64), v.to(_F64)
        u_full = a * u64 + b * v64 + c
        v_full = d * u64 + e * v64 + f

        u_int = torch.round(u_full).to(torch.int64)
        v_int = torch.round(v_full).to(torch.int64)
        valid = (u_int >= 1) & (u_int < W - 1) & (v_int >= 1) & (v_int < H - 1)
        us, vs = u_int.clamp(0, W - 1), v_int.clamp(0, H - 1)
        ids = id_map[vs, us]
        final_mask = (valid & seg_mask[vs, us] & ((ids == current_id) | (ids == 0))
                      & ((z - depth_map[vs, us]) < depth_threshold))

        u0 = torch.floor(u_full).to(torch.int64).clamp(0, W - 1)
        v0 = torch.floor(v_full).to(torch.int64).clamp(0, H - 1)
        u1 = (u0 + 1).clamp(0, W - 1)
        v1 = (v0 + 1).clamp(0, H - 1)
        wu = (u_full - u0).clamp(0, 1)[:, None]
        wv = (v_full - v0).clamp(0, 1)[:, None]

        def rgb(rows, cols):
            return image[rows, cols].flip(-1).to(torch.float32) / 255.0

        col = (rgb(v0, u0) * (1 - wu) * (1 - wv) + rgb(v0, u1) * wu * (1 - wv)
               + rgb(v1, u0) * (1 - wu) * wv + rgb(v1, u1) * wu * wv)
        w = max(float(smpl_out.get("bbox_height", 100.0)), 50.0) ** 2
        colors = torch.where(final_mask[:, None], col * w, 0.0).to(torch.float32)
        weights = torch.where(final_mask, w, 0.0).to(torch.float32)[:, None]
        return colors, weights

    # -- inpainting ----------------------------------------------------------

    def inpaint_missing_colors(self, vertex_sums, vertex_counts) -> torch.Tensor:
        """Average -> symmetry fill -> KNN fill (k=3, ties to the lower vertex) ->
        mesh-median filter (reference :410-465)."""
        sums = to_tensor(vertex_sums, self.device)
        counts = to_tensor(vertex_counts, self.device)
        avg = sums / torch.where(counts == 0, torch.ones_like(counts), counts)
        valid = counts[:, 0] > 0
        if not bool(valid.any()):
            return torch.ones_like(avg) * 0.5
        si = self.symmetry_idx
        mirrored = ~valid & valid[si]
        avg = torch.where(mirrored[:, None], avg[si], avg)
        valid = valid | mirrored
        if not bool(valid.all()):
            tv = to_tensor(self.body.v_template, self.device, _F64)
            vi = torch.nonzero(valid)[:, 0]
            mi = torch.nonzero(~valid)[:, 0]
            k = min(3, len(vi))
            nn_idx = _nearest(tv[mi], tv[vi], k)
            vcol = avg[vi]
            acc = vcol[nn_idx[:, 0]]
            for j in range(1, k):
                acc = acc + vcol[nn_idx[:, j]]
            avg = avg.index_put((mi,), acc / k)
        return self._median_filter_colors(avg, torch.ones(len(avg), dtype=torch.bool,
                                                          device=self.device))

    def _median_filter_colors(self, colors, valid_mask) -> torch.Tensor:
        """Mesh-neighbourhood per-channel median (reference :468-506): each valid
        vertex with at least 3 neighbours, 3 of them valid, takes the median of its
        own and its valid neighbours' colours (the mean of the two middle values
        for an even count)."""
        colors = to_tensor(colors, self.device)
        valid_mask = to_tensor(valid_mask, self.device, torch.bool)
        if int(valid_mask.sum()) < 10 or self.neighbours.shape[1] == 0:
            return colors
        nb = self.neighbours
        present = nb >= 0
        nb_c = nb.clamp(min=0)
        nb_valid = present & valid_mask[nb_c]
        n_valid = nb_valid.sum(1)
        apply = valid_mask & (present.sum(1) >= 3) & (n_valid >= 3)
        vals = torch.where(nb_valid[..., None], colors[nb_c], float("inf"))
        stacked = torch.sort(torch.cat([colors[:, None], vals], dim=1), dim=1).values
        n = n_valid + 1
        lo = stacked.gather(1, ((n - 1) // 2)[:, None, None].expand(-1, 1, colors.shape[1]))
        hi = stacked.gather(1, (n // 2)[:, None, None].expand(-1, 1, colors.shape[1]))
        return torch.where(apply[:, None], ((lo + hi) / 2)[:, 0], colors)

    # -- pass 2 --------------------------------------------------------------

    def render_colored_mesh(self, smpl_out: Dict, vertex_colors, image_shape,
                            intrinsics: Optional[np.ndarray] = None):
        """Render the textured body into the full image (ROI-cropped pinhole
        camera; reference :508-647). Returns (bgr uint8 (H, W, 3), mask bool,
        depth float32) on the device."""
        H, W = image_shape[:2]
        dev = self.device
        vertices = to_tensor(smpl_out["vertices"], dev)
        if vertices.ndim == 3:
            vertices = vertices[0]
        tform = np.asarray(smpl_out["crop_info"]["tform"])
        tinv = invert_affine(tform)

        if intrinsics is not None and "pos_cam" in smpl_out:
            T_mesh = to_host(smpl_out["pos_cam"]).reshape(3)
            K = np.asarray(intrinsics)
            f_x, f_y = K[0, 0], K[1, 1]
            c_x, c_y = K[0, 2], K[1, 2]
        else:
            T_mesh = to_host(smpl_out["cam_t"]).reshape(-1)[-3:]
            s_x, s_y = tinv[0, 0], tinv[1, 1]
            t_x, t_y = tinv[0, 2], tinv[1, 2]
            f_x, f_y = s_x * F_HMR, s_y * F_HMR
            c_x, c_y = s_x * C_HMR + t_x, s_y * C_HMR + t_y

        corners = np.array([[0, 0, 1], [CROP, 0, 1], [CROP, CROP, 1], [0, CROP, 1]],
                           np.float64)
        full = (tinv @ corners.T).T
        min_x, max_x = full[:, 0].min(), full[:, 0].max()
        min_y, max_y = full[:, 1].min(), full[:, 1].max()
        pad_x, pad_y = (max_x - min_x) * 0.5, (max_y - min_y) * 0.5
        rx0 = int(max(0, min_x - pad_x))
        ry0 = int(max(0, min_y - pad_y))
        rx1 = int(min(W, max_x + pad_x))
        ry1 = int(min(H, max_y + pad_y))
        rw, rh = rx1 - rx0, ry1 - ry0
        render = torch.zeros((H, W, 3), dtype=torch.uint8, device=dev)
        mask = torch.zeros((H, W), dtype=torch.bool, device=dev)
        depth = torch.full((H, W), float("inf"), dtype=torch.float32, device=dev)
        if rw <= 0 or rh <= 0:
            return render, mask, depth

        verts_cam = vertices + to_tensor(T_mesh, dev)[None]
        z = verts_cam[:, 2]
        z_safe = torch.where(z == 0, 1e-6, z).to(_F64)
        u = float(f_x) * verts_cam[:, 0].to(_F64) / z_safe + float(c_x - rx0)
        v = float(f_y) * verts_cam[:, 1].to(_F64) / z_safe + float(c_y - ry0)
        screen = torch.stack([u, v, z.to(_F64)], dim=1).to(torch.float32)
        rgb_roi, depth_roi, fid = rasterize_mesh(
            to_host(screen), self.faces_host, to_host(vertex_colors).astype(np.float32),
            rh, rw, z_near=0.05)
        m_roi = to_tensor(fid >= 0, dev)
        bgr = (to_tensor(rgb_roi, dev).flip(-1).clamp(0, 1) * 255).to(torch.uint8)
        render[ry0:ry1, rx0:rx1] = torch.where(m_roi[..., None], bgr, 0)
        mask[ry0:ry1, rx0:rx1] = m_roi
        depth[ry0:ry1, rx0:rx1] = torch.where(m_roi, to_tensor(depth_roi, dev),
                                              float("inf"))
        return render, mask, depth

    # -- coordinate conversions (reference :649-725), per instance on the host --

    def convert_crop_cam_to_world(self, cam_t, crop_info, cam_intrinsics, c2w) -> np.ndarray:
        cam_t = to_host(cam_t)
        tform = np.asarray(crop_info["tform"])
        s = (np.linalg.norm(tform[0, :2]) + np.linalg.norm(tform[1, :2])) / 2.0
        K = np.asarray(cam_intrinsics)
        f_real = (K[0, 0] + K[1, 1]) / 2.0
        z_crop = cam_t[2]
        z_real = z_crop * (s * f_real / F_HMR)
        u_crop = F_HMR * cam_t[0] / z_crop + C_HMR
        v_crop = F_HMR * cam_t[1] / z_crop + C_HMR
        pt_img = invert_affine(tform) @ np.array([u_crop, v_crop, 1.0])
        x_real = (pt_img[0] - K[0, 2]) * z_real / f_real
        y_real = (pt_img[1] - K[1, 2]) * z_real / f_real
        pos_cam = np.array([x_real, y_real, z_real])
        return np.asarray(c2w)[:3, :3] @ pos_cam + np.asarray(c2w)[:3, 3]

    def convert_world_to_crop_cam(self, pos_world, crop_info, cam_intrinsics,
                                  c2w) -> np.ndarray:
        c2w = np.asarray(c2w)
        pos_cam = c2w[:3, :3].T @ (to_host(pos_world) - c2w[:3, 3])
        x_real, y_real, z_real = pos_cam
        z_real = max(z_real, 0.1)
        K = np.asarray(cam_intrinsics)
        f_real = (K[0, 0] + K[1, 1]) / 2.0
        u_img = f_real * x_real / z_real + K[0, 2]
        v_img = f_real * y_real / z_real + K[1, 2]
        tform = np.asarray(crop_info["tform"])
        u_crop, v_crop = tform @ np.array([u_img, v_img, 1.0])
        s = (np.linalg.norm(tform[0, :2]) + np.linalg.norm(tform[1, :2])) / 2.0
        z_crop = z_real * (F_HMR / (s * f_real))
        x_crop = (u_crop - C_HMR) * z_crop / F_HMR
        y_crop = (v_crop - C_HMR) * z_crop / F_HMR
        return np.array([x_crop, y_crop, z_crop])

    def is_mesh_valid(self, smpl_out: Dict) -> bool:
        """Reject implausible fits whose crop-space extent exceeds 300 px
        (reference :727-748)."""
        screen = self._project_crop(self._camera_vertices(smpl_out))
        extent = screen[:, :2].amax(0) - screen[:, :2].amin(0)
        return bool((extent <= 300).all())


def make_synthetic_processor(device="cuda") -> PedestrianProcessor:
    body = SyntheticBody(device=device)
    return PedestrianProcessor(segmenter=SyntheticSegmenter(device=device),
                               fitter=SyntheticSmplFitter(body), body=body, device=device)
