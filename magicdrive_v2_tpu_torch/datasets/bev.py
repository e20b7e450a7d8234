"""BEV map construction: h5 cache reader + dynamic-object / aux rasterization (the
port's own copy of the JAX package's datasets/bev.py).

Equivalent of the reference's LoadBEVSegmentation (reference
magicdrivedit/mmdet_plugin/datasets/pipelines/loading.py:308-614):

- static map layers (8 classes, e.g. 8x400x400) come from the offline h5 cache
  (one-hot encoded per sample token); without a cache they come from the nuScenes
  devkit's map API when it is importable, else they are zeros (with a warning);
- dynamic per-class object channels and the 7 aux channels (visibility,
  center-offset, center-ohw, height) are rasterized here from the gt boxes with the
  native polygon fill (``..native.fill_polygons``), matching the reference's canvas
  conventions.

Canvas convention: lidar (x, y) -> canvas (row=x, col=y) via `lidar2canvas`, then a
final transpose(ch, 2, 1) like the reference, so output is channel-first (C, h, w).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .geometry import boxes_to_corners

logger = logging.getLogger(__name__)

__all__ = ["LoadBEVSegmentation", "one_hot_decode", "one_hot_encode"]

AUX_DATA_CH = {"visibility": 1, "center_offset": 2, "center_ohw": 4, "height": 1}

# bottom corners in mmdet3d corner ordering (x0y0z0, x0y1z0, x1y1z0, x1y0z0)
_BOTTOM_CORNER_INDEX = [0, 3, 7, 4]


def one_hot_encode(labels: np.ndarray) -> np.ndarray:
    """(C, H, W) binary -> (H, W) packed int bitmask (cache format)."""
    out = np.zeros(labels.shape[1:], np.int64)
    for ci in range(labels.shape[0]):
        out |= labels[ci].astype(np.int64) << ci
    return out


def one_hot_decode(packed: np.ndarray, num_classes: int) -> np.ndarray:
    """(H, W) packed int bitmask -> (C, H, W) uint8."""
    return np.stack([((packed >> ci) & 1).astype(np.uint8)
                     for ci in range(num_classes)])


class LoadBEVSegmentation:
    def __init__(self, dataset_root: str, xbound: Tuple[float, float, float],
                 ybound: Tuple[float, float, float], classes: Sequence[str],
                 object_classes: Optional[Sequence[str]] = None,
                 aux_data: Optional[Sequence[str]] = None,
                 cache_file: Optional[str] = None):
        patch_h = ybound[1] - ybound[0]
        patch_w = xbound[1] - xbound[0]
        canvas_h = int(patch_h / ybound[2])
        canvas_w = int(patch_w / xbound[2])
        self.patch_size = (patch_h, patch_w)
        self.canvas_size = (canvas_h, canvas_w)
        self.classes = list(classes)
        self.object_classes = list(object_classes) if object_classes else None
        self.aux_data = list(aux_data) if aux_data else None
        self.lidar2canvas = np.array([
            [canvas_h / patch_h, 0, canvas_h / 2],
            [0, canvas_w / patch_w, canvas_w / 2],
            [0, 0, 1],
        ])
        self.cache = None
        self._cache_handle = None
        if cache_file:
            import os
            if os.path.isfile(cache_file):
                logger.info("using BEV cache from: %s", cache_file)
                self.cache = cache_file
            else:
                logger.warning("BEV cache %s missing; static layers -> zeros",
                               cache_file)
        self.dataset_root = dataset_root
        self._maps = None  # lazy NuScenesMap handles when devkit available
        self._warned_locations: set = set()

    # -- canvas helpers --

    def _to_canvas(self, pts_lidar: np.ndarray) -> np.ndarray:
        """(..., 2) lidar xy -> canvas xy."""
        padded = np.concatenate([pts_lidar, np.ones((*pts_lidar.shape[:-1], 1))],
                                axis=-1)
        return (padded @ self.lidar2canvas.T)[..., :2]

    @staticmethod
    def _fill_polygon(canvas: np.ndarray, poly_xy: np.ndarray, value=1):
        from ..native import fill_polygons
        fill_polygons(canvas, [poly_xy], value)

    # -- dynamic objects (reference :458-500) --

    def _project_dynamic(self, static_label: np.ndarray,
                         data: Optional[dict]) -> np.ndarray:
        ch = len(self.object_classes)
        dynamic = np.zeros((ch, *self.canvas_size), np.uint8)
        if data is not None and len(data.get("boxes", ())) > 0:
            from ..native import fill_polygons
            corners = boxes_to_corners(data["boxes"])  # (N, 8, 3)
            bottom = corners[:, _BOTTOM_CORNER_INDEX, :2]
            canvas_pts = self._to_canvas(bottom).astype(np.float32)
            labels = np.asarray(data["labels"])
            for cls_id in range(ch):
                polys = list(canvas_pts[labels == cls_id])
                if polys:
                    fill_polygons(dynamic[cls_id], polys)
        dynamic = dynamic.transpose(0, 2, 1)
        return np.concatenate([static_label, dynamic], axis=0)

    # -- aux channels (reference :370-456) --

    def _get_dynamic_aux(self, data: Optional[dict]) -> Optional[np.ndarray]:
        if self.aux_data is None:
            return None
        aux_ch = sum(AUX_DATA_CH[k] for k in self.aux_data)
        if aux_ch == 0:
            return None
        aux = np.zeros((*self.canvas_size, aux_ch), np.float32)
        if data is not None and len(data.get("boxes", ())) > 0:
            boxes = np.asarray(data["boxes"], np.float32)
            corners = boxes_to_corners(boxes)
            coords = np.stack(np.meshgrid(np.arange(self.canvas_size[1]),
                                          np.arange(self.canvas_size[0])),
                              -1).astype(np.float32)
            visibility = data.get("visibility")
            for i in range(len(boxes)):
                bottom = corners[i, _BOTTOM_CORNER_INDEX, :2]
                center = boxes[i, None, :2]
                front = corners[i, [4, 7], :2].mean(0, keepdims=True)
                left = corners[i, [0, 4], :2].mean(0, keepdims=True)
                pts = self._to_canvas(np.concatenate([bottom, center, front, left]))
                box_c, center_c, front_c, left_c = (pts[:4], pts[4:5], pts[5:6],
                                                    pts[6:7])
                mask = np.zeros(self.canvas_size, np.uint8)
                self._fill_polygon(mask, box_c)
                sel = mask > 0
                cur = 0
                if "visibility" in self.aux_data:
                    vis = visibility[i] if visibility is not None else 1.0
                    aux[sel, cur:cur + 1] = vis
                    cur += 1
                if "center_offset" in self.aux_data:
                    aux[sel, cur:cur + 2] = coords[sel] - center_c
                    cur += 2
                if "center_ohw" in self.aux_data:
                    h = np.linalg.norm(front_c - center_c)
                    w = np.linalg.norm(left_c - center_c)
                    v = ((front_c - center_c)
                         / (np.linalg.norm(front_c - center_c) + 1e-6))[0]
                    aux[sel, cur:cur + 4] = np.array([h, w, v[0], v[1]])[None]
                    cur += 4
                if "height" in self.aux_data:
                    aux[sel, cur:cur + 1] = boxes[i, 5]
                    cur += 1
        return aux.transpose(2, 1, 0)

    # -- cache / live static layers --

    def _static_from_cache(self, token: str) -> Optional[np.ndarray]:
        if self.cache is None:
            return None
        if self._cache_handle is None:
            import h5py
            self._cache_handle = h5py.File(self.cache, "r")
        try:
            packed = self._cache_handle["gt_masks_bev_static"][token][:]
        except KeyError:
            return None
        return one_hot_decode(packed, len(self.classes))

    # class name -> devkit map layers (reference loading.py:545-552)
    _LAYER_MAPPINGS = {
        "drivable_area*": ["road_segment", "lane"],
        "divider": ["road_divider", "lane_divider"],
    }

    def _map_api_for(self, location: str):
        """NuScenesMap handle per location; tests may pre-populate self._maps
        with any object exposing get_map_mask(patch_box, patch_angle,
        layer_names, canvas_size)."""
        if self._maps is None:
            self._maps = {}
        if location not in self._maps:
            from nuscenes.map_expansion.map_api import NuScenesMap
            self._maps[location] = NuScenesMap(self.dataset_root, location)
        return self._maps[location]

    def _static_live(self, data: dict) -> np.ndarray:
        """In-pipeline static-layer rasterization via the devkit's map API
        (reference LoadBEVSegmentation._get_data, loading.py:526-588): cut the
        ego-centred rotated patch with get_map_mask, transpose to the canvas
        convention, and merge the composite classes (drivable_area*, divider).
        Falls back to zeros when neither devkit nor an injected map handle is
        available (the offline h5 cache path, tools/prepare_map_aux, is then
        the supported source)."""
        zeros = np.zeros((len(self.classes), *self.canvas_size), np.uint8)
        location = data.get("location")
        if location is None:
            return zeros
        try:
            map_api = self._map_api_for(location)
        except (ImportError, FileNotFoundError, OSError,
                AssertionError, ValueError, KeyError) as e:
            # AssertionError/ValueError/KeyError: the devkit asserts location
            # against its hardcoded list and json-parses the expansion files —
            # an unknown location or corrupt asset must degrade to zero layers
            # (with the one-time warning below), not kill the training worker
            if location not in self._warned_locations:
                self._warned_locations.add(location)
                logger.warning(
                    "BEV map for %r unavailable (%s); emitting zero static "
                    "layers — use the h5 cache (tools/prepare_map_aux) or "
                    "install map expansion assets", location, e)
            return zeros

        lidar2global = np.asarray(data["ego2global"]) @ np.asarray(
            data["lidar2ego"])
        map_pose = lidar2global[:2, 3]
        patch_box = (map_pose[0], map_pose[1],
                     self.patch_size[0], self.patch_size[1])
        v = lidar2global[:3, :3] @ np.array([1.0, 0, 0])
        patch_angle = np.arctan2(v[1], v[0]) / np.pi * 180

        mappings = {name: self._LAYER_MAPPINGS.get(name, [name])
                    for name in self.classes}
        layer_names = sorted({l for ls in mappings.values() for l in ls})
        masks = np.asarray(map_api.get_map_mask(
            patch_box=patch_box, patch_angle=patch_angle,
            layer_names=layer_names, canvas_size=self.canvas_size))
        masks = masks.transpose(0, 2, 1).astype(bool)
        labels = zeros.copy()
        for k, name in enumerate(self.classes):
            for layer_name in mappings[name]:
                labels[k][masks[layer_names.index(layer_name)]] = 1
        return labels

    def __call__(self, data: Dict[str, Any], rng=None) -> Dict[str, Any]:
        static = self._static_from_cache(data["token"])
        if static is None:
            static = self._static_live(data)
        data["gt_masks_bev_static"] = static
        if self.object_classes is not None:
            data["gt_masks_bev"] = self._project_dynamic(static, data)
            data["gt_aux_bev"] = self._get_dynamic_aux(data)
        else:
            data["gt_masks_bev"] = static
            data["gt_aux_bev"] = None
        return data
