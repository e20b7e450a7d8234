"""nuScenes 12Hz clip datasets (host-side, mmcv-free; the port's own copy of the
JAX package's datasets/nuscenes.py).

The reference dataset stack (reference
magicdrivedit/datasets/nuscenes_t_dataset.py:736-1086, nuscenes_variable.py:19-245,
mmdet_plugin/datasets/nuscenes_dataset.py:211-292) reading the 12Hz `*_infos_*.pkl`
produced by tools/prepare_data (same schema as the reference converter) directly with
pickle — no mmcv/mmdet registry stack.

Pipeline per frame: load multi-view JPEGs -> ImageAug3D -> ObjectNameFilter ->
BEV map from the h5 cache (see .bev) -> Reorder -> ImageNormalize; then per-clip
collate (see .collate). Outputs numpy only; tensors are made where a batch goes to
the device.

Randomness: every item draws from generators of its own, derived from the
dataset's ``seed``, its ``epoch`` (``set_epoch``) and the item's index
(``item_rngs``): a ``random.Random`` for box dropping, box dropout / addition and
the retry after an empty clip, an ``np.random.Generator`` for the image and box
augmentations. So an item is the same whichever thread loads it and whenever, and a
resumed run loads what an uninterrupted one would.
"""
from __future__ import annotations

import logging
import os
import pickle
import random as pyrandom
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..registry import DATASETS
from .collate import collate_fn_single_clip
from .geometry import obtain_next2top, pose_to_matrix
from .transforms import Compose

IMG_FPS = 120

logger = logging.getLogger(__name__)

__all__ = ["NuScenesTDataset", "NuScenesVariableDataset", "NuScenesMultiResDataset",
           "frame_from_info", "max_full_clip_len"]


def max_full_clip_len(dataset) -> int:
    """Longest "full" clip (pixel frames, after fps subsampling), snapped down
    to 8n+1 — the derived bucket max-T when cfg.full_bucket_t is unset. Every
    full-length scene pads to this ONE length so the whole "full" bucket has one
    shape (the reference instead runs each scene length eagerly,
    nuscenes_t_dataset.py:843-894)."""
    def longest(ds) -> int:
        if isinstance(ds, NuScenesMultiResDataset):
            return max((longest(d) for d in ds.datasets.values()), default=0)
        if isinstance(ds, NuScenesVariableDataset):
            clips = ds.clip_infos.get("full", [])
            if not clips:
                return 0
            fps_list = [f for f, t in zip(ds.fps_lists or [], ds.clip_infos)
                        if t == "full"]
            min_interval = min((ds.base_fps // f for fl in fps_list for f in fl),
                               default=1)
            return max((len(c) - 1) // min_interval + 1 for c in clips)
        if getattr(ds, "num_frames", None) == "full":
            return max((len(c) for c in ds.clip_infos), default=0)
        return 0

    n = longest(dataset)
    if n <= 0:
        raise ValueError("dataset has no 'full' clips to derive a bucket max-T")
    return (n - 1) // 8 * 8 + 1


def frame_from_info(info: dict, view_order: Optional[Sequence[str]] = None) -> dict:
    """Convert one `infos` record into a frame dict (reference
    nuscenes_dataset.py:211-292 get_data_info, numpy edition)."""
    frame: Dict[str, Any] = {
        "token": info["token"],
        "timestamp": info["timestamp"],
        "metas": {
            "location": info.get("location", ""),
            "description": info.get("description", ""),
            "timeofday": info.get("timeofday", ""),
        },
        "is_key_frame": ";" not in info["token"] and len(info["token"]) < 33,
    }
    cams = info["cams"]
    cam_names = list(view_order) if view_order is not None else list(cams.keys())
    image_paths, lidar2camera, lidar2image = [], [], []
    camera_intrinsics, camera2lidar, camera2ego = [], [], []
    for name in cam_names:
        cam = cams[name]
        image_paths.append(cam["data_path"])
        l2c_r = np.linalg.inv(cam["sensor2lidar_rotation"])
        l2c_t = cam["sensor2lidar_translation"] @ l2c_r.T
        l2c = np.eye(4, dtype=np.float32)
        l2c[:3, :3] = l2c_r.T
        l2c[3, :3] = -l2c_t
        lidar2camera.append(l2c.T)
        intr = np.eye(4, dtype=np.float32)
        intr[:3, :3] = cam["camera_intrinsics"]
        camera_intrinsics.append(intr)
        lidar2image.append(intr @ l2c.T)
        c2l = np.eye(4, dtype=np.float32)
        c2l[:3, :3] = cam["sensor2lidar_rotation"]
        c2l[:3, 3] = cam["sensor2lidar_translation"]
        camera2lidar.append(c2l)
        if "sensor2ego_rotation" in cam:
            camera2ego.append(pose_to_matrix(cam["sensor2ego_rotation"],
                                             cam["sensor2ego_translation"]))
    frame.update(
        image_paths=image_paths,
        lidar2camera=np.stack(lidar2camera),
        lidar2image=np.stack(lidar2image),
        camera_intrinsics=np.stack(camera_intrinsics),
        camera2lidar=np.stack(camera2lidar),
    )
    if camera2ego:
        frame["camera2ego"] = np.stack(camera2ego)
    frame["ego2global"] = pose_to_matrix(info["ego2global_rotation"],
                                         info["ego2global_translation"])
    frame["lidar2ego"] = pose_to_matrix(info["lidar2ego_rotation"],
                                        info["lidar2ego_translation"])
    return frame


class NuScenesTDataset:
    """Fixed-length (or "full") clip dataset over 12Hz-interpolated infos."""

    def __init__(self, ann_file: str, pipeline: Optional[Sequence] = None,
                 dataset_root: str = "", object_classes: Optional[Sequence[str]] = None,
                 video_length=None, start_on_keyframe: bool = True,
                 start_on_firstframe: bool = False, next2topv2: bool = True,
                 fps: int = 12, img_collate_param: Optional[dict] = None,
                 micro_frame_size: Optional[int] = None,
                 balance_keywords: Optional[Sequence[str]] = None,
                 filter_empty_gt: bool = True, use_valid_flag: bool = False,
                 load_interval: int = 1, view_order: Optional[Sequence[str]] = None,
                 allow_class: Optional[Sequence[int]] = None,
                 del_box_ratio: float = 0.0, drop_nearest_car: int = 0,
                 drop_ori_imgs: bool = False, test_mode: bool = False, seed: int = 0,
                 **kwargs):
        self.ann_file = ann_file
        self.dataset_root = dataset_root
        self.object_classes = list(object_classes or [])
        self.video_length = video_length
        self.start_on_keyframe = start_on_keyframe
        self.start_on_firstframe = start_on_firstframe
        self.next2topv2 = next2topv2
        self.fps = fps
        self.micro_frame_size = micro_frame_size
        self.balance_keywords = balance_keywords
        self.filter_empty_gt = filter_empty_gt
        self.use_valid_flag = use_valid_flag
        self.load_interval = load_interval
        self.view_order = view_order
        self.allow_class = allow_class
        self.del_box_ratio = del_box_ratio
        self.drop_nearest_car = drop_nearest_car
        self.drop_ori_imgs = drop_ori_imgs
        self.test_mode = test_mode
        self.img_collate_param = dict(img_collate_param or {})
        self.pipeline = Compose(pipeline) if pipeline else None
        self.seed = int(seed)
        self.epoch = 0
        self.data_infos = self.load_annotations(ann_file)

    @property
    def num_frames(self):
        return self.video_length

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def item_rngs(self, index) -> Tuple[pyrandom.Random, np.random.Generator]:
        """The (python, numpy) generators of item ``index`` (an int, or a string
        index of the bucketed datasets) in the current epoch."""
        key = index if isinstance(index, int) else zlib.crc32(str(index).encode())
        seq = np.random.SeedSequence([self.seed, self.epoch, int(key)])
        return pyrandom.Random(int(seq.generate_state(1, np.uint64)[0])), \
            np.random.default_rng(seq)

    # -- annotation / clip construction (reference :843-911) --

    def load_annotations(self, ann_file: str) -> List[dict]:
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        data_infos = sorted(data["infos"], key=lambda e: e["timestamp"])
        data_infos = data_infos[:: self.load_interval]
        self.metadata = data.get("metadata", {})
        self.version = self.metadata.get("version", "")
        self.clip_infos = self.build_clips(data_infos, data["scene_tokens"])
        return data_infos

    def _balance(self, data_infos, scene_tokens):
        keywords = {k: [] for k in self.balance_keywords}
        prepend_daytime = "none" in keywords
        if not prepend_daytime:
            keywords["none"] = []
        for scene in scene_tokens:
            anno = data_infos[self.token_data_dict[scene[0]]].get(
                "description", "").lower()
            matched = [k for k in self.balance_keywords if k in anno]
            if matched:
                for k in matched:
                    keywords[k].append(scene)
            else:
                if prepend_daytime and "daytime" not in anno:
                    for tok in scene:
                        info = data_infos[self.token_data_dict[tok]]
                        info["description"] = "Daytime. " + info["description"]
                keywords["none"].append(scene)
        counts = {k: len(v) for k, v in keywords.items() if len(v) > 0}
        max_count = max(counts.values())
        balanced = []
        for k, items in keywords.items():
            if not items:
                continue
            balanced.extend(items * (max_count // counts[k]))
        return data_infos, balanced

    def build_clips(self, data_infos, scene_tokens, video_length=None,
                    repeat_times: int = 1) -> List[List[int]]:
        video_length = video_length if video_length is not None else self.video_length
        self.token_data_dict = {item["token"]: idx
                                for idx, item in enumerate(data_infos)}
        if self.balance_keywords is not None:
            data_infos, scene_tokens = self._balance(data_infos, scene_tokens)
        all_clips: List[List[int]] = []
        skipped = 0
        for scene in scene_tokens:
            if video_length == "full":
                clip = [self.token_data_dict[tok] for tok in scene]
                if self.micro_frame_size is not None:
                    # snap DOWN to the 8n+1 grid; the old `len % m - 1` form
                    # left exact multiples (e.g. 240 % 8 == 0) untrimmed
                    m = self.micro_frame_size
                    clip = clip[:(len(clip) - 1) // m * m + 1]
                all_clips.append(clip)
            else:
                starts = [0] if self.start_on_firstframe else range(
                    len(scene) - video_length + 1)
                for start in starts:
                    # 12Hz interpolated (non-key) frames have ";"-joined or long tokens
                    if self.start_on_keyframe and (";" in scene[start]
                                                   or len(scene[start]) >= 33):
                        skipped += 1
                        continue
                    all_clips.append([self.token_data_dict[tok]
                                      for tok in scene[start:start + video_length]])
        if repeat_times > 1:
            all_clips = all_clips * int(repeat_times)
        logger.info("[%s] %d scenes -> %d clips (skipped %d starts)",
                    type(self).__name__, len(scene_tokens), len(all_clips), skipped)
        return all_clips

    def __len__(self):
        return len(self.clip_infos)

    # -- per-clip loading (reference :916-932, :1031-1083) --

    def load_clip(self, clip: Sequence[int]) -> List[dict]:
        first_info = self.data_infos[clip[0]]
        frames = []
        for idx in clip:
            info = self.data_infos[idx]
            frame = frame_from_info(info, self.view_order)
            frame["next2top"] = obtain_next2top(first_info, info, v2=self.next2topv2)
            frame.update(self._ann_arrays(info))
            frames.append(frame)
        return frames

    def _ann_arrays(self, info: dict) -> dict:
        """gt boxes/labels/instance-tokens from one info record (reference
        nuscenes_dataset.get_ann_info + NuScenesTDataset.get_ann_info :934-960)."""
        if self.use_valid_flag:
            mask = np.asarray(info["valid_flag"], bool)
        else:
            mask = np.asarray(info["num_lidar_pts"]) > 0
        boxes = np.asarray(info["gt_boxes"], np.float32)[mask]
        names = np.asarray(info["gt_names"])[mask]
        labels = np.array([self.object_classes.index(n) if n in self.object_classes
                           else -1 for n in names], np.int64)
        out = {"boxes": boxes.reshape(-1, info["gt_boxes"].shape[-1]
                                      if len(info["gt_boxes"]) else 7),
               "labels": labels, "names": names}
        if "gt_box_ids" in info:
            out["tokens"] = [info["gt_box_ids"][i] for i in np.where(mask)[0]]
        else:
            out["tokens"] = [f"idx{i}" for i in range(len(boxes))]
        return out

    def _load_images(self, frame: dict):
        from PIL import Image
        imgs = []
        for path in frame["image_paths"]:
            full = path if os.path.isabs(path) else os.path.join(
                self.dataset_root, path)
            imgs.append(Image.open(full).convert("RGB"))
        frame["img"] = imgs
        frame["ori_shape"] = imgs[0].size  # (W, H)
        return frame

    def rand_del_box(self, frames: List[dict], rng: pyrandom.Random):
        """Instance dropping / class filtering (reference :962-1029)."""
        possible = sorted({t for f in frames for t in f["tokens"]})
        rng.shuffle(possible)
        possible = possible[int(len(possible) * self.del_box_ratio):]
        if self.del_box_ratio > 0 or self.drop_nearest_car > 0:
            mid = frames[len(frames) // 2]
            car_idx = np.where(mid["labels"] == 0)[0]
            car_tokens = [mid["tokens"][i] for i in car_idx]
            if car_tokens:
                centers = mid["boxes"][car_idx, :3]
                dist = (centers ** 2).sum(-1)
                car_tokens = [car_tokens[i] for i in np.argsort(dist)]
            keep = set(possible) | set(car_tokens[:3])
            if self.drop_nearest_car > 0:
                keep -= set(car_tokens[:self.drop_nearest_car])
        else:
            keep = set(possible)
        for f in frames:
            sel = [i for i, tok in enumerate(f["tokens"])
                   if tok in keep and (self.allow_class is None
                                       or int(f["labels"][i]) in self.allow_class)]
            f["boxes"] = f["boxes"][sel]
            f["labels"] = f["labels"][sel]
            f["tokens"] = [f["tokens"][i] for i in sel]

    def load_frames(self, frames: List[dict], rngs) -> Optional[dict]:
        """One clip's frames through the pipeline and the collate; ``rngs`` is the
        item's (python, numpy) generator pair."""
        py_rng, np_rng = rngs
        examples = []
        for frame in frames:
            if self.pipeline is not None:
                frame = self._load_images(frame)
                frame = self.pipeline(frame, rng=np_rng)
            if frame is None:
                return None
            if self.filter_empty_gt and frame.get("is_key_frame") and not (
                    np.asarray(frame["labels"]) != -1).any():
                return None
            examples.append(frame)
        if (self.del_box_ratio > 0 or self.allow_class is not None
                or self.drop_nearest_car > 0):
            self.rand_del_box(examples, py_rng)
        collate_param = dict(self.img_collate_param)
        collate_param.setdefault("is_train", not self.test_mode)
        ret = collate_fn_single_clip(examples, rng=py_rng, **collate_param)
        if self.drop_ori_imgs:
            ret["pixel_values_shape"] = np.asarray(ret["pixel_values"].shape,
                                                   np.int32)
            ret.pop("pixel_values")
        return ret

    def get_data_info(self, index: int) -> List[dict]:
        return self.load_clip(self.clip_infos[index])

    def prepare_train_data(self, index: int, rngs=None) -> Optional[dict]:
        frames = self.get_data_info(index)
        ret = self.load_frames(frames, rngs or self.item_rngs(index))
        if ret is None:
            return None
        is_video = self.num_frames == "full" or self.num_frames > 1
        ret["fps"] = self.fps if is_video else IMG_FPS
        ret["num_frames"] = len(frames)
        if self.num_frames == "full":
            ret["is_full_clip"] = True  # ragged scene -> pad to bucket max-T
        return ret

    def __getitem__(self, index):
        rngs = self.item_rngs(index)
        while True:
            data = self.prepare_train_data(index, rngs)
            if data is not None:
                return data
            index = rngs[0].randrange(len(self))


class NuScenesVariableDataset(NuScenesTDataset):
    """Multi-(length, fps) clips; indexed "{idx}-{T}-{fps}" (reference
    nuscenes_variable.py:19-207)."""

    def __init__(self, *args, video_length: Optional[List] = None, base_fps: int = 12,
                 fps: Optional[List[List[int]]] = None,
                 repeat_times: Optional[List[int]] = None, **kwargs):
        self.video_lengths = video_length
        self.base_fps = base_fps
        self.fps_lists = fps
        self.repeat_times = repeat_times
        super().__init__(*args, video_length=video_length, fps=base_fps, **kwargs)

    def load_annotations(self, ann_file: str) -> List[dict]:
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        data_infos = sorted(data["infos"], key=lambda e: e["timestamp"])
        data_infos = data_infos[:: self.load_interval]
        self.metadata = data.get("metadata", {})
        self.version = self.metadata.get("version", "")
        self.clip_infos = OrderedDict()
        for idx, video_length in enumerate(self.video_lengths):
            repeat = self.repeat_times[idx] if self.repeat_times else 1
            self.clip_infos[video_length] = self.build_clips(
                data_infos, data["scene_tokens"], video_length, repeat)
        return data_infos

    @property
    def possible_keys(self) -> List[Tuple[int, Any]]:
        keys = []
        for f, t in zip(self.fps_lists, self.clip_infos.keys()):
            for fps in f:
                keys.append((fps, t))
        return keys

    def key_len(self, key) -> int:
        if isinstance(key, str):
            fps, t = key.split("-")
            t = t if t == "full" else int(t)
        else:
            fps, t = key
        return len(self.clip_infos[t])

    def __len__(self):
        return sum(self.key_len(k) for k in self.possible_keys)

    def parse_index(self, index: str):
        idx, real_t, fps = index.split("-")
        real_t = real_t if real_t == "full" else int(real_t)
        return int(idx), real_t, int(fps)

    def prepare_train_data(self, index: str, rngs=None) -> Optional[dict]:
        idx, real_t, fps = self.parse_index(index)
        interval = self.base_fps // fps if (isinstance(real_t, str)
                                            or real_t > 1) else 1
        clip = self.clip_infos[real_t][idx][0::interval]
        frames = self.load_clip(clip)
        ret = self.load_frames(frames, rngs or self.item_rngs(index))
        if ret is None:
            return None
        if real_t == "full":
            ret["is_full_clip"] = True
        real_t = len(frames)
        ret["fps"] = IMG_FPS if real_t == 1 else fps
        ret["num_frames"] = real_t
        return ret

    def __getitem__(self, index: str):
        rngs = self.item_rngs(index)
        while True:
            data = self.prepare_train_data(index, rngs)
            if data is not None:
                return data
            idx, real_t, fps = self.parse_index(index)
            idx = rngs[0].randrange(len(self.clip_infos[real_t]))
            index = f"{idx}-{real_t}-{fps}"


class NuScenesMultiResDataset:
    """Dict of per-resolution variable datasets; bucket key "H-W-fps-T" (reference
    nuscenes_variable.py:210-245)."""

    def __init__(self, cfg: Sequence[Tuple[Tuple[int, int], Any]], seed: int = 0):
        self.datasets: "OrderedDict[Tuple[int, int], NuScenesVariableDataset]" = \
            OrderedDict()
        for res, d_cfg in cfg:
            if isinstance(d_cfg, dict):
                d_cfg = dict(d_cfg)
                d_cfg.pop("type", None)
                d_cfg.setdefault("seed", seed)
                d_cfg = NuScenesVariableDataset(**d_cfg)
            self.datasets[tuple(res)] = d_cfg

    def as_buckets(self) -> "OrderedDict[str, List[int]]":
        buckets: "OrderedDict[str, List[int]]" = OrderedDict()
        for res, ds in self.datasets.items():
            for key in ds.possible_keys:
                bucket_id = "-".join(map(str, [*res, *key]))
                buckets[bucket_id] = list(range(ds.key_len(key)))
        return buckets

    def parse_index(self, index: str):
        parts = index.split("-")
        idx, real_h, real_w, fps = map(int, parts[:-1])
        real_t = parts[-1]
        real_t = real_t if real_t == "full" else int(real_t)
        return idx, real_h, real_w, fps, real_t

    def __len__(self):
        return sum(len(v) for v in self.datasets.values())

    def set_epoch(self, epoch: int):
        for ds in self.datasets.values():
            ds.set_epoch(epoch)

    def __getitem__(self, index: str):
        idx, real_h, real_w, fps, real_t = self.parse_index(index)
        return self.datasets[(real_h, real_w)][f"{idx}-{real_t}-{fps}"]


DATASETS.register_module("NuScenesTDataset", module=NuScenesTDataset)
DATASETS.register_module("NuScenesVariableDataset", module=NuScenesVariableDataset)
DATASETS.register_module("NuScenesMultiResDataset", module=NuScenesMultiResDataset)
