"""PyTorch port, the nuScenes data path: yaml composition, the native host kernels,
BEV maps, clips, model batches, samplers and the loader, against the JAX package on
the CPU.

The data are the nuScenes-format sets ``tests/helpers_mini_nuscenes.generate``
writes (160x90 JPEGs, a tenth of nuScenes' 1600x900), with scene lengths (6, 6) for
fixed-length clips and (9, 19) for whole scenes. The dataset yamls are used as they
stand but for the image size: ``ImageAug3D``'s output and resize are scaled by 1/8
with the same crop geometry (224x400 -> 28x50, 424x800 -> 53x100), so that the
17-frame batches stay small; the BEV maps keep the yamls' 200x200 and 400x400.

Both packages run numpy on the host, so everything is compared for equality, not
closeness. The JAX datasets draw from unseeded generators of their own; each test
hands both packages the same seeded generators instead (the port takes them
explicitly).
"""
import copy
import os
import pickle
import random as pyrandom
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from helpers_mini_nuscenes import generate  # noqa: E402

import magicdrive_v2_tpu.datasets as J  # noqa: E402
import magicdrive_v2_tpu_torch.datasets as T  # noqa: E402
from magicdrive_v2_tpu import native as jnative  # noqa: E402
from magicdrive_v2_tpu.config import config as jconfig  # noqa: E402
from magicdrive_v2_tpu.config.yaml_compose import load_yaml_config as jload  # noqa: E402
from magicdrive_v2_tpu.registry import DATASETS as JDATASETS  # noqa: E402
from magicdrive_v2_tpu.registry import build_module as jbuild  # noqa: E402
from magicdrive_v2_tpu.utils.misc import collate_bboxes_to_maxlen as jcollate_max  # noqa: E402
from magicdrive_v2_tpu_torch import native as tnative  # noqa: E402
from magicdrive_v2_tpu_torch.config import config as tconfig  # noqa: E402
from magicdrive_v2_tpu_torch.config.presets import img_collate_param  # noqa: E402
from magicdrive_v2_tpu_torch.config.yaml_compose import load_yaml_config as tload  # noqa: E402
from magicdrive_v2_tpu_torch.registry import DATASETS as TDATASETS  # noqa: E402
from magicdrive_v2_tpu_torch.registry import build_module as tbuild  # noqa: E402
from magicdrive_v2_tpu_torch.utils.misc import collate_bboxes_to_maxlen  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ("Nuscenes", "Nuscenes_400_map_cache_box_t_with_n2t_12Hz")
# the yamls' ImageAug3D at 1/8 of their output size, on 160x90 inputs
SCALED_AUG = {"Nuscenes": ([28, 50], 0.3125), "Nuscenes_400_map_cache_box_t_with_n2t_12Hz":
              ([53, 100], 0.625)}
BOX_DIM = 16  # width of the box latents drawn in clip_to_model_batch


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """{"fixed": infos of scenes (6, 6), "full": infos of scenes (9, 19)}."""
    root = tmp_path_factory.mktemp("nusc")
    return {"fixed": generate(str(root / "fixed"), scene_lengths=(6, 6)),
            "full": generate(str(root / "full"), scene_lengths=(9, 19))}


def assert_same(a, b, where="batch"):
    """Exact equality of nested dicts / lists of numpy arrays and python values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def split_config(yaml_name, split, ann, video_length, map25=False):
    """The yaml's ``data.<split>`` on the generated set, with the collate parameters
    of the presets (train: is_train, box dropout and addition) and the yaml's
    template; ``map25`` adds the BEV object layers and aux channels (26 map channels)."""
    y = tload(os.path.join(REPO, "configs/dataset", yaml_name + ".yaml"))
    cfg = copy.deepcopy(y["data"][split])
    final_dim, resize = SCALED_AUG[yaml_name]
    for t in cfg["pipeline"]:
        if t["type"] == "ImageAug3D":
            t.update(final_dim=final_dim, resize_lim=[resize, resize])
        if t["type"] == "LoadBEVSegmentation" and map25:
            t.update(object_classes=y["object_classes"], aux_data=y["aux_data"])
    collate = img_collate_param("all-xyz", is_train=split == "train")
    cfg.update(ann_file=ann, dataset_root="", video_length=video_length,
               img_collate_param=dict(collate, template=y["template"]))
    return cfg


def seeded_pair(jds, tds, index, seed):
    """One item from each package with the same seeded generators: the JAX
    dataset's python generator and one numpy generator shared by its transforms
    (the port draws the same in the same order from its pair)."""
    jds._rng = pyrandom.Random(seed)
    gen = np.random.default_rng(seed + 1)
    for t in jds.pipeline.transforms:
        if hasattr(t, "rng"):
            t.rng = gen
    a = jds.prepare_train_data(index)
    b = tds.prepare_train_data(index, (pyrandom.Random(seed), np.random.default_rng(seed + 1)))
    return a, b


@pytest.mark.parametrize("name", sorted(f[:-5] for f in os.listdir(
    os.path.join(REPO, "configs/dataset")) if f.endswith(".yaml")))
def test_yaml_composition_matches_jax(name):
    path = os.path.join(REPO, "configs/dataset", name + ".yaml")
    assert tload(path) == jload(path)
    assert dict(tconfig.Config.fromfile(path)) == dict(jconfig.Config.fromfile(path))
    over = [("dataset.data.val.ann_file", "/x/infos.pkl"),
            ("+dataset.data.val.start_on_firstframe", True)]
    a = tconfig.merge_dataset_cfg(tconfig.Config(), name, over, num_frames=9,
                                  img_size=(424, 800))
    b = jconfig.merge_dataset_cfg(jconfig.Config(), name, over, num_frames=9,
                                  img_size=(424, 800))
    assert a["dataset"] == b["dataset"]
    assert a.dataset.data.val.start_on_firstframe is True


def test_native_host_kernels_match_jax():
    """The same library on both sides (the committed one, which runs here), and
    equal results from each entry."""
    assert jnative.available() and tnative.library_path() == str(tnative.COMMITTED)
    assert os.path.samefile(jnative._SO_PATH, tnative.COMMITTED)
    rng = np.random.default_rng(0)
    polys = [rng.uniform(-20, 220, (int(rng.integers(3, 9)), 2)).astype(np.float32)
             for _ in range(40)]
    for value in (1, 7):
        a, b = np.zeros((200, 180), np.uint8), np.zeros((200, 180), np.uint8)
        tnative.fill_polygons(a, polys, value)
        jnative.fill_polygons(b, polys, value)
        assert a.sum() > 1000 and np.array_equal(a, b)
    boxes = np.concatenate([rng.uniform(-30, 30, (25, 3)), rng.uniform(0.5, 5, (25, 3)),
                            rng.uniform(-3, 3, (25, 1)), rng.standard_normal((25, 2))],
                           axis=1).astype(np.float32)
    corners = tnative.boxes_to_corners(boxes)
    assert np.array_equal(corners, jnative.boxes_to_corners(boxes))
    np.testing.assert_allclose(corners, T.boxes_to_corners(boxes), atol=1e-5)
    assert tnative.boxes_to_corners(boxes[:0]).shape == (0, 8, 3)
    trans = rng.standard_normal((4, 4))
    trans[2, 3] += 40.0
    for proj in (True, False):
        assert np.array_equal(tnative.project_corners(corners, trans, proj),
                              jnative.project_corners(corners, trans, proj))
    with pytest.raises(ValueError, match="uint8"):
        tnative.fill_polygons(np.zeros((4, 4), np.float32), polys)


def test_bev_object_layers_and_aux_match_jax(sets):
    """LoadBEVSegmentation with the ten object layers and the 7 aux channels (the
    polygon fill and the per-box rasterisation) on every frame of a scene."""
    y = tload(os.path.join(REPO, "configs/dataset/Nuscenes_400_map_cache_box_t_with_n2t_12Hz.yaml"))
    kw = dict(dataset_root="", xbound=y["map_bound"]["x"], ybound=y["map_bound"]["y"],
              classes=y["map_classes"], object_classes=y["object_classes"],
              aux_data=y["aux_data"])
    jbev, tbev = J.LoadBEVSegmentation(**kw), T.LoadBEVSegmentation(**kw)
    cfg = dict(type="NuScenesTDataset", ann_file=sets["full"], video_length="full",
               object_classes=y["object_classes"], view_order=y["view_order"])
    tds = tbuild(cfg, TDATASETS)
    filled = 0
    for frame in tds.get_data_info(1):
        frame = dict(frame, boxes=frame["boxes"] * np.float32([4, 4, 1, 3, 3, 1, 1, 1, 1]))
        a, b = tbev(dict(frame)), jbev(dict(frame))
        for k in ("gt_masks_bev_static", "gt_masks_bev", "gt_aux_bev"):
            assert_same(a[k], b[k], k)
        filled += int(a["gt_masks_bev"][8:].sum())
    assert filled > 1000
    packed = T.one_hot_encode(a["gt_masks_bev"][:18])
    assert np.array_equal(packed, J.one_hot_encode(b["gt_masks_bev"][:18]))
    assert np.array_equal(T.one_hot_decode(packed, 18), a["gt_masks_bev"][:18])


CLIP_CASES = [(y, split, length) for y in YAMLS for split in ("train", "val")
              for length in ("fixed", "full")] + [("Nuscenes", "val", "fixed-map25")]


@pytest.mark.parametrize("yaml_name,split,length", CLIP_CASES,
                         ids=["-".join(c) for c in CLIP_CASES])
def test_clips_and_model_batches_equal_jax(sets, yaml_name, split, length):
    """NuScenesTDataset items, ``collate_clips``, ``clip_to_model_batch`` (box
    latents from one seeded generator) and, for whole scenes, ``max_full_clip_len``
    and ``pad_model_batch_to_t``: the port's equal the JAX package's, key by key."""
    full = length == "full"
    cfg = split_config(yaml_name, split, sets["full" if full else "fixed"],
                       "full" if full else 3, map25=length == "fixed-map25")
    jds, tds = jbuild(cfg, JDATASETS), tbuild(cfg, TDATASETS)
    assert len(tds) == len(jds) >= 2
    assert tds.clip_infos == jds.clip_infos
    if full:
        assert T.max_full_clip_len(tds) == J.max_full_clip_len(jds) == 17
    for index in (0, len(tds) - 1):
        a, b = seeded_pair(jds, tds, index, seed=100 + index)
        assert_same(b, a, "clip")
        if length == "fixed-map25":
            assert a["bev_map_with_aux"].shape[1] == 26 and a["bev_map_with_aux"][:, 8:].any()
        for bl in (None, BOX_DIM):
            kw = {} if bl is None else dict(box_latent_dim=bl)
            ja = J.clip_to_model_batch(J.collate_clips([a]),
                                       rng=np.random.default_rng(7), **kw)
            tb = T.clip_to_model_batch(T.collate_clips([b]),
                                       rng=np.random.default_rng(7), **kw)
            if full:
                ja, tb = J.pad_model_batch_to_t(ja, 17), T.pad_model_batch_to_t(tb, 17)
                assert tb["num_frames"] == 17
            assert_same(tb, ja, "model batch")
        assert ("box_latent" in tb["bbox"]) and tb["bbox"]["bboxes"].shape[:2] == (
            6, 17 if full else 3)


def test_train_items_draw_from_seed_epoch_and_index(sets):
    """The port's train items: the same (seed, epoch, index) gives the same item
    whichever way it is asked for; another epoch or seed draws other box dropout.
    A random draw without a generator raises."""
    cfg = split_config("Nuscenes", "train", sets["fixed"], 3)
    tds = tbuild(cfg, TDATASETS)
    masks = lambda ds: [ds[i]["bboxes_3d_data"]["masks"] for i in range(len(ds))]  # noqa: E731
    first = masks(tds)
    assert_same(masks(tbuild(cfg, TDATASETS)), first)
    assert_same(tds[1], tds.prepare_train_data(1, tds.item_rngs(1)))
    tds.set_epoch(1)
    assert any(not np.array_equal(x, y) for x, y in zip(masks(tds), first))
    other = tbuild(dict(cfg, seed=5), TDATASETS)
    assert any(not np.array_equal(x, y) for x, y in zip(masks(other), first))
    frames = tds.get_data_info(0)
    with pytest.raises(ValueError, match="rng"):
        T.collate_fn_single_clip([dict(f, img=np.zeros((6, 3, 2, 2), np.float32),
                                       gt_masks_bev=np.zeros((8, 2, 2)),
                                       gt_aux_bev=None) for f in frames],
                                 frame_emb="next2top", bbox_mode="all-xyz",
                                 bbox_drop_ratio=0.0, bbox_add_ratio=0.5, keyframe_rate=2)
    with pytest.raises(ValueError, match="rng"):
        from PIL import Image
        T.ImageAug3D([28, 50], [0.3, 0.4], [0, 0], None, False, is_train=True)(
            {"img": [Image.new("RGB", (160, 90))], "ori_shape": (160, 90)})


def _multires_cfg(ann):
    y = tload(os.path.join(REPO, "configs/dataset/Nuscenes.yaml"))
    pipeline = copy.deepcopy(y["test_pipeline"])
    for t in pipeline:
        if t["type"] == "ImageAug3D":
            t.update(final_dim=[28, 50], resize_lim=[0.3125, 0.3125])
    split = dict(type="NuScenesVariableDataset", ann_file=ann, dataset_root="",
                 object_classes=y["object_classes"], view_order=y["view_order"],
                 pipeline=pipeline, test_mode=True, video_length=[1, 3, "full"],
                 fps=[[12], [12, 6], [12]],
                 img_collate_param=dict(img_collate_param("all-xyz", is_train=False),
                                        template=y["template"]))
    return [((28, 50), split)]


def test_bucket_sampler_and_loader_match_jax(sets):
    """A multi-resolution dataset (1 and 3 frames at 12 and 6 fps, whole scenes)
    through ``prepare_dataloader`` with a bucket config: the same batches as the JAX
    loader's, in the same order, for two epochs; the sampler's state taken after 2
    batches resumes the rest."""
    cfg = _multires_cfg(sets["full"])
    jds, tds = J.NuScenesMultiResDataset(cfg), T.NuScenesMultiResDataset(cfg)
    buckets = tds.as_buckets()
    assert buckets == jds.as_buckets() and len(buckets) == 4
    bucket_config = {k: 2 for k in buckets}
    kw = dict(bucket_config=bucket_config, seed=3, num_workers=2, full_bucket_t=17)
    jl, js = J.prepare_dataloader(jds, **kw)
    tl, ts = T.prepare_dataloader(tds, **kw)
    assert len(tl) == len(jl) >= 6
    for epoch in (0, 1):
        js.set_epoch(epoch)
        ts.set_epoch(epoch)
        tds.set_epoch(epoch)
        assert list(ts) == list(js)
        batches = list(tl)
        jb = list(jl)
        assert len(batches) == len(jb) == len(tl)
        for a, b in zip(batches, jb):
            assert_same(a, b)
    assert {b["num_frames"] for b in batches} == {1, 2, 3, 17}  # 3 frames at 6 fps: 2
    full = [b for b in batches if b["num_frames"] == 17][0]
    assert full["frame_valid"].shape == (2, 17)
    # resume: the state after 2 batches of epoch 1, loaded into a new sampler
    state = ts.state_dict(2)
    assert state == js.state_dict(2) and state["epoch"] == 1
    fresh = T.BucketSampler(tds.as_buckets(), bucket_config, seed=3)
    fresh.load_state_dict(state)
    assert list(fresh) == list(ts)[2:]


def test_stateful_sampler_loader_and_resume(sets):
    """The plain path of ``prepare_dataloader``: the port's batches equal the JAX
    loader's (val split: nothing random); the port's sampler state counts batches
    of ``batch_size`` and resumes the epoch after them (the JAX state counts
    them as samples); ``prepare_multirank_dataloader`` for one process is the same
    loader, and two ranks' batches concatenate to the whole."""
    cfg = split_config("Nuscenes", "val", sets["fixed"], 3)
    jds, tds = jbuild(cfg, JDATASETS), tbuild(cfg, TDATASETS)
    kw = dict(batch_size=2, seed=4, num_workers=3)
    jl, js = J.prepare_dataloader(jds, **kw)
    tl, ts = T.prepare_dataloader(tds, **kw)
    assert list(ts) == list(js) and len(tl) == len(jl)
    batches = list(tl)
    for a, b in zip(batches, jl):
        assert_same(a, b)
    assert_same(batches, list(tl))  # worker threads change nothing
    state = ts.state_dict(2)
    assert state == {"epoch": 0, "start_index": 4}
    _, again = T.prepare_dataloader(tds, **kw)
    again.load_state_dict(state)
    assert list(again) == list(ts)[4:]
    one, one_s = T.prepare_multirank_dataloader(tds, dp_total=1, dp_local=1, **kw)
    assert_same(list(one), batches)
    two, _ = T.prepare_multirank_dataloader(tds, dp_total=2, dp_local=2, **kw)
    jtwo, _ = J.prepare_multirank_dataloader(jds, dp_total=2, dp_local=2, **kw)
    for a, b in zip(two, jtwo):
        assert_same(a, b)
    assert_same(T.concat_batches(batches[:2]), J.concat_batches(batches[:2]))


def test_loader_stops_its_threads_when_left_early(sets):
    import threading
    cfg = split_config("Nuscenes", "val", sets["fixed"], 3)
    loader, _ = T.prepare_dataloader(tbuild(cfg, TDATASETS), batch_size=1, num_workers=2,
                                     prefetch=1)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()
    assert threading.active_count() == before


def test_full_bucket_collate_and_bbox_helpers_match_jax(sets):
    cfg = split_config("Nuscenes_400_map_cache_box_t_with_n2t_12Hz", "val", sets["full"],
                       "full")
    jds, tds = jbuild(cfg, JDATASETS), tbuild(cfg, TDATASETS)
    a, b = seeded_pair(jds, tds, 1, seed=3)  # the 19-frame scene
    assert a["pixel_values"].shape[0] == 19
    ja = J.make_full_bucket_collate(25)([dict(a)])
    tb = T.make_full_bucket_collate(25)([dict(b)])
    assert_same(tb, ja)
    assert tb["num_frames"] == 25 and tb["num_frames_valid"].tolist() == [17.0]
    assert_same(T.pad_clip_to_t(dict(b, pixel_values=b["pixel_values"][:17],
                                     bev_map_with_aux=b["bev_map_with_aux"][:17],
                                     camera_param=b["camera_param"][:17],
                                     frame_emb=b["frame_emb"][:17],
                                     captions=b["captions"][:17],
                                     bboxes_3d_data={k: v[:17] for k, v in
                                                     b["bboxes_3d_data"].items()}), 25),
                J.pad_clip_to_t(dict(a, pixel_values=a["pixel_values"][:17],
                                     bev_map_with_aux=a["bev_map_with_aux"][:17],
                                     camera_param=a["camera_param"][:17],
                                     frame_emb=a["frame_emb"][:17],
                                     captions=a["captions"][:17],
                                     bboxes_3d_data={k: v[:17] for k, v in
                                                     a["bboxes_3d_data"].items()}), 25))
    rng = np.random.default_rng(0)
    items = [dict(bboxes=rng.standard_normal((3, n, 8, 3)).astype(np.float32),
                  classes=rng.integers(0, 10, (3, n)), masks=rng.integers(-1, 2, (3, n)),
                  box_latent=rng.standard_normal((3, n, 4)).astype(np.float32))
             for n in (2, 5)]
    assert_same(collate_bboxes_to_maxlen(items), jcollate_max(items))
    assert_same(collate_bboxes_to_maxlen(items, 7), jcollate_max(items, 7))
    with pytest.raises(ValueError, match="box_latent"):
        collate_bboxes_to_maxlen([items[0], {k: v for k, v in items[1].items()
                                             if k != "box_latent"}])
    shape = (2, 6, 3, 8, 3)
    bb = rng.standard_normal((2, 6, 3, 8, 3)).astype(np.float32)
    cl, ms = rng.integers(0, 9, (2, 6, 3)), rng.integers(0, 2, (2, 6, 3))
    assert_same(T.pad_bboxes_to_maxlen(shape, 5, bb, cl, ms),
                J.pad_bboxes_to_maxlen(shape, 5, bb, cl, ms))


def test_infos_pickle_and_frames_match_jax(sets):
    """``frame_from_info`` and the poses of every frame of the generated set."""
    with open(sets["full"], "rb") as f:
        infos = pickle.load(f)["infos"]
    order = ["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
             "CAM_BACK", "CAM_BACK_LEFT"]
    for info in infos:
        assert_same(T.frame_from_info(info, order), J.frame_from_info(info, order))
        assert_same(T.obtain_next2top(infos[0], info), J.obtain_next2top(infos[0], info))
