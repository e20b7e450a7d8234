"""The port's pedestrian pipeline against the JAX package's: PoseProcessor, the
rasterizer binding, the processor's methods one by one, ``run_scene`` and the app on
the synthetic scene, ``tools/extract_masks.py`` and the SegFormer backends.

The same numpy inputs, made from a seed, go through both packages; the port runs with
``device="cpu"``. Tolerances: ids and masks equal; pose within 1e-9, betas / cam /
tform within 1e-12; other floats within 1e-6; the scene's textures within 1e-5 and
its PNGs differing on at most 0.1 % of pixels. The reference's nearest-vertex search
(``cKDTree``) fixes no order among equidistant vertices, the port takes the lower
index: where the k-th nearest vertex ties, the tests check the tie instead.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation as R

from magicdrive_v2_tpu import native as jnative
from magicdrive_v2_tpu.pedestrian import PoseProcessor as JPose
from magicdrive_v2_tpu.pedestrian import processor as JP
from magicdrive_v2_tpu_torch import native as tnative
from magicdrive_v2_tpu_torch.pedestrian import PoseProcessor as TPose
from magicdrive_v2_tpu_torch.pedestrian import processor as TP
from magicdrive_v2_tpu_torch.scripts import pipeline_12hz as TAPP
from magicdrive_v2_tpu_torch.tools import extract_masks as TEM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAPP = _load_file("jax_pipeline_12hz", "scripts/pipeline_12hz.py")
JEM = _load_file("jax_extract_masks", "tools/extract_masks.py")


@pytest.fixture(scope="module")
def procs():
    return JP.make_synthetic_processor(), TP.make_synthetic_processor(device="cpu")


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# PoseProcessor
# ---------------------------------------------------------------------------


def test_rotation_6d_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    mats = R.random(32, random_state=0).as_matrix().reshape(4, 8, 3, 3)
    d6 = TPose.matrix_to_rotation_6d(torch.as_tensor(mats))
    np.testing.assert_array_equal(d6.numpy(), JPose.matrix_to_rotation_6d(mats))
    noisy = d6.numpy() + rng.normal(0, 0.05, d6.shape)
    got = TPose.rotation_6d_to_matrix(torch.as_tensor(noisy)).numpy()
    np.testing.assert_allclose(got, JPose.rotation_6d_to_matrix(noisy), rtol=0, atol=1e-12)
    np.testing.assert_allclose(TPose.rotation_6d_to_matrix(d6).numpy(),
                               JPose.rotation_6d_to_matrix(JPose.matrix_to_rotation_6d(mats)),
                               rtol=0, atol=1e-12)


def test_correct_outliers_with_trend_matches_jax():
    rng = np.random.default_rng(1)
    n = 21
    pose = R.random(n * 24, random_state=1).as_matrix().reshape(n, 24, 3, 3)
    cam = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    cam[[4, 10, 11]] += [[3.0, 0, 0], [0, -2.0, 1.0], [0, 0, 4.0]]  # teleports
    pose[[3, 15], 0] = R.random(2, random_state=7).as_matrix()    # root glitches
    for window in (5, 6, 9):
        want_pose, want_cam = JPose().correct_outliers_with_trend(pose, cam, window_size=window)
        got_pose, got_cam = TPose(device="cpu").correct_outliers_with_trend(
            pose, cam, window_size=window)
        np.testing.assert_allclose(got_cam.numpy(), want_cam, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got_pose.numpy(), want_pose, rtol=0, atol=1e-12)
        moved = np.abs(want_cam - cam).max(1) > 0
        assert moved[[4, 10, 11]].all() and (np.abs(want_pose - pose).max((1, 2, 3)) > 0).any()


def _sparse_sequence(seed, n=6, total=20, duplicates=True, axis_angle=True,
                     max_angle=0.99 * np.pi, float32=False):
    """Random sparse fits: the joints turn by up to ``max_angle`` between keys."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(np.arange(1, total - 1), n, replace=False))
    if duplicates:
        idx = np.concatenate([idx, idx[1:3]])
    rng.shuffle(idx)
    base = R.random(24, random_state=seed).as_matrix()
    mats = []
    for i in range(len(idx)):
        axis = rng.normal(size=(24, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        angle = rng.uniform(0.5, 1.0, (24, 1)) * max_angle * (idx[i] % 2)
        mats.append(base @ R.from_rotvec(axis * angle).as_matrix())
    mats = np.stack(mats)
    if float32:
        mats = mats.astype(np.float32)
    m = len(idx)
    pose = R.from_matrix(mats.reshape(-1, 3, 3)).as_rotvec().reshape(m, 72) if axis_angle \
        else mats
    cam = np.cumsum(rng.normal(0, 0.2, (m, 3)), axis=0)
    return dict(frame_indices=idx, pose=pose, betas=rng.normal(size=(m, 10)), cam=cam,
                tform=rng.normal(size=(m, 2, 3))), total


SEQUENCES = {
    "axis_angle_duplicates": dict(),
    "rotmat_duplicates": dict(axis_angle=False),
    "rotmat_float32": dict(axis_angle=False, float32=True, duplicates=False),
    "small_angles": dict(max_angle=0.3, duplicates=False),
    "even_total_4": dict(n=2, total=4, duplicates=False),
    "even_total_12": dict(n=5, total=12),
}


@pytest.mark.parametrize("cam2world", [False, True])
@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_process_sequence_matches_jax(case, cam2world):
    sparse, total = _sparse_sequence(len(case), **SEQUENCES[case])
    c2w = None
    if cam2world:
        c2w = np.tile(np.eye(4), (total, 1, 1))
        c2w[:, :3, :3] = R.random(total, random_state=3).as_matrix()
        c2w[:, :3, 3] = np.random.default_rng(3).normal(size=(total, 3))
    for windows in ({}, dict(rot_window=1, body_window=1), dict(rot_window=8, body_window=4)):
        want = JPose().process_sequence(sparse, total, full_cam2world=c2w, **windows)
        got = TPose(device="cpu").process_sequence(sparse, total, full_cam2world=c2w,
                                                   **windows)
        assert got["valid_range"] == want["valid_range"]
        assert got["pose"].dtype == torch.float64 and got["pose"].shape == (total, 24, 3, 3)
        np.testing.assert_allclose(got["pose"].numpy(), want["pose"], rtol=0, atol=1e-9)
        for k in ("betas", "cam", "tform"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-12, err_msg=k)


def test_slerp_up_to_0_99_pi_matches_scipy():
    """Two keys a relative turn of 0.9-0.99 pi apart, no smoothing: the midpoints are
    scipy's SLERP, and the turn really is that large."""
    rng = np.random.default_rng(5)
    a = R.random(24, random_state=5).as_matrix()
    axis = rng.normal(size=(24, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    rel = R.from_rotvec(axis * np.linspace(0.9, 0.99, 24)[:, None] * np.pi).as_matrix()
    sparse = dict(frame_indices=np.array([0, 8]), pose=np.stack([a, a @ rel]),
                  betas=np.zeros((2, 10)), cam=np.zeros((2, 3)), tform=np.zeros((2, 2, 3)))
    want = JPose().process_sequence(sparse, 9, rot_window=1, body_window=1)
    got = TPose(device="cpu").process_sequence(sparse, 9, rot_window=1, body_window=1)
    np.testing.assert_allclose(got["pose"].numpy(), want["pose"], rtol=0, atol=1e-9)
    half = R.from_matrix(np.swapaxes(a, 1, 2) @ got["pose"].numpy()[4]).magnitude()
    np.testing.assert_allclose(half, np.linspace(0.9, 0.99, 24) * np.pi / 2, atol=1e-9)


def test_process_sequence_below_two_detections_is_none():
    sparse = dict(frame_indices=np.array([5]), pose=np.zeros((1, 72)), betas=np.ones((1, 10)),
                  cam=np.ones((1, 3)), tform=np.tile(np.eye(2, 3), (1, 1, 1)))
    assert TPose(device="cpu").process_sequence(sparse, 10) is None
    with pytest.raises(ValueError, match="pose shape"):
        TPose(device="cpu").process_sequence(dict(sparse, frame_indices=np.array([1, 2]),
                                                  pose=np.zeros((2, 5))), 10)


# ---------------------------------------------------------------------------
# the native rasterizer
# ---------------------------------------------------------------------------


def _jax_numpy_rasterizer(*args, **kw):
    """The JAX package's numpy loop (its native library switched off)."""
    old = os.environ.get("MDV2_DISABLE_NATIVE")
    jnative._LIB, jnative._TRIED = None, False
    os.environ["MDV2_DISABLE_NATIVE"] = "1"
    try:
        return jnative.rasterize_mesh(*args, **kw)
    finally:
        if old is None:
            os.environ.pop("MDV2_DISABLE_NATIVE")
        else:
            os.environ["MDV2_DISABLE_NATIVE"] = old
        jnative._LIB, jnative._TRIED = None, False


@pytest.mark.parametrize("with_colors", [True, False])
def test_rasterize_mesh_matches_jax_native_and_numpy(with_colors):
    rng = np.random.default_rng(3)
    verts = np.concatenate([rng.uniform(-8, 72, (40, 2)), rng.uniform(-0.5, 5, (40, 1))],
                           axis=1).astype(np.float32)
    faces = rng.integers(0, 40, (60, 3)).astype(np.int32)
    colors = rng.uniform(0, 1, (40, 3)).astype(np.float32) if with_colors else None
    got = tnative.rasterize_mesh(verts, faces, colors, 64, 48, z_near=0.05)
    for want in (jnative.rasterize_mesh(verts, faces, colors, 64, 48, z_near=0.05),
                 _jax_numpy_rasterizer(verts, faces, colors, 64, 48, z_near=0.05)):
        np.testing.assert_array_equal(got[2], want[2])
        covered = got[2] >= 0
        assert covered.sum() > 100 and (~covered).sum() > 100
        np.testing.assert_allclose(got[1][covered], want[1][covered], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        assert np.isinf(got[1][~covered]).all() and not got[0][~covered].any()


def test_rasterize_mesh_rejects_bad_input():
    verts = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="face indices"):
        tnative.rasterize_mesh(verts, np.array([[0, 1, 3]]), None, 8, 8)
    with pytest.raises(ValueError, match="colors"):
        tnative.rasterize_mesh(verts, np.array([[0, 1, 2]]), np.zeros((2, 3)), 8, 8)
    rgb, depth, fid = tnative.rasterize_mesh(verts, np.zeros((0, 3), np.int32), None, 4, 5)
    assert rgb.shape == (4, 5, 3) and np.isinf(depth).all() and (fid == -1).all()


# ---------------------------------------------------------------------------
# the processor's methods
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [None, 3])
def test_warp_affine_nearest_matches_jax(channels):
    rng = np.random.default_rng(2)
    shape = (37, 53) + ((channels,) if channels else ())
    img = rng.integers(0, 255, shape, np.uint8)
    # scale 2 and half-pixel shifts: every other source coordinate lands on .5
    for t in (np.array([[2.0, 0, 1.0], [0, 2.0, -3.0]]),
              np.array([[0.5, 0, 0.25], [0, 0.5, 0.75]]),
              TP.crop_affine(np.array([20.5, 17.0]), 0.21),
              np.array([[1.3, 0.2, -4.1], [-0.3, 0.9, 2.2]])):
        want = JP.warp_affine_nearest(img, t, (61, 45), 7)
        got = TP.warp_affine_nearest(img, t, (61, 45), 7, device="cpu")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    depth = rng.uniform(1, 5, (33, 31)).astype(np.float32)
    t = np.array([[2.0, 0, 0.5], [0, 2.0, 0.5]])
    np.testing.assert_array_equal(
        TP.warp_affine_nearest(depth, t, (40, 40), np.inf, device="cpu").numpy(),
        JP.warp_affine_nearest(depth, t, (40, 40), np.inf))


def test_symmetry_indices_match_jax(procs):
    jp, tp = procs
    np.testing.assert_array_equal(tp.symmetry_idx.numpy(), jp.symmetry_idx)
    rng = np.random.default_rng(4)
    tv = rng.normal(size=(500, 3)).astype(np.float32)
    body = TP.SyntheticBody(device="cpu")
    body.v_template = torch.as_tensor(tv)
    jbody = JP.SyntheticBody()
    jbody.v_template = tv
    np.testing.assert_array_equal(
        TP.PedestrianProcessor(None, None, body, device="cpu").symmetry_idx.numpy(),
        JP.PedestrianProcessor(None, None, jbody).symmetry_idx)


def _kth_neighbour_ties(tv, valid, k=3):
    """Missing vertices whose k-th and (k+1)-th nearest valid vertex are equidistant."""
    d = ((tv[~valid][:, None] - tv[valid][None]) ** 2).sum(-1)
    d = np.sort(d, axis=1)
    return d[:, k - 1] == d[:, k] if d.shape[1] > k else np.zeros(len(d), bool)


def test_inpaint_missing_colors_symmetry_and_knn_match_jax():
    # the capsule jittered by 1e-3, so that no KNN fill meets a tie
    tv = JP.SyntheticBody().v_template
    tv = (tv + np.random.default_rng(5).normal(0, 1e-3, tv.shape)).astype(np.float32)
    jbody, tbody = JP.SyntheticBody(), TP.SyntheticBody(device="cpu")
    jbody.v_template, tbody.v_template = tv, torch.as_tensor(tv)
    jp = JP.PedestrianProcessor(None, None, jbody)
    tp = TP.PedestrianProcessor(None, None, tbody, device="cpu")
    n = len(tv)
    rng = np.random.default_rng(6)
    sums = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    counts = rng.uniform(0.5, 2, (n, 1)).astype(np.float32)
    sums *= counts
    # the +x half goes (symmetry fill) and a band across both halves (KNN fill)
    gone = (tv[:, 0] > 0.01) | ((tv[:, 2] > 0.1) & (tv[:, 2] < 0.45))
    sums[gone], counts[gone] = 0, 0
    mirrored = gone & ~gone[jp.symmetry_idx]
    knn = gone & ~mirrored
    assert mirrored.sum() > 50 and knn.sum() > 20  # both branches are reached
    assert not _kth_neighbour_ties(tv.astype(np.float64), ~knn).any()
    want = jp.inpaint_missing_colors(sums, counts)
    got = tp.inpaint_missing_colors(sums, counts)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tp.inpaint_missing_colors(np.zeros((n, 3)), np.zeros((n, 1))).numpy(),
        jp.inpaint_missing_colors(np.zeros((n, 3), np.float32), np.zeros((n, 1), np.float32)))


def test_median_filter_colors_matches_jax_with_even_counts(procs):
    jp, tp = procs
    n = len(jp.body.v_template)
    rng = np.random.default_rng(7)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    sizes = set()
    for seed in range(3):
        valid = np.random.default_rng(seed).uniform(size=n) > 0.35
        want = jp._median_filter_colors(colors, valid)
        got = tp._median_filter_colors(colors, valid).numpy()
        np.testing.assert_array_equal(got, want)
        nb = tp.neighbours.numpy()
        sizes |= set(((nb >= 0) & valid[np.maximum(nb, 0)]).sum(1)[valid] + 1)
    assert {4, 6} <= sizes  # even windows: the mean of the two middle values
    few = np.zeros(n, bool)
    few[:9] = True
    np.testing.assert_array_equal(tp._median_filter_colors(colors, few).numpy(), colors)


def _upright(tv):
    rx = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    return (tv @ rx.T).astype(np.float32)


def _fits(tv):
    near = dict(vertices=tv[None], cam_t=np.array([[0.1, 0, 30.0]], np.float32),
                crop_info={"tform": TP.crop_affine(np.array([140.0, 120.0]), 0.9)},
                bbox_height=150.0)
    far = dict(vertices=tv[None], cam_t=np.array([[-0.2, 0.1, 45.0]], np.float32),
               crop_info={"tform": TP.crop_affine(np.array([150.0, 110.0]), 0.8)},
               bbox_height=40.0)
    return near, far


def test_instance_id_map_and_sampling_match_jax(procs):
    jp, tp = procs
    tv = _upright(jp.body.v_template)
    near, far = _fits(tv)
    H, W = 240, 300
    want_id, want_depth = jp.render_instance_id_map([far, near], [1, 2], (H, W))
    got_id, got_depth = tp.render_instance_id_map([far, near], [1, 2], (H, W))
    assert (want_id == 1).sum() > 100 and (want_id == 2).sum() > 100
    np.testing.assert_array_equal(got_id.numpy(), want_id)
    np.testing.assert_array_equal(got_depth.numpy(), want_depth)
    image = np.random.default_rng(8).integers(0, 255, (H, W, 3), np.uint8)
    seg = np.random.default_rng(9).uniform(size=(H, W)) > 0.2
    for smpl, pid in ((far, 1), (near, 2)):
        want_c, want_w = jp.project_and_sample_vertices(smpl, image, seg, want_id,
                                                        want_depth, pid)
        got_c, got_w = tp.project_and_sample_vertices(smpl, torch.as_tensor(image),
                                                      torch.as_tensor(seg), got_id,
                                                      got_depth, pid)
        assert (want_w > 0).sum() > 20
        np.testing.assert_array_equal(got_w.numpy(), want_w)
        np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-6, atol=1e-6)
        assert jp.is_mesh_valid(smpl) == tp.is_mesh_valid(smpl)


@pytest.mark.parametrize("branch", ["intrinsics", "crop_camera"])
def test_render_colored_mesh_matches_jax(procs, branch):
    jp, tp = procs
    tv = _upright(jp.body.v_template)
    colors = np.random.default_rng(10).uniform(0, 1, (len(tv), 3)).astype(np.float32)
    K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1]])
    if branch == "intrinsics":
        smpl = dict(vertices=tv[None], cam_t=np.zeros((1, 3)), pos_cam=np.array([0.2, 0.1, 4.0]),
                    crop_info={"tform": np.array([[1.0, 0, 0], [0, 1.0, 0]])})
    else:
        smpl, _ = _fits(tv)
    for shape in ((240, 320), (150, 170)):  # the second clips the region of interest
        want = jp.render_colored_mesh(smpl, colors, shape, intrinsics=K)
        got = tp.render_colored_mesh(smpl, colors, shape, intrinsics=K)
        assert want[1].sum() > 50
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_conversions_match_jax(procs):
    jp, tp = procs
    rng = np.random.default_rng(11)
    K = np.array([[1266.0, 0, 800.0], [0, 1265.0, 450.0], [0, 0, 1]])
    for seed in range(4):
        c2w = np.eye(4)
        c2w[:3, :3] = R.random(random_state=seed).as_matrix()
        c2w[:3, 3] = rng.normal(size=3)
        info = {"tform": TP.crop_affine(rng.uniform(100, 800, 2), rng.uniform(0.3, 2))}
        cam_t = np.array([rng.normal(), rng.normal(), rng.uniform(20, 60)])
        np.testing.assert_allclose(tp.convert_crop_cam_to_world(cam_t, info, K, c2w),
                                   jp.convert_crop_cam_to_world(cam_t, info, K, c2w),
                                   rtol=0, atol=1e-6)
        pos = rng.normal(size=3) * 5
        np.testing.assert_allclose(tp.convert_world_to_crop_cam(pos, info, K, c2w),
                                   jp.convert_world_to_crop_cam(pos, info, K, c2w),
                                   rtol=0, atol=1e-6)
    box = np.array([1.0, 0.5, 8.0, 0.7, 0.7, 1.7, 0.3])
    l2i = np.concatenate([K, np.zeros((3, 1))], axis=1)
    np.testing.assert_array_equal(TAPP.project_box_to_bbox2d(box, l2i),
                                  JAPP.project_box_to_bbox2d(box, l2i))


def test_frames_from_infos_matches_jax(tmp_path):
    rng = np.random.default_rng(12)

    def quat():
        q = rng.normal(size=4)
        return list(q * rng.uniform(0.5, 2))  # not normalised: both normalise

    cams = {name: dict(sensor2ego_rotation=quat(), sensor2ego_translation=list(rng.normal(size=3)),
                       cam_intrinsic=np.array([[1266.0, 0, 800], [0, 1266, 450], [0, 0, 1]]),
                       data_path=f"./data/nuscenes/samples/{name}/x{i}.jpg")
            for i, name in enumerate(TAPP.CAMS + ["LIDAR_TOP"])}
    infos = [dict(lidar2ego_rotation=quat(), lidar2ego_translation=list(rng.normal(size=3)),
                  ego2global_rotation=quat(), ego2global_translation=list(rng.normal(size=3)),
                  cams=cams, timestamp=1e6 * k,
                  gt_boxes=rng.normal(size=(3, 9)), gt_names=["pedestrian", "car", "pedestrian"],
                  gt_box_ids=["a", "b", "c"]) for k in range(2)]
    want = JAPP.frames_from_infos(infos, str(tmp_path))
    got = TAPP.frames_from_infos(infos, str(tmp_path))
    for w, g in zip(want, got):
        assert sorted(g["cams"]) == sorted(w["cams"]) == sorted(TAPP.CAMS)
        for name in w["cams"]:
            assert g["cams"][name]["image_path"] == w["cams"][name]["image_path"]
            for k in ("lidar2img", "c2w", "K"):
                np.testing.assert_allclose(g["cams"][name][k], w["cams"][name][k], rtol=0,
                                           atol=1e-12)
        assert [p[1] for p in g["peds"]] == [p[1] for p in w["peds"]] == ["a", "c"]
        for (gb, _, gc), (wb, _, wc) in zip(g["peds"], w["peds"]):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-12)
    assert TAPP.group_scenes(infos) == JAPP.group_scenes(infos)


# ---------------------------------------------------------------------------
# the two passes and the app
# ---------------------------------------------------------------------------


def _pngs(d):
    return {f: np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))}


def _hold_scene_outputs(got_dir, want_dir, got_tex, want_tex, tie_free):
    assert sorted(got_tex) == sorted(want_tex)
    for tok in want_tex:
        np.testing.assert_allclose(got_tex[tok][tie_free], want_tex[tok][tie_free], rtol=0,
                                   atol=1e-5)
    got, want = _pngs(got_dir), _pngs(want_dir)
    assert sorted(got) == sorted(want)
    for f in want:
        differ = got[f] != want[f]
        differ = differ.any(-1) if differ.ndim == 3 else differ
        assert differ.mean() <= 1e-3, (f, differ.mean())


def test_run_scene_matches_jax(procs, tmp_path, monkeypatch):
    jp, tp = procs
    frames, gt_tex = JAPP.build_synthetic_scene(jp)
    t_frames, t_gt = TAPP.build_synthetic_scene(tp)
    np.testing.assert_array_equal(t_gt, gt_tex)
    for f, g in zip(frames, t_frames):
        for name in f["cams"]:
            np.testing.assert_array_equal(g["cams"][name]["image"], f["cams"][name]["image"])
    n_want, want_tex = JAPP.run_scene(jp, frames, str(tmp_path / "jax"))
    n_got, got_tex = TAPP.run_scene(tp, frames, str(tmp_path / "port"))
    assert n_got == n_want >= 4
    assert np.abs(got_tex["ped0"] - gt_tex).mean() < 0.25
    # vertices whose KNN fill meets a tie at the 3rd neighbour, and the mesh
    # neighbours their colour reaches through the median, may differ; the rest may not
    harvested = TAPP.harvest_textures(tp, frames)[0]["ped0"]["count"].numpy()[:, 0] > 0
    tv = jp.body.v_template.astype(np.float64)
    filled = ~(harvested | harvested[jp.symmetry_idx])
    tied = np.zeros(len(tv), bool)
    tied[np.flatnonzero(filled)[_kth_neighbour_ties(tv, ~filled)]] = True
    reach = tied.copy()
    for _ in range(2):
        nb = tp.neighbours.numpy()
        reach = reach | ((nb >= 0) & reach[np.maximum(nb, 0)]).any(1)
    assert tied.any() and reach.mean() < 0.5
    _hold_scene_outputs(tmp_path / "port", tmp_path / "jax", got_tex, want_tex, ~reach)

    # with the reference's nearest-vertex search given the port's tie rule, every
    # vertex agrees
    class LowestIndexTree:
        def __init__(self, points):
            self.points = np.asarray(points, np.float64)

        def query(self, x, k=1):
            d = ((np.asarray(x)[:, None] - self.points[None]) ** 2).sum(-1)
            idx = np.argsort(d, axis=1, kind="stable")[:, :k]
            return None, (idx[:, 0] if k == 1 else idx)

    import scipy.spatial
    monkeypatch.setattr(scipy.spatial, "cKDTree", LowestIndexTree)
    _, want_tex = JAPP.run_scene(jp, frames, str(tmp_path / "jax_ties"))
    _hold_scene_outputs(tmp_path / "port", tmp_path / "jax_ties", got_tex, want_tex,
                        np.ones(len(tv), bool))


def test_pipeline_app_synthetic_backends_on_the_cpu(tmp_path):
    """The app launched as a module with ``--synthetic-backends --device cpu`` writes
    the pairs the JAX app writes."""
    import subprocess
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "magicdrive_v2_tpu_torch.scripts.pipeline_12hz",
                           "--synthetic-backends", "--device", "cpu", "--save-root",
                           str(tmp_path / "port")], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = JAPP.main(["--synthetic-backends", "--save-root", str(tmp_path / "jax")])
    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    masks = [f for f in got if f.endswith("_mask.png")]
    assert n >= 4 and len(masks) == len(got) - len(masks) == n and sorted(got) == sorted(want)
    for f in want:
        differ = got[f] != want[f]
        assert (differ.any(-1) if differ.ndim == 3 else differ).mean() <= 1e-3, f
    m, rgb = got[masks[0]], got[masks[0].replace("_mask", "")]
    assert (m > 0).sum() > 50 and (rgb.sum(-1)[m > 0] > 0).mean() > 0.8


def test_read_image_decodes_bgr_or_gives_none(tmp_path):
    rgb = np.random.default_rng(13).integers(0, 255, (9, 7, 3), np.uint8)
    Image.fromarray(rgb).save(tmp_path / "a.png")
    np.testing.assert_array_equal(TAPP._read_image({"image_path": str(tmp_path / "a.png")}),
                                  rgb[:, :, ::-1])
    assert TAPP._read_image({"image_path": str(tmp_path / "missing.jpg")}) is None


def test_device_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for make in (TPose, TP.make_synthetic_processor, TP.SyntheticBody, TEM.StubBackend,
                 lambda: TAPP.main(["--synthetic-backends", "--save-root", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ---------------------------------------------------------------------------
# extract_masks and the SegFormer backends
# ---------------------------------------------------------------------------


def test_extract_masks_stub_backend_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for sub in ("samples", "sweeps"):
        for cam in ("CAM_FRONT", "CAM_BACK_LEFT"):
            d = tmp_path / "data" / sub / cam
            d.mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rng.integers(0, 255, (32, 48, 3), np.uint8)).save(
                    d / f"img{i}.jpg")
    (tmp_path / "data" / "samples" / "CAM_FRONT" / "notes.txt").write_text("skipped")
    n_want = JEM.extract(str(tmp_path / "data"), str(tmp_path / "jax"), JEM.StubBackend())
    n_got = TEM.extract(str(tmp_path / "data"), str(tmp_path / "port"),
                        TEM.StubBackend(device="cpu"))
    assert n_got == n_want == 8
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.png"))
    tot = 0
    for f in files:
        want = np.asarray(Image.open(tmp_path / "jax" / f))
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / f)), want)
        tot += want.sum()
    assert tot > 0
    assert TEM.main(["--data-root", str(tmp_path / "data"), "--save-root",
                     str(tmp_path / "cli"), "--backend", "stub", "--device", "cpu",
                     "--limit", "3"]) == 3


# the preprocessor config as SegformerImageProcessor writes it, and in the older layout
# of the published cityscapes snapshots (an int size, feature-extractor keys)
SEGFORMER_PREPROCESSORS = {
    "image_processor": None,
    "feature_extractor": dict(do_normalize=True, do_resize=True, resample=2, size=96,
                              feature_extractor_type="SegformerFeatureExtractor",
                              image_mean=[0.485, 0.456, 0.406],
                              image_std=[0.229, 0.224, 0.225], reduce_labels=False),
}


@pytest.fixture(scope="module", params=sorted(SEGFORMER_PREPROCESSORS))
def segformer_snapshot(request, tmp_path_factory):
    """A tiny cityscapes-shaped SegFormer (19 classes) written locally, no download."""
    import json

    from transformers import (SegformerConfig, SegformerForSemanticSegmentation,
                              SegformerImageProcessor)
    torch.manual_seed(0)
    cfg = SegformerConfig(num_labels=19, num_encoder_blocks=2, depths=[1, 1],
                          sr_ratios=[2, 1], hidden_sizes=[8, 16], num_attention_heads=[1, 2],
                          patch_sizes=[7, 3], strides=[4, 2], mlp_ratios=[2, 2],
                          decoder_hidden_size=16)
    d = tmp_path_factory.mktemp("segformer")
    SegformerForSemanticSegmentation(cfg).eval().save_pretrained(d)
    preprocessor = SEGFORMER_PREPROCESSORS[request.param]
    if preprocessor is None:
        SegformerImageProcessor(size={"height": 64, "width": 72}).save_pretrained(d)
    else:
        (d / "preprocessor_config.json").write_text(json.dumps(preprocessor))
    return str(d)


def test_segformer_backends_match_jax(segformer_snapshot):
    from transformers import SegformerImageProcessor

    from magicdrive_v2_tpu_torch.models.segformer import SegformerClassMap
    image = np.random.default_rng(1).integers(0, 255, (48, 80, 3), np.uint8)
    want = SegformerImageProcessor.from_pretrained(segformer_snapshot)(
        images=image, return_tensors="pt")["pixel_values"]
    got = SegformerClassMap(segformer_snapshot, device="cpu").pixel_values(image)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    want = JP.SegformerSegmenter(segformer_snapshot)(image)
    got = TP.SegformerSegmenter(segformer_snapshot, device="cpu")(image)
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got.numpy(), want)
    want = JEM.TransformersBackend(segformer_snapshot)(image)
    got = TEM.TransformersBackend(segformer_snapshot, device="cpu")(image)
    assert got.dtype == torch.uint8 and len(np.unique(want)) > 3
    np.testing.assert_array_equal(got.numpy(), want)
