"""SMPL body, HMR2 fitter and model loading of the port
(``magicdrive_v2_tpu_torch/pedestrian/smpl.py``) against the JAX package's.

The licensed SMPL pickle is not in the repository, so the tests synthesise one in
its v1.0 layout at SMPL's sizes (6890 vertices, 24 joints, 10 betas, 207 pose
basis), with chumpy objects and a sparse J_regressor as the real file has them, and
load it into both packages. The port runs with ``device="cpu"``.
"""
import pickle
import sys
import types

import numpy as np
import pytest
import scipy.sparse
import torch
from scipy.spatial.transform import Rotation as R

from magicdrive_v2_tpu.pedestrian import smpl as J
from magicdrive_v2_tpu_torch.pedestrian import smpl as T
from magicdrive_v2_tpu_torch.pedestrian.processor import (SyntheticSegmenter,
                                                          SyntheticSmplFitter, _capsule_body)

N_VERTS = 6890


def smpl_model(seed=0):
    """A model dict in the SMPL pickle's layout at SMPL's sizes: the capsule
    template of 106 rings x 65 segments jittered, seeded blendshapes, each joint
    regressed from 12 vertices, each vertex skinned to 4 joints."""
    rng = np.random.default_rng(seed)
    v_template, faces = _capsule_body(106, 65)
    assert v_template.shape == (N_VERTS, 3)
    v_template = v_template + rng.normal(0, 1e-3, v_template.shape)
    J_regressor = np.zeros((J.NUM_JOINTS, N_VERTS))
    for j in range(J.NUM_JOINTS):
        J_regressor[j, rng.choice(N_VERTS, 12, replace=False)] = 1.0 / 12
    weights = np.zeros((N_VERTS, J.NUM_JOINTS))
    for v in range(N_VERTS):
        weights[v, rng.choice(J.NUM_JOINTS, 4, replace=False)] = rng.dirichlet(np.ones(4))
    kintree = np.stack([J.SMPL_PARENTS.astype(np.int64), np.arange(J.NUM_JOINTS)])
    kintree[0, 0] = 2 ** 32 - 1  # as stored in the real pickle
    return dict(v_template=v_template, f=faces.astype(np.int64),
                shapedirs=rng.standard_normal((N_VERTS, 3, J.NUM_BETAS)) * 0.01,
                posedirs=rng.standard_normal((N_VERTS, 3, J.NUM_POSE_BASIS)) * 0.001,
                J_regressor=J_regressor, weights=weights, kintree_table=kintree)


def _chumpy_modules():
    return {k: v for k, v in sys.modules.items() if k == "chumpy" or k.startswith("chumpy.")}


@pytest.fixture(scope="module")
def smpl_pickle(tmp_path_factory):
    """The model written as the real file is: chumpy ``Ch`` objects (pickled by a
    stand-in module that is gone again when the file is read) and a scipy-sparse
    J_regressor."""
    saved = _chumpy_modules()
    ch_mod = types.ModuleType("chumpy.ch")

    class Ch:
        def __init__(self, x):
            self.x = x

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    ch_mod.Ch = Ch
    pkg = types.ModuleType("chumpy")
    pkg.ch = ch_mod
    m = smpl_model()
    raw = {k: (Ch(v) if k in ("v_template", "shapedirs", "posedirs", "weights") else v)
           for k, v in m.items()}
    raw["J_regressor"] = scipy.sparse.csc_matrix(m["J_regressor"])
    path = tmp_path_factory.mktemp("smpl") / "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl"
    try:
        sys.modules.update({"chumpy": pkg, "chumpy.ch": ch_mod})
        with open(path, "wb") as f:
            pickle.dump(raw, f, protocol=2)
    finally:
        for k in _chumpy_modules():
            del sys.modules[k]
        sys.modules.update(saved)
    return str(path), m


@pytest.fixture(scope="module")
def bodies(smpl_pickle):
    path, _ = smpl_pickle
    saved = _chumpy_modules()
    try:
        for k in saved:
            del sys.modules[k]
        tbody = T.SmplBody(path, device="cpu")  # installs the port's chumpy stand-in
        assert sys.modules["chumpy"].ch.Ch is T._ChumpyStub
        for k in _chumpy_modules():
            del sys.modules[k]
        jbody = J.SmplBody(path)
    finally:
        for k in _chumpy_modules():
            del sys.modules[k]
        sys.modules.update(saved)
    return jbody, tbody


def test_load_smpl_pickle_equals_jax(smpl_pickle, bodies):
    path, m = smpl_pickle
    jbody, tbody = bodies
    loaded = T.load_smpl_pickle(path)
    assert loaded["parents"][0] == -1 and np.array_equal(loaded["parents"][1:],
                                                         J.SMPL_PARENTS[1:])
    np.testing.assert_array_equal(loaded["J_regressor"], m["J_regressor"])
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights", "faces",
                 "parents"):
        np.testing.assert_array_equal(getattr(tbody, name).numpy(), getattr(jbody, name))
    assert tbody.posedirs.dtype == torch.float64 and tbody.posedirs.shape == (N_VERTS, 3, 207)
    assert {n for n, _ in tbody.named_buffers()} >= {"v_template", "posedirs", "weights"}


def _inputs(kind, rng):
    if kind == "none":
        return None, None, None
    orient = R.random(random_state=int(rng.integers(1 << 30))).as_matrix()
    pose = R.random(23, random_state=int(rng.integers(1 << 30))).as_matrix()
    betas = rng.normal(0, 1, 10)
    if kind == "rotmat":
        return orient[None], pose, betas
    if kind == "axis_angle":  # (3,) and (69,), betas shorter than the model's
        return (R.from_matrix(orient).as_rotvec(), R.from_matrix(pose).as_rotvec().ravel(),
                betas[:5])
    return R.from_matrix(orient).as_rotvec(), R.from_matrix(pose).as_rotvec(), betas  # (23, 3)


@pytest.mark.parametrize("kind", ["none", "rotmat", "axis_angle", "axis_angle_23x3"])
def test_smpl_vertices_match_jax(bodies, kind):
    jbody, tbody = bodies
    args = _inputs(kind, np.random.default_rng(len(kind)))
    want = jbody.vertices(*args)
    got = tbody.vertices(*args)
    assert got.dtype == torch.float32 and got.shape == (N_VERTS, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if kind != "none":
        assert np.abs(want - jbody.v_template).max() > 0.1  # the pose moved the body


def test_rodrigues_matches_jax():
    rng = np.random.default_rng(0)
    aa = np.concatenate([np.zeros((1, 3)), [[np.pi, 0, 0]], [[0, 0.99 * np.pi, 0]],
                         rng.normal(0, 1.5, (64, 3))])
    got = T.rodrigues(aa, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), J.rodrigues(aa), rtol=0, atol=1e-12)


class _FakeHmr2(torch.nn.Module):
    """Outputs that depend on the normalised crop, so the preprocessing is held."""

    def forward(self, batch):
        img = batch["img"]
        b = img.shape[0]
        assert img.shape == (b, 3, 256, 256) and img.dtype == torch.float32
        mean = img.mean(dim=(2, 3))  # (b, 3)
        return {
            "pred_vertices": mean[:, None, :] * torch.ones(b, 30, 1),
            "pred_cam_t": torch.stack([mean[:, 0], mean[:, 1], 5 + mean[:, 2]], 1),
            "pred_smpl_params": {
                "body_pose": torch.eye(3).repeat(b, 23, 1, 1) * (1 + mean[:, :1, None, None]),
                "global_orient": torch.eye(3).repeat(b, 1, 1, 1),
                "betas": mean.repeat(1, 4)[:, :10],
            },
        }


def test_hmr2_fitter_matches_jax():
    crop = np.random.default_rng(1).integers(0, 256, (256, 256, 3), np.uint8)
    want = J.Hmr2SmplFitter(_FakeHmr2()).fit(crop, 120.0)
    got = T.Hmr2SmplFitter(_FakeHmr2(), device="cpu").fit(crop, 120.0)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="256x256"):
        T.Hmr2SmplFitter(_FakeHmr2(), device="cpu").fit(crop[:128], 1.0)
    with pytest.raises(ImportError, match="hmr2"):
        T.Hmr2SmplFitter.from_checkpoint("missing.ckpt", device="cpu")


def test_make_real_processor_matches_jax(smpl_pickle):
    path, _ = smpl_pickle
    proc = T.make_real_processor(path, device="cpu")
    jproc = J.make_real_processor(path)
    assert isinstance(proc.fitter, SyntheticSmplFitter)
    assert isinstance(proc.segmenter, SyntheticSegmenter)
    assert proc.body.v_template.shape == (N_VERTS, 3) and proc.device.type == "cpu"
    np.testing.assert_array_equal(proc.symmetry_idx.numpy(), jproc.symmetry_idx)
    fit_t = proc.fitter.fit(None, 100.0)
    fit_j = jproc.fitter.fit(None, 100.0)
    for k in fit_j:
        np.testing.assert_array_equal(fit_t[k].numpy(), fit_j[k])


def test_device_defaults_to_cuda_and_raises_without_a_card(smpl_pickle):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    path, m = smpl_pickle
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.SmplBody(T._normalize_model(dict(m)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.make_real_processor(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Hmr2SmplFitter(_FakeHmr2())
