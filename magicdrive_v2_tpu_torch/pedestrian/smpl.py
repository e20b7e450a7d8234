"""SMPL body model and HMR2 fitter of the pedestrian pipeline, in PyTorch.

The reference drives its texture-harvest / re-render passes with ``hmr2_model.smpl``
(a SMPL body layer) and the HMR2 regressor (reference pedestrian_processor.py:49-66,
135-201). Here:

- ``SmplBody`` loads the licensed SMPL pickle
  (``basicModel_neutral_lbs_10_207_0_v1.0.0.pkl``) into an ``nn.Module`` whose arrays
  are buffers on ``device``, and runs the SMPL forward there in float64: shape
  blendshapes, pose blendshapes, the kinematic chain (one batched product per level
  of the tree), linear blend skinning. It takes rotation matrices (HMR2's
  ``pose2rot=False`` convention) or axis-angle, and returns float32 vertices.
- ``Hmr2SmplFitter`` puts a HMR2 regressor (an injected torch module, or one loaded
  through the ``hmr2`` package when it is installed) behind the pipeline's
  ``fit(crop, bbox_px_height)``: a 256x256 crop, ImageNet normalisation, its outputs
  left on the device.

SMPL pickles hold chumpy arrays; ``load_smpl_pickle`` unpickles them without chumpy
through a minimal stand-in and turns a sparse ``J_regressor`` (rebuilt by pickle
through scipy, which the pickle names) into a dense array. Unpickling runs code the
file names: load only a trusted SMPL file.
"""
from __future__ import annotations

import pickle
import sys
import types
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.misc import resolve_device, to_tensor
from .processor import CROP, BodyModel

# standard SMPL kinematic tree (24 joints); used to validate loaded models and by
# tests to synthesise pickles in the same format
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21], np.int32)
NUM_JOINTS = 24
NUM_BETAS = 10
NUM_POSE_BASIS = 207  # 23 joints x 9 rotation residuals

_F64 = torch.float64


class _ChumpyStub:
    """Minimal stand-in for chumpy.Ch so SMPL pickles unpickle without the chumpy
    package. Chumpy arrays pickle their dense data under ``x``."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __array__(self, dtype=None, copy=None):
        x = np.asarray(self.__dict__.get("x"))
        return x.astype(dtype) if dtype is not None else x


def _install_chumpy_stub():
    if "chumpy" in sys.modules:
        return
    mod = types.ModuleType("chumpy")
    mod.Ch = _ChumpyStub
    ch_mod = types.ModuleType("chumpy.ch")
    ch_mod.Ch = _ChumpyStub
    reord = types.ModuleType("chumpy.reordering")
    for name in ("transpose", "Transpose", "Select"):
        setattr(reord, name, _ChumpyStub)
    mod.ch = ch_mod
    sys.modules["chumpy"] = mod
    sys.modules["chumpy.ch"] = ch_mod
    sys.modules["chumpy.reordering"] = reord


def _to_np(a) -> np.ndarray:
    if hasattr(a, "toarray"):  # a sparse matrix (J_regressor)
        return np.asarray(a.toarray(), np.float64)
    return np.asarray(a, np.float64)


def load_smpl_pickle(path: str) -> Dict[str, np.ndarray]:
    """Load a SMPL model pickle (v1.0 layout: v_template, f, shapedirs, posedirs,
    J_regressor, weights, kintree_table)."""
    try:
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    except ModuleNotFoundError:
        _install_chumpy_stub()
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    return _normalize_model(data)


def _normalize_model(data: Dict) -> Dict[str, np.ndarray]:
    """Raw pickle-layout dict (f/kintree_table keys) -> loader layout."""
    if "faces" in data and "parents" in data:
        return data
    out = {}
    for key in ("v_template", "shapedirs", "posedirs", "weights"):
        out[key] = _to_np(data[key])
    out["J_regressor"] = _to_np(data["J_regressor"])
    out["faces"] = np.asarray(data["f"], np.int64)
    out["parents"] = np.asarray(data["kintree_table"], np.int64)[0]
    out["parents"][0] = -1  # stored as 2**32-1 in the pickle
    return out


def rodrigues(aa, device="cuda") -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), float64 on ``device``."""
    aa = to_tensor(aa, device, _F64)
    theta = torch.sqrt((aa * aa).sum(-1, keepdim=True))
    axis = aa / theta.clamp(min=1e-12)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(
        aa.shape[:-1] + (3, 3))
    t = theta[..., None]
    eye = torch.eye(3, dtype=_F64, device=aa.device).expand(k.shape)
    return eye + torch.sin(t) * k + (1 - torch.cos(t)) * (k @ k)


class SmplBody(BodyModel):
    """SMPL forward with the pipeline's BodyModel interface, on ``device``.

    vertices(global_orient, body_pose, betas):
      global_orient: (1, 3, 3) / (3, 3) rotation, or (3,) axis-angle, or None
      body_pose:     (23, 3, 3) rotations, or (69,)/(23, 3) axis-angle, or None
      betas:         (<=n_betas,) shape coefficients or None
    Returns (V, 3) float32 posed vertices (no global translation, like the standard
    SMPL layer / HMR2's pred_vertices before cam_t).
    """

    def __init__(self, model_or_path, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        m = (load_smpl_pickle(model_or_path) if isinstance(model_or_path, str)
             else _normalize_model(model_or_path))
        v_template = np.asarray(m["v_template"], np.float64)
        posedirs = np.asarray(m["posedirs"], np.float64)
        if posedirs.ndim == 2:  # (nb, V*3) smplx layout
            posedirs = posedirs.T.reshape(v_template.shape[0], 3, -1)
        arrays = dict(v_template=v_template,                       # (V, 3)
                      shapedirs=np.asarray(m["shapedirs"], np.float64),  # (V, 3, nb)
                      posedirs=posedirs,                           # (V, 3, 207)
                      J_regressor=np.asarray(m["J_regressor"], np.float64),  # (J, V)
                      weights=np.asarray(m["weights"], np.float64))  # (V, J)
        for name, a in arrays.items():
            self.register_buffer(name, torch.as_tensor(a, device=device))
        self.register_buffer("faces", torch.as_tensor(np.asarray(m["faces"], np.int64),
                                                      device=device))
        parents = np.asarray(m.get("parents", SMPL_PARENTS), np.int64)
        n_joints = arrays["J_regressor"].shape[0]
        if arrays["weights"].shape[1] != n_joints or len(parents) != n_joints:
            raise ValueError(f"SMPL model: {n_joints} regressed joints, weights for "
                             f"{arrays['weights'].shape[1]}, {len(parents)} parents")
        self.register_buffer("parents", torch.as_tensor(parents, device=device))
        # the kinematic tree by depth: the joints of each level below the root
        depth = np.zeros(n_joints, np.int64)
        for j in range(1, n_joints):
            depth[j] = depth[parents[j]] + 1
        self.levels = [torch.as_tensor(np.flatnonzero(depth == d), device=device)
                       for d in range(1, int(depth.max()) + 1)]

    def _as_rotmats(self, pose, n_joints: int) -> torch.Tensor:
        dev = self.v_template.device
        if pose is None:
            return torch.eye(3, dtype=_F64, device=dev).expand(n_joints, 3, 3)
        pose = to_tensor(pose, dev, _F64)
        if pose.shape[-2:] == (3, 3):
            return pose.reshape(-1, 3, 3)[:n_joints]
        return rodrigues(pose.reshape(n_joints, 3), device=dev)

    def vertices(self, global_orient, body_pose, betas) -> torch.Tensor:
        nb = self.shapedirs.shape[-1]
        n_joints = self.J_regressor.shape[0]
        dev = self.v_template.device
        b = torch.zeros(nb, dtype=_F64, device=dev)
        if betas is not None:
            bet = to_tensor(betas, dev, _F64).reshape(-1)[:nb]
            b[:len(bet)] = bet
        v_shaped = self.v_template + self.shapedirs @ b
        joints = self.J_regressor @ v_shaped  # (J, 3)

        rots = torch.cat([self._as_rotmats(global_orient, 1),
                          self._as_rotmats(body_pose, n_joints - 1)], dim=0)
        eye = torch.eye(3, dtype=_F64, device=dev)
        pose_feature = (rots[1:] - eye).reshape(-1)
        v_posed = v_shaped + self.posedirs @ pose_feature

        # forward kinematics: each joint's world transform, one level of the tree at
        # a time
        local = torch.zeros((n_joints, 4, 4), dtype=_F64, device=dev)
        local[:, :3, :3] = rots
        local[:, 3, 3] = 1.0
        local[0, :3, 3] = joints[0]
        local[1:, :3, 3] = joints[1:] - joints[self.parents[1:]]
        world = local.clone()
        for level in self.levels:
            world[level] = world[self.parents[level]] @ local[level]
        # remove the rest-pose joint locations
        skin = world.clone()
        skin[:, :3, 3] -= (world[:, :3, :3] @ joints[..., None])[..., 0]
        per_vertex = (self.weights @ skin.reshape(n_joints, 16)).reshape(-1, 4, 4)
        out = (per_vertex[:, :3, :3] @ v_posed[..., None])[..., 0] + per_vertex[:, :3, 3]
        return out.to(torch.float32)


class Hmr2SmplFitter:
    """HMR2 regressor behind the pipeline's SmplFitter interface (reference
    estimate_smpl, pedestrian_processor.py:135-182: 256x256 affine crop, ImageNet
    normalisation, forward, pick the pred_* outputs), on ``device``."""

    IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
    IMAGENET_STD = np.array([0.229, 0.224, 0.225])

    def __init__(self, model, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._mean = torch.as_tensor(self.IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(self.IMAGENET_STD, device=self.device)

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, device="cuda"):
        """Load via the `hmr2` package (4D-Humans); gated import — the package
        is not bundled in this environment."""
        try:
            from hmr2.models import load_hmr2
        except ImportError as e:
            raise ImportError(
                "HMR2 checkpoint loading needs the `hmr2` (4D-Humans) package; "
                "pass a loaded torch module to Hmr2SmplFitter(...) instead"
            ) from e
        model, _ = load_hmr2(checkpoint_path)
        return cls(model, device=device)

    def fit(self, crop_bgr, bbox_px_height: float) -> Dict:
        del bbox_px_height  # HMR2 regresses cam_t itself
        crop = to_tensor(crop_bgr, self.device)
        if tuple(crop.shape[:2]) != (CROP, CROP):
            raise ValueError(f"the crop must be {CROP}x{CROP}, got {tuple(crop.shape)}")
        rgb = crop.flip(-1).to(torch.float32) / 255.0
        rgb = (rgb.to(_F64) - self._mean) / self._std
        img = rgb.permute(2, 0, 1)[None].to(torch.float32).contiguous()
        with torch.no_grad():
            out = self.model({"img": img})
        smpl = out["pred_smpl_params"]
        return dict(
            vertices=out["pred_vertices"],
            cam_t=out["pred_cam_t"],
            smpl_pose=smpl["body_pose"].reshape(1, -1, 3, 3),
            global_orient=smpl["global_orient"].reshape(1, 1, 3, 3),
            betas=smpl["betas"].reshape(1, -1),
        )


def make_real_processor(smpl_path: str, segformer_path: Optional[str] = None,
                        hmr2_checkpoint: Optional[str] = None, hmr2_model=None,
                        device="cuda"):
    """Assemble a PedestrianProcessor with real backends where assets exist
    (reference PedestrianProcessor.__init__, pedestrian_processor.py:49-105): the
    SMPL body from the licensed pickle, the SegFormer segmenter when a local snapshot
    is given, the HMR2 fitter when a model or checkpoint is given; else the synthetic
    fitter (deterministic placement, real mesh). Everything on ``device``."""
    from .processor import (PedestrianProcessor, SegformerSegmenter, SyntheticSegmenter,
                            SyntheticSmplFitter)
    body = SmplBody(smpl_path, device=device)
    if hmr2_model is not None:
        fitter = Hmr2SmplFitter(hmr2_model, device=device)
    elif hmr2_checkpoint:
        fitter = Hmr2SmplFitter.from_checkpoint(hmr2_checkpoint, device=device)
    else:
        fitter = SyntheticSmplFitter(body)
    segmenter = (SegformerSegmenter(segformer_path, device=device)
                 if segformer_path else SyntheticSegmenter(device=device))
    return PedestrianProcessor(segmenter=segmenter, fitter=fitter, body=body, device=device)
