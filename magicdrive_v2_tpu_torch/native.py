"""ctypes binding of the native host kernels (``native/src/mdv2_native.cpp``): the
polygon fill of the BEV maps, box corners, corner projection and the z-buffered
triangle rasterizer of the pedestrian pipeline. The port's own binding of the
library the JAX package also loads.

The library is ``native/libmdv2_native.so`` as committed. It was built with
``-march=native``, so on another host CPU it may fail to load or stop on an illegal
instruction: before it is loaded into this process, a child process loads it and
calls each entry once. If that fails, the source is built with ``g++`` (no
``-march=native``) into ``build/magicdrive_v2_tpu_torch/`` and that library is
loaded. If neither works, every entry raises: there is no silent switch to another
fill (PIL's agrees with this one only to an IoU of about 0.93).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

REPO = Path(__file__).resolve().parents[1]
COMMITTED = REPO / "native" / "libmdv2_native.so"
SOURCE = REPO / "native" / "src" / "mdv2_native.cpp"
BUILD_DIR = REPO / "build" / "magicdrive_v2_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_path: Optional[Path] = None

# loads the library at argv[1] and calls each bound entry once
_PROBE = r"""
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
p, c = ctypes.c_void_p, ctypes.c_int
lib.mdv2_fill_polygons.argtypes = [p, c, c, p, p, c, ctypes.c_uint8]
lib.mdv2_boxes_to_corners.argtypes = [p, c, c, p]
lib.mdv2_project_corners.argtypes = [p, c, p, c, p]
lib.mdv2_rasterize_mesh.argtypes = [p, c, p, c, p, c, c, ctypes.c_float, p, p, p]
canvas = np.zeros((64, 64), np.uint8)
xy = np.array([[3, 4], [50, 9], [40, 60], [8, 40]], np.float32)
n_pts = np.array([4], np.int32)
lib.mdv2_fill_polygons(canvas.ctypes.data, 64, 64, xy.ctypes.data, n_pts.ctypes.data, 1, 1)
boxes = np.array([[1, 2, 0, 2, 4, 1.5, 0.3, 0, 0]] * 9, np.float32)
corners = np.empty((9, 8, 3), np.float32)
lib.mdv2_boxes_to_corners(boxes.ctypes.data, 9, 9, corners.ctypes.data)
out = np.empty_like(corners)
trans = np.eye(4)
trans[2, 3] = 5.0  # every corner in front of the camera
lib.mdv2_project_corners(corners.ctypes.data, 9, trans.ctypes.data, 1, out.ctypes.data)
verts = np.array([[2, 2, 1], [30, 4, 2], [8, 28, 3]], np.float32)
tri = np.array([[0, 1, 2]], np.int32)
rgb = np.zeros((32, 32, 3), np.float32)
depth = np.full((32, 32), np.inf, np.float32)
face_id = np.full((32, 32), -1, np.int32)
colors = np.ones_like(verts)
lib.mdv2_rasterize_mesh(verts.ctypes.data, 3, tri.ctypes.data, 1, colors.ctypes.data, 32, 32,
                        1e-4, rgb.ctypes.data, depth.ctypes.data, face_id.ctypes.data)
assert canvas.sum() > 100 and np.isfinite(out).all()
assert (face_id == 0).sum() > 100 and np.isfinite(depth[face_id == 0]).all()
"""


def _probe(path: Path) -> Optional[str]:
    """None if a child process loads ``path`` and runs each entry, else why not."""
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE, str(path)], capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        return f"exit code {proc.returncode}: {proc.stderr.strip()[-300:]}"
    return None


def _build() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libmdv2_native-{tag}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{id(out)}")
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        tmp.replace(out)
    return out


def _load() -> ctypes.CDLL:
    global _lib, _path
    if _lib is not None:
        return _lib
    why = _probe(COMMITTED) if COMMITTED.is_file() else f"{COMMITTED} is missing"
    path = COMMITTED
    if why is not None:
        logger.warning("native library %s does not run here (%s); building %s", COMMITTED,
                       why, SOURCE)
        try:
            path = _build()
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"the native host kernels are unavailable: {COMMITTED} does "
                               f"not run here ({why}) and building {SOURCE} failed ({e})")
        built_why = _probe(path)
        if built_why is not None:
            raise RuntimeError(f"the native library built from {SOURCE} does not run: "
                               f"{built_why}")
    lib = ctypes.CDLL(str(path))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c = ctypes.c_int
    lib.mdv2_fill_polygons.argtypes = [u8p, c, c, f32p, i32p, c, ctypes.c_uint8]
    lib.mdv2_boxes_to_corners.argtypes = [f32p, c, c, f32p]
    lib.mdv2_project_corners.argtypes = [f32p, c, f64p, c, f32p]
    lib.mdv2_rasterize_mesh.argtypes = [f32p, c, i32p, c, ctypes.c_void_p, c, c,
                                        ctypes.c_float, f32p, f32p, i32p]
    for entry in (lib.mdv2_fill_polygons, lib.mdv2_boxes_to_corners,
                  lib.mdv2_project_corners, lib.mdv2_rasterize_mesh):
        entry.restype = None
    _lib, _path = lib, path
    logger.info("native host kernels loaded from %s", path)
    return lib


def library_path() -> str:
    """The path of the library the entries run (loading it if needed)."""
    _load()
    return str(_path)


def fill_polygons(canvas: np.ndarray, polys: Sequence[np.ndarray],
                  value: int = 1) -> np.ndarray:
    """Fill polygons (each (P, 2) float xy) into a (h, w) uint8 canvas in place."""
    if canvas.dtype != np.uint8 or canvas.ndim != 2 or not canvas.flags.c_contiguous:
        raise ValueError(f"canvas must be a C-contiguous 2-D uint8 array, got "
                         f"{canvas.dtype} {canvas.shape}")
    lib = _load()
    if polys:
        xy = np.ascontiguousarray(np.concatenate([np.asarray(p, np.float32) for p in polys]))
        n_pts = np.asarray([len(p) for p in polys], np.int32)
        lib.mdv2_fill_polygons(canvas, canvas.shape[0], canvas.shape[1], xy, n_pts,
                               len(polys), value)
    return canvas


def boxes_to_corners(boxes: np.ndarray) -> np.ndarray:
    """(N, >=7) boxes -> (N, 8, 3) corners (``datasets.geometry.boxes_to_corners``)."""
    boxes = np.ascontiguousarray(np.asarray(boxes, np.float32))
    lib = _load()
    if boxes.shape[0] == 0:
        return np.zeros((0, 8, 3), np.float32)
    out = np.empty((boxes.shape[0], 8, 3), np.float32)
    lib.mdv2_boxes_to_corners(boxes, boxes.shape[0], boxes.shape[1], out)
    return out


def project_corners(corners: np.ndarray, trans: np.ndarray, proj: bool = True) -> np.ndarray:
    """(N, 8, 3) corners through a 4x4 transform; with ``proj`` xy divided by the
    clipped depth and z reduced to its sign."""
    corners = np.ascontiguousarray(np.asarray(corners, np.float32))
    trans = np.ascontiguousarray(np.asarray(trans, np.float64).reshape(4, 4))
    lib = _load()
    out = np.empty_like(corners)
    lib.mdv2_project_corners(corners, corners.shape[0], trans, int(proj), out)
    return out


def rasterize_mesh(verts: np.ndarray, faces: np.ndarray, colors: Optional[np.ndarray],
                   h: int, w: int, z_near: float = 1e-4):
    """Z-buffered triangle rasterization with per-vertex colours (screen-space
    barycentric weights, no perspective correction; a face with a vertex at
    z <= ``z_near`` is skipped).

    verts: (V, 3) screen x, y and camera depth z; faces: (F, 3) vertex indices;
    colors: (V, 3) or None (depth and face ids only). Returns rgb (h, w, 3) float32
    (0 where empty), depth (h, w) float32 (+inf where empty) and face_id (h, w)
    int32 (-1 where empty), as numpy arrays.
    """
    verts = np.ascontiguousarray(np.asarray(verts, np.float32))
    faces = np.ascontiguousarray(np.asarray(faces, np.int32))
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"verts must be (V, 3) and faces (F, 3), got {verts.shape} and "
                         f"{faces.shape}")
    if faces.size and (faces.min() < 0 or faces.max() >= verts.shape[0]):
        raise ValueError(f"face indices must lie in [0, {verts.shape[0]})")
    col = None
    if colors is not None:
        col = np.ascontiguousarray(np.asarray(colors, np.float32))
        if col.shape != verts.shape:
            raise ValueError(f"colors must be {verts.shape}, got {col.shape}")
    lib = _load()
    rgb = np.zeros((h, w, 3), np.float32)
    depth = np.full((h, w), np.inf, np.float32)
    face_id = np.full((h, w), -1, np.int32)
    if faces.shape[0]:
        lib.mdv2_rasterize_mesh(verts, verts.shape[0], faces, faces.shape[0],
                                None if col is None else col.ctypes.data, int(h), int(w),
                                float(z_near), rgb, depth, face_id)
    return rgb, depth, face_id
