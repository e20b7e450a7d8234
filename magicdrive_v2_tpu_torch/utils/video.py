"""Video files of the port: MP4 read and write through OpenCV's FFMPEG backend.

The one module of the port that touches ``cv2``, and only for container I/O:
``cv2.VideoCapture`` / ``cv2.VideoWriter`` with the ``mp4v`` fourcc, and
``cv2.getBuildInformation`` to report whether the build has FFMPEG. Every array
operation (the channel flip included) is numpy. ``cv2`` is imported inside each
function, so importing this module needs no OpenCV.

OpenCV decodes to BGR and encodes from BGR; the JAX package's ``imageio`` reads
and writes RGB. Both functions here take and give RGB and turn the channel order
with ``[..., ::-1]``: a missing flip would swap red and blue and show nothing else.

Codec: the JAX tools write H.264 (libx264 through imageio-ffmpeg). OpenCV's wheels
encode no H.264, so the port writes MPEG-4 Part 2 (``mp4v``) in an MP4 container;
the decoder reads either. MPEG-4 Part 2 is lossy: a frame read back differs from
the one written by a few levels.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List

import numpy as np

FOURCC = "mp4v"
# the six cameras in the order the port's multi-view video files lay them out: the
# 2x3 grid row-major, [FL, F, FR] over [BR, B, BL] (``tools/create_video_12hz``, the
# W-CODA app's ``load_grid_video``), and the BrushNet app's per-camera files
CAMS = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT", "CAM_BACK",
        "CAM_BACK_LEFT")


def read_video(path: str) -> np.ndarray:
    """Every frame of the video file ``path`` as uint8 (T, H, W, 3) in RGB order.
    Raises FileNotFoundError for a missing file and ValueError for one that does
    not open or yields no frame."""
    import cv2
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no video file {path!r}")
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise ValueError(f"cv2.VideoCapture cannot open {path!r}")
        frames: List[np.ndarray] = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[..., ::-1])
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"{path!r} yields no frame")
    return np.ascontiguousarray(np.stack(frames))


def write_video(path: str, frames: Iterable, fps: float = 12) -> int:
    """Write ``frames`` (T, H, W, 3) uint8 RGB, or an iterable of (H, W, 3) arrays
    of one size (taken one at a time), to ``path`` as an ``mp4v`` MP4 at ``fps``.
    H and W must be even (MPEG-4 Part 2 stores 4:2:0 chroma). Returns the number of
    frames written; raises ValueError when there is none, the writer does not open
    or a frame has another shape or type."""
    import cv2
    writer, size, n = None, None, 0
    try:
        for frame in frames:
            frame = np.asarray(frame)
            if size is None:
                size = frame.shape[:2]
                if frame.ndim != 3 or size[0] % 2 or size[1] % 2:
                    raise ValueError(f"{FOURCC} needs (H, W, 3) frames of even H and W, "
                                     f"got {frame.shape}")
                os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
                writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*FOURCC), float(fps),
                                         (size[1], size[0]))
                if not writer.isOpened():
                    raise ValueError(f"cv2.VideoWriter cannot open {path!r} with {FOURCC!r}")
            if frame.dtype != np.uint8 or frame.shape != (*size, 3):
                raise ValueError(f"frame {n}: {frame.dtype} {frame.shape}, expected uint8 "
                                 f"{(*size, 3)}")
            writer.write(np.ascontiguousarray(frame[..., ::-1]))
            n += 1
    finally:
        if writer is not None:
            writer.release()
    if n == 0:
        raise ValueError(f"no frame to write to {path!r}")
    return n


def backend_report() -> Dict[str, object]:
    """What this machine's OpenCV offers for video: its version and the "Video
    I/O" lines of its build information (whether FFMPEG is there)."""
    import cv2
    lines = cv2.getBuildInformation().splitlines()
    start = next((i for i, line in enumerate(lines) if "Video I/O" in line), None)
    io = []
    if start is not None:
        for line in lines[start + 1:]:
            if not line.strip() or not line.startswith("    "):
                break
            io.append(line.strip())
    ffmpeg = any(line.startswith("FFMPEG:") and "YES" in line for line in io)
    return {"cv2": cv2.__version__, "video_io": io, "ffmpeg": ffmpeg}
