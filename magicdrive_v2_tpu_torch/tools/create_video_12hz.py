"""Per-camera pedestrian renders into one 2x3 camera-grid video (counterpart of the
JAX package's tools/create_video_12hz.py; reference create_video_12hz.py).

``--render-dir`` holds a folder of PNG frames per camera, ``<CAM>/*.png``, in name
order; frame i of the video is the six cameras' frame i laid out row-major in
``CAMS`` order, [FL, F, FR] over [BR, B, BL] (the layout ``concat_6_views`` gives
and the W-CODA app's ``load_grid_video`` reads). The video has as many frames as
the shortest camera folder; a camera without frames raises. PNGs are read by PIL as
RGB (a grey mask replicated to three channels) and the video is written through
``utils/video.py`` (MPEG-4 Part 2 in an MP4 container, where the JAX tool writes
H.264: OpenCV's wheels encode no H.264).

The JAX chain around this tool does not fit together, and the port keeps it as it
is: ``pipeline_12hz`` writes flat ``<stem>.png`` / ``<stem>_mask.png`` pairs at the
camera's resolution (JAX scripts/pipeline_12hz.py:333-335), this tool reads
``<CAM>/`` folders whose frames must already be the model's size, and the two
inpainting apps read two other layouts (``<dir>/<index>/videos.mp4`` and
``masks.mp4`` grids; ``<dir>/<CAM>.mp4`` and ``<CAM>_mask.mp4`` per camera). Files
are moved and resized between the steps by hand (``chip_smoke.py`` phase
``ped_video`` does it for its synthetic scene).

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.tools.create_video_12hz --render-dir DIR \\
      [--out FILE] [--fps 12]
writes ``DIR_grid.mp4`` unless ``--out`` names another file.
"""
from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np

from ..utils.video import CAMS, write_video
from .img_folder2vid import read_rgb


def grid_video(render_dir: str, out=None, fps: float = 12) -> Tuple[str, int]:
    """Write the 2x3 grid video of ``render_dir`` to ``out`` (default
    ``<render_dir>_grid.mp4``); returns (path, number of frames)."""
    files = {}
    for cam in CAMS:
        d = os.path.join(render_dir, cam)
        files[cam] = sorted(os.path.join(d, f) for f in os.listdir(d)
                            if f.endswith(".png")) if os.path.isdir(d) else []
    empty = [cam for cam, fs in files.items() if not fs]
    if empty:
        raise ValueError(f"no renders under {render_dir!r} for {empty}")
    n = min(len(fs) for fs in files.values())

    def frames():
        for i in range(n):
            views = [read_rgb(files[cam][i]) for cam in CAMS]
            yield np.concatenate([np.concatenate(views[:3], axis=1),
                                  np.concatenate(views[3:], axis=1)], axis=0)

    out = out or render_dir.rstrip("/") + "_grid.mp4"
    write_video(out, frames(), fps=fps)
    return out, n


def main(argv=None) -> Tuple[str, int]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--render-dir", required=True,
                   help="scene dir containing <CAM>/*.png renders")
    p.add_argument("--out", default=None)
    p.add_argument("--fps", type=int, default=12)
    args = p.parse_args(argv)
    out, n = grid_video(args.render_dir, args.out, args.fps)
    print(f"wrote {out} ({n} frames)")
    return out, n


if __name__ == "__main__":
    main()
