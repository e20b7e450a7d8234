"""A folder of frames into one MP4 (counterpart of the JAX package's
tools/img_folder2vid.py; reference tools/imgFoler2vid.py).

The ``.png`` / ``.jpg`` files of the folder, in name order, read by PIL as RGB,
written through ``utils/video.py`` (MPEG-4 Part 2 in an MP4 container, where the
JAX tool writes H.264 at 4 Mbit/s: OpenCV's wheels encode no H.264). Every frame
must have the first one's size, and the size must be even.

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.tools.img_folder2vid FOLDER [--fps 12] [--out FILE]
writes ``FOLDER.mp4`` unless ``--out`` names another file.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

import numpy as np

FRAME_SUFFIXES = (".png", ".jpg")


def read_rgb(path: str) -> np.ndarray:
    """An image file as uint8 (H, W, 3) RGB (a grey or RGBA image converted by PIL)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def frame_files(folder: str) -> List[str]:
    """The frame files of ``folder`` in name order; ValueError when it has none."""
    names = sorted(f for f in os.listdir(folder) if f.endswith(FRAME_SUFFIXES))
    if not names:
        raise ValueError(f"no frames in {folder!r}")
    return [os.path.join(folder, f) for f in names]


def folder_to_video(folder: str, out: Optional[str] = None, fps: float = 12) -> Tuple[str, int]:
    """Write the frames of ``folder`` to ``out`` (default ``<folder>.mp4``); returns
    (path, number of frames)."""
    from ..utils.video import write_video
    files = frame_files(folder)
    out = out or folder.rstrip("/") + ".mp4"
    write_video(out, (read_rgb(f) for f in files), fps=fps)
    return out, len(files)


def main(argv=None) -> Tuple[str, int]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("folder")
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    out, n = folder_to_video(args.folder, args.out, args.fps)
    print(f"wrote {out} ({n} frames)")
    return out, n


if __name__ == "__main__":
    main()
