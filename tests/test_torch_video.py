"""PyTorch port, the pedestrian-video inputs: ``utils/video.py`` (MP4 through
OpenCV), the two apps' loaders (``load_grid_video`` of the W-CODA app,
``load_pedestrian_inputs`` of the BrushNet app) and the two video tools
(``create_video_12hz``, ``img_folder2vid``).

The JAX loaders read with ``imageio.mimread``, whose mp4 plugin this machine lacks;
the tests install a stand-in ``imageio`` whose ``mimread`` returns the frames the
port decoded from the same ``mp4v`` file, so both loaders see the same decoded
frames and must give bit-equal arrays, masks included.

Limits: a frame read back from an ``mp4v`` file (MPEG-4 Part 2, lossy) is within 8
levels of the written one on each view's mean per channel; the colours differ by
at least 40 levels between channels and views, so a red/blue swap or a wrong view
order fails.
"""
import ast
import importlib.util
import os
import sys
import types

import numpy as np
import pytest

from magicdrive_v2_tpu_torch.scripts.inference_magicdrive_brushnet import (
    CAMS, load_pedestrian_inputs)
from magicdrive_v2_tpu_torch.scripts.test_magicdrive import load_grid_video
from magicdrive_v2_tpu_torch.tools import create_video_12hz, img_folder2vid
from magicdrive_v2_tpu_torch.utils.video import read_video, write_video

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, T = 16, 32, 5
MEAN_LIMIT = 8  # levels of 255, on a view's mean of one channel
# a colour per view, each channel apart from the others and from the other views'
VIEW_RGB = np.array([(230, 40, 120), (40, 200, 160), (120, 90, 250),
                     (200, 160, 30), (80, 250, 40), (160, 30, 200)], np.uint8)


def grid_frames(h=H, w=W, t=T, mask=False):
    """(t, 2h, 3w, 3) uint8 frames of the 2x3 grid, view vi in VIEW_RGB[vi] (with
    ``mask``: white where a block walks across the view, black elsewhere)."""
    out = np.zeros((t, 2 * h, 3 * w, 3), np.uint8)
    for ti in range(t):
        for vi in range(6):
            r, c = divmod(vi, 3)
            cell = out[ti, r * h:(r + 1) * h, c * w:(c + 1) * w]
            if mask:
                x0 = (2 * ti + 3 * vi) % (w - 14)
                cell[:, x0:x0 + 8 + vi] = 255
            else:
                cell[:] = VIEW_RGB[vi]
    return out


def load_jax_script(name):
    path = os.path.join(REPO, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(f"jax_video_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stand_in_imageio_module():
    """An ``imageio`` whose ``mimread`` gives the port's decoded frames of a file."""
    mod = types.ModuleType("imageio")
    mod.mimread = lambda path, memtest=True: list(read_video(str(path)))
    return mod


@pytest.fixture
def stand_in_imageio(monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", stand_in_imageio_module())


def test_video_round_trip_keeps_channels_and_views(tmp_path):
    frames = grid_frames()
    path = str(tmp_path / "grid.mp4")
    assert write_video(path, frames, fps=12) == T
    got = read_video(path)
    assert got.shape == frames.shape and got.dtype == np.uint8
    for vi in range(6):
        r, c = divmod(vi, 3)
        cell = got[:, r * H:(r + 1) * H, c * W:(c + 1) * W].reshape(-1, 3).mean(0)
        assert np.abs(cell - VIEW_RGB[vi]).max() <= MEAN_LIMIT, (vi, cell, VIEW_RGB[vi])
    # the frames one at a time (a generator) give the same file contents
    path2 = str(tmp_path / "gen.mp4")
    assert write_video(path2, (f for f in frames)) == T
    np.testing.assert_array_equal(read_video(path2), got)


def test_video_io_refuses_bad_input(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_video(str(tmp_path / "none.mp4"))
    (tmp_path / "junk.mp4").write_bytes(b"not a video")
    with pytest.raises(ValueError):
        read_video(str(tmp_path / "junk.mp4"))
    with pytest.raises(ValueError, match="even"):
        write_video(str(tmp_path / "odd.mp4"), np.zeros((2, 15, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="no frame"):
        write_video(str(tmp_path / "empty.mp4"), [])
    with pytest.raises(ValueError, match="uint8"):
        write_video(str(tmp_path / "f.mp4"), np.zeros((2, 16, 32, 3), np.float32))


@pytest.mark.parametrize("extra", [0, 2])
def test_load_grid_video_equals_the_jax_package(tmp_path, stand_in_imageio, extra):
    """JAX's and the port's loader on the same decoded frames: bit-equal, RGB and
    masks; ``extra`` frames beyond the clip length are dropped by both."""
    jax_app = load_jax_script("test_magicdrive")
    vid, msk = str(tmp_path / "videos.mp4"), str(tmp_path / "masks.mp4")
    write_video(vid, grid_frames(t=T + extra))
    write_video(msk, grid_frames(t=T + extra, mask=True))
    for path, grey in ((vid, False), (msk, True)):
        mine = load_grid_video(path, T, H, W, grayscale=grey)
        ref = jax_app.load_grid_video(path, T, H, W, grayscale=grey)
        assert mine.dtype == ref.dtype == np.float32
        assert mine.shape == (6, 1 if grey else 3, T, H, W)
        np.testing.assert_array_equal(mine, ref)
    rgb = load_grid_video(vid, T, H, W)
    means = (rgb.mean(axis=(2, 3, 4)) + 1) * 127.5  # (6, 3)
    assert np.abs(means - VIEW_RGB).max() <= MEAN_LIMIT, means
    masks = load_grid_video(msk, T, H, W, grayscale=True)
    assert set(np.unique(masks)) == {0.0, 1.0}
    # view vi's walking block is 8 + vi columns wide
    widths = masks[:, 0].mean(axis=(1, 2, 3)) * W
    assert np.abs(widths - (8 + np.arange(6))).max() < 1.0, widths


def test_load_grid_video_refuses_short_or_small_videos(tmp_path, stand_in_imageio):
    jax_app = load_jax_script("test_magicdrive")
    vid = str(tmp_path / "videos.mp4")
    write_video(vid, grid_frames(t=3))
    for loader in (load_grid_video, jax_app.load_grid_video):
        with pytest.raises(ValueError, match="3 frames < requested 5"):
            loader(vid, T, H, W)
    with pytest.raises(ValueError, match="grid"):
        load_grid_video(vid, 3, H + 2, W)


def write_ped_dir(root, h, w, t, cams=CAMS):
    """<CAM>.mp4 (the view's colour, a bar moving) and <CAM>_mask.mp4 per camera."""
    os.makedirs(root, exist_ok=True)
    for ci, cam in enumerate(cams):
        rgb = np.broadcast_to(VIEW_RGB[ci], (t, h, w, 3)).copy()
        msk = np.zeros((t, h, w, 3), np.uint8)
        for ti in range(t):
            rgb[ti, :, ti:ti + 4] = 255 - VIEW_RGB[ci]
            msk[ti, 2:h - 2, 2 * ti:2 * ti + 6 + ci] = 255
        write_video(os.path.join(root, f"{cam}.mp4"), rgb)
        write_video(os.path.join(root, f"{cam}_mask.mp4"), msk)


def test_load_pedestrian_inputs_equals_the_jax_package(tmp_path, stand_in_imageio):
    """Complete files (one frame more than asked for, 4 rows and columns more than
    the model's size, cut by both): bit-equal to JAX's loader."""
    jax_app = load_jax_script("inference_magicdrive_brushnet")
    root = str(tmp_path / "ped")
    write_ped_dir(root, H + 4, W + 4, T + 1)
    imgs, masks = load_pedestrian_inputs(root, T, H, W)
    ref_imgs, ref_masks = jax_app.load_pedestrian_inputs(root, T, H, W)
    assert imgs.shape == (6, 3, T, H, W) and masks.shape == (6, 1, T, H, W)
    np.testing.assert_array_equal(imgs, ref_imgs)
    np.testing.assert_array_equal(masks, ref_masks)
    assert set(np.unique(masks)) == {0.0, 1.0}
    # each camera's own colour, in CAMS order (the bar aside: the median)
    med = (np.median(imgs.reshape(6, 3, -1), axis=2) + 1) * 127.5
    assert np.abs(med - VIEW_RGB).max() <= MEAN_LIMIT, med


def test_load_pedestrian_inputs_refuses_missing_and_short_files(tmp_path):
    """Where JAX's loader zero-fills (a camera without files, a video shorter than
    the clip), the port raises."""
    root = str(tmp_path / "ped")
    write_ped_dir(root, H, W, T, cams=CAMS[:5])
    with pytest.raises(ValueError, match="CAM_BACK_LEFT.mp4' is missing"):
        load_pedestrian_inputs(root, T, H, W)
    write_ped_dir(root, H, W, T - 1, cams=CAMS[5:])
    with pytest.raises(ValueError, match="CAM_BACK_LEFT.mp4"):
        load_pedestrian_inputs(root, T, H, W)
    os.remove(os.path.join(root, "CAM_FRONT_mask.mp4"))
    with pytest.raises(ValueError, match="CAM_FRONT_mask.mp4' is missing"):
        load_pedestrian_inputs(root, T - 1, H, W)


def write_pngs(folder, frames):
    from PIL import Image
    os.makedirs(folder, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(folder, f"f{i:05d}.png"))


def test_img_folder2vid_cli(tmp_path):
    frames = grid_frames(t=4)
    folder = str(tmp_path / "frames")
    write_pngs(folder, frames)
    (tmp_path / "frames" / "notes.txt").write_text("not a frame")
    out, n = img_folder2vid.main([folder, "--fps", "10"])
    assert out == folder + ".mp4" and n == 4
    got = read_video(out)
    assert got.shape == frames.shape
    assert np.abs(got.reshape(-1, 3).mean(0) - frames.reshape(-1, 3).mean(0)).max() <= 4
    with pytest.raises(ValueError, match="no frames"):
        img_folder2vid.main([str(tmp_path)])


def test_create_video_12hz_cli_feeds_load_grid_video(tmp_path):
    """Per-camera PNG folders (a grey mask PNG among them for one camera) -> the
    grid video, which the W-CODA loader splits back into the cameras in order; the
    video has the shortest camera's length; a camera without renders raises."""
    from PIL import Image
    render = tmp_path / "scene"
    for ci, cam in enumerate(create_video_12hz.CAMS):
        n = T + (ci == 2)  # one camera has a frame more
        write_pngs(str(render / cam), [np.broadcast_to(VIEW_RGB[ci], (H, W, 3)).copy()] * n)
    Image.fromarray(np.full((H, W), 77, np.uint8)).save(render / "CAM_BACK" / "f00000.png")
    out, n = create_video_12hz.main(["--render-dir", str(render)])
    assert out == str(render) + "_grid.mp4" and n == T
    views = load_grid_video(out, T, H, W)
    means = (views[:, :, 1:].mean(axis=(2, 3, 4)) + 1) * 127.5
    assert np.abs(means - VIEW_RGB).max() <= MEAN_LIMIT, means
    first_back = (views[4, :, 0].mean(axis=(1, 2)) + 1) * 127.5
    assert np.abs(first_back - 77).max() <= MEAN_LIMIT, first_back
    for f in os.listdir(render / "CAM_FRONT_RIGHT"):
        os.remove(render / "CAM_FRONT_RIGHT" / f)
    with pytest.raises(ValueError, match="CAM_FRONT_RIGHT"):
        create_video_12hz.main(["--render-dir", str(render), "--out", str(tmp_path / "x.mp4")])


def test_video_module_uses_cv2_for_container_io_only():
    """``utils/video.py`` reaches nothing of ``cv2`` but the capture and the writer,
    the fourcc, the capture's ``CAP_PROP_*`` constants and the build report; it
    imports ``cv2`` only inside functions, and never through ``importlib``."""
    path = os.path.join(REPO, "magicdrive_v2_tpu_torch", "utils", "video.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    allowed = {"VideoCapture", "VideoWriter", "VideoWriter_fourcc", "getBuildInformation",
               "__version__"}
    used = {node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "cv2"}
    assert used, "the module reaches no cv2 name"
    assert {u for u in used if not u.startswith("CAP_PROP_")} <= allowed, used
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("cv2" in ast.dump(n) for n in top), "cv2 imported at module level"
    assert "importlib" not in ast.dump(tree)
    # cv2 is not bound under another name, nor passed around whole
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert alias.name != "cv2" or alias.asname is None, alias.asname
        if isinstance(node, ast.ImportFrom):
            assert node.module != "cv2", "from cv2 import ..."
        if isinstance(node, ast.Call):
            assert not any(isinstance(a, ast.Name) and a.id == "cv2" for a in node.args)


def spy_inpaint_inputs(monkeypatch):
    """Records the ``x_inpaint`` / ``mask_inpaint`` of each call of either
    package's ``MagicDrivePipeline.sample`` (the apps' tests): {"jax": [...],
    "port": [...]}, each entry a dict of numpy arrays."""
    from magicdrive_v2_tpu.pipelines import magicdrive as jpipe
    from magicdrive_v2_tpu_torch.pipelines import magicdrive as tpipe
    got = {"jax": [], "port": []}
    for key, mod in (("jax", jpipe), ("port", tpipe)):
        def sample(self, batch, *args, _real=mod.MagicDrivePipeline.sample, _key=key, **kw):
            got[_key].append({k: np.array(batch[k]) for k in ("x_inpaint", "mask_inpaint")})
            return _real(self, batch, *args, **kw)
        monkeypatch.setattr(mod.MagicDrivePipeline, "sample", sample)
    return got


def write_grid_dirs(root, indices, h, w, t):
    """``<root>/<index>/videos.mp4`` and ``masks.mp4`` for each index: the 2x3 grid
    of the view colours (moved by the index) and the walking mask blocks."""
    for i in indices:
        d = os.path.join(root, str(i))
        os.makedirs(d, exist_ok=True)
        write_video(os.path.join(d, "videos.mp4"), np.roll(grid_frames(h, w, t), 7 * i, axis=2))
        write_video(os.path.join(d, "masks.mp4"), grid_frames(h, w, t, mask=True))
