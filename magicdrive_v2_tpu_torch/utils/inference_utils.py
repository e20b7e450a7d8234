"""Inference helpers: null conditions for classifier-free guidance, prompt
editing, the clip length of a config, conditioning from a config's validation
split, the 2x3 six-view grid and saving frames as PNG files (written with ``zlib``
and ``struct`` alone)."""
from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# Weather/time-of-day prompt editing: force_daytime scrubs rain/night vocabulary
# and pins the city; force_rainy / force_night substitute a canonical prompt when
# the keyword is absent. Each mode also gives a negative prompt that replaces the
# null caption in classifier-free guidance.
_DAYTIME_SCRUBS = (
    ("rain", "sunny"), ("water reflections", ""), ("reflections in water", ""),
    (" with umbrellas", ""), (" with umbrella", ""), (" holds umbrella", ""),
    ("night", ""), (" in dark", ""), (" dark", ""), (" difficult lighting", ""),
    ("boston-seaport", "singapore-onenorth"),
    ("singapore-hollandvillage", "singapore-onenorth"),
)
_RAINY_PROMPT = "A driving scene image at boston-seaport. Rain. water reflections."
_NIGHT_PROMPT = ("A driving scene image at singapore-hollandvillage. "
                 "Night, congestion. difficult lighting. very dark.")
_NEG_PROMPTS = {
    "daytime": "Rain, Night, water reflections, umbrella",
    "rainy": "Daytime. night, onenorth, queenstown",
    "night": "Daytime. rain, boston-seaport",
}
# zlib level of the written frames (1: the fastest compression)
PNG_LEVEL = 1


def edit_prompt(prompt: str, *, force_daytime: bool = False,
                force_rainy: bool = False, force_night: bool = False):
    """Returns (edited_prompt, neg_prompt | None)."""
    if force_daytime:
        out = "Daytime. " + prompt.lower()
        for a, b in _DAYTIME_SCRUBS:
            out = out.replace(a, b)
        return out, _NEG_PROMPTS["daytime"]
    if force_rainy:
        out = prompt if "rain" in prompt.lower() else _RAINY_PROMPT
        return out, _NEG_PROMPTS["rainy"]
    if force_night:
        out = prompt if "night" in prompt.lower() else _NIGHT_PROMPT
        return out, _NEG_PROMPTS["night"]
    return prompt, None


def resolve_num_frames(cfg, cli_num_frames=None, app_name: str = "app") -> int:
    """The clip length: ``--num-frames``, else the config's ``num_frames``; for
    ``num_frames="full"`` the config's ``full_bucket_t`` (an 8n+1 length), and an
    error without one."""
    if cli_num_frames:
        return int(cli_num_frames)
    nf = cfg.get("num_frames", 17)
    if nf == "full":
        t = int(cfg.get("full_bucket_t", 0) or 0)
        if t % 8 != 1:
            raise ValueError(
                f"{app_name}: num_frames='full' needs full_bucket_t (an 8n+1 "
                "scene length) in the config or an explicit --num-frames; got "
                f"full_bucket_t={cfg.get('full_bucket_t')!r}")
        return t
    return int(nf)


def build_val_dataset(cfg, video_length):
    """The config's ``dataset.data.val`` split, its clip length ``video_length``
    unless the split sets one ("full": whole scenes)."""
    from ..registry import DATASETS, build_module
    ds_cfg = dict(cfg.dataset.data.val)
    ds_cfg.setdefault("video_length", video_length)
    return build_module(ds_cfg, DATASETS)


def full_bucket_length(cfg, dataset) -> int:
    """The bucket every whole scene pads to: the config's ``full_bucket_t``, else the
    dataset's longest full clip snapped to 8n+1."""
    from ..datasets import max_full_clip_len
    t = int(cfg.get("full_bucket_t", 0) or 0) or max_full_clip_len(dataset)
    if t % 8 != 1:
        raise ValueError(f"full bucket length must be 8n+1, got {t}")
    return t


def dataset_model_batch(dataset, index, full_t: Optional[int] = None) -> Dict:
    """The model batch (numpy, captions as strings) of clip ``index``; with
    ``full_t`` padded to that many frames (``frame_valid`` marks the scene's own)."""
    from ..datasets import clip_to_model_batch, collate_clips, pad_model_batch_to_t
    batch = clip_to_model_batch(collate_clips([dataset[index]]))
    return pad_model_batch_to_t(batch, full_t) if full_t else batch


def _null_cams_like(cams: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
    """cams: (BNC, T, 1, r, c); uncond: (r', c) broadcast to every entry."""
    r, c = uncond.shape
    out = torch.zeros(tuple(cams.shape[:3]) + (r, c), dtype=cams.dtype, device=cams.device)
    return out + uncond.detach().to(cams)[None, None, None]


def add_null_condition(model_args: Dict, uncond_cam, uncond_rel_pos,
                       prepend: bool = False, use_map0: bool = False) -> Dict:
    """Batched-CFG condition doubling: appends (or prepends) the null half —
    zeroed bbox (masks=0 -> null features), uncond cam / rel_pos parameters, and
    the *same* maps unless use_map0."""
    unchanged = {"mv_order_map", "t_order_map", "height", "width", "num_frames", "fps",
                 "num_timesteps"}
    out = {}

    def cat(a, b):
        return torch.cat(([b, a] if prepend else [a, b]), dim=0)

    for k, v in model_args.items():
        if k in unchanged or v is None:
            out[k] = v
        elif k == "bbox":
            out[k] = {kk: cat(vv, torch.zeros_like(vv)) for kk, vv in v.items()}
        elif k == "cams":
            out[k] = cat(v, _null_cams_like(v, uncond_cam))
        elif k == "rel_pos":
            v = v[..., :-1, :] if v.shape[-2] == 4 else v
            out[k] = cat(v, _null_cams_like(v, uncond_rel_pos))
        elif k == "maps" and use_map0:
            out[k] = cat(v, torch.zeros_like(v))
        else:
            out[k] = torch.cat([v, v], dim=0)
    return out


def replace_with_null_condition(model_args: Dict, uncond_cam, uncond_rel_pos,
                                uncond_y, keys: Sequence[str],
                                append: bool = False) -> Dict:
    """Two-pass-CFG null replacement."""
    keys = set(keys)
    out = dict(model_args)
    if "y" in keys and "y" in out:
        out["y"] = uncond_y if not append else torch.cat([out["y"], uncond_y], 0)
    if "bbox" in keys and out.get("bbox") is not None:
        out["bbox"] = {k: torch.zeros_like(v) for k, v in out["bbox"].items()}
    if "cams" in keys and "cams" in out:
        out["cams"] = _null_cams_like(out["cams"], uncond_cam)
    if "rel_pos" in keys and "rel_pos" in out:
        v = out["rel_pos"]
        v = v[..., :-1, :] if v.shape[-2] == 4 else v
        out["rel_pos"] = _null_cams_like(v, uncond_rel_pos)
    if "maps" in keys and "maps" in out:
        out["maps"] = torch.zeros_like(out["maps"])
    return out


def concat_6_views(imgs):
    """(6, C, T, H, W) -> (C, T, 2H, 3W), views 0-2 on top; numpy arrays or
    tensors."""
    assert imgs.shape[0] == 6
    cat = torch.cat if isinstance(imgs, torch.Tensor) else np.concatenate
    return cat([cat([imgs[0], imgs[1], imgs[2]], -1),
                cat([imgs[3], imgs[4], imgs[5]], -1)], -2)


def to_uint8_video(x) -> np.ndarray:
    """(C, T, H, W) float in [-1, 1] -> (T, H, W, C) uint8."""
    x = np.asarray(x.float().cpu() if isinstance(x, torch.Tensor) else x)
    x = (np.clip((x + 1) / 2, 0, 1) * 255).round().astype(np.uint8)
    return np.transpose(x, (1, 2, 3, 0))


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """An (H, W, 3) uint8 RGB image as an 8-bit PNG (no filter on any row)."""
    h, w, c = img.shape
    if img.dtype != np.uint8 or c != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {img.dtype} {img.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), PNG_LEVEL)))
        f.write(_png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 image of a PNG that ``write_png`` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if (depth, color) != (8, 2):
                raise ValueError(f"{path}: only 8-bit RGB is read, got {depth}, {color}")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only unfiltered rows are read")
    return rows[:, 1:].reshape(h, w, 3)


def save_sample(x, save_path: str, force_image: bool = False) -> str:
    """Save (C, T, H, W) in [-1, 1]: one frame as ``save_path.png``, more (or any
    number with ``force_image``) as ``save_path/NNNN.png``. Returns the path
    written."""
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    vid = to_uint8_video(x)
    if vid.shape[0] == 1 and not force_image:
        write_png(save_path + ".png", vid[0])
        return save_path + ".png"
    os.makedirs(save_path, exist_ok=True)
    # frames in parallel: zlib releases the GIL while it compresses
    with ThreadPoolExecutor(min(8, len(vid))) as pool:
        list(pool.map(lambda i: write_png(os.path.join(save_path, f"{i:04d}.png"), vid[i]),
                      range(len(vid))))
    return save_path
