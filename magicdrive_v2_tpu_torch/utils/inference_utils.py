"""Inference helpers: null conditions for classifier-free guidance."""
from __future__ import annotations

from typing import Dict, Sequence

import torch


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
