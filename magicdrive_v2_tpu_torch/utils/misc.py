"""Small shared helpers."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


def torch_randn(shape, seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The reference's ``torch.manual_seed(s); torch.randn(shape)`` latent draw:
    always the CPU generator, so the starting latent does not depend on the
    device the model runs on (and equals the JAX package's at a matched seed)."""
    if generator is None:
        generator = torch.Generator()
        if seed is not None:
            generator.manual_seed(int(seed))
    return torch.randn(*shape, generator=generator)


def randn_rows(shape, generator: Optional[torch.Generator], rows=(1, 0), *,
               dtype=None, device=None) -> torch.Tensor:
    """``torch.randn(shape)`` from ``generator`` (on its device; without one, the
    global generator on ``device``) as data-parallel rank ``rank`` of ``rows``
    (dp, rank) draws it: dp such tensors drawn stacked along the first dim, and the
    rank's part kept, so the ranks' parts in rank order are one process's draw."""
    dp, rank = rows
    n = shape[0]
    out = torch.randn((dp * n,) + tuple(shape[1:]), generator=generator, dtype=dtype,
                      device=generator.device if generator is not None else device)
    return out[rank * n:(rank + 1) * n]


def torch_randn_stream(seed: int) -> Callable:
    """The reference's seed contract for one sample: ``torch.manual_seed(s)``
    followed by several ``torch.randn`` calls (z first, then the box latents), as
    ``draw(shape) -> tensor`` on one CPU generator."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return lambda shape: torch_randn(shape, generator=gen)


def add_box_latent(bboxes: Dict, b: int, nc: int, t: int, sample_fn: Callable) -> Dict:
    """Attach per-instance latents shared across views and time: ``sample_fn(n)``
    draws (n, D) for the b*n_boxes instances, broadcast to (b*nc, t, n_boxes, D)."""
    n_boxes = bboxes["bboxes"].shape[-3]
    latent = np.asarray(sample_fn(b * n_boxes)).reshape(b, 1, 1, n_boxes, -1)
    latent = np.broadcast_to(latent, (b, nc, t, n_boxes, latent.shape[-1]))
    bboxes = dict(bboxes)
    bboxes["box_latent"] = latent.reshape(b * nc, t, n_boxes, -1)
    return bboxes


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default everywhere)
    raises when no card is present; nothing falls back to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return device


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """A tensor or array-like on ``device``, its dtype kept unless ``dtype`` is given
    (a numpy array that is read-only or not C-contiguous is copied first)."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if not (x.flags.writeable and x.flags.c_contiguous):
            x = np.array(x, order="C")
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=dtype)


def to_host(x) -> np.ndarray:
    """A tensor or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_device(v, device):
    """numpy arrays and tensors, in nested dicts too, onto ``device``; other values
    as they are."""
    if isinstance(v, dict):
        return {k: to_device(x, device) for k, x in v.items()}
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return to_tensor(v, device)
    return v


def collate_bboxes_to_maxlen(bbox_list, max_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pad per-sample bbox dicts (bboxes (T, L, 8, 3), classes (T, L), masks (T, L),
    optional box_latent (T, L, D)) to a common box count and stack them. Masks
    keep the 3-state convention 0 = null/padding, 1 = keep, -1 = visible-masked."""
    if max_len is None:
        max_len = max(int(b["bboxes"].shape[1]) for b in bbox_list)
    out = {"bboxes": [], "classes": [], "masks": []}
    for b in bbox_list:
        pad = max_len - b["bboxes"].shape[1]
        out["bboxes"].append(np.pad(b["bboxes"], ((0, 0), (0, pad), (0, 0), (0, 0))))
        out["classes"].append(np.pad(b["classes"], ((0, 0), (0, pad)), constant_values=0))
        out["masks"].append(np.pad(b["masks"], ((0, 0), (0, pad)), constant_values=0))
        if b.get("box_latent") is not None:
            out.setdefault("box_latent", []).append(
                np.pad(b["box_latent"], ((0, 0), (0, pad), (0, 0))))
    if "box_latent" in out and len(out["box_latent"]) != len(bbox_list):
        raise ValueError(f"box_latent present on {len(out['box_latent'])} of "
                         f"{len(bbox_list)} items: all or none must carry it")
    return {k: np.stack(v) for k, v in out.items()}
