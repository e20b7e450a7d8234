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


def to_device(v, device):
    """numpy arrays and tensors, in nested dicts too, onto ``device``; other values
    as they are."""
    if isinstance(v, dict):
        return {k: to_device(x, device) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(v)
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return v
