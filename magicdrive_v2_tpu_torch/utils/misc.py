"""Small shared helpers."""
from __future__ import annotations

from typing import Optional

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


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default everywhere)
    raises when no card is present; nothing falls back to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return device
