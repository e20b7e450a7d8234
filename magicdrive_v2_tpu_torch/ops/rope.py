"""Rotary position embedding with *interleaved* pair rotation.

Counterpart of the JAX package's ops/rope.py: theta 10000, one frequency per
even channel index, each repeated twice, positions ``arange(n)`` along the
sequence axis (-2).
"""
from __future__ import annotations

from typing import Optional

import torch


def rope_frequencies(dim: int, n: int, theta: float = 10000.0,
                     positions: Optional[torch.Tensor] = None,
                     device=None) -> torch.Tensor:
    """Per-position angles, shape (n, dim), each frequency repeated twice."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=device) / dim))
    if positions is None:
        positions = torch.arange(n, dtype=torch.float32, device=device)
    angles = torch.einsum("n,d->nd", positions.to(torch.float32), freqs)
    return torch.repeat_interleave(angles, 2, dim=-1)


def rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor] = None,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate the last dim of x over its sequence axis (-2). x: (..., N, D)."""
    n, d = x.shape[-2], x.shape[-1]
    angles = rope_frequencies(d, n, theta, positions, device=x.device)
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    return x * cos + rotate_half_interleaved(x) * sin
