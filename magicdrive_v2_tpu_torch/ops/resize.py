"""Antialiased linear resize, the arithmetic of ``jax.image.resize(x, shape,
"linear" | "trilinear")`` (antialias on, its default), as a plain PyTorch
function.

Every axis whose size changes gets a dense (in, out) weight matrix of the
triangle kernel, widened by 1/scale when the axis shrinks (a low-pass filter
before sampling); the matrices are applied one axis after the other.
``F.interpolate(mode="trilinear")`` samples without widening the kernel and
disagrees whenever an axis shrinks by more than 2.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["linear_resize_weights", "resize_linear_antialiased"]

_EPS32 = float(torch.finfo(torch.float32).eps)


def linear_resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of one axis: output sample j sits at
    input coordinate (j + 0.5) / scale - 0.5; each input i weighs
    max(0, 1 - |i - that| / max(1 / scale, 1)), the column normalised to sum 1
    (0 where it sums to ~0), and 0 for a sample outside the input."""
    f32 = dict(dtype=torch.float32, device=device)
    scale = torch.tensor(out_size / in_size, **f32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, **f32)[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _EPS32,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_linear_antialiased(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x`` resized to ``shape`` (same rank) in ``x``'s floating dtype: the
    weights are computed in fp32 and cast to that dtype, as JAX does."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} must have the rank of x {tuple(x.shape)}")
    if not x.is_floating_point():
        x = x.float()
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = linear_resize_weights(n_in, n_out, x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
