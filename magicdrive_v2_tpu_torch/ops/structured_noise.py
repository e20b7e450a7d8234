"""Phase-preserving structured noise for the SDE-BrushNet inpaint branch
(counterpart of the JAX package's ops/structured_noise.py).

Gaussian-statistics noise whose LOW spatial frequencies carry the phase of a
guidance image while the HIGH frequencies stay pure noise, a smooth radial
low-pass blend in 2-D FFT space:

  out_hat(f) = M(|f|) * x_phase(f) * |n_hat(f)| + (1 - M(|f|)) * n_hat(f)

with ``M`` a sigmoid of ``cutoff_radius`` and ``transition_width`` in
frequency-pixel units; the result is re-standardised per (..., H, W) slice.
The FFTs are ``torch.fft`` (cuFFT on the card: a library call, not a kernel
of the port). The input noise is passed in or drawn from an explicit
``torch.Generator``, never from a global stream.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["generate_structured_noise", "sample_cutoff_radius"]


def _radial_mask(h: int, w: int, cutoff_radius, transition_width: float,
                 device=None) -> torch.Tensor:
    """(h, w) fp32 low-pass mask: 1 inside the cutoff, 0 outside, a sigmoid
    between."""
    fy = torch.fft.fftfreq(h, device=device) * h
    fx = torch.fft.fftfreq(w, device=device) * w
    r = torch.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    return torch.sigmoid((cutoff_radius - r) / max(transition_width, 1e-6) * 4.0)


def generate_structured_noise(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                              cutoff_radius=4.0, transition_width: float = 2.0,
                              input_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., H, W) structure guidance. Returns fp32 noise of x's shape whose
    low-frequency phase follows x. ``input_noise`` (the standard normal draw
    the blend starts from) is drawn from ``generator`` when not given."""
    if input_noise is None:
        if generator is None:
            raise ValueError("generate_structured_noise needs a generator or input_noise")
        input_noise = torch.randn(x.shape, generator=generator, device=generator.device)
    input_noise = input_noise.to(x.device, torch.float32).reshape(x.shape)
    h, w = x.shape[-2], x.shape[-1]
    mask = _radial_mask(h, w, cutoff_radius, transition_width, x.device)

    x_hat = torch.fft.fft2(x.float())
    n_hat = torch.fft.fft2(input_noise)
    x_phase = x_hat / (x_hat.abs() + 1e-8)
    blended = mask * x_phase * n_hat.abs() + (1.0 - mask) * n_hat
    out = torch.fft.ifft2(blended).real
    # per slice to zero mean and unit population std (ddof 0, as jnp.std)
    mean = out.mean(dim=(-2, -1), keepdim=True)
    std = out.std(dim=(-2, -1), keepdim=True, correction=0)
    return (out - mean) / (std + 1e-8)


def sample_cutoff_radius(generator: Optional[torch.Generator], r0: float = 4.0,
                         lam: float = 0.1) -> torch.Tensor:
    """Training-time jitter of the cutoff: r = r0 + Exp(lam), by inverting a
    uniform draw on [1e-8, 1) from ``generator``."""
    gdev = generator.device if generator is not None else "cpu"
    u = torch.rand((), generator=generator, device=gdev) * (1.0 - 1e-8) + 1e-8
    return r0 + (-torch.log(u) / lam)
