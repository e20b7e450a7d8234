"""Fused adaLN-modulate for Hopper: LayerNorm (fp32 statistics, no affine) and
``x_hat * (1 + scale) + shift`` in one pass over a (B, N, C) tensor.

Counterpart of the JAX package's ops/fused_adaln.py (Pallas ``_kernel``). The
kernel is ``csrc/adaln_modulate.cu``. On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version. Where autograd
records (grad enabled, an input requires grad) the launch goes through
``kernel_vjp.KernelFunction``, whose backward is the second kernel of
``csrc/adaln_modulate.cu`` (the JAX trainer differentiates the plain composition,
``_xla_fallback``, which XLA fuses); ``adaln_modulate_backward_plain`` is its
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .kernel_vjp import KernelFunction, needs_grad

MAX_C = 1280  # 32 lanes x kMaxFloatsPerLane of csrc/adaln_modulate.cu
_fn = None


def adaln_modulate_plain(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """x: (B, N, C); shift/scale: (B, C). All arithmetic in fp32, one rounding."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    out = normed * (1.0 + scale.float()[:, None]) + shift.float()[:, None]
    return out.to(x.dtype)


ROWS_PER_BLOCK = 64  # kBwdRows of csrc/adaln_modulate.cu: rows of a backward block


def adaln_modulate_backward_plain(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                                  dout: torch.Tensor, eps: float = 1e-6):
    """The backward kernel's formulation in plain PyTorch, fp32: (dx, dshift,
    dscale) in the inputs' dtypes; dx = rstd (g' - mean(g') - x_hat mean(g'
    x_hat)), g' = dout (1 + scale), dshift = sum_n dout, dscale = sum_n dout x_hat."""
    x32, g = x.float(), dout.float()
    mean = x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mean).square().mean(dim=-1, keepdim=True) + eps)
    xh = (x32 - mean) * rstd
    gp = g * (1.0 + scale.float()[:, None])
    dx = rstd * (gp - gp.mean(dim=-1, keepdim=True)
                 - xh * (gp * xh).mean(dim=-1, keepdim=True))
    return (dx.to(x.dtype), g.sum(dim=1).to(shift.dtype), (g * xh).sum(dim=1).to(scale.dtype))


def forward_plain(x, shift, scale, eps):
    """``KernelFunction``'s forward with the plain version (CPU tests)."""
    return adaln_modulate_plain(x, shift, scale, eps), ()


def backward_plain(args, saved, grad):
    """``KernelFunction``'s backward with the plain version (CPU tests)."""
    x, shift, scale, eps = args
    return (*adaln_modulate_backward_plain(x, shift, scale, grad, eps), None)


def _kernel():
    global _fn
    if _fn is None:
        lib = _cuda_build.load("adaln_modulate")
        fwd = lib.mdv2_adaln_modulate
        fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_float,
                                                ctypes.c_int, ctypes.c_void_p])
        bwd = lib.mdv2_adaln_modulate_backward
        bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        for fn in (fwd, bwd):
            fn.restype = ctypes.c_int
        _fn = (fwd, bwd)
    return _fn


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x: (B, N, C); shift/scale: (B, C) or (B, 1, C), of x's dtype. On the card
    C must be at most 1280 and a whole number of 16-byte chunks."""
    if shift.ndim == 3:
        shift = shift[:, 0]
    if scale.ndim == 3:
        scale = scale[:, 0]
    if x.ndim != 3:
        raise ValueError(f"expected x of shape (B, N, C), got {tuple(x.shape)}")
    B, N, C = x.shape
    if shift.shape != (B, C) or scale.shape != (B, C):
        raise ValueError(f"shift {tuple(shift.shape)} / scale {tuple(scale.shape)} "
                         f"must be ({B}, {C})")
    if x.device.type == "cpu":
        return adaln_modulate_plain(x, shift, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"adaln_modulate runs on cuda or cpu tensors, got {x.device}")
    if not (shift.device == x.device and scale.device == x.device):
        raise ValueError("x, shift and scale lie on different devices")
    _cuda_build.dtype_code(x.dtype)  # raises on a type the kernel does not take
    if shift.dtype != x.dtype or scale.dtype != x.dtype:
        raise TypeError(f"shift/scale must have x's dtype {x.dtype}, got "
                        f"{shift.dtype} / {scale.dtype}")
    if C > MAX_C or (C * x.element_size()) % 16:
        raise ValueError(f"adaln_modulate: the kernel takes rows of at most {MAX_C} "
                         f"elements in whole 16-byte chunks, got C={C} {x.dtype}")
    if needs_grad(x, shift, scale):
        return KernelFunction.apply(_forward, _backward, "adaln_modulate", x, shift, scale, eps)
    return _launch(x, shift, scale, eps)


def _forward(x, shift, scale, eps):
    """The launch under autograd; the backward recomputes the row statistics and
    reads no output."""
    return _launch(x, shift, scale, eps), ()


def _backward(args, saved, grad):
    """The backward kernels on the saved inputs: (dx, dshift, dscale, None)."""
    x, shift, scale, eps = args
    B, N, C = x.shape
    code = _cuda_build.dtype_code(x.dtype)
    x, scale, grad = x.contiguous(), scale.contiguous(), grad.contiguous()
    if grad.data_ptr() % 16:
        grad = grad.clone()
    dx = torch.empty_like(x)
    dshift = torch.empty((B, C), dtype=shift.dtype, device=x.device)
    dscale = torch.empty((B, C), dtype=scale.dtype, device=x.device)
    part = torch.empty((B, -(-N // ROWS_PER_BLOCK), 2, C), dtype=torch.float32,
                       device=x.device)
    with _cuda_build.on_device(x) as stream:
        err = _kernel()[1](x.data_ptr(), scale.data_ptr(), grad.data_ptr(), dx.data_ptr(),
                           dshift.data_ptr(), dscale.data_ptr(), part.data_ptr(), B, N, C,
                           float(eps), code, stream)
    _cuda_build.check(err, "adaln_modulate (backward)")
    adaln_modulate.backward_launches += 1
    return dx, dshift, dscale, None


def _launch(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
            eps: float) -> torch.Tensor:
    """One launch of the kernel on tensors the wrapper has checked."""
    B, N, C = x.shape
    code = _cuda_build.dtype_code(x.dtype)
    x, shift, scale = x.contiguous(), shift.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    with _cuda_build.on_device(x) as stream:
        err = _kernel()[0](x.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), B * N, N, C, float(eps), code, stream)
    _cuda_build.check(err, "adaln_modulate")
    adaln_modulate.launches += 1
    return out


adaln_modulate.launches = 0
adaln_modulate.backward_launches = 0
