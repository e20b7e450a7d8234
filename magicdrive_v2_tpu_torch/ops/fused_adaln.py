"""Fused adaLN-modulate for Hopper: LayerNorm (fp32 statistics, no affine) and
``x_hat * (1 + scale) + shift`` in one pass over a (B, N, C) tensor.

Counterpart of the JAX package's ops/fused_adaln.py (Pallas ``_kernel``). The
kernel is ``csrc/adaln_modulate.cu``. On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version. Where autograd
records (grad enabled, an input requires grad) the launch goes through
``plain_vjp.PlainVJPFunction``, whose backward is the plain version's, recomputed: the
JAX trainer differentiates the plain composition (``_xla_fallback``) too.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .plain_vjp import PlainVJPFunction, needs_grad

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


def _kernel():
    global _fn
    if _fn is None:
        fn = _cuda_build.load("adaln_modulate").mdv2_adaln_modulate
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
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
        return PlainVJPFunction.apply(_launch, adaln_modulate_plain, "adaln_modulate",
                                      x, shift, scale, eps)
    return _launch(x, shift, scale, eps)


def _launch(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
            eps: float) -> torch.Tensor:
    """One launch of the kernel on tensors the wrapper has checked."""
    B, N, C = x.shape
    code = _cuda_build.dtype_code(x.dtype)
    x, shift, scale = x.contiguous(), shift.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    with _cuda_build.on_device(x) as stream:
        err = _kernel()(x.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), B * N, N, C, float(eps), code, stream)
    _cuda_build.check(err, "adaln_modulate")
    adaln_modulate.launches += 1
    return out


adaln_modulate.launches = 0
