"""Flash attention for Hopper: generic BNHD attention, separate q, k and v.

Counterpart of the JAX package's ops/flash_attention.py (Pallas ``_fa_kernel``).
The kernel is ``csrc/flash_attention.cu``; its device code is the online-softmax
core it shares with the fused-qkv kernel (``csrc/attn_core.cuh``). On a CUDA
tensor the wrapper launches the kernel or raises; on a CPU tensor it runs the
plain version. Inference only (no backward yet).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda_build
from .attention import plain_attention

_fn = None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch (fp32 softmax composition)."""
    return plain_attention(q, k, v, scale=scale)


def _kernel():
    global _fn
    if _fn is None:
        fn = _cuda_build.load("flash_attention").mdv2_flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D). k and v may be strided views
    (unit stride on the head dim); M may differ from N. On the card the head dim
    is at most 144 and, in bf16, a multiple of 8 with 16-byte aligned rows."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected BNHD tensors, got {q.shape} {k.shape} {v.shape}")
    B, N, H, D = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, D) or v.shape != (B, M, H, D):
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    code = _cuda_build.dtype_code(q.dtype)
    if D > _cuda_build.MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {_cuda_build.MAX_HEAD_DIM} is not supported "
                         "by the kernel")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16 and (D % 8 or any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]) for t in (q, k, v))):
        raise ValueError("the bf16 kernel takes head dims in multiples of 8 and q/k/v "
                         f"rows on 16-byte boundaries, got head_dim {D}, strides "
                         f"{q.stride()} {k.stride()} {v.stride()}")
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        B, N, M, H, D,
                        q.stride(0), q.stride(1), q.stride(2),
                        k.stride(0), k.stride(1), k.stride(2),
                        v.stride(0), v.stride(1), v.stride(2),
                        float(scale), code, stream)
    _cuda_build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
