"""Flash attention for Hopper: generic BNHD attention, separate q, k and v.

Counterpart of the JAX package's ops/flash_attention.py (Pallas ``_fa_kernel``).
The kernels are in ``csrc/flash_attention.cu``: in bf16 the wgmma bodies of
``csrc/attn_k3_sm90.cuh``, whose launch plan (``plan_bf16``) is computed here, in
Python, and handed to the C entry point; in fp32 the CUDA-core body of
``csrc/attn_core.cuh``. On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it runs the plain version. Where autograd records (grad
enabled, an input requires grad) the launch goes through
``kernel_vjp.KernelFunction``: the forward kernel also writes each row's
log-sum-exp, and the backward is the kernels of ``csrc/attn_bwd_sm90.cuh``, the
port's counterpart of the JAX ``_fa_bwd`` (jax.vjp of the XLA composition).
``flash_attention_backward_plain`` is that backward in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _cuda_build
from .attention import plain_attention
from .flash_fused import (BLOCK_RESERVED, BWD_WIDTH, Q_ROWS, SM_SHARED, TILE_ROWS,
                          plan_backward_bf16)
from .kernel_vjp import KernelFunction, needs_grad

_fns = None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch (fp32 softmax composition)."""
    return plain_attention(q, k, v, scale=scale)




def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                                   scale: float):
    """The backward kernel's formulation in plain PyTorch, fp32: P = exp(scale q
    k^T - lse), delta = rowsum(dO o O), dS = P o (dO v^T - delta); returns (dq,
    dk, dv) in the inputs' dtypes."""
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", q32, k32) * scale - lse[..., None])
    delta = (g32 * out.float()).sum(-1).permute(0, 2, 1)  # (B, H, N)
    ds = p * (torch.einsum("bnhd,bmhd->bhnm", g32, v32) - delta[..., None])
    if k.shape[1] == 1:  # one key: the softmax is constant, its grads exactly zero
        ds = torch.zeros_like(ds)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k32) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q32) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", p, g32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def forward_plain(q, k, v, scale):
    """``KernelFunction``'s forward with the plain version (CPU tests): (out,
    (out, lse)), lse (B, H, N) the natural log-sum-exp of the fp32 scaled
    logits, as the kernel saves it."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    out = flash_attention_plain(q, k, v, scale=scale)
    return out, (out, torch.logsumexp(logits, dim=-1))


def backward_plain(args, saved, grad):
    """``KernelFunction``'s backward with the plain version (CPU tests)."""
    q, k, v, scale = args
    return (*flash_attention_backward_plain(q, k, v, *saved, grad, scale), None)


# ---------------------------------------------------------------- bf16 launch plan

STAGES = 3              # depth of the streaming kernel's k/v ring (kStages)
# bf16 head dims the kernel takes -> (depth of the logit product, a multiple of 16:
# one tensor-core k-step; width of the value product and of the v tiles). q and k
# tiles keep the head dim itself; where it is an odd number of 8-column chunks the
# last k-step reads a zero chunk. 72 is the model's, 144 the condition embedders'
# (1152 / 8), 8 and 16 the tiny configurations'.
PADDED_WIDTH = {8: (16, 16), 16: (16, 16), 72: (80, 72), 144: (144, 144)}


class K3Plan(NamedTuple):
    dp: int             # depth of the logit product
    dv: int             # width of the value product
    resident: bool      # the whole k/v sequence in shared memory (else the ring)
    kv_tiles: int       # 64-row k/v tiles per (batch, head)
    q_tiles: int        # 128-row q tiles per (batch, head)
    run: int            # q tiles per block
    blocks: int         # B * H * ceil(q_tiles / run)
    smem_bytes: int     # dynamic shared memory of one block
    blocks_per_sm: int  # what the kernel is compiled for (its __launch_bounds__)


def _smem(D: int, dv: int, tiles: int) -> int:
    """Two q halves, `tiles` k and v tiles, the zero chunk (odd D / 8)."""
    return 2 * TILE_ROWS * (2 * D + tiles * (D + dv)) + (2 * TILE_ROWS * 8 if D // 8 % 2 else 0)


RUN = 6  # q tiles a block of the resident kernel takes, at most (see PERF.md)


def default_run(q_tiles: int) -> int:
    """q tiles per block of the resident kernel: the (batch, head)'s q tiles split
    into runs of at most ``RUN``, as evenly as they go."""
    runs = -(-q_tiles // RUN)
    return -(-q_tiles // runs)


def plan_bf16(B: int, N: int, M: int, H: int, D: int,
              run: Optional[int] = None) -> K3Plan:
    """Launch plan of the bf16 kernel for q (B, N, H, D) against k/v (B, M, H, D);
    ``run`` overrides the q tiles per block of the resident kernel. Raises on a
    head dim it does not take."""
    if D not in PADDED_WIDTH:
        raise ValueError(f"the bf16 kernel takes head dims {sorted(PADDED_WIDTH)}, got {D}")
    dp, dv = PADDED_WIDTH[D]
    kv_tiles = -(-M // TILE_ROWS)
    q_tiles = -(-N // Q_ROWS)
    per_sm = 2 if dv <= 72 else 1
    smem = _smem(D, dv, kv_tiles)
    resident = per_sm * (smem + BLOCK_RESERVED) <= SM_SHARED
    if resident:
        if run is None:
            run = default_run(q_tiles)
        run = max(1, min(run, q_tiles))
    else:
        if run not in (None, 1):
            raise ValueError(f"the streaming kernel takes one q tile a block, got run={run}")
        run, smem = 1, _smem(D, dv, STAGES)
    blocks = B * H * -(-q_tiles // run)
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"{blocks} blocks exceed the grid limit")
    return K3Plan(dp, dv, resident, kv_tiles, q_tiles, run, blocks, smem, per_sm)


def _kernels():
    global _fns
    if _fns is None:
        lib = _cuda_build.load("flash_attention")
        bf16 = lib.mdv2_k3_attention
        bf16.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_longlong] * 9
                         + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        f32 = lib.mdv2_flash_attention_f32
        f32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                        + [ctypes.c_longlong] * 9
                        + [ctypes.c_float, ctypes.c_void_p])
        bwd = lib.mdv2_k3_backward
        bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        for fn in (bf16, f32, bwd):
            fn.restype = ctypes.c_int
        _fns = (bf16, f32, bwd)
    return _fns


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2))


def attend_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                plan: K3Plan, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the bf16 kernel with the given plan, on tensors the wrapper
    has checked (``flash_attention`` calls it with ``plan_bf16``'s plan); with
    ``lse`` (B, H, N) fp32 it also writes the rows' log-sum-exp."""
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    with _cuda_build.on_device(q) as stream:
        err = _kernels()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            None if lse is None else lse.data_ptr(),
                            B, N, k.shape[1], H, D, *_strides(q, k, v), float(scale),
                            int(plan.resident), plan.run, plan.blocks, plan.smem_bytes, stream)
    _cuda_build.check(err, "flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D). k and v may be strided views
    (unit stride on the head dim); M may differ from N. On the card the head dim
    is at most 144 in fp32 and one of ``PADDED_WIDTH`` in bf16, with 16-byte
    aligned rows."""
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
    if needs_grad(q, k, v):
        return KernelFunction.apply(_forward, _backward, "flash_attention", q, k, v, scale)
    return _launch(q, k, v, scale)


def _forward(q, k, v, scale):
    """The launch under autograd: (out, (out, lse)); the projection after it
    keeps the same output, so saving it costs nothing."""
    B, N, H, _ = q.shape
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    out = _launch(q, k, v, scale, lse)
    return out, (out, lse)


def _backward(args, saved, grad):
    """The backward kernels on the saved inputs: (dq, dk, dv, None)."""
    q, k, v, scale = args
    out, lse = saved
    B, N, H, D = q.shape
    M = k.shape[1]
    code = _cuda_build.dtype_code(q.dtype)
    if (code == 0 and D not in PADDED_WIDTH) or D > _cuda_build.MAX_HEAD_DIM:
        raise ValueError(f"the backward kernel takes head dims {sorted(PADDED_WIDTH)} in "
                         f"bf16 and up to {_cuda_build.MAX_HEAD_DIM} in fp32, got {D}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    grad = grad.contiguous()
    if grad.data_ptr() % 16:
        grad = grad.clone()
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, M, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, M, H, D), dtype=v.dtype, device=q.device)
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    # bf16 at the Hopper body's head dims (72 on the model's path) takes its plan;
    # fp32 and bf16 at 144 the CUDA-core / mma.sync body
    plan = plan_backward_bf16(B, N, M, H, D) if code == 0 and D in BWD_WIDTH else None
    arrays = _cuda_build.backward_args(
        [q, k, v, grad, out, dq, dk, dv, lse, delta] + [None] * 10,
        [B, H, N, M, D, 1] + _cuda_build.bwd_strides(q, k, v, grad, out, dq, dk, dv)
        + ([0, 0] if plan is None else [plan.dq_smem, plan.dkdv_smem]),
        [float(scale), 0.0])
    with _cuda_build.on_device(q) as stream:
        err = _kernels()[2](*arrays, code, stream)
    _cuda_build.check(err, "flash_attention (backward)")
    flash_attention.backward_launches += 1
    return dq, dk, dv, None


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors the wrapper has checked; with
    ``lse`` it also writes the rows' log-sum-exp."""
    B, N, H, D = q.shape
    code = _cuda_build.dtype_code(q.dtype)
    if D > _cuda_build.MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {_cuda_build.MAX_HEAD_DIM} is not supported "
                         "by the kernel")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if code == 0:
        if D % 8 or any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
                        for t in (q, k, v)):
            raise ValueError("the bf16 kernel takes head dims in multiples of 8 and q/k/v "
                             f"rows on 16-byte boundaries, got head_dim {D}, strides "
                             f"{q.stride()} {k.stride()} {v.stride()}")
        out = attend_bf16(q, k, v, scale, plan_bf16(B, N, k.shape[1], H, D), lse)
    else:
        out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
        with _cuda_build.on_device(q) as stream:
            err = _kernels()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                None if lse is None else lse.data_ptr(), B, N, k.shape[1],
                                H, D, *_strides(q, k, v), float(scale), stream)
        _cuda_build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.backward_launches = 0
