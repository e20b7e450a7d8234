"""Fused adaLN-modulate for Hopper: LayerNorm (fp32 statistics, no affine) and
``x_hat * (1 + scale) + shift`` in one pass over a (B, N, C) tensor.

Counterpart of the JAX package's ops/fused_adaln.py (Pallas ``_kernel``). The
kernel is ``csrc/adaln_modulate.cu``. On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version. Where autograd
records (grad enabled, an input requires grad) the launch goes through
``kernel_vjp.KernelFunction``, whose backward is the second kernel of
``csrc/adaln_modulate.cu``, ``adaln_bwd_ring``, one launch on the grid of
``plan_adaln_backward`` (the JAX trainer differentiates the plain composition,
``_xla_fallback``, which XLA fuses). ``adaln_modulate_backward_plain`` is its plain
version, ``adaln_modulate_backward_blocked_plain`` the same with the column sums
added in the kernel's order.
"""
from __future__ import annotations

import ctypes
import functools

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


def adaln_modulate_backward_plain(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                                  dout: torch.Tensor, eps: float = 1e-6):
    """The backward kernel's formulation in plain PyTorch, fp32: (dx, dshift,
    dscale) in the inputs' dtypes; dx = rstd (g' - mean(g') - x_hat mean(g'
    x_hat)), g' = dout (1 + scale), dshift = sum_n dout, dscale = sum_n dout x_hat."""
    x32, g = x.float(), dout.float()
    xh, rstd = _normed(x32, eps)
    gp = g * (1.0 + scale.float()[:, None])
    dx = rstd * (gp - gp.mean(dim=-1, keepdim=True)
                 - xh * (gp * xh).mean(dim=-1, keepdim=True))
    return (dx.to(x.dtype), g.sum(dim=1).to(shift.dtype), (g * xh).sum(dim=1).to(scale.dtype))


def _normed(x32: torch.Tensor, eps: float):
    """x_hat and rstd of fp32 rows."""
    mean = x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mean).square().mean(dim=-1, keepdim=True) + eps)
    return (x32 - mean) * rstd, rstd


# the backward block's shape, kRingWarps and kBlocksPerSm of csrc/adaln_modulate.cu
# (which the library reports, and ``_kernel`` checks at load): warps a block, and
# blocks an SM holds at once
BACKWARD_WARPS = 4
BLOCKS_PER_SM = 3


def plan_adaln_backward(B: int, N: int, C: int, sm_count: int):
    """The backward's grid for x of (B, N, C) on a card of ``sm_count`` SMs:
    (rows_per_block, blocks_per_batch). One wave of ``BLOCKS_PER_SM`` blocks an SM,
    shared out over the B batches (at least one block a batch, at most one a row);
    block k of batch b takes rows k * rows_per_block up to the next block's (the
    last of a batch fewer, none empty). C does not change the plan; it is checked
    with the others."""
    if min(B, N, C, sm_count) < 1 or C > MAX_C:
        raise ValueError(f"no backward plan for B={B} N={N} C={C} on {sm_count} SMs")
    blocks = min(max(BLOCKS_PER_SM * sm_count // B, 1), N)
    rows = -(-N // blocks)
    return rows, -(-N // rows)


def adaln_modulate_backward_blocked_plain(x: torch.Tensor, shift: torch.Tensor,
                                          scale: torch.Tensor, dout: torch.Tensor,
                                          plan, eps: float = 1e-6):
    """``adaln_modulate_backward_plain`` with dshift and dscale added as the kernel
    adds them under ``plan`` (rows_per_block, blocks_per_batch), in fp32: each of a
    block's BACKWARD_WARPS warps adds its rows (n0 + w, n0 + w + BACKWARD_WARPS,
    ...) one at a time, the block adds its warps in order, the batch its blocks in
    order."""
    rows, blocks = plan
    B, N, C = x.shape
    W = BACKWARD_WARPS
    dx = adaln_modulate_backward_plain(x, shift, scale, dout, eps)[0]
    g = dout.float()
    terms = torch.stack([g, g * _normed(x.float(), eps)[0]], dim=2)  # (B, N, 2, C)
    steps = -(-rows // W)
    padded = terms.new_zeros(B, blocks * rows, 2, C)
    padded[:, :N] = terms
    padded = padded.view(B, blocks, rows, 2, C)
    by_warp = terms.new_zeros(B, blocks, steps * W, 2, C)
    by_warp[:, :, :rows] = padded
    by_warp = by_warp.view(B, blocks, steps, W, 2, C)
    warp_sums = terms.new_zeros(B, blocks, W, 2, C)
    for j in range(steps):  # a warp's rows, one at a time
        warp_sums += by_warp[:, :, j]
    block_sums = terms.new_zeros(B, blocks, 2, C)
    for w in range(W):
        block_sums += warp_sums[:, :, w]
    total = terms.new_zeros(B, 2, C)
    for k in range(blocks):
        total += block_sums[:, k]
    return dx, total[:, 0].to(shift.dtype), total[:, 1].to(scale.dtype)


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
        bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        for fn in (fwd, bwd):
            fn.restype = ctypes.c_int
        warps, per_sm = ctypes.c_int(), ctypes.c_int()
        lib.mdv2_adaln_backward_shape(ctypes.byref(warps), ctypes.byref(per_sm))
        if (warps.value, per_sm.value) != (BACKWARD_WARPS, BLOCKS_PER_SM):
            raise RuntimeError(
                f"adaln_modulate: the backward kernel's blocks are {warps.value} warps, "
                f"{per_sm.value} an SM; the plan assumes {BACKWARD_WARPS}, {BLOCKS_PER_SM}")
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
    check_width(C, x.dtype)
    if needs_grad(x, shift, scale):
        return KernelFunction.apply(_forward, _backward, "adaln_modulate", x, shift, scale, eps)
    return _launch(x, shift, scale, eps)


def check_width(C: int, dtype) -> None:
    """Raises on a row width the kernels refuse: more than ``MAX_C`` elements, or
    not a whole number of 16-byte chunks."""
    if C > MAX_C or (C * dtype.itemsize) % 16:
        raise ValueError(f"adaln_modulate: the kernel takes rows of at most {MAX_C} "
                         f"elements in whole 16-byte chunks, got C={C} {dtype}")


def _forward(x, shift, scale, eps):
    """The launch under autograd; the backward recomputes the row statistics and
    reads no output."""
    return _launch(x, shift, scale, eps), ()


def _backward(args, saved, grad):
    """The backward kernel on the saved inputs: (dx, dshift, dscale, None)."""
    x, shift, scale, eps = args
    B, N, C = x.shape
    code = _cuda_build.dtype_code(x.dtype)
    x, scale, grad = x.contiguous(), scale.contiguous(), grad.contiguous()
    if grad.data_ptr() % 16:
        grad = grad.clone()
    rows, blocks = plan_adaln_backward(B, N, C, _sm_count(x.device))
    dx = torch.empty_like(x)
    dshift, dscale = torch.empty((2, B, C), dtype=x.dtype, device=x.device)
    part = torch.empty(B * blocks * 2 * C, dtype=torch.float32, device=x.device)
    with _cuda_build.on_device(x) as stream:
        count = _backward_counters(x.device, stream, B)
        err = _kernel()[1](x.data_ptr(), scale.data_ptr(), grad.data_ptr(), dx.data_ptr(),
                           dshift.data_ptr(), dscale.data_ptr(), part.data_ptr(),
                           count.data_ptr(), B, N, C, rows, blocks, float(eps), code, stream)
    _cuda_build.check(err, "adaln_modulate (backward)")
    adaln_modulate.backward_launches += 1
    return dx, dshift, dscale, None


H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The SMs of ``device``'s card; an H100's for a CPU tensor, which reaches here
    only where a test stands in for the C entry
    (``tests/test_torch_ops.py::test_every_launch_runs_under_the_device_guard``)."""
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


_counters = {}  # (device, stream handle) -> the backward's counters


def _backward_counters(device, stream: int, B: int) -> torch.Tensor:
    """At least B of the backward's counters (one a batch), kept for each device and
    stream and zeroed once: the last block of a batch sets its own back to zero,
    and the launches that share them run in order on their stream."""
    count = _counters.get((device, stream))
    if count is None or count.numel() < B:
        count = _counters[(device, stream)] = torch.zeros(B, dtype=torch.int32,
                                                          device=device)
    return count


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
