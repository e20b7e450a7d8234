"""The autograd Function of the kernel wrappers: a hand-written kernel forward
and backward.

Counterpart of the JAX package's ``custom_vjp`` backwards (``_bwd`` of
ops/flash_fused.py, ``_fa_bwd`` of ops/flash_attention.py), which are
``jax.vjp`` of the XLA composition of the same function, compiled and fused by
XLA on a TPU; the JAX trainer differentiates K2's composition directly. On the
card the port runs a backward kernel in their place (``csrc/attn_bwd_sm90.cuh``
for K1 and K3, ``csrc/adaln_modulate.cu`` for K2), from what the forward kernel
saved; a CPU test hands in the plain versions of both.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

# backwards run, by kernel name (one a call of the Function's backward, whatever
# ``backward_fn`` is); each wrapper counts its backward kernels' launches apart,
# as ``<wrapper>.backward_launches``
backward_calls: Dict[str, int] = {}


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd records: grad enabled and an input requires grad. Only
    then does a wrapper go through ``KernelFunction``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class KernelFunction(torch.autograd.Function):
    """``apply(forward_fn, backward_fn, name, *args)``: the output of
    ``forward_fn(*args) -> (out, saved)``, where ``saved`` is a tuple of tensors
    the backward needs beside the inputs (the output itself where the backward
    reads it, the row log-sum-exp): a Function that kept its output regardless
    would hold it where no other op does (K2's, under a frame mask's
    ``torch.where``); its grads are ``backward_fn(args, saved, grad)``, one grad
    or None per argument. The tensor arguments are saved; the others (None,
    numbers, index lists) are kept as they are. Grads of views (k and v of one
    projection) go back through those views. ``backward_calls[name]`` counts the
    backwards."""

    @staticmethod
    def forward(ctx, forward_fn: Callable, backward_fn: Callable, name: str, *args):
        out, saved = forward_fn(*args)
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at), *saved)
        ctx.args = [None if i in ctx.tensor_at else a for i, a in enumerate(args)]
        ctx.backward_fn, ctx.name = backward_fn, name
        return out

    @staticmethod
    def backward(ctx, grad):
        backward_calls[ctx.name] = backward_calls.get(ctx.name, 0) + 1
        tensors = ctx.saved_tensors
        n = len(ctx.tensor_at)
        args = list(ctx.args)
        for i, t in zip(ctx.tensor_at, tensors[:n]):
            args[i] = t
        grads = ctx.backward_fn(args, tuple(tensors[n:]), grad)
        return (None, None, None) + tuple(
            g if ctx.needs_input_grad[3 + i] else None for i, g in enumerate(grads))
