"""Backward of the kernel wrappers: the grads of a kernel's plain version,
recomputed from the saved inputs.

Counterpart of the JAX package's ``custom_vjp`` backwards (``_bwd`` of
ops/flash_fused.py, ``_fa_bwd`` of ops/flash_attention.py), which differentiate
the XLA composition of the same function. The forward on the card stays the
hand-written kernel; only its backward runs the plain PyTorch version, under
``torch.enable_grad()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

# backwards run, by kernel name (each a recompute through the plain version: no launch)
backward_calls: Dict[str, int] = {}


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd records: grad enabled and an input requires grad. Only
    then does a wrapper go through ``PlainVJPFunction``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class PlainVJPFunction(torch.autograd.Function):
    """``apply(forward_fn, plain_fn, name, *args)``: the output of
    ``forward_fn(*args)`` (the kernel on the card; a CPU test hands in the plain
    version), with the grads of ``plain_fn(*args)`` recomputed from the saved
    inputs. The tensor arguments are saved and get grads; the others (None,
    numbers, index lists) are kept as they are. Grads of views (k and v of one
    projection) go back through those views. ``backward_calls[name]`` counts the
    backwards. A ``plain_fn`` with a ``backward_group_step(*args)`` that names a
    number of groups recomputes that many groups (dim 0 of its output) a pass,
    ``plain_fn(*args, groups=(g0, g1))``, and sums the passes' grads."""

    @staticmethod
    def forward(ctx, forward_fn: Callable, plain_fn: Callable, name: str, *args):
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        ctx.args = [None if i in ctx.tensor_at else a for i, a in enumerate(args)]
        ctx.plain_fn, ctx.name = plain_fn, name
        return forward_fn(*args)

    @staticmethod
    def backward(ctx, grad):
        backward_calls[ctx.name] = backward_calls.get(ctx.name, 0) + 1
        args = list(ctx.args)
        needs = [ctx.needs_input_grad[3 + i] for i in ctx.tensor_at]
        for i, t, n in zip(ctx.tensor_at, ctx.saved_tensors, needs):
            args[i] = t.detach().requires_grad_(n)
        wanted = [i for i, n in zip(ctx.tensor_at, needs) if n]
        step_fn = getattr(ctx.plain_fn, "backward_group_step", None)
        step = step_fn(*args) if step_fn is not None else None
        inputs = [args[i] for i in wanted]
        with torch.enable_grad():
            if step is None:
                out = ctx.plain_fn(*args)
                grads = torch.autograd.grad(out, inputs, grad, allow_unused=True)
            else:
                grads = [None] * len(inputs)
                for g0 in range(0, grad.shape[0], step):
                    g1 = min(g0 + step, grad.shape[0])
                    out = ctx.plain_fn(*args, groups=(g0, g1))
                    part = torch.autograd.grad(out, inputs, grad[g0:g1], allow_unused=True)
                    grads = [p if g is None else g if p is None else g + p
                             for g, p in zip(grads, part)]
        result = [None] * (3 + len(args))
        for i, g in zip(wanted, grads):
            result[3 + i] = g
        return tuple(result)
