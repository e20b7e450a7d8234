"""Data-parallel training with the fp32 state sharded over the dp axis of the
(dp, sp) mesh (counterpart of the JAX package's parallel/fsdp.py, where
``shard_params`` places the fp32 parameters with a ``NamedSharding`` and XLA
inserts the all-gathers of the forward and the reduce-scatters of the grads).

The port writes those collectives out, by hand rather than through
``torch.distributed.fsdp``: the trainer reads bf16 casts of the fp32 masters
through ``torch.func.functional_call`` (``stdit3.compute_params``), and the casts
must fall where one process casts. ``param_spec`` is the JAX package's rule: a
parameter of at least ``min_size`` elements is split into dp contiguous blocks
along its largest dim that dp divides; a smaller one is replicated.
``shard_for_training`` replaces each split parameter of a model by this rank's
block, in place, so the AdamW moments (built over the blocks) and an EMA copied
from the model follow the same sharding, and the EMA updates each block with no
collective. Each step:

- ``ParamSharding.compute_params``: every split parameter is cast to the
  compute dtype on its block and all-gathered over dp (``_GatherParam``); the
  whole model is gathered once a step, before the forward, and the remat
  recompute reads the same gathered tensors (no second gather);
- the backward of each gather casts the full grad to fp32, reduce-scatters it
  over dp and divides by dp: this rank's block of the mean over the dp rows,
  as soon as that parameter's grad is whole;
- ``reduce_replicated_grads``: the replicated parameters' grads, averaged over
  dp in flat buckets after the backward.

The collectives are ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on
the dp group, whatever its backend: NCCL, or gloo (ranks sharing one card, or the
CPU), which takes both on CUDA tensors too, staging them through the host; a
backend that refuses one raises.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.magicdrive.stdit3 import needs_cast
from .comm import _gather, all_reduce_grads

logger = logging.getLogger(__name__)

MIN_SHARD_SIZE = 2 ** 18  # the JAX package's: smaller parameters stay replicated


def param_spec(shape, dp: int, min_size: int = MIN_SHARD_SIZE) -> Optional[int]:
    """The dim of a parameter of ``shape`` split over dp ranks, or None (replicated):
    the largest dim that dp divides (the first of equal ones), for parameters of at
    least ``min_size`` elements (JAX ``parallel/fsdp.param_spec``)."""
    if dp <= 1 or int(np.prod(shape)) < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % dp == 0:
            return i
    return None


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``dim`` of the sum of ``x`` over the group."""
    inp = x.movedim(dim, 0).contiguous()
    out = inp.new_empty((inp.shape[0] // dist.get_world_size(group),) + tuple(inp.shape[1:]))
    dist.reduce_scatter_tensor(out, inp, group=group)
    return out.movedim(0, dim).contiguous()


def _block(x: torch.Tensor, dim: int, dp: int, rank: int) -> torch.Tensor:
    n = x.shape[dim] // dp
    return x.narrow(dim, rank * n, n)


class _GatherParam(torch.autograd.Function):
    """A split parameter as a forward reads it: this rank's block cast to ``dtype``
    (None: as it is), all-gathered over dp along ``dim``. Backward: the full grad
    in the block's dtype, reduce-scattered over dp and divided by dp."""

    @staticmethod
    def forward(ctx, block, dim, dtype, group):
        ctx.dim, ctx.group, ctx.block_dtype = dim, group, block.dtype
        return _gather(block if dtype is None else block.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, grad):
        g = _reduce_scatter(grad.to(ctx.block_dtype), ctx.dim, ctx.group)
        return g / dist.get_world_size(ctx.group), None, None, None


@dataclasses.dataclass(eq=False)
class ParamSharding:
    """Which parameter of one model is split over dp, and along which dim (None:
    replicated): ``dims`` and the full ``shapes`` by parameter name, the dp group,
    dp and this rank's place in it. Every model of the same architecture (the
    training model, its EMA) is split alike."""
    dims: Dict[str, Optional[int]]
    shapes: Dict[str, Tuple[int, ...]]
    group: object
    dp: int
    rank: int
    sp_rank: int = 0

    @property
    def sharded(self) -> Dict[str, int]:
        return {n: d for n, d in self.dims.items() if d is not None}

    def shard(self, module: torch.nn.Module) -> torch.nn.Module:
        """Replace each split parameter of ``module`` by this rank's block (a copy; the
        full tensor is freed), in place; requires_grad is kept."""
        for name, dim in self.sharded.items():
            owner, leaf = _owner(module, name)
            p = owner._parameters[leaf]
            if tuple(p.shape) != self.shapes[name]:
                raise ValueError(f"{name}: {tuple(p.shape)} is not the full "
                                 f"{self.shapes[name]}")
            owner._parameters[leaf] = torch.nn.Parameter(
                _block(p.detach(), dim, self.dp, self.rank).clone(),
                requires_grad=p.requires_grad)
        return module

    def compute_params(self, module: torch.nn.Module, dtype) -> Dict[str, torch.Tensor]:
        """``stdit3.compute_params`` of the sharded ``module``: every parameter whole,
        in the dtype a forward reads it (casts of the fp32 masters by
        ``needs_cast``), the split ones gathered over dp (``_GatherParam``), in the
        autograd graph down to the blocks."""
        out = {}
        for name, p in module.named_parameters():
            cast = dtype if needs_cast(name, p, dtype) else None
            dim = self.dims[name]
            if dim is None:
                out[name] = p if cast is None else p.to(cast)
            else:
                out[name] = _GatherParam.apply(p, dim, cast, self.group)
        return out

    def reduce_replicated_grads(self, params: Iterable[Tuple[str, torch.Tensor]]) -> int:
        """Average the grads of the replicated parameters among ``params`` (name,
        tensor) over dp, in place, in flat buckets; returns the number of
        all-reduces."""
        grads = [p.grad for name, p in params if self.dims[name] is None and p.grad is not None]
        for g in grads:
            g.div_(self.dp)
        return all_reduce_grads(grads, self.group)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's block for parameter
        ``name`` (a moment, an EMA entry, the parameter), all-gathered over dp: a
        collective of the dp group. Replicated entries come back as they are."""
        dim = self.dims.get(name)
        return t.detach() if dim is None else _gather(t.detach(), dim, self.group)

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``full`` of parameter ``name``
        (itself when the parameter is replicated, or for names that are no
        parameter: buffers)."""
        dim = self.dims.get(name)
        if dim is None:
            return full
        if tuple(full.shape) != self.shapes[name]:
            raise ValueError(f"{name}: {tuple(full.shape)} is not the full "
                             f"{self.shapes[name]}")
        return _block(full, dim, self.dp, self.rank).clone()

    def full_state_dict(self, module: torch.nn.Module, keep: bool) -> Optional[Dict]:
        """``module.state_dict()`` as one process holds it: every split entry
        gathered over dp, one at a time, onto the host where ``keep`` (the writing
        rank); a collective of the dp group. None where not ``keep``."""
        out = {} if keep else None
        for k, v in module.state_dict().items():
            whole = self.full(k, v)
            if keep:
                out[k] = whole.cpu()
            del whole
        return out

    def load_full_state_dict(self, module: torch.nn.Module, state: Dict):
        """Load a one-process state dict into the sharded ``module``: each rank its
        blocks, strictly."""
        module.load_state_dict({k: self.local(k, v) for k, v in state.items()})

    def local_bytes(self, module: torch.nn.Module) -> Tuple[int, int]:
        """(bytes of the split parameters' blocks, bytes of the replicated
        parameters) of ``module`` on this rank."""
        split = repl = 0
        for name, p in module.named_parameters():
            n = p.numel() * p.element_size()
            if self.dims[name] is None:
                repl += n
            else:
                split += n
        return split, repl


def _owner(module: torch.nn.Module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def shard_for_training(model: torch.nn.Module, mesh,
                       min_size: int = MIN_SHARD_SIZE) -> Optional[ParamSharding]:
    """Split the fp32 parameters of ``model`` (whole, the same on every rank) over
    the dp group of ``mesh`` by ``param_spec``, in place, and return the sharding;
    None (the model untouched) without a mesh or at dp 1. Build the optimizer and
    copy the EMA after this call."""
    if mesh is None or mesh.dp == 1:
        return None
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    sharding = ParamSharding(
        dims={n: param_spec(s, mesh.dp, min_size) for n, s in shapes.items()},
        shapes=shapes, group=mesh.dp_group, dp=mesh.dp, rank=mesh.dp_rank,
        sp_rank=mesh.sp_rank)
    sharding.shard(model)
    logger.info("fsdp over dp=%d (%s): %d of %d parameters split, %d of %d elements",
                mesh.dp, dist.get_backend(mesh.dp_group), len(sharding.sharded), len(shapes),
                sum(int(np.prod(shapes[n])) for n in sharding.sharded),
                sum(int(np.prod(s)) for s in shapes.values()))
    return sharding
