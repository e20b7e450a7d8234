"""The collectives of sequence parallelism, written out (the JAX package leaves
them to GSPMD, which inserts them at its ``shard_hint`` sites).

Each is a ``torch.autograd.Function``: ``all_to_all`` (its backward is the
inverse all-to-all), ``split_seq`` (this rank's block of a dim; backward: an
all-gather) and ``gather_seq`` (an all-gather; backward: this rank's block).
Rank r of a group of P holds the contiguous block ``[r*n/P, (r+1)*n/P)`` of a
split dim, as GSPMD's block sharding does. The collectives run on
``torch.distributed``'s ``all_to_all_single`` / ``all_gather_into_tensor`` /
``all_reduce`` with whatever backend the group was built with; a backend that
refuses raises.

The grad rule of sequence-parallel training (GSPMD's implicit grad reduction,
written out). The model runs replicated up to its split, on its block of tokens
in between, and gathers after its final layer; the loss is whole on every rank.
The model splits with ``split_seq_share``, whose backward keeps this rank's
block of the grad (zeros elsewhere, no collective), and a forward that runs
whole on every rank under a mesh passes its output through ``share_grad`` (the
grad over P). Then every grad a backward leaves is this rank's share of one
process's grad:
- inside the split span (blocks, final layer, and the replicated t / condition
  embeddings they read): the part from this rank's tokens;
- upstream of the split (the x / control / map embedders): the part from this
  rank's block;
- a tensor on both paths: the sum of its shares.
So one all-reduce sum over the sp group (``reduce_sp_grads``) gives one
process's grads on every rank, whichever path a parameter sits on.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_to_all(x: torch.Tensor, scatter_dim: int, gather_dim: int, group) -> torch.Tensor:
    P = dist.get_world_size(group)
    if P == 1:
        return x
    scatter_dim %= x.ndim
    gather_dim %= x.ndim
    n = x.shape[scatter_dim]
    if n % P:
        raise ValueError(f"all_to_all: dim {scatter_dim} of size {n} does not split over "
                         f"{P} ranks")
    inp = x.movedim(scatter_dim, 0).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    # block j of out is rank j's piece of this rank's block of the scatter dim:
    # (P, n/P, rest...) -> P next to the gather dim, merged into it
    rest = list(inp.shape[1:])
    g = gather_dim if gather_dim < scatter_dim else gather_dim - 1  # in rest
    out = out.view(P, n // P, *rest).movedim(0, g + 1)
    shape = [n // P] + rest
    shape[g + 1] *= P
    return out.reshape(shape).movedim(0, scatter_dim).contiguous()


def _split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    P = dist.get_world_size(group)
    if P == 1:
        return x
    n = x.shape[dim]
    if n % P:
        raise ValueError(f"split_seq: dim {dim} of size {n} does not split over {P} ranks")
    r = dist.get_rank(group)
    return x.narrow(dim, r * (n // P), n // P).contiguous()


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    P = dist.get_world_size(group)
    if P == 1:
        return x
    inp = x.movedim(dim, 0).contiguous()
    out = torch.empty((P * inp.shape[0],) + tuple(inp.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, inp, group=group)
    return out.movedim(0, dim).contiguous()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scatter_dim, gather_dim, group):
        ctx.dims, ctx.group = (scatter_dim, gather_dim), group
        return _all_to_all(x, scatter_dim, gather_dim, group)

    @staticmethod
    def backward(ctx, grad):
        s, g = ctx.dims
        return _all_to_all(grad, g, s, ctx.group), None, None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _split(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _split(grad, ctx.dim, ctx.group), None, None


class _SplitSeqShare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return _split(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        P = dist.get_world_size(ctx.group)
        if P == 1:
            return grad, None, None
        shape = list(grad.shape)
        shape[ctx.dim] = ctx.n
        out = grad.new_zeros(shape)
        r = dist.get_rank(ctx.group)
        out.narrow(ctx.dim, r * (ctx.n // P), ctx.n // P).copy_(grad)
        return out, None, None


class _ShareGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / dist.get_world_size(ctx.group), None


def all_to_all(x: torch.Tensor, scatter_dim: int, gather_dim: int, group) -> torch.Tensor:
    """Scatter ``scatter_dim`` over the group's ranks and gather ``gather_dim``:
    each rank's ``x`` holds its block of ``gather_dim``; the result holds every
    rank's block of ``gather_dim`` (in rank order) and this rank's block of
    ``scatter_dim``. Contiguous."""
    return _AllToAll.apply(x, scatter_dim, gather_dim, group)


def split_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous block of ``dim`` (x is the same on every rank)."""
    return _SplitSeq.apply(x, dim, group)


def gather_seq(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of ``dim``, concatenated in rank order."""
    return _GatherSeq.apply(x, dim, group)


def split_seq_share(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``split_seq`` for training: the same forward; the backward leaves this rank's
    share of the grad of ``x`` (its block, zeros elsewhere, no collective), which
    ``reduce_sp_grads`` sums."""
    return _SplitSeqShare.apply(x, dim, group)


def share_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; the backward divides the grad by the group's size: the share
    of a rank in a forward every rank of the group computes whole."""
    return _ShareGrad.apply(x, group)


def all_reduce_grads(grads, group, bucket_bytes: int = 1 << 28) -> int:
    """Sum the tensors ``grads`` over the group, in place: in flat buckets of at
    most ``bucket_bytes`` (one dtype and device each), one all-reduce a bucket, in
    the order given (the same on every rank). Returns the number of all-reduces."""
    grads = list(grads)
    if dist.get_world_size(group) == 1 or not grads:
        return 0
    calls = 0
    bucket, size = [], 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        o = 0
        for g in bucket:
            g.copy_(flat[o:o + g.numel()].view_as(g))
            o += g.numel()

    for g in grads:
        nbytes = g.numel() * g.element_size()
        if bucket and (g.dtype != bucket[0].dtype or g.device != bucket[0].device
                       or size + nbytes > bucket_bytes):
            flush()
            calls += 1
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    flush()
    return calls + 1


def reduce_sp_grads(params, group, bucket_bytes: int = 1 << 28) -> int:
    """Sum the grads of ``params`` (those that have one) over the sp group, in
    place (``all_reduce_grads``). Returns the number of all-reduces."""
    return all_reduce_grads([p.grad for p in params if p.grad is not None], group,
                            bucket_bytes)
