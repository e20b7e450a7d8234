"""The (dp, sp) mesh of the port and the batch-scattered VAE call (counterpart
of the JAX package's parallel/sharding.py).

The JAX package builds a device mesh and drops ``shard_hint`` constraints for
GSPMD. The port runs one process per GPU: its mesh holds the process groups of
the data-parallel columns and the sequence-parallel rows, dp outer and sp inner
as ``make_mesh`` orders devices there, and the model splits and gathers the
token axis with the explicit collectives of ``parallel/comm.py``. Outside a
``use_mesh`` context everything runs unsharded, so the same model code serves
one process and many.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .comm import gather_seq

_state = threading.local()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Process groups of a (dp, sp) mesh over ranks ``0 .. dp*sp - 1`` of the
    default group, and this rank's place in it (``dp_rank``, ``sp_rank``).
    ``group`` spans the whole mesh (``sp_vae`` scatters over it)."""
    dp: int
    sp: int
    dp_rank: int
    sp_rank: int
    group: object
    dp_group: object
    sp_group: object

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def rank(self) -> int:
        """This rank's index in the mesh, dp-major."""
        return self.dp_rank * self.sp + self.sp_rank


def get_current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    prev = get_current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def make_mesh(dp: int = 1, sp: int = 1) -> Mesh:
    """The (dp, sp) mesh over the first dp*sp ranks of the initialised default
    group: rank d*sp + s sits in dp row d and sp column s, so each sp group is a
    contiguous block of ranks. Every rank of the default group must call it (the
    groups are made collectively), and this rank must belong to the mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed default "
                           "group (parallel.distributed.maybe_initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * sp > world:
        raise ValueError(f"mesh dp={dp} x sp={sp} needs {dp * sp} ranks, the world has "
                         f"{world}")
    if rank >= dp * sp:
        raise ValueError(f"rank {rank} lies outside the dp={dp} x sp={sp} mesh")
    whole = dist.new_group(list(range(dp * sp)))
    sp_groups = [dist.new_group([d * sp + s for s in range(sp)]) for d in range(dp)]
    dp_groups = [dist.new_group([d * sp + s for d in range(dp)]) for s in range(sp)]
    d, s = divmod(rank, sp)
    return Mesh(dp=dp, sp=sp, dp_rank=d, sp_rank=s, group=whole, dp_group=dp_groups[s],
                sp_group=sp_groups[d])


def sp_size() -> int:
    mesh = get_current_mesh()
    return 1 if mesh is None else mesh.sp


def dp_size() -> int:
    mesh = get_current_mesh()
    return 1 if mesh is None else mesh.dp


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` filler rows, cycling the batch (``pad`` may exceed it)."""
    if not pad:
        return x
    reps = -(-pad // x.shape[0])
    return torch.cat([x, torch.cat([x] * reps, dim=0)[:pad]], dim=0)


def sp_vae(x: torch.Tensor, vae_fn: Callable, mesh: Optional[Mesh] = None,
           noise: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """A VAE decode or encode batch-scattered over the ranks of ``group`` (default:
    every rank of the mesh): the rows of x (the b*NC views, the same on every rank
    of the group) are padded with cycled rows to a multiple of the group's size,
    each rank runs ``vae_fn`` on its contiguous block of rows, and the results are
    all-gathered and trimmed (the JAX package's ``sp_vae``). ``noise``: the
    encode's posterior noise for all b rows, drawn once as one process draws it
    (the JAX package's one key for the whole batch); it is padded as x is and each
    rank hands its block to ``vae_fn(rows, noise=block)``, so the latents equal
    one process's. Without a mesh, or over one rank, it is ``vae_fn(x)`` (with
    ``noise=noise``)."""
    mesh = mesh or get_current_mesh()
    kw = {} if noise is None else {"noise": noise}
    if mesh is None:
        return vae_fn(x, **kw)
    group = mesh.group if group is None else group
    n, b = dist.get_world_size(group), x.shape[0]
    if n == 1:
        return vae_fn(x, **kw)
    x = _pad_rows(x, (-b) % n)
    per = x.shape[0] // n
    r = dist.get_rank(group)
    rows = slice(r * per, (r + 1) * per)
    if noise is not None:
        kw["noise"] = _pad_rows(noise, (-b) % n)[rows]
    out = vae_fn(x[rows], **kw)
    return gather_seq(out, 0, group)[:b]
