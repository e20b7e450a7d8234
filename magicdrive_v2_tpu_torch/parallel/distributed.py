"""Multi-process runs of the port: one process per GPU, under ``torchrun`` or any
launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` (the JAX package's parallel/distributed.py, whose cluster is
``jax.distributed``): the process group, the training mesh rule of
``training_mesh_shape``, and a launcher for tests and the smoke script.

One rank is one GPU, so a rank holds one data-parallel row: the JAX package's
``local_dp_info`` is ``(1, Mesh.dp_rank)`` here, and its ``make_global_batch`` /
``local_rows`` (which stitch each process's rows into global arrays and back)
have no counterpart: each rank keeps its own rows, and the trainer reduces the
grads over dp (``parallel/fsdp.py``).

Everything here is a no-op in a single-process run, so the apps behave as before
on one process.
"""
from __future__ import annotations

import contextlib
import datetime
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def world_size() -> int:
    """The launcher's world size (1 without one)."""
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")) or 0)


def rank_device(device="cuda") -> torch.device:
    """The device this process runs on: for ``"cuda"`` in a multi-process run the
    card ``LOCAL_RANK``; otherwise ``device`` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and world_size() > 1:
        return torch.device("cuda", local_rank())
    return device


def maybe_initialize(device="cuda", backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Join the process group the launcher describes, once; returns whether a
    process group was initialised by this call. ``backend`` defaults to ``nccl`` for a CUDA
    ``device`` (one card per rank; the card ``LOCAL_RANK`` becomes the current
    device first) and ``gloo`` for the CPU. An explicit ``backend="gloo"`` lets
    several ranks share one card (NCCL refuses two ranks on one device)."""
    if world_size() <= 1 or dist.is_initialized():
        return False
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method="env://", world_size=world_size(),
                            rank=int(os.environ["RANK"]), **kw)
    logger.info("torch.distributed: rank %d of %d, backend %s, device %s",
                dist.get_rank(), dist.get_world_size(), backend, device)
    return True


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _warm_device(group) -> torch.device:
    # an NCCL group takes tensors on the current card only
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def startup_barrier(mesh=None) -> None:
    """A barrier and one warm-up all-reduce on each of the mesh's groups (the whole
    mesh, its dp columns and sp rows) while every rank stands at the same point,
    so a broken group fails at start-up and not in the middle of a sample.
    No-op in a single-process run."""
    if not dist.is_initialized():
        return
    dist.barrier()
    groups = [None] if mesh is None else [None, mesh.group, mesh.dp_group, mesh.sp_group]
    for group in groups:
        x = torch.ones(1, device=_warm_device(group))
        dist.all_reduce(x, group=group)
        n = dist.get_world_size(group)
        if int(x.item()) != n:
            raise RuntimeError(f"startup all-reduce over {n} ranks gave {x.item()}")
    logger.info("startup barrier passed (%d processes)", dist.get_world_size())


def shutdown() -> None:
    """Leave the process group (the apps' exit)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def app_process_group(device="cuda", timeout_s: Optional[float] = None):
    """An app's run: joins the launcher's process group (``maybe_initialize``,
    collectives and barriers time out after ``timeout_s``, else the backend's
    default), yields this rank's device, and leaves the group at the end if it
    joined it."""
    joined = maybe_initialize(device, timeout_s=timeout_s)
    try:
        yield rank_device(device)
    finally:
        if joined:
            shutdown()


def training_mesh_shape(sp_size: int, world: int) -> Tuple[int, int]:
    """(dp, sp) of a training run in a world of ``world`` processes: the JAX train
    apps' ``sp = min(sp_size, devices)`` and ``dp = devices // sp``, dp outer. So a
    config's sp_size 4 trains sharded over 2 ranks and unsharded in one process
    (where its ``simulate_sp_size`` alone picks the pad), and the ranks beyond an
    sp group are data-parallel rows. Serving differs: there fewer ranks than
    ``sp_size`` run unsharded (``pipelines.sequence_parallel_mesh``). A world that
    sp does not divide raises ValueError (the JAX apps leave the extra devices
    idle)."""
    sp = max(1, min(int(sp_size or 1), world))
    if world % sp:
        raise ValueError(f"{world} processes do not split into data-parallel rows of "
                         f"sp={sp} (sp_size {sp_size}): run a multiple of {sp}")
    return world // sp, sp


def training_mesh(sp_size: int):
    """The (dp, sp) mesh of a training run by ``training_mesh_shape`` over this
    process group, or None in a single-process run. This rank's dp row is
    ``rank // sp`` (``Mesh.dp_rank``)."""
    from .sharding import make_mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    dp, sp = training_mesh_shape(sp_size, world)
    return make_mesh(dp=dp, sp=sp) if world > 1 else None


def free_port() -> int:
    """A TCP port of this host that is free now (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankGroup:
    """Ranks 0..n-1 of one group on this host, started as a launcher would start
    them: RANK, WORLD_SIZE, LOCAL_RANK (``local_ranks[r]``, else r), MASTER_ADDR
    and MASTER_PORT (a free port) set, ``env`` added. Each rank's output goes to a
    file, so a rank that prints much never blocks on a pipe. The caller may work
    while they run; ``wait`` then collects them, and ``close`` kills whatever still
    runs (call it in a ``finally``: a rank must not outlive its caller)."""

    def __init__(self, n: int, argv: Sequence[str], deadline_s: float,
                 env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None,
                 local_ranks: Optional[Sequence[int]] = None):
        base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                    WORLD_SIZE=str(n), **(env or {}))
        local = list(local_ranks) if local_ranks is not None else list(range(n))
        self.n, self.deadline_s = n, deadline_s
        self.end = time.time() + deadline_s
        self.logs = [tempfile.TemporaryFile("w+") for _ in range(n)]
        self.procs = [subprocess.Popen([sys.executable] + list(argv), cwd=cwd,
                                       env=dict(base, RANK=str(r), LOCAL_RANK=str(local[r])),
                                       stdout=self.logs[r], stderr=subprocess.STDOUT,
                                       text=True)
                      for r in range(n)]

    def output(self, r: int) -> str:
        self.logs[r].flush()
        self.logs[r].seek(0)
        return self.logs[r].read()

    def _failed(self, r: int) -> RuntimeError:
        return RuntimeError(f"rank {r} of {self.n} exited with {self.procs[r].returncode}:\n"
                            f"{self.output(r)[-6000:]}")

    def wait(self) -> List[str]:
        """Each rank's output once all exited 0. Raises, and kills every rank, when a
        rank fails or the group outlives its deadline (counted from the start): a
        rank that died must not leave the others waiting in a collective."""
        try:
            while any(p.poll() is None for p in self.procs):
                failed = [r for r, p in enumerate(self.procs) if p.poll() not in (None, 0)]
                if failed:
                    raise self._failed(failed[0])
                if time.time() > self.end:
                    raise RuntimeError(f"{self.n} ranks outlived their deadline of "
                                       f"{self.deadline_s} s; rank 0's output:\n"
                                       f"{self.output(0)[-6000:]}")
                time.sleep(0.05)
            failed = [r for r, p in enumerate(self.procs) if p.returncode != 0]
            if failed:
                raise self._failed(failed[0])
            return [self.output(r) for r in range(self.n)]
        finally:
            self.close()

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self.logs:
            if not log.closed:
                log.close()


def spawn_ranks(n: int, argv: Sequence[str], deadline_s: float,
                env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None,
                local_ranks: Optional[Sequence[int]] = None) -> List[str]:
    """Run ``python argv...`` as ranks 0..n-1 of one group on this host
    (``RankGroup``) and wait for them. Raises, and kills every rank, when a rank
    fails or the group outlives ``deadline_s``. Returns each rank's output."""
    return RankGroup(n, argv, deadline_s, env=env, cwd=cwd, local_ranks=local_ranks).wait()
