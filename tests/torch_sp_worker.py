"""One rank of the sequence-parallel CPU tests of the port (not a test module).

    python tests/torch_sp_worker.py DIR

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set (``spawn_ranks`` in
``tests/test_torch_common.py`` sets them). It joins a gloo group, reads the
cases of ``DIR/inputs.pt`` (written by the test process), runs each under a
(dp=1, sp=WORLD_SIZE) mesh through the port's plain kernel versions, and writes
its results to ``DIR/rank<R>.pt``. It imports torch and the port only.
"""
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from magicdrive_v2_tpu_torch.parallel import comm  # noqa: E402
from magicdrive_v2_tpu_torch.parallel.distributed import (maybe_initialize,  # noqa: E402
                                                          shutdown)
from magicdrive_v2_tpu_torch.parallel.sharding import make_mesh, sp_vae, use_mesh  # noqa: E402


def global_tensor(seed, shape):
    """The same tensor on every rank (a seeded CPU generator)."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64)


def block(x, dim, r, P):
    n = x.shape[dim] // P
    return x.narrow(dim, r * n, n)


def run_comm(case, mesh):
    """Each Function: what it computes, its round trip, and its backward against
    autograd through the gather-and-slice it stands for. Returns the worst
    absolute error of each check (fp64 inputs: every one should be 0 or ~1e-16)."""
    P, r, group = mesh.sp, mesh.sp_rank, mesh.sp_group
    shape, s, g = case["shape"], case["scatter_dim"], case["gather_dim"]
    X = global_tensor(1, shape)
    Ws = [global_tensor(10 + q, shape) for q in range(P)]  # rank q's loss weights
    errs = {}

    def err(a, b):
        return float((a - b).abs().max())

    if case["fn"] == "all_to_all":
        x = block(X, g, r, P).clone().requires_grad_(True)
        y = comm.all_to_all(x, s, g, group)
        errs["forward"] = err(y, block(X, s, r, P))
        errs["round_trip"] = err(comm.all_to_all(y, g, s, group), x)
        (y * block(Ws[r], s, r, P)).sum().backward()
        Xr = X.clone().requires_grad_(True)
        sum((block(Xr, s, q, P) * block(Ws[q], s, q, P)).sum() for q in range(P)).backward()
        errs["backward"] = err(x.grad, block(Xr.grad, g, r, P))
    elif case["fn"] == "split_seq":
        x = X.clone().requires_grad_(True)
        y = comm.split_seq(x, s, group)
        errs["forward"] = err(y, block(X, s, r, P))
        errs["round_trip"] = err(comm.gather_seq(y, s, group), X)
        (y * block(Ws[r], s, r, P)).sum().backward()
        Xr = X.clone().requires_grad_(True)
        sum((block(Xr, s, q, P) * block(Ws[q], s, q, P)).sum() for q in range(P)).backward()
        errs["backward"] = err(x.grad, Xr.grad)
    else:  # gather_seq: replicated use downstream, the same weights on every rank
        x = block(X, s, r, P).clone().requires_grad_(True)
        y = comm.gather_seq(x, s, group)
        errs["forward"] = err(y, X)
        errs["round_trip"] = err(comm.split_seq(y, s, group), x)
        (y * Ws[0]).sum().backward()
        Xr = X.clone().requires_grad_(True)
        (Xr * Ws[0]).sum().backward()
        errs["backward"] = err(x.grad, block(Xr.grad, s, r, P))
    return errs


def run_mesh(case, mesh):
    """A (dp=2, sp=2) mesh: this rank's place, and an all-reduce of the ranks over
    its sp row and its dp column."""
    import torch.distributed as dist
    m = make_mesh(dp=2, sp=2)
    sums = {}
    for name, group in (("sp_sum", m.sp_group), ("dp_sum", m.dp_group)):
        x = torch.tensor([float(dist.get_rank())])
        dist.all_reduce(x, group=group)
        sums[name] = int(x.item())
    return dict(dp_rank=m.dp_rank, sp_rank=m.sp_rank, rank=m.rank, size=m.size, **sums)


def build_model(case):
    from magicdrive_v2_tpu_torch.models.magicdrive.brushnet import (BrushNetConfig,
                                                                    MagicDriveSTDiT3BrushNet)
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import (MagicDriveSTDiT3,
                                                                  MagicDriveSTDiT3Config)
    cfg_cls, model_cls = ((BrushNetConfig, MagicDriveSTDiT3BrushNet)
                          if case["kind"] == "brushnet"
                          else (MagicDriveSTDiT3Config, MagicDriveSTDiT3))
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    model = model_cls(cfg_cls(**{k: v for k, v in case["cfg"].items() if k in fields}))
    model.load_state_dict(case["state"], strict=True)
    return model.eval()


def run_model(case, mesh):
    model = build_model(case)
    with torch.no_grad(), use_mesh(mesh):
        return model(**case["batch"])


def run_sp_vae(case, mesh):
    from magicdrive_v2_tpu_torch.models.vae.cogvideox import (CogVAEConfig,
                                                              VideoAutoencoderKLCogVideoX)
    vae = VideoAutoencoderKLCogVideoX(CogVAEConfig(**case["cfg"]), device="cpu")
    vae.module.load_state_dict(case["state"], strict=True)
    with torch.no_grad():
        return sp_vae(case["z"], vae.decode, mesh)


def run_pipeline(case, mesh):
    """``from_config`` on the config file (which builds its own mesh) and
    ``sample``."""
    from magicdrive_v2_tpu_torch.config.config import Config, merge_dot_options
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline
    cfg = Config.fromfile(case["config"])
    merge_dot_options(cfg, case["options"])
    pipe = MagicDrivePipeline.from_config(cfg, device="cpu")
    pipe.model.load_state_dict(case["state"], strict=True)
    if case.get("vae_state") is not None:
        pipe.vae.module.load_state_dict(case["vae_state"], strict=True)
    out = pipe.sample(case["batch"], **case["kwargs"])
    return {"video": out, "sp": pipe.mesh.sp if pipe.mesh is not None else 1}


def run_world_check(case, mesh):
    """``from_config``'s mesh rule for ``sp_size`` in this world: the error it
    raises, or None."""
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import sequence_parallel_mesh
    try:
        sequence_parallel_mesh(case["sp"])
    except ValueError as e:
        return str(e)
    return None


RUNNERS = {"comm": run_comm, "mesh": run_mesh, "stdit3": run_model, "brushnet": run_model,
           "sp_vae": run_sp_vae, "pipeline": run_pipeline, "world_check": run_world_check}


def main():
    out_dir = sys.argv[1]
    torch.set_num_threads(1)
    maybe_initialize("cpu", timeout_s=120)
    rank = int(os.environ["RANK"])
    cases = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
    results = {}
    try:
        mesh = make_mesh(dp=1, sp=int(os.environ["WORLD_SIZE"]))
        for name, case in cases.items():
            results[name] = RUNNERS[case["kind"]](case, mesh)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown()


if __name__ == "__main__":
    main()
