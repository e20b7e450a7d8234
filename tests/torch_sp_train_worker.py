"""One rank of the sequence- and data-parallel training CPU tests of the port
(not a test module).

    python tests/torch_sp_train_worker.py DIR

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set (``spawn_ranks`` in
``tests/test_torch_common.py`` sets them). It joins a gloo group, reads the
cases of ``DIR/inputs.pt``, runs each (the model cases under the case's
``mesh`` (dp, sp), by default (1, WORLD_SIZE), through the port's plain kernel
versions; the app cases through the apps' own ``main``) and writes its results
to ``DIR/rank<R>.pt``. ``run_steps`` is also the one-process reference the
tests run in their own process. It imports torch and the port only.
"""
import copy
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from magicdrive_v2_tpu_torch.parallel.distributed import (maybe_initialize,  # noqa: E402
                                                          shutdown)
from magicdrive_v2_tpu_torch.parallel.sharding import make_mesh, sp_vae, use_mesh  # noqa: E402


def build_model(case):
    from magicdrive_v2_tpu_torch.models.magicdrive.brushnet import (BrushNetConfig,
                                                                    MagicDriveSTDiT3BrushNet)
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import (MagicDriveSTDiT3,
                                                                  MagicDriveSTDiT3Config)
    brush = case["cfg"].get("sde_inpaint") is not None
    cfg_cls, model_cls = ((BrushNetConfig, MagicDriveSTDiT3BrushNet) if brush
                          else (MagicDriveSTDiT3Config, MagicDriveSTDiT3))
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    model = model_cls(cfg_cls(**{k: v for k, v in case["cfg"].items() if k in fields}))
    model.load_state_dict(case["state"], strict=True)
    return model.train()


def dp_rows(batch, mesh):
    """This dp row's rows of a global batch (leading dims b or b*NC, sample-major)."""
    if isinstance(batch, dict):
        return {k: dp_rows(v, mesh) for k, v in batch.items()}
    n = batch.shape[0] // mesh.dp
    return batch[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]


def run_steps(case, mesh):
    """``len(case["draws"])`` steps of ``make_train_step`` under ``mesh`` (None: one
    process) on the case's batch (the global batch: on a mesh of dp > 1 each dp
    row takes its rows, and the state is split over dp with ``fsdp_min_size``):
    each step's metrics, the grads it stepped with (the reduced ones; after the
    clip), and the parameters and EMA after it, all gathered whole; the bytes of
    this rank's split blocks of parameters, moments and EMA. A BrushNet model
    trains its branch (``build_brushnet_training``); draws a step is not handed
    are drawn from (seed, step)."""
    from magicdrive_v2_tpu_torch.parallel.fsdp import shard_for_training
    from magicdrive_v2_tpu_torch.schedulers.rf import (RFLOW_BRUSHNET, RFLOW_SDEBRUSHNET,
                                                       build_scheduler)
    from magicdrive_v2_tpu_torch.training import trainer as TT
    from magicdrive_v2_tpu_torch.utils import train_utils as TU

    model = build_model(case)
    hyper = case["hyper"]
    brush = case["cfg"].get("sde_inpaint") is not None
    geo = dict(height=case["height"], width=case["width"], num_frames=case["num_frames"])
    batch = case["batch"]
    sharding = None
    if mesh is not None and mesh.dp > 1:
        batch = dp_rows(batch, mesh)
        sharding = shard_for_training(model, mesh, min_size=case["fsdp_min_size"])
    if brush:
        kw = {k: v for k, v in case["scheduler"].items() if k != "type"}
        sched = (RFLOW_SDEBRUSHNET if case["cfg"]["sde_inpaint"] else RFLOW_BRUSHNET)(**kw)
        state, step = TT.build_brushnet_training(
            model, sched, dict(hyper, dtype="fp32"), **geo, seed=case.get("seed", 0),
            simulate_sp=case.get("simulate_sp"), sharding=sharding)
    else:
        mask = TU.trainable_mask(model.named_parameters())
        opt = TU.make_optimizer(model.named_parameters(), trainable=mask, sharding=sharding,
                                **hyper)
        state = TT.TrainState(step=0, model=model, optimizer=opt,
                              ema=copy.deepcopy(model).requires_grad_(False),
                              sharding=sharding)
        step = TT.make_train_step(build_scheduler(case["scheduler"]), **geo, dtype=torch.float32,
                                  ema_decay=0.99, ema_mask=mask, seed=case.get("seed", 0),
                                  simulate_sp=case.get("simulate_sp"))

    def whole(name, t):
        return (t if sharding is None else sharding.full(name, t)).detach().clone()

    out = []
    for draws in case["draws"]:
        with use_mesh(mesh):
            state, m = step(state, batch, **draws)
        out.append(dict(
            metrics={k: v.detach().clone() for k, v in m.items()},
            grads={n: whole(n, p.grad) for n, p in state.model.named_parameters()
                   if p.grad is not None},
            params={n: whole(n, p) for n, p in state.model.named_parameters()},
            ema={n: whole(n, p) for n, p in state.ema.named_parameters()}))
    if sharding is not None:
        moments = [v for s in state.optimizer.adamw.state.values() for k, v in s.items()
                   if k in ("exp_avg", "exp_avg_sq")]
        out[-1]["local_bytes"] = dict(
            params=sharding.local_bytes(state.model), ema=sharding.local_bytes(state.ema),
            moments=sum(v.numel() * v.element_size() for v in moments))
    return out


def run_sp_vae_encode(case, mesh):
    """The encode scattered over the ranks with the posterior noise drawn whole
    (the train app's ``posterior_noise``) and sliced by ``sp_vae``."""
    from magicdrive_v2_tpu_torch.models.vae.cogvideox import (CogVAEConfig,
                                                              VideoAutoencoderKLCogVideoX)
    from magicdrive_v2_tpu_torch.scripts.train_magicdrive import posterior_noise
    vae = VideoAutoencoderKLCogVideoX(CogVAEConfig(**case["cfg"]), device="cpu")
    vae.module.load_state_dict(case["state"], strict=True)
    noise = posterior_noise(vae, case["x"], torch.Generator().manual_seed(case["seed"]))
    return sp_vae(case["x"], vae.encode, mesh, noise=noise)


def run_app(case, mesh):
    """An app's ``main`` in this process group (it builds its own mesh): the
    metrics lines it returns."""
    import importlib
    app = importlib.import_module(f"magicdrive_v2_tpu_torch.scripts.{case['app']}")
    return {"lines": [{k: float(v) for k, v in line.items() if k != "elapsed_s"}
                      for line in app.main(case["argv"])]}


def run_dp_encode(case, mesh):
    """The train app's encode (``encode_latents``) of this dp row's views of the
    case's global ``x`` at step 3."""
    from magicdrive_v2_tpu_torch.models.vae.cogvideox import (CogVAEConfig,
                                                              VideoAutoencoderKLCogVideoX)
    from magicdrive_v2_tpu_torch.scripts.train_magicdrive import encode_latents
    vae = VideoAutoencoderKLCogVideoX(CogVAEConfig(**case["cfg"]), device="cpu")
    vae.module.load_state_dict(case["state"], strict=True)
    return encode_latents(vae, dp_rows(case["x"], mesh), case["seed"], 3, mesh)


RUNNERS = {"steps": run_steps, "sp_vae_encode": run_sp_vae_encode, "dp_encode": run_dp_encode,
           "app": run_app}


def main():
    import logging
    out_dir = sys.argv[1]
    torch.set_num_threads(1)
    logging.basicConfig(level=logging.INFO)
    maybe_initialize("cpu", timeout_s=120)
    rank = int(os.environ["RANK"])
    cases = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
    results = {}
    meshes = {}
    try:
        for name, case in cases.items():
            shape = tuple(case.get("mesh", (1, int(os.environ["WORLD_SIZE"]))))
            if shape not in meshes:  # made collectively, in the cases' order
                meshes[shape] = make_mesh(*shape)
            results[name] = RUNNERS[case["kind"]](case, meshes[shape])
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown()


if __name__ == "__main__":
    main()
