"""One rank of the sequence-parallel training CPU tests of the port (not a test
module).

    python tests/torch_sp_train_worker.py DIR

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set (``spawn_ranks`` in
``tests/test_torch_common.py`` sets them). It joins a gloo group, reads the
cases of ``DIR/inputs.pt``, runs each (the model cases under a (dp=1,
sp=WORLD_SIZE) mesh, through the port's plain kernel versions; the app cases
through the apps' own ``main``) and writes its results to ``DIR/rank<R>.pt``.
``run_steps`` is also the one-process reference the tests run in their own
process. It imports torch and the port only.
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


def run_steps(case, mesh):
    """``len(case["draws"])`` steps of ``make_train_step`` under ``mesh`` (None: one
    process) on the case's batch: each step's metrics, the grads it stepped with
    (the reduced ones; after the clip), and the parameters and EMA after it. A
    BrushNet model trains its branch (``build_brushnet_training``); draws a step is
    not handed are drawn from (seed, step)."""
    from magicdrive_v2_tpu_torch.schedulers.rf import (RFLOW_BRUSHNET, RFLOW_SDEBRUSHNET,
                                                       build_scheduler)
    from magicdrive_v2_tpu_torch.training import trainer as TT
    from magicdrive_v2_tpu_torch.utils import train_utils as TU

    model = build_model(case)
    hyper = case["hyper"]
    brush = case["cfg"].get("sde_inpaint") is not None
    geo = dict(height=case["height"], width=case["width"], num_frames=case["num_frames"])
    if brush:
        kw = {k: v for k, v in case["scheduler"].items() if k != "type"}
        sched = (RFLOW_SDEBRUSHNET if case["cfg"]["sde_inpaint"] else RFLOW_BRUSHNET)(**kw)
        state, step = TT.build_brushnet_training(
            model, sched, dict(hyper, dtype="fp32"), **geo, seed=case.get("seed", 0),
            simulate_sp=case.get("simulate_sp"))
    else:
        mask = TU.trainable_mask(model.named_parameters())
        opt = TU.make_optimizer(model.named_parameters(), trainable=mask, **hyper)
        state = TT.TrainState(step=0, model=model, optimizer=opt,
                              ema=copy.deepcopy(model).requires_grad_(False))
        step = TT.make_train_step(build_scheduler(case["scheduler"]), **geo, dtype=torch.float32,
                                  ema_decay=0.99, ema_mask=mask, seed=case.get("seed", 0),
                                  simulate_sp=case.get("simulate_sp"))
    out = []
    for draws in case["draws"]:
        with use_mesh(mesh):
            state, m = step(state, case["batch"], **draws)
        out.append(dict(
            metrics={k: v.detach().clone() for k, v in m.items()},
            grads={n: p.grad.clone() for n, p in state.model.named_parameters()
                   if p.grad is not None},
            params={n: p.detach().clone() for n, p in state.model.named_parameters()},
            ema={n: p.detach().clone() for n, p in state.ema.named_parameters()}))
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
    metrics lines it returns, or the message of the NotImplementedError it raises."""
    import importlib
    app = importlib.import_module(f"magicdrive_v2_tpu_torch.scripts.{case['app']}")
    try:
        lines = app.main(case["argv"])
    except NotImplementedError as e:
        return {"refused": str(e)}
    return {"lines": [{k: float(v) for k, v in line.items() if k != "elapsed_s"}
                      for line in lines]}


RUNNERS = {"steps": run_steps, "sp_vae_encode": run_sp_vae_encode, "app": run_app}


def main():
    import logging
    out_dir = sys.argv[1]
    torch.set_num_threads(1)
    logging.basicConfig(level=logging.INFO)
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
