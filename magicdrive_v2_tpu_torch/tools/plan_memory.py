"""Per-device memory of the (dp, sp) training step, measured (counterpart of the JAX
package's tools/plan_memory.py, with its arguments and its ``PLAN {json}`` line). A
measurement tool, not the benchmark.

The step is the JAX tool's: one sample per dp row (``--rows``), forward and
backward of the rectified-flow training loss through XL/2 (``--remat``; bf16 over
fp32 masters, fp32 with ``--tiny``, the JAX tool's depth-2 narrow model), then the
global grad norm, with no optimizer update (``perf_lab.build_train_step``: the
trainer's ``make_grad_step``, the part of its step before the update). The
fp32 masters are split over dp by the port's ``parallel/fsdp.py``; the tokens are
split over sp by the model under the mesh, H padded for sp as the JAX tool forces
it. ``--infer``: one forward of the bf16 model instead (dp forced to 1), the
parameters whole on every sp rank.

Measured, not compiled: torch has no ahead-of-time buffer plan for a step that
launches hand-written kernels, so the tool runs the step, once, in one rank process
per (dp, sp) slot started by the port's rank launcher
(``parallel.distributed.RankGroup``): NCCL with a card a rank where the host has as
many cards, else gloo with every rank on card 0, sharing it (then a rank's peak is
its own, but the ranks' sum must fit the one card).

The ``PLAN`` line's keys, each the largest over the ranks (``ranks`` has every
rank's):
- ``shape``, ``remat`` (not with ``--infer``), ``backend`` (device / collective
  backend), ``device`` (the card's name and power limit);
- ``per_device_param_gb``: what the rank holds of the model's parameters (this
  rank's blocks of the split ones) and buffers (whole on every rank);
- ``per_device_batch_gb``: the rank's batch;
- ``per_device_peak_gb``: ``torch.cuda.max_memory_allocated`` over the step;
  ``per_device_temp_gb``: the peak less the parameters and the batch. Both null
  on the CPU, which keeps no such count;
- ``step_s``: the seconds of the measured step, in place of ``compile_s``.
The JAX keys with no counterpart: ``per_device_args_gb`` (XLA's argument
buffers: here the parameters and the batch, reported apart),
``per_device_out_gb`` and ``per_device_alias_gb`` (XLA's output and donated
buffers: an eager step has no output plan, its grads sit beside the parameters
within the peak), ``per_device_plan_gb`` (XLA's sum of those: the measured peak
stands in its place) and ``compile_s`` (nothing is compiled ahead).

Usage (from the repository root; XL/2's flagship case on 8 ranks):
  python3 -m magicdrive_v2_tpu_torch.tools.plan_memory --sp 4 --dp 2 --remat full
  python3 -m magicdrive_v2_tpu_torch.tools.plan_memory --sp 2 --infer
  python3 -m magicdrive_v2_tpu_torch.tools.plan_memory --dp 1 --sp 1 --rows 32 \\
      --height 224 --width 400 --frames 1 --no-temporal    # the stage-1 config's step
  python3 -m magicdrive_v2_tpu_torch.tools.plan_memory --tiny --dp 2 --sp 2 \\
      --height 64 --width 80 --frames 9 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from .perf_lab import card_label

GB = 2.0 ** 30
DEADLINE_S = 1800


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--height", type=int, default=424)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--sp", type=int, default=4)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--remat", default="full", choices=["full", "dots", "offload_carry"])
    ap.add_argument("--tiny", action="store_true",
                    help="the depth-2 narrow model (checks the tool quickly)")
    ap.add_argument("--infer", action="store_true",
                    help="one forward instead of the train step (dp is forced to 1)")
    ap.add_argument("--rows", type=int, default=1, help="samples per dp row")
    ap.add_argument("--depth", type=int, default=None, help="cut the depth (full: 28)")
    ap.add_argument("--control-depth", type=int, default=None, help="(full: 13)")
    ap.add_argument("--no-temporal", action="store_true",
                    help="the stage-1 image model: no temporal blocks (with_temp_block off, "
                         "control_skip_temporal on)")
    ap.add_argument("--simulate-sp", type=int, default=None,
                    help="the training-time H pad of that sp size (a stage-3 config's "
                         "simulate_sp_size)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--deadline", type=float, default=DEADLINE_S)
    ap.add_argument("--rank-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.infer:
        args.dp = 1
    return args


def _overrides(args) -> Dict:
    out = {k: v for k, v in (("depth", args.depth), ("control_depth", args.control_depth))
           if v is not None}
    if args.no_temporal:
        out.update(with_temp_block=False, control_skip_temporal=True)
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _batch_bytes(batch) -> int:
    if isinstance(batch, dict):
        return sum(_batch_bytes(v) for v in batch.values())
    return _nbytes([batch]) if isinstance(batch, torch.Tensor) else 0


def _infer_setup(args, device, mesh):
    """The bf16 (fp32 with ``--tiny``) model cast for inference, whole on every
    rank, and one forward of a b=1 synthetic batch under the mesh."""
    from ..models.magicdrive.stdit3 import MagicDriveSTDiT3, cast_model
    from ..parallel.sharding import use_mesh
    from ..pipelines.magicdrive import synthetic_batch
    from ..utils.ckpt import init_weights
    from .perf_lab import TINY_MAP, _to, flagship_config
    sp = 1 if mesh is None else mesh.sp
    dtype = torch.float32 if args.tiny else torch.bfloat16
    cfg = flagship_config(dtype, tiny=args.tiny, enable_sequence_parallelism=sp > 1,
                          force_pad_h_for_sp_size=sp if sp > 1 else None, **_overrides(args))
    with torch.device(device):
        model = MagicDriveSTDiT3(cfg).eval()
    init_weights(model, seed=0)
    cast_model(model, dtype)
    batch = synthetic_batch(cfg, args.frames, args.height, args.width, l_txt=60,
                            map_size=TINY_MAP if args.tiny else (8, 400, 400))
    h, w = batch.pop("height"), batch.pop("width")
    batch = _to(batch, device)

    @torch.no_grad()
    def step():
        with use_mesh(mesh):
            return model(**batch, height=h, width=w)

    return step, model, batch


def rank_worker(args) -> int:
    """One rank: join the group, build the step, run it once; print ``RANK {json}``."""
    from ..parallel.distributed import maybe_initialize, rank_device, shutdown
    from ..parallel.sharding import make_mesh
    from .perf_lab import build_train_step
    import torch.distributed as dist
    maybe_initialize(args.device, backend=os.environ.get("MDV2_PLAN_BACKEND"),
                     timeout_s=args.deadline)
    try:
        device = rank_device(args.device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh(dp=args.dp, sp=args.sp) if world > 1 else None
        on_card = device.type == "cuda"
        if args.infer:
            step, model, batch = _infer_setup(args, device, mesh)
            sharding = None
        else:
            step, model, sharding, batch = build_train_step(
                args.frames, args.height, args.width, device=device, tiny=args.tiny,
                remat=args.remat, rows=args.rows, mesh=mesh, simulate_sp=args.simulate_sp,
                **_overrides(args))
        param_bytes = _nbytes(model.parameters())
        buffer_bytes = _nbytes(model.buffers())
        batch_bytes = _batch_bytes(batch)
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = step()
        if on_card:
            torch.cuda.synchronize(device)
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if on_card else None
        finite = all(bool(torch.as_tensor(o).isfinite().all())
                     for o in (out if isinstance(out, tuple) else (out,)))
        print("RANK " + json.dumps(dict(
            rank=dist.get_rank() if dist.is_initialized() else 0,
            dp_row=0 if mesh is None else mesh.dp_rank,
            sp_rank=0 if mesh is None else mesh.sp_rank,
            param_bytes=param_bytes, buffer_bytes=buffer_bytes, batch_bytes=batch_bytes,
            split_params=0 if sharding is None else len(sharding.sharded),
            peak_bytes=peak, step_s=step_s, finite=finite,
            loss=None if args.infer else float(out[0]),
            grad_norm=None if args.infer else float(out[1]))), flush=True)
    finally:
        shutdown()
    return 0


def launch_plan(args) -> Tuple[Dict[str, str], Optional[List[int]], str]:
    """How the dp * sp ranks of ``args`` start: (their added environment, their local
    ranks, the collective backend). NCCL with a card a rank where the host has as
    many cards; else gloo with every rank on card 0; gloo on the CPU."""
    n = args.dp * args.sp
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("plan_memory: no card (torch.cuda.is_available() is False); "
                         "--device cpu measures no peak")
    if not on_card:
        return {"OMP_NUM_THREADS": "1"}, None, "gloo"
    if torch.cuda.device_count() < n:
        return {"MDV2_PLAN_BACKEND": "gloo"}, [0] * n, "gloo"
    return {}, None, "nccl"


def summarise(args, outs: List[str], backend: str) -> Dict:
    """The plan (printed as ``PLAN {json}`` by ``main``) from the ranks' outputs
    (their ``RANK`` lines)."""
    ranks = []
    for r, text in enumerate(outs):
        line = next((ln for ln in text.splitlines() if ln.startswith("RANK ")), None)
        if line is None:
            raise RuntimeError(f"rank {r} printed no RANK line:\n{text[-4000:]}")
        ranks.append(json.loads(line[5:]))
    peaks = [r["peak_bytes"] for r in ranks]
    on_card = torch.device(args.device).type == "cuda"
    mode = "fwd-only" if args.infer else f"b={args.rows}/dp-row"
    return dict(
        shape=f"{args.rows * args.dp}x6view {args.height}x{args.width}x{args.frames}f "
              f"{mode} dp={args.dp} sp={args.sp}" + (" tiny" if args.tiny else "")
              + (f" depth={args.depth}/{args.control_depth}" if args.depth else "")
              + (" no-temporal" if args.no_temporal else ""),
        **({} if args.infer else {"remat": args.remat}),
        backend=f"{'cuda' if on_card else 'cpu'}/{backend}",
        device=card_label() if on_card else "cpu",
        step_s=max(r["step_s"] for r in ranks),
        per_device_param_gb=max(r["param_bytes"] + r["buffer_bytes"] for r in ranks) / GB,
        per_device_batch_gb=max(r["batch_bytes"] for r in ranks) / GB,
        per_device_peak_gb=None if None in peaks else max(peaks) / GB,
        per_device_temp_gb=None if None in peaks else max(
            r["peak_bytes"] - r["param_bytes"] - r["buffer_bytes"] - r["batch_bytes"]
            for r in ranks) / GB,
        ranks=ranks)


def plan(args) -> Dict:
    """Start the dp * sp ranks of this module, wait for them, and summarise."""
    from ..parallel.distributed import RankGroup
    env, local_ranks, backend = launch_plan(args)
    argv = ["-m", "magicdrive_v2_tpu_torch.tools.plan_memory", "--rank-worker",
            *rank_argv(args)]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    outs = RankGroup(args.dp * args.sp, argv, args.deadline, env=env, cwd=repo,
                     local_ranks=local_ranks).wait()
    return summarise(args, outs, backend)


def rank_argv(args) -> List[str]:
    """The command line of ``args`` for a rank."""
    out = ["--height", str(args.height), "--width", str(args.width), "--frames",
           str(args.frames), "--sp", str(args.sp), "--dp", str(args.dp), "--remat", args.remat,
           "--rows", str(args.rows), "--device", args.device, "--deadline", str(args.deadline)]
    for flag, v in (("--depth", args.depth), ("--control-depth", args.control_depth),
                    ("--simulate-sp", args.simulate_sp)):
        if v is not None:
            out += [flag, str(v)]
    return (out + ["--tiny"] * args.tiny + ["--infer"] * args.infer
            + ["--no-temporal"] * args.no_temporal)


def main(argv=None):
    args = parse_args(argv)
    if args.rank_worker:
        return rank_worker(args)
    res = plan(args)
    print("PLAN " + json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
