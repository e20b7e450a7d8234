"""Perf lab: time and trace the port's denoise step on one card (counterpart of the
JAX package's tools/perf_lab.py, with its command names). A measurement tool, not
the benchmark.

The step (JAX ``build_step``): MagicDriveSTDiT3-XL/2 at full width and depth in
bf16 with seeded random weights, 6 views of 424x800, 17 frames, b=1, batched
classifier-free guidance over the condition cache (the batch doubled, ``uncond +
2 (cond - uncond)``, ``z + pred / 30``), ``chained`` steps a call. On the CPU (the
tests) the tiny flagship in fp32 at 9 frames of 64x80, as the JAX tool runs off
its TPU.

Commands:
  time          p50 of 3 chained calls (4 steps a call), s a step, each call's
  time848       17 x 848x1600, one pass a step (no CFG doubling), 1 step a call
  time424full   232 x 424x800, one pass a step, 1 step a call
  vae848        the CogVideoX VAE encode of 6 cameras at 848x1600, one camera a
                call (``--num-frames``, default 232), s and peak memory
  profile       a torch.profiler chrome trace of one chained call (1 step) into
                ``--trace-dir``, then ``report``
  profile848    the same at 17 x 848x1600, one pass
  trainprofile  a trace of one train step (fwd+bwd of the rectified-flow loss, the
                global grad norm; remat full, b=1, bf16 over fp32 masters) at
                17 x 224x400; ``trainprofile424`` at 17 x 424x800
  report [DIR]  device time of the trace's kernels summed by a normalised name
                (template arguments, hex and numbers stripped), total device ms,
                the top entries with their counts
  ops [DIR]     the same, by the kernel's full name

Every time is printed beside the card's name and power limit (``nvidia-smi``). A
trace with no device event makes ``report`` raise, unless ``--cpu`` asks for the
CPU operators (the tests, on a trace written on the CPU).

Usage (from the repository root, on a machine with a card):
  python3 -m magicdrive_v2_tpu_torch.tools.perf_lab time [--chained 4]
  python3 -m magicdrive_v2_tpu_torch.tools.perf_lab profile [--trace-dir DIR]
  python3 -m magicdrive_v2_tpu_torch.tools.perf_lab report [DIR] [--top 40]
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import statistics
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import torch

TRACE_DIR = os.path.join("outputs", "perf_lab_trace")
SHAPE_424 = (17, 424, 800)
TINY_SHAPE, TINY_MAP = (9, 64, 80), (8, 80, 80)
COMMANDS = ("time", "time848", "time424full", "vae848", "profile", "profile848",
            "trainprofile", "trainprofile424", "report", "ops")


def card_label() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or "cpu"
    where there is no card."""
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[torch.cuda.current_device()]


def flagship_config(dtype, tiny: bool = False, **overrides):
    """MagicDriveSTDiT3-XL/2 as the 424x800 config builds it (no skipped temporal
    control blocks); ``tiny``: the JAX package's tiny flagship (hidden 64, 4 heads,
    depth 2 / control depth 1, small box and map embedders). ``overrides`` replace
    config fields. The one place that makes the XL/2 config for the tools and
    ``chip_smoke.py``."""
    from ..config.presets import MV_ORDER_MAP, xl2_model
    from ..models.magicdrive.stdit3 import build_model_config
    md = xl2_model(control_skip_temporal=False)
    if tiny:
        hidden, heads = 64, 4
        md["bbox_embedder_param"].update(class_token_dim=hidden,
                                         proj_dims=[hidden, 32, 32, hidden], num_heads=heads)
        md["frame_emb_param"].update(num_heads=heads)
        md["map_embedder_param"].update(block_out_channels=[8, 16, 24, 32])
        overrides = dict(dict(hidden_size=hidden, num_heads=heads, depth=2, control_depth=1),
                         **overrides)
    return build_model_config(md, vae_out_channels=16, mv_order_map=MV_ORDER_MAP, dtype=dtype,
                              **overrides)


def _to(v, device):
    if isinstance(v, dict):
        return {k: _to(x, device) for k, x in v.items()}
    return torch.from_numpy(v).to(device) if hasattr(v, "shape") else v


class ChainedStep:
    """``chained`` denoise steps of ``model`` from ``z`` at timestep ``t`` (the JAX
    tool's ``run_chain``): with ``cfg_double`` each step runs the model once on the
    doubled batch and mixes ``uncond + 2 (cond - uncond)``; else one pass. The
    condition cache is made by ``encode`` (once, after the weights are final) and
    reused by every call."""

    def __init__(self, model, cond: Dict, z: torch.Tensor, t: torch.Tensor, height: float,
                 width: float, chained: int, cfg_double: bool = True):
        self.model, self.z, self.t = model, z, t
        self.height, self.width, self.chained = height, width, chained
        self.cfg_double = cfg_double
        self.cond = {k: self._double(v) for k, v in cond.items()}
        self.cache = None

    def _double(self, v):
        if isinstance(v, dict):
            return {k: self._double(x) for k, x in v.items()}
        return torch.cat([v, v]) if self.cfg_double else v

    @torch.no_grad()
    def encode(self):
        c = self.cond
        shape = (2 if self.cfg_double else 1,) + tuple(self.z.shape[1:])
        self.cache = self.model.encode_conditions(shape, c["y"], c["maps"], c["bbox"],
                                                  c["cams"], c["rel_pos"])
        return self

    @torch.no_grad()
    def __call__(self) -> torch.Tensor:
        if self.cache is None:
            self.encode()
        z = self.z
        for _ in range(self.chained):
            pred = self.model(self._double(z), self._double(self.t), **self.cond,
                              height=self.height, width=self.width, cond_cache=self.cache)
            if self.cfg_double:
                cond, uncond = pred.chunk(2)
                pred = uncond + 2.0 * (cond - uncond)
            z = z + pred.to(z.dtype) * (1.0 / 30)
        return z


def build_step(chained: int = 2, shape: Optional[Tuple[int, int, int]] = None,
               cfg_double: bool = True, device: str = "cuda", seed: int = 0) -> ChainedStep:
    """The step on ``device``: on the card XL/2 in bf16 at ``shape`` (frames,
    height, width; default 17 x 424x800), on the CPU the tiny flagship in fp32 at 9
    x 64x80; seeded random weights (``utils/ckpt.init_weights``), the synthetic
    batch of the JAX tool (60 caption tokens, b=1)."""
    from ..models.magicdrive.stdit3 import MagicDriveSTDiT3, cast_model
    from ..pipelines.magicdrive import synthetic_batch
    from ..utils.ckpt import init_weights
    on_card = torch.device(device).type == "cuda"
    if on_card:
        num_frames, height, width = shape or SHAPE_424
        cfg, map_size = flagship_config(torch.bfloat16), (8, 400, 400)
    else:
        (num_frames, height, width), map_size = TINY_SHAPE, TINY_MAP
        cfg = flagship_config(torch.float32, tiny=True)
    with torch.device(device):
        model = MagicDriveSTDiT3(cfg).eval()
    init_weights(model, seed=seed)
    cast_model(model, cfg.dtype)
    batch = synthetic_batch(cfg, num_frames, height, width, l_txt=60, map_size=map_size)
    h, w = batch.pop("height"), batch.pop("width")
    x, t = _to(batch.pop("x"), device), _to(batch.pop("timestep"), device)
    step = ChainedStep(model, _to(batch, device), x, t, h, w, chained, cfg_double)
    step.shape = (num_frames, height, width)
    return step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_step(step: ChainedStep, calls: int = 3, warm: bool = True) -> Dict:
    """One untimed call (unless ``warm`` is False: the caller ran one), then
    ``calls`` timed ones (host clock, the card synchronised): seconds a step of
    each, their median."""
    dev = step.z.device
    if warm:
        step()
        _sync(dev)
    per_step = []
    for _ in range(calls):
        t0 = time.perf_counter()
        step()
        _sync(dev)
        per_step.append((time.perf_counter() - t0) / step.chained)
    return dict(p50_s=statistics.median(per_step), step_s=per_step, chained=step.chained,
                shape=list(step.shape), cfg_double=step.cfg_double, device=card_label())


def trace(fn, trace_dir: str, name: str = "trace", warm: bool = True) -> str:
    """``fn()`` once untimed (unless ``warm`` is False: the caller ran it), then once
    under torch.profiler (CPU and CUDA activities); the chrome trace is written to
    ``trace_dir/<name>.json``. Returns its path."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    return path


_TEMPLATE = re.compile(r"<[^<>]*>")
_NUMBER = re.compile(r"\b0x[0-9a-fA-F]+\b|\b\d+\b")


def normalise(name: str) -> str:
    """A kernel name without its template arguments and its free-standing numbers
    and hex addresses (so one kernel at several tile sizes groups), as the JAX tool
    strips HLO names' numeric suffixes; numbers inside identifiers stay."""
    prev = None
    while prev != name:
        prev, name = name, _TEMPLATE.sub("", name)
    name = _NUMBER.sub("", name)
    return re.sub(r"\s+", " ", name).strip()


def load_trace(trace_dir: str) -> List[Dict]:
    """The events of the newest chrome trace (``*.json``) under ``trace_dir``."""
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace (*.json) under {trace_dir!r}")
    with open(files[-1]) as f:
        return json.load(f).get("traceEvents", [])


def report(trace_dir: str = TRACE_DIR, top: int = 40, cpu: bool = False,
           by: str = "normalised") -> Dict:
    """Device time of the trace's kernel events (chrome category "kernel"; with
    ``cpu`` the "cpu_op" events instead) summed by name: total ms, the busy span
    from the first event's start to the last one's end, the top ``top`` entries as
    (ms, count, name). ``by`` "normalised" (``normalise``) or "full". Raises
    ValueError when the trace holds no such event."""
    cat = "cpu_op" if cpu else "kernel"
    events = [e for e in load_trace(trace_dir)
              if e.get("ph") == "X" and e.get("cat") == cat and "dur" in e]
    if not events:
        raise ValueError(f"the trace under {trace_dir!r} holds no {cat!r} event"
                         + ("" if cpu else " (no device time: was the card traced?)"))
    by_name, counts = collections.Counter(), collections.Counter()
    for e in events:
        key = normalise(e["name"]) if by == "normalised" else e["name"]
        by_name[key] += e["dur"] / 1e3
        counts[key] += 1
    total = sum(by_name.values())
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    rows = [dict(ms=ms, count=counts[n], share=ms / total, name=n)
            for n, ms in by_name.most_common(top)]
    return dict(category=cat, events=len(events), total_ms=total, span_ms=span,
                top=rows)


def print_report(rep: Dict):
    print(f"total {rep['category']} time: {rep['total_ms']:.3f} ms over {rep['events']} "
          f"events (span {rep['span_ms']:.3f} ms)")
    for r in rep["top"]:
        print(f"{r['ms']:10.3f} ms  x{r['count']:<6d} {100 * r['share']:5.1f} %  "
              f"{r['name'][:110]}")


def build_train_step(num_frames: int, height: int, width: int, device: str = "cuda",
                     tiny: bool = False, remat: str = "full", rows: int = 1,
                     mesh=None, seed: int = 0, simulate_sp: Optional[int] = None,
                     **overrides):
    """One training step without an optimizer update (the JAX tools' ``fwd_bwd``):
    the trainer's grads (``training.trainer.make_grad_step``: the rectified-flow
    loss of a batch through the model, remat ``remat``, bf16 over fp32 masters,
    fp32 when ``tiny``; the backward; under ``mesh`` the dp mean and the sp sum),
    then the global grad norm. Returns (step() -> (loss, grad norm), model,
    sharding, batch): the model with seeded random fp32 masters split over the
    mesh's dp (``parallel.fsdp``), the batch this rank's ``rows`` samples (its dp
    row's) of the synthetic batch of ``rows`` x dp, on ``device``."""
    from ..models.magicdrive.stdit3 import MagicDriveSTDiT3
    from ..parallel.fsdp import shard_for_training
    from ..parallel.sharding import use_mesh
    from ..pipelines.magicdrive import synthetic_batch
    from ..schedulers.rf import RFLOW
    from ..training.trainer import TrainState, make_grad_step
    from ..utils.ckpt import init_weights
    from ..utils.train_utils import make_optimizer
    dp, dp_rank, sp = (1, 0, 1) if mesh is None else (mesh.dp, mesh.dp_rank, mesh.sp)
    dtype = torch.float32 if tiny else torch.bfloat16
    cfg = flagship_config(dtype, tiny=tiny, grad_checkpoint=True, remat_policy=remat,
                          enable_sequence_parallelism=sp > 1,
                          force_pad_h_for_sp_size=sp if sp > 1 else None, **overrides)
    with torch.device(device):
        model = MagicDriveSTDiT3(cfg).train()
    init_weights(model, seed=seed)
    sharding = shard_for_training(model, mesh)
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        model.named_parameters(), lr=1e-4, sharding=sharding), ema=None, sharding=sharding)
    batch = synthetic_batch(cfg, num_frames, height, width, l_txt=60, b=rows * dp,
                            map_size=TINY_MAP if tiny else (8, 400, 400))
    for k in ("height", "width", "timestep"):
        batch.pop(k)
    lo, hi = dp_rank * rows, (dp_rank + 1) * rows

    def mine(v, n):
        if isinstance(v, dict):
            return {k: mine(x, n) for k, x in v.items()}
        return v[lo * n:hi * n]  # bbox, cams, rel_pos: b*NC rows

    nc = cfg.nc
    local = {k: mine(v, nc if k in ("bbox", "cams", "rel_pos") else 1)
             for k, v in batch.items()}
    local = _to(local, device)
    local["mask"] = torch.ones((rows, local["x"].shape[2]), device=device)
    scheduler = RFLOW(num_timesteps=1000, use_timestep_transform=True, cog_style_trans=True)
    grad_step = make_grad_step(scheduler, height=height, width=width, num_frames=num_frames,
                               dtype=dtype, seed=seed, simulate_sp=simulate_sp)

    def step():
        with use_mesh(mesh):
            metrics = grad_step(state, local)
            norm = state.optimizer.global_norm()
        state.step += 1
        return metrics["loss"], norm.detach()

    return step, model, sharding, local


def cmd_vae848(num_frames: int = 232, height: int = 848, width: int = 1600,
               cameras: int = 6) -> Dict:
    """The bf16 CogVideoX VAE encode of ``cameras`` cameras (seeded random weights
    and input), one camera a call, ``micro_frame_size`` 8 (frames streamed with the
    conv caches carried) and ``micro_batch_size`` 1: seconds in all and a camera,
    the latent frames, peak memory."""
    from ..models.vae.cogvideox import CogVAEConfig, VideoAutoencoderKLCogVideoX
    from ..utils.ckpt import init_weights
    vae = VideoAutoencoderKLCogVideoX(CogVAEConfig(dtype=torch.bfloat16), micro_frame_size=8,
                                      micro_batch_size=1, device="cuda")
    init_weights(vae.module, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    seconds, latent = [], None
    with torch.no_grad():
        for _ in range(cameras):
            x = torch.randn((1, 3, num_frames, height, width), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            latent = vae.encode(x, sample=False)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            del x
    return dict(command="vae848", frames=num_frames, hw=[height, width], cameras=cameras,
                seconds=sum(seconds), camera_s=seconds, latent_shape=list(latent.shape),
                finite=bool(latent.isfinite().all()),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, device=card_label())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("command", nargs="?", default="time", choices=COMMANDS)
    p.add_argument("trace", nargs="?", default=None, help="report / ops: the trace directory")
    p.add_argument("--trace-dir", default=TRACE_DIR)
    p.add_argument("--chained", type=int, default=None,
                   help="steps a timed call (default 4 for time, 1 otherwise)")
    p.add_argument("--num-frames", type=int, default=232, help="vae848's frames")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--cpu", action="store_true",
                   help="report / ops: the trace's CPU operators (a trace written on "
                        "the CPU)")
    args = p.parse_args(argv)
    trace_dir = args.trace or args.trace_dir
    if args.command in ("report", "ops"):
        rep = report(trace_dir, args.top, args.cpu, "normalised" if args.command == "report"
                     else "full")
        print_report(rep)
        return rep
    if not torch.cuda.is_available():
        raise SystemExit("perf_lab: no card (torch.cuda.is_available() is False)")
    shapes = {"time848": ((17, 848, 1600), False), "profile848": ((17, 848, 1600), False),
              "time424full": ((232, 424, 800), False)}
    shape, cfg_double = shapes.get(args.command, (None, True))
    if args.command == "vae848":
        out = cmd_vae848(args.num_frames)
    elif args.command.startswith("time"):
        chained = args.chained or (4 if args.command == "time" else 1)
        step = build_step(chained, shape, cfg_double)
        out = dict(command=args.command, **time_step(step))
    elif args.command.startswith("trainprofile"):
        nf, h, w = (17, 424, 800) if args.command == "trainprofile424" else (17, 224, 400)
        step = build_train_step(nf, h, w)[0]
        path = trace(step, trace_dir, args.command)
        out = dict(command=args.command, trace=path, shape=[nf, h, w], device=card_label())
    else:  # profile, profile848
        step = build_step(args.chained or 1, shape, cfg_double)
        path = trace(step, trace_dir, args.command)
        out = dict(command=args.command, trace=path, shape=list(step.shape),
                   device=card_label())
    print(json.dumps(out), flush=True)
    if "trace" in out:
        print_report(report(trace_dir, args.top))
    return out


if __name__ == "__main__":
    main()
