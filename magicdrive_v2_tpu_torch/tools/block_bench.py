"""One MVSTDiTBlock at the 424p bench shape, through the kernels against through
their plain versions (counterpart of the JAX package's tools/block_bench.py,
whose "fused" and "xla" variants are "kernels" and "plain" here).

The bench shape is the 424x800 sample's: B=12 (two samples of six views),
T=5, S=1350, C=1152, 16 heads, qk_norm, the default camera neighbours, bf16,
y (B, 1, 72, C), t (B/6, 6C); seeded random weights. A spatial block launches
K1 twice (self-attention, cross-view attention), K2 three times and K3 once; a
temporal block K2 twice and K3 once. A chain of 8 applications of one block is
timed with CUDA events, the median of 3 chains in ms per block.

``routed`` points the model's three kernel sites (K1 and K3 in
``models/layers/blocks``, K2 in ``models/magicdrive/stdit3``) at the wrappers
("kernels"), at their plain PyTorch versions ("plain") or at three given
callables, and puts back what was there when it exits, also after an
exception. The package itself has no such switch.

Usage (from the repository root, on a machine with a card):
  python3 -m magicdrive_v2_tpu_torch.tools.block_bench [spatial|temporal|both]
  python3 -m magicdrive_v2_tpu_torch.tools.block_bench profile [--route plain] \\
      [--temporal] [--trace PATH]
Each result is one JSON line, the last but one each kind's first block through
the kernels held against the plain route (``first_block_check``); ``profile``
writes a torch.profiler (chrome) trace of one chain and prints the device time
by kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import sys
import time
from typing import Optional

import torch

ROUTES = ("kernels", "plain")
# the JAX bench's shape: B (2 samples x 6 views), T, S, C, heads, caption tokens
BENCH_SHAPE = dict(B=12, T=5, S=1350, C=1152, heads=16, L=72)
CHAIN, REPS = 8, 3


def patch_points():
    """The three names through which the model's modules reach the wrappers
    (K3 through the dispatcher, which sends a call without a bias on to it)."""
    from ..models.layers import blocks
    from ..models.magicdrive import stdit3
    return ((blocks, "fused_qkv_attention"), (stdit3, "adaln_modulate"),
            (blocks, "dot_product_attention"))


def route_functions(route: str):
    """(K1, K2, K3) of ``route``: the wrappers, or their plain versions (K1's
    fp32 logits six groups at a time)."""
    from .. import ops
    if route == "kernels":
        return ops.fused_qkv_attention, ops.adaln_modulate, ops.dot_product_attention
    if route == "plain":
        return (functools.partial(ops.fused_qkv_attention_plain, group_chunk=6),
                ops.adaln_modulate_plain, ops.plain_attention)
    raise ValueError(f"route must be one of {ROUTES} or three callables, got {route!r}")


@contextlib.contextmanager
def routed(route):
    """Within the block, the model's K1, K2 and K3 sites call ``route``'s
    functions: "kernels", "plain", or a tuple of three callables. Yields the
    functions that were in place; they are put back on exit, whatever raised."""
    fns = route_functions(route) if isinstance(route, str) else tuple(route)
    if len(fns) != 3:
        raise ValueError(f"three functions (K1, K2, K3), got {len(fns)}")
    points = patch_points()
    saved = [getattr(mod, name) for mod, name in points]
    try:
        for (mod, name), fn in zip(points, fns):
            setattr(mod, name, fn)
        yield saved
    finally:
        for (mod, name), fn in zip(points, saved):
            setattr(mod, name, fn)


def make_block(temporal: bool, C: int, heads: int, dtype, device, seed: int = 1):
    """A spatial or temporal MVSTDiTBlock (qk_norm, the default camera
    neighbours) with seeded random weights, cast as the model casts them."""
    from ..models.magicdrive.stdit3 import DEFAULT_MV_ORDER_MAP, MVSTDiTBlock, cast_model
    from ..utils.ckpt import init_weights
    nbr = tuple(tuple(v) for v in DEFAULT_MV_ORDER_MAP.values())
    with torch.device(device):
        block = MVSTDiTBlock(hidden_size=C, num_heads=heads, qk_norm=True,
                             temporal=temporal, neighbors=nbr).eval()
    init_weights(block, seed=seed)
    return cast_model(block, dtype)


def bench_inputs(B: int, T: int, S: int, C: int, L: int, dtype, device, seed: int = 0):
    """x (B, T, S, C), y (B, 1, L, C), t (B/6, 6C): standard normal draws from a
    generator on ``device`` seeded ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    return draw(B, T, S, C), draw(B, 1, L, C), draw(B // 6, 6 * C)


def chain(block, x, y, t, n: int = CHAIN):
    """``n`` applications of ``block``, each on the last one's output."""
    for _ in range(n):
        x = block(x, y, t, None, None)
    return x


def time_chain(block, x, y, t, n: int = CHAIN, reps: int = REPS):
    """ms per block of ``reps`` chains of ``n``, after one untimed chain:
    (median, every chain's, clock). On the card by CUDA events; on the CPU (the
    tests' small runs) by the host clock, which times no device."""
    on_card = x.device.type == "cuda"
    chain(block, x, y, t, n)
    times = []
    for _ in range(reps):
        if on_card:
            torch.cuda.synchronize()
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            chain(block, x, y, t, n)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop) / n)
        else:
            t0 = time.perf_counter()
            chain(block, x, y, t, n)
            times.append((time.perf_counter() - t0) * 1e3 / n)
    return statistics.median(times), times, "cuda events" if on_card else "host (cpu)"


def _launches():
    from .. import ops
    return {name: getattr(ops, name).launches
            for name in ("fused_qkv_attention", "adaln_modulate", "flash_attention")}


def first_block_check(block, x, y, t):
    """One application of ``block`` through the kernels and through the plain
    versions, and the plain one in fp32 on fp32 copies of the weights and inputs.
    The kernels pass when ``rms(kernels - plain) <= 2**-6 * rms(plain inc) +
    rms(plain - plain fp32)``, over the block's increment (output - x): the rule
    the full model's bf16 checks use."""
    import copy
    with torch.no_grad():
        with routed("kernels"):
            out = block(x, y, t, None, None).float()
        with routed("plain"):
            ref = block(x, y, t, None, None).float()
            ref32 = copy.deepcopy(block).float()(x.float(), y.float(), t.float(), None, None)
    rms = lambda a: float(a.square().mean().sqrt())  # noqa: E731
    inc = ref - x.float()
    limit = 2.0 ** -6 * rms(inc) + rms(ref - ref32)
    err = rms(out - ref)
    return dict(max_abs_err=float((out - ref).abs().max()), rms_err=err, rms_limit=limit,
                rms_increment=rms(inc), rms_bf16_vs_fp32=rms(ref - ref32),
                finite=bool(out.isfinite().all()), ok=err <= limit)


def bench(which: str = "both", B: int = 12, T: int = 5, S: int = 1350, C: int = 1152,
          heads: int = 16, L: int = 72, n: int = CHAIN, reps: int = REPS,
          dtype=torch.bfloat16, device="cuda", seed: int = 0):
    """One row a block kind and route: ms per block (median of ``reps`` chains of
    ``n``), every chain's, and the kernel launches of one block."""
    from ..utils.misc import resolve_device
    device = resolve_device(device)
    kinds = {"spatial": (False,), "temporal": (True,), "both": (False, True)}[which]
    x, y, t = bench_inputs(B, T, S, C, L, dtype, device, seed)
    rows = []
    for temporal in kinds:
        block = make_block(temporal, C, heads, dtype, device)
        for route in ROUTES:
            with torch.no_grad(), routed(route):
                before = _launches()
                chain(block, x, y, t, 1)
                per_block = {k: v - before[k] for k, v in _launches().items()}
                ms, all_ms, clock = time_chain(block, x, y, t, n, reps)
            rows.append(dict(block="temporal" if temporal else "spatial", route=route,
                             shape=dict(B=B, T=T, S=S, C=C, heads=heads, L=L),
                             dtype=str(dtype).replace("torch.", ""), chain=n, reps=reps,
                             device=str(device), clock=clock, ms_per_block=ms,
                             ms_per_block_each_chain=all_ms, launches_per_block=per_block))
        del block
    return rows


def check_first_blocks(B: int = 12, T: int = 5, S: int = 1350, C: int = 1152,
                       heads: int = 16, L: int = 72, dtype=torch.bfloat16, device="cuda",
                       seed: int = 0):
    """``first_block_check`` of a spatial and of a temporal block on ``bench``'s
    inputs: {kind: its result}."""
    from ..utils.misc import resolve_device
    device = resolve_device(device)
    x, y, t = bench_inputs(B, T, S, C, L, dtype, device, seed)
    return {kind: first_block_check(make_block(kind == "temporal", C, heads, dtype, device),
                                    x, y, t)
            for kind in ("spatial", "temporal")}


def profile(route: str = "kernels", temporal: bool = False, trace: Optional[str] = None):
    """One chain of ``route`` at the bench shape under torch.profiler (after an
    untimed one): the chrome trace written to ``trace``, and the 20 kernels with
    the most device time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from ..utils.misc import resolve_device
    device = resolve_device("cuda")
    s = BENCH_SHAPE
    x, y, t = bench_inputs(s["B"], s["T"], s["S"], s["C"], s["L"], torch.bfloat16, device)
    block = make_block(temporal, s["C"], s["heads"], torch.bfloat16, device)
    trace = trace or os.path.join(
        "outputs", f"block_bench_trace_{'t' if temporal else 's'}_{route}.json")
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    with torch.no_grad(), routed(route):
        chain(block, x, y, t)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chain(block, x, y, t)
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    rows = sorted(((e.key, e.count, getattr(e, "device_time_total", 0.0) / 1e3)
                   for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0.0) > 0), key=lambda r: -r[2])
    return dict(route=route, block="temporal" if temporal else "spatial", trace=trace,
                top=[dict(name=k[:90], calls=c, ms=ms) for k, c, ms in rows[:20]])


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("which", nargs="?", default="both",
                   choices=["spatial", "temporal", "both", "profile"])
    p.add_argument("--route", default="kernels", choices=ROUTES, help="profile's route")
    p.add_argument("--temporal", action="store_true", help="profile the temporal block")
    p.add_argument("--trace", default=None, help="profile's chrome trace file")
    args = p.parse_args(argv)
    print(json.dumps({"card": card_line(), "torch": torch.__version__}), flush=True)
    t0 = time.time()
    if args.which == "profile":
        print(json.dumps(profile(args.route, args.temporal, args.trace)), flush=True)
    else:
        for row in bench(args.which, **BENCH_SHAPE):
            print(json.dumps(row), flush=True)
        print(json.dumps({"first_block_vs_plain": check_first_blocks(**BENCH_SHAPE)}),
              flush=True)
    print(json.dumps({"seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
