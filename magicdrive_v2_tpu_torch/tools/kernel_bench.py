"""K1 (``fused_qkv_attention``) at the 424p bench shape, three ways (counterpart of
the JAX package's tools/kernel_bench.py, which sets its Pallas kernel against its
XLA reference): the CUDA kernel, its plain PyTorch version, and
``scaled_dot_product_attention`` (no q/k RMSNorm: the nearest library call, summed
over the sources for J=2, on q, k and v laid out as it takes them before the
timed calls).

Shape G=60 groups (two samples x six views x T=5), N=1350 tokens, H=16 heads of
D=72, bf16 on the card; J=1 (spatial self-attention, q/k norm) and J=2 (cross-view
attention over the two neighbour views, ``kv_perm`` = the groups rolled by one
either way). Inputs from numpy ``default_rng(seed)`` as the JAX bench draws them:
qkv standard normal, the norm weights 1 + 0.1 x standard normal.

Each route runs ``loop`` calls back to back, one untimed first; on the card one
pair of CUDA events around the ``loop`` calls gives ms a call ("chained ms"). The
kernel's max abs error is against the plain version on the same inputs. With
``--device cpu`` (the tests) only the plain route runs, timed by the host clock
and labelled so: the kernel route is refused on the CPU, never swapped for the
plain one.

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.tools.kernel_bench [--device cpu] \\
      [--G 60 --N 1350 --H 16 --D 72] [--loop 20]
One JSON line a (route, J), then one with the kernel's errors.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

SHAPE = dict(G=60, N=1350, H=16, D=72)
LOOP = 20
ROUTES = ("kernel", "plain", "sdpa")


def k1_inputs(G: int, N: int, H: int, D: int, dtype, device, seed: int = 0):
    """(qkv (G, N, 3, H, D), q norm weight, k norm weight) as the JAX bench draws
    them, on ``device``: qkv in ``dtype``, the weights fp32."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((G, N, 3, H, D), np.float32))
    qw = torch.from_numpy(rng.standard_normal((D,), np.float32) * 0.1 + 1.0)
    kw = torch.from_numpy(rng.standard_normal((D,), np.float32) * 0.1 + 1.0)
    return qkv.to(device=device, dtype=dtype), qw.to(device), kw.to(device)


def kv_perm(G: int, J: int) -> Optional[np.ndarray]:
    """None for J=1; for J=2 the groups rolled by one either way, (2, G)."""
    if J == 1:
        return None
    return np.stack([np.roll(np.arange(G), 1), np.roll(np.arange(G), -1)]).astype(np.int32)


def route_fn(route: str, qkv, qw, kw, perm):
    """A call of ``route`` on these inputs (no autograd)."""
    import torch.nn.functional as F

    from ..ops.flash_fused import fused_qkv_attention, fused_qkv_attention_plain
    if route == "kernel":
        if qkv.device.type != "cuda":
            raise ValueError("the kernel route runs on the card only; --device cpu runs "
                             "the plain route")
        return lambda: fused_qkv_attention(qkv, qw, kw, perm)
    if route == "plain":
        return lambda: fused_qkv_attention_plain(qkv, qw, kw, perm)
    if route == "sdpa":  # q, k, v laid out (G, H, N, D) and gathered before the call
        G = qkv.shape[0]
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        sources = [np.arange(G)] if perm is None else list(perm)
        kv = [(k[p].contiguous(), v[p].contiguous()) for p in
              (torch.as_tensor(p, device=qkv.device, dtype=torch.long) for p in sources)]

        def sdpa():
            out = None
            for kj, vj in kv:
                o = F.scaled_dot_product_attention(q, kj, vj)
                out = o if out is None else out + o
            return out
        return sdpa
    raise ValueError(f"route must be one of {ROUTES}, got {route!r}")


def chained_ms(fn, loop: int, on_card: bool):
    """ms a call of ``loop`` calls back to back after one untimed call: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    if on_card:
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(loop):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / loop
    t0 = time.perf_counter()
    for _ in range(loop):
        fn()
    return (time.perf_counter() - t0) * 1e3 / loop


def bench(device: str = "cuda", G: int = SHAPE["G"], N: int = SHAPE["N"], H: int = SHAPE["H"],
          D: int = SHAPE["D"], loop: int = LOOP, seed: int = 0,
          routes=None) -> List[Dict]:
    """One row a (route, J): chained ms, the clock, the device (the card's name and
    power limit), the kernel's launches. On the card the routes are kernel, plain
    and sdpa in bf16; on the CPU plain in fp32."""
    on_card = torch.device(device).type == "cuda"
    if routes is None:
        routes = ROUTES if on_card else ("plain",)
    if "kernel" in routes and not on_card:
        raise ValueError("the kernel route runs on the card only")
    from ..ops.flash_fused import fused_qkv_attention
    dtype = torch.bfloat16 if on_card else torch.float32
    qkv, qw, kw = k1_inputs(G, N, H, D, dtype, device, seed)
    from .perf_lab import card_label
    label = card_label() if on_card else "cpu"
    rows = []
    with torch.no_grad():
        for J in (1, 2):
            perm = kv_perm(G, J)
            for route in routes:
                before = fused_qkv_attention.launches
                ms = chained_ms(route_fn(route, qkv, qw, kw, perm), loop, on_card)
                rows.append(dict(route=route, J=J, G=G, N=N, H=H, D=D, dtype=str(dtype)[6:],
                                 ms=ms, loop=loop,
                                 clock="cuda events" if on_card else "host (cpu)",
                                 device=label, kernel_launches=fused_qkv_attention.launches - before))
    return rows


def kernel_cases(G: int = SHAPE["G"], N: int = SHAPE["N"], H: int = SHAPE["H"],
                 D: int = SHAPE["D"], seed: int = 0) -> List[Dict]:
    """On the card, bf16, J=1 and J=2: the kernel's output, the plain version's on
    the same inputs, and the plain version on |v| (``abs_v``: the sum over keys of
    p |v|, which a bf16 limit on their difference scales with, as ``chip_smoke.py``'s
    ``compare`` holds it)."""
    qkv, qw, kw = k1_inputs(G, N, H, D, torch.bfloat16, "cuda", seed)
    abs_v = torch.stack([qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2].abs()], 2)
    out = []
    with torch.no_grad():
        for J in (1, 2):
            perm = kv_perm(G, J)
            out.append(dict(J=J, kernel=route_fn("kernel", qkv, qw, kw, perm)(),
                            plain=route_fn("plain", qkv, qw, kw, perm)(),
                            abs_v=route_fn("plain", abs_v, qw, kw, perm)()))
    return out


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    for k, v in SHAPE.items():
        p.add_argument(f"--{k}", type=int, default=v)
    p.add_argument("--loop", type=int, default=LOOP)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no card (torch.cuda.is_available() is False); "
                         "--device cpu runs the plain version")
    shape = {k: getattr(args, k) for k in SHAPE}
    rows = bench(args.device, **shape, loop=args.loop, seed=args.seed)
    for r in rows:
        print(json.dumps(r), flush=True)
    if on_card:
        errs = [dict(J=c["J"], max_abs_err=float((c["kernel"].float() - c["plain"].float())
                                                 .abs().max()),
                     plain_max_abs=float(c["plain"].float().abs().max()),
                     finite=bool(c["kernel"].isfinite().all()))
                for c in kernel_cases(**shape, seed=args.seed)]
        print(json.dumps({"kernel_vs_plain": errs, "device": rows[0]["device"]}), flush=True)
    return rows


if __name__ == "__main__":
    main()
