#!/usr/bin/env python3
"""Smoke test of the PyTorch / Hopper port on one NVIDIA GPU.

Run ``python3 chip_smoke.py`` from the repository root on a machine with one
card. It imports only ``magicdrive_v2_tpu_torch`` and

1. ``device``   reads the card's name and power limit, builds the three CUDA
                kernels from ``magicdrive_v2_tpu_torch/csrc`` with ``nvcc`` and
                checks that ptxas spilled no register of the bf16 K1 and K3
                kernels;
2. ``shapes``   builds the model of phase 3, counts each kernel's launches over
                ``encode_conditions`` and over one denoiser forward, and notes,
                over a sample of one Euler step, every distinct shape and type
                the model hands to a kernel's wrapper;
3. ``kernels``  holds each kernel against its plain PyTorch version on the card
                (stated limits), in fp32 and bf16, at every shape of phase 2 and
                at further shapes (the long-sequence regime, ragged tiles), and
                times kernel, plain version and the nearest PyTorch library
                call at the main path's shapes (K1 also: its pre-pass alone; K1
                and K3: the achieved TFLOP/s; K3: its share of the bound and the
                time of each q-tiles-per-block setting of its launch plan);
4. ``slice``    drives the main path: MagicDriveSTDiT3-XL/2 at full width and depth
                in bf16, six views of 424x800, 17 frames, batched classifier-free
                guidance, ``MagicDrivePipeline.sample(decode=True)`` for a few
                requests: 30 Euler steps, then the CogVideoX-2b VAE decode in bf16
                one view at a time, with seeded random weights and the
                ``t5-dummy`` text encoder; checks shape, finiteness, determinism
                of the decoded video and that the kernels' launch counters moved
                by the expected amounts; times sampling and decode apart;
5. ``slice_vs_plain``  one forward of the same model at reduced depth in fp32 with
                the kernels against one with their plain versions;
6. ``decode_vs_cpu``  the VAE decode on the card against the CPU's (fp32, TF32 off,
                one view of 5 latent frames, so the 3 + 2 streaming runs), and a
                bf16 against an fp32 decode of one main-path view on the card,
                beside two controls with one cast point moved;
7. ``app``      the inference app (``magicdrive_v2_tpu_torch.scripts.
                inference_magicdrive``) on the 424x800 config with synthetic
                conditioning, 17 frames, 2 steps; checks its launch counters and
                the 17 PNG frames of the 2x3 grid it wrote.

Every phase prints one JSON line. Any failure raises: the exit code is then not
0 and no result line is printed. Without a card the script exits with code 1.

Options (none needed): ``--steps N`` sampling steps (default 30), ``--requests N``
(default 2), ``--seed S`` weights seed, ``--profile`` to add a ``profile`` phase
(device time by kernel over one Euler step and over the decode of one view, from
torch.profiler).

cuDNN keeps its default algorithm choice (``torch.backends.cudnn.benchmark`` off),
under which the rerun of one seed must give the same video bit for bit.
"""
import argparse
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import time

# data-sheet peaks of an H100 SXM: dense bf16 tensor-core rate, fp32 CUDA-core
# rate, device-memory rate. Bounds below are arithmetic on these, not measurements.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

NUM_FRAMES, HEIGHT, WIDTH = 17, 424, 800
APP_CONFIG = "configs/magicdrive/inference/fullx424x800_stdit3_CogVAE_boxTDS_wCT_xCE_wSST.py"
L_BOX = 10  # box slots per frame in the synthetic batch
CAMERA_NEIGHBORS = ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0))


def require(ok, what):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(torch, fn, iters):
    """Mean milliseconds of ``fn`` over ``iters`` launches, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_err(a, b):
    a, b = a.float(), b.float()
    require(bool(a.isfinite().all()), "kernel output is not finite")
    return float((a - b).abs().max()), float(b.abs().max())


FP32_LIMIT = 2e-5  # absolute: the same fp32 arithmetic summed in another order


def compare(torch, out, ref, slack):
    """Hold a kernel's output against its plain version's.

    fp32: ``|out - ref| <= 2e-5`` for every element.
    bf16, two limits:
    - every element: ``|out - ref| <= 2**-7 * |ref| + slack``. Both sides round one
      fp32 value to bf16 at the end, so where their fp32 values differ the results
      may be neighbouring bf16 numbers: one ulp, at most ``2**-7 * |ref|``. ``slack``
      (a number or a tensor of ref's shape) bounds how far the two fp32 values can
      lie apart. For the attention kernels that is the rounding of the
      probabilities to bf16 ahead of p.v, of unnormalised ones in the kernel and of
      normalised ones in the plain version: at most a relative 2**-8 (half an
      ulp at the bottom of a binade) on every term of each side, so
      ``2**-7 * sum_m p_m |v_m|``, which the caller computes as the plain version
      on ``|v|``. This is the worst case; the second limit is the tight one. For adaLN both sides are fp32 arithmetic on the same
      numbers.
    - the whole tensor: ``rms(out - ref) <= 2**-6 * rms(ref)``: one-ulp differences
      on a part of the values stay well below it; a wrong logit or weight does not.
    Returns (max abs error, largest element's error / limit, rms error / limit
    [0 in fp32], rms(ref)).
    """
    dtype = out.dtype
    out, ref = out.float(), ref.float()
    require(out.shape == ref.shape, (out.shape, ref.shape))
    require(bool(out.isfinite().all()), "kernel output is not finite")
    diff = (out - ref).abs()
    rms = float(ref.square().mean().sqrt())
    require(rms > 0.0, "reference is all zero")
    if dtype == torch.float32:
        return float(diff.max()), float(diff.max()) / FP32_LIMIT, 0.0, rms
    return (float(diff.max()), float((diff / (2.0 ** -7 * ref.abs() + slack)).max()),
            float(diff.square().mean().sqrt()) / (2.0 ** -6 * rms), rms)


ADALN_SLACK = 2e-5  # absolute, as in fp32


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def cross_view_perm(n_groups_of_views, neighbors=CAMERA_NEIGHBORS):
    """The (2, G) group permutation CrossViewAttention builds for G = n * 6 views."""
    import numpy as np
    nbr = np.asarray(neighbors)
    base = np.arange(n_groups_of_views)[:, None] * nbr.shape[0]
    return np.stack([(base + nbr[None, :, j]).reshape(-1) for j in range(nbr.shape[1])]
                    ).astype(np.int32)


# K3 shapes (B, N, M, H, D) for the bf16 body's other branches: k/v too long to
# stay in shared memory (streamed through the ring) at every head dim; q tiles
# that do not fill the last run of a block (7 tiles in runs of 4 and 3), the last
# q tile ragged
K3_BRANCH_CASES = ((2, 300, 2000, 4, 72), (2, 130, 400, 2, 144), (1, 70, 4000, 2, 8),
                   (1, 70, 4000, 2, 16), (2, 850, 150, 4, 72))


def check_kernels(torch, seen, l_cond):
    """``seen``: what ``recorded_shapes`` noted on the main path."""
    import torch.nn.functional as F
    from magicdrive_v2_tpu_torch.ops import (adaln_modulate, adaln_modulate_plain,
                                             flash_attention, flash_attention_plain,
                                             flash_fused, fused_qkv_attention,
                                             fused_qkv_attention_plain)
    from magicdrive_v2_tpu_torch.ops.flash_attention import attend_bf16, plan_bf16
    dev = "cuda"
    gen = torch.Generator(device="cpu").manual_seed(0)
    both = (torch.float32, torch.bfloat16)
    cases = []
    worst_err = {"fused_qkv_attention": 0.0, "adaln_modulate": 0.0, "flash_attention": 0.0}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def judge(kernel, out, ref, slack, **what):
        torch.cuda.synchronize()
        err, ratio, rms_ratio, rms = compare(torch, out, ref, slack)
        cases.append(dict(kernel=kernel, **what, dtype=str(out.dtype), max_abs_err=err,
                          ref_rms=rms, err_over_limit=ratio, rms_err_over_limit=rms_ratio))
        require(ratio <= 1.0 and rms_ratio <= 1.0, cases[-1])
        worst_err[kernel] = max(worst_err[kernel], err)

    # ---- K1 fused qkv attention
    def run_k1(G, N, H, D, dtype, norm, perm, main_path=False):
        qkv = randn(G, N, 3, H, D, dtype=dtype)
        qw = kw = None
        if norm:
            qw = (torch.randn(D, generator=gen) * 0.1 + 1).to(dev)
            kw = (torch.randn(D, generator=gen) * 0.1 + 1).to(dev)
        J = 1 if perm is None or torch.as_tensor(perm).ndim == 1 else len(perm)
        out = fused_qkv_attention(qkv, qw, kw, perm)
        ref = fused_qkv_attention_plain(qkv, qw, kw, perm, group_chunk=min(G, 6))
        slack = None
        if dtype == torch.bfloat16:  # sum_m p_m |v_m|, summed over the sources too
            qkv[:, :, 2].abs_()
            slack = 2.0 ** -7 * fused_qkv_attention_plain(
                qkv, qw, kw, perm, group_chunk=min(G, 6)).float()
        judge("fused_qkv_attention", out, ref, slack, shape=[G, N, H, D],
              J=J, norm=norm, main_path=main_path)

    G, N, H, D = 60, 1350, 16, 72
    main_k1 = {((G, N, 3, H, D), torch.bfloat16, True, J) for J in (1, 2)}
    require(main_k1 <= set(seen["fused_qkv_attention"]), sorted(map(str, seen["fused_qkv_attention"])))
    for (shape, _, norm, _), perm in sorted(seen["fused_qkv_attention"].items(), key=str):
        for dtype in both:
            run_k1(shape[0], shape[1], shape[3], shape[4], dtype, norm, perm, main_path=True)
    for dtype in both:
        for norm in (True, False):
            # N=1350 (424x800) and N=5300 (848x1600): the regimes of the three TPU bodies
            run_k1(6, 1350, 16, 72, dtype, norm, None)
            run_k1(6, 1350, 16, 72, dtype, norm, cross_view_perm(1))
            run_k1(2, 5300, 16, 72, dtype, norm, None)
        run_k1(6, 5300, 16, 72, dtype, True, cross_view_perm(1))
        # ragged tiny shapes: last q and k tiles partial, head dims below the tile widths
        run_k1(3, 70, 2, 8, dtype, True, [[1, 2, 0], [2, 0, 1]])
        run_k1(2, 130, 3, 24, dtype, True, [1, 0])

    # timing at the main path's shapes, bf16: G = 60 groups of N = 1350 tokens
    qkv = randn(G, N, 3, H, D, dtype=torch.bfloat16)
    qw = (torch.randn(D, generator=gen) * 0.1 + 1).to(dev)
    perm = torch.from_numpy(cross_view_perm(G // 6)).to(dev)
    before = fused_qkv_attention.launches
    k1 = dict(
        ms=time_ms(torch, lambda: fused_qkv_attention(qkv, qw, qw, None), 5),
        ms_cross_view=time_ms(torch, lambda: fused_qkv_attention(qkv, qw, qw, perm), 5),
        plain_ms=time_ms(torch, lambda: fused_qkv_attention_plain(
            qkv, qw, qw, None, group_chunk=6), 1),
        plain_ms_cross_view=time_ms(torch, lambda: fused_qkv_attention_plain(
            qkv, qw, qw, perm, group_chunk=6), 1))
    # every timed call launched the kernel: 2 x (1 warm-up + 5 timed)
    require(fused_qkv_attention.launches == before + 12, "launch counter while timing")
    # the bf16 kernel's pre-pass alone (k norm and tiling; part of every launch above)
    plan = flash_fused.plan_bf16(G, N, H, D)
    k1["prepass_ms"] = time_ms(torch, lambda: flash_fused.tile_k(qkv, qw, plan), 10)
    # library yardsticks: scaled_dot_product_attention on the q/k/v views (the
    # attention alone: it leaves out the q/k RMSNorm the kernel also does); for
    # cross-view two such calls, on the two sources' k/v (gathered beforehand), summed
    q_, k_, v_ = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    k1["library_ms"] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(q_, k_, v_), 5)
    kv_src = [(k_[perm[j].long()], v_[perm[j].long()]) for j in range(2)]
    k1["library_ms_cross_view"] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(q_, *kv_src[0])
        + F.scaled_dot_product_attention(q_, *kv_src[1]), 5)
    flops = 4.0 * G * H * N * N * D
    nbytes = 2.0 * (qkv.numel() + G * N * H * D)
    k1["bound_ms"], k1["bound_by"] = bound(flops, nbytes, PEAK_BF16)
    k1["bound_ms_cross_view"] = bound(2 * flops, nbytes, PEAK_BF16)[0]
    k1["tflops"] = flops / (k1["ms"] * 1e9)
    k1["tflops_cross_view"] = 2 * flops / (k1["ms_cross_view"] * 1e9)
    # the long-sequence regime (848x1600: N = 5300), fewer groups
    qkv_l = randn(12, 5300, 3, H, D, dtype=torch.bfloat16)
    k1["ms_n5300_g12"] = time_ms(torch, lambda: fused_qkv_attention(qkv_l, qw, qw, None), 2)
    flops_l = 4.0 * 12 * H * 5300 * 5300 * D
    k1["bound_ms_n5300_g12"] = bound(flops_l, 2.0 * (qkv_l.numel() + 12 * 5300 * H * D),
                                     PEAK_BF16)[0]
    k1["tflops_n5300_g12"] = flops_l / (k1["ms_n5300_g12"] * 1e9)
    k1["plain_ms_n5300_g12"] = time_ms(torch, lambda: fused_qkv_attention_plain(
        qkv_l, qw, qw, None, group_chunk=1), 1)
    ql, kl, vl = (qkv_l[:, :, i].transpose(1, 2) for i in range(3))
    k1["library_ms_n5300_g12"] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(ql, kl, vl), 2)
    del ql, kl, vl, qkv, qkv_l, q_, k_, v_, kv_src

    # ---- K2 adaLN modulate
    def run_k2(B, n, C, dtype, main_path=False):
        x = randn(B, n, C, dtype=dtype) * 3 + 0.5
        sh, sc = randn(B, C, dtype=dtype), randn(B, C, dtype=dtype)
        judge("adaln_modulate", adaln_modulate(x, sh, sc), adaln_modulate_plain(x, sh, sc),
              ADALN_SLACK, shape=[B, n, C], main_path=main_path)

    B, n, C = 12, 6750, 1152
    require(((B, n, C), torch.bfloat16) in seen["adaln_modulate"],
            sorted(map(str, seen["adaln_modulate"])))
    for dtype in both:
        for shape, _ in sorted(seen["adaln_modulate"], key=str):
            run_k2(*shape, dtype, main_path=True)
        # the tiny configuration's width, the widest row and the narrowest
        for shape in ((2, 37, 64), (2, 5, 1280), (3, 9, 8)):
            run_k2(*shape, dtype)
    x = randn(B, n, C, dtype=torch.bfloat16)
    sh, sc = randn(B, C, dtype=torch.bfloat16), randn(B, C, dtype=torch.bfloat16)
    k2 = dict(
        ms=time_ms(torch, lambda: adaln_modulate(x, sh, sc), 20),
        plain_ms=time_ms(torch, lambda: adaln_modulate_plain(x, sh, sc), 3),
        # library yardstick: F.layer_norm, then the modulation as two more passes
        library_ms=time_ms(torch, lambda: F.layer_norm(x, (C,), eps=1e-6)
                           * (1 + sc[:, None]) + sh[:, None], 5))
    k2["bound_ms"], k2["bound_by"] = bound(8.0 * x.numel(), 2.0 * (2 * x.numel() + 2 * B * C),
                                           PEAK_FP32)
    del x

    # ---- K3 flash attention: the condition cross-attention's shapes
    def run_k3(B, n, M, H_, D_, dtype, main_path=False):
        q = randn(B, n, H_, D_, dtype=dtype)
        kv = randn(B, M, 2, H_, D_, dtype=dtype)  # k and v as views of one projection
        k, v = kv[:, :, 0], kv[:, :, 1]
        slack = None
        if dtype == torch.bfloat16:
            slack = 2.0 ** -7 * flash_attention_plain(q, k, v.abs()).float()
        judge("flash_attention", flash_attention(q, k, v), flash_attention_plain(q, k, v),
              slack, shape=[B, n, M, H_, D_], main_path=main_path)

    B, n, M = 60, 1350, l_cond
    require(((B, n, H, D), M, torch.bfloat16) in seen["flash_attention"],
            sorted(map(str, seen["flash_attention"])))
    for dtype in both:
        for (qshape, m, _) in sorted(seen["flash_attention"], key=str):
            run_k3(qshape[0], qshape[1], m, qshape[2], qshape[3], dtype, main_path=True)
        # the cross-attention's other layout (one condition sequence for all frames),
        # a ragged key length, tiny heads
        for shape in ((12, 6750, l_cond, 16, 72), (3, 1350, 77, 16, 72),
                      (2, 50, 13, 2, 8), (2, 77, 200, 4, 16)):
            run_k3(*shape, dtype)
        for shape in K3_BRANCH_CASES:
            run_k3(*shape, dtype)
    q = randn(B, n, H, D, dtype=torch.bfloat16)
    kv = randn(B, M, 2, H, D, dtype=torch.bfloat16)
    kk, vv = kv[:, :, 0], kv[:, :, 1]
    plan = plan_bf16(B, n, M, H, D)
    k3 = dict(
        ms=time_ms(torch, lambda: flash_attention(q, kk, vv), 10),
        plain_ms=time_ms(torch, lambda: flash_attention_plain(q, kk, vv), 2),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2)), 10),
        plan=dict(resident=plan.resident, q_tiles_per_block=plan.run, blocks=plan.blocks,
                  smem_bytes=plan.smem_bytes))
    flops = 4.0 * B * H * n * M * D
    k3["bound_ms"], k3["bound_by"] = bound(flops, 2.0 * (2 * q.numel() + kv.numel()), PEAK_BF16)
    k3["tflops"] = flops / (k3["ms"] * 1e9)
    k3["bound_share"] = k3["bound_ms"] / k3["ms"]
    # every q-tiles-per-block setting of the launch plan, each bit-equal to the
    # wrapper's output (a q row's arithmetic does not depend on the run)
    ref = flash_attention(q, kk, vv)
    k3["ms_by_q_tiles_per_block"] = {}
    for run in (1, 2, 3, 4, 6, 11):
        p_run = plan_bf16(B, n, M, H, D, run=run)
        require(torch.equal(attend_bf16(q, kk, vv, D ** -0.5, p_run), ref), f"run {run}")
        k3["ms_by_q_tiles_per_block"][str(run)] = time_ms(
            torch, lambda: attend_bf16(q, kk, vv, D ** -0.5, p_run), 10)
    del q, kv, ref
    torch.cuda.empty_cache()
    k1["max_abs_err"] = worst_err["fused_qkv_attention"]
    k2["max_abs_err"] = worst_err["adaln_modulate"]
    k3["max_abs_err"] = worst_err["flash_attention"]
    emit("kernel_cases", fp32_limit=FP32_LIMIT,
         bf16_limit="every element 2**-7 * |ref| + slack, slack = 2**-7 * sum p|v| "
                    f"(attention) or {ADALN_SLACK} (adaLN); and rms(err) <= 2**-6 * rms(ref)",
         cases=cases)
    return {"fused_qkv_attention": k1, "adaln_modulate": k2, "flash_attention": k3}


# ---------------------------------------------------------------------------
# phases 3 and 4: the slice
# ---------------------------------------------------------------------------


def xl2_config(torch, dtype, **overrides):
    from magicdrive_v2_tpu_torch.config.presets import MV_ORDER_MAP, xl2_model
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
    return build_model_config(xl2_model(control_skip_temporal=False), vae_out_channels=16,
                              mv_order_map=MV_ORDER_MAP, dtype=dtype, **overrides)


def cogvideox_vae(torch, dtype, seed, device="cuda"):
    """The CogVideoX-2b VAE as the 424x800 config builds it (one view at a time),
    seeded random weights."""
    from magicdrive_v2_tpu_torch.models.vae.cogvideox import (CogVAEConfig,
                                                              VideoAutoencoderKLCogVideoX)
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    vae = VideoAutoencoderKLCogVideoX(CogVAEConfig(dtype=dtype), micro_batch_size=1,
                                      device=device)
    init_weights(vae.module, seed=seed)
    return vae


def decode_flops(torch, vae, latent_shape):
    """Multiply-adds x 2 of every convolution of ``vae.decode`` on a latent of
    ``latent_shape``, counted from the shapes on the meta device."""
    import torch.nn.functional as F
    from magicdrive_v2_tpu_torch.models.vae.cogvideox import VideoAutoencoderKLCogVideoX
    meta = VideoAutoencoderKLCogVideoX(vae.cfg, micro_batch_size=vae.micro_batch_size,
                                       device="meta")
    total, conv3d = [0], F.conv3d

    def counting(x, w, *args, **kw):
        y = conv3d(x, w, *args, **kw)
        total[0] += 2 * y.numel() * w[0].numel()
        return y

    F.conv3d = counting
    try:
        meta.decode(torch.zeros(latent_shape, device="meta", dtype=vae.dtype))
    finally:
        F.conv3d = conv3d
    return total[0]


def expected_launches(cfg):
    """Kernel launches of one denoiser forward with a condition cache."""
    n_ctrl_t = 0 if cfg.control_skip_temporal else cfg.control_depth
    n_base_t = cfg.depth if cfg.with_temp_block else 0
    spatial = cfg.depth + cfg.control_depth
    cross_view = cfg.depth + (0 if cfg.control_skip_cross_view else cfg.control_depth)
    blocks = spatial + n_base_t + n_ctrl_t
    return {"fused_qkv_attention": spatial + cross_view,
            "adaln_modulate": 2 * blocks + cross_view,
            "flash_attention": blocks}


def counters():
    from magicdrive_v2_tpu_torch.ops import (adaln_modulate, flash_attention,
                                             fused_qkv_attention)
    return {"fused_qkv_attention": fused_qkv_attention, "adaln_modulate": adaln_modulate,
            "flash_attention": flash_attention}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


def profiled(torch, what, fn):
    """``fn()`` once under torch.profiler (after one warm-up call): device time by
    kernel name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.time() - t0
    rows = [(e.key, e.count, getattr(e, "device_time_total", 0.0) / 1e3)
            for e in prof.key_averages() if getattr(e, "device_time_total", 0.0) > 0
            and getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower()]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    emit("profile", what=what, wall_ms=wall * 1e3, device_busy_ms=busy,
         device_idle_share=max(0.0, 1.0 - busy / (wall * 1e3)),
         top=[dict(name=n[:90], calls=c, ms=ms) for n, c, ms in rows[:30]])


def profile_step(torch, pipe, cond):
    """One single-step sample, and the decode of one view, under torch.profiler."""
    from magicdrive_v2_tpu_torch.config.presets import rflow
    from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
    pipe.scheduler = build_scheduler(rflow(num_sampling_steps=1))
    kw = dict(num_frames=NUM_FRAMES, height=HEIGHT, width=WIDTH, torch_seed=1024, decode=False)
    profiled(torch, "one Euler step (sample with 1 step, encode_conditions included)",
             lambda: pipe.sample(cond, **kw))
    z = pipe.sample(cond, **kw)[:, ::6].to(pipe.vae.dtype)  # one view's 16 channels
    profiled(torch, "VAE decode of one view (5 latent frames as 3 + 2)",
             lambda: pipe.vae.decode(z))


def patch_points():
    """The three names through which the model's modules reach the wrappers
    (flash_attention through the dispatcher, which sends a call without a bias on
    to it)."""
    from magicdrive_v2_tpu_torch.models.layers import blocks
    from magicdrive_v2_tpu_torch.models.magicdrive import stdit3
    return ((blocks, "fused_qkv_attention"), (stdit3, "adaln_modulate"),
            (blocks, "dot_product_attention"))


@contextlib.contextmanager
def patched(*replacements):
    points = patch_points()
    saved = [getattr(mod, name) for mod, name in points]
    for (mod, name), fn in zip(points, replacements):
        setattr(mod, name, fn)
    try:
        yield saved
    finally:
        for (mod, name), fn in zip(points, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def recorded_shapes(seen):
    """Note every distinct shape and type the model hands to a kernel's wrapper,
    then call the wrapper as the model would."""
    k1, k2, k3 = (getattr(mod, name) for mod, name in patch_points())

    def rec_k1(qkv, qw, kw, kv_perm=None, scale=None):
        J = 1 if kv_perm is None else len(kv_perm)
        seen["fused_qkv_attention"].setdefault(
            (tuple(qkv.shape), qkv.dtype, qw is not None, J), kv_perm)
        return k1(qkv, qw, kw, kv_perm, scale)

    def rec_k2(x, shift, scale, eps=1e-6):
        seen["adaln_modulate"].add((tuple(x.shape), x.dtype))
        return k2(x, shift, scale, eps)

    def rec_k3(q, k, v, scale=None, bias=None):
        if bias is None:
            seen["flash_attention"].add((tuple(q.shape), k.shape[1], q.dtype))
        return k3(q, k, v, scale=scale, bias=bias)

    with patched(rec_k1, rec_k2, rec_k3):
        yield


def to_card(torch, batch):
    dev = {k: (v if not hasattr(v, "shape") else torch.from_numpy(v).cuda())
           for k, v in batch.items() if k != "bbox"}
    dev["bbox"] = {k: torch.from_numpy(v).cuda() for k, v in batch["bbox"].items()}
    return dev


def build_slice(torch, steps, seed):
    """The pipeline of the ``slice`` phase; from ``encode_conditions`` and one
    denoiser forward with a condition cache the launches of each kernel; from a
    one-step sample the shapes each wrapper is given on the main path."""
    from magicdrive_v2_tpu_torch.config.presets import rflow
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import (MagicDrivePipeline,
                                                              synthetic_batch)
    from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights

    cfg = xl2_config(torch, torch.bfloat16)
    t0 = time.time()
    pipe = MagicDrivePipeline(cfg, build_scheduler(rflow(num_sampling_steps=steps)),
                              vae=cogvideox_vae(torch, torch.bfloat16, seed + 1))
    init_weights(pipe.model, seed=seed)
    setup_s = time.time() - t0
    batch = synthetic_batch(cfg, NUM_FRAMES, HEIGHT, WIDTH, l_box=L_BOX)
    per_forward = expected_launches(cfg)
    require(per_forward == {"fused_qkv_attention": 69, "adaln_modulate": 192,
                           "flash_attention": 82}, per_forward)

    # the counters rise by exactly the per-forward numbers (encode_conditions is
    # counted apart: its small temporal transformers reach flash_attention too)
    model = pipe.model
    with torch.no_grad():
        dev_batch = to_card(torch, batch)
        reset_counters()
        cache = model.encode_conditions(
            tuple(dev_batch["x"].shape), dev_batch["y"], dev_batch["maps"],
            dev_batch["bbox"], dev_batch["cams"], dev_batch["rel_pos"])
        encode_launches = read_counters()
        reset_counters()
        out = model(**dev_batch, cond_cache=cache)
        torch.cuda.synchronize()
    require(read_counters() == per_forward, (read_counters(), per_forward))
    require(out.shape == dev_batch["x"].shape and bool(out.isfinite().all()),
            "forward output shape / finiteness")
    l_cond = int(cache[0].shape[2])
    del out, cache, dev_batch

    # the shapes of the main path: one sample of a single Euler step (batched
    # classifier-free guidance doubles the batch of the forward above)
    cond = {k: batch[k] for k in ("y", "maps", "bbox", "cams", "rel_pos", "fps")}
    seen = {"fused_qkv_attention": {}, "adaln_modulate": set(), "flash_attention": set()}
    scheduler, pipe.scheduler = pipe.scheduler, build_scheduler(rflow(num_sampling_steps=1))
    reset_counters()
    with recorded_shapes(seen):
        pipe.sample(cond, num_frames=NUM_FRAMES, height=HEIGHT, width=WIDTH,
                    torch_seed=1024, decode=False)
    pipe.scheduler = scheduler
    want = {k: per_forward[k] + encode_launches[k] for k in per_forward}
    require(read_counters() == want, (read_counters(), want))
    # one view's decode, so that the timed requests find cuDNN's first calls at
    # these shapes done, as the denoiser's are by the sample above
    with torch.no_grad():
        pipe.vae.decode(torch.zeros((1, 16, 5, HEIGHT // 8, WIDTH // 8), device="cuda",
                                    dtype=pipe.vae.dtype))
        torch.cuda.synchronize()
    emit("shapes", l_cond=l_cond, setup_seconds=setup_s,
         launches_per_forward=per_forward, launches_encode_conditions=encode_launches,
         fused_qkv_attention=[dict(qkv=list(k[0]), dtype=str(k[1]), norm=k[2], J=k[3])
                              for k in seen["fused_qkv_attention"]],
         adaln_modulate=[dict(x=list(k[0]), dtype=str(k[1])) for k in seen["adaln_modulate"]],
         flash_attention=[dict(q=list(k[0]), M=k[1], dtype=str(k[2]))
                          for k in seen["flash_attention"]])
    return pipe, cond, per_forward, encode_launches, l_cond, seen


def run_slice(torch, pipe, cond, per_forward, encode_launches, l_cond, steps, requests,
              with_profile=False):
    n_params = sum(p.numel() for p in pipe.model.parameters())
    latent_shape = (1, 96, 5, 53, 100)
    video_shape = (1, 6, 3, NUM_FRAMES, HEIGHT, WIDTH)
    # the decode's own time: the pipeline's decode step, synchronised around it
    decode_seconds, latents = [], []
    pipeline_decode = pipe.decode

    def timed_decode(z):
        latents.append(z)
        torch.cuda.synchronize()
        t0 = time.time()
        out = pipeline_decode(z)
        torch.cuda.synchronize()
        decode_seconds.append(time.time() - t0)
        return out

    pipe.decode = timed_decode
    videos, seconds, launches = [], [], None
    peak = 0
    for r in range(requests):
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.time()
        v = pipe.sample(cond, num_frames=NUM_FRAMES, height=HEIGHT, width=WIDTH,
                        torch_seed=1024 + r)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        got = read_counters()
        peak = max(peak, torch.cuda.max_memory_allocated())
        require(tuple(latents[-1].shape) == latent_shape, latents[-1].shape)
        require(tuple(v.shape) == video_shape, v.shape)
        require(v.dtype == torch.float32 and bool(v.isfinite().all()), "video fp32 and finite")
        # batched CFG: one forward per step; encode_conditions runs once per sample
        want = {k: per_forward[k] * steps + encode_launches[k] for k in per_forward}
        require(got == want, (got, want))
        require(all(x > 0 for x in got.values()), got)
        launches = got if launches is None else launches
        videos.append(v)
    if requests > 1:
        require(float((videos[0] - videos[1]).abs().max()) > 1e-3, "seeds gave one result")

    # determinism: the first request again, bit for bit, decoded video included
    v_again = pipe.sample(cond, num_frames=NUM_FRAMES, height=HEIGHT, width=WIDTH,
                          torch_seed=1024)
    require(torch.equal(latents[-1], latents[0]), "two runs of one seed differ (latents)")
    require(torch.equal(v_again, videos[0]), "two runs of one seed differ (video)")
    pipe.decode = pipeline_decode
    flops = decode_flops(torch, pipe.vae, (6, 16) + latent_shape[2:])
    sampling = [s - d for s, d in zip(seconds, decode_seconds)]
    emit("slice", model="MagicDriveSTDiT3-XL/2", dtype="bfloat16", params=n_params,
         views=6, frames=NUM_FRAMES, height=HEIGHT, width=WIDTH, steps=steps,
         requests=requests, latent_shape=list(latent_shape), video_shape=list(video_shape),
         l_cond=l_cond, seconds_per_sample=sampling,
         seconds_per_step=[s / steps for s in sampling],
         decode_seconds_per_sample=decode_seconds[:requests],
         seconds_per_sample_with_decode=seconds,
         decode_tflop=flops / 1e12, decode_bound_seconds=flops / PEAK_BF16,
         decode_tflops=[flops / (d * 1e12) for d in decode_seconds[:requests]],
         launches_per_forward=per_forward, launches_encode_conditions=encode_launches,
         launches_per_sample=launches, peak_memory_bytes=peak,
         latent_abs_mean=float(latents[0].abs().mean()),
         video_abs_mean=float(videos[0].abs().mean()), deterministic=True)
    del videos, v_again, latents
    if with_profile:
        profile_step(torch, pipe, cond)
    return launches


@contextlib.contextmanager
def no_tf32(torch):
    """fp32 matmuls and convolutions in full fp32 for the duration; the flags are
    restored to what they were."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def plain_versions():
    """Route the model through the kernels' plain versions on the card (for the
    comparison only: the package itself has no such switch)."""
    from magicdrive_v2_tpu_torch import ops
    with patched(functools.partial(ops.fused_qkv_attention_plain, group_chunk=6),
                 ops.adaln_modulate_plain, ops.plain_attention):
        yield


def run_slice_vs_plain(torch, seed):
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights

    cfg = xl2_config(torch, torch.float32, depth=2, control_depth=1)
    with torch.device("cuda"):
        model = MagicDriveSTDiT3(cfg).eval()
    init_weights(model, seed=seed)
    batch = synthetic_batch(cfg, NUM_FRAMES, HEIGHT, WIDTH, l_box=L_BOX)
    dev = to_card(torch, batch)
    with torch.no_grad(), no_tf32(torch):
        reset_counters()
        out = model(**dev)
        torch.cuda.synchronize()
        with_kernels = read_counters()
        with plain_versions():
            reset_counters()
            ref = model(**dev)
            torch.cuda.synchronize()
            require(sum(read_counters().values()) == 0, read_counters())
    require(all(v > 0 for v in with_kernels.values()), with_kernels)
    err, scale = max_err(out, ref)
    # fp32 kernels against fp32 compositions through three layer groups of
    # width 1152: differences of summation order only
    limit = 1e-3 * max(1.0, scale)
    emit("slice_vs_plain", dtype="float32", depth=cfg.depth, control_depth=cfg.control_depth,
         output_shape=list(out.shape), max_abs_err=err, ref_max=scale, limit=limit,
         launches=with_kernels)
    require(scale > 1e-3 and err <= limit, (err, scale, limit))


DECODE_FP32_LIMIT = 1e-4  # absolute, frames of order 1: fp32 in another summation order
DECODE_BF16_RMS_LIMIT = 2.0 ** -5.5  # rms(bf16 - fp32) / rms(fp32), see run_decode_vs_cpu


def _group_norm_in_bf16(self, x):
    """GroupNorm wholly in the input's dtype, statistics and affine included: the
    cast point that a missing ``.float()`` gives (control only)."""
    import torch
    n, c = x.shape[:2]
    var, mean = torch.var_mean(x.view(n, self.num_groups, -1), dim=2, unbiased=False)
    per_group = c // self.num_groups
    a = torch.rsqrt(var + self.eps).repeat_interleave(per_group, 1) * self.weight.to(x.dtype)
    b = self.bias.to(x.dtype) - mean.repeat_interleave(per_group, 1) * a
    shape = (n, c) + (1,) * (x.dim() - 2)
    return torch.addcmul(b.view(shape), x, a.view(shape))


@contextlib.contextmanager
def wrong_cast_point(torch, kind):
    """Move one cast point of the port's VAE, for the controls of
    ``run_decode_vs_cpu``; the package itself has no such switch. Every
    convolution of the VAE goes through ``F.conv3d``."""
    import torch.nn.functional as F
    from magicdrive_v2_tpu_torch.models.vae import cogvideox
    conv3d = F.conv3d

    def conv_bias_after_rounding(x, w, bias=None, *args, **kw):
        y = conv3d(x, w, None, *args, **kw)  # rounded to bf16, then the bias added
        return y if bias is None else y + bias.view(1, -1, 1, 1, 1)

    owner, name, fn = {"group_norm_in_bf16": (cogvideox.GroupNorm, "forward",
                                              _group_norm_in_bf16),
                       "conv_bias_after_rounding": (F, "conv3d",
                                                    conv_bias_after_rounding)}[kind]
    saved = getattr(owner, name)
    setattr(owner, name, fn)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def run_decode_vs_cpu(torch, seed):
    """fp32 decode on the card (TF32 off) against the CPU's, one view of 5 latent
    frames of 8x10 (3 + 2 streamed); then bf16 against fp32 on the card for one
    view at the main path's latent size, for the port's cast points and for two
    controls that each move one of them (GroupNorm wholly in bf16; the conv bias
    added after rounding). The bf16 limit bounds the drift of ~60 layers that each
    round their output to bf16 (relative 2**-9), measured on an H100 at 2**-6.8 to
    2**-6.7 of the rms over three seeds, so it leaves 2.3x: it catches arithmetic that loses
    more than rounding does (a wrong scale, a dropped term). It does not catch a
    misplaced cast point: the controls read 1.00x and 1.05-1.07x the sound
    reading, and are reported, not judged."""
    gen = torch.Generator().manual_seed(seed)
    with no_tf32(torch):
        on_card = cogvideox_vae(torch, torch.float32, seed + 1)
        on_cpu = cogvideox_vae(torch, torch.float32, seed + 1, device="cpu")
        z = torch.randn(1, 16, 5, 8, 10, generator=gen)
        out, ref = on_card.decode(z.cuda()).cpu(), on_cpu.decode(z)
        require(tuple(out.shape) == (1, 3, 17, 64, 80), out.shape)
        err, scale = max_err(out, ref)
        require(scale > 1e-2 and err <= DECODE_FP32_LIMIT, (err, scale))
        del on_cpu
        z = torch.randn(1, 16, 5, 53, 100, generator=gen).cuda()
        f32 = on_card.decode(z)
        del on_card
    torch.cuda.empty_cache()
    vae = cogvideox_vae(torch, torch.bfloat16, seed + 1)
    rms = float(f32.square().mean().sqrt())

    def rms_ratio(video):
        require(bool(video.isfinite().all()), "bf16 decode not finite")
        return float((video.float() - f32).square().mean().sqrt()) / rms

    b16 = vae.decode(z.bfloat16())
    ratio = rms_ratio(b16)
    controls = {}
    for kind in ("group_norm_in_bf16", "conv_bias_after_rounding"):
        with wrong_cast_point(torch, kind):
            controls[kind] = rms_ratio(vae.decode(z.bfloat16()))
    emit("decode_vs_cpu", fp32_shape=list(out.shape), fp32_max_abs_err=err, fp32_ref_max=scale,
         fp32_limit=DECODE_FP32_LIMIT, bf16_shape=list(f32.shape), fp32_rms=rms,
         bf16_rms_err_ratio=ratio, bf16_rms_ratio_limit=DECODE_BF16_RMS_LIMIT,
         bf16_max_abs_err=float((b16.float() - f32).abs().max()),
         control_rms_err_ratio=controls)
    require(rms > 1e-2, rms)
    require(ratio <= DECODE_BF16_RMS_LIMIT, (ratio, DECODE_BF16_RMS_LIMIT))


def run_app(torch, per_forward, encode_launches):
    """The inference app on the 424x800 config, synthetic conditioning, 17 frames,
    2 steps; its frames are written under outputs/ in the checkout, read back, and
    removed."""
    from magicdrive_v2_tpu_torch.scripts import inference_magicdrive
    from magicdrive_v2_tpu_torch.utils.inference_utils import read_png
    out_dir = os.path.join("outputs", "chip_smoke_app")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    reset_counters()
    saved = inference_magicdrive.main(
        [APP_CONFIG, "--synthetic", "--num-frames", str(NUM_FRAMES), "--num-samples", "1",
         "--cfg-options", "scheduler.num_sampling_steps=2", f"outputs={out_dir}"])
    got = read_counters()
    seconds = time.time() - t0
    want = {k: per_forward[k] * 2 + encode_launches[k] for k in per_forward}
    require(got == want, (got, want))
    require(len(saved) == 1, len(saved))
    path, frames = saved[0]
    names = sorted(os.listdir(path))
    require(names == [f"{i:04d}.png" for i in range(NUM_FRAMES)], names)
    require(frames.shape == (NUM_FRAMES, 2 * HEIGHT, 3 * WIDTH, 3), frames.shape)
    for i, name in enumerate(names):
        require(bool((read_png(os.path.join(path, name)) == frames[i]).all()), name)
    require(float(frames.std()) > 1.0, "constant frames")
    nbytes = sum(os.path.getsize(os.path.join(path, n)) for n in names)
    shutil.rmtree(out_dir, ignore_errors=True)
    emit("app", config=APP_CONFIG, frames=len(names), frame_shape=list(frames.shape[1:]),
         png_bytes=nbytes, seconds=seconds, launches=got)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one Euler step with torch.profiler")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one "
              "NVIDIA GPU and does not fall back to the CPU", file=sys.stderr)
        return 1
    t_start = time.time()
    from magicdrive_v2_tpu_torch.ops import _cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    _cuda_build.build_all()
    for name in _cuda_build.SOURCES:
        _cuda_build.load(name)
    # the bf16 K1 kernels (pre-pass and attention bodies) as ptxas reported them
    k1_bodies = [r for r in _cuda_build.ptxas_report("fused_qkv_attention")
                 if "k1_" in r["function"]]
    require(len(k1_bodies) >= 2 and all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                                        for r in k1_bodies), k1_bodies)
    # the bf16 K3 kernels: resident and streaming, at each of the four head dims
    k3_bodies = [r for r in _cuda_build.ptxas_report("flash_attention")
                 if "k3_" in r["function"]]
    require(len(k3_bodies) == 8 and all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                                        for r in k3_bodies), k3_bodies)
    emit("device", nvidia_smi=smi, python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=_cuda_build.build_seconds,
         k1_ptxas=k1_bodies, k3_ptxas=k3_bodies)

    pipe, cond, per_forward, encode_launches, l_cond, seen = build_slice(
        torch, args.steps, args.seed)
    # condition tokens per frame: ego-motion + camera + caption + boxes
    require(l_cond == 1 + 1 + pipe.model.cfg.model_max_length + L_BOX, l_cond)
    kernel_numbers = check_kernels(torch, seen, l_cond)
    launches = run_slice(torch, pipe, cond, per_forward, encode_launches, l_cond,
                         args.steps, args.requests, args.profile)
    del pipe
    torch.cuda.empty_cache()
    run_slice_vs_plain(torch, args.seed)
    run_decode_vs_cpu(torch, args.seed)
    torch.cuda.empty_cache()
    run_app(torch, per_forward, encode_launches)

    # where the Pallas kernels sit in the JAX package (a path only: nothing of that
    # package is imported)
    jax_ops = "magicdrive_v2_" + "tpu/ops/"
    meta = {
        "fused_qkv_attention": dict(
            source="magicdrive_v2_tpu_torch/csrc/fused_qkv_attention.cu",
            headers=["magicdrive_v2_tpu_torch/csrc/attn_k1_sm90.cuh",
                     "magicdrive_v2_tpu_torch/csrc/sm90_common.cuh",
                     "magicdrive_v2_tpu_torch/csrc/attn_core.cuh (fp32 body)"],
            replaces=jax_ops + "flash_fused.py:120",
            also_replaces=[jax_ops + "flash_fused.py:236", jax_ops + "flash_fused.py:363"]),
        "adaln_modulate": dict(
            source="magicdrive_v2_tpu_torch/csrc/adaln_modulate.cu",
            replaces=jax_ops + "fused_adaln.py:64"),
        "flash_attention": dict(
            source="magicdrive_v2_tpu_torch/csrc/flash_attention.cu",
            headers=["magicdrive_v2_tpu_torch/csrc/attn_k3_sm90.cuh",
                     "magicdrive_v2_tpu_torch/csrc/sm90_common.cuh",
                     "magicdrive_v2_tpu_torch/csrc/attn_core.cuh (fp32 body)"],
            replaces=jax_ops + "flash_attention.py:98"),
    }
    kernels = [dict(name=name, route="cuda", launches=launches[name], **meta[name],
                    **kernel_numbers[name]) for name in meta]
    for k in kernels:
        require(k["launches"] > 0, k)
    emit("done", seconds=time.time() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
