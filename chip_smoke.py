#!/usr/bin/env python3
"""Smoke test of the PyTorch / Hopper port on one NVIDIA GPU.

Run ``python3 chip_smoke.py`` from the repository root on a machine with one
card. It imports only ``magicdrive_v2_tpu_torch`` and

1. ``device``   reads the card's name and power limit, builds the three CUDA
                kernels from ``magicdrive_v2_tpu_torch/csrc`` with ``nvcc``, checks
                that ptxas spilled no register of the bf16 K1 and K3 kernels, and
                records whether PIL, transformers and imageio import;
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
6. ``grads``    training's gradients: XL/2 at full width and depth 2/1, stage-2
                bucket (4 samples, six views of 224x400, 17 frames), one
                ``training_loss`` backward through the kernels against one through
                their plain versions, in fp32 (TF32 off) and in bf16 (casts of fp32
                masters); no parameter may lose its grad; then each kernel's
                ``autograd.Function`` against autograd through its plain version at
                every shape the step hands it, and each backward's time;
7. ``train``    the trainer: XL/2 at full width and depth from the stage-2 config
                (``configs/magicdrive/train/stage2_17x224x400.py``: batch 4, remat,
                bf16 over fp32 masters, AdamW, EMA 0.99), 4 steps, the first one
                untimed; finite loss and grad norm, moved parameters, the EMA
                identity, launch counters equal to the remat layout's; s/step,
                samples/s, tokens/s, peak memory; then the train app on the tiny
                config for 2 steps and a resume of 2;
8. ``decode_vs_cpu``  the VAE decode on the card against the CPU's (fp32, TF32 off,
                one view of 5 latent frames, so the 3 + 2 streaming runs), and a
                bf16 against an fp32 decode of one main-path view on the card,
                beside two controls with one cast point moved;
9. ``app``      the inference app (``magicdrive_v2_tpu_torch.scripts.
                inference_magicdrive``) on the 424x800 config with synthetic
                conditioning, 17 frames, 2 steps; checks its launch counters and
                the 17 PNG frames of the 2x3 grid it wrote;
10. ``dataset`` writes a nuScenes-format set to a temporary directory (two scenes
                of 41 frames at 12 Hz, six 1600x900 JPEG views a frame, 3-20 boxes
                of the ten classes), builds the 224x400 and 424x800 pipelines from
                the dataset yamls through the port's composition, and times a clip
                and 3 batches of 4 through the threaded loader; requires the native
                polygon fill (timed on the BEV object layers);
11. ``test_app`` the W-CODA test app (``scripts.test_magicdrive``) on a config
                whose ``_base_`` is the 424x800 inference config, with a dataset on
                that set: XL/2 bf16, 17 frames, 2 Euler steps, the CogVideoX-2b VAE
                decode, back-transform to 900x1600, 16 all-in-one frames read back;
                launch counters; host and device seconds apart;
12. ``train_data`` the train app on a config whose ``_base_`` is the stage-2 config,
                with a dataset on that set: XL/2 at full width and depth, b=4,
                remat, the bf16 CogVideoX-2b VAE encode in front of every step, 3
                steps (the first untimed): s/step, VAE-encode s/step, loader wait,
                peak memory, launch counters.

Every phase prints one JSON line. Any failure raises: the exit code is then not
0 and no result line is printed. Without a card the script exits with code 1.

Options (none needed): ``--steps N`` sampling steps (default 30), ``--requests N``
(default 2), ``--seed S`` weights seed, ``--profile`` to add ``profile`` phases
(device time by kernel over one Euler step, over the decode of one view and over
one train step, from torch.profiler).

cuDNN keeps its default algorithm choice (``torch.backends.cudnn.benchmark`` off),
under which the rerun of one seed must give the same video bit for bit.
"""
import argparse
import contextlib
import functools
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# data-sheet peaks of an H100 SXM: dense bf16 tensor-core rate, fp32 CUDA-core
# rate, device-memory rate. Bounds below are arithmetic on these, not measurements.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

NUM_FRAMES, HEIGHT, WIDTH = 17, 424, 800
APP_CONFIG = "configs/magicdrive/inference/fullx424x800_stdit3_CogVAE_boxTDS_wCT_xCE_wSST.py"
TRAIN_CONFIG = "configs/magicdrive/train/stage2_17x224x400.py"
TRAIN_APP_CONFIG = "configs/magicdrive/train/smoke_tiny.py"
TRAIN_FRAMES, TRAIN_HEIGHT, TRAIN_WIDTH = 17, 224, 400  # the stage-2 bucket
# the generated nuScenes-format set of phases dataset, test_app and train_data
DATA_SCENES, DATA_FRAMES, DATA_W, DATA_H = 2, 41, 1600, 900
DATA_YAML_224 = "Nuscenes_map_cache_box_t_with_n2t_12Hz"
DATA_YAML_424 = "Nuscenes_400_map_cache_box_t_with_n2t_12Hz"
NUSCENES_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
                    "motorcycle", "bicycle", "pedestrian", "traffic_cone")
CAMERAS = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT", "CAM_BACK",
           "CAM_BACK_LEFT")
WCODA_POST = dict(resize=[848, 1600], padding=[0, 52, 0, 0], cut_length=16)
L_BOX = 10  # box slots per frame in the synthetic batch
CAMERA_NEIGHBORS = ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0))


def optional_packages():
    """Version of each package outside torch / numpy that the port uses or a later
    slice may want (image decoding, dataset yamls, map caches, a real T5, video
    files), or why it does not import; a record, not a gate."""
    import importlib
    found = {}
    for name in ("PIL", "yaml", "h5py", "transformers", "imageio"):
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "no __version__")
        except Exception as e:  # a record of what the machine has, whatever the error
            found[name] = f"does not import: {type(e).__name__}: {e}"
    return found


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


def expected_launches(cfg, x_mask=False):
    """Kernel launches of one denoiser forward with a condition cache; with a frame
    mask every adaLN runs twice (the t and t0 modulations)."""
    n_ctrl_t = 0 if cfg.control_skip_temporal else cfg.control_depth
    n_base_t = cfg.depth if cfg.with_temp_block else 0
    spatial = cfg.depth + cfg.control_depth
    cross_view = cfg.depth + (0 if cfg.control_skip_cross_view else cfg.control_depth)
    blocks = spatial + n_base_t + n_ctrl_t
    return {"fused_qkv_attention": spatial + cross_view,
            "adaln_modulate": (2 * blocks + cross_view) * (2 if x_mask else 1),
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


def reset_backward_calls():
    from magicdrive_v2_tpu_torch.ops.plain_vjp import backward_calls
    backward_calls.clear()


def read_backward_calls():
    """Backwards of each kernel's ``PlainVJPFunction`` (each a recompute through
    the plain version: no launch)."""
    from magicdrive_v2_tpu_torch.ops.plain_vjp import backward_calls
    return {name: backward_calls.get(name, 0) for name in counters()}


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

# ---------------------------------------------------------------------------
# phases 6 and 7: training
# ---------------------------------------------------------------------------

GRAD_FP32_LIMIT = 1e-3       # per tensor: max|g_kernels - g_plain| / max|g_plain|
# per tensor, bf16: rms(g_kernels - g_plain) <= 2**-6 * rms(g_plain) + rms(g_plain - g_fp32),
# the last term how far bf16 arithmetic itself moves that grad (the plain versions in
# bf16 against fp32, same weights and inputs): the kernels round at other points than
# the plain versions, so their grads may differ by up to rounding's own reach
GRAD_BF16_RMS_LIMIT = 2.0 ** -6
FN_FP32_LIMIT = 1e-5         # per grad: max|g_function - g_autograd| / max|g_autograd|
FN_BF16_LIMIT = 2.0 ** -7    # the same in bf16 (one ulp of the largest element)


def train_config(torch):
    """The stage-2 config as the port loads it (4 samples a step), at the stage-2
    bucket."""
    from magicdrive_v2_tpu_torch.config.config import Config
    cfg = Config.fromfile(TRAIN_CONFIG)
    require(cfg.batch_size == 4, f"stage-2 batch_size {cfg.batch_size}")
    cfg.synthetic_buckets = [(TRAIN_FRAMES, TRAIN_HEIGHT, TRAIN_WIDTH)]
    return cfg


def train_model_config(torch, cfg, dtype, **overrides):
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
    return build_model_config(cfg.model, vae_out_channels=cfg.vae_out_channels,
                              mv_order_map=cfg.mv_order_map, dtype=dtype,
                              grad_checkpoint=cfg.grad_checkpoint, **overrides)


def train_batches(cfg, model_cfg, seed):
    """The app's synthetic batches of steps 0, 1, ... with their frame masks and
    condition dropout, as numpy; captions of the text encoder's full length."""
    from magicdrive_v2_tpu_torch.scripts.train_magicdrive import (SyntheticLoader,
                                                                   step_inputs)
    from magicdrive_v2_tpu_torch.utils.train_utils import MaskGenerator
    holder = {"step": 0}
    mask_gen = MaskGenerator(dict(cfg.get("mask_ratios", {})))
    for step, batch in enumerate(SyntheticLoader(model_cfg, cfg, holder,
                                                 l_txt=model_cfg.model_max_length)):
        holder["step"] = step + 1
        yield step_inputs(batch, cfg, mask_gen, seed, step)


def check_functions(torch, seen):
    """Each kernel's autograd.Function (forward on the card, backward the plain
    version's, recomputed) against autograd through the plain version, at every
    shape and type ``seen`` noted on the training path, including K1 with two
    sources and K3 on strided k/v views at head dims 72 and 144."""
    from magicdrive_v2_tpu_torch.ops import (adaln_modulate, adaln_modulate_plain,
                                             flash_attention, flash_attention_plain,
                                             fused_qkv_attention, fused_qkv_attention_plain)
    gen = torch.Generator().manual_seed(1)
    cases = []

    def randn(*shape, dtype, scale=1.0, shift=0.0):
        x = torch.randn(*shape, generator=gen) * scale + shift
        return x.to("cuda", dtype).requires_grad_()

    def judge(kernel, out, inputs, plain_out, what):
        require(type(out.grad_fn).__name__ == "PlainVJPFunctionBackward",
                f"{kernel}: output not from PlainVJPFunction: {out.grad_fn}")
        g = torch.randn(out.shape, generator=gen).to("cuda", out.dtype)
        got = torch.autograd.grad(out, inputs, g)
        want = torch.autograd.grad(plain_out, inputs, g)
        limit = FN_FP32_LIMIT if out.dtype == torch.float32 else FN_BF16_LIMIT
        ratios = []
        for a, b in zip(got, want):
            require(a is not None and b is not None, f"{kernel}: a grad is missing")
            a, b = a.float(), b.float()
            require(bool(a.isfinite().all()), f"{kernel}: grad not finite")
            scale = float(b.abs().max())
            require(scale > 0 and bool((a != 0).any()), f"{kernel}: zero grad")
            ratios.append(float((a - b).abs().max()) / (limit * scale))
        cases.append(dict(kernel=kernel, dtype=str(out.dtype), **what,
                          err_over_limit=max(ratios)))
        require(max(ratios) <= 1.0, cases[-1])

    for (shape, dtype, norm, J), perm in sorted(seen["fused_qkv_attention"].items(), key=str):
        qkv = randn(*shape, dtype=dtype)
        inputs, qw, kw = [qkv], None, None
        if norm:
            qw = randn(shape[-1], dtype=torch.float32, scale=0.1, shift=1.0)
            kw = randn(shape[-1], dtype=torch.float32, scale=0.1, shift=1.0)
            inputs += [qw, kw]
        judge("fused_qkv_attention",
              fused_qkv_attention(qkv, qw, kw, perm), inputs,
              fused_qkv_attention_plain(qkv, qw, kw, perm), dict(qkv=list(shape), J=J))
    for shape, dtype in sorted(seen["adaln_modulate"], key=str):
        x = randn(*shape, dtype=dtype, scale=3.0, shift=0.5)
        sh, sc = randn(shape[0], shape[2], dtype=dtype), randn(shape[0], shape[2], dtype=dtype)
        judge("adaln_modulate", adaln_modulate(x, sh, sc),
              [x, sh, sc], adaln_modulate_plain(x, sh, sc), dict(x=list(shape)))
    for qshape, M, dtype in sorted(seen["flash_attention"], key=str):
        B, N, H, D = qshape
        q = randn(*qshape, dtype=dtype)
        kv = randn(B, M, 2, H, D, dtype=dtype)  # k and v: strided views of one tensor
        k, v = kv[:, :, 0], kv[:, :, 1]
        judge("flash_attention", flash_attention(q, k, v), [q, kv],
              flash_attention_plain(q, k, v), dict(q=list(qshape), M=M))
    return cases


def compare_grads(torch, got_by_name, ref_by_name, fp32_ref=None):
    """Hold the grads through the kernels (``got_by_name``) against those through
    the plain versions (``ref_by_name``), {parameter name: grad or None}: the same
    parameters have a grad, none all zero where the plain one is not (the check
    that sees kernel outputs fall outside autograd), each within its limit: fp32
    ``GRAD_FP32_LIMIT``; bf16 ``GRAD_BF16_RMS_LIMIT`` plus the distance of the plain
    bf16 grad from ``fp32_ref``'s. Returns ((worst ratio to the limit, its tensor),
    tensors with a grad, the bf16 rounding ratios)."""
    worst, with_grad, roundings = (0.0, ""), 0, []
    for name, ref in ref_by_name.items():
        got = got_by_name[name]
        if ref is None:
            require(got is None, f"{name}: a grad through the kernels only")
            continue
        with_grad += 1
        require(got is not None, f"{name}: no grad through the kernels ({ref.dtype})")
        bf16 = fp32_ref is not None
        ref, got = ref.float(), got.float()
        require(bool(got.isfinite().all()), f"{name}: grad not finite")
        if not bool((ref != 0).any()):
            continue
        require(bool((got != 0).any()), f"{name}: all-zero grad through the kernels")
        if not bf16:
            ratio = float((got - ref).abs().max()) / (GRAD_FP32_LIMIT * float(ref.abs().max()))
        else:
            rms_ref = float(ref.square().mean().sqrt())
            rounding = float((ref - fp32_ref[name]).square().mean().sqrt())
            roundings.append(rounding / rms_ref)
            ratio = float((got - ref).square().mean().sqrt()) / (
                GRAD_BF16_RMS_LIMIT * rms_ref + rounding)
        worst = max(worst, (ratio, name))
    return worst, with_grad, roundings


def run_grads(torch, seed):
    """Grads of one training loss through the kernels against those through their
    plain versions, XL/2 at full width, depth 2/1, the stage-2 bucket; returns the
    shapes the bf16 step handed to each wrapper."""
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
    from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
    from magicdrive_v2_tpu_torch.training.trainer import step_generator, training_loss
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    from magicdrive_v2_tpu_torch.utils.misc import to_device

    cfg = train_config(torch)
    model_cfg = train_model_config(torch, cfg, torch.float32, depth=2, control_depth=1)
    with torch.device("cuda"):
        model = MagicDriveSTDiT3(model_cfg)
    init_weights(model, seed=seed)
    sched = build_scheduler(cfg.scheduler)
    batch, (nf, h, w) = next(train_batches(cfg, model_cfg, seed))
    batch["mask"][:, 0] = 0.0  # one condition frame in every sample: the t0 path runs
    dev = to_device(batch, "cuda")
    gen = step_generator(seed, 0)
    b = cfg.batch_size
    t = sched.sample_t(gen, b, height=torch.full((b,), h), width=torch.full((b,), w),
                       num_frames=torch.full((b,), float(nf)))
    noise = torch.randn(dev["x"].shape, generator=gen)
    seen = {"fused_qkv_attention": {}, "adaln_modulate": set(), "flash_attention": set()}

    def grads_of(dtype, plain):
        model.zero_grad(set_to_none=True)
        reset_counters()
        reset_backward_calls()
        with (plain_versions() if plain else recorded_shapes(seen)):
            loss, _ = training_loss(model, sched, dev, height=h, width=w, num_frames=nf,
                                    dtype=dtype, t=t, noise=noise)
            loss.backward()
        torch.cuda.synchronize()
        grads = {n: None if p.grad is None else p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        return float(loss.detach()), grads, read_counters(), read_backward_calls()

    result, fp32_plain = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        with no_tf32(torch):
            loss_k, gk, launches, backwards = grads_of(dtype, plain=False)
            loss_p, gp, plain_launches, plain_backwards = grads_of(dtype, plain=True)
        require(all(v > 0 for v in launches.values()) and all(
            v > 0 for v in backwards.values()), (launches, backwards))
        require(sum(plain_launches.values()) + sum(plain_backwards.values()) == 0,
                (plain_launches, plain_backwards))
        worst, with_grad, roundings = compare_grads(torch, gk, gp, fp32_plain)
        require(with_grad == sum(p.requires_grad for p in model.parameters()), with_grad)
        result[str(dtype)] = dict(loss_kernels=loss_k, loss_plain=loss_p, tensors=with_grad,
                                  worst_err_over_limit=worst[0], worst_tensor=worst[1],
                                  launches=launches, backward_calls=backwards)
        if roundings:
            roundings.sort()
            result[str(dtype)].update(
                plain_bf16_vs_fp32_rms_ratio_median=roundings[len(roundings) // 2],
                plain_bf16_vs_fp32_rms_ratio_max=roundings[-1])
        require(worst[0] <= 1.0, result[str(dtype)])
        if dtype == torch.float32:
            fp32_plain = gp
        del gk, gp
    del model, dev
    torch.cuda.empty_cache()
    cases = check_functions(torch, seen)
    emit("grads", model="MagicDriveSTDiT3-XL/2", depth=model_cfg.depth,
         control_depth=model_cfg.control_depth, batch=b, frames=nf, height=h,
         width=w, x_shape=list(batch["x"].shape), fp32_limit=f"per tensor max|err| <= "
         f"{GRAD_FP32_LIMIT} * max|g_plain|", bf16_limit=f"per tensor rms(err) <= "
         f"2**{math.log2(GRAD_BF16_RMS_LIMIT):g} * rms(g_plain) + rms(g_plain - g_plain_fp32)",
         by_dtype=result,
         function_limit=f"per grad max|err| <= {FN_FP32_LIMIT} (fp32) / "
         f"2**{math.log2(FN_BF16_LIMIT):g} (bf16) * max|g_plain|", function_cases=cases)
    return seen


def time_backwards(torch, seen, per_step):
    """ms of one backward of each Function at the training step's bf16 shapes (a
    recompute through the plain version), its bound, and the forward+backward of
    the nearest PyTorch call at the same shape as the yardstick."""
    import torch.nn.functional as F
    from magicdrive_v2_tpu_torch.ops import adaln_modulate, flash_attention, fused_qkv_attention
    gen = torch.Generator().manual_seed(2)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", bf16).requires_grad_()

    def backward_ms(out, inputs):
        g = torch.randn(out.shape, generator=gen).to("cuda", out.dtype)
        return time_ms(torch, lambda: torch.autograd.grad(out, inputs, g, retain_graph=True),
                       3)

    def fwd_bwd_ms(fn, inputs):
        out = fn()
        g = torch.randn(out.shape, generator=gen).to("cuda", out.dtype)
        return time_ms(torch, lambda: torch.autograd.grad(fn(), inputs, g), 3)

    rows = {}
    k1 = {J: (shape, perm) for (shape, dtype, norm, J), perm in
          seen["fused_qkv_attention"].items() if dtype == bf16 and shape[-1] == 72}
    for J, (shape, perm) in sorted(k1.items()):
        G, N, _, H, D = shape
        qkv = randn(*shape)
        qw = (torch.randn(D, generator=gen) * 0.1 + 1).cuda().requires_grad_()
        ms = backward_ms(fused_qkv_attention(qkv, qw, qw, perm), [qkv, qw])
        # the yardstick: one SDPA a source on its own k/v leaves, outputs summed
        q = randn(G, H, N, D)
        kvs = [(randn(G, H, N, D), randn(G, H, N, D)) for _ in range(J)]
        lib = fwd_bwd_ms(lambda: sum(F.scaled_dot_product_attention(q, kk, vv)
                                     for kk, vv in kvs), [q] + [t for kv in kvs for t in kv])
        flops = 2.5 * 4.0 * G * H * N * N * D * J
        nbytes = 2.0 * (2 * qkv.numel() + G * N * H * D)
        bound_ms, by = bound(flops, nbytes, PEAK_BF16)
        rows["K1 spatial" if J == 1 else "K1 cross-view"] = dict(
            qkv=list(shape), J=J, plain_backward_ms=ms, bound_ms=bound_ms, bound_by=by,
            library_fwd_bwd_ms=lib, library="scaled_dot_product_attention fwd+bwd"
            + (" x2 summed" if J > 1 else ""))
    x_shape = max(sh for sh, dtype in seen["adaln_modulate"] if dtype == bf16)
    x = randn(*x_shape)
    sh, sc = randn(x_shape[0], x_shape[2]), randn(x_shape[0], x_shape[2])
    C = x_shape[2]
    rows["K2"] = dict(
        x=list(x_shape), plain_backward_ms=backward_ms(adaln_modulate(x, sh, sc), [x, sh, sc]),
        library_fwd_bwd_ms=fwd_bwd_ms(lambda: F.layer_norm(x, (C,), eps=1e-6)
                                      * (1 + sc[:, None]) + sh[:, None], [x, sh, sc]),
        library="layer_norm + modulate fwd+bwd")
    rows["K2"]["bound_ms"], rows["K2"]["bound_by"] = bound(
        10.0 * x.numel(), 2.0 * (3 * x.numel() + 4 * sh.numel()), PEAK_FP32)
    qshape, M = max((q, m) for q, m, dtype in seen["flash_attention"]
                    if dtype == bf16 and q[-1] == 72)
    B, N, H, D = qshape
    q, kv = randn(*qshape), randn(B, M, 2, H, D)
    ms = backward_ms(flash_attention(q, kv[:, :, 0], kv[:, :, 1]), [q, kv])
    qt, kt, vt = randn(B, H, N, D), randn(B, H, M, D), randn(B, H, M, D)
    lib = fwd_bwd_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), [qt, kt, vt])
    bound_ms, by = bound(2.5 * 4.0 * B * H * N * M * D,
                         2.0 * (2 * q.numel() + 2 * kv.numel() + q.numel()), PEAK_BF16)
    rows["K3"] = dict(q=list(qshape), M=M, plain_backward_ms=ms, bound_ms=bound_ms,
                      bound_by=by, library_fwd_bwd_ms=lib,
                      library="scaled_dot_product_attention fwd+bwd")
    for name, row in rows.items():
        row["backward_calls_per_step"] = per_step[name]
    torch.cuda.empty_cache()
    return rows


def run_train(torch, seed, seen, encode_launches, steps=4, with_profile=False):
    """The trainer at full width and depth from the stage-2 config: ``steps``
    steps, the first untimed (with ``with_profile``, two more, the second under
    torch.profiler); then the Functions' backward times."""
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
    from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
    from magicdrive_v2_tpu_torch.training.trainer import build_training
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    from magicdrive_v2_tpu_torch.utils.misc import to_device

    cfg = train_config(torch)
    batch_size = cfg.batch_size
    model_cfg = train_model_config(torch, cfg, torch.bfloat16,
                                   remat_policy=cfg.get("remat_policy", "full"))
    require((model_cfg.depth, model_cfg.control_depth, model_cfg.hidden_size,
             model_cfg.grad_checkpoint) == (28, 13, 1152, True), model_cfg)
    t0 = time.time()
    with torch.device("cuda"):
        model = MagicDriveSTDiT3(model_cfg)
    init_weights(model, seed=seed)
    scheduler = build_scheduler(cfg.scheduler)
    state, step_fn = build_training(model, scheduler, cfg, height=TRAIN_HEIGHT,
                                    width=TRAIN_WIDTH, num_frames=TRAIN_FRAMES, seed=seed + 1)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    state_bytes = torch.cuda.memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    # remat: the forward and the recompute each launch every layer group's kernels,
    # the backward launches none; encode_conditions runs once, outside the groups
    per_forward = expected_launches(model_cfg, x_mask=True)
    want = {k: 2 * per_forward[k] + encode_launches[k] for k in per_forward}
    want_backward = {k: per_forward[k] + encode_launches[k] for k in per_forward}
    name = "base_blocks_s.27.attn.qkv.weight"
    param, ema = dict(model.named_parameters())[name], dict(state.ema.named_parameters())[name]
    seconds, losses, grad_norms, t_means, launches = [], [], [], [], None
    batches = train_batches(cfg, model_cfg, seed)
    tokens = None
    for i in range(steps):
        batch, (nf, h, w) = next(batches)
        require((nf, h, w) == (TRAIN_FRAMES, TRAIN_HEIGHT, TRAIN_WIDTH), (nf, h, w))
        dev = to_device(batch, "cuda")
        p_before, e_before = param.detach().clone(), ema.detach().clone()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_counters()
        reset_backward_calls()
        t_step = time.time()
        state, metrics = step_fn(state, dev)
        torch.cuda.synchronize()
        seconds.append(time.time() - t_step)
        got, backwards = read_counters(), read_backward_calls()
        require(got == want and backwards == want_backward, (got, want, backwards,
                                                             want_backward))
        launches = got
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        require(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0, (loss, gnorm))
        losses.append(loss)
        grad_norms.append(gnorm)
        t_means.append(float(metrics["t_mean"]))
        require(not torch.equal(param.detach(), p_before), f"{name} did not move")
        expect = e_before * cfg.ema_decay + param.detach() * (1 - cfg.ema_decay)
        ema_err = float((ema.detach() - expect).abs().max())
        require(ema_err <= 2.0 ** -21 * float(expect.abs().max()), ("EMA", ema_err))
        B, _, T, Hl, Wl = dev["x"].shape
        tokens = B * model_cfg.nc * T * (Hl // 2) * (Wl // 2)
    peak = torch.cuda.max_memory_allocated()
    require(state.step == steps, state.step)
    if with_profile:
        profiled(torch, f"one train step (XL/2, stage-2 bucket, b={batch_size})",
                 lambda: step_fn(state, dev))
    del state, model, param, ema, dev
    torch.cuda.empty_cache()
    timed = seconds[1:]
    s_step = sum(timed) / len(timed)
    per_step_backward = {"K1 spatial": model_cfg.depth + model_cfg.control_depth,
                         "K1 cross-view": per_forward["fused_qkv_attention"]
                         - model_cfg.depth - model_cfg.control_depth,
                         "K2": want_backward["adaln_modulate"],
                         "K3": per_forward["flash_attention"]}
    backward_rows = time_backwards(torch, seen, per_step_backward)
    emit("train", config=TRAIN_CONFIG, model="MagicDriveSTDiT3-XL/2", params=n_params,
         dtype="bfloat16 compute, float32 masters", batch=batch_size, frames=TRAIN_FRAMES,
         height=TRAIN_HEIGHT, width=TRAIN_WIDTH, tokens_per_step=tokens,
         grad_checkpoint=True, setup_seconds=setup_s, state_bytes=state_bytes,
         seconds_per_step=seconds, seconds_per_step_timed_mean=s_step,
         samples_per_second=batch_size / s_step, tokens_per_second=tokens / s_step,
         peak_memory_bytes=peak, losses=losses, grad_norms=grad_norms, t_means=t_means,
         launches_per_step=launches, backward_calls_per_step=want_backward,
         ema_identity=True, backward=backward_rows)
    return launches, backward_rows, s_step


def run_train_app(torch):
    """The train app on the tiny config: 2 steps, then a resume of 2 more; its
    files are written under outputs/ in the checkout, checked, and removed."""
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    out_dir = os.path.join("outputs", "chip_smoke_train_app")
    shutil.rmtree(out_dir, ignore_errors=True)
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    log = logging.getLogger("train")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    argv = [TRAIN_APP_CONFIG, "--synthetic", "--max-steps", "2", "--cfg-options",
            f"outputs={out_dir}"]
    t0 = time.time()
    reset_counters()
    try:
        first = train_magicdrive.main(argv)
        second = train_magicdrive.main(argv)
    finally:
        log.removeHandler(handler)
    seconds = time.time() - t0
    got = read_counters()
    require(all(v > 0 for v in got.values()), got)
    require(any(m.startswith("resumed from") and m.endswith("at step 2") for m in messages),
            "no resume message")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    require([line["step"] for line in lines] == [1, 2, 3, 4] and lines == first + second,
            lines)
    require(all(math.isfinite(line["loss"]) for line in lines), lines)
    for step in (2, 4):
        names = sorted(os.listdir(os.path.join(out_dir, f"global_step{step}")))
        require(names == ["ema.pt", "model.pt", "optimizer.pt", "rng_state.json",
                          "running_states.json"], names)
    frames = os.listdir(os.path.join(out_dir, "validation", "step4_val0_0"))
    require(len(frames) == 9, frames)
    shutil.rmtree(out_dir, ignore_errors=True)
    emit("train_app", config=TRAIN_APP_CONFIG, steps=[1, 2, 3, 4], seconds=seconds,
         losses=[line["loss"] for line in lines], launches=got, validation_frames=len(frames))


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

# ---------------------------------------------------------------------------
# phases 10-12: the nuScenes data path, the W-CODA test app, training on data
# ---------------------------------------------------------------------------


def write_nuscenes_set(root, seed=0):
    """A nuScenes-format set in the schema of tests/helpers_mini_nuscenes.py at
    nuScenes' size: DATA_SCENES scenes of DATA_FRAMES frames at 12 Hz (a key frame
    every 6th), six 1600x900 JPEG views a frame (smooth random scenes shifted from
    frame to frame, fine noise on top, quality 90), intrinsics of a 1600x900
    camera, 20 instances a scene of the ten classes of which 3-20 carry lidar
    points in a frame. Returns the path of the infos pickle."""
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    bases = {}
    for scene in range(DATA_SCENES):
        for cam in CAMERAS:
            small = rng.integers(0, 256, (18, 32, 3), dtype=np.uint8)
            bases[scene, cam] = np.asarray(Image.fromarray(small).resize(
                (DATA_W + 8 * DATA_FRAMES, DATA_H), Image.BICUBIC))
    jobs, infos, scene_tokens, ts = [], [], [], 0
    n_inst = 20
    for scene in range(DATA_SCENES):
        tokens = []
        start = np.concatenate([rng.uniform(-40, 40, (n_inst, 2)), rng.uniform(-1, 0, (n_inst, 1)),
                                rng.uniform(1, 4, (n_inst, 3)), rng.uniform(-3, 3, (n_inst, 1)),
                                np.zeros((n_inst, 2))], axis=1)
        velocity = rng.uniform(-0.5, 0.5, (n_inst, 2))
        for fi in range(DATA_FRAMES):
            token = f"s{scene}f{fi}" if fi % 6 == 0 else f"s{scene}f{fi};interp"
            tokens.append(token)
            cams = {}
            for ci, cam in enumerate(CAMERAS):
                path = os.path.join(root, "samples", f"{token}_{cam}.jpg")
                jobs.append((path, scene, cam, fi, int(rng.integers(1 << 31))))
                yaw = ci * np.pi / 3
                c, s_ = np.cos(yaw), np.sin(yaw)
                cams[cam] = dict(
                    data_path=path,
                    camera_intrinsics=np.array([[1266.0, 0, 800], [0, 1266.0, 450], [0, 0, 1]]),
                    sensor2lidar_rotation=np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]])
                    @ np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]]).T,
                    sensor2lidar_translation=np.array([1.5 * c, 1.5 * s_, 1.6]),
                    sensor2ego_rotation=[1, 0, 0, 0], sensor2ego_translation=[0, 0, 1.6])
            boxes = start.copy()
            boxes[:, :2] += velocity * fi
            points = np.zeros(n_inst, np.int64)
            points[rng.choice(n_inst, int(rng.integers(3, n_inst + 1)), replace=False)] = 5
            infos.append(dict(
                token=token, timestamp=ts, lidar_path="", sweeps=[],
                location="singapore-onenorth", description="sunny day, parked cars",
                timeofday="day", lidar2ego_rotation=[1, 0, 0, 0],
                lidar2ego_translation=[0, 0, 1.8],
                ego2global_rotation=[np.cos(.05 * fi), 0, 0, np.sin(.05 * fi)],
                ego2global_translation=[2. * fi, .1 * fi, 0], cams=cams, gt_boxes=boxes,
                gt_names=np.array([NUSCENES_CLASSES[i % 10] for i in range(n_inst)]),
                gt_box_ids=[f"inst{scene}_{i}" for i in range(n_inst)],
                num_lidar_pts=points, valid_flag=points > 0))
            ts += 1
        scene_tokens.append(tokens)

    def write(job):
        path, scene, cam, fi, s = job
        img = bases[scene, cam][:, 8 * fi:8 * fi + DATA_W].astype(np.int16)
        img = img + np.random.default_rng(s).integers(-6, 7, img.shape, dtype=np.int16)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    ann = os.path.join(root, "infos.pkl")
    with open(ann, "wb") as f:
        pickle.dump({"infos": infos, "scene_tokens": scene_tokens,
                     "metadata": {"version": "generated"}}, f)
    return ann


def dataset_config(yaml_name, ann, split, collate=None):
    """``dataset`` of an experiment config: the dataset yaml composed by the port's
    ``merge_dataset_cfg``, its ``split`` on the generated set; with ``collate``, the
    split's collate parameters and the yaml's caption template."""
    from magicdrive_v2_tpu_torch.config.config import Config, merge_dataset_cfg
    cfg = merge_dataset_cfg(Config(), yaml_name, overrides=[
        (f"dataset.data.{split}.ann_file", ann), (f"dataset.data.{split}.dataset_root", "")])
    if collate is not None:
        cfg.dataset.data[split].img_collate_param = dict(collate,
                                                         template=cfg.dataset.template)
    return cfg.dataset


def run_dataset(torch, root):
    """Writes the set, then per pipeline (224x400 train split, 424x800 val split, 17
    frames): ms of two clips on one thread, and of batches of 4 through the loader
    with its worker threads; then the BEV object layers and aux channels (the
    polygon fill) of one frame, and which fill ran."""
    import numpy as np
    from magicdrive_v2_tpu_torch import native
    from magicdrive_v2_tpu_torch.config.presets import img_collate_param
    from magicdrive_v2_tpu_torch.datasets import LoadBEVSegmentation, prepare_dataloader
    from magicdrive_v2_tpu_torch.registry import DATASETS, build_module
    t0 = time.time()
    ann = write_nuscenes_set(root)
    write_s = time.time() - t0
    jpeg_bytes = sum(os.path.getsize(os.path.join(root, "samples", n))
                     for n in os.listdir(os.path.join(root, "samples")))
    pipelines = {}
    for name, yaml_name, split, is_train, shape in (
            ("224x400 train", DATA_YAML_224, "train", True, (TRAIN_HEIGHT, TRAIN_WIDTH)),
            ("424x800 val", DATA_YAML_424, "val", False, (HEIGHT, WIDTH))):
        ds_cfg = dict(dataset_config(yaml_name, ann, split, img_collate_param(
            "all-xyz", is_train=is_train)).data[split], video_length=NUM_FRAMES)
        dataset = build_module(ds_cfg, DATASETS)
        clip_ms = []
        for i in range(2):
            t1 = time.time()
            clip = dataset[i]
            clip_ms.append((time.time() - t1) * 1e3)
        require(clip["pixel_values"].shape == (NUM_FRAMES, 6, 3) + shape,
                clip["pixel_values"].shape)
        require(bool(np.isfinite(clip["pixel_values"]).all()), "clip pixels not finite")
        loader, _ = prepare_dataloader(dataset, batch_size=4, num_workers=4, seed=0)
        batch_ms, t1 = [], time.time()
        for bi, batch in enumerate(loader):
            now = time.time()
            batch_ms.append((now - t1) * 1e3)
            t1 = now
            require(batch["pixel_values"].shape[:2] == (4, NUM_FRAMES),
                    batch["pixel_values"].shape)
            if bi == 2:
                break
        pipelines[name] = dict(clips=len(dataset), clip_ms=clip_ms,
                               batch_of_4_ms=batch_ms, map_shape=list(
                                   clip["bev_map_with_aux"].shape[1:]),
                               boxes=int(clip["bboxes_3d_data"]["bboxes"].shape[2]))
    # the 25-channel map variant: object layers and aux channels of one frame
    yaml = dataset_config(DATA_YAML_424, ann, "val")
    bev = LoadBEVSegmentation("", yaml.map_bound.x, yaml.map_bound.y, yaml.map_classes,
                              object_classes=yaml.object_classes, aux_data=yaml.aux_data)
    dataset = build_module(dict(yaml.data.val, video_length=1, pipeline=None), DATASETS)
    frame = dataset.get_data_info(0)[0]
    t1 = time.time()
    out = bev(dict(frame))
    fill_ms = (time.time() - t1) * 1e3
    require(float(out["gt_masks_bev"][8:].sum()) > 0, "no object was filled")
    lib = native.library_path()
    require(lib in (str(native.COMMITTED),) or lib.startswith(str(native.BUILD_DIR)), lib)
    emit("dataset", scenes=DATA_SCENES, frames_per_scene=DATA_FRAMES, views=6,
         jpeg_size=[DATA_W, DATA_H], jpeg_bytes=jpeg_bytes, write_seconds=write_s,
         pipelines=pipelines, bev_object_layers_ms=fill_ms,
         bev_shape=list(out["gt_masks_bev"].shape), polygon_fill="native",
         polygon_fill_library=lib,
         polygon_fill_is_committed_library=lib == str(native.COMMITTED))
    return ann


def write_config(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(f"{k} = {v!r}" for k, v in lines.items()) + "\n")


def run_test_app(torch, per_forward, encode_launches, ann, root):
    """The W-CODA test app on the 424x800 config with a dataset on the generated
    set; its frames are written under outputs/ in the checkout, read back and
    removed."""
    from magicdrive_v2_tpu_torch.config.presets import img_collate_param
    from magicdrive_v2_tpu_torch.scripts import test_magicdrive
    from magicdrive_v2_tpu_torch.utils.inference_utils import read_png
    out_dir = os.path.join("outputs", "chip_smoke_test_app")
    shutil.rmtree(out_dir, ignore_errors=True)
    config = os.path.join(root, "test_app_config.py")
    write_config(config, {
        "_base_": os.path.abspath(APP_CONFIG), "num_frames": NUM_FRAMES,
        "validation_index": [0], "outputs": out_dir, "save_mode": "all-in-one",
        "post": WCODA_POST, "scheduler": {"num_sampling_steps": 2},
        "dataset": dict(dataset_config(DATA_YAML_424, ann, "val",
                                       img_collate_param("all-xyz", is_train=False)))})
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    log = logging.getLogger("test")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    t0 = time.time()
    reset_counters()
    try:
        saved = test_magicdrive.main([config, "--num-samples", "1"])
    finally:
        log.removeHandler(handler)
    seconds = time.time() - t0
    got = read_counters()
    want = {k: per_forward[k] * 2 + encode_launches[k] for k in per_forward}
    require(got == want, (got, want))
    require(len(saved) == 1, len(saved))
    path, frames = saved[0]
    cut = WCODA_POST["cut_length"]
    out_h = WCODA_POST["resize"][0] + WCODA_POST["padding"][1] + WCODA_POST["padding"][3]
    out_w = WCODA_POST["resize"][1] + WCODA_POST["padding"][0] + WCODA_POST["padding"][2]
    names = sorted(os.listdir(path))
    require(names == [f"{i:04d}.png" for i in range(cut)], names)
    require(frames.shape == (cut, 2 * out_h, 3 * out_w, 3), frames.shape)
    t1 = time.time()
    for i, name in enumerate(names):
        require(bool((read_png(os.path.join(path, name)) == frames[i]).all()), name)
    read_s = time.time() - t1
    require(float(frames.std()) > 1.0, "constant frames")
    # the zero padding of [-1, 1] frames is mid-grey in the written frames
    require(bool((frames[:, :WCODA_POST["padding"][1]] == 128).all()), "top padding")
    shutil.rmtree(out_dir, ignore_errors=True)
    timings = json.loads(next(m for m in messages if m.startswith("timings "))[8:])
    emit("test_app", config=f"_base_ {APP_CONFIG}, dataset {DATA_YAML_424} val",
         frames=len(names), frame_shape=list(frames.shape[1:]), seconds=seconds,
         host_seconds={k: timings[k] for k in ("setup_s", "load_s", "text_s",
                                                "back_transform_s", "write_s")},
         device_seconds={"sample_and_decode_s": timings["sample_s"]},
         read_back_seconds=read_s, launches=got)
    return got


def run_train_data(torch, encode_launches, ann, root, synthetic_s_step, steps=3):
    """The train app on the stage-2 config with a dataset on the generated set:
    XL/2 b=4, the VAE encode in front of each step, ``steps`` steps (the first
    untimed), no checkpoint, no validation; beside phase ``train``'s s/step on
    synthetic latents (``synthetic_s_step``)."""
    import gc
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    cfg = train_config(torch)
    config = os.path.join(root, "train_data_config.py")
    write_config(config, {
        "_base_": os.path.abspath(TRAIN_CONFIG), "outputs": os.path.join(root, "train_out"),
        "img_collate_param_train": dict(cfg.img_collate_param_train,
                                        template="A driving scene image at {location}. "
                                                 "{description}."),
        "dataset": dict(dataset_config(DATA_YAML_224, ann, "train")),
        "ckpt_every": 0, "log_every": 1, "record_time": True, "num_workers": 4})
    model_cfg = build_model_config(cfg.model, vae_out_channels=cfg.vae_out_channels,
                                   mv_order_map=cfg.mv_order_map, dtype=torch.bfloat16,
                                   grad_checkpoint=True)
    per_forward = expected_launches(model_cfg, x_mask=True)
    want = {k: steps * (2 * per_forward[k] + encode_launches[k]) for k in per_forward}
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.time()
    lines = train_magicdrive.main([config, "--max-steps", str(steps)])
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    got = read_counters()
    require(got == want, (got, want))
    require([x["step"] for x in lines] == list(range(1, steps + 1)), lines)
    require(all(math.isfinite(x["loss"]) and x["grad_norm"] > 0 for x in lines), lines)
    gc.collect()
    torch.cuda.empty_cache()
    timed = lines[1:]
    mean = lambda key: sum(x[key] for x in timed) / len(timed)  # noqa: E731
    tokens = cfg.batch_size * 6 * 5 * (TRAIN_HEIGHT // 16) * (TRAIN_WIDTH // 16)
    s_total = mean("step_s") + mean("encode_s") + mean("loader_wait_s")
    emit("train_data", config=f"_base_ {TRAIN_CONFIG}, dataset {DATA_YAML_224} train",
         batch=cfg.batch_size, frames=TRAIN_FRAMES, height=TRAIN_HEIGHT, width=TRAIN_WIDTH,
         steps=steps, seconds=seconds, tokens_per_step=tokens,
         train_step_seconds=[x["step_s"] for x in lines],
         vae_encode_seconds=[x["encode_s"] for x in lines],
         loader_wait_seconds=[x["loader_wait_s"] for x in lines],
         seconds_per_step_timed_mean=s_total, train_step_seconds_timed_mean=mean("step_s"),
         vae_encode_seconds_timed_mean=mean("encode_s"),
         loader_wait_seconds_timed_mean=mean("loader_wait_s"),
         tokens_per_second=tokens / s_total, samples_per_second=cfg.batch_size / s_total,
         synthetic_seconds_per_step=synthetic_s_step,
         synthetic_tokens_per_second=tokens / synthetic_s_step,
         peak_memory_bytes=peak, losses=[x["loss"] for x in lines],
         grad_norms=[x["grad_norm"] for x in lines], launches=got)
    return {k: v // steps for k, v in got.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one Euler step, one view's decode and one train "
                         "step with torch.profiler")
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
    from magicdrive_v2_tpu_torch import native
    fill = native.library_path()
    emit("device", nvidia_smi=smi, python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=_cuda_build.build_seconds,
         k1_ptxas=k1_bodies, k3_ptxas=k3_bodies, optional_packages=optional_packages(),
         polygon_fill=dict(kind="native", library=fill,
                           committed_library=fill == str(native.COMMITTED)))

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
    seen_train = run_grads(torch, args.seed)
    train_launches, backward_rows, synthetic_s_step = run_train(
        torch, args.seed, seen_train, encode_launches, with_profile=args.profile)
    run_train_app(torch)
    run_decode_vs_cpu(torch, args.seed)
    torch.cuda.empty_cache()
    run_app(torch, per_forward, encode_launches)
    data_root = tempfile.mkdtemp(prefix="chip_smoke_nuscenes_")
    try:
        ann = run_dataset(torch, data_root)
        torch.cuda.empty_cache()
        test_app_launches = run_test_app(torch, per_forward, encode_launches, ann, data_root)
        torch.cuda.empty_cache()
        train_data_launches = run_train_data(torch, encode_launches, ann, data_root,
                                             synthetic_s_step)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)

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
    backward = {"fused_qkv_attention": {"spatial": backward_rows["K1 spatial"],
                                        "cross_view": backward_rows["K1 cross-view"]},
                "adaln_modulate": backward_rows["K2"],
                "flash_attention": backward_rows["K3"]}
    kernels = [dict(name=name, route="cuda", launches=launches[name],
                    launches_by_path={"sample": launches[name],
                                      "train_step": train_launches[name],
                                      "test_app": test_app_launches[name],
                                      "train_step_on_data": train_data_launches[name]},
                    **meta[name], **kernel_numbers[name], backward=backward[name])
               for name in meta]
    for k in kernels:
        require(all(n > 0 for n in k["launches_by_path"].values()), k)
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
