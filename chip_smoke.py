#!/usr/bin/env python3
"""Smoke test of the PyTorch / Hopper port on one NVIDIA GPU.

Run ``python3 chip_smoke.py`` from the repository root on a machine with one
card. It imports only ``magicdrive_v2_tpu_torch`` and

1. ``device``   reads the card's name and power limit, builds the three CUDA
                kernels and their backwards from ``magicdrive_v2_tpu_torch/csrc``
                with ``nvcc``, checks that ptxas spilled no register of the bf16 K1
                and K3 kernels nor of any backward kernel (bf16 and fp32), and
                records whether PIL, transformers, imageio, scipy, cv2, hmr2 and
                tensorboard import;
2. ``shapes``   builds the model of phase 3, counts each kernel's launches over
                ``encode_conditions`` and over one denoiser forward, and notes,
                over a sample of one Euler step, every distinct shape and type
                the model hands to a kernel's wrapper;
3. ``kernels``  holds each kernel against its plain PyTorch version on the card
                (stated limits), in fp32 and bf16, at every shape of phase 2, at
                the shapes of the 848x1600 path (K1 at G=30, N=5600 with 16, 8 and 4
                heads, K2 (6, 28000, 1152), K3 q (30, 5600, 16, 72)) and at further
                shapes (the long-sequence regime, ragged tiles), and
                times kernel, plain version and the nearest PyTorch library
                call at the main path's shapes (K1 also: its pre-pass alone; K1
                and K3: the achieved TFLOP/s; K3: its share of the bound and the
                time of each q-tiles-per-block setting of its launch plan);
4. ``slice``    drives the main path: MagicDriveSTDiT3-XL/2 at full width and depth
                in bf16, six views of 424x800, 17 frames, batched classifier-free
                guidance, ``MagicDrivePipeline.sample(decode=True)`` for a few
                requests: 5 Euler steps, then the CogVideoX-2b VAE decode in bf16
                one view at a time, with seeded random weights and the
                ``t5-dummy`` text encoder; checks shape, finiteness, determinism
                of the decoded video, that two seeds give two results (with one
                request: two one-step samples without the decode) and that the
                kernels' launch counters moved by the expected amounts; times
                sampling and decode apart;
5. ``slice_vs_plain``  one forward of the same model at reduced depth in fp32 with
                the kernels against one with their plain versions;
5c. ``block_bench`` ``tools/block_bench`` at the 424p bench shape (B=12, T=5, S=1350,
                C=1152, bf16): a chain of 8 spatial and of 8 temporal blocks through
                the kernels and through their plain versions, median of 3 chains in
                ms/block, launches a block; each kind's first block through the
                kernels held against the plain route;
5a. ``sp848``   the fullx848x1600 config (sp_size 8, force_pad_h_for_sp_size 8,
                rflow-slice, VAE tiling) through ``MagicDrivePipeline.from_config``
                in one process of an NCCL group of one, so it runs unsharded with
                the fsp8 pad (S=5600): XL/2 full width and depth, bf16, 6 views, 17
                frames, 1 step, ``sample(decode=True)``, a rerun of the seed
                bit-equal; s/step, decode s, peak memory, launches, the shapes
                each wrapper was handed;
5b. ``sp_ranks`` sequence parallelism across processes: 4 ranks (gloo on one
                card, NCCL where the host has a card a rank) run XL/2 at full width,
                depth 2 / control 1, 6x848x1600x9f at sp=4 (mesh (1, 4)) and sp=2
                (mesh (2, 2)) in fp32 and bf16, and 424x800 at sp=4 (the sp pad),
                each against the unsharded forward; then ``sp_vae`` of 6 views
                over the 4 ranks against the direct decode; last, every shape the
                ranks handed a wrapper is held against its plain version as in
                phase 3; the ranks import and join while phase sp848 reruns its
                sample (after the timed one), the unsharded forwards run beside
                their work, and each rank reports where its seconds went
                (``rank0_timeline``);
6. ``grads``    training's gradients: XL/2 at full width and depth 2/1, stage-2
                bucket (4 samples, six views of 224x400, 17 frames), one
                ``training_loss`` backward through the kernels against one through
                their plain versions, in fp32 (TF32 off) and in bf16 (casts of fp32
                masters); no parameter may lose its grad; then each kernel's
                ``autograd.Function`` (forward and backward kernels) against
                autograd through its plain version in fp32 at every shape the step
                hands it (and K1 at N=5300 with 8 heads, ``sp_train``'s; the bf16
                backward body's small head dims and K3 with one key at 72), each
                bf16 grad within 2**-7 of the largest plus the plain bf16 grad's own
                distance; two backwards at the stage-2 shapes bit-equal; the bf16
                backward's pre-pass against its plain version; each backward
                kernel's time (stage-2 shapes, K3 also as the model hands it k and
                v, and K1 at ``sp_train``'s), back to back and on the card alone,
                beside the plain recompute's, its bound, the library's
                forward+backward and its backward alone;
7. ``train``    the trainer: XL/2 at full width and depth from the stage-2 config
                (``configs/magicdrive/train/stage2_17x224x400.py``: batch 4, remat,
                bf16 over fp32 masters, AdamW, EMA 0.99), 2 steps, the first one
                untimed; finite loss and grad norm, moved parameters, the EMA
                identity, launch counters equal to the remat layout's; s/step,
                samples/s, tokens/s, peak memory; then the train app on the tiny
                config for 2 steps and a resume of 2;
7a. ``sp_train`` sequence-parallel training: XL/2 at full width, depth 2 / control
                1, from the stage-3 config (bf16 over fp32 masters, remat full) at
                its 848x1600 bucket (9 frames, b=1: S=5300, 2650 a rank), 1 step
                on 2 processes (gloo on one card, NCCL with a card a rank; the mesh
                by the train apps' rule) against 1 in one process with the sp pad
                forced: loss, grad norm, the grads before the clip, parameters and
                EMA after the step; the ranks bit-equal after it; launches
                and backwards per step; the grad all-reduce's seconds; every shape
                the ranks handed a wrapper held against its plain version;
7b. ``stage3_app`` the train app on ``configs/magicdrive/train/
                stage3_multires_sp4.py --synthetic`` in one process (sp = min(4, 1)
                = 1: ``simulate_sp_size`` [4, 8] alone picks the pad), XL/2 at full
                width, depth 7 / control 4, the 224-400-12-33 bucket at its batch of 4, 2
                steps: each step's pick, s/step, peak memory, the metrics read
                back, launches;
7e. ``stage1``  the stage-1 image path, XL/2 at full width and depth without
                temporal blocks (``with_temp_block=False``, ``control_skip_temporal``),
                6 views of 224x400 at 1 frame, bf16, seeded random weights:
                ``stage1_serving`` the noTemp inference config through
                ``from_config``, one request of its batch of 4 (batched CFG 2.0,
                48 views a forward) over its 20 steps with the decode, then the
                inference app on it, 4 samples and the first again, bit-equal, its
                PNGs read back; ``stage1_train`` the train app on the stage-1 config
                (``--synthetic``, the (1, 224, 400) bucket, b=32: 67,200 tokens a
                step, remat full, AdamW, EMA), 2 steps: s/step, samples/s, tokens/s,
                peak memory, launches and backwards equal to the remat layout's,
                every shape either path handed a wrapper held against its plain
                version and each Function against autograd through it as in phase
                ``grads``; ``stage1_k1_timing`` K1 at G = 48
                and 192, N = 350, J = 1 and 2: kernel, plain, SDPA, bound;
7c. ``dp_train`` data-parallel training with the fp32 state split over dp
                (``parallel/fsdp.py``): XL/2 at full width, depth 2 /
                control 1, from the stage-2 config (bf16 over fp32 masters, remat
                full), 2 steps on 2 ranks of a (2, 1) mesh at the stage-2 bucket (2
                rows a rank) and on 4 ranks of a (2, 2) mesh at 424x800x9 (the sp
                pad), gloo on one card (NCCL with a card a rank), each against 2
                steps in one process on the global batch: loss, grad norm, the grads
                before the clip, parameters and EMA after the steps; each rank's
                bytes of split state against one process's; s/step, each rank's
                peak memory, the gather, reduce-scatter and all-reduce seconds and
                bytes a step; launches and backwards per rank; every shape the
                ranks handed a wrapper held against its plain version; both
                meshes' ranks start at once and wait, their state built, while the
                one-process references run, then take their steps one mesh after
                the other (as ``sp_train``'s ranks wait for its reference);
7d. ``dp_app``  the train app on 2 ranks at sp_size 1 (dp=2) on the stage-2
                config, 2 rows a rank: XL/2 at full width, depth 4 / control 2, for 2
                steps (each rank's peak memory), then at depth 2 for 2 steps with
                a checkpoint: rank 0 alone writes the metrics and ``global_step2``,
                which one process loads exactly (the ranks' blocks, joined);
8. ``decode_vs_cpu``  the VAE decode on the card against the CPU's (fp32, TF32 off,
                one view of 5 latent frames, so the 3 + 2 streaming runs), and a
                bf16 against an fp32 decode of one main-path view on the card,
                beside two controls with one cast point moved;
9. ``app``      the inference app (``magicdrive_v2_tpu_torch.scripts.
                inference_magicdrive``) on the 424x800 config with synthetic
                conditioning, 9 frames (cut from 17), 2 steps; checks its launch
                counters and the 9 PNG frames of the 2x3 grid it wrote;
10. ``dataset`` writes a nuScenes-format set to a temporary directory (two scenes
                of 41 frames at 12 Hz, six 1600x900 JPEG views a frame, 3-20 boxes
                of the ten classes), builds the 224x400 and 424x800 pipelines from
                the dataset yamls through the port's composition, and times a clip
                and a batch of 4 through the threaded loader; requires the native
                polygon fill (timed on the BEV object layers);
11. ``test_app`` the W-CODA test app (``scripts.test_magicdrive``) on a config
                whose ``_base_`` is the 424x800 inference config, with a dataset on
                that set: XL/2 bf16, 9 frames (cut from 17), 1 Euler step, the
                CogVideoX-2b VAE decode, back-transform to 900x1600, 8 all-in-one
                frames read back;
                launch counters; host and device seconds apart;
12. ``train_data`` the train app on a config whose ``_base_`` is the stage-2 config,
                with a dataset on that set: XL/2 at full width and depth, b=4,
                remat, the bf16 CogVideoX-2b VAE encode in front of every step, 2
                steps (the first untimed): s/step, VAE-encode s/step, loader wait,
                peak memory, launch counters;
13. ``brushnet_vs_plain``  XL/2-SDEBrushNet at full width, depth 2 / control
                depth 1, one forward with a frame mask at 6x424x800x17f: kernels
                against plain versions in fp32 and bf16; another mask or inpaint
                timestep moves the output;
14. ``brushnet`` full XL/2-SDEBrushNet (28 + 28 BrushNet blocks) from the 424x800
                BrushNet config, bf16, 6x424x800x17f, batched CFG, t_inpaint 200:
                launches of a forward, one request of 2 steps with the VAE decode
                (s/step, s/sample, peak memory), the ShallowEncoder, the mask resize
                and the structured noise timed apart; then ``brushnet_plain``: one
                request of the plain BrushNet type, 2 steps;
15. ``repaint``  base XL/2 from the 424x800 repaint config (two-pass CFG), 3 steps,
                the reference VAE-encoded on the card: the kept region of the final
                latents equals the reference exactly;
16. ``brushnet_apps`` the BrushNet app (``--sde``) and the repaint app on their
                configs, 9 frames, 2 steps, frames read back; and (after phase 11)
                ``brushnet_test_app``: the W-CODA app with ``--sde`` on the
                generated set;
17. ``brushnet_grads``  XL/2-SDEBrushNet at full width, depth 2 / control depth
                1, the stage-2 bucket, only the BrushNet branch trainable,
                ``train=True``: one training loss backward through the kernels
                against one through their plain versions in fp32 and bf16 (the rules
                of phase 6); every branch tensor has a grad, no frozen one has; the
                launches and each Function's backwards equal their counts derived
                from the graph;
18. ``brushnet_train``  the BrushNet trainer at full width in the stage-2
                bucket and settings (b=4, remat, bf16 over fp32 masters, AdamW, EMA
                0.99): XL/2-SDEBrushNet at depth 7 / control depth 4, 2 steps (the
                SDE loss, the cutoff jitter), then ``brushnet_train_plain``: the
                BrushNet type at depth 7 / control depth 4, 2 steps;
                the frozen base and its EMA bit-equal after the steps, every branch
                tensor moved, the EMA identity, launches and backwards as derived;
                s/step, tokens/s, peak memory;
19. ``remat``   base XL/2 at depth 7 / control depth 4, stage-2 bucket, b=1:
                forward and backward under each
                remat policy (``full``, ``dots``, ``offload_carry``) over the same
                state on the card, one untimed and 2 timed (median, spread); grads
                against ``full``'s, peak memory, bytes sent to the host;
20. ``brushnet_train_app``  the BrushNet train app on the tiny config, with and
                without ``--sde``, 2 steps; its checkpoint read back strictly;
21. ``app848``  (after phase 12) the W-CODA app on the 848x1600 config
                (``configs/magicdrive/test/17-16x848x1600_map0_fsp4_cfg2.0.py``,
                rflow-slice) over the generated set through the 848x1600 dataset
                yaml, 5 frames, 1 step, ``image_filename`` frames read back; launch
                counters;
                every shape it handed a wrapper held against its plain version as
                in phase 3 (``app848_kernel_cases``);
22. ``pedestrian`` the SMPL pedestrian pipeline (``scripts.pipeline_12hz.run_scene``:
                pass 1, pose smoothing, inpainting, pass 2) at full size: a model in
                the SMPL pickle's layout at SMPL's sizes (6890 vertices, 24 joints,
                10 betas, 207 pose directions) written and loaded through
                ``make_real_processor(path, device="cuda")``; a synthetic scene of six
                900x1600 cameras at nuScenes' yaws (f=1266), 12 frames, 4 pedestrians
                (two overlapping in CAM_FRONT) rendered with a known texture; two runs
                on the card (bit-equal) and one of the port on the host (the same
                pairs, textures within 1e-5, PNGs within 0.1 % of pixels); every
                texture within 0.25 of the known one, every mask non-empty; seconds
                of each stage, of the host rasterizer and its share, of PNG writing,
                peak memory;
21a. ``app848_sde``, ``app848_brushnet`` (after ``app848``) the W-CODA app on the
                17-16 848x1600 SDE-BrushNet config at full depth (28 + 28 BrushNet
                blocks, control 13) and on the BrushNet one at depth 7 / control 4
                (``--cfg-options``), as ``app848`` runs them: 5 frames, 1 step, the
                frames read back, launch counters (SDE: K1 97, K2 304, K3 82 a
                forward), every shape held against its plain version;
21b. ``sde848_65f`` the 65-frame 848x1600 SDE-BrushNet config through
                ``MagicDrivePipeline.from_config`` in one process (sp_size 4 runs
                unsharded; 5300 tokens a frame, 540,600 a forward): full width, depth
                14 / control 7, 1 step of rflow-sdebrushnet-slice, ``sample(decode=False)``,
                the pedestrian frames and masks drawn on the card; then one view's 17
                latent frames through the tiled decode (65 frames); s/step, peak
                memory, launches, every shape held;
23. ``extract_masks`` ``tools.extract_masks`` with its stub backend over 12 JPEGs of
                900x1600 on the card and on the host: the masks equal; then the
                transformers backend and the pipeline's SegFormer segmenter on a tiny
                seeded SegFormer written locally, card against host in fp32;
24. ``ped_video`` (after ``pedestrian``, whose first card run's renders it keeps):
                OpenCV's video backend (FFMPEG required); the 900x1600 renders resized
                to 424x800 (PIL bicubic, masks nearest; a black frame where a camera
                saw nobody), laid out per camera and written by ``tools.
                create_video_12hz`` as the 2x3 grid ``videos.mp4`` / ``masks.mp4`` and
                by ``tools.img_folder2vid`` as ``<CAM>.mp4`` / ``<CAM>_mask.mp4``
                (mp4v); both read back by the apps' loaders (``load_grid_video``,
                ``load_pedestrian_inputs``) and held against the frames written (each
                view within 0.5 levels on average and 0.2 of its mean level, each
                mask's IoU >= 0.99, pedestrians in exactly the views written, no view
                swapped); then, once phase plan_memory's ranks have ended, the W-CODA
                app with ``--sde --ped-video-dir`` on
                the grid, XL/2-SDEBrushNet at full width and depth, 9 frames, 1 step:
                the model given the loader's arrays bit for bit, launch counters, the
                frames read back, every shape held against its plain version;
25. ``kernel_bench`` ``tools.kernel_bench``: K1 at G=60, N=1350, H=16, D=72 in
                bf16, J=1 and J=2, the kernel, its plain version and SDPA, chained ms;
                the kernel within the limits of phase 3 against the plain version;
26. ``perf_lab``  ``tools.perf_lab``: ``time`` of the 424p batched-CFG step at 2
                chained steps (p50 of 3 calls), then ``profile`` of one step and
                ``report`` of its trace: the three kernels found by their CUDA names,
                the device time summed over kernels within the timed step's, the
                device's busy share;
27. ``plan_memory`` ``tools.plan_memory`` at full width, 6 x 424x800 x 17, depth 4 /
                control 2, remat full, on (dp, sp) = (2, 1), then (1, 2) (each case's
                ranks share the card over gloo; they run beside phases pedestrian,
                extract_masks and ped_video's host part, whose seconds they lengthen,
                and end before ped_video's app runs): each rank's parameter and
                buffer bytes equal to the fsdp split's, the loss and grad norm equal
                on every rank, each rank's peak.

Every phase prints one JSON line. Any failure raises: the exit code is then not
0 and no result line is printed. Without a card the script exits with code 1.

Options (none needed): ``--steps N`` sampling steps of phase slice (default 5),
``--requests N``
(default 1), ``--seed S`` weights seed, ``--profile`` to add ``profile`` phases
(device time by kernel over one Euler step, over the decode of one view and over
one train step, from torch.profiler).

cuDNN keeps its default algorithm choice (``torch.backends.cudnn.benchmark`` off),
under which the rerun of one seed must give the same video bit for bit.
"""
import argparse
import contextlib
import gc
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import weakref

STARTED = time.time()

# data-sheet peaks of an H100 SXM: dense bf16 tensor-core rate, fp32 CUDA-core
# rate, device-memory rate. Bounds below are arithmetic on these, not measurements.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

NUM_FRAMES, HEIGHT, WIDTH = 17, 424, 800
# frames of the apps' runs (app, brushnet_apps, test_app, brushnet_test_app, app848):
# cut from 17 to keep the script inside its time; the samplers' phases keep 17
APP_FRAMES = 9
# frames of the 848x1600 W-CODA runs (app848, app848_sde, app848_brushnet): cut from 9
# (two latent frames, so their temporal attention still mixes frames)
APP848_FRAMES = 5
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
WCODA_POST = dict(resize=[848, 1600], padding=[0, 52, 0, 0], cut_length=APP_FRAMES - 1)
L_BOX = 10  # box slots per frame in the synthetic batch
CAMERA_NEIGHBORS = ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0))


def optional_packages():
    """Version of each package outside torch / numpy that the port uses or a later
    slice may want (image decoding, dataset yamls, map caches, a real T5 or SegFormer,
    video files, the train app's TensorBoard scalars), or that the JAX package's host
    code used and the port does without (scipy, cv2), or that a real HMR2 fitter needs
    (hmr2); or why it does not import.
    A record, not a gate."""
    import importlib
    found = {}
    for name in ("PIL", "yaml", "h5py", "transformers", "imageio", "scipy", "cv2", "hmr2",
                 "tensorboard"):
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
    """One phase's JSON line; ``wall_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "wall_s": time.time() - STARTED}),
          flush=True)


def since_start(timeline, name):
    """Notes in ``timeline`` the seconds since this process started under ``name``
    (a rank's timeline: where its time goes beside its steps)."""
    timeline[name] = time.time() - STARTED


def await_go(deadline_s, var="MDV2_GO_FILE"):
    """In a rank started before its parent is ready for it: waits until the file
    the environment variable ``var`` names exists (the parent makes it when its own
    work on the card is done: MDV2_GO_FILE before the ranks' timed steps,
    MDV2_START_FILE before they touch the card at all). Returns at once without
    the variable."""
    path = os.environ.get(var)
    end = time.time() + deadline_s
    while path and not os.path.exists(path):
        require(time.time() < end, f"{path} did not appear within {deadline_s} s")
        time.sleep(0.05)


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


def device_time_ms(torch, fn, iters, lead_ms=200.0):
    """Milliseconds of ``fn`` on the card alone and on the host, each the mean of
    ``iters`` calls after one warm-up: the calls are queued while the card spins
    for about ``lead_ms`` (at 2 GHz), so the events between them see no launch gap
    of the host's as long as the host's time (the second number, a call) stays
    under ``lead_ms / iters``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(lead_ms * 2e6))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, host_ms


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


def sp848_shapes(torch):
    """The shapes and types phase sp848 hands each wrapper (besides
    ``encode_conditions``'s, which the 424x800 path's share): one pass of
    rflow-slice, b=1, 6 views x 5 latent frames, S = 5600 tokens (53 x 100 padded to
    56 x 100), 16 heads of 72, width 1152; keyed as ``recorded_shapes`` keys them."""
    k1 = {((30, 5600, 3, 16, 72), torch.bfloat16, True, 1): None,
          ((30, 5600, 3, 16, 72), torch.bfloat16, True, 2): cross_view_perm(5)}
    k2 = {((6, 28000, 1152), torch.bfloat16)}
    return k1, k2


def sp848_k3(l_cond):
    """K3's shapes on that path: the condition cross-attention, and the temporal
    transformers of ``encode_conditions`` at b=1 (head dim 144 over the 17 frames:
    b*NC*L_BOX box sequences and b*NC camera-pose sequences)."""
    import torch
    return {((30, 5600, 16, 72), l_cond, torch.bfloat16),
            ((60, 17, 8, 144), 17, torch.bfloat16), ((6, 17, 8, 144), 17, torch.bfloat16)}


def perm_sources(kv_perm):
    """J, the k/v sources a K1 call sums over: 1 without ``kv_perm`` or with a (G,)
    one, else its first dim."""
    import numpy as np
    return 1 if kv_perm is None or np.ndim(kv_perm) == 1 else len(kv_perm)


def no_shapes():
    """An empty record for ``recorded_shapes``."""
    return {"fused_qkv_attention": {}, "adaln_modulate": set(), "flash_attention": set()}


class HeldCases:
    """Each kernel's wrapper against its plain version on the card, case by case,
    within the limits of ``compare``; remembers every shape and type it held, keyed
    as ``recorded_shapes`` keys them, so that a path's shapes can be held after it
    ran (``hold``)."""

    def __init__(self, torch):
        self.torch = torch
        self.gen = torch.Generator(device="cpu").manual_seed(0)
        # the large inputs are drawn on the card: a CPU draw of one 848x1600 K1 input
        # (580 M numbers) takes seconds
        self.card_gen = torch.Generator(device="cuda").manual_seed(0)
        self.cases = []
        self.worst = {"fused_qkv_attention": 0.0, "adaln_modulate": 0.0,
                      "flash_attention": 0.0}
        self.held = {name: set() for name in self.worst}
        self.backward_worst = dict.fromkeys(self.worst, 0.0)  # check_functions'

    def randn(self, *shape, dtype):
        return self.torch.randn(*shape, generator=self.card_gen, device="cuda").to(dtype)

    def judge(self, kernel, out, ref, slack, **what):
        self.torch.cuda.synchronize()
        err, ratio, rms_ratio, rms = compare(self.torch, out, ref, slack)
        self.cases.append(dict(kernel=kernel, **what, dtype=str(out.dtype), max_abs_err=err,
                               ref_rms=rms, err_over_limit=ratio, rms_err_over_limit=rms_ratio))
        require(ratio <= 1.0 and rms_ratio <= 1.0, self.cases[-1])
        self.worst[kernel] = max(self.worst[kernel], err)

    def k1(self, G, N, H, D, dtype, norm, perm, path=None):
        from magicdrive_v2_tpu_torch.ops import fused_qkv_attention, fused_qkv_attention_plain
        torch = self.torch
        J = perm_sources(perm)
        key = ((G, N, 3, H, D), dtype, norm, J)
        if key in self.held["fused_qkv_attention"]:
            return
        self.held["fused_qkv_attention"].add(key)
        qkv = self.randn(G, N, 3, H, D, dtype=dtype)
        qw = kw = None
        if norm:
            qw = (torch.randn(D, generator=self.gen) * 0.1 + 1).cuda()
            kw = (torch.randn(D, generator=self.gen) * 0.1 + 1).cuda()
        # the plain version's fp32 logits at most ~2 GiB a chunk of groups
        chunk = max(1, min(G, 6, 2 ** 31 // (H * N * N * 4)))
        out = fused_qkv_attention(qkv, qw, kw, perm)
        ref = fused_qkv_attention_plain(qkv, qw, kw, perm, group_chunk=chunk)
        slack = None
        if dtype == torch.bfloat16:  # sum_m p_m |v_m|, summed over the sources too
            qkv[:, :, 2].abs_()
            slack = 2.0 ** -7 * fused_qkv_attention_plain(
                qkv, qw, kw, perm, group_chunk=chunk).float()
        self.judge("fused_qkv_attention", out, ref, slack, shape=[G, N, H, D], J=J,
                   norm=norm, path=path)

    def k2(self, B, n, C, dtype, path=None):
        from magicdrive_v2_tpu_torch.ops import adaln_modulate, adaln_modulate_plain
        key = ((B, n, C), dtype)
        if key in self.held["adaln_modulate"]:
            return
        self.held["adaln_modulate"].add(key)
        x = self.randn(B, n, C, dtype=dtype) * 3 + 0.5
        sh, sc = self.randn(B, C, dtype=dtype), self.randn(B, C, dtype=dtype)
        self.judge("adaln_modulate", adaln_modulate(x, sh, sc),
                   adaln_modulate_plain(x, sh, sc), ADALN_SLACK, shape=[B, n, C], path=path)

    def k3(self, B, n, M, H, D, dtype, path=None):
        from magicdrive_v2_tpu_torch.ops import flash_attention, flash_attention_plain
        key = ((B, n, H, D), M, dtype)
        if key in self.held["flash_attention"]:
            return
        self.held["flash_attention"].add(key)
        q = self.randn(B, n, H, D, dtype=dtype)
        kv = self.randn(B, M, 2, H, D, dtype=dtype)  # k and v as views of one projection
        k, v = kv[:, :, 0], kv[:, :, 1]
        slack = None
        if dtype == self.torch.bfloat16:
            slack = 2.0 ** -7 * flash_attention_plain(q, k, v.abs()).float()
        self.judge("flash_attention", flash_attention(q, k, v), flash_attention_plain(q, k, v),
                   slack, shape=[B, n, M, H, D], path=path)

    def hold(self, seen, path):
        """Every shape in ``seen`` (a record of ``recorded_shapes``) in fp32 and in
        bf16, those not held yet; then every recorded key is a held one. Returns the
        cases this call added."""
        torch = self.torch
        first = len(self.cases)
        for dtype in (torch.float32, torch.bfloat16):
            for (shape, _, norm, _), perm in sorted(seen["fused_qkv_attention"].items(),
                                                    key=str):
                self.k1(shape[0], shape[1], shape[3], shape[4], dtype, norm, perm, path)
            for shape, _ in sorted(seen["adaln_modulate"], key=str):
                self.k2(*shape, dtype, path)
            for qshape, m, _ in sorted(seen["flash_attention"], key=str):
                self.k3(qshape[0], qshape[1], m, qshape[2], qshape[3], dtype, path)
        require(set(seen["fused_qkv_attention"]) <= self.held["fused_qkv_attention"]
                and seen["adaln_modulate"] <= self.held["adaln_modulate"]
                and seen["flash_attention"] <= self.held["flash_attention"], (path, seen))
        return self.cases[first:]


def k1_timing_row(torch, held, G, N, H, J, iters, plain_chunk):
    """K1 in bf16 at (G, N, H, 72) with J sources (J=2: the cross-view permutation of
    G // 6 view groups), kernel and plain version (``plain_chunk`` groups a pass)
    timed, beside SDPA on the q/k/v views (for J=2 two calls on the sources' k/v,
    summed), the bound and the achieved TFLOP/s."""
    import torch.nn.functional as F
    from magicdrive_v2_tpu_torch.ops import fused_qkv_attention, fused_qkv_attention_plain
    D = 72
    qkv = held.randn(G, N, 3, H, D, dtype=torch.bfloat16)
    qw = (torch.randn(D, generator=held.gen) * 0.1 + 1).cuda()
    perm = None if J == 1 else torch.from_numpy(cross_view_perm(G // 6)).cuda()
    row = dict(shape=[G, N, H, D], J=J,
               ms=time_ms(torch, lambda: fused_qkv_attention(qkv, qw, qw, perm), iters),
               plain_ms=time_ms(torch, lambda: fused_qkv_attention_plain(
                   qkv, qw, qw, perm, group_chunk=plain_chunk), 1))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if perm is None:
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v),
                                    iters)
    else:
        src = [(k[perm[j].long()], v[perm[j].long()]) for j in range(J)]
        row["library_ms"] = time_ms(
            torch, lambda: F.scaled_dot_product_attention(q, *src[0])
            + F.scaled_dot_product_attention(q, *src[1]), iters)
    flops = J * 4.0 * G * H * N * N * D
    row["bound_ms"], row["bound_by"] = bound(flops, 2.0 * (qkv.numel() + G * N * H * D),
                                             PEAK_BF16)
    row["tflops"] = flops / (row["ms"] * 1e9)
    return row


def check_kernels(torch, seen, l_cond):
    """``seen``: what ``recorded_shapes`` noted on the main path; the 848x1600
    path's shapes (``sp848_shapes``) are held too. Returns the timings and the
    ``HeldCases`` that later phases add their paths' shapes to."""
    import torch.nn.functional as F
    from magicdrive_v2_tpu_torch.ops import (adaln_modulate, adaln_modulate_plain,
                                             flash_attention, flash_attention_plain,
                                             flash_fused, fused_qkv_attention,
                                             fused_qkv_attention_plain)
    from magicdrive_v2_tpu_torch.ops.flash_attention import attend_bf16, plan_bf16
    dev = "cuda"
    held = HeldCases(torch)
    gen, randn = held.gen, held.randn
    both = (torch.float32, torch.bfloat16)

    # ---- K1 fused qkv attention
    SP848_K1, SP848_K2 = sp848_shapes(torch)
    G, N, H, D = 60, 1350, 16, 72
    main_k1 = {((G, N, 3, H, D), torch.bfloat16, True, J) for J in (1, 2)}
    require(main_k1 <= set(seen["fused_qkv_attention"]), sorted(map(str, seen["fused_qkv_attention"])))
    for (shape, _, norm, _), perm in sorted(seen["fused_qkv_attention"].items(), key=str):
        for dtype in both:
            held.k1(shape[0], shape[1], shape[3], shape[4], dtype, norm, perm, path="sample")
    for dtype in both:
        for norm in (True, False):
            # N=1350 (424x800) and N=5300 (848x1600): the regimes of the three TPU bodies
            held.k1(6, 1350, 16, 72, dtype, norm, None)
            held.k1(6, 1350, 16, 72, dtype, norm, cross_view_perm(1))
            held.k1(2, 5300, 16, 72, dtype, norm, None)
        held.k1(6, 5300, 16, 72, dtype, True, cross_view_perm(1))
        # ragged tiny shapes: last q and k tiles partial, head dims below the tile widths
        held.k1(3, 70, 2, 8, dtype, True, [[1, 2, 0], [2, 0, 1]])
        held.k1(2, 130, 3, 24, dtype, True, [1, 0])
        # the 848x1600 path (phase sp848): G = 30 (6 views x 5 latent frames, one pass
        # of rflow-slice), N = 5600 (the fsp8 pad), spatial and cross-view; and the
        # heads a rank of the fsp8 config holds at sp=2 and sp=4: 8 and 4
        for (shape, _, norm, _), perm in sorted(SP848_K1.items(), key=str):
            held.k1(shape[0], shape[1], shape[3], shape[4], dtype, norm, perm, path="sp848")
        for heads in (8, 4):
            held.k1(30, 5600, heads, 72, dtype, True, None)

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
    # the blocked regime (K1b / K1c) on the 848x1600 path: G = 30, N = 5600, the heads
    # of one rank at sp = 1, 2, 4; cross-view at 16 heads
    k1["n5600_g30"] = {}
    for heads, J in ((16, 1), (8, 1), (4, 1), (16, 2)):
        k1["n5600_g30"][f"h{heads}" + ("_cross_view" if J == 2 else "")] = k1_timing_row(
            torch, held, 30, 5600, heads, J, iters=2, plain_chunk=1)

    # ---- K2 adaLN modulate
    B, n, C = 12, 6750, 1152
    require(((B, n, C), torch.bfloat16) in seen["adaln_modulate"],
            sorted(map(str, seen["adaln_modulate"])))
    for dtype in both:
        for shape, _ in sorted(seen["adaln_modulate"], key=str):
            held.k2(*shape, dtype, path="sample")
        for shape, _ in sorted(SP848_K2, key=str):
            held.k2(*shape, dtype, path="sp848")
        # the tiny configuration's width, the widest row and the narrowest
        for shape in ((2, 37, 64), (2, 5, 1280), (3, 9, 8)):
            held.k2(*shape, dtype)
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
    # the 848x1600 path's shape (phase sp848)
    x = randn(6, 28000, C, dtype=torch.bfloat16)
    sh, sc = randn(6, C, dtype=torch.bfloat16), randn(6, C, dtype=torch.bfloat16)
    k2["x_6_28000"] = dict(
        ms=time_ms(torch, lambda: adaln_modulate(x, sh, sc), 20),
        plain_ms=time_ms(torch, lambda: adaln_modulate_plain(x, sh, sc), 3),
        library_ms=time_ms(torch, lambda: F.layer_norm(x, (C,), eps=1e-6)
                           * (1 + sc[:, None]) + sh[:, None], 5))
    k2["x_6_28000"]["bound_ms"], k2["x_6_28000"]["bound_by"] = bound(
        8.0 * x.numel(), 2.0 * (2 * x.numel() + 2 * 6 * C), PEAK_FP32)
    del x

    # ---- K3 flash attention: the condition cross-attention's shapes
    B, n, M = 60, 1350, l_cond
    require(((B, n, H, D), M, torch.bfloat16) in seen["flash_attention"],
            sorted(map(str, seen["flash_attention"])))
    for dtype in both:
        for (qshape, m, _) in sorted(seen["flash_attention"], key=str):
            held.k3(qshape[0], qshape[1], m, qshape[2], qshape[3], dtype, path="sample")
        for (qshape, m, _) in sorted(sp848_k3(l_cond), key=str):
            held.k3(qshape[0], qshape[1], m, qshape[2], qshape[3], dtype, path="sp848")
        # the cross-attention's other layout (one condition sequence for all frames),
        # a ragged key length, tiny heads
        for shape in ((12, 6750, l_cond, 16, 72), (3, 1350, 77, 16, 72),
                      (2, 50, 13, 2, 8), (2, 77, 200, 4, 16)):
            held.k3(*shape, dtype)
        for shape in K3_BRANCH_CASES:
            held.k3(*shape, dtype)
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
    # the 848x1600 path's shape (phase sp848): q (30, 5600, 16, 72)
    q8 = randn(30, 5600, H, D, dtype=torch.bfloat16)
    kv8 = randn(30, M, 2, H, D, dtype=torch.bfloat16)
    k8, v8 = kv8[:, :, 0], kv8[:, :, 1]
    row = dict(ms=time_ms(torch, lambda: flash_attention(q8, k8, v8), 10),
               plain_ms=time_ms(torch, lambda: flash_attention_plain(q8, k8, v8), 2),
               library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                   q8.transpose(1, 2), k8.transpose(1, 2), v8.transpose(1, 2)), 10))
    fl = 4.0 * 30 * H * 5600 * M * D
    row["bound_ms"], row["bound_by"] = bound(fl, 2.0 * (2 * q8.numel() + kv8.numel()), PEAK_BF16)
    k3["q_30_5600"] = row
    del q8, kv8, k8, v8
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
    emit("kernel_cases", fp32_limit=FP32_LIMIT,
         bf16_limit="every element 2**-7 * |ref| + slack, slack = 2**-7 * sum p|v| "
                    f"(attention) or {ADALN_SLACK} (adaLN); and rms(err) <= 2**-6 * rms(ref)",
         cases=held.cases)
    return {"fused_qkv_attention": k1, "adaln_modulate": k2, "flash_attention": k3}, held


# ---------------------------------------------------------------------------
# phases 3 and 4: the slice
# ---------------------------------------------------------------------------


def xl2_config(torch, dtype, **overrides):
    """XL/2 as the 424x800 config builds it (``tools/perf_lab.flagship_config``)."""
    from magicdrive_v2_tpu_torch.tools.perf_lab import flagship_config
    return flagship_config(dtype, **overrides)


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


def blocks_of(cfg):
    """The transformer blocks of one denoiser forward in their order, as (role,
    depth, spatial, cross_view, cross_attn): a spatial block launches K1 for its
    self-attention, another K1 for cross-view attention, K3 for condition
    cross-attention, and K2 for each of its two norms (three with cross-view). A
    BrushNet model adds its branch: a spatial block a depth (no cross-view attention
    when the control blocks skip it) and a temporal one, neither with condition
    cross-attention (``brushnet_skip_cross_attn``)."""
    brush = hasattr(cfg, "sde_inpaint")  # BrushNetConfig
    for i in range(cfg.depth):
        ctrl = i < cfg.control_depth
        yield "base_s", i, True, True, True
        if ctrl:
            yield "control_s", i, True, not cfg.control_skip_cross_view, True
        if brush:
            yield ("brushnet_s", i, True, not cfg.control_skip_cross_view,
                   not cfg.brushnet_skip_cross_attn)
        if cfg.with_temp_block:
            yield "base_t", i, False, False, True
        if ctrl and not cfg.control_skip_temporal:
            yield "control_t", i, False, False, True
        if brush and (cfg.with_temp_block or ctrl):
            yield "brushnet_t", i, False, False, not cfg.brushnet_skip_cross_attn


def expected_launches(cfg, x_mask=False, blocks=None):
    """Kernel launches of one denoiser forward with a condition cache (of the
    ``blocks`` of ``blocks_of`` given, else all); with a frame mask every adaLN runs
    twice (the t and t0 modulations)."""
    n = {"fused_qkv_attention": 0, "adaln_modulate": 0, "flash_attention": 0}
    for _, _, spatial, cross_view, cross_attn in (blocks_of(cfg) if blocks is None
                                                  else blocks):
        n["fused_qkv_attention"] += spatial + cross_view
        n["adaln_modulate"] += (2 + cross_view) * (2 if x_mask else 1)
        n["flash_attention"] += cross_attn
    return n


def expected_backward_calls_frozen_base(cfg, x_mask=False):
    """Backwards of each kernel's Function in one training loss of a BrushNet model
    with only its branch trainable, derived from the graph: every call whose inputs
    require grad. The branch's blocks hold trainable weights; the base stream x
    requires grad from depth 0's BrushNet skip on, so every base block but depth 0's
    spatial one; the control stream c never does (frozen weights on frozen
    inputs), nor does ``encode_conditions``."""
    return expected_launches(cfg, x_mask, [
        b for b in blocks_of(cfg) if b[0].startswith("brushnet")
        or (b[0].startswith("base") and (b[1] > 0 or b[0] == "base_t"))])


def counters():
    from magicdrive_v2_tpu_torch.ops import (adaln_modulate, flash_attention,
                                             fused_qkv_attention)
    return {"fused_qkv_attention": fused_qkv_attention, "adaln_modulate": adaln_modulate,
            "flash_attention": flash_attention}


def reset_counters():
    for fn in counters().values():
        fn.launches = fn.backward_launches = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


def reset_backward_calls():
    from magicdrive_v2_tpu_torch.ops.kernel_vjp import backward_calls
    backward_calls.clear()


def read_backward_launches():
    """Launches of each kernel's backward kernels, counted by its wrapper where it
    launches them (the forward's counters count none of them)."""
    return {name: fn.backward_launches for name, fn in counters().items()}


def read_backward_calls():
    """Backwards of each kernel's ``KernelFunction``; fails unless each ran the
    backward kernels, as many times as the wrapper launched them."""
    from magicdrive_v2_tpu_torch.ops.kernel_vjp import backward_calls
    calls = {name: backward_calls.get(name, 0) for name in counters()}
    require(calls == read_backward_launches(), (calls, read_backward_launches()))
    return calls


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


def routed(route):
    """The model's three kernel sites routed to ``route`` ("kernels", "plain" or
    three callables) for the duration: ``tools/block_bench.routed``, which puts
    back what was there on exit (for the comparisons only: the package itself
    has no such switch)."""
    from magicdrive_v2_tpu_torch.tools.block_bench import routed as route_sites
    return route_sites(route)


@contextlib.contextmanager
def recorded_shapes(seen):
    """Note every distinct shape and type the model hands to a kernel's wrapper,
    then call the wrapper as the model would."""
    from magicdrive_v2_tpu_torch.tools.block_bench import patch_points
    k1, k2, k3 = (getattr(mod, name) for mod, name in patch_points())

    def rec_k1(qkv, qw, kw, kv_perm=None, scale=None):
        J = perm_sources(kv_perm)
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

    with routed((rec_k1, rec_k2, rec_k3)):
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
    seen = no_shapes()
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
         **shape_record(seen))
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
    else:  # two seeds through a one-step sample, without the decode: they differ
        from magicdrive_v2_tpu_torch.config.presets import rflow
        from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
        scheduler, pipe.scheduler = pipe.scheduler, build_scheduler(rflow(num_sampling_steps=1))
        try:
            one_step = [pipe.sample(cond, num_frames=NUM_FRAMES, height=HEIGHT, width=WIDTH,
                                    torch_seed=seed, decode=False) for seed in (1024, 1025)]
        finally:
            pipe.scheduler = scheduler
        require(float((one_step[0] - one_step[1]).abs().max()) > 1e-3, "seeds gave one result")
        del one_step

    # determinism: the first request again, bit for bit, decoded video included
    v_again = pipe.sample(cond, num_frames=NUM_FRAMES, height=HEIGHT, width=WIDTH,
                          torch_seed=1024)
    require(torch.equal(latents[-1], latents[0]), "two runs of one seed differ (latents)")
    require(torch.equal(v_again, videos[0]), "two runs of one seed differ (video)")
    del pipe.decode  # the class's method again (a bound one kept here is a cycle)
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
        with routed("plain"):
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
# phases sp848, sp_ranks and app848: sequence-parallel serving at 848x1600
# ---------------------------------------------------------------------------

SP848_CONFIG = "configs/magicdrive/inference/fullx848x1600_stdit3_CogVAE_boxTDS_wCT_xCE_wSST.py"
APP848_CONFIG = "configs/magicdrive/test/17-16x848x1600_map0_fsp4_cfg2.0.py"
DATA_YAML_848 = "Nuscenes_400_map_cache_box_t_with_n2t_12Hz_848x1600"
H848, W848 = 848, 1600
SP848_STEPS = 1
SP_RANKS = 4            # processes of phase sp_ranks (meshes (1, 4) and (2, 2))
SP_RANKS_FRAMES = 9     # frames of its forwards (cut from 17 to keep the script in time)
SP_RANKS_DEADLINE_S = 420
# sp_vae's check: 6 views of the 224x400 bucket (4 ranks decode on one card at once)
SP_VAE_LATENT = (6, 16, 5, TRAIN_HEIGHT // 8, TRAIN_WIDTH // 8)


def run_sp848(torch, seed, per_forward, encode_launches, l_cond, after_timed):
    """The fullx848x1600 config (sp_size 8, force_pad_h_for_sp_size 8,
    rflow-slice, VAE tiling 384) through ``from_config`` in one process of an NCCL
    group of one: fewer ranks than sp_size, so it runs unsharded with the fsp8 pad
    (S 5300 -> 5600), as the JAX package does with fewer devices. XL/2 at full
    width and depth in bf16, 6 views, 17 frames (cut from "full"), SP848_STEPS
    steps, ``sample(decode=True)``; then the same seed again without the decode:
    the latents bit-equal, and the shapes each wrapper was handed those phase
    ``kernels`` held (``sp848_shapes``, ``sp848_k3``). ``after_timed()`` is called
    between the timed sample and the rerun."""
    import torch.distributed as dist
    from magicdrive_v2_tpu_torch.config.config import Config, merge_dot_options
    from magicdrive_v2_tpu_torch.parallel.distributed import free_port
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        cfg = Config.fromfile(SP848_CONFIG)
        merge_dot_options(cfg, [f"scheduler.num_sampling_steps={SP848_STEPS}", f"seed={seed}"])
        t0 = time.time()
        pipe = MagicDrivePipeline.from_config(cfg, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.time() - t0
    finally:
        dist.destroy_process_group()
    mc = pipe.model_cfg
    require(pipe.mesh is None and not mc.enable_sequence_parallelism
            and mc.force_pad_h_for_sp_size == 8 and mc.depth == 28 and mc.hidden_size == 1152
            and pipe.scheduler.slice_cfg and pipe.vae.tiling, (pipe.mesh, mc))
    require(expected_launches(mc) == per_forward, (expected_launches(mc), per_forward))
    batch = synthetic_batch(mc, NUM_FRAMES, H848, W848, l_box=L_BOX,
                            l_txt=pipe.text_encoder.model_max_length)
    cond = {k: batch[k] for k in ("y", "maps", "bbox", "cams", "rel_pos", "fps")}
    H, W = -(-H848 // 16), -(-W848 // 16)  # tokens of the latent grid: 53 x 100
    pad = mc.force_pad_h_for_sp_size - H % mc.force_pad_h_for_sp_size
    S = (H + pad) * W
    require(pipe.model._h_pad_size(H, W) == pad and S == 5600, (pad, S))
    video, seconds, decode_s, latents, got, peak = timed_sample(
        torch, pipe, cond, height=H848, width=W848, torch_seed=1024)
    del pipe.decode
    # rflow-slice: two forwards a step, a condition cache for each
    want = {k: per_forward[k] * 2 * SP848_STEPS + 2 * encode_launches[k] for k in per_forward}
    require(got == want, (got, want))
    require(tuple(video.shape) == (1, 6, 3, NUM_FRAMES, H848, W848) and video.dtype ==
            torch.float32 and bool(video.isfinite().all()), (video.shape, video.dtype))
    after_timed()
    seen848 = no_shapes()
    with recorded_shapes(seen848):
        again = pipe.sample(cond, num_frames=NUM_FRAMES, height=H848, width=W848,
                            torch_seed=1024, decode=False)
    require(torch.equal(again, latents), "two runs of one seed differ (latents)")
    k1_held, k2_held = sp848_shapes(torch)
    require(set(seen848["fused_qkv_attention"]) == set(k1_held), seen848)
    require(seen848["adaln_modulate"] == k2_held, seen848)
    require(seen848["flash_attention"] == sp848_k3(l_cond), seen848)
    emit("sp848", config=SP848_CONFIG, model="MagicDriveSTDiT3-XL/2", dtype="bfloat16",
         sp_config=int(cfg.sp_size), sp_run=1, force_pad_h_for_sp_size=8, tokens_per_view=S,
         scheduler="rflow-slice", views=6, frames=NUM_FRAMES, height=H848, width=W848,
         steps=SP848_STEPS, vae_tiling=pipe.vae.tiling, setup_seconds=setup_s,
         seconds_per_step=(seconds - decode_s) / SP848_STEPS, decode_seconds=decode_s,
         seconds_per_sample_with_decode=seconds, peak_memory_bytes=peak,
         launches_per_forward=per_forward, launches_per_sample=got, deterministic=True,
         video_abs_mean=float(video.abs().mean()))
    del pipe, video, latents, again
    gc.collect()
    torch.cuda.empty_cache()
    return got


def sp_ranks_model(torch, seed, dtype=None, **overrides):
    """XL/2 at full width, depth 2 / control depth 1, fp32, on the current card."""
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    cfg = xl2_config(torch, torch.float32, depth=2, control_depth=1, **overrides)
    with torch.device("cuda"):
        model = MagicDriveSTDiT3(cfg).eval()
    init_weights(model, seed=seed)
    return model


def sp_ranks_cases():
    """(name, sp, mesh (dp, sp), pixels, dtype name, force_pad) of phase sp_ranks: one
    forward each, in this order on every rank."""
    return [("848_sp4_fp32", 4, (1, 4), (H848, W848), "fp32"),
            ("848_sp2_fp32", 2, (2, 2), (H848, W848), "fp32"),
            ("424_sp4_fp32", 4, (1, 4), (HEIGHT, WIDTH), "fp32"),
            ("848_sp4_bf16", 4, (1, 4), (H848, W848), "bf16"),
            ("848_sp2_bf16", 2, (2, 2), (H848, W848), "bf16")]


def sp_rank_worker(torch, out_dir, seed):
    """One rank of phase sp_ranks (``chip_smoke.py --sp-rank-worker DIR``): joins the
    group the parent describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_*, and the
    backend in MDV2_SP_BACKEND), runs every case of ``sp_ranks_cases`` sharded over
    its mesh, then sp_vae; rank 0 writes the outputs, every rank its launches, the
    K1 shapes of each case and the shapes each wrapper was handed."""
    import torch.distributed as dist
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import cast_model
    from magicdrive_v2_tpu_torch.parallel.distributed import maybe_initialize, shutdown
    from magicdrive_v2_tpu_torch.parallel.sharding import make_mesh, sp_vae, use_mesh
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
    backend = os.environ["MDV2_SP_BACKEND"]
    timeline = {}
    since_start(timeline, "imported")
    maybe_initialize("cuda", backend=backend, timeout_s=SP_RANKS_DEADLINE_S)
    rank = dist.get_rank()
    since_start(timeline, "joined")
    try:
        await_go(SP_RANKS_DEADLINE_S, "MDV2_START_FILE")
        since_start(timeline, "started")
        meshes = {(1, 4): make_mesh(1, 4), (2, 2): make_mesh(2, 2)}
        model = sp_ranks_model(torch, seed, enable_sequence_parallelism=True)
        since_start(timeline, "model_built")
        outs, launches, k1_shapes, seen_all = {}, {}, {}, no_shapes()
        for name, sp, mesh, (h, w), dt in sp_ranks_cases():
            if dt == "bf16" and model.dtype != torch.bfloat16:
                cast_model(model, torch.bfloat16)
            batch = to_card(torch, synthetic_batch(model.cfg, SP_RANKS_FRAMES, h, w,
                                                   l_box=L_BOX))
            seen = no_shapes()
            with torch.no_grad(), no_tf32(torch), use_mesh(meshes[mesh]), \
                    recorded_shapes(seen):
                reset_counters()
                out = model(**batch)
                torch.cuda.synchronize()
            launches[name] = read_counters()
            k1_shapes[name] = sorted({k[0] for k in seen["fused_qkv_attention"]})
            for key, perm in seen["fused_qkv_attention"].items():
                seen_all["fused_qkv_attention"].setdefault(
                    key, None if perm is None else torch.as_tensor(perm).cpu())
            seen_all["adaln_modulate"] |= seen["adaln_modulate"]
            seen_all["flash_attention"] |= seen["flash_attention"]
            if rank == 0:
                outs[name] = out.float().cpu()
            del out, batch
        del model
        torch.cuda.empty_cache()
        since_start(timeline, "forwards_done")
        vae = cogvideox_vae(torch, torch.float32, seed + 1)
        z = torch.randn(SP_VAE_LATENT, generator=torch.Generator().manual_seed(seed)).cuda()
        with torch.no_grad(), no_tf32(torch):
            video = sp_vae(z, vae.decode, meshes[(1, 4)])
        if rank == 0:
            outs["sp_vae"] = video.float().cpu()
        since_start(timeline, "sp_vae_done")
        torch.save(dict(outputs=outs, launches=launches, k1_shapes=k1_shapes, seen=seen_all,
                        backend=dist.get_backend(), world_size=dist.get_world_size(),
                        device=str(torch.cuda.current_device()), timeline=timeline),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown()
    return 0


def start_sp_ranks(n, out_dir, seed):
    """Starts ``n`` ranks of this script's sp worker (the port's ``RankGroup``: its
    ``wait`` fails, and kills every rank, when one fails or they outlive
    SP_RANKS_DEADLINE_S); they import and join, then wait for the file ``start`` in
    ``out_dir`` before they touch the card, so they can start while the phase before
    runs. Returns (the group, the backend: ``collective_backend``)."""
    import torch
    from magicdrive_v2_tpu_torch.parallel.distributed import RankGroup
    backend, local_ranks = collective_backend(torch, n)
    group = RankGroup(n, [os.path.abspath(__file__), "--sp-rank-worker", out_dir, "--seed",
                          str(seed)], SP_RANKS_DEADLINE_S,
                      env={"MDV2_SP_BACKEND": backend,
                           "MDV2_START_FILE": os.path.join(out_dir, "start")},
                      local_ranks=local_ranks)
    return group, backend


def run_sp_ranks(torch, seed, encode_launches, held, started):
    """XL/2 at full width, depth 2 / control depth 1: one forward at sp=2 (mesh
    (2, 2): two sp groups of 2) and one at sp=4 (mesh (1, 4)), 6x848x1600x9f, in
    fp32 and bf16, and the 424x800 shape at sp=4 (the sp pad: S 1350 -> 1400), in
    SP_RANKS processes; each against the unsharded forward on the card within
    phase slice_vs_plain's limits (fp32: 1e-3 x max(1, |ref|max); bf16: rms(sharded
    - unsharded) <= 2**-6 rms(unsharded) + rms(unsharded bf16 - unsharded fp32)).
    Then sp_vae of 6 views over the 4 ranks against the direct decode (fp32). Last,
    every shape a rank handed a wrapper is held against its plain version
    (``held``: the ``HeldCases`` of phase kernels). The ranks run beside the
    unsharded forwards, which only their outputs wait for. ``started``: (out_dir,
    group, backend) of the ranks ``start_sp_ranks`` started while the phase before
    ran."""
    out_dir, group, backend = started
    try:
        t_start = time.time()  # ranks_seconds: from the start file to the ranks' exit
        try:
            open(os.path.join(out_dir, "start"), "w").close()
            refs, direct, ref_seconds = sp_ranks_references(torch, seed)
            group.wait()
            ranks_seconds = time.time() - t_start
        finally:
            group.close()
        t0 = time.time()
        res = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
               for r in range(SP_RANKS)]
        load_seconds = time.time() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return check_sp_ranks(torch, res, refs, direct, backend, encode_launches, held,
                          ref_seconds, ranks_seconds, load_seconds)


def sp_ranks_references(torch, seed):
    """The unsharded forwards of phase sp_ranks on the card (keyed (h, w, dtype)),
    the direct decode, and their seconds."""
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import cast_model
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
    refs = {}
    t0 = time.time()
    with torch.no_grad(), no_tf32(torch):
        for force_pad, sizes in ((None, [(H848, W848)]), (4, [(HEIGHT, WIDTH)])):
            model = sp_ranks_model(torch, seed, force_pad_h_for_sp_size=force_pad)
            for dt in ("fp32", "bf16") if force_pad is None else ("fp32",):
                if dt == "bf16":
                    cast_model(model, torch.bfloat16)
                for h, w in sizes:
                    batch = to_card(torch, synthetic_batch(model.cfg, SP_RANKS_FRAMES, h, w,
                                                           l_box=L_BOX))
                    refs[(h, w, dt)] = model(**batch).float()
                    del batch
            del model
        torch.cuda.empty_cache()
        vae = cogvideox_vae(torch, torch.float32, seed + 1)
        z = torch.randn(SP_VAE_LATENT, generator=torch.Generator().manual_seed(seed)).cuda()
        direct = vae.decode(z).float()
        del vae, z
    torch.cuda.synchronize()
    ref_seconds = time.time() - t0
    torch.cuda.empty_cache()
    return refs, direct, ref_seconds


def check_sp_ranks(torch, res, refs, direct, backend, encode_launches, held, ref_seconds,
                   ranks_seconds, load_seconds):
    """Phase sp_ranks' checks of the ranks' results ``res`` against the references."""
    rms = lambda x: float(x.square().mean().sqrt())  # noqa: E731
    per_forward = expected_launches(xl2_config(torch, torch.float32, depth=2, control_depth=1))
    rows = {}
    for name, sp, mesh, (h, w), dt in sp_ranks_cases():
        out, ref = res[0]["outputs"][name].cuda(), refs[(h, w, dt)]
        require(out.shape == ref.shape and bool(out.isfinite().all()), (name, out.shape))
        err, scale = max_err(out, ref)
        row = dict(sp=sp, mesh=list(mesh), pixels=[h, w], max_abs_err=err, ref_max=scale,
                   k1_qkv_shapes=[list(s) for s in res[0]["k1_shapes"][name]],
                   launches_rank0=res[0]["launches"][name])
        heads = {s[3] for s in res[0]["k1_shapes"][name]}
        require(heads == {16 // sp}, (name, heads))
        if dt == "fp32":
            row["limit"] = 1e-3 * max(1.0, scale)
            require(scale > 1e-3 and err <= row["limit"], (name, row))
        else:
            ref32 = refs[(h, w, "fp32")]
            row["rms_err"] = rms(out - ref)
            row["rms_limit"] = FORWARD_BF16_RMS_LIMIT * rms(ref) + rms(ref - ref32)
            require(row["rms_err"] <= row["rms_limit"], (name, row))
        # every rank launches what one unsharded forward (conditions embedded) does
        want = {k: n + encode_launches[k] for k, n in per_forward.items()}
        require(all(r["launches"][name] == want for r in res),
                (name, want, [r["launches"][name] for r in res]))
        rows[name] = row
    video = res[0]["outputs"]["sp_vae"].cuda()
    err, scale = max_err(video, direct)
    rows["sp_vae"] = dict(views=SP_VAE_LATENT[0], ranks=SP_RANKS, shape=list(video.shape),
                          max_abs_err=err, ref_max=scale, limit=1e-3 * max(1.0, scale))
    require(video.shape == direct.shape and err <= rows["sp_vae"]["limit"], rows["sp_vae"])
    seen = no_shapes()
    for r in res:
        for key, perm in r["seen"]["fused_qkv_attention"].items():
            seen["fused_qkv_attention"].setdefault(key, perm)
        seen["adaln_modulate"] |= r["seen"]["adaln_modulate"]
        seen["flash_attention"] |= r["seen"]["flash_attention"]
    emit("sp_ranks", backend=backend, world_size=res[0]["world_size"],
         card_of_each_rank=[r["device"] for r in res], reference_seconds=ref_seconds,
         ranks_seconds=ranks_seconds, rank0_timeline=res[0]["timeline"],
         results_load_seconds=load_seconds, depth=2, control_depth=1, frames=SP_RANKS_FRAMES,
         results=rows, kernel_cases=held.hold(seen, "sp_ranks"))
    del refs, direct, video
    torch.cuda.empty_cache()
    # rank 0's launches over the phase's forwards
    return {k: sum(res[0]["launches"][name][k] for name, *_ in sp_ranks_cases())
            for k in per_forward}


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
FN_BF16_LIMIT = 2.0 ** -7    # bf16: of max|g_fp32|, beside the plain bf16 grad's own error
REMAT_REPS = 2               # timed forward+backward runs a remat policy
REMAT_DEPTH = (7, 4)         # depth and control depth (cut from 28 / 13, as below)


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


def train_batches(cfg, model_cfg, seed, dp_row=0):
    """The app's synthetic batches of steps 0, 1, ... with their frame masks and
    condition dropout, as numpy, those of dp row ``dp_row``; captions of the text
    encoder's full length."""
    from magicdrive_v2_tpu_torch.scripts.train_magicdrive import (SyntheticLoader,
                                                                   step_inputs)
    from magicdrive_v2_tpu_torch.utils.train_utils import MaskGenerator
    holder = {"step": 0}
    mask_gen = MaskGenerator(dict(cfg.get("mask_ratios", {})))
    for step, batch in enumerate(SyntheticLoader(model_cfg, cfg, holder,
                                                 l_txt=model_cfg.model_max_length,
                                                 dp_row=dp_row)):
        holder["step"] = step + 1
        yield step_inputs(batch, cfg, mask_gen, seed, step, dp_row)


# K1 at sp_train's shape after the all-to-all (N = 5300, 8 heads), cut to 2 groups:
# one source, and two through a perm that reads group 1 twice and group 0 never
SP_TRAIN_K1 = {((2, 5300, 3, 8, 72), None), ((2, 5300, 3, 8, 72), ((1, 0), (1, 1)))}
# The bf16 backward's Hopper body at what the model's path does not reach: K1 at
# the small head dims (padded widths 16 and 32, ragged tiles, two sources), K3 at
# head dim 72 with one key (dS exactly zero) and at head dim 8 over ragged keys
BODY_K1 = {((4, 130, 3, 2, 16), ((1, 2, 3, 0), (3, 0, 1, 2))), ((4, 70, 3, 2, 32), None),
           ((3, 100, 3, 2, 24), None)}
BODY_K3 = {((4, 350, 16, 72), 1), ((2, 200, 4, 8), 70)}
# The pre-pass vs its plain version, slack beside compare's 2**-7 * |ref|: the two sum
# the squares in other orders, so x r may round to neighbouring bf16 values (2**-7 of
# it at most), then each side rounds w (x r) (2**-8 each): 2**-6 of the exact w x r,
# and ref itself lies half an ulp from that
PREPASS_LIMIT = 3 * 2.0 ** -8


def check_functions(torch, seen, held, with_extra_cases=False):
    """Each kernel's autograd.Function (its forward and backward kernels) against
    autograd through the plain version in fp32 on the same inputs, at every shape
    and type ``seen`` noted on the training path, including K1 with two sources and
    K3 on strided k/v views at head dims 72 and 144 (and, ``with_extra_cases``, K1
    at ``SP_TRAIN_K1`` and ``BODY_K1`` and K3 at ``BODY_K3``, in bf16): per grad,
    fp32 max|err| <= ``FN_FP32_LIMIT`` * max|g_fp32|; bf16 max|err| <=
    ``FN_BF16_LIMIT`` * max|g_fp32| + max|g_plain_bf16 - g_fp32|. Every backward
    runs twice and must give the same bits, and the forward gives the same bits
    with and without autograd. Each kernel's largest |grad - g_fp32| goes into
    ``held.backward_worst``. Every bf16 K1 case with the norm also holds the
    backward's pre-pass (``tile_qk``) against its plain version (``compare``, with
    ``PREPASS_LIMIT`` * |ref| of slack); every K2 case holds the backward kernel's
    grads against ``adaln_modulate_backward_blocked_plain`` under the kernel's
    plan (``hold_k2_blocked``)."""
    from magicdrive_v2_tpu_torch.ops import (adaln_modulate, adaln_modulate_plain,
                                             flash_attention, flash_attention_plain,
                                             fused_qkv_attention, fused_qkv_attention_plain)
    from magicdrive_v2_tpu_torch.ops.flash_fused import (plan_backward_bf16, tile_qk,
                                                         tile_qk_plain)
    from magicdrive_v2_tpu_torch.ops.fused_adaln import (
        adaln_modulate_backward_blocked_plain, plan_adaln_backward)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []

    def hold_prepass(qkv, ws):
        G, N, _, H, D = qkv.shape
        plan = plan_backward_bf16(G, N, N, H, D, norm=True)
        x = qkv.detach()
        out, ref = tile_qk(x, *ws, plan), tile_qk_plain(x, *[w.detach() for w in ws], plan)
        torch.cuda.synchronize()
        # zero in the plain tiles: the padding (and an all-zero input), zero in both
        real = ref != 0
        require(not bool((out[~real] != 0).any()), "backward pre-pass: padding not zero")
        out, ref = out[real], ref[real]
        err, ratio, rms_ratio, _ = compare(torch, out, ref, PREPASS_LIMIT * ref.float().abs())
        cases.append(dict(kernel="fused_qkv_attention_backward_prepass", qkv=list(qkv.shape),
                          max_abs_err=err, err_over_limit=ratio,
                          rms_err_over_limit=rms_ratio))
        require(ratio <= 1.0 and rms_ratio <= 1.0, cases[-1])

    def hold_k2_blocked(got, g, inputs):
        """K2's grads (dx, dshift, dscale) against the plain version of the
        kernel's blocked sums on the same inputs, in their dtype: fp32 max|err| <=
        ``FN_FP32_LIMIT`` * max|ref|; bf16 ``compare`` with that as slack."""
        x, sh, sc = (a.detach() for a in inputs)
        B, N, C = x.shape
        plan = plan_adaln_backward(B, N, C, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        ref = adaln_modulate_backward_blocked_plain(x, sh, sc, g, plan)
        ratios, rms_ratios = [], []
        for a, r in zip(got, ref):
            slack = FN_FP32_LIMIT * float(r.float().abs().max())
            if a.dtype == torch.float32:
                ratios.append(float((a - r).abs().max()) / slack)
            else:
                _, ratio, rms_ratio, _ = compare(torch, a, r, slack)
                ratios.append(ratio)
                rms_ratios.append(rms_ratio)
        cases.append(dict(kernel="adaln_modulate_backward_vs_blocked_plain", x=[B, N, C],
                          dtype=str(x.dtype), plan=list(plan), err_over_limit=max(ratios),
                          rms_err_over_limit=max(rms_ratios, default=0.0)))
        require(max(ratios) <= 1.0 and max(rms_ratios, default=0.0) <= 1.0, cases[-1])

    def randn(*shape, dtype, scale=1.0, shift=0.0):
        x = torch.randn(*shape, generator=gen, device="cuda") * scale + shift
        return x.to(dtype).requires_grad_()

    def judge(kernel, fn, plain, inputs, what, zero=()):
        """``zero``: the positions in ``inputs`` whose grad the arithmetic makes
        exactly zero (q's with one key: a softmax over one key is constant); those
        must be zero on both sides. Returns the kernel's grads and the output's
        grad they came from."""
        out = fn(*inputs)
        require(type(out.grad_fn).__name__ == "KernelFunctionBackward",
                f"{kernel}: output not from KernelFunction: {out.grad_fn}")
        with torch.no_grad():  # saving the statistics leaves the forward's bits alone
            require(torch.equal(out, fn(*inputs)), f"{kernel}: forward moved under autograd")
        g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
        got = torch.autograd.grad(out, inputs, g, retain_graph=True)
        bit_equal = all(torch.equal(a, b) for a, b in
                        zip(got, torch.autograd.grad(out, inputs, g)))
        del out
        bf16 = inputs[0].dtype == torch.bfloat16
        ins32 = [x.detach().float().requires_grad_() for x in inputs]
        ref = torch.autograd.grad(plain(*ins32), ins32, g.float())
        rounding = torch.autograd.grad(plain(*inputs), inputs, g) if bf16 else None
        ratios, worst = [], 0.0
        for i, (a, r) in enumerate(zip(got, ref)):
            require(a is not None and r is not None, f"{kernel}: a grad is missing")
            a = a.float()
            require(bool(a.isfinite().all()), f"{kernel}: grad not finite")
            if i in zero:
                require(not bool((a != 0).any()) and not bool((r != 0).any()),
                        f"{kernel}: input {i}'s grad is not zero")
                continue
            scale = float(r.abs().max())
            require(scale > 0 and bool((a != 0).any()), f"{kernel}: zero grad")
            err = float((a - r).abs().max())
            limit = (FN_BF16_LIMIT * scale + float((rounding[i].float() - r).abs().max())
                     if bf16 else FN_FP32_LIMIT * scale)
            ratios.append(err / limit)
            worst = max(worst, err)
        held.backward_worst[kernel] = max(held.backward_worst[kernel], worst)
        cases.append(dict(kernel=kernel, dtype=str(inputs[0].dtype), **what,
                          err_over_limit=max(ratios), max_abs_err=worst,
                          backward_bit_equal=bit_equal))
        require(max(ratios) <= 1.0 and bit_equal, cases[-1])
        return got, g

    k1_cases = [(shape, dtype, norm, perm) for (shape, dtype, norm, _), perm
                in sorted(seen["fused_qkv_attention"].items(), key=str)]
    if with_extra_cases:
        k1_cases += [(shape, torch.bfloat16, True, perm)
                     for shape, perm in sorted(SP_TRAIN_K1 | BODY_K1, key=str)]
    for shape, dtype, norm, perm in k1_cases:
        qkv = randn(*shape, dtype=dtype)
        if norm:
            ws = [randn(shape[-1], dtype=torch.float32, scale=0.1, shift=1.0) for _ in range(2)]
            if dtype == torch.bfloat16:
                hold_prepass(qkv, ws)
            judge("fused_qkv_attention", lambda x, a, b: fused_qkv_attention(x, a, b, perm),
                  lambda x, a, b: fused_qkv_attention_plain(x, a, b, perm), [qkv] + ws,
                  dict(qkv=list(shape), J=perm_sources(perm), norm=True))
        else:
            judge("fused_qkv_attention", lambda x: fused_qkv_attention(x, None, None, perm),
                  lambda x: fused_qkv_attention_plain(x, None, None, perm), [qkv],
                  dict(qkv=list(shape), J=perm_sources(perm), norm=False))
    for shape, dtype in sorted(seen["adaln_modulate"], key=str):
        x = randn(*shape, dtype=dtype, scale=3.0, shift=0.5)
        sh, sc = randn(shape[0], shape[2], dtype=dtype), randn(shape[0], shape[2], dtype=dtype)
        hold_k2_blocked(*judge("adaln_modulate", adaln_modulate, adaln_modulate_plain,
                               [x, sh, sc], dict(x=list(shape))), [x, sh, sc])
    k3_cases = sorted(seen["flash_attention"], key=str)
    if with_extra_cases:
        k3_cases += [(qshape, M, torch.bfloat16) for qshape, M in sorted(BODY_K3)]
    for qshape, M, dtype in k3_cases:
        B, N, H, D = qshape
        q = randn(*qshape, dtype=dtype)
        kv = randn(B, M, 2, H, D, dtype=dtype)  # k and v: strided views of one tensor
        judge("flash_attention", lambda a, b: flash_attention(a, b[:, :, 0], b[:, :, 1]),
              lambda a, b: flash_attention_plain(a, b[:, :, 0], b[:, :, 1]), [q, kv],
              dict(q=list(qshape), M=M), zero=(0,) if M == 1 else ())
    torch.cuda.empty_cache()
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


def run_grads(torch, seed, held):
    """Grads of one training loss through the kernels against those through their
    plain versions, XL/2 at full width, depth 2/1, the stage-2 bucket, then each
    Function at the step's shapes (``check_functions``); returns the shapes the
    step handed to each wrapper."""
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
        with (routed("plain") if plain else recorded_shapes(seen)):
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
    cases = check_functions(torch, seen, held, with_extra_cases=True)
    emit("grads", model="MagicDriveSTDiT3-XL/2", depth=model_cfg.depth,
         control_depth=model_cfg.control_depth, batch=b, frames=nf, height=h,
         width=w, x_shape=list(batch["x"].shape), fp32_limit=f"per tensor max|err| <= "
         f"{GRAD_FP32_LIMIT} * max|g_plain|", bf16_limit=f"per tensor rms(err) <= "
         f"2**{math.log2(GRAD_BF16_RMS_LIMIT):g} * rms(g_plain) + rms(g_plain - g_plain_fp32)",
         by_dtype=result,
         function_limit=f"per grad, against autograd through the plain version in fp32: "
         f"max|err| <= {FN_FP32_LIMIT} * max|g_fp32| (fp32), "
         f"2**{math.log2(FN_BF16_LIMIT):g} * max|g_fp32| + max|g_plain_bf16 - g_fp32| "
         f"(bf16); two backwards bit-equal", function_cases=cases)
    return seen


# K1 at sp_train's shape after the all-to-all, one source: a row of time_backwards
SP_TRAIN_K1_ROW = (2, 5300, 3, 8, 72)


def time_backwards(torch, seen, per_step, rows_wanted=("K1", "K2", "K3")):
    """ms of one backward of each Function (its backward kernels) at the training
    step's bf16 shapes and K1 at ``SP_TRAIN_K1_ROW`` (of the kernels in
    ``rows_wanted``), beside the plain recompute
    (the plain version's forward and backward, the backward of the wrappers before
    there were backward kernels), its bound, and the nearest PyTorch call at the
    same shape as the yardstick: its forward+backward (``library_ms``) and its
    backward alone (``library_backward_ms``, timed as the kernel's). Each backward
    also on the card alone, the host ahead of it (``device_ms``; the host's ms a
    call, ``host_ms``): back to back, a backward of short kernels may wait on the
    host's launches. K3 twice: k and v as their own leaves (the kernels alone), and
    as the model hands them, strided views of one (B, M, 2, H, D) projection whose
    grad autograd assembles from the two (``K3 packed kv``: its select and copy
    kernels too). The rows run one after the other with the allocator's cache
    emptied between them, the largest (K1 at ``SP_TRAIN_K1_ROW``, whose plain
    recompute holds 1.8 GB of logits) last. K2's row adds its bound share
    (``bound_ms / device_ms``)."""
    import torch.nn.functional as F
    from magicdrive_v2_tpu_torch.ops import (adaln_modulate, adaln_modulate_plain,
                                             flash_attention, flash_attention_plain,
                                             fused_qkv_attention, fused_qkv_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf16).requires_grad_()

    def backward_ms(out, inputs):
        """ms back to back by CUDA events, and the card's time alone and the host's
        a call (``device_time_ms``)."""
        g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)

        def call():
            return torch.autograd.grad(out, inputs, g, retain_graph=True)

        device_ms, host_ms = device_time_ms(torch, call, 10)
        return dict(ms=time_ms(torch, call, 10), device_ms=device_ms, host_ms=host_ms)

    def library_backward(out, inputs):
        timed = backward_ms(out, inputs)
        return dict(library_backward_ms=timed["ms"],
                    library_backward_device_ms=timed["device_ms"])

    def fwd_bwd_ms(fn, inputs, iters=3):
        out = fn()
        g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
        return time_ms(torch, lambda: torch.autograd.grad(fn(), inputs, g), iters)

    def k1_row(shape, perm):
        G, N, _, H, D = shape
        J = perm_sources(perm)
        qkv = randn(*shape)
        qw = (torch.randn(D, generator=gen, device="cuda") * 0.1 + 1).requires_grad_()
        row = backward_ms(fused_qkv_attention(qkv, qw, qw, perm), [qkv, qw])
        plain = fwd_bwd_ms(lambda: fused_qkv_attention_plain(qkv, qw, qw, perm), [qkv, qw], 2)
        # the yardstick: one SDPA a source on its own k/v leaves, outputs summed
        q = randn(G, H, N, D)
        kvs = [(randn(G, H, N, D), randn(G, H, N, D)) for _ in range(J)]
        leaves = [q] + [t for kv in kvs for t in kv]

        def sdpa():
            return sum(F.scaled_dot_product_attention(q, kk, vv) for kk, vv in kvs)

        lib = fwd_bwd_ms(sdpa, leaves)
        row.update(library_backward(sdpa(), leaves))
        flops = 2.5 * 4.0 * G * H * N * N * D * J
        nbytes = 2.0 * (2 * qkv.numel() + G * N * H * D)
        bound_ms, by = bound(flops, nbytes, PEAK_BF16)
        return dict(
            qkv=list(shape), J=J, plain_ms=plain, bound_ms=bound_ms, bound_by=by,
            library_ms=lib,
            library="scaled_dot_product_attention" + (" x2 summed" if J > 1 else ""), **row)

    def next_row():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def k2_row(x_shape):
        x = randn(*x_shape)
        sh, sc = randn(x_shape[0], x_shape[2]), randn(x_shape[0], x_shape[2])
        C = x_shape[2]

        def modulated_layer_norm():
            return F.layer_norm(x, (C,), eps=1e-6) * (1 + sc[:, None]) + sh[:, None]

        row = dict(
            x=list(x_shape), **backward_ms(adaln_modulate(x, sh, sc), [x, sh, sc]),
            plain_ms=fwd_bwd_ms(lambda: adaln_modulate_plain(x, sh, sc), [x, sh, sc]),
            library_ms=fwd_bwd_ms(modulated_layer_norm, [x, sh, sc]),
            **library_backward(modulated_layer_norm(), [x, sh, sc]),
            library="layer_norm + modulate")
        row["bound_ms"], row["bound_by"] = bound(
            10.0 * x.numel(), 2.0 * (3 * x.numel() + 4 * sh.numel()), PEAK_FP32)
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        return row

    rows = {}
    if "K1" in rows_wanted:
        k1 = {J: (shape, perm) for (shape, dtype, norm, J), perm in
              seen["fused_qkv_attention"].items() if dtype == bf16 and shape[-1] == 72}
        for J, (shape, perm) in sorted(k1.items()):
            rows["K1 spatial" if J == 1 else "K1 cross-view"] = k1_row(shape, perm)
            next_row()
    if "K2" in rows_wanted:
        rows["K2"] = k2_row(max(sh for sh, dtype in seen["adaln_modulate"] if dtype == bf16))
        next_row()
    if "K3" in rows_wanted:
        qshape, M = max((q, m) for q, m, dtype in seen["flash_attention"]
                        if dtype == bf16 and q[-1] == 72)
        B, N, H, D = qshape
        qt, kt, vt = randn(B, H, N, D), randn(B, H, M, D), randn(B, H, M, D)
        lib = dict(library_ms=fwd_bwd_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                         [qt, kt, vt]),
                   **library_backward(F.scaled_dot_product_attention(qt, kt, vt),
                                      [qt, kt, vt]))
        # k and v: strided views of one projection, as the model hands them
        q, kv = randn(*qshape), randn(B, M, 2, H, D)
        bound_ms, by = bound(2.5 * 4.0 * B * H * N * M * D,
                             2.0 * (2 * q.numel() + 2 * kv.numel() + q.numel()), PEAK_BF16)
        k, v = (kv[:, :, i].detach().requires_grad_() for i in range(2))
        for name, inputs in (("K3", [q, k, v]), ("K3 packed kv", [q, kv])):
            qkv_ = (q, k, v) if name == "K3" else (q, kv[:, :, 0], kv[:, :, 1])
            rows[name] = dict(
                q=list(qshape), M=M, **backward_ms(flash_attention(*qkv_), inputs),
                plain_ms=fwd_bwd_ms(lambda: flash_attention_plain(*qkv_), inputs),
                bound_ms=bound_ms, bound_by=by, **lib, library="scaled_dot_product_attention")
            next_row()
    if "K1" in rows_wanted:
        rows["K1 sp_train"] = k1_row(SP_TRAIN_K1_ROW, None)
        next_row()
    for name, row in rows.items():  # sp_train's row: not a call of the stage-2 step
        calls = per_step.get(name)
        row["backward_calls_per_step"] = calls
        if calls is not None:
            row["seconds_per_step"] = row["ms"] * calls / 1e3
            row["plain_seconds_per_step"] = row["plain_ms"] * calls / 1e3
    torch.cuda.empty_cache()
    return rows


def run_train(torch, seed, seen, encode_launches, steps=2, with_profile=False):
    """The trainer at full width and depth from the stage-2 config: ``steps``
    steps, the first untimed (with ``with_profile``, two more, the second under
    torch.profiler); then the Functions' backward times. Returns the launches and
    the backwards of a step, the backward rows and s/step."""
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
    # the backward kernels run once a call; encode_conditions runs once, outside the
    # groups
    per_forward = expected_launches(model_cfg, x_mask=True)
    want = {k: 2 * per_forward[k] + encode_launches[k] for k in per_forward}
    want_backward = {k: per_forward[k] + encode_launches[k] for k in per_forward}
    name = "base_blocks_s.27.attn.qkv.weight"
    param, ema = dict(model.named_parameters())[name], dict(state.ema.named_parameters())[name]
    seconds, losses, grad_norms, t_means, launches = [], [], [], [], None
    backward_launches = None
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
        launches, backward_launches = got, read_backward_launches()
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
                         "K3": per_forward["flash_attention"],
                         "K3 packed kv": per_forward["flash_attention"]}
    backward_rows = time_backwards(torch, seen, per_step_backward)
    emit("train", config=TRAIN_CONFIG, model="MagicDriveSTDiT3-XL/2", params=n_params,
         dtype="bfloat16 compute, float32 masters", batch=batch_size, frames=TRAIN_FRAMES,
         height=TRAIN_HEIGHT, width=TRAIN_WIDTH, tokens_per_step=tokens,
         grad_checkpoint=True, setup_seconds=setup_s, state_bytes=state_bytes,
         seconds_per_step=seconds, seconds_per_step_timed_mean=s_step,
         samples_per_second=batch_size / s_step, tokens_per_second=tokens / s_step,
         peak_memory_bytes=peak, losses=losses, grad_norms=grad_norms, t_means=t_means,
         launches_per_step=launches, backward_calls_per_step=want_backward,
         backward_launches_per_step=backward_launches, ema_identity=True,
         backward=backward_rows)
    return launches, backward_launches, backward_rows, s_step


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


# ---------------------------------------------------------------------------
# phases 7a and 7b: sequence-parallel training and the stage-3 config
# ---------------------------------------------------------------------------

STAGE3_CONFIG = "configs/magicdrive/train/stage3_multires_sp4.py"
SP_TRAIN_RANKS = 2          # processes of phase sp_train (mesh (1, 2))
SP_TRAIN_BUCKET = (9, H848, W848)  # 848-1600-12-9, one view group: S = 53 x 100
# cut from 2 to keep the script in time; dp_train's (2, 2) mesh takes 2 sp steps
SP_TRAIN_STEPS = 1
SP_TRAIN_DEADLINE_S = 600
# params and EMA after the steps, sharded against one process: an element may move
# apart by at most two opposite AdamW steps a step; beyond an eighth of a step only
# where a grad's sign flipped between the two runs' roundings, at most this share
SP_TRAIN_FLIP_SHARE = 0.05
STAGE3_APP_BUCKET = (33, 224, 400)  # 224-400-12-33 at its batch of 4
STAGE3_APP_STEPS = 2
STAGE3_APP_DEPTH = (7, 4)  # depth and control depth (cut from 28 / 13; PERF.md has both)


def sp_train_config(torch):
    """The stage-3 config as the port loads it, at the 848-1600-12-9 bucket, b=1."""
    from magicdrive_v2_tpu_torch.config.config import Config
    cfg = Config.fromfile(STAGE3_CONFIG)
    require((cfg.sp_size, list(cfg.simulate_sp_size)) == (4, [4, 8]), cfg.sp_size)
    require("848-1600-12-9" in cfg.bucket_config, cfg.bucket_config)
    cfg.synthetic_buckets = [SP_TRAIN_BUCKET]
    cfg.batch_size = 1
    return cfg


def small_train_state(torch, cfg, seed, dtype, bucket, mesh=None, **overrides):
    """XL/2 at full width, depth 2 / control depth 1, from ``cfg`` (remat full, AdamW
    at its lr without a warm-up, so that two steps move the parameters by that lr;
    EMA 0.99) in ``dtype`` over fp32 masters on the current card, with seeded
    weights, split over the dp of ``mesh`` (``parallel.fsdp``) when it has dp > 1:
    (model config, state, the step of ``bucket`` (frames, height, width))."""
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
    from magicdrive_v2_tpu_torch.parallel.fsdp import shard_for_training
    from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
    from magicdrive_v2_tpu_torch.training.trainer import build_training_multibucket
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    model_cfg = train_model_config(torch, cfg, dtype, depth=2, control_depth=1,
                                   remat_policy="full", **overrides)
    with torch.device("cuda"):
        model = MagicDriveSTDiT3(model_cfg)
    init_weights(model, seed=seed)
    run_cfg = dict(cfg, warmup_steps=0,
                   dtype={torch.bfloat16: "bf16", torch.float32: "fp32"}[dtype])
    state, get_step = build_training_multibucket(
        model, build_scheduler(cfg.scheduler), run_cfg, seed=seed + 1,
        sharding=shard_for_training(model, mesh))
    nf, h, w = bucket
    return model_cfg, state, get_step(h, w, nf)


def train_steps(torch, state, step_fn, batches, bucket, steps, mesh=None, seen=None,
                after_step=None, capture=contextlib.nullcontext):
    """``steps`` steps of ``batches`` (the app's synthetic batches with frame masks
    and condition dropout, each of ``bucket``) under ``mesh``; each step's loss,
    grad norm, seconds, launches and backwards; the grads of the first step
    before the clip, on the host, whole (gathered over dp, within ``capture``)."""
    from magicdrive_v2_tpu_torch.parallel.sharding import use_mesh
    from magicdrive_v2_tpu_torch.utils.misc import to_device
    named = dict(state.model.named_parameters())
    grads0 = {}
    clip_step = state.optimizer.step

    def whole(name, g):
        return g if state.sharding is None else state.sharding.full(name, g)

    def step_keeping_grads():
        if not grads0:
            with capture():
                grads0.update({n: None if p.grad is None else whole(n, p.grad).cpu().clone()
                               for n, p in named.items()})
        return clip_step()

    state.optimizer.step = step_keeping_grads
    rows = []
    nf, h, w = bucket
    for i in range(steps):
        batch, got_bucket = next(batches)
        require(got_bucket == (nf, float(h), float(w)), got_bucket)
        dev = to_device(batch, "cuda")
        torch.cuda.synchronize()
        reset_counters()
        reset_backward_calls()
        t0 = time.time()
        with use_mesh(mesh), (recorded_shapes(seen) if seen is not None
                              else contextlib.nullcontext()):
            state, metrics = step_fn(state, dev)
        torch.cuda.synchronize()
        rows.append(dict(seconds=time.time() - t0, loss=float(metrics["loss"]),
                         grad_norm=float(metrics["grad_norm"]), launches=read_counters(),
                         backwards=read_backward_calls()))
        if after_step is not None:
            rows[-1].update(after_step(state))
    state.optimizer.step = clip_step
    return rows, grads0


def flat_state(torch, state):
    """Every parameter and EMA tensor, flattened into one host tensor, in order."""
    parts = [p.detach().reshape(-1) for p in state.model.parameters()]
    parts += [p.detach().reshape(-1) for p in state.ema.parameters()]
    return torch.cat(parts).cpu()


def sp_train_worker(torch, out_dir, seed):
    """One rank of phase sp_train (``chip_smoke.py --sp-train-worker DIR``): joins
    the group the parent describes (backend in MDV2_SP_BACKEND), builds the mesh by
    the train apps' rule (``training_mesh``: sp = min(sp_size 4, 2 ranks)), runs
    the steps sharded with the grad reduction timed, and after the last step sends
    its parameters and EMA to rank 0, which compares them bit for bit. Rank 0 writes the
    first step's grads and the final parameters and EMA; every rank its steps and
    the shapes it handed each wrapper."""
    import torch.distributed as dist
    from magicdrive_v2_tpu_torch.parallel.distributed import (maybe_initialize, shutdown,
                                                              training_mesh)
    from magicdrive_v2_tpu_torch.training import trainer
    backend = os.environ["MDV2_SP_BACKEND"]
    timeline = {}
    since_start(timeline, "imported")
    maybe_initialize("cuda", backend=backend, timeout_s=SP_TRAIN_DEADLINE_S)
    rank = dist.get_rank()
    since_start(timeline, "joined")
    reduce_sp_grads = trainer.reduce_sp_grads
    reduces = []

    def timed_reduce(params, group):
        torch.cuda.synchronize()
        t0 = time.time()
        calls = reduce_sp_grads(params, group)
        torch.cuda.synchronize()
        reduces.append(dict(seconds=time.time() - t0, all_reduces=calls,
                            bytes=sum(p.grad.numel() * p.grad.element_size()
                                      for p in params if p.grad is not None)))
        return calls

    trainer.reduce_sp_grads = timed_reduce
    try:
        cfg = sp_train_config(torch)
        mesh = training_mesh(cfg.sp_size)
        require(mesh is not None and (mesh.dp, mesh.sp) == (1, SP_TRAIN_RANKS), mesh)
        model_cfg, state, step_fn = small_train_state(torch, cfg, seed, torch.bfloat16,
                                                      SP_TRAIN_BUCKET,
                                                      enable_sequence_parallelism=True)
        since_start(timeline, "state_built")
        await_go(SP_TRAIN_DEADLINE_S)
        since_start(timeline, "go")

        def ranks_equal(state):
            if state.step < SP_TRAIN_STEPS:
                return {}
            flat = flat_state(torch, state)
            other = flat.clone() if rank == 0 else flat
            dist.broadcast(other, src=1, group=mesh.sp_group)
            return {"equal_to_rank1": bool(torch.equal(flat, other)) if rank == 0 else None}

        seen = no_shapes()
        with no_tf32(torch):  # as the one-process reference runs
            rows, grads0 = train_steps(torch, state, step_fn,
                                       train_batches(cfg, model_cfg, seed), SP_TRAIN_BUCKET,
                                       SP_TRAIN_STEPS, mesh=mesh, seen=seen,
                                       after_step=ranks_equal)
        since_start(timeline, "steps_done")
        out = dict(rows=rows, reduces=reduces, seen=seen, backend=dist.get_backend(),
                   device=str(torch.cuda.current_device()), timeline=timeline)
        if rank == 0:
            out.update(grads0=grads0,
                       params={n: p.detach().cpu() for n, p in state.model.named_parameters()},
                       ema={n: p.detach().cpu() for n, p in state.ema.named_parameters()})
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        trainer.reduce_sp_grads = reduce_sp_grads
        shutdown()
    return 0


def run_sp_train(torch, seed, encode_launches, held):
    """Sequence-parallel training at the 848x1600 bucket of the stage-3 config: XL/2
    at full width, depth 2 / control depth 1, bf16 over fp32 masters, remat full,
    b=1, 6 views x 9 frames (S=5300, 2650 a rank). SP_TRAIN_STEPS steps on
    SP_TRAIN_RANKS processes (gloo on one card, NCCL with a card a rank) against as
    many in one process with force_pad_h_for_sp_size=2 (the same function; S needs no pad).
    Held: the loss and grad norm within 2**-6; the first step's grads before the
    clip by phase grads' bf16 rule (rms of the difference within 2**-6 rms plus the
    distance of the one-process bf16 grad from its fp32 one); the parameters and
    EMA after the steps within two opposite AdamW steps a step, beyond an eighth of a
    step in at most SP_TRAIN_FLIP_SHARE of the elements; the ranks bit-equal after
    the steps (the CPU tests hold them after every step); each rank's launches and
    backwards those of one unsharded remat step; every shape a rank handed a
    wrapper held against its plain version."""
    from magicdrive_v2_tpu_torch.parallel.distributed import RankGroup
    from magicdrive_v2_tpu_torch.utils.train_utils import multistep_warmup_schedule
    t_phase = time.time()
    cfg = sp_train_config(torch)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sp_train_")
    try:
        # the ranks start first and wait, their state built, until the one-process
        # reference below is done (the file ``go``)
        backend, local_ranks = collective_backend(torch, SP_TRAIN_RANKS)
        go = os.path.join(out_dir, "go")
        group = RankGroup(SP_TRAIN_RANKS, [os.path.abspath(__file__), "--sp-train-worker",
                                           out_dir, "--seed", str(seed)],
                          SP_TRAIN_DEADLINE_S, env={"MDV2_SP_BACKEND": backend,
                                                    "MDV2_GO_FILE": go},
                          local_ranks=local_ranks)
        try:
            ref_rows, grads_ref = {}, {}
            with no_tf32(torch):
                for dtype, steps in ((torch.float32, 1), (torch.bfloat16, SP_TRAIN_STEPS)):
                    torch.cuda.reset_peak_memory_stats()
                    model_cfg, state, step_fn = small_train_state(
                        torch, cfg, seed, dtype, SP_TRAIN_BUCKET, force_pad_h_for_sp_size=2)
                    ref_rows[dtype], grads_ref[dtype] = train_steps(
                        torch, state, step_fn, train_batches(cfg, model_cfg, seed),
                        SP_TRAIN_BUCKET, steps)
                    if dtype == torch.bfloat16:
                        params_ref = {n: p.detach().cpu()
                                      for n, p in state.model.named_parameters()}
                        ema_ref = {n: p.detach().cpu() for n, p in state.ema.named_parameters()}
                        ref_peak = torch.cuda.max_memory_allocated()
                    del state, step_fn
                    torch.cuda.empty_cache()
            ref_seconds = time.time() - t_phase
            t0 = time.time()
            open(go, "w").close()
            group.wait()
            ranks_seconds = time.time() - t0  # from the go to the ranks' exit
        finally:
            group.close()
        t0 = time.time()
        res = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
               for r in range(SP_TRAIN_RANKS)]
        load_seconds = time.time() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    bf16_model_cfg = train_model_config(torch, cfg, torch.bfloat16, depth=2, control_depth=1)
    per_forward = expected_launches(bf16_model_cfg, x_mask=True)
    want = {k: 2 * per_forward[k] + encode_launches[k] for k in per_forward}
    want_backward = {k: per_forward[k] + encode_launches[k] for k in per_forward}
    rows0, ref = res[0]["rows"], ref_rows[torch.bfloat16]
    for r in res:
        for row in r["rows"]:
            require(row["launches"] == want and row["backwards"] == want_backward,
                    (row["launches"], want, row["backwards"], want_backward))
    require(rows0[-1]["equal_to_rank1"] is True, "the ranks' parameters differ")
    metrics = []
    for got, one in zip(rows0, ref):
        for k in ("loss", "grad_norm"):
            err = abs(got[k] - one[k])
            require(math.isfinite(got[k]) and err <= 2.0 ** -6 * abs(one[k]), (k, got, one))
        metrics.append(dict(loss=got["loss"], loss_one_process=one["loss"],
                            grad_norm=got["grad_norm"], grad_norm_one_process=one["grad_norm"]))
    worst, with_grad, roundings = compare_grads(torch, res[0]["grads0"],
                                                grads_ref[torch.bfloat16],
                                                grads_ref[torch.float32])
    require(worst[0] <= 1.0 and with_grad > 0, worst)
    sched = multistep_warmup_schedule(cfg.lr)  # small_train_state's: no warm-up
    lrs = [sched(i) for i in range(SP_TRAIN_STEPS)]
    flip = 2 * sum(lrs) * (1 + cfg.weight_decay)
    agreement = {}
    for key, got, one, scale in (("params", res[0]["params"], params_ref, 1.0),
                                 ("ema", res[0]["ema"], ema_ref, 1 - cfg.ema_decay ** 2)):
        worst_abs, beyond, total = 0.0, 0, 0
        for name, p in one.items():
            err = (got[name] - p).abs()
            worst_abs = max(worst_abs, float(err.max()))
            beyond += int((err > scale * sum(lrs) / 8).sum())
            total += err.numel()
        agreement[key] = dict(max_abs_err=worst_abs, limit=scale * flip,
                              share_beyond_eighth_step=beyond / total)
        require(worst_abs <= scale * flip and beyond / total <= SP_TRAIN_FLIP_SHARE,
                (key, agreement[key]))
    seen = no_shapes()
    for r in res:
        for k, perm in r["seen"]["fused_qkv_attention"].items():
            seen["fused_qkv_attention"].setdefault(k, perm)
        seen["adaln_modulate"] |= r["seen"]["adaln_modulate"]
        seen["flash_attention"] |= r["seen"]["flash_attention"]
    heads = {k[0][3] for k in seen["fused_qkv_attention"]}
    require(heads == {16 // SP_TRAIN_RANKS}, heads)
    nf, h, w = SP_TRAIN_BUCKET
    tokens = 6 * ((nf - 1) // 4 + 1) * (h // 16) * (w // 16)
    emit("sp_train", config=STAGE3_CONFIG, bucket="848-1600-12-9", batch=1,
         depth=2, control_depth=1, dtype="bfloat16 compute, float32 masters",
         remat="full", ranks=SP_TRAIN_RANKS, backend=res[0]["backend"],
         card_of_each_rank=[r["device"] for r in res], tokens_per_step=tokens,
         tokens_per_rank=tokens // SP_TRAIN_RANKS,
         k1_heads_per_rank=sorted(heads), metrics=metrics,
         grads_worst_ratio_to_limit=worst[0], grads_worst_tensor=worst[1],
         tensors_with_grad=with_grad,
         bf16_rounding_rms_ratio_max=max(roundings) if roundings else None,
         after_steps=agreement, ranks_bit_equal_after_the_steps=rows0[-1]["equal_to_rank1"],
         seconds_per_step_rank0=[row["seconds"] for row in rows0],
         seconds_per_step_one_process=[row["seconds"] for row in ref],
         grad_all_reduce=res[0]["reduces"], launches_per_step_rank0=rows0[-1]["launches"],
         backwards_per_step=want_backward, one_process_peak_memory_bytes=ref_peak,
         reference_seconds=ref_seconds, ranks_seconds=ranks_seconds,
         rank0_timeline=res[0]["timeline"], results_load_seconds=load_seconds,
         kernel_cases=held.hold(seen, "sp_train"), seconds=time.time() - t_phase)
    torch.cuda.empty_cache()
    return {k: sum(row["launches"][k] for row in rows0) for k in per_forward}


def run_stage3_app(torch, encode_launches, depth=STAGE3_APP_DEPTH):
    """The train app on the stage-3 config (sp_size 4, simulate_sp_size [4, 8]) in
    one process: sp = min(4, 1) = 1, so the simulate pick alone pads H (14 -> 16
    for either pick). XL/2 at full width, ``depth`` (depth, control depth), the 224-400-12-33
    bucket at its batch of 4, synthetic, 2 steps, no checkpoint; each step's pick,
    s/step, peak memory, the metrics read back, the launches of 2 remat steps."""
    import random
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    t_phase = time.time()
    cfg = sp_train_config(torch)
    nf, h, w = STAGE3_APP_BUCKET
    b = cfg.bucket_config[f"{h}-{w}-12-{nf}"]
    require(b == 4, b)
    out_dir = os.path.join("outputs", "chip_smoke_stage3_app")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = [STAGE3_CONFIG, "--synthetic", "--max-steps", str(STAGE3_APP_STEPS),
            "--cfg-options", f"outputs={out_dir}", f"synthetic_buckets=[({nf},{h},{w})]",
            f"batch_size={b}", "ckpt_every=0", "log_every=1", "record_time=True",
            f"model.depth={depth[0]}", f"model.control_depth={depth[1]}"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    lines = train_magicdrive.main(argv)
    got = read_counters()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        read_back = [json.loads(line) for line in f]
    shutil.rmtree(out_dir, ignore_errors=True)
    picks = [random.Random((cfg.seed + 2) * 1_000_003 + s).choice(list(cfg.simulate_sp_size))
             for s in range(STAGE3_APP_STEPS)]
    require([line["step"] for line in read_back] == list(range(1, STAGE3_APP_STEPS + 1))
            and [line["simulate_sp"] for line in read_back] == picks, (read_back, picks))
    require(all(math.isfinite(line["loss"]) and math.isfinite(line["grad_norm"])
                for line in read_back), read_back)
    require([(x["loss"], x["grad_norm"]) for x in lines]
            == [(x["loss"], x["grad_norm"]) for x in read_back], (lines, read_back))
    model_cfg = train_model_config(torch, cfg, torch.bfloat16, depth=depth[0],
                                   control_depth=depth[1])
    require(model_cfg.hidden_size == 1152, model_cfg)
    per_forward = expected_launches(model_cfg, x_mask=True)
    want = {k: STAGE3_APP_STEPS * (2 * per_forward[k] + encode_launches[k])
            for k in per_forward}
    require(got == want, (got, want))
    T, H, W = (nf - 1) // 4 + 1, h // 16, w // 16
    emit("stage3_app", config=STAGE3_CONFIG, bucket=f"{h}-{w}-12-{nf}", batch=b,
         depth=list(depth), sp=1,
         simulate_sp_choices=list(cfg.simulate_sp_size), picks=picks,
         h_tokens=[H, 16], tokens_unpadded=b * 6 * T * H * W, tokens_padded=b * 6 * T * 16 * W,
         seconds_per_step=[x["step_s"] for x in read_back], metrics=read_back,
         peak_memory_bytes=peak, launches=got, seconds=time.time() - t_phase)
    return got


# ---------------------------------------------------------------------------
# phase 7e: the stage-1 image path (no temporal blocks, 1 frame)
# ---------------------------------------------------------------------------

NOTEMP_CONFIG = "configs/magicdrive/inference/1x224x400_stdit3_CogVAE_noTemp_xCE_wSST.py"
STAGE1_CONFIG = "configs/magicdrive/train/stage1_1x224x400.py"
STAGE1_BUCKET = (1, 224, 400)  # the stage-1 configs' (frames, height, width)
STAGE1_TRAIN_STEPS = 2


def stage1_model_checks(cfg):
    """XL/2 at full width and depth in the stage-1 layout: no temporal block."""
    require(not cfg.with_temp_block and cfg.control_skip_temporal and cfg.depth == 28
            and cfg.control_depth == 13 and cfg.hidden_size == 1152 and cfg.num_heads == 16,
            cfg)


def run_stage1_serving(torch, held):
    """The noTemp inference config at full width and depth in bf16, seeded random
    weights, ``t5-dummy``: ``MagicDrivePipeline.from_config`` and one request of the
    config's batch (4 samples, batched CFG 2.0: 48 views a forward, 350 tokens a
    view) over its 20 steps with the VAE decode; then the inference app on the
    config, 4 samples (one at a time, as the JAX app samples them), and its first
    sample again, bit-equal. Launches, PNGs read back, the shapes each wrapper was
    handed held against the plain versions. Returns (launches of the request, of the
    app's 4 samples, the launches of ``encode_conditions`` at 1 frame)."""
    import numpy as np
    from magicdrive_v2_tpu_torch.config.config import Config
    from magicdrive_v2_tpu_torch.config.presets import rflow
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
    from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
    from magicdrive_v2_tpu_torch.scripts import inference_magicdrive
    from magicdrive_v2_tpu_torch.utils.inference_utils import read_png
    t_phase = time.time()
    cfg = Config.fromfile(NOTEMP_CONFIG)
    nf, h, w = STAGE1_BUCKET
    b, steps = cfg.batch_size, cfg.scheduler["num_sampling_steps"]
    guidance = cfg.scheduler["cfg_scale"]
    require((b, steps, guidance, cfg.num_frames, tuple(cfg.image_size)) == (4, 20, 2.0, nf,
                                                                          (h, w)), cfg)
    before = torch.cuda.memory_allocated()
    t0 = time.time()
    pipe = MagicDrivePipeline.from_config(cfg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    mc = pipe.model_cfg
    stage1_model_checks(mc)
    require(mc.dtype == torch.bfloat16 and len(pipe.model.base_blocks_t) == 0
            and len(pipe.model.control_blocks_t) == 0, mc)
    per_forward = expected_launches(mc)
    batch = synthetic_batch(mc, nf, h, w, l_box=L_BOX, l_txt=pipe.text_encoder.model_max_length,
                            b=b)
    with torch.no_grad():
        dev = to_card(torch, batch)
        reset_counters()
        cache = pipe.model.encode_conditions(tuple(dev["x"].shape), dev["y"], dev["maps"],
                                             dev["bbox"], dev["cams"], dev["rel_pos"])
        encode = read_counters()
        reset_counters()
        out = pipe.model(**dev, cond_cache=cache)
        torch.cuda.synchronize()
        require(read_counters() == per_forward, (read_counters(), per_forward))
        require(out.shape == dev["x"].shape and bool(out.isfinite().all()), out.shape)
        del out, cache, dev
    cond = {k: batch[k] for k in ("y", "maps", "bbox", "cams", "rel_pos", "fps")}
    # one step without the decode notes the request's shapes, and one view's decode
    # warms cuDNN's calls at these shapes up
    seen = no_shapes()
    scheduler, pipe.scheduler = pipe.scheduler, build_scheduler(rflow(num_sampling_steps=1))
    with recorded_shapes(seen):
        pipe.sample(cond, num_frames=nf, height=h, width=w, guidance_scale=guidance,
                    torch_seed=1024, decode=False)
    pipe.scheduler = scheduler
    with torch.no_grad():
        pipe.vae.decode(torch.zeros((1, 16, 1, h // 8, w // 8), device="cuda",
                                    dtype=pipe.vae.dtype))
    video, seconds, decode_s, latents, got, peak = timed_sample(
        torch, pipe, cond, height=h, width=w, num_frames=nf, guidance_scale=guidance,
        torch_seed=1024)
    del pipe.decode
    want = {k: per_forward[k] * steps + encode[k] for k in per_forward}
    require(got == want, (got, want))
    require(tuple(latents.shape) == (b, 96, 1, h // 8, w // 8)
            and bool(latents.isfinite().all()), latents.shape)
    require(tuple(video.shape) == (b, 6, 3, nf, h, w) and bool(video.isfinite().all()),
            video.shape)
    require(float((video[0] - video[1]).abs().max()) > 1e-3, "two samples of a batch alike")
    sampling = seconds - decode_s
    request = dict(batch=b, views_per_forward=2 * b * 6, tokens_per_forward=2 * b * 6 * 350,
                   setup_seconds=setup_s, seconds_per_step=sampling / steps,
                   decode_seconds=decode_s, seconds_per_request_with_decode=seconds,
                   seconds_per_sample_with_decode=seconds / b, peak_memory_bytes=peak,
                   allocated_before_bytes=before,
                   launches=got, video_abs_mean=float(video.abs().mean()),
                   kernel_cases=len(held.hold(seen, "stage1_sample")))
    del pipe, video, latents
    gc.collect()
    torch.cuda.empty_cache()

    # the app: the config's 4 samples, then the first again
    out_dir = os.path.join("outputs", "chip_smoke_stage1_app")
    shutil.rmtree(out_dir, ignore_errors=True)
    seen_app = no_shapes()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.time()
    with recorded_shapes(seen_app):
        saved = inference_magicdrive.main([NOTEMP_CONFIG, "--synthetic", "--num-samples",
                                           str(b), "--cfg-options", f"outputs={out_dir}"])
    app_s = time.time() - t0
    app_peak = torch.cuda.max_memory_allocated()
    app_launches = read_counters()
    want = {k: b * (per_forward[k] * steps + encode[k]) for k in per_forward}
    require(app_launches == want, (app_launches, want))
    require(len(saved) == b, len(saved))
    for path, frames in saved:
        require(path.endswith(".png") and frames.shape == (1, 2 * h, 3 * w, 3), (path,
                                                                               frames.shape))
        require(bool((read_png(path) == frames[0]).all()), path)
        require(float(frames.std()) > 1.0, f"{path}: constant frame")
    require(not np.array_equal(saved[0][1], saved[1][1]), "two samples alike")
    again = inference_magicdrive.main([NOTEMP_CONFIG, "--synthetic", "--num-samples", "1",
                                       "--cfg-options", f"outputs={out_dir}_again"])
    require(np.array_equal(again[0][1], saved[0][1]), "two runs of one seed differ (frames)")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(f"{out_dir}_again", ignore_errors=True)
    emit("stage1_serving", config=NOTEMP_CONFIG, model="MagicDriveSTDiT3-XL/2 (no temporal)",
         dtype="bfloat16", views=6, frames=nf, height=h, width=w, steps=steps,
         cfg_scale=guidance, launches_per_forward=per_forward,
         launches_encode_conditions=encode, request=request,
         app=dict(samples=b, seconds=app_s, seconds_per_sample=app_s / b,
                  peak_memory_bytes=app_peak, launches=app_launches,
                  frame_shape=[2 * h, 3 * w, 3],
                  rerun_bit_equal=True, kernel_cases=len(held.hold(seen_app, "stage1_app"))),
         seconds=time.time() - t_phase)
    torch.cuda.empty_cache()
    return got, app_launches, encode


def run_stage1_train(torch, held, encode_launches, seed):
    """The train app on the stage-1 config: XL/2 at full width and depth without
    temporal blocks, ``--synthetic`` at the stage-1 bucket (1, 224, 400) and its batch
    of 32 (67,200 tokens a step), remat full, bf16 over fp32 masters, AdamW, EMA, 2
    steps, no checkpoint: s/step, samples/s, tokens/s, peak memory, the metrics read
    back, launches and backwards equal to the remat layout's, every shape each
    wrapper was handed held against the plain versions and its autograd Function
    against autograd through the plain version. Returns the launches, the shapes
    each wrapper was handed and K2's backward calls a step."""
    from magicdrive_v2_tpu_torch.config.config import Config
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    t_phase = time.time()
    cfg = Config.fromfile(STAGE1_CONFIG)
    nf, h, w = STAGE1_BUCKET
    b = cfg.batch_size
    require((b, cfg.num_frames, tuple(cfg.image_size), cfg.grad_checkpoint)
            == (32, nf, (h, w), True), cfg)
    model_cfg = train_model_config(torch, cfg, torch.bfloat16)
    stage1_model_checks(model_cfg)
    tokens = b * model_cfg.nc * (h // 16) * (w // 16)

    out_dir = os.path.join("outputs", "chip_smoke_stage1_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = [STAGE1_CONFIG, "--synthetic", "--max-steps", str(STAGE1_TRAIN_STEPS),
            "--cfg-options", f"outputs={out_dir}", f"synthetic_buckets=[({nf},{h},{w})]",
            f"batch_size={b}", "ckpt_every=0", "log_every=1", "record_time=True"]
    seen = no_shapes()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    reset_backward_calls()
    with recorded_shapes(seen):
        lines = train_magicdrive.main(argv)
    got, backwards = read_counters(), read_backward_calls()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        read_back = [json.loads(line) for line in f]
    shutil.rmtree(out_dir, ignore_errors=True)
    require([x["step"] for x in read_back] == list(range(1, STAGE1_TRAIN_STEPS + 1)),
            read_back)
    require(all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
                and x["grad_norm"] > 0 for x in read_back), read_back)
    require([(x["loss"], x["grad_norm"]) for x in lines]
            == [(x["loss"], x["grad_norm"]) for x in read_back], (lines, read_back))
    # remat: the forward and the recompute each launch every group's kernels; the
    # backward kernels run once for each call of the forward
    per_forward = expected_launches(model_cfg, x_mask=True)
    want = {k: STAGE1_TRAIN_STEPS * (2 * per_forward[k] + encode_launches[k])
            for k in per_forward}
    want_backward = {k: STAGE1_TRAIN_STEPS * (per_forward[k] + encode_launches[k])
                     for k in per_forward}
    require(got == want and backwards == want_backward, (got, want, backwards, want_backward))
    cases = held.hold(seen, "stage1_train")
    fn_cases = check_functions(torch, seen, held)
    G, N, _, H, _ = max(k[0] for k in seen["fused_qkv_attention"])
    require((G, N, H) == (b * 6, 350, 16), (G, N, H))
    timed = [x["step_s"] for x in read_back[1:]]
    s_step = sum(timed) / len(timed)
    emit("stage1_train", config=STAGE1_CONFIG, model="MagicDriveSTDiT3-XL/2 (no temporal)",
         dtype="bfloat16 compute, float32 masters",
         batch=b, bucket=list(STAGE1_BUCKET), tokens_per_step=tokens, remat="full",
         metrics=read_back, seconds_per_step=[x["step_s"] for x in read_back],
         seconds_per_step_timed_mean=s_step, samples_per_second=b / s_step,
         tokens_per_second=tokens / s_step, peak_memory_bytes=peak,
         launches=got, backward_calls=backwards,
         kernel_cases=len(cases), function_cases=fn_cases, seconds=time.time() - t_phase)
    return got, seen, want_backward["adaln_modulate"] // STAGE1_TRAIN_STEPS


def run_stage1(torch, held, seed):
    """Phase stage1: serving, then training, then K1 timed at the two paths' shapes
    (G = 48 and 192 groups of N = 350, J = 1 and 2) and K2's backward at the train
    step's bf16 shape (``time_backwards``' K2 row). Returns the launches of each
    path, the K1 timing rows and the K2 backward row."""
    sample_launches, app_launches, encode = run_stage1_serving(torch, held)
    train_launches, seen, k2_calls = run_stage1_train(torch, held, encode, seed)
    rows = {f"g{G}_n350" + ("_cross_view" if J == 2 else ""): k1_timing_row(
        torch, held, G, 350, 16, J, iters=10, plain_chunk=G)
        for G in (48, 192) for J in (1, 2)}
    emit("stage1_k1_timing", rows=rows)
    k2_row = time_backwards(torch, seen, {"K2": k2_calls}, rows_wanted=("K2",))["K2"]
    require(k2_row["x"] == [32 * 6, 350, 1152], k2_row)  # b=32 x 6 views, 350 tokens
    emit("stage1_backward_timing", k2=k2_row)
    torch.cuda.empty_cache()
    return dict(sample=sample_launches, app=app_launches, train=train_launches), rows, k2_row


# ---------------------------------------------------------------------------
# phases 7c and 7d: data-parallel training
# ---------------------------------------------------------------------------

DP_TRAIN_STEPS = 2
DP_TRAIN_DEADLINE_S = 600
# the meshes of phase dp_train: (dp, sp), the bucket (frames, height, width) and the
# rows of each dp row; the (2, 2) bucket's 27 token rows take the sp pad (28)
DP_TRAIN_MESHES = {
    "dp2": dict(dp=2, sp=1, bucket=(TRAIN_FRAMES, TRAIN_HEIGHT, TRAIN_WIDTH), rows=2),
    "dp2sp2": dict(dp=2, sp=2, bucket=(9, HEIGHT, WIDTH), rows=1),
}
DP_APP_RANKS = 2
DP_APP_ROWS = 2          # a rank's rows: the global batch is the stage-2 config's 4
# depth and control depth of dp_app's first run (cut from 28 / 13 to keep the script
# in time; its second run, with the checkpoint, is at 2 / 1)
DP_APP_DEPTH = (4, 2)
DP_APP_DEADLINE_S = 900


def collective_backend(torch, n):
    """NCCL with a card a rank where the host has ``n`` cards, else gloo with every
    rank on card 0 (NCCL refuses two ranks on one card): (backend, local ranks)."""
    if torch.cuda.device_count() >= n:
        return "nccl", None
    return "gloo", [0] * n


def dp_train_config(torch, case):
    """The stage-2 config at ``case``'s bucket, its rows a dp row and its sp_size."""
    cfg = train_config(torch)
    cfg.synthetic_buckets = [case["bucket"]]
    cfg.batch_size = case["rows"]
    cfg.sp_size = case["sp"]
    return cfg


def concat_rows(parts):
    """The global batch of the dp rows' batches ``parts`` (leading dims b or b*NC,
    sample-major), rows in dp order."""
    import numpy as np
    if isinstance(parts[0], dict):
        return {k: concat_rows([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


def global_batches(cfg, model_cfg, seed, dp):
    """The global batches of ``dp`` rows, step by step: each row's as that rank draws
    it (``train_batches(dp_row=d)``), concatenated in dp order."""
    rows = [train_batches(cfg, model_cfg, seed, dp_row=d) for d in range(dp)]
    while True:
        parts = [next(r) for r in rows]
        yield concat_rows([batch for batch, _ in parts]), parts[0][1]


def dp_train_worker(torch, out_dir, seed):
    """One rank of phase dp_train (``chip_smoke.py --dp-train-worker DIR``): joins the
    group the parent describes (backend in MDV2_SP_BACKEND, the mesh in
    MDV2_DP_CASE), builds the mesh by the train apps' rule, splits the state over dp
    and runs the steps on its dp row's rows with the gathers, reduce-scatters and
    all-reduces of FSDP timed, then gathers the parameters and EMA. Rank 0 writes
    the first step's grads and the final parameters and EMA, every rank its steps,
    its peak memory, the bytes of its blocks and the shapes it handed each
    wrapper."""
    import torch.distributed as dist
    from magicdrive_v2_tpu_torch.parallel import fsdp
    from magicdrive_v2_tpu_torch.parallel.distributed import (maybe_initialize, shutdown,
                                                              training_mesh)
    case = DP_TRAIN_MESHES[os.environ["MDV2_DP_CASE"]]
    timeline = {}
    since_start(timeline, "imported")
    maybe_initialize("cuda", backend=os.environ["MDV2_SP_BACKEND"],
                     timeout_s=DP_TRAIN_DEADLINE_S)
    rank = dist.get_rank()
    since_start(timeline, "joined")
    timed = {"gather": [], "reduce_scatter": [], "all_reduce": []}
    paused = []
    originals = dict(gather=fsdp._gather, reduce_scatter=fsdp._reduce_scatter,
                     all_reduce=fsdp.all_reduce_grads)

    def timing(kind, nbytes):
        fn = originals[kind]

        def run(*args):
            if paused:
                return fn(*args)
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args)
            torch.cuda.synchronize()
            timed[kind].append((time.time() - t0, nbytes(args, out)))
            return out
        return run

    def size(t):
        return t.numel() * t.element_size()

    @contextlib.contextmanager
    def untimed():
        paused.append(True)
        try:
            yield
        finally:
            paused.pop()

    fsdp._gather = timing("gather", lambda a, out: size(out))
    fsdp._reduce_scatter = timing("reduce_scatter", lambda a, out: size(a[0]))
    fsdp.all_reduce_grads = timing("all_reduce", lambda a, out: sum(size(g) for g in a[0]))
    try:
        cfg = dp_train_config(torch, case)
        mesh = training_mesh(cfg.sp_size)
        require(mesh is not None and (mesh.dp, mesh.sp) == (case["dp"], case["sp"]), mesh)
        torch.cuda.reset_peak_memory_stats()
        model_cfg, state, step_fn = small_train_state(
            torch, cfg, seed, torch.bfloat16, case["bucket"], mesh=mesh,
            enable_sequence_parallelism=mesh.sp > 1)
        sharding = state.sharding
        since_start(timeline, "state_built")
        await_go(DP_TRAIN_DEADLINE_S)
        since_start(timeline, "go")

        def per_step(state):
            out = {k: dict(calls=len(v), seconds=sum(s for s, _ in v),
                           bytes=sum(b for _, b in v)) for k, v in timed.items()}
            for v in timed.values():
                v.clear()
            return {"collectives": out}

        seen = no_shapes()
        with no_tf32(torch):
            rows, grads0 = train_steps(
                torch, state, step_fn, train_batches(cfg, model_cfg, seed, mesh.dp_rank),
                case["bucket"], DP_TRAIN_STEPS, mesh=mesh, seen=seen, after_step=per_step,
                capture=untimed)
        since_start(timeline, "steps_done")
        peak = torch.cuda.max_memory_allocated()
        moments = sum(size(v) for st in state.optimizer.adamw.state.values()
                      for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
        local = dict(params=sharding.local_bytes(state.model),
                     ema=sharding.local_bytes(state.ema), moments=moments)
        blocks = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()]
                           + [p.detach().reshape(-1) for p in state.ema.parameters()])
        peer = blocks.clone()
        if mesh.sp > 1:  # the sp ranks of a dp row hold the same blocks
            dist.broadcast(peer, src=mesh.dp_rank * mesh.sp, group=mesh.sp_group)
        with untimed():
            params = {n: sharding.full(n, p).cpu() for n, p in state.model.named_parameters()}
            ema = {n: sharding.full(n, p).cpu() for n, p in state.ema.named_parameters()}
        out = dict(rows=rows, seen=seen, backend=dist.get_backend(),
                   device=str(torch.cuda.current_device()), peak_memory_bytes=peak,
                   local_bytes=local, mesh=[mesh.dp, mesh.sp], dp_row=mesh.dp_rank,
                   blocks_equal_sp_peer=bool(torch.equal(blocks, peer)),
                   split_parameters=len(sharding.sharded))
        since_start(timeline, "gathered")
        out["timeline"] = timeline
        if rank == 0:
            out.update(grads0=grads0, params=params, ema=ema)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        fsdp._gather = originals["gather"]
        fsdp._reduce_scatter = originals["reduce_scatter"]
        fsdp.all_reduce_grads = originals["all_reduce"]
        shutdown()
    return 0


def run_dp_train(torch, seed, encode_launches, held):
    """Data-parallel training with the state split over dp (``parallel/fsdp.py``), on
    ranks of one card (gloo; NCCL with a card a rank): XL/2 at full width, depth 2 /
    control depth 1, from the stage-2 config (bf16 over fp32 masters, remat full),
    2 steps, first on a (2, 1) mesh at the stage-2 bucket (2 rows a rank: the global
    batch of 4), then on a (2, 2) mesh at 424x800x9 (1 row a dp row, 27 token rows
    padded to 28 for sp=2). Each against 2 steps in one process on the global batch
    (each row's batch as its rank draws it; the sp pad forced at sp=2): the loss
    and grad norm within 2**-6; the first step's grads before the clip by phase
    grads' bf16 rule (so no parameter lost its grad); the parameters and EMA after
    the steps within two opposite AdamW steps, beyond an eighth of a step in at
    most SP_TRAIN_FLIP_SHARE of the elements; the sp ranks of a dp row bit-equal.
    Each rank's bytes of split parameters, EMA and moments at most 1/dp of one
    process's plus the replicated parameters; launches and backwards per rank
    those of one remat step; every shape the ranks handed a wrapper held against
    its plain version. Returns rank 0's launches over the (2, 1) mesh's steps.

    Both meshes' ranks start first and build their state while this process runs
    both references; then each mesh's ranks take their steps in turn (the file
    ``go`` of each), so no timed step runs beside other work on the card."""
    from magicdrive_v2_tpu_torch.parallel.distributed import RankGroup
    launches = None
    groups, out_dirs, refs = {}, {}, {}
    try:
        for name, case in DP_TRAIN_MESHES.items():
            n = case["dp"] * case["sp"]
            backend, local_ranks = collective_backend(torch, n)
            out_dirs[name] = tempfile.mkdtemp(prefix="chip_smoke_dp_train_")
            groups[name] = RankGroup(
                n, [os.path.abspath(__file__), "--dp-train-worker", out_dirs[name],
                    "--seed", str(seed)], DP_TRAIN_DEADLINE_S, local_ranks=local_ranks,
                env={"MDV2_SP_BACKEND": backend, "MDV2_DP_CASE": name,
                     "MDV2_GO_FILE": os.path.join(out_dirs[name], "go")})
        for name, case in DP_TRAIN_MESHES.items():
            refs[name] = dp_train_reference(torch, case, seed)
        for name, case in DP_TRAIN_MESHES.items():
            t0 = time.time()
            open(os.path.join(out_dirs[name], "go"), "w").close()
            groups[name].wait()
            ranks_seconds = time.time() - t0  # from the go to the ranks' exit
            res = [torch.load(os.path.join(out_dirs[name], f"rank{r}.pt"), weights_only=False)
                   for r in range(case["dp"] * case["sp"])]
            load_seconds = time.time() - t0 - ranks_seconds
            shutil.rmtree(out_dirs[name], ignore_errors=True)
            rows0 = check_dp_train(torch, name, case, res, refs.pop(name), encode_launches,
                                   held, ranks_seconds, load_seconds)
            if launches is None:
                launches = {k: sum(row["launches"][k] for row in rows0)
                            for k in rows0[0]["launches"]}
    finally:
        for name in groups:
            groups[name].close()
            shutil.rmtree(out_dirs[name], ignore_errors=True)
    return launches


def dp_train_reference(torch, case, seed):
    """Phase dp_train's one-process reference for the mesh ``case``: 1 step in fp32
    and DP_TRAIN_STEPS in bf16 on the global batch; its rows, the first step's grads,
    the bf16 run's final parameters and EMA, which parameters train, peak memory
    and seconds."""
    t_phase = time.time()
    cfg = dp_train_config(torch, case)
    dp, sp = case["dp"], case["sp"]
    pad = {"force_pad_h_for_sp_size": sp} if sp > 1 else {}
    ref_rows, grads_ref = {}, {}
    with no_tf32(torch):
        for dtype, steps in ((torch.float32, 1), (torch.bfloat16, DP_TRAIN_STEPS)):
            torch.cuda.reset_peak_memory_stats()
            model_cfg, state, step_fn = small_train_state(torch, cfg, seed, dtype,
                                                          case["bucket"], **pad)
            ref_rows[dtype], grads_ref[dtype] = train_steps(
                torch, state, step_fn, global_batches(cfg, model_cfg, seed, dp),
                case["bucket"], steps)
            if dtype == torch.bfloat16:
                params_ref = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
                ema_ref = {n: p.detach().cpu() for n, p in state.ema.named_parameters()}
                trainable = {n: p.requires_grad for n, p in state.model.named_parameters()}
                ref_peak = torch.cuda.max_memory_allocated()
            del state, step_fn
            torch.cuda.empty_cache()
    return dict(rows=ref_rows, grads=grads_ref, params=params_ref, ema=ema_ref,
                trainable=trainable, peak=ref_peak, seconds=time.time() - t_phase)


def check_dp_train(torch, name, case, res, ref_run, encode_launches, held, ranks_seconds,
                   load_seconds):
    """Phase dp_train's checks of the ranks' results ``res`` of the mesh ``case``
    against its one-process reference ``ref_run``; emits the mesh's line and
    returns rank 0's rows."""
    from magicdrive_v2_tpu_torch.parallel.fsdp import param_spec
    from magicdrive_v2_tpu_torch.utils.train_utils import multistep_warmup_schedule
    t_phase = time.time()
    cfg = dp_train_config(torch, case)
    dp, sp = case["dp"], case["sp"]
    ref_rows, grads_ref = ref_run["rows"], ref_run["grads"]
    params_ref, ema_ref, trainable = ref_run["params"], ref_run["ema"], ref_run["trainable"]
    ref_peak, ref_seconds = ref_run["peak"], ref_run["seconds"]
    bf16_model_cfg = train_model_config(torch, cfg, torch.bfloat16, depth=2,
                                        control_depth=1)
    per_forward = expected_launches(bf16_model_cfg, x_mask=True)
    want = {k: 2 * per_forward[k] + encode_launches[k] for k in per_forward}
    want_backward = {k: per_forward[k] + encode_launches[k] for k in per_forward}
    for r in res:
        require(r["mesh"] == [dp, sp] and r["blocks_equal_sp_peer"], (r["mesh"], name))
        for row in r["rows"]:
            require(row["launches"] == want and row["backwards"] == want_backward,
                    (name, row["launches"], want, row["backwards"], want_backward))
    rows0, ref = res[0]["rows"], ref_rows[torch.bfloat16]
    metrics = []
    for got, one in zip(rows0, ref):
        for k in ("loss", "grad_norm"):
            err = abs(got[k] - one[k])
            require(math.isfinite(got[k]) and err <= 2.0 ** -6 * abs(one[k]),
                    (name, k, got, one))
        metrics.append(dict(loss=got["loss"], loss_one_process=one["loss"],
                            grad_norm=got["grad_norm"],
                            grad_norm_one_process=one["grad_norm"]))
    worst, with_grad, roundings = compare_grads(torch, res[0]["grads0"],
                                                grads_ref[torch.bfloat16],
                                                grads_ref[torch.float32])
    require(worst[0] <= 1.0 and with_grad > 0, (name, worst))
    lrs = [multistep_warmup_schedule(cfg.lr)(i) for i in range(DP_TRAIN_STEPS)]
    flip = 2 * sum(lrs) * (1 + cfg.weight_decay)
    agreement = {}
    for key, got, one, scale in (("params", res[0]["params"], params_ref, 1.0),
                                 ("ema", res[0]["ema"], ema_ref, 1 - cfg.ema_decay ** 2)):
        worst_abs, beyond, total = 0.0, 0, 0
        for pname, p in one.items():
            err = (got[pname] - p).abs()
            worst_abs = max(worst_abs, float(err.max()))
            beyond += int((err > scale * sum(lrs) / 8).sum())
            total += err.numel()
        agreement[key] = dict(max_abs_err=worst_abs, limit=scale * flip,
                              share_beyond_eighth_step=beyond / total)
        require(worst_abs <= scale * flip and beyond / total <= SP_TRAIN_FLIP_SHARE,
                (name, key, agreement[key]))
    # one process's state against each rank's blocks
    split = {k: param_spec(tuple(p.shape), dp) is not None for k, p in params_ref.items()}
    one_params = sum(p.numel() * 4 for p in params_ref.values())
    one_moments = 2 * sum(p.numel() * 4 for k, p in params_ref.items() if trainable[k])
    repl = sum(p.numel() * 4 for k, p in params_ref.items() if not split[k])
    shards = []
    for r in res:
        lb = r["local_bytes"]
        local_params = sum(lb["params"])
        require(lb["params"][1] == repl and lb["ema"] == lb["params"]
                and local_params <= (one_params - repl) / dp + repl
                and lb["moments"] <= (one_moments - 2 * repl) / dp + 2 * repl,
                (name, lb, one_params, one_moments, repl))
        shards.append(dict(dp_row=r["dp_row"], params_split=lb["params"][0],
                           params_replicated=lb["params"][1], ema=sum(lb["ema"]),
                           moments=lb["moments"], peak_memory_bytes=r["peak_memory_bytes"]))
    seen = no_shapes()
    for r in res:
        for k, perm in r["seen"]["fused_qkv_attention"].items():
            seen["fused_qkv_attention"].setdefault(k, perm)
        seen["adaln_modulate"] |= r["seen"]["adaln_modulate"]
        seen["flash_attention"] |= r["seen"]["flash_attention"]
    nf, h, w = case["bucket"]
    emit("dp_train", mesh=[dp, sp], config=TRAIN_CONFIG, bucket=f"{h}-{w}-12-{nf}",
         rows_per_dp_row=case["rows"], global_batch=dp * case["rows"], depth=2,
         control_depth=1, dtype="bfloat16 compute, float32 masters", remat="full",
         backend=res[0]["backend"], card_of_each_rank=[r["device"] for r in res],
         split_parameters=res[0]["split_parameters"], metrics=metrics,
         grads_worst_ratio_to_limit=worst[0], grads_worst_tensor=worst[1],
         tensors_with_grad=with_grad,
         bf16_rounding_rms_ratio_max=max(roundings) if roundings else None,
         after_steps=agreement,
         one_process_bytes=dict(params=one_params, moments=one_moments, ema=one_params,
                                replicated_params=repl),
         each_rank=shards, one_process_peak_memory_bytes=ref_peak,
         seconds_per_step_rank0=[row["seconds"] for row in rows0],
         seconds_per_step_one_process=[row["seconds"] for row in ref],
         collectives_per_step_rank0=[row["collectives"] for row in rows0],
         launches_per_step_rank0=rows0[-1]["launches"], backwards_per_step=want_backward,
         reference_seconds=ref_seconds, ranks_seconds=ranks_seconds,
         rank0_timeline=res[0]["timeline"], results_load_seconds=load_seconds,
         kernel_cases=held.hold(seen, f"dp_train_{name}"),
         seconds=ref_seconds + ranks_seconds + load_seconds + time.time() - t_phase)
    torch.cuda.empty_cache()
    return rows0


def dp_app_worker(torch, out_dir):
    """One rank of phase dp_app (``chip_smoke.py --dp-app-worker DIR``): joins the
    group (backend in MDV2_SP_BACKEND) and runs the train app's ``main`` on each
    argv of MDV2_DP_APP_ARGVS (JSON), one after the other; writes, for each run,
    its metrics lines, launches and peak memory, and, where the app writes a
    checkpoint, its own blocks of the model and EMA as the app held them then
    (with the split dims)."""
    import torch.distributed as dist
    from magicdrive_v2_tpu_torch.parallel.distributed import maybe_initialize, shutdown
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    from magicdrive_v2_tpu_torch.utils import ckpt
    maybe_initialize("cuda", backend=os.environ["MDV2_SP_BACKEND"],
                     timeout_s=DP_APP_DEADLINE_S)
    rank = dist.get_rank()
    save = ckpt.save_checkpoint
    blocks = {}

    def save_keeping_blocks(*args, model, ema=None, sharding=None, **kw):
        if kw.get("optimizer") is not None:  # a training checkpoint
            blocks.update(
                dims=dict(sharding.dims), dp_row=sharding.rank,
                model={n: p.detach().cpu() for n, p in model.named_parameters()},
                ema={n: p.detach().cpu() for n, p in ema.named_parameters()})
        return save(*args, model=model, ema=ema, sharding=sharding, **kw)

    ckpt.save_checkpoint = save_keeping_blocks
    try:
        runs = []
        for argv in json.loads(os.environ["MDV2_DP_APP_ARGVS"]):
            blocks.clear()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            t0 = time.time()
            lines = train_magicdrive.main(argv)
            runs.append(dict(lines=lines, seconds=time.time() - t0, launches=read_counters(),
                             peak_memory_bytes=torch.cuda.max_memory_allocated(),
                             blocks=dict(blocks)))
        torch.save(runs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        ckpt.save_checkpoint = save
        shutdown()
    return 0


def spawn_dp_app(torch, argvs):
    """The train app on DP_APP_RANKS ranks of this script's dp_app worker, once for
    each argv of ``argvs``: for each run, each rank's results; the backend."""
    from magicdrive_v2_tpu_torch.parallel.distributed import spawn_ranks
    backend, local_ranks = collective_backend(torch, DP_APP_RANKS)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_app_")
    try:
        spawn_ranks(DP_APP_RANKS, [os.path.abspath(__file__), "--dp-app-worker", out_dir],
                    DP_APP_DEADLINE_S, local_ranks=local_ranks,
                    env={"MDV2_SP_BACKEND": backend, "MDV2_DP_APP_ARGVS": json.dumps(argvs)})
        by_rank = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                   for r in range(DP_APP_RANKS)]
        return [list(run) for run in zip(*by_rank)], backend
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def run_dp_app(torch, encode_launches):
    """The train app on 2 ranks of the card at sp_size 1, so dp=2, on the stage-2
    config (2 rows a rank: its global batch of 4), synthetic: first XL/2 at full
    width, depth DP_APP_DEPTH, 2 steps (the second with the AdamW moments in place),
    no checkpoint: each rank's peak memory, s/step, launches; then at depth 2 /
    control depth 1, 2 steps
    with a checkpoint at step 2: rank 0 alone writes
    ``metrics.jsonl`` (one line a step) and ``global_step2``, and one process loads
    that checkpoint (model, EMA, AdamW moments) exactly into an unsplit state: the
    whole of the ranks' blocks. Returns the launches of a rank over the first run's
    steps."""
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
    from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
    from magicdrive_v2_tpu_torch.training.trainer import build_training_multibucket
    from magicdrive_v2_tpu_torch.utils.ckpt import load_checkpoint
    t_phase = time.time()
    cfg = train_config(torch)
    out_root = os.path.join("outputs", "chip_smoke_dp_app")
    shutil.rmtree(out_root, ignore_errors=True)
    base = ["--synthetic", "--cfg-options", "sp_size=1", f"batch_size={DP_APP_ROWS}",
            "log_every=1", "record_time=True",
            f"synthetic_buckets=[({TRAIN_FRAMES},{TRAIN_HEIGHT},{TRAIN_WIDTH})]"]
    runs = {}
    try:
        large = f"depth{DP_APP_DEPTH[0]}"
        full_dir, small_dir = os.path.join(out_root, "large"), os.path.join(out_root, "small")
        (full, small), backend = spawn_dp_app(torch, [
            [TRAIN_CONFIG, "--max-steps", "2"] + base + [
                f"outputs={full_dir}", "ckpt_every=0", f"model.depth={DP_APP_DEPTH[0]}",
                f"model.control_depth={DP_APP_DEPTH[1]}"],
            [TRAIN_CONFIG, "--max-steps", "2"] + base + [f"outputs={small_dir}", "ckpt_every=2",
                                                         "model.depth=2",
                                                         "model.control_depth=1"]])
        for key, res, d, steps in ((large, full, full_dir, 2),
                                   ("depth2", small, small_dir, 2)):
            with open(os.path.join(d, "metrics.jsonl")) as f:
                read_back = [json.loads(line) for line in f]
            require([x["step"] for x in read_back] == list(range(1, steps + 1)), read_back)
            for r in res:  # every rank logged the global batch's numbers; rank 0 wrote
                require([(x["loss"], x["grad_norm"]) for x in r["lines"]]
                        == [(x["loss"], x["grad_norm"]) for x in read_back], (key, r["lines"]))
            require(all(math.isfinite(x["loss"]) for x in read_back), read_back)
            runs[key] = dict(metrics=read_back, seconds=[r["seconds"] for r in res],
                             peak_memory_bytes=[r["peak_memory_bytes"] for r in res],
                             launches_rank0=res[0]["launches"])
        model_cfg = train_model_config(torch, cfg, torch.bfloat16, depth=DP_APP_DEPTH[0],
                                       control_depth=DP_APP_DEPTH[1])
        per_forward = expected_launches(model_cfg, x_mask=True)
        want = {k: 2 * (2 * per_forward[k] + encode_launches[k]) for k in per_forward}
        require(all(r["launches"] == want for r in full), ([r["launches"] for r in full], want))
        ckpt = os.path.join(small_dir, "global_step2")
        require(sorted(os.listdir(ckpt)) == ["ema.pt", "model.pt", "optimizer.pt",
                                             "rng_state.json", "running_states.json"],
                os.listdir(ckpt))
        # the ranks' blocks, joined along their split dims
        blocks = [r["blocks"] for r in small]
        dims = blocks[0]["dims"]
        require([b["dp_row"] for b in blocks] == list(range(DP_APP_RANKS)), "dp rows")
        whole = {key: {n: blocks[0][key][n] if dims[n] is None
                       else torch.cat([b[key][n] for b in blocks], dim=dims[n])
                       for n in dims} for key in ("model", "ema")}
        small_cfg = train_model_config(torch, cfg, torch.float32, depth=2, control_depth=1)
        with torch.device("cuda"):
            model = MagicDriveSTDiT3(small_cfg)
        state, _ = build_training_multibucket(model, build_scheduler(cfg.scheduler), cfg)
        running = load_checkpoint(ckpt, model=state.model, ema=state.ema,
                                  optimizer=state.optimizer)
        require(running["step"] == 2 and state.optimizer.count == 2, running)
        for key, module in (("model", state.model), ("ema", state.ema)):
            for n, p in module.named_parameters():
                require(torch.equal(p.detach().cpu(), whole[key][n]), (key, n))
        moments = [st for st in state.optimizer.adamw.state.values()]
        require(len(moments) == len(state.optimizer.params)
                and all(st["exp_avg"].shape == p.shape
                        for st, p in zip(moments, state.optimizer.params)), "moments")
        del state, model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    peaks = runs[large]["peak_memory_bytes"]
    emit("dp_app", config=TRAIN_CONFIG, ranks=DP_APP_RANKS, mesh=[DP_APP_RANKS, 1],
         backend=backend, rows_per_rank=DP_APP_ROWS, global_batch=DP_APP_RANKS * DP_APP_ROWS,
         depth=list(DP_APP_DEPTH),
         runs=runs, peak_memory_gb_each_rank=[p / 1e9 for p in peaks],
         peak_memory_gb_both_ranks=sum(peaks) / 1e9,
         checkpoint_loaded_in_one_process="global_step2 (depth 2): params and EMA equal the "
         "ranks' blocks joined, moments and step loaded", seconds=time.time() - t_phase)
    return runs[large]["launches_rank0"]


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
        # the card's weights on the CPU (a seeded fill draws from each device's own
        # generator)
        on_cpu = cogvideox_vae(torch, torch.float32, seed + 1, device="cpu")
        on_cpu.module.load_state_dict(on_card.module.state_dict())
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
    """The inference app on the 424x800 config, synthetic conditioning, APP_FRAMES
    frames, 2 steps; its frames are written under outputs/ in the checkout, read back, and
    removed."""
    from magicdrive_v2_tpu_torch.scripts import inference_magicdrive
    from magicdrive_v2_tpu_torch.utils.inference_utils import read_png
    out_dir = os.path.join("outputs", "chip_smoke_app")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    reset_counters()
    saved = inference_magicdrive.main(
        [APP_CONFIG, "--synthetic", "--num-frames", str(APP_FRAMES), "--num-samples", "1",
         "--cfg-options", "scheduler.num_sampling_steps=2", f"outputs={out_dir}"])
    got = read_counters()
    seconds = time.time() - t0
    want = {k: per_forward[k] * 2 + encode_launches[k] for k in per_forward}
    require(got == want, (got, want))
    require(len(saved) == 1, len(saved))
    path, frames = saved[0]
    names = sorted(os.listdir(path))
    require(names == [f"{i:04d}.png" for i in range(APP_FRAMES)], names)
    require(frames.shape == (APP_FRAMES, 2 * HEIGHT, 3 * WIDTH, 3), frames.shape)
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


class FirstClips:
    """The first ``n`` clips of ``dataset``: a loader over it holds one batch of
    ``n``, so it loads no batch ahead that nobody takes."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i]


def run_dataset(torch, root):
    """Writes the set, then per pipeline (224x400 train split, 424x800 val split, 17
    frames): ms of one clip on one thread, and of one batch of 4 through the loader
    with its worker threads (each cut from two to keep the script inside its time); then the BEV object layers and aux channels (the
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
        t1 = time.time()
        clip = dataset[0]
        clip_ms.append((time.time() - t1) * 1e3)
        require(clip["pixel_values"].shape == (NUM_FRAMES, 6, 3) + shape,
                clip["pixel_values"].shape)
        require(bool(np.isfinite(clip["pixel_values"]).all()), "clip pixels not finite")
        loader, _ = prepare_dataloader(FirstClips(dataset, 4), batch_size=4, num_workers=4,
                                       seed=0)
        batch_ms, t1 = [], time.time()
        for bi, batch in enumerate(loader):
            now = time.time()
            batch_ms.append((now - t1) * 1e3)
            t1 = now
            require(batch["pixel_values"].shape[:2] == (4, NUM_FRAMES),
                    batch["pixel_values"].shape)
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


# Euler steps of the W-CODA app's phases (test_app, brushnet_test_app, app848)
TEST_APP_STEPS = 1


def run_test_app(torch, per_forward, encode_launches, ann, root, base_config=APP_CONFIG,
                 extra_argv=(), phase="test_app", data_yaml=DATA_YAML_424,
                 save_mode="all-in-one", seen=None, frames=APP_FRAMES):
    """The W-CODA test app on the config ``base_config`` with a dataset on the
    generated set through ``data_yaml``, ``extra_argv`` added to its command line;
    its ``frames`` frames (cut to one less) are written under outputs/ in the
    checkout in ``save_mode``, read back and removed. TEST_APP_STEPS steps, two
    forwards a step under the config's rflow-slice. With ``seen``, the shapes each
    wrapper was handed are noted there."""
    from magicdrive_v2_tpu_torch.config.presets import img_collate_param
    from magicdrive_v2_tpu_torch.scripts import test_magicdrive
    from magicdrive_v2_tpu_torch.utils.inference_utils import read_png
    out_dir = os.path.join("outputs", f"chip_smoke_{phase}")
    shutil.rmtree(out_dir, ignore_errors=True)
    config = os.path.join(root, f"{phase}_config.py")
    post = dict(WCODA_POST, cut_length=frames - 1)
    write_config(config, {
        "_base_": os.path.abspath(base_config), "num_frames": frames,
        "validation_index": [0], "outputs": out_dir, "save_mode": save_mode,
        "post": post, "scheduler": {"num_sampling_steps": TEST_APP_STEPS},
        "dataset": dict(dataset_config(data_yaml, ann, "val",
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
        with (recorded_shapes(seen) if seen is not None else contextlib.nullcontext()):
            saved = test_magicdrive.main([config, "--num-samples", "1", *extra_argv])
    finally:
        log.removeHandler(handler)
    seconds = time.time() - t0
    got = read_counters()
    from magicdrive_v2_tpu_torch.config.config import Config
    passes = 2 if "slice" in Config.fromfile(config).scheduler.type else 1
    want = {k: passes * (per_forward[k] * TEST_APP_STEPS + encode_launches[k])
            for k in per_forward}
    require(got == want, (got, want))
    cut = post["cut_length"]
    out_h = post["resize"][0] + post["padding"][1] + post["padding"][3]
    out_w = post["resize"][1] + post["padding"][0] + post["padding"][2]
    grid = save_mode == "all-in-one"  # else one video a view
    require(len(saved) == (1 if grid else 6), len(saved))
    t1 = time.time()
    for path, frames in saved:
        names = sorted(os.listdir(path))
        require(names == [f"{i:04d}.png" for i in range(cut)], names)
        require(frames.shape == ((cut, 2 * out_h, 3 * out_w, 3) if grid
                                 else (cut, out_h, out_w, 3)), frames.shape)
        for i, name in enumerate(names):
            require(bool((read_png(os.path.join(path, name)) == frames[i]).all()), name)
        require(float(frames.std()) > 1.0, "constant frames")
        # the zero padding of [-1, 1] frames is mid-grey in the written frames
        require(bool((frames[:, :post["padding"][1]] == 128).all()), "top padding")
    read_s = time.time() - t1
    shutil.rmtree(out_dir, ignore_errors=True)
    timings = json.loads(next(m for m in messages if m.startswith("timings "))[8:])
    emit(phase, config=f"_base_ {base_config}, dataset {data_yaml} val",
         argv=list(extra_argv), save_mode=save_mode, videos=len(saved),
         frames=len(names), frame_shape=list(frames.shape[1:]), seconds=seconds,
         host_seconds={k: timings[k] for k in ("setup_s", "load_s", "text_s",
                                                "back_transform_s", "write_s")},
         device_seconds={"sample_and_decode_s": timings["sample_s"]},
         read_back_seconds=read_s, launches=got)
    return got


def run_train_data(torch, encode_launches, ann, root, synthetic_s_step, steps=2):
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


# ---------------------------------------------------------------------------
# phases 13-16: BrushNet / SDE-BrushNet inpainting and RePaint editing
# ---------------------------------------------------------------------------

BRUSHNET_CONFIG = ("configs/magicdrive/inference/"
                   "fullx424x800_stdit3_CogVAE_boxTDS_wCT_xCE_wSST_brushnet.py")
REPAINT_CONFIG = ("configs/magicdrive/inference/"
                  "fullx424x800_stdit3_CogVAE_boxTDS_wCT_xCE_wSST_repaint.py")
SDE_BRUSHNET = "MagicDriveSTDiT3-XL/2-SDEBrushNet"
PLAIN_BRUSHNET = "MagicDriveSTDiT3-XL/2-BrushNet"
INPAINT_NOISE_SCALE = 0.2
BRUSHNET_STEPS = 2
REPAINT_STEPS = 3
# bf16 forward, kernels against plain versions (the rule of phase grads):
# rms(out_kernels - out_plain) <= 2**-6 * rms(out_plain) + rms(out_plain - out_fp32)
FORWARD_BF16_RMS_LIMIT = 2.0 ** -6


def brushnet_config(torch, dtype, sde=True, **overrides):
    from magicdrive_v2_tpu_torch.models.magicdrive.brushnet import BrushNetConfig
    return BrushNetConfig.from_base(xl2_config(torch, dtype, **overrides), sde_inpaint=sde)


def inpaint_batch(cfg):
    """synthetic_batch at 6x424x800x17f plus the inpaint inputs of the apps
    (numpy-seeded pixels and 0/1 masks) and the SDE model's t_inpaint."""
    import numpy as np
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
    from magicdrive_v2_tpu_torch.scripts.inference_magicdrive_brushnet import (
        synthetic_inpaint_inputs)
    batch = synthetic_batch(cfg, NUM_FRAMES, HEIGHT, WIDTH, l_box=L_BOX)
    batch["x_inpaint"], batch["mask_inpaint"] = synthetic_inpaint_inputs(
        0, cfg.nc, NUM_FRAMES, HEIGHT, WIDTH)
    batch["t_inpaint"] = np.full((1,), INPAINT_NOISE_SCALE * 1000, np.float32)
    return batch


def run_brushnet_vs_plain(torch, seed):
    """XL/2-SDEBrushNet at full width, depth 2 / control depth 1, one forward with
    a frame mask at 6x424x800x17f (b=1): kernels against plain versions in fp32
    (TF32 off) and in bf16 (the fp32 weights cast), and the inpaint branch live."""
    from magicdrive_v2_tpu_torch.models.magicdrive.brushnet import MagicDriveSTDiT3BrushNet
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import cast_model
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    cfg = brushnet_config(torch, torch.float32, depth=2, control_depth=1)
    with torch.device("cuda"):
        model = MagicDriveSTDiT3BrushNet(cfg).eval()
    init_weights(model, seed=seed)
    batch = inpaint_batch(cfg)
    dev = to_card(torch, batch)
    gen = torch.Generator().manual_seed(seed)
    noise_shape = (cfg.nc * cfg.in_channels * 5, HEIGHT // 8, WIDTH // 8)
    dev["inpaint_input_noise"] = torch.randn(noise_shape, generator=gen).cuda()
    dev["x_mask"] = torch.tensor([[True, False, True, True, False]], device="cuda")
    want = expected_launches(cfg, x_mask=True)
    rows = {}
    with torch.no_grad(), no_tf32(torch):
        outs = {}
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16:
                cast_model(model, dtype)
            reset_counters()  # the forward embeds its conditions: count that apart
            model.encode_conditions(tuple(dev["x"].shape), dev["y"], dev["maps"], dev["bbox"],
                                    dev["cams"], dev["rel_pos"])
            encode = read_counters()
            reset_counters()
            out = model(**dev)
            torch.cuda.synchronize()
            require(read_counters() == {k: want[k] + encode[k] for k in want},
                    (read_counters(), want, encode))
            with routed("plain"):
                reset_counters()
                ref = model(**dev)
                torch.cuda.synchronize()
                require(sum(read_counters().values()) == 0, read_counters())
            outs[dtype] = (out, ref)
            err, scale = max_err(out, ref)
            rows[str(dtype)] = dict(max_abs_err=err, ref_max=scale)
            if dtype == torch.float32:
                # the inpaint branch is live: another mask or inpaint timestep moves it
                for key, value in (("mask_inpaint", 1 - dev["mask_inpaint"]),
                                   ("t_inpaint", torch.full((1,), 800.0, device="cuda"))):
                    moved = float((model(**{**dev, key: value}) - out).abs().max())
                    rows[str(dtype)][f"moved_by_{key}"] = moved
                    require(moved > 1e-3, (key, moved))
                limit = 1e-3 * max(1.0, scale)
                rows[str(dtype)]["limit"] = limit
                require(scale > 1e-3 and err <= limit, rows)
        out, ref = (x.float() for x in outs[torch.bfloat16])
        ref32 = outs[torch.float32][1].float()
        rms = lambda x: float(x.square().mean().sqrt())  # noqa: E731
        limit = FORWARD_BF16_RMS_LIMIT * rms(ref) + rms(ref - ref32)
        rows["torch.bfloat16"].update(rms_err=rms(out - ref), rms_limit=limit,
                                      rms_bf16_vs_fp32=rms(ref - ref32))
        require(bool(out.isfinite().all()) and rms(out - ref) <= limit, rows)
    emit("brushnet_vs_plain", model=SDE_BRUSHNET, depth=cfg.depth,
         control_depth=cfg.control_depth, output_shape=list(out.shape), x_mask=True,
         launches_per_forward=want, results=rows,
         bf16_limit="rms(kernels - plain) <= 2**-6 * rms(plain) + rms(plain - plain fp32)")
    del model, outs, out, ref, ref32, dev
    torch.cuda.empty_cache()


def brushnet_pipeline(torch, model_type, scheduler_type, steps, seed):
    """MagicDrivePipeline.from_config on the 424x800 BrushNet config with
    ``model_type`` and ``scheduler_type``, ``steps`` Euler steps."""
    from magicdrive_v2_tpu_torch.config.config import Config, merge_dot_options
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline
    cfg = Config.fromfile(BRUSHNET_CONFIG)
    merge_dot_options(cfg, [f"model.type={model_type}", f"scheduler.type={scheduler_type}",
                            f"scheduler.num_sampling_steps={steps}", f"seed={seed}"])
    t0 = time.time()
    pipe = MagicDrivePipeline.from_config(cfg)
    return pipe, time.time() - t0


def timed_sample(torch, pipe, cond, height=HEIGHT, width=WIDTH, num_frames=NUM_FRAMES, **kw):
    """One sample with decode: (video, seconds in all, seconds of the decode,
    latents, launch counts, peak memory). The decode is timed inside
    ``sample(decode=True)`` by a wrapper on the instance that reaches the pipeline
    through a weak reference only: a bound method kept there would be a reference
    cycle that keeps the pipeline, and its memory, alive after the caller drops it."""
    timing = {}
    pipeline = weakref.ref(pipe)
    decode = type(pipe).decode

    def timed_decode(z):
        timing["latents"] = z
        torch.cuda.synchronize()
        t0 = time.time()
        out = decode(pipeline(), z)
        torch.cuda.synchronize()
        timing["decode"] = time.time() - t0
        return out

    pipe.decode = timed_decode
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    video = pipe.sample(cond, num_frames=num_frames, height=height, width=width, **kw)
    torch.cuda.synchronize()
    return (video, time.time() - t0, timing["decode"], timing["latents"], read_counters(),
            torch.cuda.max_memory_allocated())


def run_brushnet(torch, seed, encode_launches):
    """Full XL/2-SDEBrushNet (28 + 28 BrushNet blocks) from the 424x800 BrushNet
    config, bf16, 6x424x800x17f, batched CFG, t_inpaint 0.2 x 1000: launches of one
    forward, a one-step warm-up sample, then one timed request of BRUSHNET_STEPS
    steps with the VAE decode; the ShallowEncoder, the mask resize and the
    structured noise timed apart at the request's shapes. Then one request of the
    plain BrushNet type (2 steps)."""
    from magicdrive_v2_tpu_torch.ops.resize import resize_linear_antialiased
    from magicdrive_v2_tpu_torch.ops.structured_noise import generate_structured_noise
    from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
    pipe, setup_s = brushnet_pipeline(torch, SDE_BRUSHNET, "rflow-sdebrushnet",
                                      BRUSHNET_STEPS, seed)
    cfg = pipe.model_cfg
    require(cfg.sde_inpaint and cfg.depth == 28 and cfg.control_depth == 13
            and cfg.hidden_size == 1152 and cfg.num_heads == 16, cfg)
    n_params = sum(p.numel() for p in pipe.model.parameters())
    n_brush = sum(p.numel() for name, p in pipe.model.named_parameters()
                  if name.startswith(("brushnet_blocks", "shallow_encoder",
                                      "x_brushnet_embedder", "t_inpaint_block",
                                      "t_combine_block")))
    per_forward = expected_launches(cfg)
    require(per_forward == {"fused_qkv_attention": 97, "adaln_modulate": 304,
                            "flash_attention": 82}, per_forward)
    batch = inpaint_batch(cfg)
    cond = {k: v for k, v in batch.items() if k not in ("x", "timestep", "height", "width")}
    model = pipe.model
    latent_shape = (1, 96, 5, HEIGHT // 8, WIDTH // 8)
    # one forward at b=1 with a condition cache: the per-forward launches
    with torch.no_grad():
        dev = to_card(torch, batch)
        dev["inpaint_input_noise"] = torch.randn(
            pipe.inpaint_noise_shape(latent_shape, True), device="cuda")
        cache = model.encode_conditions(latent_shape, dev["y"], dev["maps"], dev["bbox"],
                                        dev["cams"], dev["rel_pos"])
        reset_counters()
        out = model(**dev, cond_cache=cache)
        torch.cuda.synchronize()
        require(read_counters() == per_forward, (read_counters(), per_forward))
        require(out.shape == latent_shape and bool(out.isfinite().all()), out.shape)
        del out, cache, dev
    # warm-up: one step, no decode (cuDNN's first calls at these shapes)
    scheduler, pipe.scheduler = pipe.scheduler, build_scheduler(
        dict(type="rflow-sdebrushnet", num_sampling_steps=1, inpaint_noise_scale=0.2))
    pipe.sample(cond, num_frames=NUM_FRAMES, height=HEIGHT, width=WIDTH, torch_seed=1024,
                decode=False)
    pipe.scheduler = scheduler
    with torch.no_grad():
        pipe.vae.decode(torch.zeros((1, 16) + latent_shape[2:], device="cuda",
                                    dtype=pipe.vae.dtype))
    video, seconds, decode_s, latents, got, peak = timed_sample(torch, pipe, cond,
                                                                torch_seed=1024)
    want = {k: per_forward[k] * BRUSHNET_STEPS + encode_launches[k] for k in per_forward}
    require(got == want, (got, want))
    require(tuple(latents.shape) == latent_shape and bool(latents.isfinite().all()),
            latents.shape)
    require(tuple(video.shape) == (1, 6, 3, NUM_FRAMES, HEIGHT, WIDTH)
            and bool(video.isfinite().all()), video.shape)
    sampling = seconds - decode_s
    # the branch's own stages at the request's shapes (batched CFG: 12 views)
    dt = cfg.dtype
    x_px = torch.randn((12, 3, NUM_FRAMES, HEIGHT, WIDTH), device="cuda", dtype=dt)
    m_px = (torch.rand((12, 1, NUM_FRAMES, HEIGHT, WIDTH), device="cuda") > 0.5).to(dt)
    with torch.no_grad():
        shallow_ms = time_ms(torch, lambda: model.shallow_encoder(x_px), 3)
        resize_ms = time_ms(torch, lambda: resize_linear_antialiased(
            m_px, (12, 1) + latent_shape[2:]), 3)
        enc = model.shallow_encoder(x_px).reshape(-1, *latent_shape[3:])
        noise = torch.randn(enc.shape, device="cuda")
        noise_ms = time_ms(torch, lambda: generate_structured_noise(enc, input_noise=noise), 5)
    del x_px, m_px, enc, noise
    emit("brushnet", model=SDE_BRUSHNET, config=BRUSHNET_CONFIG, dtype="bfloat16",
         params=n_params, brushnet_params=n_brush, setup_seconds=setup_s, views=6,
         frames=NUM_FRAMES, height=HEIGHT, width=WIDTH, steps=BRUSHNET_STEPS,
         t_inpaint=INPAINT_NOISE_SCALE * 1000, cfg="batched",
         seconds_per_sample=sampling, seconds_per_step=sampling / BRUSHNET_STEPS,
         decode_seconds=decode_s, seconds_per_sample_with_decode=seconds,
         peak_memory_bytes=peak, shallow_encoder_ms=shallow_ms, mask_resize_ms=resize_ms,
         structured_noise_ms=noise_ms, stage_shapes=dict(
             shallow_encoder=[12, 3, NUM_FRAMES, HEIGHT, WIDTH],
             mask_resize=[[12, 1, NUM_FRAMES, HEIGHT, WIDTH], [12, 1, *latent_shape[2:]]]),
         launches_per_forward=per_forward, launches_encode_conditions=encode_launches,
         launches_per_sample=got, latent_abs_mean=float(latents.abs().mean()),
         video_abs_mean=float(video.abs().mean()))
    sde_launches = got
    del pipe, model, video, latents
    gc.collect()
    torch.cuda.empty_cache()
    # what stays on the card of the SDE phase: its pipeline (6 GB of weights) must
    # be gone, or the plain phase's peak would count it
    held = torch.cuda.memory_allocated()
    require(held < 2e9, f"{held} bytes still allocated after the SDE pipeline was dropped")

    # one request of the plain BrushNet type
    steps = 2
    pipe, setup_s = brushnet_pipeline(torch, PLAIN_BRUSHNET, "rflow-brushnet", steps, seed)
    require(not pipe.model_cfg.sde_inpaint, pipe.model_cfg)
    require(expected_launches(pipe.model_cfg) == per_forward, "plain BrushNet launches")
    cond = {k: v for k, v in cond.items() if k != "t_inpaint"}
    video, seconds, decode_s, latents, got, peak = timed_sample(torch, pipe, cond,
                                                                torch_seed=1025)
    want = {k: per_forward[k] * steps + encode_launches[k] for k in per_forward}
    require(got == want, (got, want))
    require(tuple(video.shape) == (1, 6, 3, NUM_FRAMES, HEIGHT, WIDTH)
            and bool(video.isfinite().all()), video.shape)
    emit("brushnet_plain", model=PLAIN_BRUSHNET, config=BRUSHNET_CONFIG, steps=steps,
         allocated_before_bytes=held, setup_seconds=setup_s,
         seconds_per_sample_with_decode=seconds,
         decode_seconds=decode_s, seconds_per_step=(seconds - decode_s) / steps,
         peak_memory_bytes=peak, launches_per_sample=got,
         video_abs_mean=float(video.abs().mean()))
    del pipe, video, latents
    torch.cuda.empty_cache()
    return sde_launches


def repaint_inputs(torch, pipe, seed):
    """The reference: 0.2 x standard normal pixels of six views, VAE-encoded on the
    card (C-major latents), and the latent mask keeping the top half of every view."""
    import numpy as np
    from magicdrive_v2_tpu_torch.scripts.inference_magicdrive_repaint import (
        compress_time_for_mask)
    nc, C = pipe.model_cfg.nc, pipe.model_cfg.in_channels
    gen = torch.Generator().manual_seed(seed)
    ref_px = (torch.randn((nc, 3, NUM_FRAMES, HEIGHT, WIDTH), generator=gen) * 0.2).cuda()
    torch.cuda.synchronize()
    t0 = time.time()
    ref_lat = pipe.vae.encode(ref_px.to(pipe.vae.dtype),
                              generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    encode_s = time.time() - t0
    T, H, W = ref_lat.shape[2:]
    ref_z = ref_lat.float().reshape(1, nc, C, T, H, W).transpose(1, 2).reshape(1, C * nc, T, H, W)
    px_mask = np.zeros((1, nc, NUM_FRAMES, HEIGHT, WIDTH), np.float32)
    px_mask[..., :HEIGHT // 2, :] = 1.0
    lat_mask = compress_time_for_mask(px_mask)[..., ::8, ::8][..., :H, :W]
    lat_mask = np.repeat(lat_mask[:, None], C, axis=1).reshape(1, C * nc, T, H, W)
    return ref_z, torch.from_numpy(lat_mask).cuda(), encode_s


def run_repaint(torch, seed, per_forward, encode_launches):
    """Base XL/2 from the 424x800 repaint config (``rflow-slice-repaint``: two-pass
    CFG), REPAINT_STEPS steps, the reference encoded on the card: the kept region
    of the final latents equals the reference exactly."""
    from magicdrive_v2_tpu_torch.config.config import Config, merge_dot_options
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
    cfg = Config.fromfile(REPAINT_CONFIG)
    merge_dot_options(cfg, [f"scheduler.num_sampling_steps={REPAINT_STEPS}", f"seed={seed}"])
    t0 = time.time()
    pipe = MagicDrivePipeline.from_config(cfg)
    setup_s = time.time() - t0
    require(type(pipe.scheduler).__name__ == "RFLOW_SLICE_REPAINT", type(pipe.scheduler))
    require(expected_launches(pipe.model_cfg) == per_forward, "base launches")
    batch = synthetic_batch(pipe.model_cfg, NUM_FRAMES, HEIGHT, WIDTH, l_box=L_BOX)
    cond = {k: v for k, v in batch.items() if k not in ("x", "timestep", "height", "width")}
    ref_z, lat_mask, encode_s = repaint_inputs(torch, pipe, seed)
    kw = dict(num_frames=NUM_FRAMES, height=HEIGHT, width=WIDTH)
    # warm-up at the same shapes, then the timed run
    pipe.sample_repaint(cond, ref_z, lat_mask, generator=torch.Generator().manual_seed(1),
                        **kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    z = pipe.sample_repaint(cond, ref_z, lat_mask, generator=torch.Generator().manual_seed(0),
                            **kw)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    got = read_counters()
    # two-pass CFG: two forwards a step, the conditions encoded for each pass
    want = {k: 2 * (per_forward[k] * REPAINT_STEPS + encode_launches[k]) for k in per_forward}
    require(got == want, (got, want))
    keep = lat_mask == 1
    require(z.shape == ref_z.shape and bool(z.isfinite().all()), z.shape)
    require(torch.equal(z[keep], ref_z[keep]), "the kept region is not the reference")
    moved = float((z[~keep] - ref_z[~keep]).abs().max())
    require(moved > 1e-2, moved)
    emit("repaint", model="MagicDriveSTDiT3-XL/2", config=REPAINT_CONFIG, scheduler="rflow-slice-repaint",
         cfg="two-pass", dtype="bfloat16", steps=REPAINT_STEPS, setup_seconds=setup_s,
         vae_encode_seconds=encode_s, seconds=seconds, seconds_per_step=seconds / REPAINT_STEPS,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), kept_fraction=float(keep.float().mean()),
         kept_region_equals_reference=True, repainted_max_change=moved, launches=got)
    del pipe, z, ref_z
    torch.cuda.empty_cache()
    return got


def read_back(saved, n_frames, shape):
    """The frames an app wrote: names, shape, and each PNG equal to the array the
    app returned; then the directory is removed. Returns the PNG bytes."""
    from magicdrive_v2_tpu_torch.utils.inference_utils import read_png
    require(len(saved) == 1, len(saved))
    path, frames = saved[0]
    names = sorted(os.listdir(path))
    require(names == [f"{i:04d}.png" for i in range(n_frames)], names)
    require(frames.shape == (n_frames,) + shape, frames.shape)
    for i, name in enumerate(names):
        require(bool((read_png(os.path.join(path, name)) == frames[i]).all()), name)
    require(float(frames.std()) > 1.0, "constant frames")
    return sum(os.path.getsize(os.path.join(path, n)) for n in names)


def run_brushnet_apps(torch, sde_per_forward, base_per_forward, encode_launches):
    """The BrushNet app (``--synthetic --sde``) and the repaint app (``--synthetic``)
    on their 424x800 configs, APP_FRAMES frames, 2 steps; launch counters and the
    frames read back."""
    from magicdrive_v2_tpu_torch.scripts import (inference_magicdrive_brushnet,
                                                 inference_magicdrive_repaint)
    rows = {}
    for name, app, config, argv, want in (
            ("brushnet_app", inference_magicdrive_brushnet, BRUSHNET_CONFIG, ["--sde"],
             {k: 2 * sde_per_forward[k] + encode_launches[k] for k in sde_per_forward}),
            ("repaint_app", inference_magicdrive_repaint, REPAINT_CONFIG, [],
             {k: 2 * (2 * base_per_forward[k] + encode_launches[k]) for k in base_per_forward})):
        out_dir = os.path.join("outputs", f"chip_smoke_{name}")
        shutil.rmtree(out_dir, ignore_errors=True)
        reset_counters()
        t0 = time.time()
        saved = app.main([config, "--synthetic", "--num-frames", str(APP_FRAMES),
                          "--num-samples", "1", *argv, "--cfg-options",
                          "scheduler.num_sampling_steps=2", f"outputs={out_dir}"])
        seconds = time.time() - t0
        got = read_counters()
        require(got == want, (name, got, want))
        nbytes = read_back(saved, APP_FRAMES, (2 * HEIGHT, 3 * WIDTH, 3))
        shutil.rmtree(out_dir, ignore_errors=True)
        rows[name] = dict(config=config, argv=argv, steps=2, seconds=seconds, png_bytes=nbytes,
                          launches=got)
        torch.cuda.empty_cache()
    emit("brushnet_apps", frames=APP_FRAMES, frame_shape=[2 * HEIGHT, 3 * WIDTH, 3], apps=rows)


# ---------------------------------------------------------------------------
# phases app848_sde, app848_brushnet, sde848_65f: the 848x1600 inpainting configs
# ---------------------------------------------------------------------------

APP848_SDE_CONFIG = "configs/magicdrive/test/17-16x848x1600_map0_fsp4_cfg2.0_sde_brushnet.py"
APP848_BRUSHNET_CONFIG = "configs/magicdrive/test/17-16x848x1600_map0_fsp4_cfg2.0_brushnet.py"
SDE848_65F_CONFIG = ("configs/magicdrive/inference/"
                     "65x848x1600_stdit3_CogVAE_boxTDS_wCT_xCE_wSST_sde_brushnet.py")
# depth / control depth of app848_brushnet: app848_sde runs the full-depth blocks,
# brushnet_plain the plain type at full depth
APP848_BRUSHNET_DEPTH = (7, 4)
# depth / control depth of sde848_65f (cut from 28 / 13 to keep the script in time;
# at full depth it peaked at 48.4 GB, PERF.md)
SDE848_65F_DEPTH = (14, 7)


def run_app848_inpainting(torch, encode_launches, ann, root, held):
    """The W-CODA app on the two 17-16 848x1600 inpainting configs over the
    generated set (rflow-sdebrushnet-slice / rflow-brushnet-slice, sp_size 4 on one
    rank: unsharded, S = 5300, which the fsp4 pad leaves as it is): the SDE-BrushNet one at full depth (28 + 28 BrushNet blocks, control
    13), the BrushNet one at depth APP848_BRUSHNET_DEPTH; as ``app848`` runs, with
    the shapes each wrapper was handed held. Returns the launches of each."""
    out = {}
    for phase, config, depth in (("app848_sde", APP848_SDE_CONFIG, None),
                                 ("app848_brushnet", APP848_BRUSHNET_CONFIG,
                                  APP848_BRUSHNET_DEPTH)):
        overrides = {} if depth is None else dict(depth=depth[0], control_depth=depth[1])
        model_cfg = brushnet_config(torch, torch.bfloat16, sde=depth is None, **overrides)
        per_forward = expected_launches(model_cfg)
        if depth is None:
            require(per_forward == {"fused_qkv_attention": 97, "adaln_modulate": 304,
                                    "flash_attention": 82}, per_forward)
        argv = () if depth is None else ("--cfg-options", f"model.depth={depth[0]}",
                                         f"model.control_depth={depth[1]}")
        seen = no_shapes()
        out[phase] = run_test_app(torch, per_forward, encode_launches, ann, root,
                                  base_config=config, extra_argv=argv, phase=phase,
                                  data_yaml=DATA_YAML_848, save_mode="image_filename",
                                  seen=seen, frames=APP848_FRAMES)
        emit(f"{phase}_kernel_cases", per_forward=per_forward,
             cases=held.hold(seen, phase), shapes=shape_record(seen))
        torch.cuda.empty_cache()
    return out


def shape_record(seen):
    """A record of ``recorded_shapes`` as JSON."""
    return dict(fused_qkv_attention=[dict(qkv=list(k[0]), dtype=str(k[1]), norm=k[2], J=k[3])
                                     for k in seen["fused_qkv_attention"]],
                adaln_modulate=[dict(x=list(k[0]), dtype=str(k[1]))
                                for k in seen["adaln_modulate"]],
                flash_attention=[dict(q=list(k[0]), M=k[1], dtype=str(k[2]))
                                 for k in seen["flash_attention"]])


def run_sde848_65f(torch, seed, encode_launches, held):
    """The 65-frame 848x1600 SDE-BrushNet config through ``from_config`` in one
    process of an NCCL group of one (sp_size 4 on one rank: unsharded; 5300 tokens a
    frame divide 4, so the fsp4 pad adds none): XL/2-SDEBrushNet at full width, depth
    SDE848_65F_DEPTH, bf16, rflow-sdebrushnet-slice (two forwards of b=1 a step), 6 views of 65
    frames (17 latent frames: 540,600 tokens a forward), 1 step,
    ``sample(decode=False)``, the pedestrian frames and masks drawn on the card; then
    one view's 17 latent frames through the tiled VAE decode (65 frames). s/step,
    peak memory, launches; every shape the path handed a wrapper held against its
    plain version (``held``). Returns the launches."""
    import torch.distributed as dist
    from magicdrive_v2_tpu_torch.config.config import Config, merge_dot_options
    from magicdrive_v2_tpu_torch.parallel.distributed import free_port
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
    from magicdrive_v2_tpu_torch.utils.inference_utils import resolve_num_frames
    cfg = Config.fromfile(SDE848_65F_CONFIG)
    merge_dot_options(cfg, ["scheduler.num_sampling_steps=1", f"seed={seed}",
                            f"model.depth={SDE848_65F_DEPTH[0]}",
                            f"model.control_depth={SDE848_65F_DEPTH[1]}"])
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        t0 = time.time()
        pipe = MagicDrivePipeline.from_config(cfg, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.time() - t0
    finally:
        dist.destroy_process_group()
    mc = pipe.model_cfg
    require(pipe.mesh is None and mc.sde_inpaint
            and (mc.depth, mc.control_depth) == SDE848_65F_DEPTH
            and mc.hidden_size == 1152 and mc.force_pad_h_for_sp_size == 4
            and pipe.scheduler.slice_cfg and pipe.vae.tiling, (pipe.mesh, mc))
    frames = resolve_num_frames(cfg)
    require(frames == 65, frames)
    per_forward = expected_launches(mc)
    # 53 x 100 token rows and columns: 5300 tokens a frame divide 4, so the fsp4 pad
    # adds none (it pads where H * W does not divide 4)
    H, W = -(-H848 // 16), -(-W848 // 16)
    pad = pipe.model._h_pad_size(H, W)
    S = (H + pad) * W
    require(pad == 0 and S == 5300, (pad, S))
    batch = synthetic_batch(mc, frames, H848, W848, l_box=L_BOX,
                            l_txt=pipe.text_encoder.model_max_length)
    cond = {k: batch[k] for k in ("y", "maps", "bbox", "cams", "rel_pos", "fps")}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    px = (1, mc.nc, frames, H848, W848)
    cond["x_inpaint"] = torch.randn((1, 3 * mc.nc) + px[2:], generator=gen, device="cuda",
                                    dtype=torch.bfloat16)
    cond["mask_inpaint"] = (torch.rand(px, generator=gen, device="cuda") > 0.5).to(
        torch.bfloat16)
    cond["t_inpaint"] = torch.full((1,), INPAINT_NOISE_SCALE * 1000.0, device="cuda")
    seen = no_shapes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.time()
    with recorded_shapes(seen):
        latents = pipe.sample(cond, num_frames=frames, height=H848, width=W848,
                              torch_seed=1024, decode=False)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    got = read_counters()
    T = (frames - 1) // 4 + 1
    want = {k: 2 * (per_forward[k] + encode_launches[k]) for k in per_forward}
    require(got == want, (got, want))
    require(tuple(latents.shape) == (1, 6 * mc.in_channels, T, H848 // 8, W848 // 8)
            and bool(latents.isfinite().all()), latents.shape)
    del cond
    # one view's latent frames through the tiled decode
    z = latents[:, ::mc.nc].to(pipe.vae.dtype)
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.no_grad():
        video = pipe.vae.decode(z)
    torch.cuda.synchronize()
    decode_s = time.time() - t0
    require(tuple(video.shape) == (1, 3, frames, H848, W848) and bool(video.isfinite().all()),
            video.shape)
    del pipe, video, z
    gc.collect()
    torch.cuda.empty_cache()
    cases = held.hold(seen, "sde848_65f")
    tokens = 6 * T * S
    emit("sde848_65f", config=SDE848_65F_CONFIG, model=SDE_BRUSHNET, dtype="bfloat16",
         depth=list(SDE848_65F_DEPTH), sp_config=int(cfg.sp_size), sp_run=1,
         force_pad_h_for_sp_size=4,
         scheduler="rflow-sdebrushnet-slice", views=6, frames=frames, latent_frames=T,
         height=H848, width=W848, tokens_per_view=S, tokens_per_forward=tokens,
         steps=1, setup_seconds=setup_s, seconds_per_step=seconds, peak_memory_bytes=peak,
         decode_one_view_seconds=decode_s, vae_tiling=int(cfg.vae_tiling),
         launches_per_forward=per_forward, launches_per_sample=got,
         latent_abs_mean=float(latents.abs().mean()), shapes=shape_record(seen),
         kernel_cases=cases)
    del latents
    torch.cuda.empty_cache()
    return got


# ---------------------------------------------------------------------------
# phase block_bench: one block at the 424p bench shape, kernels against plain
# ---------------------------------------------------------------------------

# the launches of one block: spatial (self-attention and cross-view attention, three
# norms, condition cross-attention), temporal (two norms, condition cross-attention)
BLOCK_LAUNCHES = {"spatial": {"fused_qkv_attention": 2, "adaln_modulate": 3,
                              "flash_attention": 1},
                  "temporal": {"fused_qkv_attention": 0, "adaln_modulate": 2,
                               "flash_attention": 1}}


def run_block_bench(torch, seed):
    """``tools/block_bench`` at its bench shape (B=12, T=5, S=1350, C=1152, 16
    heads, bf16): a chain of 8 spatial and of 8 temporal blocks, through the kernels
    and through their plain versions, the median of 3 chains in ms per block, and
    each kind's first block through the kernels held against the plain route
    (``first_block_check``'s limit). Returns the launches of the timed chains."""
    from magicdrive_v2_tpu_torch.tools import block_bench as bb
    reset_counters()
    rows = bb.bench("both", **bb.BENCH_SHAPE, seed=seed)
    launches = read_counters()
    for r in rows:
        want = (BLOCK_LAUNCHES[r["block"]] if r["route"] == "kernels"
                else dict.fromkeys(BLOCK_LAUNCHES["spatial"], 0))
        require(r["launches_per_block"] == want, r)
    checks = bb.check_first_blocks(**bb.BENCH_SHAPE, seed=seed)
    require(all(c["ok"] and c["finite"] for c in checks.values()), checks)
    ms = {(r["block"], r["route"]): r["ms_per_block"] for r in rows}
    emit("block_bench", shape=bb.BENCH_SHAPE, dtype="bfloat16", chain=bb.CHAIN, reps=bb.REPS,
         rows=rows, first_block_vs_plain=checks,
         kernels_over_plain={k: ms[(k, "kernels")] / ms[(k, "plain")]
                             for k in ("spatial", "temporal")},
         launches=launches)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 17-20: BrushNet training and the remat policies
# ---------------------------------------------------------------------------

BRUSH_TRAIN_APP_CONFIG = "configs/magicdrive/train/brushnet_smoke.py"
BRUSHNET_STEPS_TRAIN, PLAIN_BRUSHNET_STEPS_TRAIN = 2, 2
# depth / control depth of the SDE and the plain BrushNet types' steps, cut from 28 /
# 13 to keep the script inside its time (PERF.md keeps the full-depth numbers)
SDE_BRUSHNET_TRAIN_DEPTH = (7, 4)
PLAIN_BRUSHNET_TRAIN_DEPTH = (7, 4)


def brushnet_train_setup(torch, dtype, sde=True, **overrides):
    """(stage-2 config, its base model config, the BrushNet config over it, the
    scheduler: ``RFLOW_SDEBRUSHNET`` or ``RFLOW_BRUSHNET`` with the config's
    arguments), as the BrushNet train app builds them; ``overrides`` on the base."""
    from magicdrive_v2_tpu_torch.models.magicdrive.brushnet import BrushNetConfig
    from magicdrive_v2_tpu_torch.scripts.train_brushnet import brushnet_scheduler
    cfg = train_config(torch)
    base_cfg = train_model_config(torch, cfg, dtype, **overrides)
    model_cfg = BrushNetConfig.from_base(base_cfg, sde_inpaint=sde)
    return cfg, base_cfg, model_cfg, brushnet_scheduler(cfg, sde)


def brushnet_train_batches(cfg, base_cfg, seed):
    """The stage-2 synthetic batches (frame masks, condition dropout) with the
    inpaint inputs of each step: standard-normal pixels and 0/1 masks."""
    import numpy as np
    shape = (TRAIN_FRAMES, TRAIN_HEIGHT, TRAIN_WIDTH)
    for step, (batch, bucket) in enumerate(train_batches(cfg, base_cfg, seed)):
        b, nc = batch["x"].shape[0], base_cfg.nc
        rng = np.random.default_rng((seed, step, 9))
        batch["x_inpaint"] = rng.standard_normal((b, 3 * nc) + shape, np.float32)
        batch["mask_inpaint"] = rng.integers(0, 2, (b, nc) + shape).astype(np.float32)
        yield batch, bucket


def freeze_base(model):
    """Only the BrushNet branch requires grad (the train app's mask); returns it."""
    from magicdrive_v2_tpu_torch.training.lora import (BRUSHNET_EXTRA_TRAINABLE,
                                                       lora_trainable_mask)
    mask = lora_trainable_mask(model.named_parameters(), BRUSHNET_EXTRA_TRAINABLE)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return mask


def run_brushnet_grads(torch, seed, encode_launches):
    """Grads of one SDE-BrushNet training loss (``train=True``, only the branch
    trainable) through the kernels against those through their plain versions:
    XL/2 at full width, depth 2 / control depth 1, the stage-2 bucket, fp32 (TF32
    off) and bf16; launches and each Function's backwards against their counts
    derived from the graph."""
    from magicdrive_v2_tpu_torch.models.magicdrive.brushnet import MagicDriveSTDiT3BrushNet
    from magicdrive_v2_tpu_torch.ops.structured_noise import sample_cutoff_radius
    from magicdrive_v2_tpu_torch.training.trainer import step_generator, training_loss
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    from magicdrive_v2_tpu_torch.utils.misc import to_device

    cfg, base_cfg, model_cfg, sched = brushnet_train_setup(torch, torch.float32, depth=2,
                                                           control_depth=1)
    with torch.device("cuda"):
        model = MagicDriveSTDiT3BrushNet(model_cfg)
    init_weights(model, seed=seed)
    mask = freeze_base(model)
    batch, (nf, h, w) = next(brushnet_train_batches(cfg, base_cfg, seed))
    batch["mask"][:, 0] = 0.0  # one condition frame in every sample: the t0 path runs
    dev = to_device(batch, "cuda")
    b = cfg.batch_size
    gen = step_generator(seed, 0)
    hw = dict(height=torch.full((b,), h), width=torch.full((b,), w),
              num_frames=torch.full((b,), float(nf)))
    t, t_inpaint = sched.sample_t(gen, b, **hw), sched.sample_t(gen, b, **hw)
    noise = torch.randn(dev["x"].shape, generator=gen)
    cutoff = float(sample_cutoff_radius(gen, model_cfg.structured_noise_r0))
    lat = dev["x"].shape[2:]
    model_draws = dict(cutoff_radius=cutoff, inpaint_input_noise=torch.randn(
        (b * model_cfg.nc * model_cfg.in_channels * lat[0],) + tuple(lat[1:]),
        generator=gen).cuda())
    per_forward = expected_launches(model_cfg, x_mask=True)
    want = {k: 2 * per_forward[k] + encode_launches[k] for k in per_forward}
    want_backward = expected_backward_calls_frozen_base(model_cfg, x_mask=True)

    def grads_of(dtype, plain):
        model.zero_grad(set_to_none=True)
        reset_counters()
        reset_backward_calls()
        with (routed("plain") if plain else contextlib.nullcontext()):
            loss, _ = training_loss(model, sched, dev, height=h, width=w, num_frames=nf,
                                    dtype=dtype, t=t, noise=noise,
                                    t_inpaint=t_inpaint, model_kwargs=model_draws)
            loss.backward()
        torch.cuda.synchronize()
        grads = {n: None if p.grad is None else p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        return float(loss.detach()), grads, read_counters(), read_backward_calls()

    result, fp32_plain = {}, None
    trainable = [n for n, m in mask.items() if m]
    for dtype in (torch.float32, torch.bfloat16):
        with no_tf32(torch):
            loss_k, gk, launches, backwards = grads_of(dtype, plain=False)
            loss_p, gp, plain_launches, plain_backwards = grads_of(dtype, plain=True)
        # remat: the forward and the recompute each launch every group's kernels
        require(launches == want and backwards == want_backward,
                (launches, want, backwards, want_backward))
        require(sum(plain_launches.values()) + sum(plain_backwards.values()) == 0,
                (plain_launches, plain_backwards))
        require(all(gp[n] is not None and bool((gp[n] != 0).any()) for n in trainable),
                "a trainable tensor without a grad")
        require(all(gk[n] is None and gp[n] is None for n in mask if not mask[n]),
                "a frozen tensor with a grad")
        worst, with_grad, roundings = compare_grads(torch, gk, gp, fp32_plain)
        require(with_grad == len(trainable), (with_grad, len(trainable)))
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
    emit("brushnet_grads", model=SDE_BRUSHNET, depth=model_cfg.depth,
         control_depth=model_cfg.control_depth, batch=b, frames=nf, height=h, width=w,
         train=True, cutoff_radius=cutoff, trainable_tensors=len(trainable),
         frozen_tensors=len(mask) - len(trainable), launches_expected=want,
         backward_calls_expected=want_backward, by_dtype=result,
         fp32_limit=f"per tensor max|err| <= {GRAD_FP32_LIMIT} * max|g_plain|",
         bf16_limit=f"per tensor rms(err) <= 2**{math.log2(GRAD_BF16_RMS_LIMIT):g} * "
         "rms(g_plain) + rms(g_plain - g_plain_fp32)")
    del model, dev, fp32_plain
    gc.collect()
    torch.cuda.empty_cache()


def run_brushnet_train(torch, seed, encode_launches):
    """The BrushNet trainer at full width in the stage-2 bucket and settings (b=4,
    remat, bf16 over fp32 masters, AdamW, EMA 0.99, logit-normal t), only the
    branch trainable: XL/2-SDEBrushNet at SDE_BRUSHNET_TRAIN_DEPTH (the SDE loss, the cutoff
    jitter) for BRUSHNET_STEPS_TRAIN steps, then the plain BrushNet type at
    PLAIN_BRUSHNET_TRAIN_DEPTH for PLAIN_BRUSHNET_STEPS_TRAIN, the first step of
    each untimed. The frozen base and
    its EMA stay bit-equal, every branch tensor moves, the EMA identity holds, the
    launches and backwards are the remat layout's. Returns the SDE step's launches."""
    from magicdrive_v2_tpu_torch.models.magicdrive.brushnet import MagicDriveSTDiT3BrushNet
    from magicdrive_v2_tpu_torch.training.trainer import build_brushnet_training
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    from magicdrive_v2_tpu_torch.utils.misc import to_device

    sde_launches = None
    for sde, steps in ((True, BRUSHNET_STEPS_TRAIN), (False, PLAIN_BRUSHNET_STEPS_TRAIN)):
        depth = SDE_BRUSHNET_TRAIN_DEPTH if sde else PLAIN_BRUSHNET_TRAIN_DEPTH
        cfg, base_cfg, model_cfg, sched = brushnet_train_setup(
            torch, torch.bfloat16, sde=sde, depth=depth[0], control_depth=depth[1])
        require((model_cfg.depth, model_cfg.control_depth, model_cfg.hidden_size,
                 model_cfg.grad_checkpoint, model_cfg.remat_policy)
                == (*depth, 1152, True, "full"), model_cfg)
        t0 = time.time()
        with torch.device("cuda"):
            model = MagicDriveSTDiT3BrushNet(model_cfg)
        init_weights(model, seed=seed)
        state, step_fn = build_brushnet_training(
            model, sched, cfg, height=TRAIN_HEIGHT, width=TRAIN_WIDTH,
            num_frames=TRAIN_FRAMES, seed=seed + 1)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        state_bytes = torch.cuda.memory_allocated()
        n_params = sum(p.numel() for p in model.parameters())
        trainable = {n for n, p in model.named_parameters() if p.requires_grad}
        n_trainable = sum(p.numel() for n, p in model.named_parameters() if n in trainable)
        before = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
        per_forward = expected_launches(model_cfg, x_mask=True)
        want = {k: 2 * per_forward[k] + encode_launches[k] for k in per_forward}
        want_backward = expected_backward_calls_frozen_base(model_cfg, x_mask=True)
        name = f"brushnet_blocks_s.{model_cfg.depth - 1}.attn.qkv.weight"
        param, ema = dict(model.named_parameters())[name], dict(state.ema.named_parameters())[name]
        seconds, losses, grad_norms, t_means, launches, tokens = [], [], [], [], None, None
        batches = brushnet_train_batches(cfg, base_cfg, seed)
        for i in range(steps):
            batch, (nf, h, w) = next(batches)
            require((nf, h, w) == (TRAIN_FRAMES, TRAIN_HEIGHT, TRAIN_WIDTH), (nf, h, w))
            dev = to_device(batch, "cuda")
            e_before = ema.detach().clone()
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
            require(got == want and backwards == want_backward,
                    (got, want, backwards, want_backward))
            launches = got
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            require(math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0, (loss, gnorm))
            losses.append(loss)
            grad_norms.append(gnorm)
            t_means.append(float(metrics["t_mean"]))
            expect = e_before * cfg.ema_decay + param.detach() * (1 - cfg.ema_decay)
            ema_err = float((ema.detach() - expect).abs().max())
            require(ema_err <= 2.0 ** -21 * float(expect.abs().max()), ("EMA", ema_err))
            B, _, T, Hl, Wl = dev["x"].shape
            tokens = B * model_cfg.nc * T * (Hl // 2) * (Wl // 2)
        peak = torch.cuda.max_memory_allocated()
        require(state.step == steps, state.step)
        ema_params = dict(state.ema.named_parameters())
        moved = 0
        for n, p in model.named_parameters():
            if n in trainable:
                moved += not torch.equal(p.detach().cpu(), before[n])
            else:
                require(torch.equal(p.detach().cpu(), before[n])
                        and torch.equal(ema_params[n].detach().cpu(), before[n]),
                        f"frozen {n} or its EMA changed")
        require(moved == len(trainable), (moved, len(trainable)))
        timed = seconds[1:]
        s_step = sum(timed) / len(timed)
        emit("brushnet_train" if sde else "brushnet_train_plain",
             model=SDE_BRUSHNET if sde else PLAIN_BRUSHNET, config=TRAIN_CONFIG,
             depth=model_cfg.depth, control_depth=model_cfg.control_depth,
             params=n_params, trainable_params=n_trainable,
             trainable_tensors=len(trainable), frozen_tensors=len(before) - len(trainable),
             dtype="bfloat16 compute, float32 masters", batch=cfg.batch_size,
             frames=TRAIN_FRAMES, height=TRAIN_HEIGHT, width=TRAIN_WIDTH,
             tokens_per_step=tokens, grad_checkpoint=True, remat_policy="full",
             setup_seconds=setup_s, state_bytes=state_bytes, seconds_per_step=seconds,
             seconds_per_step_timed_mean=s_step, samples_per_second=cfg.batch_size / s_step,
             tokens_per_second=tokens / s_step, peak_memory_bytes=peak, losses=losses,
             grad_norms=grad_norms, t_means=t_means, launches_per_step=launches,
             backward_calls_per_step=want_backward, frozen_bit_equal=True,
             branch_moved=moved, ema_identity=True)
        if sde:
            sde_launches = launches
        del state, model, param, ema, ema_params, dev, before, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    return sde_launches


def run_remat(torch, seed, encode_launches):
    """Base XL/2 at full width, depth REMAT_DEPTH, in the stage-2 bucket at b=1: a training
    loss forward and backward under each remat policy, one untimed, then
    ``REMAT_REPS`` timed (median and spread); loss and grads against "full"'s,
    seconds, peak memory, and what "offload_carry" sends to the host. Every policy
    runs over the same state on the card (the weights and the batch): "full"'s
    grads wait on the host between comparisons."""
    import dataclasses
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import REMAT_POLICIES
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
    from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
    from magicdrive_v2_tpu_torch.training.trainer import step_generator, training_loss
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    from magicdrive_v2_tpu_torch.utils.misc import to_device

    cfg = train_config(torch)
    cfg.batch_size = 1
    model_cfg = train_model_config(torch, cfg, torch.bfloat16, depth=REMAT_DEPTH[0],
                                   control_depth=REMAT_DEPTH[1])
    require((model_cfg.depth, model_cfg.grad_checkpoint) == (REMAT_DEPTH[0], True), model_cfg)
    with torch.device("cuda"):
        model = MagicDriveSTDiT3(model_cfg)
    init_weights(model, seed=seed)
    sched = build_scheduler(cfg.scheduler)
    batch, (nf, h, w) = next(train_batches(cfg, model_cfg, seed))
    dev = to_device(batch, "cuda")
    gen = step_generator(seed, 0)
    t = sched.sample_t(gen, 1, height=torch.full((1,), h), width=torch.full((1,), w),
                       num_frames=torch.full((1,), float(nf)))
    noise = torch.randn(dev["x"].shape, generator=gen)
    per_forward = expected_launches(model_cfg, x_mask=True)
    want = {k: 2 * per_forward[k] + encode_launches[k] for k in per_forward}
    B, _, T, Hl, Wl = dev["x"].shape
    carry_numel = B * model_cfg.nc * T * (Hl // 2) * (Wl // 2) * model_cfg.hidden_size
    offload = model.carry_offload

    def fwd_bwd(policy):
        model.cfg = dataclasses.replace(model_cfg, remat_policy=policy)
        model.zero_grad(set_to_none=True)
        offload.tensors_to_host = offload.bytes_to_host = 0
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.time()
        loss, _ = training_loss(model, sched, dev, height=h, width=w, num_frames=nf,
                                dtype=torch.bfloat16, t=t, noise=noise)
        loss.backward()
        torch.cuda.synchronize()
        seconds = time.time() - t0
        got = read_counters()
        require(got == want, (policy, got, want))
        return dict(seconds=seconds, peak=torch.cuda.max_memory_allocated(),
                    above=torch.cuda.max_memory_allocated() - held, held=held,
                    loss=float(loss.detach()), launches=got)

    rows, ref = {}, None
    for policy in REMAT_POLICIES:
        fwd_bwd(policy)  # warm-up: first calls at these shapes, pinned host buffers
        reps = [fwd_bwd(policy) for _ in range(REMAT_REPS)]
        seconds = sorted(r["seconds"] for r in reps)
        rows[policy] = dict(seconds_forward_backward_median=seconds[len(seconds) // 2],
                            seconds_min=seconds[0], seconds_max=seconds[-1],
                            repetitions=REMAT_REPS,
                            peak_memory_bytes=max(r["peak"] for r in reps),
                            peak_above_held_bytes=max(r["above"] for r in reps),
                            held_bytes=max(r["held"] for r in reps), loss=reps[0]["loss"],
                            launches=reps[0]["launches"])
        # the last repetition's grads, on the model
        grads = {n: p.grad for n, p in model.named_parameters()}
        if policy == "full":
            ref = {n: None if g is None else g.cpu() for n, g in grads.items()}
            del grads
            model.zero_grad(set_to_none=True)
            continue
        ref_dev = {n: None if g is None else g.cuda() for n, g in ref.items()}
        worst, with_grad, _ = compare_grads(torch, grads, ref_dev, fp32_ref=ref_dev)
        equal = sum(torch.equal(grads[n], ref_dev[n]) for n in ref if ref[n] is not None)
        del grads, ref_dev
        model.zero_grad(set_to_none=True)
        rows[policy].update(worst_err_over_limit=worst[0], worst_tensor=worst[1],
                            tensors=with_grad, bit_equal_tensors=equal,
                            loss_minus_full=rows[policy]["loss"] - rows["full"]["loss"])
        require(with_grad == sum(g is not None for g in ref.values()) == len(ref)
                and worst[0] <= 1.0, rows[policy])
        require(abs(rows[policy]["loss"] - rows["full"]["loss"])
                <= GRAD_BF16_RMS_LIMIT * abs(rows["full"]["loss"]), rows[policy])
        if policy == "offload_carry":
            # one carry a layer group, two (x and c) in the control depths
            n = model_cfg.depth + model_cfg.control_depth
            rows[policy].update(tensors_to_host=offload.tensors_to_host,
                                bytes_to_host=offload.bytes_to_host)
            require(offload.tensors_to_host == n
                    and offload.bytes_to_host == n * carry_numel * 2, rows[policy])
    emit("remat", model="MagicDriveSTDiT3-XL/2", config=TRAIN_CONFIG, batch=1,
         depth=list(REMAT_DEPTH),
         frames=nf, height=h, width=w, dtype="bfloat16 compute, float32 masters",
         policies=rows, grads_limit=f"per tensor rms(g - g_full) <= "
         f"2**{math.log2(GRAD_BF16_RMS_LIMIT):g} * rms(g_full)")
    del model, dev, ref
    gc.collect()
    torch.cuda.empty_cache()


def run_brushnet_train_app(torch):
    """The BrushNet train app on the tiny config, with and without ``--sde``, 2 steps
    each; its checkpoint read back into a model built from the config
    (``load_state_dict`` strict); the files are removed."""
    from magicdrive_v2_tpu_torch.config.config import Config
    from magicdrive_v2_tpu_torch.models.magicdrive.brushnet import (BrushNetConfig,
                                                                    MagicDriveSTDiT3BrushNet)
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
    from magicdrive_v2_tpu_torch.scripts import train_brushnet
    from magicdrive_v2_tpu_torch.utils.ckpt import load_checkpoint
    rows = {}
    cfg = Config.fromfile(BRUSH_TRAIN_APP_CONFIG)
    for sde in (False, True):
        out_dir = os.path.join("outputs", "chip_smoke_train_brushnet" + ("_sde" if sde else ""))
        shutil.rmtree(out_dir, ignore_errors=True)
        reset_counters()
        t0 = time.time()
        lines = train_brushnet.main([BRUSH_TRAIN_APP_CONFIG, "--synthetic", "--max-steps", "2",
                                     "--cfg-options", f"outputs={out_dir}"]
                                    + (["--sde"] if sde else []))
        seconds = time.time() - t0
        got = read_counters()
        require(all(v > 0 for v in got.values()), got)
        require([x["step"] for x in lines] == [1, 2]
                and all(math.isfinite(x["loss"]) for x in lines), lines)
        ckpt = os.path.join(out_dir, "global_step2")
        names = sorted(os.listdir(ckpt))
        require(names == ["ema.pt", "model.pt", "rng_state.json", "running_states.json"], names)
        model_cfg = BrushNetConfig.from_base(build_model_config(
            cfg.model, vae_out_channels=cfg.vae_out_channels, mv_order_map=cfg.mv_order_map,
            dtype=torch.float32), sde_inpaint=sde)
        model, ema = MagicDriveSTDiT3BrushNet(model_cfg), MagicDriveSTDiT3BrushNet(model_cfg)
        running = load_checkpoint(ckpt, model=model, ema=ema)  # strict load_state_dict
        require(running["step"] == 2, running)
        shutil.rmtree(out_dir, ignore_errors=True)
        rows["sde" if sde else "brushnet"] = dict(
            seconds=seconds, losses=[x["loss"] for x in lines],
            grad_norms=[x["grad_norm"] for x in lines], launches=got,
            checkpoint=names, reloaded_strict=True)
    emit("brushnet_train_app", config=BRUSH_TRAIN_APP_CONFIG, steps=[1, 2], runs=rows)


# the pedestrian phase's scene: a 6-camera rig at nuScenes' yaws (degrees, positive to
# the left of the front camera) and image size, f=1266, the principal point at the
# centre; 4 pedestrians over PED_FRAMES frames (1 s at 12 Hz)
PED_FRAMES, PED_H, PED_W, PED_FOCAL = 12, 900, 1600, 1266.0
PED_CAMERA_YAWS = (("CAM_FRONT", 0.0), ("CAM_FRONT_LEFT", 55.0), ("CAM_FRONT_RIGHT", -55.0),
                   ("CAM_BACK", 180.0), ("CAM_BACK_LEFT", 110.0), ("CAM_BACK_RIGHT", -110.0))
# (start, step a frame) of each pedestrian's centre, world frame = the front camera's
# axes (x right, y down, z ahead): two overlap in CAM_FRONT, one is seen by CAM_FRONT
# and CAM_FRONT_LEFT, one by CAM_BACK
PED_WALKS = {"front_near": ((-0.8, 0.1, 6.0), (0.1, 0.0, 0.0)),
             "front_far": ((0.6, 0.1, 8.5), (-0.1, 0.0, 0.0)),
             "front_left": ((-3.5, 0.1, 6.06), (0.05, 0.0, 0.02)),
             "back": ((2.39, 0.1, -6.58), (-0.05, 0.0, 0.0))}
MASK_IMAGES = 12  # JPEGs of phase extract_masks


def write_smpl_layout_model(path, seed):
    """A model in the SMPL pickle's v1.0 layout (v_template, f, shapedirs, posedirs,
    J_regressor, weights, kintree_table) at SMPL's sizes: the capsule template of 106
    rings x 65 segments (6890 vertices, 13,650 faces), 24 joints each regressed from
    12 vertices, each vertex skinned to 4 joints, 10 betas and 207 pose directions of
    seeded small values."""
    import pickle

    import numpy as np

    from magicdrive_v2_tpu_torch.pedestrian.processor import _capsule_body
    from magicdrive_v2_tpu_torch.pedestrian.smpl import (NUM_BETAS, NUM_JOINTS,
                                                         NUM_POSE_BASIS, SMPL_PARENTS)
    rng = np.random.default_rng(seed)
    v_template, faces = _capsule_body(106, 65)
    n = len(v_template)
    J_regressor = np.zeros((NUM_JOINTS, n))
    for j in range(NUM_JOINTS):
        J_regressor[j, rng.choice(n, 12, replace=False)] = 1.0 / 12
    weights = np.zeros((n, NUM_JOINTS))
    joints = np.argsort(rng.random((n, NUM_JOINTS)), axis=1)[:, :4]
    weights[np.arange(n)[:, None], joints] = rng.dirichlet(np.ones(4), n)
    kintree = np.stack([SMPL_PARENTS.astype(np.int64), np.arange(NUM_JOINTS)])
    kintree[0, 0] = 2 ** 32 - 1  # as the real file stores the root's parent
    model = dict(v_template=v_template.astype(np.float64), f=faces.astype(np.int64),
                 shapedirs=rng.standard_normal((n, 3, NUM_BETAS)) * 0.01,
                 posedirs=rng.standard_normal((n, 3, NUM_POSE_BASIS)) * 0.001,
                 J_regressor=J_regressor, weights=weights, kintree_table=kintree)
    with open(path, "wb") as f:
        pickle.dump(model, f, protocol=2)
    return n, len(faces)


def pedestrian_scene(torch, processor, n_frames=PED_FRAMES):
    """The synthetic scene of phase pedestrian, built as the app's
    ``build_synthetic_scene`` builds its own: each camera's image renders every
    pedestrian in front of it with the known texture (normalised template xyz) at
    identity rotation in that camera, z-merged, on ``processor``'s device; each frame
    lists every pedestrian's box (0.7 x 0.7 x the body's height, in the world frame).
    Returns (frames, gt_tex) with host images."""
    import numpy as np

    from magicdrive_v2_tpu_torch.utils.misc import to_host
    dev = processor.device
    tv = to_host(processor.body.v_template)
    gt_tex = (tv - tv.min(0)) / (np.ptp(tv, 0) + 1e-6)
    K = np.array([[PED_FOCAL, 0, PED_W / 2], [0, PED_FOCAL, PED_H / 2], [0, 0, 1]])
    K4 = np.eye(4)
    K4[:3, :3] = K
    c2ws = {}
    for name, yaw in PED_CAMERA_YAWS:
        a = math.radians(yaw)
        c2w = np.eye(4)
        c2w[:3, :3] = [[math.cos(a), 0, -math.sin(a)], [0, 1, 0], [math.sin(a), 0, math.cos(a)]]
        c2w[:3, 3] = 0.5 * c2w[:3, 2]  # on a ring of 0.5 m, looking out
        c2ws[name] = c2w
    frames = []
    for f in range(n_frames):
        at = {tok: np.asarray(start) + f * np.asarray(step)
              for tok, (start, step) in PED_WALKS.items()}
        frame = {"cams": {}, "peds": [], "timestamp": f / 12.0}
        for name, c2w in c2ws.items():
            w2c = np.linalg.inv(c2w)
            canvas = torch.zeros((PED_H, PED_W, 3), dtype=torch.uint8, device=dev)
            zbuf = torch.full((PED_H, PED_W), float("inf"), device=dev)
            for pos in at.values():
                pos_cam = (w2c @ np.append(pos, 1.0))[:3]
                if pos_cam[2] < 1.0:
                    continue
                u = PED_FOCAL * pos_cam[0] / pos_cam[2] + PED_W / 2
                v = PED_FOCAL * pos_cam[1] / pos_cam[2] + PED_H / 2
                size = PED_FOCAL * 2.0 / pos_cam[2] / 0.8
                if not (-size < u < PED_W + size and -size < v < PED_H + size):
                    continue
                s = 255.0 / size  # the region around it, as pass 2 frames a body
                tform = np.array([[s, 0, -(u - size / 2) * s], [0, s, -(v - size / 2) * s]])
                render, mask, depth = processor.render_colored_mesh(
                    dict(vertices=tv[None], cam_t=pos_cam[None], pos_cam=pos_cam,
                         crop_info={"tform": tform}), gt_tex, (PED_H, PED_W), intrinsics=K)
                closer = mask & (depth < zbuf)
                canvas = torch.where(closer[..., None], render, canvas)
                zbuf = torch.where(closer, depth, zbuf)
            frame["cams"][name] = dict(image=to_host(canvas), lidar2img=(K4 @ w2c)[:3],
                                       c2w=c2w, K=K)
        body_h = float(np.ptp(tv[:, 2]))
        for tok, pos in at.items():
            frame["peds"].append((np.array([*pos, 0.7, 0.7, body_h, 0.0]), tok, pos.copy()))
        frames.append(frame)
    return frames, gt_tex


@contextlib.contextmanager
def pedestrian_stage_seconds(torch, sync):
    """Seconds spent in each stage of ``run_scene`` (pass 1, smoothing, inpainting,
    pass 2), in the host rasterizer (both passes) and writing PNGs, summed over the
    calls made meanwhile; with ``sync`` the card is synchronised around each."""
    from magicdrive_v2_tpu_torch.pedestrian import processor as processor_module
    from magicdrive_v2_tpu_torch.scripts import pipeline_12hz as app
    points = ((app, "harvest_textures", "pass1"), (app, "smooth_poses", "smoothing"),
              (app, "inpaint_textures", "inpaint"), (app, "render_frames", "pass2"),
              (processor_module, "rasterize_mesh", "rasterizer"), (app, "_imwrite", "png_write"))
    seconds = {key: 0.0 for _, _, key in points}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in points]

    def timed(fn, key):
        def call(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            seconds[key] += time.perf_counter() - t0
            return out
        return call

    for (mod, name, key), (_, _, fn) in zip(points, saved):
        setattr(mod, name, timed(fn, key))
    try:
        yield seconds
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def read_pngs(directory):
    import numpy as np
    from PIL import Image
    out = {}
    for name in sorted(os.listdir(directory)):
        with Image.open(os.path.join(directory, name)) as im:
            out[name] = np.asarray(im)
    return out


def run_scene_timed(torch, processor, frames, out_dir):
    """``run_scene`` with its stages timed; (n, textures, PNG arrays, seconds)."""
    from magicdrive_v2_tpu_torch.scripts import pipeline_12hz
    sync = processor.device.type == "cuda"
    with pedestrian_stage_seconds(torch, sync) as seconds:
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        n, textures = pipeline_12hz.run_scene(processor, frames, out_dir)
        if sync:
            torch.cuda.synchronize()
        seconds = dict(seconds, run_scene=time.perf_counter() - t0)
    seconds["rasterizer_share"] = seconds["rasterizer"] / seconds["run_scene"]
    return n, textures, read_pngs(out_dir), seconds


def run_pedestrian(torch, seed, keep_renders=None):
    """Phase pedestrian: the SMPL pedestrian pipeline at full size on the card (see
    the module docstring); the scene is made on the card, the CPU run of the port is
    the reference. With ``keep_renders`` (a path) the first card run's PNG pairs are
    copied there (phase ped_video reads them)."""
    import numpy as np

    from magicdrive_v2_tpu_torch.pedestrian.smpl import make_real_processor
    root = tempfile.mkdtemp(prefix="chip_smoke_pedestrian_")
    try:
        model_path = os.path.join(root, "smpl_layout_v1.0.pkl")
        n_verts, n_faces = write_smpl_layout_model(model_path, seed)
        t0 = time.perf_counter()
        processor = make_real_processor(model_path, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        frames, gt_tex = pedestrian_scene(torch, processor)
        scene_s = time.perf_counter() - t0
        runs = []
        torch.cuda.reset_peak_memory_stats()
        before_gb = torch.cuda.memory_allocated() / 1e9  # the model, and earlier phases'
        for i in range(2):
            runs.append(run_scene_timed(torch, processor, frames, os.path.join(root, f"card{i}")))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n, textures, pngs, _ = runs[0]
        require(n > 0 and len(pngs) == 2 * n, (n, len(pngs)))
        require(sorted(textures) == sorted(PED_WALKS), sorted(textures))
        tex_err = {tok: float(np.abs(tex - gt_tex).mean()) for tok, tex in textures.items()}
        require(all(e < 0.25 for e in tex_err.values()), tex_err)
        mask_px = {k: int((v > 0).sum()) for k, v in pngs.items() if k.endswith("_mask.png")}
        require(all(px > 0 for px in mask_px.values()), mask_px)
        # a rerun on the card is bit-equal
        require(runs[1][0] == n and sorted(runs[1][2]) == sorted(pngs), runs[1][0])
        require(all(np.array_equal(textures[t], runs[1][1][t]) for t in textures), "textures")
        require(all(np.array_equal(pngs[k], runs[1][2][k]) for k in pngs), "rerun PNGs")
        # the port on the host: the same counts, textures within 1e-5, PNGs within
        # 0.1 % of pixels
        cpu_processor = make_real_processor(model_path, device="cpu")
        n_cpu, tex_cpu, pngs_cpu, cpu_seconds = run_scene_timed(
            torch, cpu_processor, frames, os.path.join(root, "cpu"))
        require(n_cpu == n and sorted(pngs_cpu) == sorted(pngs), (n_cpu, n))
        tex_diff = max(float(np.abs(textures[t] - tex_cpu[t]).max()) for t in textures)
        require(tex_diff <= 1e-5, tex_diff)
        px_diff = {}
        for k, v in pngs.items():
            differ = v != pngs_cpu[k]
            px_diff[k] = float((differ.any(-1) if differ.ndim == 3 else differ).mean())
        require(max(px_diff.values()) <= 1e-3, px_diff)
        if keep_renders is not None:
            shutil.copytree(os.path.join(root, "card0"), keep_renders)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("pedestrian", cameras=[c for c, _ in PED_CAMERA_YAWS], image_hw=[PED_H, PED_W],
         frames=PED_FRAMES, pedestrians=len(PED_WALKS), body=dict(vertices=n_verts,
                                                                  faces=n_faces, joints=24),
         pairs_written=n, texture_error_vs_gt=tex_err,
         mask_pixels=dict(masks=len(mask_px), least=min(mask_px.values()),
                          most=max(mask_px.values())),
         setup_s=setup_s, scene_build_s=scene_s,
         card_seconds=[r[3] for r in runs], cpu_seconds=cpu_seconds, peak_memory_gb=peak_gb,
         allocated_before_runs_gb=before_gb,
         rerun_bit_equal=True, cpu_vs_card=dict(texture_max_abs=tex_diff,
                                                pixels_differing_max=max(px_diff.values())))


def run_extract_masks(torch, seed):
    """Phase extract_masks: the stub backend over MASK_IMAGES JPEGs of 900x1600 (smooth
    random images, every camera), on the card and on the host: the PNGs equal; the
    SegFormer backends on a tiny local snapshot, card against host."""
    import numpy as np
    from PIL import Image

    from magicdrive_v2_tpu_torch.pedestrian.processor import SegformerSegmenter
    from magicdrive_v2_tpu_torch.tools import extract_masks
    root = tempfile.mkdtemp(prefix="chip_smoke_masks_")
    try:
        rng = np.random.default_rng(seed)
        for i in range(MASK_IMAGES):
            cam_dir = os.path.join(root, "data", "samples", extract_masks.CAMS[i % 6])
            os.makedirs(cam_dir, exist_ok=True)
            coarse = Image.fromarray(rng.integers(0, 256, (9, 16, 3), np.uint8))
            coarse.resize((PED_W, PED_H), Image.BILINEAR).save(
                os.path.join(cam_dir, f"frame{i:02d}.jpg"), quality=90)
        seconds, masks = {}, {}
        for device in ("cuda", "cpu"):
            out = os.path.join(root, device)
            t0 = time.perf_counter()
            n = extract_masks.extract(os.path.join(root, "data"), out,
                                      extract_masks.StubBackend(device))
            seconds[device] = time.perf_counter() - t0
            require(n == MASK_IMAGES, n)
            masks[device] = {os.path.relpath(os.path.join(d, f), out): read_pngs(d)[f]
                             for d, _, fs in os.walk(out) for f in fs}
        require(sorted(masks["cuda"]) == sorted(masks["cpu"])
                and len(masks["cuda"]) == 2 * MASK_IMAGES, sorted(masks["cuda"]))
        require(all(np.array_equal(masks["cuda"][k], masks["cpu"][k]) for k in masks["cpu"]),
                "masks differ between the card and the host")
        share = {g: float(np.mean([(v > 0).mean() for k, v in masks["cuda"].items()
                                   if k.startswith(g)])) for g in extract_masks.GROUPS}
        require(all(0 < s < 1 for s in share.values()), share)
        # the transformers backends on this machine's transformers: a tiny seeded
        # SegFormer written locally, one image, the card against the host in fp32
        snapshot = os.path.join(root, "segformer")
        write_tiny_segformer(torch, snapshot, seed)
        with Image.open(os.path.join(root, "data", "samples", extract_masks.CAMS[0],
                                     "frame00.jpg")) as im:
            rgb = np.asarray(im.convert("RGB"))
        agree = {}
        with no_tf32(torch):
            for name, make in (("transformers_backend", extract_masks.TransformersBackend),
                               ("segformer_segmenter", SegformerSegmenter)):
                image = rgb if name == "transformers_backend" else rgb[:, :, ::-1]
                got = {d: make(snapshot, device=d)(image).cpu().numpy() for d in ("cuda", "cpu")}
                require(got["cuda"].shape == (PED_H, PED_W), got["cuda"].shape)
                agree[name] = float((got["cuda"] == got["cpu"]).mean())
        require(min(agree.values()) >= 0.999, agree)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("extract_masks", backend="stub", images=MASK_IMAGES, image_hw=[PED_H, PED_W],
         card_s=seconds["cuda"], cpu_s=seconds["cpu"], mask_share=share, equal=True,
         tiny_segformer_card_vs_cpu=agree)


def write_tiny_segformer(torch, path, seed):
    """A SegFormer of the cityscapes head (19 classes), two tiny stages, seeded random
    weights, written with ``save_pretrained``, beside a preprocessor config in the
    published cityscapes snapshots' layout (512x512 input): nothing is downloaded."""
    from transformers import SegformerConfig, SegformerForSemanticSegmentation
    torch.manual_seed(seed)
    cfg = SegformerConfig(num_labels=19, num_encoder_blocks=2, depths=[1, 1],
                          sr_ratios=[2, 1], hidden_sizes=[16, 32], num_attention_heads=[1, 2],
                          patch_sizes=[7, 3], strides=[4, 2], mlp_ratios=[2, 2],
                          decoder_hidden_size=32)
    SegformerForSemanticSegmentation(cfg).eval().save_pretrained(path)
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump(dict(do_normalize=True, do_resize=True, resample=2, size=512,
                       image_mean=[0.485, 0.456, 0.406], image_std=[0.229, 0.224, 0.225],
                       feature_extractor_type="SegformerFeatureExtractor",
                       reduce_labels=False), f)


# ---------------------------------------------------------------------------
# phases 24-27: the pedestrian videos into the apps, and the measurement tools
# ---------------------------------------------------------------------------

PED_VIDEO_FRAMES = APP_FRAMES    # frames of the W-CODA run on the rendered pedestrians
PED_VIDEO_STEPS = 1
# a view read back against the frames written (sound reads on an H100's machine: 0.05-0.14
# levels a view, 0.06-0.07 of the view's mean level, masks equal on every pixel; the
# renders are 97-99 % black, 0.7-2.3 levels a view on average, so an all-black read
# misses by 0.7 levels or more, and the pedestrians cover < 1 % of the pixels)
PED_VIDEO_RGB_LIMIT = 0.5        # mean abs error of a view, levels of 255
PED_VIDEO_RGB_SHARE = 0.2        # ... and of a view with content, over its mean level
PED_VIDEO_MASK_IOU = 0.99        # a view's mask read back over the one written
# levels of 255 within which two views' mean colours count as one colour (the
# renders are pedestrians on black, 0.7-2.3 levels a view on average; a view's mean
# reads back within ~0.02)
PED_VIDEO_SAME_COLOUR = 0.25
PLAN_MEMORY_CASES = ((2, 1), (1, 2))  # (dp, sp) of phase plan_memory
# its depth and control depth (cut from 7 / 4 to keep the script in time)
PLAN_MEMORY_DEPTH = (4, 2)
PLAN_MEMORY_DEADLINE_S = 600


def ped_video_layout(torch, renders, root):
    """The pipeline's flat ``<stem>.png`` / ``<stem>_mask.png`` renders (900x1600, a
    pair only where a camera saw a pedestrian) laid out as ``create_video_12hz``
    reads them: ``root/rgb/<CAM>/fNNNNN.png`` and ``root/mask/<CAM>/...`` at 424x800
    (PIL bicubic for RGB, nearest for masks), a black frame where a camera saw none.
    Returns (rgb (NC, T, H, W, 3), mask (NC, T, H, W) uint8) as written."""
    import numpy as np
    from PIL import Image

    from magicdrive_v2_tpu_torch.utils.video import CAMS
    rgb = np.zeros((6, PED_FRAMES, HEIGHT, WIDTH, 3), np.uint8)
    mask = np.zeros((6, PED_FRAMES, HEIGHT, WIDTH), np.uint8)
    for ci, cam in enumerate(CAMS):
        for kind in ("rgb", "mask"):
            os.makedirs(os.path.join(root, kind, cam), exist_ok=True)
        for f in range(PED_FRAMES):
            stem = os.path.join(renders, f"frame{f:04d}_{cam}")
            if os.path.isfile(stem + ".png"):
                with Image.open(stem + ".png") as im:
                    rgb[ci, f] = np.asarray(im.convert("RGB").resize((WIDTH, HEIGHT),
                                                                     Image.BICUBIC))
                with Image.open(stem + "_mask.png") as im:
                    mask[ci, f] = np.asarray(im.convert("L").resize((WIDTH, HEIGHT),
                                                                    Image.NEAREST))
            Image.fromarray(rgb[ci, f]).save(os.path.join(root, "rgb", cam, f"f{f:05d}.png"))
            Image.fromarray(mask[ci, f]).save(os.path.join(root, "mask", cam, f"f{f:05d}.png"))
    return rgb, mask


def held_against_written(views, rgb, mask):
    """Views read back by a loader ((NC, 3, T, H, W) in [-1, 1] and (NC, 1, T, H, W)
    0/1) against the frames written: each view's mean abs error in levels and over
    its written mean level, each view's mean colour per channel (written, read),
    each view's mask IoU (read against written, 1 where both are empty). Requires
    each view within PED_VIDEO_RGB_LIMIT, each view with content within
    PED_VIDEO_RGB_SHARE of its mean level, each mask IoU at PED_VIDEO_MASK_IOU or
    more, pedestrians read back in exactly the views they were written to (one or
    more), and each view's mean colour nearer its own written view's than any
    written view of another colour (no view swapped; views of one colour, such as
    black ones where a camera saw no pedestrian, cannot be told apart)."""
    import numpy as np
    imgs, masks = views
    t = imgs.shape[2]
    got = np.rint((imgs.transpose(0, 2, 3, 4, 1) + 1) * 127.5)  # (NC, T, H, W, 3)
    want = rgb[:, :t].astype(np.float64)
    err = np.abs(got - want).mean(axis=(1, 2, 3, 4))
    level = want.mean(axis=(1, 2, 3, 4))
    mean_got, mean_want = got.mean(axis=(1, 2, 3)), want.mean(axis=(1, 2, 3))
    m_got, m_want = masks[:, 0] > 0.5, mask[:, :t] > 127
    inter = (m_got & m_want).sum(axis=(1, 2, 3))
    union = (m_got | m_want).sum(axis=(1, 2, 3))
    iou = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
    with_ped = [v for v in range(len(err)) if m_want[v].any()]
    require(bool((err <= PED_VIDEO_RGB_LIMIT).all()), ("rgb error", err))
    require(all(err[v] <= PED_VIDEO_RGB_SHARE * level[v] for v in range(len(err))
                if level[v] > 0), ("rgb error over the view's level", err, level))
    require(bool((iou >= PED_VIDEO_MASK_IOU).all()), ("mask IoU", iou))
    require(len(with_ped) > 0 and with_ped == [v for v in range(len(err)) if m_got[v].any()],
            ("views with a pedestrian", with_ped))
    distinct = 0
    for v in range(len(err)):  # the written view nearest in mean colour has v's colour
        near = int(np.abs(mean_want - mean_got[v]).max(axis=1).argmin())
        require(np.abs(mean_want[near] - mean_want[v]).max() <= PED_VIDEO_SAME_COLOUR,
                ("view swapped", v, near))
        distinct += all(np.abs(mean_want[w] - mean_want[v]).max() > PED_VIDEO_SAME_COLOUR
                        for w in range(len(err)) if w != v)
    return dict(mean_abs_err_levels=err.tolist(), view_mean_levels=level.tolist(),
                mask_iou=iou.tolist(), mask_pixels_written=m_want.sum(axis=(1, 2, 3)).tolist(),
                views_with_pedestrians=with_ped, mean_rgb_written=mean_want.tolist(),
                mean_rgb_read=mean_got.tolist(), views_told_apart=distinct)


@contextlib.contextmanager
def recorded_inpaint_inputs(record):
    """Note the x_inpaint / mask_inpaint (host numpy) of every
    ``MagicDrivePipeline.sample`` call, and whether the video it returned is
    finite."""
    import numpy as np
    from magicdrive_v2_tpu_torch.pipelines import magicdrive as pipelines
    real = pipelines.MagicDrivePipeline.sample

    def sample(self, batch, *args, **kw):
        out = real(self, batch, *args, **kw)
        record.append(dict(x_inpaint=np.array(batch["x_inpaint"]),
                           mask_inpaint=np.array(batch["mask_inpaint"]),
                           finite=bool(out.isfinite().all()), shape=list(out.shape)))
        return out

    pipelines.MagicDrivePipeline.sample = sample
    try:
        yield record
    finally:
        pipelines.MagicDrivePipeline.sample = real


def run_ped_video(torch, renders, sde_per_forward, encode_launches, held, before_app=None):
    """Phase ped_video (see the module docstring): the pedestrian renders of phase
    pedestrian into the two video layouts through the port's tools, read back by the
    apps' loaders and held against the frames written, then (after ``before_app()``,
    where given) the W-CODA app with ``--sde --ped-video-dir`` at full width on
    them. Returns its launches."""
    from magicdrive_v2_tpu_torch.scripts import test_magicdrive
    from magicdrive_v2_tpu_torch.scripts.inference_magicdrive_brushnet import (
        inpaint_batch_inputs, load_pedestrian_inputs)
    from magicdrive_v2_tpu_torch.tools import create_video_12hz, img_folder2vid
    from magicdrive_v2_tpu_torch.utils import video
    from magicdrive_v2_tpu_torch.utils.inference_utils import read_png
    t_phase = time.time()
    backend = video.backend_report()
    require(backend["ffmpeg"], backend)
    root = tempfile.mkdtemp(prefix="chip_smoke_ped_video_")
    out_dir = os.path.join("outputs", "chip_smoke_ped_video")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        t0 = time.time()
        rgb, mask = ped_video_layout(torch, renders, os.path.join(root, "layout"))
        grid_dir, cam_dir = os.path.join(root, "grid", "0"), os.path.join(root, "cams")
        made = [create_video_12hz.grid_video(os.path.join(root, "layout", "rgb"),
                                             os.path.join(grid_dir, "videos.mp4")),
                create_video_12hz.grid_video(os.path.join(root, "layout", "mask"),
                                             os.path.join(grid_dir, "masks.mp4"))]
        for cam in video.CAMS:
            made.append(img_folder2vid.folder_to_video(
                os.path.join(root, "layout", "rgb", cam), os.path.join(cam_dir, f"{cam}.mp4")))
            made.append(img_folder2vid.folder_to_video(
                os.path.join(root, "layout", "mask", cam),
                os.path.join(cam_dir, f"{cam}_mask.mp4")))
        require(all(n == PED_FRAMES for _, n in made), made)
        write_s = time.time() - t0
        t0 = time.time()
        grid = (test_magicdrive.load_grid_video(os.path.join(grid_dir, "videos.mp4"),
                                                PED_FRAMES, HEIGHT, WIDTH),
                test_magicdrive.load_grid_video(os.path.join(grid_dir, "masks.mp4"),
                                                PED_FRAMES, HEIGHT, WIDTH, grayscale=True))
        cams = load_pedestrian_inputs(cam_dir, PED_FRAMES, HEIGHT, WIDTH)
        read_s = time.time() - t0
        held_grid = held_against_written(grid, rgb, mask)
        held_cams = held_against_written(cams, rgb, mask)
        files_s = time.time() - t_phase
        t0 = time.time()
        if before_app is not None:
            before_app()
        waited_s = time.time() - t0
        free_gb_at_app = torch.cuda.mem_get_info()[0] / 1e9
        # the W-CODA app on the grid videos: synthetic conditioning, sample index 0
        config = os.path.join(root, "ped_video_config.py")
        write_config(config, {
            "_base_": os.path.abspath(BRUSHNET_CONFIG), "num_frames": PED_VIDEO_FRAMES,
            "outputs": out_dir, "save_mode": "all-in-one", "post": WCODA_POST,
            "scheduler": {"num_sampling_steps": PED_VIDEO_STEPS}})
        record, seen = [], no_shapes()
        reset_counters()
        t0 = time.time()
        with recorded_inpaint_inputs(record), recorded_shapes(seen):
            saved = test_magicdrive.main([config, "--synthetic", "--num-samples", "1", "--sde",
                                          "--ped-video-dir", os.path.dirname(grid_dir)])
        app_s = time.time() - t0
        got = read_counters()
        from magicdrive_v2_tpu_torch.config.config import Config
        passes = 2 if "slice" in Config.fromfile(config).scheduler.type else 1
        want = {k: passes * (sde_per_forward[k] * PED_VIDEO_STEPS + encode_launches[k])
                for k in sde_per_forward}
        require(got == want, (got, want))
        # the model was given the loader's arrays, bit for bit
        x_want, m_want = inpaint_batch_inputs(
            *(a[:, :, :PED_VIDEO_FRAMES] for a in grid))
        require(len(record) == 1 and record[0]["finite"], [r["finite"] for r in record])
        require((record[0]["x_inpaint"] == x_want).all()
                and (record[0]["mask_inpaint"] == m_want).all(), "inpaint inputs")
        cut = WCODA_POST["cut_length"]
        require(len(saved) == 1, len(saved))
        path, frames = saved[0]
        names = sorted(os.listdir(path))
        require(names == [f"{i:04d}.png" for i in range(cut)], names)
        for i, name in enumerate(names):
            require(bool((read_png(os.path.join(path, name)) == frames[i]).all()), name)
        require(float(frames.std()) > 1.0, "constant frames")
        cases = held.hold(seen, "ped_video")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    emit("ped_video", cv2=backend, renders_hw=[PED_H, PED_W], video_hw=[HEIGHT, WIDTH],
         frames=PED_FRAMES, videos=len(made), codec=video.FOURCC,
         h264_read="not run: this machine's OpenCV encodes no H.264, so no H.264 file can "
                   "be made here",
         grid_vs_written=held_grid, cameras_vs_written=held_cams,
         app=dict(config=BRUSHNET_CONFIG, argv=["--synthetic", "--sde", "--ped-video-dir"],
                  frames=PED_VIDEO_FRAMES, steps=PED_VIDEO_STEPS, seconds=app_s,
                  frame_shape=list(frames.shape[1:]), video_shape=record[0]["shape"],
                  inpaint_inputs_equal_loader=True),
         kernel_cases=len(cases), launches=got, write_videos_s=write_s,
         read_videos_s=read_s, files_s=files_s, free_gb_at_app=free_gb_at_app,
         seconds=time.time() - t_phase - waited_s, waited_for_plan_memory_s=waited_s)
    return got


def run_kernel_bench(torch, seed):
    """Phase kernel_bench: ``tools/kernel_bench`` at its shape (K1 at G=60, N=1350,
    H=16, D=72, bf16, J=1 and J=2): the kernel, the plain version and SDPA, chained
    ms; the kernel held against the plain version on the tool's inputs within the
    limits of ``compare``."""
    from magicdrive_v2_tpu_torch.tools import kernel_bench as kb
    t0 = time.time()
    rows = kb.bench("cuda", seed=seed)
    require({(r["route"], r["J"]) for r in rows}
            == {(route, J) for route in kb.ROUTES for J in (1, 2)}, rows)
    require(all(r["kernel_launches"] == (kb.LOOP + 1 if r["route"] == "kernel" else 0)
                for r in rows), rows)
    checks = []
    for case in kb.kernel_cases(seed=seed):
        err, ratio, rms_ratio, _ = compare(torch, case["kernel"], case["plain"],
                                           2.0 ** -7 * case["abs_v"].float())
        require(ratio <= 1.0 and rms_ratio <= 1.0, (case["J"], err, ratio, rms_ratio))
        checks.append(dict(J=case["J"], max_abs_err=err, err_over_limit=ratio,
                           rms_err_over_limit=rms_ratio))
    ms = {(r["route"], r["J"]): r["ms"] for r in rows}
    emit("kernel_bench", shape=kb.SHAPE, loop=kb.LOOP, rows=rows, kernel_vs_plain=checks,
         kernel_over_sdpa={J: ms[("kernel", J)] / ms[("sdpa", J)] for J in (1, 2)},
         seconds=time.time() - t0)
    torch.cuda.empty_cache()


PERF_LAB_CHAINED = 2
PERF_LAB_SLACK = 0.02  # the profiled step's device time over the timed step's


def run_perf_lab(torch, seed, per_forward):
    """Phase perf_lab: ``tools/perf_lab`` ``time`` at ``chained`` PERF_LAB_CHAINED on
    its step (XL/2 bf16, 6 x 424x800 x 17, batched CFG), then ``profile`` of one
    chained call of 1 step and ``report`` of its trace: the three kernels among its
    entries by their CUDA names (their places by device time), the summed device time within the timed step's
    (PERF_LAB_SLACK), the device's busy share of the step. Returns the launches of
    one timed call."""
    from magicdrive_v2_tpu_torch.tools import perf_lab
    t0 = time.time()
    step = perf_lab.build_step(PERF_LAB_CHAINED, seed=seed)
    step.encode()
    reset_counters()
    out = step()
    torch.cuda.synchronize()
    launches = read_counters()
    want = {k: PERF_LAB_CHAINED * per_forward[k] for k in per_forward}
    require(launches == want, (launches, want))
    require(bool(out.isfinite().all()) and out.shape == step.z.shape, "perf_lab step output")
    del out
    timed = perf_lab.time_step(step, calls=3, warm=False)
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_perf_lab_")
    try:
        step.chained = 1
        t1 = time.time()
        path = perf_lab.trace(step, trace_dir, "profile", warm=False)
        trace_s = time.time() - t1
        trace_mb = os.path.getsize(path) / 1e6
        rep = perf_lab.report(trace_dir, top=None)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    # each kernel's place among the entries by device time (K1 is its two launches)
    names = [r["name"] for r in rep["top"]]
    found = {k: next((i for i, n in enumerate(names) if k in n), None)
             for k in ("k1_attention", "k1_tile_k", "adaln_rows", "k3_")}
    require(all(i is not None for i in found.values()), (found, names[:40]))
    step_ms = timed["p50_s"] * 1e3
    require(rep["total_ms"] <= step_ms * (1 + PERF_LAB_SLACK), (rep["total_ms"], step_ms))
    emit("perf_lab", command="time", chained=PERF_LAB_CHAINED, time=timed,
         report=dict(total_device_ms=rep["total_ms"], span_ms=rep["span_ms"],
                     events=rep["events"], entries=len(names), top=rep["top"][:15]),
         device_busy_share=rep["total_ms"] / step_ms, kernel_places=found,
         trace_s=trace_s, trace_mb=trace_mb, launches=launches, seconds=time.time() - t0)
    del step
    torch.cuda.empty_cache()
    return launches


def plan_memory_split_bytes(torch, dp, depth):
    """The bytes a rank holds of the fp32 masters under ``parallel.fsdp``'s split
    over ``dp`` (a split parameter's block, the others whole) and of the buffers
    (whole), for XL/2 at ``depth`` (depth, control depth), counted on the meta
    device."""
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
    from magicdrive_v2_tpu_torch.parallel.fsdp import param_spec
    from magicdrive_v2_tpu_torch.tools.perf_lab import flagship_config
    with torch.device("meta"):
        model = MagicDriveSTDiT3(flagship_config(torch.bfloat16, depth=depth[0],
                                                 control_depth=depth[1]))
    params = sum(p.numel() * 4 // (dp if param_spec(tuple(p.shape), dp) is not None else 1)
                 for p in model.parameters())
    return params, sum(b.numel() * b.element_size() for b in model.buffers())


def plan_memory_args(case):
    from magicdrive_v2_tpu_torch.tools import plan_memory
    dp, sp = case
    return plan_memory.parse_args([
        "--dp", str(dp), "--sp", str(sp), "--depth", str(PLAN_MEMORY_DEPTH[0]),
        "--control-depth", str(PLAN_MEMORY_DEPTH[1]), "--remat", "full",
        "--deadline", str(PLAN_MEMORY_DEADLINE_S)])


def start_plan_memory(torch, root):
    """Phase plan_memory's ranks, started now, every case's at once: each imports
    and then waits for its case's file ``root/go_<dp>_<sp>`` before it joins its
    group and touches the card (this script's --plan-memory-worker). A thread lets
    the cases run one after the other (their peaks together would not fit the card)
    while this process goes on with other phases. Returns the run for
    ``run_plan_memory``; ``close_plan_memory`` ends whatever still runs."""
    from magicdrive_v2_tpu_torch.parallel.distributed import RankGroup
    from magicdrive_v2_tpu_torch.tools import plan_memory
    gc.collect()
    torch.cuda.empty_cache()  # this process's cache back to the card for the ranks
    run = dict(groups={}, outs={}, errors=[], t0=time.time())
    try:
        for case in PLAN_MEMORY_CASES:
            args = plan_memory_args(case)
            env, local_ranks, backend = plan_memory.launch_plan(args)
            go = os.path.join(root, "go_%d_%d" % case)
            # two host threads a rank: the phases beside them keep the host's cores
            env = dict(env, MDV2_START_FILE=go, OMP_NUM_THREADS="2",
                       MDV2_PLAN_ARGV=json.dumps(plan_memory.rank_argv(args)))
            run["groups"][case] = (RankGroup(args.dp * args.sp,
                                             [os.path.abspath(__file__),
                                              "--plan-memory-worker"],
                                             PLAN_MEMORY_DEADLINE_S, env=env,
                                             local_ranks=local_ranks), backend, go)
    except BaseException:
        close_plan_memory(run)
        raise

    def cases_in_turn():
        try:
            for case in PLAN_MEMORY_CASES:
                group, _, go = run["groups"][case]
                open(go, "w").close()
                run["outs"][case] = group.wait()
        except BaseException as e:  # noqa: BLE001 -- raised again by run_plan_memory
            run["errors"].append(e)

    run["thread"] = threading.Thread(target=cases_in_turn, daemon=True)
    run["thread"].start()
    return run


def close_plan_memory(run):
    for group, _, _ in run["groups"].values():
        group.close()


def plan_memory_worker():
    """One rank of phase plan_memory: imports the tool, waits for its case's start
    file, then runs ``tools/plan_memory``'s rank worker on MDV2_PLAN_ARGV."""
    from magicdrive_v2_tpu_torch.tools import perf_lab, plan_memory  # noqa: F401
    await_go(PLAN_MEMORY_DEADLINE_S, "MDV2_START_FILE")
    return plan_memory.main(json.loads(os.environ["MDV2_PLAN_ARGV"]) + ["--rank-worker"])


def run_plan_memory(torch, run, beside):
    """Phase plan_memory: ``tools/plan_memory`` at full width, 6 x 424x800 x 17, depth
    PLAN_MEMORY_DEPTH, remat full, on (dp, sp) = PLAN_MEMORY_CASES (the ranks of
    ``start_plan_memory``, each case's sharing the card over gloo, the phases
    ``beside`` running meanwhile in this process): waits for them; each rank's
    parameter and buffer bytes equal what the fsdp split gives it, finite loss and
    grad norm equal on every rank, the peaks."""
    from magicdrive_v2_tpu_torch.tools import plan_memory
    t0 = time.time()
    run["thread"].join(PLAN_MEMORY_DEADLINE_S)
    require(not run["thread"].is_alive(), "plan_memory's ranks outlived their deadline")
    if run["errors"]:
        raise run["errors"][0]
    wait_s = time.time() - t0
    results = {}
    for case in PLAN_MEMORY_CASES:
        _, backend, _ = run["groups"][case]
        results[case] = plan_memory.summarise(plan_memory_args(case), run["outs"][case],
                                              backend)
    rows = {}
    for (dp, sp), res in results.items():
        params, buffers = plan_memory_split_bytes(torch, dp, PLAN_MEMORY_DEPTH)
        for r in res["ranks"]:
            require((r["param_bytes"], r["buffer_bytes"]) == (params, buffers),
                    (dp, sp, r, params, buffers))
            require(r["finite"] and r["peak_bytes"] > 0, r)
        require(len({(r["loss"], r["grad_norm"]) for r in res["ranks"]}) == 1, res["ranks"])
        rows[f"dp{dp}_sp{sp}"] = {k: v for k, v in res.items() if k != "ranks"}
        rows[f"dp{dp}_sp{sp}"]["ranks"] = [
            {k: r[k] for k in ("rank", "param_bytes", "buffer_bytes", "batch_bytes",
                               "peak_bytes", "step_s", "loss", "grad_norm")}
            for r in res["ranks"]]
    emit("plan_memory", depth=list(PLAN_MEMORY_DEPTH), shape=[NUM_FRAMES, HEIGHT, WIDTH],
         plans=rows, beside=list(beside), seconds=time.time() - run["t0"], wait_s=wait_s)



def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--requests", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one Euler step, one view's decode and one train "
                         "step with torch.profiler")
    ap.add_argument("--sp-rank-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sp-train-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-train-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dp-app-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--plan-memory-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one "
              "NVIDIA GPU and does not fall back to the CPU", file=sys.stderr)
        return 1
    if args.sp_rank_worker:  # one rank of phase sp_ranks, started by that phase
        return sp_rank_worker(torch, args.sp_rank_worker, args.seed)
    if args.sp_train_worker:  # one rank of phase sp_train, started by that phase
        return sp_train_worker(torch, args.sp_train_worker, args.seed)
    if args.dp_train_worker:  # one rank of phase dp_train
        return dp_train_worker(torch, args.dp_train_worker, args.seed)
    if args.dp_app_worker:  # one rank of phase dp_app
        return dp_app_worker(torch, args.dp_app_worker)
    if args.plan_memory_worker:  # one rank of phase plan_memory
        return plan_memory_worker()
    t_start = time.time()
    from magicdrive_v2_tpu_torch.ops import _cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    # the optional packages import while nvcc builds the kernels
    packages = {}
    probe = threading.Thread(target=lambda: packages.update(optional_packages()))
    probe.start()
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
    # the backward kernels, bf16 and fp32: K1's and K3's (attn_bwd_sm90.cuh, built into
    # both libraries at their head dims) and K2's
    bwd_bodies = {name: [r for r in _cuda_build.ptxas_report(name)
                         if "attn_bwd_" in r["function"] or "adaln_bwd_" in r["function"]]
                  for name in _cuda_build.SOURCES}
    require([len(v) for v in bwd_bodies.values()] == [19, 17, 2] and all(
        r["spill_stores"] == 0 and r["spill_loads"] == 0
        for v in bwd_bodies.values() for r in v), bwd_bodies)
    from magicdrive_v2_tpu_torch import native
    fill = native.library_path()
    probe.join()
    emit("device", nvidia_smi=smi, python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, build_seconds=_cuda_build.build_seconds,
         k1_ptxas=k1_bodies, k3_ptxas=k3_bodies, backward_ptxas=bwd_bodies,
         optional_packages=packages,
         polygon_fill=dict(kind="native", library=fill,
                           committed_library=fill == str(native.COMMITTED)))

    pipe, cond, per_forward, encode_launches, l_cond, seen = build_slice(
        torch, args.steps, args.seed)
    # condition tokens per frame: ego-motion + camera + caption + boxes
    require(l_cond == 1 + 1 + pipe.model.cfg.model_max_length + L_BOX, l_cond)
    kernel_numbers, held = check_kernels(torch, seen, l_cond)
    launches = run_slice(torch, pipe, cond, per_forward, encode_launches, l_cond,
                         args.steps, args.requests, args.profile)
    del pipe
    torch.cuda.empty_cache()
    run_slice_vs_plain(torch, args.seed)
    block_bench_launches = run_block_bench(torch, args.seed)
    # sp_ranks' processes import and join while sp848 reruns its sample (after its
    # timed one, which they would slow)
    sp_dir, sp_ranks = tempfile.mkdtemp(prefix="chip_smoke_sp_ranks_"), []
    try:
        sp848_launches = run_sp848(
            torch, args.seed, per_forward, encode_launches, l_cond,
            after_timed=lambda: sp_ranks.extend(start_sp_ranks(SP_RANKS, sp_dir, args.seed)))
        sp_ranks_launches = run_sp_ranks(torch, args.seed, encode_launches, held,
                                         started=(sp_dir, *sp_ranks))
    finally:
        if sp_ranks:
            sp_ranks[0].close()
        shutil.rmtree(sp_dir, ignore_errors=True)
    seen_train = run_grads(torch, args.seed, held)
    train_launches, train_backwards, backward_rows, synthetic_s_step = run_train(
        torch, args.seed, seen_train, encode_launches, with_profile=args.profile)
    run_train_app(torch)
    torch.cuda.empty_cache()
    sp_train_launches = run_sp_train(torch, args.seed, encode_launches, held)
    stage3_launches = run_stage3_app(torch, encode_launches)
    torch.cuda.empty_cache()
    stage1_launches, stage1_k1_rows, stage1_k2_backward = run_stage1(torch, held, args.seed)
    dp_train_launches = run_dp_train(torch, args.seed, encode_launches, held)
    # dp_app's two ranks need much of the card (~58 GB at full depth): this process
    # gives back what its allocator still holds from dp_train's references (a rank ran
    # out of memory beside ~20 GB of it on an H100 80GB HBM3)
    gc.collect()
    torch.cuda.empty_cache()
    dp_app_launches = run_dp_app(torch, encode_launches)
    torch.cuda.empty_cache()
    run_decode_vs_cpu(torch, args.seed)
    torch.cuda.empty_cache()
    run_app(torch, per_forward, encode_launches)
    run_brushnet_vs_plain(torch, args.seed)
    brushnet_launches = run_brushnet(torch, args.seed, encode_launches)
    repaint_launches = run_repaint(torch, args.seed, per_forward, encode_launches)
    sde_per_forward = expected_launches(brushnet_config(torch, torch.bfloat16))
    run_brushnet_apps(torch, sde_per_forward, per_forward, encode_launches)
    run_brushnet_grads(torch, args.seed, encode_launches)
    brushnet_train_launches = run_brushnet_train(torch, args.seed, encode_launches)
    run_remat(torch, args.seed, encode_launches)
    run_brushnet_train_app(torch)
    data_root = tempfile.mkdtemp(prefix="chip_smoke_nuscenes_")
    try:
        ann = run_dataset(torch, data_root)
        torch.cuda.empty_cache()
        test_app_launches = run_test_app(torch, per_forward, encode_launches, ann, data_root)
        torch.cuda.empty_cache()
        brushnet_test_app_launches = run_test_app(
            torch, sde_per_forward, encode_launches, ann, data_root,
            base_config=BRUSHNET_CONFIG, extra_argv=("--sde",), phase="brushnet_test_app")
        torch.cuda.empty_cache()
        train_data_launches = run_train_data(torch, encode_launches, ann, data_root,
                                             synthetic_s_step)
        torch.cuda.empty_cache()
        seen848 = no_shapes()
        app848_launches = run_test_app(
            torch, per_forward, encode_launches, ann, data_root, base_config=APP848_CONFIG,
            phase="app848", data_yaml=DATA_YAML_848, save_mode="image_filename",
            seen=seen848, frames=APP848_FRAMES)
        emit("app848_kernel_cases", cases=held.hold(seen848, "app848"))
        inpaint848_launches = run_app848_inpainting(torch, encode_launches, ann, data_root,
                                                    held)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    sde848_65f_launches = run_sde848_65f(torch, args.seed, encode_launches, held)
    # plan_memory's ranks run beside pedestrian, extract_masks and ped_video's video
    # files (host work and small launches), and end before ped_video's full-depth app
    work = tempfile.mkdtemp(prefix="chip_smoke_ped_plan_")
    renders = os.path.join(work, "card0")
    plan_run = start_plan_memory(torch, work)
    try:
        run_pedestrian(torch, args.seed, keep_renders=renders)
        run_extract_masks(torch, args.seed)
        ped_video_launches = run_ped_video(
            torch, renders, sde_per_forward, encode_launches, held,
            before_app=lambda: run_plan_memory(
                torch, plan_run, beside=("pedestrian", "extract_masks", "ped_video files")))
    finally:
        close_plan_memory(plan_run)
        shutil.rmtree(work, ignore_errors=True)
    run_kernel_bench(torch, args.seed)
    perf_lab_launches = run_perf_lab(torch, args.seed, per_forward)
    for name, worst in held.worst.items():  # over every case held, later paths' too
        kernel_numbers[name]["max_abs_err"] = worst
    kernel_numbers["fused_qkv_attention"]["stage1_n350"] = stage1_k1_rows

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
    kernels = [dict(name=name, route="cuda", launches=launches[name],
                    launches_by_path={"sample": launches[name],
                                      "train_step": train_launches[name],
                                      "test_app": test_app_launches[name],
                                      "train_step_on_data": train_data_launches[name],
                                      "brushnet_sample": brushnet_launches[name],
                                      "repaint": repaint_launches[name],
                                      "brushnet_test_app": brushnet_test_app_launches[name],
                                      "brushnet_train_step": brushnet_train_launches[name],
                                      "sp848_sample": sp848_launches[name],
                                      "sp_ranks_rank0": sp_ranks_launches[name],
                                      "sp_train_rank0": sp_train_launches[name],
                                      "stage3_app": stage3_launches[name],
                                      "dp_train_rank0": dp_train_launches[name],
                                      "dp_app_rank0": dp_app_launches[name],
                                      "app848": app848_launches[name],
                                      "app848_sde": inpaint848_launches["app848_sde"][name],
                                      "app848_brushnet":
                                          inpaint848_launches["app848_brushnet"][name],
                                      "sde848_65f": sde848_65f_launches[name],
                                      "block_bench": block_bench_launches[name],
                                      "ped_video_app": ped_video_launches[name],
                                      "perf_lab_step": perf_lab_launches[name],
                                      "stage1_sample_b4": stage1_launches["sample"][name],
                                      "stage1_app": stage1_launches["app"][name],
                                      "stage1_train": stage1_launches["train"][name]},
                    **meta[name], **kernel_numbers[name])
               for name in meta]
    for k in kernels:
        require(all(n > 0 for n in k["launches_by_path"].values()), k)
    # the backward kernels: launches are the Functions' backwards in the train step
    # (stage-2, full depth), the times those of the step's bf16 shapes
    bwd_header = "magicdrive_v2_tpu_torch/csrc/attn_bwd_sm90.cuh"
    bwd_meta = {
        "fused_qkv_attention": dict(
            row="K1 spatial", headers=[bwd_header], jax_backward=jax_ops + "flash_fused.py:487"
            " (_bwd: jax.vjp of _xla_reference)",
            other_rows={"cross_view": backward_rows["K1 cross-view"],
                        "sp_train": backward_rows["K1 sp_train"]}),
        "adaln_modulate": dict(
            row="K2", jax_backward="none: the JAX trainer differentiates _xla_fallback "
            "(" + jax_ops + "fused_adaln.py)",
            functions=["adaln_bwd_ring<__nv_bfloat16>", "adaln_bwd_ring<float>"],
            other_rows={"stage1": stage1_k2_backward}),
        "flash_attention": dict(
            row="K3", headers=[bwd_header], jax_backward=jax_ops + "flash_attention.py:137"
            " (_fa_bwd: jax.vjp of xla_attention)",
            other_rows={"packed_kv": backward_rows["K3 packed kv"]}),
    }
    for name, extra in bwd_meta.items():
        row = dict(backward_rows[extra.pop("row")])
        require(train_backwards[name] > 0, (name, train_backwards))
        kernels.append(dict(
            name=name + "_backward", route="cuda", source=meta[name]["source"],
            replaces=meta[name]["replaces"], launches=train_backwards[name],
            max_abs_err=held.backward_worst[name], ms=row.pop("ms"), plain_ms=row.pop("plain_ms"),
            bound_ms=row.pop("bound_ms"), bound_by=row.pop("bound_by"),
            library_ms=row.pop("library_ms"), shape=row, **extra))
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
