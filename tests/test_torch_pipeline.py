"""PyTorch port, the slice as a whole: ``MagicDrivePipeline.sample`` at the tiny
flagship config (and a tiny VAE for ``decode=True``) against the JAX pipeline on
the CPU, fp32; ``from_config`` and the inference app on the CPU.

The starting latent comes from the CPU torch generator both packages share
(``torch_seed``), the conditioning from the numpy-seeded ``synthetic_batch``, the
weights through ``from_jax_params``. Tolerance 3e-4 absolute on latents of order
1: two Euler steps of batched-CFG (guidance 2.0 doubles the model's fp32 error)
through a model that itself agrees to 1e-4.
"""
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_common import (assert_close, fill_tree, j, load_into, np_tree,
                               random_params, tiny_configs)

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.models.text_encoder.t5 import DummyTextEncoder as JDummy
from magicdrive_v2_tpu.models.vae.cogvideox import AutoencoderKLCogVideoX as JVAE
from magicdrive_v2_tpu.models.vae.cogvideox import CogVAEConfig as JVAECfg
from magicdrive_v2_tpu.models.vae.cogvideox import VideoAutoencoderKLCogVideoX
from magicdrive_v2_tpu.pipelines.magicdrive import MagicDrivePipeline as JPipeline
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu_torch.config.presets import rflow
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3 as TModel
from magicdrive_v2_tpu_torch.models.text_encoder.t5 import DummyTextEncoder
from magicdrive_v2_tpu_torch.models.vae.cogvideox import (CogVAEConfig,
                                                          VideoAutoencoderKLCogVideoX as TVAE,
                                                          get_latent_size)
from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params, load_state_dict_cast
from magicdrive_v2_tpu_torch.utils.misc import torch_randn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF, HH, WW, L_TXT, STEPS = 9, 64, 80, 20, 2
# a tiny VAE with the model's 16 latent channels
TINY_VAE = dict(block_out_channels=(8, 8, 8, 16), latent_channels=16, layers_per_block=1,
                norm_num_groups=4)


def _tiny_vaes():
    """(JAX wrapper, port wrapper) of the tiny VAE over the same random weights
    (GroupNorm scales around 1); the JAX decode runs under ``jax.jit``."""
    jvae = VideoAutoencoderKLCogVideoX(JVAECfg(**TINY_VAE))
    shapes = jax.eval_shape(lambda: JVAE(jvae.cfg).init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 3, 1, 16, 16))))
    jvae.params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 1.0 if getattr(p[-1], "key", "") == "scale" else v,
        fill_tree(shapes, 3, std=0.1))
    jvae.decode = jax.jit(jvae.decode)
    tvae = TVAE(CogVAEConfig(**TINY_VAE), device="cpu")
    load_state_dict_cast(tvae.module, from_jax_params(np_tree(jvae.params)), strict=True)
    return jvae, tvae


def _jax_tree(v):
    if isinstance(v, dict):
        return {k: _jax_tree(x) for k, x in v.items()}
    return j(v) if isinstance(v, np.ndarray) else v


@pytest.fixture(scope="module")
def pipes():
    jcfg, tcfg = tiny_configs(model_max_length=L_TXT)
    batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=L_TXT)
    jmodel = JModel(jcfg)
    params = random_params(jmodel, **_jax_tree(batch))
    sched_kw = rflow(num_sampling_steps=STEPS)
    jvae, tvae = _tiny_vaes()
    jpipe = JPipeline(jmodel, params, jvae, JDummy(model_max_length=L_TXT),
                      JR.build_scheduler(sched_kw))
    tmodel = load_into(TModel(tcfg), params, control_depth=tcfg.control_depth)
    tpipe = MagicDrivePipeline(tcfg, build_scheduler(sched_kw), model=tmodel, device="cpu",
                               vae=tvae)
    cond = {k: v for k, v in batch.items() if k not in ("x", "timestep", "height", "width")}
    return jpipe, tpipe, cond


def test_sample_latents_match_the_jax_pipeline(pipes):
    jpipe, tpipe, cond = pipes
    ref = jpipe.sample(_jax_tree(cond), num_frames=NF, height=HH, width=WW, torch_seed=1027,
                       decode=False)
    out = tpipe.sample(cond, num_frames=NF, height=HH, width=WW, torch_seed=1027,
                       decode=False)
    assert out.shape == (1, 96, 3, 8, 10) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert_close(out, ref, 3e-4)
    # the sampler moved the latent away from its starting noise
    z0 = torch_randn(out.shape, seed=1027)
    assert float((out - z0).abs().max()) > 1e-2


def test_slice_cfg_matches_batched_and_is_deterministic(pipes):
    _, tpipe, cond = pipes
    kw = dict(num_frames=NF, height=HH, width=WW, torch_seed=5, decode=False)
    a = tpipe.sample(cond, **kw)
    b = tpipe.sample(cond, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    tpipe.scheduler.slice_cfg = True
    try:
        c = tpipe.sample(cond, **kw)
    finally:
        tpipe.scheduler.slice_cfg = False
    np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5)
    # a different guidance scale and use_map0 both change the result
    assert float((a - tpipe.sample(cond, guidance_scale=4.0, **kw)).abs().max()) > 1e-4
    assert float((a - tpipe.sample(cond, use_map0=True, **kw)).abs().max()) > 1e-5


def test_frame_mask_pins_reference_frames(pipes):
    _, tpipe, cond = pipes
    z = torch_randn((1, 96, 3, 8, 10), seed=9)
    mask = np.array([[0.0, 1.0, 1.0]], np.float32)
    out = tpipe.sample(cond, num_frames=NF, height=HH, width=WW, z=z, mask=mask,
                       generator=torch.Generator().manual_seed(0), decode=False)
    np.testing.assert_array_equal(out[:, :, 0].numpy(), z[:, :, 0].numpy())
    assert float((out[:, :, 1:] - z[:, :, 1:]).abs().max()) > 1e-2


def test_captions_and_neg_prompts_go_through_the_text_encoder(pipes):
    jpipe, tpipe, cond = pipes
    je, te = JDummy(model_max_length=L_TXT), DummyTextEncoder(model_max_length=L_TXT, device="cpu")
    texts = ["A driving scene image at boston-seaport. Rain.", "night, <b>cars</b> www.x.y"]
    a, b = te.encode(texts), je.encode(texts)
    np.testing.assert_array_equal(a["y"].numpy(), np.asarray(b["y"]))
    np.testing.assert_array_equal(a["mask"].numpy(), np.asarray(b["mask"]))
    assert te.null(2).shape == (2, 1, L_TXT, 4096) and float(te.null(2).abs().max()) == 0.0
    cap = {k: v for k, v in cond.items() if k != "y"}
    cap["captions"] = texts[:1]
    kw = dict(num_frames=NF, height=HH, width=WW, torch_seed=5, decode=False)
    out = tpipe.sample(cap, **kw)
    out_neg = tpipe.sample(cap, neg_prompts=["Daytime. rain"], **kw)
    assert float((out - out_neg).abs().max()) > 1e-5
    np.testing.assert_array_equal(tpipe.null_y(1).numpy()[0, 0],
                                  tpipe.model.y_embedder.y_embedding.numpy())


def test_prepare_text_embedding_matches_the_jax_pipeline(pipes):
    """Box class tokens and the base token from the text encoder, as in JAX (the
    fixture's models are restored afterwards)."""
    jpipe, tpipe, _ = pipes
    jparams, model = jpipe.params, tpipe.model
    saved = (model.bbox_embedder._class_tokens.clone(), model.base_token.clone())
    try:
        jpipe.prepare_text_embedding()
        tpipe.prepare_text_embedding()
        jp = jpipe.params["params"]
        assert_close(model.bbox_embedder._class_tokens, jp["bbox_embedder"]["class_tokens"], 1e-5)
        assert_close(model.base_token, jp["base_token"], 1e-5)
        assert float((model.base_token - saved[1]).abs().max()) > 1e-3
    finally:
        jpipe.params = jparams
        model.bbox_embedder._class_tokens.copy_(saved[0])
        model.base_token.copy_(saved[1])


def test_decode_is_not_silently_skipped_and_latent_size(pipes):
    """``sample(decode=True)`` against the JAX pipeline's: the six views of the
    latents decoded one by one through the tiny VAE. Tolerance 2e-3 absolute on
    frames of order 1: the latents' 3e-4 through the decoder's ~20 layers."""
    jpipe, tpipe, cond = pipes
    kw = dict(num_frames=NF, height=HH, width=WW, torch_seed=1027)
    ref = jpipe.sample(_jax_tree(cond), **kw)
    out = tpipe.sample(cond, **kw)
    assert out.shape == (1, 6, 3, NF, HH, WW) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert_close(out, ref, 2e-3)
    # the decode of the latents the same call samples, view by view
    lat = tpipe.sample(cond, decode=False, **kw)
    np.testing.assert_array_equal(tpipe.decode(lat).numpy(), out.numpy())
    with pytest.raises(ValueError, match="VAE"):
        MagicDrivePipeline(tpipe.model_cfg, tpipe.scheduler, model=tpipe.model,
                           device="cpu").sample(cond, **kw)
    vae = VideoAutoencoderKLCogVideoX()
    for size in ([17, 424, 800], [9, 64, 80], [1, 224, 400], [16, 848, 1600], [33, 424, 800]):
        assert get_latent_size(size) == vae.get_latent_size(size), size
    assert get_latent_size([17, 424, 800]) == [5, 53, 100]
    assert get_latent_size([34, 64, 80], 17) == vae.get_latent_size([34, 64, 80], 17)
    assert get_latent_size([35, 64, 80], 17) == vae.get_latent_size([35, 64, 80], 17)


def test_inference_app_writes_the_six_view_grid(tmp_path, caplog):
    """The app on the CPU: the smoke_tiny config, synthetic conditioning, 2 steps,
    the tiny VAE from a diffusers snapshot the test writes. 9 frames -> 9 PNGs of
    the 2x3 grid (128x240) equal to the arrays the app returns; 1 frame -> one
    PNG. A missing T5 snapshot falls back to "t5-dummy"; a config with a dataset
    conditions on it (tests/test_torch_wcoda_app.py), so a val split without an
    ann_file is refused; sp_size > 1 in one process runs unsharded with a warning
    (tests/test_torch_sp_pipeline.py runs it on ranks); a missing --ckpt-path is
    refused."""
    from magicdrive_v2_tpu_torch.scripts.inference_magicdrive import main
    from magicdrive_v2_tpu_torch.utils.inference_utils import read_png
    _, tvae = _tiny_vaes()
    snap = tmp_path / "snapshot" / "vae"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text(json.dumps(
        dict(TINY_VAE, block_out_channels=list(TINY_VAE["block_out_channels"]))))
    torch.save(tvae.module.state_dict(), snap / "diffusion_pytorch_model.bin")
    config = os.path.join(REPO, "configs/magicdrive/inference/smoke_tiny.py")
    argv = [config, "--device", "cpu", "--num-samples", "1", "--cfg-options",
            f"outputs={tmp_path / 'out'}", f"vae.from_pretrained={snap.parent}",
            "vae.subfolder=vae", "scheduler.num_sampling_steps=2"]
    # a T5 snapshot that is not there falls back to the dummy encoder
    t5 = ["text_encoder.type=t5", f"text_encoder.from_pretrained={tmp_path / 'no_t5'}"]
    [(path, frames)] = main(argv[:1] + ["--synthetic", "--num-frames", "9"] + argv[1:] + t5)
    assert path == str(tmp_path / "out" / "sample_0_0") and frames.shape == (9, 128, 240, 3)
    assert sorted(os.listdir(path)) == [f"{i:04d}.png" for i in range(9)]
    for i in range(9):
        np.testing.assert_array_equal(read_png(os.path.join(path, f"{i:04d}.png")), frames[i])
    assert frames.std() > 1.0  # not a constant image
    [(path1, frames1)] = main(argv[:1] + ["--synthetic", "--num-frames", "1"] + argv[1:])
    assert path1.endswith("sample_0_0.png") and frames1.shape == (1, 128, 240, 3)
    np.testing.assert_array_equal(read_png(path1), frames1[0])
    with pytest.raises(TypeError, match="ann_file"):
        main(argv + ["dataset.data.val.type=NuScenesTDataset"])
    with caplog.at_level(logging.WARNING):
        [(_, frames_sp)] = main(argv[:1] + ["--synthetic", "--num-frames", "1"] + argv[1:]
                                + ["sp_size=2"])
    assert "sp_size=2 but only 1 process(es); running unsharded" in caplog.text
    np.testing.assert_array_equal(frames_sp, frames1)
    with pytest.raises(FileNotFoundError, match="ckpt_path"):
        main(argv[:1] + ["--synthetic", "--ckpt-path", str(tmp_path / "no.pt")] + argv[1:])


@pytest.mark.parametrize("broken", ["config.json", "safetensors header"])
def test_from_config_raises_on_a_malformed_vae_snapshot(tmp_path, broken):
    """A VAE snapshot that is there but unreadable raises; only an absent one
    leaves the VAE random (the no-JAX script's config names no local snapshot)."""
    from magicdrive_v2_tpu_torch.config.config import Config
    (tmp_path / "config.json").write_text(
        "{not json" if broken == "config.json" else json.dumps(
            dict(TINY_VAE, block_out_channels=list(TINY_VAE["block_out_channels"]))))
    with open(tmp_path / "diffusion_pytorch_model.safetensors", "wb") as f:
        f.write((64).to_bytes(8, "little") + b'{"decoder.conv_in.conv.weight": {"dty')
    cfg = Config.fromfile(os.path.join(REPO, "configs/magicdrive/inference/smoke_tiny.py"))
    cfg.set_path("vae.from_pretrained", str(tmp_path))
    with pytest.raises(json.JSONDecodeError):
        MagicDrivePipeline.from_config(cfg, device="cpu")


def test_inference_helpers_match_the_jax_package():
    from magicdrive_v2_tpu.utils import inference_utils as J
    from magicdrive_v2_tpu_torch.utils import inference_utils as T
    vids = np.random.default_rng(0).uniform(-1.2, 1.2, (6, 3, 2, 4, 5)).astype(np.float32)
    grid = J.concat_6_views(vids)
    np.testing.assert_array_equal(T.concat_6_views(vids), grid)
    np.testing.assert_array_equal(T.concat_6_views(torch.from_numpy(vids)).numpy(), grid)
    np.testing.assert_array_equal(T.to_uint8_video(torch.from_numpy(grid)),
                                  J.to_uint8_video(grid))
    for flags in ({}, {"force_daytime": True}, {"force_rainy": True}, {"force_night": True}):
        for prompt in ("A driving scene image at boston-seaport. Rain, night.", "Sunny."):
            assert T.edit_prompt(prompt, **flags) == J.edit_prompt(prompt, **flags)
    for cfg, cli in (({"num_frames": 9}, None), ({"num_frames": "full", "full_bucket_t": 233},
                                                 None), ({"num_frames": "full"}, 17)):
        assert T.resolve_num_frames(cfg, cli) == J.resolve_num_frames(cfg, cli)
    with pytest.raises(ValueError, match="full_bucket_t"):
        T.resolve_num_frames({"num_frames": "full"})


def test_device_defaults_to_cuda_and_raises_without_a_card():
    _, tcfg = tiny_configs()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MagicDrivePipeline(tcfg, build_scheduler(rflow(num_sampling_steps=1)))


_NO_JAX_SCRIPT = r"""
import sys
import torch
from magicdrive_v2_tpu_torch.config.presets import MV_ORDER_MAP, rflow, xl2_model
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
import magicdrive_v2_tpu_torch.ops, magicdrive_v2_tpu_torch.models.text_encoder.t5

md = xl2_model(control_skip_temporal=False)
md["bbox_embedder_param"].update(class_token_dim=32, proj_dims=[32, 16, 16, 32], num_heads=4)
md["frame_emb_param"].update(num_heads=4)
md["map_embedder_param"].update(block_out_channels=[4, 8, 12, 16], conditioning_size=[8, 40, 40])
cfg = build_model_config(md, vae_out_channels=4, mv_order_map=MV_ORDER_MAP,
                         dtype=torch.float32, hidden_size=32, num_heads=4, depth=2,
                         control_depth=1, caption_channels=16, model_max_length=8)
pipe = MagicDrivePipeline(cfg, build_scheduler(rflow(num_sampling_steps=2)), device="cpu")
init_weights(pipe.model, seed=0)
batch = synthetic_batch(cfg, 9, 32, 40, l_txt=8, caption_channels=16, map_size=(8, 40, 40))
out = pipe.sample(batch, num_frames=9, height=32, width=40, torch_seed=1, decode=False)
assert out.shape == (1, 24, 3, 4, 5) and bool(torch.isfinite(out).all())

# from a config file, with the CogVideoX-2b VAE it builds; one frame keeps the
# CPU decode short
from magicdrive_v2_tpu_torch.config.config import Config
cfg = Config.fromfile("configs/magicdrive/inference/smoke_tiny.py")
pipe = MagicDrivePipeline.from_config(cfg, device="cpu")
batch = synthetic_batch(pipe.model_cfg, 1, 64, 80, l_txt=32)
vid = pipe.sample(batch, num_frames=1, height=64, width=80, torch_seed=1024, decode=True)
assert vid.shape == (1, 6, 3, 1, 64, 80) and bool(torch.isfinite(vid).all()), vid.shape
assert float(vid.std()) > 1e-3

# one step of the train app on the tiny training config
import os
import tempfile
from magicdrive_v2_tpu_torch.scripts import train_magicdrive
with tempfile.TemporaryDirectory() as d:
    lines = train_magicdrive.main(["configs/magicdrive/train/smoke_tiny.py", "--synthetic",
                                   "--device", "cpu", "--max-steps", "1",
                                   "--cfg-options", f"outputs={d}"])
    tb_files = os.listdir(os.path.join(d, "tb"))  # its TensorBoard scalars
assert [x["step"] for x in lines] == [1], lines
assert len(tb_files) == 1, tb_files
# one step of the BrushNet train app, SDE-BrushNet (LoRA mask, train switch)
from magicdrive_v2_tpu_torch.scripts import train_brushnet
with tempfile.TemporaryDirectory() as d:
    lines = train_brushnet.main(["configs/magicdrive/train/brushnet_smoke.py", "--synthetic",
                                 "--sde", "--device", "cpu", "--max-steps", "1",
                                 "--cfg-options", f"outputs={d}"])
assert [x["step"] for x in lines] == [1], lines
# the data path: a nuScenes-format set through a dataset yaml and the loader, the
# native host kernels, the W-CODA app's module
sys.path.insert(0, "tests")
from helpers_mini_nuscenes import generate
from magicdrive_v2_tpu_torch import native
from magicdrive_v2_tpu_torch.config.config import Config, merge_dataset_cfg
from magicdrive_v2_tpu_torch.datasets import prepare_dataloader
from magicdrive_v2_tpu_torch.registry import DATASETS, build_module
import magicdrive_v2_tpu_torch.scripts.test_magicdrive
with tempfile.TemporaryDirectory() as d:
    ann = generate(d, (6, 6))
    ds = merge_dataset_cfg(Config(), "Nuscenes", [("dataset.data.val.ann_file", ann)]).dataset
    dataset = build_module(dict(ds.data.val, video_length=3), DATASETS)
    data = next(iter(prepare_dataloader(dataset, batch_size=2)[0]))
assert data["pixel_values"].shape[:3] == (2, 3, 6), data["pixel_values"].shape
assert native.library_path().endswith(".so")
# the pedestrian pipeline on its synthetic scene, and the mask tool on its stub backend
import numpy as np
from PIL import Image
import magicdrive_v2_tpu_torch.pedestrian
from magicdrive_v2_tpu_torch.scripts import pipeline_12hz
from magicdrive_v2_tpu_torch.tools import extract_masks
with tempfile.TemporaryDirectory() as d:
    proc = magicdrive_v2_tpu_torch.pedestrian.make_synthetic_processor(device="cpu")
    frames, gt_tex = pipeline_12hz.build_synthetic_scene(proc)
    n_ped, textures = pipeline_12hz.run_scene(proc, frames, d)
    os.makedirs(os.path.join(d, "data", "samples", "CAM_FRONT"))
    Image.fromarray(frames[0]["cams"]["CAM_FRONT"]["image"]).save(
        os.path.join(d, "data", "samples", "CAM_FRONT", "a.jpg"))
    n_masks = extract_masks.extract(os.path.join(d, "data"), os.path.join(d, "masks"),
                                    extract_masks.StubBackend(device="cpu"))
assert n_ped >= 4 and float(np.abs(textures["ped0"] - gt_tex).mean()) < 0.25, n_ped
assert n_masks == 1, n_masks
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "magicdrive_v2_tpu", "scipy", "cv2"))
assert not bad, bad
print("NO_JAX_OK", float(out.abs().mean()), float(vid.abs().mean()))
"""


def test_port_runs_without_importing_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def test_port_sources_name_no_jax_import():
    """No port file and not chip_smoke.py imports JAX, its libraries, scipy or cv2,
    or names the JAX package; the one exception is ``cv2`` in ``utils/video.py``,
    the port's video container I/O (what it may reach of cv2:
    tests/test_torch_video.py)."""
    import re
    pat = re.compile(r"import (jax|flax|optax|orbax|scipy|cv2)"
                     r"|from (jax|flax|optax|orbax|scipy|cv2)|magicdrive_v2_tpu[^_]")
    cv2_pat = re.compile(r"import cv2|from cv2")
    video = os.path.join(REPO, "magicdrive_v2_tpu_torch", "utils", "video.py")
    roots = [os.path.join(REPO, "magicdrive_v2_tpu_torch"), os.path.join(REPO, "chip_smoke.py")]
    hits, video_cv2 = [], 0
    for root in roots:
        files = [root] if os.path.isfile(root) else [
            os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith((".py", ".cu", ".cuh"))]
        for path in files:
            with open(path) as fh:
                for n, line in enumerate(fh, 1):
                    if not pat.search(line):
                        continue
                    if path == video and cv2_pat.search(line) and not pat.search(
                            cv2_pat.sub("", line)):
                        video_cv2 += 1
                        continue
                    hits.append(f"{path}:{n}: {line.strip()}")
    assert os.path.isfile(roots[1]), "chip_smoke.py is missing"
    assert not hits, hits
    assert video_cv2 > 0, "utils/video.py no longer imports cv2: drop the exception"
