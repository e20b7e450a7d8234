"""PyTorch port, the serving apps on a dataset config: ``inference_magicdrive``
(fixed length and whole scenes) and the W-CODA ``test_magicdrive`` (its three save
modes, ``cut_length``, ``use_map0``, the back-transform, whole scenes), each against
the JAX app run in this process on the same config, weights and data.

Weights: the tiny flagship (hidden 64, depth 2 / control depth 1, fp32) with every
JAX leaf random, exported by the JAX package's ``export_torch_state_dict`` into a
``.pt`` that both apps load with ``--ckpt-path`` (the JAX app through
``convert_torch_state_dict``; the port must find every key). The VAE is a tiny
CogVideoX snapshot both load with ``vae.from_pretrained``; the text encoder is
``t5-dummy`` on both sides. Data: ``tests/helpers_mini_nuscenes.generate`` with
scenes of 9 and 19 frames, 24x40 images, 2 Euler steps.

Limits: latents 3e-4 absolute (as the pipeline's parity test: two Euler steps of
batched CFG in fp32); written frames (uint8) within 2 levels of 255 everywhere
and 0.05 on average: the frames differ by the decode of latents that differ by
3e-4 (at most ~2e-3 in [-1, 1], a quarter of a level), then by the rounding to
uint8 that it can flip, twice where the back-transform rounds before its
bicubic resize.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_common import fill_tree, np_tree, random_params

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.config.config import Config as JConfig
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.models.magicdrive.stdit3 import build_model_config as jbuild_cfg
from magicdrive_v2_tpu.models.vae import cogvideox as jvae_mod
from magicdrive_v2_tpu.utils import inference_utils as jinf
from magicdrive_v2_tpu.utils.ckpt import export_torch_state_dict
from magicdrive_v2_tpu_torch.models.vae import cogvideox as tvae_mod
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params, load_state_dict_cast
from magicdrive_v2_tpu_torch.utils.inference_utils import read_png

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from helpers_mini_nuscenes import generate  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_VAE = dict(block_out_channels=[8, 8, 8, 16], latent_channels=16, layers_per_block=1,
                norm_num_groups=4)
LATENT_ATOL = 3e-4
FRAME_MAX, FRAME_MEAN = 2, 0.05

CFG = '''
from magicdrive_v2_tpu.config.presets import MV_ORDER_MAP, img_collate_param, rflow, xl2_model
from magicdrive_v2_tpu.config.yaml_compose import load_yaml_config

dtype = "fp32"
seed = 3
outputs = {out_dir!r}
num_frames = {num_frames!r}
image_size = (24, 40)
bbox_mode = "all-xyz"
mv_order_map = MV_ORDER_MAP
vae_out_channels = 16
validation_index = {validation_index!r}
post = dict(resize=[48, 80], padding=[0, 4, 0, 0], cut_length=7)
use_map0 = True

model = xl2_model(bbox_mode=bbox_mode, control_skip_temporal=False)
model.update(depth=2, control_depth=1, hidden_size=64, num_heads=4)
model["bbox_embedder_param"].update(class_token_dim=64, proj_dims=[64, 32, 32, 64],
                                    num_heads=4)
model["frame_emb_param"].update(num_heads=4)
model["map_embedder_param"].update(block_out_channels=[8, 16, 24, 32])
model["model_max_length"] = 16
model.pop("from_pretrained", None)

scheduler = rflow(num_sampling_steps=2, cfg_scale=2.0)
text_encoder = dict(type="t5-dummy", model_max_length=16)
vae = dict(from_pretrained={vae_dir!r}, micro_frame_size=None, micro_batch_size=None)

_yaml = load_yaml_config({yaml_path!r})
_pipe = _yaml["test_pipeline"]
for _t in _pipe:
    if _t["type"] == "ImageAug3D":
        _t["final_dim"] = [24, 40]
        _t["resize_lim"] = [0.25, 0.25]
_val = dict(_yaml["data"]["val"], ann_file={ann_file!r}, dataset_root="", pipeline=_pipe,
            img_collate_param=dict(img_collate_param(bbox_mode, is_train=False),
                                   template=_yaml["template"]))
dataset = dict(data=dict(val=_val))
'''


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The data, the tiny VAE snapshot and the exported model weights."""
    root = tmp_path_factory.mktemp("wcoda")
    ann = generate(str(root / "nusc"), scene_lengths=(9, 19))
    # tiny VAE: random weights (GroupNorm scales around 1) as a diffusers snapshot
    shapes = jax.eval_shape(lambda: jvae_mod.AutoencoderKLCogVideoX(jvae_mod.CogVAEConfig(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in TINY_VAE.items()})).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 1, 16, 16))))
    vparams = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 1.0 if getattr(p[-1], "key", "") == "scale" else v,
        fill_tree(shapes, 3, std=0.1))
    tvae = tvae_mod.VideoAutoencoderKLCogVideoX(
        tvae_mod.CogVAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in TINY_VAE.items()}), device="cpu")
    load_state_dict_cast(tvae.module, from_jax_params(np_tree(vparams)), strict=True)
    vae_dir = root / "vae"
    vae_dir.mkdir()
    (vae_dir / "config.json").write_text(json.dumps(TINY_VAE))
    torch.save(tvae.module.state_dict(), vae_dir / "diffusion_pytorch_model.bin")
    # the model: every JAX leaf random, exported to reference torch names
    cfg_path = write_config(root / "probe.py", root / "probe_out", ann, str(vae_dir), 9, [0])
    jcfg = JConfig.fromfile(cfg_path)
    mcfg = jbuild_cfg(jcfg.model, vae_out_channels=16, mv_order_map=jcfg.mv_order_map,
                      dtype=jnp.float32)
    batch = synthetic_batch(mcfg, 9, 24, 40, l_txt=16)
    jb = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in batch.items() if k != "timestep"}
    params = random_params(JModel(mcfg), **jb, timestep=jnp.full((1,), 500.0))
    ckpt = str(root / "model.pt")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                export_torch_state_dict(np_tree(params), mcfg.control_depth).items()}, ckpt)
    return dict(root=root, ann=ann, vae_dir=str(vae_dir), ckpt=ckpt)


def write_config(path, out_dir, ann, vae_dir, num_frames, validation_index):
    path.write_text(CFG.format(out_dir=str(out_dir), ann_file=ann, vae_dir=vae_dir,
                               num_frames=num_frames, validation_index=validation_index,
                               yaml_path=os.path.join(REPO, "configs/dataset/Nuscenes.yaml")))
    return str(path)


class Recorder:
    """Records the latents each package's VAE decodes, and what the JAX app saves
    (its ``save_sample`` writes mp4 through imageio; here it writes nothing)."""

    def __init__(self, monkeypatch):
        self.latents = {"jax": [], "port": []}
        self.jax_saved = []
        jdecode, tdecode = jvae_mod.VideoAutoencoderKLCogVideoX.decode, \
            tvae_mod.VideoAutoencoderKLCogVideoX.decode

        def jax_decode(vae, z, *a, **kw):
            self.latents["jax"].append(np.asarray(z, np.float32))
            return jdecode(vae, z, *a, **kw)

        def port_decode(vae, z, *a, **kw):
            self.latents["port"].append(z.float().numpy())
            return tdecode(vae, z, *a, **kw)

        def save_sample(x, path, fps=12, force_image=False):
            self.jax_saved.append((path, jinf.to_uint8_video(np.asarray(x)), force_image))
            return path

        monkeypatch.setattr(jvae_mod.VideoAutoencoderKLCogVideoX, "decode", jax_decode)
        monkeypatch.setattr(tvae_mod.VideoAutoencoderKLCogVideoX, "decode", port_decode)
        monkeypatch.setattr(jinf, "save_sample", save_sample)


def run_jax_app(script, argv, monkeypatch):
    """The JAX package's app ``scripts/<script>.py`` in this process."""
    path = os.path.join(REPO, "scripts", script + ".py")
    spec = importlib.util.spec_from_file_location(f"jax_app_{script}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [path] + argv)
    mod.main()


def compare_frames(port, ref, what):
    assert port.shape == ref.shape and port.dtype == ref.dtype == np.uint8, (what, port.shape,
                                                                           ref.shape)
    diff = np.abs(port.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= FRAME_MAX and diff.mean() <= FRAME_MEAN, (what, diff.max(),
                                                                   diff.mean())
    assert port.std() > 1.0, what  # not a constant image


def compare_latents(rec):
    assert len(rec.latents["port"]) == len(rec.latents["jax"]) > 0
    for a, b in zip(rec.latents["port"], rec.latents["jax"]):
        assert a.shape == b.shape and np.abs(b).max() > 1e-2
        np.testing.assert_allclose(a, b, atol=LATENT_ATOL)


def loaded_keys_message(caplog):
    return [r.getMessage() for r in caplog.records if r.getMessage().startswith("loaded ")]


@pytest.mark.parametrize("length", ["fixed", "full"])
def test_inference_app_on_a_dataset_config_matches_jax(assets, tmp_path, monkeypatch,
                                                       caplog, length):
    """Fixed: 9-frame clips at validation indices 0 and 3. Full: both whole scenes
    padded to the derived 17-frame bucket (9 and 19 -> 17 frames), the video trimmed
    to the scene's own length."""
    from magicdrive_v2_tpu_torch.scripts import inference_magicdrive
    full = length == "full"
    rec = Recorder(monkeypatch)
    cfg = write_config(tmp_path / "cfg.py", tmp_path / "out", assets["ann"],
                       assets["vae_dir"], "full" if full else 9, [0, 1] if full else [0, 3])
    run_jax_app("inference_magicdrive", [cfg, "--ckpt-path", assets["ckpt"]], monkeypatch)
    with caplog.at_level("INFO", logger="inference"):
        saved = inference_magicdrive.main([cfg, "--ckpt-path", assets["ckpt"], "--device",
                                           "cpu"])
    assert loaded_keys_message(caplog) == [f"loaded {assets['ckpt']}: 0 missing, 0 unused keys"]
    compare_latents(rec)
    assert [p for p, _, _ in rec.jax_saved] == [p for p, _ in saved]
    lengths = [f.shape[0] for _, f in saved]
    assert lengths == ([9, 17] if full else [9, 9])
    for (path, frames), (_, ref, _) in zip(saved, rec.jax_saved):
        compare_frames(frames, ref, path)
        assert sorted(os.listdir(path)) == [f"{i:04d}.png" for i in range(len(frames))]
        assert np.array_equal(read_png(os.path.join(path, "0000.png")), frames[0])
    if full:
        assert "full-length generation: bucket max-T = 17 frames" in caplog.text


@pytest.mark.parametrize("save_mode,length", [("all-in-one", "fixed"),
                                              ("single-view", "fixed"),
                                              ("image_filename", "fixed"),
                                              ("all-in-one", "full")])
def test_wcoda_test_app_matches_jax(assets, tmp_path, monkeypatch, caplog, save_mode,
                                    length):
    """The W-CODA app: 9 frames (or the whole first scene, 9 of a 17-frame bucket)
    cut to 7, back-transformed to 48x80 with 4 rows of padding on top, use_map0;
    the files each save mode writes, equal in number and shape to the JAX app's,
    the frames within the stated limit; the latents (two persistent seed streams:
    the second sample's continue the first's) within 3e-4."""
    from magicdrive_v2_tpu_torch.scripts import test_magicdrive
    rec = Recorder(monkeypatch)
    full = length == "full"
    out = tmp_path / "out"
    cfg = write_config(tmp_path / "cfg.py", out, assets["ann"], assets["vae_dir"],
                       "full" if full else 9, [0] if full else [0, 3])
    argv = [cfg, "--save-mode", save_mode, "--ckpt-path", assets["ckpt"]]
    run_jax_app("test_magicdrive", argv, monkeypatch)
    with caplog.at_level("INFO", logger="test"):
        saved = test_magicdrive.main(argv + ["--device", "cpu"])
    assert loaded_keys_message(caplog) == [f"loaded {assets['ckpt']}: 0 missing, 0 unused keys"]
    compare_latents(rec)
    assert [p for p, _, _ in rec.jax_saved] == [p for p, _ in saved]
    per_sample = {"all-in-one": 1, "single-view": 6, "image_filename": 6}[save_mode]
    assert len(saved) == per_sample * (1 if full else 2)
    h, w = (2 * 52, 3 * 80) if save_mode == "all-in-one" else (52, 80)
    for (path, frames), (_, ref, force_image) in zip(saved, rec.jax_saved):
        assert frames.shape == (7, h, w, 3), frames.shape
        compare_frames(frames, ref, path)
        assert force_image == (save_mode == "image_filename")
        assert (frames[:, :4] == 128).all()  # the zero padding of [-1, 1] frames
        names = sorted(os.listdir(path))
        assert names == [f"{i:04d}.png" for i in range(7)]
        assert np.array_equal(read_png(os.path.join(path, names[-1])), frames[-1])
    if save_mode == "image_filename":
        assert sorted(os.listdir(out / "scene_0")) == sorted(
            ["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT", "CAM_BACK",
             "CAM_BACK_LEFT"])
    if full:
        assert "full-length generation: bucket max-T = 17 frames" in caplog.text
        assert rec.latents["port"][0].shape[2] == 5  # the 17-frame bucket's latents


def test_wcoda_test_app_refuses_what_is_not_ported(tmp_path, assets):
    from magicdrive_v2_tpu_torch.scripts import test_magicdrive
    cfg = write_config(tmp_path / "cfg.py", tmp_path / "out", assets["ann"],
                       assets["vae_dir"], 9, [0])
    for extra in (["--brushnet"], ["--sde"], ["--ped-video-dir", str(tmp_path)],
                  ["--inpaint-noise-scale", "0.3"],
                  ["--cfg-options", "model.type=MagicDriveSTDiT3-XL/2-BrushNet"]):
        with pytest.raises(NotImplementedError, match="queue A item 4"):
            test_magicdrive.main([cfg, "--device", "cpu"] + extra)
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        test_magicdrive.main([cfg, "--device", "cpu", "--cfg-options", "sp_size=4"])
    with pytest.raises(FileNotFoundError, match="ckpt_path"):
        test_magicdrive.main([cfg, "--device", "cpu", "--ckpt-path", str(tmp_path / "no.pt")])
