"""PyTorch port, the 848x1600 inpainting configs against the JAX package on the
CPU, at tiny width and image size:

- the BrushNet and SDE-BrushNet sample latents with ``force_pad_h_for_sp_size=4``
  where the pad applies, under the configs' slice CFG, 2 Euler steps (the check of
  tests/test_torch_brushnet_sampling.py): 24x40 images give a latent H of 3, 2
  token rows of 3 columns, 6 tokens, padded to 4 rows;
- the W-CODA app (``scripts.test_magicdrive``) on a config whose ``_base_`` is each
  17-16 848x1600 inpainting config, with the tiny model, 24x40 images, 9 frames and
  2 steps over the mini set (the check of tests/test_torch_brushnet_wcoda.py);
- the BrushNet inference app on a config whose ``_base_`` is the 65-frame
  SDE-BrushNet config: 65 frames (17 latent frames), the tiled decode setting,
  against JAX's ``scripts/inference_magicdrive_brushnet.py``.

At 848x1600 itself the token grid is 53 x 100 = 5300 tokens, which 4 divides, so
the fsp4 pad adds none there; these sizes make it pad. The configs' ``sp_size`` 4:
the port's app, one process, runs unsharded (a world of 1); the JAX app, which
would shard over 4 of its 8 CPU devices and decode inside one jitted program
where the test cannot read its latents, runs with ``sp_size=1``. The pad is the
configured one either way, so both compute one function.

Limits: those of the checks reused (latents 3e-4 absolute; frames within 2 levels
and 0.05 on average).
"""
import os

import pytest

from test_torch_brushnet_apps import (brush_assets, check_saved, hand_over,  # noqa: F401
                                      jax_normal)
from test_torch_brushnet_sampling import check_latents
from test_torch_brushnet_wcoda import check_wcoda_app
from test_torch_wcoda_app import (CFG_DATASET, REPO, Recorder, compare_latents,
                                  loaded_keys_message, run_jax_app)

import jax

CONFIGS = {
    "sde": "configs/magicdrive/test/17-16x848x1600_map0_fsp4_cfg2.0_sde_brushnet.py",
    "brushnet": "configs/magicdrive/test/17-16x848x1600_map0_fsp4_cfg2.0_brushnet.py",
    "65f": "configs/magicdrive/inference/"
           "65x848x1600_stdit3_CogVAE_boxTDS_wCT_xCE_wSST_sde_brushnet.py"}

# over a config's own settings: the tiny model (the config's type, sp_size and
# fsp4 pad kept), 24x40 images, 2 steps of its scheduler, t5-dummy, the tiny VAE
# snapshot (in the "vae" subfolder the configs name); the W-CODA configs' 17 frames
# cut to the mini set's 9-frame scenes, the 65 frames kept
CFG_848 = '''
_base_ = {base!r}
dtype = "fp32"
seed = 3
outputs = {out_dir!r}
{num_frames}
image_size = (24, 40)
bbox_mode = "all-xyz"
validation_index = [0, 1]
post = dict(resize=[48, 80], padding=[0, 4, 0, 0], cut_length=7)
model = dict(depth=2, control_depth=1, hidden_size=64, num_heads=4, model_max_length=16,
             from_pretrained=None,
             bbox_embedder_param=dict(class_token_dim=64, proj_dims=[64, 32, 32, 64],
                                      num_heads=4),
             frame_emb_param=dict(num_heads=4),
             map_embedder_param=dict(block_out_channels=[8, 16, 24, 32]))
scheduler = dict(num_sampling_steps=2)
text_encoder = dict(type="t5-dummy", model_max_length=16)
vae = dict(from_pretrained={vae_root!r})
''' + CFG_DATASET


JAX_ONE_DEVICE = ["--cfg-options", "sp_size=1"]


def write_848_config(path, which, assets, out_dir):
    path.write_text(CFG_848.format(
        base=os.path.join(REPO, CONFIGS[which]), out_dir=str(out_dir),
        num_frames="" if which == "65f" else "num_frames = 9",
        vae_root=os.path.dirname(assets["vae_dir"]), ann_file=assets["ann"],
        yaml_path=os.path.join(REPO, "configs/dataset/Nuscenes.yaml")))
    return str(path)


@pytest.mark.parametrize("kind", ["brushnet", "sde"])
def test_latents_under_the_fsp4_pad_match_jax(kind):
    tpipe = check_latents(kind, slice_cfg=True, hh=24, pad=4)
    assert tpipe.model_cfg.force_pad_h_for_sp_size == 4
    assert tpipe.model._h_pad_size(2, 3) == 2  # 2 x 3 tokens: two rows more


@pytest.mark.parametrize("variant", ["sde", "brushnet"])
def test_wcoda_app_on_the_848_inpainting_configs_matches_jax(brush_assets, tmp_path,
                                                             monkeypatch, caplog, variant):
    """The configs' own model type, scheduler (slice CFG: the SDE noise drawn for
    the 6 views a pass) and inpaint noise scale 0.2; two clips."""
    cfg = write_848_config(tmp_path / "cfg.py", variant, brush_assets, tmp_path / "out")
    check_wcoda_app(cfg, [], brush_assets["ckpts"][variant], variant == "sde",
                    (6 * 16 * 3, 3, 5), monkeypatch, caplog, JAX_ONE_DEVICE)


def test_brushnet_app_at_65_frames_matches_jax(brush_assets, tmp_path, monkeypatch, caplog):
    """The 65-frame SDE-BrushNet config: 65 frames, 17 latent frames, the JAX app's
    z and SDE noise (its sample key's draws; slice CFG: the 6 views of one pass)
    handed to the port; latents and the 65 written frames agree."""
    from magicdrive_v2_tpu_torch.scripts import inference_magicdrive_brushnet as app
    rec = Recorder(monkeypatch)
    cfg = write_848_config(tmp_path / "cfg.py", "65f", brush_assets, tmp_path / "out")
    ckpt = brush_assets["ckpts"]["sde"]
    argv = [cfg, "--synthetic", "--num-samples", "1", "--ckpt-path", ckpt]
    run_jax_app("inference_magicdrive_brushnet", argv + JAX_ONE_DEVICE, monkeypatch)
    key = jax.random.PRNGKey(1024)
    left = hand_over(monkeypatch, {1024: [
        jax_normal(jax.random.split(key)[0], (1, 96, 17, 3, 5)),
        jax_normal(key, (6 * 16 * 17, 3, 5))]})
    with caplog.at_level("INFO", logger="inference_brushnet"):
        saved = app.main(argv + ["--device", "cpu"])
    assert left() == {}
    assert loaded_keys_message(caplog) == [f"loaded {ckpt}: 0 missing, 0 unused keys"]
    compare_latents(rec)
    assert rec.latents["port"][0].shape == (6, 16, 17, 3, 5)
    assert len(saved) == 1
    check_saved(saved, rec, 65, (2 * 24, 3 * 40, 3))
