"""PyTorch port, the inpainting apps against the JAX apps run in this process:
``inference_magicdrive_brushnet`` (SDE-BrushNet) and ``inference_magicdrive_repaint``
on synthetic conditioning, 9 frames of 24x40, 2 Euler steps.

Weights: the tiny SDE-BrushNet (hidden 64, depth 2 / control depth 1, fp32) with
every JAX leaf random, exported by the JAX package's ``export_torch_state_dict``
into ``.pt`` files both apps load with ``--ckpt-path``: the SDE tree, the plain
BrushNet tree (without the two inpaint-timestep layers) and the base model's
part of it; the port must find every key. The VAE is the tiny CogVideoX
snapshot of tests/test_torch_wcoda_app.py, the text encoder ``t5-dummy``.

Randomness: the JAX apps draw the starting latents, the SDE noise, the VAE
posterior's noise and RePaint's step noise from ``jax.random`` keys; the port's
apps draw them, in a stated order, from one CPU generator per sample
(``torch_randn_stream(1024 + sample)``). The tests replace that stream by one
that hands over JAX's draws, checking each shape.

Limits as tests/test_torch_wcoda_app.py: latents 3e-4 absolute, written frames
within 2 levels everywhere and 0.05 on average.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from helpers_mini_nuscenes import generate
from test_torch_brushnet import brush_configs
from test_torch_common import fill_tree, np_tree, random_params
from test_torch_wcoda_app import (TINY_VAE, Recorder, compare_frames, compare_latents,
                                  loaded_keys_message, run_jax_app, write_config)

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.models.magicdrive.brushnet import MagicDriveSTDiT3BrushNet as JBrush
from magicdrive_v2_tpu.models.vae import cogvideox as jvae_mod
from magicdrive_v2_tpu.utils.ckpt import export_torch_state_dict
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import (MagicDriveSTDiT3,
                                                               MagicDriveSTDiT3Config)
from magicdrive_v2_tpu_torch.models.vae import cogvideox as tvae_mod
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.utils import misc
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params, load_state_dict_cast

NF, HH, WW = 9, 24, 40
LATENT = (1, 96, 3, 3, 5)
SDE_KEYS = ("t_inpaint_block.", "t_combine_block.")


@pytest.fixture(scope="module")
def brush_assets(tmp_path_factory):
    """The data, the tiny VAE snapshot, and the three checkpoints (SDE, BrushNet,
    base) of one random JAX SDE-BrushNet tree."""
    root = tmp_path_factory.mktemp("brush")
    ann = generate(str(root / "nusc"), scene_lengths=(9, 9))
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

    jcfg, tcfg = brush_configs(True, model_max_length=16)
    batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=16)
    rng = np.random.default_rng(0)
    batch["x_inpaint"] = rng.standard_normal((1, 18, NF, HH, WW)).astype(np.float32)
    batch["mask_inpaint"] = rng.integers(0, 2, (1, 6, NF, HH, WW)).astype(np.float32)
    batch["t_inpaint"] = np.full((1,), 300.0, np.float32)
    jb = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in batch.items() if k != "timestep"}
    params = random_params(JBrush(jcfg), **jb, timestep=jnp.full((1,), 500.0),
                           rngs_key=jax.random.PRNGKey(0))
    sde = export_torch_state_dict(np_tree(params), tcfg.control_depth)
    base_cfg = MagicDriveSTDiT3Config(**{f.name: getattr(tcfg, f.name)
                                         for f in dataclasses.fields(MagicDriveSTDiT3Config)})
    base_keys = set(MagicDriveSTDiT3(base_cfg).state_dict())
    ckpts = {}
    for name, keep in (("sde", lambda k: True),
                       ("brushnet", lambda k: not k.startswith(SDE_KEYS)),
                       ("base", lambda k: k in base_keys)):
        ckpts[name] = str(root / f"{name}.pt")
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sde.items() if keep(k)},
                   ckpts[name])
    return dict(root=root, ann=ann, vae_dir=str(vae_dir), ckpts=ckpts)


def jax_normal(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def hand_over(monkeypatch, draws_by_seed):
    """``torch_randn_stream(seed)`` of the port's apps: for a seed in
    ``draws_by_seed`` a stream that returns those arrays in order (each of the
    shape asked for, and all of them used: checked by ``left``), for any other
    seed the real stream."""
    real = misc.torch_randn_stream

    def stream(seed):
        queue = draws_by_seed.get(int(seed))
        if queue is None:
            return real(seed)

        def draw(shape):
            arr = queue.pop(0)
            assert arr.shape == tuple(shape), (seed, arr.shape, shape)
            return torch.from_numpy(arr)
        return draw

    monkeypatch.setattr(misc, "torch_randn_stream", stream)
    return lambda: {s: len(q) for s, q in draws_by_seed.items() if q}


def check_saved(saved, rec, n_frames, shape):
    from magicdrive_v2_tpu_torch.utils.inference_utils import read_png
    assert [p for p, _, _ in rec.jax_saved] == [p for p, _ in saved]
    for (path, frames), (_, ref, _) in zip(saved, rec.jax_saved):
        assert frames.shape == (n_frames,) + shape, frames.shape
        compare_frames(frames, ref, path)
        assert sorted(os.listdir(path)) == [f"{i:04d}.png" for i in range(n_frames)]
        assert np.array_equal(read_png(os.path.join(path, "0003.png")), frames[3])


def test_brushnet_app_matches_jax(brush_assets, tmp_path, monkeypatch, caplog):
    """``--sde --inpaint-noise-scale 0.3``, two samples: the JAX app's z (the split
    of its sample key) and SDE noise (its key's draw for the doubled batch of
    batched CFG) handed to the port."""
    from magicdrive_v2_tpu_torch.scripts import inference_magicdrive_brushnet as app
    rec = Recorder(monkeypatch)
    cfg = write_config(tmp_path / "cfg.py", tmp_path / "out", brush_assets["ann"],
                       brush_assets["vae_dir"], NF, [0])
    argv = [cfg, "--synthetic", "--sde", "--inpaint-noise-scale", "0.3", "--num-samples", "2",
            "--ckpt-path", brush_assets["ckpts"]["sde"]]
    run_jax_app("inference_magicdrive_brushnet", argv, monkeypatch)
    noise_shape = (2 * 6 * 16 * 3, 3, 5)
    draws = {1024 + ns: [jax_normal(jax.random.split(jax.random.PRNGKey(1024 + ns))[0], LATENT),
                         jax_normal(jax.random.PRNGKey(1024 + ns), noise_shape)]
             for ns in range(2)}
    left = hand_over(monkeypatch, draws)
    with caplog.at_level("INFO", logger="inference_brushnet"):
        saved = app.main(argv + ["--device", "cpu"])
    assert left() == {}
    assert loaded_keys_message(caplog) == [
        f"loaded {brush_assets['ckpts']['sde']}: 0 missing, 0 unused keys"]
    compare_latents(rec)
    assert len(saved) == 2
    check_saved(saved, rec, NF, (2 * HH, 3 * WW, 3))
    with pytest.raises(NotImplementedError, match="video reader"):
        app.main([cfg, "--ped-dir", str(tmp_path), "--device", "cpu"])


def test_repaint_app_matches_jax(brush_assets, tmp_path, monkeypatch, caplog):
    """The base model, two steps: the JAX app's VAE posterior noise (the encode's
    default key 0), starting latent and step noises (its sample key's draws)
    handed to the port. The known region of the final latents is the encoded
    reference in both."""
    from magicdrive_v2_tpu_torch.scripts import inference_magicdrive_repaint as app
    rec = Recorder(monkeypatch)
    encoded = {"jax": [], "port": []}
    jencode, tencode = (jvae_mod.VideoAutoencoderKLCogVideoX.encode,
                        tvae_mod.VideoAutoencoderKLCogVideoX.encode)

    def jax_encode(vae, x, *a, **kw):
        out = jencode(vae, x, *a, **kw)
        encoded["jax"].append(np.asarray(out))
        return out

    def port_encode(vae, x, *a, **kw):
        out = tencode(vae, x, *a, **kw)
        encoded["port"].append(out.numpy())
        return out

    monkeypatch.setattr(jvae_mod.VideoAutoencoderKLCogVideoX, "encode", jax_encode)
    monkeypatch.setattr(tvae_mod.VideoAutoencoderKLCogVideoX, "encode", port_encode)
    cfg = write_config(tmp_path / "cfg.py", tmp_path / "out", brush_assets["ann"],
                       brush_assets["vae_dir"], NF, [0])
    argv = [cfg, "--synthetic", "--ckpt-path", brush_assets["ckpts"]["base"]]
    run_jax_app("inference_magicdrive_repaint", argv, monkeypatch)
    key = jax.random.PRNGKey(1024)
    z_key, rest = jax.random.split(key)
    draws = {1024: [jax_normal(jax.random.PRNGKey(0), (6, 16, 3, 3, 5)),
                    jax_normal(z_key, LATENT)]
             + [jax_normal(k, LATENT) for k in jax.random.split(rest, 2)]}
    left = hand_over(monkeypatch, draws)
    with caplog.at_level("INFO", logger="inference_repaint"):
        saved = app.main(argv + ["--device", "cpu"])
    assert left() == {}
    assert loaded_keys_message(caplog) == [
        f"loaded {brush_assets['ckpts']['base']}: 0 missing, 0 unused keys"]
    np.testing.assert_allclose(encoded["port"][0], encoded["jax"][0], atol=1e-4)
    compare_latents(rec)
    # the top half of every view (latent rows 0-1 of 3: rows 0-11 of 24 pixels,
    # sampled every 8th) is the encoded reference exactly
    ref = encoded["port"][0].reshape(1, 6, 16, 3, 3, 5).transpose(0, 2, 1, 3, 4, 5)
    lat = rec.latents["port"][0].reshape(1, 6, 16, 3, 3, 5).transpose(0, 2, 1, 3, 4, 5)
    np.testing.assert_array_equal(lat[..., :2, :], ref[..., :2, :])
    assert float(np.abs(lat[..., 2:, :] - ref[..., 2:, :]).max()) > 1e-2
    check_saved(saved, rec, NF, (2 * HH, 3 * WW, 3))


def test_compress_time_for_mask_matches_jax():
    import importlib.util
    from magicdrive_v2_tpu_torch.scripts.inference_magicdrive_repaint import (
        compress_time_for_mask)
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "inference_magicdrive_repaint.py")
    spec = importlib.util.spec_from_file_location("jax_repaint_app", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rng = np.random.default_rng(0)
    for t_img in (1, 3, 9, 17, 19):
        m = (rng.random((2, 6, t_img, 4, 5)) > 0.8).astype(np.float32)
        np.testing.assert_array_equal(compress_time_for_mask(m), mod.compress_time_for_mask(m))
