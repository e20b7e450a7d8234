"""PyTorch port, the W-CODA app (``scripts.test_magicdrive``) with the inpainting
models on a dataset config, against the JAX app run in this process: ``--sde``
with ``--inpaint-noise-scale``, and ``--brushnet``; the same model reached by a
``*-BrushNet`` model type in the config, and through the two thin wrappers.

Data, weights and limits as tests/test_torch_brushnet_apps.py (the mini nuScenes
set of two 9-frame scenes, 24x40 images, 2 Euler steps, the tiny SDE-BrushNet
tree exported to ``.pt``). The SDE model's noise: the JAX app draws it from the
sample's key (1024 + sample); the port from ``torch_randn_stream(1024 + sample)``,
which the test replaces by a stream handing over JAX's draw.
"""
import os

import numpy as np
import pytest

from test_torch_brushnet_apps import brush_assets, hand_over, jax_normal  # noqa: F401
from test_torch_wcoda_app import (Recorder, compare_frames, compare_latents,
                                  loaded_keys_message, run_jax_app, write_config)

import jax

NF = 9
NOISE_SHAPE = (2 * 6 * 16 * 3, 3, 5)  # batched CFG doubles the batch the model sees


def check_wcoda_app(cfg, argv, ckpt, sde, noise_shape, monkeypatch, caplog, jax_argv=()):
    """The JAX and the port's W-CODA app on ``cfg`` with ``argv`` (the JAX app's
    followed by ``jax_argv``), the SDE model's noise (JAX's draw for
    ``noise_shape``) handed over: the latents and the two clips' frames (7 frames,
    48x80 with 4 rows on top, all-in-one) agree."""
    from magicdrive_v2_tpu_torch.scripts import test_magicdrive
    rec = Recorder(monkeypatch)
    argv = [cfg, "--save-mode", "all-in-one", "--ckpt-path", ckpt] + argv
    run_jax_app("test_magicdrive", argv + list(jax_argv), monkeypatch)
    left = lambda: {}  # noqa: E731
    if sde:
        left = hand_over(monkeypatch, {1024 + ns: [jax_normal(jax.random.PRNGKey(1024 + ns),
                                                              noise_shape)]
                                       for ns in range(2)})
    with caplog.at_level("INFO", logger="test"):
        saved = test_magicdrive.main(argv + ["--device", "cpu"])
    assert left() == {}
    assert loaded_keys_message(caplog) == [f"loaded {ckpt}: 0 missing, 0 unused keys"]
    compare_latents(rec)
    assert [p for p, _, _ in rec.jax_saved] == [p for p, _ in saved]
    assert len(saved) == 2
    for (path, frames), (_, ref, _) in zip(saved, rec.jax_saved):
        assert frames.shape == (7, 2 * 52, 3 * 80, 3), frames.shape
        compare_frames(frames, ref, path)
        assert (frames[:, :4] == 128).all()  # the zero padding of [-1, 1] frames
        assert sorted(os.listdir(path)) == [f"{i:04d}.png" for i in range(7)]
    return saved


@pytest.mark.parametrize("variant", ["sde", "brushnet"])
def test_wcoda_inpainting_app_matches_jax(brush_assets, tmp_path, monkeypatch, caplog,
                                          variant):
    """Two clips (validation indices 0 and 1) cut to 7 frames, back-transformed to
    48x80 with 4 rows on top, all-in-one; the latents and the frames against the
    JAX app's, the SDE model at inpaint timestep 0.3 x 1000."""
    cfg = write_config(tmp_path / "cfg.py", tmp_path / "out", brush_assets["ann"],
                       brush_assets["vae_dir"], NF, [0, 1])
    flags = ["--sde", "--inpaint-noise-scale", "0.3"] if variant == "sde" else ["--brushnet"]
    check_wcoda_app(cfg, flags, brush_assets["ckpts"][variant], variant == "sde",
                    NOISE_SHAPE, monkeypatch, caplog)


def test_brushnet_model_type_and_wrappers_reach_the_same_app(brush_assets, tmp_path,
                                                             monkeypatch):
    """``--brushnet``, a BrushNet model type in the config and the
    ``test_magicdrive_brushnet`` wrapper give the same frames; ``--sde`` and the
    ``test_magicdrive_sde_brushnet`` wrapper too, and they differ from BrushNet's
    (another model: the inpaint timestep layers). ``--ped-video-dir`` needs a
    video reader the port does not have."""
    from magicdrive_v2_tpu_torch.scripts import (test_magicdrive, test_magicdrive_brushnet,
                                                 test_magicdrive_sde_brushnet)
    cfg = write_config(tmp_path / "cfg.py", tmp_path / "out", brush_assets["ann"],
                       brush_assets["vae_dir"], NF, [0])
    base = [cfg, "--save-mode", "all-in-one", "--device", "cpu"]
    brush = base + ["--ckpt-path", brush_assets["ckpts"]["brushnet"]]
    sde = base + ["--ckpt-path", brush_assets["ckpts"]["sde"]]

    def frames(saved):
        assert len(saved) == 1
        return saved[0][1]

    ref = frames(test_magicdrive.main(brush + ["--brushnet"]))
    for other in (test_magicdrive.main(brush + [
            "--cfg-options", "model.type=MagicDriveSTDiT3-XL/2-BrushNet"]),
            test_magicdrive_brushnet.main(brush)):
        np.testing.assert_array_equal(frames(other), ref)
    ref_sde = frames(test_magicdrive.main(sde + ["--sde"]))
    np.testing.assert_array_equal(frames(test_magicdrive_sde_brushnet.main(sde)), ref_sde)
    assert np.abs(ref_sde.astype(int) - ref.astype(int)).max() > 2
    with pytest.raises(NotImplementedError, match="video reader"):
        test_magicdrive.main(base + ["--brushnet", "--ped-video-dir", str(tmp_path)])
