"""PyTorch port, sequence-parallel serving on the CPU: ``from_config`` with
``sp_size`` > 1 on 2 gloo ranks sampling 2 steps and decoding, against the JAX
pipeline on a (1, 2) mesh; ``sp_size`` larger than the world runs unsharded with
a warning, as the JAX package does with fewer devices, and a world larger than
``sp_size`` is refused; each serving app (``inference_magicdrive``, the W-CODA
``test_magicdrive`` on a mini nuScenes set, ``inference_magicdrive_brushnet``)
on 2 ranks writes its frames once, and they are the one-process run's.

The ranks are processes started by ``spawn_ranks`` (``tests/torch_sp_worker.py``
for the pipeline, the app's own module for the app), with a deadline. The
starting latent comes from the CPU torch generator both packages share; the
weights are every flax leaf random, carried by ``from_jax_params``; the VAE is a
tiny snapshot both packages load.

Tolerances (fp32): 2e-4 absolute on the latents (two Euler steps of batched CFG
through the tiny model); 2e-3 on the decoded frames (the latents' error through
the decoder's ~20 layers, as tests/test_torch_pipeline.py states it); the app's
uint8 frames within one level of the one-process run's (the sharded model's
~1e-7 from the unsharded may move a rounding).
"""
import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch

from helpers_mini_nuscenes import generate
from test_torch_common import (assert_close, fill_tree, j, np_tree, random_params,
                               spawn_ranks, tiny_configs)
from test_torch_wcoda_app import FRAME_MAX, FRAME_MEAN, write_config

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.config.config import Config as JConfig
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.models.text_encoder.t5 import DummyTextEncoder as JDummy
from magicdrive_v2_tpu.models.vae.cogvideox import AutoencoderKLCogVideoX as JVAE
from magicdrive_v2_tpu.models.vae.cogvideox import CogVAEConfig as JVAECfg
from magicdrive_v2_tpu.models.vae.cogvideox import VideoAutoencoderKLCogVideoX as JVAEWrap
from magicdrive_v2_tpu.parallel.sharding import make_mesh as j_make_mesh
from magicdrive_v2_tpu.parallel.sharding import sp_vae as j_sp_vae
from magicdrive_v2_tpu.pipelines.magicdrive import MagicDrivePipeline as JPipeline
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu_torch.config.config import Config, merge_dot_options
from magicdrive_v2_tpu_torch.config.presets import rflow
from magicdrive_v2_tpu_torch.models.vae.cogvideox import CogVAEConfig
from magicdrive_v2_tpu_torch.models.vae.cogvideox import VideoAutoencoderKLCogVideoX as TVAE
from magicdrive_v2_tpu_torch.parallel.sharding import (Mesh, dp_size, get_current_mesh,
                                                       sp_size, use_mesh)
from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params, load_state_dict_cast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs/magicdrive/inference/smoke_tiny.py")
WORKER = os.path.join(REPO, "tests", "torch_sp_worker.py")
DEADLINE_S = 240
NF, HH, WW, L_TXT, STEPS, SEED = 9, 64, 80, 32, 2, 1027
TINY_VAE = dict(block_out_channels=[8, 8, 8, 16], latent_channels=16, layers_per_block=1,
                norm_num_groups=4)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The tiny model's JAX params and port state, the tiny VAE (JAX wrapper and a
    diffusers snapshot), the conditioning, the config options."""
    root = tmp_path_factory.mktemp("sp_pipeline")
    jcfg, tcfg = tiny_configs(model_max_length=L_TXT, grad_checkpoint=False)
    cond = synthetic_batch(tcfg, NF, HH, WW, l_txt=L_TXT)
    params = random_params(JModel(jcfg), **{k: (j(v) if isinstance(v, np.ndarray) else
                                                {kk: j(vv) for kk, vv in v.items()}
                                                if isinstance(v, dict) else v)
                                            for k, v in cond.items()})
    for k in ("x", "timestep", "height", "width"):
        cond.pop(k)
    vcfg = JVAECfg(**{k: tuple(v) if isinstance(v, list) else v for k, v in TINY_VAE.items()})
    shapes = jax.eval_shape(lambda: JVAE(vcfg).init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 3, 1, 16, 16))))
    jvae = JVAEWrap(vcfg)
    jvae.params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 1.0 if getattr(p[-1], "key", "") == "scale" else v,
        fill_tree(shapes, 3, std=0.1))
    tvae = TVAE(CogVAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in TINY_VAE.items()}), device="cpu")
    load_state_dict_cast(tvae.module, from_jax_params(np_tree(jvae.params)), strict=True)
    snap = root / "snapshot" / "vae"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text(json.dumps(TINY_VAE))
    torch.save(tvae.module.state_dict(), snap / "diffusion_pytorch_model.bin")
    state = {k: torch.from_numpy(np.array(v))
             for k, v in from_jax_params(np_tree(params), tcfg.control_depth).items()}
    options = [f"vae.from_pretrained={snap.parent}", "vae.subfolder=vae",
               f"scheduler.num_sampling_steps={STEPS}"]
    return dict(root=root, jcfg=jcfg, params=params, jvae=jvae, cond=cond, state=state,
                options=options)


@pytest.fixture(scope="module")
def sharded(assets):
    """from_config with sp_size=2 on 2 ranks: the latents of a 2-step sample, and
    their decode (sample(decode=True)'s, through sp_vae)."""
    tmp = assets["root"] / "ranks"
    tmp.mkdir()
    cond = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                {kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else v) for k, v in assets["cond"].items()}
    kw = dict(num_frames=NF, height=HH, width=WW, torch_seed=SEED)
    cases = {name: dict(kind="pipeline", config=CONFIG,
                        options=assets["options"] + ["sp_size=2"], state=assets["state"],
                        batch=cond, kwargs=dict(kw, decode=decode))
             for name, decode in (("latents", False), ("video", True))}
    cases.update({f"world_check_sp{sp}": dict(kind="world_check", sp=sp) for sp in (1, 2)})
    torch.save(cases, tmp / "inputs.pt")
    spawn_ranks(2, [WORKER, str(tmp)], DEADLINE_S)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(2)]


def test_two_step_sample_at_sp2_matches_the_jax_pipeline_on_a_mesh(assets, sharded):
    """Both ranks build the (1, 2) mesh, sample the same latents and decode the same
    video; both equal the JAX pipeline's on a (1, 2) mesh (its model sharded by
    GSPMD) and its sp_vae decode of those latents over the mesh. (The JAX
    ``sample(decode=True)`` under a mesh hands sp_vae the latents sharded over W,
    which its jit's input sharding refuses: ROADMAP queue C; so the reference
    decodes the latents from the host.)"""
    jcfg = dataclasses.replace(assets["jcfg"], enable_sequence_parallelism=True)
    mesh = j_make_mesh(dp=1, sp=2, devices=jax.devices()[:2])
    jpipe = JPipeline(JModel(jcfg), assets["params"], assets["jvae"],
                      JDummy(model_max_length=L_TXT),
                      JR.build_scheduler(rflow(num_sampling_steps=STEPS)), mesh=mesh)
    jcond = {k: (j(v) if isinstance(v, np.ndarray) else
                 {kk: j(vv) for kk, vv in v.items()} if isinstance(v, dict) else v)
             for k, v in assets["cond"].items()}
    ref_lat = np.asarray(jpipe.sample(jcond, decode=False, num_frames=NF, height=HH,
                                      width=WW, torch_seed=SEED))
    views = ref_lat.reshape(1, 16, 6, 3, 8, 10).transpose(0, 2, 1, 3, 4, 5).reshape(
        6, 16, 3, 8, 10)
    ref_vid = np.asarray(j_sp_vae(views, assets["jvae"].decode, mesh)).reshape(
        1, 6, 3, NF, HH, WW)
    for r in sharded:
        assert r["latents"]["sp"] == r["video"]["sp"] == 2
    lat, vid = sharded[0]["latents"]["video"], sharded[0]["video"]["video"]
    assert torch.equal(sharded[1]["latents"]["video"], lat)
    assert torch.equal(sharded[1]["video"]["video"], vid)
    assert lat.shape == (1, 96, 3, 8, 10) and vid.shape == (1, 6, 3, NF, HH, WW)
    assert torch.isfinite(vid).all()
    assert_close(lat, ref_lat, 2e-4)
    assert_close(vid, ref_vid, 2e-3)


def test_sp_size_above_the_world_runs_unsharded_with_a_warning(caplog, assets):
    """One process and sp_size=4: no mesh, no sequence-parallel pad, a warning; the
    JAX pipeline does the same with fewer devices than sp_size (16 on its 8). With
    force_pad_h_for_sp_size the pad is the configured one either way."""
    cfg = Config.fromfile(CONFIG)
    merge_dot_options(cfg, assets["options"] + ["sp_size=4",
                                                "model.enable_sequence_parallelism=True"])
    with caplog.at_level(logging.WARNING):
        pipe = MagicDrivePipeline.from_config(cfg, device="cpu")
    assert "sp_size=4 but only 1 process(es); running unsharded" in caplog.text
    assert pipe.mesh is None and not pipe.model_cfg.enable_sequence_parallelism
    jcfg = JConfig.fromfile(CONFIG)
    jcfg["sp_size"] = 16
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jpipe = JPipeline.from_config(jcfg, init_params=False)
    assert "sp_size=16 but only 8 device(s); running unsharded" in caplog.text
    assert jpipe.mesh is None and not jpipe.model.cfg.enable_sequence_parallelism
    merge_dot_options(cfg, ["model.force_pad_h_for_sp_size=4"])
    pipe = MagicDrivePipeline.from_config(cfg, device="cpu")
    assert pipe.model._h_pad_size(3, 5) == 1 and pipe.model._h_pad_size(4, 5) == 0


def test_a_world_larger_than_sp_size_is_refused(sharded):
    """On 2 ranks, sp_size 1 would have each rank repeat the whole sample: refused,
    as any sp_size below the world is; sp_size 2 builds its mesh."""
    for r in sharded:
        assert r["world_check_sp1"] == ("sp_size=1 in a world of 2 processes: launch "
                                        "sp_size processes (one sequence-parallel group)")
        assert r["world_check_sp2"] is None


def test_use_mesh_nests_and_sizes_read_the_current_mesh():
    """No process group needed: sp_size / dp_size read the innermost mesh, 1
    outside any; the previous mesh comes back on exit, also after an error."""
    a = Mesh(dp=1, sp=4, dp_rank=0, sp_rank=2, group=None, dp_group=None, sp_group=None)
    b = Mesh(dp=2, sp=2, dp_rank=1, sp_rank=1, group=None, dp_group=None, sp_group=None)
    assert get_current_mesh() is None and (sp_size(), dp_size()) == (1, 1)
    with use_mesh(a):
        assert (sp_size(), dp_size(), a.rank, a.size) == (4, 1, 2, 4)
        with pytest.raises(RuntimeError):
            with use_mesh(b):
                assert (sp_size(), dp_size(), b.rank, b.size) == (2, 2, 3, 4)
                raise RuntimeError
        assert get_current_mesh() is a
        with use_mesh(None):
            assert sp_size() == 1
    assert get_current_mesh() is None


def test_inference_app_on_two_ranks_writes_its_frames_once(assets, tmp_path):
    """The app with sp_size=2 on 2 ranks: rank 0 alone writes the 9 PNG frames of
    the 2x3 grid, and they are those of the app in one process (which runs the
    same config unsharded, with the warning)."""
    from magicdrive_v2_tpu_torch.scripts.inference_magicdrive import main
    args = ["--synthetic", "--num-frames", str(NF), "--device", "cpu", "--cfg-options"]
    opts = assets["options"] + ["sp_size=2"]
    outs = spawn_ranks(2, ["-m", "magicdrive_v2_tpu_torch.scripts.inference_magicdrive",
                           CONFIG] + args + opts + [f"outputs={tmp_path / 'ranks'}"],
                       DEADLINE_S)
    [(path, frames)] = main([CONFIG] + args + opts + [f"outputs={tmp_path / 'one'}"])
    assert sorted(os.listdir(tmp_path / "ranks")) == ["sample_0_0"]
    written = read_frames(tmp_path / "ranks" / "sample_0_0", NF)
    assert_written_once(outs, written, frames, "saved")


def read_frames(path, n):
    from magicdrive_v2_tpu_torch.utils.inference_utils import read_png
    assert sorted(os.listdir(path)) == [f"{i:04d}.png" for i in range(n)]
    return np.stack([read_png(os.path.join(path, f"{i:04d}.png")) for i in range(n)])


def assert_written_once(outs, written, frames, tag, levels=1, mean=None):
    """Both ranks joined the group and split the tokens over it; rank 0 alone
    logged and wrote the frames; they are the one-process run's within ``levels``
    (and ``mean`` on average)."""
    assert all("startup barrier passed (2 processes)" in o and "do not split" not in o
               for o in outs), outs
    assert tag in outs[0] and tag not in outs[1], outs
    assert written.shape == frames.shape, (written.shape, frames.shape)
    diff = np.abs(written.astype(int) - frames.astype(int))
    assert diff.max() <= levels and (mean is None or diff.mean() <= mean), (diff.max(),
                                                                            diff.mean())
    assert frames.std() > 1.0


def test_wcoda_app_on_two_ranks_writes_its_frames_once(assets, tmp_path):
    """The W-CODA app on a mini nuScenes set (one 9-frame scene of 24x40 images,
    cut to 7 frames, back-transformed with 4 rows of padding) with sp_size=2 on 2
    ranks: rank 0 alone writes the 6 views of the scene in the image_filename
    layout, equal to the one-process run's (unsharded, with the warning) within
    tests/test_torch_wcoda_app.py's limits: the back-transform rounds before its
    resize and after it, so a rounding the sharded model's ~1e-7 moves can show
    twice."""
    from magicdrive_v2_tpu_torch.scripts import test_magicdrive
    ann = generate(str(tmp_path / "nusc"), scene_lengths=(9,))
    vae_dir = str(assets["root"] / "snapshot" / "vae")
    argv = ["--device", "cpu", "--save-mode", "image_filename", "--cfg-options", "sp_size=2"]
    ranks_cfg = write_config(tmp_path / "ranks.py", tmp_path / "ranks", ann, vae_dir, 9, [0])
    outs = spawn_ranks(2, ["-m", "magicdrive_v2_tpu_torch.scripts.test_magicdrive",
                           ranks_cfg] + argv, DEADLINE_S)
    one_cfg = write_config(tmp_path / "one.py", tmp_path / "one", ann, vae_dir, 9, [0])
    saved = test_magicdrive.main([one_cfg] + argv)
    assert sorted(os.listdir(tmp_path / "ranks")) == ["scene_0"]
    assert len(saved) == 6
    for path, frames in saved:
        view = os.path.basename(path)
        written = read_frames(tmp_path / "ranks" / "scene_0" / view, 7)
        assert frames.shape == (7, 52, 80, 3) and (frames[:, :4] == 128).all()
        assert_written_once(outs, written, frames, "sample 0 saved", FRAME_MAX, FRAME_MEAN)


def test_brushnet_app_on_two_ranks_writes_its_frames_once(assets, tmp_path):
    """The SDE-BrushNet app on synthetic conditioning with sp_size=2 on 2 ranks:
    rank 0 alone writes the 2x3 grid of the 9 inpainted frames, equal to the
    one-process run's."""
    from magicdrive_v2_tpu_torch.scripts import inference_magicdrive_brushnet as app
    ann = generate(str(tmp_path / "nusc"), scene_lengths=(9,))
    vae_dir = str(assets["root"] / "snapshot" / "vae")
    argv = ["--synthetic", "--sde", "--device", "cpu", "--cfg-options", "sp_size=2"]
    ranks_cfg = write_config(tmp_path / "ranks.py", tmp_path / "ranks", ann, vae_dir, 9, [0])
    outs = spawn_ranks(2, ["-m", "magicdrive_v2_tpu_torch.scripts.inference_magicdrive_brushnet",
                           ranks_cfg] + argv, DEADLINE_S)
    one_cfg = write_config(tmp_path / "one.py", tmp_path / "one", ann, vae_dir, 9, [0])
    [(path, frames)] = app.main([one_cfg] + argv)
    assert sorted(os.listdir(tmp_path / "ranks")) == ["sample_0_0"]
    assert frames.shape == (9, 2 * 24, 3 * 40, 3)
    written = read_frames(tmp_path / "ranks" / "sample_0_0", 9)
    assert_written_once(outs, written, frames, "saved")
