"""PyTorch port, the stage-1 image path: MagicDriveSTDiT3 without temporal blocks
(``with_temp_block=False``, ``control_skip_temporal=True``) at 1 frame, through the
apps, against the JAX package's apps run in this process on the CPU:

- the inference app on a config whose ``_base_`` is
  ``configs/magicdrive/inference/1x224x400_stdit3_CogVAE_noTemp_xCE_wSST.py``
  (synthetic conditioning, 6 views of 224x400, batched CFG 2.0): the latents each
  app decodes and the one frame of the 2x3 grid each writes;
- the train app on a config whose ``_base_`` is
  ``configs/magicdrive/train/stage1_1x224x400.py``, ``--synthetic`` with the
  stage-1 bucket (1, 224, 400) passed (both apps' synthetic default is (9, 224,
  400)), 2 steps at its remat and logit-normal t: the metrics lines, the JAX app's
  weights and its step keys' draws of t and noise handed to the port; and the
  TensorBoard scalars the port's app writes, read back, equal its ``metrics.jsonl``;
- the train app's loader, encode stage and two trainer steps at 1 frame on the
  generated nuScenes set (``tests/test_torch_train_data.py``'s check, stage-1
  model and clips).

The model is the tiny flagship over each config's own settings: hidden 64, 4
heads, depth 2 / control depth 1, fp32, every JAX leaf random. The inference app
reads it from a ``.pt`` the JAX package's exporter wrote (``--ckpt-path``), a
tiny CogVideoX VAE snapshot and ``t5-dummy``, 2 Euler steps.

Limits: latents 3e-4 absolute and frames within 2 levels (0.05 on average), as
``tests/test_torch_wcoda_app.py``; metrics 2e-5 relative, as
``tests/test_torch_train_data.py``; the TensorBoard scalars equal the metrics
lines' values rounded to float32, TensorBoard's type.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_common import fill_tree, np_tree, random_params, read_scalars
from test_torch_train_data import assets, encode_and_train_against_jax  # noqa: F401
from test_torch_wcoda_app import (REPO, Recorder, compare_frames, compare_latents,
                                  loaded_keys_message, run_jax_app)

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.config.config import Config as JConfig
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.models.magicdrive.stdit3 import build_model_config as jbuild_cfg
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu.utils.ckpt import export_torch_state_dict
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params, load_state_dict_cast
from magicdrive_v2_tpu_torch.utils.inference_utils import read_png

NOTEMP_CONFIG = "configs/magicdrive/inference/1x224x400_stdit3_CogVAE_noTemp_xCE_wSST.py"
STAGE1_CONFIG = "configs/magicdrive/train/stage1_1x224x400.py"
HH, WW = 224, 400
STAGE1_BUCKET = ["--cfg-options", f"synthetic_buckets=[(1,{HH},{WW})]"]
METRICS_RTOL = 2e-5

TINY_MODEL = '''
model = dict(depth=2, control_depth=1, hidden_size=64, num_heads=4, from_pretrained=None,
             bbox_embedder_param=dict(class_token_dim=64, proj_dims=[64, 32, 32, 64],
                                      num_heads=4),
             frame_emb_param=dict(num_heads=4),
             map_embedder_param=dict(block_out_channels=[8, 16, 24, 32]){extra})
'''

CFG_INFER = '''
_base_ = {base!r}
dtype = "fp32"
seed = 3
outputs = {out_dir!r}
scheduler = dict(num_sampling_steps=2)
text_encoder = dict(type="t5-dummy", model_max_length=16)
vae = dict(from_pretrained={vae_root!r})
''' + TINY_MODEL.format(extra=", model_max_length=16")

# ckpt_every: a step count (the JAX app divides by it; both apps save at the end)
CFG_TRAIN = '''
_base_ = {base!r}
dtype = "fp32"
seed = 3
outputs = {out_dir!r}
batch_size = 2
ckpt_every = 1000
log_every = 1
''' + TINY_MODEL.format(extra="")


def write(path, text, **fields):
    path.write_text(text.format(**fields))
    return str(path)


@pytest.fixture(scope="module")
def noTemp(assets, tmp_path_factory):  # noqa: F811
    """The inference config's tiny model: its config file and its weights exported
    to reference torch names."""
    root = tmp_path_factory.mktemp("stage1_infer")
    cfg_path = write(root / "probe.py", CFG_INFER, base=os.path.join(REPO, NOTEMP_CONFIG),
                     out_dir=str(root / "probe_out"),
                     vae_root=os.path.dirname(assets["vae_dir"]))
    jcfg = JConfig.fromfile(cfg_path)
    mcfg = jbuild_cfg(jcfg.model, vae_out_channels=16, mv_order_map=jcfg.mv_order_map,
                      dtype=jnp.float32)
    assert (mcfg.with_temp_block, mcfg.control_skip_temporal) == (False, True)
    batch = synthetic_batch(mcfg, 1, HH, WW, l_txt=16)
    jb = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in batch.items() if k != "timestep"}
    params = random_params(JModel(mcfg), **jb, timestep=jnp.full((1,), 500.0))
    state = export_torch_state_dict(np_tree(params), mcfg.control_depth)
    assert not any(k.startswith(("base_blocks_t.", "control_blocks_t.")) for k in state)
    ckpt = str(root / "model.pt")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}, ckpt)
    return dict(ckpt=ckpt, vae_root=os.path.dirname(assets["vae_dir"]))


def test_inference_app_on_the_noTemp_config_matches_jax(noTemp, tmp_path, monkeypatch,
                                                        caplog):
    """One sample: the latents each app decodes (1 latent frame) and the one PNG
    frame of the 2x3 grid, written by both as ``<path>.png`` and read back."""
    from magicdrive_v2_tpu_torch.scripts import inference_magicdrive
    rec = Recorder(monkeypatch)
    cfg = write(tmp_path / "cfg.py", CFG_INFER, base=os.path.join(REPO, NOTEMP_CONFIG),
                out_dir=str(tmp_path / "out"), vae_root=noTemp["vae_root"])
    argv = [cfg, "--synthetic", "--ckpt-path", noTemp["ckpt"]]
    run_jax_app("inference_magicdrive", argv, monkeypatch)
    with caplog.at_level("INFO", logger="inference"):
        saved = inference_magicdrive.main(argv + ["--device", "cpu"])
    assert loaded_keys_message(caplog) == [f"loaded {noTemp['ckpt']}: 0 missing, 0 unused keys"]
    compare_latents(rec)
    assert rec.latents["port"][0].shape == (6, 16, 1, HH // 8, WW // 8)
    assert [p + ".png" for p, _, _ in rec.jax_saved] == [p for p, _ in saved]
    assert len(saved) == 1
    (path, frames), (_, ref, _) = saved[0], rec.jax_saved[0]
    assert frames.shape == (1, 2 * HH, 3 * WW, 3)
    compare_frames(frames, ref, path)
    assert np.array_equal(read_png(path), frames[0])


def jax_step_draws(cfg, step, shape, num_frames):
    """The t and noise the JAX app's step ``step`` draws: its key is
    fold_in(PRNGKey(seed + 1), step), which ``training_losses`` splits into the
    keys of t and of the noise."""
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 1), step)
    t_key, n_key = jax.random.split(key)
    b = shape[0]
    hw = dict(height=jnp.full((b,), float(HH)), width=jnp.full((b,), float(WW)),
              num_frames=jnp.full((b,), float(num_frames)))
    t = JR.build_scheduler(dict(cfg.scheduler)).sample_t(t_key, b, **hw)
    noise = jax.random.normal(n_key, shape, jnp.float32)
    return torch.from_numpy(np.asarray(t)), torch.from_numpy(np.asarray(noise))


def test_train_app_on_the_stage1_config_matches_jax(tmp_path, monkeypatch):
    """Two steps of the stage-1 config (remat, logit-normal t, condition dropout):
    the JAX app on one device with every weight random, then the port's app with
    those weights and each step's t and noise from the JAX step's key. The port's
    TensorBoard scalars (one event file: rank 0's) equal its metrics lines."""
    import magicdrive_v2_tpu_torch.training.trainer as TT
    import magicdrive_v2_tpu_torch.utils.ckpt as tckpt
    from magicdrive_v2_tpu_torch.config.config import Config
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive

    base = os.path.join(REPO, STAGE1_CONFIG)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcfg_path = write(tmp_path / "jax.py", CFG_TRAIN, base=base, out_dir=str(jdir))
    tcfg_path = write(tmp_path / "port.py", CFG_TRAIN, base=base, out_dir=str(tdir))
    init, weights = JModel.init, {}

    def random_init(self, *args, **kwargs):
        assert (self.cfg.with_temp_block, self.cfg.control_skip_temporal) == (False, True)
        params = fill_tree(jax.eval_shape(lambda: init(self, *args, **kwargs)))
        weights["params"] = np_tree(params)  # the app's step donates its buffers
        return params

    one = jax.devices()[:1]
    monkeypatch.setattr(JModel, "init", random_init)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    monkeypatch.setenv("MDV2_JAXCACHE_DIR", "")
    run_jax_app("train_magicdrive", [jcfg_path, "--synthetic", "--max-steps", "2"]
                + STAGE1_BUCKET, monkeypatch)
    with open(jdir / "metrics.jsonl") as f:
        ref = [json.loads(line) for line in f]

    cfg = Config.fromfile(tcfg_path)
    assert cfg.grad_checkpoint and cfg.scheduler["sample_method"] == "logit-normal"

    def jax_weights(model, seed):
        load_state_dict_cast(model, from_jax_params(weights["params"],
                                                    model.cfg.control_depth), strict=True)

    build = TT.build_training_multibucket

    def handing_draws(*args, **kwargs):
        state, get_step = build(*args, **kwargs)

        def get(h, w, t_img, **kw):
            assert (h, w, t_img) == (HH, WW, 1)
            step_fn = get_step(h, w, t_img, **kw)

            def step(state, batch):
                t, noise = jax_step_draws(cfg, state.step, tuple(batch["x"].shape), t_img)
                return step_fn(state, batch, t=t, noise=noise)
            return step
        return state, get

    monkeypatch.setattr(tckpt, "init_weights", jax_weights)
    monkeypatch.setattr(TT, "build_training_multibucket", handing_draws)
    lines = train_magicdrive.main([tcfg_path, "--synthetic", "--max-steps", "2", "--device",
                                   "cpu"] + STAGE1_BUCKET)
    assert [x["step"] for x in lines] == [x["step"] for x in ref] == [1, 2]
    for mine, theirs in zip(lines, ref):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(mine[k], theirs[k], rtol=METRICS_RTOL, err_msg=k)
    with open(tdir / "metrics.jsonl") as f:
        written = [json.loads(line) for line in f]
    assert written == lines
    scalars = read_scalars(str(tdir / "tb"))
    assert sorted(scalars) == ["grad_norm", "loss"]
    for tag, events in scalars.items():
        assert events == [(x["step"], float(np.float32(x[tag]))) for x in written], tag


def test_train_app_writes_no_tensorboard_without_the_package(tmp_path, monkeypatch, caplog):
    """When ``torch.utils.tensorboard`` does not import, the app trains on and
    ``metrics.jsonl`` alone holds the scalars."""
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = tmp_path / "out"
    with caplog.at_level("WARNING", logger="train"):
        lines = train_magicdrive.main([
            os.path.join(REPO, "configs/magicdrive/train/smoke_tiny.py"), "--synthetic",
            "--max-steps", "1", "--device", "cpu", "--cfg-options", f"outputs={out}",
            "ckpt_every=0", "report_every=0"])
    assert [x["step"] for x in lines] == [1]
    assert not (out / "tb").exists()
    assert "no TensorBoard scalars (" in caplog.text
    with open(out / "metrics.jsonl") as f:
        assert [json.loads(line) for line in f] == lines


def test_encode_stage_and_two_train_steps_at_one_frame_match_jax(assets, tmp_path):  # noqa: F811
    """``test_torch_train_data``'s loader, encode and trainer checks on 1-frame clips
    of the generated set with the stage-1 model: the causal VAE's one-frame encode
    and the one-frame branches of the timestep shift and the embedders."""
    assert encode_and_train_against_jax(assets, tmp_path, stage1=True) == 1


def test_chip_smoke_derives_the_stage1_train_launches(monkeypatch):
    """chip_smoke.py holds phase stage1's launches and Function backwards against
    counts derived from the stage-1 layout (``blocks_of``: no temporal block): a
    train step under remat launches each kernel twice a forward (the forward and
    the recompute) and backs every call once. Here the wrappers go through
    ``KernelFunction`` where autograd records, as on the card, around the plain
    versions; the tiny model at 1 frame, the trainer's grad step."""
    import chip_smoke
    from magicdrive_v2_tpu_torch.ops import kernel_vjp
    from magicdrive_v2_tpu_torch.tools.block_bench import patch_points
    from magicdrive_v2_tpu_torch.tools.perf_lab import build_train_step
    from test_torch_common import kernel_sites_as_on_the_card

    calls = {}
    for (module, attr), site in zip(patch_points(), kernel_sites_as_on_the_card(calls)):
        monkeypatch.setattr(module, attr, site)
    step, model, _, batch = build_train_step(1, 64, 80, device="cpu", tiny=True, rows=2,
                                             with_temp_block=False, control_skip_temporal=True)
    assert len(model.base_blocks_t) == len(model.control_blocks_t) == 0
    with torch.no_grad():
        model.encode_conditions(tuple(batch["x"].shape), batch["y"], batch["maps"],
                                batch["bbox"], batch["cams"], batch["rel_pos"])
    encode, _ = dict(calls), calls.clear()
    monkeypatch.setattr(kernel_vjp, "backward_calls", {})
    step()
    per_forward = chip_smoke.expected_launches(model.cfg, x_mask=True)
    assert calls == {k: 2 * n + encode.get(k, 0) for k, n in per_forward.items()}
    assert kernel_vjp.backward_calls == {k: n + encode.get(k, 0) for k, n in per_forward.items()}
