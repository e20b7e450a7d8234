"""PyTorch port, the train app on a dataset config: the loader's batches, the
encode stage (model batch, VAE latents, text) and two train steps against the JAX
package on the CPU; and the app's resume on data, bit for bit.

Data: ``tests/helpers_mini_nuscenes.generate`` at 24x40: scenes of 9 and 19
frames and clips of 9 (3 latent frames, so the temporal blocks have grads) for the
parity test, scenes of 6 and clips of 3 for the resume test. The parity test collates without box dropout or addition
(``is_train=False``), so the JAX datasets, whose generators are unseeded, draw
nothing that changes an item; the resume test uses the training presets (dropout
and addition on), which the port draws from (seed, epoch, index).

Weights: the tiny flagship (hidden 64, depth 2 / control depth 1, fp32) with every
JAX leaf random, carried by ``from_jax_params``; a tiny CogVideoX VAE with random
weights on both sides.

Limits: the VAE's posterior moments 2e-5 absolute (the VAE's fp32 parity), the
latents fed to the steps therefore the same up to that; the two train steps as in
``tests/test_torch_training.py::test_two_train_steps_match_jax`` (metrics 2e-5
relative; parameters within 2e-6, or within the two opposite steps an element
whose grad lies below the packages' agreement may take).
"""
import copy
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_common import fill_tree, j, load_into, np_tree, random_params, t

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.config.config import Config as JConfig
from magicdrive_v2_tpu.datasets import clip_to_model_batch as jclip_to_model_batch
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.models.magicdrive.stdit3 import build_model_config as jbuild_cfg
from magicdrive_v2_tpu.models.text_encoder.t5 import DummyTextEncoder as JDummy
from magicdrive_v2_tpu.models.vae import cogvideox as jvae_mod
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu.training import trainer as JT
from magicdrive_v2_tpu.utils import train_utils as JU
from magicdrive_v2_tpu_torch.config.config import Config
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3 as TModel
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
from magicdrive_v2_tpu_torch.models.vae import cogvideox as tvae_mod
from magicdrive_v2_tpu_torch.schedulers import rf as TR
from magicdrive_v2_tpu_torch.training import trainer as TT
from magicdrive_v2_tpu_torch.utils import train_utils as TU
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params, load_state_dict_cast
from magicdrive_v2_tpu_torch.utils.misc import to_device

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from helpers_mini_nuscenes import generate  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_VAE = dict(block_out_channels=[8, 8, 8, 16], latent_channels=16, layers_per_block=1,
                norm_num_groups=4)
SEED = 11

CFG = '''
from magicdrive_v2_tpu.config.presets import (MV_ORDER_MAP, img_collate_param, rflow,
                                              xl2_model)
from magicdrive_v2_tpu.config.yaml_compose import load_yaml_config

dtype = "fp32"
seed = {seed}
outputs = {out_dir!r}
num_frames = {num_frames}
image_size = (24, 40)
bbox_mode = "all-xyz"
mv_order_map = MV_ORDER_MAP
vae_out_channels = 16
img_collate_param_train = dict(img_collate_param(bbox_mode, is_train={is_train}),
                               template="A driving scene image at {{location}}. {{description}}.")

model = xl2_model(bbox_mode=bbox_mode, control_skip_temporal=False)
model.update(depth=2, control_depth=1, hidden_size=64, num_heads=4)
model["bbox_embedder_param"].update(class_token_dim=64, proj_dims=[64, 32, 32, 64],
                                    num_heads=4)
model["frame_emb_param"].update(num_heads=4)
model["map_embedder_param"].update(block_out_channels=[8, 16, 24, 32])
model["model_max_length"] = 16
model.pop("from_pretrained", None)

scheduler = rflow(sample_method="logit-normal")
val_scheduler = rflow(num_sampling_steps=2)
text_encoder = dict(type="t5-dummy", model_max_length=16)
vae = dict(from_pretrained={vae_dir!r}, micro_frame_size=None, micro_batch_size=None)

_yaml = load_yaml_config({yaml_path!r})
_pipe = _yaml["train_pipeline"]
for _t in _pipe:
    if _t["type"] == "ImageAug3D":
        _t["final_dim"] = [24, 40]
        _t["resize_lim"] = [0.25, 0.25]
_train = dict(_yaml["data"]["train"], ann_file={ann_file!r}, dataset_root="", pipeline=_pipe)
_val = dict(_yaml["data"]["val"], ann_file={ann_file!r}, dataset_root="", pipeline=_pipe,
            img_collate_param=dict(img_collate_param(bbox_mode, is_train=False),
                                   template=_yaml["template"]))
dataset = dict(data=dict(train=_train, val=_val))

lr = 1e-3
adam_eps = 1e-8
warmup_steps = 3
grad_clip = 0.05
grad_checkpoint = False
batch_size = {batch_size}
epochs = 2
ckpt_every = 100
log_every = 1
mask_ratios = dict(image_head=0.5)
drop_cond_ratio = 0.5
drop_cond_ratio_t = 0.4
num_workers = 2
report_every = {report_every}
validation_index = [1]
num_validation = 1
'''


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The data and the tiny VAE as a snapshot, with its JAX parameters."""
    root = tmp_path_factory.mktemp("train_data")
    ann = {"short": generate(str(root / "short"), scene_lengths=(6, 6)),
           "long": generate(str(root / "long"), scene_lengths=(9, 19))}
    cfg = jvae_mod.CogVAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in TINY_VAE.items()})
    shapes = jax.eval_shape(lambda: jvae_mod.AutoencoderKLCogVideoX(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 1, 16, 16))))
    vparams = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 1.0 if getattr(p[-1], "key", "") == "scale" else v,
        fill_tree(shapes, 5, std=0.1))
    tvae = tvae_mod.VideoAutoencoderKLCogVideoX(
        tvae_mod.CogVAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in TINY_VAE.items()}), device="cpu")
    load_state_dict_cast(tvae.module, from_jax_params(np_tree(vparams)), strict=True)
    vae_dir = root / "vae"
    vae_dir.mkdir()
    (vae_dir / "config.json").write_text(json.dumps(TINY_VAE))
    torch.save(tvae.module.state_dict(), vae_dir / "diffusion_pytorch_model.bin")
    return dict(root=root, ann=ann, vae_dir=str(vae_dir), vae_cfg=cfg, vae_params=vparams)


def write_config(path, assets, is_train=False, batch_size=2, report_every=None, long=True):
    path.write_text(CFG.format(seed=SEED, out_dir=str(path.parent / "out"),
                               ann_file=assets["ann"]["long" if long else "short"],
                               num_frames=9 if long else 3, vae_dir=assets["vae_dir"],
                               is_train=is_train, batch_size=batch_size,
                               report_every=report_every,
                               yaml_path=os.path.join(REPO, "configs/dataset/Nuscenes.yaml")))
    return str(path)


def jax_train_script():
    path = os.path.join(REPO, "scripts", "train_magicdrive.py")
    spec = importlib.util.spec_from_file_location("jax_app_train_magicdrive", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same(a, b, where="batch"):
    if isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert a == b, where
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), where
    else:
        assert a == b, (where, a, b)


def test_encode_stage_and_two_train_steps_match_jax(assets, tmp_path):
    """The loaders' first two batches equal; the encode stage's model batch equals
    JAX's ``clip_to_model_batch`` with the same generator, its VAE moments are
    within 2e-5 of the JAX VAE's, and its latents are those moments' sample with
    the noise the port drew (from (seed + 7, step)); then two steps of the port's
    trainer on those batches against two of JAX's."""
    from magicdrive_v2_tpu_torch.pipelines.magicdrive import build_text_encoder, build_vae
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive as app
    path = write_config(tmp_path / "cfg.py", assets)
    jcfg, tcfg = JConfig.fromfile(path), Config.fromfile(path)
    jloader, _ = jax_train_script().build_dataloader(jcfg, 1)
    tloader, _, _ = app.build_dataloader(tcfg, SEED)
    raws = []
    for (jraw, traw), _ in zip(zip(jloader, tloader), range(2)):
        assert_same(traw, jraw)
        raws.append(traw)

    vae = build_vae(tcfg, torch.float32, "cpu", 0)
    assert vae.cfg.block_out_channels == (8, 8, 8, 16)  # the snapshot's
    te = build_text_encoder(tcfg, "cpu")
    jvae = jvae_mod.VideoAutoencoderKLCogVideoX(assets["vae_cfg"])
    jvae.params = assets["vae_params"]
    mcfg = build_model_config(tcfg.model, vae_out_channels=16, mv_order_map=tcfg.mv_order_map,
                              dtype=torch.float32, grad_checkpoint=False)
    box_dim = dict(mcfg.bbox_embedder_param)["class_token_dim"]
    batches = []
    for step, raw in enumerate(raws):
        batch = app.encode_batch(raw, vae, te, box_latent_dim=box_dim, seed=SEED, step=step,
                                 device="cpu")
        ref = jclip_to_model_batch(raw, box_latent_dim=box_dim,
                                   rng=np.random.default_rng((SEED + 13, step)))
        x_px = ref.pop("x")
        assert_same({k: v for k, v in batch.items() if k not in ("x", "y")},
                    {k: v for k, v in ref.items() if k != "captions"})
        moments = np.asarray(jvae._encode_micro_batched(j(x_px), jvae.params))
        tmoments = vae.encode_moments_seq(torch.from_numpy(x_px)).numpy()
        np.testing.assert_allclose(tmoments, moments, atol=2e-5)
        mean, logvar = np.split(moments, 2, axis=1)
        eps = torch.randn(mean.shape, generator=TT.step_generator(SEED + 7, step)).numpy()
        lat = (mean + np.exp(0.5 * np.clip(logvar, -30, 20)) * eps) * vae.scaling_factor
        b = raw["pixel_values"].shape[0]
        lat = lat.reshape(b, 6, *lat.shape[1:]).transpose(0, 2, 1, 3, 4, 5).reshape(
            b, -1, *lat.shape[2:])
        np.testing.assert_allclose(batch["x"].numpy(), lat, atol=1e-4)
        np.testing.assert_array_equal(
            batch["y"].numpy(), np.asarray(JDummy(model_max_length=16).encode(
                ref["captions"])["y"]))
        batches.append(batch)

    # two train steps on those batches: the JAX step (jit) against the port's
    jmcfg = jbuild_cfg(jcfg.model, vae_out_channels=16, mv_order_map=jcfg.mv_order_map,
                       dtype=jnp.float32, grad_checkpoint=False)
    jmodel = JModel(jmcfg)
    mask_gen = TU.MaskGenerator(dict(tcfg.mask_ratios))
    steps = [app.step_inputs(to_device(bt, "cpu"), tcfg, mask_gen, SEED, i)
             for i, bt in enumerate(batches)]
    (b0, (nf, hh, ww)) = steps[0]
    np_batch = lambda bt: {k: ({kk: vv.numpy() if torch.is_tensor(vv) else vv  # noqa: E731
                                for kk, vv in v.items()} if isinstance(v, dict)
                               else v.numpy() if torch.is_tensor(v) else v)
                           for k, v in bt.items()}
    jb = lambda bt: {k: ({kk: j(vv) for kk, vv in v.items()} if isinstance(v, dict)  # noqa: E731
                         else j(v)) for k, v in np_batch(bt).items()}
    cond = {k: v for k, v in jb(b0).items() if k not in ("mask", "drop_cond_mask",
                                                          "drop_frame_mask")}
    params = random_params(jmodel, **cond, timestep=jnp.full((2,), 500.0), height=hh,
                           width=ww)
    hyper = dict(lr=1e-3, weight_decay=1e-2, adam_eps=1e-8, grad_clip=0.05, warmup_steps=3)
    jsched = JR.build_scheduler(dict(tcfg.scheduler))
    jmask = JU.trainable_mask(params)
    tx = JU.make_optimizer(trainable=jmask, **hyper)
    jstate = JT.create_train_state(params, tx)
    jstep = jax.jit(JT.make_train_step(jmodel, jsched, tx, height=hh, width=ww,
                                       num_frames=nf, ema_decay=0.99, ema_mask=jmask))
    model = load_into(TModel(mcfg), params, control_depth=mcfg.control_depth).train()
    tmask = TU.trainable_mask(model.named_parameters())
    opt = TU.make_optimizer(model.named_parameters(), trainable=tmask, **hyper)
    state = TT.TrainState(step=0, model=model, optimizer=opt,
                          ema=copy.deepcopy(model).requires_grad_(False))
    tstep = TT.make_train_step(TR.build_scheduler(dict(tcfg.scheduler)), height=hh,
                               width=ww, num_frames=nf, dtype=torch.float32, ema_decay=0.99,
                               ema_mask=tmask)
    weak = {name: torch.zeros(p.shape, dtype=torch.bool)
            for name, p in model.named_parameters()}
    hw = {k: j(np.full((2,), v, np.float32)) for k, v in (("height", hh), ("width", ww),
                                                          ("num_frames", nf))}
    for i, (bt, _) in enumerate(steps):
        key = jax.random.PRNGKey(20 + i)
        t_key, n_key = jax.random.split(key)
        tt = jsched.sample_t(t_key, 2, **hw)
        noise = jax.random.normal(n_key, bt["x"].shape, jnp.float32)
        jstate, jm = jstep(jstate, jb(bt), key)
        state, m = tstep(state, to_device(bt, "cpu"), t=t(np.asarray(tt)),
                         noise=t(np.asarray(noise)))
        for k in ("loss", "grad_norm", "t_mean"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5, err_msg=k)
        for name, p in model.named_parameters():
            g = p.grad.abs()
            weak[name] |= (g <= 2e-4 * g.max()) & bool(g.max() > 0)
    sched = TU.multistep_warmup_schedule(hyper["lr"], hyper["warmup_steps"])
    flip = 2 * (sched(0) + sched(1)) * (1 + hyper["weight_decay"])
    overall = sum(int(w.sum()) for w in weak.values()) / sum(w.numel() for w in weak.values())
    assert overall <= 0.05, overall
    for tree, module in ((jstate.params, state.model), (jstate.ema_params, state.ema)):
        ref = from_jax_params(np_tree(tree), mcfg.control_depth)
        for name, p in module.named_parameters():
            err = np.abs(p.detach().numpy() - ref[name])
            assert float(err.max()) <= flip, (name, float(err.max()))
            np.testing.assert_array_less(err[~weak[name].numpy()], 2e-6, err_msg=name)


def _app(cfg, steps, *extra):
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    return train_magicdrive.main([cfg, "--device", "cpu", "--max-steps", str(steps), *extra])


def test_train_app_on_data_resumes_bit_for_bit(assets, tmp_path, caplog):
    """6 steps (4 clips a epoch, batch 1: two epochs) in one run equal 3 steps plus
    a resume of 3 bit for bit: the metrics, the model, EMA and optimizer at step 6,
    the running states (the sampler's position and the epoch) at the break; the
    box dropout and addition of the training presets are drawn. Validation renders
    a clip of the val split at step 6."""
    a, b = ((tmp_path / d).mkdir() or write_config(tmp_path / d / "cfg.py", assets,
                                                   is_train=True, batch_size=1,
                                                   report_every=6, long=False)
                  for d in ("a", "b"))
    whole = _app(a, 6)
    first = _app(b, 3)
    with open(tmp_path / "b" / "out" / "global_step3" / "running_states.json") as f:
        assert json.load(f) == {"epoch": 0, "epoch_step": 3, "step": 3,
                                "sampler": {"epoch": 0, "start_index": 3}}
    with caplog.at_level("INFO", logger="train"):
        second = _app(b, 3)
    assert any(r.getMessage().endswith("at step 3") for r in caplog.records)
    key = lambda lines: [(x["step"], x["loss"], x["grad_norm"]) for x in lines]  # noqa: E731
    assert key(whole) == key(first + second) and [x["step"] for x in whole] == list(range(1, 7))
    for name in ("model.pt", "ema.pt", "optimizer.pt"):
        x = torch.load(tmp_path / "a" / "out" / "global_step6" / name)
        y = torch.load(tmp_path / "b" / "out" / "global_step6" / name)
        if name == "optimizer.pt":
            assert x["count"] == y["count"] == 6
            x, y = ({i: s["exp_avg"] for i, s in d["adamw"]["state"].items()} for d in (x, y))
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x), name
    for d in ("a", "b"):
        with open(tmp_path / d / "out" / "global_step6" / "running_states.json") as f:
            assert json.load(f) == {"epoch": 1, "epoch_step": 2, "step": 6,
                                    "sampler": {"epoch": 1, "start_index": 2}}
    # 3 pixel frames are one latent frame, which decodes to one frame
    assert os.listdir(tmp_path / "a" / "out" / "validation") == ["step6_val0_0.png"]
