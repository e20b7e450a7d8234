"""PyTorch port, data-parallel training on the CPU: ``parallel/fsdp.py`` (the JAX
package's ``param_spec``; the fp32 state split over dp, the gathers of the
forward and the reduce-scatters of the backward), the order of the grad
reductions (the mean over dp, then the sum over sp, then the clip), the draws
made for the global batch and sliced by dp rows, the sharded checkpoints in the
one-process format, and both train apps on a (dp, sp) mesh, against one process
of the port on the global batch and against the JAX package.

The ranks are two gloo groups started once for the module by ``spawn_ranks``,
each with a deadline, running ``tests/torch_sp_train_worker.py`` through the
port's plain kernel versions: 2 ranks on a (2, 1) mesh (the model cases and the
apps) and 4 ranks on a (2, 2) mesh. They run while this process compiles its
JAX references (on the virtual CPU devices of ``tests/conftest.py``). The models
are those of ``tests/test_torch_sp_train.py`` (the tiny flagship: hidden 64, 4
heads, depth 2 / control depth 1, fp32, every JAX leaf random; the tiny
SDE-BrushNet) on 9 frames of 48x80: tokens 3x5, so S=15 takes the sp pad (H 3
-> 4) at sp=2. The model cases split every parameter of at least 2**10
elements (``fsdp_min_size``): at this width 87 of 214, over 90 % of the
elements; the apps use the JAX package's 2**18.

Tolerances are that file's: against JAX the loss 1e-5 relative and the grads
2e-4 of each tensor's largest |g|; against one process of the port the loss
1e-6 relative, the first step's grads 2e-4 of each tensor's largest |g|, the
parameters and EMA after two AdamW steps within two opposite steps where a grad
lies below that agreement and within 2e-6 elsewhere. Resumes and round trips of
a checkpoint are held bit for bit.
"""
import dataclasses
import os
import shutil

import numpy as np
import optax
import pytest
import torch

from test_torch_common import j, load_into, np_tree, random_params, spawn_ranks, tiny_configs
from test_torch_sp_train import (HYPER, RAW_GRADS, SCHED, VAE_TINY, _jax_batch,
                                 assert_grads_match_jax, assert_steps_close, flip_bound,
                                 port_cfg)
from torch_sp_train_worker import run_steps

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from magicdrive_v2_tpu.models.magicdrive import brushnet as JB
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.ops.structured_noise import sample_cutoff_radius as j_cutoff
from magicdrive_v2_tpu.parallel.fsdp import param_spec as j_param_spec
from magicdrive_v2_tpu.parallel.fsdp import shard_params as j_shard_params
from magicdrive_v2_tpu.parallel.sharding import make_mesh as j_make_mesh
from magicdrive_v2_tpu.parallel.sharding import use_mesh as j_use_mesh
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu.training import trainer as JT
from magicdrive_v2_tpu_torch.models.magicdrive import brushnet as TB
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3 as TModel
from magicdrive_v2_tpu_torch.models.vae.cogvideox import CogVAEConfig, VideoAutoencoderKLCogVideoX
from magicdrive_v2_tpu_torch.parallel.fsdp import MIN_SHARD_SIZE, param_spec
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.utils.ckpt import (_iter_tree, _torch_key, from_jax_params,
                                                init_weights)
from magicdrive_v2_tpu_torch.utils.misc import to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_sp_train_worker.py")
SMOKE = os.path.join(REPO, "configs/magicdrive/train/smoke_tiny.py")
BRUSH_SMOKE = os.path.join(REPO, "configs/magicdrive/train/brushnet_smoke.py")
DEADLINE_S = 300
NF, HH, WW = 9, 48, 80
B = 4  # the global batch of the flagship cases: 2 rows a dp row
MAP_SIZE = (8, 100, 100)  # BEV maps (the default 400x400 costs 15x the step at this size)
MIN_SIZE = 2 ** 10
POLICIES = ("full", "dots", "offload_carry")
MESHES = {"dp2": (2, 1), "dp2sp2": (2, 2)}
SDE_SCHED = dict(SCHED, type="rflow-sdebrushnet")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    yield
    torch.set_num_threads(n)


def hw(b):
    return dict(height=np.full((b,), float(HH), np.float32),
                width=np.full((b,), float(WW), np.float32),
                num_frames=np.full((b,), float(NF), np.float32))


@pytest.fixture(scope="module")
def setup():
    """JAX and port configs of the tiny flagship, the JAX params, the port's state
    dict, and a global batch of 4 samples with frame masks and per-frame ego poses."""
    jcfg, tcfg = tiny_configs(grad_checkpoint=False)
    batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=16, b=B, map_size=MAP_SIZE, seed=5)
    for k in ("timestep", "height", "width"):
        batch.pop(k)
    batch["mask"] = np.array([[1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 1, 1]], np.float32)
    batch["rel_pos"] = np.random.default_rng(6).standard_normal(
        batch["rel_pos"].shape).astype(np.float32)
    params = random_params(JModel(jcfg), **{k: v for k, v in _jax_batch(batch).items()
                                            if k != "mask"}, timestep=jnp.full((B,), 500.0),
                           height=float(HH), width=float(WW))
    state = load_into(TModel(tcfg), params, control_depth=tcfg.control_depth).state_dict()
    return jcfg, tcfg, params, state, batch


@pytest.fixture(scope="module")
def sde(setup):
    """(JAX config, port config, params, port state, global batch of 2) of the tiny
    SDE-BrushNet."""
    jcfg, tcfg, *_ = setup
    jb = JB.BrushNetConfig(**{**dataclasses.asdict(jcfg), "sde_inpaint": True})
    tb = TB.BrushNetConfig.from_base(tcfg, sde_inpaint=True)
    batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=8, b=2, map_size=MAP_SIZE, seed=3)
    for k in ("timestep", "height", "width"):
        batch.pop(k)
    rng = np.random.default_rng(0)
    batch["x_inpaint"] = rng.standard_normal((2, 3 * tcfg.nc, NF, HH, WW)).astype(np.float32)
    batch["mask_inpaint"] = rng.integers(0, 2, (2, tcfg.nc, NF, HH, WW)).astype(np.float32)
    batch["mask"] = np.array([[1, 1, 0], [1, 0, 1]], np.float32)
    params = random_params(JB.MagicDriveSTDiT3BrushNet(jb), **_jax_batch(
        {k: v for k, v in batch.items() if k != "mask"}), timestep=jnp.full((2,), 500.0),
        t_inpaint=jnp.full((2,), 300.0), height=float(HH), width=float(WW),
        rngs_key=jax.random.PRNGKey(5))
    state = load_into(TB.MagicDriveSTDiT3BrushNet(tb), params,
                      control_depth=tb.control_depth).state_dict()
    return jb, tb, params, state, batch


def jax_draws(batch, n):
    """t and noise of n steps for the global batch, as the JAX step draws them from
    PRNGKey(10 + i)."""
    jsched = JR.build_scheduler(SCHED)
    b = batch["x"].shape[0]
    out = []
    for i in range(n):
        t_key, n_key = jax.random.split(jax.random.PRNGKey(10 + i))
        tt = jsched.sample_t(t_key, b, **{k: j(v) for k, v in hw(b).items()})
        noise = jax.random.normal(n_key, batch["x"].shape, jnp.float32)
        out.append(dict(t=torch.from_numpy(np.array(tt)),
                        noise=torch.from_numpy(np.array(noise))))
    return out


def jax_sde_draws(jcfg, batch):
    """t, t_inpaint, noise, the cutoff and the structured noise's normal draw of one
    SDE-BrushNet step for the global batch, as JAX's make_brushnet_train_step draws
    them from PRNGKey(10): the step's split into the loss's key and the model's,
    the loss's into t, t_inpaint and noise, the model's into the cutoff and the
    normal draw of shape (b*NC*C*T', H', W')."""
    jsched = JR.build_scheduler(SDE_SCHED)
    x = batch["x"]
    b = x.shape[0]
    hwj = {k: j(v) for k, v in hw(b).items()}
    loss_key, noise_key = jax.random.split(jax.random.PRNGKey(10))
    t_key, ti_key, n_key = jax.random.split(loss_key, 3)
    cutoff_key, normal_key = jax.random.split(noise_key)
    draws = dict(t=jsched.sample_t(t_key, b, **hwj), t_inpaint=jsched.sample_t(ti_key, b, **hwj),
                 noise=jax.random.normal(n_key, x.shape, jnp.float32),
                 inpaint_input_noise=jax.random.normal(
                     normal_key, (b * x.shape[1] * x.shape[2],) + x.shape[3:], jnp.float32))
    out = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    out["cutoff_radius"] = float(j_cutoff(cutoff_key, jcfg.structured_noise_r0))
    return out


def steps_case(cfg, state, batch, draws, hyper, mesh, **kw):
    return dict(kind="steps", cfg=cfg, state=state, batch=to_device(batch, "cpu"),
                height=float(HH), width=float(WW), num_frames=NF, scheduler=SCHED,
                hyper=hyper, draws=draws, mesh=mesh, fsdp_min_size=MIN_SIZE, **kw)


def model_cases(setup, sde, mesh):
    """The flagship under each remat policy (2 steps, warm-up and a clip that
    triggers; JAX's draws), one step of raw grads for JAX of each model (JAX's
    draws handed in), the SDE-BrushNet under
    each policy (2 steps, every draw made by the step), and the train app's encode
    of 6 views (3 a dp row), on ``mesh``."""
    _, tcfg, _, state, batch = setup
    jb, tb, _, bstate, bbatch = sde
    sp = mesh[1] > 1
    cfg = port_cfg(tcfg, enable_sequence_parallelism=sp, grad_checkpoint=True)
    bcfg = port_cfg(tb, enable_sequence_parallelism=sp, grad_checkpoint=True)
    out = {"raw": steps_case(cfg, state, batch, jax_draws(batch, 1), RAW_GRADS, mesh),
           "sde_raw": steps_case(bcfg, bstate, bbatch, [jax_sde_draws(jb, bbatch)],
                                 RAW_GRADS, mesh),
           "dp_encode": dict(kind="dp_encode", mesh=mesh, **encode_case())}
    for policy in POLICIES:
        out[f"base_{policy}"] = steps_case(dict(cfg, remat_policy=policy), state, batch,
                                           jax_draws(batch, 2), HYPER, mesh)
        out[f"sde_{policy}"] = steps_case(dict(bcfg, remat_policy=policy), bstate, bbatch,
                                          [{}, {}], HYPER, mesh, seed=7)
    return out


def encode_case():
    """A tiny VAE (seed 2) and 6 views of 9 frames at 32x40 (seed 8)."""
    vae = VideoAutoencoderKLCogVideoX(CogVAEConfig(**VAE_TINY), device="cpu")
    init_weights(vae.module, seed=2)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (6, 3, 9, 32, 40)).astype(np.float32))
    return dict(cfg=VAE_TINY, state=vae.module.state_dict(), x=x, seed=11)


def one_process(case):
    """``run_steps`` of the case in this process on the global batch: no mesh, the
    sp pad forced where the case's mesh has sp > 1."""
    cfg = dict(case["cfg"])
    if case["mesh"][1] > 1:
        cfg.update(enable_sequence_parallelism=False, force_pad_h_for_sp_size=case["mesh"][1])
    return run_steps(dict(case, cfg=cfg), None)


def _app_case(app, config, out, flags, opts):
    return dict(kind="app", app=app, argv=[config, "--synthetic", "--device", "cpu"] + flags
                + ["--cfg-options", f"outputs={out}"] + opts)


def app_cases(tmp):
    """The apps on the 2 ranks of the (2, 1) group, in this order (sp_size 1: dp=2):
    - ``whole``: 3 steps, a checkpoint every step, validation at step 3 with the EMA
      gathered by "allgather";
    - ``first`` then ``resume``: 2 steps (checkpoint at 2), then a resume of 1 step
      from that checkpoint with validation at step 3, ``val_gather_mode`` set to the
      JAX app's "checkpoint";
    - ``from_one``: a resume from a one-process checkpoint (written by this process
      before the ranks start) with no step, writing it back gathered;
    - ``brush``: the SDE-BrushNet app, 2 steps."""
    common = ["sp_size=1", "log_every=1"]
    d = {k: os.path.join(tmp, k) for k in ("whole", "resume", "from_one", "brush")}
    return {
        "app_whole": _app_case("train_magicdrive", SMOKE, d["whole"], ["--max-steps", "3"],
                               common + ["ckpt_every=1", "report_every=3",
                                         "val_gather_mode=allgather"]),
        "app_first": _app_case("train_magicdrive", SMOKE, d["resume"], ["--max-steps", "2"],
                               common + ["ckpt_every=2", "report_every=0"]),
        "app_resume": _app_case("train_magicdrive", SMOKE, d["resume"], ["--max-steps", "1"],
                                common + ["ckpt_every=1", "report_every=3",
                                          "val_gather_mode=checkpoint"]),
        "app_from_one": _app_case("train_magicdrive", SMOKE, d["from_one"],
                                  ["--max-steps", "0"], common + ["ckpt_every=4"]),
        "brush_app": _app_case("train_brushnet", BRUSH_SMOKE, d["brush"],
                               ["--sde", "--max-steps", "2"], ["sp_size=1"]),
    }


def _app(out, steps, *opts):
    """The train app in this process: ``steps`` steps, the config's options and
    ``opts``, writing under ``out``."""
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    return train_magicdrive.main([SMOKE, "--synthetic", "--device", "cpu", "--max-steps",
                                  str(steps), "--cfg-options", f"outputs={out}",
                                  "log_every=1", *opts])


@pytest.fixture(autouse=True, scope="module")
def _rank_groups(setup, sde, tmp_path_factory):
    """Both groups, started before the first test and run while this process
    compiles its JAX references. Before them this process writes the one-process
    checkpoint the ``from_one`` case resumes (2 steps of the app, global_step2),
    and a copy of it to compare against. Yields {mesh name: future of (each
    rank's results, each rank's log)} and the apps' directory."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = str(tmp_path_factory.mktemp("dp_train"))
    one = os.path.join(tmp, "one_process")
    _app(one, 2, "report_every=0")
    shutil.copytree(os.path.join(one, "global_step2"),
                    os.path.join(tmp, "from_one", "global_step2"))
    groups = {}
    for name, mesh in MESHES.items():
        cases = model_cases(setup, sde, mesh)
        if name == "dp2":
            cases.update(app_cases(tmp))
        os.makedirs(os.path.join(tmp, name))
        torch.save(cases, os.path.join(tmp, name, "inputs.pt"))
        groups[name] = (mesh[0] * mesh[1], os.path.join(tmp, name))

    def run(n, d):
        logs = spawn_ranks(n, [WORKER, d], DEADLINE_S)
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=True)
                for r in range(n)], logs

    with ThreadPoolExecutor(len(groups)) as pool:
        yield {name: pool.submit(run, *g) for name, g in groups.items()}, tmp


@pytest.fixture(scope="module")
def ranks(_rank_groups):
    futures, _ = _rank_groups
    return {name: f.result() for name, f in futures.items()}


@pytest.fixture(scope="module")
def cases(setup, sde):
    return {name: model_cases(setup, sde, mesh) for name, mesh in MESHES.items()}


def _jax_step(jmodel, make_step, params, batch, mesh_shape, control_depth):
    """One JAX train step (``make_step(capture)``) on a (dp, sp) mesh of virtual
    devices from PRNGKey(10), the params placed by ``shard_params`` and the batch
    split over dp, through an optax transformation that keeps the grads as its
    state: (loss, the grads in the port's names)."""
    dp, sp = mesh_shape
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    mesh = j_make_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])
    with j_use_mesh(mesh):
        sharded, _ = j_shard_params(params, mesh)
        jb = jax.tree_util.tree_map(  # split over dp where the leading dim is the batch's
            lambda a: jax.device_put(a, NamedSharding(
                mesh, P("dp", *[None] * (a.ndim - 1)) if a.ndim and a.shape[0] % dp == 0
                else P())), _jax_batch(batch))
        jstep = jax.jit(make_step(capture))
        jstate, jm = jstep(JT.create_train_state(sharded, capture), jb, jax.random.PRNGKey(10))
    return float(jm["loss"]), from_jax_params(np_tree(jstate.opt_state), control_depth)


def jax_flagship_step(setup, mesh_shape):
    """JAX's make_train_step of the tiny flagship on the mesh."""
    jcfg, tcfg, params, _, batch = setup
    jmodel = JModel(dataclasses.replace(jcfg, enable_sequence_parallelism=mesh_shape[1] > 1))
    return _jax_step(jmodel, lambda tx: JT.make_train_step(
        jmodel, JR.build_scheduler(SCHED), tx, height=HH, width=WW, num_frames=NF),
        params, batch, mesh_shape, tcfg.control_depth)


def jax_sde_step(sde, mesh_shape):
    """JAX's make_brushnet_train_step (sde=True) of the tiny SDE-BrushNet on the
    mesh."""
    jcfg, tcfg, params, _, batch = sde
    jmodel = JB.MagicDriveSTDiT3BrushNet(dataclasses.replace(
        jcfg, enable_sequence_parallelism=mesh_shape[1] > 1))
    return _jax_step(jmodel, lambda tx: JT.make_brushnet_train_step(
        jmodel, JR.build_scheduler(SDE_SCHED), tx, height=HH, width=WW, num_frames=NF,
        sde=True), params, batch, mesh_shape, tcfg.control_depth)


def same_on_every_rank(results, name):
    """The case's steps, equal on every rank (whole parameters, EMA and grads, and
    the metrics) bit for bit."""
    out = results[0][name]
    for r in results[1:]:
        for a, b in zip(out, r[name]):
            for k, v in a["metrics"].items():
                assert torch.equal(v, b["metrics"][k]), (name, k)
            for key in ("params", "ema", "grads"):
                for n, x in a[key].items():
                    assert torch.equal(x, b[key][n]), (name, key, n)
    return out


# --------------------------------------------------------------- (a) param_spec


def _jax_leaves(tree, control_depth):
    """(port names, the JAX leaf's shape) of every leaf of a flax tree."""
    for path, leaf in _iter_tree(tree.get("params", tree)):
        key, base = _torch_key(path, control_depth)
        names = [key] if base is None else [key.format(i=base + i)
                                            for i in range(leaf.shape[0])]
        yield names, tuple(leaf.shape)


@pytest.mark.parametrize("kind", ["flagship", "sde_brushnet"])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_param_spec_equals_jax(setup, sde, kind, dp):
    """(a) For every parameter of the tiny model, at the JAX package's min_size and at
    the model cases' 2**10: the port's rule on the torch tensor and JAX's
    ``param_spec`` on the flax leaf replicate the same parameters and split the
    others along a dim of the same length (the torch layout may transpose it), so a
    rank holds the same elements' count."""
    _, tcfg, params, _, _ = setup if kind == "flagship" else sde
    with torch.device("meta"):
        model = TModel(tcfg) if kind == "flagship" else TB.MagicDriveSTDiT3BrushNet(tcfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mesh = j_make_mesh(dp=dp, sp=1, devices=jax.devices()[:dp])
    split = {}
    for min_size in (MIN_SHARD_SIZE, MIN_SIZE):
        seen = set()
        for names, shape in _jax_leaves(params, tcfg.control_depth):
            spec = tuple(j_param_spec(shape, mesh, min_size=min_size))
            jdim = next((i for i, a in enumerate(spec) if a is not None), None)
            for name in (n for n in names if n in shapes):  # the rest are buffers here
                dim = param_spec(shapes[name], dp, min_size)
                assert (dim is None) == (jdim is None), (name, shape, shapes[name])
                if dim is not None:
                    assert shapes[name][dim] == shape[jdim], (name, shape, shapes[name])
                seen.add(name)
                split[min_size] = split.get(min_size, 0) + (dim is not None)
        assert seen == set(shapes)
    assert (split[MIN_SIZE] > 0) == (dp > 1)


# --------------------------------------------------------------- (e) the apps' rows


def test_app_rows_and_masks_equal_the_jax_apps_per_rank(tmp_path, monkeypatch):
    """(e) dp row d of the port's app draws what the JAX app draws on a process at
    dp offset d: the synthetic rows (JAX ``SyntheticLoader`` with seed_offset=d and
    dp 1) and the frame masks and condition dropout (JAX ``step_rng(...,
    per_rank=True)``). The JAX app runs in this process on one device, its mesh
    rows placed at offset d, its step replaced by one that records the batches."""
    import importlib.util
    import sys

    from magicdrive_v2_tpu.parallel import distributed as jdist
    from magicdrive_v2_tpu.training import trainer as jtrainer
    from magicdrive_v2_tpu.utils import ckpt as jckpt
    from magicdrive_v2_tpu_torch.config.config import Config
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive as app
    from magicdrive_v2_tpu_torch.utils.train_utils import MaskGenerator

    init = JModel.init

    def shapes_only(self, *args, **kwargs):  # the params' shapes, no forward
        shapes = jax.eval_shape(lambda: init(self, *args, **kwargs))
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    seen = []

    def recording_build(model, scheduler, params, cfg, **kw):
        def get_step(*a, **k):
            def step(state, batch, key):
                seen.append(jax.tree_util.tree_map(np.asarray, batch))
                return state, {"loss": jnp.float32(1.0), "grad_norm": jnp.float32(1.0)}
            return step
        return jtrainer.TrainState(step=0, params=params, opt_state=None,
                                   ema_params=None), get_step

    one = jax.devices()[:1]
    monkeypatch.setattr(JModel, "init", shapes_only)
    monkeypatch.setattr(jtrainer, "build_training_multibucket", recording_build)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    monkeypatch.setattr(jckpt, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setenv("MDV2_JAXCACHE_DIR", "")
    path = os.path.join(REPO, "scripts", "train_magicdrive.py")
    spec = importlib.util.spec_from_file_location("jax_train_magicdrive_app", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # 33 frames: 9 latent frames, so the frame masks can hold condition frames
    opts = ["batch_size=2", "drop_cond_ratio=0.5", "drop_cond_ratio_t=0.5",
            "synthetic_buckets=[(33,32,40)]",
            "mask_ratios={'random': 0.5, 'quarter_head': 0.3}"]
    cfg = Config.fromfile(SMOKE)
    from magicdrive_v2_tpu_torch.config.config import merge_dot_options
    merge_dot_options(cfg, opts)
    model_cfg = build_model_config(cfg.model, mv_order_map=cfg.mv_order_map,
                                   dtype=torch.float32)
    for d in (0, 1):
        seen.clear()
        monkeypatch.setattr(jdist, "local_dp_info", lambda dp, sp, d=d: (1, d))
        monkeypatch.setattr(sys, "argv", [path, SMOKE, "--synthetic", "--max-steps", "3",
                                          "--cfg-options", f"outputs={tmp_path}/{d}"] + opts)
        mod.main()
        assert len(seen) == 3
        holder = {"step": 0}
        loader = iter(app.SyntheticLoader(model_cfg, cfg, holder, dp_row=d))
        mask_gen = MaskGenerator(dict(cfg.mask_ratios))
        for step, ref in enumerate(seen):
            holder["step"] = step
            mine, _ = app.step_inputs(next(loader), cfg, mask_gen, cfg.seed, step, d)
            for k in ("x", "y", "bbox", "cams", "rel_pos", "mask", "drop_cond_mask",
                      "drop_frame_mask"):
                if isinstance(mine[k], dict):
                    for kk in mine[k]:
                        np.testing.assert_array_equal(mine[k][kk], ref[k][kk], err_msg=k)
                else:
                    np.testing.assert_array_equal(np.asarray(mine[k]), ref[k], err_msg=k)
    assert (np.asarray(seen[0]["mask"]) == 0).any()  # the masks are not all-true


# --------------------------------------------------------------- (b), (c), (d) the step


@pytest.fixture(scope="module")
def jax_steps(setup):
    return {name: jax_flagship_step(setup, mesh) for name, mesh in MESHES.items()}


@pytest.fixture(scope="module")
def jax_sde_steps(sde):
    """JAX's SDE-BrushNet step on the (2, 1) mesh and on one device. (On a mesh with
    sp > 1 JAX's SDE step does not run on the CPU: XLA's CPU FFT refuses the layout
    the sp split gives the structured noise's input, a RET_CHECK in fft_thunk.cc.)"""
    return {"dp2": jax_sde_step(sde, MESHES["dp2"]), "one_device": jax_sde_step(sde, (1, 1))}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_equals_jax(jax_steps, ranks, mesh):
    """(b, c) One step of raw grads (lr 0, no clip) on the (2, 1) and (2, 2) meshes
    against JAX's make_train_step on the same mesh with ``shard_params``: the loss
    and every grad. (The JAX steps compile while the ranks run.)"""
    results, _ = ranks[mesh]
    assert_grads_match_jax(same_on_every_rank(results, "raw")[0], jax_steps[mesh])


def test_sde_brushnet_sharded_step_equals_jax(cases, jax_sde_steps, ranks):
    """(d) One SDE-BrushNet step of raw grads on the (2, 1) mesh, JAX's draws for the
    global batch handed in (the step slices them by dp rows), against JAX's
    make_brushnet_train_step on the same mesh with ``shard_params``: the loss within
    1e-5 and the branch's grads within 2e-4 of each tensor's largest |g|. The
    ShallowEncoder's grads come through the structured noise's phase
    normalisation (x_hat / |x_hat|, small FFT magnitudes), where the packages
    disagree on one device already (~1.4e-3 of the largest |g|, below the 2e-3 held
    here): those must lie within that one-device disagreement plus 2e-4, so the
    split adds no more than the other grads may differ by. (Not on (2, 2): see
    ``jax_sde_steps``.)"""
    results, _ = ranks["dp2"]
    got = same_on_every_rank(results, "sde_raw")[0]
    jloss, ref = jax_sde_steps["dp2"]
    _, jone = jax_sde_steps["one_device"]
    one = one_process(cases["dp2"]["sde_raw"])[0]["grads"]
    np.testing.assert_allclose(float(got["metrics"]["loss"]), jloss, rtol=1e-5)
    shallow = [n for n in got["grads"] if n.startswith("shallow_encoder")]
    assert shallow and len(shallow) < len(got["grads"])
    for name, g in got["grads"].items():
        scale = float(np.abs(ref[name]).max())
        assert scale > 0, name
        err = float(np.abs(g.numpy() - ref[name]).max())
        bound = 2e-4 * scale
        if name in shallow:
            apart = float(np.abs(one[name].numpy() - jone[name]).max())
            assert apart <= 2e-3 * float(np.abs(jone[name]).max()), (name, apart)
            bound += apart
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_train_steps_equal_one_process(cases, ranks, mesh, policy):
    """(b, c) Two flagship steps on a (2, 1) mesh and on a (2, 2) mesh with the sp
    pad (S=15 padded to 20), under each remat policy, with a warm-up and a clip
    that triggers, JAX's draws for the global batch: the loss, the grads, the
    parameters and EMA after each step equal one process on the global batch (rows
    in dp order), on every rank alike."""
    results, _ = ranks[mesh]
    name = f"base_{policy}"
    got = same_on_every_rank(results, name)
    assert float(got[0]["metrics"]["grad_norm"]) > HYPER["grad_clip"]
    assert_steps_close(got, one_process(cases[mesh][name]), agree=2e-4,
                       flip=flip_bound(HYPER), loss_rtol=1e-6)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
def test_sde_brushnet_sharded_train_steps(cases, ranks, mesh, policy):
    """(d) Two SDE-BrushNet steps (the branch trains; the frozen base split too; t,
    t_inpaint, noise, the cutoff and the structured noise drawn for the global
    batch from (seed, step) and sliced by dp rows) equal one process's on the
    global batch; the frozen base gets no grad and stays put, in the model and the
    EMA (the EMA mask)."""
    results, _ = ranks[mesh]
    name = f"sde_{policy}"
    got = same_on_every_rank(results, name)
    case = cases[mesh][name]
    assert_steps_close(got, one_process(case), agree=2e-4, flip=flip_bound(HYPER),
                       loss_rtol=1e-6)
    frozen = [n for n in got[-1]["params"] if n not in got[-1]["grads"]]
    assert frozen
    for n in frozen:
        assert torch.equal(got[-1]["params"][n], case["state"][n])
        assert torch.equal(got[-1]["ema"][n], case["state"][n])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_encode_of_dp_rows_equals_one_process(ranks, mesh):
    """The train app's encode (``encode_latents``) of each dp row's 3 views, its
    posterior noise drawn for the 6 of the global batch and sliced by rows, scattered
    over the row's sp group (padded to 4 views at sp=2): the rows' latents, in dp
    order, are one process's encode of the 6 (within 2e-5), equal on the sp ranks of
    a row."""
    from magicdrive_v2_tpu_torch.scripts.train_magicdrive import encode_latents
    results, _ = ranks[mesh]
    dp, sp = MESHES[mesh]
    rows = [results[d * sp]["dp_encode"] for d in range(dp)]
    for d in range(dp):
        for s in range(sp):
            assert torch.equal(results[d * sp + s]["dp_encode"], rows[d])
    case = encode_case()
    vae = VideoAutoencoderKLCogVideoX(CogVAEConfig(**case["cfg"]), device="cpu")
    vae.module.load_state_dict(case["state"], strict=True)
    ref = encode_latents(vae, case["x"], case["seed"], 3)
    got = torch.cat(rows)
    assert got.shape == ref.shape == (6, 4, 3, 4, 5)
    assert float((got - ref).abs().max()) < 2e-5


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_share_of_the_state(cases, ranks, mesh):
    """Each rank's split parameters, EMA and AdamW moments are 1/dp of one
    process's; the replicated parameters whole (both given apart)."""
    results, _ = ranks[mesh]
    dp = MESHES[mesh][0]
    params = results[0]["base_full"][-1]["params"]  # whole, by name
    split = sum(v.numel() * 4 for v in params.values()
                if param_spec(tuple(v.shape), dp, MIN_SIZE) is not None)
    whole = sum(v.numel() * 4 for v in params.values())
    for res in results:
        local = res["base_full"][-1]["local_bytes"]
        assert local["params"][0] == local["ema"][0] == split // dp
        assert local["params"][0] + local["params"][1] < whole
        assert local["moments"] == 2 * (split // dp + local["params"][1])
    assert split > 0.9 * whole


# --------------------------------------------------------------- (e), (f) the apps


def _lines(path):
    import json
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _files_equal(a, b, names=("model.pt", "ema.pt", "optimizer.pt")):
    for name in names:
        x = torch.load(os.path.join(a, name), weights_only=True)
        y = torch.load(os.path.join(b, name), weights_only=True)
        _tree_equal(x, y, name)


def _tree_equal(x, y, where):
    if isinstance(x, dict):
        assert x.keys() == y.keys(), where
        for k in x:
            _tree_equal(x[k], y[k], f"{where}.{k}")
    elif isinstance(x, torch.Tensor):
        assert torch.equal(x, y), where
    else:
        assert x == y, where


def test_train_app_resumes_bit_for_bit_and_renders_alike(ranks, _rank_groups):
    """(e) The train app on 2 ranks (dp=2): only rank 0 writes (one metrics line a
    step); a resume on 2 ranks from its global_step2 reaches, bit for bit, the
    checkpoint an uninterrupted 2-rank run writes at step 3 (model, EMA, moments,
    metrics); validation at step 3 renders the same frames in both, the resume's
    ``val_gather_mode`` "checkpoint" read and gathered as "allgather"."""
    results, logs = ranks["dp2"]
    _, tmp = _rank_groups
    for r, log in enumerate(logs):
        assert f"mesh: dp=2 sp=1 (rank {r}: dp row {r}; sp_size 1)" in log
    whole, resume = os.path.join(tmp, "whole"), os.path.join(tmp, "resume")
    assert [x["step"] for x in _lines(whole)] == [1, 2, 3]
    assert [x["step"] for x in _lines(resume)] == [1, 2, 3]
    assert results[0]["app_whole"] == results[1]["app_whole"]
    for a, b in zip(_lines(resume), _lines(whole)):
        assert {k: v for k, v in a.items() if k != "elapsed_s"} == \
            {k: v for k, v in b.items() if k != "elapsed_s"}
    _files_equal(os.path.join(resume, "global_step3"), os.path.join(whole, "global_step3"))
    frames = sorted(os.listdir(os.path.join(whole, "validation", "step3_val0_0")))
    assert frames and frames == sorted(os.listdir(os.path.join(resume, "validation",
                                                               "step3_val0_0")))
    for f in frames:
        with open(os.path.join(whole, "validation", "step3_val0_0", f), "rb") as a, \
                open(os.path.join(resume, "validation", "step3_val0_0", f), "rb") as b:
            assert a.read() == b.read(), f
    for log in logs:
        assert log.count("val_gather_mode 'checkpoint' gathers the EMA as 'allgather'") == 1


def test_checkpoints_cross_world_sizes(ranks, _rank_groups, tmp_path, caplog):
    """(e) A dp=2 checkpoint is the one-process format: one process loads its
    global_step2 exactly (params, EMA, moments, step) and writes it back unchanged,
    then takes a step (another global batch, so not the 2-rank run's step 3). A
    one-process checkpoint resumed on 2 ranks and written back, gathered, is the
    same files."""
    from magicdrive_v2_tpu_torch.config.config import Config
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
    from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
    from magicdrive_v2_tpu_torch.training.trainer import build_training_multibucket
    from magicdrive_v2_tpu_torch.utils.ckpt import load_checkpoint
    ranks["dp2"]  # the groups have ended
    _, tmp = _rank_groups
    _files_equal(os.path.join(tmp, "from_one", "global_step2"),
                 os.path.join(tmp, "one_process", "global_step2"))
    src = os.path.join(tmp, "resume", "global_step2")
    cfg = Config.fromfile(SMOKE)
    model = TModel(build_model_config(cfg.model, mv_order_map=cfg.mv_order_map,
                                      dtype=torch.float32))
    state, _ = build_training_multibucket(model, build_scheduler(cfg.scheduler), cfg)
    running = load_checkpoint(src, model=state.model, ema=state.ema,
                              optimizer=state.optimizer)
    assert running["step"] == 2 and state.optimizer.count == 2
    saved = {n: torch.load(os.path.join(src, n), weights_only=True)
             for n in ("model.pt", "ema.pt", "optimizer.pt")}
    _tree_equal(state.model.state_dict(), saved["model.pt"], "model")
    _tree_equal(state.ema.state_dict(), saved["ema.pt"], "ema")
    _tree_equal(state.optimizer.state_dict(), saved["optimizer.pt"], "optimizer")
    out = str(tmp_path)
    shutil.copytree(src, os.path.join(out, "global_step2"))
    _app(out, 0, "ckpt_every=4")  # written back as it was read
    _files_equal(os.path.join(out, "global_step2"), src)
    with caplog.at_level("INFO", logger="train"):
        (line,) = _app(out, 1, "report_every=0")
    assert any(r.getMessage().endswith("global_step2 at step 2") for r in caplog.records)
    assert line["step"] == 3 and np.isfinite(line["loss"])
    two_ranks = {x["step"]: x for x in _lines(os.path.join(tmp, "whole"))}[3]
    assert line["loss"] != two_ranks["loss"]


def test_brushnet_app_on_two_ranks_equals_one_process(ranks, _rank_groups):
    """(f) The SDE-BrushNet app on 2 ranks (dp=2, each rank its row of seed + d):
    its 2 steps' loss and grad norm and its checkpoint (model and EMA, in the
    one-process format) equal one process stepping on the global batch of both
    rows."""
    from magicdrive_v2_tpu_torch.config.config import Config
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
    from magicdrive_v2_tpu_torch.scripts.train_brushnet import brushnet_scheduler, make_batch
    from magicdrive_v2_tpu_torch.training.trainer import build_brushnet_training
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    results, _ = ranks["dp2"]
    _, tmp = _rank_groups
    assert results[0]["brush_app"] == results[1]["brush_app"]
    got = results[0]["brush_app"]["lines"]
    cfg = Config.fromfile(BRUSH_SMOKE)
    model_cfg = TB.BrushNetConfig.from_base(
        build_model_config(cfg.model, mv_order_map=cfg.mv_order_map, dtype=torch.float32),
        sde_inpaint=True, brushnet_skip_cross_attn=True)
    model = TB.MagicDriveSTDiT3BrushNet(model_cfg)
    init_weights(model, seed=cfg.seed)
    (h, w), t_img = cfg.image_size, cfg.num_frames
    state, step_fn = build_brushnet_training(model, brushnet_scheduler(cfg, True), cfg,
                                             height=float(h), width=float(w),
                                             num_frames=t_img, seed=cfg.seed + 1)
    def concat(parts):
        if isinstance(parts[0], dict):
            return {k: concat([p[k] for p in parts]) for k in parts[0]}
        return np.concatenate(parts)

    for step, line in enumerate(got, start=1):
        batch = concat([make_batch(model_cfg, cfg, step, d) for d in (0, 1)])
        state, m = step_fn(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(line["loss"], float(m["loss"]), rtol=1e-6)
        np.testing.assert_allclose(line["grad_norm"], float(m["grad_norm"]), rtol=1e-5)
    ckpt = os.path.join(tmp, "brush", "global_step2")
    flip = flip_bound(dict(lr=cfg.lr))
    for name, module in (("model.pt", state.model), ("ema.pt", state.ema)):
        saved = torch.load(os.path.join(ckpt, name), weights_only=True)
        assert saved.keys() == module.state_dict().keys()
        for k, v in module.state_dict().items():
            assert float((saved[k] - v).abs().max()) <= flip, (name, k)

