"""PyTorch port, sequence-parallel training on the CPU: the training-time H pad
(``simulate_sp``), the grad rule over sp (``parallel.comm``: every rank's grads
are its share, summed over the sp group before the clip), the encode scattered
with its posterior noise drawn whole (``sp_vae(noise=...)``), and the train apps'
mesh rule (sp = min(sp_size, world), dp = world // sp), against one process of
the port and against the JAX package.

The ranks are the 2 processes of one gloo group (``tests/torch_sp_train_worker.py``,
started once for the module by ``spawn_ranks`` with a deadline); they run the
port's plain kernel versions. The model is the tiny flagship of
``tests/test_torch_training.py`` (hidden 64, 4 heads, depth 2 / control depth 1,
fp32, every JAX leaf random) on 9 frames of 48x80: tokens 3x5, so S=15 takes the
sp pad (H 3 -> 4) on 2 ranks. The JAX references run in this process, on the
virtual CPU devices of ``tests/conftest.py`` where a mesh is needed.

Tolerances are that file's: against JAX the loss 1e-5 relative and the grads 2e-4
of each tensor's largest |g|; two AdamW steps (eps 1e-8) within the most two
opposite steps where a grad lies below that agreement, every other element
within 2e-6. Sharded against one process of the port the same limits hold, the
loss within 1e-6: the sum over the ranks orders the grads' sums as another library
would, and where a grad is what is left of cancelling terms (the map embedder's
first convolution: |g| ~1e-8) the two differ by ~1e-4 of its largest; an element
whose two grads differ by more than 1e-3 of its own counts with the weak ones. The ranks
hold bit-equal parameters after every step.
"""
import dataclasses
import os

import numpy as np
import optax
import pytest
import torch

from test_torch_common import (assert_close, j, load_into, np_tree, random_params,
                               read_scalars, spawn_ranks, t, tiny_configs)
from torch_sp_train_worker import run_steps

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.models.magicdrive import brushnet as JB
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.parallel.sharding import make_mesh as j_make_mesh
from magicdrive_v2_tpu.parallel.sharding import use_mesh as j_use_mesh
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu.training import trainer as JT
from magicdrive_v2_tpu.utils import train_utils as JU
from magicdrive_v2_tpu_torch.config.presets import rflow
from magicdrive_v2_tpu_torch.models.magicdrive import brushnet as TB
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3 as TModel
from magicdrive_v2_tpu_torch.models.vae.cogvideox import CogVAEConfig, VideoAutoencoderKLCogVideoX
from magicdrive_v2_tpu_torch.parallel.distributed import training_mesh_shape
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params, init_weights
from magicdrive_v2_tpu_torch.utils.misc import to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_sp_train_worker.py")
SMOKE = os.path.join(REPO, "configs/magicdrive/train/smoke_tiny.py")
BRUSH_SMOKE = os.path.join(REPO, "configs/magicdrive/train/brushnet_smoke.py")
DEADLINE_S = 240
NF, HH, WW, B = 9, 48, 80, 2
SIMULATE = 8  # H 3 -> 8: S = 40
SCHED = rflow(sample_method="logit-normal")
EPS = 1e-8
HYPER = dict(lr=1e-3, weight_decay=1e-2, adam_eps=EPS, grad_clip=0.05, warmup_steps=3)
RAW_GRADS = dict(lr=0.0, weight_decay=0.0, adam_eps=1e-8, grad_clip=1e9)  # p.grad as is
VAE_TINY = dict(block_out_channels=(8, 8, 8, 16), latent_channels=4, layers_per_block=1,
                norm_num_groups=4)
HW = dict(height=np.full((B,), float(HH), np.float32), width=np.full((B,), float(WW), np.float32),
          num_frames=np.full((B,), float(NF), np.float32))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    yield
    torch.set_num_threads(n)


def _jax_batch(batch):
    return {k: ({kk: j(vv) for kk, vv in v.items()} if isinstance(v, dict) else j(v))
            for k, v in batch.items()}


def port_cfg(cfg, **replace):
    cfg = dataclasses.replace(cfg, **replace)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module")
def setup():
    """JAX and port configs, the JAX params, the port's state dict, and one batch of
    2 samples with a frame mask and ego poses that differ per frame."""
    jcfg, tcfg = tiny_configs(grad_checkpoint=False)
    batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=16, b=B, seed=5)
    for k in ("timestep", "height", "width"):
        batch.pop(k)
    batch["mask"] = np.array([[1, 0, 1], [0, 1, 1]], np.float32)
    batch["rel_pos"] = np.random.default_rng(6).standard_normal(
        batch["rel_pos"].shape).astype(np.float32)
    params = random_params(JModel(jcfg), **{k: v for k, v in _jax_batch(batch).items()
                                            if k != "mask"}, timestep=jnp.full((B,), 500.0),
                           height=float(HH), width=float(WW))
    state = load_into(TModel(tcfg), params, control_depth=tcfg.control_depth).state_dict()
    return jcfg, tcfg, params, state, batch


_SDE = {}


def sde_setup(setup):
    """(JAX config, port config, params, port state, batch, the SDE noise's normal
    draw, its key) of the tiny SDE-BrushNet on one sample of the same size."""
    if not _SDE:
        jcfg, tcfg, *_ = setup
        jb = JB.BrushNetConfig(**{**dataclasses.asdict(jcfg), "sde_inpaint": True})
        tb = TB.BrushNetConfig.from_base(tcfg, sde_inpaint=True)
        batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=8, b=1, seed=3)
        for k in ("timestep", "height", "width"):
            batch.pop(k)
        rng = np.random.default_rng(0)
        batch["x_inpaint"] = rng.standard_normal((1, 3 * tcfg.nc, NF, HH, WW)).astype(np.float32)
        batch["mask_inpaint"] = rng.integers(0, 2, (1, tcfg.nc, NF, HH, WW)).astype(np.float32)
        batch["mask"] = np.array([[1, 1, 0]], np.float32)
        key = jax.random.PRNGKey(5)
        params = random_params(JB.MagicDriveSTDiT3BrushNet(jb), **_jax_batch(
            {k: v for k, v in batch.items() if k != "mask"}), timestep=jnp.full((1,), 500.0),
            t_inpaint=jnp.full((1,), 300.0), height=float(HH), width=float(WW), rngs_key=key)
        state = load_into(TB.MagicDriveSTDiT3BrushNet(tb), params,
                          control_depth=tb.control_depth).state_dict()
        lat = (NF - 1) // 4 + 1, HH // 8, WW // 8
        noise = np.asarray(jax.random.normal(key, (tcfg.nc * tcfg.in_channels * lat[0],
                                                   lat[1], lat[2])))
        _SDE.update(jb=jb, tb=tb, params=params, state=state, batch=batch, noise=noise, key=key)
    s = _SDE
    return s["jb"], s["tb"], s["params"], s["state"], s["batch"], s["noise"], s["key"]


def jax_draws(batch, n):
    """t and noise of n steps as the JAX step draws them from PRNGKey(10 + i)."""
    jsched = JR.build_scheduler(SCHED)
    out = []
    for i in range(n):
        t_key, n_key = jax.random.split(jax.random.PRNGKey(10 + i))
        tt = jsched.sample_t(t_key, B, **{k: j(v) for k, v in HW.items()})
        noise = jax.random.normal(n_key, batch["x"].shape, jnp.float32)
        out.append(dict(t=t(np.asarray(tt)), noise=t(np.asarray(noise))))
    return out


def steps_case(cfg, state, batch, draws, hyper, **kw):
    return dict(kind="steps", cfg=cfg, state=state, batch=to_device(batch, "cpu"),
                height=float(HH), width=float(WW), num_frames=NF, scheduler=SCHED,
                hyper=hyper, draws=draws, **kw)


def one_process(case, **cfg_replace):
    """``run_steps`` of the case in this process, its config changed."""
    return run_steps(dict(case, cfg=dict(case["cfg"], **cfg_replace)), None)


def sp2_ref(case):
    """The one-process reference of a sharded case: no mesh, the pad of sp 2."""
    return one_process(case, enable_sequence_parallelism=False, force_pad_h_for_sp_size=2)


@pytest.fixture(scope="module")
def cases(setup):
    jcfg, tcfg, params, state, batch = setup
    sp_cfg = port_cfg(tcfg, enable_sequence_parallelism=True, grad_checkpoint=True)
    out = {"base": steps_case(sp_cfg, state, batch, jax_draws(batch, 2), HYPER),
           "simulate": steps_case(sp_cfg, state, batch, jax_draws(batch, 1), RAW_GRADS,
                                  simulate_sp=SIMULATE)}
    for policy in ("dots", "offload_carry"):
        out[f"remat_{policy}"] = steps_case(dict(sp_cfg, remat_policy=policy), state, batch,
                                            jax_draws(batch, 1), RAW_GRADS)
    # S=15 does not split over 2 ranks without the pad: every rank runs it whole
    out["unsplit"] = steps_case(port_cfg(tcfg), state, batch, jax_draws(batch, 1), RAW_GRADS)
    _, tb, _, bstate, bbatch, _, _ = sde_setup(setup)
    out["sde"] = steps_case(port_cfg(tb, enable_sequence_parallelism=True,
                                     grad_checkpoint=True), bstate, bbatch, [{}, {}],
                            HYPER, seed=7)
    vae = VideoAutoencoderKLCogVideoX(CogVAEConfig(**VAE_TINY), device="cpu")
    init_weights(vae.module, seed=2)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 3, 9, 32, 40)).astype(np.float32))
    out["sp_vae_encode"] = dict(kind="sp_vae_encode", cfg=VAE_TINY,
                                state=vae.module.state_dict(), x=x, seed=11)
    return out


@pytest.fixture(autouse=True, scope="module")
def _rank_group(cases, tmp_path_factory):
    """Every multi-rank case in one group of 2 ranks, started before the first test
    and run while this process compiles its JAX references: the model cases, the
    encode, the train app on smoke_tiny with sp_size 4 and simulate_sp_size [4, 8]
    for 2 steps (seed 1: the picks are 4, 8), and the BrushNet app with --sde at
    sp_size 2. Yields a future of (each rank's results, each rank's log, the app's
    output directory)."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = str(tmp_path_factory.mktemp("sp_train"))
    app_dir = os.path.join(tmp, "app")
    all_cases = dict(cases)
    all_cases["app"] = dict(kind="app", app="train_magicdrive", argv=[
        SMOKE, "--synthetic", "--device", "cpu", "--max-steps", "2", "--cfg-options",
        f"outputs={app_dir}", "sp_size=4", "simulate_sp_size=[4,8]", "seed=1"])
    all_cases["brush_app"] = dict(kind="app", app="train_brushnet", argv=[
        BRUSH_SMOKE, "--synthetic", "--sde", "--device", "cpu", "--max-steps", "1",
        "--cfg-options", f"outputs={os.path.join(tmp, 'brush')}", "sp_size=2"])
    torch.save(all_cases, os.path.join(tmp, "inputs.pt"))

    def run():
        logs = spawn_ranks(2, [WORKER, tmp], DEADLINE_S)
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                   for r in range(2)]
        return results, logs, app_dir

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


@pytest.fixture(scope="module")
def ranks(_rank_group):
    return _rank_group.result()


@pytest.fixture(scope="module")
def jax_simulate_step(setup):
    """One JAX make_train_step(simulate_sp=8) on a (1, 2) mesh of virtual devices
    (enable_sequence_parallelism), through an optax transformation that keeps the
    grads as its state: (loss, the grads in the port's names)."""
    jcfg, tcfg, params, _, batch = setup
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    jmodel = JModel(dataclasses.replace(jcfg, enable_sequence_parallelism=True))
    with j_use_mesh(j_make_mesh(dp=1, sp=2, devices=jax.devices()[:2])):
        jstep = jax.jit(JT.make_train_step(jmodel, JR.build_scheduler(SCHED), capture,
                                           height=HH, width=WW, num_frames=NF,
                                           simulate_sp=SIMULATE))
        jstate, jm = jstep(JT.create_train_state(params, capture), _jax_batch(batch),
                           jax.random.PRNGKey(10))
    return float(jm["loss"]), from_jax_params(np_tree(jstate.opt_state), tcfg.control_depth)


def assert_grads_match_jax(step, jax_step):
    """The loss within 1e-5 relative, every grad within 2e-4 of its tensor's
    largest |g| (JAX's)."""
    jloss, ref = jax_step
    np.testing.assert_allclose(float(step["metrics"]["loss"]), jloss, rtol=1e-5)
    checked = 0
    for name, g in step["grads"].items():
        scale = float(np.abs(ref[name]).max())
        if scale == 0.0:
            continue
        np.testing.assert_allclose(g.numpy(), ref[name], atol=2e-4 * scale, err_msg=name)
        checked += 1
    assert checked > 0.9 * len(step["grads"]), (checked, len(step["grads"]))


def assert_steps_close(got, ref, *, agree, flip, loss_rtol):
    """Step by step: the metrics, the parameters and EMA after the step within
    ``flip`` where a grad of either step lay below ``agree`` of its tensor's
    largest |g| or the two runs' grads differ by more than 1e-3 of it (AdamW's
    steps may then differ by more than 1e-3 of the learning rate: the shallow
    encoder's grads are ~1e-7, near eps) and within 2e-6 elsewhere; the first step's grads within
    ``agree`` (a later step's start from parameters that may differ by ``flip``)."""
    weak = {}
    for i, (a, b) in enumerate(zip(got, ref)):
        for k in ("loss", "grad_norm", "t_mean"):
            np.testing.assert_allclose(float(a["metrics"][k]), float(b["metrics"][k]),
                                       rtol=loss_rtol, err_msg=k)
        assert a["grads"].keys() == b["grads"].keys()
        for name, g in b["grads"].items():
            scale = float(g.abs().max())
            if i == 0:
                np.testing.assert_allclose(a["grads"][name].numpy(), g.numpy(),
                                           atol=agree * scale, err_msg=name)
            w = ((g.abs() <= agree * scale)
                 | ((a["grads"][name] - g).abs() > 1e-3 * (g.abs() + EPS))) & (scale > 0)
            weak[name] = weak[name] | w if name in weak else w
        for key in ("params", "ema"):
            for name, p in b[key].items():
                err = (a[key][name] - p).abs()
                assert float(err.max()) <= flip, (key, name, float(err.max()))
                if name in weak:
                    assert float(err.masked_fill(weak[name], 0).max()) <= 2e-6, (key, name)
    overall = sum(int(w.sum()) for w in weak.values()) / sum(w.numel() for w in weak.values())
    assert overall <= 0.05, overall


def flip_bound(hyper, steps=2):
    sched = JU.multistep_warmup_schedule(hyper["lr"], hyper.get("warmup_steps", 0))
    return 2 * sum(float(sched(i)) for i in range(steps)) * (1 + hyper.get("weight_decay", 1e-2))


def same_on_every_rank(results, name):
    out = results[0][name]
    for r in results[1:]:
        for a, b in zip(out, r[name]):
            for key in ("params", "ema", "grads"):
                for n, x in a[key].items():
                    assert torch.equal(x, b[key][n]), (name, key, n)
    return out


# --------------------------------------------------------------- simulate_sp


def test_simulate_sp_forward_equals_force_pad_and_jax(setup):
    """(a) simulate_sp=8 pads H 3 -> 8: exactly the force_pad_h_for_sp_size=8 model
    in the port, JAX's simulate_sp forward within 2e-4, and not the unpadded
    function (the grid effect)."""
    jcfg, tcfg, params, state, batch = setup
    nb = {k: v for k, v in batch.items() if k != "mask"}
    nb.update(x_mask=batch["mask"], timestep=np.array([300.0, 700.0], np.float32))
    inputs = dict(to_device(nb, "cpu"), height=float(HH), width=float(WW))
    model = load_into(TModel(tcfg), params, control_depth=tcfg.control_depth)
    forced = load_into(TModel(dataclasses.replace(tcfg, force_pad_h_for_sp_size=SIMULATE)),
                       params, control_depth=tcfg.control_depth)
    with torch.no_grad():
        out = model(**inputs, simulate_sp=SIMULATE)
        torch.testing.assert_close(out, forced(**inputs), rtol=0, atol=0)
        assert float((out - model(**inputs)).abs().max()) > 1e-3
    ref = jax.jit(lambda p, b: JModel(jcfg).apply(p, **b, height=float(HH), width=float(WW),
                                                  simulate_sp=SIMULATE))(params, _jax_batch(nb))
    assert_close(out, ref, 2e-4)


def test_simulate_sp_sde_brushnet_forward_equals_force_pad_and_jax(setup):
    """(a) The SDE-BrushNet (the inpaint stream padded with x) at simulate_sp=8: the
    port's force_pad model exactly, JAX's simulate_sp forward within 2e-4 (the SDE
    noise JAX's draw from its key)."""
    jb_cfg, tb, params, _, batch, noise, key = sde_setup(setup)
    nb = {k: v for k, v in batch.items() if k != "mask"}
    nb.update(timestep=np.array([400.0], np.float32), t_inpaint=np.array([300.0], np.float32))
    inputs = dict(to_device(nb, "cpu"), height=float(HH), width=float(WW))
    model = load_into(TB.MagicDriveSTDiT3BrushNet(tb), params, control_depth=tb.control_depth)
    forced = load_into(TB.MagicDriveSTDiT3BrushNet(
        dataclasses.replace(tb, force_pad_h_for_sp_size=SIMULATE)), params,
        control_depth=tb.control_depth)
    with torch.no_grad():
        out = model(**inputs, simulate_sp=SIMULATE, inpaint_input_noise=t(noise))
        torch.testing.assert_close(out, forced(**inputs, inpaint_input_noise=t(noise)),
                                   rtol=0, atol=0)
    ref = jax.jit(lambda p, b: JB.MagicDriveSTDiT3BrushNet(jb_cfg).apply(
        p, **b, height=float(HH), width=float(WW), simulate_sp=SIMULATE,
        rngs_key=key))(params, _jax_batch(nb))
    assert_close(out, ref, 2e-4)


def test_simulate_sp_train_step_matches_jax(setup, jax_simulate_step):
    """(b) One step of the port's make_train_step(simulate_sp=8) in one process
    against JAX's make_train_step(simulate_sp=8): the loss and every grad (the
    port's with lr 0 and no clip, so they stay on the parameters). The JAX step
    runs on a (1, 2) mesh, where simulate_sp outranks the mesh's pad: the function
    is the unsharded one."""
    _, tcfg, _, state, batch = setup
    got = run_steps(steps_case(port_cfg(tcfg), state, batch, jax_draws(batch, 1), RAW_GRADS,
                               simulate_sp=SIMULATE), None)
    assert_grads_match_jax(got[0], jax_simulate_step)


# --------------------------------------------------------------- sp = 2 ranks


def test_sharded_train_steps_equal_one_process_and_jax(cases, ranks, jax_simulate_step):
    """(c) Two steps at sp=2 (S=15 padded to 20, 10 tokens a rank; remat full; a
    warm-up and a clip that triggers): the loss, the reduced grads, the
    parameters and EMA after each step equal one unsharded process with
    force_pad_h_for_sp_size=2. A step at sp=2 with simulate_sp=8 (S=40, 20 a
    rank): JAX's step on a (1, 2) mesh, loss and every grad."""
    got = same_on_every_rank(ranks[0], "base")
    assert float(got[0]["metrics"]["grad_norm"]) > HYPER["grad_clip"]
    assert_steps_close(got, sp2_ref(cases["base"]), agree=2e-4, flip=flip_bound(HYPER),
                       loss_rtol=1e-6)
    assert_grads_match_jax(same_on_every_rank(ranks[0], "simulate")[0], jax_simulate_step)


@pytest.mark.parametrize("policy", ["dots", "offload_carry"])
def test_sharded_grads_under_each_remat_policy(cases, ranks, policy):
    """(c) The recompute re-runs the all-to-alls in the backward, in the same order
    on every rank: the reduced grads under remat "dots" and "offload_carry" equal
    one process's."""
    got = same_on_every_rank(ranks[0], f"remat_{policy}")
    assert_steps_close(got, sp2_ref(cases[f"remat_{policy}"]), agree=2e-4, flip=0.0,
                       loss_rtol=1e-6)


def test_forward_that_does_not_split_shares_its_grads(cases, ranks):
    """Without the sp pad S=15 does not split over 2 ranks: both run the whole
    forward, each keeps half of every grad (``share_grad``), and the sum over sp is
    one process's grad exactly."""
    results, logs, _ = ranks
    got = same_on_every_rank(results, "unsplit")
    assert_steps_close(got, one_process(cases["unsplit"]), agree=1e-6, flip=0.0,
                       loss_rtol=1e-6)
    for log in logs:
        assert "S=15 tokens do not split over sp=2 ranks" in log


def test_sde_brushnet_sharded_train_steps(cases, ranks):
    """(c) Two SDE-BrushNet steps at sp=2 (the branch trains over the frozen base;
    t, t_inpaint, noise, the cutoff and the structured noise drawn from (seed,
    step) on every rank alike, before the split): one process's with
    force_pad_h_for_sp_size=2. The frozen base gets no grad and stays put."""
    got = same_on_every_rank(ranks[0], "sde")
    ref = sp2_ref(cases["sde"])
    hyper = cases["sde"]["hyper"]
    assert_steps_close(got, ref, agree=2e-4, flip=flip_bound(hyper), loss_rtol=1e-6)
    frozen = [n for n in got[-1]["params"] if n not in got[-1]["grads"]]
    assert frozen and all(torch.equal(got[-1]["params"][n], cases["sde"]["state"][n])
                          for n in frozen)


def test_sp_vae_encode_with_sliced_noise(ranks):
    """(d) 3 views over 2 ranks (padded to 4 with a cycled view), the posterior noise
    drawn once for the 3 and sliced: the direct encode's latents, with the noise it
    draws from the same generator."""
    cfg = CogVAEConfig(**VAE_TINY)
    results = ranks[0]
    out = results[0]["sp_vae_encode"]
    assert torch.equal(out, results[1]["sp_vae_encode"])
    vae = VideoAutoencoderKLCogVideoX(cfg, device="cpu")
    init_weights(vae.module, seed=2)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 3, 9, 32, 40)).astype(np.float32))
    direct = vae.encode(x, generator=torch.Generator().manual_seed(11))
    assert out.shape == direct.shape == (3, 4, 3, 4, 5)
    assert float((out - direct).abs().max()) < 2e-5


# --------------------------------------------------------------- the apps


def _app(args):
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    return train_magicdrive.main([SMOKE, "--synthetic", "--device", "cpu"] + args)


def test_train_app_sp4_on_two_ranks_resumes_in_one_process(ranks, tmp_path, caplog):
    """(e) sp_size 4 on 2 ranks trains at sp=2 with simulate_sp from [4, 8] (the
    picks 4, 8 from the common seed; rank 0 alone writes). One process resumes
    its global_step2 to step 4: the metrics and the saved model and EMA equal 4
    uninterrupted steps in one process, within the sharded tolerances."""
    results, logs, app_dir = ranks
    for r, log in enumerate(logs):
        assert (f"mesh: dp=1 sp=2 (rank {r}: dp row 0; sp_size 4), simulate_sp from [4, 8]"
                in log)
    assert results[0]["app"] == results[1]["app"]
    sharded = results[0]["app"]["lines"]
    assert [x["simulate_sp"] for x in sharded] == [4.0, 8.0]
    with open(os.path.join(app_dir, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 2  # rank 0's lines only
    # rank 0's TensorBoard scalars only: one event file, rank 0's values
    assert read_scalars(os.path.join(app_dir, "tb")) == {
        k: [(x["step"], float(np.float32(x[k]))) for x in sharded]
        for k in ("loss", "grad_norm")}
    opts = ["--cfg-options", "sp_size=4", "simulate_sp_size=[4,8]", "seed=1"]
    with caplog.at_level("INFO", logger="train"):
        resumed = _app(["--max-steps", "2"] + opts + [f"outputs={app_dir}"])
    assert any(r.getMessage().endswith("at step 2") for r in caplog.records)
    whole_dir = str(tmp_path / "whole")
    whole = _app(["--max-steps", "4"] + opts + [f"outputs={whole_dir}"])
    assert [x["simulate_sp"] for x in whole] == [4, 8, 4, 8]
    for a, b in zip(sharded + resumed, whole):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    lr = 1e-4  # smoke_tiny's, no warm-up; adam_eps 1e-15: a near-zero grad steps a whole lr
    for name in ("model.pt", "ema.pt"):
        x = torch.load(os.path.join(app_dir, "global_step4", name))
        y = torch.load(os.path.join(whole_dir, "global_step4", name))
        assert x.keys() == y.keys()
        moved = 0
        for k in x:
            err = (x[k] - y[k]).abs()
            assert float(err.max()) <= 2 * 4 * lr * 1.01, (name, k)
            moved += int((err > 1e-6).sum())
        assert moved <= 0.01 * sum(v.numel() for v in x.values()), (name, moved)


def test_brushnet_app_on_two_ranks(ranks, tmp_path):
    """The SDE-BrushNet app at sp_size 2 on 2 ranks: S=20 splits without a pad, so
    its step equals one process's run of the same config."""
    from magicdrive_v2_tpu_torch.scripts import train_brushnet
    results = ranks[0]
    assert results[0]["brush_app"] == results[1]["brush_app"]
    (got,) = results[0]["brush_app"]["lines"]
    (ref,) = train_brushnet.main([BRUSH_SMOKE, "--synthetic", "--sde", "--device", "cpu",
                                  "--max-steps", "1", "--cfg-options",
                                  f"outputs={tmp_path}"])
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("sp_size,world,dp_sp", [
    (4, 1, (1, 1)), (4, 2, (1, 2)), (4, 4, (1, 4)), (1, 1, (1, 1)), (None, 1, (1, 1)),
    (4, 8, (2, 4)), (1, 2, (2, 1)), (2, 3, None)])
def test_training_sp_size_rule(sp_size, world, dp_sp):
    """sp = min(sp_size, world) and dp = world // sp, the JAX train apps' rule (not
    the serving rule, which runs unsharded on fewer ranks); the ranks beyond an sp
    group are dp rows. A world that sp does not divide raises ValueError (JAX
    leaves the extra devices idle)."""
    if dp_sp is None:
        with pytest.raises(ValueError, match="do not split into data-parallel rows"):
            training_mesh_shape(sp_size, world)
    else:
        assert training_mesh_shape(sp_size, world) == dp_sp
