"""PyTorch port, training: the loss, its grads, whole train steps, the optimizer,
EMA, masks, checkpoints and the train app, against the JAX package on the CPU.

The model is the tiny flagship of ``configs/magicdrive/train/smoke_tiny.py``
(hidden 64, 4 heads, depth 2 / control depth 1, 9 frames of 64x80, fp32), with
every JAX leaf random and loaded into the port through ``from_jax_params``.
Tolerances:
- loss: 1e-5 relative; grads: 2e-4 of each tensor's largest |g| (fp32 through ~10
  blocks whose GEMMs the two libraries sum in different orders);
- two AdamW steps: a first update is ~lr * g / (|g| + eps), so an element whose
  grad lies below the two packages' agreement (2e-4 of the tensor's largest) may
  step the other way: such elements within the most two opposite steps can move
  them apart (2 * sum of the learning rates * (1 + weight decay)), every other
  element within 2e-6 (params of order 0.05, lr 1e-3). eps is 1e-8
  there: with the stage-2 configs' 1e-15 a grad that is zero but for rounding
  (a k bias's: the softmax ignores it) steps a whole lr in a direction rounding
  picks, in either package; ``test_clipped_adamw_matches_optax`` holds eps 1e-15.
"""
import copy
import json
import os
import pickle
import random as pyrandom

import numpy as np
import pytest
import torch

from test_torch_common import j, load_into, np_tree, random_params, t, tiny_configs

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu.training import trainer as JT
from magicdrive_v2_tpu.utils import train_utils as JU
from magicdrive_v2_tpu_torch.config.presets import rflow
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3 as TModel
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import cast_model, compute_params
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.schedulers import rf as TR
from magicdrive_v2_tpu_torch.training import trainer as TT
from magicdrive_v2_tpu_torch.utils import train_utils as TU
from magicdrive_v2_tpu_torch.utils.misc import to_device
from magicdrive_v2_tpu_torch.utils.ckpt import (find_latest, from_jax_params, init_weights,
                                                load_checkpoint, load_rng_state,
                                                save_checkpoint, save_rng_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF, HH, WW, B = 9, 64, 80, 2
SMOKE = os.path.join(REPO, "configs/magicdrive/train/smoke_tiny.py")
SCHED = rflow(sample_method="logit-normal")  # the stage-1 and stage-2 configs' scheduler


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for this module's many small CPU ops: the tier-1 run
    has several test workers on one machine, and one thread per core each
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_batch(batch):
    return {k: ({kk: j(vv) for kk, vv in v.items()} if isinstance(v, dict) else j(v))
            for k, v in batch.items()}


# (with_temp_block, control_skip_temporal, frames, frame mask): the default layout
# and the stage-1 image model's (no temporal block, 1 frame, no frame mask: the
# stage-1 config's mask_ratios are empty)
LAYOUTS = {"temporal": (True, False, NF, [[1, 0, 1], [0, 1, 1]]),
           "stage1": (False, True, 1, [[1], [1]])}


def make_setup(layout):
    """JAX and port models with the same random weights, one batch of 2 samples
    with a frame mask; remat off on both sides (remat changes no value, tested
    apart below, and keeps the JAX compiles short)."""
    temp, skip_t, nf, mask = LAYOUTS[layout]
    jcfg, tcfg = tiny_configs(grad_checkpoint=False, with_temp_block=temp,
                              control_skip_temporal=skip_t)
    batch = synthetic_batch(tcfg, nf, HH, WW, l_txt=16, b=B, seed=5)
    for k in ("timestep", "height", "width"):
        batch.pop(k)
    batch["mask"] = np.array(mask, np.float32)
    # ego poses that differ from frame to frame (the synthetic batch's are all one
    # matrix, which leaves the frame embedder's attention rows uniform and its q/k
    # grads zero but for rounding)
    batch["rel_pos"] = np.random.default_rng(6).standard_normal(
        batch["rel_pos"].shape).astype(np.float32)
    jmodel = JModel(jcfg)
    params = random_params(jmodel, **{k: v for k, v in _jax_batch(batch).items()
                                      if k != "mask"}, timestep=jnp.full((B,), 500.0),
                           height=float(HH), width=float(WW))
    return jcfg, tcfg, jmodel, params, batch


@pytest.fixture(scope="module")
def setup():
    return make_setup("temporal")


@pytest.fixture(scope="module")
def stage1_setup():
    return make_setup("stage1")


def _port_model(tcfg, params):
    return load_into(TModel(tcfg), params, control_depth=tcfg.control_depth).train()


def _jax_model_fn(jmodel, params, batch):
    cond = {k: v for k, v in _jax_batch(batch).items() if k not in ("x", "mask")}

    def model_fn(x_t, tt, x_mask):
        return jmodel.apply(params, x_t, tt, **cond, height=float(HH), width=float(WW),
                            x_mask=x_mask)
    return model_fn


def hw(nf):
    return dict(height=np.full((B,), float(HH), np.float32),
                width=np.full((B,), float(WW), np.float32),
                num_frames=np.full((B,), float(nf), np.float32))


HW = hw(NF)


@pytest.mark.parametrize("layout", ["temporal", "stage1"])
def test_loss_and_every_grad_match_jax(request, layout):
    """The loss and every parameter's grad, in the default layout (9 frames) and in
    stage 1's (no temporal blocks, 1 frame: the timestep shift's one-frame branch),
    both with the stage-2 / stage-1 configs' scheduler (logit-normal t)."""
    nf = LAYOUTS[layout][2]
    jcfg, tcfg, jmodel, params, batch = request.getfixturevalue(
        "setup" if layout == "temporal" else "stage1_setup")
    rng = np.random.default_rng(0)
    tt = np.array([321.0, 777.0], np.float32)
    noise = rng.standard_normal(batch["x"].shape).astype(np.float32)
    sched = JR.build_scheduler(SCHED)

    def loss_fn(p):
        out = sched.training_losses(_jax_model_fn(jmodel, p, batch), jax.random.PRNGKey(0),
                                    j(batch["x"]), mask=j(batch["mask"]), t=j(tt),
                                    noise=j(noise), **{k: j(v) for k, v in hw(nf).items()})
        return out["loss"].mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _port_model(tcfg, params)
    loss, t_used = TT.training_loss(model, TR.build_scheduler(SCHED),
                                    to_device(batch, "cpu"), height=HH, width=WW,
                                    num_frames=nf, dtype=torch.float32, t=t(tt), noise=t(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(t_used.numpy(), tt)
    ref = from_jax_params(np_tree(jgrads), tcfg.control_depth)
    own = dict(model.named_parameters())
    # what JAX differentiates beyond the port's parameters are the port's buffers
    assert set(ref) - set(own) == {n for n, _ in model.named_buffers()}
    checked = 0
    for name, p in own.items():
        g_ref = ref[name]
        scale = float(np.abs(g_ref).max())
        if scale == 0.0:
            continue
        assert p.grad is not None and bool((p.grad != 0).any()), name
        np.testing.assert_allclose(p.grad.numpy(), g_ref, atol=2e-4 * scale, err_msg=name)
        checked += 1
    assert checked > 0.9 * len(own), (checked, len(own))


def test_two_train_steps_match_jax(setup):
    """Two steps of the port's make_train_step against two of JAX's (jit), with a
    warm-up and a clip that triggers; t and noise from the JAX step's own split of
    its key. Params, EMA and metrics."""
    jcfg, tcfg, jmodel, params, batch = setup
    hyper = dict(lr=1e-3, weight_decay=1e-2, adam_eps=1e-8, grad_clip=0.05,
                 warmup_steps=3)
    sched_cfg = SCHED
    jsched = JR.build_scheduler(sched_cfg)
    jmask = JU.trainable_mask(params)
    tx = JU.make_optimizer(trainable=jmask, **hyper)
    jstate = JT.create_train_state(params, tx)
    jstep = jax.jit(JT.make_train_step(jmodel, jsched, tx, height=HH, width=WW,
                                       num_frames=NF, ema_decay=0.99, ema_mask=jmask))
    jb = _jax_batch(batch)

    model = _port_model(tcfg, params)
    tmask = TU.trainable_mask(model.named_parameters())
    opt = TU.make_optimizer(model.named_parameters(), trainable=tmask, **hyper)
    state = TT.TrainState(step=0, model=model, optimizer=opt,
                          ema=copy.deepcopy(model).requires_grad_(False))
    tstep = TT.make_train_step(TR.build_scheduler(sched_cfg), height=HH, width=WW,
                               num_frames=NF, dtype=torch.float32, ema_decay=0.99,
                               ema_mask=tmask)
    dev = to_device(batch, "cpu")
    weak = {name: torch.zeros(p.shape, dtype=torch.bool)
            for name, p in model.named_parameters()}
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        t_key, n_key = jax.random.split(key)  # what JAX's training_losses splits
        tt = jsched.sample_t(t_key, B, **{k: j(v) for k, v in HW.items()})
        noise = jax.random.normal(n_key, batch["x"].shape, jnp.float32)
        jstate, jm = jstep(jstate, jb, key)
        state, m = tstep(state, dev, t=t(np.asarray(tt)), noise=t(np.asarray(noise)))
        for k in ("loss", "grad_norm", "t_mean"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5, err_msg=k)
        assert float(m["grad_norm"]) > hyper["grad_clip"]  # the clip triggered
        for name, p in model.named_parameters():  # grads below the packages' agreement
            g = p.grad.abs()  # (a tensor with no grad at all steps by weight decay alone)
            weak[name] |= (g <= 2e-4 * g.max()) & bool(g.max() > 0)
    assert state.step == 2 and state.optimizer.count == 2
    # the loose bound covers a few elements, never most of a tensor (at most the k
    # half of a kv bias, whose grad is 0 but for rounding: softmax ignores it)
    share = {name: float(w.float().mean()) for name, w in weak.items()}
    overall = sum(int(w.sum()) for w in weak.values()) / sum(w.numel() for w in weak.values())
    worst = max(share, key=share.get)
    print(f"loosely compared: {overall:.4%} of all elements, at most "
          f"{share[worst]:.4%} of a tensor ({worst})")
    assert overall <= 0.05 and share[worst] <= 0.5, (overall, worst, share[worst])
    sched = TU.multistep_warmup_schedule(hyper["lr"], hyper["warmup_steps"])
    flip = 2 * (sched(0) + sched(1)) * (1 + hyper["weight_decay"])
    for tree, module in ((jstate.params, state.model), (jstate.ema_params, state.ema)):
        ref = from_jax_params(np_tree(tree), tcfg.control_depth)
        for name, p in module.named_parameters():
            err = np.abs(p.detach().numpy() - ref[name])
            assert float(err.max()) <= flip, (name, float(err.max()))
            strong = ~weak[name].numpy()
            np.testing.assert_array_less(err[strong], 2e-6, err_msg=name)
    moved = [name for name, p in state.model.named_parameters()
             if not np.array_equal(p.detach().numpy(), from_jax_params(
                 np_tree(params), tcfg.control_depth)[name])]
    assert len(moved) == len(tmask)


@pytest.mark.parametrize("freeze", [(), ("base_s",), ("t_embedder", "control_t")],
                         ids=["none", "base_s", "t_embedder+control_t"])
def test_trainable_mask_agrees_with_jax(setup, freeze):
    jcfg, tcfg, jmodel, params, batch = setup
    jmask = JU.trainable_mask(params, freeze)
    spread = jax.tree_util.tree_map(lambda p, m: np.full(p.shape, m), params, jmask)
    ref = {k: bool(np.all(v)) for k, v in from_jax_params(spread, tcfg.control_depth).items()}
    model = TModel(tcfg)
    mask = TU.trainable_mask(model.named_parameters(), freeze)
    assert {k: ref[k] for k in mask} == mask
    # JAX's frozen buffers are the port's buffers: never parameters
    assert {k for k, v in ref.items() if k not in mask} == {
        n for n, _ in model.named_buffers()}
    assert not any(ref[n] for n, _ in model.named_buffers())
    if freeze:
        assert not all(mask.values())


def test_schedule_matches_jax():
    for warmup, milestones in ((5, (8, 10)), (0, (3,)), (1000, ())):
        jsch = JU.multistep_warmup_schedule(8e-5, warmup, milestones, 0.1)
        tsch = TU.multistep_warmup_schedule(8e-5, warmup, milestones, 0.1)
        for count in range(13):
            np.testing.assert_allclose(tsch(count), float(jsch(count)), rtol=1e-6)
    assert TU.multistep_warmup_schedule(1.0, 4)(0) == 0.25  # optax's count before the step


def test_clipped_adamw_matches_optax():
    """torch.optim.AdamW behind the global-norm clip equals the JAX optax chain,
    frozen leaves included (no update, no decay, no share of the norm)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (7,), "frozen": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * sc for k, s in shapes.items()}
             for sc in (3.0, 0.01, 1.0)]  # the clip triggers, then does not
    trainable = {"a": True, "b": True, "frozen": False}
    hyper = dict(lr=1e-2, weight_decay=1e-2, adam_eps=1e-15, grad_clip=1.0, warmup_steps=2,
                 milestones=(2,), gamma=0.5)
    tx = JU.make_optimizer(trainable=trainable, **hyper)
    jp = {k: j(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
    opt = TU.make_optimizer(tp.items(), trainable=trainable, **hyper)
    for g in grads:
        upd, st = tx.update({k: j(v) for k, v in g.items()}, st, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = t(g[k]) if trainable[k] else None
        norm = opt.step()
        ref_norm = np.sqrt(sum(float((g[k] ** 2).sum()) for k in ("a", "b")))
        np.testing.assert_allclose(float(norm), ref_norm, rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(tp["frozen"].detach().numpy(), p0["frozen"])
    assert not tp["frozen"].requires_grad


def test_update_ema_and_combine_frame_mask_match_jax():
    rng = np.random.default_rng(2)
    ema = {"w": rng.standard_normal((3, 4)).astype(np.float32),
           "frozen": rng.standard_normal((2,)).astype(np.float32)}
    new = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in ema.items()}
    mask = {"w": True, "frozen": False}
    ref = JU.update_ema({k: j(v) for k, v in ema.items()}, {k: j(v) for k, v in new.items()},
                        0.99, mask)
    e_mod, p_mod = torch.nn.Module(), torch.nn.Module()
    for k in ema:
        e_mod.register_parameter(k, torch.nn.Parameter(t(ema[k])))
        p_mod.register_parameter(k, torch.nn.Parameter(t(new[k])))
    TU.update_ema(e_mod, p_mod, 0.99, mask)
    for k in ema:
        np.testing.assert_allclose(getattr(e_mod, k).detach().numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)
    fv = np.ones((2, 9), np.float32)
    fv[1, 5:] = 0
    for m in (None, np.array([[1, 0, 1], [0, 0, 1]], np.float32),
              np.array([[1, 1, 1], [0, 1, 0]], np.float32)):
        got = TT.combine_frame_mask(None if m is None else t(m), t(fv))
        want = JT.combine_frame_mask(None if m is None else j(m), j(fv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mask_generator_and_condition_dropout_match_jax():
    from magicdrive_v2_tpu_torch.config.presets import default_mask_ratios
    ratios = dict(default_mask_ratios(), quarter_random=0.2, random=0.1, intepolate=0.1,
                  image_head=0.1)
    for seed in range(5):
        a = JU.MaskGenerator(ratios, pyrandom.Random(seed))
        b = TU.MaskGenerator(ratios, pyrandom.Random(seed))
        np.testing.assert_array_equal(b.get_masks(16, 5), a.get_masks(16, 5))
        np.testing.assert_array_equal(b.get_masks(4, 5, valid=np.array([5, 3, 1, 4])),
                                      a.get_masks(4, 5, valid=np.array([5, 3, 1, 4])))
        for x, y in zip(TU.sample_condition_dropout(pyrandom.Random(seed), 8, 17, 0.5, 0.4),
                        JU.sample_condition_dropout(pyrandom.Random(seed), 8, 17, 0.5, 0.4)):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- the port alone


def _tiny_port(**replace):
    _, tcfg = tiny_configs(**replace)
    model = TModel(tcfg)
    init_weights(model, seed=0)
    batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=16, b=1, seed=1)
    for k in ("timestep", "height", "width"):
        batch.pop(k)
    batch["mask"] = np.array([[1, 0, 1]], np.float32)
    return tcfg, model, to_device(batch, "cpu")


def test_remat_recomputes_each_layer_group_and_changes_no_grad():
    grads, calls = {}, {}
    for remat in (False, True):
        tcfg, model, batch = _tiny_port(grad_checkpoint=remat)
        n = [0]
        model.base_blocks_t[1].register_forward_pre_hook(
            lambda *a: n.__setitem__(0, n[0] + 1))
        loss, _ = TT.training_loss(model, TR.build_scheduler(SCHED), batch, height=HH,
                                   width=WW, num_frames=NF, dtype=torch.float32,
                                   t=torch.tensor([400.0]),
                                   noise=torch.ones(batch["x"].shape))
        loss.backward()
        grads[remat] = {k: p.grad for k, p in model.named_parameters()}
        calls[remat] = n[0]
    assert calls == {False: 1, True: 2}  # forward, and the recompute in the backward
    for k, g in grads[False].items():
        torch.testing.assert_close(grads[True][k], g, rtol=0, atol=0, msg=k)


def test_remat_policies_not_ported_raise():
    """An unknown remat policy raises; "dots" and "offload_carry" are ported: each
    builds and runs a backward that reaches every parameter (their grads against
    "full" are in tests/test_torch_remat.py)."""
    with pytest.raises(ValueError, match="unknown remat_policy"):
        _tiny_port(remat_policy="something")
    for policy in ("dots", "offload_carry"):
        tcfg, model, batch = _tiny_port(grad_checkpoint=True, remat_policy=policy)
        loss, _ = TT.training_loss(model, TR.build_scheduler(SCHED), batch, height=HH,
                                   width=WW, num_frames=NF, dtype=torch.float32,
                                   t=torch.tensor([400.0]), noise=torch.ones(batch["x"].shape))
        loss.backward()
        assert all(p.grad is not None and bool(p.grad.isfinite().all())
                   for p in model.parameters()), policy
    _tiny_port(grad_checkpoint=False, remat_policy="dots")  # no remat: plain autograd


def test_bf16_compute_params_cast_at_use_with_fp32_grads():
    """functional_call over bf16 casts of the fp32 masters gives the inference
    model's bf16 forward bit for bit (cast_model's rule), and the grads land in
    fp32 on the masters, the fp32-kept parameters included."""
    tcfg, model, batch = _tiny_port(dtype=torch.bfloat16)
    kw = dict(height=float(HH), width=float(WW), x_mask=batch["mask"])
    args = (batch["x"], torch.tensor([300.0]))
    cond = {k: batch[k] for k in ("y", "maps", "bbox", "cams", "rel_pos", "fps")}
    with torch.no_grad():
        ref = cast_model(copy.deepcopy(model), torch.bfloat16)(*args, **cond, **kw)
    params = compute_params(model, torch.bfloat16)
    assert params["base_blocks_s.0.attn.qkv.weight"].dtype == torch.bfloat16
    assert params["base_blocks_s.0.attn.q_norm.weight"].dtype == torch.float32
    out = torch.func.functional_call(model, params, args, {**cond, **kw})
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    out.square().mean().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 and p.dtype == torch.float32
               for p in model.parameters())


def test_checkpoint_roundtrip_and_find_latest(tmp_path):
    tcfg, model, batch = _tiny_port()
    cfg = dict(lr=1e-3, warmup_steps=2)
    state, step = TT.build_training(model, TR.build_scheduler(SCHED), cfg, height=HH,
                                    width=WW, num_frames=NF)
    state, _ = step(state, batch)
    assert find_latest(str(tmp_path)) is None
    for s in (1, 10, 2):
        save_checkpoint(str(tmp_path), s, model=state.model, optimizer=state.optimizer,
                        ema=state.ema, running_states={"epoch": 0})
    latest = find_latest(str(tmp_path))
    assert latest.endswith("global_step10")
    with open(os.path.join(latest, "running_states.json")) as f:
        assert json.load(f) == {"epoch": 0, "step": 10}
    _, fresh, _ = _tiny_port()
    fresh_state, _ = TT.build_training(fresh, TR.build_scheduler(SCHED), cfg, height=HH,
                                       width=WW, num_frames=NF)
    running = load_checkpoint(latest, model=fresh_state.model, ema=fresh_state.ema,
                              optimizer=fresh_state.optimizer)
    assert running["step"] == 10 and fresh_state.optimizer.count == 1
    for a, b in ((state.model, fresh_state.model), (state.ema, fresh_state.ema)):
        for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)


def test_rng_state_roundtrip_and_no_code_from_a_tampered_file(tmp_path):
    """The host RNG states go through JSON: a resumed run draws what the saved one
    would, and a pickle put in the file's place is refused without running."""
    path = str(tmp_path / "rng_state.json")
    save_rng_state(path)
    want = (pyrandom.random(), np.random.standard_normal(3))
    load_rng_state(path)
    got = (pyrandom.random(), np.random.standard_normal(3))
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    marker = tmp_path / "ran"
    with open(path, "wb") as f:
        pickle.dump(_Touch(str(marker)), f)
    with open(path, "rb") as f:  # the payload does run where a pickle is loaded
        pickle.load(f)
    assert marker.exists()
    marker.unlink()
    for load in (lambda: load_rng_state(path),
                 lambda: load_checkpoint(str(tmp_path))):
        with pytest.raises(ValueError):
            load()
    assert not marker.exists()


class _Touch:
    """Unpickling this creates a file: stands for code a pickle could run."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return _touch, (self.path,)


def _touch(path):
    open(path, "w").close()


def _app(args):
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    return train_magicdrive.main([SMOKE, "--synthetic", "--device", "cpu"] + args)


def test_app_resume_equals_an_uninterrupted_run(tmp_path, caplog):
    """4 steps in one run equal 2 steps plus a resume of 2, bit for bit: the
    metrics, and the model, EMA and optimizer saved at step 4 (once: the final
    save skips the step ckpt_every = 4 has just saved)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    with caplog.at_level("INFO", logger="magicdrive_v2_tpu_torch.utils.ckpt"):
        whole = _app(["--max-steps", "4", "--cfg-options", f"outputs={a}"])
    saved = [r.getMessage() for r in caplog.records if r.getMessage().startswith("saved")]
    assert len(saved) == 1 and saved[0].endswith("global_step4"), saved
    first = _app(["--max-steps", "2", "--cfg-options", f"outputs={b}"])
    with caplog.at_level("INFO", logger="train"):
        second = _app(["--max-steps", "2", "--cfg-options", f"outputs={b}"])
    assert any(r.getMessage().startswith("resumed from") and r.getMessage().endswith(
        "at step 2") for r in caplog.records)
    key = lambda lines: [(x["step"], x["loss"], x["grad_norm"]) for x in lines]
    assert key(whole) == key(first + second) and [x["step"] for x in whole] == [1, 2, 3, 4]
    for name in ("model.pt", "ema.pt"):
        x = torch.load(os.path.join(a, "global_step4", name))
        y = torch.load(os.path.join(b, "global_step4", name))
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x), name
    x = torch.load(os.path.join(a, "global_step4", "optimizer.pt"))
    y = torch.load(os.path.join(b, "global_step4", "optimizer.pt"))
    assert x["count"] == y["count"] == 4
    for i, s in x["adamw"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], y["adamw"]["state"][i][k])
    # in-training validation with the EMA weights at report_every = 4: 9 PNG frames
    assert len(os.listdir(os.path.join(a, "validation", "step4_val0_0"))) == 9
    with open(os.path.join(b, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4]


def test_app_refuses_what_is_not_ported(tmp_path):
    """A dataset without a train split is refused. sp_size 2 and simulate_sp_size
    run in one process (sp = min(2, 1) = 1; the simulate pick pads H); 4 ranks at
    sp_size 2 form a (2, 2) mesh, 3 ranks (which sp does not divide) are refused by
    name. No card, no silent CPU run."""
    out = f"outputs={tmp_path}"
    from magicdrive_v2_tpu_torch.parallel.distributed import training_mesh_shape
    from magicdrive_v2_tpu_torch.scripts import train_magicdrive
    with pytest.raises(KeyError, match="data.train"):
        train_magicdrive.main([SMOKE, "--device", "cpu", "--cfg-options", out,
                               "dataset={'type': 'x'}"])
    (line,) = _app(["--max-steps", "1", "--cfg-options", out, "sp_size=2",
                    "simulate_sp_size=[4]"])
    assert line["step"] == 1 and line["simulate_sp"] == 4 and np.isfinite(line["loss"])
    assert training_mesh_shape(2, 4) == (2, 2)  # the ranks beyond sp are dp rows
    with pytest.raises(ValueError, match="data-parallel rows"):
        training_mesh_shape(2, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_magicdrive.main([SMOKE, "--synthetic", "--cfg-options", out])


@pytest.mark.parametrize("point", ["adaln_modulate", "fused_qkv_attention",
                                   "dot_product_attention"])
def test_chip_smoke_grads_check_refuses_outputs_outside_autograd(point, monkeypatch):
    """The comparison chip_smoke.py's phase grads makes on the card, tried on a
    stand-in for fault C1: one wrapper's output detached from autograd, as a
    kernel's result written into a fresh tensor is. It must refuse that (a lost or
    zero grad, or grads that moved past the limit where another path still reaches
    a parameter) and accept the sound path."""
    import chip_smoke
    from magicdrive_v2_tpu_torch.models.layers import blocks
    from magicdrive_v2_tpu_torch.models.magicdrive import stdit3

    def grads(model, batch):
        model.zero_grad(set_to_none=True)
        loss, _ = TT.training_loss(model, TR.build_scheduler(SCHED), batch, height=HH,
                                   width=WW, num_frames=NF, dtype=torch.float32,
                                   t=torch.tensor([400.0]), noise=torch.ones(batch["x"].shape))
        loss.backward()
        return {n: None if p.grad is None else p.grad.clone()
                for n, p in model.named_parameters()}

    tcfg, model, batch = _tiny_port(grad_checkpoint=False)
    ref = grads(model, batch)
    worst, n, _ = chip_smoke.compare_grads(torch, grads(model, batch), ref)
    assert worst[0] == 0.0 and n == len(ref)
    module = stdit3 if point == "adaln_modulate" else blocks
    sound = getattr(module, point)
    monkeypatch.setattr(module, point, lambda *a, **k: sound(*a, **k).detach())
    with pytest.raises(RuntimeError, match="chip_smoke check failed"):
        # as run_grads judges: no grad lost, then every tensor within its limit
        worst, _, _ = chip_smoke.compare_grads(torch, grads(model, batch), ref)
        chip_smoke.require(worst[0] <= 1.0, worst)
