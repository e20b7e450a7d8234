"""PyTorch port, BrushNet / SDE-BrushNet training against the JAX package on the
CPU: the SDE model's ``train`` switch (the structured noise's cutoff jitter) and
two train steps of the port's ``make_train_step`` against two of JAX's
``make_brushnet_train_step`` (jit), with
only the branch trainable.

Models: tests/test_torch_brushnet.py's tiny configs (hidden 64, depth 2 / control
depth 1, 9 frames of 32x40, fp32), every JAX leaf random; the port remats each
layer group ("full"), JAX does not (remat changes no value). JAX's random draws
(t, t_inpaint, the velocity noise, the cutoff and the SDE model's normal draw,
from the JAX step's own split of its key) are handed to the port.

Tolerances: the forward 1e-4 as the BrushNet forwards' (fp32 through ~20
blocks); the steps those of tests/test_torch_training.py's two-step test (loss,
grad norm, t mean 2e-5 relative; trainable parameters and EMA within 2e-6 but for
elements whose grad lies below the packages' 2e-4 agreement, bounded by two
opposite AdamW steps; the SDE model's ShallowEncoder within 0.2 of the steps'
learning rates, see ``strong_within``); frozen parameters and their EMA bit for
bit.
"""
import numpy as np
import pytest
import torch

from test_torch_brushnet import ATOL, HH, NF, WW, inpaint_inputs, input_noise, tree
from test_torch_brushnet import models as brush_models
from test_torch_common import assert_close, j, load_into, np_tree, t

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.ops.structured_noise import sample_cutoff_radius as j_cutoff
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu.training import lora as JL
from magicdrive_v2_tpu.training import trainer as JT
from magicdrive_v2_tpu.utils import train_utils as JU
from magicdrive_v2_tpu_torch.models.magicdrive import brushnet as TB
from magicdrive_v2_tpu_torch.ops.structured_noise import sample_cutoff_radius
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.schedulers import rf as TR
from magicdrive_v2_tpu_torch.training import lora as TL
from magicdrive_v2_tpu_torch.training import trainer as TT
from magicdrive_v2_tpu_torch.utils import train_utils as TU
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params
from magicdrive_v2_tpu_torch.utils.misc import to_device

B = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the tier-1 run has several test workers on one
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_sde_train_forward_matches_jax():
    """``train=True`` with JAX's cutoff (r0 + Exp(0.1) from the first half of its
    key) and JAX's normal draw (the second half) equals JAX's training forward; a
    second cutoff moves the output; a generator draws the cutoff first."""
    jcfg, tcfg, jmodel, params, tmodel, batch = brush_models(True)
    key = jax.random.PRNGKey(7)
    ref = jmodel.apply(params, **tree(batch, j), rngs_key=key, train=True)
    ck, nk = jax.random.split(key)
    cutoff = float(j_cutoff(ck, jcfg.structured_noise_r0))
    assert cutoff > jcfg.structured_noise_r0 + 1.0  # far enough from eval's r0 to matter
    noise = t(input_noise(nk, tcfg, 1))
    tb = tree(batch, t)
    with torch.no_grad():
        out = tmodel(**tb, train=True, cutoff_radius=cutoff, inpaint_input_noise=noise)
        assert_close(out, ref, ATOL)
        for other in (dict(train=False), dict(train=True, cutoff_radius=cutoff + 10.0)):
            moved = tmodel(**tb, inpaint_input_noise=noise, **other)
            assert float((moved - out).abs().max()) > 1e-4, other
        g = torch.Generator().manual_seed(0)
        drawn = tmodel(**tb, train=True, generator=g)
        g.manual_seed(0)
        r = float(sample_cutoff_radius(g, tcfg.structured_noise_r0))
        n = torch.randn(noise.shape, generator=g)
        np.testing.assert_array_equal(drawn.numpy(), tmodel(
            **tb, train=True, cutoff_radius=r, inpaint_input_noise=n).numpy())
        with pytest.raises(ValueError, match="generator or cutoff_radius"):
            tmodel(**tb, train=True, inpaint_input_noise=noise)
        with pytest.raises(ValueError, match="train=True"):
            tmodel(**tb, cutoff_radius=cutoff, inpaint_input_noise=noise)


def strong_within(sde, name, lr_sum):
    """The bound on an element's difference after two steps where its grad lies
    above 2e-4 of the tensor's largest. The packages' grads agree within ~1e-6 of
    the tensor's largest |grad| (so 2e-6). The SDE model's ShallowEncoder's agree
    within 1.1e-5 (measured; within 2e-5, say): its grads come through the
    structured noise's phase normalisation, x_hat / |x_hat|, which divides by small
    FFT magnitudes. Such a grad may then be off by 2e-5 / 2e-4 = 0.1 of itself, and
    an AdamW step (~lr * m / sqrt(v)) by as much of its learning rate: twice that,
    0.2 of the two steps' learning rates."""
    return 0.2 * lr_sum if sde and name.startswith("shallow_encoder") else 2e-6


def _batch(tcfg):
    batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=8, b=B, map_size=(8, 40, 40), seed=5)
    for k in ("timestep", "height", "width"):
        batch.pop(k)
    batch["mask"] = np.array([[1, 0, 1], [0, 1, 1]], np.float32)
    # ego poses that differ from frame to frame (no degenerate attention rows)
    batch["rel_pos"] = np.random.default_rng(6).standard_normal(
        batch["rel_pos"].shape).astype(np.float32)
    xi, mi = zip(*(inpaint_inputs(tcfg.nc, seed=s) for s in (1, 2)))
    batch["x_inpaint"], batch["mask_inpaint"] = np.concatenate(xi), np.concatenate(mi)
    return batch


@pytest.mark.parametrize("sde", [False, True], ids=["brushnet", "sde"])
def test_two_brushnet_train_steps_match_jax(sde):
    """Two steps of the port's step against two of JAX's jitted
    ``make_brushnet_train_step``: a warm-up and a clip that triggers, only the
    branch trainable (``lora_trainable_mask(BRUSHNET_EXTRA_TRAINABLE)``)."""
    jcfg, tcfg, jmodel, params, _, _ = brush_models(sde)
    batch = _batch(tcfg)
    hyper = dict(lr=1e-3, weight_decay=1e-2, adam_eps=1e-8, grad_clip=0.05, warmup_steps=3)
    sched_cfg = dict(type="rflow-sdebrushnet" if sde else "rflow-brushnet",
                     use_timestep_transform=True, cog_style_trans=True,
                     sample_method="logit-normal")
    jsched = JR.build_scheduler(sched_cfg)
    jmask = JL.lora_trainable_mask(params, JL.BRUSHNET_EXTRA_TRAINABLE)
    tx = JU.make_optimizer(trainable=jmask, **hyper)
    jstate = JT.create_train_state(params, tx)
    jstep = jax.jit(JT.make_brushnet_train_step(jmodel, jsched, tx, height=HH, width=WW,
                                                num_frames=NF, ema_decay=0.99,
                                                ema_mask=jmask, sde=sde))
    jb = tree(batch, j)

    model = load_into(TB.MagicDriveSTDiT3BrushNet(tcfg), params,
                      control_depth=tcfg.control_depth)
    assert model.cfg.grad_checkpoint and model.cfg.remat_policy == "full"
    tmask = TL.lora_trainable_mask(model.named_parameters(), TL.BRUSHNET_EXTRA_TRAINABLE)
    opt = TU.make_optimizer(model.named_parameters(), trainable=tmask, **hyper)
    state = TT.TrainState(step=0, model=model, optimizer=opt,
                          ema=load_into(TB.MagicDriveSTDiT3BrushNet(tcfg), params,
                                        control_depth=tcfg.control_depth).requires_grad_(False))
    tstep = TT.make_train_step(TR.build_scheduler(sched_cfg), height=HH, width=WW,
                               num_frames=NF, dtype=torch.float32, ema_decay=0.99,
                               ema_mask=tmask)
    dev = to_device(batch, "cpu")
    hw = {k: jnp.full((B,), float(v)) for k, v in (("height", HH), ("width", WW),
                                                    ("num_frames", NF))}
    trainable = [n for n, m in tmask.items() if m]
    weak = {n: torch.zeros(dict(model.named_parameters())[n].shape, dtype=torch.bool)
            for n in trainable}
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        loss_key, noise_key = jax.random.split(key)  # the JAX step's split
        if sde:  # RFLOW_SDEBRUSHNET.training_losses' split, then the model's
            t_key, ti_key, n_key = jax.random.split(loss_key, 3)
            ck, nk = jax.random.split(noise_key)
            draws = dict(t_inpaint=jsched.sample_t(ti_key, B, **hw),
                         cutoff_radius=float(j_cutoff(ck, jcfg.structured_noise_r0)),
                         inpaint_input_noise=input_noise(nk, tcfg, B))
        else:
            t_key, n_key = jax.random.split(loss_key)
            draws = {}
        draws.update(t=jsched.sample_t(t_key, B, **hw),
                     noise=jax.random.normal(n_key, batch["x"].shape, jnp.float32))
        jstate, jm = jstep(jstate, jb, key)
        state, m = tstep(state, dev, **{k: v if isinstance(v, float) else t(np.asarray(v))
                                        for k, v in draws.items()})
        for k in ("loss", "grad_norm", "t_mean"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5, err_msg=k)
        assert float(m["grad_norm"]) > hyper["grad_clip"]  # the clip triggered
        for name, p in model.named_parameters():
            if name not in weak:
                assert p.grad is None, name  # frozen: no grad computed at all
                continue
            g = p.grad.abs()  # grads below the packages' agreement
            weak[name] |= (g <= 2e-4 * g.max()) & bool(g.max() > 0)
    assert state.step == 2 and state.optimizer.count == 2
    share = {n: float(w.float().mean()) for n, w in weak.items()}
    overall = sum(int(w.sum()) for w in weak.values()) / sum(w.numel() for w in weak.values())
    worst = max(share, key=share.get)
    print(f"loosely compared: {overall:.4%} of the trainable elements, at most "
          f"{share[worst]:.4%} of a tensor ({worst})")
    assert overall <= 0.05 and share[worst] <= 0.5, (overall, worst, share[worst])
    sched = TU.multistep_warmup_schedule(hyper["lr"], hyper["warmup_steps"])
    flip = 2 * (sched(0) + sched(1)) * (1 + hyper["weight_decay"])
    start = from_jax_params(np_tree(params), tcfg.control_depth)
    for tree_, module in ((jstate.params, state.model), (jstate.ema_params, state.ema)):
        ref = from_jax_params(np_tree(tree_), tcfg.control_depth)
        for name, p in module.named_parameters():
            got = p.detach().numpy()
            if not tmask[name]:  # frozen: the initial weights, bit for bit, on both sides
                np.testing.assert_array_equal(got, ref[name], err_msg=name)
                np.testing.assert_array_equal(got, start[name], err_msg=name)
                continue
            err = np.abs(got - ref[name])
            assert float(err.max()) <= flip, (name, float(err.max()))
            np.testing.assert_array_less(err[~weak[name].numpy()],
                                         strong_within(sde, name, sched(0) + sched(1)),
                                         err_msg=name)
    moved = [n for n in trainable
             if not np.array_equal(dict(state.model.named_parameters())[n].detach().numpy(),
                                   start[n])]
    assert len(moved) == len(trainable) > 0


@pytest.mark.parametrize("sde", [False, True], ids=["brushnet", "sde"])
def test_step_reads_the_sde_variant_off_the_model(sde):
    """One step factory serves both types: the model's ``sde_inpaint`` picks the
    loss, so a scheduler of the other type is refused, and the plain BrushNet step
    takes no SDE draw."""
    from magicdrive_v2_tpu_torch.config.presets import rflow
    from test_torch_common import tiny_configs
    tcfg = TB.BrushNetConfig.from_base(tiny_configs()[1], sde_inpaint=sde)
    model = TB.MagicDriveSTDiT3BrushNet(tcfg)
    batch = to_device(_batch(tcfg), "cpu")
    wrong = TR.build_scheduler(rflow(type="rflow-brushnet" if sde else "rflow-sdebrushnet"))
    with pytest.raises(ValueError, match=f"sde_inpaint={sde}"):
        TT.training_loss(model, wrong, batch, height=HH, width=WW, num_frames=NF,
                         dtype=torch.float32)
    mask = TL.lora_trainable_mask(model.named_parameters(), TL.BRUSHNET_EXTRA_TRAINABLE)
    state = TT.TrainState(step=0, model=model, ema=None, optimizer=TU.make_optimizer(
        model.named_parameters(), lr=1e-3, trainable=mask))
    step = TT.make_train_step(TR.build_scheduler(rflow(type="rflow-brushnet")), height=HH,
                              width=WW, num_frames=NF, dtype=torch.float32)
    if not sde:
        with pytest.raises(TypeError, match="t_inpaint"):
            step(state, batch, t_inpaint=torch.tensor([250.0] * B))
    else:  # the SDE model with the plain BrushNet scheduler
        with pytest.raises(ValueError, match="sde_inpaint=True"):
            step(state, batch)
    assert state.step == 0

