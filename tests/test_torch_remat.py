"""PyTorch port, the remat policies "dots" and "offload_carry" against "full" on
the CPU (the JAX package's tests/test_stdit3.py test_dots_remat_matches_full and
test_offload_carry_remat_matches_full are the model): the same loss and every
grad, and each policy's mechanism. Tiny flagship (hidden 64, depth 2 / control
depth 1, 9 frames of 64x80, fp32), the base model with every parameter trainable
and the SDE-BrushNet model with only its branch trainable (the BrushNet train
step's case: the frozen first base block and the control blocks get no input that
requires grad).

Tolerance: none. A policy changes what is kept between the forward and the
backward, never the arithmetic: on the CPU every recomputed op repeats its
forward bit for bit, so loss and grads must equal "full"'s exactly.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_common import tiny_configs

from magicdrive_v2_tpu_torch.config.presets import rflow
from magicdrive_v2_tpu_torch.models.magicdrive import brushnet as TB
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.schedulers import rf as TR
from magicdrive_v2_tpu_torch.training import trainer as TT
from magicdrive_v2_tpu_torch.training.lora import (BRUSHNET_EXTRA_TRAINABLE,
                                                   lora_trainable_mask)
from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
from magicdrive_v2_tpu_torch.utils.misc import to_device
from magicdrive_v2_tpu_torch.utils.train_utils import make_optimizer

NF, HH, WW = 9, 64, 80
KINDS = ("base", "sde_brushnet")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the tier-1 run has several test workers on one
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def build(kind, policy, grad_checkpoint=True):
    """(model, batch, loss kwargs): seeded weights, one sample with a frame mask;
    the BrushNet model with its base frozen."""
    _, tcfg = tiny_configs(grad_checkpoint=grad_checkpoint, remat_policy=policy)
    batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=16, b=1, seed=1)
    for k in ("timestep", "height", "width"):
        batch.pop(k)
    batch["mask"] = np.array([[1, 0, 1]], np.float32)
    kw = dict(t=torch.tensor([400.0]), noise=torch.ones(batch["x"].shape))
    if kind == "base":
        model = MagicDriveSTDiT3(tcfg)
        init_weights(model, seed=0)
    else:
        model = TB.MagicDriveSTDiT3BrushNet(TB.BrushNetConfig.from_base(tcfg, sde_inpaint=True))
        init_weights(model, seed=0)
        make_optimizer(model.named_parameters(), lr=1e-3, trainable=lora_trainable_mask(
            model.named_parameters(), BRUSHNET_EXTRA_TRAINABLE))
        rng = np.random.default_rng(2)
        batch["x_inpaint"] = rng.standard_normal((1, 3 * tcfg.nc, NF, HH, WW)).astype(np.float32)
        batch["mask_inpaint"] = rng.integers(0, 2, (1, tcfg.nc, NF, HH, WW)).astype(np.float32)
        kw.update(t_inpaint=torch.tensor([250.0]),
                  model_kwargs=dict(generator=torch.Generator().manual_seed(3)))
    return model, to_device(batch, "cpu"), kw


def training_loss(model, batch, kw):
    sched = TR.build_scheduler(rflow(type="rflow-sdebrushnet" if "t_inpaint" in kw else "rflow"))
    if "model_kwargs" in kw:  # a fresh generator: every run draws the same noise
        kw = dict(kw, model_kwargs=dict(generator=torch.Generator().manual_seed(3)))
    loss, _ = TT.training_loss(model, sched, batch, height=HH, width=WW, num_frames=NF,
                               dtype=torch.float32, **kw)
    return loss


def loss_and_grads(model, batch, kw):
    loss = training_loss(model, batch, kw)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


class _CountProducts(TorchDispatchMode):
    """Counts the aten matrix products run under it."""

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "addmm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["dots", "offload_carry"])
@pytest.mark.parametrize("kind", KINDS)
def test_remat_policy_gives_full_remat_loss_and_grads(kind, policy):
    ref_loss, ref = loss_and_grads(*build(kind, "full"))
    loss, got = loss_and_grads(*build(kind, policy))
    assert torch.equal(loss, ref_loss)
    assert got.keys() == ref.keys() and len(ref) > 0
    for name, g in ref.items():
        assert g is not None and got[name] is not None, name
        torch.testing.assert_close(got[name], g, rtol=0, atol=0, msg=name)
    if kind == "sde_brushnet":  # only the branch trains; its grads are live
        assert all(n.startswith(("brushnet_blocks", "shallow_encoder", "x_brushnet_embedder",
                                 "t_inpaint_block", "t_combine_block")) for n in ref)
        assert all(bool((g != 0).any()) for g in ref.values())


@pytest.mark.parametrize("kind", KINDS)
def test_dots_keeps_the_linear_products_and_recomputes_the_batched_ones(kind):
    """Products the backward runs: without remat only the grads' own; under "full"
    also the forward's again; under "dots" the linear layers' (aten mm / addmm)
    come from the forward, the plain attention's batched ones (bmm) are
    recomputed as under "full"."""
    counts = {}
    for policy, remat in (("none", False), ("full", True), ("dots", True)):
        model, batch, kw = build(kind, "full" if policy == "none" else policy, remat)
        loss = training_loss(model, batch, kw)
        with _CountProducts() as mode:
            loss.backward()
        counts[policy] = mode.n
    linear = {p: c["mm"] + c["addmm"] for p, c in counts.items()}
    assert linear["dots"] == linear["none"] < linear["full"], counts
    assert counts["dots"]["bmm"] == counts["full"]["bmm"] > counts["none"]["bmm"], counts


@pytest.mark.parametrize("kind", KINDS)
def test_offload_carry_packs_exactly_the_group_carries(kind):
    """The hooks move to the host each group's carry that it updates: depth 0 x and
    c (and the BrushNet stream xi), depth 1 x (and xi), c passing through it; and
    nothing else checkpoint saves (the shared conditioning stays)."""
    model, batch, kw = build(kind, "offload_carry")
    offload = model.carry_offload
    loss_and_grads(model, batch, kw)
    B, T, S, C = model.cfg.nc, 3, (HH // 16) * (WW // 16), model.cfg.hidden_size
    n = 5 if kind == "sde_brushnet" else 3
    assert offload.tensors_to_host == n
    assert offload.bytes_to_host == n * B * T * S * C * 4
    with torch.no_grad():  # no autograd: no remat, nothing saved
        assert torch.isfinite(training_loss(model, batch, kw))
    assert offload.tensors_to_host == n


def test_unknown_remat_policy_raises_and_policies_need_remat():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        build("base", "something")
    # without grad_checkpoint the policy is never read: plain autograd
    model, batch, kw = build("base", "offload_carry", grad_checkpoint=False)
    loss_and_grads(model, batch, kw)
    assert model.carry_offload.tensors_to_host == 0


def test_chip_smoke_derives_the_brushnet_backward_calls(monkeypatch):
    """chip_smoke.py holds the backwards of each kernel's Function in a BrushNet
    training loss (only the branch trainable) against a count derived from the
    graph, and the launches against twice a forward's (the forward and the
    recompute). Here the three wrappers go through ``KernelFunction`` where
    autograd records, as on the card, with the plain versions on both sides."""
    import chip_smoke
    from magicdrive_v2_tpu_torch.ops import kernel_vjp
    from magicdrive_v2_tpu_torch.tools.block_bench import patch_points
    from test_torch_common import kernel_sites_as_on_the_card

    calls = {}
    for (module, attr), site in zip(patch_points(), kernel_sites_as_on_the_card(calls)):
        monkeypatch.setattr(module, attr, site)
    model, batch, kw = build("sde_brushnet", "full")
    with torch.no_grad():
        model.encode_conditions(tuple(batch["x"].shape), batch["y"], batch["maps"],
                                batch["bbox"], batch["cams"], batch["rel_pos"])
    encode, _ = dict(calls), calls.clear()
    monkeypatch.setattr(kernel_vjp, "backward_calls", {})
    loss_and_grads(model, batch, kw)
    per_forward = chip_smoke.expected_launches(model.cfg, x_mask=True)
    assert calls == {k: 2 * n + encode.get(k, 0) for k, n in per_forward.items()}
    assert kernel_vjp.backward_calls == chip_smoke.expected_backward_calls_frozen_base(
        model.cfg, x_mask=True)
