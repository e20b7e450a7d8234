"""PyTorch port, LoRA, the BrushNet trainable mask and the BrushNet train app
against the JAX package on the CPU.

Models: the tiny flagship (hidden 64, depth 2 / control depth 1) as the base
model and as BrushNet / SDE-BrushNet (tests/test_torch_brushnet.py's configs),
every JAX leaf random. Tolerances: merged weights 1e-6 (one fp32 product of rank
2 added to weights of order 0.05: rounding of the sum only); masks, targets,
shapes and batches exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_brushnet import models as brush_models
from test_torch_common import j, np_tree, random_params, tiny_configs

from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.training import lora as JL
from magicdrive_v2_tpu_torch.models.magicdrive import brushnet as TB
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.training import lora as TL
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params, load_checkpoint
from magicdrive_v2_tpu_torch.utils.train_utils import flax_style_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRUSH_SMOKE = os.path.join(REPO, "configs/magicdrive/train/brushnet_smoke.py")
KINDS = ("base", "brushnet", "sde")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the tier-1 run has several test workers on one
    machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def trees(kind):
    """(JAX params, port config, the port's state dict of them as numpy)."""
    if kind == "base":
        jcfg, tcfg = tiny_configs()
        batch = synthetic_batch(tcfg, 9, 64, 80, l_txt=8, b=1, seed=0)
        jb = {k: ({kk: j(vv) for kk, vv in v.items()} if isinstance(v, dict) else
                  j(v) if isinstance(v, np.ndarray) else v) for k, v in batch.items()}
        params = random_params(JModel(jcfg), **jb)
    else:
        _, tcfg, _, params, _, _ = brush_models(kind == "sde")
    return params, tcfg, from_jax_params(np_tree(params), tcfg.control_depth)


@pytest.mark.parametrize("kind", KINDS)
def test_init_lora_targets_and_shapes_match_jax(kind):
    """The JAX adapters of a tree, carried over per block, and the port's over the
    same weights: one set of names, one shape each; a in +-1/sqrt(in), b zero."""
    params, tcfg, state = trees(kind)
    jlora = JL.init_lora(params, rank=2, rng=jax.random.PRNGKey(0))
    ref = TL.lora_from_jax(np_tree(jlora), tcfg.control_depth)
    weights = [(n, torch.from_numpy(np.array(v))) for n, v in state.items()]
    mine = TL.init_lora(weights, 2, torch.Generator().manual_seed(0))
    assert len(ref) > 0 and mine.keys() == ref.keys()
    # the reference's targets on the base blocks only: 7 linears a block
    n_base = tcfg.depth * (2 if tcfg.with_temp_block else 1)
    assert len(mine) == 7 * n_base
    assert all(".cross_view_attn." not in n and n.startswith("base_blocks") for n in mine)
    for name, ab in mine.items():
        assert tuple(ab["a"].shape) == ref[name]["a"].shape, name
        assert tuple(ab["b"].shape) == ref[name]["b"].shape, name
        bound = 1 / np.sqrt(state[name].shape[1])
        assert float(ab["a"].abs().max()) <= bound and float(ab["a"].abs().max()) > bound / 2
        assert not bool(ab["b"].any())


@pytest.mark.parametrize("kind", KINDS)
def test_merge_lora_of_jax_adapters_equals_jax_merge(kind):
    params, tcfg, state = trees(kind)
    jlora = JL.init_lora(params, rank=2, rng=jax.random.PRNGKey(1))
    # b is zero at init: give it values, so the merge moves the weights
    keys = iter(jax.random.split(jax.random.PRNGKey(2), 1000))
    jlora = jax.tree_util.tree_map(lambda x: jax.random.normal(next(keys), x.shape) * 0.1,
                                   jlora)
    ref = from_jax_params(np_tree(JL.merge_lora(params, jlora, alpha=4.0, rank=2)),
                          tcfg.control_depth)
    tensors = {n: torch.from_numpy(np.array(v)) for n, v in state.items()}
    merged = TL.merge_lora(tensors, TL.lora_from_jax(np_tree(jlora), tcfg.control_depth),
                           alpha=4.0, rank=2)
    assert merged.keys() == ref.keys()
    moved = 0
    for name, w in merged.items():
        np.testing.assert_allclose(w.numpy(), ref[name], rtol=0, atol=1e-6, err_msg=name)
        if not np.array_equal(ref[name], state[name]):
            moved += 1
        else:  # what no adapter targets is the same tensor, untouched
            assert merged[name] is tensors[name]
    assert moved == 7 * tcfg.depth * (2 if tcfg.with_temp_block else 1)


@pytest.mark.parametrize("kind", ["brushnet", "sde"])
def test_brushnet_trainable_mask_equals_jax_leaf_for_leaf(kind):
    """The port's patterns on its '/'-joined paths select what the JAX patterns
    select on flax's (``re.match`` anchored at the start; the SDE blocks
    ``t_inpaint_block_1`` in flax, ``t_inpaint_block.1`` in torch)."""
    params, tcfg, _ = trees(kind)
    jmask = JL.lora_trainable_mask(params, JL.BRUSHNET_EXTRA_TRAINABLE)
    spread = jax.tree_util.tree_map(lambda p, m: np.full(p.shape, m), params, jmask)
    ref = {k: bool(np.all(v)) for k, v in from_jax_params(spread, tcfg.control_depth).items()}
    model = TB.MagicDriveSTDiT3BrushNet(tcfg)
    mask = TL.lora_trainable_mask(model.named_parameters(), TL.BRUSHNET_EXTRA_TRAINABLE)
    assert mask == {k: ref[k] for k in mask}
    # what JAX holds beyond the port's parameters are the port's buffers: frozen
    assert set(ref) - set(mask) == {n for n, _ in model.named_buffers()}
    assert not any(ref[n] for n, _ in model.named_buffers())
    trainable = {n for n, m in mask.items() if m}
    assert trainable and all(n.startswith(("brushnet_blocks", "shallow_encoder",
                                           "x_brushnet_embedder", "t_inpaint_block",
                                           "t_combine_block")) for n in trainable)
    assert any(n.startswith("t_inpaint_block.1") for n in trainable) == (kind == "sde")


def test_flax_style_paths_of_both_models():
    """The groups follow the model the names come from: its control depth (the
    length of control_blocks_s) and whether it has BrushNet blocks."""
    base = flax_style_paths(["base_blocks_s.0.attn.qkv.weight", "base_blocks_t.1.mlp.fc1.bias",
                             "control_blocks_s.0.attn.proj.weight"])
    assert base == {"base_blocks_s.0.attn.qkv.weight": "ctrl_layers/base_s/attn/qkv/weight",
                    "base_blocks_t.1.mlp.fc1.bias": "plain_layers/base_t/mlp/fc1/bias",
                    "control_blocks_s.0.attn.proj.weight":
                        "ctrl_layers/control_s/attn/proj/weight"}
    brush = flax_style_paths(["base_blocks_s.0.attn.qkv.weight", "base_blocks_s.1.attn.qkv.weight",
                              "brushnet_blocks_t.1.after_proj.weight",
                              "control_blocks_s.0.attn.proj.weight",
                              "control_blocks_t.0.attn.proj.weight", "t_inpaint_block.1.weight"])
    assert brush == {
        "base_blocks_s.0.attn.qkv.weight": "brush_ctrl_layers/base_s/attn/qkv/weight",
        "base_blocks_s.1.attn.qkv.weight": "brush_plain_layers/base_s/attn/qkv/weight",
        "brushnet_blocks_t.1.after_proj.weight": "brush_plain_layers/brushnet_t/after_proj/weight",
        "control_blocks_s.0.attn.proj.weight": "brush_ctrl_layers/control_s/attn/proj/weight",
        "control_blocks_t.0.attn.proj.weight": "brush_ctrl_layers/control_t/attn/proj/weight",
        "t_inpaint_block.1.weight": "t_inpaint_block/1/weight"}
    # no control blocks: every base block is a plain layer
    assert flax_style_paths(["base_blocks_s.0.attn.qkv.weight"]) == {
        "base_blocks_s.0.attn.qkv.weight": "plain_layers/base_s/attn/qkv/weight"}


# ---------------------------------------------------------------- the train app


def _port_app(argv):
    from magicdrive_v2_tpu_torch.scripts import train_brushnet
    return train_brushnet.main([BRUSH_SMOKE, "--synthetic", "--device", "cpu"] + argv)


def test_app_batches_equal_the_jax_apps(tmp_path, monkeypatch):
    """The JAX app runs in this process on one device up to its steps, its step
    replaced by one that records the batches: each equals the port app's
    ``make_batch`` exactly."""
    import importlib.util
    import sys

    from magicdrive_v2_tpu.models.magicdrive import brushnet as JB
    from magicdrive_v2_tpu.training import trainer as JT
    from magicdrive_v2_tpu.utils import ckpt as jckpt
    from magicdrive_v2_tpu_torch.config.config import Config
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
    from magicdrive_v2_tpu_torch.scripts.train_brushnet import make_batch

    seen = []

    def recording_step(*args, **kwargs):
        def step(state, batch, key):
            seen.append(jax.tree_util.tree_map(np.asarray, batch))
            return state, {"loss": jnp.float32(1.0)}
        return step

    init = JB.MagicDriveSTDiT3BrushNet.init

    def shapes_only(self, *args, **kwargs):  # the params' shapes, no forward
        shapes = jax.eval_shape(lambda: init(self, *args, **kwargs))
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(JT, "make_brushnet_train_step", recording_step)
    monkeypatch.setattr(JB.MagicDriveSTDiT3BrushNet, "init", shapes_only)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    # the JAX app on one device, as the port runs (the tests' CPU has 8 virtual
    # ones, and the JAX app's batch is batch_size rows a local device)
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    monkeypatch.setattr(jckpt, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.setenv("MDV2_JAXCACHE_DIR", "")
    path = os.path.join(REPO, "scripts", "train_brushnet.py")
    spec = importlib.util.spec_from_file_location("jax_train_brushnet_app", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [path, BRUSH_SMOKE, "--synthetic", "--sde",
                                      "--max-steps", "2", "--cfg-options",
                                      f"outputs={tmp_path}", "batch_size=2"])
    mod.main()
    assert len(seen) == 2
    cfg = Config.fromfile(BRUSH_SMOKE)
    cfg.batch_size = 2
    model_cfg = build_model_config(cfg.model, mv_order_map=cfg.mv_order_map)
    for step, ref in enumerate(seen, start=1):
        mine = make_batch(model_cfg, cfg, step)
        assert mine.keys() == ref.keys()
        for k, v in mine.items():
            if isinstance(v, dict):
                assert v.keys() == ref[k].keys()
                for kk in v:
                    np.testing.assert_array_equal(v[kk], ref[k][kk], err_msg=f"{k}.{kk}")
            else:
                np.testing.assert_array_equal(v, ref[k], err_msg=k)
    assert mine["x_inpaint"].shape == (2, 18, 9, 64, 80)
    assert set(np.unique(mine["mask_inpaint"])) == {0.0, 1.0}


@pytest.mark.parametrize("sde", [False, True], ids=["brushnet", "sde"])
def test_app_trains_the_branch_and_its_checkpoint_reloads(sde, tmp_path):
    out = str(tmp_path)
    lines = _port_app(["--max-steps", "2", "--cfg-options", f"outputs={out}"]
                      + (["--sde"] if sde else []))
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) and x["grad_norm"] > 0 for x in lines)
    ckpt = os.path.join(out, "global_step2")
    assert sorted(os.listdir(ckpt)) == ["ema.pt", "model.pt", "rng_state.json",
                                        "running_states.json"]
    from magicdrive_v2_tpu_torch.config.config import Config
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
    cfg = Config.fromfile(BRUSH_SMOKE)
    tcfg = TB.BrushNetConfig.from_base(build_model_config(
        cfg.model, mv_order_map=cfg.mv_order_map, dtype=torch.float32), sde_inpaint=sde)
    model, ema = TB.MagicDriveSTDiT3BrushNet(tcfg), TB.MagicDriveSTDiT3BrushNet(tcfg)
    running = load_checkpoint(ckpt, model=model, ema=ema)  # load_state_dict strict=True
    assert running["step"] == 2
    saved = torch.load(os.path.join(ckpt, "model.pt"))
    assert saved.keys() == model.state_dict().keys()
    # the frozen base is the seeded init in both, the branch moved
    from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
    fresh = TB.MagicDriveSTDiT3BrushNet(tcfg)
    init_weights(fresh, seed=cfg.seed)
    mask = TL.lora_trainable_mask(fresh.named_parameters(), TL.BRUSHNET_EXTRA_TRAINABLE)
    own, ema_p = dict(model.named_parameters()), dict(ema.named_parameters())
    for name, p in fresh.named_parameters():
        if mask[name]:
            continue
        assert torch.equal(own[name], p) and torch.equal(ema_p[name], p), name
    assert any(not torch.equal(own[n], p) for n, p in fresh.named_parameters() if mask[n])


def test_app_refuses_what_is_not_ported(tmp_path):
    """sp_size 2 in one process trains at sp = min(2, 1) = 1 (the JAX app's rule);
    4 ranks at sp_size 2 form a (2, 2) mesh, 3 ranks (which sp does not divide)
    are refused by name; no card, no silent CPU run."""
    from magicdrive_v2_tpu_torch.parallel.distributed import training_mesh_shape
    from magicdrive_v2_tpu_torch.scripts import train_brushnet
    out = f"outputs={tmp_path}"
    (line,) = _port_app(["--max-steps", "1", "--cfg-options", out, "sp_size=2"])
    assert line["step"] == 1 and np.isfinite(line["loss"])
    assert training_mesh_shape(2, 4) == (2, 2)  # the ranks beyond sp are dp rows
    with pytest.raises(ValueError, match="data-parallel rows"):
        training_mesh_shape(2, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_brushnet.main([BRUSH_SMOKE, "--synthetic", "--cfg-options", out])
