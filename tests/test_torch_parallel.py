"""PyTorch port, sequence parallelism on the CPU: the collectives of
``parallel/comm.py``, the mesh, the Ulysses-sharded tiny MagicDriveSTDiT3 and
SDE-BrushNet forwards, and the batch-scattered VAE decode (``sp_vae``), each
held against the JAX package.

The ranks are processes of one gloo group (``tests/torch_sp_worker.py``,
started by ``spawn_ranks`` with a deadline); they run the port's plain kernel
versions. One group of 4 ranks and one of 2, started together, serve the whole
module. The JAX
references run in this process on the virtual CPU devices of
``tests/conftest.py``: unsharded, with ``force_pad_h_for_sp_size``, and on a
(1, 4) mesh. Weights are every flax leaf random, carried by ``from_jax_params``.

Tolerances: 2e-4 absolute in fp32 against JAX (the JAX package's own for its
sequence-parallel tests); the port's sharded run against its unsharded one
within 1e-5 (the same arithmetic, tokens in other blocks), its scattered decode
against the direct one within 2e-5 (the port's VAE tests' fp32 tolerance: other
batch sizes); the collectives on fp64 values exactly.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_common import (assert_close, fill_tree, j, load_into, np_tree,
                               random_params, spawn_ranks, t, tiny_configs)

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.models.magicdrive import brushnet as JB
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.models.vae.cogvideox import AutoencoderKLCogVideoX as JVAE
from magicdrive_v2_tpu.models.vae.cogvideox import CogVAEConfig as JVAECfg
from magicdrive_v2_tpu.models.vae.cogvideox import VideoAutoencoderKLCogVideoX as JVAEWrap
from magicdrive_v2_tpu.parallel.sharding import make_mesh as j_make_mesh
from magicdrive_v2_tpu.parallel.sharding import sp_vae as j_sp_vae
from magicdrive_v2_tpu.parallel.sharding import use_mesh as j_use_mesh
from magicdrive_v2_tpu_torch.models.magicdrive import brushnet as TB
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3 as TModel
from magicdrive_v2_tpu_torch.models.vae.cogvideox import CogVAEConfig, VideoAutoencoderKLCogVideoX
from magicdrive_v2_tpu_torch.pipelines.magicdrive import synthetic_batch
from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params, load_state_dict_cast

TOL = 2e-4
DEADLINE_S = 240
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sp_worker.py")
# pixels 64x80 -> tokens 4x5: S=20 splits over 4 ranks; 48x80 -> 3x5: S=15 takes
# the sp pad (H 3 -> 4, S=20)
SIZES = {"s20": (64, 80), "s15": (48, 80)}
NF = 9
# the cases of each Function: the qkv layout of the attention (G, N, 3, H, D),
# heads scattered and the sequence gathered; the token layout (B, T, S, C) split
# and gathered over S
COMM = {"all_to_all": dict(shape=(3, 8, 3, 8, 5), scatter_dim=3, gather_dim=1),
        "split_seq": dict(shape=(3, 2, 8, 5), scatter_dim=2, gather_dim=None),
        "gather_seq": dict(shape=(3, 2, 8, 5), scatter_dim=2, gather_dim=None)}
VAE_TINY = dict(block_out_channels=(8, 8, 8, 16), latent_channels=4, layers_per_block=1,
                norm_num_groups=4)


def tree(v, conv):
    if isinstance(v, dict):
        return {k: tree(x, conv) for k, x in v.items()}
    return conv(v) if isinstance(v, np.ndarray) else v


def jax_forward(model, params, batch, **kw):
    """The JAX model's output under ``jax.jit`` (one compile instead of one per
    operation); height and width static."""
    batch = tree(batch, j)
    hw = {k: batch.pop(k) for k in ("height", "width")}
    return jax.jit(lambda p, b: model.apply(p, **b, **hw, **kw))(params, batch)


def port_cfg(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def run_groups(groups, tmp):
    """{n: cases}: each group of n ranks runs its cases, all groups at once; {n: each
    rank's results}."""
    from concurrent.futures import ThreadPoolExecutor
    dirs = {}
    for n, cases in groups.items():
        dirs[n] = os.path.join(tmp, f"sp{n}")
        os.makedirs(dirs[n])
        torch.save(cases, os.path.join(dirs[n], "inputs.pt"))
    with ThreadPoolExecutor(len(groups)) as pool:
        logs = {n: pool.submit(spawn_ranks, n, [WORKER, dirs[n]], DEADLINE_S) for n in groups}
        logs = {n: f.result() for n, f in logs.items()}
    return {n: [dict(torch.load(os.path.join(dirs[n], f"rank{r}.pt"), weights_only=True),
                     log=logs[n][r]) for r in range(n)] for n in groups}


@pytest.fixture(scope="module")
def base():
    """The tiny model (JAX and port, the same weights) and the batches of SIZES."""
    jcfg, tcfg = tiny_configs(grad_checkpoint=False)
    batches = {k: synthetic_batch(tcfg, NF, h, w, l_txt=8, map_size=(8, 80, 80))
               for k, (h, w) in SIZES.items()}
    for bt in batches.values():
        bt["height"], bt["width"] = float(bt["height"]), float(bt["width"])
    jmodel = JModel(jcfg)
    params = random_params(jmodel, **tree(batches["s20"], j))
    tmodel = load_into(TModel(tcfg), params, control_depth=tcfg.control_depth)
    return jcfg, tcfg, jmodel, params, tmodel, batches


@pytest.fixture(scope="module")
def vae():
    """(JAX wrapper, port wrapper) of the tiny VAE over the same random weights, and
    6 views of latents."""
    cfg = JVAECfg(**VAE_TINY)
    shapes = jax.eval_shape(lambda: JVAE(cfg).init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 3, 1, 16, 16))))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 1.0 if getattr(p[-1], "key", "") == "scale" else v,
        fill_tree(shapes, 3, std=0.1))
    jw = JVAEWrap(cfg)
    jw.params = params
    tw = VideoAutoencoderKLCogVideoX(CogVAEConfig(**VAE_TINY), device="cpu")
    load_state_dict_cast(tw.module, from_jax_params(np_tree(params)), strict=True)
    z = np.random.default_rng(4).standard_normal((6, 4, 3, 4, 5)).astype(np.float32)
    return jw, tw, z


@pytest.fixture(scope="module")
def groups(base, vae, tmp_path_factory):
    """A group of 4 ranks (the collectives, a (dp=2, sp=2) mesh, the tiny model at
    both sizes with ``enable_sequence_parallelism``, sp_vae) and one of 2 (the
    collectives, the tiny SDE-BrushNet), run at once."""
    _, tcfg, _, _, tmodel, batches = base
    cfg = port_cfg(dataclasses.replace(tcfg, enable_sequence_parallelism=True))
    sp4 = {f"comm_{fn}": dict(kind="comm", fn=fn, **c) for fn, c in COMM.items()}
    sp4["mesh"] = dict(kind="mesh")
    for k, bt in batches.items():
        sp4[k] = dict(kind="stdit3", cfg=cfg, state=tmodel.state_dict(), batch=tree(bt, t))
    # without the sp pad S=15 does not split over 4 ranks
    sp4["s15_unsplit"] = dict(sp4["s15"], cfg=port_cfg(tcfg))
    _, tw, z = vae
    sp4["sp_vae"] = dict(kind="sp_vae", cfg=VAE_TINY, state=tw.module.state_dict(),
                         z=torch.from_numpy(z))
    sp2 = {f"comm_{fn}": dict(kind="comm", fn=fn, **c) for fn, c in COMM.items()}
    _, tb, params, batch, noise = sde_brushnet(base)
    bmodel = load_into(TB.MagicDriveSTDiT3BrushNet(tb), params, control_depth=tb.control_depth)
    sp2["brushnet"] = dict(
        kind="brushnet", cfg=port_cfg(dataclasses.replace(tb, enable_sequence_parallelism=True)),
        state=bmodel.state_dict(), batch=dict(tree(batch, t), inpaint_input_noise=t(noise)))
    return run_groups({4: sp4, 2: sp2}, str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def sp4(groups):
    return groups[4]


@pytest.fixture(scope="module")
def sp2(groups):
    return groups[2]


_SDE = {}


def sde_brushnet(base):
    """(JAX config, port config, params, batch, the SDE noise's normal draw) of the
    tiny SDE-BrushNet at 9 frames of 32x40 (tokens 2x3: S=6 splits over 2 ranks)."""
    if not _SDE:
        jcfg, tcfg, *_ = base
        jb = JB.BrushNetConfig(**{**dataclasses.asdict(jcfg), "sde_inpaint": True})
        tb = TB.BrushNetConfig.from_base(tcfg, sde_inpaint=True)
        batch = synthetic_batch(tcfg, NF, 32, 40, l_txt=8, map_size=(8, 40, 40))
        batch["height"], batch["width"] = float(batch["height"]), float(batch["width"])
        rng = np.random.default_rng(0)
        batch["x_inpaint"] = rng.standard_normal((1, 3 * tcfg.nc, NF, 32, 40)).astype(np.float32)
        batch["mask_inpaint"] = rng.integers(0, 2, (1, tcfg.nc, NF, 32, 40)).astype(np.float32)
        batch["t_inpaint"] = np.full((1,), 300.0, np.float32)
        key = jax.random.PRNGKey(5)
        params = random_params(JB.MagicDriveSTDiT3BrushNet(jb), **tree(batch, j), rngs_key=key)
        noise = np.asarray(jax.random.normal(key, (tcfg.nc * tcfg.in_channels * 3, 4, 5)))
        _SDE.update(jb=jb, tb=tb, params=params, batch=batch, noise=noise, key=key)
    s = _SDE
    return s["jb"], s["tb"], s["params"], s["batch"], s["noise"]


def same_on_every_rank(results, name):
    out = results[0][name]
    for r in results[1:]:
        assert torch.equal(r[name], out), "the ranks disagree"
    return out


@pytest.mark.parametrize("fn", list(COMM))
@pytest.mark.parametrize("sp", [2, 4])
def test_comm_function(sp2, sp4, sp, fn):
    """Forward (what the Function computes), round trip (with its inverse), and
    backward (against autograd through the gather-and-slice it stands for), on
    every rank, exactly."""
    for rank, res in enumerate({2: sp2, 4: sp4}[sp]):
        errs = res[f"comm_{fn}"]
        assert set(errs) == {"forward", "round_trip", "backward"}
        assert all(e == 0.0 for e in errs.values()), (rank, errs)


def test_mesh_layout(sp4):
    """make_mesh(dp=2, sp=2) on 4 ranks: rank d*sp + s in dp row d, sp column s;
    an all-reduce of the ranks over each group sums its row / column."""
    for rank, res in enumerate(sp4):
        m = res["mesh"]
        d, s = divmod(rank, 2)
        assert (m["dp_rank"], m["sp_rank"], m["rank"], m["size"]) == (d, s, rank, 4)
        assert m["sp_sum"] == 2 * d * 2 + 1  # ranks 2d, 2d+1
        assert m["dp_sum"] == s + (2 + s)  # ranks s, 2+s


def test_sharded_forward_without_pad(base, sp4):
    """S=20 over 4 ranks (5 tokens each, no pad): the same as the port unsharded
    and as the JAX model."""
    jcfg, tcfg, jmodel, params, tmodel, batches = base
    out = same_on_every_rank(sp4, "s20")
    with torch.no_grad():
        ref = tmodel(**tree(batches["s20"], t))
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) < 1e-5
    assert_close(out, jax_forward(jmodel, params, batches["s20"]), TOL)


def test_sharded_forward_with_sp_pad(base, sp4):
    """S=15 over 4 ranks: the sp size pads H 3 -> 4. The sharded output equals JAX's
    with force_pad_h_for_sp_size=4 and JAX's on a (1, 4) mesh with
    enable_sequence_parallelism, and differs from the unpadded model's (the
    grid effect)."""
    jcfg, tcfg, jmodel, params, tmodel, batches = base
    out = same_on_every_rank(sp4, "s15")
    ref_pad = jax_forward(JModel(dataclasses.replace(jcfg, force_pad_h_for_sp_size=4)),
                          params, batches["s15"])
    assert_close(out, ref_pad, TOL)
    model_sp = JModel(dataclasses.replace(jcfg, enable_sequence_parallelism=True))
    with j_use_mesh(j_make_mesh(dp=1, sp=4, devices=jax.devices()[:4])):
        ref_mesh = jax_forward(model_sp, params, batches["s15"])
    assert_close(out, ref_mesh, TOL)
    with torch.no_grad():
        unpadded = tmodel(**tree(batches["s15"], t))
    assert float((out - unpadded).abs().max()) > 1e-3


def test_sequence_that_does_not_split_runs_whole_on_every_rank(base, sp4):
    """Without enable_sequence_parallelism S=15 does not divide over 4 ranks: as
    JAX's shard_hint leaves such an axis unsharded, every rank computes the whole
    (unpadded) forward, and says so."""
    *_, tmodel, batches = base
    out = same_on_every_rank(sp4, "s15_unsplit")
    with torch.no_grad():
        ref = tmodel(**tree(batches["s15"], t))
    assert float((out - ref).abs().max()) < 1e-5
    for res in sp4:
        assert "S=15 tokens do not split over sp=4 ranks" in res["log"]


def test_sde_brushnet_sharded_forward(base, sp2):
    """The tiny SDE-BrushNet (the inpaint stream split with x and c) at sp=2
    against the JAX model, the SDE noise JAX's draw from its key."""
    jb, tb, params, batch, _ = sde_brushnet(base)
    out = same_on_every_rank(sp2, "brushnet")
    ref = jax_forward(JB.MagicDriveSTDiT3BrushNet(jb), params, batch, rngs_key=_SDE["key"])
    assert_close(out, ref, TOL)


def test_sp_vae_decode(vae, sp4):
    """6 views over 4 ranks (padded to 8 with cycled views): the direct decode's
    video, and JAX sp_vae's on a (1, 4) mesh."""
    jw, tw, z = vae
    out = same_on_every_rank(sp4, "sp_vae")
    with torch.no_grad():
        direct = tw.decode(torch.from_numpy(z))
    assert out.shape == direct.shape == (6, 3, 9, 32, 40)
    # another batch size and thread count: the port's VAE tests' fp32 tolerance
    assert float((out - direct).abs().max()) < 2e-5
    ref = j_sp_vae(j(z), jw.decode, j_make_mesh(dp=1, sp=4, devices=jax.devices()[:4]))
    assert_close(out, ref, TOL)


def test_rank_group_lets_its_caller_work_while_the_ranks_run(tmp_path):
    """``RankGroup`` returns as soon as its ranks are started: here they wait for a
    file the caller writes afterwards. ``wait`` returns each rank's output (RANK
    and WORLD_SIZE set as a launcher sets them); a rank that fails makes ``wait``
    raise; ``close`` kills ranks that still run."""
    from magicdrive_v2_tpu_torch.parallel.distributed import RankGroup
    go = tmp_path / "go"
    wait_for_go = ("import os, time\n"
                   f"while not os.path.exists({str(go)!r}):\n    time.sleep(0.01)\n"
                   "print(os.environ['RANK'], os.environ['WORLD_SIZE'])")
    group = RankGroup(2, ["-c", wait_for_go], 60)
    try:
        assert all(p.poll() is None for p in group.procs)
        go.write_text("")
        assert [out.split() for out in group.wait()] == [["0", "2"], ["1", "2"]]
    finally:
        group.close()
    failing = RankGroup(2, ["-c", "import os, sys; sys.exit(3 * int(os.environ['RANK']))"], 60)
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with 3"):
        failing.wait()
    sleeping = RankGroup(1, ["-c", "import time; time.sleep(60)"], 60)
    sleeping.close()
    assert sleeping.procs[0].returncode not in (None, 0)
