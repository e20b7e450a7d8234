"""PyTorch port, the measurement tools against the JAX package's, on the CPU at
small sizes: ``kernel_bench`` (its plain K1 against JAX ``_xla_reference``),
``perf_lab`` (the chained CFG denoise step against JAX ``build_step``'s
``run_chain``; ``report`` on a trace written here; ``flagship_config`` against
the tests' tiny flagship) and ``plan_memory`` (a (2, 2) gloo mesh of four
processes: each rank's parameter bytes against what JAX ``shard_params`` places on
each device).

Tolerances: K1 in fp32 2e-5 absolute and 1e-4 relative (tests/test_torch_ops.py: two
evaluation orders of the same fp32 arithmetic); the chained step 1e-4
absolute as tests/test_torch_stdit3.py (fp32 through ~10 blocks of GEMMs summed in
another order, twice); bytes exact.
"""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_common import j, load_into, tiny_configs

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.ops.flash_fused import _xla_reference
from magicdrive_v2_tpu_torch.tools import kernel_bench, perf_lab, plan_memory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K1_ATOL, K1_RTOL, STEP_ATOL = 2e-5, 1e-4, 1e-4
SMALL = dict(G=6, N=40, H=2, D=8)


@pytest.mark.parametrize("J", [1, 2])
@pytest.mark.parametrize("norm", [True, False])
def test_kernel_bench_plain_equals_jax_xla_reference(J, norm):
    qkv, qw, kw = kernel_bench.k1_inputs(**SMALL, dtype=torch.float32, device="cpu")
    if not norm:
        qw = kw = None
    perm = kernel_bench.kv_perm(SMALL["G"], J)
    with torch.no_grad():
        mine = kernel_bench.route_fn("plain", qkv, qw, kw, perm)()
    ref = _xla_reference(j(qkv.numpy()), None if qw is None else j(qw.numpy()),
                         None if kw is None else j(kw.numpy()), perm, SMALL["D"] ** -0.5)
    assert mine.shape == (6, 40, 2, 8)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=K1_ATOL, rtol=K1_RTOL)
    if not norm:  # the library line computes the same function without the norm
        sdpa = kernel_bench.route_fn("sdpa", qkv, None, None, perm)()
        np.testing.assert_allclose(sdpa.transpose(1, 2).numpy(), np.asarray(ref),
                                   atol=K1_ATOL, rtol=K1_RTOL)


def test_kernel_bench_cli_on_the_cpu_runs_the_plain_route_only(capsys):
    rows = kernel_bench.main(["--device", "cpu", "--loop", "2", *sum(
        ([f"--{k}", str(v)] for k, v in SMALL.items()), [])])
    assert [(r["route"], r["J"]) for r in rows] == [("plain", 1), ("plain", 2)]
    assert all(r["clock"] == "host (cpu)" and r["kernel_launches"] == 0 for r in rows)
    assert len(capsys.readouterr().out.strip().splitlines()) == 2
    with pytest.raises(ValueError, match="card only"):
        kernel_bench.bench("cpu", **SMALL, routes=("kernel",))
    qkv, qw, kw = kernel_bench.k1_inputs(**SMALL, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="card only"):
        kernel_bench.route_fn("kernel", qkv, qw, kw, None)


def test_flagship_config_is_the_tiny_flagship_and_xl2():
    """``perf_lab.flagship_config(tiny=True)`` is the tests' tiny flagship (equal to
    the JAX package's: tests/test_torch_common.py); without ``tiny`` it is XL/2."""
    _, tcfg = tiny_configs()
    assert perf_lab.flagship_config(torch.float32, tiny=True) == tcfg
    full = perf_lab.flagship_config(torch.bfloat16)
    assert (full.hidden_size, full.num_heads, full.depth, full.control_depth) == (1152, 16, 28,
                                                                                 13)


def test_perf_lab_chained_step_equals_jax_run_chain(monkeypatch):
    """The JAX tool's step on the CPU (tiny flagship, fp32, 9 x 64x80, batched CFG,
    2 chained steps) and the port's on the same weights (``from_jax_params``) and
    the same synthetic batch."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("jax_perf_lab",
                                                  os.path.join(REPO, "tools", "perf_lab.py"))
    jperf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jperf)
    # the JAX tool points the compile cache at the TPU's directory: keep the tests'
    monkeypatch.setattr(jperf, "_enable_compile_cache", lambda: None)
    run_chain, args, chained = jperf.build_step(chained=2)
    assert chained == 2
    ref = np.asarray(run_chain(*args))
    step = perf_lab.build_step(2, device="cpu")
    assert step.shape == perf_lab.TINY_SHAPE and step.chained == 2
    load_into(step.model, args[0], control_depth=step.model.cfg.control_depth)
    np.testing.assert_array_equal(step.z.numpy(), np.asarray(args[3]))
    out = step.encode()()
    assert out.shape == ref.shape and np.abs(ref - np.asarray(args[3])).max() > 1e-3
    np.testing.assert_allclose(out.numpy(), ref, atol=STEP_ATOL)
    timed = perf_lab.time_step(step, calls=1)
    assert timed["device"] == "cpu" and len(timed["step_s"]) == 1


def test_perf_lab_train_step_is_the_trainers_step_before_its_update():
    """``perf_lab.build_train_step`` (what ``plan_memory`` measures) runs the
    trainer's own grads: on the tiny flagship in fp32 at 9 x 64x80 its loss and
    grad norm equal, bit for bit, the metrics of ``make_train_step``'s step on the
    same model and batch, and it leaves the parameters as they were (no update)."""
    from magicdrive_v2_tpu_torch.schedulers.rf import RFLOW
    from magicdrive_v2_tpu_torch.training.trainer import TrainState, make_train_step
    from magicdrive_v2_tpu_torch.utils.train_utils import make_optimizer
    nf, h, w = perf_lab.TINY_SHAPE
    step, model, sharding, batch = perf_lab.build_train_step(nf, h, w, device="cpu",
                                                             tiny=True)
    assert sharding is None
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, norm = step()
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        model.named_parameters(), lr=1e-4), ema=None)
    train_step = make_train_step(
        RFLOW(num_timesteps=1000, use_timestep_transform=True, cog_style_trans=True),
        height=h, width=w, num_frames=nf, dtype=torch.float32)
    _, metrics = train_step(state, batch)
    assert torch.isfinite(loss) and float(norm) > 0
    assert torch.equal(loss, metrics["loss"]) and torch.equal(norm, metrics["grad_norm"])


def test_perf_lab_report_on_a_cpu_trace(tmp_path, capsys):
    """``profile``'s trace and ``report``: written here, the CPU operators summed by
    normalised name (``--cpu``); without ``--cpu`` a trace without device events
    raises."""
    a = torch.randn(64, 64)
    path = perf_lab.trace(lambda: torch.relu(a @ a).sum(), str(tmp_path), "profile")
    assert os.path.isfile(path)
    rep = perf_lab.main(["report", str(tmp_path), "--cpu", "--top", "5"])
    names = [r["name"] for r in rep["top"]]
    assert "aten::mm" in names and rep["category"] == "cpu_op"
    assert abs(sum(r["share"] for r in rep["top"]) - sum(
        r["ms"] for r in rep["top"]) / rep["total_ms"]) < 1e-9
    assert "total cpu_op time" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no 'kernel' event"):
        perf_lab.main(["report", str(tmp_path)])
    assert perf_lab.normalise("void k1_attention<128, 72, (bool)1>(float*, int) 0x7f3a") \
        == "void k1_attention(float*, int)"


def _jax_bytes_by_device(cfg, port_params):
    """Bytes JAX ``shard_params`` places on each device of a (2, 2) mesh, of the
    leaves the port keeps as parameters and of the rest (the port's buffers), and
    the whole bytes of the latter."""
    from __graft_entry__ import _fast_init, _flagship_config
    from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
    from magicdrive_v2_tpu.parallel.fsdp import shard_params
    from magicdrive_v2_tpu.parallel.sharding import make_mesh
    from magicdrive_v2_tpu.pipelines.magicdrive import synthetic_batch
    from magicdrive_v2_tpu_torch.utils.ckpt import _iter_tree, _torch_key
    jcfg = _flagship_config(tiny=True, dtype=jnp.float32)
    batch = synthetic_batch(jcfg, 9, 64, 80, l_txt=60, map_size=(8, 80, 80))
    params = _fast_init(JModel(jcfg), batch)
    mesh = make_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    sharded, _ = shard_params(params, mesh)
    on = {"param": {}, "buffer": {}}
    buffer_whole = 0
    for path, leaf in _iter_tree(dict(sharded)):
        key, base = _torch_key(path, cfg.control_depth)
        name = key if base is None else key.format(i=base)
        kind = "param" if name in port_params else "buffer"
        buffer_whole += leaf.nbytes if kind == "buffer" else 0
        for shard in leaf.addressable_shards:
            on[kind][shard.device] = on[kind].get(shard.device, 0) + shard.data.nbytes
    return mesh, on, buffer_whole


def test_plan_memory_measures_the_stage1_model_with_no_temporal():
    """``--no-temporal`` plans the stage-1 image model's step (no temporal blocks): one
    rank holds that model's parameters, the temporal blocks' fewer, and the step
    runs at 1 frame."""
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
    res = plan_memory.main(["--tiny", "--dp", "1", "--sp", "1", "--height", "64",
                            "--width", "80", "--frames", "1", "--no-temporal", "--device",
                            "cpu", "--deadline", "600"])
    assert res["shape"].endswith("tiny no-temporal"), res["shape"]
    (rank,) = res["ranks"]
    assert rank["finite"]
    sizes = {}
    for name, flags in (("stage1", dict(with_temp_block=False, control_skip_temporal=True)),
                        ("temporal", {})):
        with torch.device("meta"):
            model = MagicDriveSTDiT3(tiny_configs(**flags)[1])
        sizes[name] = sum(p.numel() * 4 for p in model.parameters())
    assert rank["param_bytes"] == sizes["stage1"] < sizes["temporal"]


def test_plan_memory_tiny_on_a_2x2_cpu_mesh_holds_what_jax_shards():
    """Four gloo ranks, (dp, sp) = (2, 2): each rank's parameter bytes equal the
    bytes JAX ``shard_params`` places on its device of the leaves the port keeps as
    parameters; the port's buffers (not split over dp, ROADMAP queue C) are whole on
    every rank: the JAX leaves' whole bytes. The step ran: finite loss and grad
    norm, the same on every rank; no peak on the CPU."""
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3
    res = plan_memory.main(["--tiny", "--dp", "2", "--sp", "2", "--height", "64",
                            "--width", "80", "--frames", "9", "--device", "cpu",
                            "--deadline", "600"])
    assert res["shape"].startswith("2x6view 64x80x9f") and "dp=2 sp=2" in res["shape"]
    assert res["remat"] == "full" and res["backend"] == "cpu/gloo"
    assert res["per_device_peak_gb"] is None and res["per_device_temp_gb"] is None
    ranks = res["ranks"]
    assert [(r["dp_row"], r["sp_rank"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["finite"] for r in ranks) and len({r["loss"] for r in ranks}) == 1
    assert len({r["grad_norm"] for r in ranks}) == 1
    _, tcfg = tiny_configs()
    with torch.device("meta"):
        model = MagicDriveSTDiT3(tcfg)
    mesh, on, buffer_whole = _jax_bytes_by_device(tcfg, dict(model.named_parameters()))
    whole = sum(p.numel() * 4 for p in model.parameters())
    for r in ranks:
        dev = mesh.devices[r["dp_row"], r["sp_rank"]]
        assert r["param_bytes"] == on["param"][dev], (r, on["param"][dev])
        assert r["buffer_bytes"] == buffer_whole
        assert r["split_params"] > 0 and r["param_bytes"] < whole
    assert res["per_device_param_gb"] * 2 ** 30 == max(r["param_bytes"] + r["buffer_bytes"]
                                                      for r in ranks)
    print(json.dumps({k: v for k, v in res.items() if k != "ranks"}))
