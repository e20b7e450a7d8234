"""PyTorch port, the slice as a whole: ``MagicDrivePipeline.sample(decode=False)``
at the tiny flagship config against the JAX pipeline on the CPU, fp32.

The starting latent comes from the CPU torch generator both packages share
(``torch_seed``), the conditioning from the numpy-seeded ``synthetic_batch``, the
weights through ``from_jax_params``. Tolerance 3e-4 absolute on latents of order
1: two Euler steps of batched-CFG (guidance 2.0 doubles the model's fp32 error)
through a model that itself agrees to 1e-4.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_common import assert_close, j, load_into, random_params, tiny_configs

from magicdrive_v2_tpu.models.magicdrive.stdit3 import MagicDriveSTDiT3 as JModel
from magicdrive_v2_tpu.models.text_encoder.t5 import DummyTextEncoder as JDummy
from magicdrive_v2_tpu.models.vae.cogvideox import VideoAutoencoderKLCogVideoX
from magicdrive_v2_tpu.pipelines.magicdrive import MagicDrivePipeline as JPipeline
from magicdrive_v2_tpu.schedulers import rf as JR
from magicdrive_v2_tpu_torch.config.presets import rflow
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import MagicDriveSTDiT3 as TModel
from magicdrive_v2_tpu_torch.models.text_encoder.t5 import DummyTextEncoder
from magicdrive_v2_tpu_torch.models.vae.cogvideox import get_latent_size
from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
from magicdrive_v2_tpu_torch.utils.misc import torch_randn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF, HH, WW, L_TXT, STEPS = 9, 64, 80, 20, 2


def _jax_tree(v):
    if isinstance(v, dict):
        return {k: _jax_tree(x) for k, x in v.items()}
    return j(v) if isinstance(v, np.ndarray) else v


@pytest.fixture(scope="module")
def pipes():
    jcfg, tcfg = tiny_configs(model_max_length=L_TXT)
    batch = synthetic_batch(tcfg, NF, HH, WW, l_txt=L_TXT)
    jmodel = JModel(jcfg)
    params = random_params(jmodel, **_jax_tree(batch))
    sched_kw = rflow(num_sampling_steps=STEPS)
    jpipe = JPipeline(jmodel, params, VideoAutoencoderKLCogVideoX(),
                      JDummy(model_max_length=L_TXT), JR.build_scheduler(sched_kw))
    tmodel = load_into(TModel(tcfg), params, control_depth=tcfg.control_depth)
    tpipe = MagicDrivePipeline(tcfg, build_scheduler(sched_kw), model=tmodel, device="cpu")
    cond = {k: v for k, v in batch.items() if k not in ("x", "timestep", "height", "width")}
    return jpipe, tpipe, cond


def test_sample_latents_match_the_jax_pipeline(pipes):
    jpipe, tpipe, cond = pipes
    ref = jpipe.sample(_jax_tree(cond), num_frames=NF, height=HH, width=WW, torch_seed=1027,
                       decode=False)
    out = tpipe.sample(cond, num_frames=NF, height=HH, width=WW, torch_seed=1027,
                       decode=False)
    assert out.shape == (1, 96, 3, 8, 10) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert_close(out, ref, 3e-4)
    # the sampler moved the latent away from its starting noise
    z0 = torch_randn(out.shape, seed=1027)
    assert float((out - z0).abs().max()) > 1e-2


def test_slice_cfg_matches_batched_and_is_deterministic(pipes):
    _, tpipe, cond = pipes
    kw = dict(num_frames=NF, height=HH, width=WW, torch_seed=5, decode=False)
    a = tpipe.sample(cond, **kw)
    b = tpipe.sample(cond, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    tpipe.scheduler.slice_cfg = True
    try:
        c = tpipe.sample(cond, **kw)
    finally:
        tpipe.scheduler.slice_cfg = False
    np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5)
    # a different guidance scale and use_map0 both change the result
    assert float((a - tpipe.sample(cond, guidance_scale=4.0, **kw)).abs().max()) > 1e-4
    assert float((a - tpipe.sample(cond, use_map0=True, **kw)).abs().max()) > 1e-5


def test_frame_mask_pins_reference_frames(pipes):
    _, tpipe, cond = pipes
    z = torch_randn((1, 96, 3, 8, 10), seed=9)
    mask = np.array([[0.0, 1.0, 1.0]], np.float32)
    out = tpipe.sample(cond, num_frames=NF, height=HH, width=WW, z=z, mask=mask,
                       generator=torch.Generator().manual_seed(0), decode=False)
    np.testing.assert_array_equal(out[:, :, 0].numpy(), z[:, :, 0].numpy())
    assert float((out[:, :, 1:] - z[:, :, 1:]).abs().max()) > 1e-2


def test_captions_and_neg_prompts_go_through_the_text_encoder(pipes):
    jpipe, tpipe, cond = pipes
    je, te = JDummy(model_max_length=L_TXT), DummyTextEncoder(model_max_length=L_TXT, device="cpu")
    texts = ["A driving scene image at boston-seaport. Rain.", "night, <b>cars</b> www.x.y"]
    a, b = te.encode(texts), je.encode(texts)
    np.testing.assert_array_equal(a["y"].numpy(), np.asarray(b["y"]))
    np.testing.assert_array_equal(a["mask"].numpy(), np.asarray(b["mask"]))
    assert te.null(2).shape == (2, 1, L_TXT, 4096) and float(te.null(2).abs().max()) == 0.0
    cap = {k: v for k, v in cond.items() if k != "y"}
    cap["captions"] = texts[:1]
    kw = dict(num_frames=NF, height=HH, width=WW, torch_seed=5, decode=False)
    out = tpipe.sample(cap, **kw)
    out_neg = tpipe.sample(cap, neg_prompts=["Daytime. rain"], **kw)
    assert float((out - out_neg).abs().max()) > 1e-5
    np.testing.assert_array_equal(tpipe.null_y(1).numpy()[0, 0],
                                  tpipe.model.y_embedder.y_embedding.numpy())


def test_decode_is_not_silently_skipped_and_latent_size(pipes):
    _, tpipe, cond = pipes
    with pytest.raises(NotImplementedError, match="VAE"):
        tpipe.sample(cond, num_frames=NF, height=HH, width=WW, torch_seed=1)
    vae = VideoAutoencoderKLCogVideoX()
    for size in ([17, 424, 800], [9, 64, 80], [1, 224, 400], [16, 848, 1600], [33, 424, 800]):
        assert get_latent_size(size) == vae.get_latent_size(size), size
    assert get_latent_size([17, 424, 800]) == [5, 53, 100]
    assert get_latent_size([34, 64, 80], 17) == vae.get_latent_size([34, 64, 80], 17)
    assert get_latent_size([35, 64, 80], 17) == vae.get_latent_size([35, 64, 80], 17)


def test_device_defaults_to_cuda_and_raises_without_a_card():
    _, tcfg = tiny_configs()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MagicDrivePipeline(tcfg, build_scheduler(rflow(num_sampling_steps=1)))


_NO_JAX_SCRIPT = r"""
import sys
import torch
from magicdrive_v2_tpu_torch.config.presets import MV_ORDER_MAP, rflow, xl2_model
from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config
from magicdrive_v2_tpu_torch.pipelines.magicdrive import MagicDrivePipeline, synthetic_batch
from magicdrive_v2_tpu_torch.schedulers.rf import build_scheduler
from magicdrive_v2_tpu_torch.utils.ckpt import init_weights
import magicdrive_v2_tpu_torch.ops, magicdrive_v2_tpu_torch.models.text_encoder.t5

md = xl2_model(control_skip_temporal=False)
md["bbox_embedder_param"].update(class_token_dim=32, proj_dims=[32, 16, 16, 32], num_heads=4)
md["frame_emb_param"].update(num_heads=4)
md["map_embedder_param"].update(block_out_channels=[4, 8, 12, 16], conditioning_size=[8, 40, 40])
cfg = build_model_config(md, vae_out_channels=4, mv_order_map=MV_ORDER_MAP,
                         dtype=torch.float32, hidden_size=32, num_heads=4, depth=2,
                         control_depth=1, caption_channels=16, model_max_length=8)
pipe = MagicDrivePipeline(cfg, build_scheduler(rflow(num_sampling_steps=2)), device="cpu")
init_weights(pipe.model, seed=0)
batch = synthetic_batch(cfg, 9, 32, 40, l_txt=8, caption_channels=16, map_size=(8, 40, 40))
out = pipe.sample(batch, num_frames=9, height=32, width=40, torch_seed=1, decode=False)
assert out.shape == (1, 24, 3, 4, 5) and bool(torch.isfinite(out).all())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "magicdrive_v2_tpu"))
assert not bad, bad
print("NO_JAX_OK", float(out.abs().mean()))
"""


def test_port_runs_without_importing_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def test_port_sources_name_no_jax_import():
    import re
    pat = re.compile(r"import (jax|flax|optax)|from (jax|flax|optax)|magicdrive_v2_tpu[^_]")
    roots = [os.path.join(REPO, "magicdrive_v2_tpu_torch"), os.path.join(REPO, "chip_smoke.py")]
    hits = []
    for root in roots:
        files = [root] if os.path.isfile(root) else [
            os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith((".py", ".cu", ".cuh"))]
        for path in files:
            with open(path) as fh:
                for n, line in enumerate(fh, 1):
                    if pat.search(line):
                        hits.append(f"{path}:{n}: {line.strip()}")
    assert os.path.isfile(roots[1]), "chip_smoke.py is missing"
    assert not hits, hits
