"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy-seeded inputs go through a JAX module and its counterpart in
``magicdrive_v2_tpu_torch``; weights travel through ``from_jax_params`` and
``load_state_dict(strict=True)``. Every flax leaf is filled with random values
(not flax's init, which zero-initialises several projections and would make a
comparison vacuous). JAX runs on the CPU with matmul precision "highest"
(tests/conftest.py); the port runs in fp32 on ``device="cpu"``.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from magicdrive_v2_tpu_torch.utils.ckpt import from_jax_params, load_state_dict_cast

# Two intra-op threads for the port's CPU ops in every process that imports these
# helpers (each test worker does): the tier-1 run puts 6 workers on 8 cores, and a
# torch thread per core in each oversubscribes them, its idle OpenMP threads
# spinning on cores the other workers' JAX compiles need. ALL_THREADS: the count
# before, for a module whose checks were written against it (``all_threads``).
ALL_THREADS = torch.get_num_threads()
torch.set_num_threads(min(ALL_THREADS, 2))


def all_threads():
    """A module-scoped autouse fixture body: torch's own thread count for the
    module's tests, the cap again after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(ALL_THREADS)
    yield
    torch.set_num_threads(n)


def fill_tree(shapes, seed=0, std=0.05):
    """Random values for every leaf of a tree of ShapeDtypeStructs: normal(std),
    RMSNorm weights centred on 1."""
    paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for i, (path, s) in enumerate(paths_leaves):
        rng = np.random.default_rng([seed, i])
        v = rng.standard_normal(s.shape).astype(np.float32) * std
        names = [getattr(p, "key", "") for p in path]
        if len(names) >= 2 and names[-1] == "weight" and names[-2].endswith("_norm"):
            v = v + 1.0
        out.append(jnp.asarray(v, dtype=s.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def random_params(module, *args, seed=0, method=None, **kwargs):
    """Parameter tree of a flax module, every leaf random, without running init."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method, **kwargs))
    return fill_tree(shapes, seed)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load_into(torch_module, params, control_depth=13):
    """from_jax_params + load_state_dict(strict=True)."""
    state = from_jax_params(np_tree(params), control_depth)
    load_state_dict_cast(torch_module, state, strict=True)
    return torch_module.eval()


def t(x):
    """numpy -> torch."""
    return torch.from_numpy(np.array(x))


def j(x):
    """numpy -> jax."""
    return jnp.asarray(x)


def assert_close(torch_out, jax_out, atol, rtol=0.0, min_scale=1e-3):
    a = torch_out.detach().cpu().numpy() if isinstance(torch_out, torch.Tensor) else torch_out
    b = np.asarray(jax_out)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(b).max() > min_scale, "reference output is ~0: comparison would be vacuous"
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


def tiny_configs(**replace):
    """(JAX config, port config) of the tiny flagship: hidden 64, 4 heads, depth
    2 / control depth 1, fp32. ``replace`` overrides fields on both."""
    from __graft_entry__ import _flagship_config
    from magicdrive_v2_tpu_torch.config.presets import MV_ORDER_MAP, xl2_model
    from magicdrive_v2_tpu_torch.models.magicdrive.stdit3 import build_model_config

    jcfg = _flagship_config(tiny=True, dtype=jnp.float32)
    hidden, heads = 64, 4
    md = xl2_model(control_skip_temporal=False)
    md["bbox_embedder_param"].update(class_token_dim=hidden,
                                     proj_dims=[hidden, 32, 32, hidden], num_heads=heads)
    md["frame_emb_param"].update(num_heads=heads)
    md["map_embedder_param"].update(block_out_channels=[8, 16, 24, 32])
    tcfg = build_model_config(md, vae_out_channels=16, mv_order_map=MV_ORDER_MAP,
                              dtype=torch.float32, hidden_size=hidden, num_heads=heads,
                              depth=2, control_depth=1)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        tcfg = dataclasses.replace(tcfg, **replace)
    return jcfg, tcfg


def test_tiny_configs_agree():
    """Every architecture field of the port's config equals the JAX package's."""
    jcfg, tcfg = tiny_configs()
    # training-only and sharding fields are not part of the port's config
    skip = {"dtype", "grad_checkpoint", "remat_policy", "enable_sequence_parallelism"}
    for f in dataclasses.fields(jcfg):
        if f.name in skip:
            continue
        assert getattr(jcfg, f.name) == getattr(tcfg, f.name), f.name
    assert (jcfg.nc, jcfg.out_channels) == (tcfg.nc, tcfg.out_channels)


def spawn_ranks(n, argv, deadline_s, env=None, cwd=None):
    """The port's launcher (``parallel.distributed.spawn_ranks``) for the CPU
    tests: ranks of a gloo group started from the repo's root, one OpenMP thread
    each."""
    from magicdrive_v2_tpu_torch.parallel.distributed import spawn_ranks as spawn
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return spawn(n, argv, deadline_s, env=dict(OMP_NUM_THREADS="1", **(env or {})),
                 cwd=cwd or repo)
