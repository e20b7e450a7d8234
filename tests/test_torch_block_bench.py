"""PyTorch port, the block bench (``magicdrive_v2_tpu_torch.tools.block_bench``)
on the CPU at a tiny shape: its chain of blocks against the JAX bench's
(``tools/block_bench.py``: a ``fori_loop`` of ``MVSTDiTBlock.apply``) with the
same weights and inputs, its routing of the three kernel sites, and its rows.

Tolerance: the JAX block test's (tests/test_torch_stdit3.py), 5e-5 absolute a
block, so 1e-4 over a chain of three fp32 blocks of width 32.
"""
import numpy as np
import pytest
import torch

from test_torch_common import assert_close, j, load_into, random_params, t

import jax
import jax.numpy as jnp
from magicdrive_v2_tpu.models.magicdrive.stdit3 import MVSTDiTBlock as JBlock
from magicdrive_v2_tpu_torch import ops
from magicdrive_v2_tpu_torch.models.layers import blocks
from magicdrive_v2_tpu_torch.models.magicdrive import stdit3
from magicdrive_v2_tpu_torch.tools import block_bench as bb

SMALL = dict(B=6, T=2, S=10, C=32, heads=4, L=5)
NBRS = ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0))


def sites():
    return (blocks.fused_qkv_attention, stdit3.adaln_modulate, blocks.dot_product_attention)


@pytest.mark.parametrize("route", ["kernels", "plain", "given"])
def test_routed_sets_the_three_sites_and_restores_them_after_an_exception(route):
    before = sites()
    assert before == (ops.fused_qkv_attention, ops.adaln_modulate, ops.dot_product_attention)
    given = (lambda *a, **k: "k1", lambda *a, **k: "k2", lambda *a, **k: "k3")
    with pytest.raises(RuntimeError, match="inside"):
        with bb.routed(given if route == "given" else route) as saved:
            assert tuple(saved) == before
            inside = sites()
            raise RuntimeError("inside")
    assert sites() == before
    if route == "given":
        assert inside == given
    elif route == "kernels":
        assert inside == before
    else:
        assert inside[0].func is ops.fused_qkv_attention_plain
        assert inside[0].keywords == {"group_chunk": 6}
        assert inside[1:] == (ops.adaln_modulate_plain, ops.plain_attention)
    with pytest.raises(ValueError):
        with bb.routed("fused"):
            pass
    assert sites() == before


@pytest.mark.parametrize("temporal", [False, True], ids=["spatial", "temporal"])
def test_chain_matches_the_jax_bench_chain(temporal):
    """Three applications of one block (qk_norm, the default neighbours, fp32)
    equal three of the JAX block under its ``fori_loop``, and equal the port's
    block applied three times by hand, through either route."""
    rng = np.random.default_rng(3)
    s = SMALL
    x = rng.standard_normal((s["B"], s["T"], s["S"], s["C"])).astype(np.float32)
    y = rng.standard_normal((s["B"], 1, s["L"], s["C"])).astype(np.float32)
    tt = rng.standard_normal((s["B"] // 6, 6 * s["C"])).astype(np.float32)
    jm = JBlock(hidden_size=s["C"], num_heads=s["heads"], qk_norm=True, temporal=temporal,
                neighbors=NBRS, dtype=jnp.float32)
    p = random_params(jm, j(x), j(y), j(tt), None, None)
    ref = jax.jit(lambda p, x: jax.lax.fori_loop(
        0, 3, lambda i, a: jm.apply(p, a, j(y), j(tt), None, None), x))(p, j(x))
    tm = load_into(stdit3.MVSTDiTBlock(s["C"], s["heads"], qk_norm=True, temporal=temporal,
                                       neighbors=NBRS), p)
    with torch.no_grad():
        by_hand = t(x)
        for _ in range(3):
            by_hand = tm(by_hand, t(y), t(tt), None, None)
        for route in bb.ROUTES:
            with bb.routed(route):
                out = bb.chain(tm, t(x), t(y), t(tt), 3)
            assert_close(out, ref, 1e-4)
            np.testing.assert_array_equal(out.numpy(), by_hand.numpy())


def test_bench_rows_at_a_small_shape_on_the_cpu():
    """Both block kinds, both routes: a row each with the host clock (no device
    time on the CPU), no launch (the wrappers run their plain versions on CPU
    tensors); each kind's first block through the kernels' wrappers within the
    limit of the plain route."""
    rows = bb.bench("both", **SMALL, n=2, reps=1, dtype=torch.bfloat16, device="cpu")
    assert [(r["block"], r["route"]) for r in rows] == [
        ("spatial", "kernels"), ("spatial", "plain"), ("temporal", "kernels"),
        ("temporal", "plain")]
    for r in rows:
        assert r["clock"] == "host (cpu)" and r["device"] == "cpu"
        assert r["ms_per_block"] > 0 and len(r["ms_per_block_each_chain"]) == 1
        assert r["launches_per_block"] == {"fused_qkv_attention": 0, "adaln_modulate": 0,
                                           "flash_attention": 0}
    checks = bb.check_first_blocks(**SMALL, device="cpu")
    assert set(checks) == {"spatial", "temporal"}
    for check in checks.values():
        assert check["ok"] and check["finite"] and check["rms_increment"] > 1e-3
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bb.bench("spatial", **SMALL, device="cuda")
    assert bb.BENCH_SHAPE == dict(B=12, T=5, S=1350, C=1152, heads=16, L=72)
