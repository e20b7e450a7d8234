"""PyTorch port, K2's backward (``ops/fused_adaln.py``) on the CPU.

On the card the backward is one launch of ``adaln_bwd_ring``
(``csrc/adaln_modulate.cu``) on the grid of ``plan_adaln_backward``; here the
plan is held to cover every row once, and the plain version of the kernel's
blocked column sums (``adaln_modulate_backward_blocked_plain``) is held against
the unblocked plain version and against ``jax.vjp`` of the composition the JAX
trainer differentiates (``_xla_fallback``). fp32; the blocked sums add the same
terms in another order than ``Tensor.sum``, so they agree within rtol 1e-5 and
1e-5 of the largest sum (``SUM_TOL``); against JAX the tolerances of
``tests/test_torch_ops.py::test_adaln_function_backward`` (atol 1e-4, rtol 1e-5).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_common import j, t

import jax

from magicdrive_v2_tpu.ops.fused_adaln import _xla_fallback
from magicdrive_v2_tpu_torch.ops import fused_adaln as k2

SUM_TOL = 1e-5
SMS = 132  # an H100's


def kernel_rows(N, plan):
    """The rows of one batch each (block, warp) of the kernel takes under ``plan``,
    as ``adaln_bwd_ring`` computes them: block k from row k * rows_per_block, warp
    w its rows n0 + w, n0 + w + W, ... while inside the block."""
    rows, blocks = plan
    W = k2.BACKWARD_WARPS
    out = []
    for k in range(blocks):
        n0 = k * rows
        take = min(N - n0, rows)
        assert take >= 1, f"block {k} of the batch takes no row"
        for w in range(W):
            cnt = (take - w + W - 1) // W if take > w else 0
            out.append(n0 + w + W * np.arange(cnt))
    return out


@pytest.mark.parametrize("C", [64, 1152, 1280])
@pytest.mark.parametrize("N", [1, 5, 63, 64, 65, 350, 1750, 5300])
@pytest.mark.parametrize("B", [1, 6, 24, 192])
def test_plan_covers_every_row_once(B, N, C):
    """Every row of every batch is taken by exactly one warp of one block, and no
    block reaches past its batch's N rows (block i is batch i // blocks_per_batch:
    its rows are that batch's)."""
    rows, blocks = k2.plan_adaln_backward(B, N, C, SMS)
    assert rows >= 1 and blocks >= 1 and B * blocks <= 2 ** 31 - 1
    taken = np.zeros(N, np.int64)
    for r in kernel_rows(N, (rows, blocks)):
        assert r.size == 0 or (r.min() >= 0 and r.max() < N)
        np.add.at(taken, r, 1)
    assert (taken == 1).all()


def test_plan_fills_the_card_at_the_training_shapes():
    """One wave of three blocks an SM: stage 2's x (24, 1750, 1152) in 384 blocks of
    110 rows, stage 1's (192, 350, 1152) in 384 blocks of 175."""
    assert k2.plan_adaln_backward(24, 1750, 1152, SMS) == (110, 16)
    assert k2.plan_adaln_backward(192, 350, 1152, SMS) == (175, 2)


@pytest.mark.parametrize("bad", [(0, 5, 64), (2, 0, 64), (2, 5, 0), (2, 5, 1288)])
def test_plan_refuses_what_the_kernel_cannot_take(bad):
    with pytest.raises(ValueError):
        k2.plan_adaln_backward(*bad, SMS)


def _inputs(B, N, C, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, C)).astype(np.float32) * 3 + 0.5
    sh, sc = (rng.standard_normal((B, C)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    return x, sh, sc, g


# (B, N, C), plan: the card's, and splits that make several blocks and warps
BLOCKED_CASES = {
    "b2_n37_c64_card": ((2, 37, 64), None),
    "b2_n37_c64_3blocks": ((2, 37, 64), (16, 3)),
    "b2_n37_c64_1block": ((2, 37, 64), (37, 1)),
    "b3_n5_c1152_card": ((3, 5, 1152), None),
    "b3_n5_c1152_1block": ((3, 5, 1152), (5, 1)),
    "b2_n70_c1152_2blocks": ((2, 70, 1152), (35, 2)),
}


@pytest.mark.parametrize("case", sorted(BLOCKED_CASES))
def test_blocked_plain_matches_plain_and_jax(case):
    """dx is the plain version's; dshift and dscale, added in the kernel's order,
    equal the plain version's within ``SUM_TOL`` and ``jax.vjp`` of
    ``_xla_fallback``'s within its tolerances."""
    (B, N, C), plan = BLOCKED_CASES[case]
    plan = plan or k2.plan_adaln_backward(B, N, C, SMS)
    x, sh, sc, g = _inputs(B, N, C, seed=B * N + C)
    got = k2.adaln_modulate_backward_blocked_plain(t(x), t(sh), t(sc), t(g), plan)
    ref = k2.adaln_modulate_backward_plain(t(x), t(sh), t(sc), t(g))
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    for a, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, r, rtol=SUM_TOL,
                                   atol=SUM_TOL * float(r.abs().max()))
    _, vjp = jax.vjp(lambda a, b, c: _xla_fallback(a, b[:, None], c[:, None], 1e-6),
                     j(x), j(sh), j(sc))
    for a, r in zip(got, vjp(j(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=1e-5)


def test_blocked_plain_in_bf16_rounds_once():
    """bf16 inputs: the blocked sums and the plain ones, both fp32 then rounded once
    to bf16, are at most one bf16 ulp apart; dx is the plain version's."""
    x, sh, sc, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(4, 63, 1152, 3))
    plan = k2.plan_adaln_backward(4, 63, 1152, SMS)
    got = k2.adaln_modulate_backward_blocked_plain(x, sh, sc, g, plan)
    ref = k2.adaln_modulate_backward_plain(x, sh, sc, g)
    assert all(a.dtype == torch.bfloat16 for a in got)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    for a, r in zip(got[1:], ref[1:]):
        a, r = a.float(), r.float()
        assert bool(((a - r).abs() <= 2.0 ** -7 * r.abs() + 1e-6).all())


def test_wrapper_runs_the_plain_version_on_a_cpu_tensor(monkeypatch):
    """A CPU tensor under autograd: the forward and the grads are the plain
    version's, and no kernel (forward or backward) is counted."""
    monkeypatch.setattr(k2.adaln_modulate, "launches", 0)
    monkeypatch.setattr(k2.adaln_modulate, "backward_launches", 0)
    x, sh, sc, g = _inputs(2, 9, 64, 5)
    inputs = [t(a).requires_grad_() for a in (x, sh, sc)]
    out = k2.adaln_modulate(*inputs)
    torch.testing.assert_close(out, k2.adaln_modulate_plain(*inputs), rtol=0, atol=0)
    got = torch.autograd.grad(out, inputs, t(g))
    ref = k2.adaln_modulate_backward_plain(*inputs, t(g))
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
    assert (k2.adaln_modulate.launches, k2.adaln_modulate.backward_launches) == (0, 0)


@pytest.mark.parametrize("C,dtype,ok", [
    (1152, torch.bfloat16, True), (1280, torch.bfloat16, True), (64, torch.float32, True),
    (1284, torch.float32, False), (1288, torch.bfloat16, False),
    (1148, torch.bfloat16, False), (1150, torch.float32, False)])
def test_wrapper_refuses_widths_the_kernels_cannot_take(C, dtype, ok):
    """On the card rows longer than ``MAX_C`` or not whole 16-byte chunks raise;
    the wrapper's check, called directly (this build has no card)."""
    if ok:
        k2.check_width(C, dtype)
    else:
        with pytest.raises(ValueError, match="16-byte chunks"):
            k2.check_width(C, dtype)


def test_wrapper_raises_off_cpu_and_cuda():
    x = torch.empty(2, 3, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        k2.adaln_modulate(x, x[:, 0], x[:, 1])


@pytest.mark.parametrize("name,const", [("BACKWARD_WARPS", "kRingWarps"),
                                         ("BLOCKS_PER_SM", "kBlocksPerSm")])
def test_plan_assumes_the_kernels_block_shape(name, const):
    """The plan and the blocked plain version take the backward block's shape from
    Python constants; the kernel's source states the same (on the card the loaded
    library's report is checked too)."""
    src = (Path(k2.__file__).parents[1] / "csrc" / "adaln_modulate.cu").read_text()
    found = re.findall(rf"constexpr int {const} = (\d+);", src)
    assert found == [str(getattr(k2, name))]
