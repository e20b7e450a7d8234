"""PyTorch port, what the kernels' backward formulations are handed, on the CPU.

On the card each kernel's ``KernelFunction`` runs a backward kernel from what the
forward kernel saved; these tests check that the saved log-sum-exp is the rows'
logsumexp, that K1's lists of the (source, group) pairs that read each group are
complete and ordered, and that each Function saves only what its backward
reads. The plain backward formulations (``*_backward_plain``) are held against
autograd through the plain forward and against ``jax.vjp`` of the JAX functions
in tests/test_torch_ops.py.
"""
import importlib

import numpy as np
import pytest
import torch

from magicdrive_v2_tpu_torch.ops.kernel_vjp import KernelFunction

k1, k2, k3 = (importlib.import_module(f"magicdrive_v2_tpu_torch.ops.{m}")
              for m in ("flash_fused", "fused_adaln", "flash_attention"))

CROSS_VIEW = np.array([[5, 0, 1, 2, 3, 4], [1, 2, 3, 4, 5, 0]])  # the camera neighbours
SHARED = np.array([[1, 2, 3, 4, 5, 0], [2, 2, 2, 0, 5, 5]])  # non-bijective: 1, 3, 4 unread


@pytest.mark.parametrize("perm", [None, CROSS_VIEW[:1], CROSS_VIEW],
                         ids=["J1", "one_source", "cross_view"])
def test_k1_saved_lse_is_the_logsumexp(perm):
    """With one source (k/v of group perm[g] or g) the forward saves logsumexp over
    the keys of the scaled fp32 logits of the normalised q and k; with several it
    saves nothing (the backward takes each source's), and every source's
    ``lse`` as the plain version writes it is that source's logsumexp."""
    G, N, H, D = 6, 10, 2, 8
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(G, N, 3, H, D, generator=gen)
    w = torch.randn(2, D, generator=gen) * 0.1 + 1
    p = np.arange(G)[None] if perm is None else perm
    out, saved = k1.forward_plain(qkv, w[0], w[1], perm, D ** -0.5)
    assert len(saved) == (2 if p.shape[0] == 1 else 0)
    lse = torch.empty(p.shape[0], G, H, N)
    k1.fused_qkv_attention_plain(qkv, w[0], w[1], perm, D ** -0.5, lse=lse)
    if saved:
        assert saved[0] is out
        torch.testing.assert_close(saved[1], lse, rtol=0, atol=0)
    q, k = k1._rms(qkv[:, :, 0], w[0]), k1._rms(qkv[:, :, 1], w[1])
    for j in range(p.shape[0]):
        logits = torch.einsum("gnhd,gmhd->ghnm", q, k[torch.as_tensor(p[j])]) * D ** -0.5
        torch.testing.assert_close(lse[j], torch.logsumexp(logits, dim=-1), rtol=1e-6,
                                   atol=1e-6)


def test_k3_saved_lse_is_the_logsumexp():
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, n, 3, 16, generator=gen) for n in (9, 5, 5))
    out, (saved_out, lse) = k3.forward_plain(q, k, v, 0.3)
    assert saved_out is out
    torch.testing.assert_close(out, k3.flash_attention_plain(q, k, v, 0.3), rtol=0, atol=0)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * 0.3
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("perm", [CROSS_VIEW, SHARED, CROSS_VIEW[:1]],
                         ids=["cross_view", "shared", "one_source"])
def test_inverse_perm_lists_every_reader_in_order(perm):
    """The dK/dV kernel of group g' sums the pairs (j, g) with perm[j][g] = g', in
    increasing j * G + g: every pair once, groups nobody reads with none."""
    G = perm.shape[1]
    off, src = k1.inverse_perm(torch.as_tensor(perm, dtype=torch.int32), G)
    assert off.dtype == src.dtype == torch.int32 and off.shape == (G + 1,)
    assert src.shape == (perm.size,) and off[0] == 0 and off[-1] == perm.size
    for g2 in range(G):
        want = [j * G + g for j in range(perm.shape[0]) for g in range(G) if perm[j, g] == g2]
        assert src[off[g2]:off[g2 + 1]].tolist() == want


@pytest.mark.parametrize("kernel", ["k1_J1", "k1_J2", "k2", "k3"])
def test_functions_save_only_what_the_backward_reads(kernel):
    """Each Function keeps its tensor inputs and, beside them, only what its
    backward reads: K1 with one source and K3 their output (which the projection
    after them keeps anyway) and log-sum-exp; K1 with two sources and K2 nothing
    more (K2's output, under a frame mask's ``torch.where``, no other op keeps)."""
    gen = torch.Generator().manual_seed(5)
    if kernel.startswith("k1"):
        qkv = torch.randn(6, 9, 3, 2, 8, generator=gen).requires_grad_()
        ws = [torch.ones(8, requires_grad=True) for _ in range(2)]
        perm = None if kernel == "k1_J1" else CROSS_VIEW
        out = KernelFunction.apply(k1.forward_plain, k1.backward_plain, "k1", qkv, *ws, perm,
                                   8 ** -0.5)
        inputs, extra = [qkv, *ws], 2 if perm is None else 0
    elif kernel == "k2":
        inputs = [torch.randn(2, 5, 16, generator=gen).requires_grad_(),
                  *(torch.randn(2, 16, generator=gen).requires_grad_() for _ in range(2))]
        out = KernelFunction.apply(k2.forward_plain, k2.backward_plain, "k2", *inputs, 1e-6)
        extra = 0
    else:
        inputs = [torch.randn(2, n, 2, 8, generator=gen).requires_grad_() for n in (7, 5, 5)]
        out = KernelFunction.apply(k3.forward_plain, k3.backward_plain, "k3", *inputs, 0.3)
        extra = 2
    saved = out.grad_fn.saved_tensors
    assert len(saved) == len(inputs) + extra
    assert all(a is b for a, b in zip(saved, inputs))
    if extra:
        assert saved[len(inputs)].data_ptr() == out.data_ptr()


# ---------------------------------------------------------------- the bf16 backward's plan


def test_backward_plan_at_the_stage2_shapes():
    """K1 at the stage-2 step (qkv (120, 350, 3, 16, 72), with the norm) and K3 (q
    (120, 350, 16, 72) against M = 312): six 64-row q tiles a (group, head), three a
    block; the pre-pass's scratch holds q and k as 80-wide tiles."""
    plan = k1.plan_backward_bf16(120, 350, 350, 16, 72, norm=True)
    assert (plan.dp, plan.dv, plan.q_tiles, plan.k_tiles) == (80, 72, 6, 6)
    assert plan.dq_blocks == plan.dkdv_blocks == 120 * 16 * 2
    assert plan.scratch_shape == (2, 120, 16, 6, 10, 64, 8)
    # three q, dO and output tiles, a four-deep ring of k and v tiles (64 x 80 bf16)
    assert plan.dq_smem == 2 * (3 * 3 + 2 * 4) * 64 * 80
    # three k and v tiles, a four-deep ring of q and dO tiles with their lse and delta
    assert plan.dkdv_smem == 2 * (2 * 3 + 2 * 4) * 64 * 80 + 4 * 2 * 4 * 64
    k3_plan = k1.plan_backward_bf16(120, 350, 312, 16, 72)
    assert (k3_plan.k_tiles, k3_plan.dkdv_blocks, k3_plan.scratch_shape) == (5, 120 * 16 * 2,
                                                                            None)


@pytest.mark.parametrize("D", sorted(k1.BWD_WIDTH))
def test_backward_plan_fits_and_covers(D):
    """Every head dim the Hopper body takes: the padded width covers it in 16-deep
    k-steps, the products' width covers it in 8-column groups, the block's shared
    memory fits the card (``BWD_BLOCKS_PER_SM`` blocks an SM, each with the
    runtime's reserve), and the blocks' tiles cover the rows at the path's lengths: N = 350
    (stage 2), M = 312 and M = 1 (K3's keys), N = 5300 (848x1600)."""
    for N, M in ((350, 350), (350, 312), (350, 1), (5300, 5300), (1, 1)):
        plan = k1.plan_backward_bf16(2, N, M, 3, D, norm=N == M)
        assert plan.dp >= D and plan.dp % 16 == 0 and plan.dv >= D and plan.dv % 8 == 0
        assert plan.q_tiles * 64 >= N > (plan.q_tiles - 1) * 64
        assert plan.k_tiles * 64 >= M > (plan.k_tiles - 1) * 64
        assert plan.dq_blocks * k1.BWD_GROUPS >= 2 * 3 * plan.q_tiles
        assert plan.dkdv_blocks * k1.BWD_GROUPS >= 2 * 3 * plan.k_tiles
        assert max(plan.dq_smem, plan.dkdv_smem) <= k1.SMEM_LIMIT
        assert k1.BWD_BLOCKS_PER_SM * (plan.dkdv_smem + k1.BLOCK_RESERVED) <= k1.SM_SHARED
        assert plan.scratch_shape == ((2, 2, 3, plan.q_tiles, plan.dp // 8, 64, 8)
                                      if N == M else None)


@pytest.mark.parametrize("D,M", [(12, 350), (40, 350), (64, 350), (144, 1), (72, 312)])
def test_backward_plan_refuses_what_the_body_does_not_take(D, M):
    """Head dims outside ``BWD_WIDTH`` (K3's 144 keeps the mma.sync body), and the
    normalised tiles of a call whose keys are not its queries."""
    with pytest.raises(ValueError):
        k1.plan_backward_bf16(2, 350, M, 2, D, norm=D == 72)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("N", [350, 64, 1])
def test_backward_prepass_plain_is_the_forward_norm(dtype, N):
    """The pre-pass's plain counterpart holds exactly the q and k that
    ``fused_qkv_attention_plain`` normalises, in the tile layout (column chunk c of a
    tile's 64 rows, then chunk c + 1), zero past N and past D; attention on those
    rows without the norm is the plain version's with it. ``tile_qk`` takes it for
    a CPU tensor."""
    G, H, D = 2, 3, 72
    gen = torch.Generator().manual_seed(6)
    qkv = torch.randn(G, N, 3, H, D, generator=gen).to(dtype)
    qw, kw = (torch.randn(D, generator=gen) * 0.1 + 1 for _ in range(2))
    plan = k1.plan_backward_bf16(G, N, N, H, D, norm=True)
    tiles = k1.tile_qk_plain(qkv, qw, kw, plan)
    assert tiles.shape == plan.scratch_shape and tiles.dtype == dtype
    torch.testing.assert_close(k1.tile_qk(qkv, qw, kw, plan), tiles, rtol=0, atol=0)
    rows = k1.untile(tiles, N, D)
    torch.testing.assert_close(rows[0], k1._rms(qkv[:, :, 0], qw), rtol=0, atol=0)
    torch.testing.assert_close(rows[1], k1._rms(qkv[:, :, 1], kw), rtol=0, atol=0)
    g, h, n, d = G - 1, 1, N - 1, 43  # one element where the layout puts it
    assert tiles[1, g, h, n // 64, d // 8, n % 64, d % 8] == rows[1, g, n, h, d]
    mask = torch.ones_like(tiles, dtype=torch.bool)
    for c in range(D // 8):
        for t_ in range(plan.q_tiles):
            mask[:, :, :, t_, c, :max(0, min(64, N - 64 * t_))] = False
    assert not bool(tiles[mask].any())
    out = k1.fused_qkv_attention_plain(torch.stack([rows[0], rows[1], qkv[:, :, 2]], dim=2),
                                       None, None)
    torch.testing.assert_close(out, k1.fused_qkv_attention_plain(qkv, qw, kw), rtol=0, atol=0)
