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
