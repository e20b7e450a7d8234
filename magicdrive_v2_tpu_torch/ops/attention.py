"""Unified attention entry point, BNHD layout: (batch, seq, heads, head_dim).

Counterpart of the JAX package's ops/attention.py. ``plain_attention`` is the
fp32-softmax composition (``xla_attention`` there). ``dot_product_attention``
dispatches: a call with a bias goes to the plain version (the kernel takes no
bias: that is the contract, tested by ``bias is not None``); without a bias a
CUDA tensor goes to the flash-attention kernel and a CPU tensor to the plain
version.
"""
from __future__ import annotations

from typing import Optional

import torch


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D); logits and softmax in fp32,
    probabilities rounded to v's dtype for the value product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", weights, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention with BNHD layout. `bias` broadcasts to (B, H, N, M) if given."""
    assert q.ndim == 4 and k.ndim == 4 and v.ndim == 4, (q.shape, k.shape, v.shape)
    if bias is not None:
        return plain_attention(q, k, v, scale=scale, bias=bias)
    from .flash_attention import flash_attention
    return flash_attention(q, k, v, scale=scale)
