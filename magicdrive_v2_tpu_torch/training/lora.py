"""Functional LoRA and the BrushNet trainable mask (counterpart of the JAX
package's training/lora.py).

The adapters are a separate ``{weight name: {"a": (r, in), "b": (out, r)}}``
dict, one entry per block, merged in weight space,

    W_eff = W + (b @ a) * alpha / r      (torch's Linear layout (out, in)),

by a pure function on a ``{name: tensor}`` dict that can feed
``torch.func.functional_call``; merging before the forward equals per-layer
additive LoRA without dropout. a is kaiming-uniform with bound 1/sqrt(in), b is
zero (the reference's init). The JAX package keeps the same arrays in flax's
(in, out) layout and merges with ``einsum("...ri,...or->...io")``, so its
adapters carry over with no transpose (``lora_from_jax``).

Patterns are regular expressions anchored at the start (``re.match``), written
against ``flax_style_paths`` of the torch names: the JAX package's scanned
groups, torch leaf and sub-module names (``weight``; ``t_inpaint_block/1``).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Sequence, Tuple

import torch

from ..utils import train_utils
from ..utils.ckpt import lora_from_jax

__all__ = ["init_lora", "merge_lora", "lora_trainable_mask", "lora_from_jax",
           "DEFAULT_LORA_TARGETS", "BRUSHNET_EXTRA_TRAINABLE"]

# the reference's targets: attention qkv / proj, condition cross-attention q / kv /
# proj, MLP fc1 / fc2, on the base blocks only
DEFAULT_LORA_TARGETS = (
    r".*base_[st]/attn/qkv/weight$",
    r".*base_[st]/attn/proj/weight$",
    r".*base_[st]/cross_attn/q_linear/weight$",
    r".*base_[st]/cross_attn/kv_linear/weight$",
    r".*base_[st]/cross_attn/proj/weight$",
    r".*base_[st]/mlp/fc1/weight$",
    r".*base_[st]/mlp/fc2/weight$",
)

# only_train_extra_blocks: the BrushNet branch (its blocks, the ShallowEncoder, its
# patch embedder and the SDE timestep blocks) trains, the base model is frozen
BRUSHNET_EXTRA_TRAINABLE = (
    r".*brushnet_[st]/.*",
    r".*shallow_encoder/.*",
    r".*x_brushnet_embedder/.*",
    r".*t_inpaint_block/1/.*",
    r".*t_combine_block/1/.*",
)


def _matches(names: Iterable[str], patterns: Sequence[str]) -> Dict[str, bool]:
    compiled = [re.compile(p) for p in patterns]
    return {name: any(p.match(path) for p in compiled)
            for name, path in train_utils.flax_style_paths(names).items()}


def init_lora(named_params: Iterable[Tuple[str, torch.Tensor]], rank: int,
              generator: torch.Generator, targets: Sequence[str] = DEFAULT_LORA_TARGETS
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Adapters for every Linear weight a target matches, in the order of
    ``named_params`` (every parameter of one model): ``a`` (rank, in) uniform on
    +-1/sqrt(in) from ``generator`` (torch's kaiming_uniform_ with a=sqrt(5)),
    ``b`` (out, rank) zero; fp32 on ``generator``'s device."""
    named_params = list(named_params)
    match = _matches((name for name, _ in named_params), targets)
    dev = generator.device
    out = {}
    for name, w in named_params:
        if not match[name]:
            continue
        d_out, d_in = w.shape
        bound = 1.0 / math.sqrt(d_in)
        a = torch.rand((rank, d_in), generator=generator, device=dev) * (2 * bound) - bound
        out[name] = {"a": a, "b": torch.zeros((d_out, rank), device=dev)}
    return out


def merge_lora(params: Dict[str, torch.Tensor], lora: Dict[str, Dict[str, torch.Tensor]],
               alpha: float, rank: int) -> Dict[str, torch.Tensor]:
    """``params`` with ``W + (b @ a) * alpha / rank`` (in W's dtype) for every
    weight ``lora`` holds; the others as they are. Differentiable in both."""
    scale = alpha / rank
    merged = dict(params)
    for name, ab in lora.items():
        w = params[name]
        a = torch.as_tensor(ab["a"], device=w.device)
        b = torch.as_tensor(ab["b"], device=w.device)
        merged[name] = w + ((b @ a) * scale).to(w.dtype)
    return merged


def lora_trainable_mask(named_params: Iterable[Tuple[str, torch.Tensor]],
                        extra_trainable: Sequence[str] = ()) -> Dict[str, bool]:
    """{name: trainable} over every parameter of one model: only what one of
    ``extra_trainable`` matches trains (``only_train_extra_blocks``);
    ``BRUSHNET_EXTRA_TRAINABLE`` keeps the BrushNet branch trainable and freezes
    the base."""
    return _matches((name for name, _ in named_params), extra_trainable)
