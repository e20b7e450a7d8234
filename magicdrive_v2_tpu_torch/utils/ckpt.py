"""Weights for the port: conversion from the JAX package's parameter tree, and a
seeded random fill.

``from_jax_params`` maps a flax parameter tree (nested dicts of numpy arrays)
to a state dict in the port's key names and layouts, which are the reference
torch checkpoint's:

  Dense kernel (in, out)            -> Linear weight (out, in)
  Conv kernel  (kh, kw, I, O)       -> Conv2d weight (O, I, kh, kw)
  Conv kernel  (kt, kh, kw, I, O)   -> Conv3d weight (O, I, kt, kh, kw)
  tables and buffers                unchanged

Scanned layer groups (a leading layer axis) are unstacked into
``base_blocks_s.{i}`` etc., the plain segment offset by ``control_depth``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_NAME_REWRITES = [
    (re.compile(r"^t_block_1$"), "t_block.1"),
    (re.compile(r"^mlp_([02])$"), r"mlp.\1"),
    (re.compile(r"^second_linear_([024])$"), r"second_linear.\1"),
    (re.compile(r"^blocks_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^conv_blocks_(\d+)$"), r"conv_blocks.\1"),
    (re.compile(r"^class_tokens$"), "_class_tokens"),
    (re.compile(r"^after_proj_layer$"), "after_proj"),
    (re.compile(r"^qkv_kernel$"), "qkv.weight"),
    (re.compile(r"^qkv_bias$"), "qkv.bias"),
    (re.compile(r"^kernel$"), "weight"),
]

# scanned layer containers: (group, block) -> (module list, offset by control_depth?)
_SCAN_SEGMENTS = {
    ("ctrl_layers", "base_s"): ("base_blocks_s", False),
    ("ctrl_layers", "base_t"): ("base_blocks_t", False),
    ("ctrl_layers", "control_s"): ("control_blocks_s", False),
    ("ctrl_layers", "control_t"): ("control_blocks_t", False),
    ("plain_layers", "base_s"): ("base_blocks_s", True),
    ("plain_layers", "base_t"): ("base_blocks_t", True),
}


def _rewrite_segment(seg: str) -> str:
    for pat, repl in _NAME_REWRITES:
        if pat.match(seg):
            return pat.sub(repl, seg)
    return seg


def _torch_key(path: Tuple[str, ...], control_depth: int) -> Tuple[str, Optional[int]]:
    """(key, first layer index or None). A scanned key holds "{i}"."""
    parts = [p for p in path if p != "params"]
    base = None
    if len(parts) >= 2 and (parts[0], parts[1]) in _SCAN_SEGMENTS:
        name, offset = _SCAN_SEGMENTS[(parts[0], parts[1])]
        base = control_depth if offset else 0
        parts = [name + ".{i}"] + parts[2:]
    # the temporal mini-transformer's parameters sit directly on its embedder
    parts = [_rewrite_segment(p) for p in parts if p != "temp"]
    return ".".join(parts), base


def _to_torch_layout(key: str, w: np.ndarray) -> np.ndarray:
    w = np.asarray(w)
    if not key.endswith("weight"):
        return w
    if w.ndim == 2:
        return w.T
    if w.ndim == 4:
        return w.transpose(3, 2, 0, 1)
    if w.ndim == 5:
        return w.transpose(4, 3, 0, 1, 2)
    return w


def _iter_tree(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_tree(v, prefix + (k,))
    else:
        yield prefix, tree


def from_jax_params(tree: Any, control_depth: int = 13) -> Dict[str, np.ndarray]:
    """Flax parameter tree (nested dicts of arrays, with or without the outer
    ``"params"``) -> state dict of numpy arrays for ``load_state_dict``."""
    root = tree.get("params", tree) if isinstance(tree, dict) else tree
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _iter_tree(root):
        key, base = _torch_key(path, control_depth)
        arr = np.asarray(leaf)
        if base is None:
            out[key] = _to_torch_layout(key, arr)
        else:
            for i in range(arr.shape[0]):
                out[key.format(i=base + i)] = _to_torch_layout(key, arr[i])
    return out


def load_numpy_state_dict(module: torch.nn.Module, state: Dict[str, np.ndarray],
                          strict: bool = True):
    """``load_state_dict`` from numpy arrays, cast to each parameter's dtype."""
    own = module.state_dict()
    tensors = {}
    for k, v in state.items():
        t = torch.from_numpy(np.array(v))  # a copy: the source may be read-only
        if k in own:
            t = t.to(own[k].dtype)
        tensors[k] = t
    return module.load_state_dict(tensors, strict=strict)


@torch.no_grad()
def init_weights(model: torch.nn.Module, seed: int = 0, std: float = 0.02,
                 chunk: int = 1 << 24) -> torch.nn.Module:
    """Fill every parameter and buffer with small normal values from
    ``np.random.default_rng``: one stream per tensor, keyed by (seed, position in
    the state dict). The projections the reference zero-initialises are filled
    too, so every branch of the network contributes to the output."""
    for i, (name, t) in enumerate(model.state_dict().items()):
        if not t.is_floating_point():
            continue
        rng = np.random.default_rng([seed, i])
        flat = t.view(-1)
        for s in range(0, flat.numel(), chunk):
            n = min(chunk, flat.numel() - s)
            vals = torch.from_numpy(rng.standard_normal(n, np.float32))
            flat[s:s + n] = (vals * std).to(device=t.device, dtype=t.dtype)
        if name.endswith("_norm.weight"):
            t.add_(1.0)  # RMSNorm weights centre on 1
    return model
