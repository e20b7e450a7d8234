"""Weights for the port: conversion from the JAX package's parameter tree, the
reading of torch checkpoints and diffusers snapshots, and a seeded random fill.

``from_jax_params`` maps a flax parameter tree (nested dicts of numpy arrays)
to a state dict in the port's key names and layouts, which are the reference
torch checkpoint's:

  Dense kernel (in, out)            -> Linear weight (out, in)
  Conv kernel  (kh, kw, I, O)       -> Conv2d weight (O, I, kh, kw)
  Conv kernel  (kt, kh, kw, I, O)   -> Conv3d weight (O, I, kt, kh, kw)
  tables and buffers                unchanged

Scanned layer groups (a leading layer axis) are unstacked into
``base_blocks_s.{i}`` etc., the plain segment offset by ``control_depth``. The
VAE's ``down_blocks_N`` / ``resnets_N`` / ... become ``down_blocks.N`` / ...
and a GroupNorm ``scale`` its ``weight``.

Training checkpoints keep the JAX package's layout, one ``global_step{N}/``
directory each with ``running_states.json`` and ``rng_state.json``; the tensors are
the port's own: ``torch.save`` of the model's, the EMA's and the optimizer's state
dicts (``model.pt``, ``ema.pt``, ``optimizer.pt``).
"""
from __future__ import annotations

import json
import logging
import os
import random as pyrandom
import re
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

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
    # the CogVideoX VAE's module tree
    (re.compile(r"^down_blocks_(\d+)$"), r"down_blocks.\1"),
    (re.compile(r"^up_blocks_(\d+)$"), r"up_blocks.\1"),
    (re.compile(r"^resnets_(\d+)$"), r"resnets.\1"),
    (re.compile(r"^downsamplers_(\d+)$"), r"downsamplers.\1"),
    (re.compile(r"^upsamplers_(\d+)$"), r"upsamplers.\1"),
    (re.compile(r"^scale$"), "weight"),  # GroupNorm
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


def load_state_dict_cast(module: torch.nn.Module, state: Dict[str, Any],
                         strict: bool = True):
    """``load_state_dict`` from numpy arrays or tensors, each cast to the dtype of
    the module's entry of that name."""
    own = module.state_dict()
    tensors = {}
    for k, v in state.items():
        # a copy: a numpy source may be read-only
        t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        if k in own:
            t = t.to(own[k].dtype)
        tensors[k] = t
    return module.load_state_dict(tensors, strict=strict)


# ---------------------------------------------------------------------------
# torch checkpoints and diffusers snapshots, read without extra packages
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file: an 8-byte little-endian header length, a JSON
    header of {name: {dtype, shape, data_offsets}}, then the raw little-endian
    buffers, offsets relative to the end of the header."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        t = torch.frombuffer(data, dtype=dtype, offset=begin,
                             count=(end - begin) // dtype.itemsize) if end > begin \
            else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"]).clone()
    return out


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from ``.safetensors`` or a torch ``.pt`` / ``.pth`` / ``.bin``
    file (``torch.load(weights_only=True)``; a ``"state_dict"`` entry is
    unwrapped). Tensors on the CPU in their stored dtype."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in sd.items()}


def resolve_pretrained_dir(path: str, subfolder: Optional[str] = None
                           ) -> Tuple[Optional[dict], Dict[str, torch.Tensor]]:
    """(config.json as a dict or None, state dict) of a local diffusers snapshot:
    a directory (``subfolder`` inside it, e.g. "vae", when present) holding
    ``config.json`` and ``diffusion_pytorch_model.{safetensors,bin}``, one
    weights file, or an index of shards; or a weights file itself. A hub id is
    not fetched: anything but a local path raises ``FileNotFoundError``."""
    if os.path.isfile(path):
        return None, load_torch_file(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"pretrained path {path!r} is not a local file or directory (nothing is "
            "downloaded; pass a snapshot directory)")
    d = path
    if subfolder and os.path.isdir(os.path.join(d, subfolder)):
        d = os.path.join(d, subfolder)
    cfg = None
    if os.path.isfile(os.path.join(d, "config.json")):
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
    for name in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                 "model.safetensors", "pytorch_model.bin"):
        if os.path.isfile(os.path.join(d, name)):
            return cfg, load_torch_file(os.path.join(d, name))
    index = [f for f in sorted(os.listdir(d)) if f.endswith(".index.json")]
    if index:  # a sharded snapshot: every shard, or the model would be part random
        with open(os.path.join(d, index[0])) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        merged: Dict[str, torch.Tensor] = {}
        for shard in shards:
            merged.update(load_torch_file(os.path.join(d, shard)))
        return cfg, merged
    cands = [f for f in sorted(os.listdir(d))
             if f.endswith((".safetensors", ".bin", ".pt", ".pth"))]
    if len(cands) != 1:
        raise FileNotFoundError(f"expected one weights file under {d!r}, found {cands}")
    return cfg, load_torch_file(os.path.join(d, cands[0]))


@torch.no_grad()
def init_weights(model: torch.nn.Module, seed: int = 0, std: float = 0.02,
                 chunk: int = 1 << 24) -> torch.nn.Module:
    """Fill every parameter and buffer with small normal values from
    ``np.random.default_rng``: one stream per tensor, keyed by (seed, position in
    the state dict), the tensors filled on 8 threads (numpy draws without the
    GIL). The projections the reference zero-initialises are filled too, so every
    branch of the network contributes to the output. RMSNorm and GroupNorm weights
    centre on 1."""
    centred = {f"{n}.weight" for n, m in model.named_modules()
               if isinstance(m, torch.nn.GroupNorm)}

    def fill(item):
        i, (name, t) = item
        if not t.is_floating_point():
            return
        rng = np.random.default_rng([seed, i])
        flat = t.view(-1)
        for s in range(0, flat.numel(), chunk):
            n = min(chunk, flat.numel() - s)
            vals = torch.from_numpy(rng.standard_normal(n, np.float32))
            flat[s:s + n] = (vals * std).to(device=t.device, dtype=t.dtype)
        if name.endswith("_norm.weight") or name in centred:
            t.add_(1.0)

    items = list(enumerate(model.state_dict().items()))
    # a tensor under two names is filled once, as its last name (what a fill in
    # order leaves)
    last = {t.data_ptr(): i for i, (_, t) in items if t.numel()}
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(fill, [it for it in items if last.get(it[1][1].data_ptr()) == it[0]]))
    return model


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------


def _ckpt_name(step: int) -> str:
    return f"global_step{step}"


def find_latest(ckpt_dir: str) -> Optional[str]:
    """The ``global_step*`` directory with the largest step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"global_step(\d+)", name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            steps.append(int(m.group(1)))
    if not steps:
        return None
    return os.path.join(ckpt_dir, _ckpt_name(max(steps)))


def save_rng_state(path: str, extra: Optional[dict] = None):
    """Persist the host's python and numpy global random states as JSON."""
    version, internal, gauss = pyrandom.getstate()
    kind, keys, pos, has_gauss, cached = np.random.get_state()
    state = {"python": [version, list(internal), gauss],
             "numpy": [kind, keys.tolist(), int(pos), int(has_gauss), float(cached)]}
    if extra:
        state.update(extra)
    with open(path, "w") as f:
        json.dump(state, f)


def load_rng_state(path: str) -> dict:
    """Restore what ``save_rng_state`` wrote. The file is read as JSON, so a
    file from elsewhere can set the random states but run no code."""
    with open(path) as f:
        state = json.load(f)
    version, internal, gauss = state["python"]
    pyrandom.setstate((version, tuple(internal), gauss))
    kind, keys, pos, has_gauss, cached = state["numpy"]
    np.random.set_state((kind, np.asarray(keys, dtype=np.uint32), pos, has_gauss, cached))
    return state


def save_checkpoint(ckpt_dir: str, step: int, *, model: torch.nn.Module,
                    optimizer=None, ema: Optional[torch.nn.Module] = None,
                    running_states: Optional[dict] = None) -> str:
    """Write one resumable checkpoint directory; returns its path."""
    path = os.path.abspath(os.path.join(ckpt_dir, _ckpt_name(step)))
    os.makedirs(path, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(path, "model.pt"))
    if ema is not None:
        torch.save(ema.state_dict(), os.path.join(path, "ema.pt"))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(path, "optimizer.pt"))
    running = dict(running_states or {})
    running["step"] = step
    with open(os.path.join(path, "running_states.json"), "w") as f:
        json.dump(running, f, indent=2, default=str)
    save_rng_state(os.path.join(path, "rng_state.json"))
    logger.info("saved checkpoint: %s", path)
    return path


def load_checkpoint(path: str, *, model: Optional[torch.nn.Module] = None,
                    ema: Optional[torch.nn.Module] = None, optimizer=None) -> dict:
    """Load a directory ``save_checkpoint`` wrote into the given model, EMA and
    optimizer (each that is given and was saved), in place, onto their devices.
    Returns the running states (``step``, ...)."""
    def read(name):
        f = os.path.join(path, name)
        return torch.load(f, map_location="cpu", weights_only=True) \
            if os.path.isfile(f) else None

    if model is not None:
        model.load_state_dict(read("model.pt"))
    if ema is not None and (sd := read("ema.pt")) is not None:
        ema.load_state_dict(sd)
    if optimizer is not None and (sd := read("optimizer.pt")) is not None:
        optimizer.load_state_dict(sd)
    rs = os.path.join(path, "running_states.json")
    running = {}
    if os.path.isfile(rs):
        with open(rs) as f:
            running = json.load(f)
    rng = os.path.join(path, "rng_state.json")
    if os.path.isfile(rng):
        load_rng_state(rng)
    return running
