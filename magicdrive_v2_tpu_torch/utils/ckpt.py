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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_NAME_REWRITES = [
    (re.compile(r"^t_block_1$"), "t_block.1"),
    (re.compile(r"^t_inpaint_block_1$"), "t_inpaint_block.1"),
    (re.compile(r"^t_combine_block_1$"), "t_combine_block.1"),
    (re.compile(r"^mlp_([02])$"), r"mlp.\1"),
    (re.compile(r"^second_linear_([024])$"), r"second_linear.\1"),
    (re.compile(r"^blocks_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^conv_blocks_(\d+)$"), r"conv_blocks.\1"),
    (re.compile(r"^class_tokens$"), "_class_tokens"),
    (re.compile(r"^after_proj_layer$"), "after_proj"),
    (re.compile(r"^qkv_kernel$"), "qkv.weight"),
    (re.compile(r"^qkv_bias$"), "qkv.bias"),
    (re.compile(r"^embedding_table$"), "embedding_table.weight"),  # LabelEmbedder
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
    # the BrushNet models' groups: base, control and brushnet blocks
    ("brush_ctrl_layers", "base_s"): ("base_blocks_s", False),
    ("brush_ctrl_layers", "base_t"): ("base_blocks_t", False),
    ("brush_ctrl_layers", "control_s"): ("control_blocks_s", False),
    ("brush_ctrl_layers", "control_t"): ("control_blocks_t", False),
    ("brush_ctrl_layers", "brushnet_s"): ("brushnet_blocks_s", False),
    ("brush_ctrl_layers", "brushnet_t"): ("brushnet_blocks_t", False),
    ("brush_plain_layers", "base_s"): ("base_blocks_s", True),
    ("brush_plain_layers", "base_t"): ("base_blocks_t", True),
    ("brush_plain_layers", "brushnet_s"): ("brushnet_blocks_s", True),
    ("brush_plain_layers", "brushnet_t"): ("brushnet_blocks_t", True),
}


def scanned_group(layer_list: str, index: int, control_depth: int,
                  brushnet: bool) -> Optional[Tuple[str, str]]:
    """(group, block) of the JAX package's scanned tree that holds block ``index``
    of the port's ``layer_list`` (``_SCAN_SEGMENTS`` read backwards; the BrushNet
    models' groups when ``brushnet``), or None for a list that is not scanned."""
    for (group, block), (name, offset) in _SCAN_SEGMENTS.items():
        if (name == layer_list and group.startswith("brush_") == brushnet
                and offset == (index >= control_depth)):
            return group, block
    return None


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
    if not key.endswith("weight") or key.endswith("embedding_table.weight"):
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


def lora_from_jax(tree: Any, control_depth: int = 13) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX package's LoRA adapter tree (``{..., "kernel": {"a", "b"}}``, a
    leading layer axis on scanned groups) -> ``{port weight name: {"a": (r, in),
    "b": (out, r)}}``, one entry per block. Both layouts are torch's, so the
    arrays carry over as they are."""
    root = tree.get("params", tree)
    out: Dict[str, Dict[str, np.ndarray]] = {}

    def walk(node, path):
        if set(node) == {"a", "b"}:
            key, base = _torch_key(path, control_depth)
            a, b = np.array(node["a"]), np.array(node["b"])
            if base is None:
                out[key] = {"a": a, "b": b}
            else:
                for i in range(a.shape[0]):
                    out[key.format(i=base + i)] = {"a": a[i], "b": b[i]}
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(root, ())
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


def load_reference_weights(model: torch.nn.Module, cfg, ckpt_path: Optional[str] = None):
    """The apps' ``--ckpt-path`` (else the config's ``ckpt_path``): a reference
    torch checkpoint loaded into ``model`` (``strict=False``; the result names
    the missing and unused keys), or None when none is configured ("???" is
    none). A configured file that is missing raises."""
    ckpt = ckpt_path or cfg.get("ckpt_path")
    if not ckpt or ckpt == "???":
        return None
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"ckpt_path {ckpt!r} does not exist")
    return ckpt, load_state_dict_cast(model, load_torch_file(ckpt), strict=False)


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
    """Fill every parameter and buffer with small normal values, drawn where the
    tensor lives: one torch generator per tensor on its device, seeded from
    (seed, position in the state dict), drawn in fp32 ``chunk`` values at a time,
    scaled by ``std`` and rounded to the tensor's dtype. The same seed gives the same
    weights on the same kind of device; the CPU's and the card's generators differ,
    so a model to be held against another on the other device is copied, not
    initialised twice. The projections the reference zero-initialises are filled
    too, so every branch of the network contributes to the output. RMSNorm and
    GroupNorm weights centre on 1."""
    centred = {f"{n}.weight" for n, m in model.named_modules()
               if isinstance(m, torch.nn.GroupNorm)}
    items = list(enumerate(model.state_dict().items()))
    # a tensor under two names is filled once, as its last name (what a fill in
    # order leaves)
    last = {t.data_ptr(): i for i, (_, t) in items if t.numel()}
    for i, (name, t) in items:
        if not t.is_floating_point() or last.get(t.data_ptr()) != i:
            continue
        gen = torch.Generator(device=t.device)
        gen.manual_seed((seed * (1 << 20) + i) % (1 << 63))
        flat = t.view(-1)
        for s in range(0, flat.numel(), chunk):
            n = min(chunk, flat.numel() - s)
            vals = torch.randn(n, generator=gen, device=t.device, dtype=torch.float32)
            flat[s:s + n] = (vals * std).to(t.dtype)
        if name.endswith("_norm.weight") or name in centred:
            t.add_(1.0)
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
                    running_states: Optional[dict] = None, sharding=None) -> str:
    """Write one resumable checkpoint directory in the one-process format; returns
    its path. In a ``torch.distributed`` group every rank calls it, and rank 0
    writes. With a ``sharding`` (``parallel.fsdp.ParamSharding``: model, EMA and
    moments are this rank's blocks) each file's split entries are first gathered
    over dp to rank 0, one file at a time, so the checkpoint is the one a single
    process writes and resumes at any world size. Every rank leaves only once the
    directory is whole, so none resumes from a half-written one."""
    import torch.distributed as dist
    path = os.path.abspath(os.path.join(ckpt_dir, _ckpt_name(step)))
    writer = not dist.is_initialized() or dist.get_rank() == 0
    if writer:
        os.makedirs(path, exist_ok=True)
    for name, state in (("model.pt", model), ("ema.pt", ema), ("optimizer.pt", optimizer)):
        if state is None:
            continue
        if sharding is None:
            sd = state.state_dict() if writer else None
        elif name == "optimizer.pt":
            sd = full_optimizer_state(state, sharding, keep=writer)
        else:  # the dp group of rank 0 (sp column 0) gathers
            sd = sharding.full_state_dict(state, keep=writer) if sharding.sp_rank == 0 \
                else None
        if writer:
            torch.save(sd, os.path.join(path, name))
        del sd
    if writer:
        running = dict(running_states or {})
        running["step"] = step
        with open(os.path.join(path, "running_states.json"), "w") as f:
            json.dump(running, f, indent=2, default=str)
        save_rng_state(os.path.join(path, "rng_state.json"))
        logger.info("saved checkpoint: %s", path)
    if dist.is_initialized():
        dist.barrier()
    return path


def full_optimizer_state(optimizer, sharding, keep: bool) -> Optional[dict]:
    """``ClippedAdamW.state_dict()`` as one process holds it: the moments of split
    parameters gathered over dp (a collective of the dp groups of sp column 0;
    other ranks return None), on the host where ``keep``."""
    sd = optimizer.state_dict()
    if sharding.sp_rank != 0:
        return None
    out = {} if keep else None
    for i, entry in sd["adamw"]["state"].items():
        name = optimizer.names[i]
        full = {k: sharding.full(name, v) if k in ("exp_avg", "exp_avg_sq") else v
                for k, v in entry.items()}
        if keep:
            out[i] = {k: v.cpu() for k, v in full.items()}
        del full
    if not keep:
        return None
    return {"count": sd["count"], "adamw": {"state": out,
                                             "param_groups": sd["adamw"]["param_groups"]}}


def local_optimizer_state(state: dict, optimizer, sharding) -> dict:
    """A one-process ``ClippedAdamW`` state dict cut to this rank's blocks."""
    adamw = state["adamw"]
    local = {i: {k: sharding.local(optimizer.names[int(i)], v)
                 if k in ("exp_avg", "exp_avg_sq") else v for k, v in entry.items()}
             for i, entry in adamw["state"].items()}
    return {"count": state["count"], "adamw": dict(adamw, state=local)}


def load_checkpoint(path: str, *, model: Optional[torch.nn.Module] = None,
                    ema: Optional[torch.nn.Module] = None, optimizer=None,
                    sharding=None) -> dict:
    """Load a directory ``save_checkpoint`` wrote into the given model, EMA and
    optimizer (each that is given and was saved), in place, onto their devices;
    with a ``sharding`` each rank takes its blocks of the one-process tensors.
    Returns the running states (``step``, ...)."""
    def read(name):
        f = os.path.join(path, name)
        return torch.load(f, map_location="cpu", weights_only=True) \
            if os.path.isfile(f) else None

    for module, name in ((model, "model.pt"), (ema, "ema.pt")):
        if module is None or (sd := read(name)) is None:
            continue
        if sharding is None:
            module.load_state_dict(sd)
        else:
            sharding.load_full_state_dict(module, sd)
        del sd
    if optimizer is not None and (sd := read("optimizer.pt")) is not None:
        optimizer.load_state_dict(sd if sharding is None
                                  else local_optimizer_state(sd, optimizer, sharding))
    rs = os.path.join(path, "running_states.json")
    running = {}
    if os.path.isfile(rs):
        with open(rs) as f:
            running = json.load(f)
    rng = os.path.join(path, "rng_state.json")
    if os.path.isfile(rng):
        load_rng_state(rng)
    return running
