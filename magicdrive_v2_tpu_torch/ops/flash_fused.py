"""Fused qkv-direct attention for Hopper.

Counterpart of the JAX package's ops/flash_fused.py, whose three Pallas bodies
(full-row, blocked-K, blocked-K with the head in the grid) compute one function;
here one kernel, ``csrc/fused_qkv_attention.cu``, covers every sequence length.

- consumes the qkv projection output directly as (G, N, 3, H, D): no split, no
  head transpose, no separate RMSNorm pass;
- per-head RMSNorm of q and k with the cast points of the model's RMSNorm: fp32
  normalise, round to the compute dtype, multiply by the fp32 weight, round back;
- fp32 logits and softmax; the value product takes the probabilities rounded to
  the compute dtype and accumulates in fp32;
- ``kv_perm`` (G,) or (J, G): k/v are read from group ``kv_perm[j][g]`` (the
  cross-view neighbour gather); each source has its own softmax and the outputs
  are summed over j in fp32.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version. Where autograd records (grad enabled, an input requires
grad) the launch goes through ``plain_vjp.PlainVJPFunction``, whose backward is
the plain version's, recomputed, as the JAX ``_bwd`` recomputes through XLA: it
gives the grads of qkv and of both norm weights. The recompute runs over blocks of
groups whose fp32 logits stay within ``BACKWARD_LOGITS_BYTES``: at 848x1600 one
group's logits are 16 x 5300^2 x 4 B = 1.8 GB, and all of a step's groups at once
would not fit the card. In bf16 the kernel is two launches: a pre-pass that
normalises k once per row into a scratch buffer of zero-padded tiles, then the
attention, which reads q and v from qkv and k from those tiles; their launch plan
(``plan_bf16``) is computed here, in Python, and handed to the C entry points.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import _cuda_build
from .plain_vjp import PlainVJPFunction, needs_grad

_EPS = 1e-6
_fns = None
# fp32 logits (of one source) that the backward's plain recompute holds at once
BACKWARD_LOGITS_BYTES = 2 ** 31


def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + _EPS)
    return (w.float() * x32.to(dtype).float()).to(dtype)


def _perm_array(kv_perm, G: int) -> Optional[np.ndarray]:
    if kv_perm is None:
        return None
    if isinstance(kv_perm, torch.Tensor):
        kv_perm = kv_perm.detach().cpu().numpy()
    perm = np.asarray(kv_perm, np.int32)
    if perm.ndim == 1:
        perm = perm[None]
    if perm.ndim != 2 or perm.shape[1] != G:
        raise ValueError(f"kv_perm must be ({G},) or (J, {G}), got {perm.shape}")
    if perm.min() < 0 or perm.max() >= G:
        raise ValueError("kv_perm holds a group index out of range")
    return perm


def fused_qkv_attention_plain(qkv: torch.Tensor,
                              q_norm_weight: Optional[torch.Tensor],
                              k_norm_weight: Optional[torch.Tensor],
                              kv_perm=None, scale: Optional[float] = None,
                              group_chunk: Optional[int] = None,
                              groups: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The same function in plain PyTorch, with the kernel's cast points.
    ``group_chunk`` bounds the fp32 logits held at once (groups per pass);
    ``groups`` (g0, g1): only those groups' output (their k/v sources may be any
    group)."""
    G, N, _, H, D = qkv.shape
    lo, hi = groups if groups is not None else (0, G)
    if scale is None:
        scale = D ** -0.5
    perm = _perm_array(kv_perm, G)
    if perm is None:
        perm = np.arange(G, dtype=np.int32)[None]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if q_norm_weight is not None:
        q = _rms(q, q_norm_weight)
        k = _rms(k, k_norm_weight)
    out = torch.zeros((hi - lo, N, H, D), dtype=torch.float32, device=qkv.device)
    step = group_chunk or hi - lo
    for g0 in range(lo, hi, step):
        g1 = min(g0 + step, hi)
        q32 = q[g0:g1].float()
        for j in range(perm.shape[0]):
            idx = torch.as_tensor(perm[j, g0:g1].astype(np.int64), device=qkv.device)
            k_j, v_j = k[idx], v[idx]
            logits = torch.einsum("gnhd,gmhd->ghnm", q32, k_j.float()) * scale
            p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
            denom = p.sum(dim=-1)  # (g, H, N)
            o = torch.einsum("ghnm,gmhd->gnhd", p.to(qkv.dtype).float(), v_j.float())
            out[g0 - lo:g1 - lo] += o / denom.permute(0, 2, 1)[..., None]
    return out.to(qkv.dtype)


def _backward_group_step(qkv: torch.Tensor, *args) -> Optional[int]:
    """Groups a pass of the backward's recompute takes, or None for all at once."""
    G, N, _, H, _ = qkv.shape
    step = max(1, BACKWARD_LOGITS_BYTES // (H * N * N * 4))
    return step if step < G else None


fused_qkv_attention_plain.backward_group_step = _backward_group_step


# ---------------------------------------------------------------- bf16 launch plan

TILE_ROWS = 64      # rows of a k/v tile and of half a q tile (kRows of attn_k1_sm90.cuh)
Q_ROWS = 128        # q rows per block: two 64-row halves, one warpgroup each
THREADS = 256       # threads per attention block
SMEM_LIMIT = 232_448  # dynamic shared memory one block may take on an H100
# bf16 head dims the kernel takes -> (padded width of its tiles, a multiple of 16,
# the depth of one tensor-core k-step; width of the value product). The model's
# head dim is 72.
PADDED_WIDTH = {8: (16, 16), 16: (16, 16), 24: (32, 32), 32: (32, 32), 72: (80, 72)}


class K1Plan(NamedTuple):
    dp: int                     # padded head dim of the tiles
    q_tiles: int                # 128-row q tiles per (group, head)
    blocks: int                 # attention blocks: G * H * q_tiles
    tiles: int                  # 64-row tiles per (group, head) in the scratch
    scratch_shape: Tuple[int, ...]  # normalised k: (G, H, tiles, dp / 8, 64, 8) bf16
    smem_bytes: int             # dynamic shared memory of one attention block


def plan_bf16(G: int, N: int, H: int, D: int, J: int = 1) -> K1Plan:
    """Launch plan of the bf16 kernel for qkv (G, N, 3, H, D) and J k/v sources;
    raises on a head dim it does not take."""
    if D not in PADDED_WIDTH:
        raise ValueError(f"the bf16 kernel takes head dims {sorted(PADDED_WIDTH)}, got {D}")
    dp, dv = PADDED_WIDTH[D]
    q_tiles = -(-N // Q_ROWS)
    blocks = G * H * q_tiles
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"{blocks} blocks exceed the grid limit")
    tiles = 2 * q_tiles
    # two q tiles and the k and v rings (three tiles deep) in bf16; with J > 1 the
    # fp32 sum over the sources, dv / 2 values per thread, and a ring two tiles
    # deep, so that two blocks still fit on an SM
    if J == 1:
        smem = 2 * (2 + 2 * 3) * TILE_ROWS * dp
    else:
        smem = 2 * (2 + 2 * 2) * TILE_ROWS * dp + 4 * (dv // 2) * THREADS
    return K1Plan(dp, q_tiles, blocks, tiles, (G, H, tiles, dp // 8, TILE_ROWS, 8), smem)


def _kernels():
    global _fns
    if _fns is None:
        lib = _cuda_build.load("fused_qkv_attention")
        tile = lib.mdv2_k1_tile_k
        tile.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_void_p])
        attend = lib.mdv2_k1_attention
        attend.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        f32 = lib.mdv2_fused_qkv_attention_f32
        f32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        for fn in (tile, attend, f32):
            fn.restype = ctypes.c_int
        _fns = (tile, attend, f32)
    return _fns


def tile_k(qkv: torch.Tensor, kw: Optional[torch.Tensor], plan: K1Plan) -> torch.Tensor:
    """The bf16 kernel's pre-pass alone: the k rows of qkv, normalised when the
    fp32 (D,) weight is given, laid out as the plan's zero-padded tiles."""
    G, N, _, H, D = qkv.shape
    tiles = torch.empty(plan.scratch_shape, dtype=torch.bfloat16, device=qkv.device)
    with _cuda_build.on_device(qkv) as stream:
        err = _kernels()[0](qkv.data_ptr(), tiles.data_ptr(),
                            None if kw is None else kw.data_ptr(),
                            G, N, H, D, plan.dp, plan.tiles, _EPS, stream)
    _cuda_build.check(err, "fused_qkv_attention (pre-pass)")
    return tiles


def _perm_tensor(kv_perm, G: int, device) -> Optional[torch.Tensor]:
    """int32 (J, G) device tensor. A caller on a hot path passes one ready-made
    (the cross-view module keeps its own); anything else is checked and copied."""
    if kv_perm is None:
        return None
    if isinstance(kv_perm, torch.Tensor) and kv_perm.device == device \
            and kv_perm.dtype == torch.int32 and kv_perm.ndim == 2 \
            and kv_perm.shape[1] == G and kv_perm.is_contiguous():
        return kv_perm
    return torch.from_numpy(_perm_array(kv_perm, G)).to(device)


def _norm_weight(w: torch.Tensor, D: int, device) -> torch.Tensor:
    """The (D,) fp32 weight as the kernel reads it (no copy when it already is)."""
    if w.shape != (D,):
        raise ValueError(f"norm weight must be ({D},), got {tuple(w.shape)}")
    return w.detach().to(device=device, dtype=torch.float32).contiguous()


def fused_qkv_attention(qkv: torch.Tensor,
                        q_norm_weight: Optional[torch.Tensor],
                        k_norm_weight: Optional[torch.Tensor],
                        kv_perm: Union[None, Sequence, np.ndarray, torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """qkv: (G, N, 3, H, D) -> (G, N, H, D). q/k_norm_weight: both (D,) or both
    None. kv_perm: None, (G,) or (J, G) group indices. On the card the head dim
    is at most 144 in fp32 and one of ``PADDED_WIDTH`` in bf16."""
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(f"expected qkv of shape (G, N, 3, H, D), got {tuple(qkv.shape)}")
    if (q_norm_weight is None) != (k_norm_weight is None):
        raise ValueError("give both norm weights or neither")
    if scale is None:
        scale = qkv.shape[-1] ** -0.5
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, q_norm_weight, k_norm_weight,
                                         kv_perm, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention runs on cuda or cpu tensors, got {qkv.device}")
    if needs_grad(qkv, q_norm_weight, k_norm_weight):
        return PlainVJPFunction.apply(_launch, fused_qkv_attention_plain,
                                      "fused_qkv_attention", qkv, q_norm_weight,
                                      k_norm_weight, kv_perm, scale)
    return _launch(qkv, q_norm_weight, k_norm_weight, kv_perm, scale)


def _launch(qkv: torch.Tensor, q_norm_weight: Optional[torch.Tensor],
            k_norm_weight: Optional[torch.Tensor], kv_perm, scale: float) -> torch.Tensor:
    """One call of the kernel (two launches in bf16) on a CUDA qkv."""
    G, N, _, H, D = qkv.shape
    bf16 = _cuda_build.dtype_code(qkv.dtype) == 0
    if not bf16 and D > _cuda_build.MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {_cuda_build.MAX_HEAD_DIM} is not supported "
                         "by the kernel")
    perm = _perm_tensor(kv_perm, G, qkv.device)
    J = 1 if perm is None else perm.shape[0]
    plan = plan_bf16(G, N, H, D, J) if bf16 else None
    qkv = qkv.contiguous()
    if bf16 and qkv.data_ptr() % 16:
        raise ValueError("the bf16 kernel reads qkv rows in 16-byte pieces: qkv must "
                         "start on a 16-byte boundary")
    qw = kw = None
    if q_norm_weight is not None:
        qw = _norm_weight(q_norm_weight, D, qkv.device)
        kw = _norm_weight(k_norm_weight, D, qkv.device)
    out = torch.empty((G, N, H * D), dtype=qkv.dtype, device=qkv.device)
    perm_ptr = None if perm is None else perm.data_ptr()
    _, attend, f32 = _kernels()
    if bf16:
        tiles = tile_k(qkv, kw, plan)
        with _cuda_build.on_device(qkv) as stream:
            err = attend(qkv.data_ptr(), tiles.data_ptr(), out.data_ptr(), perm_ptr,
                         None if qw is None else qw.data_ptr(), G, N, H, D, J,
                         float(scale), _EPS, plan.dp, plan.q_tiles, plan.blocks,
                         plan.smem_bytes, stream)
    else:
        with _cuda_build.on_device(qkv) as stream:
            err = f32(qkv.data_ptr(), out.data_ptr(), perm_ptr,
                      None if qw is None else qw.data_ptr(),
                      None if kw is None else kw.data_ptr(),
                      G, N, H, D, J, float(scale), _EPS, stream)
    _cuda_build.check(err, "fused_qkv_attention")
    fused_qkv_attention.launches += 1
    return out.view(G, N, H, D)


fused_qkv_attention.launches = 0
