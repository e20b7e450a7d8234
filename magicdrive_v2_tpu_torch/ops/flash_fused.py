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
grad) the launch goes through ``kernel_vjp.KernelFunction``: the forward kernel
also writes the rows' log-sum-exp (with one source; with several the backward
takes each source's), and the backward is the kernels of
``csrc/attn_bwd_sm90.cuh`` (the port's counterpart of the JAX ``_bwd``, jax.vjp
of the XLA composition): the grads of qkv and of both norm weights, with no N x N
buffer. ``fused_qkv_attention_backward_plain`` is that backward in plain
PyTorch; in bf16 its own pre-pass (``tile_qk``, plain counterpart ``tile_qk_plain``)
first normalises q and k once into tiles, by the plan ``plan_backward_bf16``. In
bf16 the forward kernel is two launches: a pre-pass that
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
from .kernel_vjp import KernelFunction, needs_grad

_EPS = 1e-6
_fns = None


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
                              lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in plain PyTorch, with the kernel's cast points.
    ``group_chunk`` bounds the fp32 logits held at once (groups per pass); an
    ``lse`` (J, G, H, N) fp32 tensor receives each source's row log-sum-exp (the
    kernel's forward writes it under autograd, with one source)."""
    G, N, _, H, D = qkv.shape
    if scale is None:
        scale = D ** -0.5
    perm = _perm_array(kv_perm, G)
    if perm is None:
        perm = np.arange(G, dtype=np.int32)[None]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if q_norm_weight is not None:
        q = _rms(q, q_norm_weight)
        k = _rms(k, k_norm_weight)
    out = torch.zeros((G, N, H, D), dtype=torch.float32, device=qkv.device)
    step = group_chunk or G
    for g0 in range(0, G, step):
        g1 = min(g0 + step, G)
        q32 = q[g0:g1].float()
        for j in range(perm.shape[0]):
            idx = torch.as_tensor(perm[j, g0:g1].astype(np.int64), device=qkv.device)
            k_j, v_j = k[idx], v[idx]
            logits = torch.einsum("gnhd,gmhd->ghnm", q32, k_j.float()) * scale
            m = logits.amax(dim=-1, keepdim=True)
            p = torch.exp(logits - m)
            denom = p.sum(dim=-1)  # (g, H, N)
            o = torch.einsum("ghnm,gmhd->gnhd", p.to(qkv.dtype).float(), v_j.float())
            out[g0:g1] += o / denom.permute(0, 2, 1)[..., None]
            if lse is not None:
                lse[j, g0:g1] = m[..., 0].detach() + torch.log(denom.detach())
    return out.to(qkv.dtype)


def _rms_backward_plain(x: torch.Tensor, w: torch.Tensor, dn: torch.Tensor):
    """Back through ``_rms`` from dn (fp32), the grad of its output: (dx fp32,
    dw fp32 (D,)), the kernel's formulation: y = x r, dx = r (g - y mean(g y)),
    g = dn w, dw = sum(dn x_hat) with x_hat the forward's rounded y."""
    x32 = x.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + _EPS)
    y = x32 * r
    g = dn * w.float()
    dx = r * (g - y * (g * y).mean(dim=-1, keepdim=True))
    dw = (dn * y.to(x.dtype).float()).reshape(-1, x.shape[-1]).sum(0)
    return dx, dw


def fused_qkv_attention_backward_plain(qkv: torch.Tensor,
                                       q_norm_weight: Optional[torch.Tensor],
                                       k_norm_weight: Optional[torch.Tensor], kv_perm,
                                       scale: float, lse: Optional[torch.Tensor],
                                       dout: torch.Tensor):
    """The backward kernel's formulation in plain PyTorch, fp32: per source j,
    P_j = exp(scale q k_j^T - lse_j), delta_j = rowsum(P_j o dP_j) (the source's
    own rowsum(dO o O_j)), dS_j = P_j o (dO v_j^T - delta_j); the k/v grads of a
    group summed over the sources that read it; q and k back through the norm.
    ``lse`` (1, G, H, N): the forward's, with one source; with several (None) the
    backward takes each source's, as the dQ kernel's first pass does. Returns
    (dqkv in qkv's dtype, dq_norm_weight, dk_norm_weight) (None without the
    norm)."""
    G, N, _, H, D = qkv.shape
    perm = _perm_array(kv_perm, G)
    if perm is None:
        perm = np.arange(G, dtype=np.int32)[None]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if q_norm_weight is not None:
        q, k = _rms(q, q_norm_weight), _rms(k, k_norm_weight)
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), dout.float()
    dq, dk, dv = (torch.zeros_like(q32) for _ in range(3))
    for j in range(perm.shape[0]):
        idx = torch.as_tensor(perm[j].astype(np.int64), device=qkv.device)
        logits = torch.einsum("gnhd,gmhd->ghnm", q32, k32[idx]) * scale
        lse_j = torch.logsumexp(logits, dim=-1) if lse is None else lse[j]
        p = torch.exp(logits - lse_j[..., None])
        dp = torch.einsum("gnhd,gmhd->ghnm", g32, v32[idx])
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        if N == 1:  # one key: the softmax is constant, its grads exactly zero
            ds = torch.zeros_like(ds)
        dq += torch.einsum("ghnm,gmhd->gnhd", ds, k32[idx]) * scale
        dk.index_add_(0, idx, torch.einsum("ghnm,gnhd->gmhd", ds, q32) * scale)
        dv.index_add_(0, idx, torch.einsum("ghnm,gnhd->gmhd", p, g32))
    dqw = dkw = None
    if q_norm_weight is not None:
        dq, dqw = _rms_backward_plain(qkv[:, :, 0], q_norm_weight, dq)
        dk, dkw = _rms_backward_plain(qkv[:, :, 1], k_norm_weight, dk)
        dqw, dkw = dqw.to(q_norm_weight.dtype), dkw.to(k_norm_weight.dtype)
    return torch.stack([dq, dk, dv], dim=2).to(qkv.dtype), dqw, dkw


def forward_plain(qkv, q_norm_weight, k_norm_weight, kv_perm, scale):
    """``KernelFunction``'s forward with the plain version (CPU tests): with one
    source it saves the output and the rows' log-sum-exp (1, G, H, N), with
    several nothing."""
    G, N, _, H, _ = qkv.shape
    perm = _perm_array(kv_perm, G)
    if perm is not None and perm.shape[0] > 1:
        return fused_qkv_attention_plain(qkv, q_norm_weight, k_norm_weight, kv_perm, scale), ()
    lse = torch.empty((1, G, H, N), dtype=torch.float32, device=qkv.device)
    out = fused_qkv_attention_plain(qkv, q_norm_weight, k_norm_weight, kv_perm, scale, lse=lse)
    return out, (out, lse)


def backward_plain(args, saved, grad):
    """``KernelFunction``'s backward with the plain version (CPU tests)."""
    qkv, qw, kw, kv_perm, scale = args
    lse = saved[1] if saved else None
    return (*fused_qkv_attention_backward_plain(qkv, qw, kw, kv_perm, scale, lse, grad),
            None, None)


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


# ---------------------------------------------------------------- bf16 backward plan

SM_SHARED = 233_472     # shared memory of one H100 SM, all its blocks together
BLOCK_RESERVED = 1_024  # shared memory the runtime keeps for every block
BWD_STAGES = 4          # depth of the backward kernels' ring (wg::kStages)
BWD_GROUPS = 3          # warpgroups a block, each 64 resident rows (wg::kGroups)
BWD_BLOCKS_PER_SM = 1   # what their registers allow (__launch_bounds__(384, 1))
# bf16 head dims the backward's Hopper body (csrc/attn_bwd_sm90.cuh, namespace wg)
# takes -> (padded width of its tiles, width of the dQ / dK / dV products): K1's
# bf16 head dims; K3's 144 runs the mma.sync body
BWD_WIDTH = PADDED_WIDTH


class BwdPlan(NamedTuple):
    dp: int             # padded head dim of the tiles: the depth of S and dP
    dv: int             # width of the dQ, dK and dV products
    q_tiles: int        # 64-row q tiles per (group, head): the pre-pass's tiles
    k_tiles: int        # 64-row key tiles per (group, head)
    dq_blocks: int      # G * H * ceil(q_tiles / BWD_GROUPS): a block takes that many
    #                     tiles (one warpgroup each) and writes a weight-grad partial
    dkdv_blocks: int    # G * H * ceil(k_tiles / BWD_GROUPS)
    dq_smem: int        # dynamic shared memory of one dQ block
    dkdv_smem: int      # ... of one dK/dV block
    scratch_shape: Optional[Tuple[int, ...]]  # with the norm: q and k normalised,
    #                     (2, G, H, q_tiles, dp / 8, 64, 8) bf16; else None


def plan_backward_bf16(G: int, N: int, M: int, H: int, D: int, norm: bool = False) -> BwdPlan:
    """Launch plan of the bf16 backward's Hopper body for q (G, N, H, D) against
    k/v (G, M, H, D); ``norm``: K1's q/k RMSNorm, whose pre-pass tiles q and k of
    one qkv (M == N). A block of ``BWD_GROUPS`` warpgroups holds their tiles (q, dO
    and the output, or k and v: 64 rows a warpgroup) and a ring of ``BWD_STAGES``
    streamed pairs (k and v, or q and dO with the q rows' lse and delta). Raises on
    a head dim the body does not take."""
    if D not in BWD_WIDTH:
        raise ValueError(f"the backward's bf16 Hopper body takes head dims {sorted(BWD_WIDTH)}, "
                         f"got {D}")
    if norm and M != N:
        raise ValueError(f"the normalised tiles are K1's: M must equal N, got {M} != {N}")
    dp, dv = BWD_WIDTH[D]
    q_tiles, k_tiles = -(-N // TILE_ROWS), -(-M // TILE_ROWS)
    dq_blocks = G * H * -(-q_tiles // BWD_GROUPS)
    dkdv_blocks = G * H * -(-k_tiles // BWD_GROUPS)
    if max(dq_blocks, dkdv_blocks) > 2 ** 31 - 1:
        raise ValueError(f"{max(dq_blocks, dkdv_blocks)} blocks exceed the grid limit")
    dq_smem = 2 * (3 * BWD_GROUPS + 2 * BWD_STAGES) * TILE_ROWS * dp
    dkdv_smem = (2 * (2 * BWD_GROUPS + 2 * BWD_STAGES) * TILE_ROWS * dp
                 + 4 * 2 * BWD_STAGES * TILE_ROWS)
    scratch = (2, G, H, q_tiles, dp // 8, TILE_ROWS, 8) if norm else None
    return BwdPlan(dp, dv, q_tiles, k_tiles, dq_blocks, dkdv_blocks, dq_smem, dkdv_smem,
                   scratch)


def tile_qk_plain(qkv: torch.Tensor, q_norm_weight: torch.Tensor,
                  k_norm_weight: torch.Tensor, plan: BwdPlan) -> torch.Tensor:
    """The backward's pre-pass in plain PyTorch: q and k of qkv normalised as the
    forward normalises them (``_rms``), in the plan's tiles (2, G, H, T, dp / 8,
    64, 8): inside a 64-row tile, columns 8c..8c+7 of all its rows, then those of
    c + 1; zero past N and past D."""
    G, N, _, H, D = qkv.shape
    _, _, _, T, C, R, E = plan.scratch_shape
    rows = torch.stack([_rms(qkv[:, :, 0], q_norm_weight), _rms(qkv[:, :, 1], k_norm_weight)])
    padded = rows.new_zeros((2, G, T * R, H, C * E))
    padded[:, :, :N, :, :D] = rows
    return padded.view(2, G, T, R, H, C, E).permute(0, 1, 4, 2, 5, 3, 6).contiguous()


def untile(tiles: torch.Tensor, N: int, D: int) -> torch.Tensor:
    """The rows of the pre-pass's tiles: (2, G, H, T, C, 64, 8) -> (2, G, N, H, D)."""
    P, G, H, T, C, R, E = tiles.shape
    rows = tiles.permute(0, 1, 3, 5, 2, 4, 6).reshape(P, G, T * R, H, C * E)
    return rows[:, :, :N, :, :D]


def _kernels():
    global _fns
    if _fns is None:
        lib = _cuda_build.load("fused_qkv_attention")
        tile = lib.mdv2_k1_tile_k
        tile.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_void_p])
        attend = lib.mdv2_k1_attention
        attend.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        f32 = lib.mdv2_fused_qkv_attention_f32
        f32.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        bwd = lib.mdv2_k1_backward
        bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        bwd_tiles = lib.mdv2_k1_backward_tiles
        bwd_tiles.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                              + [ctypes.c_float, ctypes.c_void_p])
        for fn in (tile, attend, f32, bwd, bwd_tiles):
            fn.restype = ctypes.c_int
        _fns = (tile, attend, f32, bwd, bwd_tiles)
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


def tile_qk(qkv: torch.Tensor, q_norm_weight: torch.Tensor, k_norm_weight: torch.Tensor,
            plan: BwdPlan) -> torch.Tensor:
    """The backward's pre-pass alone (bf16): q and k of qkv normalised, as the
    plan's tiles; on a CPU tensor its plain version."""
    if qkv.device.type == "cpu":
        return tile_qk_plain(qkv, q_norm_weight, k_norm_weight, plan)
    G, N, _, H, D = qkv.shape
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the pre-pass reads a contiguous bf16 qkv in 16-byte pieces")
    qw = _norm_weight(q_norm_weight, D, qkv.device)
    kw = _norm_weight(k_norm_weight, D, qkv.device)
    tiles = torch.empty(plan.scratch_shape, dtype=torch.bfloat16, device=qkv.device)
    with _cuda_build.on_device(qkv) as stream:
        err = _kernels()[4](qkv.data_ptr(), tiles.data_ptr(), qw.data_ptr(), kw.data_ptr(),
                            G, N, H, D, plan.dp, plan.q_tiles, _EPS, stream)
    _cuda_build.check(err, "fused_qkv_attention (backward pre-pass)")
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
        return KernelFunction.apply(_forward, _backward, "fused_qkv_attention", qkv,
                                    q_norm_weight, k_norm_weight, kv_perm, scale)
    return _launch(qkv, q_norm_weight, k_norm_weight, kv_perm, scale)


def inverse_perm(perm: torch.Tensor, G: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (source j, group g) pairs that read each group: ``src`` (J * G,) int32
    holds j * G + g ordered by the group read, then by j * G + g, and the pairs
    reading g' are ``src[off[g']:off[g' + 1]]`` (``off`` (G + 1,) int32). Any index
    array, not only a permutation; on the perm's device, with no sync."""
    flat = perm.reshape(-1).long()
    read, order = torch.sort(flat, stable=True)
    off = torch.searchsorted(read, torch.arange(G + 1, device=perm.device))
    return off.to(torch.int32), order.to(torch.int32)


def _forward(qkv, q_norm_weight, k_norm_weight, kv_perm, scale):
    """The launch under autograd: (out, (out, lse)) with one source, lse (1, G,
    H, N) fp32 (the projection after it keeps the same output, so saving it costs
    nothing); (out, ()) with several, whose statistics the backward takes itself
    (the J > 1 body of the forward kernel is at its 128 registers)."""
    G, N, _, H, _ = qkv.shape
    perm = _perm_tensor(kv_perm, G, qkv.device)
    if perm is not None and perm.shape[0] > 1:
        return _launch(qkv, q_norm_weight, k_norm_weight, perm, scale), ()
    lse = torch.empty((1, G, H, N), dtype=torch.float32, device=qkv.device)
    out = _launch(qkv, q_norm_weight, k_norm_weight, perm, scale, lse)
    return out, (out, lse)


def _backward(args, saved, grad):
    """The backward kernels on the saved inputs: (dqkv, dq_norm_weight,
    dk_norm_weight, None, None)."""
    qkv, q_norm_weight, k_norm_weight, kv_perm, scale = args
    G, N, _, H, D = qkv.shape
    code = _cuda_build.dtype_code(qkv.dtype)
    if (code == 0 and D not in PADDED_WIDTH) or D > _cuda_build.MAX_HEAD_DIM:
        raise ValueError(f"the backward kernel takes head dims {sorted(PADDED_WIDTH)} in "
                         f"bf16 and up to {_cuda_build.MAX_HEAD_DIM} in fp32, got {D}")
    dev = qkv.device
    perm = _perm_tensor(kv_perm, G, dev)
    J = 1 if perm is None else perm.shape[0]
    inv = (None, None) if perm is None else inverse_perm(perm, G)
    qkv = qkv.contiguous()
    grad = grad.contiguous()
    if grad.data_ptr() % 16:
        grad = grad.clone()
    dqkv = torch.empty_like(qkv)
    # one source: the forward's output and lse; several: the dQ kernel's first pass
    # writes lse and delta (and reads no output)
    out, lse = saved if J == 1 else (None, torch.empty((J, G, H, N), dtype=torch.float32,
                                                       device=dev))
    delta = torch.empty((J, G, H, N), dtype=torch.float32, device=dev)
    norm = q_norm_weight is not None
    qw = kw = parts = dw = tiles = None
    plan = plan_backward_bf16(G, N, N, H, D, norm) if code == 0 else None
    if norm:
        qw, kw = _norm_weight(q_norm_weight, D, dev), _norm_weight(k_norm_weight, D, dev)
        # a weight-grad partial for each dQ and dK/dV block (one grid size: M = N)
        blocks = G * H * -(-N // TILE_ROWS) if plan is None else plan.dq_blocks
        parts = torch.empty((2, blocks, D), dtype=torch.float32, device=dev)
        dw = torch.empty((2, D), dtype=torch.float32, device=dev)
        if plan is not None:  # bf16: q and k normalised once, for both kernels
            tiles = tile_qk(qkv, qw, kw, plan)
    views = [t[:, :, i] for t in (qkv, dqkv) for i in range(3)]
    arrays = _cuda_build.backward_args(
        views[:3] + [grad, out] + views[3:] + [
            lse, delta, perm, *inv, qw, kw,
            *((None, None, None, None) if not norm else (parts[0], parts[1], dw[0], dw[1])),
            tiles],
        [G, H, N, N, D, J] + _cuda_build.bwd_strides(*views[:3], grad, grad if out is None
                                                     else out, *views[3:])
        + ([0, 0] if plan is None else [plan.dq_smem, plan.dkdv_smem]),
        [float(scale), _EPS])
    with _cuda_build.on_device(qkv) as stream:
        err = _kernels()[3](*arrays, code, stream)
    _cuda_build.check(err, "fused_qkv_attention (backward)")
    fused_qkv_attention.backward_launches += 1
    if not norm:
        return dqkv, None, None, None, None
    return (dqkv, dw[0].to(q_norm_weight.dtype), dw[1].to(k_norm_weight.dtype), None, None)


def _launch(qkv: torch.Tensor, q_norm_weight: Optional[torch.Tensor],
            k_norm_weight: Optional[torch.Tensor], kv_perm, scale: float,
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One call of the kernel (two launches in bf16) on a CUDA qkv; with ``lse``
    (1, G, H, N) fp32 (one source only) it also writes the rows' log-sum-exp."""
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
    attend, f32 = _kernels()[1:3]
    if bf16:
        tiles = tile_k(qkv, kw, plan)
        with _cuda_build.on_device(qkv) as stream:
            err = attend(qkv.data_ptr(), tiles.data_ptr(), out.data_ptr(), perm_ptr,
                         None if qw is None else qw.data_ptr(),
                         None if lse is None else lse.data_ptr(), G, N, H, D, J,
                         float(scale), _EPS, plan.dp, plan.q_tiles, plan.blocks,
                         plan.smem_bytes, stream)
    else:
        with _cuda_build.on_device(qkv) as stream:
            err = f32(qkv.data_ptr(), out.data_ptr(), perm_ptr,
                      None if qw is None else qw.data_ptr(),
                      None if kw is None else kw.data_ptr(),
                      None if lse is None else lse.data_ptr(),
                      G, N, H, D, J, float(scale), _EPS, stream)
    _cuda_build.check(err, "fused_qkv_attention")
    fused_qkv_attention.launches += 1
    return out.view(G, N, H, D)


fused_qkv_attention.launches = 0
fused_qkv_attention.backward_launches = 0
