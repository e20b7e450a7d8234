"""Layer library of the PyTorch port (counterpart of the JAX package's
models/layers/blocks.py).

Norms run in fp32 and cast back to the compute dtype. Parameter names and
layouts are the reference torch checkpoint's, so a converted state dict loads
with ``strict=True``. Canonical token layout is 4D ``(B, T, S, C)``.

Spatial self-attention and cross-view attention run through
``ops.fused_qkv_attention``; condition cross-attention runs through
``ops.dot_product_attention``. The temporal self-attention is a plain einsum
composition, as it is in the JAX package.

Sequence parallelism (Ulysses): given an ``sp_group``, spatial self-attention
and cross-view attention take tokens split over S, turn the qkv projection
into heads split over the group by one all-to-all, run the kernel on the full S
with H/sp heads, and turn its output back by another. Everything else is per
token and needs no communication.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention
from ...ops.flash_fused import fused_qkv_attention
from ...ops.rope import apply_rope, rope_frequencies, rotate_half_interleaved
from ...parallel.comm import all_to_all


def approx_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def t2i_modulate(x: torch.Tensor, shift, scale) -> torch.Tensor:
    return x * (1 + scale) + shift


def layer_norm_fp32(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm computed in fp32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _rms_apply(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the reference cast points: fp32 normalise, round to the
    compute dtype, multiply by the fp32 weight, round back."""
    dtype = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (weight.float() * x32.to(dtype).float()).to(dtype)


class RMSNorm(nn.Module):
    """LlamaRMSNorm: fp32 inner computation, fp32 weight."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_apply(x, self.weight, self.eps)


class Mlp(nn.Module):
    """timm-style MLP: fc1 -> act -> fc2."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, act=approx_gelu):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class PatchEmbed3D(nn.Module):
    """Video-to-patch embedding via a strided Conv3d. Input (B, C, T, H, W);
    output (B, T'*H'*W', E)."""

    def __init__(self, patch_size: Tuple[int, int, int] = (2, 4, 4), in_chans: int = 3,
                 embed_dim: int = 96, flatten: bool = True):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.embed_dim = embed_dim
        self.flatten = flatten
        self.proj = nn.Conv3d(in_chans, embed_dim, kernel_size=self.patch_size,
                              stride=self.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, D, H, W = x.shape
        pt, ph, pw = self.patch_size
        pad_d, pad_h, pad_w = (-D) % pt, (-H) % ph, (-W) % pw
        if pad_d or pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h, 0, pad_d))
        x = self.proj(x.to(self.proj.weight.dtype))  # (B, E, T', H', W')
        if self.flatten:
            x = x.flatten(2).transpose(1, 2)
        return x


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos|sin] order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(nn.Linear(frequency_embedding_size, hidden_size),
                                 nn.SiLU(), nn.Linear(hidden_size, hidden_size))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(emb.to(self.mlp[0].weight.dtype))


class SizeEmbedder(TimestepEmbedder):
    """Embeds a vector of scalars (e.g. fps) to (B, d*hidden)."""

    def forward(self, s: torch.Tensor, bs: int) -> torch.Tensor:
        if s.ndim == 1:
            s = s[:, None]
        if s.shape[0] != bs:
            s = s.repeat(bs // s.shape[0], 1)
        b, d = s.shape
        emb = timestep_embedding(s.reshape(-1), self.frequency_embedding_size)
        emb = self.mlp(emb.to(self.mlp[0].weight.dtype))
        return emb.reshape(b, d * emb.shape[-1])


class CaptionEmbedder(nn.Module):
    """Caption projection with null-embedding drop for CFG. ``y_embedding`` is a
    buffer, as in the reference."""

    def __init__(self, in_channels: int, hidden_size: int, uncond_prob: float = 0.0,
                 token_num: int = 120):
        super().__init__()
        self.y_proj = Mlp(in_channels, hidden_size, hidden_size)
        self.register_buffer(
            "y_embedding", torch.randn(token_num, in_channels) / in_channels ** 0.5)
        self.uncond_prob = uncond_prob

    def token_drop(self, caption: torch.Tensor, drop_ids: torch.Tensor) -> torch.Tensor:
        drop = drop_ids.bool()[:, None, None, None]
        null = self.y_embedding[: caption.shape[2]].to(caption.dtype)
        return torch.where(drop, null, caption)

    def forward(self, caption: torch.Tensor,
                force_drop_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if force_drop_ids is not None:
            caption = self.token_drop(caption, force_drop_ids)
        return self.y_proj(caption.to(self.y_proj.fc1.weight.dtype))


def pos_embedding_2d(dim: int, h: int, w: int, scale: float = 1.0,
                     base_size: Optional[int] = None, device=None) -> torch.Tensor:
    """2D sincos positional embedding, (1, h*w, dim): channels at grid position
    (i, j) are [sin(gw_j f), cos(gw_j f), sin(gh_i f), cos(gh_i f)]."""
    assert dim % 4 == 0
    half = dim // 2
    inv_freq = 1.0 / (10000 ** (torch.arange(0, half, 2, dtype=torch.float32,
                                             device=device) / half))
    gh = torch.arange(h, dtype=torch.float32, device=device) / scale
    gw = torch.arange(w, dtype=torch.float32, device=device) / scale
    if base_size is not None:
        gh = gh * (base_size / h)
        gw = gw * (base_size / w)

    def sincos(t):
        out = torch.einsum("i,d->id", t, inv_freq)
        return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)

    emb_w = sincos(gw)
    emb_h = sincos(gh)
    emb = torch.cat([emb_w[None, :, :].expand(h, w, half),
                     emb_h[:, None, :].expand(h, w, half)], dim=-1)
    return emb.reshape(1, h * w, dim)


# ---------------------------------------------------------------------------
# Attention modules
# ---------------------------------------------------------------------------


def ulysses_attention(qkv: torch.Tensor, q_norm_weight, k_norm_weight, kv_perm,
                      scale: float, sp_group=None) -> torch.Tensor:
    """``fused_qkv_attention`` on qkv (G, N, 3, H, D) -> (G, N, H, D). With an
    ``sp_group`` of P ranks, N is this rank's block of the sequence: one
    all-to-all makes it (G, P*N, 3, H/P, D), the kernel attends over the whole
    sequence with H/P heads (the q/k norm is per head, kv_perm indexes G), and
    one all-to-all turns the output back to (G, N, H, D)."""
    if sp_group is None:
        return fused_qkv_attention(qkv, q_norm_weight, k_norm_weight, kv_perm, scale)
    qkv = all_to_all(qkv, 3, 1, sp_group)
    out = fused_qkv_attention(qkv, q_norm_weight, k_norm_weight, kv_perm, scale)
    return all_to_all(out, 1, 2, sp_group)


class SelfAttention(nn.Module):
    """Fused-QKV self-attention with optional per-head RMS qk-norm and RoPE.

    Three branches: (B, N, C) without RoPE goes through the fused qkv kernel
    (spatial attention; with ``sp_group`` N is this rank's block of the
    sequence); (B, T, S, C) with RoPE is the temporal einsum attention batched
    over S; (B, N, C) with RoPE is the small temporal transformer of the
    condition embedders.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_norm: bool = False, use_rope: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.use_rope = dim, num_heads, use_rope
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.q_norm = RMSNorm(self.head_dim) if qk_norm else None
        self.k_norm = RMSNorm(self.head_dim) if qk_norm else None
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, kv_mask: Optional[torch.Tensor] = None,
                sp_group=None) -> torch.Tensor:
        """kv_mask: optional (B, N_keys) bool; False keys are excluded from every
        query's softmax (logits set to -1e9). sp_group: the sequence-parallel
        group x's tokens are split over (spatial attention only)."""
        H, D = self.num_heads, self.head_dim
        if x.ndim == 4 and self.use_rope:
            B, T, S, C = x.shape
            qkv = self.qkv(x).reshape(B, T, S, 3, H, D)
            q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
            if self.q_norm is not None:
                q = self.q_norm(q)
                k = self.k_norm(k)
            ang = rope_frequencies(D, T, device=x.device)
            cos = torch.cos(ang).to(q.dtype)[None, :, None, None, :]
            sin = torch.sin(ang).to(q.dtype)[None, :, None, None, :]
            q = q * cos + rotate_half_interleaved(q) * sin
            k = k * cos + rotate_half_interleaved(k) * sin
            logits = torch.einsum("btshd,bushd->bhtus", q.float(), k.float()) * D ** -0.5
            if kv_mask is not None:
                logits = torch.where(kv_mask[:, None, None, :, None], logits,
                                     torch.full_like(logits, -1e9))
            w = torch.softmax(logits, dim=3).to(v.dtype)
            out = torch.einsum("bhtus,bushd->btshd", w, v).reshape(B, T, S, C)
            return self.proj(out)
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, H, D)
        qw = None if self.q_norm is None else self.q_norm.weight
        kw = None if self.k_norm is None else self.k_norm.weight
        if not self.use_rope and kv_mask is None:
            out = ulysses_attention(qkv, qw, kw, None, D ** -0.5, sp_group)
            return self.proj(out.reshape(B, N, C))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if qw is not None:
            q = _rms_apply(q, qw)
            k = _rms_apply(k, kw)
        if self.use_rope:
            q = apply_rope(q.transpose(1, 2)).transpose(1, 2)
            k = apply_rope(k.transpose(1, 2)).transpose(1, 2)
        bias = None
        if kv_mask is not None:
            bias = torch.where(kv_mask[:, None, None, :], 0.0, -1e9).float()
        out = dot_product_attention(q, k, v, scale=D ** -0.5, bias=bias)
        return self.proj(out.reshape(B, N, C))


class CrossViewAttention(nn.Module):
    """Cross-view attention over static camera neighbours: q/k/v projected once
    per camera, one fused-attention call for all neighbours (per-neighbour
    softmax, outputs summed), one output projection of the sum plus
    ``(n_nbr - 1) * bias`` (the reference projects each neighbour's output)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_norm: bool = False):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.q_norm = RMSNorm(self.head_dim) if qk_norm else None
        self.k_norm = RMSNorm(self.head_dim) if qk_norm else None
        self.proj = nn.Linear(dim, dim)
        self._perms = {}

    def _perm(self, Bp: int, NC: int, nbr: np.ndarray, device) -> torch.Tensor:
        key = (Bp, NC, nbr.tobytes(), str(device))
        perm = self._perms.get(key)
        if perm is None:
            base = np.arange(Bp)[:, None] * NC
            arr = np.stack([(base + nbr[None, :, j]).reshape(-1)
                            for j in range(nbr.shape[1])]).astype(np.int32)
            perm = torch.from_numpy(arr).to(device)
            self._perms[key] = perm
        return perm

    def forward(self, x_mv: torch.Tensor, neighbors: Sequence[Sequence[int]],
                sp_group=None) -> torch.Tensor:
        # x_mv: (B', NC, S, C); neighbors: static (NC, n_nbr) index array; with
        # sp_group S is this rank's block (the views, on the batch axis, are whole)
        Bp, NC, S, C = x_mv.shape
        H, D = self.num_heads, self.head_dim
        nbr = np.asarray(neighbors)
        n_nbr = nbr.shape[1]
        qkv = self.qkv(x_mv).reshape(Bp * NC, S, 3, H, D)
        qw = None if self.q_norm is None else self.q_norm.weight
        kw = None if self.k_norm is None else self.k_norm.weight
        out = ulysses_attention(qkv, qw, kw, self._perm(Bp, NC, nbr, x_mv.device),
                                D ** -0.5, sp_group)
        out = self.proj(out.reshape(Bp, NC, S, C))
        if n_nbr > 1 and self.proj.bias is not None:
            out = out + (n_nbr - 1) * self.proj.bias
        return out


class CrossAttention(nn.Module):
    """PixArt-style condition cross-attention over fixed-length condition tokens."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.head_dim = dim // num_heads
        self.q_linear = nn.Linear(dim, dim)
        self.kv_linear = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        Nc = cond.shape[1]
        H, D = self.num_heads, self.head_dim
        q = self.q_linear(x).reshape(B, N, H, D)
        kv = self.kv_linear(cond).reshape(B, Nc, 2, H, D)
        out = dot_product_attention(q, kv[:, :, 0], kv[:, :, 1], scale=D ** -0.5)
        return self.proj(out.reshape(B, N, C))


class SharedKVAttention(nn.Module):
    """Attention through one shared qkv projection: q from x, k and v from
    ``cond`` (x itself without one), optional per-head RMS qk-norm; the product
    through ``ops.dot_product_attention``. No MagicDrive config builds it."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_norm: bool = False):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.q_norm = RMSNorm(self.head_dim) if qk_norm else None
        self.k_norm = RMSNorm(self.head_dim) if qk_norm else None
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, C = x.shape
        H, D = self.num_heads, self.head_dim
        cond = x if cond is None else cond
        w, b = self.qkv.weight, self.qkv.bias
        q = F.linear(x, w[:C], None if b is None else b[:C]).reshape(B, N, H, D)
        kv = F.linear(cond, w[C:], None if b is None else b[C:])
        kv = kv.reshape(B, cond.shape[1], 2, H, D)
        k, v = kv[:, :, 0], kv[:, :, 1]
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        out = dot_product_attention(q, k, v, scale=D ** -0.5)
        return self.proj(out.reshape(B, N, C))


class LabelEmbedder(nn.Module):
    """Class-label embedding; with ``dropout_prob`` > 0 the table holds one more
    row, the null label that ``force_drop_ids`` selects. No MagicDrive config
    builds it."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float = 0.0):
        super().__init__()
        self.num_classes = num_classes
        self.embedding_table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, labels: torch.Tensor,
                force_drop_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if force_drop_ids is not None:
            labels = torch.where(force_drop_ids.bool(), self.num_classes, labels)
        return self.embedding_table(labels)


class FinalLayer(nn.Module):
    """Plain (not adaLN) final projection: affine-free fp32 LayerNorm, then one
    linear layer. No MagicDrive config builds it."""

    def __init__(self, hidden_size: int, num_patch: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden_size, num_patch * out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(layer_norm_fp32(x))


def t_mask_select(x_mask: torch.Tensor, x: torch.Tensor, masked_x: torch.Tensor,
                  T: int, S: int) -> torch.Tensor:
    """Frame-conditioned select. x/masked_x: (B, T*S, C), x_mask: (B, T) bool."""
    B, N, C = x.shape
    out = torch.where(x_mask[:, :, None, None], x.reshape(B, T, S, C),
                      masked_x.reshape(B, T, S, C))
    return out.reshape(B, N, C)


class T2IFinalLayer(nn.Module):
    """Final adaLN projection."""

    def __init__(self, hidden_size: int, num_patch: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden_size, num_patch * out_channels)
        self.scale_shift_table = nn.Parameter(
            torch.randn(2, hidden_size) / hidden_size ** 0.5)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                x_mask: Optional[torch.Tensor] = None, t0: Optional[torch.Tensor] = None,
                T: Optional[int] = None, S: Optional[int] = None) -> torch.Tensor:
        # x: (B, T*S, C); t: (B, C)
        table = self.scale_shift_table.to(x.dtype)
        shift, scale = (table[None] + t[:, None]).unbind(dim=1)
        normed = layer_norm_fp32(x)
        out = t2i_modulate(normed, shift[:, None, :], scale[:, None, :])
        if x_mask is not None:
            shift0, scale0 = (table[None] + t0[:, None]).unbind(dim=1)
            out0 = t2i_modulate(normed, shift0[:, None, :], scale0[:, None, :])
            out = t_mask_select(x_mask, out, out0, T, S)
        return self.linear(out)
