"""Condition embedders: 3D boxes, camera poses, ego motion, BEV maps
(counterpart of the JAX package's models/magicdrive/embedder.py).

Parameter names follow the reference torch checkpoint: the temporal
mini-transformer's ``attn`` / ``mlp`` / ``scale_shift_table`` sit directly on
the embedder that owns it.

Mask conventions:
  null_mask: 0 -> "really no box" (padding) -> learned null feature
  mask:      0 -> box exists but hidden (dropout / visibility) -> learned mask feature
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.blocks import Mlp, SelfAttention, layer_norm_fp32, t2i_modulate

XYZ_MIN = (-200.0, -300.0, -20.0)
XYZ_RANGE = (350.0, 650.0, 80.0)


def normalizer(mode: str, data: torch.Tensor) -> torch.Tensor:
    """Min-max normalize box corners."""
    if mode in ("cxyz", "all-xyz"):
        lo = torch.tensor(XYZ_MIN, dtype=data.dtype, device=data.device)
        rng = torch.tensor(XYZ_RANGE, dtype=data.dtype, device=data.device)
        return (data - lo) / rng
    raise NotImplementedError(mode)


def fourier_embed(x: torch.Tensor, num_freqs: int, include_input: bool = True,
                  log_sampling: bool = True) -> torch.Tensor:
    """NeRF-style frequency embedding: [x, sin(x*f0), cos(x*f0), sin(x*f1), ...]
    with f_k = 2^k for log sampling."""
    outs = [x] if include_input else []
    if log_sampling:
        freqs = 2.0 ** torch.linspace(0.0, num_freqs - 1, num_freqs)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (num_freqs - 1), num_freqs)
    for f in freqs.tolist():
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


def fourier_out_dim(input_dims: int, num_freqs: int, include_input: bool = True) -> int:
    return input_dims * ((1 if include_input else 0) + 2 * num_freqs)


def cog_temp_down(x: torch.Tensor) -> torch.Tensor:
    """CogVideoX temporal halving: odd T keeps the first frame, the rest
    avg-pool by 2. x: (B, T, N, D)."""
    T = x.shape[1]
    if T % 2 == 1:
        first, rest = x[:, :1], x[:, 1:]
        if rest.shape[1] > 0:
            rest = (rest[:, 0::2] + rest[:, 1::2]) / 2
            return torch.cat([first, rest], dim=1)
        return first
    return (x[:, 0::2] + x[:, 1::2]) / 2


def make_time_downsampler(factor) -> Callable[..., torch.Tensor]:
    """factor -1: (masked) mean; 4.5: cog x2; 0: identity. ``valid``: optional
    (B, T) frame-validity mask for clips padded to a bucket length."""
    if factor == -1:
        def mean_down(x, valid=None):
            if valid is None:
                return x.mean(dim=1, keepdim=True)
            v = valid.to(x.dtype).reshape(valid.shape + (1,) * (x.ndim - 2))
            return (x * v).sum(dim=1, keepdim=True) / \
                v.sum(dim=1, keepdim=True).clamp(min=1.0)
        return mean_down
    if factor == 4.5:
        return lambda x, valid=None: cog_temp_down(cog_temp_down(x))
    if factor == 0:
        return lambda x, valid=None: x
    raise NotImplementedError(factor)


class _TemporalMixin:
    """RoPE attention + MLP over the time axis, shared by the temporal bbox and
    camera embedders. Input (B', T, D)."""

    def _init_temporal(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                       qk_norm: bool, use_scale_shift_table: bool):
        self.attn = SelfAttention(hidden_size, num_heads, qkv_bias=True,
                                  qk_norm=qk_norm, use_rope=True)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        if use_scale_shift_table:
            self.scale_shift_table = nn.Parameter(
                torch.randn(6, hidden_size) / hidden_size ** 0.5)
        else:
            self.scale_shift_table = None

    def temporal_block(self, x: torch.Tensor,
                       kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.scale_shift_table is not None:
            table = self.scale_shift_table.to(x.dtype)
            sh_mha, sc_mha, g_mha, sh_mlp, sc_mlp, g_mlp = table[:, None, :].unbind(0)
        else:
            sh_mha = sc_mha = sh_mlp = sc_mlp = 0.0
            g_mha = g_mlp = 1.0
        x_m = t2i_modulate(layer_norm_fp32(x), sh_mha, sc_mha)
        x = x + g_mha * self.attn(x_m, kv_mask=kv_mask)
        x_m = t2i_modulate(layer_norm_fp32(x), sh_mlp, sc_mlp)
        return x + g_mlp * self.mlp(x_m)


class TemporalTransformerBlock(nn.Module, _TemporalMixin):
    """Stand-alone form of the temporal block (the JAX package's module of the
    same name, whose parameters nest under ``temp``)."""

    def __init__(self, hidden_size: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 qk_norm: bool = False, use_scale_shift_table: bool = False):
        super().__init__()
        self._init_temporal(hidden_size, num_heads, mlp_ratio, qk_norm,
                            use_scale_shift_table)

    def forward(self, x, kv_mask=None):
        return self.temporal_block(x, kv_mask)


class ContinuousBBoxWithTextEmbedding(nn.Module):
    """Per-box token from Fourier corner coords + class token."""

    _base_after_proj = True

    def __init__(self, n_classes: int, class_token_dim: int = 768,
                 trainable_class_token: bool = False, embedder_num_freq: int = 4,
                 proj_dims: Sequence[int] = (768, 512, 512, 768), mode: str = "cxyz",
                 minmax_normalize: bool = True, use_text_encoder_init: bool = True,
                 after_proj: bool = False, sample_id: bool = False, **_unused):
        super().__init__()
        self.mode = mode
        self.n_corners = {"cxyz": 4, "all-xyz": 8}[mode]
        self.embedder_num_freq = embedder_num_freq
        self.minmax_normalize = minmax_normalize
        self.sample_id = sample_id
        self.use_after_proj = after_proj
        self.proj_dims = tuple(proj_dims)
        pos_dim = fourier_out_dim(3, embedder_num_freq) * self.n_corners
        self.bbox_proj = nn.Linear(pos_dim, proj_dims[0])
        self.second_linear = nn.Sequential(
            nn.Linear(proj_dims[0] + class_token_dim, proj_dims[1]), nn.SiLU(),
            nn.Linear(proj_dims[1], proj_dims[2]), nn.SiLU(),
            nn.Linear(proj_dims[2], proj_dims[3]))
        self.register_buffer("_class_tokens", torch.randn(n_classes, class_token_dim))
        if sample_id:
            self.mean_var = nn.Parameter(torch.randn(n_classes, 2))
        self.null_class_feature = nn.Parameter(torch.zeros(class_token_dim))
        self.null_pos_feature = nn.Parameter(torch.zeros(pos_dim))
        self.mask_class_feature = nn.Parameter(torch.zeros(class_token_dim))
        self.mask_pos_feature = nn.Parameter(torch.zeros(pos_dim))
        if after_proj and self._base_after_proj:
            self.after_proj = nn.Linear(proj_dims[-1], proj_dims[-1])

    @property
    def _dtype(self):
        return self.bbox_proj.weight.dtype

    def forward_feature(self, pos_emb: torch.Tensor, cls_emb: torch.Tensor) -> torch.Tensor:
        emb = F.silu(self.bbox_proj(pos_emb))
        emb = torch.cat([emb, cls_emb.to(emb.dtype)], dim=-1)
        return self.second_linear(emb)

    def embed_boxes(self, bboxes, classes, null_mask=None, mask=None, box_latent=None):
        """bboxes: (B, N, n_corners, 3); classes: (B, N) int; masks: (B, N) in {0,1}.
        Returns (B, N, proj_dims[-1])."""
        B, N = classes.shape
        dt = self._dtype
        flat = bboxes.reshape(B * N, self.n_corners, 3)

        def prep_mask(m):
            if m is None:
                m = torch.ones((B * N,), dtype=torch.float32, device=flat.device)
            return m.reshape(B * N, 1).to(dt)

        mask = prep_mask(mask)
        null_mask = prep_mask(null_mask)
        if self.minmax_normalize:
            flat = normalizer(self.mode, flat)
        pos = fourier_embed(flat, self.embedder_num_freq).reshape(B * N, -1).to(dt)
        null_pos = self.null_pos_feature[None].to(dt)
        mask_pos = self.mask_pos_feature[None].to(dt)
        pos = pos * null_mask + null_pos * (1 - null_mask)
        pos = pos * mask + mask_pos * (1 - mask)

        cls = self._class_tokens[classes.reshape(-1)].to(dt)
        if self.sample_id:
            mv = self.mean_var[classes.reshape(-1)].float()
            mu, logvar = mv[:, :1], mv[:, 1:]
            std = torch.exp(0.5 * logvar)
            assert box_latent is not None, "sample_id requires box_latent"
            lat = box_latent.reshape(B * N, -1).float()
            cls = cls + (lat * std + mu).to(dt)
        null_cls = self.null_class_feature[None].to(dt)
        mask_cls = self.mask_class_feature[None].to(dt)
        cls = cls * null_mask + null_cls * (1 - null_mask)
        cls = cls * mask + mask_cls * (1 - mask)

        emb = self.forward_feature(pos, cls).reshape(B, N, -1)
        if self.use_after_proj and self._base_after_proj:
            emb = self.after_proj(emb)
        return emb

    def forward(self, bboxes, classes, null_mask=None, mask=None, box_latent=None):
        return self.embed_boxes(bboxes, classes, null_mask, mask, box_latent)


class ContinuousBBoxWithTextTempEmbedding(ContinuousBBoxWithTextEmbedding, _TemporalMixin):
    """Temporal variant: per-box token sequence over T frames -> temporal
    transformer -> temporal downsample to latent frames."""

    _base_after_proj = False

    def __init__(self, *args, num_heads: int = 8, mlp_ratio: float = 4.0,
                 qk_norm: bool = False, use_scale_shift_table: bool = False,
                 time_downsample_factor: Any = -1, **kwargs):
        super().__init__(*args, **kwargs)
        hidden = self.proj_dims[-1]
        self._init_temporal(hidden, num_heads, mlp_ratio, qk_norm, use_scale_shift_table)
        if self.use_after_proj:
            self.final_proj = nn.Linear(hidden, hidden)
        self.downsampler = make_time_downsampler(time_downsample_factor)

    def forward(self, bboxes, classes, null_mask=None, mask=None, box_latent=None,
                frame_valid=None):
        """bboxes: (B, T, N, n_corners, 3); classes, masks: (B, T, N); frame_valid:
        optional (B, T) bool. Returns (B, T_latent, N, D)."""
        B, T, N = classes.shape
        flat = lambda a: None if a is None else a.reshape((B * T,) + a.shape[2:])
        emb = self.embed_boxes(bboxes.reshape(B * T, N, self.n_corners, 3),
                               classes.reshape(B * T, N), flat(null_mask), flat(mask),
                               flat(box_latent))
        D = emb.shape[-1]
        emb = emb.reshape(B, T, N, D).transpose(1, 2).reshape(B * N, T, D)
        kv_mask = None
        if frame_valid is not None:
            kv_mask = frame_valid.bool()[:, None].expand(B, N, T).reshape(B * N, T)
        emb = self.temporal_block(emb, kv_mask=kv_mask)
        emb = emb.reshape(B, N, T, D).transpose(1, 2)
        if self.use_after_proj:
            emb = self.final_proj(emb)
        return self.downsampler(emb, valid=frame_valid)


class CamEmbedder(nn.Module):
    """Camera intrinsics+extrinsics token."""

    def __init__(self, input_dim: int, out_dim: int, num: int = 7, num_freqs: int = 4,
                 include_input: bool = True, log_sampling: bool = True,
                 after_proj: bool = False, **_unused):
        super().__init__()
        self.input_dim, self.out_dim, self.num = input_dim, out_dim, num
        self.num_freqs, self.include_input = num_freqs, include_input
        self.log_sampling = log_sampling
        self.use_after_proj = after_proj
        self.emb2token = nn.Linear(
            fourier_out_dim(input_dim, num_freqs, include_input) * num, out_dim)
        self.uncond_cam = nn.Parameter(torch.randn(input_dim, num))
        self._init_tail()

    def _init_tail(self):
        if self.use_after_proj:
            self.after_proj = nn.Linear(self.out_dim, self.out_dim)

    def _token(self, param: torch.Tensor, mask: Optional[torch.Tensor]):
        if param.shape[1] == 4:
            param = param[:, :-1]
        bs = param.shape[0]
        if mask is not None:
            param = torch.where((mask > 0)[:, None, None], param,
                                self.uncond_cam[None].to(param.dtype))
        cols = param.transpose(1, 2).reshape(bs * self.num, self.input_dim)
        emb = fourier_embed(cols, self.num_freqs, self.include_input, self.log_sampling)
        emb = emb.reshape(bs, -1).to(self.emb2token.weight.dtype)
        return self.emb2token(emb), emb

    def embed_cam(self, param: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """param: (N, 3, num) or (N, 4, num); mask: (N,), >0 keeps, else uncond."""
        token, emb = self._token(param, mask)
        if self.use_after_proj:
            token = self.after_proj(token)
        return token, emb

    def forward(self, param, mask=None):
        return self.embed_cam(param, mask)[0]


class CamEmbedderTemp(CamEmbedder, _TemporalMixin):
    """Ego-motion (frame) embedder: camera token + temporal transformer +
    downsample."""

    def __init__(self, *args, num_heads: int = 8, mlp_ratio: float = 4.0,
                 qk_norm: bool = False, use_scale_shift_table: bool = False,
                 time_downsample_factor: Any = -1, **kwargs):
        self._temp_args = (num_heads, mlp_ratio, qk_norm, use_scale_shift_table)
        super().__init__(*args, **kwargs)
        self.downsampler = make_time_downsampler(time_downsample_factor)

    def _init_tail(self):
        self._init_temporal(self.out_dim, *self._temp_args)
        if self.use_after_proj:
            self.final_proj = nn.Linear(self.out_dim, self.out_dim)

    def embed_cam(self, param, mask=None, T=None, S=None, frame_valid=None):
        token, emb = self._token(param, mask)
        D = token.shape[-1]
        b = param.shape[0] // (T * S)
        token = token.reshape(b, T, S, D).transpose(1, 2).reshape(b * S, T, D)
        kv_mask = None
        if frame_valid is not None:
            kv_mask = frame_valid.bool()[:, None].expand(b, S, T).reshape(b * S, T)
        token = self.temporal_block(token, kv_mask=kv_mask)
        token = token.reshape(b, S, T, D).transpose(1, 2)
        if self.use_after_proj:
            token = self.final_proj(token)
        return self.downsampler(token, valid=frame_valid), emb


class MapControlEmbedding(nn.Module):
    """ControlNet-style conv pyramid encoding the BEV map. Input (B, C_map, H, W);
    output (B, emb_ch, H', W')."""

    def __init__(self, conditioning_embedding_channels: int = 320,
                 conditioning_size: Sequence[int] = (25, 200, 200),
                 block_out_channels: Sequence[int] = (32, 64, 128, 256), **_unused):
        super().__init__()
        bo = list(block_out_channels)
        self.conv_in = nn.Conv2d(conditioning_size[0], bo[0], 3, padding=1)
        blocks = []
        for i in range(len(bo) - 2):
            blocks.append(nn.Conv2d(bo[i], bo[i], 3, padding=1))
            blocks.append(nn.Conv2d(bo[i], bo[i + 1], 3, stride=2, padding=(2, 1)))
        blocks.append(nn.Conv2d(bo[-2], bo[-2], 3, padding=(2, 1)))
        blocks.append(nn.Conv2d(bo[-2], bo[-1], 3, stride=(2, 1), padding=(2, 1)))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(bo[-1], conditioning_embedding_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(cond.to(self.conv_in.weight.dtype)))
        for blk in self.blocks:
            x = F.silu(blk(x))
        return self.conv_out(x)


class CausalConv3d(nn.Module):
    """Causal 3D conv: front-only time padding. Input/output (B, C, T, H, W)."""

    def __init__(self, chan_in: int, chan_out: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3), time_stride: int = 1):
        super().__init__()
        kt, kh, kw = kernel_size
        self.pad = (kw // 2, kw // 2, kh // 2, kh // 2, (kt - 1) + (1 - time_stride), 0)
        self.conv = nn.Conv3d(chan_in, chan_out, kernel_size,
                              stride=(time_stride, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, self.pad).to(self.conv.weight.dtype))


class CogDownsample3D(nn.Module):
    """CogVideoX downsample block with the ZeroPad2d(1, 0, 1, 0) pre-pad fused
    in. Input/output (B, C, T, H, W); stride 1 keeps H, W; compress_time halves T
    cog-style."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 compress_time: bool = True):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        x = F.pad(x, (1, 0, 1, 0))  # W left+1, H top+1
        H, W = H + 1, W + 1
        if self.compress_time:
            t = x.permute(0, 2, 3, 4, 1).reshape(B, T, H * W, C)
            t = cog_temp_down(t)
            T = t.shape[1]
            x = t.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)
        x = F.pad(x, (0, 1, 0, 1))  # W right+1, H bottom+1
        x = x.permute(0, 2, 1, 3, 4).reshape(B * T, C, H + 1, W + 1)
        x = self.conv(x.to(self.conv.weight.dtype))
        Ho, Wo = x.shape[-2:]
        return x.reshape(B, T, -1, Ho, Wo).permute(0, 2, 1, 3, 4)


class MapControlTempEmbedding(nn.Module):
    """Temporal compression of map features. Input/output (B, C, T, H, W)."""

    def __init__(self, hidden_size: int, time_downsample_factor: Any = 4):
        super().__init__()
        h = hidden_size
        self.time_downsample_factor = time_downsample_factor
        if time_downsample_factor in (4, 1):
            ts = 2 if time_downsample_factor == 4 else 1
            self.conv_blocks = nn.ModuleList([
                CausalConv3d(h // 2, h // 2, (3, 3, 3), time_stride=ts),
                CausalConv3d(h // 2, h, (3, 3, 3), time_stride=ts)])
        elif time_downsample_factor == 4.5:
            # indices 1 and 3: the reference interleaves parameter-free pads
            self.conv_blocks = nn.ModuleDict({
                "1": CogDownsample3D(h // 2, h // 2, stride=1, compress_time=True),
                "3": CogDownsample3D(h // 2, h, stride=1, compress_time=True)})
        else:
            raise NotImplementedError(time_downsample_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.time_downsample_factor == 4.5:
            return self.conv_blocks["3"](self.conv_blocks["1"](x))
        if self.time_downsample_factor == 4:
            pad = (-x.shape[2]) % 4
            if pad:
                x = F.pad(x, (0, 0, 0, 0, pad, 0))
        return self.conv_blocks[1](self.conv_blocks[0](x))
