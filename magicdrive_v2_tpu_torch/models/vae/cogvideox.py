"""CogVideoX 3D causal VAE of the port (counterpart of the JAX package's
models/vae/cogvideox.py), in PyTorch idiom: NCDHW tensors, ``nn.Module``s whose
state-dict keys are the diffusers ``AutoencoderKLCogVideoX`` names.

Two paths through every module, as in the JAX package:

- full sequence: one call over all frames;
- streaming: frames go through in chunks and each causal conv carries its last
  ``k_t - 1`` input frames to the next chunk. The carried frames live in a
  ``cache`` dict that the caller makes fresh for each stream (one view of a
  micro-batch, one tile) and threads through the forward calls; nothing is kept
  on the modules, so no state leaks from one call to the next.

GroupNorm statistics are taken over each chunk's frames, so a streamed decode
differs from a full-sequence one at that level, exactly as the JAX package's (and
the reference's) chunked path does.

Cast points (``CogVAEConfig.dtype`` = bf16): convolutions compute in bf16 (their
weights are stored in bf16), GroupNorm computes its statistics and affine in fp32
from fp32 parameters and rounds once on output, SiLU and the residual add run in
bf16.

The convolutions are cuDNN's (``F.conv3d``): the JAX VAE's are XLA convolutions,
not Pallas kernels, so this module has no hand-written kernel.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import MODELS
from ...utils.misc import resolve_device

logger = logging.getLogger(__name__)

Cache = Optional[Dict[nn.Module, torch.Tensor]]


class CausalConv3d(nn.Module):
    """Causal 3D conv: time front-padded with the replicated first frame, space
    zero-padded by the convolution itself. With a ``cache`` the last ``k_t - 1``
    input frames are carried to the next chunk; the first chunk of a stream (no
    entry yet) replicates its first frame."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3), stride: int = 1,
                 dilation: int = 1, dtype=torch.float32):
        super().__init__()
        kt, kh, kw = kernel_size
        self.time_pad = dilation * (kt - 1)
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size,
                              stride=(stride, 1, 1), dilation=(dilation, 1, 1),
                              padding=(0, kh // 2, kw // 2), dtype=dtype)

    def forward(self, x: torch.Tensor, cache: Cache = None) -> torch.Tensor:
        if self.time_pad > 0:
            prev = None if cache is None else cache.get(self)
            if prev is None:
                prev = x[:, :, :1].expand(-1, -1, self.time_pad, -1, -1)
            x = torch.cat([prev.to(x.dtype), x], dim=2)
            if cache is not None:
                cache[self] = x[:, :, -self.time_pad:].clone()
        return self.conv(x.to(self.conv.weight.dtype))


class GroupNorm(nn.GroupNorm):
    """GroupNorm over (C-group, T, H, W) in fp32 with fp32 parameters; the result
    is rounded once to the input's dtype. The statistics come from one reduction
    over each group (``F.group_norm``'s CUDA kernel gives a group one thread
    block, 32 blocks for a whole view at 424x800), then ``x * a + b`` with the
    per-channel ``a = w / std`` and ``b = bias - mean * a``, as ``F.group_norm``
    applies them."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        x32 = x.float()
        var, mean = torch.var_mean(x32.view(n, self.num_groups, -1), dim=2, unbiased=False)
        per_group = c // self.num_groups
        a = torch.rsqrt(var + self.eps).repeat_interleave(per_group, 1) * self.weight.float()
        b = self.bias.float() - mean.repeat_interleave(per_group, 1) * a
        shape = (n, c) + (1,) * (x.dim() - 2)
        return torch.addcmul(b.view(shape), x32, a.view(shape)).to(x.dtype)


def _nearest_resize_time(z: torch.Tensor, t_out: int) -> torch.Tensor:
    """Nearest resize along time with the floor index ``i * t_in // t_out``."""
    t_in = z.shape[2]
    if t_in == t_out:
        return z
    idx = torch.from_numpy(np.arange(t_out) * t_in // t_out).to(z.device)
    return z.index_select(2, idx)


def _nearest_resize_hw(z: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    h_in, w_in = z.shape[3], z.shape[4]
    if (h_in, w_in) == (h_out, w_out):
        return z
    hi = torch.from_numpy(np.arange(h_out) * h_in // h_out).to(z.device)
    wi = torch.from_numpy(np.arange(w_out) * w_in // w_out).to(z.device)
    return z.index_select(3, hi).index_select(4, wi)


class SpatialNorm3D(nn.Module):
    """Latent-conditioned normalization: zq is nearest-resized to f's shape, the
    first frame on its own when f has an odd number of frames above one."""

    def __init__(self, f_channels: int, zq_channels: int, groups: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.norm_layer = GroupNorm(groups, f_channels)
        self.conv_y = CausalConv3d(zq_channels, f_channels, (1, 1, 1), dtype=dtype)
        self.conv_b = CausalConv3d(zq_channels, f_channels, (1, 1, 1), dtype=dtype)

    def forward(self, f: torch.Tensor, zq: torch.Tensor, cache: Cache = None):
        Tf, Hf, Wf = f.shape[2:]
        if Tf > 1 and Tf % 2 == 1:
            z_first = _nearest_resize_hw(_nearest_resize_time(zq[:, :, :1], 1), Hf, Wf)
            z_rest = _nearest_resize_hw(_nearest_resize_time(zq[:, :, 1:], Tf - 1), Hf, Wf)
            zq = torch.cat([z_first, z_rest], dim=2)
        else:
            zq = _nearest_resize_hw(_nearest_resize_time(zq, Tf), Hf, Wf)
        return self.norm_layer(f) * self.conv_y(zq, cache) + self.conv_b(zq, cache)


class ResnetBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-6,
                 spatial_norm_dim: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        out_channels = out_channels or in_channels
        self.spatial = spatial_norm_dim is not None
        if self.spatial:
            self.norm1 = SpatialNorm3D(in_channels, spatial_norm_dim, groups, dtype)
            self.norm2 = SpatialNorm3D(out_channels, spatial_norm_dim, groups, dtype)
        else:
            self.norm1 = GroupNorm(groups, in_channels, eps)
            self.norm2 = GroupNorm(groups, out_channels, eps)
        self.conv1 = CausalConv3d(in_channels, out_channels, dtype=dtype)
        self.conv2 = CausalConv3d(out_channels, out_channels, dtype=dtype)
        self.conv_shortcut = (nn.Conv3d(in_channels, out_channels, 1, dtype=dtype)
                              if in_channels != out_channels else None)

    def _norm(self, norm, h, zq, cache):
        return norm(h, zq, cache) if self.spatial else norm(h)

    def forward(self, x: torch.Tensor, zq: Optional[torch.Tensor] = None,
                cache: Cache = None) -> torch.Tensor:
        h = self.conv1(F.silu(self._norm(self.norm1, x, zq, cache)), cache)
        h = self.conv2(F.silu(self._norm(self.norm2, h, zq, cache)), cache)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x.to(self.conv_shortcut.weight.dtype))
        return h + x


def _conv_per_frame(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1,
                    padding: int = 0) -> torch.Tensor:
    """A 2D conv applied to every frame of (B, C, T, H, W), as a (1, kh, kw) 3D conv
    (no frame-major copy of the activations)."""
    w = conv.weight
    return F.conv3d(x.to(w.dtype), w.unsqueeze(2), conv.bias, stride=(1, stride, stride),
                    padding=(0, padding, padding))


class Downsample3D(nn.Module):
    """compress_time: time average of frame pairs (the first frame kept alone when
    the count is odd); then a bottom/right zero pad and a 3x3 stride-2 conv per
    frame."""

    def __init__(self, in_channels: int, out_channels: int, compress_time: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(in_channels, out_channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[2]
        if self.compress_time and T > 1:
            if T % 2 == 1:
                rest = x[:, :, 1:]
                x = torch.cat([x[:, :, :1], (rest[:, :, 0::2] + rest[:, :, 1::2]) / 2], 2)
            else:
                x = (x[:, :, 0::2] + x[:, :, 1::2]) / 2
        return _conv_per_frame(self.conv, F.pad(x, (0, 1, 0, 1)), stride=2)


class Upsample3D(nn.Module):
    """Nearest 2x upsample in H and W (and in time under compress_time, the first
    frame kept single when the count is odd), then a 3x3 conv per frame."""

    def __init__(self, in_channels: int, out_channels: int, compress_time: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[2]
        if self.compress_time and T > 1 and T % 2 == 1:
            first = F.interpolate(x[:, :, :1], scale_factor=(1, 2, 2), mode="nearest")
            rest = F.interpolate(x[:, :, 1:], scale_factor=(2, 2, 2), mode="nearest")
            x = torch.cat([first, rest], dim=2)
        elif self.compress_time and T > 1:
            x = F.interpolate(x, scale_factor=(2, 2, 2), mode="nearest")
        else:
            x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
        return _conv_per_frame(self.conv, x, padding=1)


class DownBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 3,
                 groups: int = 32, add_downsample: bool = True,
                 compress_time: bool = False, dtype=torch.float32):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock3D(in_channels if i == 0 else out_channels, out_channels, groups,
                          dtype=dtype) for i in range(num_layers))
        self.downsamplers = nn.ModuleList(
            [Downsample3D(out_channels, out_channels, compress_time, dtype)]
            if add_downsample else [])

    def forward(self, x: torch.Tensor, cache: Cache = None) -> torch.Tensor:
        for r in self.resnets:
            x = r(x, None, cache)
        for d in self.downsamplers:
            x = d(x)
        return x


class MidBlock3D(nn.Module):
    def __init__(self, in_channels: int, num_layers: int = 2, groups: int = 32,
                 spatial_norm_dim: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock3D(in_channels, in_channels, groups, spatial_norm_dim=spatial_norm_dim,
                          dtype=dtype) for _ in range(num_layers))

    def forward(self, x: torch.Tensor, zq: Optional[torch.Tensor] = None,
                cache: Cache = None) -> torch.Tensor:
        for r in self.resnets:
            x = r(x, zq, cache)
        return x


class UpBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 4,
                 groups: int = 32, spatial_norm_dim: int = 16, add_upsample: bool = True,
                 compress_time: bool = False, dtype=torch.float32):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock3D(in_channels if i == 0 else out_channels, out_channels, groups,
                          spatial_norm_dim=spatial_norm_dim, dtype=dtype)
            for i in range(num_layers))
        self.upsamplers = nn.ModuleList(
            [Upsample3D(out_channels, out_channels, compress_time, dtype)]
            if add_upsample else [])

    def forward(self, x: torch.Tensor, zq: torch.Tensor, cache: Cache = None):
        for r in self.resnets:
            x = r(x, zq, cache)
        for u in self.upsamplers:
            x = u(x)
        return x


@dataclasses.dataclass(frozen=True)
class CogVAEConfig:
    """CogVideoX-2b's VAE by default; ``dtype`` is the convolutions' type."""
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    latent_channels: int = 16
    layers_per_block: int = 3
    norm_num_groups: int = 32
    temporal_compression_ratio: int = 4
    scaling_factor: float = 1.15258426
    dtype: Any = torch.float32


class CogVideoXEncoder3D(nn.Module):
    def __init__(self, cfg: CogVAEConfig):
        super().__init__()
        level = int(np.log2(cfg.temporal_compression_ratio))
        ch, dt, g = cfg.block_out_channels, cfg.dtype, cfg.norm_num_groups
        self.conv_in = CausalConv3d(cfg.in_channels, ch[0], dtype=dt)
        self.down_blocks = nn.ModuleList(
            DownBlock3D(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block, g,
                        add_downsample=i != len(ch) - 1, compress_time=i < level, dtype=dt)
            for i in range(len(ch)))
        self.mid_block = MidBlock3D(ch[-1], 2, g, dtype=dt)
        self.norm_out = GroupNorm(g, ch[-1])
        self.conv_out = CausalConv3d(ch[-1], 2 * cfg.latent_channels, dtype=dt)

    def forward(self, x: torch.Tensor, cache: Cache = None) -> torch.Tensor:
        x = self.conv_in(x, cache)
        for blk in self.down_blocks:
            x = blk(x, cache)
        x = self.mid_block(x, None, cache)
        return self.conv_out(F.silu(self.norm_out(x)), cache)


class CogVideoXDecoder3D(nn.Module):
    def __init__(self, cfg: CogVAEConfig):
        super().__init__()
        level = int(np.log2(cfg.temporal_compression_ratio))
        rev = list(reversed(cfg.block_out_channels))
        dt, g, zc = cfg.dtype, cfg.norm_num_groups, cfg.latent_channels
        self.conv_in = CausalConv3d(zc, rev[0], dtype=dt)
        self.mid_block = MidBlock3D(rev[0], 2, g, spatial_norm_dim=zc, dtype=dt)
        self.up_blocks = nn.ModuleList(
            UpBlock3D(rev[max(i - 1, 0)], rev[i], cfg.layers_per_block + 1, g,
                      spatial_norm_dim=zc, add_upsample=i != len(rev) - 1,
                      compress_time=i < level, dtype=dt)
            for i in range(len(rev)))
        self.norm_out = SpatialNorm3D(rev[-1], zc, g, dtype=dt)
        self.conv_out = CausalConv3d(rev[-1], cfg.out_channels, dtype=dt)

    def forward(self, z: torch.Tensor, cache: Cache = None) -> torch.Tensor:
        x = self.conv_in(z, cache)
        x = self.mid_block(x, z, cache)
        for blk in self.up_blocks:
            x = blk(x, z, cache)
        return self.conv_out(F.silu(self.norm_out(x, z, cache)), cache)


class DiagonalGaussian:
    """The posterior N(mean, exp(logvar)) of (B, 2*latent, ...) moments."""

    def __init__(self, parameters: torch.Tensor, dim: int = 1):
        self.mean, logvar = parameters.chunk(2, dim=dim)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mean + std * noise``; the noise is drawn from ``generator`` (on the
        generator's device) unless given."""
        if noise is None:
            dev = generator.device if generator is not None else self.mean.device
            noise = torch.randn(self.mean.shape, generator=generator, device=dev,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise.to(self.mean)

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKLCogVideoX(nn.Module):
    """Encoder and decoder; the public API is (B, C, T, H, W)."""

    def __init__(self, cfg: CogVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = CogVideoXEncoder3D(cfg)
        self.decoder = CogVideoXDecoder3D(cfg)

    def encode_moments(self, x: torch.Tensor, cache: Cache = None) -> torch.Tensor:
        """x (B, C, T, H, W) -> moments (B, 2*latent, T', H', W')."""
        return self.encoder(x, cache)

    def decode(self, z: torch.Tensor, cache: Cache = None) -> torch.Tensor:
        """z (B, latent, T', H', W') -> (B, C, T, H, W)."""
        return self.decoder(z, cache)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(DiagonalGaussian(self.encode_moments(x)).mode())


def blend_tiles_h(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend the left tile ``a`` into ``b`` over ``extent`` columns (in fp32,
    rounded to b's dtype)."""
    extent = min(a.shape[4], b.shape[4], extent)
    w = (torch.arange(extent, device=b.device, dtype=torch.float32) / extent)
    mixed = a[..., -extent:].float() * (1 - w) + b[..., :extent].float() * w
    return torch.cat([mixed.to(b.dtype), b[..., extent:]], dim=4)


def blend_tiles_v(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    extent = min(a.shape[3], b.shape[3], extent)
    w = (torch.arange(extent, device=b.device, dtype=torch.float32) / extent)[:, None]
    mixed = a[..., -extent:, :].float() * (1 - w) + b[..., :extent, :].float() * w
    return torch.cat([mixed.to(b.dtype), b[..., extent:, :]], dim=3)


def _stitch(rows, blend_h: int, blend_w: int, limit_h: int, limit_w: int) -> torch.Tensor:
    """Blend each tile into its upper and left neighbours and crop it to its
    stride; rows of tiles -> one tensor."""
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend_tiles_v(rows[i - 1][j], tile, blend_h)
            if j > 0:
                tile = blend_tiles_h(row[j - 1], tile, blend_w)
            out_row.append(tile[:, :, :, :limit_h, :limit_w])
        out_rows.append(torch.cat(out_row, dim=4))
    return torch.cat(out_rows, dim=3)


def get_latent_size(input_size: Sequence[Optional[int]],
                    micro_frame_size: Optional[int] = None,
                    patch_size: Sequence[int] = (4, 8, 8),
                    n_blocks: int = 4) -> list:
    """[T, H, W] in pixels -> latent [T', H', W']: H and W divide by the spatial
    patch; T halves per temporal level with the odd rule (8n -> 2n, 8n+1 -> 2n+1),
    per micro-frame chunk when ``micro_frame_size`` is set."""
    T, H, W = input_size
    if micro_frame_size is None or T is None or T <= micro_frame_size + 1:
        latent = [None,
                  H // patch_size[1] if H is not None else None,
                  W // patch_size[2] if W is not None else None]
        level = int(np.log2(patch_size[0]))
        t = T
        if t is not None:
            for i in range(n_blocks):
                if i < level and i != n_blocks - 1:
                    t = t // 2 + 1 if t % 2 == 1 else t // 2
        latent[0] = t
        return latent
    sub = get_latent_size([micro_frame_size, H, W], None, patch_size, n_blocks)
    sub[0] = sub[0] * (T // micro_frame_size)
    if T % micro_frame_size == 1:
        sub[0] += 1
    elif T % micro_frame_size != 0:
        raise RuntimeError(f"unsupported input_size={input_size}")
    return sub


@MODELS.register_module("VideoAutoencoderKLCogVideoX")
class VideoAutoencoderKLCogVideoX:
    """The VAE as the pipeline uses it: scaling factor, micro-frame streamed
    encode (8n+1 inputs put the extra frame with the first chunk), decode of 2
    latent frames at a time, ``micro_batch_size`` chunking of the (B*NC) axis,
    spatial tiling, latent-size arithmetic. ``module`` holds the weights."""

    # latent frames per decoder chunk (the reference's num_latent_frames_batch_size)
    num_latent_frames_batch_size = 2

    def __init__(self, cfg: Optional[CogVAEConfig] = None, micro_frame_size=None,
                 micro_batch_size=None, from_pretrained=None, subfolder=None,
                 tiling: Optional[dict] = None, device="cuda"):
        self.device = resolve_device(device)
        self.micro_frame_size = micro_frame_size
        self.micro_batch_size = micro_batch_size
        self.from_pretrained = from_pretrained
        self.subfolder = subfolder
        self.tiling = tiling  # dict(tile_sample_min_height=..., ...) or None
        self._build(cfg or CogVAEConfig())

    def _build(self, cfg: CogVAEConfig):
        self.cfg = cfg
        with torch.device(self.device):
            self.module = AutoencoderKLCogVideoX(cfg).eval()
        self.out_channels = cfg.latent_channels
        self.patch_size = (cfg.temporal_compression_ratio, 8, 8)
        self.scaling_factor = cfg.scaling_factor

    @property
    def dtype(self):
        return self.cfg.dtype

    def load_pretrained(self, path: Optional[str] = None, subfolder: Optional[str] = None):
        """Load a local diffusers CogVideoX-VAE snapshot (``config.json`` and
        ``diffusion_pytorch_model.{safetensors,bin}``, or one weights file). The
        snapshot's config replaces the architecture fields of ``cfg``; every
        parameter must be present, keys the module lacks are logged."""
        from ...utils.ckpt import load_state_dict_cast, resolve_pretrained_dir
        path = path or self.from_pretrained
        if not path:
            raise ValueError("no pretrained path: set from_pretrained=")
        cfg_json, sd = resolve_pretrained_dir(path, subfolder or self.subfolder)
        if cfg_json:
            keep = {f.name for f in dataclasses.fields(CogVAEConfig)} - {"dtype"}
            updates = {k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in cfg_json.items() if k in keep}
            self._build(dataclasses.replace(self.cfg, **updates))
        res = load_state_dict_cast(self.module, sd, strict=False)
        if res.missing_keys:
            raise KeyError(f"VAE snapshot {path!r} lacks {len(res.missing_keys)} "
                           f"parameters, e.g. {res.missing_keys[:8]}")
        if res.unexpected_keys:
            logger.info("VAE snapshot: %d keys unused, e.g. %s",
                        len(res.unexpected_keys), res.unexpected_keys[:8])
        return self

    # ---- encode ----

    @torch.no_grad()
    def encode_moments_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Moments (B, 2*latent, T', H', W') of x (B, C, T, H, W). When
        ``micro_frame_size`` is set and T exceeds it by more than one, frames stream
        through the encoder in chunks of that size (the first takes the extra
        frame of an 8n+1 input) with the conv caches carried across chunks."""
        mfs, T = self.micro_frame_size, x.shape[2]
        if mfs is None or T <= mfs + 1:
            return self.module.encode_moments(x)
        if not (T % mfs == 0 or (T - 1) % mfs == 0):
            raise ValueError(f"T={T} incompatible with micro_frame_size={mfs}")
        first_len = mfs + 1 if (T - 1) % mfs == 0 else mfs
        cache: Dict = {}
        out = [self.module.encode_moments(x[:, :, :first_len], cache)]
        for s in range(first_len, T, mfs):
            out.append(self.module.encode_moments(x[:, :, s:s + mfs], cache))
        return torch.cat(out, dim=2)

    @torch.no_grad()
    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               sample: bool = True, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, C, T, H, W) -> scaled latents: a posterior sample (noise from
        ``generator`` or ``noise``) or its mode."""
        mbs = self.micro_batch_size
        if mbs is None or x.shape[0] <= mbs:
            moments = self._encode_dispatch(x)
        else:
            moments = torch.cat([self._encode_dispatch(x[i:i + mbs])
                                 for i in range(0, x.shape[0], mbs)], dim=0)
        dist = DiagonalGaussian(moments, dim=1)
        z = dist.sample(generator, noise) if sample else dist.mode()
        return z * self.scaling_factor

    def _encode_dispatch(self, x: torch.Tensor) -> torch.Tensor:
        if self.tiling and (x.shape[3] > self.tiling.get("tile_sample_min_height", 240) or
                            x.shape[4] > self.tiling.get("tile_sample_min_width", 360)):
            return self.tiled_encode_moments(x, **self.tiling)
        return self.encode_moments_seq(x)

    @torch.no_grad()
    def tiled_encode_moments(self, x: torch.Tensor, tile_sample_min_height: int = 240,
                             tile_sample_min_width: int = 360,
                             tile_overlap_factor_height: float = 1 / 6,
                             tile_overlap_factor_width: float = 1 / 5,
                             **_ignored) -> torch.Tensor:
        """Spatially tiled encode, the overlapping moments blended linearly; pixel
        tiles stride by whole latent units."""
        spatial = 2 ** (len(self.cfg.block_out_channels) - 1)
        tile_h, tile_w = tile_sample_min_height // spatial, tile_sample_min_width // spatial
        stride_h = int(tile_h * (1 - tile_overlap_factor_height))
        stride_w = int(tile_w * (1 - tile_overlap_factor_width))
        blend_h = int(tile_h * tile_overlap_factor_height)
        blend_w = int(tile_w * tile_overlap_factor_width)
        H, W = x.shape[3], x.shape[4]
        rows = [[self.encode_moments_seq(
                    x[:, :, :, i * spatial:(i + tile_h) * spatial,
                      j * spatial:(j + tile_w) * spatial])
                 for j in range(0, W // spatial, stride_w)]
                for i in range(0, H // spatial, stride_h)]
        out = _stitch(rows, blend_h, blend_w, tile_h - blend_h, tile_w - blend_w)
        return out[:, :, :, :H // spatial, :W // spatial]

    # ---- decode ----

    @torch.no_grad()
    def decode(self, z: torch.Tensor, frame_batching: bool = True) -> torch.Tensor:
        """z (B, latent, T', H', W') -> pixels (B, C, T, H, W) in the VAE's dtype.
        Views go through ``micro_batch_size`` at a time; each streams its latent
        frames 2 at a time (the first chunk takes the T' % 2 remainder) with fresh
        conv caches. ``frame_batching=False`` decodes all frames in one call."""
        mbs = self.micro_batch_size
        if mbs is None or z.shape[0] <= mbs:
            return self._decode_dispatch(z, frame_batching)
        return torch.cat([self._decode_dispatch(z[i:i + mbs], frame_batching)
                          for i in range(0, z.shape[0], mbs)], dim=0)

    def _decode_dispatch(self, z: torch.Tensor, frame_batching: bool) -> torch.Tensor:
        if self.tiling:
            return self.tiled_decode(z, frame_batching=frame_batching, **self.tiling)
        return self._decode_frames(z, frame_batching)

    def _decode_frames(self, z: torch.Tensor, frame_batching: bool = True) -> torch.Tensor:
        fbs, T = self.num_latent_frames_batch_size, z.shape[2]
        z = z / self.scaling_factor
        if not frame_batching or T <= fbs + 1:
            return self.module.decode(z)
        first_len = fbs + T % fbs
        cache: Dict = {}
        out = [self.module.decode(z[:, :, :first_len], cache)]
        for s in range(first_len, T, fbs):
            out.append(self.module.decode(z[:, :, s:s + fbs], cache))
        return torch.cat(out, dim=2)

    @torch.no_grad()
    def tiled_decode(self, z: torch.Tensor, tile_sample_min_height: int = 240,
                     tile_sample_min_width: int = 360,
                     tile_overlap_factor_height: float = 1 / 6,
                     tile_overlap_factor_width: float = 1 / 5,
                     frame_batching: bool = True) -> torch.Tensor:
        """Spatially tiled decode with overlap blending; each tile streams its latent
        frames like ``decode``, with its own caches."""
        spatial = 2 ** (len(self.cfg.block_out_channels) - 1)
        tile_h = int(tile_sample_min_height / spatial)
        tile_w = int(tile_sample_min_width / spatial)
        stride_h = int(tile_h * (1 - tile_overlap_factor_height))
        stride_w = int(tile_w * (1 - tile_overlap_factor_width))
        blend_h = int(tile_sample_min_height * tile_overlap_factor_height)
        blend_w = int(tile_sample_min_width * tile_overlap_factor_width)
        H, W = z.shape[3], z.shape[4]
        rows = [[self._decode_frames(z[:, :, :, i:i + tile_h, j:j + tile_w], frame_batching)
                 for j in range(0, W, stride_w)]
                for i in range(0, H, stride_h)]
        out = _stitch(rows, blend_h, blend_w, tile_sample_min_height - blend_h,
                      tile_sample_min_width - blend_w)
        return out[:, :, :, :H * spatial, :W * spatial]

    # ---- shape arithmetic ----

    def get_latent_size(self, input_size, micro_frame_size=-1) -> list:
        if micro_frame_size == -1:
            micro_frame_size = self.micro_frame_size
        return get_latent_size(input_size, micro_frame_size, self.patch_size,
                               len(self.cfg.block_out_channels))
