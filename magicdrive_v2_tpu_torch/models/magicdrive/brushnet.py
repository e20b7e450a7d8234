"""BrushNet pedestrian-inpainting variants of MagicDriveSTDiT3, in PyTorch
(counterpart of the JAX package's models/magicdrive/brushnet.py).

- ``ShallowEncoder``: a light stand-in for the VAE on the inpaint frames, 8x in
  space (three stride-2 3x3 convolutions with ReLU, one 3x3), 4t+1 -> t+1 in
  time (a (5, 1) convolution of stride 4 over the zero-padded time axis). cuDNN
  convolutions: no kernel of the port's own.
- ``MagicDriveSTDiT3BrushNet``: the base model plus a full-depth branch of
  ``brushnet_blocks_s`` / ``brushnet_blocks_t`` (control blocks without
  condition cross-attention) fed by the patchified cat[x, shallow(x_inpaint),
  mask]; each block's ``after_proj`` skip is added into the base stream. The
  pixel mask reaches the latent grid through the antialiased linear resize
  (``ops.resize``), the arithmetic of ``jax.image.resize(..., "trilinear")``.
- The SDE variant (``sde_inpaint``): an independent inpaint timestep through
  ``t_inpaint_block`` and ``t_combine_block`` (12h -> 6h) feeds ONLY the
  BrushNet blocks, and the shallow-encoded frames are mixed at ``t_inpaint``
  with phase-preserving structured noise (``ops.structured_noise``).
- The layer stack is walked in the reference order, one ``BrushLayerGroup`` per
  depth: base s, control s, brushnet s (``x + c_skip + xi_skip``), base t,
  control t (+skip), brushnet t (+skip).
- Under a mesh the inpaint token stream xi is split over S with x and c (see
  ``stdit3``); the ShallowEncoder, the mask resize and the structured noise run
  before the split, on every rank.

Randomness: the structured noise starts from a standard normal draw of shape
(B*C*T', H', W') for the batch the model sees (``inpaint_input_noise``), or from
an explicit ``generator``; the JAX model draws it from ``rngs_key``. In training
(``train=True``) its FFT cutoff is jittered, r0 + Exp(rate 0.1): ``cutoff_radius``,
or drawn from the generator first, before the normal draw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_linear_antialiased
from ...ops.structured_noise import generate_structured_noise, sample_cutoff_radius
from ...parallel.comm import split_seq_share
from ...registry import MODELS
from ...utils.misc import randn_rows
from ..layers.blocks import PatchEmbed3D, pos_embedding_2d
from .stdit3 import MagicDriveSTDiT3, MagicDriveSTDiT3Config, MVSTDiTBlock


@dataclasses.dataclass(frozen=True)
class BrushNetConfig(MagicDriveSTDiT3Config):
    """The base config plus the inpainting branch's switches; the LoRA keys of
    a config are dropped (``from_dict`` keeps only known fields)."""
    brushnet_skip_cross_attn: bool = True
    sde_inpaint: bool = False
    structured_noise_r0: float = 4.0
    structured_noise_transition: float = 2.0

    @classmethod
    def from_base(cls, base: MagicDriveSTDiT3Config, **fields) -> "BrushNetConfig":
        return cls(**{f.name: getattr(base, f.name)
                      for f in dataclasses.fields(MagicDriveSTDiT3Config)}, **fields)


class ShallowEncoder(nn.Module):
    """(B, 3, 4t+1, 8h, 8w) -> (B, out_channels, t+1, h, w)."""

    def __init__(self, out_channels: int = 4, temporal_downsample: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, stride=2, padding=1)
        self.conv2 = nn.Conv2d(64, 128, 3, stride=2, padding=1)
        self.conv3 = nn.Conv2d(128, 256, 3, stride=2, padding=1)
        self.conv4 = nn.Conv2d(256, out_channels, 3, stride=1, padding=1)
        td = temporal_downsample
        # over (B, C, T, H*W): a conv over time only, zero padding td // 2 each side
        self.temporal_conv = nn.Conv2d(out_channels, out_channels, (td + 1, 1),
                                       stride=(td, 1), padding=(td // 2, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        h = x.transpose(1, 2).reshape(B * T, C, H, W).to(self.conv1.weight.dtype)
        for conv in (self.conv1, self.conv2, self.conv3):
            h = F.relu(conv(h))
        h = self.conv4(h)
        Co, Hs, Ws = h.shape[1:]
        h = h.reshape(B, T, Co, Hs * Ws).transpose(1, 2)
        h = self.temporal_conv(h)
        return h.reshape(B, Co, h.shape[2], Hs, Ws)


class BrushLayerGroup(nn.Module):
    """Depth i of the BrushNet stack: base s, control s, brushnet s (both skips
    added to x), base t, control t (+skip), brushnet t (+skip); the unit the JAX
    package scans as ``BrushCtrlLayerGroup`` / ``BrushPlainLayerGroup``. It holds
    the model's own blocks and is not part of the model's module tree."""

    def __init__(self, base_s, brushnet_s, control_s=None, base_t=None, control_t=None,
                 brushnet_t=None):
        super().__init__()
        self.base_s, self.control_s, self.brushnet_s = base_s, control_s, brushnet_s
        self.base_t, self.control_t, self.brushnet_t = base_t, control_t, brushnet_t
        # the carry (x, c, xi) entries the group updates (without control blocks c
        # passes through)
        self.carry_updated = (True, control_s is not None or control_t is not None, True)

    def forward(self, x, c, xi, y, t, t_bn, x_mask, t0, t0_bn, pad_mask, sp_group=None):
        x = self.base_s(x, y, t, x_mask, t0, sp_group=sp_group)
        if self.control_s is not None:
            c, c_skip = self.control_s(c, y, t, x_mask, t0, sp_group=sp_group)
            x = x + c_skip
        xi, xi_skip = self.brushnet_s(xi, y, t_bn, x_mask, t0_bn, sp_group=sp_group)
        x = x + xi_skip
        if self.base_t is not None:
            x = self.base_t(x, y, t, x_mask, t0, pad_mask)
        if self.control_t is not None:
            c, c_skip = self.control_t(c, y, t, x_mask, t0, pad_mask)
            x = x + c_skip
        if self.brushnet_t is not None:
            xi, xi_skip = self.brushnet_t(xi, y, t_bn, x_mask, t0_bn, pad_mask)
            x = x + xi_skip
        return x, c, xi


class MagicDriveSTDiT3BrushNet(MagicDriveSTDiT3):
    """BrushNet inpainting model; ``cfg.sde_inpaint`` selects the SDE variant."""

    def __init__(self, cfg: BrushNetConfig):
        super().__init__(cfg)
        hidden = cfg.hidden_size
        self.shallow_encoder = ShallowEncoder(out_channels=cfg.in_channels,
                                              temporal_downsample=4)
        self.x_brushnet_embedder = PatchEmbed3D(cfg.patch_size, 2 * cfg.in_channels + 1,
                                                hidden)
        common = dict(hidden_size=hidden, num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                      qk_norm=cfg.qk_norm, neighbors=cfg.mv_order_map,
                      is_control_block=True, skip_cross_attn=cfg.brushnet_skip_cross_attn)
        self.brushnet_blocks_s = nn.ModuleList(
            [MVSTDiTBlock(**common, skip_cross_view=cfg.control_skip_cross_view)
             for _ in range(cfg.depth)])
        # the JAX package's control groups always hold a brushnet t block, its
        # plain groups only with temporal blocks
        n_t = cfg.depth if cfg.with_temp_block else cfg.control_depth
        self.brushnet_blocks_t = nn.ModuleList(
            [MVSTDiTBlock(**common, temporal=True) for _ in range(n_t)])
        if cfg.sde_inpaint:
            self.t_inpaint_block = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 6 * hidden))
            self.t_combine_block = nn.Sequential(nn.SiLU(),
                                                 nn.Linear(12 * hidden, 6 * hidden))

        def at(blocks, i):
            return blocks[i] if i < len(blocks) else None

        self._layer_groups = [
            BrushLayerGroup(self.base_blocks_s[i], self.brushnet_blocks_s[i],
                            at(self.control_blocks_s, i), at(self.base_blocks_t, i),
                            at(self.control_blocks_t, i), at(self.brushnet_blocks_t, i))
            for i in range(cfg.depth)]

    def encode_inpaint(self, x_inpaint, mask_inpaint, latent_shape):
        """Shallow-encoded inpaint frames and the pixel mask resized to the latent
        grid ``latent_shape`` (T', H', W')."""
        xi = self.shallow_encoder(x_inpaint)
        mask = resize_linear_antialiased(
            mask_inpaint, tuple(mask_inpaint.shape[:2]) + tuple(latent_shape))
        return xi, mask

    def forward(self, x, timestep, y, maps, bbox, cams, rel_pos, fps,
                height: float, width: float, x_inpaint=None, mask_inpaint=None,
                drop_cond_mask=None, drop_frame_mask=None, x_mask=None, t_inpaint=None,
                num_timesteps: float = 1000.0, inpaint_input_noise=None,
                generator: Optional[torch.Generator] = None, cond_cache=None,
                frame_valid=None, train: bool = False, cutoff_radius=None,
                simulate_sp: Optional[int] = None, dp_rows=(1, 0)):
        """As ``MagicDriveSTDiT3.forward`` plus the inpaint inputs: x_inpaint
        (b, 3*NC, T_img, H, W) pixels, mask_inpaint (b, NC, T_img, H, W) in
        [0, 1]; with ``frame_valid`` their pad frames must be zero (the temporal
        conv is centred, and zero pads reproduce its own zero padding). SDE:
        t_inpaint (b,), and either the standard normal draw
        ``inpaint_input_noise`` ((B*C*T', H', W') for B = b*NC) the structured
        noise is made from, or a ``generator`` to draw it. The structured noise's
        FFT cutoff is ``structured_noise_r0``; with ``train`` it is jittered to
        r0 + Exp(rate 0.1): ``cutoff_radius`` if given, else drawn from
        ``generator`` before the normal draw (the JAX model splits its key into
        the cutoff's and the noise's); the normal draw is data-parallel rank
        ``dp_rows`` (dp, rank)'s part of one made for the global batch
        (``randn_rows``). ``simulate_sp``: the H pad of that sp size, as in the
        base model."""
        cfg = self.cfg
        NC, dt = cfg.nc, self.dtype
        b = x.shape[0]
        B = b * NC
        T_img = rel_pos.shape[1]

        C_in = cfg.in_channels
        _, _, Tx, Hx, Wx = x.shape
        x = x.reshape(b, C_in, NC, Tx, Hx, Wx).transpose(1, 2)
        x = x.reshape(B, C_in, Tx, Hx, Wx).to(dt)

        xi_px = x_inpaint.reshape(b, 3, NC, *x_inpaint.shape[2:]).transpose(1, 2)
        xi_px = xi_px.reshape(B, 3, *x_inpaint.shape[2:]).to(dt)
        mi = mask_inpaint.reshape(B, 1, *mask_inpaint.shape[2:]).to(dt)
        xi_enc, mi = self.encode_inpaint(xi_px, mi, (Tx, Hx, Wx))

        if cutoff_radius is not None and not (cfg.sde_inpaint and train):
            raise ValueError("cutoff_radius is the SDE model's training cutoff: pass "
                             "train=True to an SDE-BrushNet model")
        if cfg.sde_inpaint:
            if t_inpaint is None:
                raise ValueError("the SDE-BrushNet model needs t_inpaint")
            cutoff = cfg.structured_noise_r0
            if train:
                if cutoff_radius is None and generator is None:
                    raise ValueError("train=True draws the cutoff: pass a generator or "
                                     "cutoff_radius")
                cutoff = float(cutoff_radius if cutoff_radius is not None
                               else sample_cutoff_radius(generator, cfg.structured_noise_r0))
            flat = xi_enc.reshape(B * xi_enc.shape[1] * Tx, Hx, Wx)
            if inpaint_input_noise is None and generator is not None:
                inpaint_input_noise = randn_rows(flat.shape, generator, dp_rows)
            noise_inpaint = generate_structured_noise(
                flat, generator, cutoff_radius=cutoff,
                transition_width=cfg.structured_noise_transition,
                input_noise=inpaint_input_noise).reshape(xi_enc.shape)
            # the rectified-flow mix at the independent inpaint timestep, in fp32
            tp = 1.0 - t_inpaint.float().repeat_interleave(NC, dim=0) / num_timesteps
            tp = tp.reshape(-1, 1, 1, 1, 1)
            xi_enc = (tp * xi_enc.float() + (1 - tp) * noise_inpaint.float()).to(dt)

        T, H, W = self.get_dynamic_size((Tx, Hx, Wx))
        h_pad_size = self._h_pad_size(H, W, simulate_sp)
        if h_pad_size > 0:
            pad = (0, 0, 0, h_pad_size * cfg.patch_size[1])
            x, xi_enc, mi = F.pad(x, pad), F.pad(xi_enc, pad), F.pad(mi, pad)
            H += h_pad_size
        S = H * W

        base_size = round(S ** 0.5)
        scale = math.sqrt(height * width) / cfg.input_sq_size
        pos_emb = pos_embedding_2d(cfg.hidden_size, H, W, scale=scale,
                                   base_size=base_size, device=x.device).to(dt)

        t_emb = self.t_embedder(timestep.float())
        fps_emb = self.fps_embedder(
            torch.as_tensor(fps, device=x.device).reshape(-1, 1).to(dt), b)
        t_emb = t_emb + fps_emb
        t_mlp = self.t_block(t_emb)
        t0_emb = t0_mlp = None
        if x_mask is not None:
            t0_emb = self.t_embedder(torch.zeros_like(timestep, dtype=torch.float32)) + fps_emb
            t0_mlp = self.t_block(t0_emb)

        if cfg.sde_inpaint:
            ti_emb = self.t_embedder(t_inpaint.float()) + fps_emb
            t_bn = self.t_combine_block(torch.cat([t_mlp, self.t_inpaint_block(ti_emb)], -1))
            t0_bn = None
            if x_mask is not None:
                t0_bn = self.t_combine_block(
                    torch.cat([t0_mlp, self.t_inpaint_block(t0_emb)], -1))
        else:
            t_bn, t0_bn = t_mlp, t0_mlp

        if cond_cache is not None:
            y_cond, c_map = cond_cache
        else:
            y_cond, c_map = self.encode_conditions(
                (b, C_in * NC, Tx, Hx, Wx), y, maps, bbox, cams, rel_pos,
                drop_cond_mask, drop_frame_mask, frame_valid, simulate_sp)

        pos = pos_emb.reshape(1, 1, S, -1)
        x_b = self.x_embedder(x).reshape(B, T, S, -1) + pos
        x_c = (self.x_control_embedder(x).reshape(B, T, S, -1) + pos
               if cfg.use_x_control_embedder else x_b)
        xi = self.x_brushnet_embedder(torch.cat([x, xi_enc, mi], dim=1)).reshape(B, T, S, -1)
        xi = xi + pos
        sp_group = self._sp_group(S)
        if sp_group is not None:  # the token streams split over S
            x_b, x_c, xi, c_map = (split_seq_share(a, 2, sp_group)
                                   for a in (x_b, x_c, xi, c_map))
        c = x_c + self.before_proj(c_map)
        x = x_b

        x_mask_rep = None
        if x_mask is not None:
            x_mask_rep = x_mask.bool().repeat_interleave(NC, dim=0)
        pad_mask_rep = self._latent_pad_mask(frame_valid, T_img, T, NC)

        x, c, xi = self.run_layer_groups(
            (x, c, xi),
            (y_cond, t_mlp, t_bn, x_mask_rep, t0_mlp, t0_bn, pad_mask_rep, sp_group))
        return self._final(x, t_emb, t0_emb, x_mask_rep, sp_group, b, (T, H, W),
                           (Tx, Hx, Wx))


class MagicDriveSTDiT3SDEBrushNet(MagicDriveSTDiT3BrushNet):
    """The SDE variant under its own name (the config's ``sde_inpaint`` decides)."""


MODELS.register_module("MagicDriveSTDiT3-XL/2-BrushNet", module=MagicDriveSTDiT3BrushNet)
MODELS.register_module("MagicDriveSTDiT3-XL/2-SDEBrushNet", module=MagicDriveSTDiT3SDEBrushNet)
