"""MagicDriveSTDiT3: the multi-view spatiotemporal DiT, in PyTorch
(counterpart of the JAX package's models/magicdrive/stdit3.py).

- Canonical token layout is 4D (B, T, S, C) with B = b * NC camera views.
- The layer stack is four ``nn.ModuleList``s, ``base_blocks_s``,
  ``base_blocks_t``, ``control_blocks_s`` and ``control_blocks_t``, walked in the
  reference order: per control depth base_s -> control_s (+skip) -> base_t ->
  control_t (+skip); then base_s -> base_t for the remaining depth.
- adaLN (LayerNorm + modulate) runs through ``ops.adaln_modulate``, spatial and
  cross-view attention through ``ops.fused_qkv_attention``, condition
  cross-attention through ``ops.dot_product_attention``.
- Training: with ``grad_checkpoint`` each layer group (depth i's base s,
  control s, base t and control t, what the JAX package remats as one scanned
  step) runs under ``torch.utils.checkpoint`` when autograd records, by
  ``remat_policy``: "full", "dots" (selective: the linear layers' products
  kept) or "offload_carry" (the carry in pinned host memory); the compute
  dtype comes from ``compute_params``, bf16 casts of fp32 master parameters
  handed to ``torch.func.functional_call`` (flax's ``param_dtype`` fp32 and
  ``dtype`` bf16).
- Sequence parallelism: under a ``parallel.use_mesh`` context whose sp size is
  above 1, ``forward`` splits the token streams over S after the embedders
  (rank r holds the contiguous block r), the blocks run on the split tokens
  (spatial and cross-view attention through the Ulysses all-to-all pair of
  ``blocks.ulysses_attention``, everything else per token) and S is gathered
  once, after the final layer. H is padded so S divides a sequence-parallel
  size: ``force_pad_h_for_sp_size``, else ``forward``'s ``simulate_sp`` (the
  training-time pad of ``simulate_sp_size``), else with
  ``enable_sequence_parallelism`` the mesh's sp size, as in the JAX package; the
  conditioning stays replicated. In a backward under the mesh every grad is this
  rank's share of one process's (``parallel.comm``'s grad rule): the trainer sums
  them over the sp group.
- Parameter names and layouts are the reference torch checkpoint's.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ...ops.fused_adaln import adaln_modulate
from ...parallel.comm import gather_seq, share_grad, split_seq_share
from ...parallel.sharding import get_current_mesh, sp_size
from ..layers.blocks import (
    CaptionEmbedder,
    CrossAttention,
    CrossViewAttention,
    Mlp,
    PatchEmbed3D,
    SelfAttention,
    SizeEmbedder,
    T2IFinalLayer,
    TimestepEmbedder,
    pos_embedding_2d,
)
from .embedder import (
    CamEmbedder,
    CamEmbedderTemp,
    ContinuousBBoxWithTextEmbedding,
    ContinuousBBoxWithTextTempEmbedding,
    MapControlEmbedding,
    MapControlTempEmbedding,
)

logger = logging.getLogger(__name__)
_UNSPLIT_WARNED = set()  # (S, sp) pairs the unsplit forward was reported for

_EMBEDDER_CLASSES = {
    "CamEmbedder": CamEmbedder,
    "CamEmbedderTemp": CamEmbedderTemp,
    "ContinuousBBoxWithTextEmbedding": ContinuousBBoxWithTextEmbedding,
    "ContinuousBBoxWithTextTempEmbedding": ContinuousBBoxWithTextTempEmbedding,
    "MapControlEmbedding": MapControlEmbedding,
}


def resolve_embedder(cls_path: str):
    """Accepts both short names and reference-style dotted paths."""
    return _EMBEDDER_CLASSES[cls_path.rsplit(".", 1)[-1]]


DEFAULT_MV_ORDER_MAP = {0: [5, 1], 1: [0, 2], 2: [1, 3], 3: [2, 4], 4: [3, 5], 5: [4, 0]}


@dataclasses.dataclass(frozen=True)
class MagicDriveSTDiT3Config:
    """Architecture hyper-parameters, the sequence-parallel pad and the remat
    switch (``from_dict`` drops keys it does not know)."""
    input_sq_size: int = 512
    in_channels: int = 4
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    class_dropout_prob: float = 0.1
    pred_sigma: bool = True
    caption_channels: int = 4096
    model_max_length: int = 300
    qk_norm: bool = True
    with_temp_block: bool = True
    control_depth: int = 13
    use_x_control_embedder: bool = False
    uncond_cam_in_dim: Tuple[int, int] = (3, 7)
    cam_encoder_cls: str = "CamEmbedder"
    cam_encoder_param: Tuple = ()
    bbox_embedder_cls: str = "ContinuousBBoxWithTextTempEmbedding"
    bbox_embedder_param: Tuple = ()
    map_embedder_cls: str = "MapControlEmbedding"
    map_embedder_param: Tuple = ()
    frame_emb_cls: str = "CamEmbedderTemp"
    frame_emb_param: Tuple = ()
    map_embedder_downsample_rate: Any = 4
    micro_frame_size: Optional[int] = 17
    control_skip_cross_view: bool = True
    control_skip_temporal: bool = True
    force_pad_h_for_sp_size: Optional[int] = None
    # pad H so S divides the mesh's sp size (when force_pad_h_for_sp_size is unset)
    enable_sequence_parallelism: bool = False
    # training: remat each layer group when autograd records; remat_policy "full"
    # (recompute the group in the backward), "dots" (keep the linear layers'
    # products) or "offload_carry" (keep the group's carry in host memory)
    grad_checkpoint: bool = True
    remat_policy: str = "full"
    mv_order_map: Tuple[Tuple[int, ...], ...] = tuple(
        tuple(v) for v in DEFAULT_MV_ORDER_MAP.values())
    dtype: Any = torch.bfloat16

    @property
    def nc(self) -> int:
        return len(self.mv_order_map)

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.pred_sigma else self.in_channels

    @classmethod
    def from_dict(cls, d: Dict) -> "MagicDriveSTDiT3Config":
        d = dict(d)
        for k in ("type", "from_pretrained", "force_huggingface"):
            d.pop(k, None)
        known = {f.name for f in dataclasses.fields(cls)}
        if "mv_order_map" in d and isinstance(d["mv_order_map"], dict):
            d["mv_order_map"] = tuple(tuple(v) for _, v in sorted(d["mv_order_map"].items()))
        for k in ("cam_encoder_param", "bbox_embedder_param", "map_embedder_param",
                  "frame_emb_param"):
            if k in d and isinstance(d[k], dict):
                d[k] = tuple(sorted(d[k].items()))
        kept = {k: v for k, v in d.items() if k in known}
        if "patch_size" in kept:
            kept["patch_size"] = tuple(kept["patch_size"])
        if "uncond_cam_in_dim" in kept:
            kept["uncond_cam_in_dim"] = tuple(kept["uncond_cam_in_dim"])
        return cls(**kept)


class MVSTDiTBlock(nn.Module):
    """One transformer block: adaLN -> self-attn (spatial or temporal view) ->
    condition cross-attn -> cross-view attn -> MLP, with t/t0 frame-mask
    switching."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 qk_norm: bool = False, temporal: bool = False,
                 is_control_block: bool = False, skip_cross_attn: bool = False,
                 skip_cross_view: bool = False,
                 neighbors: Tuple[Tuple[int, ...], ...] = ()):
        super().__init__()
        self.hidden_size = hidden_size
        self.temporal = temporal
        self.is_control_block = is_control_block
        self.skip_cross_attn = skip_cross_attn
        self.skip_cross_view = skip_cross_view or temporal
        self.neighbors = neighbors
        self.attn = SelfAttention(hidden_size, num_heads, qkv_bias=True,
                                  qk_norm=qk_norm, use_rope=temporal)
        if not skip_cross_attn:
            self.cross_attn = CrossAttention(hidden_size, num_heads)
        if not self.skip_cross_view:
            # the reference builds cross_view_attn without a qkv bias
            self.cross_view_attn = CrossViewAttention(hidden_size, num_heads,
                                                      qkv_bias=False, qk_norm=True)
            self.scale_shift_table_mva = nn.Parameter(
                torch.randn(3, hidden_size) / hidden_size ** 0.5)
            self.mva_proj = nn.Linear(hidden_size, hidden_size)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        self.scale_shift_table = nn.Parameter(
            torch.randn(6, hidden_size) / hidden_size ** 0.5)
        if is_control_block:
            self.after_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x, y, t, x_mask, t0, pad_mask=None, sp_group=None):
        # x: (B, T, S, C) with B = b*NC; y: (B, Ty, L, C); t/t0: (b, 6C);
        # x_mask: (B, T) bool or None; pad_mask: optional (B, T) frame validity,
        # used only as the temporal attention's key mask; sp_group: the group S
        # is split over (x holds this rank's block).
        B, T, S, C = x.shape
        b = t.shape[0]
        NC = B // b

        def mods_of(table, tt, n):
            return (table.to(x.dtype)[None] + tt.reshape(b, 6, C)[:, :n]
                    ).repeat_interleave(NC, dim=0)  # (B, n, C)

        def sel(a, a0):
            if x_mask is None:
                return a
            return torch.where(x_mask[:, :, None, None], a, a0)

        def norm_mod(inp, idx_shift, idx_scale, mods_, mods0_):
            flat = inp.reshape(B, T * S, C)
            out = adaln_modulate(flat, mods_[:, idx_shift], mods_[:, idx_scale])
            out = out.reshape(B, T, S, C)
            if x_mask is None:
                return out
            out0 = adaln_modulate(flat, mods0_[:, idx_shift], mods0_[:, idx_scale])
            return sel(out, out0.reshape(B, T, S, C))

        def gate(mods_, mods0_, idx, val):
            g = mods_[:, idx, None, None, :] * val
            if x_mask is None:
                return g
            return sel(g, mods0_[:, idx, None, None, :] * val)

        m = mods_of(self.scale_shift_table, t, 6)
        m0 = mods_of(self.scale_shift_table, t0, 6) if x_mask is not None else None

        # ---- self attention (spatial or temporal view) ----
        x_m = norm_mod(x, 0, 1, m, m0)
        if self.temporal:
            x_m = self.attn(x_m, kv_mask=pad_mask)
        else:
            x_m = self.attn(x_m.reshape(B * T, S, C), sp_group=sp_group).reshape(B, T, S, C)
        x = x + gate(m, m0, 2, x_m)

        # ---- condition cross attention ----
        if not self.skip_cross_attn:
            Ty, L = y.shape[1], y.shape[2]
            if Ty == 1:
                x_c = self.cross_attn(x.reshape(B, T * S, C), y[:, 0])
            else:
                x_c = self.cross_attn(x.reshape(B * T, S, C), y.reshape(B * T, L, C))
            x = x + x_c.reshape(B, T, S, C)

        # ---- cross-view attention ----
        if not self.skip_cross_view:
            mv = mods_of(self.scale_shift_table_mva, t, 3)
            mv0 = mods_of(self.scale_shift_table_mva, t0, 3) if x_mask is not None else None
            x_v = norm_mod(x, 0, 1, mv, mv0)
            # (b*NC, T, S, C) -> (b*T, NC, S, C)
            x_mv = x_v.reshape(b, NC, T, S, C).transpose(1, 2).reshape(b * T, NC, S, C)
            out = self.cross_view_attn(x_mv, self.neighbors, sp_group=sp_group)
            out = out.reshape(b, T, NC, S, C).transpose(1, 2).reshape(B, T, S, C)
            x = x + self.mva_proj(gate(mv, mv0, 2, out))

        # ---- MLP ----
        x_m = self.mlp(norm_mod(x, 3, 4, m, m0))
        x = x + gate(m, m0, 5, x_m)

        if self.is_control_block:
            return x, self.after_proj(x)
        return x


class LayerGroup(nn.Module):
    """Depth i of the layer stack: base s, control s (its skip added to x), base t,
    control t (its skip added to x); the unit the JAX package remats (one step of
    its scanned ``CtrlLayerGroup`` / ``PlainLayerGroup``). It holds the model's own
    blocks and is not part of the model's module tree."""

    def __init__(self, base_s, control_s=None, base_t=None, control_t=None):
        super().__init__()
        self.base_s, self.control_s = base_s, control_s
        self.base_t, self.control_t = base_t, control_t
        # the carry (x, c) entries the group updates (without control blocks c
        # passes through)
        self.carry_updated = (True, control_s is not None or control_t is not None)

    def forward(self, x, c, y, t, x_mask, t0, pad_mask, sp_group=None):
        x = self.base_s(x, y, t, x_mask, t0, sp_group=sp_group)
        if self.control_s is not None:
            c, c_skip = self.control_s(c, y, t, x_mask, t0, sp_group=sp_group)
            x = x + c_skip
        if self.base_t is not None:
            x = self.base_t(x, y, t, x_mask, t0, pad_mask)
        if self.control_t is not None:
            c, c_skip = self.control_t(c, y, t, x_mask, t0, pad_mask)
            x = x + c_skip
        return x, c


REMAT_POLICIES = ("full", "dots", "offload_carry")

# remat "dots" (the JAX package's dots_with_no_batch_dims_saveable): the outputs of
# the linear layers' matrix products are kept from the forward, everything else is
# recomputed in the backward: the plain attention's batched products (aten bmm) and
# the kernels too, whose launches are no aten op. F.linear on a contiguous input of
# any rank is one aten addmm (mm without a bias), on a strided one a copy and mm.
DOTS_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def save_matmuls():
    """``context_fn`` of ``checkpoint`` for remat "dots"."""
    return create_selective_checkpoint_contexts(list(DOTS_SAVED_OPS))


def _group_step(group, params, args, *carry):
    return functional_call(group, params, carry + args)


class CarryOffload:
    """Remat "offload_carry": between the forward and the backward, each layer
    group's carry (the x, c and xi it updates) waits in pinned host memory instead
    of on the card; everything else is recomputed, as under "full" (the JAX
    package's save_and_offload_only_these_names on the tagged carry). The
    non-reentrant checkpoint saves its tensor arguments through the ambient
    ``saved_tensors_hooks``: ``hooks`` packs those that are the given carry
    tensors into host copies (``non_blocking``, on the current stream) and leaves
    the others; the backward copies them back. Counts what went to the host."""

    def __init__(self):
        self.tensors_to_host = 0
        self.bytes_to_host = 0

    def hooks(self, carry):
        moved = {id(t) for t in carry}

        def pack(t):
            if id(t) not in moved:
                return t
            # the carry's own strides: the recompute must see the layout the
            # forward saw (a permuted carry takes other aten paths than a
            # contiguous one, and checkpoint checks what they save)
            host = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="cpu",
                                       pin_memory=t.is_cuda)
            host.copy_(t, non_blocking=True)
            self.tensors_to_host += 1
            self.bytes_to_host += t.numel() * t.element_size()
            return t.device, host

        def unpack(packed):
            if isinstance(packed, torch.Tensor):
                return packed
            device, host = packed
            return host.to(device, non_blocking=True)

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


class MagicDriveSTDiT3(nn.Module):
    """Main DiT."""

    def __init__(self, cfg: MagicDriveSTDiT3Config):
        super().__init__()
        self.cfg = cfg
        hidden, patch = cfg.hidden_size, cfg.patch_size
        C_in = cfg.in_channels
        self.x_embedder = PatchEmbed3D(patch, C_in, hidden)
        self.t_embedder = TimestepEmbedder(hidden)
        self.t_block = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 6 * hidden))
        self.y_embedder = CaptionEmbedder(cfg.caption_channels, hidden,
                                          uncond_prob=cfg.class_dropout_prob,
                                          token_num=cfg.model_max_length)
        self.fps_embedder = SizeEmbedder(hidden)
        if cfg.use_x_control_embedder:
            self.x_control_embedder = PatchEmbed3D(patch, C_in, hidden)
        self.register_buffer("base_token", torch.randn(hidden))
        self.camera_embedder = resolve_embedder(cfg.cam_encoder_cls)(
            out_dim=hidden, **dict(cfg.cam_encoder_param))
        self.frame_embedder = resolve_embedder(cfg.frame_emb_cls)(
            out_dim=hidden, **dict(cfg.frame_emb_param))
        self.bbox_embedder = resolve_embedder(cfg.bbox_embedder_cls)(
            **dict(cfg.bbox_embedder_param))
        self.controlnet_cond_embedder = resolve_embedder(cfg.map_embedder_cls)(
            conditioning_embedding_channels=hidden // 2,
            **dict(cfg.map_embedder_param))
        self.controlnet_cond_embedder_temp = MapControlTempEmbedding(
            hidden, cfg.map_embedder_downsample_rate)
        self.controlnet_cond_patchifier = PatchEmbed3D(patch, hidden, hidden)
        self.before_proj = nn.Linear(hidden, hidden)

        common = dict(hidden_size=hidden, num_heads=cfg.num_heads,
                      mlp_ratio=cfg.mlp_ratio, qk_norm=cfg.qk_norm,
                      neighbors=cfg.mv_order_map)
        self.base_blocks_s = nn.ModuleList(
            [MVSTDiTBlock(**common) for _ in range(cfg.depth)])
        self.base_blocks_t = nn.ModuleList(
            [MVSTDiTBlock(**common, temporal=True) for _ in range(cfg.depth)]
            if cfg.with_temp_block else [])
        self.control_blocks_s = nn.ModuleList(
            [MVSTDiTBlock(**common, is_control_block=True,
                          skip_cross_view=cfg.control_skip_cross_view)
             for _ in range(cfg.control_depth)])
        self.control_blocks_t = nn.ModuleList(
            [MVSTDiTBlock(**common, temporal=True, is_control_block=True)
             for _ in range(cfg.control_depth)]
            if not cfg.control_skip_temporal else [])
        self.final_layer = T2IFinalLayer(hidden, int(np.prod(patch)), cfg.out_channels)

        if cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: expected one of "
                             f"{REMAT_POLICIES}")
        self.carry_offload = CarryOffload()

        def at(blocks, i):
            return blocks[i] if i < len(blocks) else None

        # a plain list: the groups share the blocks above and stay out of the
        # module tree (and the state dict)
        self._layer_groups = [
            LayerGroup(self.base_blocks_s[i], at(self.control_blocks_s, i),
                       at(self.base_blocks_t, i), at(self.control_blocks_t, i))
            for i in range(cfg.depth)]

    @property
    def dtype(self):
        return self.before_proj.weight.dtype

    # ------------------------------------------------------------------
    # embedding helpers
    # ------------------------------------------------------------------

    def encode_text(self, y, drop_cond_mask=None):
        force_drop = None if drop_cond_mask is None else (1 - drop_cond_mask)
        return self.y_embedder(y, force_drop_ids=force_drop)[:, 0]  # (b, L, C)

    def encode_box(self, bbox: Dict[str, torch.Tensor], drop_mask: torch.Tensor,
                   frame_valid=None):
        """bbox masks use {0: null/pad, 1: keep, -1: visible-masked}; drop_mask
        (B, T_img) 0 -> drop."""
        masks = bbox["masks"]
        B, T, L = masks.shape
        drop = drop_mask[:, :, None].expand(B, T, L)
        null_mask = torch.where(masks == 0, 0.0, 1.0)
        keep = torch.ones_like(null_mask)
        keep = torch.where(masks == -1, torch.zeros_like(keep), keep)
        keep = torch.where((masks == 1) & (drop == 0), torch.zeros_like(keep), keep)
        classes = bbox["classes"].long().clamp(min=0)
        kw = {}
        if frame_valid is not None and isinstance(
                self.bbox_embedder, ContinuousBBoxWithTextTempEmbedding):
            kw["frame_valid"] = frame_valid
        return self.bbox_embedder(bbox["bboxes"], classes, null_mask, keep,
                                  bbox.get("box_latent"), **kw)

    def encode_cond_sequence(self, bbox, cams, rel_pos, y, drop_cond_mask,
                             drop_frame_mask, frame_valid=None):
        """Per-frame condition sequence [frame, cam, y, boxes]:
        (B, T_lat, L_cond, C)."""
        b = y.shape[0]
        NC = cams.shape[0] // b
        T_img = cams.shape[1]
        fv_rep = None if frame_valid is None else \
            frame_valid.bool().repeat_interleave(NC, dim=0)

        y_emb = self.encode_text(y, drop_cond_mask).repeat_interleave(NC, dim=0)

        cond_tail = []
        if bbox is not None:
            drop_box = (drop_cond_mask[:, None].bool() & drop_frame_mask.bool()).float()
            drop_box = drop_box.repeat_interleave(NC, dim=0)
            bbox_emb = self.encode_box(bbox, drop_box, fv_rep)  # (B, T_lat, L_box, C)
            cond_tail.append(self.base_token[None, None, None].to(bbox_emb.dtype) + bbox_emb)

        # camera token from the first frame only
        S_cam = cams.shape[2]
        cam_flat = cams[:, 0].reshape(b * NC * S_cam, *cams.shape[3:])
        cam_mask = drop_cond_mask.repeat_interleave(NC * S_cam, dim=0)
        cam_tok, _ = self.camera_embedder.embed_cam(cam_flat, cam_mask, T=1, S=S_cam)
        cam_emb = cam_tok.reshape(b * NC, 1, S_cam, -1)

        # ego-motion tokens over all frames, temporally downsampled
        S_f = rel_pos.shape[2]
        rp_flat = rel_pos.reshape(b * NC * T_img * S_f, *rel_pos.shape[3:])
        frame_mask = drop_frame_mask.repeat_interleave(NC, dim=0).reshape(
            b * NC, T_img, 1).repeat_interleave(S_f, dim=2).reshape(-1)
        fe_kw = {}
        if fv_rep is not None and isinstance(self.frame_embedder, CamEmbedderTemp):
            fe_kw["frame_valid"] = fv_rep
        frame_emb, _ = self.frame_embedder.embed_cam(rp_flat, frame_mask, T=T_img,
                                                     S=S_f, **fe_kw)
        T_lat = frame_emb.shape[1]

        base = self.base_token[None, None, None].to(cam_emb.dtype)
        cam_emb = (base + cam_emb).expand(-1, T_lat, -1, -1)
        frame_emb = base + frame_emb
        y_rep = y_emb[:, None].expand(-1, T_lat, -1, -1)
        return torch.cat([frame_emb, cam_emb, y_rep] + cond_tail, dim=2)

    def encode_map(self, maps, NC, h_pad_size, x_latent_shape):
        b, T_img = maps.shape[:2]
        c = self.controlnet_cond_embedder(maps.reshape(b * T_img, *maps.shape[2:]))
        ch, Hm, Wm = c.shape[1:]
        c = c.reshape(b, T_img, ch, Hm, Wm).permute(0, 2, 1, 3, 4)
        mfs = self.cfg.micro_frame_size
        if mfs is None:
            c = self.controlnet_cond_embedder_temp(c)
        else:
            c = torch.cat([self.controlnet_cond_embedder_temp(c[:, :, i:i + mfs])
                           for i in range(0, T_img, mfs)], dim=2)
        if tuple(c.shape[-3:]) != tuple(x_latent_shape):
            # "nearest-exact" is the rule the JAX package's nearest resize follows
            c = F.interpolate(c, size=tuple(x_latent_shape), mode="nearest-exact")
        if h_pad_size > 0:
            c = F.pad(c, (0, 0, 0, h_pad_size * self.cfg.patch_size[1]))
        c = self.controlnet_cond_patchifier(c)  # (b, T*H'*W', hidden)
        return c.repeat_interleave(NC, dim=0)

    def get_dynamic_size(self, latent_shape) -> Tuple[int, int, int]:
        T, H, W = latent_shape
        pt, ph, pw = self.cfg.patch_size
        return (-(-T // pt), -(-H // ph), -(-W // pw))

    def _latent_pad_mask(self, frame_valid, T_img: int, T: int, NC: int):
        """(b, T_img) pixel-frame validity -> (B, T) latent frame validity: latent
        frame i is valid iff pixel frame 4i is."""
        if frame_valid is None:
            return None
        lat_valid = frame_valid.bool()[:, ::4]
        assert self.cfg.patch_size[0] == 1 and lat_valid.shape[1] == T, (
            "frame_valid requires temporal patch 1 and T_img == 4*(T'-1)+1",
            frame_valid.shape, T_img, T)
        return lat_valid.repeat_interleave(NC, dim=0)

    def _h_pad_size(self, H: int, W: int, simulate_sp: Optional[int] = None) -> int:
        """H padding so S = H*W divides a sequence-parallel size:
        ``force_pad_h_for_sp_size``, else ``simulate_sp`` (the training-time pad
        the app picks from ``simulate_sp_size`` each step), else (with
        ``enable_sequence_parallelism``) the current mesh's sp size. The pad
        changes the function (the grid effect), so a sharded run equals the
        unsharded one with ``force_pad_h_for_sp_size`` set to the same size."""
        pad_to = self.cfg.force_pad_h_for_sp_size
        if pad_to is None and simulate_sp:
            pad_to = simulate_sp
        if pad_to is None and self.cfg.enable_sequence_parallelism:
            pad_to = sp_size()
        if pad_to and (H * W) % pad_to != 0:
            return pad_to - H % pad_to
        return 0

    def _sp_group(self, S: int):
        """The sequence-parallel group this forward splits its S tokens over, or
        None: no mesh, an sp size of 1, or S not divisible by it (then every rank
        computes all of it, as the JAX package's ``shard_hint`` leaves such an
        axis unsharded)."""
        mesh = get_current_mesh()
        if mesh is None or mesh.sp == 1:
            return None
        if S % mesh.sp:
            if (S, mesh.sp) not in _UNSPLIT_WARNED:
                _UNSPLIT_WARNED.add((S, mesh.sp))
                logger.warning("S=%d tokens do not split over sp=%d ranks: every rank "
                               "computes all of them", S, mesh.sp)
            return None
        if self.cfg.num_heads % mesh.sp:
            raise ValueError(f"sequence parallelism over {mesh.sp} ranks splits the "
                             f"{self.cfg.num_heads} heads: they must divide")
        return mesh.sp_group

    def _final(self, x, t_emb, t0_emb, x_mask_rep, sp_group, b, grid, latent):
        """Final layer on this rank's tokens, S gathered, unpatchify: (B, T, S', C)
        -> (b, C_out*NC, Tx, Hx, Wx) fp32. grid: (T, H, W) tokens, latent: (Tx, Hx,
        Wx). A forward that ran whole on every rank of a mesh leaves each rank
        1/sp of the grads (``share_grad``), as a split one leaves its share."""
        cfg = self.cfg
        NC = cfg.nc
        B, T, S_loc, _ = x.shape
        t_fin = t_emb.repeat_interleave(NC, dim=0)
        t0_fin = None if t0_emb is None else t0_emb.repeat_interleave(NC, dim=0)
        x = self.final_layer(x.reshape(B, T * S_loc, -1), t_fin, x_mask_rep, t0_fin, T,
                             S_loc)
        if sp_group is not None:
            x = gather_seq(x.reshape(B, T, S_loc, -1), 2, sp_group).reshape(B, -1, x.shape[-1])
        x = self.unpatchify(x, *grid, *latent).float()
        C_out = cfg.out_channels
        x = x.reshape(b, NC, C_out, *latent).transpose(1, 2)
        mesh = get_current_mesh()
        if sp_group is None and mesh is not None and mesh.sp > 1:
            x = share_grad(x, mesh.sp_group)
        return x.reshape(b, C_out * NC, *latent)

    def _resize_cond_time(self, y_cond, T):
        if y_cond.shape[1] != T and y_cond.shape[1] > 1:
            idx = torch.floor((torch.arange(T, device=y_cond.device) + 0.5)
                              * (y_cond.shape[1] / T)).long()
            y_cond = y_cond[:, idx]
        return y_cond

    # ------------------------------------------------------------------

    def encode_conditions(self, x_shape, y, maps, bbox, cams, rel_pos,
                          drop_cond_mask=None, drop_frame_mask=None, frame_valid=None,
                          simulate_sp: Optional[int] = None):
        """Step-independent conditioning (y_cond, c_map), computed once per sample
        and passed to ``forward`` as ``cond_cache``. x_shape: the
        (b, C*NC, T', H', W') latent shape the denoiser will be called with;
        ``simulate_sp`` the one it will be called with (c_map takes its pad)."""
        cfg = self.cfg
        NC, dt = cfg.nc, self.dtype
        b = x_shape[0]
        T_img = rel_pos.shape[1]
        dev = rel_pos.device
        if drop_cond_mask is None:
            drop_cond_mask = torch.ones((b,), dtype=torch.float32, device=dev)
        if drop_frame_mask is None:
            drop_frame_mask = torch.ones((b, T_img), dtype=torch.float32, device=dev)
        Tx, Hx, Wx = x_shape[-3:]
        T, H, W = self.get_dynamic_size((Tx, Hx, Wx))
        h_pad_size = self._h_pad_size(H, W, simulate_sp)
        H += h_pad_size
        S = H * W
        y_cond = self.encode_cond_sequence(bbox, cams, rel_pos, y.to(dt), drop_cond_mask,
                                           drop_frame_mask, frame_valid)
        y_cond = self._resize_cond_time(y_cond, T)
        c_map = self.encode_map(maps.to(dt), NC, h_pad_size, (Tx, Hx, Wx))
        return y_cond, c_map.reshape(b * NC, T, S, -1)

    def forward(self, x, timestep, y, maps, bbox, cams, rel_pos, fps,
                height: float, width: float, drop_cond_mask=None,
                drop_frame_mask=None, x_mask=None, cond_cache=None, frame_valid=None,
                simulate_sp: Optional[int] = None):
        """x: (b, C*NC, T', H', W') latents; timestep: (b,); y: (b, 1, L, 4096);
        maps: (b, T_img, C_map, Hm, Wm); bbox: dict or None;
        cams: (b*NC, T_img, 1, 3, 7); rel_pos: (b*NC, T_img, 1, 4, 4); fps: (b,) or
        (1,); height/width: python numbers. cond_cache: optional (y_cond, c_map)
        from ``encode_conditions``; simulate_sp: the H pad of that sp size (see
        ``_h_pad_size``). Returns fp32 of x's shape (out_channels folded like
        in_channels)."""
        cfg = self.cfg
        NC, dt = cfg.nc, self.dtype
        b = x.shape[0]
        B = b * NC
        T_img = rel_pos.shape[1]

        # (b, C*NC, T, H, W) -> (B, C, T, H, W); channels are C-major over (C, NC)
        C_in = cfg.in_channels
        _, _, Tx, Hx, Wx = x.shape
        x = x.reshape(b, C_in, NC, Tx, Hx, Wx).transpose(1, 2)
        x = x.reshape(B, C_in, Tx, Hx, Wx).to(dt)

        T, H, W = self.get_dynamic_size((Tx, Hx, Wx))
        h_pad_size = self._h_pad_size(H, W, simulate_sp)
        if h_pad_size > 0:
            x = F.pad(x, (0, 0, 0, h_pad_size * cfg.patch_size[1]))
            H += h_pad_size
        S = H * W

        base_size = round(S ** 0.5)
        scale = math.sqrt(height * width) / cfg.input_sq_size
        pos_emb = pos_embedding_2d(cfg.hidden_size, H, W, scale=scale,
                                   base_size=base_size, device=x.device).to(dt)

        t_emb = self.t_embedder(timestep.float())  # (b, C)
        fps_emb = self.fps_embedder(
            torch.as_tensor(fps, device=x.device).reshape(-1, 1).to(dt), b)
        t_emb = t_emb + fps_emb
        t_mlp = self.t_block(t_emb)
        t0_emb = t0_mlp = None
        if x_mask is not None:
            t0_emb = self.t_embedder(torch.zeros_like(timestep, dtype=torch.float32)) + fps_emb
            t0_mlp = self.t_block(t0_emb)

        if cond_cache is not None:
            y_cond, c_map = cond_cache
        else:
            y_cond, c_map = self.encode_conditions(
                (b, C_in * NC, Tx, Hx, Wx), y, maps, bbox, cams, rel_pos,
                drop_cond_mask, drop_frame_mask, frame_valid, simulate_sp)

        x_b = self.x_embedder(x).reshape(B, T, S, -1) + pos_emb.reshape(1, 1, S, -1)
        if cfg.use_x_control_embedder:
            x_c = self.x_control_embedder(x).reshape(B, T, S, -1) + pos_emb.reshape(1, 1, S, -1)
        else:
            x_c = x_b
        sp_group = self._sp_group(S)
        if sp_group is not None:  # the token streams split over S
            x_b, x_c, c_map = (split_seq_share(a, 2, sp_group) for a in (x_b, x_c, c_map))
        c = x_c + self.before_proj(c_map)
        x = x_b

        x_mask_rep = None
        if x_mask is not None:
            x_mask_rep = x_mask.bool().repeat_interleave(NC, dim=0)  # (B, T)
        pad_mask_rep = self._latent_pad_mask(frame_valid, T_img, T, NC)

        x, c = self.run_layer_groups(
            (x, c), (y_cond, t_mlp, x_mask_rep, t0_mlp, pad_mask_rep, sp_group))
        return self._final(x, t_emb, t0_emb, x_mask_rep, sp_group, b, (T, H, W),
                           (Tx, Hx, Wx))

    def run_layer_groups(self, carry: Tuple[torch.Tensor, ...], args: Tuple) -> Tuple:
        """Each layer group in turn on the ``carry`` (x, c[, xi]) with the shared
        ``args``. When autograd records and ``grad_checkpoint``, each group runs under
        the non-reentrant ``torch.utils.checkpoint`` by ``remat_policy``."""
        cfg = self.cfg
        if not (cfg.grad_checkpoint and torch.is_grad_enabled()):
            for group in self._layer_groups:
                carry = group(*carry, *args)
            return carry
        kw = dict(use_reentrant=False)
        if cfg.remat_policy == "dots":
            kw["context_fn"] = save_matmuls
        for group in self._layer_groups:
            # the recompute runs in the backward, after a caller's functional_call has
            # returned: it gets the group's parameters as they are now (the caller's
            # casts) handed in again. The carry goes in as tensor arguments of their
            # own (checkpoint saves those, where the offload hooks see them), the
            # shared arguments as one tuple (kept as they are)
            params = dict(group.named_parameters())
            if cfg.remat_policy == "offload_carry":
                moved = [t for t, updated in zip(carry, group.carry_updated) if updated]
                with self.carry_offload.hooks(moved):
                    carry = checkpoint(_group_step, group, params, args, *carry, **kw)
            else:
                carry = checkpoint(_group_step, group, params, args, *carry, **kw)
        return carry

    def unpatchify(self, x, N_t, N_h, N_w, R_t, R_h, R_w):
        pt, ph, pw = self.cfg.patch_size
        C_out = self.cfg.out_channels
        B = x.shape[0]
        x = x.reshape(B, N_t, N_h, N_w, pt, ph, pw, C_out)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)  # B C_out N_t pt N_h ph N_w pw
        x = x.reshape(B, C_out, N_t * pt, N_h * ph, N_w * pw)
        return x[:, :, :R_t, :R_h, :R_w]


def build_model_config(model_cfg: Dict, vae_out_channels: int = 16,
                       mv_order_map: Optional[Dict] = None,
                       dtype=torch.bfloat16, **overrides) -> MagicDriveSTDiT3Config:
    """Translate a reference-style experiment ``model = dict(...)`` into the
    config. XL/2 presets: depth 28, hidden 1152, patch (1, 2, 2), 16 heads."""
    d = dict(model_cfg)
    kind = d.pop("type", "MagicDriveSTDiT3-XL/2")
    if "XL/2" in kind or "XL-2" in kind:
        d.setdefault("depth", 28)
        d.setdefault("hidden_size", 1152)
        d.setdefault("patch_size", (1, 2, 2))
        d.setdefault("num_heads", 16)
    d.setdefault("in_channels", vae_out_channels)
    if mv_order_map is not None:
        d["mv_order_map"] = mv_order_map
    for k in ("enable_flash_attn", "enable_layernorm_kernel", "enable_xformers",
              "freeze_y_embedder", "freeze_x_embedder", "freeze_old_embedder",
              "freeze_temporal_blocks", "freeze_old_params", "zero_and_train_embedder",
              "only_train_base_blocks", "only_train_temp_blocks",
              "only_train_extra_blocks", "qk_norm_trainable", "use_st_cross_attn",
              "sequence_parallelism_temporal", "input_size", "drop_path",
              "class_dropout_prob", "simulate_sp_size"):
        d.pop(k, None)
    d.update(overrides)
    d["dtype"] = dtype
    return MagicDriveSTDiT3Config.from_dict(d)


# parameters that enter fp32 arithmetic: the RMSNorm weights, the unconditional
# camera parameters and the box-id statistics
_KEEP_FP32 = ("_norm.weight", "uncond_cam", "mean_var")


def needs_cast(name: str, p: torch.Tensor, dtype) -> bool:
    """Whether a forward in ``dtype`` reads parameter ``name`` through a cast
    (floating point, not one of the fp32-kept ones, not in ``dtype`` already)."""
    return p.is_floating_point() and not name.endswith(_KEEP_FP32) and dtype != p.dtype


def cast_model(model: nn.Module, dtype) -> nn.Module:
    """Cast the model to its compute dtype, in place (inference). Parameters that
    enter fp32 arithmetic stay fp32. Buffers are cast where they are used."""
    for name, p in model.named_parameters():
        if needs_cast(name, p, dtype):
            p.data = p.data.to(dtype)
    return model


def compute_params(model: nn.Module, dtype) -> Dict[str, torch.Tensor]:
    """The parameters as a forward in ``dtype`` reads them (training): casts of the
    fp32 masters by ``cast_model``'s rule, for ``torch.func.functional_call``. The
    casts are in the autograd graph, so the grads land on the fp32 masters."""
    return {name: p.to(dtype) if needs_cast(name, p, dtype) else p
            for name, p in model.named_parameters()}
