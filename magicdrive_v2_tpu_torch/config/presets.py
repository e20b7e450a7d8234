"""Config presets of the port: its own copy of the JAX package's
config/presets.py, the names the experiment files under configs/ import."""
from __future__ import annotations

MV_ORDER_MAP = {0: [5, 1], 1: [0, 2], 2: [1, 3], 3: [2, 4], 4: [3, 5], 5: [4, 0]}


def xl2_model(bbox_mode: str = "all-xyz", with_temp_block: bool = True,
              control_skip_temporal: bool = False, sp_size: int = 1,
              force_pad_h_for_sp_size=None, micro_frame_size=None, **overrides) -> dict:
    """MagicDriveSTDiT3-XL/2 as the reference's 424x800 inference config builds it."""
    model = dict(
        type="MagicDriveSTDiT3-XL/2",
        qk_norm=True,
        pred_sigma=False,
        enable_sequence_parallelism=sp_size > 1,
        force_pad_h_for_sp_size=force_pad_h_for_sp_size,
        with_temp_block=with_temp_block,
        use_x_control_embedder=True,
        uncond_cam_in_dim=(3, 7),
        cam_encoder_cls="CamEmbedder",
        cam_encoder_param=dict(input_dim=3, num=7, after_proj=True),
        bbox_embedder_cls="ContinuousBBoxWithTextTempEmbedding",
        bbox_embedder_param=dict(
            n_classes=10, class_token_dim=1152, trainable_class_token=False,
            embedder_num_freq=4, proj_dims=[1152, 512, 512, 1152], mode=bbox_mode,
            minmax_normalize=False, use_text_encoder_init=True, after_proj=True,
            sample_id=True, num_heads=8, mlp_ratio=4.0, qk_norm=True,
            use_scale_shift_table=True, time_downsample_factor=4.5),
        map_embedder_cls="MapControlEmbedding",
        map_embedder_param=dict(conditioning_size=[8, 400, 400],
                                block_out_channels=[16, 32, 96, 256]),
        map_embedder_downsample_rate=4.5,
        micro_frame_size=micro_frame_size,
        frame_emb_cls="CamEmbedderTemp",
        frame_emb_param=dict(input_dim=3, num=4, after_proj=True, num_heads=8,
                             mlp_ratio=4.0, qk_norm=True, use_scale_shift_table=True,
                             time_downsample_factor=4.5),
        control_skip_cross_view=True,
        control_skip_temporal=control_skip_temporal,
    )
    model.update(overrides)
    return model


def rflow(num_sampling_steps=30, cfg_scale=2.0, **kw) -> dict:
    kind = kw.pop("type", "rflow")
    return dict(type=kind, use_timestep_transform=True, cog_style_trans=True,
                num_sampling_steps=num_sampling_steps, cfg_scale=cfg_scale, **kw)


NUSCENES_CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
                    "motorcycle", "bicycle", "pedestrian", "traffic_cone"]


def cogvae(micro_frame_size=None, micro_batch_size=1,
           from_pretrained="./pretrained/CogVideoX-2b") -> dict:
    return dict(type="VideoAutoencoderKLCogVideoX", from_pretrained=from_pretrained,
                subfolder="vae", micro_frame_size=micro_frame_size,
                micro_batch_size=micro_batch_size)


def t5_xxl(from_pretrained="./pretrained/t5-v1_1-xxl", model_max_length=300) -> dict:
    return dict(type="t5", from_pretrained=from_pretrained,
                model_max_length=model_max_length)


def default_mask_ratios() -> dict:
    """~25 % frame-mask training."""
    return {
        "random": 0.01, "intepolate": 0.002, "quarter_random": 0.002,
        "quarter_head": 0.002, "quarter_tail": 0.002, "quarter_head_tail": 0.002,
        "image_random": 0.0, "image_head": 0.22, "image_tail": 0.005,
        "image_head_tail": 0.005,
    }


def img_collate_param(bbox_mode: str = "all-xyz", is_train: bool = True) -> dict:
    return dict(frame_emb="next2top", bbox_mode=bbox_mode, bbox_view_shared=False,
                keyframe_rate=6, bbox_drop_ratio=0.4 if is_train else 0.0,
                bbox_add_ratio=0.1 if is_train else 0.0, bbox_add_num=3,
                bbox_processor_type=2)
