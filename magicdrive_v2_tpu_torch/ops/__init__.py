from .attention import dot_product_attention, plain_attention  # noqa: F401
from .flash_attention import flash_attention, flash_attention_plain  # noqa: F401
from .flash_fused import fused_qkv_attention, fused_qkv_attention_plain  # noqa: F401
from .fused_adaln import adaln_modulate, adaln_modulate_plain  # noqa: F401
from .rope import apply_rope, rope_frequencies, rotate_half_interleaved  # noqa: F401
