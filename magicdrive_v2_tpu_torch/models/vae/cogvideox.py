"""CogVideoX VAE: only the latent-size arithmetic so far (the sampler needs it
to shape the starting latent); encode and decode are not ported yet."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


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
