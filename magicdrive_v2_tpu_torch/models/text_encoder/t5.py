"""Text encoders of the port, registered as "t5-dummy" (``DummyTextEncoder``,
deterministic) and "t5" (``T5Encoder``, T5-XXL through ``transformers`` from a
local snapshot).

API: ``encode(texts) -> {y: (B, 1, L, D), mask: (B, L)}`` and ``null(n)``, the
DiT's learned null caption embedding set through ``set_null_embedding``.
"""
from __future__ import annotations

import hashlib
import html
import os
import re
from typing import List, Optional

import numpy as np
import torch

from ...registry import MODELS
from ...utils.misc import resolve_device

try:
    import ftfy
    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False

_URL_RE = re.compile(r"(?:https?|ftp):\/\/[^\s]+|www\.[^\s]+")
_BAD_PUNCT_RE = re.compile(r"[#®•©™&@·º½¾¿¡§~\)\(\]\[\}\{\|\\/\*]{1,}")
_WS_RE = re.compile(r"\s+")


def basic_clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def clean_caption(caption: str) -> str:
    """Fix encoding, strip urls/html/bad punctuation runs, collapse whitespace."""
    caption = basic_clean(caption)
    caption = _URL_RE.sub("", caption)
    try:
        from bs4 import BeautifulSoup
        caption = BeautifulSoup(caption, features="html.parser").text
    except Exception:
        pass
    caption = _BAD_PUNCT_RE.sub(r" ", caption)
    caption = _WS_RE.sub(" ", caption)
    return caption.strip()


def text_preprocessing(text: str, use_text_preprocessing: bool = True) -> str:
    if use_text_preprocessing:
        return clean_caption(clean_caption(text))
    return text.lower().strip()


@MODELS.register_module("t5")
class T5Encoder:
    """T5 encoder of ``transformers`` from a local snapshot directory. Raises
    ``OSError`` when the directory is missing (nothing is downloaded) and
    ``ImportError`` without ``transformers``; ``MagicDrivePipeline.from_config``
    then falls back to "t5-dummy"."""

    def __init__(self, from_pretrained: str, model_max_length: int = 120,
                 device="cuda", dtype=torch.float32, **kwargs):
        if not os.path.isdir(from_pretrained):
            raise OSError(f"T5 snapshot {from_pretrained!r} is not a local directory")
        from transformers import AutoTokenizer, T5EncoderModel
        self.device = resolve_device(device)
        self.tokenizer = AutoTokenizer.from_pretrained(from_pretrained,
                                                       local_files_only=True)
        self.model = T5EncoderModel.from_pretrained(
            from_pretrained, local_files_only=True, torch_dtype=dtype).to(self.device).eval()
        self.model_max_length = model_max_length
        self.output_dim = self.model.config.d_model
        self.null_y: Optional[torch.Tensor] = None

    @torch.no_grad()
    def encode(self, texts: List[str]):
        tok = self.tokenizer([text_preprocessing(t) for t in texts],
                             max_length=self.model_max_length, padding="max_length",
                             truncation=True, return_attention_mask=True,
                             add_special_tokens=True, return_tensors="pt")
        ids, mask = tok["input_ids"].to(self.device), tok["attention_mask"].to(self.device)
        emb = self.model(input_ids=ids, attention_mask=mask)[0]
        return dict(y=emb[:, None], mask=mask)

    def set_null_embedding(self, y_embedding: torch.Tensor):
        self.null_y = y_embedding.detach()

    def null(self, n: int) -> torch.Tensor:
        assert self.null_y is not None, "call set_null_embedding(y_embedding) first"
        return self.null_y[None, None].expand((n, 1) + tuple(self.null_y.shape))


@MODELS.register_module("t5-dummy")
class DummyTextEncoder:
    """Deterministic stand-in with the T5 encoder's API: embeddings are seeded
    per text from a hash (numpy), so both packages produce the same arrays."""

    def __init__(self, model_max_length: int = 120, output_dim: int = 4096,
                 device="cuda", **kwargs):
        self.model_max_length = model_max_length
        self.output_dim = output_dim
        self.device = resolve_device(device)
        self.null_y: Optional[torch.Tensor] = None

    def encode(self, texts: List[str]):
        L, D = self.model_max_length, self.output_dim
        ys, masks = [], []
        for t in texts:
            words = text_preprocessing(t).split()[:L]
            seed = int.from_bytes(hashlib.sha256(t.encode()).digest()[:4], "little")
            rng = np.random.default_rng(seed)
            y = rng.standard_normal((L, D), dtype=np.float32) * 0.1
            mask = np.zeros((L,), np.int32)
            mask[: max(1, len(words) + 1)] = 1
            y[len(words) + 1:] = 0.0
            ys.append(y)
            masks.append(mask)
        return dict(y=torch.from_numpy(np.stack(ys))[:, None].to(self.device),
                    mask=torch.from_numpy(np.stack(masks)).to(self.device))

    def set_null_embedding(self, y_embedding: torch.Tensor):
        self.null_y = y_embedding.detach()

    def null(self, n: int) -> torch.Tensor:
        if self.null_y is None:
            return torch.zeros((n, 1, self.model_max_length, self.output_dim),
                               device=self.device)
        return self.null_y[None, None].expand((n, 1) + tuple(self.null_y.shape))

