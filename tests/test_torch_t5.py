"""PyTorch port, the T5 text encoder (``models/text_encoder/t5.py`` ``T5Encoder``)
against the JAX package's (``FlaxT5EncoderModel`` loaded ``from_pt``) on one
local snapshot written here: a tiny T5 v1.1 encoder (gated-gelu, relative
position buckets) saved by ``save_pretrained`` with seeded random weights, and
a word-level fast tokenizer that ends every text with ``</s>``. Nothing is
downloaded.

Tolerance: 2e-5 absolute on embeddings of order 0.1-1 (two fp32
implementations of one encoder); masks and token counts exactly.
"""
import numpy as np
import pytest
import torch

from test_torch_common import assert_close

from magicdrive_v2_tpu.models.text_encoder.t5 import T5Encoder as JT5
from magicdrive_v2_tpu_torch.models.text_encoder.t5 import T5Encoder as TT5

WORDS = ["<pad>", "</s>", "<unk>", "a", "driving", "scene", "image", "at", "boston",
         "singapore", ".", "rain", "night", "many", "cars", "and", "pedestrians", "parked",
         "truck", "turn", "left", ","]
L = 12
CAPTIONS = ["A driving scene image at boston. Rain, many cars.",
            "A driving scene image at singapore. Night, pedestrians and a parked truck, "
            "turn left and a truck and many cars and pedestrians.",  # over L tokens
            "A driving scene image at hollywood."]  # an unknown word


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast, T5Config, T5EncoderModel
    path = tmp_path_factory.mktemp("t5_tiny")
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                      special_tokens=[("</s>", 1)])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(path)
    cfg = T5Config(vocab_size=len(WORDS), d_model=32, d_kv=8, d_ff=48, num_layers=2,
                   num_heads=4, relative_attention_num_buckets=8,
                   relative_attention_max_distance=16, feed_forward_proj="gated-gelu",
                   dropout_rate=0.0, pad_token_id=0, eos_token_id=1, decoder_start_token_id=0)
    torch.manual_seed(0)
    T5EncoderModel(cfg).save_pretrained(path)
    return str(path)


def test_t5_encoder_matches_jax_flax_from_pt(snapshot):
    ref = JT5(snapshot, model_max_length=L, local_files_only=True)
    enc = TT5(snapshot, model_max_length=L, device="cpu")
    assert enc.output_dim == ref.output_dim == 32 and enc.model_max_length == L
    out, want = enc.encode(CAPTIONS), ref.encode(CAPTIONS)
    assert out["y"].shape == (3, 1, L, 32) and out["y"].dtype == torch.float32
    assert_close(out["y"], np.asarray(want["y"]), 2e-5)
    np.testing.assert_array_equal(out["mask"].numpy(), np.asarray(want["mask"]))
    # the first caption: 11 words and </s>; the second truncated at L; every row
    # of the third but the pad embedded
    assert out["mask"].sum(1).tolist() == [12, 12, 8]
    ids = enc.tokenizer(CAPTIONS[2:], max_length=L, padding="max_length", truncation=True)
    assert ids["input_ids"][0][5:8] == [2, 10, 1]  # <unk> . </s>
    null = torch.randn(L, 32)
    enc.set_null_embedding(null)
    assert torch.equal(enc.null(2), null[None, None].expand(2, 1, L, 32))
    with pytest.raises(OSError, match="not a local directory"):
        TT5(snapshot + "_missing", device="cpu")
