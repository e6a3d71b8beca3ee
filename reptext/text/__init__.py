"""Self-contained tokenization (no transformers/sentencepiece dependency).

The reference ships its tokenizers through the HF pipeline
(RepText/pipeline_flux_controlnet.py:194-226: CLIPTokenizer + T5TokenizerFast
loaded by from_pretrained). Here both are vendored pure-Python so the runtime
is dependency-free: a CLIP byte-BPE (vocab.json + merges.txt) and a
SentencePiece unigram encoder with a protobuf-wire-format reader for
spiece.model.
"""

from reptext.text.clip_bpe import CLIPBPETokenizer  # noqa: F401
from reptext.text.spm import SentencePieceUnigram  # noqa: F401


def pad_to_common_length(a, b, pad_id: int = 0):
    """Right-pad two [B, S] token-id arrays to a common sequence length.

    True-CFG paths concatenate negative and positive prompt embeddings on the
    batch axis (reference pipeline_flux_controlnet_inpaint.py:1033-1035), so
    their token sequences must match in length; HF tokenizers pad to
    max_length, but the hash-id demo fallback does not.
    """
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    s = max(a.shape[1], b.shape[1])
    out = []
    for x in (a, b):
        if x.shape[1] < s:
            x = np.pad(x, [(0, 0), (0, s - x.shape[1])],
                       constant_values=pad_id)
        out.append(x)
    return out[0], out[1]
