"""Vendored tokenizer tests: parity against HF implementations on shared files.

CLIP: our pure-Python byte-BPE vs transformers.CLIPTokenizer loading the SAME
vocab.json/merges.txt. T5: our protobuf-wire reader + unigram Viterbi vs the
`tokenizers` Unigram model built from the SAME piece table (the oracle the HF
fast T5 tokenizer runs on).
"""

import json
import struct

import pytest

from reptext.text import CLIPBPETokenizer, SentencePieceUnigram
from reptext.text.clip_bpe import bytes_to_unicode
from reptext.text.spm import (
    CONTROL,
    NORMAL,
    UNKNOWN,
    normalize,
    parse_model_proto,
)

# ------------------------------------------------------------------ CLIP BPE


def _tiny_clip_files(tmp_path):
    """A small but structurally real CLIP vocab: byte alphabet + merges."""
    byte_chars = list(bytes_to_unicode().values())
    vocab = {}
    for c in byte_chars:
        vocab[c] = len(vocab)
    for c in byte_chars:
        vocab[c + "</w>"] = len(vocab)
    merges = [
        ("h", "e"), ("l", "l"), ("he", "ll"), ("o</w>", ""),  # placeholder fix below
    ]
    # real merge list (pairs of existing symbols); build hello/world pieces
    merges = [
        ("h", "e"), ("l", "l"), ("ll", "o</w>"), ("he", "llo</w>"),
        ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d</w>"),
        ("1", "2"),
    ]
    for a, b in merges:
        if a + b not in vocab:
            vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)

    (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges),
        encoding="utf-8",
    )
    return tmp_path


PROMPTS = [
    "hello world",
    "Hello, WORLD!  multiple   spaces",
    'a sign that says "hello"',
    "hello-world 123",
    "café naïve",          # accents (no merges -> byte pieces)
    "مرحبا بالعالم",        # Arabic
    "hello 你好 world",     # CJK spacing path
    "",
]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_clip_bpe_matches_transformers(tmp_path, prompt):
    from transformers import CLIPTokenizer

    d = _tiny_clip_files(tmp_path)
    ours = CLIPBPETokenizer.from_dir(str(d))
    hf = CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt"))

    assert ours.tokenize(prompt) == hf.tokenize(prompt), prompt
    want = hf(prompt, padding="max_length", max_length=77, truncation=True)["input_ids"]
    assert ours.encode(prompt, max_length=77) == want, prompt


def test_clip_bpe_decode_roundtrip(tmp_path):
    d = _tiny_clip_files(tmp_path)
    ours = CLIPBPETokenizer.from_dir(str(d))
    ids = ours.encode("hello world", max_length=77)
    assert ours.decode(ids) == "hello world"


# ------------------------------------------------- SentencePiece wire format


def _write_varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _serialize_model_proto(pieces):
    """Minimal ModelProto writer (field 1: SentencePiece{piece,score,type})."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        pb = piece.encode("utf-8")
        body += b"\x0a" + _write_varint(len(pb)) + pb          # field 1, wire 2
        body += b"\x15" + struct.pack("<f", score)             # field 2, wire 5
        body += b"\x18" + _write_varint(ptype)                 # field 3, wire 0
        out += b"\x0a" + _write_varint(len(body)) + body       # outer field 1
    # unrelated trailing field (e.g. trainer_spec, field 2) must be skipped
    out += b"\x12" + _write_varint(3) + b"abc"
    return bytes(out)


TINY_PIECES = [
    ("<pad>", 0.0, CONTROL),
    ("</s>", 0.0, CONTROL),
    ("<unk>", 0.0, UNKNOWN),
    ("▁", -4.0, NORMAL),
    ("▁hello", -1.5, NORMAL),
    ("▁world", -1.8, NORMAL),
    ("▁he", -3.0, NORMAL),
    ("llo", -3.5, NORMAL),
    ("w", -5.0, NORMAL),
    ("o", -5.1, NORMAL),
    ("r", -5.2, NORMAL),
    ("l", -5.3, NORMAL),
    ("d", -5.4, NORMAL),
    ("h", -5.5, NORMAL),
    ("e", -5.6, NORMAL),
    ("▁a", -2.5, NORMAL),
    ("b", -5.7, NORMAL),
    ("a", -5.8, NORMAL),
]


def test_model_proto_roundtrip():
    data = _serialize_model_proto(TINY_PIECES)
    got = parse_model_proto(data)
    assert [(p, t) for p, _, t in got] == [(p, t) for p, _, t in TINY_PIECES]
    for (_, gs, _), (_, ws, _) in zip(got, TINY_PIECES):
        assert gs == pytest.approx(ws, abs=1e-6)  # fp32 wire encoding


def test_spm_file_loading(tmp_path):
    path = tmp_path / "spiece.model"
    path.write_bytes(_serialize_model_proto(TINY_PIECES))
    sp = SentencePieceUnigram.from_file(str(path))
    assert sp.piece_to_id["▁hello"] == 4
    assert sp.unk_id == 2 and sp.eos_id == 1 and sp.pad_id == 0


@pytest.mark.parametrize("text", [
    "hello world",
    "hello  world ",
    "a held word",        # forces viterbi over sub-pieces
    "hello xyz world",    # xyz has no pieces -> unk fallbacks
    "ab ba",
])
def test_spm_viterbi_matches_tokenizers_unigram(text):
    import tokenizers
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers

    vocab = [(p, s) for (p, s, _t) in TINY_PIECES]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2, byte_fallback=False))
    tok.normalizer = normalizers.Sequence(
        [normalizers.NFKC(), normalizers.Replace(tokenizers.Regex(r"\s+"), " "),
         normalizers.Strip()]
    )
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="first", split=False
    )

    ours = SentencePieceUnigram(TINY_PIECES)
    got = ours.encode(text, add_eos=False, max_length=None)
    want = tok.encode(text).ids
    assert got == want, (text, [TINY_PIECES[i][0] for i in got],
                         [TINY_PIECES[i][0] for i in want])


def test_spm_encode_eos_pad():
    sp = SentencePieceUnigram(TINY_PIECES)
    ids = sp.encode("hello", max_length=8, add_eos=True, pad_to_max=True)
    assert len(ids) == 8
    assert ids[-1] == sp.pad_id or ids[ids.index(1):] == [1] + [0] * (7 - ids.index(1))
    assert sp.decode(ids) == "hello"


def test_spm_normalize():
    assert normalize("hello  world") == "▁hello▁world"
    assert normalize("") == ""
    # NFKC: fullwidth -> ascii
    assert normalize("Ｈi") == "▁Hi"


def test_cli_tokenize_uses_vendored_tokenizers(tmp_path):
    """cli._tokenize must work from checkpoint files with no transformers."""
    from reptext.cli import _tokenize
    from reptext.configs import CLIPConfig, T5Config

    (tmp_path / "tokenizer").mkdir()
    _tiny_clip_files(tmp_path / "tokenizer")
    (tmp_path / "tokenizer_2").mkdir()
    (tmp_path / "tokenizer_2" / "spiece.model").write_bytes(
        _serialize_model_proto(TINY_PIECES))

    clip_ids, t5_ids = _tokenize(
        "hello world", CLIPConfig(), T5Config(), str(tmp_path))
    assert clip_ids.shape == (1, 77)
    assert t5_ids.shape == (1, 512)
    ours_clip = CLIPBPETokenizer.from_dir(str(tmp_path / "tokenizer"))
    assert list(map(int, clip_ids[0])) == ours_clip.encode("hello world", 77)
    sp = SentencePieceUnigram(TINY_PIECES)
    assert list(map(int, t5_ids[0][:3])) == sp.encode("hello world", add_eos=True)
