"""Record bidi golden fixtures from GNU FriBidi (the known-good reference).

Run manually: ``python tests/record_bidi_fixtures.py`` — writes
``tests/fixtures/bidi_cases.json`` with {logical, visual} pairs produced by
libfribidi's fribidi_log2vis (UAX#9 reference implementation). The committed
fixture file is what tests assert against; fribidi is only needed to
re-record.
"""

import ctypes
import ctypes.util
import json
import os

CASES = [
    # pure scripts
    "hello world",
    "مرحبا بالعالم",
    # Arabic + Arabic-script numbers context (EN after AL -> AN)
    "غرفة 101",
    "الطابق 3 شقة 14",
    "سعر 25.50 دولار",
    "خصم 50% اليوم",
    # Arabic + Latin mixes
    "افتح GPS الآن",
    "قهوة Coffee House طازجة",
    "welcome أهلا back",
    "اشرب pepsi بارد",
    # numbers in LTR context stay EN
    "room 101 فندق",
    # punctuation + brackets (N0)
    "قال (مرحبا) ثم ذهب",
    "عنوان [مهم] هنا",
    "قال: hello!",
    "هل تعمل؟",
    "اتصل 555-1234 الآن",
    # quotes / mixed neutral runs
    'قهوة "فاخرة" جدا',
    "أ+ب=ج",
    # directional marks: RLM forces trailing Latin into RTL paragraph order
    "ملف pdf‏",
    "عدد 7 ‎ok",
    # ALM before digits
    "؜123 عدد",
    # Latin base with embedded Arabic
    "open مقهى door",
    "price: 30 ريال",
    "شارع king fahd رقم 12",
    "مكتب (office) رقم 5",
    "تخفيضات 20% على apple iphone 15",
]

# X1-X8 / isolate cases: bidi.py implements the full explicit state machine
# (embedding stack, overrides, isolates, X10 run sequences) as of round 3;
# these fixtures verify it against fribidi. Each records fribidi's output and
# this implementation's, so any divergence on either side trips the test.
EXPLICIT_CASES = [
    "ab \u202Ecd\u202C gh",          # RLO override: UAX#9 reverses "cd"
    "ab \u202Bcd ef\u202C gh",       # RLE embedding around Latin
    "\u0645\u0631\u062d\u0628\u0627 \u2066hi there\u2069 \u0628\u0643",  # LRI isolate in RTL par
    "abc \u202B\u0634\u0627\u0631\u0639 (\u0645\u0647\u0645)\u202C xyz",  # brackets inside an RLE run (N0 with e_dir != sos)
    "\u2068\u0646\u0635\u2069 neutral first",    # FSI: first-strong inside isolate
    "ab \u202Dcd \u0634\u0627\u0631\u0639\u202C gh",   # LRO forces Arabic into LTR order
    "\u0642\u0628\u0644 \u202Aab cd\u202C \u0628\u0639\u062f",  # LRE inside RTL paragraph
    "a \u202B1 + 2\u202C b",          # numbers inside an RLE (EN at odd level)
    "ab \u202B\u0645\u0631 \u202Ecd ef\u202C \u0633\u0644\u0627\u0645\u202C gh",  # nested RLE>RLO
    "\u0627 \u2066one \u2067\u0639\u062f\u062f 5\u2069 two\u2069 \u0628",  # nested isolates LRI>RLI
    "x \u2067ab \u0634 cd\u2069 y",   # RLI around mixed Latin/Arabic
    "\u0623\u0648\u0644 \u2066(a) [b]\u2069 \u0622\u062e\u0631",  # brackets inside LRI in RTL par
    "ab \u2067\u0645\u0647\u0645 gh",  # unmatched RLI (eos vs paragraph level)
    "ab \u202Ecd \u0645\u0631 ef",     # unmatched RLO runs to end of text
    "\u202C\u202C ab \u0634",          # stray PDFs (X7 no-ops)
    "\u2069 ab \u0634 \u2069",         # stray PDIs (X6a with no initiator)
    "\u0645\u0631\u062d\u0628\u0627 \u202E123\u202C \u0628\u0643",  # RLO over digits
]


# directional marks/codes an LTR renderer must not draw (matches
# reptext.conditioning.bidi._REMOVED)
_MARKS = {0x200E, 0x200F, 0x061C, 0x202A, 0x202B, 0x202C, 0x202D, 0x202E,
          0x2066, 0x2067, 0x2068, 0x2069}

_FLAG_SHAPE_MIRRORING = 0x00000001
_FRIBIDI_PAR_LTR = 0x00000110
_FRIBIDI_PAR_RTL = 0x00000111


def log2vis(text: str, lib) -> str:
    """Pure UAX#9 reorder + mirroring via fribidi's low-level API.

    (fribidi_log2vis is not used because it also runs Arabic joining/shaping
    with ligature FEFF placeholders; shaping has its own golden tests.)

    The paragraph direction is computed in Python with the isolate-aware P2
    (skip characters between an isolate initiator and its matching PDI) and
    passed to fribidi explicitly: fribidi 1.0.8's fribidi_get_par_direction
    does NOT skip isolated sequences, which deviates from UAX#9 P2 whenever
    the first strong character sits inside an isolate.
    """
    n = len(text)
    FriBidiChar = ctypes.c_uint32
    str_in = (FriBidiChar * n)(*[ord(c) for c in text])
    pbase = ctypes.c_uint32()

    btypes = (ctypes.c_uint32 * n)()
    lib.fribidi_get_bidi_types(str_in, n, btypes)
    from reptext.conditioning.bidi import base_direction

    ours_rtl = base_direction(text) == "rtl"
    if not any(ch in "⁦⁧⁨" for ch in text):
        # Independent P2 oracle: on isolate-free text fribidi's paragraph
        # direction IS spec-correct, so our base_direction must agree (PAR_ON
        # = no strong char = LTR per P3). Only inside isolates do we fall
        # back to our own isolate-aware P2 (fribidi 1.0.8 predates it) —
        # keeping the oracle non-self-referential everywhere it can be.
        lib.fribidi_get_par_direction.restype = ctypes.c_uint32
        frib_dir = lib.fribidi_get_par_direction(btypes, n)
        assert ours_rtl == (frib_dir == _FRIBIDI_PAR_RTL), (
            f"base_direction disagrees with fribidi P2 on {text!r}")
    pbase.value = _FRIBIDI_PAR_RTL if ours_rtl else _FRIBIDI_PAR_LTR

    brackets = (ctypes.c_uint32 * n)()
    lib.fribidi_get_bracket_types(str_in, n, btypes, brackets)

    levels = (ctypes.c_int8 * n)()
    lib.fribidi_get_par_embedding_levels_ex.restype = ctypes.c_int8
    ok = lib.fribidi_get_par_embedding_levels_ex(
        btypes, brackets, n, ctypes.byref(pbase), levels)
    assert ok, text

    visual = (FriBidiChar * n)(*[ord(c) for c in text])
    # L4 mirroring operates on the logical string given the levels; it is a
    # separate call (fribidi_reorder_line's flag only controls internals).
    lib.fribidi_shape_mirroring(levels, n, visual)
    lib.fribidi_reorder_line.restype = ctypes.c_int8
    ok = lib.fribidi_reorder_line(
        _FLAG_SHAPE_MIRRORING, btypes, n, 0, pbase.value, levels, visual, None)
    assert ok, text
    return "".join(chr(c) for c in visual[:n] if c not in _MARKS)


def main():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from reptext.conditioning.bidi import reorder_visual

    path = ctypes.util.find_library("fribidi") or "libfribidi.so.0"
    lib = ctypes.CDLL(path)
    fixtures = [{"logical": t, "visual": log2vis(t, lib)} for t in CASES]
    for t in EXPLICIT_CASES:
        uax9 = log2vis(t, lib)
        ours = reorder_visual(t)
        if ours != uax9:
            raise SystemExit(
                f"explicit-case divergence from fribidi: {t!r}\n"
                f"  fribidi: {uax9!r}\n  ours:    {ours!r}")
        fixtures.append({"logical": t, "visual": uax9, "explicit": True})
    out_path = os.path.join(os.path.dirname(__file__), "fixtures", "bidi_cases.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(fixtures, f, ensure_ascii=False, indent=1)
    print(f"wrote {len(fixtures)} cases to {out_path}")
    for fx in fixtures:
        print(repr(fx["logical"]), "->", repr(fx["visual"]))


if __name__ == "__main__":
    main()
