"""Arabic shaping + bidi tests with hand-derived golden forms."""

from reptext.conditioning import (
    bidi_reorder,
    contains_arabic,
    prepare_display_text,
    shape_arabic,
)


def test_contains_arabic():
    assert contains_arabic("سلام")
    assert contains_arabic("hello سلام")
    assert not contains_arabic("hello 123")


def test_shape_salam():
    # سلام: seen-initial, lam-medial, alef-final(lam-alef not applicable: lam
    # is medial-joined to seen)... actually س ل ا م: seen init, lam+alef is a
    # ligature in FINAL form (prev seen joins), meem isolated (alef blocks).
    shaped = shape_arabic("سلام")
    assert shaped == "ﺳﻼﻡ"  # seen-init, lam-alef-final, meem-iso


def test_shape_alsalam():
    # السلام: alef-iso, lam-init, seen-medial, lam-alef-final, meem-iso
    shaped = shape_arabic("السلام")
    assert shaped == "ﺍﻟﺴﻼﻡ"


def test_shape_muhammad():
    # محمد: meem-init, hah-medial, meem-medial, dal-final
    shaped = shape_arabic("محمد")
    assert shaped == "ﻣﺤﻤﺪ"


def test_shape_isolated_letter():
    assert shape_arabic("ب") == "ﺏ"  # beh isolated


def test_shape_with_diacritics_transparent():
    # beh + fatha + noon: diacritic must not break joining: beh-init, noon-final
    shaped = shape_arabic("بَن")
    assert shaped == "ﺑَﻦ"


def test_shape_preserves_non_arabic():
    assert shape_arabic("abc 123") == "abc 123"


def test_bidi_pure_rtl_reverses():
    shaped = shape_arabic("محمد")
    vis = bidi_reorder(shaped)
    assert vis == shaped[::-1]


def test_bidi_mixed_base_rtl():
    # Arabic first -> base RTL; Latin run keeps internal order but moves left.
    out = bidi_reorder("عرب abc")
    assert out == "abc " + "عرب"[::-1]


def test_bidi_mixed_base_ltr():
    # Latin first -> base LTR; Arabic run reversed in place.
    out = bidi_reorder("abc عرب def")
    assert out == "abc " + "عرب"[::-1] + " def"


def test_bidi_numbers_in_rtl_stay_ltr():
    out = bidi_reorder("عرب 123")
    assert "123" in out          # digits not reversed
    assert out == "123 " + "عرب"[::-1]


def test_bidi_bracket_mirroring():
    out = bidi_reorder("(عرب)")
    # whole string is one RTL run: reversed, brackets mirrored
    assert out == "(" + "عرب"[::-1] + ")"


def test_prepare_display_text_latin_identity():
    assert prepare_display_text("Shakker Labs") == "Shakker Labs"


def test_prepare_display_text_arabic():
    out = prepare_display_text("السلام")
    # shaped then reversed for LTR rendering
    assert out == "ﺍﻟﺴﻼﻡ"[::-1]


# --- Extended Arabic-script letters (Persian / Urdu / Uyghur), Presentation
# Forms-A. The fork is titled "Arabic-text-image-generation"; the reference
# renders these raw (RepText/infer.py:74-76). Golden forms hand-derived from
# the Unicode FB50 block chart. ---


def test_shape_persian_parcham():
    # پرچم (flag): peh-init, reh-final, tcheh-init, meem-final
    assert shape_arabic("پرچم") == (
        "ﭘﺮﭼﻢ"
    )


def test_shape_persian_gol_and_zhaleh():
    # گل (flower): gaf-init, lam-final-form
    assert shape_arabic("گل") == "ﮔﻞ"  # gaf-init FB94, lam-FINAL FEDE (no joiner after)
    # ژاله (dew): jeh right-joining -> isolated before alef; alef final? no —
    # jeh doesn't join forward, so alef isolated; lam-init, heh-final
    assert shape_arabic("ژاله") == (
        "ﮊﺍﻟﻪ"
    )


def test_shape_farsi_yeh_medial():
    # سیب (apple): seen-init, farsi-yeh-medial, beh-final
    assert shape_arabic("سیب") == "ﺳﯿﺐ"  # farsi-yeh MEDIAL FBFF


def test_shape_urdu_tteh_ddal_rreh():
    # ٹماٹر (tomato): tteh-init, meem-medial, alef-final, tteh-init, reh-final
    assert shape_arabic("ٹماٹر") == (
        "ﭨﻤﺎﭨﺮ"
    )
    # ڈاک (mail): ddal right-joining isolated, alef isolated... ddal has no
    # initial -> isolated; alef doesn't receive join -> isolated; kaf final? no
    # prev alef doesn't join forward -> kaf isolated
    assert shape_arabic("ڈاک") == "ﮈﺍﮎ"
    # گاڑی (car): gaf-init? no — gaf then alef: alef has no initial, gaf joins
    # forward but alef only joins backward -> gaf-init + alef-final; rreh
    # right-joining isolated (alef blocks), farsi-yeh final
    assert shape_arabic("گاڑی") == (
        "ﮔﺎﮌﯼ"  # gaf-init, alef-final, rreh-iso, farsi-yeh-iso
    )


def test_shape_urdu_heh_doachashmee_and_yeh_barree():
    # تھے (were): teh-init, heh-doachashmee-medial, yeh-barree-final
    assert shape_arabic("تھے") == "ﺗﮭﮯ"  # heh-doachashmee MEDIAL FBAD
    # کیجیۓ: yeh barree with hamza final after joining letter
    assert shape_arabic("نۓ") == "ﻧﮱ"


def test_shape_urdu_heh_goal_noon_ghunna():
    # ماہ: meem-init, alef-final, heh-goal isolated (alef blocks)
    assert shape_arabic("ماہ") == "ﻣﺎﮦ"
    # میں (in): meem-init, farsi-yeh-medial, noon-ghunna-final
    assert shape_arabic("میں") == "ﻣﯿﮟ"  # farsi-yeh MEDIAL FBFF


def test_shape_uyghur_e_and_oe():
    # ئۆگىنىش fragment: oe right-joining; E dual-joining
    assert shape_arabic("ېۆ") == "ﯦﯚ"  # E-init, OE-final
    assert shape_arabic("ۇ") == "ﯗ"              # U isolated


def test_shape_alef_wasla():
    # ٱلله fragment: alef-wasla isolated at start before lam (receives no
    # join from nothing; doesn't join forward) then lam-init, lam-medial,
    # heh-final
    out = shape_arabic("ٱلله")
    assert out[0] == "ﭐ"


def test_extended_letters_roundtrip_through_display():
    # prepare_display_text shapes + reverses RTL for an LTR renderer
    txt = "پاکستان"  # پاکستان
    vis = prepare_display_text(txt)
    assert len(vis) == len(txt)
    # visually first glyph (leftmost) = last logical char: noon, isolated
    # because the preceding alef does not join forward
    assert vis[0] == "ﻥ"  # noon ISOLATED (preceding alef blocks the join)
    assert vis[-1] == "ﭘ"  # peh initial (logical first, visually rightmost)
