"""Evaluation metrics: the OCR glyph-accuracy judge (the north-star metric
the north star asks for — "OCR-verified glyph accuracy"; the reference
validates text fidelity only visually, SURVEY.md §4)."""

from reptext.eval.ocr import (  # noqa: F401
    CHARSET,
    OCRJudge,
    char_accuracy,
    decode_logits,
    load_judge,
    load_judge_ensemble,
    prepare_crop,
    save_judge,
    train_judge,
)
