"""CPU glyph-conditioning frontend: Arabic shaping, glyph render, masks, canny."""

from reptext.conditioning.arabic import (  # noqa: F401
    bidi_reorder,
    contains_arabic,
    prepare_display_text,
    shape_arabic,
)
from reptext.conditioning.canny import canny_edges, inverted_canny_rgb  # noqa: F401
from reptext.conditioning.glyph import (  # noqa: F401
    Conditions,
    LineCondition,
    TextLine,
    build_conditions,
    build_line_condition,
    default_font_path,
    render_glyph_line,
)
