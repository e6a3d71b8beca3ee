"""The generation path needs JAX, numpy, scipy, optax, chex, einops and the
standard library only: with the optional packages blocked it still imports
the CLI, pipelines and server, builds Arabic conditions and writes a PNG."""

import os
import subprocess
import sys

_SCRIPT = r"""
import sys
for name in ("flax", "PIL", "orbax", "safetensors", "torch", "transformers"):
    sys.modules[name] = None          # any import of it now raises ImportError

import reptext.cli, reptext.pipelines, reptext.serving  # noqa: E401
from reptext.conditioning import TextLine, build_conditions
from reptext.utils.png import decode_png, encode_png

conds = build_conditions([TextLine("مرحبا بكم", (10, 10)), TextLine("OPEN", (10, 120))],
                         width=320, height=256)
img = conds.glyph_canvas
assert img.max() > 0 and conds.lines[0].bbox[2] > conds.lines[0].bbox[0]
assert (decode_png(encode_png(img)) == img).all()
print("OK")
"""


def test_generation_path_imports_without_optional_packages():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr
