"""Structured pipeline output (reference public return contract).

The reference returns ``FluxPipelineOutput(images=...)`` where ``images`` is a
list of PIL images for ``output_type="pil"`` or an ndarray otherwise
(RepText/pipeline_flux_controlnet.py:1132-1148). This framework's pipelines
default to raw uint8 numpy (``output_type="np"``, ``return_dict=False``) but
honor the reference contract when asked.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class FluxPipelineOutput:
    """``images``: list[PIL.Image.Image] | np.ndarray | packed latents."""

    images: Any

    def __iter__(self):
        # tuple-compatibility: the reference returns ``(image,)`` when
        # ``return_dict=False`` — allow ``images, = out`` style unpacking
        yield self.images

    def __getitem__(self, i):
        return (self.images,)[i]


def to_pil_images(images_uint8) -> list:
    """uint8 [B, H, W, 3] -> list of PIL images (VaeImageProcessor.postprocess
    parity, invoked at RepText/pipeline_flux_controlnet.py:1139-1140).
    Pillow is needed only here; output_type="np" needs nothing beyond numpy."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError('output_type="pil" needs Pillow; use output_type="np" '
                          "for uint8 arrays") from e

    return [Image.fromarray(im) for im in images_uint8]
