"""Model assemblies: FLUX MMDiT transformer and RepText ControlNet."""

from reptext.models.flux import FluxTransformer2D  # noqa: F401
from reptext.models.controlnet import RepTextControlNet  # noqa: F401
from reptext.models.multi_controlnet import (  # noqa: F401
    ControlNetEntry,
    MultiControlNet,
)
