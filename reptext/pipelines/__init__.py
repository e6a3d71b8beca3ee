"""End-to-end sampling pipelines mirroring the reference API surface."""

from reptext.pipelines.outputs import FluxPipelineOutput  # noqa: F401
from reptext.pipelines.txt2img import FluxRepTextPipeline  # noqa: F401
from reptext.pipelines.inpaint import (  # noqa: F401
    DEFAULT_NEGATIVE_PROMPT,
    FluxRepTextInpaintPipeline,
    default_inpaint_controlnet_config,
)
