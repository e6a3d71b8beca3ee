"""reptext: multilingual visual-text rendering in JAX (FLUX + RepText).

A from-scratch rebuild of the capabilities of the RepText FLUX ControlNet stack
(reference: DeepNeuralAI313/Arabic-text-image-generation-RepText):

- ``reptext.conditioning``: CPU glyph-conditioning frontend (Arabic shaping/bidi,
  TrueType glyph rendering, canny edges, position/region masks).
- ``reptext.ops``: core tensor ops: attention dispatch (cuDNN flash attention on
  the GPU, XLA einsum reference), RoPE, latent packing.
- ``reptext.nn``: the module layer (``nn.module``) and the models' building
  blocks (MMDiT blocks, embeddings, VAE, CLIP, T5).
- ``reptext.models``: FluxTransformer2D and RepText ControlNet assemblies.
- ``reptext.sampling``: FlowMatch Euler schedule + fused lax.scan denoise loop.
- ``reptext.parallel``: device mesh + sharding rules (dp/tp/sp).
- ``reptext.io``: torch-safetensors -> JAX weight conversion, orbax checkpoints.
- ``reptext.pipelines``: txt2img + inpaint pipelines mirroring the reference API
  surface (RepText/pipeline_flux_controlnet.py, pipeline_flux_controlnet_inpaint.py).
"""

__version__ = "0.1.0"

from reptext.configs import (  # noqa: F401
    ControlNetConfig,
    FluxConfig,
    PipelineConfig,
    VAEConfig,
)
