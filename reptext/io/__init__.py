"""Weight conversion (HF safetensors -> JAX pytrees) and checkpointing."""

from reptext.io.convert import (  # noqa: F401
    convert_clip,
    convert_controlnet,
    convert_flux_transformer,
    convert_t5,
    convert_vae,
    load_safetensors_state,
)
