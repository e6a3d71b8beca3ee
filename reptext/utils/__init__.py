"""Utilities: image pre/post-processing, profiling, logging."""

from reptext.utils.image import postprocess_images, preprocess_images  # noqa: F401
