"""Compiler options of the model's jitted programs.

XLA's Triton GEMM emitter is off: every matmul goes to cuBLAS. With it on,
the compiled inpaint sampler gave all-NaN latents in about 4 of 10 calls on
an H100 (JAX 0.9.0), at random for the same device inputs, and only while
its RepText ControlNet ran at batch 4 (two text lines times the CFG pair);
its finite results were bitwise equal, the mark of a value read from memory
that no kernel wrote. With the emitter off, every call was finite and a
step cost the same. ``xla_gpu_*`` options are ignored off the GPU.
"""

from __future__ import annotations

import jax

COMPILER_OPTIONS = {"xla_gpu_enable_triton_gemm": False}


def jit(fun, **kwargs):
    """``jax.jit`` with the model's compiler options."""
    return jax.jit(fun, compiler_options=COMPILER_OPTIONS, **kwargs)
