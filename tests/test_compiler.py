"""The model's jitted programs carry the compiler options of utils/compiler.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from reptext.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig)
from reptext.pipelines import FluxRepTextInpaintPipeline
from reptext.utils import compiler


def test_gemms_go_to_cublas_on_the_gpu():
    assert compiler.COMPILER_OPTIONS == {"xla_gpu_enable_triton_gemm": False}


def test_jit_with_the_options_runs_here():
    f = compiler.jit(lambda a, b: a @ b)
    np.testing.assert_allclose(f(jnp.eye(3), jnp.ones((3, 2))), np.ones((3, 2)))


@pytest.fixture(scope="module")
def tiny_inpaint():
    return FluxRepTextInpaintPipeline.create_inpaint(
        inpaint_cn_cfg=dataclasses.replace(ControlNetConfig().tiny(), extra_condition_channels=4),
        flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
        vae_cfg=VAEConfig().tiny(), clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(),
        pipe_cfg=PipelineConfig(height=64, width=64, num_inference_steps=2,
                                true_guidance_scale=3.0))


@pytest.mark.parametrize("program", [
    "txt2img sampler", "chunk sampler", "inpaint sampler", "vae decode", "t5", "clip"])
def test_pipeline_programs_are_built_with_the_options(tiny_inpaint, monkeypatch, program):
    built = []
    real = compiler.jit
    monkeypatch.setattr(compiler, "jit", lambda f, **kw: built.append(f) or real(f, **kw))
    pipe = dataclasses.replace(tiny_inpaint)   # no cached programs
    {"txt2img sampler": lambda: pipe._get_sampler(2),
     "chunk sampler": lambda: pipe._get_chunk_sampler(2, 1),
     "inpaint sampler": lambda: pipe._get_inpaint_sampler(2, 3.0),
     "vae decode": lambda: pipe._vae_decode,
     "t5": lambda: pipe._t5_apply,
     "clip": lambda: pipe._clip_apply}[program]()
    assert built
