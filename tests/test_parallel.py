"""Mesh + sharding tests (SURVEY.md §2.3).

The sharding layer needs >=8 devices. tests/conftest.py gives the CPU
backend 8 virtual devices; where the live backend has fewer, the scenarios
run in a subprocess pinned to an 8-device CPU backend.
"""

import os
import subprocess
import sys

import jax
import pytest

# e2e sampling / heavy-compile module: slow tier (pytest -m 'not slow' skips)
pytestmark = pytest.mark.slow


@pytest.mark.smoke
def test_mesh_scenarios():
    if jax.default_backend() == "cpu" and len(jax.devices()) >= 8:
        import mesh_scenarios

        mesh_scenarios.main()
        return

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_NUM_CPU_DEVICES="8")
    proc = subprocess.run(
        [sys.executable, "-c", "import runpy; runpy.run_path("
         f"{os.path.join(here, 'mesh_scenarios.py')!r}, run_name='__main__')"],
        env=env, cwd=os.path.dirname(here), capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ALL MESH SCENARIOS OK" in proc.stdout, proc.stdout


def test_make_mesh_validates_factorization():
    # Host-side validation logic; no multi-device backend needed.
    import numpy as np

    from reptext.parallel import make_mesh

    devs = jax.devices()
    if len(devs) == 1:
        with pytest.raises(ValueError):
            make_mesh(dp=2, tp=3, devices=list(devs))
        mesh = make_mesh(devices=list(devs))
        assert mesh.shape == {"dp": 1, "tp": 1}
    else:
        assert np.prod(list(make_mesh(devices=list(devs)).shape.values())) == len(devs)
