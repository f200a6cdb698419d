"""Test harness config: force CPU with 8 virtual devices so multi-device
sharding is testable without accelerators (SURVEY.md §4 test plan, item (d)).

Must run before jax is imported anywhere: XLA_FLAGS must be set before the
CPU client exists. The suite runs on the CPU unless JAX_PLATFORMS names a
platform — the gpu-marked tests run on a card with JAX_PLATFORMS=cuda,cpu.
"""

import json
import os
import pathlib

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from jpeg_tpu.utils import synth

_REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def photo():
    """240x320 RGB photographic-like image generated from a seed (textured
    regions, hard edges, sensor noise): q75 4:2:0 MCUs peak near 580 bits
    and q95 blocks near 340 bits, so it exercises the device packer's
    scale-1 budget and its scale-2 retry rung."""
    return synth.photo(240, 320, seed=0)


@pytest.fixture(scope="session")
def photo_square():
    """256x256 RGB photographic-like image from a second seed."""
    return synth.photo(256, 256, seed=7)


@pytest.fixture(scope="session")
def reference_src():
    """Source tree of the reference C project (BASELINE.json
    reference_path); tests that need it skip where it is not mounted."""
    ref = json.loads((_REPO / "BASELINE.json").read_text())["reference_path"]
    path = pathlib.Path(ref) / "src"
    if not path.exists():
        pytest.skip(f"reference tree {path} not present")
    return path


def psnr(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return np.inf
    return 10.0 * np.log10(255.0**2 / mse)
