"""Test configuration: the tests run on the CPU with 8 virtual devices, so
mesh/sharding tests need no accelerator (SURVEY §4.3).

Set SDR_TESTS_ON_GPU=1 to keep JAX on the GPU instead; only then do the
`gpu`-marked tests run (`SDR_TESTS_ON_GPU=1 python -m pytest -m gpu tests/`
on the card).  Whether there is a GPU is decided in the `gpu` fixture,
never at import time.
"""

import os

if os.environ.get("SDR_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("SDR_TESTS_ON_GPU") != "1":
    # in case a plugin imported jax before this file ran
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU."""
    from sdr_tpu import device
    if device.backend() != "gpu":
        pytest.skip("needs a GPU: run with SDR_TESTS_ON_GPU=1 on the card")
