"""Test configuration: run on the CPU with 8 virtual devices unless the
caller picks a platform.

The virtual devices exercise multi-device sharding (shard_map over a
Mesh) without accelerator hardware. Tests marked `gpu` need the card;
they skip here and run on the GPU through `python chip_smoke.py`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import subprocess

import numpy as np
import pytest

REF_SRC = "/root/reference/QuicKmer.c"
REF_BIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       ".refbin", "quicKmer2")


@pytest.fixture(scope="session")
def ref_binary():
    """Compile the reference binary once for differential testing
    (SURVEY.md section 7: differential tests are the decisive oracle).
    Skips when the reference source is not on this machine."""
    if not os.path.exists(REF_BIN):
        if not os.path.exists(REF_SRC):
            pytest.skip(f"reference source {REF_SRC} is not present")
        os.makedirs(os.path.dirname(REF_BIN), exist_ok=True)
        subprocess.run(
            ["gcc", "-O2", "-pthread", "-std=c99", "-o", REF_BIN, REF_SRC, "-lm"],
            check=True, capture_output=True)
    return REF_BIN


@pytest.fixture()
def gpu():
    """The first JAX device when it is a GPU; skips otherwise. Decided
    here, at run time, so every xdist worker collects the same tests."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture()
def rng():
    return np.random.default_rng(0xC0FFEE)
