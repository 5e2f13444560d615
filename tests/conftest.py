"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's test strategy of running GPU-free in CI
(reference: .github/workflows/build-ubuntu.yml:226) — we force the JAX CPU
backend with 8 virtual devices so sharding/collective code paths are
exercised without accelerator hardware.
"""

import os

# Force the CPU backend: tests run on the local virtual 8-device CPU mesh
# even on a machine with a GPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it is
# set and the checkout's .jax_cache otherwise (colmap_tpu.util.compile_cache,
# applied when the package is imported). Do NOT enable
# jax_persistent_cache_enable_xla_caches="all" here: persisted XLA:CPU AOT
# executables are stamped with the host's CPU features, and loading one
# compiled under other features aborts the process.

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)
