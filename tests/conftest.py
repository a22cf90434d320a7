"""Test configuration: a virtual 8-device CPU mesh with x64 enabled.

Unit/parity tests run on the CPU, where f64 is native (the reference
goldens were produced in f64).  Device timings come from bench.py and
chip_smoke.py on the card, never from these tests.

Tests marked `gpu` need the card: they skip on the CPU.  On a machine with
a GPU run them with  STFEM_TESTS_ON_CARD=1 python -m pytest -m gpu tests/ ;
that variable keeps JAX's default platform instead of forcing the CPU.
jax.config.update is authoritative after import (an environment variable
alone does not switch a platform JAX already chose).
"""
import os

if os.environ.get("STFEM_TESTS_ON_CARD") != "1":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if os.environ.get("STFEM_TESTS_ON_CARD") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The full suite compiles many hundreds of XLA:CPU programs; with all of
    them retained in-process the compiler segfaults reproducibly partway
    through (jaxlib backend_compile_and_load, observed at the same test in
    consecutive runs while each module passes in isolation).  Dropping the
    executable caches per module bounds the accumulation; re-compiles within
    a module still amortize."""
    yield
    jax.clear_caches()
