"""Checks that need the GPU: the Triton time-solve kernel as compiled for
the card, and the float-float error-free transforms under the GPU
compiler.  They skip inside the test where JAX finds no GPU; run them on
the card with  STFEM_TESTS_ON_CARD=1 python -m pytest -m gpu tests/ ."""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform})")
    return dev


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_time_solve_kernel_on_card(gpu, dt):
    """The compiled kernel agrees with the XLA form on a masked-tail N."""
    import jax
    import jax.numpy as jnp

    from stfem_tpu.ops.pallas_timesolve import (time_solve_triton,
                                                time_solve_xla)

    S, nt, N = 32, 3, 40 ** 3 + 17
    dtype = jnp.dtype(dt)
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((S * nt, N)), dtype)
    G = jnp.asarray(0.3 * rng.standard_normal((nt, nt, N)), jnp.float32)
    C = jnp.asarray(rng.uniform(-0.9, 0.9, (nt, N)), jnp.float32)
    k = jax.jit(lambda *a: time_solve_triton(*a, S, nt, dtype))(w, G, C)
    x = jax.jit(lambda *a: time_solve_xla(*a, S, nt, dtype))(w, G, C)
    k, x = np.asarray(k, np.float64), np.asarray(x, np.float64)
    tol = 1e-5 if dt == "float32" else 2.0 ** -7
    assert np.max(np.abs(k - x)) <= tol * np.max(np.abs(x))


def test_two_prod_exact_on_card(gpu):
    """The split product stays error-free under the GPU compiler (which may
    contract multiplies and adds into fused multiply-adds)."""
    import jax
    import jax.numpy as jnp

    from stfem_tpu.ops.floatfloat import _two_prod

    rng = np.random.default_rng(1)
    n = 1 << 18
    a = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n)))
    b = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n)))
    a, b = a.astype(np.float32), b.astype(np.float32)
    p, e = jax.jit(_two_prod)(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, a.astype(np.float64)
                                  * b.astype(np.float64))
