"""Float-float (double-single) residual arithmetic parity vs native f64.

The ff path is the bench's default IR residual (ops/floatfloat.py): on CPU
f64 is native, so the f64 results here are the exact oracle.  The contract is
~2^-48-level agreement -- far below the 1e-9 absolute accuracy the
true-1e-8 iterative refinement needs even under the catastrophic
cancellation of r = b - A x with x converged to the f32 floor.
"""
import jax.numpy as jnp
import numpy as np

from stfem_tpu.mesh.grid import StructuredMesh
from stfem_tpu.ops.floatfloat import (KronAssembledFF, ff_add, ff_from_f64,
                                      ff_mul, ff_system_residual_step,
                                      ff_to_f64)
from stfem_tpu.ops.kronfac import KronAssembled
from stfem_tpu.ops.spatial import LaplaceMassOperator
from stfem_tpu.system import SystemMatrix
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import TimeStepType


def test_ff_primitives():
    rng = np.random.default_rng(0)
    a64 = rng.standard_normal(1000) * np.logspace(-3, 3, 1000)
    b64 = rng.standard_normal(1000) * np.logspace(3, -3, 1000)
    a = ff_from_f64(jnp.asarray(a64))
    b = ff_from_f64(jnp.asarray(b64))
    # splitting keeps ~49 of f64's 53 mantissa bits (2^-49 ~ 1.8e-15)
    np.testing.assert_allclose(np.asarray(ff_to_f64(a)), a64, rtol=5e-15)
    s = np.asarray(ff_to_f64(ff_add(a, b)))
    p = np.asarray(ff_to_f64(ff_mul(a, b)))
    # the sloppy-add error bound is relative to the OPERAND magnitudes
    # (under cancellation the result-relative error is unbounded for any
    # finite precision -- exactly the residual use case)
    mag = np.abs(a64) + np.abs(b64)
    assert np.max(np.abs(s - (a64 + b64)) / mag) < 1e-14
    np.testing.assert_allclose(p, a64 * b64, rtol=2e-13, atol=1e-18)


def test_ff_kron_pair_parity():
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    deg = 3
    K64 = LaplaceMassOperator(mesh, deg, deg + 1, 0.0, 1.0,
                              dtype=jnp.float64)
    M64 = LaplaceMassOperator(mesh, deg, deg + 1, 1.0, 0.0,
                              dtype=jnp.float64)
    kron = KronAssembled(K64, M64, jnp.float64)
    kff = KronAssembledFF(kron)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2,) + mesh.dof_shape(deg))
    Kx, Mx = kron.pair(jnp.asarray(x))
    Kf, Mf = kff.pair(ff_from_f64(jnp.asarray(x)))
    scale = float(jnp.max(jnp.abs(Kx)))
    np.testing.assert_allclose(np.asarray(ff_to_f64(Kf)), np.asarray(Kx),
                               atol=1e-12 * scale)
    np.testing.assert_allclose(np.asarray(ff_to_f64(Mf)), np.asarray(Mx),
                               atol=1e-12)


def test_ff_residual_cancellation():
    """The bench's rectangular per-step residual in ff matches the f64
    SystemMatrix residual to ~1e-13 of ||rhs|| -- i.e. the cancelled digits
    survive (a plain f32 residual is only ~1e-7 here)."""
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    deg, fe_deg, ntao = 3, 2, 4
    tau = 1.0 / 16
    K64 = LaplaceMassOperator(mesh, deg, deg + 1, 0.0, 1.0,
                              dtype=jnp.float64)
    M64 = LaplaceMassOperator(mesh, deg, deg + 1, 1.0, 0.0,
                              dtype=jnp.float64)
    Alpha, Beta, _, _ = get_fe_time_weights(TimeStepType.DG, fe_deg, tau,
                                            ntao)
    struct = SystemMatrix._detect_step_structure(np.asarray(Alpha),
                                                 np.asarray(Beta))
    nt, A0, A1, B0, B1 = struct
    A04 = np.concatenate([A1[:, -1:], A0], axis=1)
    B04 = np.concatenate([B1[:, -1:], B0], axis=1)
    m64 = SystemMatrix(K64, M64, A04, B04)

    rng = np.random.default_rng(2)
    nb = Alpha.shape[0]
    x = rng.standard_normal((nb,) + mesh.dof_shape(deg))
    # an rhs NEAR A x: the residual cancels ~5 digits, the regime the ff
    # path must survive
    full = SystemMatrix(K64, M64, Alpha, Beta)
    rhs = np.asarray(full.vmult(jnp.asarray(x)))
    rhs = rhs * (1.0 + 1e-5 * rng.standard_normal(rhs.shape))

    # f64 stepwise oracle (bench _resid_stepwise semantics)
    xs = x.reshape((nb // nt, nt) + x.shape[1:])
    prev = np.concatenate([np.zeros_like(xs[:1, -1:]), xs[:-1, -1:]], axis=0)
    xin = np.concatenate([prev, xs], axis=1)
    rh = rhs.reshape(xs.shape)
    r_ref = np.stack([np.asarray(rh[s] - m64.vmult(jnp.asarray(xin[s])))
                      for s in range(nb // nt)]).reshape(x.shape)

    # ff path
    kron = KronAssembled(K64, M64, jnp.float64)
    kff = KronAssembledFF(kron)
    mask = jnp.asarray(K64.mask_np, jnp.float32)
    A_ff = ff_from_f64(A04)
    B_ff = ff_from_f64(B04)
    r_ff = []
    for s in range(nb // nt):
        rf = ff_system_residual_step(
            kff, mask, A_ff, B_ff,
            ff_from_f64(jnp.asarray(rh[s])), ff_from_f64(jnp.asarray(xin[s])))
        r_ff.append(np.asarray(ff_to_f64(rf)))
    r_ff = np.stack(r_ff).reshape(x.shape)

    scale = float(np.linalg.norm(rhs.reshape(-1)))
    err = np.linalg.norm((r_ff - r_ref).reshape(-1)) / scale
    assert err < 1e-12, err


def test_ff_slab_residual_parity():
    """FFSlabResidual (the bench's IR residual engine) vs the f64 whole-slab
    residual incl. the Gamma previous-slab coupling, under jit."""
    import jax

    from stfem_tpu.ops.floatfloat import FFSlabResidual

    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    deg, fe_deg, ntao = 3, 2, 4
    tau = 1.0 / 16
    K64 = LaplaceMassOperator(mesh, deg, deg + 1, 0.0, 1.0,
                              dtype=jnp.float64)
    M64 = LaplaceMassOperator(mesh, deg, deg + 1, 1.0, 0.0,
                              dtype=jnp.float64)
    Alpha, Beta, Gamma, _ = get_fe_time_weights(TimeStepType.DG, fe_deg,
                                                tau, ntao)
    full = SystemMatrix(K64, M64, Alpha, Beta)
    r64 = SystemMatrix(K64, M64, np.zeros_like(Gamma), Gamma)

    rng = np.random.default_rng(4)
    nb = Alpha.shape[0]
    x = rng.standard_normal((nb,) + mesh.dof_shape(deg))
    prev = rng.standard_normal(mesh.dof_shape(deg))
    fslab = rng.standard_normal(x.shape)

    rhs_ref = np.asarray(r64.vmult(jnp.asarray(prev)[None])) + fslab
    r_ref = rhs_ref - np.asarray(full.vmult(jnp.asarray(x)))

    ffres = FFSlabResidual(K64, M64, Alpha, Beta, Gamma)
    (rh, rl), rnorm, bnorm = jax.jit(ffres.residual)(
        ff_from_f64(jnp.asarray(prev)), ff_from_f64(jnp.asarray(x)),
        ff_from_f64(jnp.asarray(fslab)))
    r_got = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
    scale = np.linalg.norm(rhs_ref.reshape(-1))
    err = np.linalg.norm((r_got - r_ref).reshape(-1)) / scale
    assert err < 1e-12, err
    np.testing.assert_allclose(float(rnorm),
                               np.linalg.norm(r_ref.reshape(-1)), rtol=1e-5)
    np.testing.assert_allclose(float(bnorm), scale, rtol=1e-5)


def test_ff_wave_slab_residual_parity():
    """FFSlabResidual with the Schur-reduced WAVE tables (full previous-
    step coupling + K-path/velocity rhs tables) vs the f64 whole-slab
    oracle -- the wave bench's IR residual engine."""
    import jax

    from stfem_tpu.ops.floatfloat import FFSlabResidual
    from stfem_tpu.time.tables import get_fe_time_weights_wave

    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    deg, fe_deg, ntao = 3, 2, 4
    tau = 1.0 / 16
    K64 = LaplaceMassOperator(mesh, deg, deg + 1, 0.0, 1.0,
                              dtype=jnp.float64)
    M64 = LaplaceMassOperator(mesh, deg, deg + 1, 1.0, 0.0,
                              dtype=jnp.float64)
    A1, B1, G1, Z1 = get_fe_time_weights(TimeStepType.DG, fe_deg, tau, 1)
    A_lhs, B_lhs, rhs_uK, rhs_uM, rhs_vM = get_fe_time_weights_wave(
        TimeStepType.DG, A1, B1, G1, Z1, ntao)
    full = SystemMatrix(K64, M64, A_lhs, B_lhs)
    r_u = SystemMatrix(K64, M64, rhs_uK, rhs_uM)
    r_v = SystemMatrix(K64, M64, np.zeros_like(rhs_vM), rhs_vM)

    rng = np.random.default_rng(11)
    nb = A_lhs.shape[0]
    x = rng.standard_normal((nb,) + mesh.dof_shape(deg))
    prev_u = rng.standard_normal(mesh.dof_shape(deg))
    prev_v = rng.standard_normal(mesh.dof_shape(deg))
    fslab = rng.standard_normal(x.shape)

    rhs_ref = (np.asarray(r_u.vmult(jnp.asarray(prev_u)[None]))
               + np.asarray(r_v.vmult(jnp.asarray(prev_v)[None])) + fslab)
    r_ref = rhs_ref - np.asarray(full.vmult(jnp.asarray(x)))

    ffres = FFSlabResidual(K64, M64, A_lhs, B_lhs, rhs_uM,
                           Gamma_K=rhs_uK, Gamma_v=rhs_vM)
    assert ffres.full_coupling
    (rh, rl), rnorm, bnorm = jax.jit(ffres.residual)(
        ff_from_f64(jnp.asarray(prev_u)), ff_from_f64(jnp.asarray(x)),
        ff_from_f64(jnp.asarray(fslab)),
        prev_v_ff=ff_from_f64(jnp.asarray(prev_v)))
    r_got = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
    scale = np.linalg.norm(rhs_ref.reshape(-1))
    err = np.linalg.norm((r_got - r_ref).reshape(-1)) / scale
    assert err < 1e-12, err
    np.testing.assert_allclose(float(rnorm),
                               np.linalg.norm(r_ref.reshape(-1)), rtol=1e-5)


# ---- error-free transforms, property-tested against exact arithmetic ----

from fractions import Fraction  # noqa: E402

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from hypothesis.extra.numpy import arrays  # noqa: E402

from stfem_tpu.ops.floatfloat import _split, _two_prod, _two_sum  # noqa: E402

# magnitudes bounded so no product or sum over/underflows f32
_F32 = st.one_of(st.just(0.0), st.floats(2.0 ** -50, 2.0 ** 50, width=32),
                 st.floats(-2.0 ** 50, -2.0 ** -50, width=32))
_VEC = arrays(np.float32, 64, elements=_F32)
_jit_prod = jax.jit(_two_prod)
_jit_sum = jax.jit(_two_sum)
_jit_split = jax.jit(_split)


def _exact(x):
    return [Fraction(float(v)) for v in np.asarray(x, np.float64)]


@settings(max_examples=60, deadline=None)
@given(_VEC, _VEC)
def test_two_prod_exact(a, b):
    """p + err equals the exact product a * b (an f32 product has at most
    48 significant bits, so the f64 product is exact too)."""
    p, err = _jit_prod(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(np.asarray(p), (a * b).astype(np.float32))
    for pi, ei, ref in zip(_exact(p), _exact(err), _exact(exact)):
        assert pi + ei == ref


@settings(max_examples=60, deadline=None)
@given(_VEC, _VEC)
def test_two_sum_exact(a, b):
    """s + err equals the exact sum a + b, with s the rounded f32 sum."""
    s, err = _jit_sum(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(s), a + b)
    for si, ei, ai, bi in zip(_exact(s), _exact(err), _exact(a), _exact(b)):
        assert si + ei == ai + bi


@settings(max_examples=60, deadline=None)
@given(_VEC)
def test_split_halves_exact(a):
    """hi + lo == a exactly, and each half fits in 12 significant bits (so
    the four partial products of _two_prod are exact in f32)."""
    hi, lo = _jit_split(jnp.asarray(a))
    hi, lo = np.asarray(hi, np.float64), np.asarray(lo, np.float64)
    np.testing.assert_array_equal(hi + lo, a.astype(np.float64))
    for h in (hi, lo):
        nz = h[h != 0.0]
        mant, _ = np.frexp(nz)
        np.testing.assert_array_equal(mant * 2.0 ** 12,
                                      np.round(mant * 2.0 ** 12))
