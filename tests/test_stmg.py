"""STMG preconditioner integration tests: mesh-independent O(10) FGMRES
iteration counts and golden-exact errors for heat and wave.

Iteration-count parity with the reference goldens (7/9 for heat DG(1) refs
2/3) is within +-1 since the order-invariant Arnoldi eigenvalue estimates
(GMGParams.eig_exact, round 3); bounds here are golden + 1.05."""
import pytest

from stfem_tpu.drivers.heat import run_heat_cycle, stmg_preconditioner_factory
from stfem_tpu.stmg.gmg import GMGParams
from stfem_tpu.types import ProblemType, TimeStepType

GOLDEN_DG1 = {2: 1.78760e-02, 3: 3.24200e-03}


@pytest.mark.parametrize("ref,max_avg", [(2, 8.05), (3, 10.05)])
def test_heat_stmg_iterations(ref, max_avg):
    res = run_heat_cycle(
        refinement=ref, fe_degree=1, type_=TimeStepType.DG,
        n_timesteps_at_once=2,
        preconditioner_factory=stmg_preconditioner_factory(fe_degree_min=1),
        gmres_maxiter=40)
    assert res.avg_iterations <= max_avg
    assert res.l2_l2 == pytest.approx(GOLDEN_DG1[ref], rel=2e-5)


def test_wave_stmg():
    res = run_heat_cycle(
        refinement=2, fe_degree=1, type_=TimeStepType.DG,
        problem=ProblemType.wave, n_timesteps_at_once=4,
        preconditioner_factory=stmg_preconditioner_factory(
            params=GMGParams(skip_identity_levels=True), fe_degree_min=1),
        gmres_maxiter=40)
    assert res.avg_iterations <= 13
    # golden tests/tp_01.output:371 (wave DG(1), 4 steps at once)
    assert res.l2_l2 == pytest.approx(2.07852e-02, rel=2e-5)
    assert res.linf_linf == pytest.approx(7.45999e-02, rel=2e-5)


def test_heat_cgp_stmg():
    res = run_heat_cycle(
        refinement=2, fe_degree=2, type_=TimeStepType.CGP,
        n_timesteps_at_once=2,
        preconditioner_factory=stmg_preconditioner_factory(fe_degree_min=1),
        gmres_maxiter=40)
    assert res.avg_iterations <= 14
    assert res.converged if hasattr(res, "converged") else True


def test_vanka_fastdiag_scan_equals_dense():
    """Multi-step fastdiag (block-bidiagonal per-step solve + associative-scan
    coupling) must agree with the reference-style dense patch inverse to
    machine precision, for DG and CGP tables; the wave tables (full
    lower-triangular cross-step coupling) must fall back to the dense
    T x T eigen-path."""
    import jax.numpy as jnp
    import numpy as np

    from stfem_tpu.mesh.grid import StructuredMesh
    from stfem_tpu.ops.spatial import LaplaceMassOperator
    from stfem_tpu.stmg.vanka import PreconditionVanka
    from stfem_tpu.time.tables import (get_fe_time_weights,
                                       get_fe_time_weights_wave)

    mesh = StructuredMesh([3, 3], [0.0, 0.0], [1.0, 1.0], refinement=1)
    K = LaplaceMassOperator(mesh, 2, 3, 0.0, 1.0)
    M = LaplaceMassOperator(mesh, 2, 3, 1.0, 0.0)
    rng = np.random.default_rng(7)
    import os
    for type_, r in [(TimeStepType.DG, 1), (TimeStepType.CGP, 2)]:
        A, B, _, _ = get_fe_time_weights(type_, r, 0.125, 4)
        # grid apply (per-axis banded matmuls) is the default on this
        # uniform unmapped mesh; the cell-major scan path stays under
        # STFEM_GRID_VANKA=0
        v_grid = PreconditionVanka(K, M, A, B, mode="fastdiag", n_steps=4)
        assert v_grid.n_steps == 4 and v_grid.Wdn is not None
        os.environ["STFEM_GRID_VANKA"] = "0"
        try:
            v_scan = PreconditionVanka(K, M, A, B, mode="fastdiag",
                                       n_steps=4)
        finally:
            del os.environ["STFEM_GRID_VANKA"]
        assert v_scan.n_steps == 4 and v_scan.Ginv is not None
        v_dense = PreconditionVanka(K, M, A, B, mode="dense")
        # defects are interior-supported in the solver (rhs and operator
        # outputs are masked); the separable eigenbasis relies on it
        src = jnp.asarray(rng.standard_normal((A.shape[0],)
                                              + mesh.dof_shape(2))) * K.mask
        np.testing.assert_allclose(np.asarray(v_scan.vmult(src)),
                                   np.asarray(v_dense.vmult(src)),
                                   rtol=1e-9, atol=1e-11)
        # single-step fastdiag path unchanged
        v_fd = PreconditionVanka(K, M, A, B, mode="fastdiag")
        np.testing.assert_allclose(np.asarray(v_fd.vmult(src)),
                                   np.asarray(v_dense.vmult(src)),
                                   rtol=1e-9, atol=1e-11)

    # separable (per-axis Kronecker) eigenbasis active on this uniform
    # unmapped mesh and exact vs both the dense-eigh fastdiag and the dense
    # inverse (round-2: kills the batched C x A x A eigh at setup and the
    # dense V matmul in the apply)
    A, B, _, _ = get_fe_time_weights(TimeStepType.DG, 1, 0.125, 4)
    # default: grid apply (banded matmuls built from the per-axis factors)
    v_auto = PreconditionVanka(K, M, A, B, mode="fastdiag", n_steps=4)
    assert v_auto.Wdn is not None and v_auto.V is None
    os.environ["STFEM_SEP_VANKA_APPLY"] = "1"
    os.environ["STFEM_GRID_VANKA"] = "0"
    try:
        v_fac = PreconditionVanka(K, M, A, B, mode="fastdiag", n_steps=4)
    finally:
        del os.environ["STFEM_SEP_VANKA_APPLY"]
        del os.environ["STFEM_GRID_VANKA"]
    assert v_fac.Vsep is not None
    os.environ["STFEM_NO_SEP_VANKA"] = "1"
    try:
        v_eigh = PreconditionVanka(K, M, A, B, mode="fastdiag", n_steps=4)
    finally:
        del os.environ["STFEM_NO_SEP_VANKA"]
    assert v_eigh.Vsep is None
    src = jnp.asarray(rng.standard_normal((A.shape[0],)
                                          + mesh.dof_shape(2))) * K.mask
    y_eigh = np.asarray(v_eigh.vmult(src))
    np.testing.assert_allclose(np.asarray(v_auto.vmult(src)), y_eigh,
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(v_fac.vmult(src)), y_eigh,
                               rtol=1e-9, atol=1e-11)
    # ineligible (coefficient field) -> falls back to the batched eigh
    coeff = lambda pts: 1.0 + pts[..., 0]
    K_c = LaplaceMassOperator(mesh, 2, 3, 0.0, 1.0, coefficient=coeff)
    v_c = PreconditionVanka(K_c, M, A, B, mode="fastdiag", n_steps=4)
    assert v_c.Vsep is None

    # wave tables: cross-step coupling is NOT rank-1 bidiagonal -> fallback
    A, B, G, Z = get_fe_time_weights(TimeStepType.DG, 1, 0.125, 1)
    Aw, Bw = get_fe_time_weights_wave(TimeStepType.DG, A, B, G, Z, 4)[:2]
    v_wave = PreconditionVanka(K, M, Aw, Bw, mode="fastdiag", n_steps=4)
    assert v_wave.n_steps == 1 and v_wave.TTg is not None
    v_wave_dense = PreconditionVanka(K, M, Aw, Bw, mode="dense")
    src = jnp.asarray(rng.standard_normal((Aw.shape[0],)
                                          + mesh.dof_shape(2))) * K.mask
    np.testing.assert_allclose(np.asarray(v_wave.vmult(src)),
                               np.asarray(v_wave_dense.vmult(src)),
                               rtol=1e-9, atol=1e-11)


def test_direct_coarse_solver():
    """coarse_grid_smoother_type='Direct': the assembled-and-inverted
    coarsest slab operator gives the same FGMRES iteration counts as the
    reference-style coarse GMRES (pinned here on CPU), at one matmul of
    runtime cost."""
    import jax.numpy as jnp
    from stfem_tpu.krylov import fgmres
    from stfem_tpu.mesh.grid import StructuredMesh
    from stfem_tpu.ops.spatial import LaplaceMassOperator
    from stfem_tpu.stmg.gmg import GMGParams, build_stmg
    from stfem_tpu.system import SystemMatrix
    from stfem_tpu.time.tables import get_fe_time_weights

    import numpy as np

    mesh = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=2)
    K = LaplaceMassOperator(mesh, 2, 3, 0.0, 1.0, dtype=jnp.float32)
    M = LaplaceMassOperator(mesh, 2, 3, 1.0, 0.0, dtype=jnp.float32)
    a, b, _, _ = get_fe_time_weights(TimeStepType.DG, 1, 1 / 16, 4)
    matrix = SystemMatrix(K, M, a, b)
    rng = np.random.default_rng(0)
    rhs = matrix.vmult(jnp.asarray(
        rng.standard_normal((8,) + mesh.dof_shape(2)), jnp.float32))
    iters = {}
    for ctype in ("GMRES", "Direct"):
        gmg = build_stmg(mesh, 1, 2, TimeStepType.DG, 4, 1 / 16,
                         dtype=jnp.float32, fe_degree_min=1,
                         params=GMGParams(smoothing_steps=2, variable=False,
                                          coarse_grid_smoother_type=ctype))
        res = fgmres(matrix.vmult, rhs, jnp.zeros_like(rhs),
                     precondition=gmg.vmult, maxiter=40, abstol=1e-30,
                     reltol=1e-8)
        assert bool(res.converged)
        iters[ctype] = int(res.iterations)
    assert abs(iters["Direct"] - iters["GMRES"]) <= 1


def _time_solve_reference(w, GinvT, cvecT, S, nt):
    """Sequential f64 block-bidiagonal recurrence (the plain oracle)."""
    import numpy as np

    N = w.shape[-1]
    ws = np.asarray(w, np.float64).reshape(S, nt, N)
    G = np.asarray(GinvT, np.float64)
    c = np.asarray(cvecT, np.float64)
    y = np.einsum("ijn,sjn->sin", G, ws)
    out = np.empty_like(y)
    prev = np.zeros(N)
    for s in range(S):
        out[s] = y[s] + prev[None] * c
        prev = y[s, nt - 1] + c[nt - 1] * prev
    return out.reshape(S * nt, N)


def _time_solve_inputs(S, nt, N, dtype, seed=11):
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((S * nt, N)), dtype)
    GinvT = jnp.asarray(0.3 * rng.standard_normal((nt, nt, N)), jnp.float32)
    cvecT = jnp.asarray(rng.uniform(-0.9, 0.9, (nt, N)), jnp.float32)
    return w, GinvT, cvecT


_TS_CASES = [(4, 3, 1000, "float32"), (32, 3, 777, "float32"),
             (5, 2, 1536, "bfloat16"), (8, 3, 3 * 17 ** 2, "bfloat16")]


@pytest.mark.parametrize("S,nt,N,dt", _TS_CASES)
def test_pallas_timesolve_kernel_parity(S, nt, N, dt):
    """The Triton time-solve kernel (ops/pallas_timesolve.py, interpret
    mode on CPU) reproduces the sequential recurrence on position counts
    that are not a power of two (masked tail tile): 1e-5 relative for f32
    storage, bf16 resolution of the output for bf16 storage."""
    import jax.numpy as jnp
    import numpy as np

    from stfem_tpu.ops.pallas_timesolve import time_solve_triton

    dtype = jnp.dtype(dt)
    w, GinvT, cvecT = _time_solve_inputs(S, nt, N, dtype)
    ref = _time_solve_reference(w, GinvT, cvecT, S, nt)
    out = time_solve_triton(w, GinvT, cvecT, S, nt, dtype, block=256,
                            interpret=True)
    assert out.shape == (S * nt, N) and out.dtype == dtype
    tol = 1e-5 if dtype == jnp.float32 else 2.0 ** -8
    err = np.max(np.abs(np.asarray(out, np.float64) - ref))
    assert err <= tol * np.max(np.abs(ref)), err


@pytest.mark.parametrize("S,nt,N,dt", _TS_CASES)
def test_xla_timesolve_parity(S, nt, N, dt):
    """The XLA time solve (the non-CUDA path) against the same oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from stfem_tpu.ops.pallas_timesolve import time_solve_xla

    dtype = jnp.dtype(dt)
    w, GinvT, cvecT = _time_solve_inputs(S, nt, N, dtype, seed=3)
    ref = _time_solve_reference(w, GinvT, cvecT, S, nt)
    out = jax.jit(time_solve_xla, static_argnums=(3, 4, 5))(
        w, GinvT, cvecT, S, nt, dtype)
    assert out.dtype == dtype
    tol = 1e-5 if dtype == jnp.float32 else 2.0 ** -8
    err = np.max(np.abs(np.asarray(out, np.float64) - ref))
    assert err <= tol * np.max(np.abs(ref)), err


def test_pallas_timesolve_tile_legality():
    """Triton blocks must be powers of two; the grid covers N with one
    masked tail tile (cdiv), so any N is legal and N = 80^3 (the 16^3
    bench eigen grid) needs no padding."""
    import jax
    import jax.numpy as jnp

    from stfem_tpu.ops.pallas_timesolve import BLOCK, time_solve_triton

    assert BLOCK & (BLOCK - 1) == 0
    w, GinvT, cvecT = _time_solve_inputs(2, 3, 100, jnp.float32)
    with pytest.raises(AssertionError):
        time_solve_triton(w, GinvT, cvecT, 2, 3, jnp.float32, block=96,
                          interpret=True)
    N = 80 ** 3
    args = (jax.ShapeDtypeStruct((96, N), jnp.bfloat16),
            jax.ShapeDtypeStruct((3, 3, N), jnp.float32),
            jax.ShapeDtypeStruct((3, N), jnp.float32))
    f = jax.jit(lambda a, b, c: time_solve_triton(a, b, c, 32, 3,
                                                  jnp.bfloat16))
    text = f.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert f"grid_x = {-(-N // BLOCK)} : i32" in text


def _lowered_text(fn, args, platform):
    import jax
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


def test_time_solve_platform_choice(monkeypatch):
    """time_solve lowers to the Triton kernel for CUDA and to plain XLA for
    the CPU; the grid Vanka routes f32/bf16 multi-step levels through it,
    f64 levels and STFEM_PALLAS_TIMESOLVE=0 through the XLA form."""
    import jax.numpy as jnp

    from stfem_tpu.mesh.grid import StructuredMesh
    from stfem_tpu.ops.pallas_timesolve import time_solve
    from stfem_tpu.ops.spatial import LaplaceMassOperator
    from stfem_tpu.stmg.vanka import PreconditionVanka
    from stfem_tpu.time.tables import get_fe_time_weights

    triton = "__gpu$xla.gpu.triton"
    args = _time_solve_inputs(4, 3, 1000, jnp.float32)
    solve = lambda w, g, c: time_solve(w, g, c, 4, 3, jnp.float32)  # noqa
    assert triton in _lowered_text(solve, args, "cuda")
    assert triton not in _lowered_text(solve, args, "cpu")

    mesh = StructuredMesh([4, 4], [0.0, 0.0], [1.0, 1.0])
    A, B, _, _ = get_fe_time_weights(TimeStepType.DG, 2, 0.125, 4)

    def vanka(dtype):
        K = LaplaceMassOperator(mesh, 3, 4, 0.0, 1.0, dtype=dtype)
        M = LaplaceMassOperator(mesh, 3, 4, 1.0, 0.0, dtype=dtype)
        v = PreconditionVanka(K, M, A, B, n_steps=4)
        x = jnp.zeros((A.shape[0],) + tuple(K.dof_shape), dtype)
        return v, x

    v32, x32 = vanka(jnp.float32)
    assert v32.ts_kernel
    assert triton in _lowered_text(lambda x: v32.vmult(x), (x32,), "cuda")
    assert triton not in _lowered_text(lambda x: v32.vmult(x), (x32,),
                                       "cpu")
    v64, x64 = vanka(jnp.float64)
    assert not v64.ts_kernel
    assert triton not in _lowered_text(lambda x: v64.vmult(x), (x64,),
                                       "cuda")
    monkeypatch.setenv("STFEM_PALLAS_TIMESOLVE", "0")
    v_off, _ = vanka(jnp.float32)
    assert not v_off.ts_kernel
    assert triton not in _lowered_text(lambda x: v_off.vmult(x), (x32,),
                                       "cuda")
