"""Spatial operator correctness: matrix-free apply vs assembled element
matrices (the reference's tp_05 identity check, tests/tp_05dgp_support.cc:
132-151), adjointness of gather/scatter, symmetry, and exactness checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stfem_tpu.mesh.grid import StructuredMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator, cell_gather, cell_scatter


def assembled_apply(op, x):
    E = op.element_matrices()
    u = cell_gather(x * op.mask, op.cells, op.degree)
    C = int(np.prod(op.cells))
    u = u.reshape(C, -1)
    y = jnp.einsum("cab,cb->ca", E, u)
    y = y.reshape(op.cells + (op.degree + 1,) * op.dim)
    return cell_scatter(y, op.cells, op.degree) * op.mask


@pytest.mark.parametrize("dim,degree,distort", [
    (1, 1, 0.0), (1, 3, 0.0),
    (2, 1, 0.0), (2, 2, 0.0), (2, 4, 0.0),
    (2, 2, 0.15),
    (3, 1, 0.0), (3, 2, 0.0), (3, 2, 0.1),
])
def test_matrix_free_equals_assembled(dim, degree, distort):
    mesh = StructuredMesh([2] * dim, [0.0] * dim, [1.0] * dim, refinement=1,
                          distort=distort)
    op = LaplaceMassOperator(mesh, degree, degree + 1, 1.0, 1.0)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(mesh.dof_shape(degree)))
    y1 = op.apply(x)
    y2 = assembled_apply(op, x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                               rtol=1e-11, atol=1e-11)


def test_gather_scatter_adjoint():
    mesh = StructuredMesh([3, 2], [0, 0], [1, 1], refinement=1)
    k = 2
    shape = mesh.dof_shape(k)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(shape))
    yc = jnp.asarray(rng.standard_normal(mesh.cells + (k + 1, k + 1)))
    # <gather(x), yc> == <x, scatter(yc)>
    lhs = jnp.sum(cell_gather(x, mesh.cells, k) * yc)
    rhs = jnp.sum(x * cell_scatter(yc, mesh.cells, k))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_operator_symmetry():
    mesh = StructuredMesh([1, 1], [0, 0], [1, 1], refinement=2)
    op = LaplaceMassOperator(mesh, 2, 3, 0.3, 1.7)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(mesh.dof_shape(2)))
    y = jnp.asarray(rng.standard_normal(mesh.dof_shape(2)))
    np.testing.assert_allclose(float(jnp.sum(y * op.apply(x))),
                               float(jnp.sum(x * op.apply(y))), rtol=1e-11)


def test_mass_volume():
    """1^T M 1 = |domain| with no Dirichlet mask."""
    mesh = StructuredMesh([2, 3], [0, 0], [2.0, 3.0], refinement=1)
    free = np.ones(mesh.dof_shape(2))
    op = LaplaceMassOperator(mesh, 2, 3, 1.0, 0.0, mask=free)
    one = jnp.ones(mesh.dof_shape(2))
    np.testing.assert_allclose(float(jnp.sum(op.apply(one))), 6.0, rtol=1e-12)


def test_laplace_energy_of_linear():
    """x^T K x = int |grad u|^2 = 1 for u = x coordinate on unit square."""
    mesh = StructuredMesh([1, 1], [0, 0], [1, 1], refinement=2)
    free = np.ones(mesh.dof_shape(1))
    op = LaplaceMassOperator(mesh, 1, 2, 0.0, 1.0, mask=free)
    coords = mesh.dof_coordinates(1)
    u = jnp.asarray(coords[..., 0])
    np.testing.assert_allclose(float(jnp.sum(u * op.apply(u))), 1.0,
                               rtol=1e-12)


def test_diagonal_matches_assembled():
    mesh = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1)
    op = LaplaceMassOperator(mesh, 2, 3, 1.0, 1.0)
    d = np.asarray(op.diagonal()).reshape(-1)
    n = d.size
    # unit-vector probing of the matrix-free operator
    shape = mesh.dof_shape(2)
    mask = np.asarray(op.mask_np).reshape(-1)
    for i in range(0, n, 7):
        e = np.zeros(n)
        e[i] = 1.0
        di = float(np.asarray(op.apply(jnp.asarray(e.reshape(shape)))
                              ).reshape(-1)[i])
        expected = di if mask[i] else 1.0
        np.testing.assert_allclose(d[i], expected, rtol=1e-11, atol=1e-13)


def test_coefficient_field():
    """Piecewise coefficient multiplies the Laplace term."""
    mesh = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1)

    def coeff(pts):
        return np.where(pts[..., 0] < 0.5, 2.0, 1.0)

    op_c = LaplaceMassOperator(mesh, 1, 2, 0.0, 1.0, coefficient=coeff)
    op_1 = LaplaceMassOperator(mesh, 1, 2, 0.0, 1.0)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(mesh.dof_shape(1)))
    y_c = np.asarray(op_c.apply(x))
    y_1 = np.asarray(op_1.apply(x))
    assert not np.allclose(y_c, y_1)
    # energy with coefficient >= energy without (coeff >= 1)
    assert float(jnp.sum(x * op_c.apply(x))) >= float(jnp.sum(x * op_1.apply(x))) - 1e-12


@pytest.mark.parametrize("dim,cells,coeff,nonuni", [
    (1, (5,), False, False),
    (2, (3, 4), False, True),
    (3, (3, 3, 3), True, False),
    (2, (4, 4), True, True),
])
def test_grid_sumfac_parity(dim, cells, coeff, nonuni, monkeypatch):
    """Gather-free grid sum-factorization (ops/gridsumfac.py) must agree
    with the cell-local path to machine precision for vmult, vmult_slice,
    and Tvmult on uniform / non-uniform / coefficient meshes."""
    from stfem_tpu.system import SystemMatrix
    from stfem_tpu.time.tables import get_fe_time_weights
    from stfem_tpu.types import TimeStepType

    rng = np.random.default_rng(3)
    if nonuni:
        mesh = StructuredMesh(
            list(cells), [0.0] * dim, [1.0] * dim,
            axis_steps=[np.sort(rng.uniform(0.5, 1.5, c)) for c in cells])
    else:
        mesh = StructuredMesh(list(cells), [0.0] * dim, [1.0] * dim)
    cf = (lambda p: 1.0 + 0.5 * np.sin(3 * p[..., 0])) if coeff else None
    k = 3
    K = LaplaceMassOperator(mesh, k, k + 1, 0.0, 1.0, dtype=jnp.float64,
                            coefficient=cf)
    M = LaplaceMassOperator(mesh, k, k + 1, 1.0, 0.0, dtype=jnp.float64,
                            coefficient=cf)
    A, B, _, _ = get_fe_time_weights(TimeStepType.DG, 2, 0.125, 2)
    monkeypatch.setenv("STFEM_KRON_MATVEC", "0")  # force the grid path
    m_grid = SystemMatrix(K, M, A, B, precision=None)
    monkeypatch.setenv("STFEM_GRID_SUMFAC", "0")
    m_ref = SystemMatrix(K, M, A, B, precision=None)
    monkeypatch.delenv("STFEM_GRID_SUMFAC")
    assert m_grid._grid is not None and m_ref._grid is None
    x = jnp.asarray(rng.standard_normal((A.shape[0],) + tuple(K.dof_shape)))
    for name, fg, fr in [("vmult", m_grid.vmult, m_ref.vmult),
                         ("Tvmult", m_grid.Tvmult, m_ref.Tvmult)]:
        yg, yr = fg(x), fr(x)
        np.testing.assert_allclose(np.asarray(yg), np.asarray(yr),
                                   rtol=1e-12, atol=1e-13, err_msg=name)
    sg, sr = m_grid.vmult_slice(x[0]), m_ref.vmult_slice(x[0])
    np.testing.assert_allclose(np.asarray(sg), np.asarray(sr),
                               rtol=1e-12, atol=1e-13, err_msg="slice")


@pytest.mark.parametrize("dim,cells,nonuni", [
    (1, (5,), False),
    (2, (3, 4), True),
    (3, (3, 3, 3), False),
])
def test_kron_matvec_parity(dim, cells, nonuni, monkeypatch):
    """1D-assembled Kronecker apply (ops/kronfac.py) must agree with the
    cell-local path to machine precision on separable geometry (uniform and
    non-uniform tensor steps), and must NOT engage when a coefficient field
    breaks separability."""
    from stfem_tpu.system import SystemMatrix
    from stfem_tpu.time.tables import get_fe_time_weights
    from stfem_tpu.types import TimeStepType

    rng = np.random.default_rng(3)
    if nonuni:
        mesh = StructuredMesh(
            list(cells), [0.0] * dim, [1.0] * dim,
            axis_steps=[np.sort(rng.uniform(0.5, 1.5, c)) for c in cells])
    else:
        mesh = StructuredMesh(list(cells), [0.0] * dim, [1.0] * dim)
    k = 3
    K = LaplaceMassOperator(mesh, k, k + 1, 0.0, 1.0, dtype=jnp.float64)
    M = LaplaceMassOperator(mesh, k, k + 1, 1.0, 0.0, dtype=jnp.float64)
    A, B, _, _ = get_fe_time_weights(TimeStepType.DG, 2, 0.125, 2)
    m_kron = SystemMatrix(K, M, A, B, precision=None)
    assert m_kron._kron is not None
    monkeypatch.setenv("STFEM_KRON_MATVEC", "0")
    monkeypatch.setenv("STFEM_GRID_SUMFAC", "0")
    m_ref = SystemMatrix(K, M, A, B, precision=None)
    monkeypatch.delenv("STFEM_KRON_MATVEC")
    monkeypatch.delenv("STFEM_GRID_SUMFAC")
    assert m_ref._kron is None and m_ref._grid is None
    x = jnp.asarray(rng.standard_normal((A.shape[0],) + tuple(K.dof_shape)))
    for name, fg, fr in [("vmult", m_kron.vmult, m_ref.vmult),
                         ("Tvmult", m_kron.Tvmult, m_ref.Tvmult)]:
        np.testing.assert_allclose(np.asarray(fg(x)), np.asarray(fr(x)),
                                   rtol=1e-12, atol=1e-13, err_msg=name)
    sg, sr = m_kron.vmult_slice(x[0]), m_ref.vmult_slice(x[0])
    np.testing.assert_allclose(np.asarray(sg), np.asarray(sr),
                               rtol=1e-12, atol=1e-13, err_msg="slice")
    # masked-input (strong-Dirichlet lift) path
    np.testing.assert_allclose(
        np.asarray(m_kron.vmult(x, mask_input=False)),
        np.asarray(m_ref.vmult(x, mask_input=False)),
        rtol=1e-12, atol=1e-13, err_msg="lift")
    # a coefficient field must disable the Kronecker route
    cf = lambda p: 1.0 + 0.5 * np.sin(3 * p[..., 0])  # noqa: E731
    Kc = LaplaceMassOperator(mesh, k, k + 1, 0.0, 1.0, dtype=jnp.float64,
                             coefficient=cf)
    Mc = LaplaceMassOperator(mesh, k, k + 1, 1.0, 0.0, dtype=jnp.float64,
                             coefficient=cf)
    assert SystemMatrix(Kc, Mc, A, B, precision=None)._kron is None


def test_kron_banded_f64_parity():
    """The banded diagonal form of the Kronecker apply (the sharded halo
    mode of KronAssembled.pair) must equal the dense 1D matmuls to machine
    precision, for uniform and non-uniform tensor steps."""
    from stfem_tpu.ops.kronfac import KronAssembled

    rng = np.random.default_rng(7)
    for nonuni in (False, True):
        if nonuni:
            mesh = StructuredMesh(
                [3, 4], [0.0, 0.0], [1.0, 1.0],
                axis_steps=[np.sort(rng.uniform(0.5, 1.5, c))
                            for c in (3, 4)])
        else:
            mesh = StructuredMesh([4, 4, 4], [0.0] * 3, [1.0] * 3)
        k = 4
        K = LaplaceMassOperator(mesh, k, k + 1, 0.0, 1.0,
                                dtype=jnp.float64)
        M = LaplaceMassOperator(mesh, k, k + 1, 1.0, 0.0,
                                dtype=jnp.float64)
        kr = KronAssembled(K, M, jnp.float64)
        assert len(kr.Md) == mesh.dim
        x = jnp.asarray(rng.standard_normal(
            (2,) + tuple(mesh.dof_shape(k))))
        kd, md = kr._pair_impl(x, True, True, banded=False)
        kb, mb = kr._pair_impl(x, True, True, banded=True)
        np.testing.assert_allclose(np.asarray(kb), np.asarray(kd),
                                   rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(np.asarray(mb), np.asarray(md),
                                   rtol=1e-13, atol=1e-14)
        # f32 operators carry the banded factors too (enable_halo_mode
        # may flip them to the banded pad+slice form AFTER construction
        # for sharded runs) but default to the dense matmuls; force_banded
        # must produce the identical result
        kr32 = KronAssembled(
            LaplaceMassOperator(mesh, k, k + 1, 0.0, 1.0,
                                dtype=jnp.float32),
            LaplaceMassOperator(mesh, k, k + 1, 1.0, 0.0,
                                dtype=jnp.float32), jnp.float32)
        assert len(kr32.Md) == mesh.dim
        assert not kr32.force_banded and not kr32._shifted
        x32 = x.astype(jnp.float32)
        kd32, md32 = kr32.pair(x32)
        kr32.force_banded = True
        kb32, mb32 = kr32.pair(x32)
        np.testing.assert_allclose(np.asarray(kb32), np.asarray(kd32),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(np.asarray(mb32), np.asarray(md32),
                                   rtol=2e-5, atol=2e-6)


def test_system_matrix_zero_column_reduction():
    """Step-coupling blocks read only the previous step's last time-dof
    (DG jump / CGP trial value); SystemMatrix must slice those input
    columns away (col reduction) and still match the unreduced apply."""
    from stfem_tpu.system import SystemMatrix
    from stfem_tpu.time.tables import get_fe_time_weights
    from stfem_tpu.types import TimeStepType

    mesh = StructuredMesh([4, 4], [0.0, 0.0], [1.0, 1.0])
    k = 3
    K = LaplaceMassOperator(mesh, k, k + 1, 0.0, 1.0, dtype=jnp.float64)
    M = LaplaceMassOperator(mesh, k, k + 1, 1.0, 0.0, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    for ts in (TimeStepType.DG, TimeStepType.CGP):
        A, B, _, _ = get_fe_time_weights(ts, 2, 1 / 16, 4)
        nt, A0, A1, B0, B1 = SystemMatrix._detect_step_structure(
            np.asarray(A), np.asarray(B))
        mc = SystemMatrix(K, M, A1, B1, precision=None)
        assert mc._col_reduced is not None
        x = jnp.asarray(rng.standard_normal((nt,) + tuple(K.dof_shape)))
        y_fast = mc.vmult(x)
        y_ref = mc._fused_apply(x, False, mc.alpha_is_zero,
                                mc.beta_is_zero, True)
        np.testing.assert_allclose(np.asarray(y_fast), np.asarray(y_ref),
                                   rtol=1e-13, atol=1e-14)
        # the square slab system has no zero columns -- must not trigger
        assert SystemMatrix(K, M, A, B, precision=None)._col_reduced is None
