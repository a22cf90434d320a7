"""Stokes convergence driver: the tp_03stokes application rebuilt in JAX
(reference tests/tp_03stokes.cc): Q_{k+1}^dim velocity x DGP(k) pressure,
strong Dirichlet BCs, mean-pressure normalization, space-time errors for u
(incl. Hdiv-semi) and p."""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import quad_coordinates
from ..krylov import FGMRESResult, fgmres
from ..mesh.fe import shape_data_1d
from ..mesh.fe_dgp import (dgp_gradients_at_tensor_gauss,
                           dgp_values_at_tensor_gauss)
from ..mesh.grid import StructuredMesh
from ..ops.spatial import LaplaceMassOperator, _sumfac, cell_gather, cell_scatter
from ..ops.stokes import StokesOperator
from ..problems import stokes as stokes_problem
from ..system_stokes import StokesSystemMatrix
from ..time.quadrature import gauss
from ..time.tables import get_fe_time_weights, get_time_basis, get_time_quad
from ..types import TimeStepType


@dataclass
class StokesCycleResult:
    n_cells: int
    n_dofs_u: int
    n_dofs_p: int
    n_blocks: int
    n_timesteps: int
    total_iterations: int
    avg_iterations: float
    l2_l2_u: float
    linf_linf_u: float
    l2_h1_u: float
    l2_hdiv_u: float
    l2_l2_p: float
    linf_linf_p: float
    l2_h1_p: float


class StokesErrorCalculator:
    """u errors at QGauss(u_degree+1), p errors at QGauss(p_degree+1)
    (reference tp_03stokes.cc:833-848)."""

    def __init__(self, S: StokesOperator, type_: TimeStepType,
                 time_degree: int, dtype=jnp.float64):
        self.S = S
        mesh = S.mesh
        self.type_ = type_
        self.nt = time_degree + 1 if type_ == TimeStepType.DG else time_degree
        basis = get_time_basis(type_, time_degree)
        tq, tw = gauss(time_degree + 1)
        self.tq, self.tw = tq, tw
        self.phi = basis.eval_matrix(tq)
        dim = S.dim
        # u evaluation (QGauss(u_degree+1))
        nqu = S.u_degree + 1
        sdu = shape_data_1d(S.u_degree, nqu)
        self.Su = jnp.asarray(sdu.S, dtype)
        self.Du = jnp.asarray(sdu.D, dtype)
        gu = mesh.geometry(nqu, S.u_degree)
        self.jxw_u = jnp.asarray(gu.jxw, dtype)
        self.jinv = jnp.asarray(gu.jinv_diag, dtype)
        self.coords_u = jnp.asarray(quad_coordinates(mesh, nqu), dtype)
        # p evaluation (QGauss(p_degree+1))
        nqp = S.p_degree + 1
        if S.dg_pressure:
            self.Pq_err = jnp.asarray(dgp_values_at_tensor_gauss(
                dim, S.p_degree, nqp), dtype)
            self.dPq_err = jnp.asarray(dgp_gradients_at_tensor_gauss(
                dim, S.p_degree, nqp), dtype)
        else:
            sdp = shape_data_1d(S.p_degree, nqp)
            self.Sp_err = jnp.asarray(sdp.S, dtype)
            self.Dp_err = jnp.asarray(sdp.D, dtype)
        gp = mesh.geometry(nqp, S.p_degree)
        self.jxw_p = jnp.asarray(gp.jxw, dtype)
        self.jinv_p = jnp.asarray(gp.jinv_diag, dtype)
        self.coords_p = jnp.asarray(quad_coordinates(mesh, nqp), dtype)
        self.nqp = nqp

    def _reconstruct(self, q_idx, xs, prev):
        out = jnp.zeros_like(prev)
        for i, v in enumerate(self.phi[q_idx]):
            if v == 0.0:
                continue
            if self.type_ == TimeStepType.CGP:
                blk = prev if i == 0 else xs[i - 1]
            else:
                blk = xs[i]
            out = out + v * blk
        return out

    def evaluate(self, time, tau, u_time, p_time, prev_u, prev_p,
                 n_at_once):
        """u_time: [T, dim, *grid], p_time: [T, *cells, nploc]."""
        S = self.S
        dim = S.dim
        res = dict(l2_u=0.0, linf_u=-1.0, h1_u=0.0, hdiv_u=0.0,
                   l2_p=0.0, linf_p=-1.0, h1_p=0.0)
        for it in range(n_at_once):
            pu = prev_u if it == 0 else u_time[self.nt * it - 1]
            pp = prev_p if it == 0 else p_time[self.nt * it - 1]
            for q in range(len(self.tq)):
                t = time + tau * it + self.tq[q] * tau
                u = self._reconstruct(q, u_time[self.nt * it:], pu)
                p = self._reconstruct(q, p_time[self.nt * it:], pp)
                u = u * S.mask_u
                # u values/grads at quad
                vals, grads, divs = [], [], 0.0
                for c in range(dim):
                    uc = cell_gather(u[c], S.cells, S.u_degree)
                    vals.append(_sumfac([self.Su] * dim, uc, dim))
                    gc = []
                    for e in range(dim):
                        mats = [self.Du if d == e else self.Su
                                for d in range(dim)]
                        gc.append(_sumfac(mats, uc, dim) * self.jinv[e])
                    grads.append(gc)
                    divs = divs + gc[c]
                ue = stokes_problem.exact_u(self.coords_u, t)
                ge = stokes_problem.exact_grad_u(self.coords_u, t)
                l2 = sum(jnp.sum(self.jxw_u * (vals[c] - ue[..., c]) ** 2)
                         for c in range(dim))
                linf = jnp.max(jnp.stack(
                    [jnp.max(jnp.abs(vals[c] - ue[..., c]))
                     for c in range(dim)]))
                h1 = sum(jnp.sum(self.jxw_u
                                 * (grads[c][e] - ge[..., c, e]) ** 2)
                         for c in range(dim) for e in range(dim))
                div_e = sum(ge[..., c, c] for c in range(dim))
                hdiv = jnp.sum(self.jxw_u * (divs - div_e) ** 2)
                res["l2_u"] += tau * self.tw[q] * float(l2)
                res["h1_u"] += tau * self.tw[q] * float(h1)
                res["hdiv_u"] += tau * self.tw[q] * float(hdiv)
                res["linf_u"] = max(res["linf_u"], float(linf))
                # p errors
                pe = stokes_problem.exact_p(self.coords_p, t)
                gpe = stokes_problem.exact_grad_p(self.coords_p, t)
                if S.dg_pressure:
                    nploc = S.n_ploc
                    pq = jnp.einsum("...m,mQ->...Q", p,
                                    self.Pq_err.reshape(nploc, -1))
                    pq = pq.reshape(p.shape[:-1] + (self.nqp,) * dim)
                    h1p = 0.0
                    for e in range(dim):
                        dpq = jnp.einsum(
                            "...m,mQ->...Q", p,
                            self.dPq_err[..., e].reshape(nploc, -1))
                        dpq = dpq.reshape(
                            p.shape[:-1] + (self.nqp,) * dim) * self.jinv[e]
                        h1p = h1p + jnp.sum(self.jxw_p
                                            * (dpq - gpe[..., e]) ** 2)
                else:
                    pc = cell_gather(p * S.mask_p, S.cells, S.p_degree)
                    pq = _sumfac([self.Sp_err] * dim, pc, dim)
                    h1p = 0.0
                    for e in range(dim):
                        mats = [self.Dp_err if d == e else self.Sp_err
                                for d in range(dim)]
                        dpq = _sumfac(mats, pc, dim) * self.jinv_p[e]
                        h1p = h1p + jnp.sum(self.jxw_p
                                            * (dpq - gpe[..., e]) ** 2)
                l2p = jnp.sum(self.jxw_p * (pq - pe) ** 2)
                linfp = jnp.max(jnp.abs(pq - pe))
                res["l2_p"] += tau * self.tw[q] * float(l2p)
                res["h1_p"] += tau * self.tw[q] * float(h1p)
                res["linf_p"] = max(res["linf_p"], float(linfp))
        return res


def run_stokes_cycle(refinement: int, fe_degree: int,
                     type_: TimeStepType = TimeStepType.DG,
                     n_timesteps_at_once: int = 1,
                     viscosity: float = 1.0, end_time: float = 1.0,
                     mean_pressure: bool = True,
                     preconditioner_factory=None, gmres_maxiter: int = 200,
                     rel_tol: float = 1e-12,
                     extrapolate: bool = True,
                     nitsche_boundary: bool = False,
                     dg_pressure: bool = True) -> StokesCycleResult:
    dim = 2
    is_cgp = type_ == TimeStepType.CGP
    u_degree = fe_degree + 1
    p_degree = fe_degree
    n_q = u_degree + 1
    nt = fe_degree if is_cgp else fe_degree + 1
    mesh = StructuredMesh([1, 1], [0.0, 0.0], [1.0, 1.0],
                          refinement=refinement)
    # reference tp_03stokes.cc:105-109: min(cell diameter, T) pre-refinement
    step_ = min(mesh.coarse_cell_diameter, end_time)
    n_steps = int(end_time / step_)
    tau = end_time * 2.0 ** (-(refinement + 1)) / n_steps
    T = nt * n_timesteps_at_once

    weak_faces = ()
    if nitsche_boundary:
        # all boundaries weak (conv test: zero Dirichlet data => no extra RHS)
        weak_faces = tuple((d, sd) for d in range(dim) for sd in (0, 1))
    S = StokesOperator(mesh, u_degree, p_degree, n_q, viscosity,
                       weak_faces=weak_faces, dg_pressure=dg_pressure)
    Mu = LaplaceMassOperator(mesh, u_degree, n_q, 1.0, 0.0,
                             mask=S.mask_u_np)
    a, b, g, z = get_fe_time_weights(type_, fe_degree, tau,
                                     n_timesteps_at_once)
    matrix = StokesSystemMatrix(S, Mu, a, b)
    if is_cgp:
        rhs_matrix = StokesSystemMatrix(S, Mu, a, b, gamma=g, zeta=z,
                                        type_=type_)
    else:
        rhs_matrix = StokesSystemMatrix(S, Mu, a, b, gamma=None, zeta=g,
                                        type_=type_)

    # force quadrature data (QGauss(u_degree+1) like the operator)
    sd = shape_data_1d(u_degree, n_q)
    Sf = jnp.asarray(sd.S)
    geom = mesh.geometry(n_q, u_degree)
    jxw = jnp.asarray(geom.jxw)
    fcoords = jnp.asarray(quad_coordinates(mesh, n_q))

    def force_u(t):
        f = stokes_problem.rhs_u(fcoords, t, viscosity)
        comps = []
        for c in range(dim):
            y = _sumfac([Sf] * dim, f[..., c] * jxw, dim, forward=False)
            comps.append(cell_scatter(y, mesh.cells, u_degree))
        return jnp.stack(comps, axis=0) * S.mask_u

    a1, b1, g1, z1 = get_fe_time_weights(type_, fe_degree, tau, 1)
    tq_pts = get_time_quad(type_, fe_degree)[0]

    def assemble_force(time):
        zero_p = jnp.zeros((S.n_p,))
        parts = []
        for it in range(n_timesteps_at_once):
            step_parts = [None] * nt
            for j, q in enumerate(tq_pts):
                t = time + tau * it + tau * q
                F = force_u(t)
                if type_ == TimeStepType.DG:
                    c = a1[j, j]
                    step_parts[j] = (F * c if step_parts[j] is None
                                     else step_parts[j] + F * c)
                else:
                    if j == 0:
                        for i in range(nt):
                            c = -g1[i, 0]
                            step_parts[i] = (F * c if step_parts[i] is None
                                             else step_parts[i] + F * c)
                    else:
                        c = a1[j - 1, j - 1]
                        step_parts[j - 1] = (
                            F * c if step_parts[j - 1] is None
                            else step_parts[j - 1] + F * c)
            parts += step_parts
        flat_u = jnp.stack([p.reshape(-1) for p in parts])
        return jnp.concatenate(
            [flat_u, jnp.broadcast_to(zero_p, (T, zero_p.size))], axis=1)

    precond = None
    if preconditioner_factory is not None:
        ctx = dict(mesh=mesh, fe_degree=fe_degree, u_degree=u_degree,
                   p_degree=p_degree, type_=type_, viscosity=viscosity,
                   n_timesteps_at_once=n_timesteps_at_once, time_step=tau,
                   n_q=n_q, refinement=refinement, weak_faces=weak_faces,
                   dg_pressure=dg_pressure)
        precond = preconditioner_factory(ctx)

    @jax.jit
    def solve_slab(matrix_, rhs_matrix_, precond_, prev_flat, time):
        prev_u = prev_flat[:S.n_u].reshape((dim,) + S.dof_shape_u)
        prev_p = prev_flat[S.n_u:].reshape(S.p_shape)
        rhs = rhs_matrix_.vmult_slice(prev_u, prev_p)
        rhs = rhs + assemble_force(time)
        x0 = (jnp.broadcast_to(prev_flat, (T, prev_flat.size))
              if extrapolate else jnp.zeros((T, prev_flat.size)))
        res = fgmres(matrix_.vmult, rhs, x0, precondition=precond_,
                     maxiter=gmres_maxiter, abstol=1e-12, reltol=rel_tol)
        return res

    err = StokesErrorCalculator(S, type_, fe_degree)
    coords_u = jnp.asarray(mesh.dof_coordinates(u_degree))
    u0 = jnp.moveaxis(stokes_problem.exact_u(coords_u, 0.0), -1, 0)
    p0 = jnp.zeros(S.p_shape)  # exact p(0) = 0
    prev_flat = S.pack(u0, p0)

    vol = float(np.prod(np.asarray(mesh.upper) - np.asarray(mesh.lower)))
    detj = float(np.prod(mesh.h))

    time, l2, linf, h1, hdiv = 0.0, 0.0, -1.0, 0.0, 0.0
    l2p, linfp, h1p = 0.0, -1.0, 0.0
    total_iters, n_slabs = 0, 0
    while time < end_time - 1e-12:
        res: FGMRESResult = solve_slab(matrix, rhs_matrix, precond,
                                       prev_flat, jnp.asarray(time))
        assert bool(res.converged), (time, float(res.residual))
        total_iters += int(res.iterations)
        x = res.x
        u_time, p_time = S.unpack(x)
        if mean_pressure:
            if dg_pressure:
                # subtract the mean from each pressure time block (DGP: the
                # constant-mode coefficient carries the cell mean)
                means = jnp.sum(p_time[..., 0],
                                axis=tuple(range(1, dim + 1))) * detj / vol
                p_time = p_time.at[..., 0].add(
                    -means.reshape((T,) + (1,) * dim))
            else:
                pq = S._p_at_quad(p_time)
                means = jnp.sum(pq * S.jxw,
                                axis=tuple(range(1, pq.ndim))) / vol
                p_time = p_time - means.reshape((T,) + (1,) * dim)
        prev_u = prev_flat[:S.n_u].reshape((dim,) + S.dof_shape_u)
        prev_p = prev_flat[S.n_u:].reshape(S.p_shape)
        e = err.evaluate(time, tau, u_time, p_time, prev_u, prev_p,
                         n_timesteps_at_once)
        l2 += e["l2_u"]
        h1 += e["h1_u"]
        hdiv += e["hdiv_u"]
        linf = max(linf, e["linf_u"])
        l2p += e["l2_p"]
        h1p += e["h1_p"]
        linfp = max(linfp, e["linf_p"])
        prev_flat = S.pack(u_time[-1], p_time[-1])
        time += n_timesteps_at_once * tau
        n_slabs += 1

    return StokesCycleResult(
        n_cells=mesh.n_cells, n_dofs_u=S.n_u, n_dofs_p=S.n_p,
        n_blocks=2 * T, n_timesteps=n_slabs, total_iterations=total_iters,
        avg_iterations=total_iters / n_slabs,
        l2_l2_u=float(np.sqrt(l2)), linf_linf_u=float(linf),
        l2_h1_u=float(np.sqrt(h1)), l2_hdiv_u=float(np.sqrt(hdiv)),
        l2_l2_p=float(np.sqrt(l2p)), linf_linf_p=float(linfp),
        l2_h1_p=float(np.sqrt(h1p)))


def run_lid_driven(refinement: int = 3, fe_degree: int = 1,
                   type_: TimeStepType = TimeStepType.DG,
                   n_timesteps_at_once: int = 1, viscosity: float = 1.0,
                   end_time: float = 2.0, u_max: float = 1.0,
                   preconditioner_factory=None, gmres_maxiter: int = 100,
                   rel_tol: float = 1e-8, n_slabs_max: int | None = None,
                   strong_bc: bool = False, boundary_lift: bool = True,
                   functionals_path: str | None = None,
                   probe_points=((0.5, 0.5),)):
    """Lid-driven cavity with a moving wall, weak (Nitsche) or strong.

    Reference setup (tests/json/tf05stokes.json + stokes::LidDriven,
    stokes.h:72-99): boundary id 1 (x = x_max face) moves tangentially with
    u_y = u_max * sin(pi t / 4); all other walls no-slip.  The shipped lid
    config runs nitscheBoundary=true (weak); the reference's strong path
    interpolates g at every (timestep, time-dof) quadrature time, zeroes the
    constrained entries before the slab solve and pastes the values after
    (tp_03stokes.cc:1022-1046, operators.h:2103-2223).  strong_bc=True
    replicates that scheme; boundary_lift=True additionally applies the
    mathematically consistent lift rhs -= A x_g on interior rows (the
    reference omits it -- its matrix-free reads constrained dofs as zero, so
    the pasted data never feeds the interior equations; see ops/boundary.py).
    Returns per-slab iteration counts and the final (u, p) fields.
    """
    dim = 2
    is_cgp = type_ == TimeStepType.CGP
    u_degree = fe_degree + 1
    p_degree = fe_degree
    n_q = u_degree + 1
    nt = fe_degree if is_cgp else fe_degree + 1
    mesh = StructuredMesh([1, 1], [0.0, 0.0], [1.0, 1.0],
                          refinement=refinement)
    step_ = min(mesh.coarse_cell_diameter, end_time)
    n_steps = max(int(end_time / step_), 1)
    tau = end_time * 2.0 ** (-(refinement + 1)) / n_steps
    T = nt * n_timesteps_at_once

    # x = x_max: the moving wall (boundary id 1); strong mode eliminates it
    weak_faces = () if strong_bc else ((0, 1),)
    S = StokesOperator(mesh, u_degree, p_degree, n_q, viscosity,
                       weak_faces=weak_faces)
    Mu = LaplaceMassOperator(mesh, u_degree, n_q, 1.0, 0.0,
                             mask=S.mask_u_np)
    a, b, g, z = get_fe_time_weights(type_, fe_degree, tau,
                                     n_timesteps_at_once)
    a1, b1, g1, z1 = get_fe_time_weights(type_, fe_degree, tau, 1)
    matrix = StokesSystemMatrix(S, Mu, a, b)
    rhs_matrix = StokesSystemMatrix(S, Mu, a, b,
                                    gamma=g if is_cgp else None,
                                    zeta=z if is_cgp else g, type_=type_)

    def lid_g(coords, t):
        gx = jnp.zeros(coords.shape[:-1])
        gy = jnp.full(coords.shape[:-1], u_max) * jnp.sin(np.pi * t / 4.0)
        return jnp.stack([gx, gy], axis=-1)

    tq_pts = get_time_quad(type_, fe_degree)[0]

    def assemble_nitsche_rhs(time):
        """Reference TimeIntegrator::assemble_nitsche
        (time_integrators.h:126-171): weak data integrated per time-quadrature
        point with the diagonal-Alpha rule."""
        parts_u = [None] * T
        parts_p = [None] * T
        for it in range(n_timesteps_at_once):
            for j, q in enumerate(tq_pts):
                t = time + tau * it + tau * float(q)
                ru, rp = S.nitsche_rhs(lid_g, t)
                if type_ == TimeStepType.DG:
                    tt = it * nt + j
                    coef = [(tt, a1[j, j])]
                else:
                    if j == 0:
                        coef = [(it * nt + i, -g1[i, 0]) for i in range(nt)]
                    else:
                        coef = [(it * nt + j - 1, a1[j - 1, j - 1])]
                for tt, c in coef:
                    pu = ru * c
                    pp = rp * c
                    parts_u[tt] = pu if parts_u[tt] is None \
                        else parts_u[tt] + pu
                    parts_p[tt] = pp if parts_p[tt] is None \
                        else parts_p[tt] + pp
        flat = [jnp.concatenate([parts_u[tt].reshape(-1),
                                 parts_p[tt].reshape(-1)]) for tt in range(T)]
        return jnp.stack(flat)

    precond = None
    if preconditioner_factory is not None:
        ctx = dict(mesh=mesh, fe_degree=fe_degree, u_degree=u_degree,
                   p_degree=p_degree, type_=type_, viscosity=viscosity,
                   n_timesteps_at_once=n_timesteps_at_once, time_step=tau,
                   n_q=n_q, refinement=refinement, weak_faces=weak_faces)
        precond = preconditioner_factory(ctx)

    # strong mode: lid values supported on the moving-wall dofs EXCLUDING
    # the cavity corners (the reference's no-slip zero constraints are added
    # first and win there, operators.h:2110-2112)
    if strong_bc:
        from ..ops.boundary import slab_time_offsets
        cu = mesh.dof_coordinates(u_degree)
        on_wall = np.isclose(cu[..., 0], 1.0)
        on_other = (np.isclose(cu[..., 0], 0.0) | np.isclose(cu[..., 1], 0.0)
                    | np.isclose(cu[..., 1], 1.0))
        lid = jnp.asarray((on_wall & ~on_other).astype(S.dtype))
        t_offsets = jnp.asarray(slab_time_offsets(
            type_, fe_degree, tau, n_timesteps_at_once), S.dtype)
        u_mask_flat = jnp.concatenate(
            [jnp.broadcast_to(S.mask_u, (dim,) + S.dof_shape_u).reshape(-1),
             jnp.ones((S.n_p,), S.dtype)])

        def xg_blocks(time):
            """[T, n_u+n_p] boundary-supported g at every block time."""
            amps = u_max * jnp.sin(np.pi * (time + t_offsets) / 4.0)
            gy = amps[:, None, None] * lid[None]
            gu = jnp.stack([jnp.zeros_like(gy), gy], axis=1)
            return jnp.concatenate(
                [gu.reshape(T, -1), jnp.zeros((T, S.n_p), S.dtype)], axis=1)

    @jax.jit
    def solve_slab(matrix_, rhs_matrix_, precond_, prev_flat, time):
        prev_u = prev_flat[:S.n_u].reshape((dim,) + S.dof_shape_u)
        prev_p = prev_flat[S.n_u:].reshape(S.p_shape)
        if strong_bc:
            x_g = xg_blocks(time)
            if boundary_lift:
                # consistent lift: prev read unmasked (its pasted boundary
                # values feed the time coupling) and rhs -= A x_g
                rhs = rhs_matrix_.vmult_slice(prev_u, prev_p,
                                              mask_input=False)
                rhs = rhs - matrix_.vmult(x_g, mask_input=False)
            else:
                # reference paste scheme (constrained dofs read as zero)
                rhs = rhs_matrix_.vmult_slice(prev_u, prev_p)
            x0 = jnp.broadcast_to(prev_flat * u_mask_flat,
                                  (T, prev_flat.size))
        else:
            rhs = rhs_matrix_.vmult_slice(prev_u, prev_p)
            rhs = rhs + assemble_nitsche_rhs(time)
            x0 = jnp.broadcast_to(prev_flat, (T, prev_flat.size))
        res = fgmres(matrix_.vmult, rhs, x0, precondition=precond_,
                     maxiter=gmres_maxiter, abstol=1e-12, reltol=rel_tol)
        if strong_bc:
            # reference set_inhomogeneity after the solve
            res = res._replace(x=res.x * u_mask_flat[None] + xg_blocks(time))
        return res

    # functionals: probe u + moving-wall force + divergence per time dof,
    # resampled by the time-evaluation matrix (reference practical Stokes
    # output, tp_03stokes.cc:918-996)
    pe = writer = None
    if functionals_path is not None:
        from ..ops.functionals import (compute_divergence_norm,
                                       compute_wall_force)
        from ..utils.probes import FunctionalsWriter, PointEvaluator
        pe = PointEvaluator(mesh, u_degree, probe_points)
        writer = FunctionalsWriter(functionals_path, type_, fe_degree)

        def functional_row(u_b, p_b):
            vals = [v for c in range(dim) for v in pe(np.asarray(u_b[c]))]
            dl = compute_wall_force(S, u_b, p_b, (0, 1))
            vals += [dl[0], dl[1],
                     compute_divergence_norm(S, jnp.asarray(u_b))]
            return np.asarray(vals)

        prev_row = functional_row(jnp.zeros((dim,) + S.dof_shape_u),
                                  jnp.zeros(S.p_shape))

    prev_flat = jnp.zeros(S.n_u + S.n_p)
    time = 0.0
    iters = []
    n_slabs = int(round(end_time / (n_timesteps_at_once * tau)))
    if n_slabs_max is not None:
        n_slabs = min(n_slabs, n_slabs_max)
    for s in range(n_slabs):
        res = solve_slab(matrix, rhs_matrix, precond, prev_flat,
                         jnp.asarray(time))
        assert bool(res.converged), (time, float(res.residual))
        iters.append(int(res.iterations))
        x = res.x
        u_time, p_time = S.unpack(x)
        means = jnp.sum(p_time[..., 0], axis=tuple(range(1, dim + 1))) \
            * float(np.prod(mesh.h)) / 1.0
        p_time = p_time.at[..., 0].add(-means.reshape((T,) + (1,) * dim))
        if writer is not None:
            for it in range(n_timesteps_at_once):
                rows = np.stack([functional_row(u_time[it * nt + i],
                                                p_time[it * nt + i])
                                 for i in range(nt)])
                writer.write_step(time + it * tau, tau, rows,
                                  prev_row if is_cgp else None)
                prev_row = rows[-1]
        prev_flat = S.pack(u_time[-1], p_time[-1])
        time += n_timesteps_at_once * tau
    u, p = S.unpack(prev_flat)
    return dict(iterations=iters, u=np.asarray(u), p=np.asarray(p),
                tau=tau, time=time)


def run_navier_stokes_cycle(refinement: int, fe_degree: int,
                            type_: TimeStepType = TimeStepType.DG,
                            n_timesteps_at_once: int = 1,
                            viscosity: float = 1.0, end_time: float = 1.0,
                            n_picard: int = 3,
                            preconditioner_factory=None,
                            gmres_maxiter: int = 200,
                            rel_tol: float = 1e-10,
                            delta0: float = 0.0,
                            nonlinear_extrapolation=None) -> StokesCycleResult:
    """Navier-Stokes convergence cycle: per slab, a Picard (Oseen) iteration
    with the convective linearization in "form" mode; the manufactured
    solution/RHS include the convection term (reference stokes::RHSFunction
    with nonlinear factor, exact_solution.h:287-317).

    The reference plumbs the nonlinear machinery without shipping a solver
    loop (SURVEY.md section 3.3); this driver exercises it.

    nonlinear_extrapolation (types.NonlinearExtrapolation or None): build
    the first linearization point of each slab by the reference's
    extrapolation matrix applied to the previous slab's time polynomial
    (extrapolate_nonlinear, fe_time.h:1223-1240); None broadcasts the
    previous value (the Constant predictor).
    """
    dim = 2
    is_cgp = type_ == TimeStepType.CGP
    u_degree = fe_degree + 1
    p_degree = fe_degree
    n_q = u_degree + 1
    nt = fe_degree if is_cgp else fe_degree + 1
    mesh = StructuredMesh([1, 1], [0.0, 0.0], [1.0, 1.0],
                          refinement=refinement)
    step_ = min(mesh.coarse_cell_diameter, end_time)
    n_steps = int(end_time / step_)
    tau = end_time * 2.0 ** (-(refinement + 1)) / n_steps
    T = nt * n_timesteps_at_once

    S = StokesOperator(mesh, u_degree, p_degree, n_q, viscosity,
                       delta0=delta0)
    Mu = LaplaceMassOperator(mesh, u_degree, n_q, 1.0, 0.0,
                             mask=S.mask_u_np)
    a, b, g, z = get_fe_time_weights(type_, fe_degree, tau,
                                     n_timesteps_at_once)
    matrix = StokesSystemMatrix(S, Mu, a, b)
    rhs_matrix = StokesSystemMatrix(S, Mu, a, b,
                                    gamma=g if is_cgp else None,
                                    zeta=z if is_cgp else g, type_=type_)

    sd = shape_data_1d(u_degree, n_q)
    Sf = jnp.asarray(sd.S)
    geom = mesh.geometry(n_q, u_degree)
    jxw = jnp.asarray(geom.jxw)
    fcoords = jnp.asarray(quad_coordinates(mesh, n_q))

    def force_u(t):
        f = stokes_problem.rhs_u(fcoords, t, viscosity, navier=True)
        comps = []
        for c in range(dim):
            y = _sumfac([Sf] * dim, f[..., c] * jxw, dim, forward=False)
            comps.append(cell_scatter(y, mesh.cells, u_degree))
        return jnp.stack(comps, axis=0) * S.mask_u

    a1, b1, g1, z1 = get_fe_time_weights(type_, fe_degree, tau, 1)
    tq_pts = get_time_quad(type_, fe_degree)[0]

    def assemble_force(time):
        zero_p = jnp.zeros((S.n_p,))
        parts = [None] * T
        for it in range(n_timesteps_at_once):
            for j, q in enumerate(tq_pts):
                t = time + tau * it + tau * float(q)
                F = force_u(t)
                if type_ == TimeStepType.DG:
                    tt, c = it * nt + j, a1[j, j]
                    parts[tt] = F * c if parts[tt] is None \
                        else parts[tt] + F * c
                else:
                    if j == 0:
                        for i in range(nt):
                            tt, c = it * nt + i, -g1[i, 0]
                            parts[tt] = F * c if parts[tt] is None \
                                else parts[tt] + F * c
                    else:
                        tt, c = it * nt + j - 1, a1[j - 1, j - 1]
                        parts[tt] = F * c if parts[tt] is None \
                            else parts[tt] + F * c
        flat_u = jnp.stack([p_.reshape(-1) for p_ in parts])
        return jnp.concatenate(
            [flat_u, jnp.broadcast_to(zero_p, (T, zero_p.size))], axis=1)

    precond = None
    if preconditioner_factory is not None:
        ctx = dict(mesh=mesh, fe_degree=fe_degree, u_degree=u_degree,
                   p_degree=p_degree, type_=type_, viscosity=viscosity,
                   n_timesteps_at_once=n_timesteps_at_once, time_step=tau,
                   n_q=n_q, refinement=refinement, weak_faces=())
        precond = preconditioner_factory(ctx)

    @jax.jit
    def solve_oseen(matrix_, rhs_matrix_, precond_, prev_flat, u_lin, time):
        prev_u = prev_flat[:S.n_u].reshape((dim,) + S.dof_shape_u)
        prev_p = prev_flat[S.n_u:].reshape(S.p_shape)
        rhs = rhs_matrix_.vmult_slice(prev_u, prev_p)
        rhs = rhs + assemble_force(time)
        x0 = jnp.broadcast_to(prev_flat, (T, prev_flat.size))
        A = lambda v: matrix_.vmult(v, u_lin=u_lin, mode="form")
        res = fgmres(A, rhs, x0, precondition=precond_,
                     maxiter=gmres_maxiter, abstol=1e-12, reltol=rel_tol)
        return res

    err = StokesErrorCalculator(S, type_, fe_degree)
    coords_u = jnp.asarray(mesh.dof_coordinates(u_degree))
    u0 = jnp.moveaxis(stokes_problem.exact_u(coords_u, 0.0), -1, 0)
    p0 = jnp.zeros(mesh.cells + (S.n_ploc,))
    prev_flat = S.pack(u0, p0)
    detj = float(np.prod(mesh.h))

    E_extra = None
    if nonlinear_extrapolation is not None:
        assert n_timesteps_at_once == 1, \
            "extrapolation predictor wired for single-step slabs"
        from ..time.tables import get_extrapolation_matrix
        E_extra = jnp.asarray(get_extrapolation_matrix(
            type_, nonlinear_extrapolation, fe_degree, 1.0, 0.0, 0.0))

    time, l2, linf, h1, hdiv = 0.0, 0.0, -1.0, 0.0, 0.0
    l2p, linfp, h1p = 0.0, -1.0, 0.0
    total_iters, n_slabs = 0, 0
    prev_slab_u = None       # previous slab's u blocks (extrapolation src)
    prev_slab_start = None   # u at the previous slab's start
    while time < end_time - 1e-12:
        # Picard: first linearization point from the previous slab --
        # constant broadcast, or the extrapolation-matrix predictor
        # (reference extrapolate_nonlinear, fe_time.h:1223-1240)
        if E_extra is not None and prev_slab_u is not None:
            src = jnp.concatenate([prev_slab_start[None], prev_slab_u],
                                  axis=0)
            u_lin = jnp.einsum("ij,j...->i...", E_extra, src)
        else:
            u_lin = jnp.broadcast_to(
                prev_flat[:S.n_u].reshape((dim,) + S.dof_shape_u),
                (T, dim) + S.dof_shape_u)
        for _ in range(n_picard):
            res: FGMRESResult = solve_oseen(matrix, rhs_matrix, precond,
                                            prev_flat, u_lin,
                                            jnp.asarray(time))
            u_lin, _ = S.unpack(res.x)
        assert bool(res.converged), (time, float(res.residual))
        total_iters += int(res.iterations)
        u_time, p_time = S.unpack(res.x)
        means = jnp.sum(p_time[..., 0], axis=tuple(range(1, dim + 1))) \
            * detj
        p_time = p_time.at[..., 0].add(-means.reshape((T,) + (1,) * dim))
        prev_u = prev_flat[:S.n_u].reshape((dim,) + S.dof_shape_u)
        prev_p = prev_flat[S.n_u:].reshape(S.p_shape)
        e = err.evaluate(time, tau, u_time, p_time, prev_u, prev_p,
                         n_timesteps_at_once)
        l2 += e["l2_u"]; h1 += e["h1_u"]; hdiv += e["hdiv_u"]
        linf = max(linf, e["linf_u"])
        l2p += e["l2_p"]; h1p += e["h1_p"]
        linfp = max(linfp, e["linf_p"])
        prev_slab_start = prev_flat[:S.n_u].reshape((dim,) + S.dof_shape_u)
        prev_slab_u = u_time
        prev_flat = S.pack(u_time[-1], p_time[-1])
        time += n_timesteps_at_once * tau
        n_slabs += 1

    return StokesCycleResult(
        n_cells=mesh.n_cells, n_dofs_u=S.n_u, n_dofs_p=S.n_p,
        n_blocks=2 * T, n_timesteps=n_slabs, total_iterations=total_iters,
        avg_iterations=total_iters / n_slabs,
        l2_l2_u=float(np.sqrt(l2)), linf_linf_u=float(linf),
        l2_h1_u=float(np.sqrt(h1)), l2_hdiv_u=float(np.sqrt(hdiv)),
        l2_l2_p=float(np.sqrt(l2p)), linf_linf_p=float(linfp),
        l2_h1_p=float(np.sqrt(h1p)))


def dfg_square_mesh(refinement: int = 1, dim: int = 2,
                    vertex_map=None, map_exact: bool = False):
    """The dfgBenchmarkSquare channel: non-uniform tensor subdivision with
    the cell column around the obstacle removed (reference grids.h:243-323;
    2D: [0,2.2]x[0,0.41], obstacle at (0.2,0.2); 3D: [0,2.5]x[0,0.41]^2,
    obstacle column at x,y = (0.5, 0.2))."""
    if dim == 2:
        x_steps = [0.15, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.35, 0.35]
        y_steps = [0.15, 0.1, 0.16]
        base_mask = np.ones((len(x_steps), len(y_steps)))
        base_mask[1, 1] = 0.0  # the [0.15,0.25]^2 obstacle cell
        steps = [x_steps, y_steps]
        lower = [0.0, 0.0]
    else:
        x_steps = [0.3, 0.15, 0.1, 0.15, 0.25, 0.25, 0.25, 0.25, 0.25,
                   0.25, 0.3]
        y_steps = [0.15, 0.1, 0.16]
        z_steps = [0.41 / 3] * 3
        base_mask = np.ones((len(x_steps), len(y_steps), len(z_steps)))
        base_mask[2, 1, :] = 0.0  # obstacle column through z
        steps = [x_steps, y_steps, z_steps]
        lower = [0.0, 0.0, 0.0]
    r = 2 ** refinement
    cm = base_mask
    for d in range(dim):
        cm = np.repeat(cm, r, axis=d)
    return StructuredMesh([1] * dim, lower, None, refinement=refinement,
                          cell_mask=cm, axis_steps=steps,
                          vertex_map=vertex_map, map_exact=map_exact)


def dfg_cylinder_map(center, half_width: float = 0.05,
                     radius: float = 0.05, support: float = 0.14):
    """Smooth compactly-supported morph (x,y)->(x,y) that carries the square
    obstacle boundary {max(|x-cx|,|y-cy|) = half_width} exactly onto the
    circle of the given radius, decaying to the identity at distance
    `support` from the obstacle center.  The structured-mesh analogue of the
    reference's dfgBenchmark curved manifolds (grids.h:196-242): instead of
    attaching a CylindricalManifold to a multiblock grid we morph the masked
    tensor grid, keeping the pure-arithmetic DoF indexing.

    Acts on the leading two coordinates; extra coordinates (the 3D channel's
    z axis along the cylinder) pass through unchanged.  jax-traceable, so
    map_exact geometry can take analytic Jacobians through it."""
    import jax.numpy as jnp
    cx, cy = center

    def fmap(x):
        dx = x[..., 0] - cx
        dy = x[..., 1] - cy
        r2 = dx * dx + dy * dy
        r = jnp.sqrt(jnp.maximum(r2, 1e-30))
        m = jnp.maximum(jnp.abs(dx), jnp.abs(dy))
        # distance along the ray to the square obstacle boundary
        r_sq = half_width * r / jnp.maximum(m, 1e-30)
        un = jnp.clip((r - r_sq) / (support - r_sq), 0.0, 1.0)
        w = 1.0 - un * un * (3.0 - 2.0 * un)   # smoothstep decay
        s = 1.0 + w * (radius - r_sq) / r
        # inside the obstacle (r < r_sq) keep the pure radial rescale so the
        # removed cells deform consistently with their boundary
        s_in = radius / jnp.maximum(r_sq, 1e-30)
        s = jnp.where(r < r_sq, s_in, s)
        out = [cx + dx * s, cy + dy * s]
        for d in range(2, x.shape[-1]):
            out.append(x[..., d])
        return jnp.stack(out, axis=-1)

    return fmap


def dfg_cylinder_mesh(refinement: int = 1, dim: int = 2,
                      map_exact: bool = True):
    """The DFG cylinder channel (reference gridDescriptor dfgBenchmark,
    grids.h:196-242): the dfgBenchmarkSquare masked tensor grid morphed so
    the obstacle boundary is the cylinder of diameter 0.1 at (0.2,0.2)
    (2D; at x,y = (0.5,0.2) through z in 3D)."""
    center = (0.2, 0.2) if dim == 2 else (0.5, 0.2)
    fmap = dfg_cylinder_map(center)
    return dfg_square_mesh(refinement, dim, vertex_map=fmap,
                           map_exact=map_exact)


def run_dfg_square(refinement: int = 1, fe_degree: int = 1,
                   type_: TimeStepType = TimeStepType.DG,
                   viscosity: float = 1e-3, u_mean: float = 0.2,
                   dfg_benchmark: int = 3, end_time: float = 8.0,
                   tau: float = 1.0 / 16.0, n_slabs: int = 4,
                   preconditioner_factory=None, gmres_maxiter: int = 100,
                   rel_tol: float = 1e-8, cylinder: bool = False,
                   weak_obstacle: bool = False):
    """Flow around the obstacle (DFG 2D benchmark, reference
    tests/tp_03stokes.cc + stokes_dfg.json): weak (Nitsche) inflow with the
    DFG parabolic profile, weak no-slip walls, do-nothing outflow.

    cylinder=False: the dfgBenchmarkSquare grid (square obstacle);
    cylinder=True: the dfgBenchmark grid (curved cylinder of diameter 0.1
    via the exact-geometry squircle morph, drag/lift on the curved
    boundary).

    weak_obstacle=True imposes the obstacle no-slip by Nitsche on the
    (curved) obstacle faces -- the reference's scheme
    (operators.h:1658-1751 applies to all weak boundaries incl. the
    cylinder); False eliminates the obstacle dofs strongly (mask).
    """
    dim = 2
    is_cgp = type_ == TimeStepType.CGP
    u_degree = fe_degree + 1
    p_degree = fe_degree
    n_q = u_degree + 1
    nt = fe_degree if is_cgp else fe_degree + 1
    mesh = dfg_cylinder_mesh(refinement) if cylinder \
        else dfg_square_mesh(refinement)
    T = nt
    u_max = u_mean * 1.5   # 2D (reference stokes.h:41)

    weak_faces = ((0, 0), (1, 0), (1, 1))   # inflow + both walls
    free_faces = ((0, 1),)                   # do-nothing outflow
    S = StokesOperator(mesh, u_degree, p_degree, n_q, viscosity,
                       weak_faces=weak_faces, free_faces=free_faces,
                       weak_obstacle=weak_obstacle)
    Mu = LaplaceMassOperator(mesh, u_degree, n_q, 1.0, 0.0,
                             mask=S.mask_u_np)
    a, b, g, z = get_fe_time_weights(type_, fe_degree, tau, 1)
    matrix = StokesSystemMatrix(S, Mu, a, b)
    rhs_matrix = StokesSystemMatrix(S, Mu, a, b,
                                    gamma=g if is_cgp else None,
                                    zeta=z if is_cgp else g, type_=type_)

    def g_inflow(coords, t):
        y = coords[..., 1]
        x = coords[..., 0]
        if dfg_benchmark == 3:
            factor = jnp.sin(np.pi * t / 8.0)
        else:
            factor = jnp.where(t < 0.1,
                               0.5 - 0.5 * jnp.cos(10.0 * np.pi * t), 1.0)
        prof = 4.0 * u_max * y * (0.41 - y) / 0.41 ** 2
        gx = jnp.where(x < 1e-8, prof * factor, 0.0)
        return jnp.stack([gx, jnp.zeros_like(gx)], axis=-1)

    tq_pts = get_time_quad(type_, fe_degree)[0]
    a1 = a

    def assemble_nitsche_rhs(time):
        parts_u = [None] * T
        parts_p = [None] * T
        for j, q in enumerate(tq_pts):
            t = time + tau * float(q)
            ru, rp = S.nitsche_rhs(g_inflow, t)
            if type_ == TimeStepType.DG:
                coef = [(j, a1[j, j])]
            else:
                coef = ([(i, -g[i, 0]) for i in range(nt)] if j == 0
                        else [(j - 1, a1[j - 1, j - 1])])
            for tt, c in coef:
                pu, pp = ru * c, rp * c
                parts_u[tt] = pu if parts_u[tt] is None else parts_u[tt] + pu
                parts_p[tt] = pp if parts_p[tt] is None else parts_p[tt] + pp
        return jnp.stack([jnp.concatenate([parts_u[tt].reshape(-1),
                                           parts_p[tt].reshape(-1)])
                          for tt in range(T)])

    precond = None
    if preconditioner_factory is not None:
        ctx = dict(mesh=mesh, fe_degree=fe_degree, u_degree=u_degree,
                   p_degree=p_degree, type_=type_, viscosity=viscosity,
                   n_timesteps_at_once=1, time_step=tau, n_q=n_q,
                   refinement=refinement, weak_faces=weak_faces,
                   free_faces=free_faces, weak_obstacle=weak_obstacle)
        precond = preconditioner_factory(ctx)

    @jax.jit
    def solve_slab(matrix_, rhs_matrix_, precond_, prev_flat, time):
        prev_u = prev_flat[:S.n_u].reshape((dim,) + S.dof_shape_u)
        prev_p = prev_flat[S.n_u:].reshape(S.p_shape)
        rhs = rhs_matrix_.vmult_slice(prev_u, prev_p)
        rhs = rhs + assemble_nitsche_rhs(time)
        x0 = jnp.broadcast_to(prev_flat, (T, prev_flat.size))
        res = fgmres(matrix_.vmult, rhs, x0, precondition=precond_,
                     maxiter=gmres_maxiter, abstol=1e-12, reltol=rel_tol)
        return res

    from ..ops.functionals import compute_divergence_norm, compute_drag_lift
    # reference drag/lift scale: 2/(D u_mean^2 H) (tp_03stokes.cc:914-917)
    dl_scale = 2.0 / (0.1 * u_mean ** 2 * 0.41)
    prev_flat = jnp.zeros(S.n_u + S.n_p)
    time, iters = 0.0, []
    drag_lift, div_norms = [], []
    for s in range(n_slabs):
        res = solve_slab(matrix, rhs_matrix, precond, prev_flat,
                         jnp.asarray(time))
        assert bool(res.converged), (time, float(res.residual))
        iters.append(int(res.iterations))
        u_time, p_time = S.unpack(res.x)
        prev_flat = S.pack(u_time[-1], p_time[-1])
        drag_lift.append(compute_drag_lift(S, u_time[-1], p_time[-1],
                                           dl_scale))
        div_norms.append(compute_divergence_norm(S, u_time[-1]))
        time += tau
    u, p = S.unpack(prev_flat)
    return dict(iterations=iters, u=np.asarray(u), p=np.asarray(p),
                mesh=mesh, time=time, drag_lift=np.asarray(drag_lift),
                divergence=div_norms)
