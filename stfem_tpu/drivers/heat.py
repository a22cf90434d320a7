"""Heat/wave convergence driver: the tp_01 application rebuilt in JAX
(reference tests/tp_01.cc).  One call = one (refinement, degree) cycle:
build mesh/operators/tables, march the time loop, return errors + iteration
counts for the convergence tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from ..errors import ErrorCalculator
from ..integrators import ForceAssembler, TimeIntegratorFO, TimeIntegratorWave
from ..mesh.grid import StructuredMesh
from ..ops.spatial import LaplaceMassOperator
from ..problems import heat as heat_problem
from ..system import SystemMatrix
from ..time.tables import get_fe_time_weights, get_fe_time_weights_wave
from ..types import ProblemType, TimeStepType


def stmg_preconditioner_factory(dtype=None, params=None, **build_kwargs):
    """preconditioner_factory building the reference-default STMG V-cycle
    (float32 preconditioner under the f64 outer solve, tp_01.cc:801-806)."""
    import jax.numpy as jnp
    from ..stmg.gmg import build_stmg

    def factory(ctx):
        pdtype = dtype if dtype is not None else jnp.float32
        gmg = build_stmg(ctx["mesh"], ctx["fe_degree"], ctx["space_degree"],
                         ctx["type_"], ctx["n_timesteps_at_once"],
                         ctx["time_step"], problem=ctx["problem"],
                         params=params, dtype=pdtype,
                         laplace_coefficient=ctx.get("coefficient"),
                         **build_kwargs)
        return gmg  # pytree module; callable via __call__ = vmult

    return factory


@dataclass
class CycleResult:
    n_cells: int
    n_dofs: int
    n_blocks: int
    n_timesteps: int
    total_iterations: int
    avg_iterations: float
    l2_l2: float
    linf_linf: float
    l2_h1: float

    @property
    def st_dofs(self):
        return self.n_timesteps * self.n_dofs * self.n_blocks


def run_heat_cycle(refinement: int, fe_degree: int,
                   type_: TimeStepType = TimeStepType.DG,
                   problem: ProblemType = ProblemType.heat,
                   n_timesteps_at_once: int = 2,
                   subdivisions=(1, 1), lower=(0.0, 0.0), upper=(1.0, 1.0),
                   end_time: float = 1.0, frequency: float = 1.0,
                   preconditioner_factory=None, gmres_maxiter: int = 100,
                   rel_tol: float = 1e-12,
                   extrapolate: bool = True,
                   distort_grid: float = 0.0,
                   coefficient=None, compute_errors: bool = True,
                   initial_fn=None, rhs_fn_override=None,
                   do_output: bool = False,
                   output_prefix: str = "solution",
                   timer=None,
                   dirichlet_g=None, boundary_lift: bool = True,
                   exact_override=None,
                   initial_v_fn=None,
                   probe_points=None,
                   functionals_path: str | None = None) -> CycleResult:
    """One convergence cycle (reference tp_01.cc:56-725).

    preconditioner_factory(ctx) -> callable: builds the STMG preconditioner
    from the cycle context dict; None runs unpreconditioned FGMRES.
    timer: optional utils.timer.TimerOutput -- records "setup" and "step"
    scopes (the reference's TimerOutput scopes, tp_01.cc:648,709-710; inside
    one jitted slab solve XLA fuses vmult/vanka/gmg, so the per-step wall
    time is the honest granularity on an accelerator).
    """
    from contextlib import nullcontext
    dim = len(subdivisions)
    scope = timer.scope if timer is not None else \
        (lambda *a, **k: nullcontext())
    is_cgp = type_ == TimeStepType.CGP
    space_degree = fe_degree + 1
    n_q = space_degree + 1
    nt_dofs = fe_degree if is_cgp else fe_degree + 1
    n_blocks = nt_dofs * n_timesteps_at_once

    mesh = StructuredMesh(subdivisions, lower, upper, refinement=refinement,
                          distort=distort_grid)
    # reference tp_01.cc:87,105-108: timestep from the UNREFINED cell size
    spc_step = mesh.coarse_cell_diameter / np.sqrt(dim)
    # guard: the reference's integer division assumes end_time >= spc_step
    # (true for every shipped config); short-horizon runs get one step
    n_steps = max(int(end_time / spc_step), 1)
    time_step = end_time * 2.0 ** (-(refinement + 1)) / n_steps

    K = LaplaceMassOperator(mesh, space_degree, n_q, 0.0, 1.0,
                            coefficient=coefficient)
    M = LaplaceMassOperator(mesh, space_degree, n_q, 1.0, 0.0)

    Alpha_1, Beta_1, Gamma_1, Zeta_1 = get_fe_time_weights(
        type_, fe_degree, time_step, 1)
    Alpha, Beta, Gamma, Zeta = get_fe_time_weights(
        type_, fe_degree, time_step, n_timesteps_at_once)
    zero_col = np.zeros_like(Gamma)

    f = frequency
    if problem == ProblemType.wave:
        A_lhs, B_lhs, rhs_uK, rhs_uM, rhs_vM = get_fe_time_weights_wave(
            type_, Alpha_1, Beta_1, Gamma_1, Zeta_1, n_timesteps_at_once)
        matrix = SystemMatrix(K, M, A_lhs, B_lhs)
        rhs_matrix = SystemMatrix(K, M, rhs_uK, rhs_uM)
        rhs_matrix_v = SystemMatrix(K, M, np.zeros_like(rhs_vM), rhs_vM)
        rhs_fn = lambda p, t: heat_problem.wave_rhs(p, t, f)
    else:
        matrix = SystemMatrix(K, M, Alpha, Beta)
        rhs_uK = Gamma if is_cgp else zero_col
        rhs_uM = Zeta if is_cgp else Gamma
        rhs_matrix = SystemMatrix(K, M, rhs_uK, rhs_uM)
        rhs_fn = lambda p, t: heat_problem.rhs(p, t, f)
    if rhs_fn_override is not None:
        rhs_fn = rhs_fn_override

    force = ForceAssembler(mesh, space_degree, n_q, rhs_fn, K.mask_np)

    precond = None
    if preconditioner_factory is not None:
        ctx = dict(mesh=mesh, fe_degree=fe_degree, space_degree=space_degree,
                   type_=type_, n_timesteps_at_once=n_timesteps_at_once,
                   time_step=time_step, problem=problem, n_q=n_q,
                   refinement=refinement, coefficient=coefficient)
        with scope("setup:gmg"):
            precond = preconditioner_factory(ctx)

    bv = None
    if dirichlet_g is not None:
        from ..ops.boundary import SlabBoundaryValues
        assert problem != ProblemType.wave, \
            "strong inhomogeneous Dirichlet wired for first-order problems"
        bv = SlabBoundaryValues(mesh, space_degree, dirichlet_g, type_,
                                fe_degree, time_step, n_timesteps_at_once,
                                mask=K.mask_np)
    if problem == ProblemType.wave:
        step = TimeIntegratorWave(type_, fe_degree, Alpha_1, Beta_1, Gamma_1,
                                  Zeta_1, rel_tol, matrix, precond,
                                  rhs_matrix, rhs_matrix_v, force,
                                  n_timesteps_at_once, extrapolate,
                                  maxiter=gmres_maxiter)
    else:
        step = TimeIntegratorFO(type_, fe_degree, Alpha_1, Gamma_1, rel_tol,
                                matrix, precond, rhs_matrix, force,
                                n_timesteps_at_once, extrapolate,
                                maxiter=gmres_maxiter,
                                boundary_values=bv,
                                boundary_lift=boundary_lift)

    # the reference under-integrates the error norms with QGauss(fe_degree+1)
    # (ErrorCalculator gets space_degree=fe_degree, tp_01.cc:809-815) -- we
    # replicate this for golden parity
    if exact_override is not None:
        exact_fn, exact_grad_fn = exact_override
    else:
        exact_fn = lambda p, t: heat_problem.exact_solution(p, t, f)
        exact_grad_fn = lambda p, t: heat_problem.exact_gradient(p, t, f)
    err = None
    if compute_errors:
        err = ErrorCalculator(mesh, type_, fe_degree, space_degree,
                              exact_fn, exact_grad_fn,
                              n_q=fe_degree + 1)

    coords = jnp.asarray(mesh.dof_coordinates(space_degree))
    # initial value: nodal interpolation of the exact solution at t=0
    if initial_fn is not None:
        prev_x = jnp.asarray(initial_fn(np.asarray(coords)))
    else:
        prev_x = exact_fn(coords, 0.0)
    if problem == ProblemType.wave:
        prev_v = jnp.asarray(initial_v_fn(np.asarray(coords))) \
            if initial_v_fn is not None \
            else heat_problem.wave_exact_v(coords, 0.0, f)
    else:
        prev_v = None

    # point probes -> functionals file (reference tp_01.cc:449-481,584-635:
    # RemotePointEvaluation + dense time-resampling; here a Cartesian-mesh
    # dense contraction, utils/probes.py)
    pe = writer = None
    if probe_points is not None:
        from ..utils.probes import FunctionalsWriter, PointEvaluator
        pe = PointEvaluator(mesh, space_degree, probe_points)
        # appends across cycles like the reference (tp_01.cc:620 ios::app);
        # the config driver truncates once per config run
        writer = FunctionalsWriter(functionals_path, type_, fe_degree)
        prev_probe = pe(prev_x)

    time = 0.0
    l2 = 0.0
    linf = -1.0
    h1 = 0.0
    total_iters = 0
    n_slabs = 0
    while time < end_time - 1e-12:
        with scope("step"):
            if problem == ProblemType.wave:
                x, v, stats = step.solve_wave(prev_x, prev_v, time,
                                              time_step)
                prev_v = v[-1]
            else:
                x, stats = step.solve(prev_x, time, time_step)
            import jax
            jax.block_until_ready(x)
        assert stats.converged, \
            f"FGMRES stalled at t={time}: {stats}"
        total_iters += stats.iterations
        if compute_errors:
            e = err.evaluate_error(time, time_step, x, prev_x,
                                   n_timesteps_at_once)
            l2 += float(e["l2"])
            h1 += float(e["h1_semi"])
            linf = max(linf, float(e["linf"]))
        if pe is not None:
            for it in range(n_timesteps_at_once):
                vals = np.stack([pe(x[it * nt_dofs + i])
                                 for i in range(nt_dofs)])
                writer.write_step(time + it * time_step, time_step, vals,
                                  prev_probe if is_cgp else None)
                prev_probe = vals[-1]
        prev_x = x[-1]
        time += n_timesteps_at_once * time_step
        n_slabs += 1
        if do_output:
            # reference tp_01.cc:636-644 (VTU dumps) -> structured VTK via
            # the native writer
            from ..utils.native import write_vtk
            write_vtk(f"{output_prefix}_{n_slabs:04d}.vtk",
                      np.asarray(coords), np.asarray(prev_x))

    return CycleResult(
        n_cells=mesh.n_cells, n_dofs=mesh.n_dofs(space_degree),
        n_blocks=n_blocks, n_timesteps=n_slabs,
        total_iterations=total_iters,
        avg_iterations=total_iters / n_slabs,
        l2_l2=float(np.sqrt(l2)), linf_linf=linf,
        l2_h1=float(np.sqrt(h1)))
