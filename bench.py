"""STMG slab-solve benchmark on the GPU: three sections, one process.

  heat   3D heat, Q4 space x dG(2) time, 16^3 cells, 32 timesteps per slab
         system (26.4M space-time DoFs per slab): the headline
  stokes 3D Stokes, Q2^3/DGP1 x dG(1), 8^3 cells, 8 timesteps per slab
  wave   3D acoustic wave, Q4 x dG(2) (Schur-reduced), 8^3 cells, 16 steps

Every slab is solved to TRUE relative residual <= 1e-8 by iterative
refinement: a glue-free preconditioned-Richardson f32 solve stopped at the
f32 floor, a float-float (double-single) residual of the high-precision
discretization, and a Richardson f32 correction solve; every slab is then
verified by an untimed high-precision residual.  The f32 floor and the
correction tolerance are DERIVED at setup by a probe solve of slab 0 (run
to stall, floor = measured true residual; rtol1 = 1.4 * floor,
ir_rtol = 0.5e-8 / floor), so no tolerance is hand-tuned per size.

Timing: host clock around the timed slab dispatches, ended by
block_until_ready; the verification runs outside the window.  Sections run
only on a GPU; `--rehearse` runs them on the CPU at a tiny size to check
control flow and convergence, and prints no time and no rate.  Every result
line names the platform, device kind, device count and the card's power
limit.

Usage:  python bench.py [--sections heat,stokes,wave]
        JAX_PLATFORMS=cpu python bench.py --rehearse

Env knobs (A/B only; defaults are the configuration above):
STFEM_BENCH_CELLS, _SLABS, _NTAO, _STEPS (MG smoothing steps), _INNER
(relaxation sweeps per smoother application), _SKIPID, _COARSE
(Direct|GMRES|Smoother), _BF16 (bf16 Vanka storage), _LEVEL_BF16, _EIG_PROXY,
_IR / _IR_RTOL / _IR_PASSES, _IR_FF (float-float residual engine, default 1;
0 = native-f64 stepwise residual), _IR_RICH, _OUTER
(fgmres|richardson|chebyshev), _OMEGA, _RTOL1, _REORTH; the Stokes and wave
sections read STFEM_BENCH_STOKES_* / STFEM_BENCH_WAVE_*.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from stfem_tpu.utils.runtime import peak_bytes_in_use

# keys that only mean something on the card; a rehearsal drops them
DEVICE_KEYS = ("dofs_per_s", "solve_s", "compile_s", "warm_s",
               "peak_bytes_in_use")


def run_stokes_bench(host, dev, n_slabs=None, cells=None,
                     ntao=None) -> dict:
    """3D Stokes slab-solve throughput: Q2^3 velocity x DGP1 pressure on a
    hyperRectangle (reference tf01stokes family,
    include/operators.h:1193-1766), homogeneous Dirichlet velocity, smooth
    body force, Stokes STMG V-cycle (Vanka with u-only mass mask,
    smoothing_range 5 -- the tf01stokes.json configuration), timed slab
    solves with mean-pressure normalization.  Setup runs on `host`, the
    solves on `dev`.  Returns the section's result dict.

    Env: _STOKES_CELLS (default 8), _STOKES_NTAO (default 8),
    _STOKES_SLABS (default 6), _STOKES_MAXITER; arguments override.
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    from stfem_tpu.krylov import fgmres
    from stfem_tpu.mesh.fe import shape_data_1d
    from stfem_tpu.mesh.grid import StructuredMesh
    from stfem_tpu.ops.spatial import (LaplaceMassOperator, _sumfac,
                                       cell_scatter)
    from stfem_tpu.errors import quad_coordinates
    from stfem_tpu.stmg.gmg import GMGParams, build_stmg_stokes
    from stfem_tpu.ops.stokes import StokesOperator
    from stfem_tpu.system_stokes import StokesSystemMatrix
    from stfem_tpu.time.tables import get_fe_time_weights, get_time_quad
    from stfem_tpu.types import TimeStepType

    cells = cells or int(os.environ.get("STFEM_BENCH_STOKES_CELLS", "8"))
    ntao = ntao or int(os.environ.get("STFEM_BENCH_STOKES_NTAO", "8"))
    n_slabs = n_slabs or int(os.environ.get("STFEM_BENCH_STOKES_SLABS",
                                            "6"))
    maxiter = int(os.environ.get("STFEM_BENCH_STOKES_MAXITER", "60"))
    # f32-only slab solves (STFEM_BENCH_STOKES_IR=0) stall at the
    # kappa*eps_f32 TRUE-residual floor (~1e-6 at 8^3); their convergence
    # bar is true rel <= 1e-5.  The default ff-IR path holds 1e-8.
    target = float(os.environ.get("STFEM_BENCH_STOKES_TARGET", "1e-5"))
    k = 1                      # dG(1) in time
    u_deg, p_deg, n_q = 2, 1, 3
    dim = 3
    nt = k + 1
    tau = 1.0 / 16.0
    dtype = jnp.float32
    t0 = _time.time()
    with jax.default_device(host):
        refinement = int(np.log2(cells // 2))
        mesh = StructuredMesh([2] * dim, [0.0] * dim, [1.0] * dim,
                              refinement=refinement)
        S = StokesOperator(mesh, u_deg, p_deg, n_q, 1.0, dtype=dtype)
        Mu = LaplaceMassOperator(mesh, u_deg, n_q, 1.0, 0.0, dtype=dtype,
                                 mask=S.mask_u_np)
        a, b, g, z = get_fe_time_weights(TimeStepType.DG, k, tau, ntao)
        matrix = StokesSystemMatrix(S, Mu, a, b)
        rhs_matrix = StokesSystemMatrix(S, Mu, a, b, gamma=None, zeta=g,
                                        type_=TimeStepType.DG)
        # smoother A/B knobs (VERDICT r4 #1b, 3D h-growth levers):
        # _STOKES_SMOOTHER=Chebyshev selects the Chebyshev wrapper with
        # degree = _STOKES_STEPS (deal.II semantics), _STOKES_RANGE the
        # smoothing range, _STOKES_INNER the relaxation inner sweeps,
        # _STOKES_COARSE the coarse solver type (Direct|GMRES|Smoother).
        from stfem_tpu.types import SupportedSmoothers as _SS
        st_smoother = (_SS.Chebyshev if os.environ.get(
            "STFEM_BENCH_STOKES_SMOOTHER", "Relaxation") == "Chebyshev"
            else _SS.Relaxation)
        _inner_env = os.environ.get("STFEM_BENCH_STOKES_INNER", "")
        st_params = GMGParams(
            smoother=st_smoother,
            smoothing_range=float(os.environ.get(
                "STFEM_BENCH_STOKES_RANGE", "5.0")),
            smoothing_steps=int(os.environ.get(
                "STFEM_BENCH_STOKES_STEPS", "1")),
            smoother_inner_iterations=(int(_inner_env) if _inner_env
                                       else None),
            coarse_grid_smoother_type=os.environ.get(
                "STFEM_BENCH_STOKES_COARSE", "Smoother"))
        gmg = build_stmg_stokes(mesh, k, TimeStepType.DG, ntao, tau,
                                viscosity=1.0, dtype=dtype,
                                params=st_params,
                                fe_degree_min=1)
        T = nt * ntao
        # smooth body force at the Radau points of each step (diagonal
        # Alpha rule), assembled once per slab batch on the host
        sd = shape_data_1d(u_deg, n_q)
        Sf = jnp.asarray(sd.S)
        geom = mesh.geometry(n_q, u_deg)
        jxw = jnp.asarray(geom.jxw)
        fcoords = jnp.asarray(quad_coordinates(mesh, n_q))
        tq = get_time_quad(TimeStepType.DG, k)[0]
        a1 = get_fe_time_weights(TimeStepType.DG, k, tau, 1)[0]

        def fvec(p, t):
            # smooth divergence-containing body force (solver bench: any
            # smooth field; errors are not evaluated here)
            x, y_, z_ = p[..., 0], p[..., 1], p[..., 2]
            s = jnp.sin(np.pi * x) * jnp.sin(np.pi * y_) * jnp.sin(
                np.pi * z_) * jnp.sin(t + 0.3)
            return jnp.stack([s, 2.0 * s, -s], axis=-1)

        def force_u(t):
            f = fvec(fcoords, t)
            comps = []
            for c in range(dim):
                y = _sumfac([Sf] * dim, f[..., c] * jxw, dim, forward=False)
                comps.append(cell_scatter(y, mesh.cells, u_deg))
            return jnp.stack(comps, axis=0) * S.mask_u

        def slab_force(time):
            zero_p = jnp.zeros((S.n_p,))
            parts = []
            for it in range(ntao):
                for j, q in enumerate(tq):
                    F = force_u(time + tau * it + tau * float(q))
                    parts.append(F.reshape(-1) * float(a1[j, j]))
            flat_u = jnp.stack(parts)
            return jnp.concatenate(
                [flat_u, jnp.broadcast_to(zero_p, (T, zero_p.size))],
                axis=1)

        forces = jnp.stack([slab_force(i * tau * ntao)
                            for i in range(n_slabs)])
        prev0 = jnp.zeros(S.n_u + S.n_p, dtype)
        # Stokes iterative refinement (VERDICT r4 #1a): the ff saddle
        # residual engine (ops/ff_stokes.py) lifts the convergence bar
        # from the f32 floor to TRUE rel <= 1e-8, heat-bench semantics.
        # Under x64 (the heat IR default) the force assembly above is
        # ALREADY the exact f64 quadrature (Sf/jxw/coords are f64), so
        # its ff split is the high-precision force pair.
        use_ir = (os.environ.get("STFEM_BENCH_STOKES_IR", "1") == "1"
                  and bool(jax.config.jax_enable_x64))
        ffres = None
        if use_ir:
            from stfem_tpu.ops.ff_stokes import build_ff_stokes_residual
            from stfem_tpu.ops.floatfloat import ff_from_f64
            S64 = StokesOperator(mesh, u_deg, p_deg, n_q, 1.0,
                                 dtype=jnp.float64)
            ffres = build_ff_stokes_residual(S64, a, b, zeta=g)
            fhi, flo = ff_from_f64(forces.astype(jnp.float64))
    setup_s = _time.time() - t0
    matrix, rhs_matrix, gmg, forces, prev0 = jax.device_put(
        (matrix, rhs_matrix, gmg, forces, prev0), dev)
    if use_ir:
        ffres, fhi, flo = jax.device_put((ffres, fhi, flo), dev)
    detj = float(np.prod(mesh.h))
    vol = 1.0

    # Round 4: the Stokes V-cycle is CONTRACTIVE after the
    # space-ladder/pinv-coarse fixes (commit c3e760b), so the outer is
    # glue-free preconditioned Richardson like the heat headline -- its
    # stopping residual is the true f32 residual (no Givens-estimate lag,
    # which measured ~100x pessimistic on the saddle point), the program
    # is one while_loop (compiles minutes faster than the unrolled
    # FGMRES restart chain), and each step costs matvec + V-cycle only.
    # STFEM_BENCH_STOKES_OUTER=fgmres restores the r3 restart scheme.
    outer_kind = os.environ.get("STFEM_BENCH_STOKES_OUTER", "richardson")
    restart = int(os.environ.get("STFEM_BENCH_STOKES_RESTART", "20"))
    n_cycles = -(-maxiter // restart)

    def solve_slab(matrix_, rhs_matrix_, gmg_, prev_flat, fslab):
        from stfem_tpu.krylov import richardson_solve
        prev_u = prev_flat[:S.n_u].reshape((dim,) + S.dof_shape_u)
        prev_p = prev_flat[S.n_u:].reshape(S.p_shape)
        rhs = rhs_matrix_.vmult_slice(prev_u, prev_p) + fslab
        bnorm = jnp.linalg.norm(rhs.reshape(-1))
        x = jnp.broadcast_to(prev_flat, (T, prev_flat.size))
        it_total = jnp.asarray(0, jnp.int32)
        tr = jnp.asarray(1.0, rhs.dtype)
        if outer_kind == "richardson":
            # pin f32 through the while carry (the heat main enables x64
            # for the IR machinery; mixed table dtypes would promote)
            mv = lambda v: matrix_.vmult(v).astype(jnp.float32)
            pc = lambda v: gmg_.vmult(v).astype(jnp.float32)
            res = richardson_solve(mv, rhs.astype(jnp.float32),
                                   x.astype(jnp.float32), pc,
                                   maxiter=maxiter, abstol=1e-30,
                                   reltol=0.5 * target)
            x = res.x
            it_total = res.iterations
        else:
            for _cyc in range(n_cycles):
                r = rhs - matrix_.vmult(x)
                tr = jnp.linalg.norm(r.reshape(-1)) / bnorm
                res = fgmres(matrix_.vmult, r, jnp.zeros_like(x),
                             precondition=gmg_.vmult, maxiter=restart,
                             abstol=1e-30, reltol=1e-9)
                done = tr <= target
                x = jnp.where(done, x, x + res.x)
                it_total = it_total + jnp.where(done, 0, res.iterations)
        r = rhs - matrix_.vmult(x)
        tr = jnp.linalg.norm(r.reshape(-1)) / bnorm
        # mean-pressure normalization (DGP constant mode carries the mean)
        u_time, p_time = S.unpack(x)
        means = jnp.sum(p_time[..., 0],
                        axis=tuple(range(1, dim + 1))) * detj / vol
        p_time = p_time.at[..., 0].add(-means.reshape((T,) + (1,) * dim))
        # pin the carry dtype (under the heat bench's jax_enable_x64 the
        # mean-shift arithmetic weak-promotes to f64)
        xs = S.pack(u_time[-1], p_time[-1]).astype(prev_flat.dtype)
        return xs, it_total, tr, tr <= target

    jit_slab = jax.jit(solve_slab)

    def mean_normalize(x):
        """Remove the per-time-block mean pressure (DGP constant mode)."""
        u_time, p_time = S.unpack(x)
        means = jnp.sum(p_time[..., 0],
                        axis=tuple(range(1, dim + 1))) * detj / vol
        p_time = p_time.at[..., 0].add(-means.reshape((T,) + (1,) * dim))
        return S.pack(u_time, p_time)

    if use_ir:
        # ---- heat-bench IR composition on the saddle system ----
        # ONE stage executable with a lax.cond prolog (rhs assembly | ff
        # residual) feeding the shared Richardson chain; probe slab 0
        # measures the f32 floor and derives the tolerances; every slab
        # is verified by an untimed ff residual; `converged` requires
        # TRUE rel <= 1e-8 (reference accuracy, time_integrators.h:56-59).
        from stfem_tpu.krylov import richardson_solve as _rich
        from stfem_tpu.ops.floatfloat import ff_add_f32 as _ff_add_f32
        n_flat = S.n_u + S.n_p

        @jax.jit
        def jit_stage_st(matrix_, rhs_matrix_, gmg_, ffres_, prev_ff,
                         x_base32, fh, fl, reltol, is_corr):
            one = jnp.asarray(1.0, jnp.float32)

            def prolog_first(_):
                pu = prev_ff[0][:S.n_u].reshape((dim,) + S.dof_shape_u)
                pp = prev_ff[0][S.n_u:].reshape(S.p_shape)
                rhs = (rhs_matrix_.vmult_slice(pu, pp).astype(jnp.float32)
                       + fh)
                x0 = jnp.broadcast_to(prev_ff[0], (T, n_flat))
                return rhs, x0, one, one

            def prolog_corr(_):
                x_ff = (x_base32, jnp.zeros_like(x_base32))
                (r_hi, _rl), rnorm, bn = ffres_.residual(prev_ff, x_ff,
                                                         (fh, fl))
                return (r_hi / rnorm, jnp.zeros((T, n_flat), jnp.float32),
                        rnorm, bn)

            rhs, x0, rnorm, bn = jax.lax.cond(is_corr, prolog_corr,
                                              prolog_first, None)
            mv = lambda v: matrix_.vmult(v).astype(jnp.float32)
            pc = lambda v: gmg_.vmult(v).astype(jnp.float32)
            res = _rich(mv, rhs, x0, pc, maxiter=maxiter, abstol=1e-30,
                        reltol=reltol)
            x_ff = _ff_add_f32((x_base32, jnp.zeros_like(x_base32)),
                               rnorm * res.x)
            return x_ff, res.iterations, res.residual, rnorm, bn

        @jax.jit
        def jit_verify_st(ffres_, prev_ff, x_ff, fh, fl):
            _r, rn, bn = ffres_.residual(prev_ff, x_ff, (fh, fl))
            return rn, bn

        @jax.jit
        def jit_carry_st(x_ff):
            # next-slab previous value: LAST time block, mean-normalized
            # pressure (the hi/lo shift by a constant stays exact enough:
            # only u_prev enters the DG rhs coupling; p_prev is inert)
            xn = mean_normalize(x_ff[0])
            return (xn[-1], x_ff[1][-1])

        def slab_ir(prev_ff, i, rtol1_, ir_rtol_):
            zero = jnp.zeros((T, n_flat), jnp.float32)
            xf1, it, rs, _, _ = jit_stage_st(
                matrix, rhs_matrix, gmg, ffres, prev_ff, zero,
                fhi[i], flo[i], rtol1_, False)
            x_ff, extra, _, rnorm, bn = jit_stage_st(
                matrix, rhs_matrix, gmg, ffres, prev_ff, xf1[0],
                fhi[i], flo[i], ir_rtol_, True)
            return x_ff, it + extra, rnorm, bn

        # probe slabs 0 AND 1: floor + derived tolerances (+ all
        # compiles).  Slab 0's rhs is force-only (prev = 0); slabs with a
        # nonzero previous value have a DIFFERENT f32-estimate floor
        # (measured 6.8e-7 vs 1.5e-6 at 8^3), so a slab-0-only floor
        # makes rtol1 unreachable on every later slab and the first
        # solves burn maxiter.  The probe marches one carry step and
        # takes the max.
        t0 = _time.time()
        p0 = (prev0, jnp.zeros_like(prev0))
        _x, _it, rnp_, bnp_ = slab_ir(p0, 0, np.float32(1e-8),
                                      np.float32(2.0))
        floor = float(rnp_) / float(bnp_)
        if np.isfinite(floor) and floor <= 1e-3 and n_slabs > 1:
            p1 = jit_carry_st(_x)
            _x1, _it1, rnp1, bnp1 = slab_ir(p1, 1, np.float32(1e-8),
                                            np.float32(2.0))
            floor1 = float(rnp1) / float(bnp1)
            if np.isfinite(floor1):
                floor = max(floor, floor1)
        compile_s = _time.time() - t0
        if not np.isfinite(floor) or floor > 1e-3:
            print(f"# stokes IR probe floor {floor:.3e} (non-contractive "
                  f"V-cycle?) -- falling back to the f32-only path",
                  flush=True)
            use_ir = False
        else:
            rtol1 = np.float32(max(1.4 * floor, 1e-8))
            ir_rtol = np.float32(min(max(0.5e-8 / max(floor, 1e-12),
                                         1e-7), 2e-3))
            print(f"# stokes probe: floor {floor:.3e} -> rtol1 "
                  f"{float(rtol1):.3e}, ir_rtol {float(ir_rtol):.3e} "
                  f"(compile+probe {compile_s:.1f}s)", flush=True)

    if use_ir:
        def march_ir():
            prev = (prev0, jnp.zeros_like(prev0))
            its, rels, times = [], [], []
            for i in range(n_slabs):
                t0 = _time.time()
                x_ff, it, rnorm, bn = slab_ir(prev, i, rtol1, ir_rtol)
                jax.block_until_ready(x_ff)
                times.append(_time.time() - t0)
                rn2, bn2 = jit_verify_st(ffres, prev, x_ff, fhi[i],
                                         flo[i])
                rels.append(float(rn2) / float(bn2))
                its.append(int(it))
                prev = jit_carry_st(x_ff)
            return np.array(times), np.array(rels), np.array(its)

        t0 = _time.time()
        times, rels, its = march_ir()
        warm_s = _time.time() - t0
        times, rels, its = march_ir()
        elapsed = float(times.sum())
        st_dofs = (S.n_u + S.n_p) * T * n_slabs
        return dict(section="stokes", cells=mesh.n_cells,
                    u_dofs=int(S.n_u), p_dofs=int(S.n_p), n_blocks=int(T),
                    slabs=n_slabs, avg_iters=float(its.mean()),
                    slab_true_rel=[float(r) for r in rels],
                    true_rel_residual=float(rels.max()),
                    target=1e-8, converged=bool(np.all(rels <= 1e-8)),
                    setup_s=setup_s, compile_s=compile_s, warm_s=warm_s,
                    solve_s=elapsed, dofs_per_s=st_dofs / elapsed,
                    peak_bytes_in_use=peak_bytes_in_use(dev),
                    probe_floor=floor)

    def march(prev_flat):
        outs = []
        prev = prev_flat
        for i in range(n_slabs):
            prev, it, tr, cv = jit_slab(matrix, rhs_matrix, gmg, prev,
                                        forces[i])
            outs.append((it, tr, cv))
        return prev, outs

    t0 = _time.time()
    last, outs = march(prev0)
    jax.block_until_ready(last)
    compile_s = _time.time() - t0
    t0 = _time.time()
    last, outs = march(prev0)
    jax.block_until_ready(last)
    elapsed = _time.time() - t0
    its = np.asarray([int(o[0]) for o in outs])
    trs = np.asarray([float(o[1]) for o in outs])
    cvs = np.asarray([bool(o[2]) for o in outs])
    st_dofs = (S.n_u + S.n_p) * T * n_slabs
    return dict(section="stokes", cells=mesh.n_cells,
                u_dofs=int(S.n_u), p_dofs=int(S.n_p), n_blocks=int(T),
                slabs=n_slabs, avg_iters=float(its.mean()),
                slab_true_rel=[float(r) for r in trs],
                true_rel_residual=float(trs.max()), target=target,
                converged=bool(np.all(cvs)), setup_s=setup_s,
                compile_s=compile_s, solve_s=elapsed,
                dofs_per_s=st_dofs / elapsed,
                peak_bytes_in_use=peak_bytes_in_use(dev))


def run_wave_bench(host, dev, n_slabs=None, cells=None, ntao=None) -> dict:
    """3D acoustic-wave slab-solve throughput: Q4 space x dG(2) time on the
    Schur-reduced second-order formulation
    (include/time_integrators.h:400-447, fe_time.h:444-474), glue-free
    Richardson + float-float iterative refinement to TRUE rel <= 1e-8,
    with the dense velocity-recovery epilogue INSIDE the timed window
    (the recovered v feeds the next slab's rhs, so it is part of the
    march, not post-processing).  Returns the section's result dict.

    Env: _WAVE_CELLS (8), _WAVE_NTAO (16), _WAVE_SLABS (6); arguments
    override.
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    from stfem_tpu.integrators import ForceAssembler
    from stfem_tpu.krylov import richardson_solve
    from stfem_tpu.mesh.grid import StructuredMesh
    from stfem_tpu.ops.floatfloat import (FFSlabResidual, ff_add_f32,
                                          ff_from_f64)
    from stfem_tpu.ops.spatial import LaplaceMassOperator
    from stfem_tpu.problems import heat as heat_problem
    from stfem_tpu.stmg.gmg import GMGParams, build_stmg
    from stfem_tpu.system import SystemMatrix
    from stfem_tpu.time.tables import (get_fe_time_weights,
                                       get_fe_time_weights_wave,
                                       get_time_quad)
    from stfem_tpu.types import ProblemType, SupportedSmoothers, \
        TimeStepType

    # default 8^3: the wave hierarchy cannot use the heat bench's proxy
    # eigenvalue estimates (the Schur-reduced tables make lambda_max(PA)
    # h/domain-DEPENDENT), so estimates run on the full levels -- as
    # deal.II 20-step POWER iterations (the converged host-side Arnoldi
    # dominated setup).  Iteration counts: 27.75 avg at 8^3 and 54.75 at
    # 16^3 (h-growth ~2x), both TRUE <= 1e-8.
    cells = cells or int(os.environ.get("STFEM_BENCH_WAVE_CELLS", "8"))
    # ntao=16: the wave composition is tau-robust to 16 steps at once but
    # STALLS at 32 in 3D (probe floor 0.17; inner=3 / range=4 measured
    # no-fix/diverge at 16^3 -- the 2D lab's rho gains do not transfer;
    # heat is tau-robust through 32/64).  The reference's own wave
    # evidence is ntao=1 only (tf07/tf08.json).
    ntao = ntao or int(os.environ.get("STFEM_BENCH_WAVE_NTAO", "16"))
    n_slabs = n_slabs or int(os.environ.get("STFEM_BENCH_WAVE_SLABS", "6"))
    maxiter = int(os.environ.get("STFEM_BENCH_WAVE_MAXITER", "40"))
    fe_degree, space_degree = 2, 4
    nt = fe_degree + 1
    tau = 1.0 / 16.0
    freq = 1.0
    dim = 3
    dtype = jnp.float32
    t0 = _time.time()
    with jax.default_device(host):
        refinement = int(np.log2(cells // 2))
        mesh = StructuredMesh([2] * dim, [0.0] * dim, [1.0] * dim,
                              refinement=refinement)
        K = LaplaceMassOperator(mesh, space_degree, space_degree + 1,
                                0.0, 1.0, dtype=dtype)
        M = LaplaceMassOperator(mesh, space_degree, space_degree + 1,
                                1.0, 0.0, dtype=dtype)
        A1, B1, G1, Z1 = get_fe_time_weights(TimeStepType.DG, fe_degree,
                                             tau, 1)
        A_lhs, B_lhs, rhs_uK, rhs_uM, rhs_vM = get_fe_time_weights_wave(
            TimeStepType.DG, A1, B1, G1, Z1, ntao)
        matrix = SystemMatrix(K, M, A_lhs, B_lhs)
        r_u = SystemMatrix(K, M, rhs_uK, rhs_uM)
        r_v = SystemMatrix(K, M, np.zeros_like(rhs_vM), rhs_vM)
        wave_bf16 = os.environ.get("STFEM_BENCH_WAVE_BF16", "1") == "1"
        gmg = build_stmg(mesh, fe_degree, space_degree, TimeStepType.DG,
                         ntao, tau, problem=ProblemType.wave, dtype=dtype,
                         fe_degree_min=1,
                         params=GMGParams(
                             smoother=SupportedSmoothers.Relaxation,
                             smoothing_range=float(os.environ.get(
                                 "STFEM_BENCH_WAVE_RANGE", "1.0")),
                             coarse_grid_smoother_type="Direct",
                             smoother_inner_iterations=int(os.environ.get(
                                 "STFEM_BENCH_WAVE_INNER", "2")),
                             skip_identity_levels=True,
                             vanka_bf16=wave_bf16, level_bf16=wave_bf16,
                             # wave cannot use the spatial eig PROXY
                             # (lambda_max(PA) is domain/h-dependent under
                             # the Schur-reduced tables); deal.II 20-step
                             # power (+1.2 safety), accelerator-backed for
                             # big levels, replaces the converged host-side
                             # Arnoldi on the full levels
                             # (STFEM_BENCH_WAVE_EIG_EXACT=1 restores it)
                             eig_exact=os.environ.get(
                                 "STFEM_BENCH_WAVE_EIG_EXACT", "0") == "1",
                             eig_proxy_cells=int(os.environ.get(
                                 "STFEM_BENCH_WAVE_EIG_PROXY", "0"))),
                         eig_device=dev)
        n_blocks = A_lhs.shape[0]
        shape = (n_blocks,) + mesh.dof_shape(space_degree)
        # dense v-recovery tables (TimeIntegratorWave semantics)
        Ainv = np.linalg.inv(np.asarray(A1, np.float64))
        AixB64 = Ainv @ np.asarray(B1, np.float64)
        AixG64 = -(Ainv @ np.asarray(G1, np.float64))  # DG sign
        AixB = jnp.asarray(AixB64, dtype)
        AixG = jnp.asarray(AixG64, dtype)
        from stfem_tpu.ops.floatfloat import ff_from_f64 as _fff
        AixB_ff = _fff(AixB64[-1])          # last-row recovery in ff
        AixG_ff = _fff(np.asarray(AixG64[-1, 0]))
        # ff residual engine on the wave tables (full-step coupling)
        K64 = LaplaceMassOperator(mesh, space_degree, space_degree + 1,
                                  0.0, 1.0, dtype=jnp.float64)
        M64 = LaplaceMassOperator(mesh, space_degree, space_degree + 1,
                                  1.0, 0.0, dtype=jnp.float64)
        ffres = FFSlabResidual(K64, M64, A_lhs, B_lhs, rhs_uM,
                               Gamma_K=rhs_uK, Gamma_v=rhs_vM)
        # force slabs at the Radau points, assembled in f64 -> ff pairs
        force64 = ForceAssembler(mesh, space_degree, space_degree + 1,
                                 lambda p, t: heat_problem.wave_rhs(
                                     p, t, freq),
                                 K.mask_np, dtype=jnp.float64)
        tq = get_time_quad(TimeStepType.DG, fe_degree)[0]
        t_offsets = np.asarray([tau * it + tau * float(q)
                                for it in range(ntao) for q in tq])
        f_scales = np.asarray([float(A1[j, j]) for _ in range(ntao)
                               for j in range(nt)])
        fhis, flos = [], []
        for i in range(n_slabs):
            f64 = force64.batched(i * tau * ntao
                                  + jnp.asarray(t_offsets),
                                  jnp.asarray(f_scales))
            fh, fl = ff_from_f64(f64)
            fhis.append(fh)
            flos.append(fl)
        fhi = jnp.stack(fhis)
        flo = jnp.stack(flos)
        coords = jnp.asarray(mesh.dof_coordinates(space_degree),
                             jnp.float64)
        u0 = heat_problem.wave_exact_u(coords, 0.0, freq) \
            if hasattr(heat_problem, "wave_exact_u") \
            else heat_problem.exact_solution(coords, 0.0, freq)
        v0 = heat_problem.wave_exact_v(coords, 0.0, freq)
        prev_u = ff_from_f64(u0.astype(jnp.float64))
        prev_v = ff_from_f64(v0.astype(jnp.float64))
    setup_s = _time.time() - t0
    (matrix, r_u, r_v, gmg, ffres, fhi, flo, prev_u, prev_v, AixB, AixG,
     AixB_ff, AixG_ff) = jax.device_put(
        (matrix, r_u, r_v, gmg, ffres, fhi, flo, prev_u, prev_v, AixB,
         AixG, AixB_ff, AixG_ff), dev)

    @jax.jit
    def jit_stage(matrix_, ru_, rv_, gmg_, ffres_, prev_u_, prev_v_,
                  x_base32, fh, fl, reltol, is_corr):
        def prolog_first(_):
            rhs = (ru_.vmult(prev_u_[0][None])
                   + rv_.vmult(prev_v_[0][None]) + fh)
            one = jnp.asarray(1.0, jnp.float32)
            return rhs, jnp.broadcast_to(prev_u_[0], shape), one, one

        def prolog_corr(_):
            x_ff = (x_base32, jnp.zeros_like(x_base32))
            (r_hi, _rl), rnorm, bn = ffres_.residual(
                prev_u_, x_ff, (fh, fl), prev_v_ff=prev_v_)
            return r_hi / rnorm, jnp.zeros(shape, jnp.float32), rnorm, bn

        rhs, x0, rnorm, bn = jax.lax.cond(is_corr, prolog_corr,
                                          prolog_first, None)
        res = richardson_solve(matrix_.vmult, rhs, x0, gmg_.vmult,
                               maxiter=maxiter, abstol=1e-30,
                               reltol=reltol)
        x_ff = ff_add_f32((x_base32, jnp.zeros_like(x_base32)),
                          rnorm * res.x)
        # dense v-recovery epilogue (all timesteps, f32 -- the reference
        # recovers v every slab, time_integrators.h:400-447), plus the
        # LAST v in ff (it feeds the next slab's rhs through the ff
        # residual engine, so it must carry the pair's full precision)
        from stfem_tpu.ops.floatfloat import ff_add, ff_mul
        u = x_ff[0].reshape((ntao, nt) + shape[1:])
        pu = jnp.concatenate([jnp.broadcast_to(
            prev_u_[0], (1, 1) + shape[1:]), u[:-1, -1:]], axis=0)
        v = (jnp.einsum("ij,sj...->si...", AixB, u)
             + AixG[:, :1].reshape((1, nt) + (1,) * dim) * pu)
        # a reduced checksum of the dense recovery is RETURNED so XLA
        # cannot dead-code-eliminate it (ADVICE r4: `del v` made the
        # all-timesteps recovery vanish from the compiled program while
        # the metric unit claimed it ran); the callers ignore the value
        # but every jit output is materialized
        v_chk = jnp.sum(v)
        vl = None
        for j in range(nt):
            blk = n_blocks - nt + j
            term = ff_mul((AixB_ff[0][j], AixB_ff[1][j]),
                          (x_ff[0][blk], x_ff[1][blk]))
            vl = term if vl is None else ff_add(vl, term)
        pu_last = ((x_ff[0][n_blocks - nt - 1], x_ff[1][n_blocks - nt - 1])
                   if ntao > 1 else prev_u_)
        vl = ff_add(vl, ff_mul((AixG_ff[0], AixG_ff[1]), pu_last))
        return (x_ff, res.iterations, res.residual, res.converged, rnorm,
                bn, vl, v_chk)

    @jax.jit
    def jit_verify(ffres_, prev_u_, prev_v_, x_ff, fh, fl):
        _r, rn, bn = ffres_.residual(prev_u_, x_ff, (fh, fl),
                                     prev_v_ff=prev_v_)
        return rn, bn

    def slab(prev_u_, prev_v_, i, rtol1_, ir_rtol_, n_corr=1):
        zero = jnp.zeros(shape, jnp.float32)
        xf1, it, rs, cv, _, _, _, _ = jit_stage(
            matrix, r_u, r_v, gmg, ffres, prev_u_, prev_v_, zero,
            fhi[i], flo[i], rtol1_, False)
        x_ff = xf1
        rnorm = bn = v_last = None
        for _c in range(n_corr):
            x_ff, extra, _, _, rnorm, bn, v_last, _vchk = jit_stage(
                matrix, r_u, r_v, gmg, ffres, prev_u_, prev_v_, x_ff[0],
                fhi[i], flo[i], ir_rtol_, True)
            it = it + extra
        return x_ff, it, rs, cv, rnorm, bn, v_last

    # probe slab 0: floor + derived tolerances (heat-bench semantics)
    t0 = _time.time()
    _x, _it, _rs, _cv, rnp_, bnp_, _vl = slab(prev_u, prev_v, 0,
                                              np.float32(1e-8),
                                              np.float32(2.0))
    floor = float(rnp_) / float(bnp_)
    if not np.isfinite(floor):
        raise FloatingPointError(
            "wave bench: non-finite probe floor (V-cycle diverged; "
            "STFEM_BENCH_WAVE_BF16=0 for the f32 hierarchy)")
    rtol1 = np.float32(max(1.4 * floor, 1e-8))
    ir_rtol = np.float32(min(max(0.5e-8 / max(floor, 1e-12), 1e-7), 2e-3))
    compile_s = _time.time() - t0
    print(f"# wave probe: floor {floor:.3e} -> rtol1 {float(rtol1):.3e}, "
          f"ir_rtol {float(ir_rtol):.3e} (compile+probe {compile_s:.1f}s)",
          flush=True)
    # one-slab v-recovery oracle (ADVICE r4): the bench's converged check
    # verifies u against a rhs BUILT FROM the recovered v, so a wrong
    # recovery table would propagate silently; cross-check the probe
    # slab's recovered last-step v against the dense f64 recovery
    # Ainv@B u + Ainv@G u_prev (host numpy, untimed)
    u64o = (np.asarray(jax.device_get(_x[0]), np.float64)
            + np.asarray(jax.device_get(_x[1]), np.float64)
            ).reshape((ntao, nt) + shape[1:])
    prev_u64o = (np.asarray(jax.device_get(prev_u[0]), np.float64)
                 + np.asarray(jax.device_get(prev_u[1]), np.float64))
    pu_last64 = u64o[-2, -1] if ntao > 1 else prev_u64o
    v_oracle = (np.einsum("j,j...->...", AixB64[-1], u64o[-1])
                + AixG64[-1, 0] * pu_last64)
    vff = (np.asarray(jax.device_get(_vl[0]), np.float64)
           + np.asarray(jax.device_get(_vl[1]), np.float64))
    v_rel = (np.linalg.norm((vff - v_oracle).reshape(-1))
             / max(np.linalg.norm(v_oracle.reshape(-1)), 1e-300))
    print(f"# wave v-recovery vs dense f64 oracle: rel {v_rel:.2e}",
          flush=True)
    assert v_rel < 1e-9, \
        f"wave ff v-recovery deviates from the f64 oracle: {v_rel:.3e}"

    # a single correction pass must bridge floor -> 1e-8; when the first
    # solve stalls high (floor > 1e-3, e.g. marginal smoother configs at
    # 16^3) the required ratio exceeds what one pass reliably delivers --
    # run two (the second pass re-measures the ff residual, so it also
    # recovers the lo bits the stage API drops between passes)
    n_corr = 2 if floor > 1e-3 else 1

    def march(pu, pv):
        its, rels, times = [], [], []
        for i in range(n_slabs):
            t0 = _time.time()
            x_ff, it, rs, cv, rnorm, bn, v_last = slab(pu, pv, i, rtol1,
                                                       ir_rtol, n_corr)
            jax.block_until_ready((x_ff, v_last))
            times.append(_time.time() - t0)
            rn2, bn2 = jit_verify(ffres, pu, pv, x_ff, fhi[i], flo[i])
            rels.append(float(rn2) / float(bn2))
            its.append(int(it))
            pu = (x_ff[0][-1], x_ff[1][-1])
            pv = v_last                      # ff pair from the stage
        return np.array(times), np.array(rels), np.array(its)

    t_all = _time.time()
    times, rels, its = march(prev_u, prev_v)
    warm_s = _time.time() - t_all
    times, rels, its = march(prev_u, prev_v)
    elapsed = float(times.sum())
    st_dofs = int(np.prod(shape)) * n_slabs
    # the TRUE-residual contract for the pair: u satisfies the Schur slab
    # system to <= 1e-8; v is the exact linear image of u (recovery)
    return dict(section="wave", cells=mesh.n_cells,
                space_dofs=int(mesh.n_dofs(space_degree)),
                n_blocks=int(n_blocks), slabs=n_slabs,
                avg_iters=float(its.mean()),
                slab_true_rel=[float(r) for r in rels],
                true_rel_residual=float(rels.max()), target=1e-8,
                converged=bool(np.all(rels <= 1e-8)),
                v_recovery_rel=float(v_rel),
                setup_s=setup_s, compile_s=compile_s, warm_s=warm_s,
                solve_s=elapsed, dofs_per_s=st_dofs / elapsed,
                peak_bytes_in_use=peak_bytes_in_use(dev),
                probe_floor=floor)


def run_heat_bench(host, dev, n_slabs=None, cells=None, ntao=None) -> dict:
    """The headline section: 3D heat, Q4 x dG(2), 16^3 cells, 32 timesteps
    per slab.  Setup runs on `host`, the slab solves on `dev`.  Returns the
    section's result dict (per-slab TRUE residuals included)."""
    import jax
    import jax.numpy as jnp

    from stfem_tpu.integrators import ForceAssembler
    from stfem_tpu.krylov import (chebyshev_solve,
                                  estimate_error_propagator_radius, fgmres,
                                  richardson_solve)
    from stfem_tpu.mesh.grid import StructuredMesh
    from stfem_tpu.ops.spatial import LaplaceMassOperator
    from stfem_tpu.problems import heat as heat_problem
    from stfem_tpu.stmg.gmg import GMGParams, build_stmg
    from stfem_tpu.system import SystemMatrix
    from stfem_tpu.time.tables import get_fe_time_weights
    from stfem_tpu.types import TimeStepType

    # true-1e-8 mode (default ON): after the f32 solve, run
    # STFEM_BENCH_IR_PASSES iterative-refinement passes -- high-precision
    # residual of the f64 discretization, f32 re-solve of the scaled
    # correction (reference semantics: f64 outer + f32 preconditioner,
    # time_integrators.h:56-59 + stmg.h:1331-1344).  STFEM_BENCH_IR=0
    # restores the plain f32 path.
    use_ir = os.environ.get("STFEM_BENCH_IR", "1") == "1"
    ir_passes = int(os.environ.get("STFEM_BENCH_IR_PASSES", "1"))
    # float-float IR engine (default): the residual/update/verify chain runs
    # in double-single arithmetic (two f32s, ~2^-48; ops/floatfloat.py), no
    # f64 arrays on the device at all.  STFEM_BENCH_IR_FF=0 selects the
    # native-f64 stepwise residual for A/B.
    ir_ff = os.environ.get("STFEM_BENCH_IR_FF", "1") == "1"
    if use_ir:
        jax.config.update("jax_enable_x64", True)
    cells_per_axis = cells or int(os.environ.get("STFEM_BENCH_CELLS", "16"))
    n_slabs = n_slabs or int(os.environ.get("STFEM_BENCH_SLABS", "10"))
    smoothing_steps = int(os.environ.get("STFEM_BENCH_STEPS", "1"))
    fe_degree = 2              # dG(2) in time
    space_degree = 4           # Q4 in space
    # temporal blocking: solve STFEM_BENCH_NTAO timesteps as ONE slab system
    # (the method's own scaling axis; batches the time blocks through every
    # spatial sweep, amortizing the sequential V-cycle launch chain)
    n_at_once = ntao or int(os.environ.get("STFEM_BENCH_NTAO", "32"))
    vanka_bf16 = os.environ.get("STFEM_BENCH_BF16", "1") == "1"
    dtype = jnp.float32

    refinement = int(np.log2(cells_per_axis // 2))
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3,
                          refinement=refinement)
    assert mesh.cells[0] == cells_per_axis
    tau = 1.0 / 16.0

    # Setup (element matrices, band assembly, patch inverses, eigenvalue
    # estimation) is many small eager operations; dispatched one primitive
    # at a time they run faster on the host than as device launches, so
    # setup is pinned to `host` and the module arrays move to `dev` before
    # the first jitted solve.  Moving setup onto the card as jitted
    # programs is ROADMAP Speed 3.
    t0 = time.time()
    with jax.default_device(host):
        K = LaplaceMassOperator(mesh, space_degree, space_degree + 1, 0.0,
                                1.0, dtype=dtype)
        M = LaplaceMassOperator(mesh, space_degree, space_degree + 1, 1.0,
                                0.0, dtype=dtype)
        Alpha, Beta, Gamma, Zeta = get_fe_time_weights(
            TimeStepType.DG, fe_degree, tau, n_at_once)
        matrix = SystemMatrix(K, M, Alpha, Beta)
        rhs_matrix = SystemMatrix(K, M, np.zeros_like(Gamma), Gamma)
        print(f"# setup/ops {time.time() - t0:.1f}s", flush=True)
        # tuned solver knobs (A/B matrix in STATUS.md): V(1,1) with 2-sweep
        # relaxation, Identity levels skipped, direct dense coarse solve
        from stfem_tpu.types import SupportedSmoothers
        smoother_type = (SupportedSmoothers.Chebyshev
                         if os.environ.get("STFEM_BENCH_SMOOTHER",
                                           "Relaxation") == "Chebyshev"
                         else SupportedSmoothers.Relaxation)
        smoothing_range = float(os.environ.get("STFEM_BENCH_RANGE", "1.0"))
        coarse_type = os.environ.get("STFEM_BENCH_COARSE", "Direct")
        inner_env = os.environ.get("STFEM_BENCH_INNER", "")
        inner = int(inner_env) if inner_env else 2
        skip_id = os.environ.get("STFEM_BENCH_SKIPID", "1") == "1"
        gmg = build_stmg(mesh, fe_degree, space_degree, TimeStepType.DG,
                         n_at_once, tau, dtype=dtype, fe_degree_min=1,
                         params=GMGParams(smoothing_steps=smoothing_steps,
                                          variable=os.environ.get(
                                              "STFEM_BENCH_VARIABLE",
                                              "0") == "1",
                                          variable_steps_cap=int(
                                              os.environ.get(
                                                  "STFEM_BENCH_VCAP", "0")),
                                          smoother=smoother_type,
                                          smoothing_range=smoothing_range,
                                          coarse_grid_smoother_type=coarse_type,
                                          vanka_bf16=vanka_bf16,
                                          smoother_inner_iterations=inner,
                                          post_smoother_inner_iterations=(
                                              int(os.environ[
                                                  "STFEM_BENCH_POST_INNER"])
                                              if "STFEM_BENCH_POST_INNER"
                                              in os.environ else None),
                                          skip_identity_levels=skip_id,
                                          no_post_smooth=os.environ.get(
                                              "STFEM_BENCH_NOPOST",
                                              "0") == "1",
                                          no_post_smooth_finest=os.environ.get(
                                              "STFEM_BENCH_NOPOST_FINE",
                                              "0") == "1",
                                          level_bf16=os.environ.get(
                                              "STFEM_BENCH_LEVEL_BF16",
                                              "1") == "1",
                                          eig_proxy_cells=int(os.environ.get(
                                              "STFEM_BENCH_EIG_PROXY", "4")),
                                          smooth_all_levels=os.environ.get(
                                              "STFEM_BENCH_SMOOTHALL",
                                              "0") == "1"),
                         # big-level power iterations run on the card
                         # (one dispatch each) -- on the host they
                         # dominate the 16^3 setup time
                         eig_device=dev)
        print(f"# setup/hierarchy {time.time() - t0:.1f}s", flush=True)
        force = ForceAssembler(mesh, space_degree, space_degree + 1,
                               lambda p, t: heat_problem.rhs(p, t, 1.0),
                               K.mask_np, dtype=dtype)
        matrix64 = rhs_matrix64 = force64 = ffres = None
        if use_ir and ir_ff:
            from stfem_tpu.ops.floatfloat import FFSlabResidual
            K64 = LaplaceMassOperator(mesh, space_degree, space_degree + 1,
                                      0.0, 1.0, dtype=jnp.float64)
            M64 = LaplaceMassOperator(mesh, space_degree, space_degree + 1,
                                      1.0, 0.0, dtype=jnp.float64)
            ffres = FFSlabResidual(K64, M64, Alpha, Beta, Gamma)
            force64 = ForceAssembler(mesh, space_degree, space_degree + 1,
                                     lambda p, t: heat_problem.rhs(p, t, 1.0),
                                     K.mask_np, dtype=jnp.float64)
        elif use_ir:
            # f64 discretization for the refinement residuals (reference
            # outer-solver precision, time_integrators.h:56-59).  The f64
            # FORCE slabs are precomputed at setup (the reference assembles
            # its rhs on the CPU too); only the previous-slab coupling + one
            # f64 system matvec per IR pass remain in the timed loop.
            K64 = LaplaceMassOperator(mesh, space_degree, space_degree + 1,
                                      0.0, 1.0, dtype=jnp.float64)
            M64 = LaplaceMassOperator(mesh, space_degree, space_degree + 1,
                                      1.0, 0.0, dtype=jnp.float64)
            # f64 residual form: STEPWISE scan by default (the 32-step scan
            # keeps the f64 working set at 3 blocks); the whole-slab apply
            # is STFEM_BENCH_IR_STEPWISE=0.
            ir_stepwise = os.environ.get("STFEM_BENCH_IR_STEPWISE",
                                         "1") == "1"
            if ir_stepwise:
                struct64 = SystemMatrix._detect_step_structure(
                    np.asarray(Alpha), np.asarray(Beta))
                assert struct64 is not None, "IR needs the step structure"
                nt64, A0_, A1_, B0_, B1_ = struct64
                # fuse the rank-1 step coupling into the step pair via a
                # RECTANGULAR (nt x nt+1) table reading [prev_last, step
                # blocks] -- one Kronecker pair on nt+1 blocks instead of
                # two pairs (nt + 1).
                assert not (np.any(A1_[:, :-1]) or np.any(B1_[:, :-1])), \
                    "step coupling must read only the previous last dof"
                A04 = np.concatenate([A1_[:, -1:], A0_], axis=1)
                B04 = np.concatenate([B1_[:, -1:], B0_], axis=1)
                matrix64 = SystemMatrix(K64, M64, A04, B04)
            else:
                matrix64 = SystemMatrix(K64, M64, Alpha, Beta)
            rhs_matrix64 = SystemMatrix(K64, M64, np.zeros_like(Gamma),
                                        Gamma)
            force64 = ForceAssembler(mesh, space_degree, space_degree + 1,
                                     lambda p, t: heat_problem.rhs(p, t, 1.0),
                                     K.mask_np, dtype=jnp.float64)
    setup_time = time.time() - t0
    print(f"# setup {setup_time:.1f}s", flush=True)
    n_blocks = Alpha.shape[0]
    shape = (n_blocks,) + mesh.dof_shape(space_degree)

    from stfem_tpu.time.tables import get_time_quad
    tq = get_time_quad(TimeStepType.DG, fe_degree)[0]

    nt = len(tq)

    # force at the Radau points of each blocked step (diagonal-Alpha rule;
    # the multi-step Alpha is block-diagonal with repeated blocks), batched:
    # ONE integrate+scatter sweep for the whole slab
    t_offsets = np.array([tau * (row // nt) + tau * float(tq[row % nt])
                          for row in range(n_blocks)], np.float32)
    f_scales = np.array([Alpha[row, row] for row in range(n_blocks)],
                        np.float32)

    # default FGMRES basis scales with the problem: 18 suffices at 8^3
    # (8-10.5 avg iters); 16^3 runs 9 avg iters since the ladder-ordering
    # fix, so 24 is 2.5x headroom -- basis length is device memory AND
    # Gram-Schmidt traffic (V+Z at 16^3: 40 slots = 8 GB, 24 = 4.9 GB)
    default_maxiter = 18 if cells_per_axis <= 8 else 24
    bench_maxiter = int(os.environ.get("STFEM_BENCH_MAXITER",
                                       str(default_maxiter)))
    # "1" = CGS2 (two passes), "selective" = DGKS-criterion second pass,
    # "0" = CGS1.  Measured: "selective" is identical to CGS2 here -- the
    # preconditioned Arnoldi vectors lose most of their mass to the
    # projection every iteration (that IS fast convergence), so the DGKS
    # criterion always fires; keep plain CGS2 as the default
    # under IR the untimed true-residual verify gates `converged`, so the
    # cheaper single-pass CGS is safe (identical verified residuals); the
    # ungated f32-only mode keeps CGS2
    _reorth_env = os.environ.get("STFEM_BENCH_REORTH",
                                 "0" if use_ir else "1")
    reorth = (_reorth_env if _reorth_env in ("selective", "gram")
              else _reorth_env == "1")
    vbf16 = jnp.bfloat16 if os.environ.get(
        "STFEM_BENCH_VBF16", "0") == "1" else None
    # right-preconditioned (non-flexible) GMRES: the V-cycle is linear, so
    # dropping the Z basis halves Krylov memory (one extra V-cycle per solve)
    flex = os.environ.get("STFEM_BENCH_FLEX", "1") == "1"

    # first-solve tolerance: in IR mode, iterations past the f32
    # TRUE-residual floor (~kappa*eps, grows with refinement) buy nothing --
    # the f32 residual estimate keeps dropping while the true residual
    # stalls, and the correction pass bridges the rest either way.  The
    # floor is MEASURED by a probe solve of slab 0 at setup (see below);
    # rtol1 = 1.4 * floor.  STFEM_BENCH_RTOL1 overrides.
    _rtol1_env = os.environ.get("STFEM_BENCH_RTOL1")
    rtol1 = (float(_rtol1_env) if _rtol1_env
             else (1e-8 if not use_ir else None))

    # glue-free outer iterations (STFEM_BENCH_OUTER=richardson|chebyshev):
    # matvec + V-cycle per step with a TRUE-residual check, no Krylov basis
    # traffic / Gram-Schmidt / Givens at all.  Chebyshev needs spectral
    # bounds for P A: rho(I - P A) estimated by power iteration at setup
    # (untimed), spectrum taken as [1 - 1.05 rho, 1 + 1.05 rho].
    # IR-mode default: glue-free preconditioned Richardson.  At 16^3
    # true-1e-8 the V-cycle contracts ~10x/step early on
    # (1 -> 0.38 -> 0.017 -> 1e-3 -> 7e-5 -> 1.2e-5), so the first solve
    # reaches the f32 floor in 5 steps and each step costs only
    # matvec + V-cycle, without FGMRES's Krylov glue.  Correctness is
    # gated by the untimed IR true-residual verify.  The f32-only mode
    # keeps FGMRES (its Givens estimate is the only stopping signal there).
    outer = os.environ.get("STFEM_BENCH_OUTER",
                           "richardson" if use_ir else "fgmres")
    cheb_interval = None
    glue_free_maxiter = int(os.environ.get("STFEM_BENCH_MAXITER", "40"))

    def make_outer_solve(outer_kind):
        def outer_solve(matrix_, gmg_, rhs, x0, reltol, maxiter):
            if outer_kind == "richardson":
                return richardson_solve(
                    matrix_.vmult, rhs, x0, gmg_.vmult,
                    omega=float(os.environ.get("STFEM_BENCH_OMEGA", "1.0")),
                    maxiter=glue_free_maxiter, abstol=1e-30, reltol=reltol)
            if outer_kind == "chebyshev":
                return chebyshev_solve(
                    matrix_.vmult, rhs, x0, gmg_.vmult,
                    lambda_min=cheb_interval[0],
                    lambda_max=cheb_interval[1],
                    maxiter=glue_free_maxiter, abstol=1e-30, reltol=reltol)
            return fgmres(matrix_.vmult, rhs, x0, precondition=gmg_.vmult,
                          maxiter=maxiter, abstol=1e-30, reltol=reltol,
                          reorthogonalize=reorth, basis_dtype=vbf16,
                          flexible=flex)
        return outer_solve

    outer_solve = make_outer_solve(outer)

    def solve_slab(matrix_, rhs_matrix_, gmg_, force_, prev_x, t):
        rhs = rhs_matrix_.vmult(prev_x[None])
        rhs = rhs + force_.batched(t + jnp.asarray(t_offsets),
                                   jnp.asarray(f_scales))
        x0 = jnp.broadcast_to(prev_x, shape)
        res = outer_solve(matrix_, gmg_, rhs, x0, rtol1, bench_maxiter)
        return res.x, res.iterations, res.residual, res.converged

    # one IR pass must bridge the f32 true-residual floor down to 1e-8: the
    # correction tolerance scales accordingly; derived from the probe floor
    # at setup (ir_rtol = 0.5e-8 / floor).  STFEM_BENCH_IR_RTOL overrides.
    _ir_rtol_env = os.environ.get("STFEM_BENCH_IR_RTOL")
    ir_rtol = float(_ir_rtol_env) if _ir_rtol_env else None

    from functools import partial

    @partial(jax.jit, static_argnums=(9,))
    def march_f32(matrix_, rhs_matrix_, gmg_, force_, m64_, r64_, f64slabs,
                  prev_x, t0_, n):
        # the whole time loop lives on-device: ONE dispatch for n slabs
        def step(carry, _):
            prev, t = carry
            x, iters, resid, conv = solve_slab(
                matrix_, rhs_matrix_, gmg_, force_, prev, t)
            return (x[-1], t + np.float32(tau * n_at_once)), \
                (iters, iters, resid, conv)
        (last, _), (xs, iters, resid, conv) = jax.lax.scan(
            step, (prev_x, t0_), jnp.arange(n))
        return last, xs, iters, resid, conv

    # the IR march is a HOST loop over per-slab jitted stages: the
    # high-precision residual and the f32 solves compile as SEPARATE
    # executables, so the V-cycle compiles once and every stage reuses it.
    # Dispatches are async -- the host loop costs enqueue latency only.
    #
    # Compile-time consolidation (VERDICT r2 #2): reltol is a TRACED
    # argument of the one shared outer-solver executable, so the first
    # solve (rtol1), the floor probe (1e-8), and the correction solve
    # (ir_rtol) all reuse a single compiled program -- the V-cycle, the
    # dominant compile payload, is compiled exactly once.
    @jax.jit
    def jit_rhs(rhs_matrix_, force_, prev_x, t):
        return rhs_matrix_.vmult(prev_x[None]) + force_.batched(
            t + jnp.asarray(t_offsets), jnp.asarray(f_scales))

    def build_jit_outer(outer_kind):
        osv = make_outer_solve(outer_kind)

        @jax.jit
        def jit_outer_(matrix_, gmg_, rhs, x0, reltol):
            res = osv(matrix_, gmg_, rhs, x0, reltol, bench_maxiter)
            return res.x, res.iterations, res.residual, res.converged
        return jit_outer_

    jit_outer = build_jit_outer(outer)

    def _resid_stepwise(m64_, rhs64, x):
        if isinstance(m64_, SystemMatrix) \
                and int(m64_.Alpha.shape[1]) == n_blocks:
            # whole-slab apply (STFEM_BENCH_IR_STEPWISE=0)
            r = rhs64 - m64_.vmult(x)
            return r, jnp.linalg.norm(r.reshape(-1))
        if isinstance(m64_, SystemMatrix):
            # rectangular per-step form: rows = one step's nt blocks,
            # cols = [previous step's last block, step blocks]
            ntb = int(m64_.Alpha.shape[0])
            sshape = (n_blocks // ntb, ntb) + x.shape[1:]
            xs = x.reshape(sshape)
            prev = jnp.concatenate(
                [jnp.zeros_like(xs[:1, -1:]), xs[:-1, -1:]], axis=0)
            xin = jnp.concatenate([prev, xs], axis=1)
            rh = rhs64.reshape(sshape)

            def body(carry, inp):
                xi, rhi = inp
                return carry, rhi - m64_.vmult(xi)

            _, rs = jax.lax.scan(body, None, (xin, rh))
            r = rs.reshape(x.shape)
            return r, jnp.linalg.norm(r.reshape(-1))
        m_step, m_coup = m64_
        cb = int(m_step.Alpha.shape[0])       # blocks per scan chunk
        sshape = (n_blocks // cb, cb) + x.shape[1:]
        xs = x.reshape(sshape)
        xp = jnp.concatenate([jnp.zeros_like(xs[:1]), xs[:-1]], axis=0)
        rh = rhs64.reshape(sshape)

        def body(carry, inp):
            xsi, xpi, rhi = inp
            return carry, rhi - m_step.vmult(xsi) - m_coup.vmult(xpi)

        _, rs = jax.lax.scan(body, None, (xs, xp, rh))
        r = rs.reshape(x.shape)
        return r, jnp.linalg.norm(r.reshape(-1))

    @jax.jit
    def jit_resid64(m64_, r64_, prev64, x, fslab64):
        rhs64 = r64_.vmult(prev64[None]) + fslab64
        r, rnorm = _resid_stepwise(m64_, rhs64, x)
        # scaled f32 correction rhs comes out of the same executable
        return (r / rnorm).astype(jnp.float32), rnorm

    @jax.jit
    def jit_update(x, rnorm, corr):
        return x + rnorm * corr.astype(jnp.float64)

    # ---- float-float IR stages (ir_ff): no x64 on the device at all ----
    @jax.jit
    def jit_resid_ff(ffres_, prev_ff, x_ff, fhi, flo):
        """ff residual -> (unit-scaled f32 correction rhs, rnorm, bnorm).
        Doubles as the untimed verifier (rnorm / bnorm is the true rel)."""
        (r_hi, _r_lo), rnorm, bn = ffres_.residual(prev_ff, x_ff,
                                                   (fhi, flo))
        return r_hi / rnorm, rnorm, bn

    # Richardson correction (STFEM_BENCH_IR_RICH=k > 0): k FIXED
    # V-cycle-preconditioned Richardson steps instead of the
    # solve-to-tolerance correction -- no convergence check at all.  Valid
    # because the IR verification (untimed ff residual) still gates
    # `converged`; if the V-cycle error propagator were not contractive
    # the verify would fail, not lie.
    ir_rich = int(os.environ.get("STFEM_BENCH_IR_RICH", "0"))

    @jax.jit
    def jit_correct_rich(matrix_, gmg_, r32):
        c = gmg_.vmult(r32)
        for _ in range(ir_rich - 1):
            c = c + gmg_.vmult(r32 - matrix_.vmult(c))
        return c, jnp.asarray(ir_rich, jnp.int32)

    def correct(matrix_, gmg_, r32):
        """Correction solve through the SHARED outer executable."""
        if ir_rich > 0:
            return jit_correct_rich(matrix_, gmg_, r32)
        corr, extra, _, _ = jit_outer(matrix_, gmg_, r32,
                                      jnp.zeros_like(r32), ir_rtol)
        return corr, extra

    @jax.jit
    def jit_update_ff(x_ff, rnorm, corr):
        from stfem_tpu.ops.floatfloat import ff_add_f32
        return ff_add_f32(x_ff, rnorm * corr)

    # polynomial initial-guess extrapolation (VERDICT r4 #2a): the
    # reference ships extrapolation matrices (fe_time.h:530-641); here the
    # previous SLAB's last time step (nt dofs, a degree-k polynomial in
    # time) is extrapolated into the first STFEM_BENCH_X0_STEPS steps of
    # the new slab's initial guess; steps beyond that keep the constant
    # (last-value) broadcast -- polynomial extrapolation s steps out
    # amplifies like s^k and is nonsense far from the data.
    # STFEM_BENCH_X0=const (default) keeps the r4 constant broadcast.
    x0_mode = os.environ.get("STFEM_BENCH_X0", "const")
    x0_steps = int(os.environ.get("STFEM_BENCH_X0_STEPS", "1"))
    E_x0 = None
    if x0_mode == "extrap":
        from stfem_tpu.time.quadrature import LagrangeBasis
        basis = LagrangeBasis(np.asarray(tq, np.float64) - 1.0)
        E = np.zeros((n_blocks, nt))
        for row in range(n_blocks):
            s, j = divmod(row, nt)
            if s < x0_steps:
                E[row] = basis.eval_matrix(
                    np.asarray([s + float(tq[j])]))[0]
            else:
                E[row, -1] = 1.0
        E_x0 = jnp.asarray(E, jnp.float32)

    def first_solve(matrix_, rhs_matrix_, gmg_, force_, prev_hi, t, reltol,
                    prev_step=None):
        """rhs assembly + outer solve through the shared executables.
        prev_step: [nt, *dof] last step of the previous slab (f32) for the
        extrapolated initial guess; None = constant broadcast."""
        rhs = jit_rhs(rhs_matrix_, force_, prev_hi, t)
        if E_x0 is not None and prev_step is not None:
            x0 = jnp.einsum("rj,j...->r...", E_x0, prev_step)
        else:
            x0 = jnp.broadcast_to(prev_hi, shape)
        return jit_outer(matrix_, gmg_, rhs, x0, reltol)

    def march_ff(matrix_, rhs_matrix_, gmg_, force_, ffres_, fslabs_ff,
                 prev_ff, t0_, n):
        """IR march with the double-single residual engine: the f32 solve,
        ff residual, f32 correction, and ff verify are separate dispatches
        of shared executables; per-slab timing semantics identical."""
        its, rss, cvs, rels, times = [], [], [], [], []
        prev, t = prev_ff, np.float32(t0_)
        prev_step = None
        fhi, flo = fslabs_ff
        for i in range(n):
            t0 = time.time()
            x32, it, rs, cv = first_solve(matrix_, rhs_matrix_, gmg_,
                                          force_, prev[0], t, rtol1,
                                          prev_step=prev_step)
            x_ff = (x32, jnp.zeros_like(x32))
            for _ in range(ir_passes):
                r32, rnorm, _bn = jit_resid_ff(
                    ffres_, prev, x_ff, fhi[i], flo[i])
                corr, extra = correct(matrix_, gmg_, r32)
                x_ff = jit_update_ff(x_ff, rnorm, corr)
                it = it + extra
            jax.block_until_ready(x_ff)
            times.append(time.time() - t0)
            # untimed ff verification (drained before the next timed window)
            _r2, rn2, bn2 = jit_resid_ff(ffres_, prev, x_ff, fhi[i], flo[i])
            rels.append(float(rn2) / float(bn2))
            its.append(it)
            rss.append(rs)
            cvs.append(cv)
            prev = (x_ff[0][-1], x_ff[1][-1])
            if E_x0 is not None:
                prev_step = x_ff[0][-nt:]
            t = np.float32(t + tau * n_at_once)
        return (prev, (np.array(times), np.array(rels)), jnp.stack(its),
                jnp.stack(rss), jnp.stack(cvs))

    def march(matrix_, rhs_matrix_, gmg_, force_, m64_, r64_, f64slabs,
              prev_x, t0_, n):
        if not use_ir:
            return march_f32(matrix_, rhs_matrix_, gmg_, force_, m64_,
                             r64_, f64slabs, prev_x, t0_, n)
        if ir_ff:
            return march_ff(matrix_, rhs_matrix_, gmg_, force_, m64_,
                            f64slabs, prev_x, t0_, n)
        # per-slab timing + IMMEDIATE untimed f64 verification: keeping
        # all f64 slab solutions on-device for a post-march verify pass
        # wastes device memory at 16^3 x 10 slabs (211 MB f64 each)
        its, rss, cvs, rels, times = [], [], [], [], []
        prev, t = prev_x, np.float32(t0_)
        for i in range(n):
            t0 = time.time()
            x32, it, rs, cv = first_solve(matrix_, rhs_matrix_, gmg_,
                                          force_, prev.astype(jnp.float32),
                                          t, rtol1)
            x = x32.astype(jnp.float64)
            prev64 = prev.astype(jnp.float64)
            for _ in range(ir_passes):
                r32, rnorm = jit_resid64(m64_, r64_, prev64, x, f64slabs[i])
                corr, extra = correct(matrix_, gmg_, r32)
                x = jit_update(x, rnorm, corr)
                it = it + extra
            jax.block_until_ready(x)
            times.append(time.time() - t0)
            # blocking float() drains the verify BEFORE the next slab's
            # timed window opens (it must not leak into the next timing)
            rels.append(float(jit_verify_slab(m64_, r64_, prev64, x,
                                              f64slabs[i])))
            its.append(it)
            rss.append(rs)
            cvs.append(cv)
            prev = x[-1]
            t = np.float32(t + tau * n_at_once)
        return (prev, (np.array(times), np.array(rels)), jnp.stack(its),
                jnp.stack(rss), jnp.stack(cvs))

    @jax.jit
    def jit_verify_slab(m64_, r64_, prev64, x, fslab64):
        """Untimed TRUE f64 relative residual of one slab solution."""
        rhs64 = r64_.vmult(prev64[None]) + fslab64
        r, _ = _resid_stepwise(m64_, rhs64, x)
        return (jnp.linalg.norm(r.reshape(-1))
                / jnp.linalg.norm(rhs64.reshape(-1)))

    with jax.default_device(host):
        coords = jnp.asarray(mesh.dof_coordinates(space_degree), dtype)
        prev = heat_problem.exact_solution(coords, 0.0, 1.0).astype(dtype)
    prev = jax.device_put(prev, dev)
    # move all module arrays to the device once (otherwise every solve call
    # re-transfers the patch inverses etc. from the host)
    matrix, rhs_matrix, gmg, force = jax.device_put(
        (matrix, rhs_matrix, gmg, force), dev)
    if outer == "chebyshev":
        from stfem_tpu.stmg.smoother import initial_guess
        v0 = jax.device_put(initial_guess(shape, K.mask_np, jnp.float32),
                            dev)

        @jax.jit
        def _rho(m_, g_, v):
            return estimate_error_propagator_radius(m_.vmult, g_.vmult, v)

        t0r = time.time()
        rho = float(_rho(matrix, gmg, v0))
        print(f"# rho(I - PA) = {rho:.4f}  ({time.time() - t0r:.1f}s)",
              flush=True)
        assert 0.0 < rho < 1.0, \
            f"V-cycle not contractive (rho = {rho}); chebyshev outer invalid"
        cheb_interval = (1.0 - 1.05 * rho, 1.0 + 1.05 * rho)
    f64slabs = None
    if use_ir:
        # host-side f64 force assembly per slab (native f64 on CPU)
        t_off64 = np.array([tau * (row // nt) + tau * float(tq[row % nt])
                            for row in range(n_blocks)], np.float64)
        f_sc64 = np.asarray(f_scales, np.float64)
        with jax.default_device(host):
            fs = [force64.batched(jnp.asarray(
                      i * tau * n_at_once + t_off64),
                      jnp.asarray(f_sc64))
                  for i in range(n_slabs)]
            f64slabs = jnp.stack(fs)
        if ir_ff:
            from stfem_tpu.ops.floatfloat import ff_from_f64
            with jax.default_device(host):
                fslabs_ff = ff_from_f64(f64slabs)
                prev_ff = ff_from_f64(prev.astype(jnp.float64))
            # route through the generic march slots: m64_ carries the ff
            # residual engine, f64slabs the (hi, lo) force pair, prev the
            # ff previous-solution pair
            matrix64 = jax.device_put(ffres, dev)
            f64slabs = jax.device_put(fslabs_ff, dev)
            prev = jax.device_put(prev_ff, dev)
        else:
            matrix64, rhs_matrix64 = jax.device_put(
                (matrix64, rhs_matrix64), dev)
            prev = prev.astype(jnp.float64)
            f64slabs = jax.device_put(f64slabs, dev)
    probe_floor = None
    if use_ir:
        # ---- probe slab 0: measure the f32 floor, derive the tolerances,
        # and pay (almost) all compile time here -- the march reuses these
        # executables via the traced-reltol consolidation.  The probe runs
        # the first solve to its stall (reltol 1e-8 is unreachable in f32;
        # glue-free maxiter bounds it) and reads the TRUE high-precision
        # relative residual: that IS the achievable f32 floor.
        t0 = time.time()
        if ir_ff:
            x32p, _, _, _ = first_solve(matrix, rhs_matrix, gmg, force,
                                        prev[0], np.float32(0.0), 1e-8)
            x_ffp = (x32p, jnp.zeros_like(x32p))
            _rp, rnp, bnp = jit_resid_ff(matrix64, prev, x_ffp,
                                         f64slabs[0][0], f64slabs[1][0])
            probe_floor = float(rnp) / float(bnp)
        else:
            x32p, _, _, _ = first_solve(matrix, rhs_matrix, gmg, force,
                                        prev.astype(jnp.float32),
                                        np.float32(0.0), 1e-8)
            probe_floor = float(jit_verify_slab(
                matrix64, rhs_matrix64, prev.astype(jnp.float64),
                x32p.astype(jnp.float64), f64slabs[0]))
        if outer == "richardson" and probe_floor > 1e-3:
            # contractivity guard (ADVICE r2): a non-contractive V-cycle
            # makes glue-free Richardson diverge where FGMRES would still
            # converge; fall back (pays one extra compile, failure path
            # only) and re-probe the floor
            print(f"# WARNING: Richardson probe stalled at rel "
                  f"{probe_floor:.2e}; falling back to FGMRES outer",
                  flush=True)
            outer = "fgmres"
            jit_outer = build_jit_outer(outer)
            if ir_ff:
                x32p, _, _, _ = first_solve(matrix, rhs_matrix, gmg, force,
                                            prev[0], np.float32(0.0), 1e-8)
                x_ffp = (x32p, jnp.zeros_like(x32p))
                _rp, rnp, bnp = jit_resid_ff(matrix64, prev, x_ffp,
                                             f64slabs[0][0], f64slabs[1][0])
                probe_floor = float(rnp) / float(bnp)
            else:
                x32p, _, _, _ = first_solve(matrix, rhs_matrix, gmg, force,
                                            prev.astype(jnp.float32),
                                            np.float32(0.0), 1e-8)
                probe_floor = float(jit_verify_slab(
                    matrix64, rhs_matrix64, prev.astype(jnp.float64),
                    x32p.astype(jnp.float64), f64slabs[0]))
        # derived tolerances: stop the first solve just above the floor;
        # one correction pass must bridge floor -> 1e-8
        if rtol1 is None:
            rtol1 = max(1.4 * probe_floor, 1e-8)
        if ir_rtol is None:
            ir_rtol = min(max(0.5e-8 / max(probe_floor, 1e-12), 1e-7),
                          2e-3)
        probe_time = time.time() - t0
        print(f"# probe: floor {probe_floor:.3e} -> rtol1 {rtol1:.3e}, "
              f"ir_rtol {ir_rtol:.3e}  (compile+probe {probe_time:.1f}s)",
              flush=True)
    print("# compiling slab solve", flush=True)

    # warmup (same static slab count as the timed run); in IR mode the
    # heavy executables are already compiled by the probe, so this times
    # the residual small-stage compiles + one full march
    t0 = time.time()
    last, xs, iters, resid, conv = march(matrix, rhs_matrix, gmg, force,
                                         matrix64, rhs_matrix64, f64slabs,
                                         prev, np.float32(0.0), n_slabs)
    jax.block_until_ready(last)
    compile_time = time.time() - t0
    if use_ir:
        warm_march_s = compile_time
        compile_time = probe_time + warm_march_s

    t0 = time.time()
    last, xs, iters, resid, conv = march(matrix, rhs_matrix, gmg, force,
                                         matrix64, rhs_matrix64, f64slabs,
                                         prev, np.float32(0.0), n_slabs)
    jax.block_until_ready(last)
    if use_ir:
        # per-slab windows, each ended by block_until_ready; the untimed
        # verification runs between them
        slab_times, _rels = xs
        elapsed = float(np.sum(slab_times))
    else:
        elapsed = time.time() - t0

    # honest accuracy check (outside the timing): TRUE relative residual of
    # one slab solve, not just the Givens estimate.  f32 outer Krylov
    # attains ~kappa * eps_f32 (~1e-6 here); the estimate reads lower.
    @jax.jit
    def true_residual(matrix_, rhs_matrix_, gmg_, force_, prev_x, t):
        x, _, _, _ = solve_slab(matrix_, rhs_matrix_, gmg_, force_,
                                prev_x, t)
        rhs = rhs_matrix_.vmult(prev_x[None]) + force_.batched(
            t + jnp.asarray(t_offsets), jnp.asarray(f_scales))
        r = rhs - matrix_.vmult(x)
        return (jnp.linalg.norm(r.reshape(-1))
                / jnp.linalg.norm(rhs.reshape(-1)))

    if use_ir:
        # per-slab high-precision verification from the march (untimed)
        true_rels = np.asarray(xs[1])
        target = 1e-8
    else:
        true_rels = np.asarray([float(true_residual(
            matrix, rhs_matrix, gmg, force, prev, np.float32(0.0)))])
        target = 1e-5
    iters_np = np.asarray(iters)
    st_dofs = int(np.prod(shape)) * n_slabs
    info = dict(section="heat", cells=mesh.n_cells,
                space_dofs=int(mesh.n_dofs(space_degree)),
                n_blocks=n_blocks, slabs=n_slabs,
                avg_iters=float(iters_np.sum()) / n_slabs,
                slab_true_rel=[float(r) for r in true_rels],
                true_rel_residual=float(true_rels.max()), target=target,
                final_rel_residual=float(np.asarray(resid)[-1]),
                converged=(bool(np.all(np.asarray(conv)))
                           and bool(np.all(true_rels <= target))),
                setup_s=setup_time, compile_s=compile_time,
                solve_s=elapsed, dofs_per_s=st_dofs / elapsed,
                peak_bytes_in_use=peak_bytes_in_use(dev))
    if use_ir:
        info.update(warm_s=warm_march_s, probe_floor=probe_floor,
                    rtol1=rtol1, ir_rtol=ir_rtol)
    return info


SECTIONS = {"heat": run_heat_bench, "stokes": run_stokes_bench,
            "wave": run_wave_bench}
# tiny sizes for the CPU rehearsal (cells per axis, timesteps per slab)
REHEARSAL = {"heat": dict(cells=2, ntao=2, n_slabs=1),
             "stokes": dict(cells=2, ntao=2, n_slabs=1),
             "wave": dict(cells=2, ntao=4, n_slabs=1)}


def run_sections(names, rehearse: bool = False, sizes=None) -> list[dict]:
    """Run the named sections in order, each result line tagged with the
    device it ran on.  Off a GPU only a rehearsal runs, and its lines carry
    no time and no rate.  A section that raises fails the run."""
    import jax

    from stfem_tpu.utils.runtime import device_info, require_gpu

    if not rehearse:
        require_gpu()
    dev = jax.devices()[0]
    try:
        host = jax.devices("cpu")[0]
    except RuntimeError:    # no CPU backend configured: set up on dev
        host = dev
    # the IR residuals and every verification are f64/float-float
    jax.config.update("jax_enable_x64", True)
    tag = device_info()
    results = []
    for name in names:
        kw = dict(REHEARSAL[name] if rehearse else {})
        kw.update((sizes or {}).get(name, {}))
        res = SECTIONS[name](host, dev, **kw)
        if rehearse:
            for k in DEVICE_KEYS:
                res.pop(k, None)
        res.update(tag)
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sections", default="heat,stokes,wave",
                    help="comma-separated subset of heat,stokes,wave")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU run at a tiny size: control flow and "
                         "convergence only, no time and no rate")
    args = ap.parse_args(argv)
    names = [n for n in args.sections.split(",") if n]
    unknown = set(names) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")

    if args.rehearse:
        # XLA:CPU's default LLVM optimization of the float-float residual
        # graphs runs out of memory at the tiny rehearsal shapes; level 0
        # compiles them in seconds (set before the backend starts)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_backend_optimization_level=0")

    import jax

    from stfem_tpu.utils.runtime import configure_compile_cache

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
    configure_compile_cache()
    results = run_sections(names, rehearse=args.rehearse)
    failed = [r["section"] for r in results if not r["converged"]]
    if failed:
        print(f"# NOT converged: {failed}", flush=True)
        return 1
    heat = [r for r in results if r["section"] == "heat"]
    if heat and not args.rehearse:
        r = heat[0]
        print(json.dumps({
            "metric": "stmg_slab_solve_throughput_3d_heat_q4_dg2",
            "value": r["dofs_per_s"],
            "unit": "space-time DoF/s (TRUE rel 1e-8 slab solves)",
            "platform": r["platform"], "device_kind": r["device_kind"],
            "device_count": r["device_count"], "gpu": r["gpu"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
