"""tp_03stokes application replica: Stokes convergence/iteration tables from
reference-format JSON configs (reference tests/tp_03stokes.cc).

CLI: python -m stfem_tpu.drivers.tp03stokes --file cfg.json
Default runs tf01stokes + tf02stokes like the reference
(tp_03stokes.cc:1260-1262).
"""
from __future__ import annotations

import argparse
import os
import sys

from ..config import Parameters, StokesParameters
from ..stmg.gmg import GMGParams, build_stmg_stokes
from ..types import TimeStepType
from ..utils.tables import ConvergenceTable
from .stokes import run_stokes_cycle


def parse_stokes_extra(path: str) -> StokesParameters:
    """stokes::Parameters (reference stokes.cc:6-27)."""
    if path and os.path.exists(path):
        return StokesParameters.parse(path)
    return StokesParameters()


def run_single(p: Parameters, stokes_extra: StokesParameters, k: int,
               ref: int):
    """One (degree, refinement) cell of the tp_03stokes sweep."""
    factory = None
    if p.space_time_mg:
        def factory(ctx):
            return build_stmg_stokes(
                ctx["mesh"], ctx["fe_degree"], ctx["type_"],
                ctx["n_timesteps_at_once"], ctx["time_step"],
                viscosity=ctx["viscosity"], params=p.mg_data,
                coarsening_type=p.coarsening_type,
                time_before_space=p.time_before_space,
                space_time_level_first=p.space_time_level_first,
                use_pmg=p.use_pmg,
                fe_degree_min=max(p.fe_degree_min, 1),
                fe_degree_min_space=max(p.fe_degree_min_space, 1))
    return run_stokes_cycle(
        refinement=ref, fe_degree=k, type_=p.type,
        n_timesteps_at_once=p.n_timesteps_at_once,
        viscosity=stokes_extra.viscosity,
        end_time=p.end_time,
        mean_pressure=stokes_extra.mean_pressure,
        preconditioner_factory=factory,
        gmres_maxiter=100 if factory else 1000,
        rel_tol=p.rel_tol, extrapolate=p.extrapolate)


def run_practical(p: Parameters, stokes_extra: StokesParameters, k: int,
                  ref: int, n_slabs_max: int | None = None):
    """One practical-mode run (spaceTimeConvergenceTest=false): the
    lid-driven cavity (dfgBenchmark 0, tf05stokes/tf06stokes + the
    practical campaign) or the DFG channel (dfgBenchmark >= 1) with the
    functionals file (probe values + wall/obstacle forces + divergence,
    tp_03stokes.cc:918-996)."""
    from ..stmg.gmg import build_stmg_stokes
    from .stokes import run_dfg_square, run_lid_driven

    def factory(ctx):
        return build_stmg_stokes(
            ctx["mesh"], ctx["fe_degree"], ctx["type_"],
            ctx["n_timesteps_at_once"], ctx["time_step"],
            viscosity=ctx["viscosity"], params=p.mg_data,
            coarsening_type=p.coarsening_type,
            time_before_space=p.time_before_space,
            space_time_level_first=p.space_time_level_first,
            use_pmg=p.use_pmg, fe_degree_min=max(p.fe_degree_min, 1),
            fe_degree_min_space=max(p.fe_degree_min_space, 1),
            weak_faces=ctx.get("weak_faces", ()),
            free_faces=ctx.get("free_faces", ()),
            weak_obstacle=ctx.get("weak_obstacle", False))

    fac = factory if p.space_time_mg else None
    if stokes_extra.dfg_benchmark == 0:
        return run_lid_driven(
            refinement=ref, fe_degree=k, type_=p.type,
            n_timesteps_at_once=p.n_timesteps_at_once,
            viscosity=stokes_extra.viscosity, end_time=p.end_time,
            preconditioner_factory=fac,
            gmres_maxiter=100 if fac else 1000, rel_tol=p.rel_tol,
            n_slabs_max=n_slabs_max,
            strong_bc=not p.nitsche_boundary,
            functionals_path=p.functional_file)
    return run_dfg_square(
        refinement=ref, fe_degree=k, type_=p.type,
        viscosity=stokes_extra.viscosity,
        u_mean=stokes_extra.u_mean,
        dfg_benchmark=stokes_extra.dfg_benchmark,
        end_time=p.end_time,
        n_slabs=n_slabs_max if n_slabs_max else 4,
        preconditioner_factory=fac,
        gmres_maxiter=150 if fac else 1500, rel_tol=p.rel_tol,
        cylinder=(p.grid_descriptor == "dfgBenchmark"))


def run_config(p: Parameters, stokes_extra: StokesParameters,
               out=sys.stdout, n_slabs_max: int | None = None):
    if not p.space_time_conv_test:
        # practical mode: iteration log + functionals file, no error norms
        if os.path.exists(p.functional_file):
            os.remove(p.functional_file)
        for k in range(p.fe_degree, p.fe_degree + p.n_deg_cycles):
            for ref in range(p.refinement, p.refinement + p.n_ref_cycles):
                res = run_practical(p, stokes_extra, k, ref, n_slabs_max)
                iters = res["iterations"]
                print(f"Average GMRES iterations "
                      f"{sum(iters) / max(len(iters), 1):g} "
                      f"({sum(iters)} gmres_iterations / {len(iters)} "
                      f"timesteps)\n", file=out)
        return
    table = ConvergenceTable()
    itable_rows = []
    for k in range(p.fe_degree, p.fe_degree + p.n_deg_cycles):
        iters_row = {"k \\ r": k}
        for ref in range(p.refinement, p.refinement + p.n_ref_cycles):
            res = run_single(p, stokes_extra, k, ref)
            print(f"\n:: Number of active cells: {res.n_cells}", file=out)
            print(f":: Number of u degrees of freedom: {res.n_dofs_u}",
                  file=out)
            print(f":: Number of p degrees of freedom: {res.n_dofs_p}",
                  file=out)
            print(f"Average GMRES iterations {res.avg_iterations:g} "
                  f"({res.total_iterations} gmres_iterations / "
                  f"{res.n_timesteps} timesteps)\n", file=out)
            st = res.n_timesteps * (res.n_dofs_u + res.n_dofs_p) \
                * res.n_blocks // 2
            table.add_row(**{
                "cells": res.n_cells,
                "s-dofs": res.n_dofs_u + res.n_dofs_p,
                "t-dofs": res.n_blocks // 2, "st-dofs": st,
                "work": st * res.total_iterations // max(res.n_timesteps, 1),
                "L∞-L∞(u)": res.linf_linf_u, "L2-L2(u)": res.l2_l2_u,
                "L2-H1_semi(u)": res.l2_h1_u,
                "L2-Hdiv_semi(u)": res.l2_hdiv_u,
                "L∞-L∞(p)": res.linf_linf_p, "L2-L2(p)": res.l2_l2_p,
                "L2-H1_semi(p)": res.l2_h1_p})
            iters_row[str(ref)] = res.avg_iterations
        for c in ("L∞-L∞(u)", "L2-L2(u)", "L2-H1_semi(u)",
                  "L2-Hdiv_semi(u)", "L∞-L∞(p)", "L2-L2(p)",
                  "L2-H1_semi(p)"):
            table.evaluate_convergence_rates(c)
        print(f"Convergence table k={k}", file=out)
        print(table.text(), file=out)
        print("", file=out)
        table.clear()
        itable_rows.append(iters_row)
    print("Iteration count table", file=out)
    if itable_rows:
        cols = list(itable_rows[0].keys())
        print(" ".join(c.rjust(7) for c in cols), file=out)
        for r in itable_rows:
            print(" ".join(f"{r[c]:7.4f}" if isinstance(r[c], float)
                           else str(r[c]).rjust(7) for c in cols), file=out)


def main(argv=None):
    import jax

    from ..utils.runtime import configure_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--file", "-f", default="default")
    ap.add_argument("--dim", "-d", type=int, default=2)
    args = ap.parse_args(argv)
    # the reference's outer solver runs in f64 (time_integrators.h:56-59)
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache()
    test_dir = os.environ.get("STFEM_TESTDIR", "/root/reference/tests/json")

    def run_one(path):
        p = Parameters.parse(path, args.dim)
        extra_path = p.additional_file
        if extra_path and not os.path.isabs(extra_path):
            # reference configs point at 'tests/json/stokes.json'
            extra_path = os.path.join(test_dir, os.path.basename(extra_path))
        run_config(p, parse_stokes_extra(extra_path))

    if args.file == "default":
        for name in ("tf01stokes.json", "tf02stokes.json"):
            run_one(os.path.join(test_dir, name))
    else:
        run_one(args.file)


if __name__ == "__main__":
    main()
