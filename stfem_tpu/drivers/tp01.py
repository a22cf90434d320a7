"""tp_01 application replica: heat & wave convergence/iteration tables from
reference-format JSON configs (reference tests/tp_01.cc).

CLI: python -m stfem_tpu.drivers.tp01 --file cfg.json --dim 2
     [--no-precondition-float]
Default (no --file) runs the reference's 8 shipped configs tf01..tf08
against /root/reference/tests/json (or a copy) like tp_01.cc:818-826.
"""
from __future__ import annotations

import argparse
import os
import sys

from ..config import Parameters
from ..stmg.gmg import GMGParams
from ..types import ProblemType, TimeStepType
from ..utils.tables import ConvergenceTable
from .heat import run_heat_cycle, stmg_preconditioner_factory


def run_single(p: Parameters, k: int, ref: int,
               precondition_float: bool = True, timer=None):
    """One (degree, refinement) cell of the tp_01 sweep (reference
    tests/tp_01.cc:735-742 convergence-cycle body)."""
    import jax.numpy as jnp

    factory = None
    if p.space_time_mg:
        factory = stmg_preconditioner_factory(
            dtype=jnp.float32 if precondition_float else jnp.float64,
            params=p.mg_data,
            coarsening_type=p.coarsening_type,
            time_before_space=p.time_before_space,
            space_time_level_first=p.space_time_level_first,
            use_pmg=p.use_pmg,
            # golden-era conventions (see SURVEY.md section 6):
            # time-k floor at degree >= 1, space-p bisect to Q1
            fe_degree_min=max(p.fe_degree_min, 1),
            poly_coarsening=p.poly_coarsening)
    extra = {}
    if not p.space_time_conv_test:
        # practical mode (reference tp_01.cc:118,374-381,556): initial value
        # = unit-integral C-inf bump at sourcePoint, zero rhs, heterogeneous
        # coefficient on K, no error norms; point probes -> functionals file
        import numpy as np
        from ..problems.coefficient import Coefficient
        from ..problems.heat import cutoff_cinfty
        src = p.source if p.source is not None else (0.0,) * p.dim
        extra = dict(
            coefficient=Coefficient(p.subdivisions, p.hyperrect_lower_left,
                                    p.hyperrect_upper_right,
                                    p.distort_coeff),
            initial_fn=lambda c: np.asarray(
                cutoff_cinfty(jnp.asarray(c), src)),
            initial_v_fn=lambda c: np.zeros(c.shape[:-1]),
            rhs_fn_override=lambda pts, t: jnp.zeros(pts.shape[:-1]),
            compute_errors=False,
            # reference probe points (tp_01.cc:449-453)
            probe_points=([(0.75, 0.0)] if p.dim == 2 else
                          [(0.75, 0.0, 0.0), (0.0, 0.0, 0.75),
                           (0.75, 0.1, 0.75)]),
            functionals_path=p.functional_file,
            do_output=p.do_output)
    return run_heat_cycle(
        refinement=ref, fe_degree=k, type_=p.type,
        problem=p.problem,
        n_timesteps_at_once=p.n_timesteps_at_once,
        subdivisions=p.subdivisions,
        lower=p.hyperrect_lower_left,
        upper=p.hyperrect_upper_right,
        end_time=p.end_time, frequency=p.frequency,
        preconditioner_factory=factory,
        gmres_maxiter=100 if factory else 800,
        rel_tol=p.rel_tol, extrapolate=p.extrapolate,
        timer=timer, **extra)


def run_config(p: Parameters, precondition_float: bool = True,
               out=sys.stdout) -> list:
    """Print the config's convergence and iteration tables; returns the
    per-cell results in sweep order."""
    from ..utils.timer import TimerOutput
    table = ConvergenceTable()
    itable_rows = []
    timer = TimerOutput() if p.print_timing else None
    if not p.space_time_conv_test and os.path.exists(p.functional_file):
        os.remove(p.functional_file)
    k0 = p.fe_degree
    results = []
    for k in range(k0, k0 + p.n_deg_cycles):
        iters_row = {"k \\ r": k}
        for ref in range(p.refinement, p.refinement + p.n_ref_cycles):
            res = run_single(p, k, ref, precondition_float, timer)
            results.append(res)
            print(f":: Number of active cells: {res.n_cells}", file=out)
            print(f":: Number of degrees of freedom: {res.n_dofs}", file=out)
            print(f"Average GMRES iterations {res.avg_iterations:g} "
                  f"({res.total_iterations} gmres_iterations / "
                  f"{res.n_timesteps} timesteps)\n", file=out)
            row = {
                "cells": res.n_cells, "s-dofs": res.n_dofs,
                "t-dofs": res.n_blocks, "st-dofs": res.st_dofs,
                "work": res.st_dofs // res.n_blocks * res.total_iterations}
            if p.space_time_conv_test:
                # error columns only in convergence mode (tp_01.cc:357,387)
                row.update({"L∞-L∞": res.linf_linf, "L2-L2": res.l2_l2,
                            "L2-H1_semi": res.l2_h1})
            table.add_row(**row)
            iters_row[str(ref)] = res.avg_iterations
        if p.space_time_conv_test:
            for c in ("L∞-L∞", "L2-L2", "L2-H1_semi"):
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
    print("", file=out)
    if timer is not None:
        # reference tp_01.cc:709-710 (printTiming -> TimerOutput wall stats)
        print(timer.summary(), file=out)
        print("", file=out)
    return results


def main(argv=None) -> list:
    """CLI entry; returns one result list per config run."""
    import jax

    from ..utils.runtime import configure_compile_cache

    # the reference's outer solver runs in f64 (time_integrators.h:56-59)
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--file", "-f", default="default")
    ap.add_argument("--dim", "-d", type=int, default=2)
    # reference CLI takes a value: `--precondition_float 1` / `0`
    # (tp_01.cc:781-792); 1 = f32 V-cycle under the f64 outer solve
    ap.add_argument("--precondition_float", "-p", type=int, choices=(0, 1),
                    default=1)
    ap.add_argument("--log_prefix", "-l", default="proc")
    args = ap.parse_args(argv)
    args.precondition_float = bool(args.precondition_float)

    if args.file == "default":
        test_dir = os.environ.get("STFEM_TESTDIR",
                                  "/root/reference/tests/json")
        configs = [("HEAT 2 steps at once DG", "tf01.json"),
                   ("", "tf02.json"),
                   ("HEAT single step", "tf03.json"),
                   ("", "tf04.json"),
                   ("WAVE 4 steps at once", "tf05.json"),
                   ("", "tf06.json"),
                   ("WAVE single step", "tf07.json"),
                   ("", "tf08.json")]
        results = []
        for header, name in configs:
            if header:
                print(header)
            p = Parameters.parse(os.path.join(test_dir, name), args.dim)
            results.append(run_config(p, args.precondition_float))
        return results
    p = Parameters.parse(args.file, args.dim)
    return [run_config(p, args.precondition_float)]


if __name__ == "__main__":
    main()
