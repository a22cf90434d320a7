"""Smoke test of the STMG slab solver on the GPU: the quickest proof that
the system still starts on the card.

    python chip_smoke.py                 # one card: phases 1-5
    python chip_smoke.py --multichip 4   # four cards: the sharded path only

Run from the root of a checkout.  One process: the bench sections are
imported and called in-process (a JAX process reserves most of the card's
memory), and only nvidia-smi runs as a child.

Phases (one card):
  1. device   JAX must find a GPU; prints its kind, count, the JAX version
              and the card's name and power limit.
  2. parity   every kernel of the main path as compiled for the card, and
              the precision guards, each error beside its tolerance:
              Vanka time solve at the 16^3 bench shape (f32 and bf16
              storage) vs an f64 recurrence; float-float Kronecker pair and
              slab residual vs native f64; the f32 outer operator
              (precision "highest") vs f64.
  3. heat     bench.py's headline section (16^3, Q4 x dG(2), 32 steps per
              slab), 3 timed slabs, each TRUE rel <= 1e-8.
  4. stokes, wave   their bench.py sections (8^3), 2 slabs each, likewise.
  5. driver   stfem_tpu.drivers.tp01.main on the 2D heat DG(1) config;
              L2-L2 at refinement 2 must match the golden 1.78760e-02.
With --multichip N only the sharded mini-bench runs (16^3, ntao=8, z
sharded): iteration parity with one card, TRUE <= 1e-8, and the collective
counts of the compiled program.

Any failed phase makes the exit code non-zero.  The last line of a passing
run is the JSON object {"ok": true, "device": {...}}; nothing like it is
printed otherwise.  Numbers printed here are smoke numbers from 3 slabs,
not the benchmark.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

SINGLE_PHASES = ("device", "parity", "heat", "stokes_wave", "driver")
GOLDEN_L2_DG1_REF2 = 1.78760e-02    # tests/test_heat_endtoend.py
GOLDEN_RTOL = 2e-5


def select_phases(multichip: int | None) -> tuple[str, ...]:
    """The phases a run executes: the multi-card path alone, or the
    single-card phases in order."""
    if multichip:
        return ("device", "multichip")
    return SINGLE_PHASES


class PhaseFailure(AssertionError):
    pass


def check(label: str, value: float, tol: float) -> None:
    ok = bool(np.isfinite(value)) and value <= tol
    print(f"  {label}: {value:.3e}  (tolerance {tol:.0e})  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseFailure(f"{label} = {value:.3e} > {tol:.0e}")


def _median_ms(fn, *args, n: int = 20) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


# ---------------------------------------------------------------- phases

def phase_device(ctx) -> None:
    import jax

    dev = jax.devices()[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__}", flush=True)
    print(f"nvidia-smi: {ctx['gpu']}", flush=True)


def _time_solve_reference(w, G, C, S, nt):
    N = w.shape[-1]
    ws = np.asarray(w, np.float64).reshape(S, nt, N)
    c = np.asarray(C, np.float64)
    y = np.einsum("ijn,sjn->sin", np.asarray(G, np.float64), ws)
    out = np.empty_like(y)
    prev = np.zeros(N)
    for s in range(S):
        out[s] = y[s] + prev[None] * c
        prev = y[s, nt - 1] + c[nt - 1] * prev
    return out.reshape(S * nt, N)


def _parity_time_solve(ctx) -> None:
    import jax
    import jax.numpy as jnp

    from stfem_tpu.ops.pallas_timesolve import time_solve, time_solve_xla

    # the 16^3 bench shape: S = 32 steps of nt = 3, N = (16 * 5)^3
    S, nt, N = 32, 3, 80 ** 3
    rng = np.random.default_rng(0)
    w64 = rng.standard_normal((S * nt, N))
    G = jnp.asarray(0.3 * rng.standard_normal((nt, nt, N)), jnp.float32)
    C = jnp.asarray(rng.uniform(-0.9, 0.9, (nt, N)), jnp.float32)
    for dt, tol in ((jnp.float32, 1e-5), (jnp.bfloat16, 2.0 ** -8)):
        w = jnp.asarray(w64, dt)
        ref = _time_solve_reference(np.asarray(w.astype(jnp.float32)), G, C,
                                    S, nt)
        scale = float(np.max(np.abs(ref)))
        kern = jax.jit(lambda a, b, c, dt=dt: time_solve(a, b, c, S, nt, dt))
        plain = jax.jit(lambda a, b, c, dt=dt: time_solve_xla(a, b, c, S, nt,
                                                              dt))
        name = jnp.dtype(dt).name
        for label, fn in (("kernel", kern), ("xla", plain)):
            out = np.asarray(fn(w, G, C), np.float64)
            check(f"time solve {label} {name} max|err|/max|ref|",
                  float(np.max(np.abs(out - ref))) / scale, tol)
        t_k, t_x = _median_ms(kern, w, G, C), _median_ms(plain, w, G, C)
        print(f"  time solve {name} S={S} nt={nt} N={N}: kernel "
              f"{t_k:.4f} ms, xla {t_x:.4f} ms (median of 20, "
              f"{ctx['gpu']})", flush=True)


def _parity_precision(ctx) -> None:
    import jax
    import jax.numpy as jnp

    from stfem_tpu.mesh.grid import StructuredMesh
    from stfem_tpu.ops.floatfloat import (FFSlabResidual, KronAssembledFF,
                                          ff_from_f64, ff_to_f64)
    from stfem_tpu.ops.kronfac import KronAssembled
    from stfem_tpu.ops.spatial import LaplaceMassOperator
    from stfem_tpu.system import SystemMatrix
    from stfem_tpu.time.tables import get_fe_time_weights
    from stfem_tpu.types import TimeStepType

    # the heat bench's 16^3 operators: Q4 space x dG(2), 32 steps per slab
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=3)
    deg = 4

    def ops(dtype):
        return (LaplaceMassOperator(mesh, deg, deg + 1, 0.0, 1.0,
                                    dtype=dtype),
                LaplaceMassOperator(mesh, deg, deg + 1, 1.0, 0.0,
                                    dtype=dtype))

    K64, M64 = ops(jnp.float64)
    K32, M32 = ops(jnp.float32)
    Alpha, Beta, Gamma, _ = get_fe_time_weights(TimeStepType.DG, 2,
                                                1.0 / 16.0, 32)
    nb = Alpha.shape[0]
    shape = (nb,) + tuple(mesh.dof_shape(deg))
    rng = np.random.default_rng(1)

    def rel(a, b, ref):
        a, b, ref = (jnp.asarray(v, jnp.float64) for v in (a, b, ref))
        return float(jnp.linalg.norm((a - b).ravel())
                     / jnp.linalg.norm(ref.ravel()))

    # float-float Kronecker pair vs the native-f64 pair
    x = jnp.asarray(rng.standard_normal(shape))
    kron64 = KronAssembled(K64, M64, jnp.float64)
    kff = KronAssembledFF(kron64)
    Kx, Mx = jax.jit(kron64.pair)(x)
    Kf, Mf = jax.jit(kff.pair)(ff_from_f64(x))
    check("ff Kronecker pair K |ff - f64| / |f64|",
          rel(ff_to_f64(Kf), Kx, Kx), 1e-13)
    check("ff Kronecker pair M |ff - f64| / |f64|",
          rel(ff_to_f64(Mf), Mx, Mx), 1e-13)
    del Kx, Mx, Kf, Mf

    # FFSlabResidual vs the native-f64 residual of the same iterate, in the
    # IR regime: rhs ~ A x, so the residual cancels ~5 digits
    A64 = SystemMatrix(K64, M64, Alpha, Beta)
    R64 = SystemMatrix(K64, M64, np.zeros_like(Gamma), Gamma)
    prev = jnp.asarray(rng.standard_normal(shape[1:]))
    Ax = jax.jit(A64.vmult)(x)
    coup = jax.jit(R64.vmult)(prev[None])
    f = (Ax - coup) * (1.0 + 1e-5 * jnp.asarray(rng.standard_normal(shape)))
    rhs = coup + f
    r_ref = rhs - Ax
    ffres = FFSlabResidual(K64, M64, Alpha, Beta, Gamma)
    (rh, rl), _, _ = jax.jit(ffres.residual)(
        ff_from_f64(prev), ff_from_f64(x), ff_from_f64(f))
    check("ff slab residual |r_ff - r_f64| / |rhs|",
          rel(ff_to_f64((rh, rl)), r_ref, rhs), 1e-13)
    del rh, rl, r_ref, f, rhs, coup

    # the outer operator in f32 under precision "highest" vs f64; a default
    # precision f32 product (TF32 on this card) is shown for contrast
    x32 = x.astype(jnp.float32)
    y64 = jax.jit(A64.vmult)(x32.astype(jnp.float64))
    y32 = jax.jit(SystemMatrix(K32, M32, Alpha, Beta).vmult)(x32)
    check("f32 outer vmult (precision highest) |f32 - f64| / |f64|",
          rel(y32, y64, y64), 1e-6)
    y_def = jax.jit(SystemMatrix(K32, M32, Alpha, Beta,
                                 precision=None).vmult)(x32)
    print(f"  f32 vmult at default precision |f32 - f64| / |f64|: "
          f"{rel(y_def, y64, y64):.3e} (information)", flush=True)


def phase_parity(ctx) -> None:
    _parity_time_solve(ctx)
    _parity_precision(ctx)


def _check_sections(results) -> None:
    for r in results:
        worst = max(r["slab_true_rel"])
        print(f"  {r['section']}: avg_iters {r['avg_iters']:.2f}, setup "
              f"{r['setup_s']:.1f} s, compile {r['compile_s']:.1f} s, solve "
              f"{r['solve_s']:.4f} s, {r['dofs_per_s']:.4e} DoF/s, peak "
              f"{r['peak_bytes_in_use']} B ({r['gpu']}; smoke, "
              f"{r['slabs']} slabs)", flush=True)
        check(f"{r['section']} worst slab TRUE rel residual", worst, 1e-8)
        if not r["converged"]:
            raise PhaseFailure(f"{r['section']} did not converge")


def phase_heat(ctx) -> None:
    import bench

    _check_sections(bench.run_sections(
        ["heat"], sizes={"heat": {"n_slabs": 3}}))


def phase_stokes_wave(ctx) -> None:
    import bench

    _check_sections(bench.run_sections(
        ["stokes", "wave"],
        sizes={"stokes": {"n_slabs": 2}, "wave": {"n_slabs": 2}}))


# the 2D heat DG(1) case of tests/test_heat_endtoend.py in the reference's
# JSON format (reference tests/json/tf01.json keys)
DRIVER_CONFIG = {
    "problemType": "heat", "timeType": "DG", "feDegree": 1,
    "nTimestepsAtOnce": 2, "refinement": 2, "nDegCycles": 1,
    "nRefCycles": 1, "spaceTimeConvergenceTest": True, "spaceTimeMg": True,
    "endTime": 1.0, "frequency": 1.0, "relativeTolerance": 1e-12,
}


def phase_driver(ctx) -> None:
    from stfem_tpu.drivers import tp01

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "heat_dg1.json")
        with open(path, "w") as f:
            json.dump(DRIVER_CONFIG, f)
        results = tp01.main(["--file", path, "--dim", "2"])
    l2 = results[0][0].l2_l2
    check("tp01 heat DG(1) ref 2 L2-L2 relative deviation from golden",
          abs(l2 / GOLDEN_L2_DG1_REF2 - 1.0), GOLDEN_RTOL)


def phase_multichip(ctx) -> None:
    import jax

    from stfem_tpu.parallel.minibench import run_sharded_minibench

    n = ctx["multichip"]
    if len(jax.devices()) < n:
        raise PhaseFailure(f"--multichip {n} but JAX sees "
                           f"{len(jax.devices())} devices")
    t0 = time.time()
    out = run_sharded_minibench(n_devices=n, cells=16, ntao=8,
                                shard_z=True, compare_single=True)
    print(f"  sharded mini-bench: mesh {out['mesh']}, "
          f"{out['sharded_iters']} V-cycle steps sharded vs "
          f"{out['single_iters']} on one card, collectives "
          f"{out['collectives']}, {time.time() - t0:.1f} s wall "
          f"({ctx['gpu']})", flush=True)
    check("sharded TRUE rel residual", out["sharded_true_rel"], 1e-8)
    check("single-card TRUE rel residual", out["single_true_rel"], 1e-8)
    if not out["iter_parity"]:
        raise PhaseFailure("sharded iteration count differs from one card")
    if out["collectives"]["collective-permute"] == 0:
        raise PhaseFailure("no halo collective-permute in the sharded HLO")


PHASES = {"device": phase_device, "parity": phase_parity,
          "heat": phase_heat, "stokes_wave": phase_stokes_wave,
          "driver": phase_driver, "multichip": phase_multichip}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", type=int, default=None, metavar="N",
                    help="run only the sharded path on N cards")
    args = ap.parse_args(argv)
    try:
        import jax

        import bench  # noqa: F401  (the checkout's bench sections)
        from stfem_tpu.utils.runtime import (configure_compile_cache,
                                             gpu_name_and_power_limit)
    except ImportError as e:
        print(f"chip_smoke: not in a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform})",
              file=sys.stderr)
        return 2
    configure_compile_cache()
    jax.config.update("jax_enable_x64", True)
    ctx = {"gpu": gpu_name_and_power_limit(), "multichip": args.multichip}
    failed = []
    for name in select_phases(args.multichip):
        print(f"== phase {name}", flush=True)
        t0 = time.time()
        try:
            PHASES[name](ctx)
        except Exception:   # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        print(f"== phase {name}: {'FAILED' if name in failed else 'ok'} "
              f"({time.time() - t0:.1f} s)", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
