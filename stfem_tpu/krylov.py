"""Jittable Krylov solvers: flexible GMRES (outer solver) and fixed-iteration
left-preconditioned GMRES (coarse-grid solver).

Mirrors the reference's solver semantics (deal.II SolverFGMRES with
ReductionControl(200, abstol, reltol), include/time_integrators.h:56-59):
convergence when ||r|| < max(abstol, reltol * ||r0||), checked on the Givens
residual estimate each iteration; iteration count returned.

Design for XLA: fixed-size Krylov basis arrays + lax.while_loop; dynamic
"loop over previous vectors" is replaced by full-basis matmuls against
zero-initialized rows (mathematically identical, matmul-shaped).  The
preconditioner is an arbitrary traceable callable (here: the full STMG
V-cycle), compiled into the same program.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class FGMRESResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray      # int32
    residual: jnp.ndarray        # final residual estimate
    converged: jnp.ndarray       # bool


def _vdot(a, b):
    return jnp.vdot(a.reshape(-1), b.reshape(-1))


def _norm(a):
    return jnp.sqrt(jnp.real(_vdot(a, a)))


def fgmres(A: Callable, b: jnp.ndarray, x0: jnp.ndarray,
           precondition: Callable | None = None, maxiter: int = 100,
           abstol: float = 1e-12, reltol: float = 1e-12,
           reorthogonalize: bool | str = True,
           basis_dtype=None, flexible: bool = True) -> FGMRESResult:
    """Flexible GMRES without restarting (basis size == maxiter; the
    reference uses basis 100 with <=200 iterations but its configured solves
    converge well within one cycle).

    reorthogonalize=False drops the second Gram-Schmidt pass: halves the
    basis HBM traffic per iteration (the dominant outer-solver cost once
    the V-cycle is fast); fine whenever the preconditioner keeps the
    iteration count well below the basis size.  "selective" applies the
    DGKS criterion: the second pass runs (lax.cond, so it only executes
    when taken) iff pass one cancelled most of w's mass
    (||w_after|| < eta ||w_before||, eta = 1/sqrt(2)) -- the standard
    robust middle ground, and the measured common case skips it.

    NOTE a recursive-Gram low-synch CGS2 ("one sweep + m x m correction")
    was implemented and REJECTED by measurement: the recursion predicts
    V w2 from pre-rounding algebra, so it cannot see the rounding-level
    orthogonality defects that reorthogonalization exists to fix -- at
    kappa 1e10 it stalls exactly like single-pass CGS while true CGS2
    converges (measured on diag(logspace(0,10)) rotated + noise).

    basis_dtype (e.g. jnp.bfloat16) stores the ORTHONORMAL basis V at
    reduced precision (Gram-Schmidt arithmetic stays f32 through type
    promotion); the solution directions Z stay in the working dtype so the
    returned x is full-precision.  Halves the dominant HBM traffic.

    flexible=False switches to RIGHT-preconditioned GMRES: the Z basis is
    never stored and the solution is reconstructed as x = x0 + M(V y) with
    ONE extra preconditioner application after convergence.  Valid ONLY
    when the preconditioner is a fixed LINEAR operator -- true for the
    STMG V-cycle as configured here (fixed-step relaxation/Chebyshev
    smoothers, direct or fixed-iteration coarse solve), in which case the
    iterates are identical to FGMRES in exact arithmetic.  Halves the
    Krylov HBM footprint (V only), enabling 32^3-scale slabs."""
    if precondition is None:
        precondition = lambda v: v
    dtype = b.dtype
    shape = b.shape
    n = b.size
    m = maxiter

    r0 = b - A(x0)
    beta = _norm(r0)
    tol = jnp.maximum(abstol, reltol * beta)

    vdtype = basis_dtype or dtype
    # Gram-Schmidt basis-read strategy.  The chunked prefix loop reads only
    # the filled rows 0..j, but each lax.dynamic_slice MATERIALIZES its
    # (CH, n) chunk -- a read+write copy of CH basis vectors per chunk per
    # pass (measured: the model "copy + matmul-read per chunk" reproduces
    # the per-iteration glue cost exactly at 16^3).  A full-basis matmul
    # reads all m_pad rows ONCE with no copy, so it wins whenever
    # m_pad <= ~2x the average active prefix -- i.e. for the short bases
    # the preconditioned solves actually use.  STFEM_GS_CHUNK=0 forces
    # full-basis; the default auto-picks full for m <= 16.
    _CH = int(os.environ.get("STFEM_GS_CHUNK", "8" if m > 16 else "0"))
    full_gs = _CH <= 0
    if full_gs:
        _CH = 8
    m_pad = ((m + 1 + _CH - 1) // _CH) * _CH
    V = jnp.zeros((m_pad, n), vdtype)
    Z = jnp.zeros((m if flexible else 1, n), dtype)
    H = jnp.zeros((m + 1, m), dtype)   # Givens-rotated (upper triangular) R
    cs = jnp.zeros(m, dtype)
    sn = jnp.zeros(m, dtype)
    g = jnp.zeros(m + 1, dtype)
    g = g.at[0].set(beta)
    # the new basis row rides the carry as `vnext` and is inserted at the
    # START of the next iteration, BEFORE any read of V: a read-then-write
    # of the carried basis forces XLA to copy the whole (m_pad, n) buffer
    # every iteration; write-before-read updates stay in place, and the
    # pending row doubles as the V[j] read
    vnext = jnp.where(beta > 0,
                      (r0 / jnp.where(beta == 0, 1, beta)).reshape(-1), 0)
    def cond(state):
        j, V, Z, H, cs, sn, g, res, vnext = state
        return (j < m) & (res > tol)

    def body(state):
        j, V, Z, H, cs, sn, g, res, vnext = state
        V = jax.lax.dynamic_update_slice_in_dim(
            V, vnext.astype(vdtype)[None], j, 0)
        v = vnext.astype(dtype).reshape(shape)
        z = precondition(v)
        w = A(z).reshape(-1)
        if flexible:
            Z = Z.at[j].set(z.reshape(-1))

        # classical Gram-Schmidt (+ optional reorthogonalization); rows > j
        # of V are zero so restricting the contraction to the CHUNKS that
        # cover rows 0..j is exact -- and reads only the filled prefix of
        # the basis instead of all m+1 rows (basis traffic is the dominant
        # outer-solver cost at 16^3+: 105 MB/vector).  True-f32 products
        # (accelerator f32 matmuls default to reduced-precision passes --
        # TF32 on the GPU -- which breaks the
        # orthogonality the residual estimate relies on)
        CH = _CH
        n_active = j // CH + 1

        if full_gs:
            # rows > j are zero, so the full contraction is exact; no
            # dynamic slices -> no chunk copies
            def gs_dots(w):
                return V @ w

            def gs_proj(w, h):
                return w - V.T @ h
        else:
            def gs_dots(w):
                def hc_body(c, h):
                    blk = jax.lax.dynamic_slice_in_dim(V, c * CH, CH, 0)
                    return jax.lax.dynamic_update_slice_in_dim(
                        h, blk @ w, c * CH, 0)
                return jax.lax.fori_loop(0, n_active, hc_body,
                                         jnp.zeros(V.shape[0], dtype))

            def gs_proj(w, h):
                def proj_body(c, wv):
                    blk = jax.lax.dynamic_slice_in_dim(V, c * CH, CH, 0)
                    hc = jax.lax.dynamic_slice_in_dim(h, c * CH, CH, 0)
                    return wv - blk.T @ hc
                return jax.lax.fori_loop(0, n_active, proj_body, w)

        def gs_pass(w):
            h = gs_dots(w)
            return h, gs_proj(w, h)

        with jax.default_matmul_precision("highest"):
            if reorthogonalize == "selective":
                wnorm_pre = jnp.linalg.norm(w)
                h1, w = gs_pass(w)
                need = jnp.linalg.norm(w) < 0.7071 * wnorm_pre
                hf, w = jax.lax.cond(
                    need,
                    lambda hw: ((lambda h2w: (hw[0] + h2w[0], h2w[1]))
                                (gs_pass(hw[1]))),
                    lambda hw: hw, (h1, w))
                h = hf[: m + 1]
                wnorm = jnp.linalg.norm(w)
            elif reorthogonalize:
                h1, w = gs_pass(w)
                h2, w = gs_pass(w)
                h = (h1 + h2)[: m + 1]
                wnorm = jnp.linalg.norm(w)
            else:
                h1, w = gs_pass(w)
                h = h1[: m + 1]
                wnorm = jnp.linalg.norm(w)
        h = h.at[j + 1].add(wnorm)
        vnext = jnp.where(wnorm > 0, w / jnp.where(wnorm == 0, 1, wnorm), 0)

        # apply the existing Givens rotations to the new column.  The chain
        #   h'[i]   = cs[i] c[i] + sn[i] h[i+1]        (i < j)
        #   c[i+1]  = -sn[i] c[i] + cs[i] h[i+1],  c[0] = h[0]
        # is a first-order affine recurrence in the carried value c --
        # evaluated as an associative scan (log2(m) tiny ops) instead of the
        # m sequential fori_loop trips, each a dependent launch.  Rotations i >= j compose as identity
        # (a=1, b=0), so c saturates at c[j] and the scan length is static.
        idx_m = jnp.arange(m)
        act = idx_m < j
        a_seq = jnp.where(act, -sn, jnp.ones((), dtype))
        b_seq = jnp.where(act, cs * h[1: m + 1], jnp.zeros((), dtype))

        def _affine_compose(x, y):
            a1, b1 = x
            a2, b2 = y
            return a1 * a2, a2 * b1 + b2

        cumA, cumB = jax.lax.associative_scan(_affine_compose,
                                              (a_seq, b_seq))
        c_carry = jnp.concatenate([h[:1], cumA * h[0] + cumB])  # len m+1
        idx = jnp.arange(m + 1)
        cs1 = jnp.concatenate([cs, jnp.ones((1,), dtype)])
        sn1 = jnp.concatenate([sn, jnp.zeros((1,), dtype)])
        h_shift = jnp.concatenate([h[1: m + 1], jnp.zeros((1,), dtype)])
        h = jnp.where(idx < j, cs1 * c_carry + sn1 * h_shift,
                      jnp.where(idx == j, c_carry, h[: m + 1]))

        # new rotation zeroing h[j+1]
        denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
        c_new = jnp.where(denom > 0, h[j] / jnp.where(denom == 0, 1, denom), 1.0)
        s_new = jnp.where(denom > 0, h[j + 1] / jnp.where(denom == 0, 1, denom), 0.0)
        cs = cs.at[j].set(c_new)
        sn = sn.at[j].set(s_new)
        h = h.at[j].set(denom)
        h = h.at[j + 1].set(0.0)
        H = H.at[:, j].set(h[: m + 1])

        g_j = g[j]
        g = g.at[j].set(c_new * g_j)
        g = g.at[j + 1].set(-s_new * g_j)
        res = jnp.abs(g[j + 1])
        return j + 1, V, Z, H, cs, sn, g, res, vnext

    state = (jnp.asarray(0, jnp.int32), V, Z, H, cs, sn, g, beta, vnext)
    j, V, Z, H, cs, sn, g, res, _ = jax.lax.while_loop(cond, body, state)

    # solve the (padded) triangular system: unused rows get identity
    mask = jnp.arange(m) < j
    R = H[:m, :m]
    R = jnp.where(jnp.logical_and(mask[None, :], mask[:, None]), R,
                  jnp.eye(m, dtype=dtype))
    rhs = jnp.where(mask, g[:m], 0.0)
    y = jax.scipy.linalg.solve_triangular(R, rhs, lower=False)
    with jax.default_matmul_precision("highest"):
        if flexible:
            x = x0 + (Z.T @ y).reshape(shape)
        else:
            vy = (V[:m].astype(dtype).T @ y).reshape(shape)
            x = x0 + precondition(vy)
    return FGMRESResult(x=x, iterations=j, residual=res, converged=res <= tol)


def richardson_solve(A: Callable, b: jnp.ndarray, x0: jnp.ndarray,
                     precondition: Callable, omega: float = 1.0,
                     maxiter: int = 100, abstol: float = 1e-30,
                     reltol: float = 1e-8) -> FGMRESResult:
    """Preconditioned Richardson iteration x += omega * P(b - A x) with a
    per-step TRUE-residual convergence check (the residual is computed for
    the update anyway, so the check costs one norm reduction).

    Rationale: the outer FGMRES's Krylov glue (basis memory traffic,
    Gram-Schmidt, Givens) is a large share of each iteration at 16^3, while
    Richardson's step is just matvec + V-cycle; whenever the V-cycle error
    propagator's spectral radius rho is below ~0.5 the glue-free iteration
    wins wall-clock despite needing more steps.  Residual semantics match
    deal.II ReductionControl: stop at ||r|| <= max(abstol, reltol*||r0||)."""
    r0 = b - A(x0)
    beta = _norm(r0)
    tol = jnp.maximum(abstol, reltol * beta)

    def cond(state):
        j, x, r, res = state
        return (j < maxiter) & (res > tol)

    def body(state):
        j, x, r, res = state
        x = x + omega * precondition(r)
        r = b - A(x)
        return j + 1, x, r, _norm(r)

    j, x, r, res = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), x0, r0, beta))
    return FGMRESResult(x=x, iterations=j, residual=res / jnp.where(
        beta == 0, 1, beta), converged=res <= tol)


def chebyshev_solve(A: Callable, b: jnp.ndarray, x0: jnp.ndarray,
                    precondition: Callable, lambda_min: float,
                    lambda_max: float, maxiter: int = 100,
                    abstol: float = 1e-30,
                    reltol: float = 1e-8) -> FGMRESResult:
    """Chebyshev-accelerated preconditioned iteration for spec(P A) within
    [lambda_min, lambda_max] (real, positive — the STMG-preconditioned
    operator's eigenvalues cluster in [1 - rho, 1]; estimate rho with
    `estimate_error_propagator_radius`).  Same step cost as Richardson
    (matvec + V-cycle + axpys, no Krylov basis) but the error bound improves
    from rho to ~rho / (1 + sqrt(1 - rho^2)) per step.  True-residual
    convergence check each step; deal.II-style first-kind recurrence
    (PreconditionChebyshev), generalized to a nonzero initial guess by
    iterating on the correction."""
    theta = (lambda_max + lambda_min) / 2.0
    delta = jnp.maximum((lambda_max - lambda_min) / 2.0, 1e-30)
    r0 = b - A(x0)
    beta = _norm(r0)
    tol = jnp.maximum(abstol, reltol * beta)

    # first step: e_1 = P r0 / theta
    e = precondition(r0) * (1.0 / theta)
    x = x0 + e
    r = b - A(x)
    res = _norm(r)

    def cond(state):
        j, x, e, r, res, rhok = state
        return (j < maxiter) & (res > tol)

    def body(state):
        # e carries the PREVIOUS increment (deal.II's `update` vector):
        # e_{k+1} = rho_{k+1} rho_k e_k + (2 rho_{k+1}/delta) P r_k
        j, x, e, r, res, rhok = state
        sigma = 2.0 * theta / delta
        rho_new = 1.0 / (sigma - rhok)
        factor1 = rho_new * rhok
        factor2 = 2.0 * rho_new / delta
        e_new = factor1 * e + factor2 * precondition(r)
        x = x + e_new
        r = b - A(x)
        return (j + 1, x, e_new, r, _norm(r), rho_new)

    state = (jnp.asarray(1, jnp.int32), x, e, r, res,
             jnp.asarray(delta / theta, b.dtype))
    j, x, _, r, res, _ = jax.lax.while_loop(cond, body, state)
    return FGMRESResult(x=x, iterations=j, residual=res / jnp.where(
        beta == 0, 1, beta), converged=res <= tol)


def estimate_error_propagator_radius(A: Callable, precondition: Callable,
                                     v0: jnp.ndarray,
                                     n_iterations: int = 15) -> float:
    """Spectral-radius estimate of E = I - P A (the preconditioned error
    propagator) by power iteration: rho(E) bounds the Richardson contraction
    and gives the Chebyshev interval [1 - rho, 1 + rho] for spec(P A)."""
    def body(_, carry):
        v, lam = carry
        w = v - precondition(A(v))
        lam = jnp.abs(_vdot(v, w))
        return w / _norm(w), lam

    v = v0 / _norm(v0)
    _, lam = jax.lax.fori_loop(0, n_iterations, body,
                               (v, jnp.zeros((), v0.dtype)))
    return lam


def gmres_fixed_left(A: Callable, b: jnp.ndarray, precondition: Callable,
                     n_iter: int) -> jnp.ndarray:
    """Left-preconditioned GMRES with exactly n_iter iterations, zero initial
    guess (the reference's coarse-grid solver: deal.II SolverGMRES with
    IterationNumberControl(maxiter=10, abstol=1e-20), stmg.h:1240-1302)."""
    shape = b.shape
    dtype = b.dtype
    m = n_iter
    pb = precondition(b).reshape(-1)
    beta = jnp.linalg.norm(pb)
    V = jnp.zeros((m + 1, b.size), dtype)
    V = V.at[0].set(jnp.where(beta > 0, pb / jnp.where(beta == 0, 1, beta), 0))
    Hc = jnp.zeros((m + 1, m), dtype)

    def body(j, carry):
        V, Hc = carry
        w = precondition(A(V[j].reshape(shape))).reshape(-1)
        h1 = V @ w
        w = w - V.T @ h1
        h2 = V @ w
        w = w - V.T @ h2
        h = h1 + h2
        wnorm = jnp.linalg.norm(w)
        h = h.at[j + 1].add(wnorm)
        V = V.at[j + 1].set(jnp.where(wnorm > 0, w / jnp.where(
            wnorm == 0, 1, wnorm), 0))
        Hc = Hc.at[:, j].set(h)
        return V, Hc

    V, Hc = jax.lax.fori_loop(0, m, body, (V, Hc))
    # least squares min || beta e1 - H y ||.
    # NOTE: on near-singular saddle-point systems this fixed-iteration
    # solve amplifies near-null directions by O(1/sigma) (measured
    # lambda(PA) ~ -1.3e6 on the tf01stokes coarse level) and an lstsq
    # rcond does NOT help (the offending sigmas sit above any safe
    # cutoff) -- Stokes coarse solves route to the assembled
    # pseudo-inverse instead (build_stmg_stokes; stokes_spectrum_lab.py).
    e1 = jnp.zeros(m + 1, dtype).at[0].set(beta)
    y, *_ = jnp.linalg.lstsq(Hc, e1)
    return (V[:m].T @ y).reshape(shape)
