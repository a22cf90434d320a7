"""Relaxation / Chebyshev smoothers with deterministic power-iteration
eigenvalue estimation (deal.II PreconditionRelaxation / PreconditionChebyshev
semantics as configured by the reference GMG, stmg.h:1199-1238).

Estimation (deal.II internal::estimate_eigenvalues, power_iteration path):
  * initial guess per block: v_i = i mod 11, minus the block mean, zeroed on
    constrained dofs (deal.II internal::set_initial_guess for distributed
    vectors; dof ORDER differs from deal.II's so estimates agree only
    statistically -- documented deviation)
  * 20 power iterations on P*A; estimate = <v, P A v> with ||v|| = 1
  * max_eig = 1.2 * estimate (safety factor), min_eig = estimate
  * alpha = max_eig / smoothing_range if range > 1
            else min(0.9 * max_eig, min_eig)
  * relaxation omega = 2 / (alpha + max_eig)
  * Chebyshev interval: theta = (max_eig + alpha)/2, delta = (max_eig-alpha)/2
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def initial_guess(shape_blocks, mask, dtype) -> jnp.ndarray:
    """[n_blocks, *dofshape] deterministic high-frequency start vector."""
    n_blocks = shape_blocks[0]
    n = int(np.prod(shape_blocks[1:]))
    v = (np.arange(n) % 11).astype(np.float64)
    v = np.tile(v[None, :], (n_blocks, 1)).reshape(shape_blocks)
    v = v * np.asarray(mask)[None]
    v = v - v.mean(axis=tuple(range(1, len(shape_blocks))), keepdims=True)
    v = v * np.asarray(mask)[None]
    return jnp.asarray(v, dtype)


import functools


@functools.partial(jax.jit, static_argnums=(3,))
def _power_jit(matrix, precond, v0, n_iterations):
    def body(_, carry):
        v, lam = carry
        # bf16 level operators return bf16; the estimate arithmetic stays
        # in the probe dtype
        w = precond.vmult(matrix.vmult(v)).astype(v.dtype)
        lam = jnp.vdot(v.reshape(-1), w.reshape(-1))
        v = w / jnp.linalg.norm(w.reshape(-1))
        return v, lam

    v = v0 / jnp.linalg.norm(v0.reshape(-1))
    _, lam = jax.lax.fori_loop(0, n_iterations, body,
                               (v, jnp.zeros((), v.dtype)))
    return lam


def power_estimate(matrix, precond, v0: jnp.ndarray,
                   n_iterations: int = 20) -> float:
    """deal.II internal::power_iteration: returns <v,(PA)v> after n its.
    matrix/precond are pytree modules with .vmult (arrays travel as jit
    arguments, keeping the compiled payload small)."""
    return float(_power_jit(matrix, precond, v0, n_iterations))


@dataclass
class EigInfo:
    min_eigenvalue: float
    max_eigenvalue: float


def arnoldi_lambda_max(matrix, precond, shape_blocks, mask, dtype,
                       tol: float = 1e-5, ncv: int = 24) -> float | None:
    """CONVERGED largest |eigenvalue| of P A via implicitly-restarted
    Arnoldi (scipy.sparse.linalg.eigs) with the deterministic start vector.

    Unlike the 20-step power iteration, the converged top eigenvalue is
    independent of the dof ORDER of the start vector -- the round-2 verdict's
    parity blocker (lexicographic here vs deal.II's hierarchical numbering
    made estimates differ by several %% and iteration counts by +-2).
    Measured on the tf01 golden ladder: exact lambda_max with safety factor
    1.0 reproduces the reference's FGMRES counts to +-1 (7/8 vs goldens
    7/9), where the shipped power estimate gave 9/9.

    Returns None if ARPACK fails to converge (caller falls back to the
    power iteration).
    """
    import scipy.sparse.linalg as spla

    n = int(np.prod(shape_blocks))
    v0 = np.asarray(initial_guess(shape_blocks, mask, jnp.float32)
                    ).reshape(-1).astype(np.float64)
    if not np.any(v0):
        return None

    @jax.jit
    def apply(v):
        w = precond.vmult(matrix.vmult(v.reshape(shape_blocks)))
        return w.reshape(-1).astype(jnp.float32)

    def matvec(v):
        return np.asarray(apply(jnp.asarray(v, jnp.float32)), np.float64)

    op = spla.LinearOperator((n, n), matvec=matvec, dtype=np.float64)
    try:
        w = spla.eigs(op, k=1, which="LM", v0=v0, ncv=min(ncv, n - 1),
                      maxiter=300, tol=tol, return_eigenvectors=False)
        lam = float(np.max(np.abs(w)))
        return lam if np.isfinite(lam) and lam > 0 else None
    except Exception:
        return None


def estimate_eigenvalues(matrix, precond, shape_blocks, mask, dtype,
                         n_iterations: int = 20,
                         safety_factor: float = 1.2,
                         device=None, method: str = "power") -> EigInfo:
    """method="power": deal.II's estimate_eigenvalues semantics -- 20-step
    power iteration, min = raw estimate, max = 1.2 * estimate.
    method="arnoldi": CONVERGED (order-invariant) lambda_max with NO safety
    factor (min = max = lambda_max; the relaxation formula then gives
    omega = 2 / (1.9 lambda_max), matching the reference's effective omega
    because deal.II's power estimate UNDERSHOOTS the true lambda_max by
    about the 1.2 factor -- measured, scripts/eig_parity_lab.py).
    device: optional explicit device for the jitted power iteration (pass
    the accelerator during host-pinned setup -- the caller must have
    device_put matrix/precond there already)."""
    if method == "arnoldi":
        lam = arnoldi_lambda_max(matrix, precond, shape_blocks, mask, dtype)
        if lam is not None:
            return EigInfo(min_eigenvalue=lam, max_eigenvalue=lam)
    v0 = initial_guess(shape_blocks, mask, dtype)
    if device is not None:
        v0 = jax.device_put(v0, device)
    est = power_estimate(matrix, precond, v0, n_iterations)
    return EigInfo(min_eigenvalue=est, max_eigenvalue=safety_factor * est)


def relaxation_parameters(info: EigInfo, smoothing_range: float) -> float:
    alpha = (info.max_eigenvalue / smoothing_range if smoothing_range > 1.0
             else min(0.9 * info.max_eigenvalue, info.min_eigenvalue))
    return 2.0 / (alpha + info.max_eigenvalue)


def chebyshev_parameters(info: EigInfo,
                         smoothing_range: float) -> tuple[float, float]:
    alpha = (info.max_eigenvalue / smoothing_range if smoothing_range > 1.0
             else min(0.9 * info.max_eigenvalue, info.min_eigenvalue))
    theta = (info.max_eigenvalue + alpha) / 2.0
    delta = (info.max_eigenvalue - alpha) / 2.0
    return theta, delta


from ..utils.module import register_module


@register_module
class RelaxationSmoother:
    """x = 0; n_iterations of x += omega P (b - A x)
    (deal.II PreconditionRelaxation.vmult).

    Holds the matrix/preconditioner MODULES (not bound methods) so the
    smoother participates in pytree flattening and its arrays travel as jit
    arguments.
    """

    def __init__(self, matrix, precond, omega: float, n_iterations: int = 1):
        self.matrix = matrix
        self.precond = precond
        self.omega = omega
        self.n_iterations = n_iterations

    def vmult(self, b: jnp.ndarray,
              n_iterations: int | None = None) -> jnp.ndarray:
        n = self.n_iterations if n_iterations is None else n_iterations
        x = self.omega * self.precond.vmult(b)
        for _ in range(n - 1):
            x = x + self.omega * self.precond.vmult(b - self.matrix.vmult(x))
        return x


@register_module
class ChebyshevSmoother:
    """deal.II PreconditionChebyshev.vmult (first-kind polynomial), zero
    initial guess, `degree` preconditioner applications."""

    def __init__(self, matrix, precond, theta: float, delta: float,
                 degree: int = 1):
        self.matrix = matrix
        self.precond = precond
        self.theta = theta
        self.delta = delta
        self.degree = degree

    def vmult(self, b: jnp.ndarray) -> jnp.ndarray:
        x = self.precond.vmult(b) * (1.0 / self.theta)
        if self.degree == 1:
            return x
        x_old = jnp.zeros_like(x)
        rhok = self.delta / self.theta
        sigma = 2.0 * self.theta / self.delta
        for _ in range(1, self.degree):
            rho_new = 1.0 / (sigma - rhok)
            factor1 = rho_new * rhok
            factor2 = 2.0 * rho_new / self.delta
            rhok = rho_new
            r = b - self.matrix.vmult(x)
            x_new = x + factor1 * (x - x_old) + factor2 * self.precond.vmult(r)
            x_old, x = x, x_new
        return x


@register_module
class IdentitySmoother:
    def __init__(self):
        pass

    def vmult(self, b: jnp.ndarray) -> jnp.ndarray:
        return b
