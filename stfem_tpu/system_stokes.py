"""Space-time Stokes slab system on the flat [T, n_u+n_p] layout.

Equivalent of the reference's SystemMatrixStokes::tensorproduct_eval
(include/operators.h:819-867): the Stokes operator is applied once per time
position, the tiny scalar time tables mix over the time axis:
  dst_u[t'] = sum_t a[t',t] S_u(x[t]) + b[t',t] M u[t]
  dst_p[t'] = sum_t a[t',t] S_p(x[t])
and the RHS slice coupling uses the Gamma/Zeta columns (CGP also couples the
pressure row through Gamma; DG does not -- matching
get_fe_time_weights_stokes' structure).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .ops.spatial import LaplaceMassOperator
from .ops.stokes import StokesOperator
from .types import TimeStepType
from .utils.module import register_module


@register_module
class StokesSystemMatrix:
    def __init__(self, stokes_op: StokesOperator,
                 mass_op: LaplaceMassOperator,
                 a: np.ndarray, b: np.ndarray,
                 gamma: np.ndarray | None = None,
                 zeta: np.ndarray | None = None,
                 type_: TimeStepType = TimeStepType.DG,
                 precision: str | None = "highest"):
        """a, b: (T, T) scalar time tables (Alpha/Beta of the scalar system);
        gamma/zeta: (T, 1) RHS columns for vmult_slice.

        precision: matmul precision for the apply (see SystemMatrix -- the
        OUTER operator needs true-f32 products; preconditioner level
        operators pass None)."""
        self.precision = precision
        self.S = stokes_op
        self.M = mass_op
        self.dtype = stokes_op.dtype
        self.a = jnp.asarray(np.asarray(a), self.dtype)
        self.b = jnp.asarray(np.asarray(b), self.dtype)
        self.gamma = None if gamma is None else jnp.asarray(
            np.asarray(gamma), self.dtype)
        self.zeta = None if zeta is None else jnp.asarray(
            np.asarray(zeta), self.dtype)
        # static zero-structure flags (decided at build time, not traced)
        self.gamma_nonzero = gamma is not None and bool(
            np.any(np.asarray(gamma) != 0.0))
        self.zeta_nonzero = zeta is not None and bool(
            np.any(np.asarray(zeta) != 0.0))
        self.type_ = type_
        self.T = self.a.shape[0]
        self.n_flat = stokes_op.n_u + stokes_op.n_p

    def vmult(self, x: jnp.ndarray, u_lin: jnp.ndarray | None = None,
              mode: str = "none", mask_input: bool = True) -> jnp.ndarray:
        """x: [T, n_u + n_p].  For Navier-Stokes pass u_lin ([T, dim, *grid])
        and mode "jacobian"/"form" (reference SystemMatrixStokes
        set_linearization_data + OperatorMode, operators.h:471-500).
        mask_input=False reads eliminated u dofs (strong-Dirichlet lift)."""
        import jax

        if self.precision is not None:
            with jax.default_matmul_precision(self.precision):
                return self._vmult_impl(x, u_lin, mode, mask_input)
        return self._vmult_impl(x, u_lin, mode, mask_input)

    def _vmult_impl(self, x, u_lin, mode, mask_input=True):
        S = self.S
        u, p = S.unpack(x)
        ru, rp = S.apply(u, p, mode=mode, u_lin=u_lin, mask_input=mask_input)
        # batched over [T, dim] leading axes
        Mu = self.M.apply(u * 1.0, mask_input=mask_input)
        dst_u = (jnp.einsum("ji,i...->j...", self.a, ru)
                 + jnp.einsum("ji,i...->j...", self.b, Mu))
        dst_p = jnp.einsum("ji,i...->j...", self.a, rp)
        return S.pack(dst_u, dst_p)

    def vmult_slice(self, prev_u: jnp.ndarray, prev_p: jnp.ndarray,
                    mask_input: bool = True) -> jnp.ndarray:
        """RHS coupling to the previous step value (reference
        SystemMatrixStokes::vmult_slice_add, operators.h:748-782).

        gamma couples the Stokes operator (CGP only; also drives the p row),
        zeta couples the velocity mass (CGP: Zeta; DG: the jump column which
        the scalar tables store in the Gamma slot).

        Runs under the same matmul-precision guard as vmult: a
        reduced-precision default matmul puts a ~1e-4 relative error into the
        rhs, which silently floors the WHOLE slab solve at 1e-4 true
        residual on every slab with a nonzero previous value (root-caused
        round 5: the f32 outer converges on the polluted rhs while the ff
        true residual reads the 1.55e-4 rhs mismatch).
        """
        import jax

        if self.precision is not None:
            with jax.default_matmul_precision(self.precision):
                return self._vmult_slice_impl(prev_u, prev_p, mask_input)
        return self._vmult_slice_impl(prev_u, prev_p, mask_input)

    def _vmult_slice_impl(self, prev_u: jnp.ndarray, prev_p: jnp.ndarray,
                          mask_input: bool = True) -> jnp.ndarray:
        S = self.S
        T = self.T
        dst_u = jnp.zeros((T, S.dim) + tuple(S.dof_shape_u), self.dtype)
        dst_p = jnp.zeros((T,) + tuple(S.p_shape), self.dtype)
        if self.gamma_nonzero:
            ru, rp = S.apply(prev_u[None], prev_p[None],
                             mask_input=mask_input)
            gu = self.gamma[:, 0].reshape((T,) + (1,) * (ru.ndim - 1))
            dst_u = dst_u + gu * ru
            gp = self.gamma[:, 0].reshape((T,) + (1,) * (rp.ndim - 1))
            dst_p = dst_p + gp * rp
        if self.zeta_nonzero:
            Mu = self.M.apply(prev_u[None], mask_input=mask_input)
            zu = self.zeta[:, 0].reshape((T,) + (1,) * (Mu.ndim - 1))
            dst_u = dst_u + zu * Mu
        return S.pack(dst_u, dst_p)
