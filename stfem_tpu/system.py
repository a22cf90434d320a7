"""Space-time slab system operator: (Alpha (x) K + Beta (x) M) x.

Design: the block vector is one dense array [n_blocks, *dofshape].
Instead of looping spatial applies per block (reference SystemMatrix::vmult,
include/operators.h:536-559), the whole batch flows through ONE fused
gather -> evaluate -> quadrature -> integrate -> scatter pass, with the tiny
Alpha/Beta mixing matrices applied AT THE QUADRATURE LEVEL as matmuls over the
block axis -- so the slab operator costs one spatial sweep, not two, and the
block-mixing is one dense matmul.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ops.spatial import LaplaceMassOperator, cell_gather, cell_scatter, _sumfac
from .utils.module import register_module


@register_module
class SystemMatrix:
    """dst = (Alpha (x) K + Beta (x) M) src for a mass operator M and
    stiffness-type operator K sharing one mesh/degree/quadrature.

    K_op must be the laplace operator (laplace_scaling=1, mass_scaling=0),
    M_op the mass operator (1, 0); their coefficient tables are honored.
    Alpha/Beta may be (n_blocks, n_blocks) for the LHS or (n_blocks, 1)
    columns for the previous-slab RHS coupling (vmult_slice).
    """

    def __init__(self, K_op: LaplaceMassOperator, M_op: LaplaceMassOperator,
                 Alpha, Beta, precision: str | None = "highest"):
        """precision: matmul precision for the apply.  Accelerator f32
        matmuls default to reduced-precision passes (TF32 on the GPU); an
        OUTER Krylov operator needs true-f32 products or the Arnoldi
        residual estimate silently drifts from the true residual (a
        reduced-precision A once gave estimate 1e-8 vs TRUE residual 2e-1
        at the bench config).  Preconditioner-internal level operators
        pass precision=None to keep the fast default -- flexible GMRES
        tolerates an inexact preconditioner but not an inexact A."""
        import os

        assert K_op.mesh is M_op.mesh and K_op.degree == M_op.degree
        self.K = K_op
        self.M = M_op
        if precision is not None:
            precision = os.environ.get("STFEM_OUTER_PRECISION", precision)
        self.precision = precision
        self.dtype = K_op.dtype
        self.Alpha = jnp.asarray(np.asarray(Alpha), self.dtype)
        self.Beta = jnp.asarray(np.asarray(Beta), self.dtype)
        self.alpha_is_zero = bool(np.all(np.asarray(Alpha) == 0.0))
        self.beta_is_zero = bool(np.all(np.asarray(Beta) == 0.0))
        self.n_blocks = self.Alpha.shape[0]

        # Previous-slab coupling columns (Gamma/Zeta) only feed the FIRST
        # step's rows in a multi-step slab; restrict the slice apply to the
        # nonzero rows instead of integrating n_blocks mostly-zero outputs
        # (reference alpha_is_zero/beta_is_zero shortcut per entry,
        # operators.h:585-611).
        self._slice_reduced = None
        self._slice_nz = None
        A_np, B_np = np.asarray(Alpha), np.asarray(Beta)
        if A_np.ndim == 2 and A_np.shape[1] == 1:
            nz = np.where((np.abs(A_np) + np.abs(B_np)).sum(1) != 0.0)[0]
            if 0 < len(nz) <= self.n_blocks // 2:
                self._slice_nz = tuple(int(i) for i in nz)
                self._slice_reduced = SystemMatrix(
                    K_op, M_op, A_np[nz], B_np[nz],
                    precision="highest" if precision is not None else None)

        # Zero INPUT columns (step-coupling blocks: the DG jump reads only
        # the previous step's LAST time-dof, CGP only its last trial dof —
        # A1/B1 have one nonzero column of nt): slice the input blocks
        # before the spatial pair instead of sweeping blocks that cannot
        # contribute.  This is the column analogue of the reference's
        # alpha_is_zero/beta_is_zero entry shortcut (operators.h:585-611).
        self._col_reduced = None
        self._col_nz = None
        if A_np.ndim == 2 and A_np.shape[1] > 1:
            colnz = np.where((np.abs(A_np) + np.abs(B_np)).sum(0) != 0.0)[0]
            if 0 < len(colnz) <= A_np.shape[1] // 2:
                self._col_nz = tuple(int(i) for i in colnz)
                self._col_reduced = SystemMatrix(
                    K_op, M_op, A_np[:, colnz], B_np[:, colnz],
                    precision=precision)

        # Diagonal-geometry middles, fastest first (mapped meshes use the
        # cell-local XLA path):
        #  1. Kronecker-assembled 1D factors (ops/kronfac.py): 3*dim-1
        #     DOF-sized per-axis matmuls, no quadrature grid at all --
        #     ~7x less memory traffic than (2) at Q4/16^3 (counted from
        #     the shapes)
        #  2. gather-free grid sum-factorization (ops/gridsumfac.py):
        #     per-axis global banded matmuls, no cell gather/scatter
        #     (needed when a coefficient field or cell mask breaks the
        #     Kronecker separability)
        #  3. full-cell-basis quad middle (STFEM_GRID_SUMFAC=0 fallback)
        self._kron = None
        if (os.environ.get("STFEM_KRON_MATVEC", "1") != "0"):
            from .ops.kronfac import KronAssembled
            if KronAssembled.supports(K_op, M_op):
                self._kron = KronAssembled(K_op, M_op, self.dtype)
        self._grid = None
        if (K_op.jinv is None and self._kron is None
                and os.environ.get("STFEM_GRID_SUMFAC") != "0"):
            from .ops.gridsumfac import GridSumFac
            self._grid = GridSumFac(K_op, M_op, self.dtype)
        self._phig = None
        self._w = None
        if self._grid is None and self._kron is None and K_op.jinv is None:
            dim, k = K_op.dim, K_op.degree
            cells = K_op.cells
            C = int(np.prod(cells))
            Q = K_op.n_q ** dim
            qshape = (K_op.n_q,) * dim
            Phi, Grad = K_op._basis_tensors()
            PhiG = np.concatenate([Phi] + [Grad[e] for e in range(dim)],
                                  axis=1)
            wM = np.asarray(M_op.jxw)
            if M_op.coeff is not None:
                wM = wM * np.asarray(M_op.coeff)
            wK = np.asarray(K_op.jxw)
            if K_op.coeff is not None:
                wK = wK * np.asarray(K_op.coeff)
            parts = [np.broadcast_to(wM, cells + qshape).reshape(C, Q)]
            for e in range(dim):
                jf2 = np.asarray(K_op.jfac[e]) ** 2
                parts.append(np.broadcast_to(wK * jf2,
                                             cells + qshape).reshape(C, Q))
            self._phig = jnp.asarray(PhiG, self.dtype)
            self._w = jnp.asarray(np.concatenate(parts, axis=1), self.dtype)

    @staticmethod
    def _detect_step_structure(Anp, Bnp):
        """Smallest nt such that BOTH tables are block-bidiagonal in
        (nt x nt) blocks with identical diagonal / sub-diagonal blocks."""
        n = Anp.shape[0]
        if Anp.shape != (n, n) or Bnp.shape != (n, n):
            return None
        for nt in range(1, n // 2 + 1):
            if n % nt:
                continue
            s = n // nt
            if s < 2:
                break
            ok = True
            A0, B0 = Anp[:nt, :nt], Bnp[:nt, :nt]
            A1, B1 = Anp[nt:2 * nt, :nt], Bnp[nt:2 * nt, :nt]
            for i in range(s):
                for j in range(s):
                    ba = Anp[i * nt:(i + 1) * nt, j * nt:(j + 1) * nt]
                    bb = Bnp[i * nt:(i + 1) * nt, j * nt:(j + 1) * nt]
                    if i == j:
                        ea, eb = A0, B0
                    elif i == j + 1:
                        ea, eb = A1, B1
                    else:
                        ea = eb = None
                    if ea is None:
                        if np.any(ba != 0.0) or np.any(bb != 0.0):
                            ok = False
                            break
                    elif not (np.array_equal(ba, ea)
                              and np.array_equal(bb, eb)):
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                return nt, A0, A1, B0, B1
        return None

    def _mix(self, which: str, transpose: bool, x):
        """Apply the block mixing: which in {'alpha','beta'};
        x: [n_blocks, ...].  One dense (n x n) matmul over the block axis
        (the bidiagonal structured form is an open A/B on the GPU,
        ROADMAP Speed 5)."""
        dense = self.Alpha if which == "alpha" else self.Beta
        M = dense.T if transpose else dense
        return jnp.einsum("ji,i...->j...", M, x)

    @property
    def dof_shape(self):
        return self.K.dof_shape

    def _fused_apply(self, x: jnp.ndarray, transpose: bool,
                     alpha_zero: bool, beta_zero: bool,
                     mask_input: bool = True) -> jnp.ndarray:
        """x: [n_src_blocks, *dofshape] -> [n_dst_blocks, *dofshape].
        mask_input=False reads boundary dofs (for the strong-Dirichlet lift
        rhs -= A x_g; output rows stay interior-masked either way)."""
        import jax

        if self.precision is not None:
            with jax.default_matmul_precision(self.precision):
                return self._fused_apply_impl(x, transpose,
                                              alpha_zero, beta_zero,
                                              mask_input)
        return self._fused_apply_impl(x, transpose, alpha_zero, beta_zero,
                                      mask_input)

    def _fused_apply_impl(self, x, transpose, alpha_zero, beta_zero,
                          mask_input=True):
        K, M = self.K, self.M
        dim, k = K.dim, K.degree
        cells = K.cells
        S, D = K.S, K.D
        mix_a = lambda v: self._mix("alpha", transpose, v)
        mix_b = lambda v: self._mix("beta", transpose, v)

        if self._kron is not None:
            xin = x * K.mask if mask_input else x
            cKK, cKM = K.laplace_scaling, K.mass_scaling
            cMK, cMM = M.laplace_scaling, M.mass_scaling
            need_K = ((not alpha_zero and cKK != 0.0)
                      or (not beta_zero and cMK != 0.0))
            need_M = ((not alpha_zero and cKM != 0.0)
                      or (not beta_zero and cMM != 0.0))
            Kx, Mx = self._kron.pair(xin, need_K, need_M)

            def _comb(cK_, cM_):
                t = None
                if cK_ != 0.0:
                    t = Kx if cK_ == 1.0 else cK_ * Kx
                if cM_ != 0.0:
                    tm = Mx if cM_ == 1.0 else cM_ * Mx
                    t = tm if t is None else t + tm
                return t

            y = None
            if not alpha_zero:
                t = _comb(cKK, cKM)
                if t is not None:
                    y = mix_a(t)
            if not beta_zero:
                t = _comb(cMK, cMM)
                if t is not None:
                    tb = mix_b(t)
                    y = tb if y is None else y + tb
            if y is None:
                return jnp.zeros((self.n_blocks,) + tuple(self.dof_shape),
                                 self.dtype)
            return y * K.mask

        if self._grid is not None:
            xin = x * K.mask if mask_input else x
            y = self._grid.apply(xin, mix_a, mix_b, alpha_zero, beta_zero)
            if y is None:
                return jnp.zeros((self.n_blocks,) + tuple(self.dof_shape),
                                 self.dtype)
            return y * K.mask

        u = cell_gather(x * K.mask if mask_input else x, cells, k)
        if self._phig is not None:
            # full-cell-basis middle: Phi (A x Q) / Grad (A x dim*Q) turn
            # the quadrature sweep into two matmul pairs per block mix
            C = int(np.prod(cells))
            Q = K.n_q ** dim
            u2 = u.reshape(u.shape[0], C, (k + 1) ** dim)
            PhiG, W = self._phig, self._w
            qv = jnp.einsum("tca,aq->tcq", mix_b(u2), PhiG[:, :Q])
            qg = jnp.einsum("tca,aq->tcq", mix_a(u2), PhiG[:, Q:])
            y2 = (jnp.einsum("tcq,aq->tca", qv * W[None, :, :Q], PhiG[:, :Q])
                  + jnp.einsum("tcq,aq->tca", qg * W[None, :, Q:],
                               PhiG[:, Q:]))
            y = y2.reshape((y2.shape[0],) + cells + (k + 1,) * dim)
            return cell_scatter(y, cells, k) * K.mask
        acc = None
        if not beta_zero:
            w = M.jxw if M.coeff is None else M.jxw * M.coeff
            val = _sumfac([S] * dim, u, dim)
            val = mix_b(val) * w
            acc = _sumfac([S] * dim, val, dim, forward=False)
        if not alpha_zero:
            w = K.jxw if K.coeff is None else K.jxw * K.coeff
            ghat = []
            for e in range(dim):
                mats = [D if d == e else S for d in range(dim)]
                ghat.append(_sumfac(mats, u, dim))
            if K.jfac is not None:
                for e in range(dim):
                    t = mix_a(ghat[e]) * (w * K.jfac[e] ** 2)
                    mats = [D if d == e else S for d in range(dim)]
                    contrib = _sumfac(mats, t, dim, forward=False)
                    acc = contrib if acc is None else acc + contrib
            else:
                ji = K.jinv
                gmix = [mix_a(g) for g in ghat]
                gphys = [sum(gmix[e] * ji[..., e, d] for e in range(dim)) * w
                         for d in range(dim)]
                for e in range(dim):
                    t = sum(gphys[d] * ji[..., e, d] for d in range(dim))
                    mats = [D if d == e else S for d in range(dim)]
                    contrib = _sumfac(mats, t, dim, forward=False)
                    acc = contrib if acc is None else acc + contrib
        if acc is None:
            return jnp.zeros((self.n_blocks,) + tuple(self.dof_shape),
                             self.dtype)
        y = cell_scatter(acc, cells, k)
        return y * K.mask

    def vmult(self, x: jnp.ndarray, mask_input: bool = True) -> jnp.ndarray:
        if (self._slice_reduced is not None and x.shape[0] == 1
                and mask_input):
            return self.vmult_slice(x[0])
        if (self._col_reduced is not None
                and x.shape[0] == self.Alpha.shape[1]):
            # static-index slice (no gather): _col_nz is a Python tuple
            xs = jnp.stack([x[i] for i in self._col_nz])
            return self._col_reduced.vmult(xs, mask_input)
        return self._fused_apply(x, False,
                                 self.alpha_is_zero, self.beta_is_zero,
                                 mask_input)

    def Tvmult(self, x: jnp.ndarray) -> jnp.ndarray:
        return self._fused_apply(x, True,
                                 self.alpha_is_zero, self.beta_is_zero)

    def vmult_slice(self, prev: jnp.ndarray) -> jnp.ndarray:
        """RHS assembly: dst_j = Alpha[j,0] K prev + Beta[j,0] M prev;
        prev has shape [*dofshape] (reference vmult_slice_add,
        include/operators.h:585-611)."""
        if self._slice_reduced is not None:
            y = self._slice_reduced.vmult_slice(prev)
            out = jnp.zeros((self.n_blocks,) + y.shape[1:], y.dtype)
            return out.at[jnp.asarray(self._slice_nz)].set(y)
        return self._fused_apply(prev[None], False,
                                 self.alpha_is_zero, self.beta_is_zero)

    def diagonal(self) -> jnp.ndarray:
        """Block-diagonal: diag_j = Alpha[j,j] diag(K) + Beta[j,j] diag(M);
        reference include/operators.h:613-640."""
        dK = self.K.diagonal()
        dM = self.M.diagonal()
        a = jnp.diagonal(self.Alpha)
        b = jnp.diagonal(self.Beta)
        lead = (self.n_blocks,) + (1,) * self.K.dim
        return (a.reshape(lead) * dK[None] + b.reshape(lead) * dM[None])
