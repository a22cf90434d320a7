"""Sum-factorized matrix-free spatial operators on structured meshes.

Dense-array equivalent of the reference's MatrixFreeOperator (deal.II
FEEvaluation cell loops, include/operators.h:967-1187): the weak form
    c_M (w_m u, v) + c_K (w_k grad u, grad v)
is applied to a whole batch of space-time blocks at once as
    gather -> per-axis 1D interpolation matmuls -> quadrature scaling
    -> transposed matmuls -> overlap-add scatter.

The block axis of the space-time vector is simply a leading batch dimension,
so one operator application serves all time blocks -- the Kronecker structure
of the slab system never materializes big matrices.

Dirichlet conditions are elimination masks: apply = mask . A(mask . x), the
operator acts as zero on constrained dofs (matching the reference's
matrix-free convention of resolving constraints in gather/scatter).
"""
from __future__ import annotations

import string
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.fe import shape_data_1d
from ..mesh.grid import Geometry, StructuredMesh
from ..utils.module import register_module

__all__ = ["LaplaceMassOperator", "cell_gather", "cell_scatter"]


def _axis_letters(dim):
    return string.ascii_lowercase[:dim], string.ascii_lowercase[13:13 + dim]


def cell_gather(x: jnp.ndarray, cells: tuple[int, ...], k: int) -> jnp.ndarray:
    """[..., *dofshape] -> [..., *cells, *(k+1)^dim] cell-local view."""
    dim = len(cells)
    lead = x.ndim - dim
    for d in range(dim):
        axis = lead + 2 * d
        nc = cells[d]
        idx = (np.arange(nc)[:, None] * k + np.arange(k + 1)[None, :]).reshape(-1)
        x = jnp.take(x, jnp.asarray(idx), axis=axis)
        x = x.reshape(x.shape[:axis] + (nc, k + 1) + x.shape[axis + 1:])
    # [..., nc1, a1, nc2, a2, ...] -> [..., nc1.., a1..]
    perm = (list(range(lead))
            + [lead + 2 * d for d in range(dim)]
            + [lead + 2 * d + 1 for d in range(dim)])
    return jnp.transpose(x, perm)


def cell_scatter(y: jnp.ndarray, cells: tuple[int, ...], k: int) -> jnp.ndarray:
    """Transpose of cell_gather: overlap-add [..., *cells, *(k+1)^dim] ->
    [..., *dofshape]."""
    dim = len(cells)
    lead = y.ndim - 2 * dim
    # interleave back to [..., nc1, a1, nc2, a2, ...]
    perm = list(range(lead))
    for d in range(dim):
        perm += [lead + d, lead + dim + d]
    y = jnp.transpose(y, perm)
    for d in reversed(range(dim)):
        axis = lead + 2 * d
        nc = cells[d]
        moved = jnp.moveaxis(y, (axis, axis + 1), (-2, -1))
        lead_shape = moved.shape[:-2]
        interior = moved[..., :, :k].reshape(lead_shape + (nc * k,))
        out = jnp.pad(interior,
                      [(0, 0)] * len(lead_shape) + [(0, 1)])
        # shared-node contribution (local dof k of each cell lands on global
        # index (c+1)*k): built by concat + reshape instead of a strided
        # scatter-add, which lowers to a serialized scatter
        last = moved[..., :, k:]                         # [..., nc, 1]
        seg = jnp.concatenate(
            [last, jnp.zeros(lead_shape + (nc, k - 1), y.dtype)], axis=-1) \
            if k > 1 else last
        seg = jnp.concatenate(
            [jnp.zeros(lead_shape + (1, k), y.dtype), seg], axis=-2)
        shared = seg.reshape(lead_shape + ((nc + 1) * k,))[..., :nc * k + 1]
        y = jnp.moveaxis(out + shared, -1, axis)
    return y


def _sumfac(mats, x, dim, forward=True):
    """Apply 1D matrices along the last `dim` axes.

    forward: x[..., a1..ad] -> [..., q1..qd] with mats[d] of shape (q, a);
    else the transpose contraction (q -> a).
    """
    locs, quads = _axis_letters(dim)
    in_ax = locs if forward else quads
    out_ax = quads if forward else locs
    operands = []
    script = []
    for d in range(dim):
        m = mats[d]
        operands.append(m if forward else m.T)
        script.append(f"{out_ax[d]}{in_ax[d]}")
    ein = ",".join(script) + f",...{''.join(in_ax)}->...{''.join(out_ax)}"
    return jnp.einsum(ein, *operands, x)


@register_module
class LaplaceMassOperator:
    """c_M (w u, v) + c_K (w grad u, grad v) on Q_degree elements.

    Parameters mirror the reference ctor (mass/laplace scaling); an optional
    coefficient field (evaluated per (cell, quad)) multiplies the scaled term
    like Coefficient does in the reference (include/operators.h:1060-1087).
    """

    def __init__(self, mesh: StructuredMesh, degree: int, n_q: int,
                 mass_scaling: float, laplace_scaling: float,
                 dtype=jnp.float64, coefficient=None,
                 mask: np.ndarray | None = None):
        self.mesh = mesh
        self.degree = degree
        self.n_q = n_q
        self.dim = mesh.dim
        self.cells = mesh.cells
        self.dof_shape = mesh.dof_shape(degree)
        self.mass_scaling = float(mass_scaling)
        self.laplace_scaling = float(laplace_scaling)
        self.dtype = dtype

        sd = shape_data_1d(degree, n_q)
        self.S = jnp.asarray(sd.S, dtype)
        self.D = jnp.asarray(sd.D, dtype)
        self._sd = sd

        geom: Geometry = mesh.geometry(n_q, degree)
        self.geom = geom
        self.jxw = jnp.asarray(geom.jxw, dtype)
        # axis-aligned (possibly cell-masked / non-uniform tensor) meshes use
        # the diagonal-J path with per-axis factors jfac[e] broadcastable
        # against [*cells, *q]; only truly distorted meshes need full
        # per-cell Jacobians
        self.jinv = None
        self.jinv_diag = None
        self.jfac = None
        if geom.jinv_diag is not None:
            self.jinv_diag = jnp.asarray(geom.jinv_diag, dtype)
            self.jfac = [self.jinv_diag[e] for e in range(self.dim)]
        elif geom.jinv_axis is not None:
            jfac = []
            for e in range(self.dim):
                shape = [1] * (2 * self.dim)
                shape[e] = self.cells[e]
                jfac.append(jnp.asarray(geom.jinv_axis[e], dtype
                                        ).reshape(shape))
            self.jfac = jfac
        else:
            self.jinv = jnp.asarray(geom.jinv, dtype)

        if mask is None:
            mask = mesh.boundary_dof_mask(degree)
        self.mask_np = np.asarray(mask)
        self.mask = jnp.asarray(mask, dtype)

        # coefficient evaluated at quadrature points (cell-wise table)
        if coefficient is not None:
            coeff = self._evaluate_coefficient(coefficient)
            self.coeff = jnp.asarray(coeff, dtype)
        else:
            self.coeff = None

    # -- reference include/operators.h:1060-1087 ---------------------------
    def _evaluate_coefficient(self, coefficient_fun) -> np.ndarray:
        qshape = (self.n_q,) * self.dim
        qx = self._sd.quad_x
        if self.geom.points is None:
            # quad point coordinates per cell
            axes = [self.mesh.lower[d]
                    + self.mesh.h[d] * (np.arange(self.cells[d])[:, None]
                                        + qx[None, :])
                    for d in range(self.dim)]
            # build [*cells, *q, dim]
            grids = np.meshgrid(*[np.arange(c) for c in self.cells],
                                indexing="ij")
            out = np.zeros(self.cells + qshape + (self.dim,))
            for d in range(self.dim):
                shape = [1] * (2 * self.dim)
                shape[d] = self.cells[d]
                shape[self.dim + d] = self.n_q
                out[..., d] = axes[d].reshape(shape)
            pts = out
        else:
            pts = self.geom.points
        return coefficient_fun(pts)

    # ----------------------------------------------------------------------
    def apply(self, x: jnp.ndarray, mask_input: bool = True) -> jnp.ndarray:
        """y = mask . A (mask . x); x has shape [..., *dofshape].
        mask_input=False reads boundary dofs too (strong-Dirichlet lift,
        see ops/boundary.py); output rows stay interior-masked."""
        cM, cK = self.mass_scaling, self.laplace_scaling
        dim, k = self.dim, self.degree
        if mask_input:
            x = x * self.mask
        u = cell_gather(x, self.cells, k)
        S, D = self.S, self.D

        acc = None
        w = self.jxw if self.coeff is None else self.jxw * self.coeff
        if cM != 0.0:
            val = _sumfac([S] * dim, u, dim)
            val = val * (cM * w)
            acc = _sumfac([S] * dim, val, dim, forward=False)
        if cK != 0.0:
            # reference-space gradients
            ghat = []
            for e in range(dim):
                mats = [D if d == e else S for d in range(dim)]
                ghat.append(_sumfac(mats, u, dim))
            if self.jfac is not None:
                # axis-aligned: J^{-1} diagonal, directions decouple
                for e in range(dim):
                    t = ghat[e] * (cK * w) * self.jfac[e] ** 2
                    mats = [D if d == e else S for d in range(dim)]
                    contrib = _sumfac(mats, t, dim, forward=False)
                    acc = contrib if acc is None else acc + contrib
            else:
                ji = self.jinv  # [*cells, *q, e, d]
                gphys = [sum(ghat[e] * ji[..., e, d] for e in range(dim))
                         for d in range(dim)]
                gphys = [g * (cK * w) for g in gphys]
                for e in range(dim):
                    t = sum(gphys[d] * ji[..., e, d] for d in range(dim))
                    mats = [D if d == e else S for d in range(dim)]
                    contrib = _sumfac(mats, t, dim, forward=False)
                    acc = contrib if acc is None else acc + contrib
        y = cell_scatter(acc, self.cells, k)
        return y * self.mask

    # alias mirroring the reference naming
    def vmult(self, x):
        return self.apply(x)

    # ----------------------------------------------------------------------
    def _basis_tensors(self):
        """Full-cell basis arrays Phi[A, Q], GradHat[e, A, Q] (numpy)."""
        dim, k, nq = self.dim, self.degree, self.n_q
        S, D = self._sd.S, self._sd.D  # (q, a)
        A = (k + 1) ** dim
        Q = nq ** dim
        Phi = np.ones((A, Q))
        Grad = np.ones((dim, A, Q))
        a_idx = np.stack(np.meshgrid(*[np.arange(k + 1)] * dim,
                                     indexing="ij"), -1).reshape(A, dim)
        q_idx = np.stack(np.meshgrid(*[np.arange(nq)] * dim,
                                     indexing="ij"), -1).reshape(Q, dim)
        for d in range(dim):
            Phi *= S[q_idx[:, d][None, :], a_idx[:, d][:, None]]
            for e in range(dim):
                Grad[e] *= (D if d == e else S)[q_idx[:, d][None, :],
                                                a_idx[:, d][:, None]]
        return Phi, Grad

    def element_matrices(self) -> jnp.ndarray:
        """Exact per-cell element matrices E[C, A, A] (the analogue of
        MatrixFreeTools::compute_matrix restricted to one cell), with
        Dirichlet rows/cols eliminated and unit diagonal on constrained dofs.
        """
        dim, k = self.dim, self.degree
        Phi, Grad = self._basis_tensors()
        Phi = jnp.asarray(Phi, self.dtype)
        Grad = jnp.asarray(Grad, self.dtype)
        C = int(np.prod(self.cells))
        Q = self.n_q ** dim
        w = self.jxw if self.coeff is None else self.jxw * self.coeff
        cM, cK = self.mass_scaling, self.laplace_scaling

        wq = jnp.broadcast_to(w, self.cells + (self.n_q,) * dim)
        wq = wq.reshape(C, Q)

        E = jnp.zeros((C, (k + 1) ** dim, (k + 1) ** dim), self.dtype)
        if cM != 0.0:
            E = E + cM * jnp.einsum("cq,aq,bq->cab", wq, Phi, Phi)
        if cK != 0.0:
            if self.jfac is not None:
                for e in range(dim):
                    sfac = jnp.broadcast_to(
                        self.jfac[e] ** 2,
                        self.cells + (1,) * dim).reshape(C, 1)
                    E = E + cK * jnp.einsum("cq,aq,bq->cab", wq * sfac,
                                            Grad[e], Grad[e])
            else:
                ji = self.jinv.reshape(C, Q, dim, dim)
                gphys = jnp.einsum("cqed,eaq->cdaq", ji, Grad)
                E = E + cK * jnp.einsum("cq,cdaq,cdbq->cab", wq, gphys, gphys)

        # Dirichlet elimination: zero constrained rows/cols.  The assembled
        # diagonal for constrained dofs is fixed up by the consumers (band
        # assembly / diagonal()), not here, to avoid multi-counting across
        # cells sharing a constrained dof.
        mloc = cell_gather(self.mask, self.cells, k).reshape(C, -1)
        E = E * mloc[:, :, None] * mloc[:, None, :]
        return E

    def diagonal(self) -> jnp.ndarray:
        """Assembled matrix diagonal as a dof-grid array; constrained dofs
        get 1.0 (reference include/operators.h:1092-1110)."""
        E = self.element_matrices()
        ediag = jax.vmap(jnp.diag)(E)  # (C, A)
        ediag = ediag.reshape(self.cells + (self.degree + 1,) * self.dim)
        d = cell_scatter(ediag, self.cells, self.degree)
        return d * self.mask + (1.0 - self.mask)
