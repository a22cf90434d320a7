"""Gather-free grid sum-factorization for diagonal-geometry meshes.

On a tensor-product grid the cell-local Gauss points are DISJOINT (cell
interior), so dof -> quadrature interpolation along one axis is a global
banded 1D matrix (nc*q x nc*k+1) applied as a dense matmul, and its
TRANSPOSE performs the inter-cell overlap-add accumulation as a matmul.
No cell gather, no overlap-add scatter, no small-axis transposes -- the
memory-layout traffic of the cell-local path.  The banded matrix costs
~nc x more MACs than the cell-local contraction, which matrix units absorb.

Replaces the quadrature loop of the reference's MatrixFreeOperator
(include/operators.h:967-1187) for the axis-aligned-geometry case; mapped
meshes keep the cell-local XLA path (see system.py).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.module import register_module

__all__ = ["GridSumFac", "axis_apply"]


def _interleave(full: np.ndarray, cells, nq: int) -> np.ndarray:
    """[*cells, *q] -> quad-grid layout [(nc1*q), (nc2*q), ...]."""
    dim = len(cells)
    perm = []
    for d in range(dim):
        perm += [d, dim + d]
    a = np.transpose(full, perm)
    return a.reshape(tuple(int(cells[d]) * nq for d in range(dim)))


def axis_apply(M, x, axis):
    """Contract M (out, in) against x's `axis`, result axis in place.

    Default "tensordot" (moveaxis copies) instead of the in-place einsum
    contraction, whose dot_general on a middle axis may relayout worse
    than explicit copies (not yet timed on the GPU; ROADMAP Speed 5).
    STFEM_AX_STYLE=einsum for A/B.
    """
    import os
    if os.environ.get("STFEM_AX_STYLE", "tensordot") == "tensordot":
        return jnp.moveaxis(jnp.tensordot(M, x, axes=(1, axis)), 0, axis)
    letters = "abcdefghijklm"
    sub = letters[: x.ndim]
    out = sub[:axis] + "z" + sub[axis + 1:]
    return jnp.einsum(f"z{sub[axis]},{sub}->{out}", M, x)


@register_module
class GridSumFac:
    """Per-axis global quadrature matmuls + full quad-grid weights for
    c_B (w_M u, v) + c_A (w_K grad u, grad v) with block-level mixing
    injected at the quadrature level (same contract as the cell-local
    path in SystemMatrix._fused_apply_impl).

    Requires K_op.jinv is None (diagonal/axis-aligned geometry).  The
    reference-space derivative matrices carry NO metric factor; the
    per-direction gradient weight grids fold jxw * coeff * jfac[e]^2,
    so non-uniform tensor steps, distorted-diagonal meshes, coefficient
    fields, and masked cells (zero jxw) are all exact.
    """

    def __init__(self, K_op, M_op, dtype):
        assert K_op.jinv is None
        dim, k, nq = K_op.dim, K_op.degree, K_op.n_q
        cells = K_op.cells
        sd = K_op._sd
        S1 = np.asarray(sd.S, np.float64)          # (q, k+1)
        D1 = np.asarray(sd.D, np.float64)
        self.dim, self.k, self.nq = dim, k, nq
        self.cells = tuple(int(c) for c in cells)

        Sg, Dg = [], []
        for d in range(dim):
            nc = self.cells[d]
            nd = nc * k + 1
            Sgd = np.zeros((nc * nq, nd))
            Dgd = np.zeros((nc * nq, nd))
            for c in range(nc):
                Sgd[c * nq:(c + 1) * nq, c * k:c * k + k + 1] = S1
                Dgd[c * nq:(c + 1) * nq, c * k:c * k + k + 1] = D1
            Sg.append(jnp.asarray(Sgd, dtype))
            Dg.append(jnp.asarray(Dgd, dtype))
        self.Sg, self.Dg = Sg, Dg

        qfull = tuple(cells) + (nq,) * dim
        wM = np.asarray(M_op.jxw, np.float64)
        if M_op.coeff is not None:
            wM = wM * np.asarray(M_op.coeff, np.float64)
        self.Wb = jnp.asarray(
            _interleave(np.broadcast_to(wM, qfull), cells, nq), dtype)
        wK = np.asarray(K_op.jxw, np.float64)
        if K_op.coeff is not None:
            wK = wK * np.asarray(K_op.coeff, np.float64)
        self.Wa = []
        for e in range(dim):
            jf2 = np.asarray(K_op.jfac[e], np.float64) ** 2
            full = _interleave(np.broadcast_to(wK * jf2, qfull), cells, nq)
            self.Wa.append(jnp.asarray(full, dtype))

    def _ax(self, M, x, axis):
        return axis_apply(M, x, axis)

    def apply(self, x, mix_a, mix_b, alpha_zero: bool, beta_zero: bool):
        """x: [..., *dofshape] -> same shape; mix_a/mix_b map the leading
        block axis at the quadrature level (identity for plain operators)."""
        dim = self.dim
        lead = x.ndim - dim
        # forward with shared prefixes: after processing axis d, `val`
        # holds S_0..S_d u and grads[e<=d] the D_e variant
        val = x
        grads = []
        for d in range(dim):
            axis = lead + d
            new_grads = [self._ax(self.Sg[d], g, axis) for g in grads]
            if not alpha_zero:
                new_grads.append(self._ax(self.Dg[d], val, axis))
            val = self._ax(self.Sg[d], val, axis)
            grads = new_grads
        acc = None
        if not alpha_zero:
            for e in range(dim):
                t = mix_a(grads[e]) * self.Wa[e]
                for d in range(dim):
                    m = self.Dg[d] if d == e else self.Sg[d]
                    t = self._ax(m.T, t, lead + d)
                acc = t if acc is None else acc + t
        if not beta_zero:
            v = mix_b(val) * self.Wb
            for d in range(dim):
                v = self._ax(self.Sg[d].T, v, lead + d)
            acc = v if acc is None else acc + v
        return acc
