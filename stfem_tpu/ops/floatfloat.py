"""Float-float (double-single) arithmetic for the IR residual.

The iterative-refinement residual r = b - A x needs ~1e-9 RELATIVE absolute
accuracy (the true-1e-8 contract), far beyond f32 but far short of f64.  A
float-float number (value = hi + lo, two f32s, ~49-bit effective mantissa,
|lo| <= ulp(hi)/2) reaches ~2^-48 relative error per operation using only
f32 arithmetic via error-free transformations (Knuth two-sum, split
two-product): ~20-30 f32 flops per emulated FMA, with the same memory
footprint as f64 (2 words).  It is the bench's default residual engine;
whether it beats native f64 on a given accelerator is a measurement
(ROADMAP Speed 5).

Used by the banded Kronecker residual apply (KronAssembledFF below): the
1D assembled matrices and the Alpha/Beta step tables are stored as ff pairs
(so the OPERATOR itself carries f64-level accuracy, not just the vectors),
and the whole stepwise residual runs in ff.  Parity: the ff residual agrees
with the native-f64 residual to ~1e-12 relative (tests/test_aux.py).

NOTE on XLA semantics: error-free transforms rely on IEEE f32 evaluation
order.  XLA preserves floating-point semantics for explicit elementwise
graphs (no unsafe reassociation), but a GPU backend may contract a multiply
feeding an add into one fused multiply-add.  Fusing a*b - p only makes the
error term MORE exact; the classic Dekker split ca - (ca - a) with
ca = 4097 a is NOT safe under contraction (fma(4097, a, -a) skips the
rounding of ca that the split relies on).  _split therefore masks the low
mantissa bits through an integer bitcast, which no contraction can change.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.module import register_module

__all__ = ["ff_from_f64", "ff_to_f64", "ff_add", "ff_add_f32", "ff_mul",
           "ff_mul_f32", "ff_neg", "KronAssembledFF"]

# keeps the sign, exponent and the top 11 explicit mantissa bits: the high
# part carries 12 significant bits, so products of two halves are exact
_HI_MASK = np.uint32(0xFFFFF000)


def _two_sum(a, b):
    """Error-free a + b = s + err (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (3 flops)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    """a = hi + lo exactly, each half with at most 12 significant bits
    (f32 only; the bit mask is immune to fused multiply-add contraction)."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & _HI_MASK, jnp.float32)
    return hi, a - hi


def _two_prod(a, b):
    """Error-free a * b = p + err (split product)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def ff_from_f64(x) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Split a float64 array (or numpy array) into an ff pair."""
    x = np.asarray(x, np.float64) if isinstance(x, np.ndarray) else x
    hi = x.astype(jnp.float32) if hasattr(x, "astype") else np.float32(x)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def ff_to_f64(a) -> jnp.ndarray:
    hi, lo = a
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def ff_neg(a):
    return -a[0], -a[1]


def ff_add(a, b):
    """Double-single addition (sloppy variant, ~11 flops: error below
    2^-48 of the result, sufficient for the 1e-9 residual contract)."""
    s, e = _two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return _quick_two_sum(s, e)


def ff_add_f32(a, b32):
    s, e = _two_sum(a[0], b32)
    e = e + a[1]
    return _quick_two_sum(s, e)


def ff_mul(a, b):
    """Double-single product (~24 flops; drops the lo*lo term)."""
    p, e = _two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return _quick_two_sum(p, e)


def ff_mul_f32(a, b32):
    p, e = _two_prod(a[0], b32)
    e = e + a[1] * b32
    return _quick_two_sum(p, e)


def _ff_banded_axis_apply(Dff, aff, axis: int, k: int):
    """ff version of kronfac._banded_axis_apply: y_i = sum_o D[o,i] x_{i+o-k}
    along `axis`; D stored as ff (2k+1, nd) pairs."""
    Dhi, Dlo = Dff
    hi, lo = aff
    nd = Dhi.shape[1]
    pad = [(0, 0)] * hi.ndim
    pad[axis] = (k, k)
    hip = jnp.pad(hi, pad)
    lop = jnp.pad(lo, pad)
    dshape = [1] * hi.ndim
    dshape[axis] = nd
    out = None
    for o in range(2 * k + 1):
        sl = [slice(None)] * hi.ndim
        sl[axis] = slice(o, o + nd)
        xo = (hip[tuple(sl)], lop[tuple(sl)])
        Do = (Dhi[o].reshape(dshape), Dlo[o].reshape(dshape))
        term = ff_mul(Do, xo)
        out = term if out is None else ff_add(out, term)
    return out


@register_module
class KronAssembledFF:
    """ff twin of ops.kronfac.KronAssembled: per-axis banded 1D assembled
    factors stored as ff pairs; pair() returns (K x, M x) in ff.

    Built from an existing f64 KronAssembled (its M1/A1 are exact f64
    assemblies); supports() mirrors the separable-geometry requirement."""

    def __init__(self, kron64):
        from .kronfac import _to_diags
        self.dim = kron64.dim
        self.k = kron64.k
        self.Md, self.Ad = [], []
        for d in range(self.dim):
            M1 = np.asarray(kron64.M1[d], np.float64)
            A1 = np.asarray(kron64.A1[d], np.float64)
            self.Md.append(ff_from_f64(_to_diags(M1, self.k)))
            self.Ad.append(ff_from_f64(_to_diags(A1, self.k)))

    def pair(self, xff, need_K: bool = True, need_M: bool = True):
        """(K x, M x) in ff; either may be None when not requested."""
        dim, k = self.dim, self.k
        lead = xff[0].ndim - dim
        val = xff
        ks = None
        for d in range(dim):
            ax = lead + d
            if need_K:
                a_term = _ff_banded_axis_apply(self.Ad[d], val, ax, k)
                ks = (a_term if ks is None
                      else ff_add(_ff_banded_axis_apply(self.Md[d], ks,
                                                        ax, k), a_term))
            if need_M or (need_K and d < dim - 1):
                val = _ff_banded_axis_apply(self.Md[d], val, ax, k)
        return (ks if need_K else None), (val if need_M else None)


def ff_mix(table_ff, xff, pattern=None):
    """Block-axis mixing y_j = sum_i T[j,i] x_i in ff; the table is a small
    dense (rows, cols) ff pair, unrolled over its nonzero entries (the
    rectangular per-step IR tables are nt x (nt+1)).  `pattern` is the
    STATIC numpy bool nonzero mask -- required when the table is a jit
    tracer (the zero-skip is a trace-time decision)."""
    Thi, Tlo = table_ff
    if pattern is None:
        pattern = (np.asarray(Thi) != 0.0) | (np.asarray(Tlo) != 0.0)
    rows, cols = pattern.shape
    outs = []
    for j in range(rows):
        acc = None
        for i in range(cols):
            if not pattern[j, i]:
                continue
            # ff x_i times the ff scalar T[j, i]
            p, e = _two_prod(xff[0][i], Thi[j, i])
            e = e + (xff[0][i] * Tlo[j, i] + xff[1][i] * Thi[j, i])
            term = _quick_two_sum(p, e)
            acc = term if acc is None else ff_add(acc, term)
        if acc is None:
            acc = (jnp.zeros_like(xff[0][0]), jnp.zeros_like(xff[1][0]))
        outs.append(acc)
    hi = jnp.stack([o[0] for o in outs])
    lo = jnp.stack([o[1] for o in outs])
    return hi, lo


@register_module
class FFSlabResidual:
    """Whole-slab true residual in float-float: the IR bench's default
    high-precision residual (the native-f64 stepwise form is the other).

    Built once from the f64 operators and the full multi-step tables; holds
    the rectangular per-step tables (rows = one step's nt blocks, cols =
    [previous step's last dof, step blocks] -- the fused form of the
    block-bidiagonal structure) and the Gamma previous-SLAB coupling, all as
    ff pairs.  residual() runs one lax.scan over the steps with ~30 native
    f32 flops per emulated FMA; no f64 arrays anywhere.
    """

    def __init__(self, K64, M64, Alpha, Beta, Gamma, Gamma_K=None,
                 Gamma_v=None, kron_ff=None, mask=None):
        """K64/M64: f64 LaplaceMassOperators (ignored when kron_ff is
        given).  kron_ff: a prebuilt ff Kronecker-like engine exposing
        pair(xff, need_K, need_M) -- the Stokes saddle engine
        (ops/ff_stokes.KronStokesFF) injects itself here, with `mask` the
        matching flat constraint mask; the heat/wave path builds the
        banded scalar engine from K64/M64."""
        from ..system import SystemMatrix
        from .kronfac import KronAssembled
        import jax.numpy as _jnp

        A_np, B_np, G_np = (np.asarray(Alpha, np.float64),
                            np.asarray(Beta, np.float64),
                            np.asarray(Gamma, np.float64))
        struct = SystemMatrix._detect_step_structure(A_np, B_np)
        assert struct is not None, "FF residual needs the step structure"
        nt, A0, A1, B0, B1 = struct
        self.nt = int(nt)
        self.n_blocks = int(A_np.shape[0])
        # step coupling columns: [previous last dof] for the first-order
        # tables, or the WHOLE previous step for the Schur-reduced wave
        # tables (their coupling reads several of the previous step's
        # dofs -- fe_time.h:444-474 wave expansion)
        self.full_coupling = bool(np.any(A1[:, :-1]) or np.any(B1[:, :-1]))
        if self.full_coupling:
            A04 = np.concatenate([A1, A0], axis=1)
            B04 = np.concatenate([B1, B0], axis=1)
        else:
            A04 = np.concatenate([A1[:, -1:], A0], axis=1)
            B04 = np.concatenate([B1[:, -1:], B0], axis=1)
        self.A_ff = ff_from_f64(A04)
        self.B_ff = ff_from_f64(B04)
        # static nonzero masks for the trace-time zero-skip in ff_mix
        self.A_nz = A04 != 0.0
        self.B_nz = B04 != 0.0
        # previous-slab coupling: Gamma scales the MASS path and feeds only
        # the FIRST step's rows (SystemMatrix rhs semantics).  Wave adds a
        # K-path prev-u table (Gamma_K) and a second previous vector with
        # an M-path table (Gamma_v): rhs = Gk (x) K u_prev
        # + G (x) M u_prev + Gv (x) M v_prev + force.
        assert G_np.shape == (self.n_blocks, 1)
        assert not np.any(G_np[nt:]), "Gamma feeds only the first step"
        self.G_ff = ff_from_f64(G_np[:nt])
        self.G_nz = G_np[:nt] != 0.0
        self.Gk_ff = self.Gk_nz = None
        self.Gv_ff = self.Gv_nz = None
        if Gamma_K is not None:
            Gk = np.asarray(Gamma_K, np.float64)
            assert Gk.shape == (self.n_blocks, 1) and not np.any(Gk[nt:])
            self.Gk_ff = ff_from_f64(Gk[:nt])
            self.Gk_nz = Gk[:nt] != 0.0
        if Gamma_v is not None:
            Gv = np.asarray(Gamma_v, np.float64)
            assert Gv.shape == (self.n_blocks, 1) and not np.any(Gv[nt:])
            self.Gv_ff = ff_from_f64(Gv[:nt])
            self.Gv_nz = Gv[:nt] != 0.0
        if kron_ff is not None:
            self.kron = kron_ff
            self.mask = _jnp.asarray(np.asarray(mask), _jnp.float32)
            return
        self.kron = KronAssembledFF(KronAssembled(K64, M64, _jnp.float64))
        self.mask = _jnp.asarray(np.asarray(K64.mask_np), _jnp.float32)

    def rhs(self, prev_ff, fslab_ff, prev_v_ff=None):
        """rhs = [Gk (x) K +] Gamma (x) M prev [+ Gv (x) M prev_v] + force,
        in ff.  prev_ff: one dof grid; fslab_ff: [n_blocks, *dofgrid]
        force pair."""
        pin = (prev_ff[0] * self.mask, prev_ff[1] * self.mask)
        need_K = self.Gk_ff is not None
        Kp, Mp = self.kron.pair(pin, need_K=need_K, need_M=True)
        coup = ff_mix(self.G_ff, (Mp[0][None], Mp[1][None]), self.G_nz)
        if need_K:
            coup = ff_add(coup, ff_mix(self.Gk_ff,
                                       (Kp[0][None], Kp[1][None]),
                                       self.Gk_nz))
        if self.Gv_ff is not None:
            vin = (prev_v_ff[0] * self.mask, prev_v_ff[1] * self.mask)
            _, Mv = self.kron.pair(vin, need_K=False, need_M=True)
            coup = ff_add(coup, ff_mix(self.Gv_ff,
                                       (Mv[0][None], Mv[1][None]),
                                       self.Gv_nz))
        coup = (coup[0] * self.mask, coup[1] * self.mask)
        # componentwise hi+hi would round at f32 -- the coupled rows need a
        # true ff add
        head = ff_add((fslab_ff[0][: self.nt], fslab_ff[1][: self.nt]), coup)
        hi = fslab_ff[0].at[: self.nt].set(head[0])
        lo = fslab_ff[1].at[: self.nt].set(head[1])
        return hi, lo

    def residual(self, prev_ff, x_ff, fslab_ff, mode: str = "auto",
                 prev_v_ff=None):
        """r = rhs - A_slab x in ff; returns ((r_hi, r_lo), ||r||, ||rhs||)
        with f32 norms (tree-reduction accuracy ~1e-6 relative -- plenty
        for IR scaling and the 1e-8 verification).  mode: "auto" maps to
        the per-step lax.scan form ("step"), whose working set is one
        step; "slab"/"chunkN"/"unroll"/"step" force the other forms
        (override via STFEM_FF_RESID_MODE; an open A/B on the GPU,
        ROADMAP Speed 5)."""
        import os as _os
        import jax as _jax
        import jax.numpy as _jnp

        rhs_hi, rhs_lo = self.rhs(prev_ff, fslab_ff, prev_v_ff=prev_v_ff)
        nsteps = self.n_blocks // self.nt
        sshape = (nsteps, self.nt) + x_ff[0].shape[1:]
        xh = x_ff[0].reshape(sshape)
        xl = x_ff[1].reshape(sshape)
        if self.full_coupling:
            # coupling columns span the WHOLE previous step
            prev_h = _jnp.concatenate(
                [_jnp.zeros_like(xh[:1]), xh[:-1]], axis=0)
            prev_l = _jnp.concatenate(
                [_jnp.zeros_like(xl[:1]), xl[:-1]], axis=0)
        else:
            prev_h = _jnp.concatenate(
                [_jnp.zeros_like(xh[:1, -1:]), xh[:-1, -1:]], axis=0)
            prev_l = _jnp.concatenate(
                [_jnp.zeros_like(xl[:1, -1:]), xl[:-1, -1:]], axis=0)
        xin_h = _jnp.concatenate([prev_h, xh], axis=1)
        xin_l = _jnp.concatenate([prev_l, xl], axis=1)
        rh = rhs_hi.reshape(sshape)
        rl = rhs_lo.reshape(sshape)

        mode = _os.environ.get("STFEM_FF_RESID_MODE", mode)
        if mode == "auto":
            # the batched forms materialize their big ff temporaries in
            # device memory, and on XLA:CPU the fused slab graph compiles
            # pathologically slowly
            mode = "step"
        if mode == "slab":
            # ALL steps at once: move the block axis first ([nt+1, S, *dof])
            # so ff_mix/kron.pair batch over the S axis for free
            xb = (_jnp.swapaxes(xin_h, 0, 1), _jnp.swapaxes(xin_l, 0, 1))
            rb = (_jnp.swapaxes(rh, 0, 1), _jnp.swapaxes(rl, 0, 1))
            out_h, out_l = ff_system_residual_step(
                self.kron, self.mask, self.A_ff, self.B_ff, rb, xb,
                self.A_nz, self.B_nz)
            out_h = _jnp.swapaxes(out_h, 0, 1)
            out_l = _jnp.swapaxes(out_l, 0, 1)
        elif mode.startswith("chunk"):
            ch = int(mode[5:] or "8")
            ns = sshape[0]
            assert ns % ch == 0, (ns, ch)

            def cshape(a):
                return a.reshape((ns // ch, ch) + a.shape[1:])

            def body(carry, inp):
                xih, xil, rhi, rli = inp
                # batched chunk: block axis first [nt+1, ch, *dof]
                r = ff_system_residual_step(
                    self.kron, self.mask, self.A_ff, self.B_ff,
                    (_jnp.swapaxes(rhi, 0, 1), _jnp.swapaxes(rli, 0, 1)),
                    (_jnp.swapaxes(xih, 0, 1), _jnp.swapaxes(xil, 0, 1)),
                    self.A_nz, self.B_nz)
                return carry, (_jnp.swapaxes(r[0], 0, 1),
                               _jnp.swapaxes(r[1], 0, 1))

            _, (out_h, out_l) = _jax.lax.scan(
                body, None, (cshape(xin_h), cshape(xin_l), cshape(rh),
                             cshape(rl)))
            out_h = out_h.reshape(sshape)
            out_l = out_l.reshape(sshape)
        elif mode == "unroll":
            outs = [ff_system_residual_step(
                self.kron, self.mask, self.A_ff, self.B_ff,
                (rh[s], rl[s]), (xin_h[s], xin_l[s]),
                self.A_nz, self.B_nz) for s in range(sshape[0])]
            out_h = _jnp.stack([o[0] for o in outs])
            out_l = _jnp.stack([o[1] for o in outs])
        else:
            def body(carry, inp):
                xih, xil, rhi, rli = inp
                r = ff_system_residual_step(
                    self.kron, self.mask, self.A_ff, self.B_ff,
                    (rhi, rli), (xih, xil), self.A_nz, self.B_nz)
                return carry, r

            _, (out_h, out_l) = _jax.lax.scan(body, None,
                                              (xin_h, xin_l, rh, rl))
        r_hi = out_h.reshape(x_ff[0].shape)
        r_lo = out_l.reshape(x_ff[0].shape)
        rnorm = _jnp.linalg.norm(r_hi.reshape(-1))
        bnorm = _jnp.linalg.norm(rhs_hi.reshape(-1))
        return (r_hi, r_lo), rnorm, bnorm


def ff_system_residual_step(kron_ff, mask, A_ff, B_ff, rhs_ff, x_ff,
                            A_nz=None, B_nz=None):
    """One step's ff residual r = rhs - (Alpha (x) K + Beta (x) M) x for the
    rectangular per-step tables (rows nt, cols nt+1; x has nt+1 blocks:
    [prev_last, step blocks]).  mask zeroes constrained dofs like the f64
    SystemMatrix apply."""
    xin = (x_ff[0] * mask, x_ff[1] * mask)
    Kx, Mx = kron_ff.pair(xin)
    aK = ff_mix(A_ff, Kx, A_nz)
    bM = ff_mix(B_ff, Mx, B_nz)
    y = ff_add(aK, bM)
    y = (y[0] * mask, y[1] * mask)
    return ff_add(rhs_ff, ff_neg(y))
