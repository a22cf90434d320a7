"""Vanka grid time-solve stage: plain XLA form and a Pallas/Triton kernel.

In the grid Vanka apply (stmg/vanka.py::_vmult_grid) the multi-step
block-bidiagonal time solve
    y_s = Ginv w_s;   last_s = y_s[-1] + kappa * last_{s-1};
    y_s += last_{s-1} * cvec
is elementwise over the flattened eigen-position axis N with tiny per-step
(nt x nt) factors.  The XLA form (stacked FMAs + associative scan) is exact
but materializes several S*nt*N temporaries and log-depth scan passes
through device memory.

The GPU kernel runs one program per power-of-two tile of N (masked tail,
since N = (cells*(k+1))^dim is rarely a power of two).  Each program keeps
the nt*nt + nt factors of its tile in registers, loops over the S steps
carrying the scalar recurrence, and reads w and writes the result exactly
once.  time_solve() picks the kernel when lowering for CUDA and the XLA
form everywhere else (host-pinned setup traces the same modules for the
CPU).

Replaces (performance-only) the per-patch solve loop of the reference's
PreconditionVanka::vmult (include/stmg.h:832-872).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["time_solve", "time_solve_triton", "time_solve_xla"]

# tile of the position axis per program; a power of two (Triton block rule)
BLOCK = 512


def time_solve_xla(w, GinvT, cvecT, S: int, nt: int, out_dtype):
    """w: (S*nt, N) -> (S*nt, N) in out_dtype.  GinvT: (nt, nt, N),
    cvecT: (nt, N).  The nt x nt solve is unrolled into broadcast FMAs and
    the step recurrence is an O(log S) associative scan."""
    N = w.shape[-1]
    ws = w.reshape(S, nt, N)
    y = jnp.stack([sum(GinvT[i, j] * ws[:, j] for j in range(nt))
                   for i in range(nt)], axis=1)              # (S, nt, N)
    u = y[:, -1]
    kap = jnp.broadcast_to(cvecT[-1], u.shape)

    def comb(first, second):
        a1, b1 = first
        a2, b2 = second
        return a2 * a1, a2 * b1 + b2

    _, last = jax.lax.associative_scan(comb, (kap, u), axis=0)
    a_prev = jnp.concatenate([jnp.zeros_like(last[:1]), last[:-1]], axis=0)
    y = y + a_prev[:, None] * cvecT[None]
    return y.reshape(S * nt, N).astype(out_dtype)


def _kernel(w_ref, g_ref, c_ref, o_ref, *, S: int, nt: int, block: int,
            N: int):
    # every index is i32: under jax_enable_x64 Python ints become i64
    # while the program id stays i32, and mixed index types do not lower
    i32 = np.int32
    start = pl.program_id(0) * i32(block)
    mask = start + jnp.arange(block, dtype=jnp.int32) < i32(N)
    cols = pl.ds(start, block)
    g = [[plgpu.load(g_ref.at[i32(i), i32(j), cols], mask=mask, other=0.0)
          .astype(jnp.float32) for j in range(nt)] for i in range(nt)]
    c = [plgpu.load(c_ref.at[i32(i), cols], mask=mask, other=0.0)
         .astype(jnp.float32) for i in range(nt)]

    def step(s, prev):
        row = s * i32(nt)
        ws = [plgpu.load(w_ref.at[row + i32(j), cols], mask=mask, other=0.0)
              .astype(jnp.float32) for j in range(nt)]
        y = [sum(g[i][j] * ws[j] for j in range(nt)) for i in range(nt)]
        for i in range(nt):
            plgpu.store(o_ref.at[row + i32(i), cols],
                        (y[i] + prev * c[i]).astype(o_ref.dtype), mask=mask)
        return y[nt - 1] + c[nt - 1] * prev

    jax.lax.fori_loop(i32(0), i32(S), step, jnp.zeros((block,), jnp.float32))


def time_solve_triton(w, GinvT, cvecT, S: int, nt: int, out_dtype,
                      block: int = BLOCK, interpret: bool = False):
    """Pallas kernel through Triton; same contract as time_solve_xla.
    interpret=True runs the Pallas interpreter (CPU tests only)."""
    N = w.shape[-1]
    assert block & (block - 1) == 0, block
    return pl.pallas_call(
        partial(_kernel, S=S, nt=nt, block=block, N=N),
        grid=(pl.cdiv(N, block),),
        out_shape=jax.ShapeDtypeStruct((S * nt, N), out_dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="vanka_time_solve",
    )(w.reshape(S * nt, N), GinvT, cvecT)


def time_solve(w, GinvT, cvecT, S: int, nt: int, out_dtype):
    """The Triton kernel when lowering for CUDA, the XLA form elsewhere."""
    return jax.lax.platform_dependent(
        w, GinvT, cvecT,
        cuda=lambda *a: time_solve_triton(*a, S, nt, out_dtype),
        default=lambda *a: time_solve_xla(*a, S, nt, out_dtype))
