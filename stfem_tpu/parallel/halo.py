"""Explicit SPMD domain decomposition with ppermute halo exchange.

This is the hand-written counterpart of the GSPMD path in
parallel/sharding.py: the spatial domain is split into contiguous cell slabs
along the first grid axis, each device owns its cell slab plus the SHARED dof
plane at internal interfaces (replicated on both neighbors, like the
reference's ghosted partitioners, SURVEY.md section 2.4).  One operator apply
is then: local sum-factorized sweep + ONE neighbor exchange (jax.lax.ppermute
to the adjacent shards) accumulating the interface-plane contributions -- the
direct analogue of deal.II's ghost-value update/compress around cell loops.

Time-direction operations stay embarrassingly parallel (block-local), exactly
mirroring the reference's structural property that only space communicates.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..system import SystemMatrix


def split_dof_grid(x: np.ndarray, n_shards: int, degree: int,
                   axis: int) -> list[np.ndarray]:
    """Split a dof-grid array into overlapping per-shard slabs (interface
    plane replicated)."""
    n_dofs = x.shape[axis]
    n_cells = (n_dofs - 1) // degree
    assert n_cells % n_shards == 0
    cl = n_cells // n_shards
    out = []
    for s in range(n_shards):
        lo = s * cl * degree
        hi = (s + 1) * cl * degree + 1
        out.append(np.take(x, np.arange(lo, hi), axis=axis))
    return out


def join_dof_grid(parts: list[np.ndarray], degree: int,
                  axis: int) -> np.ndarray:
    """Inverse of split_dof_grid (drops the replicated planes)."""
    pieces = [np.take(parts[0], np.arange(parts[0].shape[axis]), axis=axis)]
    for p in parts[1:]:
        pieces.append(np.take(p, np.arange(1, p.shape[axis]), axis=axis))
    return np.concatenate(pieces, axis=axis)


def make_sharded_vmult(matrix_local: SystemMatrix, mesh: Mesh,
                       axis_name: str | tuple[str, ...] = "x"):
    """Sharded space-time system apply.

    matrix_local: a SystemMatrix built for the LOCAL sub-mesh (each shard's
    cell slab with its own Dirichlet mask slice).  Returns a function on
    [n_blocks, local_dofs_x, ny, ...] per-shard arrays (use under shard_map
    or jit with explicit shardings).  axis_name may be a tuple of mesh axis
    names for multi-axis domain decomposition; spatial array axis i+1 is
    exchanged along axis_name[i] (corners handled by the sequential
    exchanges -- see comm.halo_accumulate_nd).
    """
    from .comm import halo_accumulate_nd

    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    array_axes = tuple(range(1, 1 + len(names)))

    def vmult(x_local):
        y = matrix_local.vmult(x_local)
        return halo_accumulate_nd(y, names, array_axes)

    return vmult


def local_submesh(mesh_full, shard: int | tuple[int, ...],
                  n_shards: int | tuple[int, ...]):
    """The shard's cell slab as a StructuredMesh.

    shard/n_shards may be ints (first-axis split, the 1-axis layout) or
    tuples over the leading axes (multi-axis domain decomposition); axes
    beyond len(n_shards) stay unsplit."""
    from ..mesh.grid import StructuredMesh
    cells = mesh_full.cells
    dim = mesh_full.dim
    sh = (shard,) if isinstance(shard, int) else tuple(shard)
    ns = (n_shards,) if isinstance(n_shards, int) else tuple(n_shards)
    assert len(sh) == len(ns) <= dim
    sh = sh + (0,) * (dim - len(sh))
    ns = ns + (1,) * (dim - len(ns))
    cl = []
    lo = np.array(mesh_full.lower, dtype=float)
    hi = np.array(mesh_full.upper, dtype=float)
    for d in range(dim):
        assert cells[d] % ns[d] == 0
        cl.append(cells[d] // ns[d])
        lo[d] = mesh_full.lower[d] + sh[d] * cl[d] * mesh_full.h[d]
        hi[d] = lo[d] + cl[d] * mesh_full.h[d]
    sub = StructuredMesh([1] * dim, lo, hi, refinement=0)
    # overwrite cell structure with the local split counts
    sub.cells = tuple(cl)
    sub.h = np.array(list(mesh_full.h))
    return sub


def local_mask(mesh_full, degree: int, shard: int | tuple[int, ...],
               n_shards: int | tuple[int, ...]):
    """Per-shard slice of the global Dirichlet mask (interface planes are
    interior dofs, NOT eliminated)."""
    full = mesh_full.boundary_dof_mask(degree)
    sh = (shard,) if isinstance(shard, int) else tuple(shard)
    ns = (n_shards,) if isinstance(n_shards, int) else tuple(n_shards)
    out = full
    for d, (s, n) in enumerate(zip(sh, ns)):
        out = split_dof_grid(out, n, degree, axis=d)[s]
    return out
