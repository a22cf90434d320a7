"""Distributed-communication backend: the single place all explicit
collectives live (the JAX analogue of the reference's MPI layer,
SURVEY.md section 2.4 / section 5 "Distributed communication backend").

The reference communicates through deal.II wrappers around MPI:
  * point-to-point ghost exchange baked into MatrixFree cell loops and
    distributed-vector update_ghost_values()/compress(add)
    (include/stmg.h:843-871)
  * MPI::sum reductions for dot products and functionals
    (include/operators.h:1387,1413)
  * tiny metadata gathers (prefix sums, compute_block_matrix.h:24-25)

Here those become exactly three device collectives under shard_map:
  * halo_accumulate / halo_accumulate_nd -- one-hop jax.lax.ppermute
    add-accumulation of the shared interface dof planes (the compress(add)
    analogue; the gather direction needs no message because the shared
    plane is replicated on both neighbors, like ghosted partitioners)
  * psum_dot / psum_norm -- interface-weighted local reduction + psum
    (the MPI::sum analogue; weights de-duplicate the replicated planes)
  * gather_metadata -- all_gather for tiny time-direction/control metadata

plus the two-level mesh constructor expressing a multi-host topology:
intra-host axes (cards joined by NVLink) and a 'dcn' axis across hosts
(nested mesh axes; shardings that only touch ('x','y') keep all traffic
inside a host).

Time-direction operations (Alpha/Beta mixing, time transfers, wave
v-recovery) are block-local by construction and never appear here --
matching the reference's structural fact that only space communicates
(SURVEY.md section 3.5).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh


def halo_accumulate(y: jnp.ndarray, axis_name: str, array_axis: int,
                    periodic: bool = False) -> jnp.ndarray:
    """Add-accumulate the shared interface planes along ONE sharded axis.

    Each shard owns a contiguous cell slab plus the shared dof plane at
    internal interfaces (replicated on both neighbors).  After a local
    operator apply, the first/last planes hold PARTIAL sums; this exchanges
    them one hop to the neighbor shard and adds -- the direct analogue of
    deal.II's compress(add) after a cell loop (reference stmg.h:843-871).

    y: local array; `array_axis` is the (positive) axis holding the sharded
    dof direction.  Must run inside shard_map with `axis_name` bound.
    """
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        return y
    idx = jax.lax.axis_index(axis_name)
    sl_first = [slice(None)] * y.ndim
    sl_first[array_axis] = slice(0, 1)
    sl_last = [slice(None)] * y.ndim
    sl_last[array_axis] = slice(-1, None)
    first = y[tuple(sl_first)]
    last = y[tuple(sl_last)]
    from_right = jax.lax.ppermute(
        first, axis_name, [(i, (i - 1) % n) for i in range(n)])
    from_left = jax.lax.ppermute(
        last, axis_name, [(i, (i + 1) % n) for i in range(n)])
    if not periodic:
        from_right = jnp.where(idx < n - 1, from_right, 0.0)
        from_left = jnp.where(idx > 0, from_left, 0.0)
    y = y.at[tuple(sl_last)].add(from_right)
    y = y.at[tuple(sl_first)].add(from_left)
    return y


def halo_accumulate_nd(y: jnp.ndarray, axis_names: tuple[str, ...],
                       array_axes: tuple[int, ...]) -> jnp.ndarray:
    """Multi-axis interface accumulation: sequential per-axis exchanges.

    Corners/edges shared by 2^d shards are handled by the SEQUENCING: the
    second exchange forwards planes already accumulated by the first, so
    every interface dof receives all its neighbors' contributions without
    explicit diagonal messages (2*dim one-hop ppermutes total, vs the
    reference's general point-to-point ghost pattern).
    """
    assert len(axis_names) == len(array_axes)
    for name, ax in zip(axis_names, array_axes):
        y = halo_accumulate(y, name, ax)
    return y


def interface_weights(local_shape: tuple[int, ...],
                      axis_names: tuple[str, ...],
                      array_axes: tuple[int, ...],
                      dtype=jnp.float64) -> jnp.ndarray:
    """Multiplicity weights de-duplicating replicated interface planes.

    A dof on an internal interface plane is replicated on both neighbor
    shards (a corner on 4, etc.); weighting it by 1/2 per shared axis makes
    sum-over-shards of (w * f) equal the global sum -- the analogue of the
    reference's locally-OWNED-dof partitioning of reductions.  Must run
    inside shard_map (reads axis_index).
    """
    w = jnp.ones(local_shape, dtype)
    for name, ax in zip(axis_names, array_axes):
        n = jax.lax.axis_size(name)
        idx = jax.lax.axis_index(name)
        L = local_shape[ax]
        pos = jnp.arange(L)
        shape = [1] * len(local_shape)
        shape[ax] = L
        first_shared = jnp.where(idx > 0, 0.5, 1.0)
        last_shared = jnp.where(idx < n - 1, 0.5, 1.0)
        wax = jnp.where(pos == 0, first_shared,
                        jnp.where(pos == L - 1, last_shared, 1.0))
        w = w * wax.reshape(shape).astype(dtype)
    return w


def psum_dot(a: jnp.ndarray, b: jnp.ndarray, axis_names: tuple[str, ...],
             array_axes: tuple[int, ...]) -> jnp.ndarray:
    """Global <a, b> from per-shard arrays with replicated interface planes
    (reference MPI::sum reductions, operators.h:1387)."""
    w = interface_weights(a.shape, axis_names, array_axes, a.dtype)
    loc = jnp.sum(w * a * b)
    return jax.lax.psum(loc, axis_names)


def psum_norm(a: jnp.ndarray, axis_names: tuple[str, ...],
              array_axes: tuple[int, ...]) -> jnp.ndarray:
    return jnp.sqrt(psum_dot(a, a, axis_names, array_axes))


def gather_metadata(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """all_gather for TINY control/time-direction metadata only (the
    reference's prefix-sum/metadata exchanges, compute_block_matrix.h:24-25).
    Bulk dof data must ride halo_accumulate/psum instead."""
    return jax.lax.all_gather(x, axis_name)


def two_level_mesh(n_slices: int, ici_shape: tuple[int, ...],
                   devices=None,
                   axis_names: tuple[str, ...] = ("dcn", "x", "y")) -> Mesh:
    """Nested device mesh: leading 'dcn' axis across hosts, trailing axes
    over the cards within a host (ici_shape).

    Shardings that only use the intra-host axis names keep every
    collective inside a host; only reductions/shardings naming the 'dcn'
    axis cross hosts -- the two-level topology rule (SURVEY.md section 5).
    On real multi-host hardware the devices argument should come from
    mesh_utils.create_hybrid_device_mesh; for one host or virtual meshes a
    row-major reshape is the correct layout.
    """
    if devices is None:
        devices = jax.devices()
    need = n_slices * int(np.prod(ici_shape))
    assert len(devices) >= need, (len(devices), need)
    arr = np.array(devices[:need]).reshape((n_slices,) + tuple(ici_shape))
    assert len(axis_names) == arr.ndim
    return Mesh(arr, axis_names)
