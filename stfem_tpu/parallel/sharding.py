"""Multi-chip distribution of the space-time solver.

Parallelism mapping (SURVEY.md section 2.4): the reference's MPI domain
decomposition becomes sharding of the SPATIAL dof-grid axes over a JAX device
mesh; time-direction operations (Alpha/Beta mixing, time transfers, wave
recovery) are block-local and need no communication, matching the reference's
structural fact that only the spatial direction communicates.

Strategy (GSPMD): annotate the block vector [n_blocks, *dofgrid] with
PartitionSpec(None, 'x', 'y'[, 'z']) and jit the whole slab solve; XLA
partitions the sum-factorization einsums and inserts halo collectives for the
cell gather/overlap-add scatter.  Coarse MG levels smaller than the
device grid degrade to (tiny) all-gathers, mirroring the reference's
repartitioning policy for coarse levels.  Pipeline/expert parallelism are
absent by design (absent in the reference, SURVEY.md section 2.4).
"""
from __future__ import annotations

import numpy as np

import jax
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def spatial_mesh(n_devices: int | None = None, dim: int = 2,
                 devices=None, shard_z: bool = False) -> Mesh:
    """Device mesh over the spatial axes.

    For dim >= 2 the default is a near-square 2-axis mesh over (x, y).
    shard_z=True (3D) factors the devices over THREE axes (x, y, z) as
    near-cubic as possible, which minimizes each shard's halo surface; the
    cards are joined all to all, so the mesh follows the algorithm alone.
    1D problems shard x only.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if dim == 1:
        return Mesh(np.array(devices), ("x",))
    if dim >= 3 and shard_z:
        # factor n_devices = a*b*c as near-cubic as possible
        a = int(np.floor(n_devices ** (1.0 / 3.0)))
        while n_devices % a:
            a -= 1
        rem = n_devices // a
        b = int(np.floor(np.sqrt(rem)))
        while rem % b:
            b -= 1
        arr = np.array(devices).reshape(a, b, rem // b)
        return Mesh(arr, ("x", "y", "z"))
    # factor n_devices = a*b as square as possible
    a = int(np.floor(np.sqrt(n_devices)))
    while n_devices % a:
        a -= 1
    arr = np.array(devices).reshape(a, n_devices // a)
    return Mesh(arr, ("x", "y"))


def block_vector_spec(mesh: Mesh, dim: int) -> PartitionSpec:
    """PartitionSpec for [n_blocks, *dofgrid]: blocks replicated, leading
    spatial axes sharded."""
    names = list(mesh.axis_names)
    spatial = [names[i] if i < len(names) else None for i in range(dim)]
    return PartitionSpec(None, *spatial)


def shard_block_vector(x, mesh: Mesh):
    dim = x.ndim - 1
    return jax.device_put(x, NamedSharding(mesh, block_vector_spec(mesh, dim)))


def level_sharding_policy(mesh: Mesh, gmg,
                          min_dofs_per_device: int = 512):
    """Explicit per-level shardings for the STMG V-cycle.

    Fine levels shard the spatial dof axes over the device mesh; once a
    level holds fewer than min_dofs_per_device spatial dofs per device the
    level (and everything below) is REPLICATED -- tiny coarse problems are
    cheaper recomputed everywhere than communicated, mirroring the
    reference's coarse-level repartitioning (RepartitioningPolicy /
    per-level partitioners, include/stmg.h:563-586).

    Returns a list (len = n_levels) of NamedShardings to install with
    install_level_shardings(gmg, ...).
    """
    n_dev = int(np.prod([s for s in mesh.devices.shape]))
    out = []
    for lvl in gmg.levels:
        n_space = int(np.prod(lvl.dof_shape))
        if n_space >= min_dofs_per_device * n_dev:
            spec = block_vector_spec(mesh, len(lvl.dof_shape))
        else:
            spec = PartitionSpec()  # replicated
        out.append(NamedSharding(mesh, spec))
    return out


def enable_halo_mode(*modules):
    """Switch every Kronecker engine reachable from `modules` to the
    banded pad+slice apply form (KronAssembled.force_banded): under a
    sharded spatial axis GSPMD lowers the shifted slices to one-hop
    surface-sized collective-permute halo exchanges (the reference's
    ghost-exchange pattern, include/stmg.h:843-871) instead of the dense
    per-axis matmul's full-array partial-sum all-reduces.

    This is the PROGRAMMATIC switch (no env state): call it on every
    operator that participates in a sharded solve, before its first jit
    trace.  install_level_shardings() calls it on the GMG automatically,
    so the V-cycle halos are one-hop whenever a spatial mesh axis is
    sharded (VERDICT r4 #7); top-level system matrices built outside the
    hierarchy must be passed explicitly.  Pytree aux caches are cleared
    so the flipped static state takes effect on already-flattened
    modules."""
    seen = set()

    def walk(o):
        if o is None or id(o) in seen:
            return
        seen.add(id(o))
        if isinstance(o, (list, tuple, set)):
            for v in o:
                walk(v)
            return
        if isinstance(o, dict):
            for v in o.values():
                walk(v)
            return
        d = getattr(o, "__dict__", None)
        if not isinstance(d, dict):
            return
        if "force_banded" in d:
            d["force_banded"] = True
        d.pop("_module_aux", None)
        for k, v in list(d.items()):
            if k != "_module_aux":
                walk(v)

    for m in modules:
        walk(m)
    return modules[0] if len(modules) == 1 else modules


def install_level_shardings(gmg, shardings):
    """Attach per-level shardings to a GMG (its V-cycle then pins each
    level's defect/correction with with_sharding_constraint).  Clears the
    pytree aux cache so the new static state takes effect, and flips the
    level operators' Kronecker applies into halo (banded) mode -- a
    sharded hierarchy always wants one-hop halo exchanges, so the switch
    is automatic here (VERDICT r4 #7)."""
    assert len(shardings) == len(gmg.levels)
    enable_halo_mode(gmg)
    gmg.level_shardings = list(shardings)
    return gmg
