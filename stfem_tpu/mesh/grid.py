"""Structured (block-Cartesian, optionally distorted) hex meshes.

The structured replacement for the reference's p4est forests: DoF indexing is
pure arithmetic on a tensor grid, so matrix-free apply is sum-factorized
einsums and the mesh itself is just {cell counts, bounding box, optional
vertex displacement field}.  Covers every shipped test/benchmark config of
the reference (all goldens use hyperRectangle grids; see SURVEY.md section 7).

Geometry data is evaluated once at setup:
  * Cartesian path: identical axis-aligned cells; J = diag(h)/cell constant.
  * General path (distorted grids): per-(cell, quad) detJxW and inverse
    Jacobian from the Q1 multilinear vertex mapping.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .fe import shape_data_1d


@dataclass(frozen=True)
class Geometry:
    """Quadrature-point geometry factors for one quadrature rule.

    cartesian: jxw is (q1,..,qd) (same every cell) and jinv_diag is (dim,).
    general:   jxw is (*cells, q1..qd), jinv is (*cells, q.., dim, dim) with
               jinv[..., e, d] = d xi_e / d x_d.
    """
    cartesian: bool
    jxw: np.ndarray
    jinv_diag: np.ndarray | None = None
    jinv: np.ndarray | None = None
    points: np.ndarray | None = None  # physical quad coords (general path)
    # per-axis inverse cell widths for non-uniform tensor grids:
    # jinv_axis[d] has shape cells[d] (diagonal Jacobian varying per cell)
    jinv_axis: tuple | None = None


class StructuredMesh:
    """Tensor-product mesh of a hyper-rectangle.

    Reference analogue: GridGenerator::subdivided_hyper_rectangle + global
    refinement + optional GridTools::distort_random (tests/tp_01.cc:83-90).
    """

    def __init__(self, subdivisions, lower, upper, refinement: int = 0,
                 distort: float = 0.0, distort_seed: int = 42,
                 cell_mask=None, axis_steps=None, vertex_map=None,
                 map_exact: bool = False):
        """axis_steps: optional per-axis lists of step widths (non-uniform
        tensor grid, e.g. the dfgBenchmarkSquare channel subdivision,
        reference grids.h:246-254); refinement splits each step into 2^r
        equal parts.  subdivisions/lower/upper are derived when given.

        vertex_map: optional smooth map applied to the vertex grid
        ((..., dim) -> (..., dim)), e.g. the squircle morph that turns the
        dfgBenchmarkSquare obstacle into the DFG cylinder (the structured
        analogue of the reference's curved manifolds, grids.h:196-242);
        geometry then uses the general per-cell Q1-mapping path.

        map_exact: evaluate geometry (quad points, Jacobians) ANALYTICALLY
        from vertex_map via jax.jacfwd instead of the Q1 vertex
        interpolation -- the curved boundary is then represented exactly
        (stronger than the reference's polynomial MappingQ manifolds);
        vertex_map must be jax-traceable on (..., dim) arrays."""
        if axis_steps is not None:
            subdivisions = [len(st) for st in axis_steps]
            upper = [float(lo + np.sum(st))
                     for lo, st in zip(lower, axis_steps)]
        self.dim = len(subdivisions)
        self.subdivisions = tuple(int(s) for s in subdivisions)
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.refinement = refinement
        self.cells = tuple(s * 2 ** refinement for s in self.subdivisions)
        self.h = (self.upper - self.lower) / np.array(self.cells)
        self.axis_steps = None
        if axis_steps is not None:
            self.axis_steps = tuple(
                np.repeat(np.asarray(st, dtype=np.float64) / 2 ** refinement,
                          2 ** refinement)
                for st in axis_steps)
        self.distort = distort
        self._vertices = None
        # cell_mask: 1.0 active / 0.0 removed cells (masked structured mesh,
        # the dfgBenchmarkSquare representation -- reference grids.h:243-323
        # builds exactly a subdivided rectangle with cells removed)
        self.cell_mask = None if cell_mask is None \
            else np.asarray(cell_mask, dtype=np.float64)
        if self.cell_mask is not None:
            assert self.cell_mask.shape == self.cells
        if distort != 0.0:
            self._vertices = self._distorted_vertices(distort, distort_seed)
        self.vertex_map = vertex_map
        self.map_exact = bool(map_exact)
        if vertex_map is not None:
            base = self._vertices if self._vertices is not None \
                else self.vertex_grid()
            self._vertices = np.asarray(vertex_map(base), dtype=np.float64)

    def coarsened(self) -> "StructuredMesh":
        """One level coarser mesh; for distorted meshes the coarse vertices
        are the even-strided fine vertices (matching deal.II's geometric
        coarsening sequence of a distorted fine triangulation)."""
        assert self.refinement > 0
        cm = None
        if self.cell_mask is not None:
            # coarse cell active iff all its children are (masks originate
            # at the base level, so any pooling choice agrees)
            cm = self.cell_mask
            for d in range(self.dim):
                shape = (cm.shape[:d] + (cm.shape[d] // 2, 2)
                         + cm.shape[d + 1:])
                cm = cm.reshape(shape).min(axis=d + 1)
        steps = None
        if self.axis_steps is not None:
            steps = [np.asarray(st).reshape(-1, 2 ** self.refinement)[:, 0]
                     * 2 ** self.refinement for st in self.axis_steps]
        m = StructuredMesh(self.subdivisions, self.lower, self.upper,
                           refinement=self.refinement - 1, distort=0.0,
                           cell_mask=cm, axis_steps=steps,
                           vertex_map=self.vertex_map,
                           map_exact=self.map_exact)
        if self._vertices is not None and self.vertex_map is None:
            m._vertices = self._vertices[
                tuple(slice(None, None, 2) for _ in range(self.dim))]
            m.distort = self.distort
        return m

    # -- reference tp_01.cc:87: minimal_cell_diameter BEFORE refinement ------
    @property
    def coarse_cell_diameter(self) -> float:
        h0 = (self.upper - self.lower) / np.array(self.subdivisions)
        return float(np.linalg.norm(h0))

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.cells))

    def n_dofs(self, degree: int) -> int:
        return int(np.prod(self.dof_shape(degree)))

    def dof_shape(self, degree: int) -> tuple[int, ...]:
        """Continuous Q_degree dof grid (lexicographic per axis)."""
        return tuple(c * degree + 1 for c in self.cells)

    def axis_vertices(self, d: int) -> np.ndarray:
        """1D vertex positions along axis d."""
        if self.axis_steps is not None:
            return np.concatenate(
                [[self.lower[d]],
                 self.lower[d] + np.cumsum(self.axis_steps[d])])
        return self.lower[d] + self.h[d] * np.arange(self.cells[d] + 1)

    def vertex_grid(self) -> np.ndarray:
        """Vertex coordinates, shape (*[c+1], dim)."""
        if self._vertices is not None:
            return self._vertices
        axes = [self.axis_vertices(d) for d in range(self.dim)]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack(mesh, axis=-1)

    def _distorted_vertices(self, factor: float, seed: int) -> np.ndarray:
        """Randomly shift interior vertices by up to factor*h_min per
        coordinate (deal.II GridTools::distort_random semantics with our own
        deterministic RNG -- documented deviation: different random stream).
        """
        axes = [self.lower[d] + self.h[d] * np.arange(self.cells[d] + 1)
                for d in range(self.dim)]
        mesh = np.meshgrid(*axes, indexing="ij")
        verts = np.stack(mesh, axis=-1)
        rng = np.random.default_rng(seed)
        hmin = float(np.min(self.h))
        shift = rng.uniform(-factor * hmin, factor * hmin, size=verts.shape)
        # keep the boundary fixed
        for d in range(self.dim):
            idx = [slice(None)] * self.dim
            idx[d] = 0
            shift[tuple(idx)] = 0.0
            idx[d] = -1
            shift[tuple(idx)] = 0.0
        return verts + shift

    def geometry(self, n_q_per_axis: int, degree_for_quad: int) -> Geometry:
        """Geometry factors at the tensor Gauss rule with n_q_per_axis points.

        degree_for_quad only selects the cached 1D shape data for quad points.
        Results are memoized per quadrature rule (operators constructed under
        jit tracing must not re-stage the setup-time numpy/jax work).
        """
        cache = self.__dict__.setdefault("_geometry_cache", {})
        if n_q_per_axis in cache:
            return cache[n_q_per_axis]
        g = self._geometry(n_q_per_axis)
        cache[n_q_per_axis] = g
        return g

    def _geometry(self, n_q_per_axis: int) -> Geometry:
        sd = shape_data_1d(1, n_q_per_axis)  # Q1 geometry mapping shapes
        qx, qw = sd.quad_x, sd.quad_w
        qshape = (n_q_per_axis,) * self.dim
        w_tensor = np.ones(qshape)
        for d in range(self.dim):
            shape = [1] * self.dim
            shape[d] = n_q_per_axis
            w_tensor = w_tensor * qw.reshape(shape)

        if self.vertex_map is not None and self.map_exact:
            return self._geometry_exact_map(n_q_per_axis, qx, w_tensor)

        if self._vertices is None and self.axis_steps is not None:
            # non-uniform tensor grid: separable per-cell diagonal Jacobian
            detj = np.ones(self.cells)
            for d in range(self.dim):
                shape = [1] * self.dim
                shape[d] = self.cells[d]
                detj = detj * self.axis_steps[d].reshape(shape)
            if self.cell_mask is not None:
                detj = detj * self.cell_mask
            jxw = detj.reshape(self.cells + (1,) * self.dim) * w_tensor
            return Geometry(cartesian=False, jxw=jxw,
                            jinv_axis=tuple(1.0 / st
                                            for st in self.axis_steps))
        if self._vertices is None:
            detj = float(np.prod(self.h))
            if self.cell_mask is not None:
                jxw = (self.cell_mask.reshape(self.cells + (1,) * self.dim)
                       * (w_tensor * detj))
                return Geometry(cartesian=False, jxw=jxw,
                                jinv_diag=1.0 / self.h)
            return Geometry(cartesian=True, jxw=w_tensor * detj,
                            jinv_diag=1.0 / self.h)

        # general path: Q1 mapping per cell
        verts = self._vertices  # (*[c+1], dim)
        dim = self.dim
        # cell corner array: (*cells, 2**dim, dim) in lexicographic corner
        # order (corner index bits = per-axis 0/1)
        corners = []
        for bits in itertools.product((0, 1), repeat=dim):
            sl = tuple(slice(b, self.cells[d] + b) for d, b in enumerate(bits))
            corners.append(verts[sl])
        corner_arr = np.stack(corners, axis=-2)  # (*cells, 2^dim, dim)

        # Q1 shape values/derivs at the tensor quad points
        # N[corner, q...] and dN[corner, q..., dxi]
        n_corners = 2 ** dim
        N = np.ones((n_corners,) + qshape)
        dN = np.ones((n_corners,) + qshape + (dim,))
        for ci, bits in enumerate(itertools.product((0, 1), repeat=dim)):
            for d, b in enumerate(bits):
                shape = [1] * dim
                shape[d] = n_q_per_axis
                f = qx if b else (1.0 - qx)
                df = np.ones_like(qx) if b else -np.ones_like(qx)
                N[ci] = N[ci] * f.reshape(shape)
                for e in range(dim):
                    dN[ci, ..., e] = dN[ci, ..., e] * (
                        (df if e == d else f).reshape(shape))
        # J[*cells, q..., dx, dxi] = sum_c corner[c, dx] dN[c, q.., dxi]
        J = np.einsum("...cx,cQe->...Qxe", corner_arr,
                      dN.reshape(n_corners, -1, dim))
        # J has shape (*cells, prod(q), dim, dim)
        detJ = np.linalg.det(J)
        if self.cell_mask is not None:
            # removed cells: zero quadrature weight, identity Jacobian (keeps
            # the inverse well-defined; their contributions vanish via jxw)
            inactive = (self.cell_mask == 0.0).reshape(-1)
            flatJ = J.reshape(-1, J.shape[-3], self.dim, self.dim)
            flatJ[inactive] = np.eye(self.dim)
            J = flatJ.reshape(J.shape)
            detJ = np.linalg.det(J)
            detJ = (detJ.reshape(self.n_cells, -1)
                    * self.cell_mask.reshape(-1, 1)).reshape(J.shape[:-2])
        Jinv = np.linalg.inv(J)  # [..., dxi, dx] since inv of [dx, dxi]
        jxw = detJ * w_tensor.reshape(-1)
        jxw = jxw.reshape(*self.cells, *qshape)
        jinv = Jinv.reshape(*self.cells, *qshape, dim, dim)
        pts = np.einsum("...cx,cQ->...Qx", corner_arr,
                        N.reshape(n_corners, -1))
        pts = pts.reshape(*self.cells, *qshape, dim)
        return Geometry(cartesian=False, jxw=jxw, jinv=jinv, points=pts)

    def _axis_steps_arrays(self):
        """Per-axis per-cell step widths (after refinement)."""
        if self.axis_steps is not None:
            return [np.asarray(st) for st in self.axis_steps]
        return [np.full(self.cells[d], self.h[d]) for d in range(self.dim)]

    def _base_quad_points(self, n_q_per_axis: int, qx) -> np.ndarray:
        """Pre-map (tensor-grid) quadrature coordinates, (*cells, *q, dim)."""
        dim = self.dim
        steps = self._axis_steps_arrays()
        pts = np.zeros(self.cells + (n_q_per_axis,) * dim + (dim,))
        for d in range(dim):
            starts = self.axis_vertices(d)[:-1]
            pos = starts[:, None] + steps[d][:, None] * qx[None, :]
            shape = [1] * (2 * dim)
            shape[d] = self.cells[d]
            shape[dim + d] = n_q_per_axis
            pts[..., d] = pos.reshape(shape)
        return pts

    def _geometry_exact_map(self, n_q_per_axis: int, qx,
                            w_tensor) -> Geometry:
        """Analytic geometry for vertex-mapped meshes: quad points, Jacobians
        and measures from jacfwd of the map composed with the (possibly
        non-uniform) tensor base grid.  Exact curved boundaries -- stronger
        than the reference's polynomial MappingQ manifolds (grids.h:196-242).
        """
        import jax
        import jax.numpy as jnp
        assert self.distort == 0.0, "map_exact with distortion: unsupported"
        dim = self.dim
        qshape = (n_q_per_axis,) * dim
        pts_base = self._base_quad_points(n_q_per_axis, qx)
        fmap = self.vertex_map
        with jax.ensure_compile_time_eval():
            flat = jnp.asarray(pts_base.reshape(-1, dim))
            pts = np.asarray(jax.vmap(fmap)(flat), dtype=np.float64)
            Jm = np.asarray(jax.vmap(jax.jacfwd(fmap))(flat),
                            dtype=np.float64)       # (N, dx, d_base)
        steps = self._axis_steps_arrays()
        stepvec = np.ones(self.cells + (dim,))
        for d in range(dim):
            shape = [1] * (dim + 1)
            shape[d] = self.cells[d]
            stepvec[..., d] = steps[d].reshape(shape[:-1])
        # chain rule with the diagonal base-grid Jacobian: dxi_d -> step_d
        J = (Jm.reshape(self.cells + qshape + (dim, dim))
             * stepvec.reshape(self.cells + (1,) * dim + (1, dim)))
        detJ = np.linalg.det(J)
        if self.cell_mask is not None:
            inactive = (self.cell_mask == 0.0)
            J[inactive] = np.eye(dim)
            detJ = np.linalg.det(J) * self.cell_mask.reshape(
                self.cells + (1,) * dim)
            active_min = detJ[~inactive].min() if (~inactive).any() else 1.0
        else:
            active_min = detJ.min()
        assert active_min > 0.0, \
            f"vertex_map folds cells (min detJ {active_min:.3e})"
        Jinv = np.linalg.inv(J)                      # [..., dxi, dx]
        jxw = detJ * w_tensor
        return Geometry(cartesian=False, jxw=jxw, jinv=Jinv,
                        points=pts.reshape(self.cells + qshape + (dim,)))

    def boundary_dof_mask(self, degree: int) -> np.ndarray:
        """1.0 for interior (free) dofs, 0.0 on the domain boundary
        (homogeneous Dirichlet elimination mask).  With a cell_mask, every
        dof touching a removed cell is also eliminated (obstacle no-slip /
        exterior dofs)."""
        mask = np.ones(self.dof_shape(degree))
        for d in range(self.dim):
            idx = [slice(None)] * self.dim
            idx[d] = 0
            mask[tuple(idx)] = 0.0
            idx[d] = -1
            mask[tuple(idx)] = 0.0
        if self.cell_mask is not None:
            k = degree
            inactive = self.cell_mask == 0.0
            for cidx in np.argwhere(inactive):
                sl = tuple(slice(int(c) * k, int(c) * k + k + 1)
                           for c in cidx)
                mask[sl] = 0.0
        return mask

    def dof_coordinates(self, degree: int) -> np.ndarray:
        """Coordinates of the Q_degree nodal points, shape (*dofshape, dim).

        For distorted meshes nodes are placed by the Q1 cell mapping of the
        reference GLL pattern (matches deal.II's MappingQ1 node placement).
        """
        from .fe import q_nodes_1d
        if self._vertices is None or (self.vertex_map is not None
                                      and self.map_exact):
            axes = []
            nodes = np.array(q_nodes_1d(degree))
            for d in range(self.dim):
                v = self.axis_vertices(d)
                widths = np.diff(v)
                pos = v[:-1, None] + widths[:, None] * nodes[None, :]
                axes.append(np.concatenate([pos[:, :-1].reshape(-1),
                                            [self.upper[d]]]))
            mesh = np.meshgrid(*axes, indexing="ij")
            base = np.stack(mesh, axis=-1)
            if self.vertex_map is not None and self.map_exact:
                # exact node placement on the curved geometry
                return np.asarray(self.vertex_map(base), dtype=np.float64)
            return base
        # distorted: multilinear interp of vertices at node pattern
        nodes = np.array(q_nodes_1d(degree))
        dim = self.dim
        out = np.zeros(self.dof_shape(degree) + (dim,))
        verts = self._vertices
        # loop cells (setup-time numpy; test-scale meshes only)
        for cidx in itertools.product(*[range(c) for c in self.cells]):
            corners = {}
            for bits in itertools.product((0, 1), repeat=dim):
                corners[bits] = verts[tuple(c + b for c, b in
                                            zip(cidx, bits))]
            local = np.zeros((degree + 1,) * dim + (dim,))
            for lidx in itertools.product(*[range(degree + 1)] * dim):
                xi = np.array([nodes[i] for i in lidx])
                pt = np.zeros(dim)
                for bits, cv in corners.items():
                    w = np.prod([xi[d] if b else 1 - xi[d]
                                 for d, b in enumerate(bits)])
                    pt += w * cv
                local[lidx] = pt
            sl = tuple(slice(c * degree, c * degree + degree + 1)
                       for c in cidx)
            out[sl] = local
        return out
