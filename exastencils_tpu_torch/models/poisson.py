"""Poisson model family (FD, node-based).

Reference: exastencils_tpu/models/poisson.py.  `PoissonMGSolver` assembles
damped red-black Gauss-Seidel V(3,3)-cycles with full-weighting
restriction, trilinear prolongation and a CG coarse solve on the dense
backend of `device`; on CUDA and in 3D the levels with at least 5 nodes
per dimension run the whole-leg kernels K1/K2 and the residual norm the
one-pass K13.  Given a `mesh`
(parallel/mesh.DomainMesh, one per rank), it runs on the sharded backend
instead, each rank the solver of its fragment (the reference's
:111-126).

With `kappa_fn` the solver solves -div(kappa grad u) = f instead
(`varcoeff_laplace_stencil`), on the dense backend only.  The JAX package
has no such model: its reference is the plain PyTorch file
portbench/references/poisson3d_varcoeff_vcycle.py.  On CUDA and in 3D the
levels with at least 5 nodes per dimension run the variable-coefficient
legs K11/K12, which read the stencil's face arrays (ops/cuda
`face_arrays`), and the finest level's residual norm the one-pass K13
on the same face arrays (`make_fused_res_norm_3d`); the coarser levels
run the plain ops.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from exastencils_tpu_torch.config import Knowledge

from exastencils_tpu_torch.core.domain import Domain, unit_domain
from exastencils_tpu_torch.core.field import DirichletBC, Field
from exastencils_tpu_torch.core.grid import NODE, LevelGrid, level_grids
from exastencils_tpu_torch.core.stencil import (BoundStencil, Stencil, node_prolongation,
                                                node_restriction)
from exastencils_tpu_torch.device import check_device, real_dtype
from exastencils_tpu_torch.parallel.backend import DenseBackend, ShardedBackend
from exastencils_tpu_torch.solver.synthesis import Equation, generate_solver


def laplace_stencil(ndim: int) -> Stencil:
    """Standard (2*ndim+1)-point FD Laplacian (-Delta) with grid-width-
    dependent coefficients; entries centre, then -/+ per dim."""
    st = Stencil("Laplace")
    st.add_entry(
        (0,) * ndim,
        lambda g: sum(2.0 / g.grid_width(d) ** 2 for d in range(g.ndim)),
    )
    for d in range(ndim):
        for s in (-1, 1):
            off = tuple(s if i == d else 0 for i in range(ndim))
            st.add_entry(off, lambda g, d=d: -1.0 / g.grid_width(d) ** 2)
    return st


def stretched_laplace_stencil(ndim: int) -> Stencil:
    """-Laplace on a non-uniform axis-aligned grid (grid_spacingModel
    "linearFct"): the exact 3-point FD formula per dim with the grid's
    node spacings h_l, h_r, -2/(h (h_l + h_r)) off the centre and
    sum_d 2/(h_l h_r) on it (the stretched Laplacian of the JAX package's
    tests/test_nonuniform.py:52-91, in any dimension).  Each off-centre
    coefficient is a per-dim 1-D tensor broadcast along its dim; the
    centre, a sum over the dims, is the one full-size coefficient."""

    def hl_hr(grid, d):
        p = np.asarray(grid.node_positions[d])
        hl, hr = np.empty_like(p), np.empty_like(p)
        hl[1:] = np.diff(p)
        hr[:-1] = np.diff(p)
        hl[0] = hl[1]
        hr[-1] = hr[-2]  # boundary rows are bc-masked, value irrelevant
        return hl, hr

    def along(grid, d, arr):
        shape = [1] * grid.ndim
        shape[d] = arr.shape[0]
        return torch.as_tensor(arr.reshape(shape), dtype=grid.dtype, device=grid.device)

    def center(grid):
        c = 0.0
        for d in range(grid.ndim):
            hl, hr = hl_hr(grid, d)
            c = c + along(grid, d, 2.0 / (hl * hr))
        return c

    st = Stencil("StretchedLaplace")
    st.add_entry((0,) * ndim, center)
    for d in range(ndim):
        for side in ("l", "r"):
            off = tuple((-1 if side == "l" else 1) if i == d else 0 for i in range(ndim))

            def coef(grid, d=d, side=side):
                hl, hr = hl_hr(grid, d)
                return along(grid, d, -2.0 / ((hl if side == "l" else hr) * (hl + hr)))

            st.add_entry(off, coef)
    return st


def face_coefficients(grid: LevelGrid, d: int, kappa_fn: Callable) -> torch.Tensor:
    """-kappa / h_d^2 at the midpoints of the edges along axis d, one
    midpoint more past each end: n + 1 values along d, the j-th at
    x_j - h_d / 2, and the node positions along the other axes.  The
    values past the ends only meet the Dirichlet ring."""
    h = grid.grid_width(d)
    coords = []
    for a in range(grid.ndim):
        x = grid.node_pos_1d(a)
        if a == d:
            x = torch.cat([x - 0.5 * h, x[-1:] + 0.5 * h])
        shape = [1] * grid.ndim
        shape[a] = x.shape[0]
        coords.append(x.reshape(shape))
    out = torch.empty([c.shape[a] for a, c in enumerate(coords)], dtype=grid.dtype,
                      device=grid.device)
    out.copy_(torch.as_tensor(kappa_fn(*coords), dtype=grid.dtype, device=grid.device))
    return out.mul_(-1.0 / h ** 2)


def minus_side(face: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """The coefficient of the neighbour at -e_d: face[i] (the midpoint
    i - 1/2), a view of the face array."""
    return face.narrow(d, 0, n)


def plus_side(face: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """The coefficient of the neighbour at +e_d: face[i + 1], a view."""
    return face.narrow(d, 1, n)


def coef_storage_bytes(stencils) -> int:
    """The bytes of the storage that the bound stencils' tensor
    coefficients hold, each storage counted once however many views share
    it."""
    seen = {}
    for st in stencils:
        for c in st.coefs:
            if isinstance(c, torch.Tensor) and c.dim():
                store = c.untyped_storage()
                seen[store.data_ptr()] = store.nbytes()
    return sum(seen.values())


@dataclass
class _FaceStencil(Stencil):
    """A stencil whose bind carries the level's face arrays
    (BoundStencil.faces), as `faces_of(grid)` gives them."""

    faces_of: Optional[Callable] = None

    def bind(self, grid: LevelGrid) -> BoundStencil:
        return replace(super().bind(grid), faces=self.faces_of(grid))


def varcoeff_laplace_stencil(ndim: int, kappa_fn: Callable) -> Stencil:
    """-div(kappa grad u), the conservative (2*ndim+1)-point node scheme
    on a uniform grid: (A u)_i = sum_d [k_{i+1/2 e_d} (u_i - u_{i+e_d})
    + k_{i-1/2 e_d} (u_i - u_{i-e_d})] / h_d^2, each k = kappa_fn(x, y[,
    z]) at the edge's midpoint, every level discretised on its own grid.
    Entries centre, then -/+ per dim, as `laplace_stencil`'s.

    A level holds ndim + 1 full-size arrays: the centre and one face
    array per axis (`face_coefficients`), whose minus and plus sides are
    views shifted by one (the operator is symmetric).  They are built at
    the first bind on a level grid, and every later bind shares them and
    carries the face arrays (BoundStencil.faces)."""
    built = {}

    def arrays(grid):
        if id(grid) not in built:
            if not grid.is_uniform:
                raise ValueError("the variable-coefficient stencil needs a uniform grid")
            n = grid.shape_of(NODE)
            faces = [face_coefficients(grid, d, kappa_fn) for d in range(ndim)]
            centre = minus_side(faces[0], 0, n[0]) + plus_side(faces[0], 0, n[0])
            for d in range(1, ndim):
                centre.add_(minus_side(faces[d], d, n[d])).add_(plus_side(faces[d], d, n[d]))
            centre.neg_()
            built[id(grid)] = (grid, centre, tuple(faces))  # the grid keeps its id unique
        return built[id(grid)][1:]

    st = _FaceStencil("VarCoeffLaplace", faces_of=lambda g: arrays(g)[1])
    st.add_entry((0,) * ndim, lambda g: arrays(g)[0])
    for d in range(ndim):
        for s, side in ((-1, minus_side), (1, plus_side)):
            off = tuple(s if i == d else 0 for i in range(ndim))
            st.add_entry(off, lambda g, d=d, side=side:
                         side(arrays(g)[1][d], d, g.shape_of(NODE)[d]))
    return st


def default_solution_2d(x, y):
    return torch.cos(math.pi * x) - torch.sin(2.0 * math.pi * y)


def default_rhs_2d(x, y):
    return (math.pi ** 2) * torch.cos(math.pi * x) - 4.0 * (math.pi ** 2) * torch.sin(
        2.0 * math.pi * y
    )


def default_solution_3d(x, y, z):
    return torch.cos(math.pi * x) - torch.sin(2.0 * math.pi * y) + torch.cos(3.0 * math.pi * z)


def default_rhs_3d(x, y, z):
    pi2 = math.pi ** 2
    return (
        pi2 * torch.cos(math.pi * x)
        - 4.0 * pi2 * torch.sin(2.0 * math.pi * y)
        + 9.0 * pi2 * torch.cos(3.0 * math.pi * z)
    )


@dataclass
class PoissonMGSolver:
    """FD Poisson with geometric multigrid on [0,1]^d: on one device, or
    with `mesh` (this rank's DomainMesh) and `shard_dims` (shards per
    spatial dim, default the mesh's shape) one fragment per rank on the
    rank's `device`.  With `kappa_fn` (dense only) the operator is
    -div(kappa grad u); `exact_fn` still defaults to `bc_fn`.  `coef_bytes`
    holds the bytes of the hierarchy's coefficient arrays, each storage
    once, and `coef_s` the seconds their build took (host clock, to a
    device sync); both 0 without `kappa_fn`."""

    knowledge: Knowledge
    device: object
    bc_fn: Callable = None  # Dirichlet boundary value g(x, y[, z])
    rhs_fn: Callable = None
    exact_fn: Callable = None  # for error reporting (PrintError@finest)
    omega: float = 0.8
    smoother: str = "RBGS"
    n_pre: int = 3
    n_post: int = 3
    cgs: str = "CG"
    cgs_max_its: int = 128
    cgs_res_reduction: float = 1e-3
    domain: Optional[Domain] = None
    mesh: object = None  # parallel/mesh.DomainMesh -> the sharded backend
    shard_dims: Optional[tuple] = None  # shards per spatial dim
    # kappa(x, y[, z]): solve -div(kappa grad u) = f (varcoeff_laplace_stencil)
    kappa_fn: Callable = None

    def __post_init__(self):
        k = self.knowledge
        nd = k.dimensionality
        self.device = check_device(self.device)
        if self.bc_fn is None:
            self.bc_fn = default_solution_2d if nd == 2 else default_solution_3d
        if self.rhs_fn is None:
            self.rhs_fn = default_rhs_2d if nd == 2 else default_rhs_3d
        if self.exact_fn is None:
            self.exact_fn = self.bc_fn
        if self.domain is None:
            self.domain = unit_domain(nd)
        self.dtype = real_dtype(k)
        self.grids = level_grids(self.domain, k, self.device, dtype=self.dtype)
        if self.kappa_fn is None:
            self.stencil = laplace_stencil(nd)
        elif self.mesh is None:
            self.stencil = varcoeff_laplace_stencil(nd, self.kappa_fn)
        else:
            raise ValueError("kappa_fn runs on the dense backend only")
        self.coef_bytes, self.coef_s = 0, 0.0
        if self.kappa_fn is not None:
            # build every level's arrays here, so that the build is timed
            # alone; the solver's binds share them
            t = time.perf_counter()
            bound = [self.stencil.bind(g) for g in self.grids.values()]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.coef_s = time.perf_counter() - t
            self.coef_bytes = coef_storage_bytes(bound)
        self.restrict_op = node_restriction(nd)
        self.prolong_op = node_prolongation(nd)
        if self.mesh is None:
            self.backend = DenseBackend(self.grids)
        else:
            dims = tuple(self.shard_dims or self.mesh.shape)
            ghost = max(1, k.comm_ghostWidth, k.comm_haloAggregationFactor)
            if k.tpu_use_pallas and nd == 3:
                # wide halos let the sharded whole-leg kernels run one
                # exchange per leg: the down leg needs 2K+2 layers (K
                # iterations + residual radius + restriction tap)
                ghost = max(ghost, 2 * max(self.n_pre, self.n_post) + 2)
            self.backend = ShardedBackend(self.grids, self.mesh, dims, ghost=ghost,
                                          replicate_below=k.tpu_coarse_replicate_threshold)

        self.solution = Field(
            "Solution",
            self.domain,
            NODE,
            bc={k.maxLevel: DirichletBC(self.bc_fn)}
            | {lvl: DirichletBC(0.0) for lvl in range(k.minLevel, k.maxLevel)},
        )
        self.equation = Equation(self.solution, self.stencil, rhs_fn=self.rhs_fn)
        self.gen = generate_solver(
            self.equation,
            k,
            self.backend,
            self.grids,
            options={
                "smoother": self.smoother,
                "smoother_damping": self.omega,
                "smoother_numPre": self.n_pre,
                "smoother_numPost": self.n_post,
                "cgs": self.cgs,
                "cgs_maxNumIts": self.cgs_max_its,
                "cgs_targetResReduction": self.cgs_res_reduction,
            },
            error_fn=self.exact_fn,
            restrict_op=self.restrict_op,
            prolong_op=self.prolong_op,
        )
        self.mg = self.gen.mg
        self.levels = self.mg.levels
        self._cycle = self.gen._cycle
        self._res_norm = self.gen._res_norm
        self._err = self.gen._err

    def init_state(self):
        """initFieldsWithZero + InitRHS@finest + apply bc to Solution@finest."""
        return self.gen.init_state()

    def max_error(self, sol):
        return self._err(sol)

    def solve(self, max_its: int = 100, target_res_reduction: float = 1e-10,
              out=None, print_error: bool = True, state=None):
        """Host-driven solve with the print sequence of Solve@finest
        (initial residual, then per cycle: max error, residual)."""
        return self.gen.solve(
            out=out,
            max_its=max_its,
            target_res_reduction=target_res_reduction,
            print_error=print_error,
            state=state,
        )

    def solve_fused(self, max_its: int = 100, target_res_reduction: float = 1e-10, state=None):
        """Device-resident solve (reference `solve_fused`,
        models/poisson.py:197-202): (sol, init_res, cur_res, it) as device
        values, no line printed."""
        return self.gen.solve_fused(max_its=max_its, target_res_reduction=target_res_reduction,
                                    state=state)
