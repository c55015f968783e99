"""Poisson model family (FD, node-based).

Reference: exastencils_tpu/models/poisson.py.  `PoissonMGSolver` assembles
damped red-black Gauss-Seidel V(3,3)-cycles with full-weighting
restriction, trilinear prolongation and a CG coarse solve on the dense
backend of `device`; on CUDA and in 3D the levels with at least 5 nodes
per dimension run the whole-leg kernels K1/K2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from exastencils_tpu_torch.config import Knowledge

from exastencils_tpu_torch.core.domain import Domain, unit_domain
from exastencils_tpu_torch.core.field import DirichletBC, Field
from exastencils_tpu_torch.core.grid import NODE, level_grids
from exastencils_tpu_torch.core.stencil import Stencil, node_prolongation, node_restriction
from exastencils_tpu_torch.device import check_device, real_dtype
from exastencils_tpu_torch.parallel.backend import DenseBackend
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
    """FD Poisson with geometric multigrid on [0,1]^d on one device."""

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
        self.stencil = laplace_stencil(nd)
        self.restrict_op = node_restriction(nd)
        self.prolong_op = node_prolongation(nd)
        self.backend = DenseBackend(self.grids)

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
