"""Geometric multigrid V-cycle.

Reference: exastencils_tpu/solver/mg.py (`MGLevelOps`, `Multigrid.cycle`,
`residual`, `res_norm`, `solve`).  V-cycles only in this port (W/F, FMG
and FAS are later work).  PyTorch runs eagerly, so the level hierarchy is
walked in Python on every cycle.

In-place contract: where a level has whole-leg kernels, the cycle updates
the iterate in place (the reference donated it); callers that reuse the
tensor they pass in must clone it first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from exastencils_tpu_torch.ops.reductions import dot, norm_l2


def _ident(x):
    return x


@dataclass
class MGLevelOps:
    """Everything the cycle needs on one level."""

    shape: tuple
    A_apply: Callable  # sol -> A sol
    smooth: Callable  # sol, rhs -> sol (one full smoother iteration)
    bc_sol: Callable = _ident
    bc_res: Callable = _ident
    restrict_fn: Optional[Callable] = None  # fine residual -> coarse rhs
    prolong_fn: Optional[Callable] = None  # coarse sol -> fine correction
    dot_fn: Callable = dot
    norm_fn: Callable = norm_l2
    # whole-leg kernels K1/K2 (ops/cuda): pre-smooth + residual + restrict
    # and prolong + correct + post-smooth, each updating sol in place;
    # they supersede the smoothing and transfer calls when set
    down_leg_fn: Optional[Callable] = None  # (sol, rhs) -> (sol, rhs_c)
    up_leg_fn: Optional[Callable] = None  # (sol, sol_c, rhs) -> sol


def _smooth_n(lv: MGLevelOps, n: int, sol, rhs):
    for _ in range(n):
        sol = lv.smooth(sol, rhs)
    return sol


@dataclass
class Multigrid:
    """V-cycle over a static level hierarchy."""

    levels: Dict[int, MGLevelOps]
    min_level: int
    max_level: int
    coarse_solve: Callable  # (sol, rhs) -> sol
    n_pre: int = 3
    n_post: int = 3

    def residual(self, level: int, sol, rhs):
        lv = self.levels[level]
        return lv.bc_res(rhs - lv.A_apply(sol))

    def cycle(self, sol, rhs, level: Optional[int] = None):
        """One V-cycle on `level` (default finest)."""
        level = self.max_level if level is None else level
        lv = self.levels[level]
        if level == self.min_level:
            return self.coarse_solve(sol, rhs)
        coarse = self.levels[level - 1]

        if lv.down_leg_fn is not None:
            sol, rhs_c = lv.down_leg_fn(sol, rhs)
        else:
            sol = _smooth_n(lv, self.n_pre, sol, rhs)
            rhs_c = lv.restrict_fn(self.residual(level, sol, rhs))

        sol_c = coarse.bc_sol(torch.zeros(coarse.shape, dtype=rhs_c.dtype,
                                          device=rhs_c.device))
        sol_c = self.cycle(sol_c, rhs_c, level - 1)

        if lv.up_leg_fn is not None:
            return lv.up_leg_fn(sol, sol_c, rhs)
        sol = lv.bc_sol(sol + lv.prolong_fn(sol_c))
        return _smooth_n(lv, self.n_post, sol, rhs)

    def res_norm(self, sol, rhs, level: Optional[int] = None):
        level = self.max_level if level is None else level
        return self.levels[level].norm_fn(self.residual(level, sol, rhs))

    def solve(
        self,
        sol,
        rhs,
        target_res_reduction: float = 1e-5,
        max_its: int = 128,
        callback: Callable = None,
    ):
        """Host-driven solve loop of Solve@finest: initial residual, then
        cycle until `curRes <= eps * initRes` or `max_its`, with
        `callback(it, sol, cur_res)` after every cycle."""
        init_res = self.res_norm(sol, rhs)
        cur_res = init_res
        it = 0
        while it < max_its and not bool(cur_res <= target_res_reduction * init_res):
            it += 1
            sol = self.cycle(sol, rhs)
            cur_res = self.res_norm(sol, rhs)
            if callback is not None:
                callback(it, sol, cur_res)
        return sol, init_res, cur_res, it
