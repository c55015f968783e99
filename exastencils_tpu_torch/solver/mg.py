"""Geometric multigrid cycles: V, W and F, FAS, and full multigrid.

Reference: exastencils_tpu/solver/mg.py (`MGLevelOps`, `Multigrid.cycle`,
`fmg`, `residual`, `res_norm`, `solve`, `solve_jit`).  The reference jits
the cycle and the residual norm; here, on CUDA, `solve` replays them as
captured CUDA graphs (runtime/staging `Staged`), and `solve_jit` keeps
the whole solve on the device, as a device loop over cycles whose only
host read per cycle is its exit test (the coarse CG inside the cycle is a
device loop of its own).  The level hierarchy is walked in Python only
when a cycle runs eagerly or is captured.  The dense backend has no halo
exchange, so the reference's `exchange` calls are absent, and every level
above the coarsest has `restrict_fn`/`prolong_fn`.

In-place contract: where a level has kernels (ops/cuda), the cycle may
update the iterate in place (the reference donated it); callers that
reuse the tensor they pass in must clone it first.  K1-K3 and K5 update
in place; the wavefronts K6-K8 (EXA_STREAM_V1=1) write new tensors, so
the cycle always continues with the tensor a kernel returns.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, Optional

import torch

from exastencils_tpu_torch.ops.reductions import dot, norm_l2
from exastencils_tpu_torch.runtime.staging import Staged, device_loop


def _ident(x):
    return x


def _smooth_n(lv, n: int, sol, rhs):
    """n smoother iterations: the fused smoother (K3 or K6) where the
    level has one, else n calls of `smooth`."""
    if n <= 0:
        return sol
    if lv.smooth_n is not None:
        return lv.smooth_n(n, sol, rhs)
    for _ in range(n):
        sol = lv.smooth(sol, rhs)
    return sol


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
    # fused n-iteration smoother K3 (K6 under EXA_STREAM_V1=1, ops/cuda);
    # overrides `smooth`
    smooth_n: Optional[Callable] = None  # (n, sol, rhs) -> sol
    # fused transfers K4 (residual + restriction) and K5 (prolongation +
    # correction, in place on sol)
    res_restrict_fn: Optional[Callable] = None  # (sol, rhs) -> rhs_c
    prolong_correct_fn: Optional[Callable] = None  # (sol, sol_c) -> sol
    # whole-leg kernels K1/K2 (K7/K8 under EXA_STREAM_V1=1): pre-smooth +
    # residual + restrict and prolong + correct + post-smooth, each
    # returning the new sol; they supersede the pair above and the
    # smoothing calls when set
    down_leg_fn: Optional[Callable] = None  # (sol, rhs) -> (sol, rhs_c)
    up_leg_fn: Optional[Callable] = None  # (sol, sol_c, rhs) -> sol


@dataclass
class Multigrid:
    """V/W/F-cycle over a static level hierarchy."""

    levels: Dict[int, MGLevelOps]
    min_level: int
    max_level: int
    coarse_solve: Callable  # (sol, rhs) -> sol
    n_pre: int = 3
    n_post: int = 3
    cycle_type: str = "V"  # V | W | F
    fas: bool = False
    # user hooks per stage, "pre" and "post": (level, sol, rhs) -> (sol, rhs)
    modifications: Dict[str, Callable] = dc_field(default_factory=dict)

    def residual(self, level: int, sol, rhs):
        lv = self.levels[level]
        return lv.bc_res(rhs - lv.A_apply(sol))

    def _hook(self, stage: str, level: int, sol, rhs):
        fn = self.modifications.get(stage)
        return fn(level, sol, rhs) if fn is not None else (sol, rhs)

    def cycle(self, sol, rhs, level: Optional[int] = None, kind: Optional[str] = None):
        """One multigrid cycle on `level` (default finest).

        kind: V = one recursion; W = two recursions (same kind);
        F = F-recursion followed by a V-recursion."""
        level = self.max_level if level is None else level
        kind = self.cycle_type if kind is None else kind
        if kind not in ("V", "W", "F"):
            raise ValueError(f"unknown cycle type {kind!r} (V | W | F)")
        lv = self.levels[level]

        if level == self.min_level:
            return self.coarse_solve(sol, rhs)

        sol, rhs = self._hook("pre", level, sol, rhs)
        fused_down = lv.down_leg_fn is not None and not self.fas
        if not fused_down:
            sol = _smooth_n(lv, self.n_pre, sol, rhs)

        coarse = self.levels[level - 1]
        if fused_down:
            sol, rhs_c = lv.down_leg_fn(sol, rhs)
        elif lv.res_restrict_fn is not None and not self.fas:
            rhs_c = lv.res_restrict_fn(sol, rhs)
        else:
            rhs_c = lv.restrict_fn(self.residual(level, sol, rhs))
        if self.fas:
            # tau-corrected coarse problem A_c(u_c) = R r + A_c(R u), initial
            # guess u_c = R u, correction P(u_c - R u).  The coarse cycle may
            # update its iterate in place, so it gets a copy of R u.
            sol_c0 = coarse.bc_sol(lv.restrict_fn(sol))
            rhs_c = rhs_c + coarse.A_apply(sol_c0)
            sol_c = sol_c0.clone()
        else:
            sol_c = coarse.bc_sol(torch.zeros(coarse.shape, dtype=rhs_c.dtype,
                                              device=rhs_c.device))

        if level - 1 > self.min_level and kind in ("W", "F"):
            recurse_kinds = ("W", "W") if kind == "W" else ("F", "V")
        else:
            recurse_kinds = (kind,)
        for rk in recurse_kinds:
            sol_c = self.cycle(sol_c, rhs_c, level - 1, kind=rk)

        if lv.up_leg_fn is not None and not self.fas:
            sol = lv.up_leg_fn(sol, sol_c, rhs)
        else:
            if lv.prolong_correct_fn is not None and not self.fas:
                sol = lv.prolong_correct_fn(sol, sol_c)
            else:
                corr = lv.prolong_fn(sol_c - sol_c0) if self.fas else lv.prolong_fn(sol_c)
                sol = lv.bc_sol(sol + corr)
            sol = _smooth_n(lv, self.n_post, sol, rhs)
        sol, rhs = self._hook("post", level, sol, rhs)
        return sol

    def fmg(self, rhs_fine, start_level: Optional[int] = None):
        """Full multigrid: restrict the rhs down to `start_level`, solve
        there, then per level upward prolongate and cycle.

        Each upward cycle runs on its own level.  The reference calls
        `self.cycle(sol, rhs)` there, which cycles on the finest level
        whatever the iterate's shape, and so fails for start levels below
        maxLevel - 1; from maxLevel - 1 up the two agree."""
        start = self.min_level if start_level is None else start_level
        rhs_per_level = {self.max_level: rhs_fine}
        for lvl in range(self.max_level, start, -1):
            rhs_per_level[lvl - 1] = self.levels[lvl].restrict_fn(rhs_per_level[lvl])

        lv0 = self.levels[start]
        sol = lv0.bc_sol(torch.zeros(lv0.shape, dtype=rhs_fine.dtype, device=rhs_fine.device))
        sol = (
            self.coarse_solve(sol, rhs_per_level[start])
            if start == self.min_level
            else self.cycle(sol, rhs_per_level[start], start)
        )
        for lvl in range(start + 1, self.max_level + 1):
            lv = self.levels[lvl]
            sol = lv.bc_sol(lv.prolong_fn(sol))
            sol = self.cycle(sol, rhs_per_level[lvl], lvl)
        return sol

    def res_norm(self, sol, rhs, level: Optional[int] = None):
        level = self.max_level if level is None else level
        return self.levels[level].norm_fn(self.residual(level, sol, rhs))

    def staged(self, name: str):
        """The staged (captured, replayed) `cycle` or `res_norm` of this
        hierarchy, made on first use; the cycle's iterate is written back
        into the caller's tensor."""
        cache = self.__dict__.setdefault("_staged", {})
        if name not in cache:
            cache[name] = Staged(self.cycle, donate=(0,)) if name == "cycle" \
                else Staged(getattr(self, name))
        return cache[name]

    def solve(
        self,
        sol,
        rhs,
        target_res_reduction: float = 1e-5,
        max_its: int = 128,
        callback: Callable = None,
        jit: bool = True,
        cycle_fn: Callable = None,
        res_norm_fn: Callable = None,
    ):
        """Host-driven solve loop of Solve@finest: initial residual, then
        cycle until `curRes <= eps * initRes` or `max_its`, with
        `callback(it, sol, cur_res)` after every cycle.  With `jit` and
        CUDA tensors the cycle and the residual norm replay captured
        graphs (the reference's jax.jit); `cycle_fn`/`res_norm_fn`
        replace them."""
        staged = jit and sol.is_cuda
        cycle = cycle_fn or (self.staged("cycle") if staged else self.cycle)
        res_norm = res_norm_fn or (self.staged("res_norm") if staged else self.res_norm)
        init_res = res_norm(sol, rhs)
        cur_res = init_res
        it = 0
        while it < max_its and not bool(cur_res <= target_res_reduction * init_res):
            it += 1
            sol = cycle(sol, rhs)
            cur_res = res_norm(sol, rhs)
            if callback is not None:
                callback(it, sol, cur_res)
        return sol, init_res, cur_res, it

    def solve_jit(self, sol, rhs, target_res_reduction: float = 1e-5, max_its: int = 128):
        """Device-resident solve: the reference's `lax.while_loop` over
        cycles as a device loop.  Returns (sol, init_res, cur_res, it),
        all on the device; the host reads the loop's done flag once per
        cycle and nothing else (the coarse solve's own loop aside).  The
        cycle updates `sol` in place where kernels run, as in `cycle`."""
        init_res = self.res_norm(sol, rhs)

        def body(c, _it):
            s, _ = c
            s = self.cycle(s, rhs)
            cur = self.res_norm(s, rhs)
            return [s, cur], torch.logical_not(cur > target_res_reduction * init_res)

        done = torch.logical_not(init_res > target_res_reduction * init_res)
        (sol, cur), it, _ = device_loop([sol, init_res], body, max_its, done=done, masked=False)
        return sol, init_res, cur, it
