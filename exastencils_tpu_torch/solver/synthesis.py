"""Solver synthesis: the L3 `generate solver for u in uEq` expansion.

Reference: exastencils_tpu/solver/synthesis.py (`Equation`,
`default_transfer_ops`, `GeneratedSolver.init_state/solve/solve_fused/
export`, `ExportedSolver`, the dense branch of `generate_solver`).  Kernel
selection keeps the reference's conditions (:384-443) with
`tpu_use_pallas` read as "use the hand-written kernels", so one Knowledge
selects the same kernel mode in both packages: on a 3D RBGS level the
fused smoother K3 (`smooth_n`), then the whole-leg kernels K1/K2, and
where the legs decline (another smoother, n_pre or n_post 0) the fused
transfers K4/K5; on any such level the residual norm K13 (`res_norm_fn`,
the port's own).  FAS cycles bypass K1/K2 and K4/K5 and keep K3
(solver/mg.py).  Every field localization (node, cell, Face_x/y/z) runs,
on the dense backend's node-shaped level arrays as in the reference; the
kernel makers decline every localization but node (ops/cuda), where the
reference's do not look.  The coarse solver is any of krylov.SOLVERS or
`Smoother`.  On the sharded backend (parallel/, reference :345-423) a level
takes the reference's communication structure: the overlap smoother
(`tpu_overlap_halo`), the aggregated smoother (`comm_haloAggregationFactor`)
and, with kernels in 3D, the sharded K3 and, where the coarse level is
sharded too, the sharded legs K1/K2; the dense kernel makers are not
asked there, nor K4/K5 anywhere on it.  GeneratedSolver wraps through the
backend (eager on the sharded one), and ExportedSolver scatters a global
numpy array on entry and gathers it on exit, so every rank gets the
global solution.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from exastencils_tpu_torch.config import Knowledge
from exastencils_tpu_torch.utils.printing import reduced_prec_str

from exastencils_tpu_torch.core.field import Field
from exastencils_tpu_torch.core.grid import CELL, FACES, NODE
from exastencils_tpu_torch.core.stencil import (
    IntergridStencil,
    Stencil,
    cell_prolongation,
    cell_restriction,
    cell_restriction_integral,
    face_prolongation,
    face_restriction,
    node_prolongation,
    node_restriction,
    node_restriction_integral,
)
from exastencils_tpu_torch.device import real_dtype
from exastencils_tpu_torch.ops.cuda import (
    make_fused_legs_3d,
    make_fused_res_norm_3d,
    make_fused_smoother_3d,
    make_fused_transfers_3d,
    make_sharded_fused_legs_3d,
    make_sharded_fused_smoother_3d,
)
from exastencils_tpu_torch.ops.smoothers import (
    is_star_radius1,
    make_aggregated_smoother,
    make_overlap_smoother,
    make_smoother,
)
from exastencils_tpu_torch.ops.stencil_apply import apply_stencil
from exastencils_tpu_torch.runtime.performance import HBM_BANDWIDTH, detect_chip
from exastencils_tpu_torch.runtime.timers import host_read, span
from exastencils_tpu_torch.solver.krylov import SOLVERS
from exastencils_tpu_torch.solver.mg import MGLevelOps, Multigrid

_GS = ("RBGS", "GaussSeidel", "GS")


def default_transfer_ops(localization: str, ndim: int,
                         interpolation: str = "linear"):
    """(restriction, prolongation) per field localization and
    interpolation kind (reference synthesis.py:59-83): 'integral_linear'
    restricts by summing (FV/FE residuals), 'linear' by averaging (FD)."""
    integral = interpolation == "integral_linear"
    if localization == NODE:
        r = node_restriction_integral(ndim) if integral else node_restriction(ndim)
        return r, node_prolongation(ndim)
    if localization == CELL:
        r = cell_restriction_integral(ndim) if integral else cell_restriction(ndim)
        return r, cell_prolongation(ndim)
    if localization in FACES:
        d = FACES.index(localization)
        return (face_restriction(d, ndim, integral),
                face_prolongation(d, ndim, integral))
    raise ValueError(f"no default transfer ops for localization {localization!r}")


@dataclass
class Equation:
    """A linear scalar discrete equation A u = f per level; `operator` is
    a Stencil or a mapping level -> Stencil."""

    unknown: Field
    operator: Union[Stencil, Dict[int, Stencil]]
    rhs_fn: Optional[Callable] = None  # f(x, y[, z]) at finest

    def stencil_at(self, level: int) -> Stencil:
        if isinstance(self.operator, dict):
            return self.operator[level]
        return self.operator


@dataclass
class GeneratedSolver:
    """Output of generate_solver: a ready multigrid solver plus the solve
    loop with the reference's reduced-precision printing."""

    knowledge: Knowledge
    equation: Equation
    backend: object
    mg: Multigrid
    residual_field: Field
    error_fn: Optional[Callable] = None  # exact solution for PrintError

    def __post_init__(self):
        b = self.backend
        # the cycle updates the iterate in place where kernels run (the
        # reference donated it): clone an iterate before reusing it.  On
        # CUDA the wrapped functions replay captured graphs, the staged
        # cycle writing its result back into the caller's iterate
        self._cycle = b.wrap(self.mg.cycle, ("field", "field"), "field", donate_argnums=(0,))
        self._res_norm = b.wrap(self.mg.res_norm, ("field", "field"), "scalar")
        if self.knowledge.solver_useFMG:
            self._fmg = b.wrap(
                lambda r: self.mg.fmg(r, start_level=self.knowledge.solver_fmg_startLevel),
                ("field",), "field")
        if self.error_fn is not None:
            self._err = b.wrap(self._max_error_local, ("field",), "scalar")

    def _max_error_local(self, sol):
        h = self.backend.handle(self.knowledge.maxLevel)
        return h.norm_max(sol - self.error_fn(*h.coords()))

    def init_state(self):
        """(bc-applied zero solution, rhs) at the finest level."""
        k = self.knowledge
        lv = self.mg.levels[k.maxLevel]
        h = self.backend.handle(k.maxLevel)
        dtype = real_dtype(k)
        return lv.bc_sol(h.zeros(dtype)), h.init_field_local(self.equation.rhs_fn, dtype)

    def solve(self, out=None, max_its=None, target_res_reduction=None,
              print_error=None, state=None):
        """`repeat until curRes <= eps * initRes` loop with reduced-
        precision printing.  `state` is an initial (sol, rhs), default
        init_state(); sol is updated in place.  With solver_useFMG the
        initial sol is full multigrid's, from the rhs alone."""
        k = self.knowledge
        max_its = k.solver_maxNumIts if max_its is None else max_its
        eps = k.solver_targetResReduction if target_res_reduction is None else target_res_reduction
        if print_error is None:
            print_error = self.error_fn is not None and (
                not k.testing_enabled or k.testing_printErr
            )

        lines = []
        emit = out if out is not None else lines.append
        sol, rhs = self.init_state() if state is None else state
        if k.solver_useFMG:
            sol = self._fmg(rhs)

        def fmt(x):
            with host_read("print"):
                x = float(x)
            return reduced_prec_str(x, k.testing_maxPrecision, k.testing_zeroThreshold)

        def callback(it, s, cur_res):
            if not k.solver_printAllResiduals:
                return
            if print_error:
                emit(fmt(self._err(s)))
            emit(fmt(cur_res))

        with span("solve", "solve"):
            emit(fmt(self._res_norm(sol, rhs)))
            sol, init_res, cur_res, it = self.mg.solve(
                sol, rhs, eps, max_its, callback,
                cycle_fn=self._cycle, res_norm_fn=self._res_norm)
        return sol, lines, float(init_res), float(cur_res), it

    def solve_fused(self, max_its=None, target_res_reduction=None, state=None):
        """The whole solve on the device (reference `solve_fused`,
        synthesis.py:179-189): `Multigrid.solve_jit` through the backend's
        `wrap`, so on CUDA one recording of captured graphs replayed per
        call.  `state` is an initial (sol, rhs), default init_state(); sol
        is updated in place.  Returns (sol, init_res, cur_res, it) as
        device values; no line is printed."""
        k = self.knowledge
        max_its = k.solver_maxNumIts if max_its is None else max_its
        eps = k.solver_targetResReduction if target_res_reduction is None else target_res_reduction
        sol, rhs = self.init_state() if state is None else state
        fused = self.__dict__.setdefault("_fused", {})
        if (eps, max_its) not in fused:
            def solve_jit(s, r):
                return self.mg.solve_jit(s, r, eps, max_its)

            fused[(eps, max_its)] = self.backend.wrap(
                solve_jit, ("field", "field"), ("field", "scalar", "scalar", "scalar"),
                donate_argnums=(0,))
        with span("solve", "solve_fused"):
            return fused[(eps, max_its)](sol, rhs)

    def staging_stats(self, max_its=None, target_res_reduction=None) -> Optional[dict]:
        """The counters (runtime/staging.StageStats) of the staged
        `solve_fused` for these arguments (the Knowledge's by default); None
        where it has not run or runs eagerly (the CPU, a sharded backend)."""
        k = self.knowledge
        max_its = k.solver_maxNumIts if max_its is None else max_its
        eps = k.solver_targetResReduction if target_res_reduction is None else target_res_reduction
        fused = self.__dict__.get("_fused", {}).get((eps, max_its))
        return fused.stats.as_dict() if hasattr(fused, "stats") else None

    def export(self) -> "ExportedSolver":
        """The embedding interface (reference `export`, synthesis.py:
        169-178, after the reference's external-field interfacing): a host
        application that owns its arrays as numpy drives the solver
        through an ExportedSolver."""
        return ExportedSolver(self)


class ExportedSolver:
    """Embeddable view of a generated solver for host applications that
    own their field data as numpy arrays (reference `ExportedSolver`,
    synthesis.py:191-274).

    Contract:
      * `solve(rhs, u0=None, ...) -> (numpy, iterations, relative
        residual)`: copy-in / copy-out.  The caller's arrays are never
        aliased or mutated: they are copied into the solver's own device
        buffers (the same buffers every call, so on CUDA every solve
        replays the one staged cycle bound to them), and the result is a
        new numpy array.  Shapes are the finest level's `self.shape`: on
        a sharded backend the global node array, which every rank passes
        whole, is scattered onto the rank's fragment on entry and
        gathered on exit (one all-reduce), so every rank gets it back.
      * `step(sol, rhs) -> sol` is the raw cycle on device tensors with
        the iterate donated: on CUDA it is the staged cycle, which writes
        its result into `sol` and returns it; on the CPU the cycle may
        update `sol` in place where kernels run.  Either way `sol` is
        consumed: callers keeping it must clone it first.
    """

    def __init__(self, gen: GeneratedSolver):
        self._g = gen
        self.knowledge = gen.knowledge
        h = gen.backend.handle(gen.knowledge.maxLevel)
        self._sharded = gen.backend.is_sharded
        self.shape = tuple(h.grid.shape_of(NODE) if self._sharded else h.work_shape)
        self.dtype = real_dtype(gen.knowledge)
        self.device = h.device
        self.step = gen._cycle  # donation: see the class docstring
        self.residual_norm = gen._res_norm
        self._sol = torch.zeros(h.work_shape, dtype=self.dtype, device=self.device)
        self._rhs = torch.zeros(h.work_shape, dtype=self.dtype, device=self.device)
        # seconds of the last solve's copy-in, cycles and copy-out (host
        # clock, each ended by a device synchronisation on CUDA)
        self.last_seconds: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _copy_in(self, buf: torch.Tensor, arr) -> torch.Tensor:
        host = np.asarray(arr)
        if host.shape != self.shape:
            raise ValueError(f"array of shape {host.shape}, the solver's is {self.shape}")
        # copy_ only reads its source: a writable array is read in place
        src = torch.from_numpy(host if host.flags.writeable else host.copy())
        if self._sharded:
            src = self._g.backend.scatter_local(self.knowledge.maxLevel,
                                                src.to(self.device, self.dtype))
        buf.copy_(src)
        return buf

    def _to_numpy(self, t: torch.Tensor) -> np.ndarray:
        if self._sharded:
            t = self._g.backend.gather_global(self.knowledge.maxLevel, t)
        return t.to("cpu", copy=True).numpy()

    def solve(self, rhs, u0=None, target_res_reduction=None, max_its=None):
        """Run the generated solve loop on caller-owned arrays; returns
        (solution numpy array, iterations, final relative residual)."""
        k = self.knowledge
        eps = (k.solver_targetResReduction
               if target_res_reduction is None else target_res_reduction)
        max_its = k.solver_maxNumIts if max_its is None else max_its
        lv = self._g.mg.levels[k.maxLevel]
        t0 = time.perf_counter()
        self._copy_in(self._rhs, rhs)
        if u0 is None:
            self._sol.zero_()
        else:
            self._copy_in(self._sol, u0)
        self._sol.copy_(lv.bc_sol(self._sol))
        self._sync()
        t1 = time.perf_counter()
        sol, init_res, cur_res, it = self._g.mg.solve(
            self._sol, self._rhs, eps, max_its,
            cycle_fn=self.step, res_norm_fn=self.residual_norm,
        )
        rel = float(cur_res) / max(float(init_res), 1e-300)
        t2 = time.perf_counter()
        out = self._to_numpy(sol)
        t3 = time.perf_counter()
        self.last_seconds = {"copy_in": t1 - t0, "solve": t2 - t1, "copy_out": t3 - t2}
        return out, it, rel


def log_performance_estimate(levels: Dict[int, MGLevelOps], itemsize: int):
    """`performance_printEstimation` (reference synthesis.py:463-486, after
    IR_EvaluatePerformanceEstimates): a bandwidth-bound time of one
    smoother sweep per level, finest first, logged at solver construction
    on logger `exastencils_tpu_torch`; the bandwidth is
    runtime/performance's for `detect_chip()`."""
    bw = HBM_BANDWIDTH.get(detect_chip(), HBM_BANDWIDTH["cpu"])
    log = logging.getLogger("exastencils_tpu_torch")
    for lvl in sorted(levels, reverse=True):
        pts = math.prod(levels[lvl].shape)
        passes = 2 if levels[lvl].smooth_n is not None else 3
        t_ms = passes * pts * itemsize / bw * 1e3
        log.info(
            "perf estimate L%d: %d points, smoother sweep ~%.4f ms "
            "(%d array passes @ %.0f GB/s HBM)",
            lvl, pts, t_ms, passes, bw / 1e9,
        )


def generate_solver(
    equation: Equation,
    knowledge: Knowledge,
    backend,
    grids,
    options: Dict = None,
    modifications: Dict[str, Callable] = None,
    residual_bc=0.0,
    error_fn: Callable = None,
    restrict_op: IntergridStencil = None,
    prolong_op: IntergridStencil = None,
) -> GeneratedSolver:
    """Expand `generate solver for u in eq with {options}` on the dense or
    the sharded backend.  `options` are Knowledge keys without the
    `solver_` prefix or full keys; `modifications` are the cycle's
    "pre"/"post" hooks."""
    k = knowledge
    for key, val in (options or {}).items():
        full = key if hasattr(k, key) else f"solver_{key}"
        k.set(full, val)
    k.update()
    if k.solver_cgs != "Smoother" and k.solver_cgs not in SOLVERS:
        raise ValueError(f"unknown coarse solver {k.solver_cgs!r}")

    u = equation.unknown
    nd = u.domain.ndim
    if restrict_op is None or prolong_op is None:
        r_d, p_d = default_transfer_ops(u.localization, nd)
        restrict_op = restrict_op or r_d
        prolong_op = prolong_op or p_d

    residual_field = Field("gen_residual", u.domain, u.localization, bc=residual_bc)

    smoother_kind = k.solver_smoother
    omega = k.solver_smoother_damping
    coloring_kind = k.solver_smoother_coloring
    if smoother_kind in _GS and not coloring_kind:
        # lexicographic GS has no parallel order; red-black is the
        # reference's documented stand-in
        coloring_kind = "red-black"
    num_colors = {"": 0, "red-black": 2, "4-way": 4, "9-way": 9, "27-way": 27}.get(
        coloring_kind, 2
    )

    levels: Dict[int, MGLevelOps] = {}
    for lvl in range(k.minLevel, k.maxLevel + 1):
        g = grids[lvl]
        h = backend.handle(lvl)
        A = equation.stencil_at(lvl).bind(g)
        bc_sol = h.bc_applier(u, lvl)
        bc_res = h.bc_applier(residual_field, lvl)
        coloring = None
        if num_colors == 2:
            coloring = h.color_masks(2)
        elif num_colors in (4, 9, 27):
            base = round(num_colors ** (1.0 / nd))

            def color_fn_nd(*idx, base=base):
                expr = 0
                for i in idx:
                    expr = expr * base + (i % base)
                return expr

            coloring = h.color_masks(num_colors, color_fn=color_fn_nd)
        smooth = make_smoother(A, bc_sol, omega=omega, coloring=coloring, exchange=h.exchange)
        smooth_n = None
        smooth_kernel = False
        kernels_3d = k.tpu_use_pallas and nd == 3
        # the sharded path's communication structure (reference
        # IR_SplitLoops / halo aggregation): overlap the interior update
        # with the halo messages, and/or widen the halo to k layers
        # exchanged once per k half-sweeps; replicated levels have no topo
        sharded_level = backend.is_sharded and hasattr(h, "topo")
        if sharded_level:
            if k.tpu_overlap_halo and is_star_radius1(A):
                smooth = make_overlap_smoother(A, bc_sol, h.topo, h.local_cells, omega, coloring)
            if k.comm_haloAggregationFactor > 1 and is_star_radius1(A):
                smooth_n = make_aggregated_smoother(A, bc_sol, h.topo, h.local_cells, omega,
                                                    coloring, k.comm_haloAggregationFactor)
            if kernels_3d and num_colors == 2 and smoother_kind in _GS:
                fused = make_sharded_fused_smoother_3d(A, u, lvl, h.topo, h.local_cells, omega,
                                                       num_colors)
                if fused is not None:
                    smooth_n, smooth_kernel = fused, True
        if kernels_3d and not backend.is_sharded and num_colors == 2 and smoother_kind in _GS:
            smooth_n = make_fused_smoother_3d(A, u, lvl, h.work_shape, omega, num_colors)
            smooth_kernel = smooth_n is not None
        restrict_fn = prolong_fn = None
        res_restrict_fn = prolong_correct_fn = None
        down_leg_fn = up_leg_fn = None
        res_norm_fn = None
        if kernels_3d and not backend.is_sharded:
            res_norm_fn = make_fused_res_norm_3d(A, residual_field, lvl, h.work_shape,
                                                 real_dtype(k))
        if lvl > k.minLevel:
            restrict_fn, prolong_fn = backend.transfer_fns(lvl, restrict_op, prolong_op)
            coarse_h = backend.handle(lvl - 1)
            if (kernels_3d and sharded_level and hasattr(coarse_h, "topo")
                    and num_colors == 2 and smoother_kind in _GS):
                down_leg_fn, up_leg_fn = make_sharded_fused_legs_3d(
                    A, u, lvl, h.topo, h.local_cells, coarse_h.local_cells,
                    restrict_op, prolong_op, omega,
                    k.solver_smoother_numPre, k.solver_smoother_numPost, num_colors)
            if kernels_3d and not backend.is_sharded:
                coarse_shape = backend.handle(lvl - 1).work_shape
                if smoother_kind in _GS:
                    down_leg_fn, up_leg_fn = make_fused_legs_3d(
                        A, u, lvl, h.work_shape, coarse_shape,
                        restrict_op, prolong_op, omega,
                        k.solver_smoother_numPre, k.solver_smoother_numPost,
                        num_colors,
                    )
                if down_leg_fn is None:
                    res_restrict_fn, prolong_correct_fn = make_fused_transfers_3d(
                        A, u, lvl, h.work_shape, coarse_shape, restrict_op, prolong_op,
                    )
        levels[lvl] = MGLevelOps(
            shape=h.work_shape,
            A_apply=(lambda x, A=A: apply_stencil(A, x)),
            smooth=smooth,
            bc_sol=bc_sol,
            bc_res=bc_res,
            exchange=h.exchange,
            restrict_fn=restrict_fn,
            prolong_fn=prolong_fn,
            dot_fn=h.dot,
            norm_fn=h.norm_l2,
            smooth_n=smooth_n,
            res_restrict_fn=res_restrict_fn,
            prolong_correct_fn=prolong_correct_fn,
            down_leg_fn=down_leg_fn,
            up_leg_fn=up_leg_fn,
            smooth_kernel=smooth_kernel,
            res_norm_fn=res_norm_fn,
        )

    if k.performance_printEstimation:
        log_performance_estimate(levels, real_dtype(k).itemsize)

    lv0 = levels[k.minLevel]
    if k.solver_cgs == "Smoother":
        def coarse_solve(sol, rhs):
            for _ in range(k.solver_cgs_maxNumIts):
                sol = lv0.smooth(sol, rhs)
            return sol
    else:
        krylov = SOLVERS[k.solver_cgs]
        extra = {}
        if k.solver_cgs_restart and k.solver_cgs in ("BiCGStab",):
            extra["restart_after"] = k.solver_cgs_restartAfter

        def coarse_solve(sol, rhs):
            return krylov(
                lambda p: lv0.A_apply(lv0.exchange(p)), sol, rhs,
                bc_sol=lv0.bc_sol,
                bc_res=lv0.bc_res,
                max_its=k.solver_cgs_maxNumIts,
                res_reduction=k.solver_cgs_targetResReduction,
                dot_fn=lv0.dot_fn,
                norm_fn=lv0.norm_fn,
                **extra,
            ).sol

    mg = Multigrid(
        levels=levels,
        min_level=k.minLevel,
        max_level=k.maxLevel,
        coarse_solve=coarse_solve,
        n_pre=k.solver_smoother_numPre,
        n_post=k.solver_smoother_numPost,
        cycle_type=k.mg_cycle,
        fas=k.solver_useFAS,
        modifications=modifications or {},
    )
    return GeneratedSolver(
        knowledge=k,
        equation=equation,
        backend=backend,
        mg=mg,
        residual_field=residual_field,
        error_fn=error_fn,
    )
