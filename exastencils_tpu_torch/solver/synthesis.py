"""Solver synthesis: the L3 `generate solver for u in uEq` expansion.

Reference: exastencils_tpu/solver/synthesis.py (`Equation`,
`GeneratedSolver.init_state/solve/solve_fused`, the dense branch of
`generate_solver`).  Kernel selection keeps the reference's conditions
(:384-443) with `tpu_use_pallas` read as "use the hand-written kernels",
so one Knowledge selects the same kernel mode in both packages: on a 3D
RBGS level the fused smoother K3 (`smooth_n`), then the whole-leg kernels
K1/K2, and where the legs decline (another smoother, n_pre or n_post 0)
the fused transfers K4/K5.  FAS cycles bypass K1/K2 and K4/K5 and keep K3
(solver/mg.py).  The coarse solvers are CG and `Smoother`; the other
Krylov solvers, the sharded backend and cell/face fields are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

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
    make_fused_smoother_3d,
    make_fused_transfers_3d,
)
from exastencils_tpu_torch.ops.smoothers import make_smoother
from exastencils_tpu_torch.ops.stencil_apply import apply_stencil
from exastencils_tpu_torch.solver.krylov import cg
from exastencils_tpu_torch.solver.mg import MGLevelOps, Multigrid

_GS = ("RBGS", "GaussSeidel", "GS")
_CG = ("CG", "ConjugateGradient")


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
            return reduced_prec_str(float(x), k.testing_maxPrecision, k.testing_zeroThreshold)

        def callback(it, s, cur_res):
            if not k.solver_printAllResiduals:
                return
            if print_error:
                emit(fmt(self._err(s)))
            emit(fmt(cur_res))

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
            fused[(eps, max_its)] = self.backend.wrap(
                lambda s, r: self.mg.solve_jit(s, r, eps, max_its),
                ("field", "field"), ("field", "scalar", "scalar", "scalar"),
                donate_argnums=(0,))
        return fused[(eps, max_its)](sol, rhs)


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
    """Expand `generate solver for u in eq with {options}` on the dense
    backend.  `options` are Knowledge keys without the `solver_` prefix
    or full keys; `modifications` are the cycle's "pre"/"post" hooks."""
    k = knowledge
    for key, val in (options or {}).items():
        full = key if hasattr(k, key) else f"solver_{key}"
        k.set(full, val)
    k.update()
    if backend.is_sharded:
        raise NotImplementedError("the port has the dense backend only")
    if k.solver_cgs not in _CG + ("Smoother",):
        raise NotImplementedError(f"coarse solver {k.solver_cgs!r}: the port has CG and Smoother")

    u = equation.unknown
    nd = u.domain.ndim
    if u.localization != NODE:
        raise NotImplementedError("the port has node fields only")
    restrict_op = restrict_op or node_restriction(nd)
    prolong_op = prolong_op or node_prolongation(nd)

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
        smooth = make_smoother(A, bc_sol, omega=omega, coloring=coloring)
        smooth_n = None
        if k.tpu_use_pallas and nd == 3 and num_colors == 2 and smoother_kind in _GS:
            smooth_n = make_fused_smoother_3d(A, u, lvl, h.work_shape, omega, num_colors)
        restrict_fn = prolong_fn = None
        res_restrict_fn = prolong_correct_fn = None
        down_leg_fn = up_leg_fn = None
        if lvl > k.minLevel:
            restrict_fn, prolong_fn = backend.transfer_fns(lvl, restrict_op, prolong_op)
            if k.tpu_use_pallas and nd == 3:
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
            restrict_fn=restrict_fn,
            prolong_fn=prolong_fn,
            dot_fn=h.dot,
            norm_fn=h.norm_l2,
            smooth_n=smooth_n,
            res_restrict_fn=res_restrict_fn,
            prolong_correct_fn=prolong_correct_fn,
            down_leg_fn=down_leg_fn,
            up_leg_fn=up_leg_fn,
        )

    lv0 = levels[k.minLevel]
    if k.solver_cgs == "Smoother":
        def coarse_solve(sol, rhs):
            for _ in range(k.solver_cgs_maxNumIts):
                sol = lv0.smooth(sol, rhs)
            return sol
    else:
        def coarse_solve(sol, rhs):
            return cg(
                lv0.A_apply, sol, rhs,
                bc_sol=lv0.bc_sol,
                bc_res=lv0.bc_res,
                max_its=k.solver_cgs_maxNumIts,
                res_reduction=k.solver_cgs_targetResReduction,
                dot_fn=lv0.dot_fn,
                norm_fn=lv0.norm_fn,
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
