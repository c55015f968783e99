"""ExaSlang-4 executor: runs the parsed AST on torch tensors.

Reference: exastencils_tpu/dsl/interpreter.py.  An L4 `loop over field`
statement becomes whole-tensor torch ops with colour/condition masks,
reductions become torch reductions, and mapping-stencil convolutions
become the banded inter-grid contractions of ops/transfer.  Fields live
in `self.state` as tensors on the executable's `device` (cpu or cuda),
in the Knowledge's real dtype.

Staged execution (`jit_functions`, default `tpu_stage_functions` on a
CUDA device): maximal stageable statement runs are captured once as CUDA
graphs and replayed (dsl/interp_staging, runtime/staging), the
counterpart of the reference's jitted runs; early-exit repeats become
device loops.  On the CPU the default is eager, and `jit_functions=True`
runs the same staging with a replay that re-runs the recorded statements
on the static buffers (for tests); `jit_functions=False` is the eager
executor on any device.

Sharded runs (dsl/interp_fragments): where the reference would place the
fields on a device mesh (parallel/dslsharding.build_dsl_mesh: a
decomposition above 1 and an initialised process group of more than one
rank, or an explicit `mesh`), each rank holds its window of every field
plus ghost layers and exchanges halos at `communicate` and before offset
reads of fields written since their last exchange; only rank 0 prints.
With one rank the program runs dense, and `communicate` moves nothing.
Staggered (Face_*) programs run dense on every rank, as in the reference.

Differences from the reference, by design:
- State is never updated in place by the interpreter's own statements:
  every store replaces the tensor (slots by copy), as the reference's
  immutable arrays do.  The in-place writers are the fast path's kernels
  (dsl/fastpath.py) and the replays of staged runs, which update their
  static state buffers; `set_field` keeps every stored field's storage
  unshared, the fast path checks that before it hands a field to a
  kernel, and a replay first takes its buffers back from any variable.
  A caller that keeps a field's tensor across a run clones it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from exastencils_tpu_torch.config import Knowledge
from exastencils_tpu_torch.dsl import nodes as N

from exastencils_tpu_torch.core.domain import AABB, Domain, unit_domain
from exastencils_tpu_torch.core.field import DirichletBC, Field, NeumannBC
from exastencils_tpu_torch.core.grid import CELL, FACES, NODE, level_grids
from exastencils_tpu_torch.core import matval as MV
from exastencils_tpu_torch.core.matval import MatVal, is_mat
from exastencils_tpu_torch.core.stencil import BoundStencil, IntergridStencil, galerkin_product
from exastencils_tpu_torch.device import check_device, real_dtype
from exastencils_tpu_torch.ops.boundary import make_bc_applier
from exastencils_tpu_torch.ops.stencil_apply import _pad, apply_stencil
from exastencils_tpu_torch.ops.transfer import (
    apply_separable,
    build_prolong_mats,
    build_restrict_mats,
)
from exastencils_tpu_torch.runtime import timers
from exastencils_tpu_torch.runtime.timers import TimerRegistry
from exastencils_tpu_torch.solver.synthesis import default_transfer_ops

from exastencils_tpu_torch.dsl.interp_base import (
    _LOC_MAP,
    _MATH_FNS,
    Frame,
    _Break,
    _Exit,
    _FieldInfo,
    _FunctionBC,
    _LoopCtx,
    _Return,
    _and,
    _apply_assign,
    _apply_binop,
    _dtype_info,
    _glibc_rand_stream,
    _is_stencil,
    _minmax,
    _scale_stencil,
    _shift,
    is_mat,
    is_py_float,
    py_float,
)
from exastencils_tpu_torch.dsl.fastpath import FastPathPlanner, fastpath_enabled
from exastencils_tpu_torch.dsl.interp_builtins import L4BuiltinsMixin
from exastencils_tpu_torch.dsl.interp_fragments import L4FragmentMixin
from exastencils_tpu_torch.dsl.interp_localsolve import L4LocalSolveMixin
from exastencils_tpu_torch.dsl.interp_staging import L4StagingMixin
from exastencils_tpu_torch.parallel.dslsharding import build_dsl_mesh
from exastencils_tpu_torch.runtime.staging import StageStats

log = logging.getLogger("exastencils_tpu_torch")


def _plane_set(arr, dim: int, idx: int, values, within=None):
    """A copy of `arr` with plane `idx` along `dim` set to `values` (a
    scalar, or a tensor of the plane's shape, with or without a size-1
    `dim`), written only inside the `within` windows {d: (lo, hi)} of the
    other dims (reference ops/shardsafe.plane_set)."""
    out = arr.clone()
    sl = [slice(None)] * arr.dim()
    sl[dim] = idx % arr.shape[dim]
    for d, (lo, hi) in (within or {}).items():
        sl[d] = slice(lo, hi)
    v = values
    if isinstance(v, torch.Tensor) and v.dim():
        if v.dim() == arr.dim():
            v = v.select(dim, 0)
        plane = tuple(n for d, n in enumerate(arr.shape) if d != dim)
        v = torch.broadcast_to(v, plane)[tuple(x for d, x in enumerate(sl) if d != dim)]
    out[tuple(sl)] = v
    return out


def _is_int(v) -> bool:
    if isinstance(v, torch.Tensor):
        return not (v.dtype.is_floating_point or v.dtype.is_complex or v.dtype == torch.bool)
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


class L4Executable(L4BuiltinsMixin, L4StagingMixin, L4LocalSolveMixin, L4FragmentMixin):
    """A runnable ExaSlang-4 program on `device` ("cpu" or "cuda").
    `mesh` (a parallel/mesh.DomainMesh) shards it over the mesh's ranks;
    by default the mesh comes from the Knowledge and the initialised
    process group when `tpu_shard_dsl` is set (build_dsl_mesh)."""

    def __init__(
        self,
        program: N.Program,
        knowledge: Knowledge,
        *,
        device,
        out=print,
        jit_functions: Optional[bool] = None,
        mesh=None,
    ):
        self.prog = program
        self.k = knowledge
        for key, val in program.inline_knowledge.items():
            knowledge.set(key, val)
        knowledge.update()
        # direction-alias offsets (east/west/...) -> concrete tuples
        N.resolve_direction_aliases(program, knowledge.dimensionality)
        self.device = check_device(device)
        self.out = out
        self.timers = TimerRegistry(knowledge, self.device)
        self.dtype = real_dtype(knowledge)
        # --- staged execution (`jit_functions`): maximal stageable
        # statement runs are captured per (statements, level, signature)
        # as CUDA graphs and replayed (dsl/interp_staging); None stages
        # where the reference jits, on the accelerator ---
        self.jit_functions = (
            knowledge.tpu_stage_functions and self.device.type == "cuda"
            if jit_functions is None else jit_functions
        )
        self._in_trace = False
        self._stage_cache: Dict[Tuple, dict] = {}
        self._stage_blacklist: set = set()
        self._stageable_memo: Dict[Tuple, bool] = {}
        self.stage_stats = StageStats()
        self._unstaged: Dict[str, str] = {}  # run -> why it stays eager
        self._io_calls = 0  # field IO builtins run (each reads the host; eager)
        # tensors a device loop body masks its updates against: in-place
        # kernels clone them first (own_field)
        self._pinned: List[list] = []
        self._host_rng = np.random.default_rng(0x5EED)  # native() RNG emulation
        self._glibc_rand = _glibc_rand_stream()  # exact std::rand() (seed 1)
        self._ghost_rules: Dict[Tuple[str, int], dict] = {}  # virtual-ghost bc rules
        self._gridcall_cache: Dict[int, N.Expr] = {}
        self._refs_memo: Dict[Tuple, frozenset] = {}
        self._frames: List[Frame] = []  # the active call frames, innermost last
        self._calls: List[Tuple[N.FunctionDecl, Optional[int]]] = []  # (function, level) called
        self._span_roles = None  # (cycle function names, solve drivers): _span_kinds

        # --- domain & grids ---
        if program.domains:
            d0 = program.domains[0]
            self.domain = Domain(d0.name, AABB(tuple(d0.lower), tuple(d0.upper)))
        else:
            self.domain = unit_domain(knowledge.dimensionality)
        self.grids = level_grids(self.domain, knowledge, self.device, dtype=self.dtype)
        self._base_grids = self.grids  # global grids (sharded runs window self.grids)
        self.lo, self.hi = knowledge.minLevel, knowledge.maxLevel

        # --- layouts ---
        self.layouts = {}
        for ld in program.layouts:
            self.layouts[ld.name] = ld

        # --- fields (merge multi-decl level sets) ---
        self.fields: Dict[str, _FieldInfo] = {}
        for fd in program.fields:
            levels = (fd.levels or N.LvlAll()).resolve(self.lo, self.hi)
            layout = self.layouts.get(fd.layout)
            loc = _LOC_MAP.get(layout.localization if layout else "Node", NODE)
            ghost = max(layout.ghost_layers) if layout and layout.ghost_layers else 1
            elem_shape, is_cplx = _dtype_info(layout.datatype if layout else None)
            dup = tuple(layout.dup_layers) if layout and layout.dup_layers is not None else None
            info = self.fields.setdefault(
                fd.name, _FieldInfo(fd.name, loc, [], num_slots=fd.num_slots,
                                    ghost=ghost, elem_shape=elem_shape,
                                    is_complex=is_cplx, dup_layers=dup)
            )
            info.levels = sorted(set(info.levels) | set(levels))
            bc = self._make_bc(fd.bc)
            for lvl in levels:
                info.bc_by_level[lvl] = bc

        # --- stencil templates: runtime-assembled stencil fields
        # (reference L2_StencilTemplateDecl -> IR_StencilField; NS
        # Examples assemble A11/A22/... per Newton/Picard iterate).
        # Stored as ordinary fields with elem_shape (n_offsets, 1) so
        # state/staging/sharding machinery applies unchanged ---
        self.stencil_templates: Dict[str, N.StencilTemplateDecl] = {}
        for st in program.stencil_templates:
            levels = (st.levels or N.LvlAll()).resolve(self.lo, self.hi)
            loc = _LOC_MAP.get(st.localization, NODE)
            info = self.fields.setdefault(
                st.name, _FieldInfo(st.name, loc, [], num_slots=1,
                                    ghost=1, elem_shape=(len(st.offsets), 1),
                                    is_complex=False, dup_layers=None))
            info.levels = sorted(set(info.levels) | set(levels))
            self.stencil_templates[st.name] = st

        # --- L4 StencilField declarations: `StencilField A< coeffField
        # => patternStencil >` — per-point coefficient vectors over the
        # pattern stencil's offsets (field/ir/IR_StencilField.scala).
        # Same runtime shape as stencil templates: writes `A:[off] = ..`,
        # reads convolve with the assembled array coefficients ---
        for sf in program.stencil_fields:
            sd = next((s for s in program.stencils if s.name == sf.stencil),
                      None)
            if sd is None or not sd.entries:
                raise ValueError(
                    f"StencilField {sf.name!r}: pattern stencil "
                    f"{sf.stencil!r} not declared")
            offsets = [
                tuple(int(self._eval_const(o)) for o in e.offsets)
                for e in sd.entries
            ]
            coeff_info = self.fields.get(sf.field)
            loc_str = "Node"
            if coeff_info is not None:
                loc_str = coeff_info.localization
            tdecl = N.StencilTemplateDecl(
                sf.name, loc_str, "global", offsets, sf.levels)
            levels = (sf.levels or N.LvlAll()).resolve(self.lo, self.hi)
            info = self.fields.setdefault(
                sf.name, _FieldInfo(sf.name, _LOC_MAP.get(loc_str, NODE), [],
                                    num_slots=1, ghost=1,
                                    elem_shape=(len(offsets), 1),
                                    is_complex=False, dup_layers=None))
            info.levels = sorted(set(info.levels) | set(levels))
            self.stencil_templates[sf.name] = tdecl

        # --- stencils (bound lazily: coefficients may reference fields,
        # the reference's stencil-field case IR_StencilField.scala) ---
        self.stencils: Dict[str, Dict[int, object]] = {}
        self._stencil_cache: Dict[Tuple[str, int], object] = {}
        for sd in program.stencils:
            levels = (sd.levels or N.LvlAll()).resolve(self.lo, self.hi)
            per_level = self.stencils.setdefault(sd.name, {})
            if isinstance(sd, N.StencilFromDefault):
                loc = _LOC_MAP.get(sd.localization, NODE)
                r_ig, p_ig = default_transfer_ops(
                    loc, self.k.dimensionality, sd.interpolation)
                ig = r_ig if sd.kind == "restriction" else p_ig
                for lvl in levels:
                    per_level[lvl] = ig
            elif isinstance(sd, N.StencilFromExpr):
                # stencil algebra over declared stencils (reference
                # IR_StencilOps / IR_OperatorTimesOperator): resolved
                # lazily so operand stencils bind at the right level
                for lvl in levels:
                    per_level[lvl] = ("__sexpr__", sd)
            elif sd.entries and isinstance(sd.entries[0], N.StencilMappingEntry):
                plain = self._mapping_as_plain_stencil(sd)
                if plain is not None:
                    # `[i0,i1] from [i0+c, i1] with w`: unit index
                    # coefficients = an ordinary same-level stencil in
                    # mapping notation (Helmholtz fromL3 operators)
                    for lvl in levels:
                        per_level[lvl] = ("__decl__", plain)
                else:
                    ig = self._mapping_to_intergrid(sd)
                    for lvl in levels:
                        per_level[lvl] = ig
            else:
                for lvl in levels:
                    per_level[lvl] = ("__decl__", sd)

        # --- functions ---
        self.functions: Dict[Tuple[str, Optional[int]], N.FunctionDecl] = {}
        for fn in program.functions:
            if fn.levels is None:
                self.functions[(fn.name, None)] = fn
            else:
                for lvl in fn.levels.resolve(self.lo, self.hi):
                    self.functions[(fn.name, lvl)] = fn

        # --- rank-mesh placement (the sharded DSL, dsl/interp_fragments) ---
        if mesh is None and knowledge.tpu_shard_dsl:
            mesh = build_dsl_mesh(knowledge, knowledge.dimensionality)
        self.mesh = mesh
        self.frag = None
        self._windows: Dict[Tuple[int, str], object] = {}
        self._owned_masks: Dict[Tuple[int, str], torch.Tensor] = {}
        self._dense_levels: set = set()
        self._halo_stale: set = set()  # (field, level, slot) written since their exchange
        self._eager_runs: set = set()
        if (mesh.rank if mesh is not None else
                dist.get_rank() if dist.is_initialized() else 0) != 0:
            self.out = lambda *args, **kwargs: None  # rank 0 prints
        if mesh is not None and any(
                info.localization in FACES for info in self.fields.values()):
            # the reference runs staggered programs dense (its mesh-pad
            # embedding does not cover their offset algebra): every rank
            # runs the whole program, rank 0 prints
            log.warning("staggered fields present: DSL mesh sharding disabled")
            mesh = None

        # --- state ---
        self.state: Dict[Tuple[str, int], torch.Tensor] = {}
        self.slot_index: Dict[Tuple[str, int], int] = {}
        self.globals: Dict[str, object] = {}
        self.init_globals()
        self._bc_appliers: Dict[Tuple[str, int], object] = {}
        self._transfer_cache: Dict[Tuple, object] = {}
        self._frozen_ctx = None  # in-place-sweep frozen-halo context
        self._cout_precision = 6  # std::cout default (native() emulation)
        self._cout_saved = 6
        self._pending_out = ""  # newline-less std::cout << segments

        # --- fast path: multigrid legs routed through the CUDA whole-leg
        # kernels (dsl/fastpath.py); fields whose stores were elided as
        # provably dead carry a rematerializer in _stale ---
        self._stale: Dict[Tuple[str, int], object] = {}
        self._stale_proven: set = set()
        if mesh is not None:
            self._setup_fragments(mesh)
        self._fastpath = None
        if fastpath_enabled(self):
            self._fastpath = FastPathPlanner(self)
        self.init_fields_with_zero()

    # ------------------------------------------------------------------
    # declaration processing helpers
    def _make_bc(self, bc_expr):
        if bc_expr is None:
            return None
        if isinstance(bc_expr, N.Call) \
                and any(f.name == bc_expr.name for f in self.prog.functions):
            # boundary handled by a user function (radiation/Robin BCs,
            # ComplexNumbers Helmholtz: `Field Solution< ...,
            # applyBC_Solution@7() >`); `apply bc` calls it
            return _FunctionBC(bc_expr.name, bc_expr.level)
        if isinstance(bc_expr, N.Call) and bc_expr.name == "Neumann":
            order = int(bc_expr.args[0].value) if bc_expr.args else 2
            return NeumannBC(order)
        if isinstance(bc_expr, N.Access) and bc_expr.name == "Neumann":
            return NeumannBC(2)
        if isinstance(bc_expr, N.Num):
            return DirichletBC(float(bc_expr.value))

        def bc_fn(*coords):
            env = {}
            for d, c in enumerate(coords):
                ax = "xyz"[d]
                env[f"vf_boundaryPosition_{ax}"] = c
                env[f"vf_boundaryPos_{ax}"] = c
                env[f"vf_boundaryCoord_{ax}"] = c
                env[f"vf_nodePosition_{ax}"] = c
                env[f"vf_nodePos_{ax}"] = c
            return self._eval_const(bc_expr, env)

        return DirichletBC(bc_fn)

    def _affine_of(self, expr, index_names: List[str]) -> Tuple[np.ndarray, float]:
        """Evaluate a from-expression as affine in the to-indices."""
        nd = len(index_names)

        def ev(e):
            if isinstance(e, N.Num):
                return np.zeros(nd), float(e.value)
            if isinstance(e, N.Access) and e.name in index_names:
                a = np.zeros(nd)
                a[index_names.index(e.name)] = 1.0
                return a, 0.0
            if isinstance(e, N.UnOp) and e.op == "-":
                a, b = ev(e.operand)
                return -a, -b
            if isinstance(e, N.BinOp):
                a1, b1 = ev(e.lhs)
                a2, b2 = ev(e.rhs)
                if e.op == "+":
                    return a1 + a2, b1 + b2
                if e.op == "-":
                    return a1 - a2, b1 - b2
                if e.op == "*":
                    if not a1.any():
                        return b1 * a2, b1 * b2
                    if not a2.any():
                        return b2 * a1, b1 * b2
                if e.op == "/" and not a2.any():
                    return a1 / b2, b1 / b2
            raise ValueError(f"mapping expression not affine: {e}")

        return ev(expr)

    def _mapping_as_plain_stencil(self, sd: N.StencilDecl):
        """A mapping stencil whose from-indices all have coefficient 1 is
        a same-level stencil `[off] => w`; returns the equivalent
        offset-entry StencilDecl, or None if any index scales."""
        entries = []
        for e in sd.entries:
            offs = []
            for d, fe in enumerate(e.from_exprs):
                try:
                    a, b = self._affine_of(fe, e.to_indices)
                except ValueError:
                    return None
                if abs(a[d] - 1.0) > 1e-12 or abs(b - round(b)) > 1e-12:
                    return None
                if any(abs(a[dd]) > 1e-12 for dd in range(len(a)) if dd != d):
                    return None
                offs.append(N.Num(int(round(b)), is_int=True))
            entries.append(N.StencilOffsetEntry(offs, e.coef))
        return N.StencilDecl(sd.name, sd.levels, entries)

    def _mapping_to_intergrid(self, sd: N.StencilDecl) -> IntergridStencil:
        """Recognize 2:1 mapping stencils (reference inter-grid operators):
        from = 2*i + c  -> restriction window entry at offset c
        from = (i + c)/2 -> prolongation window entry at offset -c."""
        entries = []
        kind = None
        for e in sd.entries:
            index_names = e.to_indices
            nd = len(e.from_exprs)
            offs = []
            for d, fe in enumerate(e.from_exprs):
                a, b = self._affine_of(fe, index_names)
                coef = a[d]
                if abs(coef - 2.0) < 1e-12:
                    this_kind = "restriction"
                    off = b
                elif abs(coef - 0.5) < 1e-12:
                    this_kind = "prolongation"
                    off = -2.0 * b
                else:
                    raise ValueError(f"unsupported mapping coefficient {coef}")
                if kind is None:
                    kind = this_kind
                elif kind != this_kind:
                    raise ValueError("mixed mapping kinds in one stencil")
                if abs(off - round(off)) > 1e-12:
                    raise ValueError("non-integer mapping offset")
                offs.append(int(round(off)))
            entries.append((tuple(offs), float(self._eval_const(e.coef))))

        nd = len(entries[0][0])
        lo = tuple(min(o[d] for o, _ in entries) for d in range(nd))
        hi = tuple(max(o[d] for o, _ in entries) for d in range(nd))
        W = np.zeros(tuple(h - l + 1 for l, h in zip(lo, hi)))
        for off, w in entries:
            W[tuple(o - l for o, l in zip(off, lo))] += w
        return IntergridStencil(kind, W, lo)

    # ------------------------------------------------------------------
    # state management
    def true_shape(self, name: str, level: int) -> Tuple[int, ...]:
        """Storage extents of `name@level`: its grid extents on a dense
        run, its window's on a sharded one."""
        return self.grids[level].shape_of(self.fields[name].localization)

    @property
    def complex_dtype(self):
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64

    def _field_dtype(self, info: _FieldInfo):
        return self.complex_dtype if info.is_complex else self.dtype

    def init_globals(self):
        """Evaluate Globals-block declarations in order (the generated
        initGlobals(); later decls may reference earlier ones).  C++
        semantics: every global EXISTS (zero-initialized) before the
        in-order assignments run, so a forward reference reads 0."""
        fr = Frame({}, None)
        for g in self.prog.globals_:
            if g.name not in self.globals and g.datatype in (
                    "Real", "Integer", "Int"):
                self.globals[g.name] = 0 if g.datatype != "Real" else 0.0
        for g in self.prog.globals_:
            self.globals[g.name] = self._coerce_decl(g, fr, None)

    def init_fields_with_zero(self):
        self._halo_stale.clear()
        for info in self.fields.values():
            for lvl in info.levels:
                shape = self.true_shape(info.name, lvl) + info.elem_shape
                if info.num_slots > 1:
                    shape = (info.num_slots,) + shape
                    self.slot_index[(info.name, lvl)] = 0
                self.state[(info.name, lvl)] = torch.zeros(
                    shape, dtype=self._field_dtype(info), device=self.device)

    def get_field(self, name: str, level: int, slot: Optional[str] = None):
        """Current tensor of `field@level` (active slot unless `slot`).
        The stored tensor itself (a view for slots): callers that keep it
        across statements that may run the fast path must clone it."""
        if self._stale and (name, level) in self._stale:
            # dead-store-elided field (fast path): rematerialize for the
            # current iterate before anyone reads it
            mat = self._stale.pop((name, level))
            mat()
        info = self.fields[name]
        arr = self.state[(name, level)]
        if info.num_slots > 1:
            idx = self._slot_idx(name, level, slot)
            return arr[idx]
        return arr

    def mark_stale(self, key: Tuple[str, int], materializer):
        """Record a dead-store-elided field (fast path): `materializer()`
        rebuilds it from the current state when read via get_field.
        Every caller carries a liveness proof that no in-program read
        can observe the staleness (dsl/liveness.py)."""
        self._stale[key] = materializer
        self._stale_proven.add(key)

    def _shares_storage(self, t: torch.Tensor, skip=None) -> bool:
        """True if `t`'s storage is also held by a state entry other than
        `skip`, by a variable of an active frame or a global, or by a
        tensor a device loop masks against (`_pinned`)."""
        ptr = t.untyped_storage().data_ptr()

        def held(v):
            if is_mat(v):
                v = v.data
            return isinstance(v, torch.Tensor) and v.untyped_storage().data_ptr() == ptr

        if any(k != skip and held(v) for k, v in self.state.items()):
            return True
        if any(held(v) for pins in self._pinned for v in pins):
            return True
        frames = [f.vars for f in self._frames] + [self.globals]
        return any(held(v) for env in frames for v in env.values())

    def own_field(self, name: str, level: int) -> torch.Tensor:
        """The stored tensor of a single-slot field, cloned first if its
        storage is shared with any other value: the tensor returned may
        be updated in place without another name seeing the change."""
        key = (name, level)
        arr = self.get_field(name, level)
        if self._shares_storage(arr, skip=key):
            arr = arr.clone()
            self.state[key] = arr
        return arr

    def set_field(self, name: str, level: int, value, slot: Optional[str] = None):
        """Store `value` as `field@level`; the stored tensor is contiguous,
        and a value whose storage another state entry already holds (an
        unmasked `V = U`) is copied, so no two fields share storage."""
        self._stale.pop((name, level), None)
        self._mark_written(name, level, slot)
        info = self.fields[name]
        key = (name, level)
        if info.num_slots > 1:
            idx = self._slot_idx(name, level, slot)
            new = self.state[key].clone()
            new[idx] = value
            self.state[key] = new
            return
        cur = self.state[key]
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value, dtype=cur.dtype, device=cur.device)
        if value.dim() == 0 and cur.dim():
            value = torch.broadcast_to(value, cur.shape)
        if not value.is_contiguous():
            value = value.contiguous()
        elif value is not cur:
            ptr = value.untyped_storage().data_ptr()
            if any(k != key and v.untyped_storage().data_ptr() == ptr
                   for k, v in self.state.items()):
                value = value.clone()
        self.state[key] = value

    def _slot_idx(self, name, level, slot):
        cur = self.slot_index[(name, level)]
        n = self.fields[name].num_slots
        if slot in (None, "active", "activeSlot"):
            return cur
        if slot in ("next", "nextSlot"):
            return (cur + 1) % n
        if slot in ("previous", "previousSlot"):
            return (cur - 1) % n
        return int(slot) % n

    def _stencil_at(self, name: str, level: int):
        """Resolve a stencil at a level; offset stencils are bound lazily
        so field-valued coefficients read the *current* field state."""
        entry = self.stencils[name][level]
        if isinstance(entry, tuple) and entry and entry[0] == "__sexpr__":
            key = (name, level)
            if key not in self._stencil_cache:
                self._fresh_coefficients(entry[1].expr, level)
                self._stencil_cache[key] = self._eval_stencil_expr(entry[1].expr, level)
            return self._stencil_cache[key]
        if not (isinstance(entry, tuple) and entry and entry[0] == "__decl__"):
            return entry  # IntergridStencil
        key = (name, level)
        if key in self._stencil_cache:
            return self._stencil_cache[key]
        sd = entry[1]
        grid = self.grids[level]
        offsets, coefs = [], []
        cacheable = True
        env = {}
        for d in range(grid.ndim):
            ax = "xyz"[d]
            env[f"vf_gridWidth_{ax}"] = grid.grid_width(d)
            env[f"vf_cellWidth_{ax}"] = grid.grid_width(d)
        env["vf_cellVolume"] = grid.volume_b()
        if not grid.is_uniform and any(
            self._referenced_names(e.coef) & set(env) for e in sd.entries
        ):
            raise NotImplementedError(
                "stencil coefficients via vf_gridWidth on a non-uniform "
                "grid would silently use the mean spacing; formulate "
                "position-dependent coefficients with grid-bound "
                "coefficient functions (grid.cell_widths_1d)"
            )
        for e in sd.entries:
            offsets.append(tuple(int(self._eval_const(o)) for o in e.offsets))
            try:
                coefs.append(self._eval_const(e.coef, env))
            except ValueError:
                # general geometry expressions (vf_nodePos offsets): still
                # static as long as no FIELD is read, so evaluate once and
                # cache
                refs = self._referenced_names(e.coef)
                if refs & set(self.fields) or refs & set(self.stencils):
                    cacheable = False
                coefs.append(self.eval_expr(e.coef, Frame({}, level), None))
        st = BoundStencil(sd.name, tuple(offsets), tuple(coefs))
        if cacheable:
            self._stencil_cache[key] = st
        return st

    def _eval_stencil_expr(self, e, level: int):
        """Evaluate a stencil-valued expression (`Stencil S from (...)`):
        +, -, scalar scaling, stencil-of-stencil products, transpose(),
        and the Galerkin triple product R * A * P (reference
        operator/ir/IR_StencilOps.scala:34,
        IR_OperatorTimesOperator.scala).  Returns a BoundStencil or
        IntergridStencil usable wherever a declared stencil is."""

        def scale(v, s):
            if isinstance(v, BoundStencil):
                return v.scale(s)
            if isinstance(v, IntergridStencil):
                return v.scaled(s)
            if isinstance(v, tuple) and v and v[0] == "__RA__":
                return ("__RA__", v[1], v[2].scale(s))
            return v * s

        def ident_like(nd):
            return BoundStencil("I", ((0,) * nd,), (1.0,))

        def mul(a, b):
            a_st = isinstance(a, (BoundStencil, IntergridStencil)) or (
                isinstance(a, tuple) and a and a[0] == "__RA__")
            b_st = isinstance(b, (BoundStencil, IntergridStencil)) or (
                isinstance(b, tuple) and b and b[0] == "__RA__")
            if not a_st and not b_st:
                return a * b
            if not a_st:
                return scale(b, a)
            if not b_st:
                return scale(a, b)
            if isinstance(a, BoundStencil) and isinstance(b, BoundStencil):
                return a.compose(b)
            if isinstance(a, IntergridStencil) and a.kind == "restriction":
                if isinstance(b, BoundStencil):
                    return ("__RA__", a, b)
                if isinstance(b, IntergridStencil) and b.kind == "prolongation":
                    return galerkin_product(a, ident_like(b.ndim), b)
            if isinstance(a, tuple) and a[0] == "__RA__":
                if isinstance(b, BoundStencil):
                    return ("__RA__", a[1], a[2].compose(b))
                if isinstance(b, IntergridStencil) and b.kind == "prolongation":
                    return galerkin_product(a[1], a[2], b)
            raise ValueError(
                f"unsupported stencil product {type(a).__name__} * {type(b).__name__}"
            )

        def ev(e, lvl):
            if isinstance(e, N.Access) and e.name in self.stencils:
                l = lvl
                if e.level is not None:
                    l = e.level.resolve(self.lo, self.hi, lvl)[0]
                return self._stencil_at(e.name, l)
            if isinstance(e, N.Call) and e.name in ("transpose", "transposed"):
                v = ev(e.args[0], lvl)
                if isinstance(v, (BoundStencil, IntergridStencil)):
                    return v.transposed()
                raise ValueError("transpose() expects a stencil")
            if isinstance(e, N.UnOp) and e.op == "-":
                return scale(ev(e.operand, lvl), -1.0)
            if isinstance(e, N.BinOp):
                if e.op == "*":
                    return mul(ev(e.lhs, lvl), ev(e.rhs, lvl))
                if e.op in ("+", "-"):
                    a = ev(e.lhs, lvl)
                    b = ev(e.rhs, lvl)
                    if isinstance(a, BoundStencil) and isinstance(b, BoundStencil):
                        return a.add(b.scale(-1.0) if e.op == "-" else b)
                    if not isinstance(a, (BoundStencil, IntergridStencil, tuple)) and \
                            not isinstance(b, (BoundStencil, IntergridStencil, tuple)):
                        return a + b if e.op == "+" else a - b
                    raise ValueError(f"cannot {e.op} stencils of these kinds")
                if e.op == "/":
                    return scale(ev(e.lhs, lvl), 1.0 / self._eval_const(e.rhs))
            return self._eval_const(e)

        out = ev(e, level)
        if isinstance(out, tuple) and out and out[0] == "__RA__":
            raise ValueError("incomplete Galerkin product: R*A without a prolongation")
        if not isinstance(out, (BoundStencil, IntergridStencil)):
            raise ValueError(f"stencil expression evaluated to non-stencil {out!r}")
        return out

    def bc_applier(self, name: str, level: int):
        key = (name, level)
        if key not in self._bc_appliers:
            info = self.fields[name]
            bc = info.bc_by_level.get(level)
            if isinstance(bc, _FunctionBC):
                bc = None  # function BCs apply via call_function, not planes
            f = Field(name, self.domain, info.localization, bc=bc)
            self._bc_appliers[key] = make_bc_applier(f, self.grids[level], level)
        return self._bc_appliers[key]

    def _apply_bc_field(self, name: str, level: int, arr):
        """`apply bc` on the field's grid (on a sharded run: on this
        rank's window, kept on the global grid's boundary planes only)."""
        out = self.bc_applier(name, level)(arr)
        info = self.fields[name]
        nd = arr.dim() - len(info.elem_shape)
        m = self._phys_boundary(level, info.localization, tuple(arr.shape[:nd]))
        if m is None:
            return out
        return torch.where(m[(...,) + (None,) * len(info.elem_shape)], out, arr)

    # ------------------------------------------------------------------
    # constant-expression evaluation (declarations, knowledge conditions)
    def _eval_const(self, e, env: Optional[dict] = None):
        env = env or {}
        if isinstance(e, N.Num):
            return 1j * e.value if e.is_imag else e.value
        if isinstance(e, N.Str):
            return e.value
        if isinstance(e, N.UnOp):
            v = self._eval_const(e.operand, env)
            return -v if e.op == "-" else (not v)
        if isinstance(e, N.BinOp):
            a = self._eval_const(e.lhs, env)
            b = self._eval_const(e.rhs, env)
            return _apply_binop(e.op, a, b)
        if isinstance(e, N.Access):
            if e.name in env:
                return env[e.name]
            if e.name == "PI":
                return math.pi
            if e.name in self.globals:
                v = self.globals[e.name]
                if self._is_alias(v):
                    # `Expr k = 40.0` global alias (Helmholtz)
                    return self._eval_const(v[1], env)
                return v
            raise ValueError(f"cannot evaluate {e.name!r} in constant context")
        if isinstance(e, N.Call):
            if e.name in _MATH_FNS:
                return _MATH_FNS[e.name](self._eval_const(e.args[0], env))
            if e.name in ("min", "max"):
                vals = [self._eval_const(a, env) for a in e.args]
                return _minmax(e.name, vals) if any(
                    hasattr(v, "shape") and getattr(v, "shape", ()) != () for v in vals
                ) else (min if e.name == "min" else max)(vals)
            if e.name == "getKnowledge":
                return self._get_knowledge(e.args)
            if e.name.startswith("integrateOver") and e.name.endswith("Face"):
                # grid integral over a cell face (grid/ir
                # IR_IntegrateOnGrid): on uniform axis-aligned grids the
                # face area is the product of the other dims' widths
                face = e.name[len("integrateOver"):-4]
                d = {"East": 0, "West": 0, "North": 1, "South": 1,
                     "Top": 2, "Bottom": 2}[face]
                area = 1.0
                for dd in range(3):
                    key = f"vf_gridWidth_{'xyz'[dd]}"
                    if dd != d and key in env:
                        area = area * env[key]
                val = self._eval_const(e.args[0], env) if e.args else 1.0
                return val * area
        raise ValueError(f"cannot const-evaluate {e}")

    def _get_knowledge(self, args):
        key = args[0].value if isinstance(args[0], (N.Str,)) else str(args[0])
        return getattr(self.k, key)

    # ------------------------------------------------------------------
    # runtime expression evaluation
    def eval_expr(self, e, fr: Frame, loop: Optional[_LoopCtx] = None):
        if isinstance(e, N.Num):
            if e.is_imag:
                return 1j * e.value
            return int(e.value) if e.is_int else e.value
        if isinstance(e, N.Str):
            return e.value
        if isinstance(e, N.UnOp):
            v = self.eval_expr(e.operand, fr, loop)
            if e.op == "-":
                if is_mat(v):
                    return v.map(torch.negative)
                return py_float(-v) if is_py_float(v) else -v
            if e.op == "im":  # `(expr)j` imaginary suffix
                return v * 1j
            return torch.logical_not(v) if isinstance(v, torch.Tensor) else (not v)
        if isinstance(e, N.BinOp):
            return self._eval_binop(e, fr, loop)
        if isinstance(e, N.Access):
            return self._eval_access(e, fr, loop)
        if isinstance(e, N.Call):
            return self._eval_call(e, fr, loop)
        if isinstance(e, N.MatrixLit):
            return self._eval_matrix_lit(e, fr, loop)
        if isinstance(e, N.TensorLit):
            return self._eval_tensor_lit(e, fr, loop)
        raise ValueError(f"cannot evaluate {e}")

    def _eval_matrix_lit(self, e: N.MatrixLit, fr, loop) -> MatVal:
        """`{{a,b},{c,d}}` / `{a,b}` literals -> MatVal of shape
        batch + (r, c); grid-array entries (e.g. vf_* expressions in
        stencil coefficients) become the batch dims (reference
        IR_MatrixExpression)."""
        rows = [[self.eval_expr(x, fr, loop) for x in row] for row in e.rows]
        flat = [x for row in rows for x in row]
        shapes = [getattr(x, "shape", ()) for x in flat]
        batch = np.broadcast_shapes(*shapes) if any(shapes) else ()
        is_cplx = any(torch.is_complex(x) for x in flat if isinstance(x, torch.Tensor)) or any(
            isinstance(x, complex) for x in flat
        )
        dtype = self.complex_dtype if is_cplx else self.dtype

        def to_arr(x):
            a = torch.as_tensor(x, dtype=dtype, device=self.device)
            return torch.broadcast_to(a, batch) if batch else a

        data = torch.stack(
            [torch.stack([to_arr(x) for x in row], dim=-1) for row in rows], dim=-2
        )
        return MatVal(data)

    def _eval_tensor_lit(self, e: N.TensorLit, fr, loop) -> MatVal:
        shape = (e.dim, 1) if e.order == 1 else (e.dim,) * e.order
        data = torch.zeros(shape, dtype=self.dtype, device=self.device)
        for idx, ex in e.entries:
            pos = (idx[0], 0) if e.order == 1 else tuple(idx)
            data[pos] = self.eval_expr(ex, fr, loop)
        return MatVal(data)

    def _resolve_level(self, spec: Optional[N.LevelSpec], fr: Frame) -> Optional[int]:
        if spec is None:
            return fr.level
        levels = spec.resolve(self.lo, self.hi, fr.level)
        if len(levels) != 1:
            raise ValueError(f"ambiguous level {levels} in access")
        return levels[0]

    def _is_alias(self, v) -> bool:
        return isinstance(v, tuple) and len(v) == 2 and v[0] == "__alias__"

    def _eval_alias(self, v, e: N.Access, fr: Frame, loop):
        node = v[1]
        if e.offset and any(e.offset):
            node = N.shift_offsets(node, tuple(e.offset))
        val = self.eval_expr(node, fr, loop)
        if e.component:
            val = self._apply_component(val, e.component, fr, loop)
        return val

    def _eval_access(self, e: N.Access, fr: Frame, loop):
        name = e.name
        if name in fr.vars:
            if self._is_alias(fr.vars[name]):
                return self._eval_alias(fr.vars[name], e, fr, loop)
            return self._maybe_component(fr.vars[name], e, fr, loop)
        if name == "PI":
            return math.pi
        if (name in ("i0", "i1", "i2") or name in ("x", "y", "z")) \
                and loop is not None and name not in self.fields \
                and name not in self.globals:
            # loop indices: i0/i1/i2, or the reference's x/y/z dimension
            # names as used in `where` clauses (dim 0 = x)
            d = int(name[1]) if name[0] == "i" else "xyz".index(name)
            return (
                self._gidx(loop.shape, d, loop.level, loop.localization)
                if d < len(loop.shape)
                else 0
            )
        if name.startswith("vf_"):
            val = self._eval_virtual_field(name, fr, loop)
            if e.offset is not None and any(e.offset):
                val = self._shift_vf(name, val, tuple(e.offset))
            return val
        if name == "levels":
            return self._resolve_level(e.level, fr)
        if name in self.stencil_templates:
            # stencil-field access: `A:[off]` reads one coefficient
            # component; a bare `A` yields the stencil view (BoundStencil
            # with array coefficients, re-bound each use so assembly
            # updates are visible; reference IR_StencilFieldAccess)
            st = self.stencil_templates[name]
            lvl = self._resolve_level(e.level, fr)
            if e.offset and any(e.offset):
                self._offset_read(name, lvl, None, max(abs(int(o)) for o in e.offset))
            arr = self.get_field(name, lvl)
            if e.sten_entry is not None:
                k = st.offsets.index(tuple(e.sten_entry))
                return self._to_loop_space(arr[..., k, 0], e.offset, loop)
            # coefficients stay on A's OWN grid, unshifted: the
            # convolution path maps its result into loop space afterwards
            # (`A@[o] * u@[o]` shifts the whole conv by the field offset),
            # and _block_coefs maps pointwise reads itself
            coefs = tuple(arr[..., k, 0] for k in range(len(st.offsets)))
            return ("__stencil__",
                    BoundStencil(name, tuple(st.offsets), coefs), lvl)
        if name in self.fields:
            info = self.fields[name]
            lvl = self._resolve_level(e.level, fr)
            if e.offset and any(e.offset):
                self._offset_read(name, lvl, e.slot, max(abs(int(o)) for o in e.offset))
            arr = self.get_field(name, lvl, e.slot)
            offset, comp = e.offset, e.component
            if comp and not info.elem_shape and offset is None \
                    and len(comp) == 1 and comp[0][0] == "idx":
                # `u[1]` on a scalar 1D field: parser ambiguity — it is a
                # stencil offset, not a component access
                offset = (int(self._eval_const(comp[0][1])),)
                comp = None
                if any(offset):
                    self._offset_read(name, lvl, e.slot, abs(offset[0]))
                    arr = self.get_field(name, lvl, e.slot)
            e_nd = len(info.elem_shape)
            bc_lvl = info.bc_by_level.get(lvl)
            bc_ghosts = (
                (name, lvl) in self._ghost_rules
                or (bc_lvl is not None and info.localization != NODE
                    and isinstance(bc_lvl, (DirichletBC, NeumannBC)))
            )
            if offset and any(offset) and bc_ghosts \
                    and loop is not None \
                    and tuple(arr.shape[:arr.ndim - e_nd]) == tuple(loop.shape):
                # offset read on a field with materialized bc ghost
                # planes: resolve through the bc-aware pad so boundary
                # cells see the wall/lid values, exactly like the
                # generated code reading its ghost storage
                r = max(abs(int(o)) for o in offset)
                xp = self._padded_operand(name, lvl, arr, r)
                sl = tuple(
                    slice(r + int(o), r + int(o) + n)
                    for o, n in zip(offset, loop.shape)
                ) + (slice(None),) * e_nd
                val = xp[sl]
            else:
                val = self._to_loop_space(arr, offset, loop, elem_ndim=e_nd)
            if info.elem_shape:
                val = MatVal(val)
            if comp:
                val = self._apply_component(val, comp, fr, loop)
            return val
        if name in self.stencils:
            lvl = self._resolve_level(e.level, fr)
            return ("__stencil__", self._stencil_at(name, lvl), lvl)
        if name in self.globals:
            if self._is_alias(self.globals[name]):
                return self._eval_alias(self.globals[name], e, fr, loop)
            return self._maybe_component(self.globals[name], e, fr, loop)
        if name == "mpiRank":
            # generated MPI IV (parallelization/api/mpi/MPI_IVs.scala);
            # the interpreter executes the whole domain in one process,
            # so the program observes rank 0 (single-process semantics,
            # like running the reference binary without mpirun)
            return 0
        if name == "mpiSize":
            return 1
        raise ValueError(f"unknown identifier {name!r}")

    def _maybe_component(self, val, e: N.Access, fr, loop):
        if e.component:
            return self._apply_component(val, e.component, fr, loop)
        return val

    def _comp_specs(self, comps, fr, loop):
        """Evaluate component-group index expressions (static slices,
        int or traced-int point indices)."""
        out = []
        for c in comps:
            if c[0] == "idx":
                if (isinstance(c[1], N.Access) and c[1].name not in fr.vars
                        and c[1].name not in self.globals
                        and c[1].name not in self.fields
                        and len(c[1].name) == 1):
                    # free index (`t1[a, 2]`, TensorClass/Access): an
                    # unbound single-letter index selects the whole axis
                    out.append(("slice", None, None))
                    continue
                out.append(("idx", self.eval_expr(c[1], fr, loop)))
            else:
                lo = None if c[1] is None else int(self.eval_expr(c[1], fr, loop))
                hi = None if c[2] is None else int(self.eval_expr(c[2], fr, loop))
                out.append(("slice", lo, hi))
        return out

    def _apply_component(self, val, comps, fr, loop):
        """Matrix/vector component read (reference
        IR_MatNodes/IR_GetElement, IR_GetSlice; L4 `m[i][j]`, `m[a:b][:]`,
        `v[i]`): int+int -> scalar; any slice keeps matrixness (an int
        index becomes a size-1 extent, matching the reference's
        Matrix<1,n> slice results)."""
        if not is_mat(val):
            raise ValueError("component access on non-matrix value")
        specs = self._comp_specs(comps, fr, loop)
        if len(specs) == 1:
            # flat vector indexing: column vectors index rows, row vectors
            # index columns; matrices index rows
            if val.cols == 1:
                specs = [specs[0], ("idx", 0)]
            elif val.rows == 1:
                specs = [("idx", 0), specs[0]]
            else:
                specs = [specs[0], ("slice", None, None)]
        (k1, *a1), (k2, *a2) = specs
        if k1 == "idx" and k2 == "idx":
            i = a1[0] if hasattr(a1[0], "shape") else int(a1[0])
            j = a2[0] if hasattr(a2[0], "shape") else int(a2[0])
            return val.data[..., i, j]

        def to_slice(k, a):
            if k == "idx":
                i = int(a[0])
                return slice(i, i + 1)
            return slice(a[0], a[1])

        return MatVal(val.data[..., to_slice(k1, a1), to_slice(k2, a2)])

    def _to_loop_space(self, arr, offset, loop, elem_ndim: int = 0):
        """Map a field array into the current loop's index space:
        out[i] = arr[i + offset], zero beyond bounds.  Handles mixed
        localizations on staggered grids (shapes differ by +-1 per dim,
        reference field accesses with offsets like `u@[1,0]`); trailing
        `elem_ndim` dims (matrix-valued fields) pass through untouched."""
        gshape = arr.shape[: arr.ndim - elem_ndim]
        if loop is None:
            return arr if not offset else _shift(arr, offset)
        shape = loop.shape
        if gshape == tuple(shape) and not offset:
            return arr
        if len(gshape) != len(shape) or any(
            abs(a - b) > 1 for a, b in zip(gshape, shape)
        ):
            return arr if not offset else _shift(arr, offset)  # cross-level etc.
        off = offset or (0,) * len(shape)
        lo_pad = [max(0, -o) for o in off]
        hi_pad = [max(0, o + shape[d] - gshape[d]) for d, o in enumerate(off)]
        if any(lo_pad) or any(hi_pad):
            pads = tuple(zip(lo_pad, hi_pad)) + ((0, 0),) * elem_ndim
            arr = _pad(arr, pads)
        sl = tuple(
            slice(o + lo_pad[d], o + lo_pad[d] + shape[d]) for d, o in enumerate(off)
        )
        return arr[sl]

    def _shift_vf(self, name: str, val, offset):
        """Offset access on a virtual field (`vf_nodePos_x@[1,0]`,
        LinearElasticity's width expressions): the value at index i+o
        along the vf's own dimension.  Beyond the array the coordinate
        continues with the end spacing (linear extrapolation — exact for
        uniform grids; the reference evaluates virtual positions the
        same way, grid/ir/IR_VF_NodePosition).  Offsets along other
        dimensions do not change a per-dim coordinate."""
        if not isinstance(val, torch.Tensor) or val.dim() == 0:
            return val  # scalar (uniform width): offset-invariant
        suffix = name[-1]
        if name[-2] != "_" or suffix not in "xyz012":
            return val
        d = "xyz".index(suffix) if suffix in "xyz" else int(suffix)
        o = int(offset[d]) if d < len(offset) else 0
        if o == 0 or d >= val.ndim or val.shape[d] == 1:
            return val
        n = val.shape[d]
        ar = torch.arange(n, device=val.device)
        shifted = torch.index_select(val, d, torch.clamp(ar + o, 0, n - 1))
        bshape = [1] * val.dim()
        bshape[d] = n
        steps = ar.reshape(bshape)
        if o > 0:
            w = val.narrow(d, n - 1, 1) - val.narrow(d, n - 2, 1)
            over = torch.clamp(steps + o - (n - 1), min=0)
        else:
            w = val.narrow(d, 0, 1) - val.narrow(d, 1, 1)
            over = torch.clamp(-(steps + o), min=0)
        return shifted + w * over.to(shifted.dtype)

    def _eval_virtual_field(self, name: str, fr: Frame, loop):
        lvl = loop.level if loop is not None else fr.level
        grid = self.grids[lvl]
        loc = loop.localization if loop is not None else NODE
        if name.endswith(("_x", "_y", "_z")):
            d = "xyz".index(name[-1])
            base = name[:-2]
        elif name.endswith(("_0", "_1", "_2")):
            d = int(name[-1])  # numeric dim suffix (generated L4 form)
            base = name[:-2]
        else:
            d = None
            base = name
        if name in ("vf_xStagCellVolume", "vf_yStagCellVolume",
                    "vf_zStagCellVolume"):
            # staggered CV volume == cell volume on uniform interior grids
            # (grid/ir/IR_VF_StagCellVolume; boundary half-CVs carry
            # Dirichlet DOFs and are never assembled)
            return grid.volume_b(loc)
        if base in ("vf_gridWidth", "vf_cellWidth", "vf_stagCVWidth"):
            w = grid.width_b(d, loc)  # scalar (uniform) | per-cell tensor
            if isinstance(w, torch.Tensor) and w.dim():
                return self._fit_coord(w, d, loop)
            return w
        if base == "vf_cellVolume":
            return grid.volume_b(loc)
        if base in ("vf_nodePosition", "vf_nodePos"):
            coords = grid.coord_mesh(NODE if loc == NODE else loc)
            return self._fit_coord(coords[d], d, loop)
        if base in ("vf_cellCenter", "vf_cellCen"):
            c = grid.coords_1d(CELL, d)
            shape = [1] * grid.ndim
            shape[d] = c.shape[0]
            return self._fit_coord(c.reshape(shape), d, loop)
        if base in ("vf_boundaryPosition", "vf_boundaryCoord"):
            coords = grid.coord_mesh(loc)
            return self._fit_coord(coords[d], d, loop)
        raise ValueError(f"unsupported virtual field {name!r}")

    def _fit_coord(self, c, d: int, loop):
        """Edge-pad a coordinate tensor along its dim to the loop's
        extent (a staggered loop may be one node longer)."""
        if loop is None or d >= c.dim():
            return c
        tgt = loop.shape[d]
        cur = c.shape[d]
        if cur == 1 or cur >= tgt:
            return c
        pads = [(0, 0)] * c.dim()
        pads[d] = (0, tgt - cur)
        return _pad(c, pads, mode="edge")

    def _padded_operand(self, name: str, level: int, arr, r: int):
        """Pad a stencil operand with bc-consistent virtual ghosts
        (reference: `apply bc` materializes ghost layers for cell/face
        fields — boundary/ir/IR_DirichletBC order-2 interpolation
        `ghost = 2*g - inner`, IR_NeumannBC order-1 mirror; node fields
        and physical-boundary comm ghosts stay zero)."""
        info = self.fields[name]
        bc = info.bc_by_level.get(level)
        loc = info.localization
        nd = arr.dim() - len(info.elem_shape)  # pad grid dims only
        padw = ((r, r),) * nd + ((0, 0),) * len(info.elem_shape)
        if r == 0:
            return arr
        if loc == NODE or bc is None or not isinstance(bc, (NeumannBC, DirichletBC)):
            xp = _pad(arr, padw)
            if (name, level) in self._ghost_rules:
                xp = self._apply_ghost_rules(name, level, xp, arr, r)
            return xp
        if isinstance(bc, NeumannBC):
            return _pad(arr, padw, mode="edge")
        # Dirichlet on cell/face: along the face dim DOFs sit on the
        # boundary (ghost beyond stays zero); along cell dims
        # ghost = 2*g_wall - inner.
        face_dim = FACES.index(loc) if loc in FACES else None
        grid = self.grids[level]
        xp = _pad(arr, padw, mode="edge")
        coords = grid.coord_mesh(loc)
        for d in range(nd):
            if d == face_dim:
                for side in (0, 1):
                    for gi in range(r):
                        idx = gi if side == 0 else xp.shape[d] - 1 - gi
                        xp = _plane_set(xp, d, idx, 0.0)
                continue
            lo_coord = grid.domain.aabb.lower[d]
            hi_coord = grid.domain.aabb.upper[d]
            within = {
                i: (r, r + arr.shape[i]) for i in range(nd) if i != d
            }
            for side in (0, 1):
                wall = lo_coord if side == 0 else hi_coord
                edge_idx = 0 if side == 0 else arr.shape[d] - 1
                pl_edge = tuple(edge_idx if i == d else slice(None) for i in range(nd))
                edge_vals = arr[pl_edge]
                if callable(bc.value):
                    pc = []
                    for i, c in enumerate(coords):
                        if i == d:
                            pc.append(torch.as_tensor(wall, dtype=grid.dtype,
                                                      device=self.device))
                        else:
                            # drop the (size-1) dim d so the coord
                            # broadcasts over the wall plane
                            pc.append(
                                c[tuple(0 if j == d else slice(None) for j in range(nd))]
                            )
                    gvals = bc.value(*pc)
                else:
                    gvals = bc.value
                ghost = torch.broadcast_to(
                    2.0 * gvals - edge_vals, edge_vals.shape
                ).to(xp.dtype)
                # align the (unpadded) wall plane with xp coordinates:
                # other dims are offset by r; pad values outside the
                # `within` window are never consumed
                ghost_x = _pad(ghost, r)
                for gi in range(r):
                    idx = (r - 1 - gi) if side == 0 else xp.shape[d] - r + gi
                    xp = _plane_set(xp, d, idx, ghost_x, within=within)
        return xp

    def _eval_binop(self, e: N.BinOp, fr: Frame, loop):
        if self.frag is not None and e.op == "*" and self._stencil_valued(e.lhs) \
                and self._stencil_valued(e.rhs):
            self._fresh_coefficients(e, fr.level)  # a product shifts coefficients
        lhs = self.eval_expr(e.lhs, fr, loop)
        if e.op == "*" and _is_stencil(lhs):
            _, st, st_level = lhs
            if not isinstance(e.rhs, N.Access) or e.rhs.name not in self.fields:
                # stencil * stencil -> composition; stencil * scalar -> scale
                rhs = self.eval_expr(e.rhs, fr, loop)
                if _is_stencil(rhs):
                    if isinstance(st, BoundStencil) and isinstance(rhs[1], BoundStencil):
                        return ("__stencil__", st.compose(rhs[1]), st_level)
                    raise ValueError(
                        "stencil-stencil products need bound offset stencils"
                    )
                if (hasattr(rhs, "shape") and getattr(rhs, "shape", ()) != ()) \
                        or is_mat(rhs):
                    # stencil applied to a general EXPRESSION (an Expr
                    # alias like SWE's `Centering * q`): the convolution
                    # re-evaluates the operand expression at each window
                    # offset, so every contained field keeps its own
                    # bc-aware ghost semantics (reference resolves the
                    # inlined expression the same way)
                    if not isinstance(st, BoundStencil):
                        raise ValueError(
                            "inter-grid stencil needs a field operand")
                    total = None
                    for off, c in zip(st.offsets, st.coefs):
                        tv = self.eval_expr(
                            N.shift_offsets(e.rhs, tuple(off)), fr, loop)
                        td = tv.data if is_mat(tv) else tv
                        term = (c.data if is_mat(c) else c) * td
                        total = term if total is None else total + term
                    return MatVal(total) if is_mat(rhs) else total
                return ("__stencil__", _scale_stencil(st, rhs), st_level)
            f_level = self._resolve_level(e.rhs.level, fr)
            off_r = max((abs(int(o)) for o in e.rhs.offset), default=0) if e.rhs.offset else 0
            self._offset_read(e.rhs.name, f_level, e.rhs.slot,
                              (st.radius + off_r) if isinstance(st, BoundStencil) else 1)
            arr = self.get_field(e.rhs.name, f_level, e.rhs.slot)
            if e.rhs.sten_entry is not None \
                    and e.rhs.name in self.stencil_templates:
                # stencil applied to ONE stencil-field coefficient plane
                # (ExaFluids' StencilRestrictionComponent template:
                # `dest:[o] = restrictionStencil * source:[o]`)
                kk = self.stencil_templates[e.rhs.name].offsets.index(
                    tuple(e.rhs.sten_entry))
                arr = arr[..., kk, 0]
            if isinstance(st, BoundStencil):
                fz = getattr(self, "_frozen_ctx", None)
                if fz is not None and fz[0] == e.rhs.name and fz[1] == f_level:
                    conv = self._apply_stencil_frozen(
                        st, e.rhs.name, f_level, arr, fz[2], fz[3])
                    return self._to_loop_space(conv, e.rhs.offset, loop)
                # matrix-coefficient stencils applied to vector fields
                # (OpticalFlow: combinedOp * flow with Vec2 unknowns and
                # 2x2 coefficient blocks) contract per-point: c @ u
                info_r = self.fields.get(e.rhs.name)
                e_nd = len(info_r.elem_shape) if info_r else 0
                if e_nd or any(is_mat(c) for c in st.coefs):
                    conv = self._apply_stencil_matrix(
                        st, e.rhs.name, f_level, arr, e_nd)
                    val = self._to_loop_space(
                        conv, e.rhs.offset, loop, elem_ndim=e_nd)
                    return MatVal(val) if e_nd else val
                # array-coefficient stencils (stencil fields) put the
                # result on the COEFFICIENT grid, which may differ from
                # the operand grid by +-1 per dim on staggered meshes
                # (A12 on Face_x applied to v on Face_y); widen the pad
                # so every window slice stays in bounds
                out_shape = tuple(arr.shape)
                c0 = st.coefs[0] if st.coefs else None
                if hasattr(c0, "shape") and getattr(c0, "shape", ()) != ():
                    out_shape = tuple(c0.shape)
                r = st.radius + max(
                    0, max(o - a for o, a in zip(out_shape, arr.shape)))
                xp = self._padded_operand(e.rhs.name, f_level, arr, r)
                conv = apply_stencil(st, xp, padded_radius=r, out_shape=out_shape)
                return self._to_loop_space(conv, e.rhs.offset, loop)
            return self._intergrid_apply(st, e.rhs.name, arr, f_level, loop)
        rhs = self.eval_expr(e.rhs, fr, loop)
        if _is_stencil(rhs):
            if e.op == "*":
                return ("__stencil__", _scale_stencil(rhs[1], lhs), rhs[2])
            raise ValueError(f"cannot apply {e.op} to a stencil")
        if e.op == "/" and _is_int(lhs) and _is_int(rhs) and (
                isinstance(lhs, torch.Tensor) or isinstance(rhs, torch.Tensor)):
            # integer tensors divide into the real dtype (jnp true_divide
            # promotes to the default float; torch would give float32)
            lhs = lhs.to(self.dtype) if isinstance(lhs, torch.Tensor) else lhs
            rhs = rhs.to(self.dtype) if isinstance(rhs, torch.Tensor) else rhs
        return _apply_binop(e.op, lhs, rhs)

    def _apply_stencil_matrix(self, st: BoundStencil, name: str, level: int,
                              arr, e_nd: int):
        """Convolution with matrix-valued coefficients and/or vector-
        valued operand DOFs: out[i] = sum_k C_k[i] @ u[i + off_k]
        (reference IR_StencilConvolution on Matrix<..> datatypes —
        OpticalFlow's coupled 2x2 system)."""
        r = st.radius
        gshape = tuple(self.true_shape(name, level))
        xp = self._padded_operand(name, level, arr, r)
        out = None
        for off, c in zip(st.offsets, st.coefs):
            sl = tuple(
                slice(r + o, r + o + n) for o, n in zip(off, gshape)
            ) + (slice(None),) * e_nd
            xs = xp[sl]
            if is_mat(c):
                term = torch.einsum("...ij,...jk->...ik", c.data, xs) \
                    if e_nd else MV.mat_binop("*", c, xs).data
            elif e_nd and hasattr(c, "ndim") and getattr(c, "ndim", 0):
                term = c[(...,) + (None,) * e_nd] * xs
            else:
                term = c * xs
            out = term if out is None else out + term
        return out

    def _intergrid_apply(self, ig: IntergridStencil, name: str, arr, f_level: int, loop):
        if loop is None:
            raise ValueError("inter-grid convolution outside a loop")
        if self.frag is not None:
            return self._intergrid_windows(ig, name, arr, f_level, loop)
        out_level = loop.level
        out_shape = self.grids[out_level].shape_of(loop.localization)
        key = (id(ig), f_level, out_level, out_shape, tuple(arr.shape), arr.dtype)
        if key not in self._transfer_cache:
            if out_level < f_level:
                mats = build_restrict_mats(ig, out_shape, tuple(arr.shape), out_shape)
            elif out_level > f_level:
                mats = build_prolong_mats(ig, out_shape, tuple(arr.shape), out_shape)
            else:
                raise ValueError("mapping stencil applied at equal levels")
            self._transfer_cache[key] = [
                torch.as_tensor(M, dtype=arr.dtype, device=arr.device) for M in mats]
        return apply_separable(self._transfer_cache[key], arr)

    # ------------------------------------------------------------------
    def call_function(self, fn: N.FunctionDecl, level: Optional[int], args):
        if not timers.active():
            return self._call(fn, level, args)
        with contextlib.ExitStack() as spans:
            for kind in self._span_kinds(fn, level):
                spans.enter_context(timers.span(kind, fn.name, level))
            return self._call(fn, level, args)

    def _call(self, fn: N.FunctionDecl, level: Optional[int], args):
        fr = Frame(dict(zip((p[0] for p in fn.params), args)), level)
        self._frames.append(fr)
        self._calls.append((fn, level))
        try:
            self.exec_block(fn.body, fr)
        except _Return as r:
            return r.value
        finally:
            self._frames.pop()
            self._calls.pop()
        return None

    def _span_kinds(self, fn: N.FunctionDecl, level: Optional[int]) -> List[str]:
        """The spans (runtime/timers) a call opens, outermost first: `solve`
        for a call from the host; `cycle` and `level` for the program's
        cycle function (one that calls itself on a coarser level) on the
        finest level, `level` below it; `check` for any other call on the
        finest level made by a solve driver (a function that calls the
        cycle function on the finest level)."""
        if self._span_roles is None:
            self._span_roles = self._find_span_roles()
        cycles, drivers = self._span_roles
        kinds = [] if self._calls else ["solve"]
        if fn.name in cycles:
            kinds += ["cycle", "level"] if level == self.hi else ["level"]
        elif level == self.hi and self._calls \
                and (id(self._calls[-1][0]), self._calls[-1][1]) in drivers:
            kinds.append("check")
        return kinds

    def _find_span_roles(self):
        """(names of cycle functions, (id, level) of solve drivers), from
        the calls in the functions' bodies."""
        def calls(node):
            stack = [node]
            while stack:
                x = stack.pop()
                if isinstance(x, (list, tuple)):
                    stack.extend(x)
                elif dataclasses.is_dataclass(x) and not isinstance(x, type):
                    if isinstance(x, N.Call):
                        yield x
                    stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))

        def levels(c, current):
            if c.level is None:
                return [current]
            try:
                return c.level.resolve(self.lo, self.hi, current)
            except ValueError:  # a relative level where the caller has none
                return []

        made = {key: list(calls(fn.body)) for key, fn in self.functions.items()}
        cycles = {name for (name, lvl), cs in made.items() if lvl is not None
                  and any(c.name == name and min(levels(c, lvl), default=lvl) < lvl for c in cs)}
        drivers = {(id(self.functions[key]), key[1]) for key, cs in made.items()
                   if any(c.name in cycles and self.hi in levels(c, key[1]) for c in cs)}
        return cycles, drivers

    def _host_read(self, conv, v, what: str):
        """conv(v), where each tensor or matrix in `v` (a value or a list) is
        a host read outside a staged run, counted in
        `StageStats.eager_reads` and a `host_read` span."""
        n = sum(isinstance(x, torch.Tensor) or is_mat(x)
                for x in (v if isinstance(v, list) else [v]))
        if not n:
            return conv(v)
        self.stage_stats.eager_reads += n
        with timers.host_read(what, n):
            return conv(v)

    # ------------------------------------------------------------------
    def emit(self, text: str, newline: bool = True):
        """Line-buffered output: `std::cout <<` segments without an endl
        (e.g. evalMOpRuntimeExe) accumulate until the next newline."""
        if newline:
            self.out(self._pending_out + text)
            self._pending_out = ""
        else:
            self._pending_out += text

    def flush_out(self):
        if self._pending_out:
            self.out(self._pending_out)
            self._pending_out = ""

    def run(self, function: str = "Application"):
        """Execute `Function Application` (reference main(), §3.3)."""
        fkey = (function, None)
        if fkey not in self.functions:
            candidates = [k for k in self.functions if k[0] == function]
            if not candidates:
                raise ValueError(f"no function {function!r}")
            fkey = candidates[0]
        try:
            return self.call_function(self.functions[fkey], fkey[1], [])
        except _Exit as ex:
            return ex.code  # DSL exit(code): terminate the application
        finally:
            self.flush_out()

    # ------------------------------------------------------------------
    # statements
    def exec_block(self, stmts: List[N.Stmt], fr: Frame, loop=None):
        """Execute statements with C++-style block scoping: Var/Val
        declarations die (and stop shadowing outer names) at block exit.
        With `jit_functions`, maximal stageable runs execute as one
        recording (see _run_staged)."""
        shadowed = {}
        declared = set()

        def note_decls(run):
            for s in run:
                if isinstance(s, N.VarDecl) and s.name not in declared:
                    declared.add(s.name)
                    if s.name in fr.vars:
                        shadowed[s.name] = fr.vars[s.name]

        try:
            for run, staged in self._partition_stmts(stmts, fr, loop):
                note_decls(run)
                if staged:
                    self._run_staged(run, fr)
                else:
                    self._exec_plan_aware(run, fr, loop)
        finally:
            for name in declared:
                if name in shadowed:
                    fr.vars[name] = shadowed[name]
                else:
                    fr.vars.pop(name, None)

    def _exec_plan_aware(self, stmts: List[N.Stmt], fr: Frame, loop=None):
        """Execute a statement run, routing recognized multigrid legs
        through the CUDA fast path (dsl/fastpath.py).  Called both eagerly
        and inside staged runs, where the kernels are captured with the
        rest of the run."""
        plan = ()
        if self._fastpath is not None and loop is None and fr.level is not None:
            plan = self._fastpath.plan(stmts, fr.level)
        if not plan:
            for s in stmts:
                self.exec_stmt(s, fr, loop)
            return
        idx = 0
        for seg in plan:
            for s in stmts[idx:seg.start]:
                self.exec_stmt(s, fr, loop)
            seg.run(self, fr)
            idx = seg.end + 1
        for s in stmts[idx:]:
            self.exec_stmt(s, fr, loop)

    def exec_stmt(self, s: N.Stmt, fr: Frame, loop: Optional[_LoopCtx] = None):
        if isinstance(s, N.VarDecl):
            fr.vars[s.name] = self._coerce_decl(s, fr, loop)
        elif isinstance(s, N.Assign):
            self._exec_assign(s, fr, loop)
        elif isinstance(s, N.If):
            cond = self.eval_expr(s.cond, fr, loop)
            if loop is not None and hasattr(cond, "shape") and cond.shape \
                    and any(isinstance(x, N.Return)
                            for x in s.then_body + s.else_body):
                # early exit from inside a data-parallel loop (the
                # IOTest compareFields pattern: `if (diff > eps) {
                # print(..); return -1 }`): fire when ANY point matches.
                # The body runs ONCE (not per point), so it must consist
                # of side-effect statements only — an assignment here
                # would write every grid point instead of the matching
                # subset (advisor r4), which we refuse rather than get
                # wrong.
                def side_effect_only(body):
                    return all(
                        isinstance(x, (N.Return, N.ExprStmt)) for x in body
                    )

                if not side_effect_only(s.then_body + s.else_body):
                    raise NotImplementedError(
                        "per-point `if` with `return` inside a field loop "
                        "mixes assignments with the early exit; only "
                        "side-effect statements (print/exit) are supported "
                        "in such a branch"
                    )
                m = torch.broadcast_to(cond, loop.shape)
                if loop.mask is not None:
                    m = torch.logical_and(m, loop.mask)
                if self._any(m, loop):
                    self.exec_block(s.then_body, fr, loop)
                elif s.else_body:
                    self.exec_block(s.else_body, fr, loop)
                return
            if loop is not None and hasattr(cond, "shape") and cond.shape:
                # per-point branch inside a data-parallel loop: the
                # reference emits an if inside the generated loop nest —
                # here both branches run under complementary masks
                base = loop.mask
                m = torch.broadcast_to(cond, loop.shape)
                loop.mask = m if base is None else torch.logical_and(base, m)
                self.exec_block(s.then_body, fr, loop)
                if s.else_body:
                    nm = torch.logical_not(m)
                    loop.mask = nm if base is None else torch.logical_and(base, nm)
                    self.exec_block(s.else_body, fr, loop)
                loop.mask = base
            elif self._host_read(bool, cond, "if"):
                self.exec_block(s.then_body, fr, loop)
            else:
                self.exec_block(s.else_body, fr, loop)
        elif isinstance(s, N.RepeatTimes):
            if self.jit_functions and loop is None and self.frag is None:
                parts = self._match_early_exit_repeat(s, fr.level)
                if parts is None and not self._in_trace \
                        and isinstance(s.count, N.Num) \
                        and float(s.count.value) > 24 \
                        and all(self._stmt_stageable(x, fr.level)
                                for x in s.body) \
                        and not self._body_mutates_slots(s.body, fr.level):
                    # large no-exit repeat: one device loop with a
                    # never-true exit (its body captured ONCE instead of
                    # unrolled 128x), replayed with no host read
                    parts = (list(s.body), N.Num(0, is_int=True), [])
                if parts is not None:
                    if self._in_trace:
                        # tail position (enforced by _fn_stageable):
                        # early return == loop break, lower inline
                        self._exec_repeat_early_exit_traced(s, fr, parts)
                        return
                    handled = self._exec_repeat_early_exit(s, fr, parts)
                    if handled == "return":
                        raise _Return(None)
                    if handled:
                        return
            n = int(self.eval_expr(s.count, fr, loop))
            for it in range(n):
                if s.count_var is not None:
                    fr.vars[s.count_var] = it
                try:
                    self.exec_block(s.body, fr, loop)
                except _Break:
                    break
                if s.count_var is not None:
                    fr.vars[s.count_var] = it + 1
        elif isinstance(s, N.RepeatUntil):
            while True:
                cond = self._host_read(bool, self.eval_expr(s.cond, fr, loop), "repeat until")
                if s.is_while and not cond:
                    break
                if (not s.is_while) and cond:
                    break
                try:
                    self.exec_block(s.body, fr, loop)
                except _Break:
                    break
        elif isinstance(s, N.LoopOverField):
            self._exec_loop(s, fr)
        elif isinstance(s, N.LoopOverFragments):
            self.exec_block(s.body, fr, loop)
        elif isinstance(s, N.ColorWith):
            self._exec_color(s, fr)
        elif isinstance(s, N.RepeatWith):
            for cond in s.conditions:
                self._exec_masked_block(cond, s.body, fr)
        elif isinstance(s, N.LevelScope):
            levels = s.levels.resolve(self.lo, self.hi, fr.level)
            if fr.level in levels:
                self.exec_block(s.body, fr, loop)
        elif isinstance(s, N.SolveMatSys):
            A = self.eval_expr(s.A, fr, loop)
            f = self.eval_expr(s.f, fr, loop)
            sol = MatVal(torch.linalg.solve(A.data, f.data))
            self._mutate_matrix_var(s.u, fr, loop, lambda _cur: sol)
        elif isinstance(s, N.SolveLocally):
            self._exec_solve_locally(s, fr, loop)
        elif isinstance(s, N.Communicate):
            with self.timers.auto_scope(
                    "COMM", self._resolve_level(s.field.level, fr)):
                self._exec_communicate(s, fr)
        elif isinstance(s, N.ApplyBC):
            lvl = self._resolve_level(s.field.level, fr)
            with self.timers.auto_scope("APPLYBC", lvl):
                bc = self.fields[s.field.name].bc_by_level.get(lvl)
                if isinstance(bc, _FunctionBC):
                    fn = self.functions.get((bc.fn_name, lvl)) \
                        or self.functions.get((bc.fn_name, None))
                    if fn is None:
                        raise ValueError(f"bc function {bc.fn_name!r} not found")
                    self.call_function(fn, lvl, [])
                    return
                arr = self.get_field(s.field.name, lvl, s.field.slot)
                self.set_field(s.field.name, lvl,
                               self._apply_bc_field(s.field.name, lvl, arr),
                               s.field.slot)
        elif isinstance(s, N.Advance):
            lvl = self._resolve_level(s.field.level, fr)
            key = (s.field.name, lvl)
            self.slot_index[key] = (self.slot_index[key] + 1) % self.fields[s.field.name].num_slots
        elif isinstance(s, N.Return):
            raise _Return(self.eval_expr(s.value, fr, loop) if s.value is not None else None)
        elif isinstance(s, N.Break):
            raise _Break()
        elif isinstance(s, N.ExprStmt):
            self.eval_expr(s.expr, fr, loop)
        else:
            raise ValueError(f"cannot execute {s}")

    def _coerce_decl(self, s: N.VarDecl, fr: Frame, loop):
        """Var/Val initialization coerced to the declared datatype:
        Matrix/Vector shapes are enforced (a flat `{a,b,c}` literal
        reshapes to RowVector/Matrix<1,n> as declared), 1x1 matrices
        collapse into scalar declarations, Int casts, Complex promotes
        (reference L4 variable declarations + IR_MatrixExpression
        shape inference)."""
        if s.datatype == "__Expr__":
            # `Expr name = <expression>`: a lazy alias — uses re-evaluate
            # in context; `name@[off]` shifts the contained accesses
            # (reference L4 expression declarations, inlined not stored)
            return ("__alias__", s.init)
        try:
            val = self.eval_expr(s.init, fr, loop) if s.init is not None else None
        except ValueError as err:
            if "unknown identifier" in str(err) and s.datatype \
                    and s.datatype.startswith("Tensor"):
                # Testing/TensorClass/Constructors/Tensor2_constructors
                # initializes from an undeclared name (`t3 = m1`);
                # degrade to default-init the way the empty reference
                # golden implies
                val = None
            else:
                raise
        elem_shape, is_cplx = _dtype_info(s.datatype)
        if elem_shape:
            dtype = self.complex_dtype if is_cplx else self.dtype
            if val is None:
                return MatVal(torch.zeros(elem_shape, dtype=dtype, device=self.device))
            if is_mat(val):
                if len(elem_shape) != 2:  # TensorN order > 2: exact match
                    return val
                if val.batch == () and (val.rows, val.cols) != elem_shape \
                        and val.rows * val.cols == elem_shape[0] * elem_shape[1]:
                    return MatVal(val.data.reshape(elem_shape))
                return val
            # scalar init broadcast over all entries
            return MatVal(torch.broadcast_to(
                torch.as_tensor(val, dtype=dtype, device=self.device), elem_shape).clone())
        if is_mat(val):
            if val.rows == 1 and val.cols == 1:
                val = val.data[..., 0, 0]
            else:
                return val  # tolerate matrix value in untyped decl
        if val is None:
            return 1j * 0.0 if is_cplx else 0.0
        if is_cplx and not (isinstance(val, torch.Tensor) and torch.is_complex(val)) \
                and not isinstance(val, complex):
            val = val + 0.0j
        if s.datatype in ("Int", "Integer") and getattr(val, "shape", ()) == ():
            f = float(val)
            # C++ double->int truncates; but LU-based det/inverse return
            # 406.99999... where the reference's exact Laplace expansion
            # returns 407 — snap to the integer when within rounding noise
            val = int(round(f)) if abs(f - round(f)) < 1e-6 else int(f)
        return val

    def _exec_assign(self, s: N.Assign, fr: Frame, loop):
        t = s.target
        if t.name in self.stencil_templates and t.sten_entry is not None:
            # `A:[off] (op)= expr` writes one stencil-field coefficient
            # component (reference IR_StencilFieldAccess assignment)
            from dataclasses import replace as _dc_replace

            k = self.stencil_templates[t.name].offsets.index(tuple(t.sten_entry))
            t = _dc_replace(t, sten_entry=None, component=(
                ("idx", N.Num(k, is_int=True)), ("idx", N.Num(0, is_int=True))))
            s = N.Assign(t, s.op, s.value)
        if t.name in self.fields:
            info = self.fields[t.name]
            lvl = self._resolve_level(t.level, fr)
            loc = info.localization
            mask = loop.mask if loop and loop.level == lvl else None
            sub = _LoopCtx(lvl, loc, self.true_shape(t.name, lvl), mask=mask)
            val = self.eval_expr(s.value, fr, sub)
            cur = self.get_field(t.name, lvl, t.slot)
            e_nd = len(info.elem_shape)
            if e_nd and t.component:
                new = self._component_write(cur, t.component, s.op, val,
                                            sub.mask, fr, sub)
            else:
                v = val.data if is_mat(val) else val
                if not e_nd and is_mat(val) and val.rows == 1 and val.cols == 1:
                    v = val.data[..., 0, 0]  # 1x1 (dot result) -> scalar
                if e_nd and not is_mat(val) and hasattr(v, "ndim") \
                        and v.ndim == cur.ndim - e_nd:
                    # grid-scalar into a matrix-valued field: broadcast
                    # over the element dims (reference scalar->matrix
                    # assignment semantics)
                    v = v[(...,) + (None,) * e_nd]
                new = _apply_assign(s.op, cur, v)
                if sub.mask is not None:
                    m = sub.mask[(...,) + (None,) * e_nd] if e_nd else sub.mask
                    new = torch.where(m, new, cur)
            self.set_field(t.name, lvl, new, t.slot)
            return
        # scalar variable (possibly a reduction accumulator)
        cur_env = fr.vars if t.name in fr.vars else (
            self.globals if t.name in self.globals else fr.vars
        )
        if loop is not None and loop.reduction and t.name == loop.reduction[1]:
            self._exec_reduction_assign(s, fr, loop, cur_env)
            return
        val = self.eval_expr(s.value, fr, loop)
        if t.component:
            cur = cur_env.get(t.name)
            if not is_mat(cur):
                raise ValueError(f"component assignment to non-matrix {t.name!r}")
            cur_env[t.name] = MatVal(self._component_write(
                cur.data, t.component, s.op, val, None, fr, loop))
            return
        cur = cur_env.get(t.name, 0.0)
        if is_mat(cur) and not is_mat(val):
            # whole-matrix assignment from a broadcastable scalar
            cur_env[t.name] = MV.mat_binop(
                {"=": "*", "+=": "+", "-=": "-", "*=": "*", "/=": "/"}[s.op],
                cur if s.op != "=" else MatVal(torch.ones_like(cur.data)), val)
            return
        cur_env[t.name] = _apply_assign(s.op, cur, val)

    def _component_write(self, data, comps, op, val, mask, fr, loop):
        """`m[i][j] (+)= v` / `m[a:b][:] = v` on an array with trailing
        (r, c) element dims (reference IR_SetElement / IR_SetSlice);
        `mask` (grid-shaped) confines the update inside masked loops."""
        specs = self._comp_specs(comps, fr, loop)
        if len(specs) == 1:
            r, c = data.shape[-2], data.shape[-1]
            if c == 1:
                specs = [specs[0], ("idx", 0)]
            elif r == 1:
                specs = [("idx", 0), specs[0]]
            else:
                specs = [specs[0], ("slice", None, None)]

        def to_index(k, a):
            if k == "idx":
                return int(a[0])
            return slice(a[0], a[1])

        idx = (..., to_index(*[specs[0][0], specs[0][1:]]),
               to_index(*[specs[1][0], specs[1][1:]]))
        sub = data[idx]
        v = val.data if is_mat(val) else val
        if is_mat(val) and isinstance(idx[-2], int) is False and isinstance(idx[-1], int) is False:
            pass  # shapes align (slice, slice)
        elif is_mat(val):
            # assigning a matrix into an int-indexed (collapsed) target:
            # squeeze size-1 dims of the value
            v = torch.squeeze(v, dim=tuple(
                ax for ax in (-2, -1) if v.shape[ax] == 1
            )) if v.ndim >= 2 else v
        new_sub = _apply_assign(op, sub, v)
        if mask is not None:
            e_nd = new_sub.ndim - len(mask.shape)
            m = mask[(...,) + (None,) * e_nd] if e_nd > 0 else mask
            new_sub = torch.where(m, new_sub, sub)
        out = data.clone()
        out[idx] = torch.broadcast_to(torch.as_tensor(new_sub, dtype=data.dtype,
                                                      device=data.device), sub.shape)
        return out

    def _exec_reduction_assign(self, s: N.Assign, fr: Frame, loop: _LoopCtx, env):
        """`redvar += expr` / `redvar = max(redvar, expr)` inside a
        reduction loop -> whole-array reduce then scalar combine."""
        op, var = loop.reduction
        # sharded: each rank reduces the points it owns, then all ranks
        # combine (the same bits on every rank); None on a dense run
        own = self._owned(loop.level, loop.localization)
        if s.op == "+=":
            arr = self.eval_expr(s.value, fr, loop)
            if is_mat(arr) and arr.rows == 1 and arr.cols == 1:
                arr = arr.data[..., 0, 0]  # dot() returns a 1x1 matrix
            if own is not None:
                m = own if loop.mask is None else torch.logical_and(loop.mask, own)
                red = self.frag.all_reduce(torch.sum(torch.where(m, arr, 0)), "sum")
            else:
                red = torch.sum(torch.where(loop.mask, arr, 0)) if loop.mask is not None \
                    else torch.sum(arr)
            env[var] = _apply_binop("+", env.get(var, 0.0), red)
            return
        if s.op == "*=":
            arr = self.eval_expr(s.value, fr, loop)
            red = torch.prod(arr) if own is None else \
                self.frag.all_reduce(torch.prod(torch.where(own, arr, 1)), "prod")
            env[var] = _apply_binop("*", env.get(var, 1.0), red)
            return
        if s.op == "=" and isinstance(s.value, N.Call) and s.value.name in ("min", "max"):
            others = [a for a in s.value.args
                      if not (isinstance(a, N.Access) and a.name == var)]
            arrs = [self.eval_expr(a, fr, loop) for a in others]
            f_red = torch.amin if s.value.name == "min" else torch.amax
            combined = _minmax(s.value.name, arrs) if len(arrs) > 1 else arrs[0]
            fill = math.inf if s.value.name == "min" else -math.inf
            if loop.mask is not None:
                combined = torch.where(loop.mask, combined, fill)
            if own is not None:
                red = self.frag.all_reduce(f_red(torch.where(own, combined, fill)),
                                           s.value.name)
            else:
                red = f_red(combined)
            env[var] = _minmax(s.value.name, [env.get(var, 0.0), red])
            return
        raise ValueError(f"unsupported reduction statement {s}")

    def _exec_loop(self, s: N.LoopOverField, fr: Frame, color_ctx=None):
        lvl = self._resolve_level(s.field.level, fr)
        info = self.fields[s.field.name]
        shape = self.true_shape(s.field.name, lvl)
        if color_ctx is None and s.condition is None and len(s.body) == 1 \
                and isinstance(s.body[0], N.Assign) \
                and s.body[0].target.name == s.field.name \
                and info.num_slots == 1 \
                and not self._is_native_rand_init(s.body[0].value) \
                and (s.sequentially or self._self_stencil_dep(s.body[0], lvl)):
            # in-place update reading own neighbors: the reference's C++
            # loop nest is lexicographic (Gauss-Seidel semantics), NOT
            # parallel -- execute as a wavefront sweep
            return self._exec_seq_loop(s, fr, lvl, info, shape)
        if s.region is not None and s.region[0] == "ghost" and info.ghost > 0 \
                and len(s.body) == 1 and isinstance(s.body[0], N.Assign) \
                and s.body[0].target.name == s.field.name:
            # `loop over f only ghost [dir] on boundary { f = expr }` on a
            # field with declared ghost layers: ghost storage is VIRTUAL
            # here (stencil operands pad on demand), so the loop becomes
            # a ghost RULE evaluated whenever the operand pad is built
            # (reference: the generated loop writes the allocated ghost
            # layer; ApplyBC_u in Testing/Application/ExaStokes_2D)
            self._record_ghost_rule(s, fr, lvl)
            return
        loop = _LoopCtx(lvl, info.localization, shape, reduction=s.reduction)
        if s.region is None:
            if s.starting or s.ending:
                # `starting [..] ending [..]`: offsets on the default
                # iteration bounds (IR_LoopOverPoints start/end offsets;
                # negative values extend into dup/ghost territory —
                # clamped to the stored extents, virtual ghosts are
                # zero-filled on read anyway)
                dims_dup = set()
                if info.localization == NODE:
                    dims_dup = set(range(len(shape)))
                elif info.localization in FACES:
                    dims_dup = {FACES.index(info.localization)}
                if info.dup_layers is not None:
                    dims_dup = {
                        d for d in dims_dup
                        if d < len(info.dup_layers) and info.dup_layers[d] > 0
                    }
                m = None
                gtrue = self._gshape(lvl, info.localization)
                for d in range(len(shape)):
                    lo = 1 if d in dims_dup else 0
                    hi = gtrue[d] - 2 if d in dims_dup else gtrue[d] - 1
                    if s.starting and d < len(s.starting):
                        lo += int(s.starting[d])
                    if s.ending and d < len(s.ending):
                        hi -= int(s.ending[d])
                    i = self._gidx(shape, d, lvl, info.localization)
                    mm = torch.logical_and(i >= lo, i <= hi)
                    m = mm if m is None else torch.logical_and(m, mm)
                loop.mask = m if loop.mask is None else torch.logical_and(
                    loop.mask, m)
            else:
                # default iteration space eliminates 'real' (physical
                # domain) boundaries along node-localized dims
                # (IR_LoopOverPointsInOneFragment.scala:73-101)
                bmask = self._node_interior_mask(
                    info.localization, shape, lvl, info.dup_layers)
                if bmask is not None:
                    loop.mask = bmask if loop.mask is None else torch.logical_and(
                        loop.mask, bmask)
        if color_ctx is not None:
            loop.mask = color_ctx if loop.mask is None else torch.logical_and(
                loop.mask, color_ctx)
        if s.condition is not None:
            cond = self.eval_expr(s.condition, fr, loop)
            loop.mask = _and(loop.mask, cond)
        if s.region is not None:
            rmask = self._region_mask(s, shape, lvl, info.localization)
            loop.mask = rmask if loop.mask is None else torch.logical_and(loop.mask, rmask)
        if s.stepping:
            # `stepping [2,2,2]` visits every step-th point, anchored at
            # the loop's start index — the first interior point on
            # node-Dirichlet dims (IterationOffsets), 0 otherwise.  The
            # block smoother (Testing/Smoothers/BS) anchors its 2x2x2
            # solve-locally blocks this way.
            interior_dims = set()
            if info.localization == NODE:
                interior_dims = {
                    d for d in range(len(shape))
                    if d < len(info.dup_layers) and info.dup_layers[d] > 0
                }
            elif info.localization in FACES:
                d = FACES.index(info.localization)
                if d < len(info.dup_layers) and info.dup_layers[d] > 0:
                    interior_dims = {d}
            for d, step in enumerate(s.stepping):
                if step and int(step) > 1:
                    start = 1 if d in interior_dims else 0
                    i = self._gidx(shape, d, lvl, info.localization)
                    mm = (i - start) % int(step) == 0
                    loop.mask = mm if loop.mask is None else torch.logical_and(
                        loop.mask, mm)
        if s.reduction is not None:
            op, var = s.reduction
            fr.vars.setdefault(var, 0.0)
        self.exec_block(s.body, fr, loop)

    def _is_native_rand_init(self, e) -> bool:
        """`f = native("...std::rand()...")` sequential inits carry no
        self-dependence — they run as one masked assign whose values are
        laid out in the C++ loop's lexicographic order (the wavefront
        would draw them once per anti-diagonal)."""
        return (isinstance(e, N.Call) and e.name == "native" and e.args
                and isinstance(e.args[0], N.Str)
                and "std::rand()" in str(e.args[0].value))

    def _ghost_key(self, name: str, d: int, side: int) -> str:
        return f"{name}__ghost{d}{'p' if side > 0 else 'm'}"

    def _record_ghost_rule(self, s: N.LoopOverField, fr: Frame, lvl: int):
        """Execute a ghost-region bc loop by MATERIALIZING the ghost
        plane as a state entry — exactly the reference's semantics where
        the generated loop writes the allocated ghost storage: the plane
        keeps the value from this `apply bc` (reads inside subsequent
        smoother sweeps see the then-stale ghost, like the C++ array
        does) until the next bc application overwrites it.  Plane values
        live in self.state."""
        name = s.field.name
        a = s.body[0]
        rdir = tuple(s.region[1] or ())
        d = next((i for i, v in enumerate(rdir) if v != 0), None)
        if d is None:
            return
        side = 1 if rdir[d] > 0 else -1
        arr = self.get_field(name, lvl)
        true = self.true_shape(name, lvl)
        nd = len(true)
        edge = true[d] - 1 if side > 0 else 0

        def plane_of(off_d):
            # ghost plane index = edge + side; expr offsets are relative
            # to the ghost plane: f@[.., o, ..] -> stored plane edge+side+o
            idx = edge + side + off_d
            if not 0 <= idx < true[d]:
                raise NotImplementedError("ghost rule reads beyond storage")
            sl = tuple(
                slice(None) if i != d else slice(idx, idx + 1)
                for i in range(nd)
            )
            return arr[sl]

        def plane_coord(vf_name):
            """Coordinate array of the ghost plane for a vf access
            (Benchmark/FivePointStencil: `sin(2 PI vf_nodePosition_x)`
            in a y-ghost rule).  Along-plane coordinates come from the
            level grid; the ghost-axis coordinate extrapolates one
            uniform width beyond the edge."""
            loc = self.fields[name].localization
            ax = "xyz".index(vf_name[-1])
            grid = self.grids[lvl]
            coords = grid.coord_mesh(loc)
            c = coords[ax]
            if ax == d:
                w = grid.width_b(d)
                edge_sl = tuple(
                    slice(true[i] - 1, true[i]) if i == d and side > 0
                    else slice(0, 1) if i == d
                    else slice(None)
                    for i in range(nd)
                )
                c = c[tuple(
                    edge_sl[i] if i == d else slice(None) for i in range(nd)
                )] + side * w
            return torch.broadcast_to(c, plane_shape_full())

        def plane_shape_full():
            return tuple(1 if i == d else true[i] for i in range(nd))

        _GHOST_FNS = {n: _MATH_FNS[n] for n in (
            "sin", "cos", "tan", "sinh", "cosh", "exp", "sqrt", "log", "fabs", "abs")}
        _GHOST_FNS["tanh"] = lambda v: torch.tanh(v) if isinstance(v, torch.Tensor) \
            else math.tanh(v)

        def ev(e):
            if isinstance(e, N.Num):
                return float(e.value)
            if isinstance(e, N.UnOp) and e.op == "-":
                return -ev(e.operand)
            if isinstance(e, N.BinOp):
                return _apply_binop(e.op, ev(e.lhs), ev(e.rhs))
            if isinstance(e, N.Call) and e.name in _GHOST_FNS:
                return _GHOST_FNS[e.name](ev(e.args[0]))
            if isinstance(e, N.Access):
                if e.name == name:
                    off = e.offset or (0,) * nd
                    if any(o != 0 for i, o in enumerate(off) if i != d):
                        raise NotImplementedError(
                            "ghost rule with off-axis self offset")
                    return plane_of(off[d])
                if e.name in fr.vars:
                    return fr.vars[e.name]
                if e.name in self.globals:
                    return self.globals[e.name]
                if e.name == "PI":
                    return math.pi
                if e.name.startswith("vf_") and e.name[-2:] in (
                        "_x", "_y", "_z"):
                    return plane_coord(e.name)
            raise NotImplementedError(
                f"unsupported ghost-rule expression {e}")

        plane_shape = tuple(1 if i == d else true[i] for i in range(nd))
        val = torch.broadcast_to(
            torch.as_tensor(ev(a.value), dtype=self._field_dtype(self.fields[name]),
                            device=self.device),
            plane_shape,
        )
        self.state[(self._ghost_key(name, d, side), lvl)] = val
        self._ghost_rules.setdefault((name, lvl), set()).add((d, side))

    def _apply_ghost_rules(self, name: str, level: int, xp, arr, r: int):
        """Write the materialized ghost planes into the zero pad ring."""
        dirs = self._ghost_rules.get((name, level))
        if not dirs:
            return xp
        true = self.true_shape(name, level)
        nd = len(true)
        for (d, side) in sorted(dirs):
            key = (self._ghost_key(name, d, side), level)
            if key not in self.state:
                continue
            plane = (r + true[d]) if side > 0 else (r - 1)
            out_sl = tuple(
                slice(None) if i != d else slice(plane, plane + 1)
                for i in range(nd)
            )
            pad_sl = tuple(
                slice(r, r + true[i]) if i != d else slice(None)
                for i in range(nd)
            )
            xp = xp.clone()
            xp[out_sl][pad_sl] = self.state[key].to(xp.dtype)
        return xp

    def _exec_seq_loop(self, s: N.LoopOverField, fr: Frame, lvl: int, info, shape):
        """`loop over f sequentially { f (+)= expr }`: lexicographic
        in-place update (the reference's coloring="None" Gauss-Seidel
        smoother, a plain C++ loop nest).  Executed as a wavefront over
        anti-diagonals (the reference's fori_loop, here a Python loop),
        which reproduces lexicographic dependencies exactly for
        axis-aligned stencils (each point update reads already-updated
        lex-smaller neighbors and old lex-larger ones)."""
        st = s.body[0]
        tname = s.field.name
        nd = len(shape)
        refs = self._referenced_names(st.value)
        if s.condition is not None:
            refs |= self._referenced_names(s.condition)
        for nm in refs:
            if nm in self.fields and (nm, lvl) in self.state:
                self.get_field(nm, lvl)  # rematerialize stale operands first
        fsizes = self._seq_fragment_sizes(lvl, nd)
        if self._field_window(tname, lvl) is not None:
            if not self._seq_on_ranks(tname, lvl, fsizes):
                # a rank border inside a reference fragment: the sweep is
                # serial across it, so run it on the fields gathered whole
                names = sorted(nm for nm in refs | {tname}
                               if nm in self.fields and (nm, lvl) in self.state)
                self.frag.stats.seq_gathered += 1
                with self._gathered_level(lvl, names, keep=tname):
                    self._exec_seq_loop(s, fr, lvl, info, self.true_shape(tname, lvl))
                return
            # cross-fragment reads see the sweep-start values, ghosts too
            self._offset_read(tname, lvl, None, 1)
        # fragment-local node partition: fragment f_d cells per dim; node g
        # is updated by fragment g//f_d at local coordinate g mod f_d
        # (dup-left owned, dup-right excluded).  Cross-fragment stencil
        # reads see the sweep-start state (per-fragment ghost copies,
        # filled by the `communicate` preceding the loop).
        u0 = u = self.get_field(tname, lvl)
        diag_idx = None
        for d in range(nd):
            li = self._gidx(shape, d, lvl, info.localization) % fsizes[d]
            diag_idx = li if diag_idx is None else diag_idx + li
        lctx = _LoopCtx(lvl, info.localization, shape)
        cond_mask = (self.eval_expr(s.condition, fr, lctx)
                     if s.condition is not None else None)
        # exclude Dirichlet-plane DOFs: sequential in-place updates would
        # otherwise corrupt boundary values that later (lex-larger) points
        # consume mid-sweep
        cond_mask = _and(cond_mask, self._valid_dof_mask(tname, lvl, None, shape))
        n_diag = sum(f - 1 for f in fsizes) + 1
        try:
            for d in range(n_diag):
                self.state[(tname, lvl)] = u
                self._frozen_ctx = (tname, lvl, u0, tuple(fsizes))
                try:
                    upd = self.eval_expr(st.value, fr, _LoopCtx(lvl, info.localization, shape))
                finally:
                    self._frozen_ctx = None
                new = _apply_assign(st.op, u, upd)
                u = torch.where(_and(diag_idx == d, cond_mask), new, u)
        finally:
            self.state[(tname, lvl)] = u0
        self.set_field(tname, lvl, u)

    def _seq_fragment_sizes(self, lvl: int, nd: int):
        """Cells of one reference fragment per dim (the whole dim where
        they do not divide evenly)."""
        fsizes = []
        for d in range(nd):
            cells = self.k.cells_per_dim(lvl, d)
            F = self.k.frags_total(d)
            fsizes.append(cells // F if F > 1 and cells % F == 0 and cells // F >= 1
                          else cells)
        return fsizes

    def _apply_stencil_frozen(self, st, name: str, lvl: int, arr, u0, fsizes):
        """Stencil conv for the in-place sweep: same-fragment reads see
        the current carry, cross-fragment reads the sweep-start state u0
        (the reference's per-fragment ghost-copy semantics)."""
        r = st.radius
        xp_u = self._padded_operand(name, lvl, arr, r)
        xp_u0 = self._padded_operand(name, lvl, u0, r)
        nd = arr.ndim
        loc = self.fields[name].localization
        iotas = [self._gidx(arr.shape, d, lvl, loc) for d in range(nd)]
        out = None
        for off, c in st.items():
            sl = tuple(slice(r + o, r + o + n) for o, n in zip(off, arr.shape))
            a = xp_u[sl]
            cross = None
            for d, o in enumerate(off):
                if o and fsizes[d] > 0:
                    li = iotas[d] % fsizes[d]
                    cm = torch.logical_or(li + o < 0, li + o > fsizes[d] - 1)
                    cross = cm if cross is None else torch.logical_or(cross, cm)
            if cross is not None:
                a = torch.where(cross, xp_u0[sl], a)
            term = c * a
            out = term if out is None else out + term
        return out

    def _self_stencil_dep(self, st: N.Assign, lvl: int) -> bool:
        """True if the assignment's value applies a stencil to the target
        field's own (same-slot, same-level) data -- the pattern whose C++
        in-place loop has Gauss-Seidel (lexicographic) semantics."""
        tname = st.target.name
        info = self.fields.get(tname)
        if info is None:
            return False
        t_slot = self._slot_idx(tname, lvl, st.target.slot) if info.num_slots > 1 else 0

        def same_level(a: N.Access) -> bool:
            return a.level is None or (
                isinstance(a.level, N.LvlRelative) and a.level.delta == 0
            )

        def has_cross_level(e) -> bool:
            if isinstance(e, N.Access):
                return e.name in self.fields and not same_level(e)
            if isinstance(e, N.BinOp):
                return has_cross_level(e.lhs) or has_cross_level(e.rhs)
            if isinstance(e, N.UnOp):
                return has_cross_level(e.operand)
            if isinstance(e, N.Call):
                return any(has_cross_level(a) for a in e.args)
            return False

        def walk(e) -> bool:
            if isinstance(e, N.BinOp):
                if (
                    e.op == "*"
                    and isinstance(e.lhs, N.Access) and e.lhs.name in self.stencils
                    and isinstance(e.rhs, N.Access) and e.rhs.name == tname
                    and same_level(e.rhs)
                ):
                    r_slot = (self._slot_idx(tname, lvl, e.rhs.slot)
                              if info.num_slots > 1 else 0)
                    if r_slot == t_slot:
                        return True
                return walk(e.lhs) or walk(e.rhs)
            if isinstance(e, N.UnOp):
                return walk(e.operand)
            if isinstance(e, N.Call):
                return any(walk(a) for a in e.args)
            return False

        # cross-level reads would be baked as stale constants in the
        # cached sweep -- keep those on the parallel path
        return walk(st.value) and not has_cross_level(st.value)

    def _referenced_names(self, e) -> set:
        out = set()
        if isinstance(e, N.Access):
            out.add(e.name)
        elif isinstance(e, N.BinOp):
            out |= self._referenced_names(e.lhs) | self._referenced_names(e.rhs)
        elif isinstance(e, N.UnOp):
            out |= self._referenced_names(e.operand)
        elif isinstance(e, N.Call):
            for a in e.args:
                out |= self._referenced_names(a)
        return out

    def _node_interior_mask(self, loc, shape, level, dup_layers=None):
        """False on physical-boundary planes along node-localized dims
        (None when nothing is excluded, e.g. pure cell fields).  Only
        dims with duplicate layers exclude their boundary planes: the
        reference's IterationOffsets come from the dup-layer bounds, so
        a `duplicateLayers = [0, 0]` layout iterates every point
        (IR_LoopOverPointsInOneFragment.scala:73-101).  `shape` is the
        loop's shape; bounds are those of the global grid of `level`."""
        nd = len(shape)
        true_shape = self._gshape(level, loc)
        if loc == NODE:
            dims = list(range(nd))
        elif loc in FACES:
            dims = [FACES.index(loc)]
        else:
            return None
        if dup_layers is not None:
            dims = [d for d in dims if d < len(dup_layers) and dup_layers[d] > 0]
        if not dims:
            return None
        m = None
        for d in dims:
            i = self._gidx(shape, d, level, loc)
            mm = torch.logical_and(i > 0, i < true_shape[d] - 1)
            m = mm if m is None else torch.logical_and(m, mm)
        return m

    def _region_mask(self, s: N.LoopOverField, shape, level, loc):
        region, rdir = s.region
        nd = len(shape)
        true_shape = self._gshape(level, loc)
        if region == "inner":
            m = torch.ones(shape, dtype=torch.bool, device=self.device)
            for d in range(nd):
                i = self._gidx(shape, d, level, loc)
                m = torch.logical_and(m, torch.logical_and(i > 0, i < true_shape[d] - 1))
            return m
        # dup/ghost boundary regions: the outermost plane in direction rdir
        m = torch.ones(shape, dtype=torch.bool, device=self.device)
        if rdir is not None:
            for d, dirval in enumerate(rdir[:nd]):
                i = self._gidx(shape, d, level, loc)
                if dirval < 0:
                    m = torch.logical_and(m, i == 0)
                elif dirval > 0:
                    m = torch.logical_and(m, i == true_shape[d] - 1)
        else:
            border = torch.zeros(shape, dtype=torch.bool, device=self.device)
            for d in range(nd):
                i = self._gidx(shape, d, level, loc)
                border = torch.logical_or(
                    border, torch.logical_or(i == 0, i == true_shape[d] - 1)
                )
            m = border
        return m

    def _exec_color(self, s: N.ColorWith, fr: Frame):
        """`color with { expr % n, [expr % m, ...] stmts }`: run stmts
        once per color; multiple color expressions iterate their cross
        product (reference L4_ColorLoops color lists, e.g. the Stokes
        Vanka smoother's `i0 % 3, i1 % 3` 9-coloring) with the first
        expression as the outer loop."""
        # the reference iterates the cross product with the FIRST color
        # expression varying fastest ("normally, the first coloring
        # expression given is the innermost", L4_ColorLoops.toRepeatLoops
        # builds the DNF from the reversed expression list) — so build
        # conditions last-expression-outermost
        exprs = [s.colors] + list(s.more_colors)
        conds = [None]
        for ce in reversed(exprs):
            if not (isinstance(ce, N.BinOp) and ce.op == "%"):
                raise ValueError("color expression must be `expr % n`")
            n = int(self._eval_const(ce.rhs))
            new = []
            for prev in conds:
                for c in range(n):
                    eq = N.BinOp("==", N.BinOp("%", ce.lhs, N.Num(n, True)),
                                 N.Num(c, True))
                    new.append(eq if prev is None else N.BinOp("&&", prev, eq))
            conds = new
        for cond in conds:
            self._exec_masked_block(cond, s.body, fr)

    def _exec_masked_block(self, cond_expr: N.Expr, body: List[N.Stmt], fr: Frame):
        """Run statements with `cond_expr` (over loop index grids) masking
        each contained field loop (color with / repeat with)."""
        for stmt in body:
            if isinstance(stmt, N.LoopOverField):
                lvl = self._resolve_level(stmt.field.level, fr)
                info = self.fields[stmt.field.name]
                shape = self.true_shape(stmt.field.name, lvl)
                lctx = _LoopCtx(lvl, info.localization, shape)
                mask = self.eval_expr(cond_expr, fr, lctx)
                mask = torch.broadcast_to(mask, shape)
                self._exec_loop(stmt, fr, color_ctx=mask)
            else:
                self.exec_stmt(stmt, fr)


