"""Hand-written CUDA kernels for Hopper: the contract and selection layer.

Reference: exastencils_tpu/ops/pallas/__init__.py (dense makers).  Each
maker returns the kernels of a dense 3D level when the configuration is
inside their contract, else None and the cycle runs the plain ops; the
conditions are the TPU makers', so one Knowledge selects the same kernel
mode in both packages:

- `make_fused_smoother_3d`: K3 (a node field, two colours, no colour
  function, Dirichlet bc, constant radius-1 star stencil, >= 5 z-planes);
- `make_fused_transfers_3d`: K4/K5 (a node field, Dirichlet bc, star
  stencil, separable transfers of the default node or cell z-geometry);
- `make_fused_legs_3d`: K1/K2 (as K3 and K4/K5, and n_pre, n_post >= 1);
  for the variable-coefficient star of models/poisson (`face_arrays`:
  three face arrays, float32 or float64) the port's own K11/K12 under the
  same conditions and under either EXA_STREAM_V1 schedule, which the JAX
  package has no counterpart of;
- `make_fused_res_norm_3d`: K13, the residual norm of `Multigrid.res_norm`
  in one pass (a node residual field whose Dirichlet value is 0, the
  kernels' shape, a constant radius-1 star or the face arrays of a
  variable-coefficient one, float32 or float64), the port's own: the JAX
  package leaves the norm to XLA.

and for a sharded 3D level (the JAX package's :57-230), on one rank's
halo-extended fragment after one wide halo exchange:

- `make_sharded_fused_smoother_3d`: K3 (the dense smoother's contract on
  the fragment's shape, two colours, ghost >= 2 on a sharded mesh), one
  exchange per g//2 iterations, the physical boundary's dup planes
  excluded by the rank's excl planes;
- `make_sharded_fused_legs_3d`: K1/K2 (the dense legs' contract, and the
  staleness budget g >= 2 n_pre + 2 and g >= 2 n_post + 1 on a sharded
  mesh), the coarse geometry shifted by the ghost width
  (stream3d.coarse_geometry).

The smoother and the legs call the schedule dispatchers of stream3d.py,
so with EXA_STREAM_V1=1 they run the single-plane wavefronts K6 (for K3)
and K7/K8 (for K1/K2) instead, as the JAX package's dispatchers do.

Every maker declines a field that is not node-localized, where the TPU
makers do not look (exastencils_tpu/ops/pallas/__init__.py:35,
solver/synthesis.py:368-440): the kernels hold a node field's Dirichlet
ring fixed, and a cell or face field's hierarchy diverges under them
(ROADMAP, "Faults in the reference, not copied").  The JAX DSL fast path
already checks the localization (exastencils_tpu/dsl/fastpath.py:384).

The TPU VMEM budget (`_max_k`) has no meaning here and is not ported.  The
CUDA transfers take at most MAX_TAPS taps per dim in y and x as well as
in z, where the TPU kernels applied y/x as dense matrices of any width:
a separable transfer wider than 3 taps in y or x only runs the plain ops
here.
"""

from __future__ import annotations

from exastencils_tpu_torch.core.field import DirichletBC, Field
from exastencils_tpu_torch.core.grid import NODE
from exastencils_tpu_torch.ops.cuda.check3d import res_norm
from exastencils_tpu_torch.ops.cuda.stream3d import (
    FACE_DTYPES,
    MAX_TAPS,
    cuda_applicable_3d,
    face_arrays,
    prolong_correct,
    prolong_correct_smooth,
    prolong_correct_smooth_faces,
    prolong_correct_smooth_fused_3d,
    rbgs_fused_3d,
    res_restrict,
    restrict_reach,
    smooth_res_restrict,
    smooth_res_restrict_faces,
    smooth_res_restrict_fused_3d,
)
from exastencils_tpu_torch.ops.transfer import separable_kernels


def _z_geometry_ok(lo_r: int, n_r: int, lo_p: int, n_p: int) -> bool:
    """The default node (lo=-1, 3-tap) and cell (lo=0, 2-tap) restriction
    z-geometries and prolongation windows of <= 3 taps: the contract of
    the TPU kernels, kept so that one Knowledge selects the same kernel
    mode in both packages."""
    if (lo_r, n_r) not in ((-1, 3), (0, 2)):
        return False
    return n_p <= 3


def _transfer_taps(restrict_op, prolong_op):
    """(r_kern, p_kern) for the kernels, or None where the transfers are
    not separable, leave the default z-geometries or exceed MAX_TAPS."""
    try:
        r_kern = separable_kernels(restrict_op)
        p_kern = separable_kernels(prolong_op)
    except ValueError:
        return None
    if not _z_geometry_ok(int(restrict_op.lo[0]), len(r_kern[0]),
                          int(prolong_op.lo[0]), len(p_kern[0])):
        return None
    if max(len(k) for k in r_kern + p_kern) > MAX_TAPS:
        return None
    return r_kern, p_kern


def _node_dirichlet(field: Field, level: int) -> bool:
    """The field condition every kernel assumes: node DOFs with a
    Dirichlet ring."""
    return field.localization == NODE and isinstance(field.bc_at(level), DirichletBC)


def make_fused_smoother_3d(A, field: Field, level: int, shape, omega: float,
                           num_colors: int, color_fn=None):
    """K3 (K6 under EXA_STREAM_V1=1) for the dense 3D path:
    smooth_n(n, sol, rhs) -> sol, n RBGS iterations (K3 in place on sol,
    K6 into a new tensor), or None outside the contract."""
    if num_colors != 2 or color_fn is not None:
        return None
    if not _node_dirichlet(field, level):
        return None
    if not cuda_applicable_3d(tuple(shape), A.offsets, A.coefs):
        return None

    def smooth_n(n, sol, rhs):
        return rbgs_fused_3d(sol, rhs, A, omega, n)

    return smooth_n


def make_fused_transfers_3d(A, field: Field, level: int, fine_shape, coarse_shape,
                            restrict_op, prolong_op):
    """K4/K5 for the dense 3D path: (res_restrict(sol, rhs) -> rhs_c,
    prolong_correct(sol, sol_c) -> sol, in place), or (None, None)
    outside the contract."""
    if not _node_dirichlet(field, level):
        return None, None
    if not cuda_applicable_3d(tuple(fine_shape), A.offsets, A.coefs):
        return None, None
    taps = _transfer_taps(restrict_op, prolong_op)
    if taps is None:
        return None, None
    r_kern, p_kern = taps
    coarse_shape = tuple(coarse_shape)
    r_lo, p_lo = tuple(restrict_op.lo), tuple(prolong_op.lo)

    def down(sol, rhs):
        return res_restrict(sol, rhs, A, r_kern, r_lo, coarse_shape)

    def up(sol, sol_c):
        return prolong_correct(sol, sol_c, p_kern, p_lo)

    return down, up


def make_fused_legs_3d(
    A, field: Field, level: int, fine_shape, coarse_shape,
    restrict_op, prolong_op, omega: float, n_pre: int, n_post: int,
    num_colors: int,
):
    """Whole-leg kernels for the dense 3D path, K1/K2 (K7/K8 under
    EXA_STREAM_V1=1), or for a variable-coefficient star (`face_arrays`)
    K11/K12.  Returns (down(sol, rhs) -> (sol, rhs_c),
    up(sol, sol_c, rhs) -> sol), K1/K2 and K11/K12 updating `sol` in place
    and K7/K8 writing a new tensor, or (None, None) outside the contract."""
    if num_colors != 2:
        return None, None
    if not _node_dirichlet(field, level):
        return None, None
    if n_pre < 1 or n_post < 1:
        return None, None
    faces = None
    if not cuda_applicable_3d(tuple(fine_shape), A.offsets, A.coefs):
        faces = face_arrays(fine_shape, A)
        if faces is None:
            return None, None
    taps = _transfer_taps(restrict_op, prolong_op)
    if taps is None:
        return None, None
    r_kern, p_kern = taps
    coarse_shape = tuple(coarse_shape)
    r_lo, p_lo = tuple(restrict_op.lo), tuple(prolong_op.lo)
    if faces is not None:
        if restrict_reach(r_kern, r_lo) > 1:
            return None, None

        def down_faces(sol, rhs):
            return smooth_res_restrict_faces(sol, rhs, A, faces, omega, n_pre, r_kern, r_lo,
                                             coarse_shape)

        def up_faces(sol, sol_c, rhs):
            return prolong_correct_smooth_faces(sol, sol_c, rhs, A, faces, omega, n_post, p_kern,
                                                p_lo)

        return down_faces, up_faces

    def down(sol, rhs):
        return smooth_res_restrict_fused_3d(sol, rhs, A, omega, n_pre, r_kern, r_lo,
                                            coarse_shape)

    def up(sol, sol_c, rhs):
        return prolong_correct_smooth_fused_3d(sol, sol_c, rhs, A, omega, n_post,
                                               p_kern, p_lo)

    return down, up


def make_fused_res_norm_3d(A, residual_field: Field, level: int, shape, dtype):
    """K13 for the dense 3D path: norm(sol, rhs) -> the l2 norm of the
    residual rhs - A sol with its ring zeroed, as `Multigrid.res_norm`'s
    plain ops compute it, or None outside the contract: the residual
    field node-localised with a Dirichlet value of exactly 0, the kernels'
    shape and a constant radius-1 star (`cuda_applicable_3d`) or the face
    arrays that a variable-coefficient star carries (`face_arrays`), and
    float32 or float64 fields.  Which operator the kernel loads follows
    from the stencil, as in `make_fused_legs_3d`."""
    if not _node_dirichlet(residual_field, level):
        return None
    value = residual_field.bc_at(level).value
    if isinstance(value, bool) or not isinstance(value, (int, float)) or value != 0:
        return None
    if dtype not in FACE_DTYPES:
        return None
    faces = None
    if not cuda_applicable_3d(tuple(shape), A.offsets, A.coefs):
        faces = face_arrays(shape, A)
        if faces is None or faces[0].dtype != dtype:
            return None

    def norm(sol, rhs):
        return res_norm(sol, rhs, A, faces)

    return norm


def _excl_planes(topo, local_cells):
    """The rank's excl planes (z lo, z hi, y lo, y hi, x lo, x hi): the dup
    plane g of a low physical boundary, g + cells[d] of a high one, else
    -1 (reference :209-215).  Host ints: the mesh coordinates are."""
    gs, ex = topo.ghosts, []
    for d in range(3):
        ex.append(gs[d] if topo.is_lo_boundary(d) else -1)
        ex.append(gs[d] + local_cells[d] if topo.is_hi_boundary(d) else -1)
    return tuple(ex)


def make_sharded_fused_smoother_3d(A, field: Field, level: int, topo, local_cells,
                                   omega: float, num_colors: int):
    """K3 (K6 under EXA_STREAM_V1=1) on a SHARDED 3D level: ONE wide-halo
    exchange per g//2 iterations (the reference's halo aggregation), then
    the fused smoother over the halo-extended fragment, the physical
    boundary's dup planes excluded by the rank's excl planes, so
    Dirichlet values stay as the dense path's never-written array edge.

    The never-updated local edge ring goes stale one layer per
    half-sweep, so g ghost layers admit g//2 iterations per exchange
    before the staleness reaches the dup planes.  The rhs is exchanged
    once per call.  Returns smooth_n(n, sol, rhs) or None outside the
    contract."""
    if num_colors != 2:
        return None
    if not _node_dirichlet(field, level):
        return None
    cells = tuple(local_cells)
    if not cuda_applicable_3d(tuple(topo.local_shape(cells)), A.offsets, A.coefs):
        return None
    sharded = any(p > 1 for p in topo.P)
    if sharded and topo.ghost < 2:
        return None
    # with no sharded dim there is no staleness at all
    per_block = (topo.ghost // 2) if sharded else None
    excl = _excl_planes(topo, cells)

    def smooth_n(n, sol, rhs):
        rhsx = topo.exchange(rhs, cells)
        done = 0
        while done < n:
            k = (n - done) if per_block is None else min(per_block, n - done)
            sol = rbgs_fused_3d(topo.exchange(sol, cells), rhsx, A, omega, k, excl)
            done += k
        return sol

    return smooth_n


def make_sharded_fused_legs_3d(A, field: Field, level: int, topo, local_cells,
                               coarse_local_cells, restrict_op, prolong_op, omega: float,
                               n_pre: int, n_post: int, num_colors: int):
    """K1/K2 on a SHARDED 3D level: the down leg (n_pre RBGS iterations +
    residual + restriction) and the up leg (prolongation + correction +
    n_post iterations) each as one pass over the halo-extended fragment,
    after one wide halo exchange of its operands.

    Geometry (reference :187-228): coarse fragment node c takes the fine
    nodes 2c + lo - g + k, and the y/x coarse ghost rows stay zero (the
    reference's ghosted restriction matrices write rows g .. g + nc only;
    in z it writes every coarse plane); the up leg corrects the whole
    fragment with the full-ghosted prolongation, so halo corrections equal
    the neighbour's interior ones and the post-smoothing in the same pass
    stays valid.

    Staleness (as the smoother's): the down leg needs g >= 2 n_pre + 2
    (K iterations + residual radius + restriction tap), the up leg g >=
    2 n_post + 1, so all owned and dup values stay bitwise those of the
    exchange-every-colour path.  Returns (down(sol, rhs) -> (sol, rhs_c),
    up(sol, sol_c, rhs) -> sol), each exchanging its sol and rhs, or
    (None, None) outside the contract.  The TPU VMEM budget (`_max_k`)
    is not ported, as for the dense legs."""
    if num_colors != 2:
        return None, None
    if not _node_dirichlet(field, level):
        return None, None
    gs = topo.ghosts
    sharded = any(p > 1 for p in topo.P)
    if sharded and topo.ghost < max(2 * n_pre + 2, 2 * n_post + 1):
        return None, None
    cells, ccells = tuple(local_cells), tuple(coarse_local_cells)
    local_shape = tuple(topo.local_shape(cells))
    coarse_shape = tuple(topo.local_shape(ccells))
    if not cuda_applicable_3d(local_shape, A.offsets, A.coefs):
        return None, None
    if not (1 <= n_pre and 1 <= n_post):
        return None, None
    taps = _transfer_taps(restrict_op, prolong_op)
    if taps is None:
        return None, None
    r_kern, p_kern = taps
    off_p = (1 - (int(prolong_op.lo[0]) - gs[0])) // 2
    if coarse_shape[0] < off_p + 2:
        return None, None  # coarse fragment too shallow (the reference's ring)
    r_lo, p_lo = tuple(restrict_op.lo), tuple(prolong_op.lo)
    excl = _excl_planes(topo, cells)

    def down(sol, rhs):
        rhsx, solx = topo.exchange(rhs, cells), topo.exchange(sol, cells)
        return smooth_res_restrict(solx, rhsx, A, omega, n_pre, r_kern, r_lo, coarse_shape,
                                   excl, ghost=gs)

    def up(sol, sol_c, rhs):
        rhsx, solx = topo.exchange(rhs, cells), topo.exchange(sol, cells)
        return prolong_correct_smooth(solx, sol_c, rhsx, A, omega, n_post, p_kern, p_lo, excl,
                                      ghost=gs)

    return down, up
