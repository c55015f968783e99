"""Hand-written CUDA kernels for Hopper: the contract and selection layer.

Reference: exastencils_tpu/ops/pallas/__init__.py (dense makers).  Each
maker returns the kernels of a dense 3D level when the configuration is
inside their contract, else None and the cycle runs the plain ops; the
conditions are the TPU makers', so one Knowledge selects the same kernel
mode in both packages:

- `make_fused_smoother_3d`: K3 (two colours, no colour function,
  Dirichlet bc, constant radius-1 star stencil, >= 5 z-planes);
- `make_fused_transfers_3d`: K4/K5 (Dirichlet bc, star stencil, separable
  transfers of the default node or cell z-geometry);
- `make_fused_legs_3d`: K1/K2 (as K3 and K4/K5, and n_pre, n_post >= 1).

The smoother and the legs call the schedule dispatchers of stream3d.py,
so with EXA_STREAM_V1=1 they run the single-plane wavefronts K6 (for K3)
and K7/K8 (for K1/K2) instead, as the JAX package's dispatchers do.

The TPU VMEM budget (`_max_k`) has no meaning here and is not ported.  The
CUDA transfers take at most MAX_TAPS taps per dim in y and x as well as
in z, where the TPU kernels applied y/x as dense matrices of any width:
a separable transfer wider than 3 taps in y or x only runs the plain ops
here.
"""

from __future__ import annotations

from exastencils_tpu_torch.core.field import DirichletBC, Field
from exastencils_tpu_torch.ops.cuda.stream3d import (  # noqa: F401
    MAX_TAPS,
    _star_coefs,
    cuda_applicable_3d,
    prolong_correct,
    prolong_correct_smooth_fused_3d,
    rbgs_fused_3d,
    res_restrict,
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


def make_fused_smoother_3d(A, field: Field, level: int, shape, omega: float,
                           num_colors: int, color_fn=None):
    """K3 (K6 under EXA_STREAM_V1=1) for the dense 3D path:
    smooth_n(n, sol, rhs) -> sol, n RBGS iterations (K3 in place on sol,
    K6 into a new tensor), or None outside the contract."""
    if num_colors != 2 or color_fn is not None:
        return None
    if not isinstance(field.bc_at(level), DirichletBC):
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
    if not isinstance(field.bc_at(level), DirichletBC):
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
    EXA_STREAM_V1=1).  Returns (down(sol, rhs) -> (sol, rhs_c),
    up(sol, sol_c, rhs) -> sol), K1/K2 updating `sol` in place and K7/K8
    writing a new tensor, or (None, None) outside the contract."""
    if num_colors != 2:
        return None, None
    if not isinstance(field.bc_at(level), DirichletBC):
        return None, None
    if not cuda_applicable_3d(tuple(fine_shape), A.offsets, A.coefs):
        return None, None
    if n_pre < 1 or n_post < 1:
        return None, None
    taps = _transfer_taps(restrict_op, prolong_op)
    if taps is None:
        return None, None
    r_kern, p_kern = taps
    coarse_shape = tuple(coarse_shape)
    r_lo, p_lo = tuple(restrict_op.lo), tuple(prolong_op.lo)

    def down(sol, rhs):
        return smooth_res_restrict_fused_3d(sol, rhs, A, omega, n_pre, r_kern, r_lo,
                                            coarse_shape)

    def up(sol, sol_c, rhs):
        return prolong_correct_smooth_fused_3d(sol, sol_c, rhs, A, omega, n_post,
                                               p_kern, p_lo)

    return down, up
