"""The single-plane wavefront kernels K6-K8 of the PyTorch port against the
JAX package's v1 Pallas kernels (EXA_STREAM_V1=1), the schedule switch,
and the v1 solves.

On the CPU the port's wrappers run their plain PyTorch versions (chunked
as the CUDA path chunks); the JAX v1 kernels run in Pallas interpret mode,
reached through the JAX dispatchers with EXA_STREAM_V1=1.  Float64, held
to max|port - jax| <= 1e-12 * max|jax|.  The CUDA kernels themselves are
held against the plain versions by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cycles import build_both, solve_both
from test_torch_fused import close, fields, star3d

from exastencils_tpu.core.stencil import cell_prolongation as j_cell_prolongation
from exastencils_tpu.core.stencil import cell_restriction as j_cell_restriction
from exastencils_tpu.core.stencil import node_prolongation as j_node_prolongation
from exastencils_tpu.core.stencil import node_restriction as j_node_restriction
from exastencils_tpu.ops.pallas.stream3d import (
    prolong_correct_smooth_fused_3d,
    rbgs_fused_3d,
    smooth_res_restrict_fused_3d,
)
from exastencils_tpu.ops.transfer import build_prolong_mats, build_restrict_mats, separable_kernels

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.interop import stencil_from_jax
from exastencils_tpu_torch.models.poisson import PoissonMGSolver
from exastencils_tpu_torch.ops.cuda import stream3d as s3

torch.set_num_threads(1)
OMEGA = 0.8
F64_DEPTH = 2  # max_wavefront_k(torch.float64): K6's iterations per launch


@pytest.fixture
def v1(monkeypatch):
    monkeypatch.setenv("EXA_STREAM_V1", "1")


def test_wavefront_depths():
    """K6 (cluster_legs3d.cu's LEG_SMOOTH) on its default cluster holds 3
    iterations a launch in float32 and 2 in float64, 3 on 2 x 2 clusters:
    its rings of 2K+2+CLUSTER_AHEAD planes of sol and rhs within one
    block's shared memory, one more iteration not (or MAX_CLUSTER_K).
    K7/K8 hold 3 in float32, so each leg of a V(3,3) cycle is one launch;
    in float64 K8 2 and K7 1 (with the node and the cell restriction),
    each within the shared memory of one block, one more iteration not."""
    assert (s3.max_wavefront_k(torch.float32), s3.max_wavefront_k(torch.float64)) == (3, F64_DEPTH)
    assert s3.max_wavefront_k(torch.float64, (2, 2)) == 3
    for dtype, itemsize in ((torch.float32, 4), (torch.float64, 8)):
        for cluster in s3.CLUSTER_SHAPES:
            k6 = s3.max_wavefront_k(dtype, cluster)
            rows, rx = s3._cluster_window(s3.LEG_SMOOTH, k6, 0, cluster)
            assert s3._cluster_smem(s3.LEG_SMOOTH, k6, 0, itemsize, cluster) == \
                2 * (2 * k6 + 2 + s3.CLUSTER_AHEAD) * rows * rx * itemsize <= s3.SMEM_LIMIT
            assert (k6 == s3.MAX_CLUSTER_K or s3._cluster_smem(s3.LEG_SMOOTH, k6 + 1, 0, itemsize,
                                                               cluster) > s3.SMEM_LIMIT)
        for mode, reach, want in ((s3.LEG_PROLONG, 0, (3, 2)), (s3.LEG_RESTRICT, 1, (3, 1)),
                                  (s3.LEG_RESTRICT, 0, (3, 1))):
            k = s3.max_cluster_k(dtype, mode, reach)
            assert k == want[itemsize // 8]
            cluster = s3.CLUSTER[mode]
            assert s3._cluster_smem(mode, k, reach, itemsize, cluster) <= s3.SMEM_LIMIT
            assert (k == s3.MAX_CLUSTER_K
                    or s3._cluster_smem(mode, k + 1, reach, itemsize, cluster) > s3.SMEM_LIMIT)


def _count_calls(monkeypatch, name):
    calls = []
    fn = getattr(s3, name)

    def spy(*args, **kw):
        calls.append(args[4])  # the iteration count K
        return fn(*args, **kw)

    monkeypatch.setattr(s3, name, spy)
    return calls


# ----------------------------------------------------------------------
# K6: the smoother wavefront
# ----------------------------------------------------------------------


@pytest.mark.parametrize("level", [3, 4])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_rbgs_wavefront_matches_pallas_v1(v1, level, K):
    n = 2 ** level + 1
    sol, rhs = fields(level * 10 + K, (n,) * 3, (n,) * 3)
    A = star3d()
    want = rbgs_fused_3d(jnp.asarray(sol), jnp.asarray(rhs), A.offsets, A.coefs, OMEGA, K,
                         interpret=True)
    sol_t = torch.from_numpy(sol.copy())
    got = s3.rbgs_wavefront(sol_t, torch.from_numpy(rhs), stencil_from_jax(A), OMEGA, K)
    assert got is not sol_t
    np.testing.assert_array_equal(sol_t.numpy(), sol)  # not in place
    close(got, want)


@pytest.mark.parametrize("excl", [(4, -1, 2, -1, -1, 6), (1, 7, -1, 10, 3, -1)])
def test_rbgs_wavefront_excl_matches_pallas_v1(v1, excl):
    shape = (9, 12, 11)
    sol, rhs = fields(3, shape, shape)
    A = star3d()
    want = rbgs_fused_3d(jnp.asarray(sol), jnp.asarray(rhs), A.offsets, A.coefs, OMEGA, 2,
                         interpret=True, excl=jnp.asarray(excl, jnp.int32))
    got = s3.rbgs_wavefront(torch.from_numpy(sol), torch.from_numpy(rhs), stencil_from_jax(A),
                            OMEGA, 2, excl)
    close(got, want)
    for d, p in enumerate(excl):
        if p >= 0:
            plane = tuple(p if i == d // 2 else slice(None) for i in range(3))
            np.testing.assert_array_equal(got[plane].numpy(), sol[plane])


def test_rbgs_wavefront_chunks_deep_k(v1, monkeypatch):
    """K = 7 in float64 runs as chunks of 2, 2, 2 and 1; K = 0 is sol."""
    shape = (9, 9, 9)
    sol, rhs = fields(8, shape, shape)
    A = star3d()
    want = rbgs_fused_3d(jnp.asarray(sol), jnp.asarray(rhs), A.offsets, A.coefs, OMEGA, 7,
                         interpret=True)
    chunks = _count_calls(monkeypatch, "rbgs_wavefront_plain")
    sol_t, rhs_t, At = torch.from_numpy(sol), torch.from_numpy(rhs), stencil_from_jax(A)
    close(s3.rbgs_wavefront(sol_t, rhs_t, At, OMEGA, 7), want)
    assert chunks == [F64_DEPTH] * 3 + [1]
    assert s3.rbgs_wavefront(sol_t, rhs_t, At, OMEGA, 0) is sol_t


# ----------------------------------------------------------------------
# K7 / K8: the whole-leg wavefronts (node and cell transfers)
# ----------------------------------------------------------------------

LEGS = {f"node_l{lv}_k{K}": (2 ** lv + 1, "node", K) for lv in (3, 4) for K in (1, 2, 3)}
LEGS["cell_l4_k2"] = (16, "cell", 2)
LEGS["node_l3_k4"] = (9, "node", 4)  # deeper than one float64 launch holds


def _leg_case(name):
    n, geom, K = LEGS[name]
    R, P = ((j_node_restriction(3), j_node_prolongation(3)) if geom == "node"
            else (j_cell_restriction(3), j_cell_prolongation(3)))
    nc = (n - 1) // 2 + 1 if geom == "node" else n // 2
    sol, rhs, sol_c = fields(n + K, (n,) * 3, (n,) * 3, (nc,) * 3)
    return (n,) * 3, (nc,) * 3, R, P, K, sol, rhs, sol_c


@pytest.mark.parametrize("name", sorted(LEGS))
def test_smooth_res_restrict_wavefront_matches_pallas_v1(v1, monkeypatch, name):
    fine, coarse, R, P, K, sol, rhs, _ = _leg_case(name)
    A = star3d()
    r_mats = build_restrict_mats(R, coarse, fine, coarse)
    want_s, want_rc = smooth_res_restrict_fused_3d(
        jnp.asarray(sol), jnp.asarray(rhs), A.offsets, A.coefs, OMEGA, K, r_mats[1], r_mats[2],
        separable_kernels(R)[0], R.lo[0], coarse, interpret=True)
    prelude = _count_calls(monkeypatch, "rbgs_wavefront")
    sol_t = torch.from_numpy(sol.copy())
    got_s, got_rc = s3.smooth_res_restrict_wavefront(sol_t, torch.from_numpy(rhs),
                                                     stencil_from_jax(A), OMEGA, K,
                                                     separable_kernels(R), R.lo, coarse)
    np.testing.assert_array_equal(sol_t.numpy(), sol)
    close(got_s, want_s)
    close(got_rc, want_rc)
    kmax = s3.max_cluster_k(torch.float64, s3.LEG_RESTRICT,
                            s3.restrict_reach(separable_kernels(R), R.lo))
    assert prelude == ([K - kmax] if K > kmax else [])


@pytest.mark.parametrize("name", sorted(LEGS))
def test_prolong_correct_smooth_wavefront_matches_pallas_v1(v1, monkeypatch, name):
    fine, coarse, R, P, K, sol, rhs, sol_c = _leg_case(name)
    A = star3d()
    p_mats = build_prolong_mats(P, fine, coarse, fine)
    want = prolong_correct_smooth_fused_3d(
        jnp.asarray(sol), jnp.asarray(sol_c), jnp.asarray(rhs), A.offsets, A.coefs, OMEGA, K,
        p_mats[1], p_mats[2], separable_kernels(P)[0], P.lo[0], interpret=True)
    tail = _count_calls(monkeypatch, "rbgs_wavefront")
    sol_t = torch.from_numpy(sol.copy())
    got = s3.prolong_correct_smooth_wavefront(sol_t, torch.from_numpy(sol_c),
                                              torch.from_numpy(rhs), stencil_from_jax(A),
                                              OMEGA, K, separable_kernels(P), P.lo)
    np.testing.assert_array_equal(sol_t.numpy(), sol)
    close(got, want)
    kmax = s3.max_cluster_k(torch.float64, s3.LEG_PROLONG)
    assert tail == ([K - kmax] if K > kmax else [])


def test_wavefront_wrappers_reject_other_devices():
    t = torch.zeros((9, 9, 9), device="meta")
    A = stencil_from_jax(star3d())
    R = j_node_restriction(3)
    k = separable_kernels(R)
    with pytest.raises(ValueError, match="unsupported device"):
        s3.rbgs_wavefront(t, t, A, OMEGA, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        s3.smooth_res_restrict_wavefront(t, t, A, OMEGA, 1, k, R.lo, (5, 5, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        s3.prolong_correct_smooth_wavefront(t, t, t, A, OMEGA, 1, k, R.lo)


def test_wavefront_cpu_path_launches_no_kernel():
    counters = (s3.rbgs_wavefront, s3.smooth_res_restrict_wavefront,
                s3.prolong_correct_smooth_wavefront)
    before = [fn.launches for fn in counters]
    _, coarse, R, P, K, sol, rhs, sol_c = _leg_case("node_l3_k2")
    A = stencil_from_jax(star3d())
    sol, rhs, sol_c = (torch.from_numpy(a) for a in (sol, rhs, sol_c))
    s3.rbgs_wavefront(sol, rhs, A, OMEGA, K)
    s3.smooth_res_restrict_wavefront(sol, rhs, A, OMEGA, K, separable_kernels(R), R.lo, coarse)
    s3.prolong_correct_smooth_wavefront(sol, sol_c, rhs, A, OMEGA, K, separable_kernels(P), P.lo)
    assert [fn.launches for fn in counters] == before


# ----------------------------------------------------------------------
# the schedule switch and the v1 solves
# ----------------------------------------------------------------------

WRAPPERS = {"K1": "smooth_res_restrict", "K2": "prolong_correct_smooth", "K3": "rbgs_fused",
            "K6": "rbgs_wavefront", "K7": "smooth_res_restrict_wavefront",
            "K8": "prolong_correct_smooth_wavefront"}
L4 = dict(dimensionality=3, minLevel=0, maxLevel=4)


@pytest.mark.parametrize("env", ["1", "0", None])
@pytest.mark.parametrize("kind", ["rbgs", "fas"])
def test_schedule_switch_selects_the_kernels(monkeypatch, env, kind):
    """One cycle of the maxLevel 4 solver: which wrappers run, on which
    level sizes.  The variable is read when the kernels are called."""
    calls = {kk: [] for kk in WRAPPERS}
    for kk, name in WRAPPERS.items():
        def spy(sol, *args, _fn=getattr(s3, name), _kk=kk, **kw):
            calls[_kk].append(sol.shape[0])
            return _fn(sol, *args, **kw)
        monkeypatch.setattr(s3, name, spy)
    ts = PoissonMGSolver(Knowledge(**L4, solver_useFAS=kind == "fas").update(), device="cpu")
    if env is None:
        monkeypatch.delenv("EXA_STREAM_V1", raising=False)
    else:
        monkeypatch.setenv("EXA_STREAM_V1", env)
    sol, rhs = ts.init_state()
    ts._cycle(sol, rhs)
    sizes = [17, 9, 5]  # levels 4, 3, 2 on the way down
    if kind == "rbgs":
        legs = ("K7", "K8") if env == "1" else ("K1", "K2")
        want = {legs[0]: sizes, legs[1]: sizes[::-1]}
        if env == "1":  # float64 V(3,3): K7 holds 1 iteration, K8 2; K6 runs the rest
            want["K6"] = sizes + sizes[::-1]
    else:  # pre- and post-smoothing per level
        want = {"K6" if env == "1" else "K3": [17, 9, 5, 5, 9, 17]}
    assert {kk: v for kk, v in calls.items() if v} == want


@pytest.mark.parametrize("name", ["rbgs", "fas"])
def test_v1_solve_matches_jax(v1, name):
    """maxLevel 4 f64 V(3,3): the port (K7/K8 resp. K6 as plain versions)
    prints the JAX package's lines with its v1 kernels in interpret mode."""
    js, ts = build_both(dict(L4, solver_useFAS=name == "fas"), {})
    j, t = solve_both(js, ts)
    assert t[4] == j[4] == 10
