"""The variable-coefficient Poisson3D model (`PoissonMGSolver(...,
kappa_fn=...)`, models/poisson.varcoeff_laplace_stencil) against its plain
reference, portbench/references/poisson3d_varcoeff_vcycle.py, loaded by
path as the benchmark loads it: equal cycles and solutions within 1e-12 in
float64 on the CPU at levels 3-5; kappa = 1 prints the Laplacian's lines;
four coefficient arrays a level, the minus sides views of the plus sides';
the faults the benchmark cell's check must catch; the route each `level`
span names and the `coef_bytes` and `coef_s` counters; the readers of the
cell's three metrics on a hand-made run.  The JAX package has no such
model (tests/test_torch_varcoeff_operator.py holds the operator to its
DSL), so this file imports no jax; its `cuda` tests run on the card
(`python -m pytest --noconftest tests/test_torch_varcoeff.py -m cuda`)."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.core.grid import NODE
from exastencils_tpu_torch.models import poisson
from exastencils_tpu_torch.models.poisson import PoissonMGSolver
from exastencils_tpu_torch.runtime import timers
from exastencils_tpu_torch.runtime.timers import Span
from portbench import harness, traffic as traffic_gen, varcoeff
from portbench.yardstick import PEAK_BYTES_S

REPO = Path(__file__).resolve().parents[1]
CELL = "api_vc.l9_f64"
BENCH = harness.Bench(REPO)
CFG, CFG_DIR = BENCH.config(BENCH.cell(CELL)["config"])
REFERENCE = BENCH.reference(CFG)
SYSTEM = BENCH.system(CFG)
SEED = 2 ** 33 + 21


@pytest.fixture(autouse=True)
def no_spans_left():
    timers.drain()
    yield
    assert not timers.TRACER.stack
    timers.drain()


def knowledge(level):
    return Knowledge(dimensionality=3, minLevel=0, maxLevel=level, useDblPrecision=True).update()


def kappa(x, y, z):
    return SYSTEM.kappa_fn(CFG["kappa"])(x, y, z)


def random_rhs(level, seed, device="cpu"):
    """Uniform noise on the inner nodes, zero on the boundary."""
    n = 2 ** level + 1
    g = torch.Generator(device=device).manual_seed(seed)
    f = torch.zeros((n,) * 3, dtype=torch.float64, device=device)
    f[1:-1, 1:-1, 1:-1] = 100.0 * (torch.rand((n - 2,) * 3, generator=g, dtype=torch.float64,
                                              device=device) - 0.5)
    return f


def system(level, device="cpu"):
    return SYSTEM.System(CFG, level, device, CFG_DIR)


@pytest.mark.parametrize("entry", ["solve_fused", "solve"])
@pytest.mark.parametrize("level", [3, 4, 5])
def test_port_matches_the_plain_reference(entry, level):
    """Each entry of the solver API on seeded random right-hand sides:
    the reference's cycle count, and the solution within 1e-12 of its
    largest entry (float64, the CPU)."""
    sut = system(level)
    for seed in (level, level + 100):
        f = random_rhs(level, seed)
        sut.load(f)
        if entry == "solve_fused":
            cycles, u = sut.solve(), sut.solution()
        else:
            u, _, _, _, cycles = sut.solver.solve(
                max_its=CFG["max_cycles"], target_res_reduction=CFG["target_res_reduction"],
                print_error=False, state=(sut.x, sut.rhs))
        u_ref, cycles_ref, _ = REFERENCE.solve(CFG, f, level, torch.float64)
        assert cycles == cycles_ref and 8 <= cycles <= 14
        assert harness.rel_gap(u, u_ref) <= 1e-12


@pytest.mark.parametrize("one", [lambda x, y, z: 1.0, lambda x, y, z: torch.ones_like(x * y * z)])
def test_unit_kappa_prints_the_laplacian_lines(one):
    """kappa = 1 (a scalar or a tensor) gives the constant Laplacian's
    coefficients as arrays: the printed lines and the solution are the
    solver's without `kappa_fn`."""
    got_sol, got, *_ = PoissonMGSolver(knowledge(4), "cpu", kappa_fn=one).solve()
    want_sol, want, *_ = PoissonMGSolver(knowledge(4), "cpu").solve()
    assert got == want and len(got) > 10
    assert torch.equal(got_sol, want_sol)


@pytest.mark.parametrize("ndim", [2, 3])
def test_four_arrays_a_level_sharing_storage(ndim):
    """ndim + 1 storages a level (the centre, one face array per axis),
    none larger than (n + 1) n^(ndim - 1) values; each axis's minus and
    plus sides are views of one face array shifted by one; a second bind
    shares the first's arrays; the hierarchy's `coef_bytes` counts each
    storage once."""
    k = Knowledge(dimensionality=ndim, minLevel=0, maxLevel=4, useDblPrecision=True).update()
    solver = PoissonMGSolver(k, "cpu", kappa_fn=lambda *x: 1.0 + sum(c * c for c in x))
    total = 0
    for lvl, grid in solver.grids.items():
        n = grid.shape_of(NODE)[0]
        a, b = solver.stencil.bind(grid), solver.stencil.bind(grid)
        assert all(x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()
                   and x.storage_offset() == y.storage_offset() for x, y in zip(a.coefs, b.coefs))
        stores = {c.untyped_storage().data_ptr(): c.untyped_storage().nbytes() for c in a.coefs}
        assert len(stores) == ndim + 1
        assert max(stores.values()) <= (n + 1) * n ** (ndim - 1) * 8
        total += sum(stores.values())
        by_off = dict(a.items())
        for d in range(ndim):
            lo, hi = ([s if i == d else 0 for i in range(ndim)] for s in (-1, 1))
            minus, plus = by_off[tuple(lo)], by_off[tuple(hi)]
            assert minus.untyped_storage().data_ptr() == plus.untyped_storage().data_ptr()
            assert minus.shape == plus.shape == (n,) * ndim
            assert torch.equal(minus.narrow(d, 1, n - 1), plus.narrow(d, 0, n - 1))
        centre = by_off[(0,) * ndim]
        assert torch.allclose(centre, -sum(c for o, c in a.items() if any(o)), rtol=1e-14)
    assert solver.coef_bytes == total
    assert PoissonMGSolver(k, "cpu").coef_bytes == 0


def test_dense_backend_only():
    with pytest.raises(ValueError, match="dense backend"):
        PoissonMGSolver(knowledge(3), "cpu", kappa_fn=kappa, mesh=object())


def test_level_spans_name_the_plain_route_and_the_counters_the_build():
    """Solved under a host-only profiler session: every `level` span of
    the solve `plain@L`, and no span outside the solve; the counters hold
    the hierarchy's bytes and the build's seconds, and the system reports
    both.  With the profiler off nothing is recorded."""
    with profile(activities=[ProfilerActivity.CPU]):
        solver = PoissonMGSolver(knowledge(4), "cpu", kappa_fn=kappa)
        cycles = int(solver.solve_fused(max_its=100, target_res_reduction=1e-10)[3])
    spans = timers.drain()
    assert {s.kind for s in spans if s.solve is None} == set()
    levels = [s.name for s in spans if s.kind == "level"]
    assert levels == [f"plain@{lvl}" for lvl in range(4, -1, -1)] * cycles and cycles == 11
    n = [2 ** lvl + 1 for lvl in range(5)]
    assert solver.coef_bytes == sum(8 * (m ** 3 + 3 * (m + 1) * m * m) for m in n)
    assert 0.0 < solver.coef_s < 10.0
    counters = system(4).counters()
    assert counters["coef_bytes"] == solver.coef_bytes and counters["coef_s"] > 0.0

    solver = PoissonMGSolver(knowledge(4), "cpu", kappa_fn=kappa)
    solver.solve_fused(max_its=100, target_res_reduction=1e-10)
    assert timers.drain() == []


# ----------------------------------------------------------------------
# faults the cell's check must catch


def kappa_at_the_nodes(grid, d, kappa_fn):
    """face_coefficients with kappa sampled at node j in place of the
    midpoint j - 1/2."""
    h = grid.grid_width(d)
    coords = []
    for a in range(grid.ndim):
        x = grid.node_pos_1d(a)
        if a == d:
            x = torch.cat([x, x[-1:] + h])
        coords.append(x.reshape([-1 if b == a else 1 for b in range(grid.ndim)]))
    return kappa_fn(*coords).mul_(-1.0 / h ** 2)


def one_face_array(face, d, n):
    """minus_side reading the plus side: one face array for both sides."""
    return poisson.plus_side(face, d, n)


def sampled_gaps(sut, level, fault=None):
    """(solution_gap, cycles_gap) of the cell's sampled solves of one seed,
    as a run computes them, with `fault` planted in the timed solve."""
    tr = dict(BENCH.traffic(BENCH.cell(CELL)["traffic"]), level=level)
    rhs, order = traffic_gen.bank(tr, SEED, torch.float64, "cpu"), traffic_gen.order(tr, SEED)
    gaps, cycle_gaps = [], []
    for i in traffic_gen.samples(tr, SEED):
        f = rhs[order[i % len(order)]]
        sut.load(f)
        cycles = sut.solve()
        if fault == "half_the_cycles":  # half the work, the count reported whole
            sut.load(f)
            eps, _ = sut.key
            sut.out = sut.solver.solve_fused(max_its=cycles // 2, target_res_reduction=eps,
                                             state=(sut.x, sut.rhs))[0]
        u_ref, cycles_ref, _ = REFERENCE.solve(CFG, f, level, torch.float64)
        gaps.append(harness.rel_gap(sut.solution(), u_ref))
        cycle_gaps.append(abs(cycles - cycles_ref))
    return max(gaps), max(cycle_gaps)


@pytest.mark.parametrize("fault", [None, "kappa_at_nodes", "one_face_array", "half_the_cycles"])
def test_faults_read_not_correct_under_the_cells_limits(monkeypatch, fault):
    """At level 4: the sound program is correct under the cell's limits;
    kappa at the nodes, one face array for both sides of an axis and half
    the cycles each are not (all three by the solution gap)."""
    if fault == "kappa_at_nodes":
        monkeypatch.setattr(poisson, "face_coefficients", kappa_at_the_nodes)
    if fault == "one_face_array":
        monkeypatch.setattr(poisson, "minus_side", one_face_array)
    limits = BENCH.limits(CELL)
    gap, cycles_gap = sampled_gaps(system(4), 4, fault)
    print(f"{fault}: solution_gap {gap:.3e}, cycles_gap {cycles_gap}")
    if fault is None:
        assert gap <= limits["solution_gap"] and cycles_gap <= limits["cycles_gap"]
    else:
        assert gap > 1e3 * limits["solution_gap"]


# ----------------------------------------------------------------------
# the cell's readers on a hand-made run


def hand_made_spans():
    """Two solves of two cycles over levels 2..0, level 2 `kernels` in the
    second solve."""
    spans = []
    for solve, top in ((10, "plain"), (40, "kernels")):
        spans.append(Span(solve, "solve", "solve_fused", None, solve, 1.0, 2.0, 30.0))
        for c in (solve + 1, solve + 10):
            spans += [Span(c, "cycle", "V-cycle@2", solve, solve, 1.0, 1.1, 10.0),
                      Span(c + 1, "level", f"{top}@2", c, solve, 1.0, 1.1, 10.0),
                      Span(c + 2, "level", "plain@1", c + 1, solve, 1.0, 1.1, 4.0),
                      Span(c + 3, "level", "plain@0", c + 2, solve, 1.0, 1.1, 1.0),
                      Span(c + 4, "coarse", "coarse@0", c + 3, solve, 1.0, 1.1, 1.0)]
    return spans


def hand_made_run(traced_solves):
    trace = {"device": [("k", 0.0, 100_000.0)], "host": [("exa.solve:solve_fused", 0.0, 1.0)],
             "wall_s": 0.2, "reps": 2}
    return SimpleNamespace(cuda=True, traffic={"traced_solves": traced_solves}, fine_dofs=513 ** 3,
                           ndim=3, dtype_bytes=8, solve_trace=trace, cycle_trace=trace,
                           counters={"setup": {"host_reads": 0, "coef_s": 0.27},
                                     "window": {"host_reads": 0, "coef_s": 0.0}})


@pytest.mark.parametrize("traced_solves,plain", [(1, 4.0), (2, 7.0)])
def test_readers_on_a_hand_made_run(monkeypatch, traced_solves, plain):
    """cycle.plain_ms sums the self time of the `plain@L` level spans per
    cycle of the last traced solves (10 ms a cycle, 6 of it level 2's own:
    4 where level 2 ran kernels, 7 over both solves); the roofline share is
    112.0 B a fine node at 3.35 TB/s against 50 ms of busy time a cycle;
    setup.coef_s is the set-up counter.  With no span, no trace and no
    counter, each reads None."""
    monkeypatch.setattr(timers, "drain", hand_made_spans)
    run = hand_made_run(traced_solves)
    new = ("cycle.plain_ms", "cycle.varcoeff_roofline_share", "setup.coef_s")
    got = {m["name"]: read(run) for m, read in BENCH.metrics(CELL, "per_layer")
           if m["name"] in new}
    least = 112.0 * 513 ** 3 / PEAK_BYTES_S
    assert got == pytest.approx({"cycle.plain_ms": plain,
                                 "cycle.varcoeff_roofline_share": 100 * least / 0.05,
                                 "setup.coef_s": 0.27})
    assert varcoeff.varcoeff_vcycle_bytes_per_fine_dof(8) == pytest.approx(57.142857 + 54.857143)

    monkeypatch.setattr(timers, "drain", lambda: [])
    run = hand_made_run(traced_solves)
    run.cycle_trace = None
    run.counters = {"setup": {"host_reads": 0}, "window": {"host_reads": 0}}
    assert {m["name"]: read(run) for m, read in BENCH.metrics(CELL, "per_layer")
            if m["name"] in new} == dict.fromkeys(new)


def test_plain_ms_reads_nothing_without_routes(monkeypatch):
    """Level spans that name no route (a program before routes) read None."""
    spans = [s if s.kind != "level" else Span(s.id, "level", "level@" + s.name.split("@")[1],
                                              s.parent, s.solve, 0.0, 1.0, s.device_ms)
             for s in hand_made_spans()]
    monkeypatch.setattr(timers, "drain", lambda: spans)
    assert varcoeff.plain_ms(hand_made_run(1)) is None


def test_the_cells_files_hold_its_settings():
    """The configuration states its kappa and assumptions and is not cut;
    the traffic is rhs4_l9's right-hand sides with fewer, earlier samples."""
    cfg = json.loads((REPO / "portbench" / "configs" / "poisson3d_varcoeff_api_f64.json")
                     .read_text())
    assert cfg["kappa"]["kappa0"] == 10.0 and cfg["reduced"] == [] and "kappa" in cfg["assumed"]
    entry = next(c for c in BENCH.manifest["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    vc, base = BENCH.traffic("rhs4_l9_vc"), BENCH.traffic("rhs4_l9")
    assert {k: vc[k] for k in ("level", "rhs", "amplitude", "noise")} == \
        {k: base[k] for k in ("level", "rhs", "amplitude", "noise")}
    assert (vc["warm_solves"], vc["samples"], vc["traced_solves"], vc["sample_within"]) == \
        (2, 2, 2, 4)
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in Path(REFERENCE.__file__).read_text()


# ----------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_makers_decline_and_no_kernel_runs_on_the_card(cuda, monkeypatch):
    """On CUDA tensors the constant-coefficient makers (K3, K4/K5) decline
    the bound stencil and the leg maker gives K11/K12; a staged solve at
    level 5 calls no constant-coefficient kernel wrapper nor a check
    kernel, but K11/K12 on levels 5-2; it equals the plain reference on
    the card."""
    import exastencils_tpu_torch.ops.cuda as makers
    from exastencils_tpu_torch.ops.cuda import check3d, stream3d

    solver = PoissonMGSolver(knowledge(5), cuda, kappa_fn=kappa)
    grid = solver.grids[5]
    A = solver.stencil.bind(grid)
    shape, coarse = grid.shape_of(NODE), solver.grids[4].shape_of(NODE)
    u = solver.solution
    assert makers.make_fused_smoother_3d(A, u, 5, shape, 0.8, 2) is None
    assert makers.make_fused_transfers_3d(A, u, 5, shape, coarse, solver.restrict_op,
                                            solver.prolong_op) == (None, None)
    down, up = makers.make_fused_legs_3d(A, u, 5, shape, coarse, solver.restrict_op,
                                         solver.prolong_op, 0.8, 3, 3, 2)
    assert down is not None and up is not None
    called = []
    for mod, names in ((stream3d, ("smooth_res_restrict", "prolong_correct_smooth", "rbgs_fused",
                                   "res_restrict", "prolong_correct", "rbgs_wavefront",
                                   "smooth_res_restrict_wavefront",
                                   "prolong_correct_smooth_wavefront")),
                       (check3d, ("residual", "inner_sum_squares"))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, name=name, **k: called.append(name))
    n0 = (stream3d.smooth_res_restrict_faces.launches,
          stream3d.prolong_correct_smooth_faces.launches)
    f = random_rhs(5, 7, "cuda")
    sol, rhs = solver.init_state()
    rhs.copy_(f)
    out = solver.solve_fused(max_its=100, target_res_reduction=1e-10, state=(sol, rhs))
    u_ref, cycles_ref, _ = REFERENCE.solve(CFG, f, 5, torch.float64)
    assert called == [] and int(out[3]) == cycles_ref
    assert stream3d.smooth_res_restrict_faces.launches > n0[0]
    assert stream3d.prolong_correct_smooth_faces.launches > n0[1]
    assert harness.rel_gap(out[0], u_ref) <= 1e-12


@pytest.mark.cuda
def test_level_routes_on_the_card(cuda):
    """Level spans of a staged solve at level 5 on the card: the constant
    Laplacian's levels 5..2 run kernels (K1/K2), 1 and 0 plain ops; so do
    the variable-coefficient solver's (K11/K12)."""
    const = PoissonMGSolver(knowledge(5), cuda)
    var = PoissonMGSolver(knowledge(5), cuda, kappa_fn=kappa)
    for solver in (const, var):
        solver.solve_fused(max_its=100, target_res_reduction=1e-10)  # captures
    t = time.perf_counter()
    names = {}
    for key, solver in (("const", const), ("var", var)):
        with profile(activities=[ProfilerActivity.CPU]):
            solver.solve_fused(max_its=100, target_res_reduction=1e-10)
            torch.cuda.synchronize()
        names[key] = {s.name for s in timers.drain() if s.kind == "level"}
    assert names["const"] == {f"kernels@{lvl}" for lvl in range(5, 1, -1)} | {"plain@1", "plain@0"}
    assert names["var"] == names["const"]
    assert time.perf_counter() - t < 60
