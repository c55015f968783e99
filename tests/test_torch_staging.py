"""Staged execution of the port (runtime/staging, dsl/interp_staging,
the staged solver entry points) against the JAX package's, on the CPU.

On the CPU a recording replays by re-running its closure on the same
static buffers, so the cache keys, buffer binding and write-back run as
they do with CUDA graphs on the card (tests/test_torch_cuda.py holds the
graphs themselves).  Each side is built from its own package's Knowledge
and parser: the partition of every function body into staged runs and the
early-exit matches equal the JAX package's; the staged port prints the
JAX package's staged lines (float64) and agrees bit for bit with the eager
port (float32); a second call replays, a changed traced int reuses the
capture, a changed constant re-keys; a run with a data-dependent `if`
stays eager and is counted; the device-loop CG and `solve_fused` match the
JAX package's `lax.while_loop` versions within 1e-12."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exastencils_tpu.config import Knowledge as JaxKnowledge
from exastencils_tpu.core import field as jfield
from exastencils_tpu.core.domain import unit_domain as j_unit_domain
from exastencils_tpu.core.grid import level_grids as j_level_grids
from exastencils_tpu.dsl.interp_base import Frame as JaxFrame
from exastencils_tpu.dsl.interpreter import L4Executable as JaxL4
from exastencils_tpu.dsl.parser import parse_l4 as jax_parse_l4
from exastencils_tpu.models.poisson import PoissonMGSolver as JaxPoisson
from exastencils_tpu.models.poisson import laplace_stencil as j_laplace
from exastencils_tpu.ops import boundary as jboundary
from exastencils_tpu.ops import stencil_apply as jstencil_apply
from exastencils_tpu.solver import krylov as jkrylov

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.core import field as tfield
from exastencils_tpu_torch.core.domain import unit_domain as t_unit_domain
from exastencils_tpu_torch.core.grid import level_grids as t_level_grids
from exastencils_tpu_torch.dsl.interp_base import Frame
from exastencils_tpu_torch.dsl.interpreter import L4Executable
from exastencils_tpu_torch.dsl.parser import parse_l4
from exastencils_tpu_torch.models.poisson import PoissonMGSolver, laplace_stencil as t_laplace
from exastencils_tpu_torch.ops import boundary as tboundary
from exastencils_tpu_torch.ops import stencil_apply as tstencil_apply
from exastencils_tpu_torch.runtime import staging
from exastencils_tpu_torch.solver import krylov as tkrylov

from test_torch_cuda import traced_float_bits
from test_torch_dsl_features import HEAD, PROGRAMS, precise
from test_torch_dsl_features import knowledge as features_knowledge

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
BENCH = os.path.join(REPO, "examples", "poisson_3d_bench.exa4")
EX2D = os.path.join(REPO, "examples", "poisson_2d.exa4")
EXAMPLES = {"3d": (BENCH, dict(dimensionality=3, minLevel=1, maxLevel=5)),
            "2d": (EX2D, dict(dimensionality=2, minLevel=0, maxLevel=5))}


def example_knowledge(which, f64=True, cls=Knowledge, **kw):
    kw = {**EXAMPLES[which][1], **kw}
    return cls(useDblPrecision=f64, tpu_compute_dtype="" if f64 else "float32",
               tpu_shard_dsl=False, **kw).update()


def port(src_or_path, k, jit=True, lines=None):
    """The port's executable of a program (file or source) on the CPU,
    staged (the CPU replay) unless jit is False."""
    return L4Executable(parse_l4(src_or_path), k, device="cpu", jit_functions=jit,
                        out=(lambda s: None) if lines is None else lines.append)


# ----------------------------------------------------------------------
# (a) partitions and early-exit matches
# ----------------------------------------------------------------------


def _blocks(stmts, path=()):
    """Every statement list of a function body, with its path."""
    yield path, stmts
    for i, s in enumerate(stmts):
        for attr in ("body", "then_body", "else_body"):
            sub = getattr(s, attr, None)
            if isinstance(sub, list) and sub:
                yield from _blocks(sub, path + ((i, attr),))


def partition_signature(ex, frame_cls):
    """(function, level, block path, statement index ranges with the staged
    flag) for every block of every function, and (function, level, path,
    matched, len(pre), len(post)) for every `repeat N times`."""
    parts, ee = [], []
    for (name, level), fn in sorted(ex.functions.items(), key=lambda kv: (kv[0][0], kv[0][1] or -1)):
        for path, stmts in _blocks(fn.body):
            pos = {id(s): i for i, s in enumerate(stmts)}
            runs = tuple((pos[id(run[0])], pos[id(run[-1])], bool(staged))
                         for run, staged in ex._partition_stmts(stmts, frame_cls({}, level), None))
            parts.append((name, level, path, runs))
            for i, s in enumerate(stmts):
                if type(s).__name__ == "RepeatTimes":
                    m = ex._match_early_exit_repeat(s, level)
                    ee.append((name, level, path, i, m is not None,
                               None if m is None else (len(m[0]), len(m[2]))))
    return parts, ee


PARTITION_CASES = ["3d", "2d"] + sorted(PROGRAMS)


@pytest.mark.parametrize("case", PARTITION_CASES)
def test_partitions_match_jax(case):
    if case in EXAMPLES:
        path = EXAMPLES[case][0]
        jex = JaxL4(jax_parse_l4(path), example_knowledge(case, cls=JaxKnowledge),
                    out=lambda s: None, jit_functions=True)
        tex = port(path, example_knowledge(case))
    else:
        src = HEAD + precise(PROGRAMS[case])
        jex = JaxL4(jax_parse_l4(src), features_knowledge(JaxKnowledge), out=lambda s: None,
                    jit_functions=True)
        tex = port(src, features_knowledge())
    want = partition_signature(jex, JaxFrame)
    got = partition_signature(tex, Frame)
    assert got == want
    if case in EXAMPLES:
        assert any(staged for *_, runs in got[0] for *_, staged in runs)


def test_bench_partition_stages_the_cycle_with_its_tail_cg():
    """MGCycle@finest's body is one staged run; the coarsest CG's repeat
    is an early-exit match (pre 8 statements, post 3) in tail position, so
    every MGCycle function stages."""
    ex = port(BENCH, example_knowledge("3d"))
    fin = ex.hi
    runs = list(ex._partition_stmts(ex.functions[("MGCycle", fin)].body, Frame({}, fin), None))
    assert [staged for _, staged in runs] == [True]
    cg_repeat = ex.functions[("MGCycle", ex.lo)].body[-1]
    pre, _, post = ex._match_early_exit_repeat(cg_repeat, ex.lo)
    assert (len(pre), len(post)) == (8, 3)
    assert all(ex._fn_stageable(ex.functions[("MGCycle", lvl)], lvl)
               for lvl in range(ex.lo, fin + 1))


# ----------------------------------------------------------------------
# (b), (c) lines and bits
# ----------------------------------------------------------------------


@pytest.mark.parametrize("which", ["3d", "2d"])
def test_staged_port_prints_the_jax_staged_lines(which):
    path = EXAMPLES[which][0]
    want = []
    JaxL4(jax_parse_l4(path), example_knowledge(which, cls=JaxKnowledge, tpu_dsl_fastpath=False),
          out=want.append, jit_functions=True).run()
    got = []
    ex = port(path, example_knowledge(which), lines=got)
    ex.run()
    assert got == want and len(got) > 3
    stats = ex.staging_stats()
    assert stats["unstaged"] == 0 and stats["replays"] > stats["captures"] > 0


@pytest.mark.parametrize("fastpath", [False, True], ids=["plain", "fastpath"])
@pytest.mark.parametrize("which", ["3d", "2d"])
def test_staged_and_eager_agree_bitwise_in_float32(which, fastpath, monkeypatch):
    """Every field and every printed line of the float32 run: staged
    (CPU replay) and eager bit for bit, with the fast path forced on the
    CPU or off."""
    if fastpath:
        monkeypatch.setenv("EXA_FASTPATH_FORCE", "1")
    path = EXAMPLES[which][0]
    out = {}
    for jit in (False, True):
        lines = []
        ex = port(path, example_knowledge(which, f64=False), jit=jit, lines=lines)
        ex.run()
        out[jit] = (ex, lines)
    (eager, l0), (staged, l1) = out[False], out[True]
    assert l1 == l0
    assert set(staged.state) == set(eager.state)
    for key, t in eager.state.items():
        assert torch.equal(staged.state[key], t), key
    assert staged.staging_stats()["unstaged"] == 0
    if fastpath and which == "3d":
        assert staged._fastpath is not None


# ----------------------------------------------------------------------
# (d), (e) cache keys and the runs that stay eager
# ----------------------------------------------------------------------

KEYED = """
Domain global< [0.0, 0.0] to [1.0, 1.0] >
Layout NodeNoComm< Real, Node >@all {
  duplicateLayers = [1, 1]
  ghostLayers     = [0, 0]
}
Field u< global, NodeNoComm, 0.0 >@all
Field w< global, NodeNoComm, 0.0 >@all
Globals {
  Var k : Integer = 1
  Var flag : Boolean = ( 1 < 2 )
}
Function Step@finest {
  loop over u@current {
    u@current = u@current + k
  }
  if ( flag ) {
    loop over w@current {
      w@current = 2.0 * u@current
    }
  }
}
Function Application ( ) : Unit {
  Step@finest ( )
}
"""


def test_second_call_replays_traced_int_reuses_and_constant_rekeys():
    ex = port(KEYED, Knowledge(dimensionality=2, minLevel=0, maxLevel=3,
                               tpu_shard_dsl=False).update())
    fin = ex.hi
    step = ex.functions[("Step", fin)]

    def call():
        ex.call_function(step, fin, [])
        return ex.get_field("u", fin)[1, 1].item(), ex.get_field("w", fin)[1, 1].item()

    assert call() == (1.0, 2.0)
    s1 = ex.staging_stats()
    assert (s1["captures"], s1["replays"]) == (1, 1)
    assert call() == (2.0, 4.0)  # replayed, not captured again
    assert (ex.stage_stats.captures, ex.stage_stats.replays) == (1, 2)
    ex.globals["k"] = 5  # a traced int: same capture, new value
    assert call() == (7.0, 14.0)
    assert (ex.stage_stats.captures, ex.stage_stats.replays) == (1, 3)
    ex.globals["flag"] = False  # a constant: a new key, a new capture
    assert call() == (12.0, 14.0)
    assert (ex.stage_stats.captures, ex.stage_stats.replays) == (2, 4)
    assert ex.stage_stats.unstaged == 0


DATA_IF = """
Function Check@finest {
  Var t : Real = 0.0
  loop over u@current with reduction ( + : t ) {
    t += u@current
  }
  if ( t > 1.0 ) {
    loop over w@current {
      w@current = w@current + 1.0
    }
  }
  print ( t )
}

Function Application ( ) : Unit {
  loop over u@finest {
    u@finest = vf_nodePos_x * vf_nodePos_y
  }
  Check@finest ( )
  Check@finest ( )
  Var n : Real = 0.0
  loop over w@finest with reduction ( + : n ) {
    n += w@finest
  }
  print ( n )
}
"""


def test_data_dependent_if_stays_eager_and_prints_the_jax_lines():
    src = HEAD + precise(DATA_IF)
    want = []
    JaxL4(jax_parse_l4(src), features_knowledge(JaxKnowledge), out=want.append,
          jit_functions=True).run()
    got = []
    ex = port(src, features_knowledge(), lines=got)
    with pytest.warns(RuntimeWarning, match="left eager"):
        ex.run()
    assert got == want and len(got) == 3
    stats = ex.staging_stats()
    assert stats["unstaged"] == 1 and len(stats["unstaged_runs"]) == 1
    assert "HostRead" in next(iter(stats["unstaged_runs"].values()))


def test_other_errors_inside_a_staged_run_raise(monkeypatch):
    """A failure that is not a host read or a missed state key is never
    turned into eager execution."""
    ex = port(BENCH, example_knowledge("3d", maxLevel=3))

    def boom(*args, **kwargs):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(ex, "_apply_bc_field", boom)
    with pytest.raises(RuntimeError, match="kernel failed"):
        ex.run()
    assert ex.stage_stats.unstaged == 0


EARLY_EXIT = """
Function Application ( ) : Unit {
  loop over u@finest {
    u@finest = vf_nodePos_x
  }
  Var r : Real = 1.0
  Var its : Integer = 0
  print ( r )
  repeat 40 times count its {
    loop over u@finest {
      u@finest = 0.5 * u@finest
    }
    r = r * 0.5
    if ( r <= 0.001 ) {
      return
    }
    loop over w@finest {
      w@finest = w@finest + u@finest
    }
  }
}

Function Smooth@finest {
  print ( 1 )
  repeat 30 times {
    loop over w@current {
      w@current = 0.75 * w@current + 0.25
    }
  }
}
"""


def test_early_exit_and_large_repeats_run_as_device_loops():
    """Outside a staged run, the early-exit repeat is one device loop with
    one host read per chunk and one for the early return, the large
    no-exit repeat one loop with none; the state equals the eager one."""
    src = HEAD + EARLY_EXIT
    out = {}
    for jit in (False, True):
        ex = port(src, features_knowledge(), jit=jit)
        ex.run()
        fin = ex.hi
        ex.call_function(ex.functions[("Smooth", fin)], fin, [])
        out[jit] = ex
    eager, staged = out[False], out[True]
    for key, t in eager.state.items():
        assert torch.equal(staged.state[key], t), key
    stats = staged.stage_stats
    # r halves to 0.0009765625 <= 0.001 in the 10th iteration
    assert stats.host_reads == 10 + 1 and stats.unstaged == 0


# ----------------------------------------------------------------------
# (f), (g) the device loops of the solver against lax.while_loop
# ----------------------------------------------------------------------


def _cg_pair(level, rhs_scale, **kw):
    kw3 = dict(dimensionality=3, minLevel=0, maxLevel=level)
    jg = j_level_grids(j_unit_domain(3), JaxKnowledge(**kw3).update(), dtype=jnp.float64)[level]
    tg = t_level_grids(t_unit_domain(3), Knowledge(**kw3).update(), "cpu", dtype=torch.float64)[level]
    shape = jg.shape_of("Node")
    jbc = jboundary.make_bc_applier(jfield.Field("u", j_unit_domain(3), bc=0.0), jg)
    tbc = tboundary.make_bc_applier(tfield.Field("u", t_unit_domain(3), bc=0.0), tg)
    jA, tA = j_laplace(3).bind(jg), t_laplace(3).bind(tg)
    rhs = rhs_scale * np.random.default_rng(11).standard_normal(shape)
    want = jkrylov.cg(lambda x: jstencil_apply.apply_stencil(jA, x), jbc(jnp.zeros(shape)),
                      jnp.asarray(rhs), bc_sol=jbc, bc_res=jbc, **kw)
    got = tkrylov.cg(lambda x: tstencil_apply.apply_stencil(tA, x),
                     tbc(torch.zeros(shape, dtype=torch.float64)), torch.from_numpy(rhs),
                     bc_sol=tbc, bc_res=tbc, **kw)
    return got, want


@pytest.mark.parametrize("case", ["init_res_zero", "converged", "max_its"])
def test_cg_device_loop_matches_jax(case):
    level, scale, kw = {"init_res_zero": (0, 1.0, {}),
                        "converged": (3, 1.0, dict(max_its=64, res_reduction=1e-9)),
                        "max_its": (3, 1.0, dict(max_its=4, res_reduction=1e-12))}[case]
    got, want = _cg_pair(level, scale, **kw)
    assert int(got.iterations) == int(want.iterations)
    assert got.iterations.dtype == torch.int64 and got.iterations.dim() == 0
    assert {"init_res_zero": 0, "max_its": 4}.get(case, int(got.iterations)) == int(got.iterations)
    want_sol = np.asarray(want.sol)
    scale_sol = max(np.abs(want_sol).max(), 1e-300)
    assert np.abs(got.sol.numpy() - want_sol).max() <= 1e-12 * scale_sol
    assert abs(float(got.residual) - float(want.residual)) <= 1e-12 * max(
        float(want.residual), np.abs(np.asarray(want.residual)).max(), 1e-300) + 1e-300


def test_cg_reads_the_done_flag_once_per_chunk(monkeypatch):
    """No host read per iteration: with a chunk of 4 iterations, a CG of
    k iterations reads its flag ceil(k / 4) times, and the masked
    iterations after the exit change nothing."""
    reads = []
    orig = staging.read_flag
    monkeypatch.setattr(staging, "read_flag", lambda f, s=None: reads.append(1) or orig(f, s))
    monkeypatch.setattr(staging, "LOOP_CHUNK", 4)
    got, want = _cg_pair(3, 1.0, max_its=64, res_reduction=1e-9)
    its = int(got.iterations)
    assert its == int(want.iterations) > 4
    assert len(reads) == -(-its // 4)
    monkeypatch.setattr(staging, "LOOP_CHUNK", 1)
    again, _ = _cg_pair(3, 1.0, max_its=64, res_reduction=1e-9)
    assert torch.equal(again.sol, got.sol) and torch.equal(again.residual, got.residual)


@pytest.mark.parametrize("fas", [False, True], ids=["rbgs", "fas"])
def test_solve_fused_matches_jax(fas):
    kw = dict(dimensionality=3, minLevel=0, maxLevel=4, solver_useFAS=fas)
    js = JaxPoisson(JaxKnowledge(tpu_use_pallas=False, **kw).update())
    ts = PoissonMGSolver(Knowledge(**kw).update(), device="cpu")
    j_sol, j_init, j_cur, j_it = js.solve_fused(max_its=100, target_res_reduction=1e-10)
    t_sol, t_init, t_cur, t_it = ts.solve_fused(max_its=100, target_res_reduction=1e-10)
    assert int(t_it) == int(j_it) > 0
    assert abs(float(t_init) - float(j_init)) <= 1e-12 * float(j_init)
    assert abs(float(t_cur) - float(j_cur)) <= 1e-12 * float(j_init)
    j_sol = np.asarray(j_sol)
    assert np.abs(t_sol.numpy() - j_sol).max() <= 1e-10 * np.abs(j_sol).max()
    # the host-driven solve of the port: same count, same final residual bits
    _, _, init, cur, it = PoissonMGSolver(Knowledge(**kw).update(), device="cpu").solve(
        max_its=100, target_res_reduction=1e-10)
    assert (it, cur, init) == (int(t_it), float(t_cur), float(t_init))


# ----------------------------------------------------------------------
# the staged callable and the device loop themselves
# ----------------------------------------------------------------------


def test_staged_binds_replays_writes_back_and_clones(monkeypatch):
    monkeypatch.setattr(staging, "MAX_BINDINGS", 2)
    calls = []

    def fn(a, b):
        calls.append(1)
        return a * 2.0 + b, (a * b).sum()

    st = staging.Staged(fn, donate=(0,))
    a, b = torch.ones(4, dtype=torch.float64), torch.arange(4, dtype=torch.float64)
    out, s = st(a, b)
    assert out is a and torch.equal(a, torch.tensor([2.0, 3.0, 4.0, 5.0], dtype=torch.float64))
    assert float(s) == 6.0 and st.stats.captures == 1
    s_held = s
    out, s2 = st(a, b)  # same tensors: a replay, the held scalar untouched
    assert st.stats.captures == 1 and st.stats.replays == 2
    assert float(s_held) == 6.0 and float(s2) == 26.0 and s2 is not s_held
    held = a.clone()
    c = torch.zeros(4, dtype=torch.float64)
    st(c, b)  # new tensor: a new binding, `a` is left alone
    assert st.stats.captures == 2 and torch.equal(a, held)
    st(torch.zeros(4, dtype=torch.float64), b)
    assert len(st._bindings) == 2  # least recently used out
    with pytest.raises(staging.HostRead):
        staging.Staged(lambda x: x * float(x.sum()))(torch.ones(3))


def test_device_loop_masks_iterations_after_the_exit(monkeypatch):
    def body(c, it):
        x, = c
        y = x * 1.5 + it.to(x.dtype)
        return [y], y > 40.0

    ref = torch.tensor(1.0, dtype=torch.float64)
    for _ in range(7):  # the exit fires in the 6th iteration
        ref_prev, ref = ref, ref * 1.5 + (_ if _ < 6 else 0)
        if ref > 40.0:
            break
    for chunk in (1, 3, 8):
        monkeypatch.setattr(staging, "LOOP_CHUNK", chunk)
        (x,), it, done = staging.device_loop([torch.tensor(1.0, dtype=torch.float64)], body, 50)
        assert bool(done) and int(it) == 6 and float(x) == float(ref)
    (x,), it, done = staging.device_loop([torch.tensor(1.0, dtype=torch.float64)], body, 3)
    assert not bool(done) and int(it) == 3
    (x,), it, done = staging.device_loop([torch.tensor(5.0, dtype=torch.float64)], body, 10,
                                         done=torch.tensor(True))
    assert int(it) == 0 and float(x) == 5.0


def test_no_host_reads_forbids_value_reads_and_restores():
    x = torch.tensor([1.0, 2.0])
    with staging.no_host_reads("cpu"):
        for read in (lambda: bool(x[0]), lambda: float(x[0]), lambda: x.sum().item(),
                     lambda: int(x[1]), lambda: x.tolist()):
            with pytest.raises(staging.HostRead):
                read()
        assert staging.read_flag(x[0] > 0)
    assert float(x[1]) == 2.0 and x.tolist() == [1.0, 2.0]


@pytest.mark.parametrize("case", ["rbgs", "jacobi", "fas", "v1_rbgs", "v1_fas"])
def test_staged_cycle_equals_the_eager_cycle_bitwise(case, monkeypatch):
    """The cycle as DenseBackend.wrap stages it on CUDA, here with the CPU
    replay (the kernel wrappers run their plain versions): bit for bit the
    eager cycle, the iterate written back in place."""
    if case.startswith("v1"):
        monkeypatch.setenv("EXA_STREAM_V1", "1")
    kw = dict(solver_useFAS=case.endswith("fas"))
    model_kw = {"smoother": "Jac"} if case == "jacobi" else {}
    ts = PoissonMGSolver(Knowledge(dimensionality=3, minLevel=0, maxLevel=4,
                                   useDblPrecision=False, tpu_compute_dtype="float32",
                                   **kw).update(), device="cpu", **model_kw)
    sol, rhs = ts.init_state()
    want = ts.mg.cycle(sol.clone(), rhs)
    want2 = ts.mg.cycle(want.clone(), rhs)
    st = staging.Staged(ts.mg.cycle, donate=(0,))
    x = sol.clone()
    assert st(x, rhs) is x and torch.equal(x, want)
    assert st(x, rhs) is x and torch.equal(x, want2)
    assert st.stats.captures == 1 and st.stats.replays == 2
    assert st.stats.host_reads == 2  # the coarse CG's loop, once a cycle


def test_staged_solve_fused_binds_once_and_writes_the_iterate_back():
    ts = PoissonMGSolver(Knowledge(dimensionality=3, minLevel=0, maxLevel=3).update(), device="cpu")
    sol, rhs = ts.init_state()
    ref_sol, init, cur, it = ts.mg.solve_jit(sol.clone(), rhs, 1e-10, 100)
    st = staging.Staged(lambda s, r: ts.mg.solve_jit(s, r, 1e-10, 100), donate=(0,))
    x = sol.clone()
    got = st(x, rhs)
    assert got[0] is x and torch.equal(x, ref_sol)
    assert (float(got[1]), float(got[2]), int(got[3])) == (float(init), float(cur), int(it))
    # an unmasked loop: one read per cycle, one more for the exit
    assert st.stats.host_reads == int(it) + 1 + int(it)  # + the CG's, once a cycle


@pytest.mark.parametrize("op", ["+", "-", "*", "/", "<=", ">"])
def test_traced_float_gives_the_python_float_bits(op):
    traced_float_bits(op, "cpu")
