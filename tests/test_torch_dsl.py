"""The port's ExaSlang L4 executor against the JAX package's, on the CPU.

The same program files and Knowledge keywords go through
`exastencils_tpu.dsl` and `exastencils_tpu_torch.dsl`, each package
parsing the program and building the Knowledge with its own front end;
in float64 the two must print the same lines.  The JAX side runs with its fast path off or only plans (never its
Pallas kernels, so no interpret mode); the port's fast path is forced on
the CPU with EXA_FASTPATH_FORCE=1, where the kernel wrappers run their
plain versions.  Also: no jax behind the port's DSL modules, the fast
path's segments, liveness gate, stale-residual rematerialization and
aliasing guard, and carrying a JAX DSL state into the port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from exastencils_tpu.config import Knowledge as JaxKnowledge
from exastencils_tpu.dsl.interpreter import L4Executable as JaxL4
from exastencils_tpu.dsl.parser import parse_l4 as jax_parse_l4

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.dsl.interpreter import L4Executable
from exastencils_tpu_torch.dsl.parser import parse_l4
from exastencils_tpu_torch.interop import dsl_state_from_jax
from exastencils_tpu_torch.ops.cuda import stream3d as s3

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
BENCH = os.path.join(REPO, "examples", "poisson_3d_bench.exa4")
EX2D = os.path.join(REPO, "examples", "poisson_2d.exa4")


def knowledge(which, f64=True, cls=Knowledge, **kw):
    """The port's Knowledge, or with cls=JaxKnowledge the JAX package's,
    from the same keywords."""
    dims = dict(dimensionality=3, minLevel=1, maxLevel=4) if which == "3d" \
        else dict(dimensionality=2, minLevel=0, maxLevel=5)
    return cls(useDblPrecision=f64, tpu_shard_dsl=False, **dims, **kw).update()


def jax_knowledge(which, f64=True, **kw):
    return knowledge(which, f64, JaxKnowledge, **kw)


def run_jax(path, k):
    lines = []
    JaxL4(jax_parse_l4(path), k, out=lines.append).run()
    return lines


def run_port(path, k, device="cpu"):
    lines = []
    ex = L4Executable(parse_l4(path), k, device=device, out=lines.append)
    ex.run()
    return ex, lines


@pytest.fixture(scope="module")
def jax_lines():
    """JAX lines per (example, f64), fast path off (the plain staged path),
    and per (example, "eager"): float32 with staging off."""
    paths = {"3d": BENCH, "2d": EX2D}
    out = {(w, f64): run_jax(paths[w], jax_knowledge(w, f64, tpu_dsl_fastpath=False))
           for w in paths for f64 in (True, False)}
    for w, path in paths.items():
        lines = []
        JaxL4(jax_parse_l4(path), jax_knowledge(w, False, tpu_dsl_fastpath=False),
              out=lines.append, jit_functions=False).run()
        out[(w, "eager")] = lines
    return out


def test_dsl_modules_import_no_jax():
    """Every module of the port, the DSL's included, imports without jax."""
    code = ("import importlib, pkgutil, sys\n"
            "import exastencils_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "assert {p.__name__ + '.dsl.interpreter', p.__name__ + '.dsl.driver',\n"
            "        p.__name__ + '.__main__'} <= set(mods)\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO)


@pytest.mark.parametrize("which,path", [("3d", BENCH), ("2d", EX2D)])
def test_examples_print_the_jax_lines_f64(jax_lines, which, path):
    _, lines = run_port(path, knowledge(which, tpu_dsl_fastpath=False))
    assert lines == jax_lines[(which, True)]
    assert len(lines) >= 8 and int(lines[-1]) >= 6


@pytest.mark.parametrize("which,path", [("3d", BENCH), ("2d", EX2D)])
def test_examples_f32_agree_with_jax(jax_lines, which, path):
    """float32: the same cycle count, and each residual within
    max(1e-5 relative, 2 F) of the JAX line, where F is the largest
    difference between the JAX package's own staged and eager float32
    lines of the program: the float32 floor as the reference measures it.
    Near that floor the residual's rounding error is absolute (set by the
    rounding of an iterate of fixed size), so the lines above it are held
    to 1e-5 relative alone, those at it to 2 F (3D: F 8.6e-4 against a
    last residual of 4.1e-3; 2D: F 2.6e-4 against 2.4e-3)."""
    ex, lines = run_port(path, knowledge(which, f64=False, tpu_dsl_fastpath=False))
    assert ex.state[("U", ex.hi)].dtype == torch.float32
    want, eager = jax_lines[(which, False)], jax_lines[(which, "eager")]
    assert len(lines) == len(want) == len(eager) and lines[-1] == want[-1] == eager[-1]
    floor = max(abs(float(a) - float(b)) for a, b in zip(want[:-1], eager[:-1]))
    assert 0 < floor < 0.5 * min(abs(float(ref)) for ref in want[:-1])
    for got, ref in zip(lines[:-1], want[:-1]):
        assert abs(float(got) - float(ref)) <= max(1e-5 * abs(float(ref)), 2 * floor), \
            (got, ref, floor)


# ----------------------------------------------------------------------
# fast path (EXA_FASTPATH_FORCE=1: kernels' plain versions on the CPU)
# ----------------------------------------------------------------------


@pytest.fixture
def force_fastpath(monkeypatch):
    monkeypatch.setenv("EXA_FASTPATH_FORCE", "1")


def seg_kind(seg):
    names = seg.run.__code__.co_varnames
    return "down" if "_down" in names else "up" if "_up" in names else "smoother"


def plans(ex, src_fn="MGCycle"):
    """{level: [(start, end, kind)]} of the fast path for every leveled
    function body named `src_fn`."""
    out = {}
    for (name, lvl), fn in ex.functions.items():
        if name == src_fn and lvl is not None:
            out[lvl] = [(s.start, s.end, seg_kind(s)) for s in ex._fastpath.plan(fn.body, lvl)]
    return out


def bench_src(liveness_blocked=False):
    src = open(BENCH).read()
    if liveness_blocked:
        # Solve reads Res@finest right after MGCycle, without a CalcRes
        src = src.replace("\t\tMGCycle@finest ( )\n\t\tCalcRes@finest ( )\n\t\tr = ResNorm@finest ( )",
                          "\t\tMGCycle@finest ( )\n\t\tr = ResNorm@finest ( )")
        assert src.count("CalcRes@finest ( )") == 1
    return src


def parse_src(src, tmp_path, parse=parse_l4):
    """`src` parsed by the port's parser (or `parse`) from a file."""
    p = tmp_path / "prog.exa4"
    p.write_text(src)
    return parse(str(p))


@pytest.mark.parametrize("blocked", [False, True])
def test_fastpath_plans_match_jax(force_fastpath, tmp_path, blocked):
    src = bench_src(blocked)
    k = knowledge("3d")
    jax_ex = JaxL4(parse_src(src, tmp_path, jax_parse_l4), jax_knowledge("3d"), out=lambda s: None)
    port = L4Executable(parse_src(src, tmp_path), k, device="cpu", out=lambda s: None)
    want = plans(jax_ex)
    got = plans(port)
    assert got == want
    finest = k.maxLevel
    for lvl in range(k.minLevel + 1, finest + 1):
        kinds = [s[2] for s in got[lvl]]
        if blocked and lvl == finest:
            # the read of Res@finest blocks the down leg: K3 at the finest
            # level instead, up leg still fused
            assert got[lvl][0] == (0, 0, "smoother") and kinds.count("down") == 0
            assert "up" in kinds
        else:
            assert kinds == ["down", "up"], (lvl, got[lvl])


def test_fastpath_prints_the_jax_lines_and_calls_k1_k2(force_fastpath, jax_lines, monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(sol, *a, **kw):
            calls.append((name, sol.shape[0]))
            return fn(sol, *a, **kw)
        monkeypatch.setattr(s3, name, wrapped)

    spy("smooth_res_restrict", s3.smooth_res_restrict)
    spy("prolong_correct_smooth", s3.prolong_correct_smooth)
    spy("rbgs_fused", s3.rbgs_fused)
    ex, lines = run_port(BENCH, knowledge("3d"))
    assert ex._fastpath is not None
    assert lines == jax_lines[("3d", True)]
    cycles = int(lines[-1])
    for name in ("smooth_res_restrict", "prolong_correct_smooth"):
        # one launch per fused level (2..4) and cycle
        assert sorted(n for c, n in calls if c == name) == sorted([5, 9, 17] * cycles)
    assert not [c for c in calls if c[0] == "rbgs_fused"]


def test_fastpath_liveness_blocked_prints_the_plain_lines(force_fastpath, tmp_path, monkeypatch):
    src = bench_src(liveness_blocked=True)
    k3 = []
    fn = s3.rbgs_fused
    monkeypatch.setattr(s3, "rbgs_fused", lambda sol, *a, **kw: k3.append(sol.shape[0]) or fn(sol, *a, **kw))
    fast = L4Executable(parse_src(src, tmp_path), knowledge("3d"), device="cpu", out=[].append)
    fast_lines = []
    fast.out = fast_lines.append
    fast.run()
    assert k3 and set(k3) == {17}
    plain_lines = []
    L4Executable(parse_src(src, tmp_path), knowledge("3d", tpu_dsl_fastpath=False),
                 device="cpu", out=plain_lines.append).run()
    assert fast_lines == plain_lines


@pytest.mark.parametrize("maker,blocked", [("make_fused_legs_3d", False),
                                            ("make_fused_smoother_3d", True)])
def test_kernel_maker_error_raises(force_fastpath, tmp_path, monkeypatch, maker, blocked):
    """No fallback: an error while the fast path builds a segment's kernel
    closures raises out of the run instead of leaving the statements to
    the plain ops."""
    from exastencils_tpu_torch.dsl import fastpath

    def broken(*a, **kw):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(fastpath, maker, broken)
    ex = L4Executable(parse_src(bench_src(blocked), tmp_path), knowledge("3d"),
                      device="cpu", out=lambda s: None)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        ex.run()


def test_stale_residual_rematerializes_on_read(force_fastpath):
    ex = L4Executable(parse_l4(BENCH), knowledge("3d"), device="cpu", out=lambda s: None)
    finest = ex.k.maxLevel
    ex.call_function(ex.functions[("InitF", finest)], finest, [])
    ex.call_function(ex.functions[("MGCycle", finest)], finest, [])
    assert ("Res", finest) in ex._stale, "residual store was not elided"
    res = ex.get_field("Res", finest).clone()
    assert ("Res", finest) not in ex._stale
    plain = L4Executable(parse_l4(BENCH), knowledge("3d", tpu_dsl_fastpath=False),
                         device="cpu", out=lambda s: None)
    plain.set_field("U", finest, ex.get_field("U", finest).clone())
    plain.set_field("F", finest, ex.get_field("F", finest).clone())
    plain.call_function(plain.functions[("CalcRes", finest)], finest, [])
    want = plain.get_field("Res", finest)
    assert torch.allclose(res, want, rtol=1e-12, atol=1e-12)


def test_fused_segments_change_only_their_fields(force_fastpath):
    """The aliasing guard: K1-K3 update the iterate in place, so after
    every fused segment each state entry except the fields the segment
    writes (u@L; for a down leg also the coarse rhs), and every global
    holding a field's tensor, equals its clone from before."""
    ex = L4Executable(parse_l4(BENCH), knowledge("3d"), device="cpu", out=lambda s: None)
    finest = ex.k.maxLevel
    ex.call_function(ex.functions[("InitF", finest)], finest, [])
    # a global holding the finest iterate's tensor itself (shared storage)
    ex.globals["alias"] = ex.state[("U", finest)]
    checked = []
    for (name, lvl), fn in ex.functions.items():
        if name != "MGCycle" or lvl is None:
            continue
        for seg in ex._fastpath.plan(fn.body, lvl):
            run, kind = seg.run, seg_kind(seg)

            def guarded(exe, fr, _run=run, _kind=kind, _lvl=lvl):
                d = dict(zip(_run.__code__.co_varnames[2:], _run.__defaults__))
                writes = {(d["_u"], _lvl)}
                if "_rhs_c" in d:
                    writes.add((d["_rhs_c"], _lvl - 1))
                before = {k: v.clone() for k, v in exe.state.items() if k not in writes}
                alias_before = exe.globals["alias"].clone()
                _run(exe, fr)
                for k, v in before.items():
                    assert torch.equal(exe.state[k], v), (k, _kind, _lvl)
                assert torch.equal(exe.globals["alias"], alias_before)
                checked.append((_kind, _lvl))

            seg.run = guarded
    ex.call_function(ex.functions[("MGCycle", finest)], finest, [])
    assert sorted(set(checked)) == sorted(
        (kind, lvl) for kind in ("down", "up") for lvl in range(2, finest + 1))
    # the shared tensor was cloned before K1 ran, so the update is not
    # visible through the global, which still holds the initial zeros
    assert not torch.equal(ex.globals["alias"], ex.state[("U", finest)])
    assert float(ex.globals["alias"].abs().max()) == 0.0


def test_dsl_state_carried_from_jax(tmp_path):
    """Two JAX cycles, the state carried into the port (slots included),
    then one more cycle in each package: the fields agree within 1e-12."""
    k = jax_knowledge("2d", tpu_dsl_fastpath=False)
    jx = JaxL4(jax_parse_l4(EX2D), k, out=lambda s: None)
    finest = k.maxLevel
    jx.call_function(jx.functions[("InitF", finest)], finest, [])
    cyc = jx.functions[("MGCycle", finest)]
    for _ in range(2):
        jx.call_function(cyc, finest, [])
    port = L4Executable(parse_l4(EX2D), knowledge("2d", tpu_dsl_fastpath=False),
                        device="cpu", out=lambda s: None)
    state = dsl_state_from_jax({key: np.asarray(v) for key, v in jx.state.items()},
                               "cpu", torch.float64)
    assert set(state) == set(jx.state) and state[("U", finest)].shape[0] == 2  # two slots
    port.state.update(state)
    port.slot_index.update(jx.slot_index)
    jx.call_function(cyc, finest, [])
    port.call_function(port.functions[("MGCycle", finest)], finest, [])
    assert port.slot_index == jx.slot_index
    for key, want in jx.state.items():
        want = np.asarray(want)
        got = port.state[key].numpy()
        assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(), 1e-300), key
