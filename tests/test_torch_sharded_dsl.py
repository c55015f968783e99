"""The port's sharded DSL (dsl/interp_fragments over parallel/dslsharding
and parallel/topology.FragmentWindows) on SPMD ranks against the JAX
package's sharded DSL.

One world of 8 spawned CPU ranks over gloo serves the file: each case runs
on the first prod(mesh) ranks (a subgroup), in float64 with
`testing_enabled`, and returns rank 0's printed lines, the listed fields
gathered whole, the placement and the exchange counts.  The JAX side runs
in this process, each program on a jax Mesh of the same shape over the
conftest's virtual devices (as exastencils_tpu/parallel/dryrun.py builds
it).  Lines must agree token by token by the dry run's rule (abs 1e-6 or
rel 1e-9), fields within 1e-10 of the JAX arrays (relative to their
largest entry), truncated to the true grid.  The module imports jax only
inside the functions that need it: the ranks import this module to run
`dsl_rank` and must import neither jax nor the JAX package."""

import functools
import math
import os
import pathlib
import sys

import numpy as np
import pytest
import torch.distributed as dist

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.dsl.interpreter import L4Executable
from exastencils_tpu_torch.dsl.parser import parse_l4
from exastencils_tpu_torch.parallel.dslsharding import build_dsl_mesh
from exastencils_tpu_torch.parallel.mesh import run_ranks

REPO = pathlib.Path(__file__).resolve().parent.parent
EX2D = (REPO / "examples" / "poisson_2d.exa4").read_text()
EX3D = (REPO / "examples" / "poisson_3d_bench.exa4").read_text()

HEAD = """
Domain global< [0.0, 0.0] to [1.0, 1.0] >

Layout NodeNoComm< Real, Node >@all {
  duplicateLayers = [1, 1]
  ghostLayers     = [0, 0]
}

Layout NodeComm< Real, Node >@all {
  duplicateLayers = [1, 1] with communication
  ghostLayers     = [1, 1] with communication
}

Field u< global, NodeComm, 0.0 >@all
Field w< global, NodeNoComm, 0.0 >@all
Field f< global, NodeNoComm, None >@all

Stencil A@all {
  [ 0,  0] =>  4.0
  [-1,  0] => -1.0
  [ 1,  0] => -1.0
  [ 0, -1] => -1.0
  [ 0,  1] => -1.25
}
"""

PRECISE = 'native ( "std::cout.precision(13)" )'

SEQ = HEAD + """
Function Sweep@all ( om : Real ) : Unit {
  communicate u@current
  loop over u@current sequentially {
    u@current += om * ( ( f@current - A@current * u@current ) / diag ( A@current ) )
  }
}

Function Application ( ) : Unit {
  %s
  loop over f@finest {
    f@finest = sin ( PI * vf_nodePos_x ) + vf_nodePos_y
  }
  repeat 3 times {
    Sweep@finest ( 1.0 )
  }
  Var n1 : Real = 0.0
  loop over u@finest with reduction ( + : n1 ) {
    n1 += u@finest * u@finest
  }
  print ( n1 )
}
""" % PRECISE

CELL = """
Domain global< [0.0, 0.0] to [1.0, 1.0] >

Layout CellL< Real, Cell >@all {
  duplicateLayers = [0, 0]
  ghostLayers     = [1, 1]
}

Field c< global, CellL, sin ( PI * vf_boundaryPos_x ) + 1.0 >@all
Field cn< global, CellL, Neumann >@all
Field g< global, CellL, None >@all

Stencil Ac@all {
  [ 0,  0] =>  4.0
  [-1,  0] => -1.0
  [ 1,  0] => -1.0
  [ 0, -1] => -1.0
  [ 0,  1] => -1.0
}

Stencil Rc from default restriction on Cell with "linear"
Stencil Pc from default prolongation on Cell with "linear"

Function Smooth@all {
  repeat 4 times {
    communicate c@current
    loop over c@current {
      c@current += 0.2 * ( g@current - Ac@current * c@current )
    }
  }
}

Function Down@((coarsest + 1) to finest) {
  communicate c@current
  loop over c@coarser {
    c@coarser = Rc@current * c@current
  }
  Down@coarser ( )
}

Function Down@coarsest {
  Var z : Real = 0.0
}

Function Up@((coarsest + 1) to finest) {
  Up@coarser ( )
  loop over cn@current {
    cn@current += Pc@current * c@coarser
  }
}

Function Up@coarsest {
  Var z : Real = 0.0
}

Function Application ( ) : Unit {
  %s
  loop over g@finest {
    g@finest = vf_cellCenter_x * vf_cellCenter_y
  }
  Smooth@finest ( )
  Down@finest ( )
  Up@finest ( )
  Var a : Real = 0.0
  loop over c@finest with reduction ( + : a ) {
    a += ( Ac@finest * c@finest ) * ( Ac@finest * cn@finest )
  }
  print ( a )
  print ( dot ( cn@finest, cn@finest ) )
}
""" % PRECISE

REDUCTIONS = HEAD + """
Function Application ( ) : Unit {
  %s
  loop over u@finest {
    u@finest = sin ( PI * vf_nodePos_x ) * cos ( PI * vf_nodePos_y )
  }
  loop over f@finest {
    if ( u@finest > 0.1 ) {
      f@finest = 2.0 * u@finest
    } else {
      f@finest = -1.0 - u@finest
    }
  }
  loop over w@finest where ( ( i0 + 2 * i1 ) %% 3 == 1 ) {
    w@finest = ( A@finest * f@finest ) + 0.5
  }
  Var mx : Real = -1.0e30
  loop over f@finest with reduction ( max : mx ) {
    mx = max ( mx, f@finest )
  }
  Var mn : Real = 1.0e30
  loop over f@finest with reduction ( min : mn ) {
    mn = min ( mn, f@finest )
  }
  Var mxn : Real = 0.0
  loop over w@finest with reduction ( max : mxn ) {
    mxn = max ( mxn, fabs ( w@finest ) )
  }
  Var t : Real = 0.0
  loop over w@finest with reduction ( + : t ) {
    t += w@finest * f@finest
  }
  print ( mx, mn, mxn, t )
  print ( dot ( u@finest, w@finest ), norm ( w@finest ), dot ( w@finest, w@finest, "kahan" ) )
}
""" % PRECISE

RANDOM_IO = HEAD + """
Function Application ( ) : Unit {
  %s
  loop over u@finest sequentially {
    u@finest = native ( "((double)std::rand()/RAND_MAX)" )
  }
  writeField ( "DIR/u.txt", u@finest )
  readField ( "DIR/u.txt", w@finest )
  print ( dot ( w@finest, w@finest ) )
  loop over f@finest {
    f@finest = A@finest * w@finest
  }
  print ( dot ( f@finest, f@finest ) )
}
""" % PRECISE

STAGGERED = """
Domain global< [0.0, 0.0] to [1.0, 1.0] >

Layout FaceXL< Real, Face_x >@all {
  duplicateLayers = [1, 0]
  ghostLayers     = [1, 1]
}

Field fx< global, FaceXL, sin ( PI * vf_boundaryPos_y ) >@all

Stencil Rf from default restriction on Face_x with "integral_linear"

Function Application ( ) : Unit {
  %s
  loop over fx@finest {
    fx@finest = vf_nodePos_x * vf_cellCenter_y
  }
  apply bc to fx@finest
  loop over fx@(finest - 1) {
    fx@(finest - 1) = Rf@finest * fx@finest
  }
  print ( dot ( fx@finest, fx@finest ), dot ( fx@(finest - 1), fx@(finest - 1) ) )
}
""" % PRECISE

# name -> program, dims, levels, mesh, extra Knowledge, fields to compare
CASES = {
    "poisson_3d_2x2x2": dict(src=EX3D, nd=3, levels=(1, 5), mesh=(2, 2, 2),
                             fields=[("U", 5), ("U", 4)]),
    "poisson_2d_4x2": dict(src=EX2D, nd=2, levels=(0, 5), mesh=(4, 2), fields=[("U", 5)]),
    "poisson_2d_2x2": dict(src=EX2D, nd=2, levels=(0, 5), mesh=(2, 2),
                           fields=[("U", 5), ("U", 3), ("F", 2)]),
    "poisson_2d_staged": dict(src=EX2D, nd=2, levels=(0, 5), mesh=(2, 2), jit=True,
                              fields=[("U", 5), ("U", 3), ("F", 2)]),
    "poisson_2d_3x1": dict(src=EX2D, nd=2, levels=(0, 5), mesh=(3, 1), fields=[("U", 5)]),
    "seq_frags_2x2": dict(src=SEQ, nd=2, levels=(0, 4), mesh=None, fields=[("u", 4)],
                          flags={"domain_rect_numFragsPerBlock_x": 2,
                                 "domain_rect_numFragsPerBlock_y": 2}),
    "seq_one_frag_2x1": dict(src=SEQ, nd=2, levels=(0, 4), mesh=(2, 1), fields=[("u", 4)]),
    "cell_dirichlet": dict(src=CELL, nd=2, levels=(1, 5), mesh=(2, 2),
                           fields=[("c", 5), ("cn", 5), ("c", 2)]),
    "reductions": dict(src=REDUCTIONS, nd=2, levels=(0, 4), mesh=(2, 2),
                       fields=[("w", 4), ("f", 4)]),
    "random_io": dict(src=RANDOM_IO, nd=2, levels=(0, 4), mesh=(2, 2),
                      fields=[("u", 4), ("w", 4)], io=True),
    "staggered": dict(src=STAGGERED, nd=2, levels=(0, 4), mesh=(2, 2),
                      fields=[("fx", 4), ("fx", 3)]),
}
JAX_TWIN = {"poisson_2d_staged": "poisson_2d_2x2"}  # same program and mesh


def mesh_shape(case):
    if case["mesh"]:
        return tuple(case["mesh"])
    flags = case.get("flags", {})
    return tuple(flags.get(f"domain_rect_numFragsPerBlock_{'xyz'[d]}", 1)
                 for d in range(case["nd"]))


def knowledge(case, cls=Knowledge):
    lo, hi = case["levels"]
    k = cls(dimensionality=case["nd"], minLevel=lo, maxLevel=hi, testing_enabled=True,
            tpu_coarse_replicate_threshold=4, **case.get("flags", {}))
    if case["mesh"]:
        k.tpu_mesh_shape = tuple(case["mesh"])
    return k.update()


def source(case, where):
    return case["src"].replace("DIR", str(where))


def _run_case(device, name, case, group, tmp):
    k = knowledge(case)
    mesh = build_dsl_mesh(k, case["nd"], group=group)
    lines = []
    where = pathlib.Path(tmp) / f"port_{name}"
    if case.get("io") and dist.get_rank(group) == 0:
        where.mkdir()
    dist.barrier(group=group)
    ex = L4Executable(parse_l4(source(case, where)), k, device=device, out=lines.append,
                      mesh=mesh, jit_functions=case.get("jit"))
    ex.run()
    fields = {f"{f}@{lvl}": ex.whole_field(f, lvl).cpu().numpy() for f, lvl in case["fields"]}
    out = {"lines": lines, "fields": fields, "mesh": mesh.shape, "sharded": ex.frag is not None,
           "staging": ex.staging_stats()}
    if ex.frag is not None:
        st = ex.frag.stats
        out["stats"] = {"communicate": st.communicate, "implicit": st.implicit,
                        "calls": st.calls, "gathers": st.gathers,
                        "seq_gathered": st.seq_gathered}
        lo, hi = case["levels"]
        out["placement"] = {lvl: (ex._window(lvl, "Node").sharded, ex._window(lvl, "Node").shape,
                                  ex._window(lvl, "Cell").sharded)
                            for lvl in range(lo, hi + 1)}
    if case.get("io"):
        out["files"] = {p.name: p.read_bytes() for p in sorted(where.iterdir())}
    return out


def dsl_rank(device, tmp):
    """One rank's share of every case, by name (a case on n ranks runs on
    ranks 0..n-1 over a subgroup; the groups are made by all ranks)."""
    groups = {n: dist.new_group(list(range(n))) for n in (2, 3, 4)}
    groups[8] = None
    out = {}
    for name, case in CASES.items():
        n = math.prod(mesh_shape(case))
        if dist.get_rank() < n:
            out[name] = _run_case(device, name, case, groups[n], tmp)
    out["imported"] = sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "exastencils_tpu"))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_dsl")
    return tmp, run_ranks(dsl_rank, 8, str(tmp), device="cpu")


@functools.lru_cache(maxsize=None)
def run_jax(name, tmp):
    """The case in the JAX package on a Mesh of the case's shape."""
    import jax
    from jax.sharding import Mesh

    from exastencils_tpu.config import Knowledge as JaxKnowledge
    from exastencils_tpu.dsl.interpreter import L4Executable as JaxL4
    from exastencils_tpu.dsl.parser import parse_l4 as jax_parse_l4

    case = CASES[name]
    shape = mesh_shape(case)
    n = math.prod(shape)
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("bx", "by", "bz")[:case["nd"]])
    where = pathlib.Path(tmp) / f"jax_{name}"
    if case.get("io"):
        where.mkdir()
    lines = []
    ex = JaxL4(jax_parse_l4(source(case, where)), knowledge(case, JaxKnowledge),
               out=lines.append, mesh=mesh)
    ex.run()
    fields = {}
    for f, lvl in case["fields"]:
        true = ex.true_shape(f, lvl)
        fields[f"{f}@{lvl}"] = np.asarray(ex.get_field(f, lvl))[
            tuple(slice(0, t) for t in true)]
    files = {}
    if case.get("io"):
        # the JAX sharded run writes its padded storage (a zero tail to a
        # multiple of the mesh); the dense run writes the true grid, as
        # the port's sharded run does
        dense = pathlib.Path(tmp) / f"jax_dense_{name}"
        dense.mkdir()
        k = knowledge(case, JaxKnowledge)
        k.tpu_shard_dsl = False
        JaxL4(jax_parse_l4(source(case, dense)), k, out=lambda s: None).run()
        files = {p.name: p.read_bytes() for p in sorted(dense.iterdir())}
    return {"lines": lines, "fields": fields, "files": files}


def _token_ok(a, b):
    if a == b:
        return True
    try:
        fa, fb = float(a), float(b)
    except ValueError:
        return False
    # the dry run's rule (exastencils_tpu/parallel/dryrun.py:106-116)
    return abs(fa - fb) <= 1e-6 or abs(fa - fb) <= 1e-9 * max(abs(fa), abs(fb))


def lines_agree(got, want):
    return len(got) == len(want) and all(
        len(g.split()) == len(w.split()) and all(map(_token_ok, g.split(), w.split()))
        for g, w in zip(got, want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_lines_are_the_jax_sharded_lines(world, name):
    tmp, results = world
    want = run_jax(JAX_TWIN.get(name, name), str(tmp))["lines"]
    got = results[0][name]["lines"]
    assert got and lines_agree(got, want), (got, want)
    n = math.prod(mesh_shape(CASES[name]))
    assert all(r[name]["lines"] == [] for r in results[1:n])  # rank 0 prints


@pytest.mark.parametrize("name", sorted(CASES))
def test_gathered_fields_match_jax(world, name):
    tmp, results = world
    want = run_jax(JAX_TWIN.get(name, name), str(tmp))["fields"]
    n = math.prod(mesh_shape(CASES[name]))
    for key, ref in want.items():
        for r in results[:n]:
            got = r[name]["fields"][key]
            assert got.shape == ref.shape, key
            scale = max(float(np.abs(ref).max()), 1e-300)
            assert float(np.abs(got - ref).max()) <= 1e-10 * scale, key


def test_placement_follows_the_threshold(world):
    """Levels 3-5 of the 2D example are sharded on 2x2 (the JAX
    field_spec with threshold 4), 0-2 held whole; on 4x2 level 3 is
    sharded along y only; on 3x1 the fragments are unequal."""
    _, results = world
    pl = results[0]["poisson_2d_2x2"]["placement"]
    assert [lvl for lvl, p in pl.items() if any(p[0])] == [3, 4, 5]
    assert pl[2][1] == (5, 5) and pl[5][1] == (17, 17)  # 16 owned + a ghost
    assert results[0]["poisson_2d_4x2"]["placement"][3][0] == (False, True)
    shapes = [r["poisson_2d_3x1"]["placement"][5][1][0] for r in results[:3]]
    assert shapes == [11, 12, 14]  # runs of 10, 10, 13 nodes and their ghosts
    pl3 = results[0]["poisson_3d_2x2x2"]["placement"]
    assert [lvl for lvl, p in pl3.items() if all(p[0])] == [3, 4, 5]


def test_exchanges_are_counted_apart(world):
    """The examples communicate before every offset read (no implicit
    exchange); the reduction and cell programs read fields written since
    their last exchange, which the executor exchanges itself."""
    _, results = world
    for name in ("poisson_2d_2x2", "poisson_3d_2x2x2"):
        st = results[0][name]["stats"]
        assert st["communicate"] > 0 and st["implicit"] == 0, (name, st)
    for name in ("reductions", "cell_dirichlet"):
        st = results[0][name]["stats"]
        assert st["implicit"] > 0, (name, st)
        assert st["calls"] == st["communicate"] + st["implicit"]


def test_sequential_sweeps_run_locally_or_gathered(world):
    """Rank borders on reference fragment borders: each rank sweeps its
    window; one fragment over 2x1 ranks: the sweep runs on the gathered
    field (exact)."""
    _, results = world
    assert results[0]["seq_frags_2x2"]["stats"]["seq_gathered"] == 0
    assert results[0]["seq_frags_2x2"]["mesh"] == (2, 2)
    assert results[0]["seq_one_frag_2x1"]["stats"]["seq_gathered"] == 3


def test_field_io_writes_the_dense_jax_bytes(world):
    tmp, results = world
    want = run_jax("random_io", str(tmp))["files"]
    assert want and results[0]["random_io"]["files"] == want


def test_staggered_program_runs_dense_on_every_rank(world):
    _, results = world
    assert [r["staggered"]["sharded"] for r in results[:4]] == [False] * 4


def test_staged_run_stays_eager_and_is_counted(world):
    _, results = world
    staging = results[0]["poisson_2d_staged"]["staging"]
    assert staging["unstaged"] > 0 and staging["captures"] == 0
    assert all("sharded run" in why for why in staging["unstaged_runs"].values())
    assert results[0]["poisson_2d_staged"]["lines"] == results[0]["poisson_2d_2x2"]["lines"]


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    _, results = world
    assert [r["imported"] for r in results] == [[]] * 8


def test_dryrun_runs_both_halves():
    from exastencils_tpu_torch.parallel.dryrun import run_dryrun

    out = run_dryrun(4, device="cpu")
    assert out["dsl"]["mesh"] == (2, 2) and out["dsl"]["sharded_instances"] > 0
    assert out["dsl"]["res_last"] < 1e-4 * out["dsl"]["res_first"]
    assert out["rel"] <= 1e-5


def test_cli_under_torchrun(tmp_path):
    """`torchrun --nproc-per-node 2 -m exastencils_tpu_torch --cpu --f64`
    over 2 x 1 fragments: the ranks join torchrun's group, rank 0 prints
    the lines of the one-process (dense) run once and passes --check
    against them."""
    import subprocess

    settings, knowledge = tmp_path / "p.settings", tmp_path / "p.knowledge"
    settings.write_text(f'l4file = "{REPO / "examples" / "poisson_2d.exa4"}"\n')
    knowledge.write_text("dimensionality = 2\nminLevel = 0\nmaxLevel = 5\n"
                         "domain_rect_numFragsPerBlock_x = 2\n"
                         "tpu_coarse_replicate_threshold = 4\n")
    cli = ["-m", "exastencils_tpu_torch", "--cpu", "--f64", str(settings), str(knowledge)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    dense = subprocess.run([sys.executable] + cli, capture_output=True, text=True, cwd=REPO,
                           env=env, timeout=300)
    assert dense.returncode == 0, dense.stderr
    (tmp_path / "dense.out").write_text(dense.stdout)
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2"] + cli + ["--check", str(tmp_path / "dense.out")],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr[-3000:]
    out = run.stdout.splitlines()
    assert out[:-1] == dense.stdout.splitlines() and out[-1].startswith("CHECK OK")
