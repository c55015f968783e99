"""Language features of the port's L4 executor against the JAX package's.

Small inline programs, each parsed and run by both packages (each with
its own parser and Knowledge) on the CPU in float64,
must print the same lines at 13 significant digits: stencil algebra (products, transpose, scaled
stencils), a sequential sweep whose damping is a function argument,
point-wise `if` inside field loops, `where` conditions, min/max/sum
reductions, integer arithmetic, count loops, slots with `advance`,
matrices and vectors, complex scalars, compensated dot products, local
block solves (collocated and offset unknowns), and cell and face fields
with their bc and transfers.  Also: automatic timers
leave the output alone, the layouts equal the JAX ones, and what the port
does not have yet (field IO builtins, the sharded DSL) raises."""

import pytest
import torch

from exastencils_tpu.config import Knowledge as JaxKnowledge
from exastencils_tpu.dsl.interpreter import L4Executable as JaxL4
from exastencils_tpu.dsl.parser import parse_l4 as jax_parse_l4

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.dsl.interpreter import L4Executable
from exastencils_tpu_torch.dsl.parser import parse_l4

torch.set_num_threads(1)

HEAD = """
Domain global< [0.0, 0.0] to [1.0, 1.0] >

Layout NodeNoComm< Real, Node >@all {
  duplicateLayers = [1, 1]
  ghostLayers     = [0, 0]
}

Field u< global, NodeNoComm, 0.0 >@all
Field w< global, NodeNoComm, 0.0 >@all
Field f< global, NodeNoComm, None >@all
Field s< global, NodeNoComm, 0.0 >[2]@all

Stencil A@all {
  [ 0,  0] =>  4.0
  [-1,  0] => -1.0
  [ 1,  0] => -1.0
  [ 0, -1] => -1.0
  [ 0,  1] => -1.25
}

Stencil A2@all from ( A * A )
Stencil At@all from ( transpose ( 2.0 * A ) )
"""

PROGRAMS = {
    "stencil_algebra": """
Function Application ( ) : Unit {
  loop over u@finest {
    u@finest = vf_nodePos_x + 2.0 * vf_nodePos_y * vf_nodePos_x
  }
  loop over w@finest {
    w@finest = A2@finest * u@finest - 0.5 * ( At@finest * u@finest )
  }
  Var norm : Real = 0.0
  loop over w@finest with reduction ( + : norm ) {
    norm += w@finest * w@finest
  }
  print ( sqrt ( norm ) )
  print ( diag ( A@finest ) )
}
""",
    "seq_sweep_argument": """
Function Sweep@all ( om : Real ) : Unit {
  loop over u@current sequentially {
    u@current += om * ( ( f@current - A@current * u@current ) / diag ( A@current ) )
  }
}

Function Application ( ) : Unit {
  loop over f@finest {
    f@finest = sin ( PI * vf_nodePos_x ) + 1.0
  }
  Sweep@finest ( 1.0 )
  Var n1 : Real = 0.0
  loop over u@finest with reduction ( + : n1 ) { n1 += u@finest * u@finest }
  Sweep@finest ( 0.5 )
  Var n2 : Real = 0.0
  loop over u@finest with reduction ( + : n2 ) { n2 += u@finest * u@finest }
  print ( n1 )
  print ( n2 )
}
""",
    "masks_and_reductions": """
Function Application ( ) : Unit {
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
  loop over w@finest where ( ( i0 + 2 * i1 ) % 3 == 1 ) {
    w@finest = f@finest + 0.5
  }
  Var mx : Real = -1.0e30
  loop over f@finest with reduction ( max : mx ) {
    mx = max ( mx, f@finest )
  }
  Var mn : Real = 1.0e30
  loop over f@finest with reduction ( min : mn ) {
    mn = min ( mn, f@finest )
  }
  Var t : Real = 0.0
  loop over w@finest with reduction ( + : t ) {
    t += w@finest * f@finest
  }
  print ( mx, mn, t )
  Var i : Integer = 7
  print ( i / 2, i % 3, 7.0 / 2, i * 3 - 1 )
  Var acc : Real = 0.0
  repeat 4 times count k {
    acc += k * 0.5
  }
  print ( acc, min ( 3.0, acc ), max ( 1, 2 ) )
  Var it : Integer = 0
  repeat until ( it >= 3 ) {
    it += 1
  }
  print ( it )
}
""",
    "slots": """
Function Application ( ) : Unit {
  loop over s@finest {
    s<active>@finest = vf_nodePos_x
  }
  repeat 3 times {
    loop over s@finest {
      s<next>@finest = s<active>@finest + 0.25 * ( A@finest * s<active>@finest )
    }
    advance s@finest
  }
  Var n : Real = 0.0
  loop over s@finest with reduction ( + : n ) {
    n += s<active>@finest * s<previous>@finest
  }
  print ( n )
}
""",
    "matrices": """
Function Application ( ) : Unit {
  Var m : Matrix<Real, 2, 2> = { { 1.0, 2.0 }, { 3.0, 5.0 } }
  Var v : ColumnVector<Real, 2> = { 1.0, -1.0 }
  Var x : ColumnVector<Real, 2> = m * v
  print ( x )
  print ( det ( m ) )
  print ( inverse ( m ) )
  print ( transpose ( m ) )
  print ( dotProduct ( v, x ) )
  print ( trace ( m ) )
  print ( m[1][0] )
  m[0][1] = 7.0
  print ( m )
  print ( m * m + 2.0 * m )
}
""",
    "complex": """
Function Application ( ) : Unit {
  Var z : Complex = 1.5 + 2.0j
  Var y : Complex = ( 0.5 )j
  print ( z * y + z )
  print ( Re ( z ), Im ( z ) )
  print ( norm ( z ) )
}
""",
    "compensated_dot": """
Function Application ( ) : Unit {
  loop over u@finest {
    u@finest = 1.0 / ( 1.0 + vf_nodePos_x * 10.0 + vf_nodePos_y )
  }
  print ( dot ( u@finest, u@finest, "kahan" ) )
  print ( dot ( u@finest, u@finest, "neumaier" ) )
  print ( dot ( u@finest, u@finest ) )
}
""",
    "solve_locally": """
Function Application ( ) : Unit {
  loop over f@finest {
    f@finest = sin ( PI * vf_nodePos_x ) + vf_nodePos_y
  }
  repeat 2 times {
    loop over u@finest {
      solve locally relax 0.9 {
        u@finest => A@finest * u@finest + 0.5 * w@finest == f@finest
        w@finest => 2.0 * w@finest - 0.25 * u@finest == 1.0
      }
    }
  }
  loop over u@finest stepping [ 2, 1 ] {
    solve locally {
      u@finest@[0, 0] => A@finest * u@finest@[0, 0] == f@finest@[0, 0]
      u@finest@[1, 0] => A@finest * u@finest@[1, 0] == f@finest@[1, 0]
    }
  }
  print ( dot ( u@finest, u@finest ), dot ( w@finest, w@finest ) )
}
""",
    "cell_and_face_fields": """
Layout CellL< Real, Cell >@all {
  duplicateLayers = [0, 0]
  ghostLayers     = [1, 1]
}

Layout FaceXL< Real, Face_x >@all {
  duplicateLayers = [1, 0]
  ghostLayers     = [1, 1]
}

Field c< global, CellL, 1.0 >@all
Field cn< global, CellL, Neumann >@all
Field fx< global, FaceXL, sin ( PI * vf_boundaryPos_y ) >@all

Stencil Rc from default restriction on Cell with "linear"
Stencil Pc from default prolongation on Cell with "linear"
Stencil Rf from default restriction on Face_x with "integral_linear"

Function Transfer@finest {
  loop over c@coarser {
    c@coarser = Rc@current * c@current
  }
  loop over cn@current {
    cn@current += Pc@current * c@coarser
  }
  loop over fx@coarser {
    fx@coarser = Rf@current * fx@current
  }
}

Function Application ( ) : Unit {
  loop over c@finest {
    c@finest = vf_cellCenter_x * vf_cellCenter_y
  }
  loop over cn@finest {
    cn@finest = vf_cellCenter_x + 0.5
  }
  Var a : Real = 0.0
  loop over c@finest with reduction ( + : a ) {
    a += ( A@finest * c@finest ) * ( A@finest * cn@finest )
  }
  print ( a )
  loop over fx@finest {
    fx@finest = vf_nodePos_x * vf_cellCenter_y
  }
  apply bc to fx@finest
  print ( dot ( fx@finest, fx@finest ) )
  Transfer@finest ( )
  print ( dot ( cn@finest, cn@finest ), dot ( fx@(finest - 1), fx@(finest - 1) ) )
}
""",
}


def knowledge(cls=Knowledge):
    return cls(dimensionality=2, minLevel=0, maxLevel=4, testing_enabled=True,
               tpu_shard_dsl=False).update()


def precise(src):
    """The program printing at 13 significant digits (the reference's
    std::cout.precision emulation), so the comparison is close to bitwise."""
    return src.replace("Function Application ( ) : Unit {",
                       'Function Application ( ) : Unit {\n  native ( "std::cout.precision(13)" )', 1)


def run_jax(src):
    lines = []
    JaxL4(jax_parse_l4(HEAD + precise(src)), knowledge(JaxKnowledge), out=lines.append).run()
    return lines


def run_port(src):
    lines = []
    L4Executable(parse_l4(HEAD + precise(src)), knowledge(), device="cpu", out=lines.append).run()
    return lines


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_prints_the_jax_lines(name):
    want = run_jax(PROGRAMS[name])
    got = run_port(PROGRAMS[name])
    assert got == want
    assert got


@pytest.mark.parametrize("call", ['writeField ( "x.txt", u@finest )',
                                  'printField ( "x.txt", u@finest )',
                                  'printVtk ( "x.vtk", u@finest )',
                                  'readField ( "x.txt", u@finest )'])
def test_io_builtins_raise_not_implemented(call):
    src = "Function Application ( ) : Unit {\n  " + call + "\n}\n"
    ex = L4Executable(parse_l4(HEAD + src), knowledge(), device="cpu", out=lambda s: None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ex.run()


def test_sharded_configuration_raises_not_implemented():
    k = Knowledge(dimensionality=2, minLevel=0, maxLevel=4, tpu_mesh_shape=[2, 1],
                  tpu_shard_dsl=True).update()
    src = "Function Application ( ) : Unit {\n  print ( 1 )\n}\n"
    with pytest.raises(NotImplementedError, match="sharded DSL"):
        L4Executable(parse_l4(HEAD + src), k, device="cpu", out=lambda s: None)


def test_automatic_timers_do_not_change_output():
    """timer_automatic*Timing instrument communicate / apply bc with
    autoTime_<CATEGORY>@level timers (runtime/timers.py) and leave the
    printed lines as they are."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                        "examples", "poisson_2d.exa4")

    def run_2d(**flags):
        k = Knowledge(dimensionality=2, minLevel=1, maxLevel=4, tpu_shard_dsl=False,
                      **flags).update()
        lines = []
        ex = L4Executable(parse_l4(path), k, device="cpu", out=lines.append)
        ex.run()
        return lines, ex.timers

    base, _ = run_2d()
    lines, timers = run_2d(timer_automaticCommTiming=True, timer_automaticBCsTiming=True)
    assert lines == base
    names = set(timers.timers)
    assert any(n.startswith("autoTime_COMM@") for n in names), names
    assert any(n.startswith("autoTime_APPLYBC@") for n in names), names
    assert all(t.num_measurements > 0 and t.num_entries == 0 for t in timers.timers.values())


def test_layout_matches_jax():
    from exastencils_tpu.core import layout as jl

    from exastencils_tpu_torch.core import layout as tl

    for loc in ("Node", "Cell", "Face_x", "Face_y"):
        got = tl.fragment_layout("f", loc, (8, 4), ghost=2)
        want = jl.fragment_layout("f", loc, (8, 4), ghost=2)
        assert got.shape == want.shape
        for d in range(2):
            for ident in ("PLB", "GLB", "DLB", "IB", "IE", "DRE", "GRE", "TOT"):
                assert got.idx(ident, d) == want.idx(ident, d)
            for lo in (False, True):
                assert got.owned_slice(d, lo) == want.owned_slice(d, lo)
