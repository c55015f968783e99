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

import chip_smoke

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

# `solve locally` on offset unknowns: blocks anchored in the ghost layers
# write owned points (tests/test_torch_dsl_features.py's program)
SOLVE_LOCALLY = HEAD + """
Function Application ( ) : Unit {
  %s
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
""" % PRECISE

# two block smoothers, each reading the other's field at offset 0 only: a
# ghost anchor's block reads that field on a ghost point, so the executor
# exchanges it although no access has an offset
SOLVE_COUPLED = HEAD + """
Function Application ( ) : Unit {
  %s
  loop over f@finest {
    f@finest = sin ( PI * vf_nodePos_x ) + vf_nodePos_y
  }
  repeat 3 times {
    loop over u@finest stepping [ 2, 1 ] {
      solve locally relax 0.9 {
        u@finest@[0, 0] => A@finest * u@finest@[0, 0] + 0.5 * w@finest@[0, 0] == f@finest@[0, 0]
        u@finest@[1, 0] => A@finest * u@finest@[1, 0] == f@finest@[1, 0]
      }
    }
    loop over w@finest stepping [ 1, 2 ] {
      solve locally {
        w@finest@[0, 0] => 2.0 * w@finest@[0, 0] - 0.25 * w@finest@[0, 1] == u@finest@[0, 0]
        w@finest@[0, 1] => 2.0 * w@finest@[0, 1] - 0.25 * w@finest@[0, 0] == 1.0
      }
    }
  }
  print ( dot ( u@finest, u@finest ), dot ( w@finest, w@finest ) )
}
""" % PRECISE

# complex 2-point blocks (the dense executor's complex per-point systems)
SOLVE_COMPLEX = HEAD + """
Layout NodeCx< Complex, Node >@all {
  duplicateLayers = [1, 1] with communication
  ghostLayers     = [1, 1] with communication
}

Field z< global, NodeCx, 0.0 >@all
Field fz< global, NodeCx, None >@all

Function Application ( ) : Unit {
  %s
  loop over fz@finest {
    fz@finest = vf_nodePos_x + ( 0.5 )j * sin ( PI * vf_nodePos_y )
  }
  repeat 2 times {
    loop over z@finest stepping [ 2, 1 ] {
      solve locally relax 0.9 {
        z@finest@[0, 0] => A@finest * z@finest@[0, 0] + ( 0.3 )j * z@finest@[0, 0] == fz@finest@[0, 0]
        z@finest@[1, 0] => A@finest * z@finest@[1, 0] == fz@finest@[1, 0]
      }
    }
  }
  Var s : Real = 0.0
  loop over z@finest with reduction ( + : s ) {
    s += abs ( z@finest ) * abs ( z@finest )
  }
  print ( s )
}
""" % PRECISE

# 7-point Poisson, 2-point x-blocks (the Vanka-style block smoother)
SOLVE_LOCALLY_3D = """
Domain global< [0.0, 0.0, 0.0] to [1.0, 1.0, 1.0] >

Layout NodeNoComm< Real, Node >@all {
  duplicateLayers = [1, 1, 1]
  ghostLayers     = [0, 0, 0]
}

Layout NodeComm< Real, Node >@all {
  duplicateLayers = [1, 1, 1] with communication
  ghostLayers     = [1, 1, 1] with communication
}

Field u< global, NodeComm, 0.0 >@all
Field f< global, NodeNoComm, None >@all

Stencil A@all {
  [ 0,  0,  0] =>  6.0
  [-1,  0,  0] => -1.0
  [ 1,  0,  0] => -1.0
  [ 0, -1,  0] => -1.0
  [ 0,  1,  0] => -1.0
  [ 0,  0, -1] => -1.0
  [ 0,  0,  1] => -1.0
}

Function Application ( ) : Unit {
  %s
  loop over f@finest {
    f@finest = sin ( PI * vf_nodePos_x ) * vf_nodePos_y + vf_nodePos_z
  }
  repeat 3 times {
    communicate u@finest
    loop over u@finest stepping [ 2, 1, 1 ] {
      solve locally relax 0.8 {
        u@finest@[0, 0, 0] => A@finest * u@finest@[0, 0, 0] == f@finest@[0, 0, 0]
        u@finest@[1, 0, 0] => A@finest * u@finest@[1, 0, 0] == f@finest@[1, 0, 0]
      }
    }
  }
  print ( dot ( u@finest, u@finest ) )
}
""" % PRECISE

# SEQ with the stretched grid's per-cell widths in its rhs
SEQ_WIDTH = SEQ.replace("f@finest = sin ( PI * vf_nodePos_x ) + vf_nodePos_y",
                        "f@finest = sin ( PI * vf_nodePos_x ) + vf_nodePos_y * vf_gridWidth_x")
LINEAR_FCT = chip_smoke.LINEAR_FCT

CELL_HEAD = HEAD + """
Layout CellL< Real, Cell >@all {
  duplicateLayers = [0, 0]
  ghostLayers     = [1, 1]
}

Field c< global, CellL, 1.0 >@all
Field g< global, CellL, None >@all

Stencil Ac@all {
  [ 0,  0] =>  4.0
  [-1,  0] => -1.0
  [ 1,  0] => -1.0
  [ 0, -1] => -1.0
  [ 0,  1] => -1.0
}

Stencil Rn from default restriction on Node with "linear"
Stencil Rc from default restriction on Cell with "linear"
"""

# node and cell fields on one level, where the threshold would split the
# nodes but not the cells (9 nodes, 8 cells over 3 ranks, threshold 3)
MIXED = CELL_HEAD + """
Function Application ( ) : Unit {
  %s
  loop over u@finest {
    u@finest = sin ( PI * vf_nodePos_x ) * vf_nodePos_y + vf_cellCenter_x
  }
  loop over c@finest {
    c@finest = vf_cellCenter_x * vf_cellCenter_y + vf_nodePos_y
  }
  repeat 2 times {
    communicate u@finest
    loop over w@finest {
      w@finest = A@finest * u@finest
    }
    loop over u@finest {
      u@finest += 0.1 * w@finest
    }
    communicate c@finest
    loop over g@finest {
      g@finest = Ac@finest * c@finest
    }
    loop over c@finest {
      c@finest += 0.1 * g@finest
    }
  }
  communicate u@finest
  loop over u@(finest - 1) {
    u@(finest - 1) = Rn@finest * u@finest
  }
  communicate c@finest
  loop over c@(finest - 1) {
    c@(finest - 1) = Rc@finest * c@finest
  }
  Var a : Real = 0.0
  loop over c@(finest - 1) with reduction ( + : a ) {
    a += c@(finest - 1) * vf_cellCenter_x
  }
  print ( dot ( u@finest, u@finest ), dot ( c@finest, c@finest ), a )
  print ( dot ( u@(finest - 1), u@(finest - 1) ), dot ( c@(finest - 1), c@(finest - 1) ) )
}
""" % PRECISE

# a radius-2 (fourth-order) stencil on levels whose ranks hold fewer
# points than its two ghost layers (threshold 1, 4 ranks along x)
WIDE = HEAD + """
Stencil B@all {
  [ 0,  0] =>  5.0
  [-1,  0] => -1.333
  [ 1,  0] => -1.333
  [-2,  0] =>  0.0833
  [ 2,  0] =>  0.0833
  [ 0, -1] => -1.333
  [ 0,  1] => -1.333
  [ 0, -2] =>  0.0833
  [ 0,  2] =>  0.0833
}

Function Smooth@all {
  repeat 3 times {
    communicate u@current
    loop over w@current {
      w@current = f@current - B@current * u@current
    }
    loop over u@current {
      u@current += 0.15 * w@current
    }
  }
}

Function Application ( ) : Unit {
  %s
  loop over f@finest {
    f@finest = sin ( PI * vf_nodePos_x ) + vf_nodePos_y
  }
  loop over f@(finest - 1) {
    f@(finest - 1) = vf_nodePos_x * vf_nodePos_y
  }
  loop over f@(finest - 2) {
    f@(finest - 2) = vf_nodePos_x + vf_nodePos_y
  }
  Smooth@finest ( )
  Smooth@(finest - 1) ( )
  Smooth@(finest - 2) ( )
  print ( dot ( u@finest, u@finest ), dot ( u@(finest - 1), u@(finest - 1) ), dot ( u@(finest - 2), u@(finest - 2) ) )
}
""" % PRECISE

# the product of a field-valued stencil with itself: radius 2 from the
# declared offsets, its coefficients shifted across rank borders
FIELD_STENCIL = HEAD + """
Field kap< global, NodeNoComm, None >@all

Stencil K@all {
  [ 0,  0] =>  4.0 * ( kap@current )
  [-1,  0] => -1.0 * ( kap@current )
  [ 1,  0] => -1.0 * ( kap@current )
  [ 0, -1] => -1.0
  [ 0,  1] => -1.0
}

Stencil K2@all from ( K * K )

Function Application ( ) : Unit {
  %s
  loop over u@finest {
    u@finest = sin ( PI * vf_nodePos_x ) * vf_nodePos_y
  }
  communicate u@finest
  loop over kap@finest {
    kap@finest = 1.0 + 0.01 * ( A@finest * ( A@finest * u@finest ) )
  }
  loop over w@finest {
    w@finest = K2@finest * u@finest
  }
  print ( dot ( w@finest, w@finest ) )
}
""" % PRECISE

# the same products inline, applied in a row: three ghost layers (the
# operand of the outer A reads u one point away); kap's first ghost layer
# reads u four points away, so K * K exchanges kap first
INLINE_PRODUCTS = HEAD + """
Field kap< global, NodeNoComm, None >@all

Stencil K@all {
  [ 0,  0] =>  4.0 * ( kap@current )
  [-1,  0] => -1.0 * ( kap@current )
  [ 1,  0] => -1.0 * ( kap@current )
  [ 0, -1] => -1.0
  [ 0,  1] => -1.0
}

Function Application ( ) : Unit {
  %s
  loop over u@finest {
    u@finest = sin ( PI * vf_nodePos_x ) * vf_nodePos_y
  }
  communicate u@finest
  loop over kap@finest {
    kap@finest = 1.0 + 0.01 * ( A@finest * ( A@finest * ( A@finest * u@finest ) ) )
  }
  loop over w@finest {
    w@finest = A@finest * A@finest * u@finest
  }
  loop over f@finest {
    f@finest = A@finest * ( A@finest * u@finest@[1, 0] ) + K@finest * K@finest * u@finest
  }
  print ( dot ( w@finest, w@finest ), dot ( f@finest, f@finest ) )
}
""" % PRECISE

# lexicographic sweeps over a cell field with ghost rules, one fragment
# over 2 x 1 ranks: the sweep runs on the gathered field and its planes.
# GHOST_RULES_REAPPLIED re-applies the rules before every sweep (the JAX
# package keeps its first planes there, test_jax_sweep_keeps_its_first_ghost_planes)
GHOST_SWEEP_BODY = """
  loop over c@finest only ghost [ -1, 0 ] on boundary {
    c@finest = c@finest@[ 1, 0 ]
  }
  loop over c@finest only ghost [ 1, 0 ] on boundary {
    c@finest = 0.5 * c@finest@[ -1, 0 ] + vf_cellCenter_y
  }
"""
GHOST_SWEEP = CELL_HEAD.replace("Field c< global, CellL, 1.0 >@all",
                                "Field c< global, CellL, None >@all") + """
Function Application ( ) : Unit {
  %s
  loop over g@finest {
    g@finest = vf_cellCenter_x * vf_cellCenter_y
  }
  loop over c@finest {
    c@finest = vf_cellCenter_x + 0.5 * vf_cellCenter_y
  }
  RULES
  repeat 3 times {
    SWEEP_RULES
    loop over c@finest sequentially {
      c@finest += 0.2 * ( g@finest - Ac@finest * c@finest )
    }
  }
  print ( dot ( c@finest, c@finest ) )
}
""" % PRECISE
GHOST_RULES = GHOST_SWEEP.replace("SWEEP_RULES", "").replace("RULES", GHOST_SWEEP_BODY)
GHOST_RULES_REAPPLIED = GHOST_SWEEP.replace("SWEEP_RULES", GHOST_SWEEP_BODY).replace("RULES", "")

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
    "solve_locally_2x2": dict(src=SOLVE_LOCALLY, nd=2, levels=(0, 4), mesh=(2, 2),
                              fields=[("u", 4), ("w", 4)]),
    "solve_locally_coupled_2x2": dict(src=SOLVE_COUPLED, nd=2, levels=(0, 4), mesh=(2, 2),
                                      fields=[("u", 4), ("w", 4)]),
    "solve_locally_complex_2x2": dict(src=SOLVE_COMPLEX, nd=2, levels=(0, 4), mesh=(2, 2),
                                      fields=[("z", 4)]),
    "solve_locally_3d": dict(src=SOLVE_LOCALLY_3D, nd=3, levels=(0, 4), mesh=(2, 2, 2),
                             fields=[("u", 4)]),
    "linearfct_2x2": dict(src=CELL, nd=2, levels=(1, 5), mesh=(2, 2), flags=LINEAR_FCT,
                          fields=[("c", 5), ("cn", 5), ("c", 2)]),
    "linearfct_seq_2x2": dict(src=SEQ_WIDTH, nd=2, levels=(0, 4), mesh=(2, 2),
                              flags=LINEAR_FCT, fields=[("u", 4), ("f", 4)]),
    "mixed_placement_3x1": dict(src=MIXED, nd=2, levels=(1, 4), mesh=(3, 1),
                                flags={"tpu_coarse_replicate_threshold": 3},
                                fields=[("u", 4), ("c", 4), ("u", 3), ("c", 3)]),
    "wide_stencil_4x1": dict(src=WIDE, nd=2, levels=(0, 4), mesh=(4, 1),
                             flags={"tpu_coarse_replicate_threshold": 1},
                             fields=[("u", 4), ("u", 3), ("u", 2)]),
    "field_stencil_2x2": dict(src=FIELD_STENCIL, nd=2, levels=(0, 4), mesh=(2, 2),
                              fields=[("w", 4)]),
    "inline_products_2x2": dict(src=INLINE_PRODUCTS, nd=2, levels=(0, 4), mesh=(2, 2),
                                fields=[("w", 4), ("f", 4)]),
    "ghost_rule_sweep_2x1": dict(src=GHOST_RULES, nd=2, levels=(0, 4), mesh=(2, 1),
                                 fields=[("c", 4)]),
    # chip_smoke.py's sharded_dsl_forms programs at maxLevel 4
    "bench_blocks_2x2x2": dict(src=chip_smoke.forms_program("blocks"), nd=3, levels=(1, 4),
                               mesh=(2, 2, 2), fields=[("U", 4), ("U", 3)]),
    "bench_stretched_2x2x2": dict(src=chip_smoke.forms_program("stretched"), nd=3,
                                  levels=(1, 4), mesh=(2, 2, 2), flags=LINEAR_FCT,
                                  fields=[("U", 4), ("F", 3)]),
    # a fault of the JAX package, not compared with it
    "ghost_rules_reapplied_2x1": dict(src=GHOST_RULES_REAPPLIED, nd=2, levels=(0, 4),
                                      mesh=(2, 1), fields=[("c", 4)], jax_fault=True),
}
COMPARED = sorted(name for name, case in CASES.items() if not case.get("jax_fault"))
JAX_TWIN = {"poisson_2d_staged": "poisson_2d_2x2"}  # same program and mesh


def mesh_shape(case):
    if case["mesh"]:
        return tuple(case["mesh"])
    flags = case.get("flags", {})
    return tuple(flags.get(f"domain_rect_numFragsPerBlock_{'xyz'[d]}", 1)
                 for d in range(case["nd"]))


def knowledge(case, cls=Knowledge):
    lo, hi = case["levels"]
    flags = {"tpu_coarse_replicate_threshold": 4, **case.get("flags", {})}
    k = cls(dimensionality=case["nd"], minLevel=lo, maxLevel=hi, testing_enabled=True,
            **flags)
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
        out["ghost"] = ex.frag.ghost
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


@pytest.mark.parametrize("name", COMPARED)
def test_lines_are_the_jax_sharded_lines(world, name):
    tmp, results = world
    want = run_jax(JAX_TWIN.get(name, name), str(tmp))["lines"]
    got = results[0][name]["lines"]
    assert got and lines_agree(got, want), (got, want)
    n = math.prod(mesh_shape(CASES[name]))
    assert all(r[name]["lines"] == [] for r in results[1:n])  # rank 0 prints


@pytest.mark.parametrize("name", COMPARED)
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


def test_offset_block_solves_exchange_what_ghost_blocks_read(world):
    """`solve locally` on offset unknowns: the blocks anchored in the
    ghost layers solve too (two ghost layers: a block one point out reads
    one more), and a field the blocks read at offset 0 only is exchanged
    when stale (SOLVE_COUPLED's w and u: six exchanges, none asked for)."""
    _, results = world
    assert results[0]["solve_locally_3d"]["ghost"] == 2
    assert results[0]["solve_locally_3d"]["placement"][4][0] == (True, True, True)
    st = results[0]["solve_locally_coupled_2x2"]["stats"]
    assert (st["communicate"], st["implicit"]) == (0, 6)


def test_node_and_cell_fields_share_a_placement(world):
    """Level 3's 9 nodes would split over 3 ranks at threshold 3 (the JAX
    field_spec), its 8 cells would not: the level holds both whole, and
    level 4 (17 nodes, 16 cells) splits both; the JAX package shards the
    nodes alone, and both print the dense lines."""
    from exastencils_tpu_torch.parallel.dslsharding import sharded_dims

    _, results = world
    assert sharded_dims((3, 1), (9, 9), 3) == (True, False)
    assert sharded_dims((3, 1), (8, 8), 3) == (False, False)
    pl = results[0]["mixed_placement_3x1"]["placement"]
    assert pl[3][0] == pl[3][2] == (False, False)
    assert pl[4][0] == pl[4][2] == (True, False)


def test_fragments_thinner_than_the_ghost_layers_are_held_whole(world):
    """A radius-2 stencil takes two ghost layers; level 2's 5 nodes over 4
    ranks would give runs of one point (threshold 1): held whole; level 3
    splits into runs of 2, 2, 2 and 3 nodes, each widened by its ghosts."""
    _, results = world
    r = results[0]["wide_stencil_4x1"]
    assert r["ghost"] == 2
    assert r["placement"][2][0] == (False, False) and r["placement"][3][0] == (True, False)
    assert [x["wide_stencil_4x1"]["placement"][3][1][0] for x in results[:4]] == [4, 6, 6, 5]


@pytest.mark.parametrize("name, ghost", [("field_stencil_2x2", 2), ("inline_products_2x2", 3)])
def test_stencil_products_set_the_halo(world, name, ghost):
    """K * K of a field-valued K reaches two points (counted from K's
    declared offsets, before any field holds values), stencils applied
    in a row add their reach; a product shifts K's coefficients across
    rank borders, so the stale kap is exchanged first (kap's ghosts were
    computed from a partial neighbourhood)."""
    _, results = world
    r = results[0][name]
    assert r["ghost"] == ghost
    assert (r["stats"]["communicate"], r["stats"]["implicit"]) == (1, 1)


def test_gathered_sweep_takes_its_ghost_rule_planes(world):
    """One fragment over 2 x 1 ranks: each sweep runs on the gathered
    field, its ghost-rule planes gathered from the ranks on their side."""
    _, results = world
    assert results[0]["ghost_rule_sweep_2x1"]["stats"]["seq_gathered"] == 3


def test_jax_sweep_keeps_its_first_ghost_planes(world):
    """A fault of the JAX package, not copied: it caches its jitted
    sequential sweep with the ghost-rule planes of the first call as
    constants, so rules applied again before each sweep go unseen, dense
    and sharded alike.  The port's sharded run prints its dense run's
    line; the JAX package's differs (with the rules applied once, as in
    ghost_rule_sweep_2x1, the two packages agree)."""
    tmp, results = world
    name = "ghost_rules_reapplied_2x1"
    case = CASES[name]
    k = knowledge(case)
    k.tpu_shard_dsl = False
    dense = []
    L4Executable(parse_l4(case["src"]), k, device="cpu", out=dense.append).run()
    got = results[0][name]["lines"]
    assert got and lines_agree(got, dense)
    want = run_jax(name, str(tmp))["lines"]
    assert want and not lines_agree(got, want)
    from exastencils_tpu.config import Knowledge as JaxKnowledge
    from exastencils_tpu.dsl.interpreter import L4Executable as JaxL4
    from exastencils_tpu.dsl.parser import parse_l4 as jax_parse_l4

    jk = knowledge(case, JaxKnowledge)
    jk.tpu_shard_dsl = False
    jax_dense = []
    JaxL4(jax_parse_l4(case["src"]), jk, out=jax_dense.append).run()
    assert jax_dense == want


@pytest.mark.parametrize("name", ["bench_blocks_2x2x2", "bench_stretched_2x2x2"])
def test_bench_forms_run_dense_and_sharded_in_the_jax_package(world, name):
    """chip_smoke.py's sharded_dsl_forms programs: the JAX package prints
    the same lines from its dense run as from its sharded one (which the
    port's ranks print), and each Solve converges."""
    from exastencils_tpu.config import Knowledge as JaxKnowledge
    from exastencils_tpu.dsl.interpreter import L4Executable as JaxL4
    from exastencils_tpu.dsl.parser import parse_l4 as jax_parse_l4

    tmp, _ = world
    case = CASES[name]
    k = knowledge(case, JaxKnowledge)
    k.tpu_shard_dsl = False
    dense = []
    JaxL4(jax_parse_l4(case["src"]), k, out=dense.append).run()
    sharded = run_jax(name, str(tmp))["lines"]
    assert lines_agree(dense, sharded)
    assert float(dense[-2]) < 0.01 * float(dense[0])


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
