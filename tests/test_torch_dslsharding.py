"""The port's DSL placement rules (parallel/dslsharding.py) against the
JAX package's (exastencils_tpu/parallel/dslsharding.py), on the CPU with
no ranks: the decomposition, the fit to the rank count, the sharded dims
per level and localization (against JAX `field_spec` on a Mesh of the
conftest's virtual devices), the mesh on a world of one, and the port's
own split of a level's cells over the ranks of an axis."""

import itertools

import numpy as np
import pytest

from exastencils_tpu.config import Knowledge as JaxKnowledge
from exastencils_tpu.parallel import dslsharding as jds

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.core.domain import unit_domain
from exastencils_tpu_torch.core.grid import level_grids
from exastencils_tpu_torch.parallel import dslsharding as tds
from exastencils_tpu_torch.parallel.mesh import DomainMesh
from exastencils_tpu_torch.parallel.topology import FragmentWindows

KNOWLEDGE = [
    dict(dimensionality=2),
    dict(dimensionality=2, domain_rect_numBlocks_x=2, domain_rect_numFragsPerBlock_y=3),
    dict(dimensionality=3, domain_rect_numFragsPerBlock_x=2, domain_rect_numFragsPerBlock_y=2,
         domain_rect_numFragsPerBlock_z=2),
    dict(dimensionality=3, tpu_mesh_shape=(4, 2)),
    dict(dimensionality=2, tpu_mesh_shape=(3, 1)),
    dict(dimensionality=1, domain_rect_numBlocks_x=4),
]


@pytest.mark.parametrize("flags", KNOWLEDGE)
def test_decomposition_from_knowledge_matches_jax(flags):
    nd = flags["dimensionality"]
    want = jds.decomposition_from_knowledge(JaxKnowledge(**flags).update(), nd)
    assert tds.decomposition_from_knowledge(Knowledge(**flags).update(), nd) == want


@pytest.mark.parametrize("nd,n", list(itertools.product((1, 2, 3), range(1, 9))))
def test_fit_to_devices_matches_jax(nd, n):
    """Every desired decomposition with entries <= 4, on 1..8 ranks."""
    for want in itertools.product(range(1, 5), repeat=nd):
        assert tds.fit_to_devices(list(want), n) == jds.fit_to_devices(list(want), n), want


MESHES = [(2, 2), (4, 2), (3, 1), (2, 2, 2), (1, 4)]


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_dims_match_jax_field_spec(shape):
    """Dim d of a field instance is sharded iff JAX's field_spec names its
    mesh axis, for every level 0..7, Node and Cell extents and
    thresholds 1, 4 and 32."""
    import jax
    from jax.sharding import Mesh

    nd = len(shape)
    names = ("bx", "by", "bz")[:nd]
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    for level, thr, cell in itertools.product(range(8), (1, 4, 32), (0, 1)):
        grid = tuple(2 ** level + 1 - cell for _ in range(nd))
        spec = jds.field_spec(mesh, grid, thr, lead_dims=1, trail_dims=2)
        want = tuple(spec[1 + d] is not None for d in range(nd))
        assert tds.sharded_dims(shape, grid, thr) == want, (level, thr, cell)


def test_build_dsl_mesh_is_none_on_a_world_of_one():
    k = Knowledge(dimensionality=2, tpu_mesh_shape=(2, 2)).update()
    assert tds.build_dsl_mesh(k, 2) is None  # no process group: one rank
    assert tds.build_dsl_mesh(k, 2, world=1) is None
    assert tds.build_dsl_mesh(Knowledge(dimensionality=2).update(), 2, world=4) is None
    mesh = tds.build_dsl_mesh(k, 2, world=4)
    assert (mesh.shape, mesh.axis_names, mesh.rank) == ((2, 2), ("bx", "by"), 0)
    import jax

    assert jds.build_dsl_mesh(JaxKnowledge(dimensionality=2, tpu_mesh_shape=(2, 2)).update(),
                              2, devices=jax.devices()[:1]) is None


def test_build_dsl_mesh_refuses_a_world_it_does_not_fill():
    k = Knowledge(dimensionality=2, tpu_mesh_shape=(2, 2)).update()
    with pytest.raises(ValueError, match="start 4 ranks"):
        tds.build_dsl_mesh(k, 2, world=6)


def test_split_starts_double_from_level_to_level():
    assert tds.split_starts([16], 3) == (0, 5, 10)
    assert tds.split_starts([16, 32, 64], 3) == (0, 20, 40)
    assert tds.split_starts([8, 16], 2) == (0, 8)
    with pytest.raises(ValueError):
        tds.split_starts([2], 3)


def test_windows_cover_the_grid_once():
    """On a 3x1 mesh the owned runs of a level tile its nodes and cells
    exactly once; each window is its run widened by the ghost layers on
    the sides with a neighbour, clipped at the grid's edge."""
    k = Knowledge(dimensionality=2, minLevel=0, maxLevel=6).update()
    grids = level_grids(unit_domain(2), k, "cpu")
    for n in (grids[6].shape_of("Node")[0], grids[6].shape_of("Cell")[0]):
        starts = tds.split_starts([16, 32, 64], 3)
        owned, bounds = [], []
        for c in range(3):
            fw = FragmentWindows(DomainMesh((3, 1), rank=c), ghost=2)
            w = fw.window((n, n), (True, False), (starts, None))
            owned.append(w.own(0))
            bounds.append(w.bounds(0))
            assert w.bounds(1) == (0, n) and w.shape[1] == n
        assert owned[0][0] == 0 and owned[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(owned, owned[1:]))
        assert bounds == [(0, owned[0][1] + 2), (owned[1][0] - 2, owned[1][1] + 2),
                          (owned[2][0] - 2, n)]
