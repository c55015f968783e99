"""The port's fragment topology (exastencils_tpu_torch/parallel/topology.py)
against the JAX package's (exastencils_tpu/parallel/topology.py).

The port's halo exchange and reductions run on SPMD ranks: one world of 8
spawned CPU ranks over gloo (a `file://` store) serves the whole file.
Ranks 0-3 run the 2x2 cases on a subgroup, then all 8 the 2x2x2 case; each
rank returns its exchanged fragment, its split-exchange (start/finish)
fragment and its owned sum of ones.  The JAX side runs in this process
under shard_map on the conftest's 8 virtual CPU devices.  Float64, held
bit for bit.  This module imports jax only inside the functions that
need it: the ranks import it to run `topology_rank` and must import
neither jax nor the JAX package (checked in every rank)."""

import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.parallel.mesh import make_domain_mesh, mesh_from_knowledge, run_ranks
from exastencils_tpu_torch.parallel.topology import (
    ShardTopology,
    dense_to_fragments,
    fragments_to_dense,
)

# (mesh shape, local cells, ghost width)
CASES = {
    "2x2_g1": ((2, 2), (8, 6), 1),
    "2x2_g3": ((2, 2), (8, 6), 3),
    "2x2x2_g2": ((2, 2, 2), (4, 6, 2), 2),
}


def stacked_input(case):
    """The seeded dense array of a case, scattered into the fragment-
    stacked layout (ghosts zero) by the JAX package's numpy function."""
    from exastencils_tpu.parallel.topology import ShardTopology as JaxTopology
    from exastencils_tpu.parallel.topology import dense_to_fragments as jax_d2f

    P, cells, g = CASES[case]
    rng = np.random.default_rng(sum(cells) + g)
    dense = rng.standard_normal(tuple(p * n + 1 for p, n in zip(P, cells)))
    return jax_d2f(dense, JaxTopology(None, P, ("bx", "by", "bz")[:len(P)], g), cells)


def fragment(stacked, P, cells, g, coords):
    loc = tuple(n + 1 + 2 * g for n in cells)
    return stacked[tuple(slice(c * t, (c + 1) * t) for c, t in zip(coords, loc))]


def topology_rank(device, inputs):
    """One rank's half of every case: (exchange, exchange_start/finish,
    owned sum of ones) of its fragment, by case, and the modules of the
    JAX package it imported."""
    sub = dist.new_group([0, 1, 2, 3])  # every rank takes part in making it
    out = {}
    for case, (P, cells, g) in CASES.items():
        group = sub if len(P) == 2 else None
        if len(P) == 2 and dist.get_rank() >= 4:
            continue
        mesh = make_domain_mesh(P, group=group)
        topo = ShardTopology(mesh, P, mesh.axis_names, g)
        x = torch.from_numpy(fragment(inputs[case], P, cells, g, mesh.coords).copy()).to(device)
        ex = topo.exchange(x, cells)
        split = topo.exchange_finish(x, topo.exchange_start(x, cells), cells)
        ones = torch.ones_like(x)
        owned = topo.psum(torch.sum(torch.where(topo.owned_mask(x.shape, cells, x.device),
                                                ones, 0)))
        out[case] = {"coords": mesh.coords, "exchange": ex.cpu().numpy(),
                     "split": split.cpu().numpy(), "owned": float(owned)}
    out["from_knowledge"] = [
        (m.shape, m.axis_names, m.coords) for m in (
            mesh_from_knowledge(Knowledge(dimensionality=3, tpu_mesh_shape=(2, 2, 2)).update()),
            mesh_from_knowledge(Knowledge(dimensionality=3, domain_rect_numBlocks_x=2,
                                          domain_rect_numBlocks_y=2,
                                          domain_rect_numBlocks_z=2).update()))]
    out["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "exastencils_tpu"))
    return out


@pytest.fixture(scope="module")
def world():
    inputs = {case: stacked_input(case) for case in CASES}
    return inputs, run_ranks(topology_rank, 8, inputs, device="cpu", timeout_s=300)


def jax_exchanges(case, stacked):
    """JAX's exchange and exchange_start/finish of the stacked array under
    shard_map."""
    import jax
    from exastencils_tpu.parallel.mesh import make_domain_mesh as jax_mesh
    from exastencils_tpu.parallel.topology import ShardTopology as JaxTopology

    P, cells, g = CASES[case]
    mesh = jax_mesh(P, devices=jax.devices()[:int(np.prod(P))])
    topo = JaxTopology(mesh, P, mesh.axis_names, g)

    def mapped(fn):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=topo.spec(), out_specs=topo.spec()))

    ex = mapped(lambda x: topo.exchange(x, cells))(stacked)
    split = mapped(lambda x: topo.exchange_finish(x, topo.exchange_start(x, cells), cells))(stacked)
    return np.asarray(ex), np.asarray(split)


@pytest.mark.parametrize("P,cells,g", [((2, 2), (8, 6), 1), ((2, 2, 2), (4, 6, 2), 2),
                                       ((2, 1, 2), (3, 5, 4), 2)])
def test_fragment_layout_matches_jax(P, cells, g):
    """dense_to_fragments / fragments_to_dense equal the JAX package's
    numpy functions, and round-trip the dense array."""
    from exastencils_tpu.parallel.topology import ShardTopology as JaxTopology
    from exastencils_tpu.parallel.topology import dense_to_fragments as jax_d2f
    from exastencils_tpu.parallel.topology import fragments_to_dense as jax_f2d

    names = tuple(n if p > 1 else None for n, p in zip(("bx", "by", "bz"), P))
    topo, jtopo = ShardTopology(None, P, names, g), JaxTopology(None, P, names, g)
    dense = np.random.default_rng(0).standard_normal(tuple(p * n + 1 for p, n in zip(P, cells)))
    stacked = dense_to_fragments(dense, topo, cells)
    np.testing.assert_array_equal(stacked, jax_d2f(dense, jtopo, cells))
    np.testing.assert_array_equal(fragments_to_dense(stacked, topo, cells),
                                  jax_f2d(stacked, jtopo, cells))
    np.testing.assert_array_equal(fragments_to_dense(stacked, topo, cells), dense)
    assert topo.local_shape(cells) == jtopo.local_shape(cells)


def ranks_of(results, case):
    return [r[case] for r in results if case in r]


@pytest.mark.parametrize("case", sorted(CASES))
def test_exchange_matches_jax_bitwise(world, case):
    """Every rank's exchanged fragment (ghosts, dup planes, edges and
    corners) is bit for bit the JAX package's under shard_map."""
    inputs, results = world
    P, cells, g = CASES[case]
    want, _ = jax_exchanges(case, inputs[case])
    got = ranks_of(results, case)
    assert len(got) == int(np.prod(P))
    for r in got:
        np.testing.assert_array_equal(r["exchange"], fragment(want, P, cells, g, r["coords"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_exchange_matches_jax_bitwise(world, case):
    """exchange_start/finish (all messages from the pre-exchange array)
    equal the JAX package's split exchange bit for bit, and the fused
    exchange off the corners (points in the received layers of two or
    more dims, which the fused exchange fills axis after axis)."""
    inputs, results = world
    P, cells, g = CASES[case]
    _, want = jax_exchanges(case, inputs[case])
    for r in ranks_of(results, case):
        np.testing.assert_array_equal(r["split"], fragment(want, P, cells, g, r["coords"]))
        loc = r["split"].shape
        # planes a neighbour's slab lands on: [0, g] (dup-left included)
        # and [t - g, t)
        ghost_dims = sum(((np.arange(t) <= g) | (np.arange(t) >= t - g)).reshape(
            [-1 if i == d else 1 for i in range(len(P))]).astype(int)
            for d, t in enumerate(loc))
        off_corner = np.broadcast_to(ghost_dims <= 1, loc)
        np.testing.assert_array_equal(r["split"][off_corner], r["exchange"][off_corner])


@pytest.mark.parametrize("case", sorted(CASES))
def test_owned_reduction_counts_each_node_once(world, case):
    """The owned mask summed over all ranks (psum = all_reduce) counts
    every global node once, on every rank."""
    _, results = world
    P, cells, _ = CASES[case]
    nodes = float(np.prod([p * n + 1 for p, n in zip(P, cells)]))
    assert [r["owned"] for r in ranks_of(results, case)] == [nodes] * int(np.prod(P))


def test_mesh_from_knowledge_matches_jax(world):
    """`tpu_mesh_shape`, else the domain_rect_numBlocks_* counts, give the
    mesh shape, with the JAX axis names; rank r sits at the row-major
    position of device r in the JAX package's mesh."""
    import jax
    from exastencils_tpu.config import Knowledge as JaxKnowledge
    from exastencils_tpu.parallel.mesh import mesh_from_knowledge as jax_from_knowledge

    jmesh = jax_from_knowledge(JaxKnowledge(dimensionality=3, tpu_mesh_shape=(2, 2, 2)).update(),
                               devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    _, results = world
    for rank, r in enumerate(results):
        for shape, names, coords in r["from_knowledge"]:
            assert (shape, names) == (tuple(jmesh.devices.shape), tuple(jmesh.axis_names))
            assert ids[coords] == jax.devices()[rank].id


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    _, results = world
    assert [r["imported"] for r in results] == [[]] * 8
