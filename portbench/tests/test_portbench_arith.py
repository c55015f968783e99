"""The benchmark's arithmetic on hand-made inputs: the V-cycle's bytes,
unions, gaps, percentiles and the readers of the metrics."""

import json
from types import SimpleNamespace

import pytest

from benchcopy import REPO
from portbench import devtrace, harness, yardstick


def test_vcycle_bytes_match_the_ports_traffic_model():
    from exastencils_tpu_torch.runtime.performance import VCycleTrafficModel

    for size in (4, 8):
        want = VCycleTrafficModel(fused_level=True, check_residual=False,
                                  dtype_bytes=size).bytes_per_fine_dof()
        assert yardstick.vcycle_bytes_per_fine_dof(size) == pytest.approx(want, rel=1e-15)
    # 2 legs x (3 + 1/8) arrays x 8/7 over the levels x 4 bytes
    assert yardstick.vcycle_bytes_per_fine_dof(4) == pytest.approx(200 / 7)
    want = VCycleTrafficModel(fused_level=True, check_residual=False, dtype_bytes=4,
                              ndim=2).bytes_per_fine_dof()
    assert yardstick.vcycle_bytes_per_fine_dof(4, ndim=2) == pytest.approx(want, rel=1e-15)


@pytest.mark.parametrize("got,ref,cycles,want", [
    ([10.0, 1.0, 0.1], [20.0, 2.0, 0.2], 2, 0.0),  # the same reductions from another r0
    ([10.0, 1.0, 0.2], [10.0, 1.0, 0.1], 2, 1.0),  # twice the reference's r2 / r0
    ([10.0, 1.0, 0.2], [10.0, 1.0, 0.1], 1, 0.0),  # only the first cycle compared
    ([10.0, 1.0], [10.0, 1.0, 0.1], 2, None),  # a cycle not reported
    ([10.0, 1.0, 0.1], [10.0, 1.1], 2, 1 / 11),  # the reference stopped after one
    (None, [10.0, 1.0], 1, None),  # a system that reports no residuals
])
def test_residual_gap(got, ref, cycles, want):
    gap = harness.residual_gap(got, ref, cycles)
    assert gap == (None if want is None else pytest.approx(want))


def test_dtype_of_names_any_torch_dtype():
    import torch

    assert harness.dtype_of("bfloat16") is torch.bfloat16
    assert harness.dtype_of("float64") is torch.float64
    with pytest.raises(ValueError):
        harness.dtype_of("Tensor")


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 38), (100, 110)]
    assert yardstick.union_us(iv) == 40
    assert yardstick.gaps_us(iv) == [(20, 30), (40, 100)]
    assert yardstick.union_us([]) == 0


def test_percentile():
    assert yardstick.p95([float(i) for i in range(1, 21)]) == pytest.approx(19.05)
    assert yardstick.p95([3.0]) == 3.0


def test_trace_reductions():
    tr = {"device": [("k1", 0, 10), ("k2", 5, 20), ("k1", 30, 40), ("k3", 100, 110)],
          "host": [("aten::item", 18, 35), ("cudaStreamSynchronize", 39, 99), ("x", 50, 60)],
          "wall_s": 200e-6, "reps": 2}
    assert devtrace.busy_s(tr) == pytest.approx(40e-6)
    assert devtrace.top_ops(tr) == [["k1", pytest.approx(20e-6)], ["k2", pytest.approx(15e-6)],
                                    ["k3", pytest.approx(10e-6)]]
    assert devtrace.idle_gaps(tr) == [["cudaStreamSynchronize", pytest.approx(60e-6)],
                                      ["aten::item", pytest.approx(10e-6)]]


def test_readers_on_a_hand_made_run():
    bench = harness.Bench(REPO)
    cell = bench.manifest["workloads"][0]["name"]
    trace = {"device": [("k", 0.0, 6000.0), ("k", 7000.0, 10000.0)], "host": [],
             "wall_s": 0.02, "reps": 2}
    run = SimpleNamespace(
        cuda=True, level=9, dtype_bytes=4, fine_dofs=513 ** 3, ndim=3, setup_s=12.5,
        window_s=10.0,
        solves=[(0.4, 20, 0), (0.5, 20, 1), (0.6, 20, 2), (0.5, 20, 3)],
        counters={"setup": {"capture_s": 1.5, "host_reads": 40},
                  "window": {"host_reads": 80, "capture_s": 0.0}},
        peak_bytes=2 ** 33, cycle_ms=15.0, cycle_trace=trace, solve_trace=trace)
    got = {m["name"]: read(run) for kind in ("end_to_end", "per_layer")
           for m, read in bench.metrics(cell, kind)}
    least = 200 / 7 * 513 ** 3 / 3.35e12
    assert got == pytest.approx({
        "solve_ms": 2500.0, "solve_ms_p95": 585.0, "peak_mem_gib": 8.0, "setup_s": 12.5,
        "solver.cycles_per_solve": 20.0, "cycle.glups": 513 ** 3 / 0.015 / 1e9,
        "cycle.kernels_per_cycle": 1.0, "staging.host_reads_per_cycle": 1.0,
        "staging.capture_s": 1.5, "kernels.cycle_roofline_share": 100 * least / 4.5e-3,
        "device.idle_share": 55.0})
    run.cycle_trace = run.solve_trace = run.cycle_ms = run.peak_bytes = None
    run.cuda = False
    for m, read in bench.metrics(cell, "per_layer") + bench.metrics(cell, "end_to_end"):
        if m["source"] == "device_trace" or m["name"] in ("peak_mem_gib", "staging.capture_s"):
            assert read(run) is None, m["name"]


def test_traffic_is_the_same_work_for_every_seed():
    from portbench import traffic as traffic_gen
    import torch

    t = json.loads((REPO / "portbench" / "traffic" / "rhs4_l9.json").read_text())
    t["level"] = 3
    a, b = (traffic_gen.bank(t, s, torch.float64, "cpu") for s in (5, 2 ** 32 + 5))
    for fa, fb in zip(a, b):
        assert float(fa.norm()) == pytest.approx(float(fb.norm()), rel=0.05)
        assert float(fa[0].abs().max()) == float(fa[:, :, -1].abs().max()) == 0.0
    again = traffic_gen.bank(t, 5, torch.float64, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    assert not torch.equal(a[0], b[0])
    assert sorted(traffic_gen.order(t, 5)) == [0, 1, 2, 3]
    t2 = dict(t, rhs=[[m[:2] for m in modes] for modes in t["rhs"]])  # a 2D mix: 2D grids
    flat = traffic_gen.bank(t2, 5, torch.float32, "cpu")
    assert [f.shape for f in flat] == [(9, 9)] * 4 and flat[0].dtype == torch.float32
    assert float(flat[1][:, 0].abs().max()) == float(flat[1][-1].abs().max()) == 0.0
    picks = traffic_gen.samples(t, 2 ** 40 + 3)
    assert len(picks) == t["samples"] and len({p % 4 for p in picks}) == len(picks)
    assert all(p < t["sample_within"] for p in picks)
