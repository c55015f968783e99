"""The control of each configuration, the plain reference computed in the
next lower precision (bfloat16 for float32, float32 for float64) in the
program's place, comes out not correct under the cells' limits; the
program's own readings come out correct.  On the CPU at level 4 (the
chip runs of portbench/control.py read both at the cells' sizes)."""

import json

import pytest

from benchcopy import tiny_checkout
from portbench import control, harness

LEVEL = 4


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return harness.Bench(tiny_checkout(tmp_path_factory.mktemp("checkout"), level=LEVEL))


@pytest.mark.parametrize("cell", ["exa4.l9_f32", "api.l9_f64"])
def test_control_fails_and_program_passes(bench, cell):
    limits = bench.limits(cell)
    found, summary = control.readings(bench, cell, [2 ** 31 + 1], [2 ** 31 + 2, 2 ** 32 + 3],
                                      "cpu", out=lambda line: json.loads(line))
    for row in found["program"]:
        assert all(row[k] <= limits[k] for k in limits), row
    for row in found["control"]:
        assert any(row[k] > limits[k] for k in limits), row
