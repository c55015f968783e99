"""Whole runs of the harness on the CPU at level 4 (the harness's look for
a CUDA device skipped), with the program broken underneath, with files
added by name, and the command itself."""

import hashlib
import json
import subprocess
import sys
import time

import pytest
import torch

from benchcopy import REPO, tiny_checkout
from portbench import harness

CELLS = ("exa4.l9_f32", "api.l9_f64")
SOUND_CYCLES = {"exa4.l9_f32": 6, "api.l9_f64": 10}  # at level 4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


def run(root, cell, wrap=None, trace=False, seed=2 ** 33 + 17):
    return harness.run_cell(harness.Bench(root), cell, seed, 1.0, trace, "cpu",
                            time.perf_counter(), wrap=wrap)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    result, lines = run(root, cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 3
    assert set(result["metrics"]) == {"solve_ms", "solve_ms_p95", "setup_s"}  # no card: no peak
    limits = harness.Bench(root).limits(cell)
    assert list(result)[-1] == "check" and list(result["check"]) == list(limits)
    assert [line.split()[1] for line in lines[-len(limits):]] == list(limits)
    assert all(line.startswith("check ") for line in lines[-len(limits):])


# Faults planted in the frozen ExaSlang program of a copied checkout.
PROGRAM_FAULTS = {
    # every second cycle of Solve skipped: half the work, the loop's count whole
    "half_the_cycles": ("\t\tMGCycle@finest ( )\n",
                        "\t\tif ( ( it % 2 ) == 1 ) {\n\t\t\tMGCycle@finest ( )\n\t\t}\n"),
    # one smoothing sweep of three dropped before and after the coarse grid
    "sweep_dropped": ("repeat 3 times {", "repeat 2 times {"),
}


def plant(root, fault):
    program = root / "portbench" / "configs" / "poisson3d_exa4.exa4"
    old, new = PROGRAM_FAULTS[fault]
    text = program.read_text()
    assert text.count(old) == 1
    program.write_text(text.replace(old, new))


class Broken:
    """The system with one fault planted where the timed path produces."""

    def __init__(self, system, fault, cycles):
        self.system, self.fault, self.cycles = system, fault, cycles

    def __getattr__(self, name):
        return getattr(self.system, name)

    def solve(self):
        if self.fault == "state_unchanged":  # the solve returns the guess as it was
            return self.cycles
        if self.fault == "half_the_cycles" and hasattr(self.system, "ex"):
            self.system.solve()  # the program's fault; the count reported whole
            return self.cycles
        if self.fault == "half_the_cycles":  # half the work, the count reported whole
            api = self.system
            eps, its = api.key
            api.out = api.solver.solve_fused(max_its=self.cycles // 2, target_res_reduction=eps,
                                             state=(api.x, api.rhs))[0]
            return self.cycles
        cycles = self.system.solve()
        if self.fault == "answer_altered":  # one value of the solution changed
            u = self.system.solution()
            u[tuple(s // 2 for s in u.shape)] += 0.1 * float(u.abs().max())
        if self.fault == "count_altered":
            cycles += 1
        return cycles


# The numbers each fault fails.  In `exa4` a solve at 513^3 runs the
# program's cap of 20 cycles, on the reference too, so there a fault that
# keeps the count shows only in the reported residuals: at this size the
# Broken wrapper reports the sound count for the skipped cycles to match.
FAILS = {
    ("exa4.l9_f32", "state_unchanged"): ["solution_gap", "residual_gap"],
    ("exa4.l9_f32", "answer_altered"): ["solution_gap"],
    ("exa4.l9_f32", "count_altered"): ["cycles_gap"],
    ("exa4.l9_f32", "half_the_cycles"): ["residual_gap"],
    ("exa4.l9_f32", "sweep_dropped"): ["cycles_gap", "residual_gap"],  # 20 = 20 at 513^3
    ("api.l9_f64", "state_unchanged"): ["solution_gap"],
    ("api.l9_f64", "answer_altered"): ["solution_gap"],
    ("api.l9_f64", "count_altered"): ["cycles_gap"],
    ("api.l9_f64", "half_the_cycles"): ["solution_gap"],
}


@pytest.mark.parametrize("cell,fault", list(FAILS))
def test_broken_timed_path_is_not_correct(root, tmp_path, cell, fault):
    if cell.startswith("exa4") and fault in PROGRAM_FAULTS:
        root = tiny_checkout(tmp_path)
        plant(root, fault)
    wrap = None if fault == "sweep_dropped" else \
        (lambda s: Broken(s, fault, SOUND_CYCLES[cell]))
    result, _ = run(root, cell, wrap=wrap)
    assert not result["correct"] and result["failed"] > 0
    over = [k for k, v in result["check"].items() if v["value"] is None or v["value"] > v["limit"]]
    assert over == FAILS[cell, fault], over


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and p.name != "BENCHMARK.json"}


def test_new_entries_are_files_found_by_name(tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric
    added as new files and manifest entries, no file there edited."""
    root = tiny_checkout(tmp_path)
    before = digest(root)
    pkg = root / "portbench"
    cfg = json.loads((pkg / "configs" / "poisson3d_api_f64.json").read_text())
    cfg.update(name="throwaway_api_gs", omega=1.0)
    (pkg / "configs" / "throwaway_api_gs.json").write_text(json.dumps(cfg))
    t = json.loads((pkg / "traffic" / "rhs4_l9.json").read_text())
    t.update(level=3, rhs=t["rhs"][:2], samples=1, sample_within=2)
    (pkg / "traffic" / "throwaway_rhs2_l3.json").write_text(json.dumps(t))
    (pkg / "workloads" / "throwaway.gs_l3.json").write_text(
        json.dumps({"limits": {"solution_gap": 1e-8, "cycles_gap": 0}}))
    (pkg / "metrics" / "solver.throwaway_max_cycles.py").write_text(
        "def read(run):\n    return max(c for _, c, _ in run.solves)\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "throwaway_api_gs", "source": "a test", "reduced": [],
                         "file": "portbench/configs/throwaway_api_gs.json", "why": "a test"})
    m["workloads"].append({"name": "throwaway.gs_l3", "config": "throwaway_api_gs",
                           "traffic": "throwaway_rhs2_l3", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "solver.throwaway_max_cycles", "unit": "cycles",
                           "better": "lower", "source": "program_counter", "layer": "solve driver",
                           "moves": "solve_ms", "workloads": ["throwaway.gs_l3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    result, _ = run(root, "throwaway.gs_l3", trace=True)
    assert result["correct"]
    got = result["metrics"]["solver.throwaway_max_cycles"]
    assert got["unit"] == "cycles" and isinstance(got["value"], int) and got["value"] > 0
    added = set(digest(root)) - set(before)
    assert all(digest(root)[k] == v for k, v in before.items())
    assert added == {"portbench/configs/throwaway_api_gs.json",
                     "portbench/traffic/throwaway_rhs2_l3.json",
                     "portbench/workloads/throwaway.gs_l3.json",
                     "portbench/metrics/solver.throwaway_max_cycles.py"}


PROBE = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from portbench import harness
root = Path(sys.argv[2])
for cell in ("exa4.l9_f32", "api.l9_f64"):
    res, _ = harness.run_cell(harness.Bench(root), cell, 11, 0.5, True, "cpu", time.perf_counter())
    assert res["correct"], res
print(json.dumps({"forbidden": harness.forbidden_modules(),
                  "port": "exastencils_tpu_torch" in sys.modules}))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root = tiny_checkout(tmp_path, sample_within=1)
    out = subprocess.run([sys.executable, "-c", PROBE, str(REPO), str(root)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"forbidden": [], "port": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "exastencils_tpu_torch_probe", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "exastencils_tpu.probe", sys)
    assert harness.forbidden_modules() == ["exastencils_tpu"]


def command(cwd, cell="exa4.l9_f32", seconds=2):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                           str(2 ** 31 + 99), "--seconds", str(seconds), "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=900)


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = command(REPO)
    assert out.returncode != 0 and out.stdout == ""


def test_command_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/."""
    root = tiny_checkout(tmp_path)
    out = command(root)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = command(REPO, seconds=10)  # past the solves a run samples among
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    last = list(harness.Bench(REPO).limits("exa4.l9_f32"))[-1]
    assert out.stderr.strip().splitlines()[-1].startswith(f"check {last} ")
