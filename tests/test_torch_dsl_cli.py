"""`python -m exastencils_tpu_torch` against `python -m exastencils_tpu`.

The same temporary settings file (l4file = examples/poisson_3d_bench.exa4)
and knowledge file (maxLevel 4) go through both CLIs on the CPU in
float64: the port prints the JAX CLI's lines, `--check` passes against a
golden written from the JAX CLI's output and exits 1 against a perturbed
one, --trace-dir writes a profiler trace, and without --cpu the port
refuses to run where no GPU is present."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BENCH = os.path.join(REPO, "examples", "poisson_3d_bench.exa4")


def cli(module, *args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    settings = d / "bench.settings"
    settings.write_text(f'l4file = "{BENCH}"\n')
    knowledge = d / "bench.knowledge"
    knowledge.write_text("dimensionality = 3\nminLevel = 1\nmaxLevel = 4\n"
                         "tpu_shard_dsl = false\n")
    jax_run = cli("exastencils_tpu", "--cpu", "--f64", str(settings), str(knowledge))
    assert jax_run.returncode == 0, jax_run.stderr
    golden = d / "bench.results"
    golden.write_text(jax_run.stdout)
    return str(settings), str(knowledge), jax_run.stdout.splitlines(), str(golden)


def test_cli_prints_the_jax_cli_lines_and_checks(config):
    settings, knowledge, want, golden = config
    run = cli("exastencils_tpu_torch", "--cpu", "--f64", settings, knowledge, "--check", golden)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    assert lines[:-1] == want and len(want) == 8
    assert lines[-1].startswith("CHECK OK")


def test_cli_check_fails_on_a_perturbed_golden(config, tmp_path):
    settings, knowledge, want, _ = config
    bad = list(want)
    bad[3] = repr(float(bad[3]) * 1.01)
    golden = tmp_path / "perturbed.results"
    golden.write_text("\n".join(bad) + "\n")
    run = cli("exastencils_tpu_torch", "--cpu", "--f64", settings, knowledge, "--check", str(golden))
    assert run.returncode == 1
    assert run.stdout.splitlines()[-1].startswith("CHECK FAILED: first difference at line 4")


def test_cli_trace_dir_writes_a_profiler_trace(config, tmp_path):
    settings, knowledge, want, _ = config
    run = cli("exastencils_tpu_torch", "--cpu", "--f64", settings, knowledge,
              "--trace-dir", str(tmp_path / "trace"))
    assert run.returncode == 0, run.stderr
    assert run.stdout.splitlines() == want
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_cli_without_gpu_refuses_to_run(config):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no GPU is present")
    settings, knowledge, _, _ = config
    run = cli("exastencils_tpu_torch", "--f64", settings, knowledge)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr and run.stdout == ""

