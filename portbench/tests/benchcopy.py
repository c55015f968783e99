"""A checkout for the CPU tests: the benchmark's files copied under a
temporary root, BENCHMARK.json's cells pointed at small traffic."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_LEVEL = 4  # 17^3 nodes: float32 still meets the program's 1e-5 in 6 cycles


def tiny_checkout(root: Path, level: int = TINY_LEVEL, sample_within: int = 3) -> Path:
    """Copy BENCHMARK.json and portbench/ to `root`; every traffic file
    gets the finest level `level` and samples among the first
    `sample_within` solves."""
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for f in (root / "portbench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(level=level, sample_within=sample_within)
        f.write_text(json.dumps(t))
    return root


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())
