"""The benchmark of the PyTorch and CUDA port on one CUDA device.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints one JSON line (portbench/harness.py);
exits non-zero without one where the cell's CUDA devices are missing, the
program is missing, or JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches at fixed paths inside the checkout (the program
# builds its CUDA library into build/exastencils_tpu_torch/ by itself).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
sys.path[0] = str(ROOT)  # the program and this package, from the checkout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import harness

    return harness.main(args, ROOT, T0)


if __name__ == "__main__":
    raise SystemExit(main())
