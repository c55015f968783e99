"""CLI driver: `python -m exastencils_tpu_torch <settings> [knowledge] [platform]`.

Reference: exastencils_tpu/__main__.py.  Builds the program of a
settings file (layer files L1-L4) and runs its Application on the GPU, or
on the CPU with --cpu; there is no fallback: without a CUDA device the
run fails unless --cpu is given.  As in the reference, fields are float32
unless --f64 is given (JAX computes in float32 unless x64 is enabled).
--check diffs the printed lines against a golden .results file;
--trace-dir writes a torch.profiler trace of the run (chrome JSON).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="exastencils_tpu_torch",
        description="ExaStencils on PyTorch/CUDA: run ExaSlang L1-L4 configs",
    )
    ap.add_argument("settings", help=".settings file (layer files, paths)")
    ap.add_argument("knowledge", nargs="?", help=".knowledge file")
    ap.add_argument("platform", nargs="?",
                    help=".platform file (accepted for compatibility)")
    ap.add_argument("--function", default="Application",
                    help="entry function (default: Application)")
    ap.add_argument("--f64", action="store_true",
                    help="compute in float64 (golden-parity mode)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch) instead of the GPU")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace (trace.json) to this directory")
    ap.add_argument("--check", default=None, metavar="GOLDEN.results",
                    help="diff the program output against a golden .results "
                         "file: exit 0 on match, 1 with the first differing "
                         "line otherwise")
    ap.add_argument("--check-eps", type=float, default=1e-6,
                    help="numeric tolerance for --check (default 1e-6)")
    args = ap.parse_args(argv)

    import torch

    from exastencils_tpu_torch.config import Knowledge
    from exastencils_tpu_torch.config.parser import parse_config_file

    from exastencils_tpu_torch.device import real_dtype
    from exastencils_tpu_torch.dsl.driver import build_program
    from exastencils_tpu_torch.dsl.interpreter import L4Executable

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("exastencils_tpu_torch: no CUDA device "
                         "(torch.cuda.is_available() is false); use --cpu")
    device = "cpu" if args.cpu else "cuda"

    k = Knowledge()
    if args.knowledge:
        parse_config_file(args.knowledge, k)
    if args.platform:
        parse_config_file(args.platform, k)  # platform keys land in _unused
    prog = build_program(args.settings, k)
    if not args.f64 and real_dtype(k) == torch.float64:
        k.tpu_compute_dtype = "float32"

    lines = []

    def emit(s):
        print(s)
        lines.append(str(s))

    ex = L4Executable(prog, k, device=device, out=emit if args.check else print)
    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        with profile(activities=acts) as prof:
            ex.run(args.function)
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "trace.json"))
    else:
        ex.run(args.function)

    if args.check:
        from exastencils_tpu_torch.native import check_results

        with tempfile.NamedTemporaryFile("w", suffix=".out", delete=False) as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
            got_path = f.name
        rc = check_results(got_path, args.check, eps=args.check_eps)
        if rc == 0:
            print(f"CHECK OK: output matches {args.check}")
            return 0
        if rc > 0:
            print(f"CHECK FAILED: first difference at line {rc} (vs {args.check})")
        else:
            print(f"CHECK FAILED: rc={rc} "
                  "(-2: golden unreadable, -3: line-count mismatch)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
