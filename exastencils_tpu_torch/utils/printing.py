"""Reduced-precision printing for golden-output testing.

Copied from exastencils_tpu/utils/printing.py so that the PyTorch port imports
nothing of the JAX package; imports point at exastencils_tpu_torch.

Reference: util/ir/IR_ResolvePrintWithReducedPrec.scala (the generated
`gen_printVal`): print with `testing_maxPrecision` significant digits,
dropping digits near the zero threshold, so residual sequences compare
stably across platforms (Testing/run_test.py EPS = 1e-6).

C++ `std::cout << x` with `precision(n)` equals printf %.ng, which
matches Python's `%.{n}g` including the 2-digit exponent form.
"""

from __future__ import annotations


def reduced_prec_str(x: float, max_precision: int = 4, zero_threshold: float = 1e-12) -> str:
    """Exact port of the generated gen_printVal decision tree
    (IR_ResolvePrintWithReducedPrec.scala:42-73)."""
    x = float(x)
    if x <= zero_threshold:
        return "EFFECTIVELY ZERO"
    # the generated nest checks thresholds from tightest upward:
    # x <= zt*10^p  ->  p significant digits (p = 1 .. maxPrecision-1)
    t = zero_threshold * 10
    for p in range(1, max_precision):
        if x <= t:
            return "%.*g" % (p, x)
        t *= 10
    return "%.*g" % (max_precision, x)


def print_with_reduced_prec(x, knowledge=None, out=print):
    mp = knowledge.testing_maxPrecision if knowledge is not None else 4
    zt = knowledge.testing_zeroThreshold if knowledge is not None else 1e-12
    out(reduced_prec_str(x, mp, zt))
