"""The benchmark's own arithmetic: the card's published peak bandwidth,
the bytes of one V-cycle, the union and gaps of device activity and the
95th percentile of a window.  Copied here so that no change to the
program moves it.
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

# NVIDIA's data sheet for one H100 SXM at its 700 W limit: HBM3 bytes/s.
PEAK_BYTES_S = 3.35e12


def vcycle_bytes_per_fine_dof(dtype_bytes: int, ndim: int = 3) -> float:
    """Device-memory bytes per fine-grid node of one V(pre, post)-cycle of
    an `ndim`-D star-stencil multigrid solver whose down leg (pre-smoothing, residual,
    restriction) and up leg (prolongation, correction, post-smoothing) are
    each one pass over the level: read sol and rhs, write sol, and write
    (down) or read (up) the coarse array, 2^-ndim of the size; summed
    over the levels, each 2^-ndim of the next.  No residual check.
    Copied from the port's runtime/performance.VCycleTrafficModel with
    fused_level=True and check_residual=False: the count holds for any
    number of smoothing steps, which one pass absorbs."""
    ratio = 0.5 ** ndim
    level_sum = 1.0 / (1.0 - ratio)
    return 2 * (3 + ratio) * level_sum * dtype_bytes


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def gaps_us(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle gaps (start, end) between the first start and the last end."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def p95(values: Sequence[float]) -> float:
    """The 95th percentile, interpolated between the ranks of the data
    (statistics.quantiles, method "inclusive")."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]

