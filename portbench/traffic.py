"""The general generator of the benchmark's traffic: the right-hand sides
of the solves, made on the device from `--seed` and a traffic file.

A traffic file (portbench/traffic/<name>.json) fixes the problem size and
the bank of right-hand sides the closed loop cycles through:

  level         finest level, 2^level + 1 nodes a side
  rhs           one entry per right-hand side of the bank, each a list of
                sine modes, one wavenumber per axis: [k, l, m] is
                sin(k pi x) sin(l pi y) sin(m pi z), [k, l] a 2D mode;
                the modes' length is the grid's dimension
  amplitude     the magnitude of every mode's coefficient
  noise         half-width of the uniform noise added at every inner
                node, as a share of `amplitude`
  warm_solves   solves of set-up before the window (each graph is
                captured in the first)
  samples       solves of a run whose solution is compared with the
                plain reference (distinct right-hand sides)
  sample_within the samples are drawn among the run's first
                `sample_within` solves
  traced_solves solves profiled after the window of a `--trace 1` run

The seed chooses each mode's sign, the noise and the order in which the
bank is served; the wavenumbers and magnitudes are the file's, so every
seed asks for the same work.  The boundary nodes of a right-hand side
are zero (every mode vanishes there).
"""

from __future__ import annotations

import hashlib
import math
import random
from typing import List

import torch

SEED_MASK = 2 ** 63 - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on `device` for one use of the seed: its 64-bit
    seed a hash of both, so that seeds of more than 32 bits differ also
    where the generator keeps only the low 32 (the CPU's)."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") & SEED_MASK)
    return g


def order(traffic: dict, seed: int) -> List[int]:
    """The order in which the bank's right-hand sides are served."""
    slots = list(range(len(traffic["rhs"])))
    random.Random(f"order:{seed}").shuffle(slots)
    return slots


def samples(traffic: dict, seed: int) -> List[int]:
    """The indices of the solves whose solutions are compared: `samples`
    of the first `sample_within` solves, with distinct right-hand sides."""
    n_rhs = len(traffic["rhs"])
    rng = random.Random(f"samples:{seed}")
    picked, slots = [], set()
    candidates = list(range(traffic["sample_within"]))
    rng.shuffle(candidates)
    for i in candidates:
        if i % n_rhs not in slots:
            picked.append(i)
            slots.add(i % n_rhs)
        if len(picked) == traffic["samples"]:
            break
    return sorted(picked)


def bank(traffic: dict, seed: int, dtype, device) -> List[torch.Tensor]:
    """The right-hand sides, in the bank's order, on `device` in `dtype`
    (computed in float64, rounded once), each of shape (n,) * dimension."""
    n = 2 ** traffic["level"] + 1
    x = torch.arange(n, dtype=torch.float64, device=device) / (n - 1)
    amp = float(traffic["amplitude"])
    out = []
    for slot, modes in enumerate(traffic["rhs"]):
        ndim = len(modes[0])
        g = generator(seed, slot, device)
        signs = torch.randint(0, 2, (len(modes),), generator=g, device=device) * 2 - 1
        f = torch.empty((n,) * ndim, dtype=torch.float64, device=device)
        f.uniform_(-1.0, 1.0, generator=g)
        f *= amp * float(traffic["noise"])
        for mode, s in zip(modes, signs.tolist()):
            axes = [torch.sin(k * math.pi * x).view([n if a == d else 1 for a in range(ndim)])
                    for d, k in enumerate(mode)]
            term = (s * amp) * (axes[0] * axes[1] if ndim > 1 else axes[0])
            for a in axes[2:]:
                term = term * a
            f += term
        for d in range(ndim):
            f.narrow(d, 0, 1).zero_()
            f.narrow(d, n - 1, 1).zero_()
        out.append(f.to(dtype))
        del f
    return out
