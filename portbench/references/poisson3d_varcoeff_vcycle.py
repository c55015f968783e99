"""Plain PyTorch reference of the variable-coefficient Poisson3D solves.

-div(kappa grad u) = f on the unit cube with kappa(x, y, z) =
exp(kappa0 (x - x^2)(y - y^2)(z - z^2)), the conservative 7-point scheme
on the nodes of a uniform grid of 2^level + 1 nodes a side (axis d is
coordinate d):

    (A u)_i = sum_d [k_{i+1/2 e_d} (u_i - u_{i+e_d}) + k_{i-1/2 e_d} (u_i - u_{i-e_d})] / h^2

each k the value of kappa at the edge's midpoint, every level
discretised on its own grid (no Galerkin product), Dirichlet data on the
boundary.  V(pre, post)-cycles of damped red-black Gauss-Seidel (colour
(i + j + k) % 2, colour 0 first), full-weighting restriction [1/4, 1/2,
1/4]^3 of the residual, trilinear prolongation of the correction and
conjugate gradients on the coarsest level, until the residual's 2-norm
has dropped by `target_res_reduction` or `max_cycles` cycles have run.

Everything is worked out again from a configuration's keys (see `solve`;
kappa0 is `kappa["kappa0"]`).  This file imports nothing of the program
under test, and takes nothing it made: it gets the right-hand side and
its own settings, and computes in the dtype it is given.  A colour
half-sweep updates the four parity classes of its colour through
stride-2 views, as poisson3d_vcycle.py does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

INNER = (slice(1, -1),) * 3
# the parity classes (i, j, k) % 2 of each colour (i + j + k) % 2
CLASSES = {c: [(a, b, (c - a - b) % 2) for a in (0, 1) for b in (0, 1)] for c in (0, 1)}
TRIG = {"sin": torch.sin, "cos": torch.cos}


def positions(level: int, dtype, device) -> torch.Tensor:
    """The node positions i / 2^level of one axis of the unit cube."""
    n = 2 ** level + 1
    return torch.arange(n, dtype=torch.float64, device=device).div_(n - 1).to(dtype)


def dirichlet(terms: Sequence[dict], level: int, dtype, device) -> torch.Tensor:
    """The iterate a solve starts from: zero inside, on the boundary the
    sum of the configuration's `dirichlet` terms, each
    {"coef": c, "fn": "sin"|"cos", "k": k, "axis": d} = c fn(k pi x_d)."""
    n = 2 ** level + 1
    u = torch.zeros((n, n, n), dtype=dtype, device=device)
    x = positions(level, dtype, device)
    for t in terms:
        shape = [1, 1, 1]
        shape[t["axis"]] = n
        u += (t["coef"] * TRIG[t["fn"]](t["k"] * math.pi * x)).reshape(shape)
    u[INNER] = 0
    return u


class Level:
    """The operator of one level: w[d] = kappa / h^2 at the midpoints
    between nodes j and j + 1 along axis d (n - 1 values along d, n along
    the others), and the diagonal, their sum over a node's six edges
    (zero on the boundary)."""

    def __init__(self, level: int, kappa0: float, dtype, device):
        n = 2 ** level + 1
        inv_h2 = float(4 ** level)
        x = positions(level, dtype, device)
        mid = (torch.arange(n - 1, dtype=torch.float64, device=device) + 0.5).div_(n - 1).to(dtype)
        self.w = []
        for d in range(3):
            axes = [(mid if a == d else x).reshape([-1 if b == a else 1 for b in range(3)])
                    for a in range(3)]
            q = [t - t * t for t in axes]
            self.w.append(torch.exp(kappa0 * q[0] * q[1] * q[2]) * inv_h2)
        wx, wy, wz = self.w
        self.diag = torch.zeros((n, n, n), dtype=dtype, device=device)
        self.diag[INNER] = (wx[:-1, 1:-1, 1:-1] + wx[1:, 1:-1, 1:-1]
                            + wy[1:-1, :-1, 1:-1] + wy[1:-1, 1:, 1:-1]
                            + wz[1:-1, 1:-1, :-1] + wz[1:-1, 1:-1, 1:])


def _par(p: int, n: int, shift: int = 0) -> slice:
    """The inner indices of parity p of an axis of n nodes, shifted."""
    start = (1 if p else 2) + shift
    return slice(start, n - 1 + shift, 2)


def half_sweep(u, f, colour: int, op: Level, omega: float):
    """One colour of damped Gauss-Seidel, in place on the inner nodes:
    u += omega / diag (f - A u) where (i + j + k) % 2 == colour.  Node i's
    edge to i - e_d is w[d][i - 1], its edge to i + e_d is w[d][i]."""
    n = u.shape[0]
    wx, wy, wz = op.w
    for a, b, c in CLASSES[colour]:
        si, sj, sk = _par(a, n), _par(b, n), _par(c, n)
        mi, mj, mk = _par(a, n, -1), _par(b, n, -1), _par(c, n, -1)
        acc = wx[mi, sj, sk] * u[mi, sj, sk] + wx[si, sj, sk] * u[_par(a, n, 1), sj, sk]
        acc += wy[si, mj, sk] * u[si, mj, sk]
        acc += wy[si, sj, sk] * u[si, _par(b, n, 1), sk]
        acc += wz[si, sj, mk] * u[si, sj, mk]
        acc += wz[si, sj, sk] * u[si, sj, _par(c, n, 1)]
        uc = u[si, sj, sk]
        diag = op.diag[si, sj, sk]
        au = diag * uc - acc
        uc += (omega / diag) * (f[si, sj, sk] - au)


def apply_inner(u, op: Level) -> torch.Tensor:
    """(A u) on the inner nodes, shape (n - 2)^3."""
    wx, wy, wz = op.w
    acc = wx[:-1, 1:-1, 1:-1] * u[:-2, 1:-1, 1:-1] + wx[1:, 1:-1, 1:-1] * u[2:, 1:-1, 1:-1]
    acc += wy[1:-1, :-1, 1:-1] * u[1:-1, :-2, 1:-1]
    acc += wy[1:-1, 1:, 1:-1] * u[1:-1, 2:, 1:-1]
    acc += wz[1:-1, 1:-1, :-1] * u[1:-1, 1:-1, :-2]
    acc += wz[1:-1, 1:-1, 1:] * u[1:-1, 1:-1, 2:]
    return op.diag[INNER] * u[INNER] - acc


def residual(u, f, op: Level) -> torch.Tensor:
    """f - A u inside, 0 on the boundary."""
    r = torch.zeros_like(u)
    r[INNER] = f[INNER] - apply_inner(u, op)
    return r


def _along(a, axis: int, s: slice):
    idx = [slice(None)] * 3
    idx[axis] = s
    return a[tuple(idx)]


def restrict(r) -> torch.Tensor:
    """Full weighting onto the coarse grid's inner nodes; coarse boundary 0."""
    n = r.shape[0]
    nc = (n + 1) // 2
    a = r
    for axis in range(3):
        a = (0.5 * _along(a, axis, slice(2, n - 2, 2))
             + 0.25 * (_along(a, axis, slice(1, n - 3, 2)) + _along(a, axis, slice(3, n - 1, 2))))
    out = torch.zeros((nc,) * 3, dtype=r.dtype, device=r.device)
    out[INNER] = a
    return out


def prolong(c) -> torch.Tensor:
    """Trilinear interpolation of a coarse grid function onto the fine grid."""
    a = c
    for axis in range(3):
        m = a.shape[axis]
        shape = list(a.shape)
        shape[axis] = 2 * m - 1
        out = torch.empty(shape, dtype=a.dtype, device=a.device)
        _along(out, axis, slice(0, None, 2)).copy_(a)
        _along(out, axis, slice(1, None, 2)).copy_(
            0.5 * (_along(a, axis, slice(0, m - 1)) + _along(a, axis, slice(1, m))))
        a = out
    return a


def coarse_cg(u, f, op: Level, max_its: int, res_reduction: float):
    """Conjugate gradients on the coarsest level, in place on u's inner
    nodes, until ||r|| <= res_reduction ||r0|| or max_its iterations; r
    and the search direction are zero on the boundary.  A level with no
    inner node (or a zero residual) returns at once."""
    r = residual(u, f, op)
    rr = torch.linalg.vector_norm(r)
    rr0 = rr
    if not bool(rr0 > 0):
        return u
    p = r.clone()
    for _ in range(max_its):
        ap = torch.zeros_like(p)
        ap[INNER] = apply_inner(p, op)
        step = rr * rr / torch.sum(p * ap)
        u[INNER] += step * p[INNER]
        r -= step * ap
        rr_new = torch.linalg.vector_norm(r)
        if bool(rr_new <= res_reduction * rr0):
            break
        p = r + (rr_new * rr_new) / (rr * rr) * p
        rr = rr_new
    return u


def vcycle(u, f, level: int, cfg: dict, ops: Dict[int, Level]):
    """One V(pre, post)-cycle on `level`, in place on u's inner nodes."""
    op = ops[level]
    if level == cfg["min_level"]:
        cg = cfg["coarse"]
        return coarse_cg(u, f, op, cg["max_its"], cg["res_reduction"])
    omega = cfg["omega"]
    for _ in range(cfg["pre"]):
        half_sweep(u, f, 0, op, omega)
        half_sweep(u, f, 1, op, omega)
    fc = restrict(residual(u, f, op))
    uc = vcycle(torch.zeros_like(fc), fc, level - 1, cfg, ops)
    del fc
    u[INNER] += prolong(uc)[INNER]
    del uc
    for _ in range(cfg["post"]):
        half_sweep(u, f, 0, op, omega)
        half_sweep(u, f, 1, op, omega)
    return u


def res_norm(u, f, op: Level) -> float:
    return float(torch.linalg.vector_norm(residual(u, f, op)))


def solve(cfg: dict, f, level: int, dtype) -> Tuple[torch.Tensor, int, List[float]]:
    """(u, cycles, residual norms r0, r1, ...) of one solve of the
    configuration `cfg` (its keys `kappa`, `min_level`, `omega`, `pre`,
    `post`, `coarse`, `dirichlet`, `target_res_reduction`, `max_cycles`)
    with the right-hand side f at `level`, from zero inside, in `dtype` on
    f's device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f = f.to(dtype)
    kappa0 = float(cfg["kappa"]["kappa0"])
    ops = {lvl: Level(lvl, kappa0, dtype, f.device) for lvl in range(cfg["min_level"], level + 1)}
    u = dirichlet(cfg["dirichlet"], level, dtype, f.device)
    norms = [res_norm(u, f, ops[level])]
    cycles = 0
    while cycles < cfg["max_cycles"] and not norms[-1] <= cfg["target_res_reduction"] * norms[0]:
        vcycle(u, f, level, cfg, ops)
        cycles += 1
        norms.append(res_norm(u, f, ops[level]))
    return u, cycles, norms
