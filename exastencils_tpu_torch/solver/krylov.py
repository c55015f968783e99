"""Krylov coarse-grid solvers: conjugate gradients.

Reference: exastencils_tpu/solver/krylov.py (`cg`, :37-82).  The
reference's `lax.while_loop` becomes a device loop (runtime/staging
`device_loop`): the iterates, the iteration count and the done flag stay
on the device, iterations after the exit are masked no-ops, and the host
reads the done flag once per chunk of iterations, not once per
iteration.  Inside a staged cycle the loop is a step of the recording.
The start condition `init_res <= 0` (an all-Dirichlet coarsest level
exits at once, with no 0/0) and the early-exit placement are the
reference's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from exastencils_tpu_torch.ops.reductions import dot, norm_l2
from exastencils_tpu_torch.runtime.staging import device_loop


class KrylovResult(NamedTuple):
    sol: torch.Tensor
    iterations: torch.Tensor  # 0-d int64, on the device
    residual: torch.Tensor


def _ident(x):
    return x


def cg(
    A_apply: Callable,
    sol: torch.Tensor,
    rhs: torch.Tensor,
    *,
    bc_sol: Callable = _ident,
    bc_res: Callable = _ident,
    max_its: int = 128,
    res_reduction: float = 1e-3,
    dot_fn: Callable = dot,
    norm_fn: Callable = norm_l2,
) -> KrylovResult:
    """Conjugate gradients, operation for operation the reference's:

        r = bc(rhs - A sol); p = bc(r)
        loop: Ap; alpha = <r,r>/<p,Ap>; sol += alpha p (bc);
              r -= alpha Ap (bc); early-exit on ||r|| <= eps*||r0||;
              beta = ||r_new||^2/||r||^2; p = bc(r + beta p)
    """
    r = bc_res(rhs - A_apply(sol))
    init_res = norm_fn(r)
    p = bc_res(r)

    def body(c, _it):
        sol, r, p, cur_res = c
        Ap = A_apply(p)
        alpha = dot_fn(r, r) / dot_fn(p, Ap)
        sol = bc_sol(sol + alpha * p)
        r = bc_res(r - alpha * Ap)
        next_res = norm_fn(r)
        done = next_res <= res_reduction * init_res
        beta = (next_res * next_res) / (cur_res * cur_res)
        p = bc_res(r + beta * p)
        return [sol, r, p, next_res], done

    (sol, _, _, cur_res), it, _ = device_loop([sol, r, p, init_res], body, max_its,
                                             done=init_res <= 0.0)
    return KrylovResult(sol, it, cur_res)
