"""Separable inter-grid transfers as per-dimension banded contractions.

Reference: exastencils_tpu/ops/transfer.py (with
`prolongation_matrix_full_ghosted` :77-103).  The numpy functions that build
the matrices are copied verbatim (importing the reference module would
import jax); `apply_separable` contracts with `torch.tensordot`.  On the card the
contraction is a float32/float64 matmul, so TF32 must stay off (see
`torch.backends.cuda.matmul.allow_tf32`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from exastencils_tpu_torch.core.stencil import IntergridStencil


def restriction_matrix_1d(
    kernel: Sequence[float],
    lo: int,
    nodes_out: int,
    total_in: int,
    total_out: int,
    ghost_in: int = 0,
    ghost_out: int = 0,
) -> np.ndarray:
    """M[i_out, j_in]: coarse node i (array row ghost_out+i) takes
    kernel[k] from fine array column ghost_in + 2*i + lo + k.  Columns
    outside [0, total_in) are dropped (zero-ghost semantics)."""
    M = np.zeros((total_out, total_in))
    for i in range(nodes_out):
        for k, w in enumerate(kernel):
            j = ghost_in + 2 * i + lo + k
            if 0 <= j < total_in:
                M[ghost_out + i, j] += w
    return M


def prolongation_matrix_1d(
    kernel: Sequence[float],
    lo: int,
    nodes_out: int,
    total_in: int,
    total_out: int,
    ghost_in: int = 0,
    ghost_out: int = 0,
) -> np.ndarray:
    """M[j_out, c_in]: fine node j takes kernel[j - 2c - lo] from coarse
    node c (transpose pattern of the restriction)."""
    M = np.zeros((total_out, total_in))
    for j in range(nodes_out):
        for k, w in enumerate(kernel):
            num = j - lo - k
            if num % 2:
                continue
            c = num // 2
            col = ghost_in + c
            if 0 <= col < total_in and 0 <= c:
                M[ghost_out + j, col] += w
    return M


def prolongation_matrix_full_ghosted(
    kernel: Sequence[float],
    lo: int,
    total_in: int,
    total_out: int,
    ghost: int,
) -> np.ndarray:
    """Prolongation over the ENTIRE halo-extended fragment: fine ghosted
    row j takes kernel[k] from coarse ghosted row (j + g - lo - k)/2
    (parity-matching), with no zeroed ghost rows, so ghost-row values
    reproduce the neighbour fragment's interior prolongation bit for bit.
    The sharded up leg K2 corrects the whole fragment with it, where halo
    corrections must stay neighbour-consistent for the post-smoothing in
    the same pass; with ghost 0 it is prolongation_matrix_1d over all
    rows."""
    M = np.zeros((total_out, total_in))
    for j in range(total_out):
        for k, w in enumerate(kernel):
            num = j + ghost - lo - k
            if num % 2:
                continue
            c = num // 2
            if 0 <= c < total_in:
                M[j, c] += w
    return M


def separable_kernels(ig: IntergridStencil) -> Tuple[np.ndarray, ...]:
    """Per-dim 1D kernels of the (tensor-product) weight window.  Uses
    the stored factorization when present, else recovers it by rank-1
    (HOSVD-style) factorization and verifies exactness."""
    if ig.kernels_1d is not None:
        return tuple(np.asarray(k, dtype=np.float64) for k in ig.kernels_1d)
    W = np.asarray(ig.weights, dtype=np.float64)
    nd = W.ndim
    # rank-1 factor: take the slice through the peak entry along each dim
    peak = np.unravel_index(np.argmax(np.abs(W)), W.shape)
    pv = W[peak]
    kernels = []
    for d in range(nd):
        idx = list(peak)
        idx[d] = slice(None)
        kernels.append(W[tuple(idx)].copy())
    # slice through the peak along d equals k_d * (pv / k_d[peak_d]);
    # the outer product of all slices is W * pv^(nd-1), so divide all
    # but the first slice by pv
    kernels = [k / (pv if i else 1.0) for i, k in enumerate(kernels)]
    rebuilt = kernels[0]
    for k in kernels[1:]:
        rebuilt = np.multiply.outer(rebuilt, k)
    if not np.allclose(rebuilt, W, atol=1e-12):
        raise ValueError("transfer window is not separable")
    return tuple(kernels)


def apply_separable(mats: Sequence, x: torch.Tensor) -> torch.Tensor:
    """y = (M_0 x M_1 x ... ) . x, one contraction per dim; the result is
    contiguous.  `mats` are numpy arrays or tensors."""
    for d, M in enumerate(mats):
        M = torch.as_tensor(M, dtype=x.dtype, device=x.device)
        x = torch.movedim(torch.tensordot(M, x, dims=([1], [d])), 0, d)
    return x.contiguous()


def build_restrict_mats(
    ig: IntergridStencil,
    coarse_nodes: Tuple[int, ...],
    fine_total: Tuple[int, ...],
    coarse_total: Tuple[int, ...],
    ghost_in: int = 0,
    ghost_out: int = 0,
):
    kernels = separable_kernels(ig)
    return [
        restriction_matrix_1d(
            kernels[d], ig.lo[d], coarse_nodes[d], fine_total[d],
            coarse_total[d], ghost_in, ghost_out,
        )
        for d in range(ig.ndim)
    ]


def build_prolong_mats(
    ig: IntergridStencil,
    fine_nodes: Tuple[int, ...],
    coarse_total: Tuple[int, ...],
    fine_total: Tuple[int, ...],
    ghost_in: int = 0,
    ghost_out: int = 0,
):
    kernels = separable_kernels(ig)
    return [
        prolongation_matrix_1d(
            kernels[d], ig.lo[d], fine_nodes[d], coarse_total[d],
            fine_total[d], ghost_in, ghost_out,
        )
        for d in range(ig.ndim)
    ]
