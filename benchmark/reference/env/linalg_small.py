# A frozen copy of serl_tpu_torch/envs/physics/linalg_small.py at commit 89bf89d,
# its CUDA binding left out: the benchmark's plain reference of the env.
"""Unrolled fixed-size linear algebra for the physics step (plain PyTorch).

Port of `serl_tpu/envs/physics/linalg_small.py`: the factorizations unroll
in Python for a static n read off the shape and run as elementwise arithmetic
on the batched leading axes. On the card this is the plain version of what
the CUDA control-step kernel (`csrc/control_step.cuh`) does per thread.

All functions take (..., n, n) / (..., n) operands. SPD factorizations clamp
the pivot at `PIVOT_EPS` so near-singular inputs degrade gracefully instead
of producing NaNs.
"""

import torch

from benchmark.reference.env.math3d import cross

PIVOT_EPS = 1e-12


def _unpack(M):
    n = M.shape[-1]
    return n, [[M[..., i, j] for j in range(n)] for i in range(n)]


def chol_unrolled(M):
    """Lower-triangular Cholesky factor of an SPD matrix as an n x n list of
    batched scalars (entries above the diagonal are None)."""
    n, m = _unpack(M)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = m[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=PIVOT_EPS))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve(L, B):
    """Solve L L^T X = B for all k columns of B (..., n, k) at once; each
    column sees the same arithmetic as a one-column solve."""
    n = len(L)
    Lc = [[None if x is None else x[..., None] for x in row] for row in L]
    y = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - Lc[i][k] * y[k]
        y[i] = s / Lc[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - Lc[k][i] * x[k]
        x[i] = s / Lc[i][i]
    return torch.stack(x, dim=-2)


def solve_spd(M, b):
    """x = M^-1 b for SPD M: (..., n, n), (..., n) -> (..., n)."""
    return _chol_solve(chol_unrolled(M), b[..., None])[..., 0]


def solve_spd_mat(M, B):
    """X = M^-1 B for SPD M: (..., n, n), (..., n, k) -> (..., n, k)."""
    return _chol_solve(chol_unrolled(M), B)


def inv_spd(M):
    """M^-1 for SPD M via the unrolled Cholesky factor."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return _chol_solve(chol_unrolled(M), eye.expand(M.shape))


def det_spd(M):
    """det(M) for (near-)SPD M = prod diag(L)^2; saturates to ~0 (instead of
    going negative) for singular inputs, which the det-threshold damping in
    opspace needs."""
    L = chol_unrolled(M)
    d = L[0][0] * L[0][0]
    for i in range(1, len(L)):
        d = d * (L[i][i] * L[i][i])
    return d


def solve3(A, b):
    """General 3x3 solve via the adjugate (12 mults + cross products)."""
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c0 = cross(r1, r2)
    det = (r0 * c0).sum(-1, keepdim=True)
    c1 = cross(r2, r0)
    c2 = cross(r0, r1)
    # A^-1 has COLUMNS c0, c1, c2 (scaled by 1/det): r_i . c_j = det * d_ij
    return (c0 * b[..., 0:1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]) / det
