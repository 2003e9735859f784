"""Closed-form 3x3 determinant / inverse on torch tensors, and the 6x6
inverse by block-Schur elimination on them.

The same cofactor formulas as the CUDA element kernels (csrc/element_forms.cuh),
so the plain path and the kernels round alike. Works under torch.func
transforms (vmap, jacfwd)."""
import torch


def det3(A):
    """Determinant of (..., 3, 3)."""
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def adj3(A):
    """Adjugate of (..., 3, 3): the transposed cofactor matrix."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    return torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )


def inv3(A, det=None):
    """Inverse of (..., 3, 3) via adjugate."""
    if det is None:
        det = det3(A)
    return adj3(A) / det[..., None, None]


def inv6(M):
    """Inverse of (..., 6, 6) via 2x2 block-Schur elimination with
    closed-form 3x3 inverses, exact-grade in float64 (vasp_tpu's
    fem/smallmat.py inv6, the node-block preconditioner's inverse).

    M = [[A, B], [C, D]]; inv = [[A^-1 + A^-1 B S^-1 C A^-1, -A^-1 B S^-1],
                                 [-S^-1 C A^-1, S^-1]], S = D - C A^-1 B."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ai = inv3(A)
    AiB = Ai @ B
    S = D - C @ AiB
    Si = inv3(S)
    CAi = C @ Ai
    top_left = Ai + AiB @ Si @ CAi
    top_right = -(AiB @ Si)
    bot_left = -(Si @ CAi)
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)
