"""Component-form 3×3 / 6×6 linear algebra (port of ``icpslam_tpu/ops/linalg3.py``).

Symmetric 3×3 matrices travel as six same-shaped component tensors
``(a, b, c, d, e, f) = (xx, xy, xz, yy, yz, zz)``; the packed form is a
components-first ``(6, N)`` tensor. Everything is closed-form and
elementwise — no LAPACK call per point.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _clamp_det(det: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(det.abs() < eps,
                       torch.sign(det) * eps + (det == 0).to(det.dtype) * eps, det)


def inv3(m: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) by the adjugate, |det| clamped
    away from zero."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d  # noqa: E741
    det = _clamp_det(a * A + b * B + c * C, eps)
    adj = torch.stack([A, D, G, B, E, H, C, F, I], dim=-1).reshape(m.shape)
    return adj / det[..., None, None]


def solve_psd(H: torch.Tensor, b: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """Solve ``(H + damping·diag(H) + 1e-9 I) x = b`` for symmetric PSD H
    (..., n, n), batched."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    if damping:
        H = H + damping * torch.diagonal(H, dim1=-2, dim2=-1)[..., None] * eye
    return torch.linalg.solve(H + 1e-9 * eye, b[..., None])[..., 0]


def symmetrize(m: torch.Tensor) -> torch.Tensor:
    return 0.5 * (m + m.transpose(-1, -2))


def eigvals_sym3(A: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues (..., 3) of symmetric (..., 3, 3)."""
    return torch.stack(eigvals_sym3_comps(*sym3_comps(A)), dim=-1)


def smallest_eigenvector_sym3(A: torch.Tensor, fallback: tuple = (0.0, 0.0, 1.0)) -> torch.Tensor:
    """Unit eigenvector (..., 3) of the smallest eigenvalue of symmetric (..., 3, 3)."""
    return torch.stack(smallest_eigenvector_sym3_comps(*sym3_comps(A), fallback=fallback), dim=-1)


def _sym_rows(xx, xy, xz, yy, yz, zz) -> torch.Tensor:
    return torch.stack([torch.stack([xx, xy, xz], dim=-1), torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def pack_sym3(A: torch.Tensor) -> torch.Tensor:
    """Symmetric (..., 3, 3) → (..., 6) as ``[xx, xy, xz, yy, yz, zz]``."""
    return torch.stack(sym3_comps(A), dim=-1)


def unpack_sym3(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_sym3`: (..., 6) → symmetric (..., 3, 3)."""
    return _sym_rows(*p.unbind(-1))


def mat_to_sym6(A: torch.Tensor) -> torch.Tensor:
    """Symmetric (..., 3, 3) → the components-first (6, ...) layout of the
    registration path."""
    return torch.stack(sym3_comps(A))


def sym6_to_mat(c: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`mat_to_sym6`: (6, ...) → symmetric (..., 3, 3)."""
    return _sym_rows(*c.unbind(0))


def sym3_comps(A: torch.Tensor):
    """Split symmetric (..., 3, 3) into its six (...,) components."""
    return (
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
    )


def inv_sym3_comps(a, b, c, d, e, f, eps: float = 1e-12):
    """Inverse of ``[[a,b,c],[b,d,e],[c,e,f]]`` with a clamped determinant."""
    cof00 = d * f - e * e
    cof01 = c * e - b * f
    cof02 = b * e - c * d
    det = _clamp_det(a * cof00 + b * cof01 + c * cof02, eps)
    inv_det = 1.0 / det
    return (
        cof00 * inv_det,
        cof01 * inv_det,
        cof02 * inv_det,
        (a * f - c * c) * inv_det,
        (b * c - a * e) * inv_det,
        (a * d - b * b) * inv_det,
    )


def rotate_sym3_comps(R: torch.Tensor, comps):
    """``B = R C Rᵀ`` for one (3, 3) rotation ``R`` and symmetric C given as
    six components; returns B's six components. Same unrolled sums as the
    JAX version (k ascending), evaluated on stacked rows."""
    a, b, c, d, e, f = comps
    C = ((a, b, c), (b, d, e), (c, e, f))
    V = [
        [R[i, 0] * C[0][j] + R[i, 1] * C[1][j] + R[i, 2] * C[2][j] for j in range(3)]
        for i in range(3)
    ]
    B = [
        [V[i][0] * R[j, 0] + V[i][1] * R[j, 1] + V[i][2] * R[j, 2] for j in range(3)]
        for i in range(3)
    ]
    return B[0][0], B[0][1], B[0][2], B[1][1], B[1][2], B[2][2]


def rotate_sym6(covs6: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """R C Rᵀ for packed (6, N) covariances."""
    return torch.stack(rotate_sym3_comps(R, tuple(covs6.unbind(0))))


def eigvals_sym3_comps(a00, a01, a02, a11, a12, a22):
    """Ascending eigenvalues of a symmetric 3×3 (trigonometric Cardano)."""
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    small = p2 < 1e-20
    p = torch.sqrt(torch.where(small, torch.ones_like(p2), p2) / 6.0)
    pinv = torch.where(small, torch.zeros_like(p), 1.0 / p)
    b00, b11, b22 = d0 * pinv, d1 * pinv, d2 * pinv
    b01, b02, b12 = a01 * pinv, a02 * pinv, a12 * pinv
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(0.5 * detB, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    e_lo = torch.where(small, q, e_lo)
    e_mid = torch.where(small, q, e_mid)
    e_hi = torch.where(small, q, e_hi)
    return e_lo, e_mid, e_hi


def smallest_eigenvector_sym3_comps(a, b, c, d, e, f, fallback=(0.0, 0.0, 1.0)):
    """Unit eigenvector of the smallest eigenvalue, from the best-conditioned
    row cross product of ``A − λ_min I``; near-isotropic → ``fallback``."""
    lam = eigvals_sym3_comps(a, b, c, d, e, f)[0]
    r0 = (a - lam, b, c)
    r1 = (b, d - lam, e)
    r2 = (c, e, f - lam)

    def cross(u, v):
        return (
            u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0],
        )

    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01 = c01[0] ** 2 + c01[1] ** 2 + c01[2] ** 2
    n02 = c02[0] ** 2 + c02[1] ** 2 + c02[2] ** 2
    n12 = c12[0] ** 2 + c12[1] ** 2 + c12[2] ** 2
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = ~use01 & (n02 >= n12)
    v = tuple(
        torch.where(use01, x01, torch.where(use02, x02, x12))
        for x01, x02, x12 in zip(c01, c02, c12)
    )
    n = torch.sqrt(torch.where(use01, n01, torch.where(use02, n02, n12)))
    ok = n > 1e-10
    inv_n = torch.where(ok, 1.0 / torch.where(ok, n, torch.ones_like(n)), 0.0)
    return tuple(
        torch.where(ok, vi * inv_n, torch.full_like(vi, fb))
        for vi, fb in zip(v, fallback)
    )


def solve_chol_unrolled(H: np.ndarray, b: np.ndarray, damping: float = 0.0) -> np.ndarray:
    """Solve ``(H + damping·diag(H) + 1e-9 I) x = b`` for one small SPD
    system by the JAX version's unrolled Cholesky (guarded sqrt), in
    float32 on the host.

    The port runs this on the host on purpose: the ICP loop already brings
    the reduced GN sums back once per iteration for its early-exit test,
    and ~n³/3 scalar steps as separate device launches would cost more
    than the whole reduction they follow.
    """
    H = np.asarray(H, np.float32)
    b = np.asarray(b, np.float32)
    n = H.shape[-1]
    f32 = np.float32
    d = (f32(damping) * np.diagonal(H) + f32(1e-9)) if damping else np.full((n,), 1e-9, np.float32)
    A = [[H[i, j] + (d[i] if i == j else f32(0.0)) for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = np.sqrt(max(s, f32(1e-30)))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return np.asarray(x, np.float32)

