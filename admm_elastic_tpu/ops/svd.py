"""Branch-free batched small SVDs.

The reference computes per-element 3x3 / 3x2 SVDs with Eigen's JacobiSVD
(TetForce.cpp:80-102, TriangleForce.cpp:90) inside an OpenMP loop. Here we
need a fixed-iteration, branch-free formulation that vmaps over millions of
elements: cyclic-Jacobi eigendecomposition of F^T F followed by a safe
orthonormalization of F V.

`svd3x3_oriented` reproduces the reference's `oriented_svd` semantics
(TetForce.cpp:88-100): U and V are proper rotations (det=+1) and any
reflection is absorbed into the sign of the LAST singular value, so
sigma = (s0, s1, s2) with s0 >= s1 >= |s2| and sign(s2) = sign(det F).

All functions operate on single matrices and are meant to be `jax.vmap`-ed;
they contain no data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_JACOBI_SWEEPS = 6  # 6 cyclic sweeps drive off-diagonals below fp64 roundoff for 3x3


def _jacobi_rotation(app, aqq, apq, eps):
    """Returns (c, s) of the Jacobi rotation annihilating apq. Branch-free."""
    tau = (aqq - app) / (2.0 * jnp.where(jnp.abs(apq) < eps, 1.0, apq))
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(jnp.abs(apq) < eps, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    return c, s


def eigh_sym3x3(A: jax.Array):
    """Eigendecomposition of a symmetric 3x3 via fixed-sweep cyclic Jacobi.

    Returns (w, V): eigenvalues descending, V columns are eigenvectors,
    A = V diag(w) V^T. det(V) = +1 is NOT guaranteed (columns are permuted
    for sorting); callers needing a rotation fix the sign themselves.

    Implemented with scalar arithmetic only (no scatters/gathers) so it
    compiles fast and maps onto the VPU cleanly under vmap.
    """
    dtype = A.dtype
    eps = jnp.asarray(jnp.finfo(dtype).tiny * 1e3, dtype)
    scale = jnp.maximum(jnp.max(jnp.abs(A)), jnp.asarray(1.0, dtype))
    # symmetric state: diagonal (a00,a11,a22) + off-diagonals (a01,a02,a12)
    a00, a11, a22 = A[0, 0] / scale, A[1, 1] / scale, A[2, 2] / scale
    a01, a02, a12 = A[0, 1] / scale, A[0, 2] / scale, A[1, 2] / scale
    one = jnp.asarray(1.0, dtype)
    zero = jnp.asarray(0.0, dtype)
    v = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]  # v[row][col]

    def rot_cols(p, q, c, s):
        for r in range(3):
            vp, vq = v[r][p], v[r][q]
            v[r][p] = c * vp - s * vq
            v[r][q] = s * vp + c * vq

    for _ in range(_JACOBI_SWEEPS):
        # (p,q) = (0,1)
        c, s = _jacobi_rotation(a00, a11, a01, eps)
        n00 = c * c * a00 - 2 * s * c * a01 + s * s * a11
        n11 = s * s * a00 + 2 * s * c * a01 + c * c * a11
        n02 = c * a02 - s * a12
        n12 = s * a02 + c * a12
        a00, a11, a01, a02, a12 = n00, n11, zero, n02, n12
        rot_cols(0, 1, c, s)
        # (p,q) = (0,2)
        c, s = _jacobi_rotation(a00, a22, a02, eps)
        n00 = c * c * a00 - 2 * s * c * a02 + s * s * a22
        n22 = s * s * a00 + 2 * s * c * a02 + c * c * a22
        n01 = c * a01 - s * a12
        n12 = s * a01 + c * a12
        a00, a22, a02, a01, a12 = n00, n22, zero, n01, n12
        rot_cols(0, 2, c, s)
        # (p,q) = (1,2)
        c, s = _jacobi_rotation(a11, a22, a12, eps)
        n11 = c * c * a11 - 2 * s * c * a12 + s * s * a22
        n22 = s * s * a11 + 2 * s * c * a12 + c * c * a22
        n01 = c * a01 - s * a02
        n02 = s * a01 + c * a02
        a11, a22, a12, a01, a02 = n11, n22, zero, n01, n02
        rot_cols(1, 2, c, s)

    w = [a00 * scale, a11 * scale, a22 * scale]
    # branch-free descending sort of (eigenvalue, eigenvector-column) pairs —
    # a 3-element sorting network of where-swaps keeps everything elementwise
    # (jnp.argsort would lower to a sort op and break XLA fusion)
    cols = [[v[r][c] for r in range(3)] for c in range(3)]

    def cswap(i, j):
        swap = w[i] < w[j]
        w[i], w[j] = (
            jnp.where(swap, w[j], w[i]),
            jnp.where(swap, w[i], w[j]),
        )
        for r in range(3):
            ci, cj = cols[i][r], cols[j][r]
            cols[i][r] = jnp.where(swap, cj, ci)
            cols[j][r] = jnp.where(swap, ci, cj)

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)

    W = jnp.stack(w)
    V = jnp.stack(
        [jnp.stack([cols[c][r] for c in range(3)]) for r in range(3)]
    )  # (row, col)
    return W, V


def _safe_normalize(v, fallback, eps):
    n = jnp.linalg.norm(v)
    safe = n > eps
    return jnp.where(safe, v / jnp.where(safe, n, 1.0), fallback), safe


def _det3(M):
    """Elementwise 3x3 determinant (jnp.linalg.det lowers to LU)."""
    return jnp.dot(M[:, 0], jnp.cross(M[:, 1], M[:, 2]))


def _orthogonal_to(u):
    """A unit vector orthogonal to unit vector u, branch-free."""
    # pick the axis least aligned with u via where-chains, project, normalize
    au = jnp.abs(u)
    use_x = (au[0] <= au[1]) & (au[0] <= au[2])
    use_y = (~use_x) & (au[1] <= au[2])
    ax = jnp.where(
        use_x,
        jnp.array([1.0, 0.0, 0.0], u.dtype),
        jnp.where(
            use_y,
            jnp.array([0.0, 1.0, 0.0], u.dtype),
            jnp.array([0.0, 0.0, 1.0], u.dtype),
        ),
    )
    w = ax - jnp.dot(ax, u) * u
    return w / jnp.linalg.norm(w)


def svd3x3_oriented(F: jax.Array):
    """Oriented SVD of a single 3x3: F = U diag(s) V^T with det U = det V = +1.

    s is sorted s0 >= s1 >= |s2|; s2 < 0 iff det F < 0 (inverted element).
    Safe for rank-deficient and zero F (returns identity factors).
    """
    dtype = F.dtype
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    w, V = eigh_sym3x3(F.T @ F)
    # make V a proper rotation: flip the last column if reflected
    detV = _det3(V)
    flip = jnp.where(detV < 0, -1.0, 1.0).astype(dtype)
    V = V * jnp.stack([jnp.ones_like(flip), jnp.ones_like(flip), flip])

    B = F @ V  # columns b_i = s_i * u_i
    norm_scale = jnp.sqrt(jnp.maximum(w[0], 0.0)) + eps
    tol = eps * 16.0 * norm_scale

    u0, ok0 = _safe_normalize(B[:, 0], jnp.array([1.0, 0.0, 0.0], dtype), tol)
    b1p = B[:, 1] - jnp.dot(u0, B[:, 1]) * u0
    u1, ok1 = _safe_normalize(b1p, _orthogonal_to(u0), tol)
    u2 = jnp.cross(u0, u1)
    U = jnp.stack([u0, u1, u2], axis=1)

    s0 = jnp.dot(u0, B[:, 0])
    s1 = jnp.dot(u1, B[:, 1])
    s2 = jnp.dot(u2, B[:, 2])  # signed: negative iff det F < 0
    s = jnp.stack([s0, s1, s2])
    return U, s, V


def polar_project(F: jax.Array):
    """Nearest proper rotation (det +1) to F.

    This is exactly the reference's LinearTetStrain projection: with a plain
    SVD (sigma >= 0) it sets S=(1,1,1) and flips S[2] when det F < 0
    (TetForce.cpp:137-143) — the flip compensates the improper factor, so the
    result is always the closest element of SO(3). With our oriented SVD
    (det U = det V = +1) that is simply U V^T.
    """
    U, _, V = svd3x3_oriented(F)
    return U @ V.T


def eigh_sym2x2(A: jax.Array):
    """Closed-form eigendecomposition of symmetric 2x2; eigenvalues descending,
    V orthogonal (columns may be permuted for sorting, so det may be -1)."""
    a, b, d = A[0, 0], A[0, 1], A[1, 1]
    half_tr = 0.5 * (a + d)
    half_diff = 0.5 * (a - d)
    rad = jnp.sqrt(half_diff * half_diff + b * b)
    w = jnp.stack([half_tr + rad, half_tr - rad])
    theta = 0.5 * jnp.arctan2(2.0 * b, a - d)
    c, s = jnp.cos(theta), jnp.sin(theta)
    V = jnp.array([[c, -s], [s, c]], dtype=A.dtype)
    # ensure column order matches descending eigenvalues
    swap = a * c * c + 2 * b * c * s + d * s * s < a * s * s - 2 * b * c * s + d * c * c
    V = jnp.where(swap, V[:, ::-1], V)
    return w, V


def svd3x2(F: jax.Array):
    """Thin SVD of a single 3x2: F = U diag(s) V^T, U (3,2) orthonormal columns,
    V (2,2) rotation, s0 >= s1 >= 0. Matches JacobiSVD thin-U semantics used by
    the triangle forces (TriangleForce.cpp:90-93)."""
    dtype = F.dtype
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    w, V = eigh_sym2x2(F.T @ F)
    w = jnp.maximum(w, 0.0)
    s = jnp.sqrt(w)
    B = F @ V
    tol = eps * 16.0 * (s[0] + eps)
    u0, _ = _safe_normalize(B[:, 0], jnp.array([1.0, 0.0, 0.0], dtype), tol)
    b1p = B[:, 1] - jnp.dot(u0, B[:, 1]) * u0
    u1, _ = _safe_normalize(b1p, _orthogonal_to(u0), tol)
    U = jnp.stack([u0, u1], axis=1)
    # recompute s with signs from projection (>=0 up to roundoff for true SVD)
    s = jnp.stack([jnp.dot(u0, B[:, 0]), jnp.dot(u1, B[:, 1])])
    return U, s, V
