"""Triangle (cloth) strain constraints (reference TriangleForce.cpp).

Selector: 2 row-groups per triangle. The rest-state 2D basis B (3,2) maps
world positions to the 3x2 deformation gradient F = X_def @ B
(TriangleForce.cpp:29-63); coeff[e,r,c] = B[e,c,r] so Dx rows are F^T.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.newton import newton_minimize
from ..ops.svd import svd3x2
from .base import ForceBatch

_D3 = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


def build_tri_basis(x: np.ndarray, faces: np.ndarray):
    """Per-triangle B (E,3,2) and rest area (E,)
    (LimitedTriangleStrain::initialize, TriangleForce.cpp:29-63)."""
    f = np.asarray(faces, dtype=np.int64)
    v = np.asarray(x, dtype=np.float64)
    x1, x2, x3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    e12 = x2 - x1
    e13 = x3 - x1
    n1 = e12 / np.linalg.norm(e12, axis=1, keepdims=True)
    t = e13 - np.einsum("ij,ij->i", e13, n1)[:, None] * n1
    n2 = t / np.linalg.norm(t, axis=1, keepdims=True)
    # Xg = basis^T @ edges (2x2): rest edges in the orthonormal tangent frame
    Xg = np.stack(
        [
            np.stack([np.einsum("ij,ij->i", n1, e12), np.einsum("ij,ij->i", n1, e13)], 1),
            np.stack([np.einsum("ij,ij->i", n2, e12), np.einsum("ij,ij->i", n2, e13)], 1),
        ],
        axis=1,
    )  # (E,2,2)
    B = np.einsum("ck,ekr->ecr", _D3, np.linalg.inv(Xg))  # (E,3,2)
    area = np.abs(np.linalg.det(Xg)) / 2.0
    return B, area


def _tri_selector_params(faces, B):
    return {
        "indices": np.asarray(faces, dtype=np.int32),
        "coeff": np.transpose(B, (0, 2, 1)).copy(),  # (E,2,3)
    }


def _F_of(Dxu):
    return jnp.swapaxes(Dxu, 1, 2)  # (E,3,2)


def _rows_of(F):
    return jnp.swapaxes(F, 1, 2)


class LimitedTriangleStrain(ForceBatch):
    """Projective-dynamics triangle strain with strain limiting: project F to
    T = U2 V^T, mix with k = stiffness*area, then clamp the column norms of z
    into [limit_min, limit_max] (TriangleForce.cpp:79-113).
    XML types `lineartrianglestrain` / `trianglestrain`."""

    R, K = 2, 3

    def __init__(self, faces, stiffness, limit_min=0.0, limit_max=9999999.0,
                 strain_limiting=True):
        self.faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        E = len(self.faces)
        self.stiffness = np.broadcast_to(np.asarray(stiffness, np.float64), (E,)).copy()
        self.limit_min = np.broadcast_to(np.asarray(limit_min, np.float64), (E,)).copy()
        self.limit_max = np.broadcast_to(np.asarray(limit_max, np.float64), (E,)).copy()
        self.strain_limiting = bool(strain_limiting)

    @property
    def n_elements(self) -> int:
        return len(self.faces)

    def build(self, x, masses, dt):
        B, area = build_tri_basis(x, self.faces)
        params = _tri_selector_params(self.faces, B)
        params["weight"] = np.sqrt(self.stiffness) * np.sqrt(area)
        params["k"] = self.stiffness * area
        params["limit_min"] = self.limit_min
        params["limit_max"] = self.limit_max
        return params, {}

    def project(self, Dx, u, params, state):
        F = _F_of(Dx + u)  # (E,3,2)
        U, s, V = jax.vmap(svd3x2)(F)
        T = jnp.einsum("eij,ekj->eik", U, V)  # U2 @ V^T, (E,3,2)
        k = params["k"][:, None, None]
        w2 = (params["weight"] ** 2)[:, None, None]
        zF = (k * T + w2 * F) / (w2 + k)

        if self.strain_limiting:
            # column norms of z, clamped into [limit_min, limit_max]
            # (TriangleForce.cpp:100-107; scale uses max(l, 1e-6))
            l = jnp.linalg.norm(zF, axis=1)  # (E,2)
            lmin = params["limit_min"][:, None]
            lmax = params["limit_max"][:, None]
            safe_l = jnp.maximum(l, 1e-6)
            scale = jnp.where(l < lmin, lmin / safe_l, jnp.where(l > lmax, lmax / safe_l, 1.0))
            zF = zF * scale[:, None, :]

        return _rows_of(zF), state


def fung_energy(sigma2, mu, b):
    """Fung exponential skin energy on 2 in-plane singular values with
    incompressibility sigma3 = 1/(sigma1*sigma2) (TriangleForce.cpp:120-144):
    mu/(2b) * (exp(b*(I1-3)) - 1)."""
    s3 = 1.0 / (sigma2[0] * sigma2[1])
    I1 = sigma2[0] ** 2 + sigma2[1] ** 2 + s3 * s3
    return mu / (2.0 * b) * (jnp.exp(b * (I1 - 3.0)) - 1.0)


class FungTriangle(ForceBatch):
    """Fung skin model: SVD -> minimize prox over 2 singular values ->
    z = U diag(sigma*) V^T (TriangleForce.cpp:164-248). b = 1, k = mu
    (TriangleForce.hpp:48, TriangleForce.cpp:195-198). L-BFGS(10 iters)
    replaced by batched Newton."""

    R, K = 2, 3
    SIGMA_FLOOR = 1e-8

    def __init__(self, faces, mu, limit_min=0.0, limit_max=9999999.0, max_iters=10):
        self.faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        E = len(self.faces)
        self.mu = np.broadcast_to(np.asarray(mu, np.float64), (E,)).copy()
        self.limit_min = limit_min
        self.limit_max = limit_max
        self.max_iters = int(max_iters)

    @property
    def n_elements(self) -> int:
        return len(self.faces)

    def build(self, x, masses, dt):
        B, area = build_tri_basis(x, self.faces)
        params = _tri_selector_params(self.faces, B)
        params["weight"] = np.sqrt(self.mu) * np.sqrt(area)
        params["mu"] = self.mu
        params["k"] = self.mu  # TriangleForce.cpp:195
        return params, {}

    def project(self, Dx, u, params, state):
        F = _F_of(Dx + u)
        U, s, V = jax.vmap(svd3x2)(F)
        iters = self.max_iters

        def solve_one(s0, mu, k):
            def objective(sig):
                return fung_energy(sig, mu, 1.0) + 0.5 * k * jnp.sum((sig - s0) ** 2)

            return newton_minimize(objective, s0, iters, floor=self.SIGMA_FLOOR)

        sigma_star = jax.vmap(solve_one)(s, params["mu"], params["k"])
        zF = jnp.einsum("eij,ej,ekj->eik", U, sigma_star, V)
        return _rows_of(zF), state


class TriArea(ForceBatch):
    """Triangle area preservation: fixed-point clamp of sigma1*sigma2 into
    [limit_min, limit_max] (TriangleForce.cpp:251-295). API-only in the
    reference (not reachable from XML)."""

    R, K = 2, 3

    def __init__(self, faces, stiffness, iters=4, limit_min=1.0, limit_max=1.0):
        self.faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        E = len(self.faces)
        self.stiffness = np.broadcast_to(np.asarray(stiffness, np.float64), (E,)).copy()
        self.iters = int(iters)
        self.limit_min = np.broadcast_to(np.asarray(limit_min, np.float64), (E,)).copy()
        self.limit_max = np.broadcast_to(np.asarray(limit_max, np.float64), (E,)).copy()

    @property
    def n_elements(self) -> int:
        return len(self.faces)

    def build(self, x, masses, dt):
        B, area = build_tri_basis(x, self.faces)
        params = _tri_selector_params(self.faces, B)
        params["weight"] = np.sqrt(self.stiffness) * np.sqrt(area)
        params["k"] = self.stiffness * area
        params["limit_min"] = self.limit_min
        params["limit_max"] = self.limit_max
        return params, {}

    def project(self, Dx, u, params, state):
        F = _F_of(Dx + u)
        U, s0, V = jax.vmap(svd3x2)(F)
        lmin, lmax = params["limit_min"], params["limit_max"]

        def fp_iter(_, Sd):
            S, d = Sd
            v = S[:, 0] * S[:, 1]
            f = v - jnp.clip(v, lmin, lmax)
            g = jnp.stack([S[:, 1], S[:, 0]], axis=1)
            gg = jnp.sum(g * g, axis=1)
            gd = jnp.sum(g * d, axis=1)
            d = -((f - gd) / jnp.where(gg > 0, gg, 1.0))[:, None] * g
            return (s0 + d, d)

        S, _ = jax.lax.fori_loop(0, self.iters, fp_iter, (s0, jnp.zeros_like(s0)))
        p = jnp.einsum("eij,ej,ekj->eik", U, S, V)
        k = params["k"][:, None, None]
        w2 = (params["weight"] ** 2)[:, None, None]
        zF = (k * p + w2 * F) / (w2 + k)
        return _rows_of(zF), state
