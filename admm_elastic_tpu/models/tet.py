"""Tetrahedral strain constraints (reference TetForce.cpp).

Selector: each tet contributes 3 row-groups; Dx reshaped is the deformation
gradient F = X_def @ B with B = D4 @ inv(rest edge matrix) (4x3)
(TetForce.cpp:28-77). We store coeff[e,r,c] = B[e,c,r] so the canonical
(E,R,3) layout Dx[e,r,:] holds F^T rows; F = Dx^T per element.

Sign convention note: the reference reconstructs z from a *plain* SVD
(sigma >= 0, U/V possibly improper) after modifying the singular values; we
use the oriented SVD (proper rotations, signed s2). The two reconstructions
are related by flipping the third modified singular value when det F < 0 —
see `_reconstruct_plain`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.newton import newton_minimize
from ..ops.svd import polar_project, svd3x3_oriented
from .base import ForceBatch

_D4 = np.array(
    [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
)


def build_tet_basis(x: np.ndarray, tets: np.ndarray):
    """Per-tet B (E,4,3) and volume (E,) from rest positions
    (helper::init_tet_force, TetForce.cpp:28-57)."""
    t = np.asarray(tets, dtype=np.int64)
    v = np.asarray(x, dtype=np.float64)
    v0, v1, v2, v3 = (v[t[:, i]] for i in range(4))
    edges = np.stack([v1 - v0, v2 - v0, v3 - v0], axis=2)  # (E,3,3) columns
    det = np.linalg.det(edges)
    bad = np.flatnonzero(np.abs(det) < 1e-300)
    if bad.size:
        raise ValueError(
            f"degenerate (zero-volume) rest tet(s) at indices {bad[:8].tolist()}"
            f"{'...' if bad.size > 8 else ''}: cannot build rest basis"
        )
    edges_inv = np.linalg.inv(edges)
    B = np.einsum("ck,ekr->ecr", _D4, edges_inv)  # (E,4,3)
    volume = np.abs(np.einsum("ij,ij->i", v0 - v3, np.cross(v1 - v3, v2 - v3))) / 6.0
    return B, volume


def _tet_selector_params(tets, B):
    """coeff[e,r,c] = B[e,c,r] -> (E,3,4)."""
    return {
        "indices": np.asarray(tets, dtype=np.int32),
        "coeff": np.transpose(B, (0, 2, 1)).copy(),
    }


def _F_of(Dxu):
    """(E,R=3,3) canonical rows -> (E,3,3) deformation gradients."""
    return jnp.swapaxes(Dxu, 1, 2)


def _rows_of(F):
    return jnp.swapaxes(F, 1, 2)


def _reconstruct_plain(U, V, s_mod, s2_sign):
    """U_o diag(s_mod') V_o^T equal to the reference's plain-SVD reconstruction
    U_p diag(s_mod) V_p^T: flip the third entry when the element is inverted
    (plain factors absorb the reflection that our oriented factors put into
    sign(s2))."""
    flip = jnp.where(s2_sign < 0, -1.0, 1.0)
    s = jnp.asarray(s_mod).at[:, 2].multiply(flip)
    return jnp.einsum("eij,ej,ekj->eik", U, s, V)


class LinearTetStrain(ForceBatch):
    """Corotational/ARAP-style tet: project F to the closest rotation and mix
    with k = stiffness * volume (TetForce.cpp:112-153)."""

    R, K = 3, 4

    def __init__(self, tets: np.ndarray, stiffness, weight_scale=1.0):
        self.tets = np.asarray(tets, dtype=np.int32).reshape(-1, 4)
        self.stiffness = np.broadcast_to(
            np.asarray(stiffness, dtype=np.float64), (len(self.tets),)
        ).copy()
        self.weight_scale = weight_scale  # parsed but unused, like the reference

    @property
    def n_elements(self) -> int:
        return len(self.tets)

    def build(self, x, masses, dt):
        B, vol = build_tet_basis(x, self.tets)
        params = _tet_selector_params(self.tets, B)
        params["weight"] = np.sqrt(self.stiffness) * np.sqrt(vol)
        params["k"] = self.stiffness * vol
        return params, {}

    def project(self, Dx, u, params, state):
        F = _F_of(Dx + u)
        R = jax.vmap(polar_project)(F)
        k = params["k"][:, None, None]
        w2 = (params["weight"] ** 2)[:, None, None]
        zF = (k * R + w2 * F) / (w2 + k)
        return _rows_of(zF), state


class TetVolume(ForceBatch):
    """Volume preservation: fixed-point projection of singular values so
    det(Sigma) lands in [limit_min, limit_max] (TetForce.cpp:160-210).
    XML force type `volpres` (ForceBuilder.cpp:406-435)."""

    R, K = 3, 4
    FP_ITERS = 4  # reference uses 4 fixed-point iterations (TetForce.cpp:188)

    def __init__(self, tets, stiffness, limit_min=1.0, limit_max=1.0):
        self.tets = np.asarray(tets, dtype=np.int32).reshape(-1, 4)
        E = len(self.tets)
        self.stiffness = np.broadcast_to(
            np.asarray(stiffness, dtype=np.float64), (E,)
        ).copy()
        self.limit_min = np.broadcast_to(np.asarray(limit_min, np.float64), (E,)).copy()
        self.limit_max = np.broadcast_to(np.asarray(limit_max, np.float64), (E,)).copy()

    @property
    def n_elements(self) -> int:
        return len(self.tets)

    def build(self, x, masses, dt):
        B, vol = build_tet_basis(x, self.tets)
        params = _tet_selector_params(self.tets, B)
        params["weight"] = np.sqrt(self.stiffness) * np.sqrt(vol)
        params["k"] = self.stiffness * vol
        params["limit_min"] = self.limit_min
        params["limit_max"] = self.limit_max
        return params, {}

    def project(self, Dx, u, params, state):
        F = _F_of(Dx + u)
        U, s, V = jax.vmap(svd3x3_oriented)(F)
        s2_sign = s[:, 2]
        # plain-SVD singular values are all non-negative
        s0 = jnp.abs(s)

        lmin, lmax = params["limit_min"], params["limit_max"]

        def fp_iter(_, Sd):
            S, d = Sd
            detS = S[:, 0] * S[:, 1] * S[:, 2]
            f = detS - jnp.clip(detS, lmin, lmax)
            g = jnp.stack(
                [S[:, 1] * S[:, 2], S[:, 0] * S[:, 2], S[:, 0] * S[:, 1]], axis=1
            )
            gg = jnp.sum(g * g, axis=1)
            gd = jnp.sum(g * d, axis=1)
            d = -((f - gd) / jnp.where(gg > 0, gg, 1.0))[:, None] * g
            return (s0 + d, d)

        S, _ = jax.lax.fori_loop(0, self.FP_ITERS, fp_iter, (s0, jnp.zeros_like(s0)))
        # reference overwrites S[2] = -1 for inverted elements (TetForce.cpp:196)
        S = jnp.where(s2_sign[:, None] < 0, S.at[:, 2].set(-1.0), S)
        p = _reconstruct_plain(U, V, S, s2_sign)
        k = params["k"][:, None, None]
        w2 = (params["weight"] ** 2)[:, None, None]
        zF = (k * p + w2 * F) / (w2 + k)
        return _rows_of(zF), state


def nh_energy(sigma, mu, lam):
    """Neo-Hookean energy density on singular values (TetForce.cpp:216-225):
    0.5 mu (I1 - log I3 - 3) + (lambda/8) log(I3)^2, I3 = det(Sigma)^2."""
    det = sigma[0] * sigma[1] * sigma[2]
    I1 = jnp.sum(sigma * sigma)
    log_I3 = 2.0 * jnp.log(det)
    return 0.5 * mu * (I1 - log_I3 - 3.0) + 0.125 * lam * log_I3 * log_I3


def stvk_energy(sigma, mu, lam):
    """St. Venant-Kirchhoff on singular values (TetForce.cpp:269-278):
    mu ||E||^2 + lambda/2 tr(E)^2, E = (Sigma^2 - I)/2."""
    E = 0.5 * (sigma * sigma - 1.0)
    return mu * jnp.sum(E * E) + 0.5 * lam * jnp.sum(E) ** 2


def nh_grad_hess(sigma, mu, lam, k, sigma0):
    """Closed-form gradient and Hessian of the NH proximal objective
    (derived from nh_energy; the reference's hand Hessian at
    TetForce.cpp:245-263 is inconsistent with its own gradient — this one
    is the true derivative, validated against AD in tests)."""
    inv = 1.0 / sigma
    logdet = jnp.log(sigma[0] * sigma[1] * sigma[2])
    g = mu * (sigma - inv) + lam * logdet * inv + k * (sigma - sigma0)
    inv2 = inv * inv
    diag = mu * (1.0 + inv2) - lam * logdet * inv2 + k
    H = lam * jnp.outer(inv, inv) + jnp.diag(diag)
    return g, H


def stvk_grad_hess(sigma, mu, lam, k, sigma0):
    """Closed-form gradient and Hessian of the StVK proximal objective
    (gradient matches StVKProx::gradient, TetForce.cpp:289-297)."""
    s2 = jnp.sum(sigma * sigma)
    g = (
        mu * sigma * (sigma * sigma - 1.0)
        + 0.5 * lam * (s2 - 3.0) * sigma
        + k * (sigma - sigma0)
    )
    diag = mu * (3.0 * sigma * sigma - 1.0) + 0.5 * lam * (s2 - 3.0) + k
    H = lam * jnp.outer(sigma, sigma) + jnp.diag(diag)
    return g, H


class HyperElasticTet(ForceBatch):
    """General hyperelastic tet: oriented SVD -> minimize the proximal
    objective over the 3 singular values -> z = U diag(sigma*) V^T
    (TetForce.cpp:303-364). The reference's per-element L-BFGS with
    More-Thuente line search is replaced by a fixed-iteration safeguarded
    Newton (ops/newton.py) that vmaps over the batch.

    On a GPU the step runs as one Pallas kernel per ADMM iteration
    (ops/pallas/nh_local.py, same math on the same layouts); `project`
    is the XLA form and the reference the kernel is tested against.

    model: 'nh' | 'stvk'. k = min(mu, lambda); w = sqrt(k * volume)
    (TetForce.cpp:306-307).
    """

    R, K = 3, 4
    SIGMA_FLOOR = 1e-8

    def __init__(self, tets, mu, lam, max_iters=10, model="nh"):
        self.tets = np.asarray(tets, dtype=np.int32).reshape(-1, 4)
        E = len(self.tets)
        self.mu = np.broadcast_to(np.asarray(mu, np.float64), (E,)).copy()
        self.lam = np.broadcast_to(np.asarray(lam, np.float64), (E,)).copy()
        self.max_iters = int(max_iters)
        if model not in ("nh", "stvk"):
            raise ValueError(f"unknown hyperelastic model {model!r}")
        self.model = model

    @property
    def n_elements(self) -> int:
        return len(self.tets)

    @staticmethod
    def uses_kernel() -> bool:
        """Whether the local step runs as the Pallas kernel: on a GPU."""
        return jax.default_backend() == "gpu"

    def build(self, x, masses, dt):
        B, vol = build_tet_basis(x, self.tets)
        params = _tet_selector_params(self.tets, B)
        k = np.minimum(self.mu, self.lam)
        params["weight"] = np.sqrt(k) * np.sqrt(vol)
        params["k"] = k
        params["mu"] = self.mu
        params["lam"] = self.lam
        # warm start persists across steps (TetForce.hpp:145 last_prox_result)
        state = {"sigma": np.ones((len(self.tets), 3))}
        return params, state

    @property
    def supports_fused_local_rhs(self) -> bool:
        return self.uses_kernel()

    def fused_local_rhs(self, params, x, u, state, with_z=False):
        """The per-iteration element pipeline for the ell/dia global modes
        in one kernel: gathered positions in, (z, u', warm start, flat
        D^T W^2 (z-u') rows) out (ops/pallas/nh_local.nh_local_step_fused).
        with_z adds the D^T W^2 z rows of the dual residual ((E*4, 6))."""
        from ..ops.pallas.nh_local import nh_local_step_fused

        out = nh_local_step_fused(
            x[params["indices"]], u, state["sigma"], params["coeff"],
            params["mu"], params["lam"], params["k"], params["weight"] ** 2,
            iters=self.max_iters, model=self.model, emit_z=with_z,
        )
        z, unew, sigma = out[:3]
        flat = jnp.concatenate([c.reshape(-1, 3) for c in out[3:]], axis=1)
        return z, unew, {**state, "sigma": sigma}, flat

    def project(self, Dx, u, params, state):
        F = _F_of(Dx + u)
        U, s, V = jax.vmap(svd3x3_oriented)(F)

        # warm-start guards (TetForce.cpp:339-347): flip a negative third
        # component, ELSE bump a collapsed (all ~0) start to 1e-3 — the
        # bump only applies when the third component was non-negative
        x2 = state["sigma"]
        neg3 = x2[:, 2] < 0.0
        x2 = x2.at[:, 2].set(jnp.abs(x2[:, 2]))
        collapsed = (~neg3) & jnp.all(jnp.abs(x2) < 1e-3, axis=1)
        x2 = jnp.where(collapsed[:, None], 1e-3, x2)

        energy = nh_energy if self.model == "nh" else stvk_energy
        grad_hess = nh_grad_hess if self.model == "nh" else stvk_grad_hess
        iters = self.max_iters

        def solve_one(x0, sigma0, mu, lam, k):
            def objective(sig):
                return energy(sig, mu, lam) + 0.5 * k * jnp.sum((sig - sigma0) ** 2)

            def gfn(sig):
                return grad_hess(sig, mu, lam, k, sigma0)[0]

            def hfn(sig):
                return grad_hess(sig, mu, lam, k, sigma0)[1]

            return newton_minimize(
                objective, x0, iters, floor=self.SIGMA_FLOOR,
                grad_fn=gfn, hess_fn=hfn,
            )

        sigma_star = jax.vmap(solve_one)(
            x2, s, params["mu"], params["lam"], params["k"]
        )
        # z = U diag(sigma*) V^T with the oriented factors (TetForce.cpp:357)
        zF = jnp.einsum("eij,ej,ekj->eik", U, sigma_star, V)
        return _rows_of(zF), {**state, "sigma": sigma_star}

    def project_with_dual(self, Dx, u, params, state):
        if not self.uses_kernel():
            return super().project_with_dual(Dx, u, params, state)
        from ..ops.pallas.nh_local import nh_local_step

        z, unew, sigma = nh_local_step(
            Dx, u, state["sigma"], params["mu"], params["lam"], params["k"],
            iters=self.max_iters, model=self.model,
        )
        return z, unew, {**state, "sigma": sigma}
