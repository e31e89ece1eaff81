"""Independent, slow, pure-numpy oracle implementing the reference ADMM
algorithm (System.cpp:26-75) with explicit sparse-as-dense matrices and
per-force Python loops. Used by parity tests to validate the JAX framework's
vectorized implementation against the exact published algorithm. This is a
re-derivation from the algorithm's math, built for testing only.
"""

from __future__ import annotations

import numpy as np


class RefForce:
    global_idx = 0

    def rows(self):
        raise NotImplementedError

    def selector(self, n_dof):
        """Returns (D_block (rows, n_dof), weights (rows,))."""
        raise NotImplementedError

    def project(self, Dx, u, z):
        """In-place update of u, z segments (local step + dual update)."""
        raise NotImplementedError


class RefSpring(RefForce):
    def __init__(self, i, j, k):
        self.i, self.j, self.k = i, j, k

    def initialize(self, x):
        self.rest = np.linalg.norm(x[self.i * 3 : self.i * 3 + 3] - x[self.j * 3 : self.j * 3 + 3])
        self.w = np.sqrt(self.k)

    def rows(self):
        return 3

    def selector(self, n_dof):
        D = np.zeros((3, n_dof))
        for c in range(3):
            D[c, self.i * 3 + c] = 1.0
            D[c, self.j * 3 + c] = -1.0
        return D, np.full(3, self.w)

    def project(self, Dx, u, z):
        g = self.global_idx
        dix = Dx[g : g + 3]
        ui = u[g : g + 3]
        dxu = dix + ui
        nrm = np.linalg.norm(dxu)
        direc = dxu / nrm if nrm > 0 else np.zeros(3)
        p = self.rest * direc
        zi = (self.k * p + self.w**2 * dxu) / (self.w**2 + self.k)
        u[g : g + 3] = ui + dix - zi
        z[g : g + 3] = zi


class RefAnchor(RefForce):
    def __init__(self, idx, weight=1000.0):
        self.idx, self.w = idx, weight

    def initialize(self, x):
        self.pos = x[self.idx * 3 : self.idx * 3 + 3].copy()

    def rows(self):
        return 3

    def selector(self, n_dof):
        D = np.zeros((3, n_dof))
        for c in range(3):
            D[c, self.idx * 3 + c] = 1.0
        return D, np.full(3, self.w)

    def project(self, Dx, u, z):
        g = self.global_idx
        dix = Dx[g : g + 3]
        u[g : g + 3] += dix - self.pos
        z[g : g + 3] = self.pos


def _tet_B(x, idx):
    v = [x[i * 3 : i * 3 + 3] for i in idx]
    edges = np.stack([v[1] - v[0], v[2] - v[0], v[3] - v[0]], axis=1)
    D4 = np.array([[-1, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    B = D4 @ np.linalg.inv(edges)
    vol = abs(np.dot(v[0] - v[3], np.cross(v[1] - v[3], v[2] - v[3]))) / 6.0
    return B, vol


class RefLinearTetStrain(RefForce):
    def __init__(self, idx, k):
        self.idx, self.k = list(idx), k

    def initialize(self, x):
        self.B, self.vol = _tet_B(x, self.idx)
        self.w = np.sqrt(self.k) * np.sqrt(self.vol)

    def rows(self):
        return 9

    def selector(self, n_dof):
        D = np.zeros((9, n_dof))
        Bt = self.B.T  # (3,4)
        for r in range(3):
            for c in range(4):
                for j in range(3):
                    D[r * 3 + j, self.idx[c] * 3 + j] = Bt[r, c]
        return D, np.full(9, self.w)

    def project(self, Dx, u, z):
        g = self.global_idx
        dix = Dx[g : g + 9]
        ui = u[g : g + 9]
        dxu = dix + ui
        F = dxu.reshape(3, 3, order="F")  # column-major map like Eigen
        U, S, Vt = np.linalg.svd(F)
        Snew = np.array([1.0, 1.0, 1.0])
        if np.linalg.det(F) < 0:
            Snew[2] = -1.0
        proj = U @ np.diag(Snew) @ Vt
        p = proj.reshape(9, order="F")
        k = self.k * self.vol
        zi = (k * p + self.w**2 * dxu) / (self.w**2 + k)
        u[g : g + 9] = ui + dix - zi
        z[g : g + 9] = zi


class RefTriangleStrain(RefForce):
    def __init__(self, idx, k, lmin=0.0, lmax=9999999.0):
        self.idx, self.k, self.lmin, self.lmax = list(idx), k, lmin, lmax

    def initialize(self, x):
        v = [x[i * 3 : i * 3 + 3] for i in self.idx]
        e12, e13 = v[1] - v[0], v[2] - v[0]
        n1 = e12 / np.linalg.norm(e12)
        t = e13 - np.dot(e13, n1) * n1
        n2 = t / np.linalg.norm(t)
        basis = np.stack([n1, n2], axis=1)
        edges = np.stack([e12, e13], axis=1)
        Xg = basis.T @ edges
        D3 = np.array([[-1, -1], [1, 0], [0, 1]], dtype=float)
        self.B = D3 @ np.linalg.inv(Xg)
        self.area = abs(np.linalg.det(Xg)) / 2.0
        self.w = np.sqrt(self.k) * np.sqrt(self.area)

    def rows(self):
        return 6

    def selector(self, n_dof):
        D = np.zeros((6, n_dof))
        for i in range(3):  # component
            for j in range(3):  # vertex
                D[i, self.idx[j] * 3 + i] = self.B[j, 0]
                D[3 + i, self.idx[j] * 3 + i] = self.B[j, 1]
        return D, np.full(6, self.w)

    def project(self, Dx, u, z):
        g = self.global_idx
        dix = Dx[g : g + 6]
        ui = u[g : g + 6]
        dxu = dix + ui
        F = dxu.reshape(3, 2, order="F")
        U, S, Vt = np.linalg.svd(F, full_matrices=False)
        T = U @ Vt
        p = T.reshape(6, order="F")
        k = self.k * self.area
        zi = (k * p + self.w**2 * dxu) / (self.w**2 + k)
        l0, l1 = np.linalg.norm(zi[:3]), np.linalg.norm(zi[3:])
        if l0 < self.lmin:
            zi[:3] *= self.lmin / max(l0, 1e-6)
        if l1 < self.lmin:
            zi[3:] *= self.lmin / max(l1, 1e-6)
        if l0 > self.lmax:
            zi[:3] *= self.lmax / max(l0, 1e-6)
        if l1 > self.lmax:
            zi[3:] *= self.lmax / max(l1, 1e-6)
        u[g : g + 6] = ui + dix - zi
        z[g : g + 6] = zi


class RefBend(RefForce):
    def __init__(self, hinge, k):
        self.idx, self.k = list(hinge), k

    def initialize(self, x):
        v = [x[i * 3 : i * 3 + 3] for i in self.idx]
        xA, xB, xD = v[0] - v[2], v[1] - v[2], v[3] - v[2]
        area1 = 0.5 * np.linalg.norm(np.cross(xA, xD))
        area2 = 0.5 * np.linalg.norm(np.cross(xD, xB))
        hA = 2 * area1 / np.linalg.norm(xD)
        hB = 2 * area2 / np.linalg.norm(xD)
        nC = np.cross(-xB, -xA)
        nD = np.cross(xD - xA, xD - xB)
        self.alpha = np.array(
            [
                hB / (hA + hB),
                hA / (hA + hB),
                -np.linalg.norm(nD) / (np.linalg.norm(nC) + np.linalg.norm(nD)),
                -np.linalg.norm(nC) / (np.linalg.norm(nC) + np.linalg.norm(nD)),
            ]
        )
        self.w = np.sqrt(self.k)

    def rows(self):
        return 9

    def selector(self, n_dof):
        D = np.zeros((9, n_dof))
        i0, i1, i2, i3 = self.idx
        for c in range(3):
            D[c, i0 * 3 + c] = 1.0
            D[c, i2 * 3 + c] = -1.0
            D[3 + c, i3 * 3 + c] = 1.0
            D[3 + c, i2 * 3 + c] = -1.0
            D[6 + c, i1 * 3 + c] = 1.0
            D[6 + c, i2 * 3 + c] = -1.0
        return D, np.full(9, self.w)

    def project(self, Dx, u, z):
        g = self.global_idx
        dix = Dx[g : g + 9]
        ui = u[g : g + 9]
        dxu = dix + ui
        a = self.alpha
        c1, c2, c3 = dxu[:3], dxu[3:6], dxu[6:]
        lam = 2.0 * (a[0] * c1 + a[3] * c2 + a[1] * c3) / (a[0] ** 2 + a[3] ** 2 + a[1] ** 2)
        p = np.concatenate([c1 - 0.5 * a[0] * lam, c2 - 0.5 * a[3] * lam, c3 - 0.5 * a[1] * lam])
        zi = (self.k * p + self.w**2 * dxu) / (self.w**2 + self.k)
        u[g : g + 9] = ui + dix - zi
        z[g : g + 9] = zi


class RefCollision(RefForce):
    """CollisionForce: identity selector over ALL dofs, weight 32
    (CollisionForce.cpp:27-70). shapes: list of ('floor', y) | ('sphere',
    center, r) | ('cylinder', cxy, r)."""

    def __init__(self, n_nodes, shapes, weight=32.0):
        self.n, self.shapes, self.w = n_nodes, shapes, weight

    def initialize(self, x):
        pass

    def rows(self):
        return 3 * self.n

    def selector(self, n_dof):
        return np.eye(n_dof), np.full(n_dof, self.w)

    def project(self, Dx, u, z):
        g = self.global_idx
        rows = 3 * self.n
        dix = Dx[g : g + rows]
        ui = u[g : g + rows]
        zi = (dix + ui).copy()
        for i in range(0, rows, 3):
            p = zi[i : i + 3]
            for s in self.shapes:
                if s[0] == "floor":
                    if p[1] < s[1]:
                        p = np.array([p[0], s[1], p[2]])
                elif s[0] == "sphere":
                    c, r = np.asarray(s[1]), s[2]
                    d = p - c
                    dist = np.linalg.norm(d)
                    if dist < r:
                        p = c + r * d / dist if dist > 0 else c + np.array([r, 0, 0])
                elif s[0] == "cylinder":
                    c, r = np.asarray(s[1]), s[2]
                    dxy = p[:2] - c
                    dist = np.linalg.norm(dxy)
                    if dist < r:
                        p = np.concatenate([c + r * dxy / max(dist, 1e-300), p[2:]])
            zi[i : i + 3] = p
        u[g : g + rows] = ui + dix - zi
        z[g : g + rows] = zi


class RefWind:
    """Wejchert-Haumann wind (ExplicitForce.cpp:42-98).

    The reference's OpenMP loop reads `v` while other threads write it
    (only the scatter is in a critical section), so its exact result is
    schedule-dependent. The deterministic interpretation used by both this
    oracle and the framework: all triangle forces are computed from the
    pre-update velocities, then scattered (Jacobi-style).
    """

    def __init__(self, tris, direction):
        self.tris = np.asarray(tris, dtype=int).reshape(-1, 3)
        self.direction = np.asarray(direction, dtype=float)

    def apply(self, dt, x, v):
        v0 = v.copy()
        for t in self.tris:
            idx = t * 3
            curr_v = (
                v0[idx[0] : idx[0] + 3]
                + v0[idx[1] : idx[1] + 3]
                + v0[idx[2] : idx[2] + 3]
            ) / 3.0
            v_r = curr_v - self.direction
            p0 = x[idx[0] : idx[0] + 3]
            p1 = x[idx[1] : idx[1] + 3]
            p2 = x[idx[2] : idx[2] + 3]
            n = np.cross(p1 - p0, p2 - p0)
            n_len = np.linalg.norm(n)
            normal = n / n_len if n_len > 0 else n
            area = 0.5 * n_len
            v_n = normal @ v_r
            force = -1000.0 * area * v_n * abs(v_n) * normal * 0.33 * dt
            for j in range(3):
                v[idx[j] : idx[j] + 3] += force


class RefSystem:
    """Direct transcription of the reference timestep algorithm."""

    def __init__(self, dt=0.04, iters=10):
        self.dt, self.iters = dt, iters
        self.forces: list[RefForce] = []
        self.gravity = None
        self.wind = None

    def setup(self, x, masses):
        self.x = np.asarray(x, dtype=float).reshape(-1).copy()
        self.v = np.zeros_like(self.x)
        self.m = np.repeat(np.asarray(masses, dtype=float), 3)

    def _assemble(self):
        n_dof = len(self.x)
        blocks, weights = [], []
        r = 0
        for f in self.forces:
            f.global_idx = r
            D, w = f.selector(n_dof)
            blocks.append(D)
            weights.append(w)
            r += f.rows()
        self.D = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, n_dof))
        self.W = np.concatenate(weights) if weights else np.zeros(0)
        dt2 = self.dt * self.dt
        M = np.diag(self.m)
        DtW2 = self.D.T * (self.W**2)[None, :]
        self.A = M + dt2 * (DtW2 @ self.D)
        self.dt2_DtW2 = dt2 * DtW2

    def initialize(self):
        for f in self.forces:
            f.initialize(self.x)
        self._assemble()
        self.u = np.zeros(len(self.W))
        self.z = np.zeros(len(self.W))

    def recompute_weights(self):
        """Runtime weight-edit path (System.cpp:159-179): rebuild W and the
        global matrix; duals/state persist."""
        self._assemble()

    def step(self, collect_residuals=False):
        dt = self.dt
        if self.gravity is not None:
            self.v += dt * np.tile(self.gravity, len(self.x) // 3)
        if self.wind is not None:
            self.wind.apply(dt, self.x, self.v)
        self.z = self.D @ self.x
        xbar = self.x + dt * self.v
        Mxbar = self.m * xbar
        curr_x = xbar.copy()
        rp, rd = [], []
        dt2 = self.dt * self.dt
        for _ in range(self.iters):
            z_prev = self.z.copy()
            Dx = self.D @ curr_x
            for f in self.forces:
                f.project(Dx, self.u, self.z)
            b = Mxbar + self.dt2_DtW2 @ (self.z - self.u)
            curr_x = np.linalg.solve(self.A, b)
            if collect_residuals:
                # r = ||W(Dx - z)||, s = dt^2 ||D^T W^2 (z - z_prev)||
                # (System.cpp:64-65)
                rp.append(np.linalg.norm(self.W * (Dx - self.z)))
                rd.append(
                    np.linalg.norm(
                        dt2 * (self.D.T * (self.W**2)[None, :])
                        @ (self.z - z_prev)
                    )
                )
        self.v = (curr_x - self.x) / dt
        self.x = curr_x
        if collect_residuals:
            return np.asarray(rp), np.asarray(rd)


class RefMovingAnchor(RefForce):
    """MovingAnchor bound to a control point (AnchorForce.cpp:61-89):
    active -> z = pos; inactive -> z = Dx + u (no-op) and the point follows
    the node. Release = active False + weight 0 + recompute_weights."""

    def __init__(self, idx, weight=1000.0):
        self.idx, self.w = idx, weight
        self.active = True
        self.pos = None

    def initialize(self, x):
        if self.pos is None:
            self.pos = x[self.idx * 3 : self.idx * 3 + 3].copy()

    def rows(self):
        return 3

    def selector(self, n_dof):
        D = np.zeros((3, n_dof))
        for c in range(3):
            D[c, self.idx * 3 + c] = 1.0
        return D, np.full(3, self.w)

    def project(self, Dx, u, z):
        g = self.global_idx
        dix = Dx[g : g + 3]
        ui = u[g : g + 3]
        if self.active:
            zi = self.pos.copy()
        else:
            zi = dix + ui
            self.pos = dix.copy()
        u[g : g + 3] = ui + dix - zi
        z[g : g + 3] = zi


class RefHyperElastic(RefForce):
    """HyperElasticTet oracle (TetForce.cpp:303-364): oriented SVD with the
    reference's U/V determinant flips, warm-started scipy L-BFGS-B over the
    three singular values with the exact NHProx/StVKProx objective+gradient
    (TetForce.cpp:216-297, incl. the FLT_MAX positivity barrier), z = U
    diag(sigma*) V^T. k = min(mu, lambda); w = sqrt(k * volume)."""

    _FLT_MAX = float(np.finfo(np.float32).max)

    def __init__(self, idx, mu, lam, max_iters=5, model="nh"):
        self.idx, self.mu, self.lam = list(idx), mu, lam
        self.max_iters, self.model = max_iters, model
        self.last_prox_result = np.ones(3)

    def initialize(self, x):
        self.B, self.vol = _tet_B(x, self.idx)
        self.k = min(self.mu, self.lam)
        self.w = np.sqrt(self.k) * np.sqrt(self.vol)

    def rows(self):
        return 9

    def selector(self, n_dof):
        D = np.zeros((9, n_dof))
        Bt = self.B.T  # (3,4)
        for r in range(3):
            for c in range(4):
                for j in range(3):
                    D[r * 3 + j, self.idx[c] * 3 + j] = Bt[r, c]
        return D, np.full(9, self.w)

    def _oriented_svd(self, F):
        """TetForce.cpp:80-102: plain SVD then determinant flips of U and Vt
        (each flip negates S[2])."""
        U, S, Vt = np.linalg.svd(F)
        S = S.copy()
        J = np.diag([1.0, 1.0, -1.0])
        if np.linalg.det(U) < 0.0:
            U = U @ J
            S[2] *= -1.0
        if np.linalg.det(Vt) < 0.0:
            Vt = J @ Vt
            S[2] *= -1.0
        return U, S, Vt

    def _value(self, s, s0):
        if s[0] < 0.0 or s[1] < 0.0 or s[2] < 0.0:
            return self._FLT_MAX
        if self.model == "nh":
            det = s[0] * s[1] * s[2]
            I1 = np.dot(s, s)
            log_I3 = np.log(det * det)
            psi = 0.5 * self.mu * (I1 - log_I3 - 3.0) + 0.125 * self.lam * log_I3**2
        else:
            st = 0.5 * (s * s - 1.0)
            psi = self.mu * np.dot(st, st) + 0.5 * self.lam * np.sum(st) ** 2
        return psi + 0.5 * self.k * np.sum((s - s0) ** 2)

    def _grad(self, s, s0):
        if self.model == "nh":
            det = s[0] * s[1] * s[2]
            if det <= 0.0:
                return np.full(3, self._FLT_MAX)
            inv = 1.0 / s
            return (
                self.mu * (s - inv)
                + self.lam * np.log(det) * inv
                + self.k * (s - s0)
            )
        t1 = self.mu * s * (s * s - 1.0)
        t2 = 0.5 * self.lam * (np.dot(s, s) - 3.0) * s
        return t1 + t2 + self.k * (s - s0)

    def project(self, Dx, u, z):
        from scipy.optimize import minimize

        g = self.global_idx
        dix = Dx[g : g + 9]
        ui = u[g : g + 9]
        dxu = dix + ui
        F = dxu.reshape(3, 3, order="F")
        U, S0, Vt = self._oriented_svd(F)

        x2 = self.last_prox_result.copy()
        # warm-start guards (TetForce.cpp:341-347)
        if x2[2] < 0.0:
            x2[2] *= -1.0
        elif abs(x2[0]) < 1e-3 and abs(x2[1]) < 1e-3 and abs(x2[2]) < 1e-3:
            x2[:] = 1e-3

        res = minimize(
            self._value, x2, args=(S0,), jac=self._grad, method="L-BFGS-B",
            options={"maxiter": self.max_iters, "gtol": 1e-8},
        )
        x2 = res.x
        self.last_prox_result = x2.copy()
        proj = U @ np.diag(x2) @ Vt
        zi = proj.reshape(9, order="F")
        u[g : g + 9] = ui + dix - zi
        z[g : g + 9] = zi
