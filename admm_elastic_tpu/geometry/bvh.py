"""Bounding volume hierarchy over triangles.

Equivalent of mclscene's BVH component (deps/mclscene/include/MCL/BVH.hpp:
35-84): two builders — LBVH from morton codes (Lauterbach 2009 style) and
object-median spatial split — plus closest-hit / any-hit ray traversal
(Moller-Trumbore triangle intersection, RayIntersect.hpp) and the profiling
counters the reference keeps (n_nodes, runtime_s).

Host-side numpy: used for picking (poordillo-style grabbing), scene radius
queries, and future mesh-mesh collision broad phase. `batched_closest_hit`
offers a vmappable jnp traversal for many rays at once.
"""

from __future__ import annotations

import time

import numpy as np


# ------------------------------------------------------------------ morton


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of each value 3 apart (for 30-bit morton)."""
    v = v.astype(np.uint64) & 0x3FF
    v = (v | (v << 16)) & np.uint64(0x30000FF)
    v = (v | (v << 8)) & np.uint64(0x300F00F)
    v = (v | (v << 4)) & np.uint64(0x30C30C3)
    v = (v | (v << 2)) & np.uint64(0x9249249)
    return v


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit interleaved morton codes of points normalized to their AABB
    (BVH.cpp:36-53 semantics)."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    ext = np.where(hi - lo > 0, hi - lo, 1.0)
    q = np.clip(((centroids - lo) / ext * 1023.0), 0, 1023).astype(np.uint64)
    return (
        (_expand_bits(q[:, 0]) << 2)
        | (_expand_bits(q[:, 1]) << 1)
        | _expand_bits(q[:, 2])
    )


# --------------------------------------------------------------------- bvh


class BVH:
    """Flat-array BVH: nodes as struct-of-arrays for cache-friendly traversal.

    nodes: left/right child indices (negative-1-based leaf encoding:
    child = -(prim_start+1)), per-node AABBs. Leaves hold a contiguous range
    of the reordered primitive index array.
    """

    def __init__(self, vertices, faces, method="lbvh", leaf_size=4):
        t0 = time.perf_counter()
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int64)
        tri = self.vertices[self.faces]  # (F,3,3)
        self._tri_lo = tri.min(axis=1) if len(tri) else np.zeros((0, 3))
        self._tri_hi = tri.max(axis=1) if len(tri) else np.zeros((0, 3))
        cent = tri.mean(axis=1) if len(tri) else np.zeros((0, 3))
        self._leaf_size = leaf_size

        if len(tri) == 0:
            order = np.zeros(0, dtype=np.int64)
        elif method == "lbvh":
            order = np.argsort(morton_codes(cent), kind="stable")
        elif method == "spatial":
            order = self._median_order(cent)
        else:
            raise ValueError(f"unknown BVH method {method!r}")
        self.prim_order = order.astype(np.int64)

        F = len(self.faces)
        max_nodes = 2 * max(F, 1)
        self.node_lo = np.empty((max_nodes, 3))
        self.node_hi = np.empty((max_nodes, 3))
        self.node_left = np.zeros(max_nodes, dtype=np.int64)
        self.node_right = np.zeros(max_nodes, dtype=np.int64)
        self.leaf_start = np.full(max_nodes, -1, dtype=np.int64)
        self.leaf_count = np.zeros(max_nodes, dtype=np.int64)
        self._n_nodes = 0
        if F:
            self._build(0, F)
        self.n_nodes = self._n_nodes
        self.runtime_s = time.perf_counter() - t0

    def _median_order(self, cent):
        """Object-median split ordering: recursive partition along the widest
        axis (make_tree_spatial behavior)."""
        order = np.arange(len(cent))
        out = np.empty_like(order)
        pos = [0]

        def rec(idx):
            if len(idx) <= self._leaf_size:
                out[pos[0] : pos[0] + len(idx)] = idx
                pos[0] += len(idx)
                return
            c = cent[idx]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            med = np.argsort(c[:, axis], kind="stable")
            half = len(idx) // 2
            rec(idx[med[:half]])
            rec(idx[med[half:]])

        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            rec(order)
        finally:
            sys.setrecursionlimit(old)
        return out

    def _alloc(self):
        i = self._n_nodes
        self._n_nodes += 1
        return i

    def _build(self, start, end):
        """Build over prim_order[start:end]; returns node index."""
        node = self._alloc()
        prims = self.prim_order[start:end]
        self.node_lo[node] = self._tri_lo[prims].min(axis=0)
        self.node_hi[node] = self._tri_hi[prims].max(axis=0)
        if end - start <= self._leaf_size:
            self.leaf_start[node] = start
            self.leaf_count[node] = end - start
            self.node_left[node] = -1
            self.node_right[node] = -1
            return node
        mid = (start + end) // 2
        self.node_left[node] = self._build(start, mid)
        self.node_right[node] = self._build(mid, end)
        return node

    # ---------------------------------------------------------- queries

    def aabb(self):
        return self.node_lo[0].copy(), self.node_hi[0].copy()

    def radius(self, center=None):
        """Bounding-sphere radius (SceneManager::radius analog)."""
        lo, hi = self.aabb()
        c = 0.5 * (lo + hi) if center is None else np.asarray(center)
        d = np.linalg.norm(self.vertices - c, axis=1)
        return float(d.max())

    def closest_hit(self, origin, direction, t_max=np.inf):
        """Closest ray-triangle hit: returns (t, face_index, (u,v)) or
        (inf, -1, None)."""
        origin = np.asarray(origin, dtype=np.float64)
        direction = np.asarray(direction, dtype=np.float64)
        inv_d = 1.0 / np.where(np.abs(direction) > 1e-300, direction, 1e-300)
        best_t, best_f, best_uv = t_max, -1, None
        if self._n_nodes == 0:
            return np.inf, -1, None
        stack = [0]
        while stack:
            node = stack.pop()
            t_near, t_far = _ray_aabb(
                origin, inv_d, self.node_lo[node], self.node_hi[node]
            )
            if t_near > min(t_far, best_t) or t_far < 0:
                continue
            if self.leaf_start[node] >= 0:
                s, c = self.leaf_start[node], self.leaf_count[node]
                for f in self.prim_order[s : s + c]:
                    tri = self.vertices[self.faces[f]]
                    t, u, v = _ray_triangle(origin, direction, tri)
                    if t is not None and 0.0 <= t < best_t:
                        best_t, best_f, best_uv = t, int(f), (u, v)
            else:
                stack.append(self.node_left[node])
                stack.append(self.node_right[node])
        return (best_t, best_f, best_uv) if best_f >= 0 else (np.inf, -1, None)

    def any_hit(self, origin, direction, t_max=np.inf) -> bool:
        t, f, _ = self.closest_hit(origin, direction, t_max)
        return f >= 0 and t < t_max


def _ray_aabb(origin, inv_d, lo, hi):
    t0 = (lo - origin) * inv_d
    t1 = (hi - origin) * inv_d
    t_near = np.minimum(t0, t1).max()
    t_far = np.maximum(t0, t1).min()
    return t_near, t_far


def _ray_triangle(origin, direction, tri, eps=1e-12):
    """Moller-Trumbore (RayIntersect.hpp:32-102 style). Returns (t,u,v) or
    (None, 0, 0)."""
    e1 = tri[1] - tri[0]
    e2 = tri[2] - tri[0]
    p = np.cross(direction, e2)
    det = np.dot(e1, p)
    if abs(det) < eps:
        return None, 0.0, 0.0
    inv = 1.0 / det
    s = origin - tri[0]
    u = np.dot(s, p) * inv
    if u < 0.0 or u > 1.0:
        return None, 0.0, 0.0
    q = np.cross(s, e1)
    v = np.dot(direction, q) * inv
    if v < 0.0 or u + v > 1.0:
        return None, 0.0, 0.0
    t = np.dot(e2, q) * inv
    return (t, u, v) if t > eps else (None, 0.0, 0.0)


def batched_closest_hit(vertices, faces, origins, directions):
    """Brute-force vmappable closest-hit for many rays on device (jnp):
    O(rays x faces) but fully parallel — the right shape for a device when
    rays x faces is moderate. Returns (t (R,), face (R,))."""
    import jax.numpy as jnp

    v = jnp.asarray(vertices)
    f = jnp.asarray(faces)
    tri = v[f]  # (F,3,3)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]

    def one(o, d):
        p = jnp.cross(d[None, :], e2)
        det = jnp.einsum("fj,fj->f", e1, p)
        inv = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
        s = o[None, :] - tri[:, 0]
        u = jnp.einsum("fj,fj->f", s, p) * inv
        q = jnp.cross(s, e1)
        vv = jnp.einsum("j,fj->f", d, q)
        vv = vv * inv
        t = jnp.einsum("fj,fj->f", e2, q) * inv
        ok = (
            (jnp.abs(det) > 1e-12)
            & (u >= 0)
            & (u <= 1)
            & (vv >= 0)
            & (u + vv <= 1)
            & (t > 1e-12)
        )
        t = jnp.where(ok, t, jnp.inf)
        best = jnp.argmin(t)
        return t[best], jnp.where(jnp.isfinite(t[best]), best, -1)

    import jax

    return jax.vmap(one)(jnp.asarray(origins), jnp.asarray(directions))
