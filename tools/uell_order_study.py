"""Host-side study: which vertex ordering minimizes uell plane count?

The delaunay100k per-ADMM-iteration cost is ~linear in the uell plane
count (slots + fold ops): ~0.17 us per (Nr,128) gather+multiply-add
(docs/PERFORMANCE.md). The packing is pure host work, so ordering
research runs offline — this script builds the exact bench mesh,
assembles A_hat, and packs it under candidate orderings.

Run (CPU, scrubbed env):
  env PYTHONPATH=. JAX_PLATFORMS=cpu \
      python -u tools/uell_order_study.py [--small]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from admm_elastic_tpu.core.uell import (  # noqa: E402
    dilute_positions,
    pack_uell,
    slab_order,
)


def build_mesh(small=False):
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(0)
    nx, ny, nz = (14, 10, 8) if small else (37, 22, 20)
    gx, gy, gz = np.meshgrid(np.arange(nx), np.arange(ny),
                             np.arange(nz), indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    pts += rng.uniform(-0.3, 0.3, pts.shape)
    pts *= 0.05
    tets = Delaunay(pts).simplices
    pp = pts[tets]
    emax = np.linalg.norm(pp[:, :, None, :] - pp[:, None, :, :],
                          axis=-1).max(axis=(1, 2))
    tets = tets[emax < 0.11]
    return pts, tets


def assemble(pts, tets):
    """A_hat sparsity+values like the bench config (NH mu=lam=1e5)."""
    import scipy.sparse as sp

    from admm_elastic_tpu.models.tet import build_tet_basis

    n = len(pts)
    B, vol = build_tet_basis(pts, tets)      # (E,4,3), (E,)
    coeff = np.transpose(B, (0, 2, 1))       # (E,3,4) selector rows
    k = np.minimum(1e5, 1e5)
    w2 = k * vol
    dt2 = 0.04 * 0.04
    Me = np.einsum("erk,erl->ekl", coeff, coeff)
    ii = np.repeat(tets[:, :, None], 4, 2).ravel()
    jj = np.repeat(tets[:, None, :], 4, 1).ravel()
    vv = (dt2 * w2[:, None, None] * Me).ravel()
    A = sp.coo_matrix((vv, (ii, jj)), shape=(n, n)).tocsr()
    A = A + sp.diags(np.full(n, 50.0 / n))
    A.sum_duplicates()
    return A


def morton_order(pts, bits=10):
    q = pts - pts.min(0)
    q = (q / q.max(0) * ((1 << bits) - 1)).astype(np.int64)

    def spread(x):
        x &= (1 << bits) - 1
        x = (x | (x << 32)) & 0x1F00000000FFFF
        x = (x | (x << 16)) & 0x1F0000FF0000FF
        x = (x | (x << 8)) & 0x100F00F00F00F00F
        x = (x | (x << 4)) & 0x10C30C30C30C30C3
        x = (x | (x << 2)) & 0x1249249249249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")


def hilbert_order(pts, bits=7):
    """3D Hilbert curve order (Skilling's transpose algorithm)."""
    q = pts - pts.min(0)
    X = (q / q.max(0) * ((1 << bits) - 1)).astype(np.int64)
    X = X.copy().T  # (3, n)
    n_dims = 3
    # Gray -> Hilbert transpose (inverse of TransposetoAxes)
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:
        P = Q - 1
        for i in range(n_dims):
            m = (X[i] & Q) != 0
            # invert low bits of X[0] where needed
            X[0] = np.where(m, X[0] ^ P, X[0])
            t = np.where(m, 0, (X[0] ^ X[i]) & P)
            X[0] ^= t
            X[i] ^= t
        Q >>= 1
    for i in range(1, n_dims):
        X[i] ^= X[i - 1]
    t2 = np.zeros(X.shape[1], np.int64)
    Q = M
    while Q > 1:
        t2 = np.where((X[n_dims - 1] & Q) != 0, t2 ^ (Q - 1), t2)
        Q >>= 1
    for i in range(n_dims):
        X[i] ^= t2
    # interleave transpose-format bits into one code
    code = np.zeros(X.shape[1], np.int64)
    for b in range(bits - 1, -1, -1):
        for i in range(n_dims):
            code = (code << 1) | ((X[i] >> b) & 1)
    return np.argsort(code, kind="stable")


def brick_order(pts, bx=0.4, by=0.2):
    """Two-level slabs: coarse x-bricks, y-rows inside, z within."""
    v = pts
    n = len(v)
    ox = np.argsort(v[:, 0], kind="stable")
    xs = np.empty(n, np.int64)
    xs[ox] = np.arange(n)
    xb = xs // max(int(n * bx / 10), 1)
    oy = np.lexsort((v[:, 1], xb))
    ys = np.empty(n, np.int64)
    ys[oy] = np.arange(n)
    yb = ys // max(int(n * by / 10), 1)
    return np.lexsort((v[:, 2], yb, xb))


def axis_slab(pts, axis, slab_target):
    p = pts[:, [axis, (axis + 1) % 3, (axis + 2) % 3]]
    return slab_order(p, slab_target)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    pts, tets = build_mesh(args.small)
    print(f"mesh: {len(pts)} verts, {len(tets)} tets")
    A = assemble(pts, tets).tocoo()
    nzm = A.data != 0
    rows, cols, vals = A.row[nzm], A.col[nzm], A.data[nzm]
    print(f"A: {len(rows)} entries, avg row nnz "
          f"{len(rows)/len(pts):.1f}")

    cands = []
    for st in (64, 128, 256, 512):
        for ax in (0, 1, 2):
            cands.append((f"slab{st} ax{ax}", axis_slab(pts, ax, st)))
    cands.append(("morton", morton_order(pts)))
    for b in (4, 5, 6, 7):
        cands.append((f"hilbert b{b}", hilbert_order(pts, b)))
    cands.append(("brick", brick_order(pts)))

    results = []
    for name, order in cands:
        for cq in (0.97, 0.99):
            for dil in (8, 6, 12):
                t0 = time.time()
                try:
                    positions, n_pos = dilute_positions(order, dil)
                    p = pack_uell(rows, cols, vals, positions, n_pos,
                                  cap_quantile=cq, max_slots=400)
                    cost = p["n_slots"] + p["n_fold_ops"]
                    results.append((cost, name, cq, dil, p["n_slots"],
                                    p["n_fold_ops"], p["n_pad"]))
                    print(f"{name:14s} cq={cq} dil={dil:2d}: "
                          f"{p['n_slots']:3d} slots + {p['n_fold_ops']:3d} "
                          f"folds = {cost:3d} planes  n_pad={p['n_pad']} "
                          f"({time.time()-t0:.1f}s)")
                except ValueError as e:
                    print(f"{name:14s} cq={cq} dil={dil:2d}: FAIL {e}")

    results.sort()
    print("\nbest 5:")
    for r in results[:5]:
        print(" ", r)


if __name__ == "__main__":
    main()
