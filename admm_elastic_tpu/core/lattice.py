"""Grid detection for vertex renumbering.

A mesh whose vertices sit on a full regular grid, in any numbering, can be
renumbered into canonical grid order; A_hat's sparsity then collapses onto
a handful of constant diagonals (the dia global solve and the whole-mesh
layouts).
"""

from __future__ import annotations

import numpy as np


def detect_grid_numbering(vertices, rel_tol=1e-6):
    """Position-based canonical renumbering: if the vertices form a full
    regular grid (uniform spacing PER AXIS; axes may differ), return
    to_canonical[orig_id] = (i*gy + j)*gz + k, else None.

    Used by System's 'auto' reorder: a grid-positioned mesh in scrambled
    numbering re-numbered this way makes A_hat's sparsity a handful of
    constant diagonals again, re-qualifying it for the dia matvec (and
    the grid-cloth layout, core/cloth.py).
    """
    v = np.asarray(vertices, np.float64)
    n = len(v)
    if n < 8:
        return None
    mins = v.min(axis=0)
    span = v.max(axis=0) - mins
    scale = max(span.max(), 1.0)
    tol = rel_tol * scale

    axes = []
    for a in range(3):
        vals = np.sort(np.unique(np.round(v[:, a] / tol).astype(np.int64)))
        vals = vals * tol
        keep = [vals[0]]
        for q in vals[1:]:
            if q - keep[-1] > tol * 4:
                keep.append(q)
        axes.append(np.asarray(keep))
    g = [len(a) for a in axes]
    # flat (2D) grids qualify too: a regular cloth plane renumbered this
    # way also collapses A_hat onto constant diagonals
    if g[0] * g[1] * g[2] != n or sorted(g)[1] < 2:
        return None
    sizes = []
    for a in range(3):
        d = np.diff(axes[a])
        if d.size == 0:
            sizes.append(1.0)  # degenerate axis: spacing irrelevant
            continue
        if np.abs(d - d[0]).max() > tol * 8:
            return None
        sizes.append(d[0])
    ijk = np.round((v - mins) / np.asarray(sizes)).astype(np.int64)
    if np.abs(v - (mins + ijk * np.asarray(sizes))).max() > tol * 8:
        return None
    if (ijk < 0).any() or (ijk >= np.asarray(g)).any():
        return None
    gy, gz = g[1], g[2]
    cid = (ijk[:, 0] * gy + ijk[:, 1]) * gz + ijk[:, 2]
    if len(np.unique(cid)) != n:
        return None
    return cid
