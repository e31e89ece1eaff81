"""Procedural mesh builders.

`make_sym_plane` reproduces the reference's vertex/face layout exactly
(trimesh2 TriMeshBuilder.h:116-170) because sample apps pin cloth corners by
raw vertex index (windyflag.cpp:93-96) — index layout is part of the contract.

Other builders (cylinder/sphere/box/torus) provide equivalent geometry for
scene parity; exact tessellation layout is not load-bearing for physics since
those objects are static in all bundled scenes.

`make_beam_tets` generates large synthetic tet meshes for benchmarks
(the 100k-tet BASELINE workload).
"""

from __future__ import annotations

import numpy as np

from .tetmesh import TetMesh
from .trimesh import TriMesh


def make_sym_plane(tess_x: int, tess_y: int) -> TriMesh:
    """Symmetric quad-split plane on [-1,1]^2, z=0.

    Vertex order: grid verts x-major ((tess_x+1)*(tess_y+1)), then quad centers.
    Each quad becomes 4 triangles around its center vertex.
    """
    tess_x = max(tess_x, 1)
    tess_y = max(tess_y, 1)
    n_grid = (tess_x + 1) * (tess_y + 1)

    verts = []
    for x in range(tess_x + 1):
        for y in range(tess_y + 1):
            verts.append((-1.0 + 2.0 * x / tess_x, -1.0 + 2.0 * y / tess_y, 0.0))
    for x in range(tess_x):
        for y in range(tess_y):
            verts.append(
                (
                    -1.0 + 2.0 * x / tess_x + 1.0 / tess_x,
                    -1.0 + 2.0 * y / tess_y + 1.0 / tess_y,
                    0.0,
                )
            )

    faces = []
    for x in range(tess_x):
        for y in range(tess_y):
            ll = y + x * (tess_y + 1)
            lr = y + (x + 1) * (tess_y + 1)
            ul = ll + 1
            ur = lr + 1
            cent = n_grid + x * tess_y + y
            faces += [(ll, lr, cent), (lr, ur, cent), (cent, ur, ul), (ll, cent, ul)]

    return TriMesh(
        np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32)
    )


def make_cylinder(tess_l: int = 10, tess_c: int = 10, radius: float = 1.0) -> TriMesh:
    """Capped cylinder along z in [-1, 1]."""
    tess_l = max(tess_l, 2)
    tess_c = max(tess_c, 3)
    verts = []
    for i in range(tess_l + 1):
        z = -1.0 + 2.0 * i / tess_l
        for j in range(tess_c):
            a = 2.0 * np.pi * j / tess_c
            verts.append((radius * np.cos(a), radius * np.sin(a), z))
    bot = len(verts)
    verts.append((0.0, 0.0, -1.0))
    top = len(verts)
    verts.append((0.0, 0.0, 1.0))
    faces = []
    for i in range(tess_l):
        for j in range(tess_c):
            a = i * tess_c + j
            b = i * tess_c + (j + 1) % tess_c
            c = (i + 1) * tess_c + j
            d = (i + 1) * tess_c + (j + 1) % tess_c
            faces += [(a, b, c), (b, d, c)]
    for j in range(tess_c):
        faces.append((bot, (j + 1) % tess_c, j))
        faces.append((top, tess_l * tess_c + j, tess_l * tess_c + (j + 1) % tess_c))
    return TriMesh(np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32))


def make_sphere(tess: int = 16, radius: float = 1.0) -> TriMesh:
    """Polar-tessellated sphere."""
    tess = max(tess, 3)
    verts = [(0.0, 0.0, -radius)]
    for i in range(1, tess):
        phi = np.pi * i / tess - np.pi / 2.0
        for j in range(tess * 2):
            theta = 2.0 * np.pi * j / (tess * 2)
            verts.append(
                (
                    radius * np.cos(phi) * np.cos(theta),
                    radius * np.cos(phi) * np.sin(theta),
                    radius * np.sin(phi),
                )
            )
    verts.append((0.0, 0.0, radius))
    n_ring = tess * 2
    top = len(verts) - 1
    faces = []
    for j in range(n_ring):
        faces.append((0, 1 + (j + 1) % n_ring, 1 + j))
    for i in range(tess - 2):
        r0 = 1 + i * n_ring
        r1 = 1 + (i + 1) * n_ring
        for j in range(n_ring):
            a, b = r0 + j, r0 + (j + 1) % n_ring
            c, d = r1 + j, r1 + (j + 1) % n_ring
            faces += [(a, b, c), (b, d, c)]
    r0 = 1 + (tess - 2) * n_ring
    for j in range(n_ring):
        faces.append((top, r0 + j, r0 + (j + 1) % n_ring))
    return TriMesh(np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32))


def make_box(tess: int = 1) -> TriMesh:
    """Unit cube [-1,1]^3 with tess subdivisions per edge, triangulated."""
    tess = max(tess, 1)
    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []

    def add_face(origin, du, dv):
        base = len(verts)
        for i in range(tess + 1):
            for j in range(tess + 1):
                p = (
                    origin[0] + du[0] * i / tess + dv[0] * j / tess,
                    origin[1] + du[1] * i / tess + dv[1] * j / tess,
                    origin[2] + du[2] * i / tess + dv[2] * j / tess,
                )
                verts.append(p)
        for i in range(tess):
            for j in range(tess):
                a = base + i * (tess + 1) + j
                b = a + tess + 1
                faces.append((a, b, a + 1))
                faces.append((b, b + 1, a + 1))

    add_face((-1, -1, -1), (2, 0, 0), (0, 2, 0))  # z=-1 (flipped below)
    add_face((-1, -1, 1), (0, 2, 0), (2, 0, 0))  # z=+1
    add_face((-1, -1, -1), (0, 0, 2), (2, 0, 0))  # y=-1
    add_face((-1, 1, -1), (2, 0, 0), (0, 0, 2))  # y=+1
    add_face((-1, -1, -1), (0, 2, 0), (0, 0, 2))  # x=-1
    add_face((1, -1, -1), (0, 0, 2), (0, 2, 0))  # x=+1
    return TriMesh(np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32))


def make_torus(tess: int = 16, inner_rad: float = 0.25, outer_rad: float = 1.0) -> TriMesh:
    tess = max(tess, 3)
    verts = []
    for i in range(tess):
        a = 2.0 * np.pi * i / tess
        cx, cy = outer_rad * np.cos(a), outer_rad * np.sin(a)
        for j in range(tess):
            b = 2.0 * np.pi * j / tess
            r = outer_rad + inner_rad * np.cos(b)
            verts.append((r * np.cos(a), r * np.sin(a), inner_rad * np.sin(b)))
    faces = []
    for i in range(tess):
        for j in range(tess):
            a = i * tess + j
            b = i * tess + (j + 1) % tess
            c = ((i + 1) % tess) * tess + j
            d = ((i + 1) % tess) * tess + (j + 1) % tess
            faces += [(a, b, c), (b, d, c)]
    return TriMesh(np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32))


def make_beam_tets(nx: int, ny: int, nz: int, size: float = 1.0) -> TetMesh:
    """Regular (nx,ny,nz)-cell hexahedral beam split into 5 tets per cell.

    (nx*ny*nz*5 tets; used to generate the 100k-tet benchmark mesh.)
    Alternating cell parity keeps shared faces conforming.
    """
    gx, gy, gz = nx + 1, ny + 1, nz + 1
    xs = np.linspace(0.0, size * nx, gx)
    ys = np.linspace(0.0, size * ny, gy)
    zs = np.linspace(0.0, size * nz, gz)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * gy + j) * gz + k

    # 5-tet decompositions for even/odd parity cells
    even = [(0, 1, 2, 5), (0, 2, 3, 7), (0, 5, 7, 4), (2, 7, 5, 6), (0, 2, 5, 7)]
    odd = [(1, 3, 0, 4), (1, 6, 2, 3), (1, 4, 6, 5), (3, 6, 4, 7), (1, 3, 4, 6)]

    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                c = [
                    vid(i, j, k),
                    vid(i + 1, j, k),
                    vid(i + 1, j + 1, k),
                    vid(i, j + 1, k),
                    vid(i, j, k + 1),
                    vid(i + 1, j, k + 1),
                    vid(i + 1, j + 1, k + 1),
                    vid(i, j + 1, k + 1),
                ]
                pattern = even if (i + j + k) % 2 == 0 else odd
                for t in pattern:
                    tets.append((c[t[0]], c[t[1]], c[t[2]], c[t[3]]))
    return TetMesh(verts.astype(np.float64), np.asarray(tets, dtype=np.int32))


def make_plane_grid(nx: int, ny: int, size: float = 1.0) -> TriMesh:
    """Regular (nx,ny)-quad cloth plane WITHOUT center vertices: grid
    vertices only, each quad split into two triangles along a consistent
    diagonal. Unlike make_sym_plane (the reference's X-crossed layout,
    DefaultBuilders/make_sym_plane), the vertex set is a regular grid, so
    A_hat collapses onto constant diagonals and the dia CG
    applies (after canonical renumbering if needed).

    Spans [-size, size]^2 at z=0 regardless of tessellation, matching
    make_sym_plane's [-1,1]^2 extent — the physical scale (and hence
    stable wind/gravity magnitudes per unit mass) is tessellation-
    independent."""
    gx, gy = nx + 1, ny + 1
    xs = np.linspace(-size, size, gx)
    ys = np.linspace(-size, size, gy)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), np.zeros(gx * gy)], axis=1)

    def vid(i, j):
        return i * gy + j

    faces = []
    for i in range(nx):
        for j in range(ny):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            faces.append((a, b, c))
            faces.append((a, c, d))
    return TriMesh(
        vertices=verts, faces=np.asarray(faces, dtype=np.int32)
    )
