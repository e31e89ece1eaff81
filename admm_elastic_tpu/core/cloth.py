"""Grid-cloth layout: host-side packing of a cloth scene whose faces and
hinges group into constant-offset stencils, for the whole-timestep XLA
program of parallel/cloth_spmd.ShardedClothStepper.

ClothStepper packs the same algorithm as a System configured with
{LimitedTriangleStrain, Bend, StaticAnchor, gravity (+WindForce),
global_solver='dia'} on a regular-grid cloth (geometry/make_plane_grid in
any vertex numbering): every element of a stencil group is addressed by a
constant vertex-index offset from its base vertex, so gathers and scatters
are static shifts of whole vertex planes.

Eligibility is structural, not nominal: faces/hinges are grouped by their
vertex-index offsets from each element's minimum index; the layout applies
whenever the grouping is small (a handful of offset stencils) and the
per-group constraint constants are uniform — which is exactly the regular
grid. Scrambled numberings recover the structure via
detect_grid_numbering's canonical permutation.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .solver import assemble_A_hat_dia

# group budget: sym-plane = 4 tri + 6 hinge stencils; editor-reordered
# face lists emit BOTH orientations of each hinge class (the Volino
# element is orientation-dependent, so they cannot be merged) -> up to
# 4 + 12. Each group is unrolled into the step program.
MAX_GROUPS = 16
# the sym-plane tessellation has 4 triangle stencils
MAX_WIND_GROUPS = 4
MAX_DIAGONALS = 24  # symmetric dia planes of the cloth matrix

# geometric multigrid stride ladders (parallel/cloth_spmd solver='mg'),
# tried in preference order (tools/cloth_mg_study.py: PCG-to-1e-10 on the 226x226 cloth
# A_hat — (2,4) 32 iters but its coarsest only fits small grids;
# (2,8) 41 iters; (4,8) 45; (4,16) 58 — vs 600+ for plain Jacobi)
MG_LADDERS = ((2, 4), (2, 8), (4, 8), (4, 16))
MG_MAX_NP2 = 8  # coarsest packed size cap: np2 * 128 dofs


def group_constant_offsets(indices):
    """Group elements by their vertex-offset stencil.

    indices: (E, K) int. base = per-row min. Returns list of
    (offsets tuple(K), element_ids array, bases array), or None if more
    than MAX_GROUPS distinct stencils exist (not a regular grid) or a base
    vertex hosts two elements of the same stencil (cannot happen for valid
    meshes — duplicate elements)."""
    idx = np.asarray(indices, np.int64)
    base = idx.min(axis=1)
    offs = idx - base[:, None]
    keys, inv = np.unique(offs, axis=0, return_inverse=True)
    if len(keys) > MAX_GROUPS:
        return None
    out = []
    for g in range(len(keys)):
        es = np.flatnonzero(inv == g)
        bases = base[es]
        if len(np.unique(bases)) != len(bases):
            return None
        out.append((tuple(int(o) for o in keys[g]), es, bases))
    return out


def detect_symplane_numbering(faces, n):
    """Canonical permutation for the SYM-PLANE tessellation (the
    reference's cloth builder, make_sym_plane / trimesh2
    make_sym_plane): (W+1)x(H+1) grid corners x-major followed by WxH
    quad centers, 4 triangles per quad around the center.

    Under the builder's numbering the center indices live on a
    different row stride than the corners, so NO triangle stencil is
    constant-offset ("one stencil per quad column"). Interleaving each
    x-column's corners with its centers — column x maps to rows
    x*(2H+1): corners at +y, centers at +(H+1)+y — puts every one of
    the 4 triangle classes (and the 6 hinge classes, and A_hat) on
    constant offsets.

    Detection is exact: (W, H) are recovered from the vertex/face
    counts (n = 2WH + W + H + 1, n_faces = 4WH) and the face list must
    REGENERATE verbatim. Returns cid (new index per old vertex) or
    None."""
    f = np.asarray(faces, np.int64)
    if f.ndim != 2 or f.shape[1] != 3 or len(f) % 4:
        return None
    F = len(f) // 4  # = W*H
    s = n - 2 * F - 1  # = W + H
    if F <= 0 or s <= 1:
        return None
    disc = s * s - 4 * F
    if disc < 0:
        return None
    r = int(round(np.sqrt(disc)))
    if r * r != disc or (s - r) % 2:
        return None
    for W, H in {((s + r) // 2, (s - r) // 2), ((s - r) // 2, (s + r) // 2)}:
        if W < 1 or H < 1 or W * H != F:
            continue
        n_grid = (W + 1) * (H + 1)
        quads = []
        for x in range(W):
            for y in range(H):
                ll = y + x * (H + 1)
                lr = y + (x + 1) * (H + 1)
                ul, ur = ll + 1, lr + 1
                cent = n_grid + x * H + y
                quads += [(ll, lr, cent), (lr, ur, cent),
                          (cent, ur, ul), (ll, cent, ul)]
        if not np.array_equal(f, np.asarray(quads, np.int64)):
            continue
        cid = np.empty(n, np.int64)
        for x in range(W + 1):
            base = x * (2 * H + 1)
            cid[x * (H + 1): (x + 1) * (H + 1)] = base + np.arange(H + 1)
        for x in range(W):
            base = x * (2 * H + 1) + (H + 1)
            cid[n_grid + x * H: n_grid + (x + 1) * H] = base + np.arange(H)
        return cid
    return None


def detect_symplane_positions(vertices, rel_tol=1e-5):
    """Position-based sym-plane canonicalization — the STRUCTURAL
    fallback when detect_symplane_numbering's exact-regeneration check
    fails (editor-touched meshes: reordered/rotated faces, renumbered
    vertices — VERDICT r3 'weak' #6).

    Geometry, not connectivity: project the rest positions onto their
    best-fit plane; a sym-plane sheet quantizes onto a half-spacing
    lattice where grid corners land on (even, even) coordinates and quad
    centers on (odd, odd). Any vertex numbering and any face ordering
    produce the same picture. Returns the interleaved-column canonical
    permutation cid (same layout as detect_symplane_numbering) or None.
    The caller validates structurally by actually building the stepper
    (group_constant_offsets + uniform-constants checks), so a false
    positive here cannot mis-simulate — it just fails to engage.
    """
    v = np.asarray(vertices, np.float64)
    n = len(v)
    if n < 5:  # W=H=1 -> 5 vertices
        return None
    c = v.mean(0)
    _, sv, vt = np.linalg.svd(v - c, full_matrices=False)
    scale = max(sv[0], 1e-30)
    if sv[2] > 1e-4 * scale:  # not planar
        return None
    p = (v - c) @ vt[:2].T
    p -= p.min(0)

    q = np.empty((n, 2), np.int64)
    for a in range(2):
        vals = np.unique(np.sort(p[:, a]))
        # merge within tolerance
        keep = [vals[0]]
        for x in vals[1:]:
            if x - keep[-1] > rel_tol * scale * 8:
                keep.append(x)
        keep = np.asarray(keep)
        if len(keep) < 3:
            return None
        h = np.diff(keep)
        if np.abs(h - h[0]).max() > rel_tol * scale * 16:
            return None  # not a uniform half-spacing lattice
        q[:, a] = np.round(p[:, a] / h[0]).astype(np.int64)
        if np.abs(p[:, a] - q[:, a] * h[0]).max() > rel_tol * scale * 16:
            return None
    par = q % 2
    corner = (par[:, 0] == 0) & (par[:, 1] == 0)
    center = (par[:, 0] == 1) & (par[:, 1] == 1)
    if not (corner | center).all():
        return None
    W2, H2 = q.max(0)
    if W2 % 2 or H2 % 2 or W2 < 2 or H2 < 2:
        return None
    W, H = W2 // 2, H2 // 2
    if corner.sum() != (W + 1) * (H + 1) or center.sum() != W * H:
        return None
    i, j = q[:, 0] // 2, q[:, 1] // 2
    cid = np.where(
        corner,
        i * (2 * H + 1) + j,
        i * (2 * H + 1) + (H + 1) + j,
    ).astype(np.int64)
    if len(np.unique(cid)) != n:
        return None
    return cid


def _uniform(arr, rel=1e-6):
    """Representative value if all rows of `arr` are equal (to rel
    tolerance of the magnitude scale), else None."""
    a = np.asarray(arr, np.float64)
    r = a.reshape(len(a), -1)
    scale = max(1.0, float(np.abs(r[0]).max()))
    if np.abs(r - r[0]).max() > rel * scale:
        return None
    return a[0]


class ClothStepper:
    """Packed grid-cloth layout of one scene (the single-device input of
    parallel/cloth_spmd.ShardedClothStepper, which steps it).

    Matches System semantics for: one LimitedTriangleStrain (uniform
    stiffness/limits per stencil group), an optional Bend (uniform alpha
    per group), StaticAnchors (uniform weight), all-node gravity kicks, an
    optional WindForce over groupable triangles, and the dia global solve
    with `cg_iters` fixed Jacobi-PCG iterations."""

    model = "cloth"

    def __init__(self, vertices, masses, tri_force, bend_force, anchor_idx,
                 anchor_weight=1000.0, gravity=(0.0, -9.8, 0.0),
                 wind=None, dt=0.04, admm_iters=10, cg_iters=25,
                 dtype=jnp.float32, collect_residuals=False):
        from ..models.anchor import StaticAnchor

        #: per-iteration residual collection: "primal", or True for primal
        #: + dual (the dual via a second reverse-shift accumulation)
        self.collect_residuals = (
            collect_residuals if collect_residuals in (True, "primal")
            else bool(collect_residuals)
        )

        v = np.asarray(vertices, np.float64)
        n = len(v)
        self.n_nodes = n
        self.dt = float(dt)
        self.admm_iters = int(admm_iters)
        self.cg_iters = int(cg_iters)
        self.dtype = dtype
        self.gravity = tuple(float(q) for q in gravity)
        masses = np.broadcast_to(np.asarray(masses, np.float64), (n,)).copy()

        groups = []  # kernel group tuples
        # masks rows 0-2 are [anchor w2, masses, 1/diag]; group validity
        # planes follow, deduplicated by content (on a grid the wind
        # groups share the triangle groups' base sets)
        mask_planes = []
        _plane_rows = {}

        def mask_row(bases):
            key = bases.tobytes()
            if key not in _plane_rows:
                plane = np.zeros(n)
                plane[bases] = 1.0
                _plane_rows[key] = 3 + len(mask_planes)
                mask_planes.append(plane)
            return _plane_rows[key]

        # ---- triangle strain groups
        pt, _ = tri_force.build(v, masses, self.dt)
        gt = group_constant_offsets(tri_force.faces)
        if gt is None:
            raise ValueError("faces are not constant-offset groupable")
        for offs, es, bases in gt:
            cp = _uniform(pt["coeff"][es])  # (2,3)
            w = _uniform(pt["weight"][es])
            k = _uniform(pt["k"][es])
            lmin = _uniform(pt["limit_min"][es])
            lmax = _uniform(pt["limit_max"][es])
            if any(q is None for q in (cp, w, k, lmin, lmax)):
                raise ValueError("non-uniform triangle group constants")
            groups.append((
                "tri", offs, tuple(float(q) for q in cp.ravel()),
                float(w) ** 2, float(k), float(lmin), float(lmax),
                mask_row(np.sort(bases)), bool(tri_force.strain_limiting),
            ))

        # ---- bend groups
        pb = None
        if bend_force is not None and bend_force.n_elements:
            pb, _ = bend_force.build(v, masses, self.dt)
            gh = group_constant_offsets(bend_force.hinges)
            if gh is None or len(groups) + len(gh) > MAX_GROUPS:
                raise ValueError("hinges are not constant-offset groupable")
            for offs, es, bases in gh:
                al = _uniform(pb["alpha"][es])  # (4,)
                w = _uniform(pb["weight"][es])
                k = _uniform(pb["stiffness"][es])
                if any(q is None for q in (al, w, k)):
                    raise ValueError("non-uniform bend group constants")
                # projection row weights (alpha0, alpha3, alpha1)
                # (BendForce.cpp:139-142, models/bend.py)
                arow = (float(al[0]), float(al[3]), float(al[1]))
                groups.append((
                    "bend", offs, arow, float(w) ** 2, float(k),
                    mask_row(np.sort(bases)),
                ))

        self.groups = tuple(groups)
        self.n_groups = len(groups)

        # ---- wind groups (optional; reuse the grouping machinery)
        wind_groups = []
        self.wind_dir = (0.0, 0.0, 0.0)
        if wind is not None:
            wdir, wtris = wind
            gw = group_constant_offsets(wtris)
            if gw is None or len(gw) > MAX_WIND_GROUPS:
                raise ValueError("wind triangles not groupable")
            self.wind_dir = tuple(float(q) for q in wdir)
            for offs, es, bases in gw:
                wind_groups.append((offs, mask_row(np.sort(bases))))
        self.wind_groups = tuple(wind_groups)

        # ---- exact same global matrix as the general path, stored as
        # symmetric diagonals (offsets >= 0; vals[d,i] = A[i,i+off])
        anchor_idx = np.asarray(anchor_idx, np.int64).reshape(-1)
        fp = {"tri": pt}
        if pb is not None:
            fp["bend"] = pb
        if len(anchor_idx):
            anc = StaticAnchor(anchor_idx, weight=anchor_weight)
            p_anc, _ = anc.build(v, masses, self.dt)
            fp["anchor"] = p_anc
        out = assemble_A_hat_dia(n, masses, self.dt, fp,
                                 max_diagonals=2 * MAX_DIAGONALS)
        if out is None:
            raise ValueError("mesh is not dia-structured (not a grid?)")
        all_offs, dia_vals, diag = out
        pos = [d for d, o in enumerate(all_offs) if o >= 0]
        if len(pos) > MAX_DIAGONALS:
            raise ValueError("too many diagonals for the cloth layout")
        self.dia_offs = tuple(all_offs[d] for d in pos)
        dia_vals = dia_vals[pos]

        self.N = -(-n // 128) * 128
        pad = self.N - n

        def padp(a, fill=0.0):
            return np.pad(np.asarray(a, np.float64), ((0, 0), (0, pad)),
                          constant_values=fill)

        self._dia = jnp.asarray(padp(dia_vals), dtype)
        aw2 = np.zeros(n)
        aw2[anchor_idx] = float(anchor_weight) ** 2
        invd = np.pad(1.0 / diag, (0, pad), constant_values=1.0)
        self._masks = jnp.asarray(
            np.concatenate(
                [padp(np.stack([aw2, masses])), invd[None, :],
                 padp(np.stack(mask_planes))], axis=0,
            ), dtype,
        )
        self._ancz = jnp.asarray(padp(v.T), dtype)

        self.state = {
            "x": jnp.asarray(np.pad(v.T, ((0, 0), (0, pad))), dtype),
            "v": jnp.zeros((3, self.N), dtype),
            "u": jnp.zeros((self.n_groups, 16, self.N), dtype),
            "ancu": jnp.zeros((3, self.N), dtype),
            "t": jnp.asarray(0.0, dtype),
        }

def cloth_from_system(system):
    """Build a ClothStepper equivalent to a buildable System when its
    mesh/forces qualify. Returns (stepper, to_canonical) or None.

    Qualifying configuration: one LimitedTriangleStrain whose faces group
    into constant-offset stencils with uniform constants, at most one Bend
    (same condition on hinges), StaticAnchors with one shared weight,
    all-node ExplicitForce kicks, at most one WindForce over groupable
    triangles, and a dia-structured A_hat. A scrambled grid numbering is
    recovered via detect_grid_numbering."""
    from ..models.anchor import StaticAnchor
    from ..models.bend import Bend
    from ..models.explicit import ExplicitForce, WindForce
    from ..models.triangle import LimitedTriangleStrain
    from .lattice import detect_grid_numbering

    s = system.settings
    # residual-driven early exit, over-relaxation, Anderson, the AMG
    # preconditioner and per-iteration CG schedules need the general path
    if s.collect_residuals not in (False, None, True, "primal") or (
            s.residual_tol is not None):
        return None
    if (s.relaxation != 1.0 or s.acceleration is not None
            or s.preconditioner != "jacobi"
            or isinstance(s.cg_fixed_iters, (tuple, list))):
        return None

    tri = None
    bend = None
    anchors = []
    for f in system.forces:
        if type(f) is LimitedTriangleStrain:
            if tri is not None:
                return None
            tri = f
        elif type(f) is Bend:
            if bend is not None:
                return None
            bend = f
        elif isinstance(f, StaticAnchor):
            anchors.append(f)
        else:
            return None
    if tri is None:
        return None

    anchor_weight = 1000.0
    if anchors:
        aw = np.unique(np.concatenate([np.asarray(a.weight).ravel()
                                       for a in anchors]))
        if len(aw) != 1:
            return None
        anchor_weight = float(aw[0])

    gravity = np.zeros(3)
    wind = None
    for e in system.explicit_forces:
        if isinstance(e, WindForce):
            if wind is not None:
                return None
            wind = e
        elif isinstance(e, ExplicitForce):
            if getattr(e, "indices", None) is not None:
                return None
            gravity = gravity + np.asarray(e.direction, np.float64)
        else:
            return None

    verts = np.asarray(system._x, np.float64)
    n = system.n_nodes
    anchor_idx = (np.concatenate([np.asarray(a.indices, np.int64).ravel()
                                  for a in anchors])
                  if anchors else np.zeros(0, np.int64))

    def build(cid):
        """Try building with vertex permutation cid (None = identity)."""
        if cid is None:
            vv, mm, remap = verts, system._m, lambda idx: np.asarray(idx)
        else:
            vv = np.empty_like(verts)
            vv[cid] = verts
            mm = np.empty(n)
            mm[cid] = system._m
            remap = lambda idx: cid[np.asarray(idx, np.int64)]
        tri_r = LimitedTriangleStrain(
            remap(tri.faces), tri.stiffness, tri.limit_min, tri.limit_max,
            strain_limiting=tri.strain_limiting,
        )
        bend_r = (Bend(remap(bend.hinges), bend.stiffness)
                  if bend is not None else None)
        wind_arg = ((np.asarray(wind.direction, np.float64),
                     remap(wind.tris)) if wind is not None else None)
        try:
            stepper = ClothStepper(
                vv, mm, tri_r, bend_r, remap(anchor_idx),
                anchor_weight=anchor_weight, gravity=tuple(gravity),
                wind=wind_arg, dt=s.timestep_s, admm_iters=s.admm_iters,
                cg_iters=(s.cg_fixed_iters
                          if s.cg_fixed_iters is not None else 25),
                dtype=s.dtype,
                collect_residuals=(s.collect_residuals
                                   if s.collect_residuals in
                                   (True, "primal") else False),
            )
        except ValueError:
            return None
        return stepper

    stepper = build(None)
    if stepper is not None:
        return stepper, np.arange(n)
    for detect in (lambda: detect_grid_numbering(verts),
                   lambda: detect_symplane_numbering(tri.faces, n),
                   lambda: detect_symplane_positions(verts)):
        cid = detect()
        if cid is None:
            continue
        stepper = build(cid)
        if stepper is not None:
            return stepper, cid
    return None
