"""Grid-cloth whole-timestep layout vs the general System path.

The cloth layout (core/cloth.py, stepped by the XLA program of
parallel/cloth_spmd.ShardedClothStepper on a one-device mesh) must
reproduce the general {LimitedTriangleStrain, Bend, StaticAnchor,
gravity+wind, dia} System trajectory to round-off, in any vertex
numbering. The general-path references project triangles with the
layout's own plane arithmetic (the `tri_lanes` fixture);
test_cloth_fast_path_vs_xla_backend compares against the model's
independent SVD instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.geometry import extract_hinges, make_plane_grid
from admm_elastic_tpu.models import (
    Bend,
    ExplicitForce,
    LimitedTriangleStrain,
    StaticAnchor,
    WindForce,
)


@pytest.fixture(autouse=True)
def _lanes_reference(request, tri_lanes):
    if "xla_backend" not in request.node.name:
        tri_lanes()


def _cloth_system(fast, *, nx=8, ny=6, wind=True, bend=True, anchors=True,
                  scramble=None, dtype=jnp.float64,
                  iters=10, cg=30, settings_kw=None):
    mesh = make_plane_grid(nx, ny)
    n = mesh.n_vertices
    verts = mesh.vertices
    faces = mesh.faces
    if scramble is not None:
        perm = np.random.RandomState(scramble).permutation(n)
        verts = verts[perm]
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        faces = inv[faces]
    kw = dict(
        timestep_s=0.04, admm_iters=iters, verbose=0, dtype=dtype,
        global_solver="dia", cg_fixed_iters=cg, lattice_fast_path=fast,
    )
    kw.update(settings_kw or {})
    sys_ = System(Settings(**kw))
    sys_.add_nodes(verts, np.full(n, 0.5 / n))
    sys_.add_force(LimitedTriangleStrain(faces, 100.0, 0.95, 1.05))
    if bend:
        sys_.add_force(Bend(extract_hinges(faces), 20.0))
    if anchors:
        top = np.flatnonzero(np.abs(verts[:, 1] - 1.0) < 1e-9)
        sys_.add_force(StaticAnchor(top[:4]))
    sys_.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    if wind:
        sys_.add_explicit_force(WindForce(faces, direction=(1.5, 0, 0.4)))
    assert sys_.initialize()
    return sys_


def _compare(steps=5, atol=1e-12, **kw):
    gen = _cloth_system(False, **kw)
    fast = _cloth_system(True, **kw)
    assert fast._lattice is not None, "cloth layout did not engage"
    assert fast._lattice.model == "cloth"
    for _ in range(steps):
        gen.step()
        fast.step()
        np.testing.assert_allclose(fast.x, gen.x, atol=atol)
    return gen, fast


def test_cloth_fast_path_full_physics():
    """Strain limiting + bend + anchors + gravity + wind: trajectory match
    to round-off against the general dia path (identical projection
    code)."""
    _compare()


def test_cloth_fast_path_vs_xla_backend():
    """Same comparison against the model's own XLA projection (independent
    SVD implementation) — loose tolerance covers fp ordering differences."""
    _compare(atol=1e-8)


def test_cloth_fast_path_no_wind_no_bend():
    """Minimal config: strain + anchors + gravity only."""
    _compare(wind=False, bend=False)


def test_cloth_fast_path_no_anchors():
    """Anchor-free cloth in free fall (A = M + dt^2 D^T W^2 D stays SPD
    through the mass matrix alone)."""
    _compare(steps=3, anchors=False, wind=False)


def test_cloth_fast_path_scrambled_numbering():
    """A randomly renumbered grid engages the fast path via
    detect_grid_numbering's canonical permutation and matches the general
    path running on the scrambled numbering."""
    gen, fast = _compare(scramble=7)
    assert not np.array_equal(np.asarray(fast._to_canon),
                              np.arange(gen.n_nodes))


def test_cloth_fast_path_adversarial_params():
    """Parameter-diverse parity: ASYMMETRIC strain limits actually engaged
    (0.6/1.02 under strong wind), nondefault anchor weight, skewed
    gravity, strong off-axis wind — guards against coefficient bugs that
    default-parameter tests cannot see (the round-1 NH Hessian bug
    class). Per-ELEMENT parameters are out of the cloth layout's
    documented scope (uniform per stencil group) and fall back to the
    general path — asserted below."""
    mesh = make_plane_grid(7, 5)
    n = mesh.n_vertices

    def build(fast, stiff=35.0):
        s = System(Settings(
            timestep_s=0.04, admm_iters=8, verbose=0, dtype=jnp.float64,
            global_solver="dia", cg_fixed_iters=30, lattice_fast_path=fast,
        ))
        s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
        s.add_force(LimitedTriangleStrain(
            mesh.faces, stiff, limit_min=0.6, limit_max=1.02))
        s.add_force(Bend(extract_hinges(mesh.faces), 3.5))
        top = np.flatnonzero(np.abs(mesh.vertices[:, 1] - 1.0) < 1e-9)
        s.add_force(StaticAnchor(top[:3], weight=77.0))
        s.add_explicit_force(ExplicitForce(direction=(0.3, -9.8, 0.1)))
        s.add_explicit_force(WindForce(mesh.faces, direction=(4.0, 1.0, -2.5)))
        assert s.initialize()
        return s

    gen = build(False)
    fast = build(True)
    assert fast._lattice is not None and fast._lattice.model == "cloth"
    for _ in range(6):
        gen.step()
        fast.step()
        np.testing.assert_allclose(fast.x, gen.x, atol=1e-11)

    # per-element stiffness falls back (documented uniform-per-group scope)
    E = len(mesh.faces)
    pe = build(True, stiff=35.0 * (0.5 + np.random.RandomState(1).rand(E)))
    assert pe._lattice is None
    pe.step()
    assert np.isfinite(pe.x).all()


def test_cloth_in_kernel_primal_residuals():
    """collect_residuals='primal' keeps the cloth layout engaged and
    emits per-iteration primal residuals matching the general path's
    instrumentation (triangle + bend + anchor pieces)."""

    def build(fast, collect):
        mesh = make_plane_grid(6, 5)
        n = mesh.n_vertices
        s = System(Settings(
            timestep_s=0.04, admm_iters=8, verbose=0, dtype=jnp.float64,
            global_solver="dia", cg_fixed_iters=30, lattice_fast_path=fast,
            collect_residuals=collect,
        ))
        s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
        s.add_force(LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05))
        s.add_force(Bend(extract_hinges(mesh.faces), 20.0))
        top = np.flatnonzero(np.abs(mesh.vertices[:, 1] - 1.0) < 1e-9)
        s.add_force(StaticAnchor(top[:4]))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        s.add_explicit_force(WindForce(mesh.faces, direction=(1.5, 0, 0.4)))
        assert s.initialize()
        return s

    ref = build(False, True)
    fast = build(True, "primal")
    assert fast._lattice is not None and fast._lattice.model == "cloth"
    for _ in range(5):
        ref.step()
        fast.step()
        rp_ref = np.asarray(ref.last_aux["primal_residual"])
        rp_fast = np.asarray(fast.last_aux["primal_residual"])
        np.testing.assert_allclose(rp_fast, rp_ref, rtol=1e-6, atol=1e-10)
        assert rp_ref[-1] < rp_ref[0]


def test_cloth_rollout_matches_stepping():
    """run(n) (scanned rollout windows) == n x step()."""
    a = _cloth_system(True, nx=6, ny=5)
    b = _cloth_system(True, nx=6, ny=5)
    assert a._lattice is not None and b._lattice is not None
    for _ in range(4):
        a.step()
    b.run(4)
    np.testing.assert_allclose(np.asarray(b.x), np.asarray(a.x), atol=1e-13)


def test_cloth_fast_path_rejects_nongrid():
    """A genuinely non-groupable mesh (sym plane with JITTERED positions
    under a scrambled vertex numbering: no constant-offset stencils, no
    detector matches — scrambled-but-regular sheets now qualify via the
    position detector, test_cloth_symplane_editor_touched) falls back to
    the general solver gracefully."""
    from admm_elastic_tpu.geometry import make_sym_plane

    mesh = make_sym_plane(6, 5)
    n = mesh.n_vertices
    rng = np.random.RandomState(0)
    perm = rng.permutation(n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    verts = mesh.vertices[perm]
    verts = verts + 0.005 * rng.standard_normal(verts.shape)
    faces = inv[mesh.faces]
    sys_ = System(Settings(timestep_s=0.04, admm_iters=4, verbose=0,
                           dtype=jnp.float64, lattice_fast_path=True))
    sys_.add_nodes(verts, np.full(n, 0.5 / n))
    sys_.add_force(LimitedTriangleStrain(faces, 100.0, 0.95, 1.05))
    sys_.add_force(StaticAnchor([0, 1]))
    sys_.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys_.initialize()
    assert sys_._lattice is None
    sys_.step()
    assert np.isfinite(sys_.x).all()


def test_group_constant_offsets():
    """Grid faces/hinges group into 2/3 stencils; degenerate duplicate
    elements are rejected."""
    from admm_elastic_tpu.core.cloth import group_constant_offsets

    mesh = make_plane_grid(5, 4)
    gt = group_constant_offsets(mesh.faces)
    assert gt is not None and len(gt) == 2
    assert sum(len(es) for _, es, _ in gt) == len(mesh.faces)
    gh = group_constant_offsets(extract_hinges(mesh.faces))
    assert gh is not None and len(gh) == 3
    dup = np.vstack([mesh.faces, mesh.faces[:1]])
    assert group_constant_offsets(dup) is None


@pytest.mark.parametrize("key", ["x", "v"])
def test_cloth_fast_path_state_access(key):
    """System.x/.v round-trip through the stepper's plane layout."""
    fast = _cloth_system(True, nx=5, ny=4, wind=False)
    assert fast._lattice is not None
    fast.step()
    val = getattr(fast, key)
    assert val.shape == (fast.n_nodes, 3)
    assert np.isfinite(val).all()
    if key == "x":
        fast.x = val  # setter writes back into plane layout
        np.testing.assert_allclose(fast.x, val, atol=1e-13)


def test_cloth_in_kernel_multigrid_trajectory():
    """preconditioner='amg' takes the general path with the aggregation
    AMG V-cycle (core/amg.py) even when the cloth layout is requested. At
    a small fixed V-cycle-PCG budget the trajectory matches the cloth
    layout running a deep Jacobi budget (both converge the global
    solves), f64."""
    mg = _cloth_system(True, nx=20, ny=15, cg=12,
                       settings_kw={"preconditioner": "amg"})
    assert mg._lattice is None and mg._amg_meta is not None
    deep = _cloth_system(True, nx=20, ny=15, cg=400)
    assert deep._lattice is not None
    for _ in range(4):
        mg.step()
        deep.step()
    np.testing.assert_allclose(np.asarray(mg.x), np.asarray(deep.x),
                               atol=2e-7)


def test_cloth_in_kernel_multigrid_matched_residual():
    """The matched-residual guarantee (VERDICT round-1 item): at 8 fixed
    V-cycle-PCG iterations (general AMG) the per-step final ADMM primal
    residual stays within a few percent of an effectively exact global
    solve (1e-13 tolerance CG on the general path) — where the Jacobi
    budget needed for the same match grows with grid diameter."""
    kw = dict(nx=40, ny=30, iters=8)
    exact = _cloth_system(
        False, cg=None,
        settings_kw={"global_solver": "ell", "cg_tol": 1e-13,
                     "cg_max_iters": 3000, "collect_residuals": True},
        **kw,
    )
    mg = _cloth_system(
        True, cg=8,
        settings_kw={"preconditioner": "amg",
                     "collect_residuals": "primal"},
        **kw,
    )
    assert mg._lattice is None and mg._amg_meta is not None
    worst = 0.0
    for _ in range(4):
        exact.step()
        mg.step()
        re = float(np.asarray(exact.last_aux["primal_residual"])[-1])
        rf = float(np.asarray(mg.last_aux["primal_residual"])[-1])
        worst = max(worst, rf / re)
    assert worst < 1.1, f"mg residual drifted from exact solve: {worst}"


def test_cloth_in_kernel_dual_residuals():
    """collect_residuals=True keeps the cloth layout engaged and emits
    BOTH residuals; dual matches the general path
    (triangle + bend + anchor contributions, iteration-0 baseline
    z_prev = D x_pre via the (A_hat - M) x / dt^2 identity)."""

    def build(fast):
        mesh = make_plane_grid(6, 5)
        n = mesh.n_vertices
        s = System(Settings(
            timestep_s=0.04, admm_iters=8, verbose=0, dtype=jnp.float64,
            global_solver="dia", cg_fixed_iters=30, lattice_fast_path=fast,
            collect_residuals=True,
        ))
        s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
        s.add_force(LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05))
        s.add_force(Bend(extract_hinges(mesh.faces), 20.0))
        top = np.flatnonzero(np.abs(mesh.vertices[:, 1] - 1.0) < 1e-9)
        s.add_force(StaticAnchor(top[:4]))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        s.add_explicit_force(WindForce(mesh.faces, direction=(1.5, 0, 0.4)))
        assert s.initialize()
        return s

    ref = build(False)
    fast = build(True)
    assert fast._lattice is not None and fast._lattice.model == "cloth"
    for _ in range(5):
        ref.step()
        fast.step()
        for key in ("primal_residual", "dual_residual"):
            r_ref = np.asarray(ref.last_aux[key])
            r_fast = np.asarray(fast.last_aux[key])
            np.testing.assert_allclose(r_fast, r_ref, rtol=1e-6,
                                       atol=1e-10, err_msg=key)
        np.testing.assert_allclose(np.asarray(fast.x), np.asarray(ref.x),
                                   rtol=1e-8, atol=1e-10)


def test_cloth_symplane_fast_path():
    """The reference's actual cloth tessellation (make_sym_plane: grid
    corners + quad centers, 4 triangles per quad — the windyflag flag)
    rides the grid-cloth layout: the
    interleaved-column renumbering (detect_symplane_numbering) puts all
    4 triangle stencils, 6 hinge stencils, 4 wind groups and A_hat on
    constant offsets. Full windyflag physics parity vs the general
    path."""
    from admm_elastic_tpu.geometry import make_sym_plane

    mesh = make_sym_plane(8, 6)

    def build(fast):
        n = mesh.n_vertices
        s = System(Settings(timestep_s=0.04, admm_iters=8, verbose=0,
                            dtype=jnp.float64, global_solver="dia",
                            cg_fixed_iters=30, lattice_fast_path=fast))
        s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
        s.add_force(LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05))
        s.add_force(Bend(extract_hinges(mesh.faces), 20.0))
        s.add_force(StaticAnchor([0, 6]))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        s.add_explicit_force(WindForce(mesh.faces, direction=(1.5, 0, 0.4)))
        assert s.initialize()
        return s

    fast = build(True)
    assert fast._lattice is not None and fast._lattice.model == "cloth"
    assert len(fast._lattice.base.groups) == 10  # 4 tri + 6 bend stencils
    assert len(fast._lattice.base.wind_groups) == 4
    ref = build(False)
    for _ in range(5):
        fast.step()
        ref.step()
    np.testing.assert_allclose(np.asarray(fast.x), np.asarray(ref.x),
                               rtol=1e-9, atol=1e-11)
    # cloth genuinely moved (wind + gravity act)
    assert np.abs(np.asarray(ref.x) - mesh.vertices).max() > 1e-3


def test_detect_symplane_numbering_rejects():
    """The detector regenerates the face list exactly — reordered faces,
    plain grids, and arbitrary meshes are rejected (no false routes)."""
    from admm_elastic_tpu.core.cloth import detect_symplane_numbering
    from admm_elastic_tpu.geometry import make_sym_plane

    m = make_sym_plane(5, 4)
    assert detect_symplane_numbering(m.faces, m.n_vertices) is not None
    shuffled = m.faces[::-1]
    assert detect_symplane_numbering(shuffled, m.n_vertices) is None
    g = make_plane_grid(6, 5)
    assert detect_symplane_numbering(g.faces, g.n_vertices) is None


def test_cloth_symplane_editor_touched():
    """Editor-touched sym-plane sheets (renumbered vertices + reordered
    faces — what exporters actually do) still ride the cloth layout via
    the POSITION-based structural detector (detect_symplane_positions).
    The exact face-list-regeneration detector rejects them, and before
    round 4 they silently fell off a 6x cliff onto the dense path.
    (Within-face cyclic ROTATIONS additionally multiply the tri/hinge
    stencil classes past the layout's group budget and still fall back
    gracefully — that is the structural qualifier working as designed.)"""
    from admm_elastic_tpu.core.cloth import detect_symplane_positions
    from admm_elastic_tpu.geometry import make_sym_plane

    mesh = make_sym_plane(8, 6)
    rng = np.random.default_rng(7)
    perm = rng.permutation(mesh.n_vertices)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    verts = mesh.vertices[perm]
    faces = inv[mesh.faces]
    rng.shuffle(faces)

    assert detect_symplane_positions(verts) is not None

    def build(fast, v, f):
        n = len(v)
        s = System(Settings(timestep_s=0.04, admm_iters=8, verbose=0,
                            dtype=jnp.float64, global_solver="dia",
                            cg_fixed_iters=30, lattice_fast_path=fast))
        s.add_nodes(v, np.full(n, 0.5 / n))
        s.add_force(LimitedTriangleStrain(f, 100.0, 0.95, 1.05))
        s.add_force(Bend(extract_hinges(f), 20.0))
        s.add_force(StaticAnchor(
            np.flatnonzero((np.abs(v[:, 1] - v[:, 1].max()) < 1e-9)
                           & ((np.abs(v[:, 0] - v[:, 0].min()) < 1e-9)
                              | (np.abs(v[:, 0] - v[:, 0].max()) < 1e-9)))
        ))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    fast = build(True, verts, faces)
    assert fast._lattice is not None and fast._lattice.model == "cloth"
    ref = build(False, verts, faces)
    for _ in range(5):
        fast.step()
        ref.step()
    np.testing.assert_allclose(np.asarray(fast.x), np.asarray(ref.x),
                               rtol=1e-9, atol=1e-11)


def test_detect_symplane_positions_rejects():
    """No false engagement: jittered (non-lattice) positions, plain
    grids without centers, and non-planar sheets are rejected."""
    from admm_elastic_tpu.core.cloth import detect_symplane_positions
    from admm_elastic_tpu.geometry import make_sym_plane

    m = make_sym_plane(5, 4)
    rng = np.random.default_rng(0)
    jit = m.vertices + 0.01 * rng.standard_normal(m.vertices.shape)
    assert detect_symplane_positions(jit) is None
    g = make_plane_grid(6, 5)
    assert detect_symplane_positions(g.vertices) is None
    bent = m.vertices.copy()
    bent[:, 2] += 0.3 * bent[:, 0] ** 2
    assert detect_symplane_positions(bent) is None


def test_cloth_kernel_state_stays_bounded():
    """Round-4 soak regression: ungated pad-lane gravity made padding
    free-fall (x_pad = g t^2/2), and ungated dual updates let PHANTOM
    bases (validity mask 0, stencils wrapping across columns) integrate
    |Dx| per ADMM iteration — the strain-limit clamp breaks the prox
    contraction — until the f32 SVD overflowed at |u| ~ 4.3e9 after about
    1,300 steps. With the gates, pads never move and phantom duals stay
    exactly zero."""
    from admm_elastic_tpu.geometry import make_sym_plane

    mesh = make_sym_plane(8, 6)
    n = mesh.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=30, verbose=0,
                        dtype=jnp.float32, global_solver="dia",
                        cg_fixed_iters=20, lattice_fast_path=True))
    s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
    s.add_force(LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05))
    s.add_force(StaticAnchor([0, 6]))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    assert s._lattice is not None and s._lattice.model == "cloth"
    x_pad0 = np.asarray(s._lattice.base.state["x"])[:, n:].copy()
    s._lattice.run(20)
    lat = s._lattice.detach()
    st = lat.state
    # pads never move (gravity gated to real vertices)
    np.testing.assert_array_equal(np.asarray(st["x"])[:, n:], x_pad0)
    assert np.abs(np.asarray(st["v"])[:, n:]).max() == 0.0
    # phantom duals exactly zero; valid duals physically bounded
    u = np.asarray(st["u"])
    masks = np.asarray(lat._masks)
    for g, spec in enumerate(lat.groups):
        mrow = spec[7] if spec[0] == "tri" else spec[5]
        phantom = masks[mrow] == 0.0
        assert np.abs(u[g][:, phantom]).max() == 0.0, f"group {g}"
    assert np.abs(u).max() < 20.0, np.abs(u).max()
    # non-anchor ancu exactly zero
    aw2 = masks[0]
    assert np.abs(np.asarray(st["ancu"])[:, aw2 == 0]).max() == 0.0
