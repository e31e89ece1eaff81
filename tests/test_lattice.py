"""Whole-mesh layouts on structured tet lattices, through System.

`lattice_fast_path=True` steps a beam lattice through the banded layout
(core/banded.py), run by the XLA program of
parallel/banded_spmd.ShardedBandedStepper on a one-device mesh; these
tests pin it against the general System path, and the grid detection
(core/lattice.detect_grid_numbering) that lets scrambled numberings
qualify."""

import jax.numpy as jnp
import numpy as np

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.core.lattice import detect_grid_numbering
from admm_elastic_tpu.geometry import make_beam_tets
from admm_elastic_tpu.models import ExplicitForce, HyperElasticTet, StaticAnchor
from admm_elastic_tpu.parallel.banded_spmd import ShardedBandedStepper


def _scrambled_beam(nx, ny, nz, size, seed=0, shift=(0.0, 0.0, 0.0)):
    beam = make_beam_tets(nx, ny, nz, size=size)
    verts = beam.vertices + np.asarray(shift)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(beam.n_vertices)  # new_id = perm_pos
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return verts[perm], inv[beam.tets]


def test_group_tables_match_mesh():
    """The beam generator's numbering IS the canonical grid order: the
    detector returns the identity, so the dia matvec and the banded layout
    see the generator's tets unchanged."""
    for dims in ((3, 2, 2), (5, 4, 3)):
        beam = make_beam_tets(*dims, size=0.25)
        cid = detect_grid_numbering(beam.vertices)
        assert cid is not None
        np.testing.assert_array_equal(cid, np.arange(beam.n_vertices))


def _general_system(beam, masses, anchors, mu, lam, dt, iters, cg, fast):
    sys_ = System(Settings(timestep_s=dt, admm_iters=iters, verbose=0,
                           dtype=jnp.float64, global_solver="dia",
                           cg_fixed_iters=cg, lattice_fast_path=fast))
    sys_.add_nodes(beam.vertices, masses)
    sys_.add_force(StaticAnchor(anchors))
    sys_.add_force(HyperElasticTet(beam.tets, mu, lam, max_iters=5,
                                   model="nh"))
    sys_.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys_.initialize()
    return sys_


def test_lattice_stepper_matches_general_system(nh_kernel):
    """Banded layout (D=1) == general System (dia solver): tight against
    the general path running the Pallas NH kernel (interpret mode — the
    layout's own prox arithmetic), loose against the XLA local step
    (its Newton line search differs in floating-point detail)."""
    nx, ny, nz, size = 4, 3, 2, 0.2
    mu = lam = 2e4
    dt, iters, cg = 0.04, 8, 40
    beam = make_beam_tets(nx, ny, nz, size)
    n = beam.n_vertices
    masses = np.full(n, 2.0 / n)
    anchors = np.flatnonzero(beam.vertices[:, 0] < 1e-9)

    args = (beam, masses, anchors, mu, lam, dt, iters, cg)
    lat = _general_system(*args, fast=True)
    assert isinstance(lat._lattice, ShardedBandedStepper)
    sys_x = _general_system(*args, fast=False)
    with nh_kernel():
        sys_p = _general_system(*args, fast=False)
        for _ in range(6):
            sys_p.step()
    xs_p = sys_p.x

    for s in range(6):
        sys_x.step()
        lat.step()
    err = np.abs(xs_p - lat.x).max()
    assert err < 1e-6, f"max|dx| vs kernel = {err}"
    errx = np.abs(sys_x.x - lat.x).max()
    assert errx < 5e-3, f"max|dx| vs xla = {errx}"
    assert np.isfinite(lat.x).all()
    # the beam actually moved (sagged under gravity)
    assert lat.x[:, 1].min() < beam.vertices[:, 1].min() - 1e-4


def test_lattice_rollout_matches_stepping():
    nx, ny, nz, size = 3, 2, 2, 0.2
    beam = make_beam_tets(nx, ny, nz, size)
    n = beam.n_vertices
    masses = np.full(n, 1.0 / n)
    anchors = np.flatnonzero(beam.vertices[:, 0] < 1e-9)

    def mk():
        s = _general_system(beam, masses, anchors, 1e4, 1e4, 0.04, 5, 30,
                            fast=True)
        assert s._lattice is not None
        return s

    a, b = mk(), mk()
    for _ in range(4):
        a.step()
    b.run(4)
    np.testing.assert_allclose(a.x, b.x, rtol=1e-12, atol=1e-12)


def test_detect_lattice_scrambled_numbering():
    """detect_grid_numbering recovers the canonical grid ids from a
    randomly renumbered, translated beam, and rejects jittered
    (non-grid) positions."""
    sverts, _ = _scrambled_beam(4, 3, 2, 0.3, shift=(1.5, -2.0, 0.25))
    cid = detect_grid_numbering(sverts)
    assert cid is not None
    canon = make_beam_tets(4, 3, 2, size=0.3).vertices + np.array(
        [1.5, -2.0, 0.25])
    np.testing.assert_allclose(canon[cid], sverts, atol=1e-9)

    rng = np.random.default_rng(1)
    jit = sverts + 0.01 * rng.standard_normal(sverts.shape)
    assert detect_grid_numbering(jit) is None


def _lat_system(beam_or_verts, tets, masses, dt, iters, cg, fast,
                model="nh", mu=1e4, lam=1e4, floor_y=None, anchors=None):
    from admm_elastic_tpu.models import Collision, Floor, LinearTetStrain

    verts = beam_or_verts
    sys_ = System(Settings(timestep_s=dt, admm_iters=iters, verbose=0,
                           dtype=jnp.float64, global_solver="dia",
                           cg_fixed_iters=cg, lattice_fast_path=fast))
    sys_.add_nodes(verts, masses)
    if anchors is not None and len(anchors):
        sys_.add_force(StaticAnchor(anchors))
    if model == "arap":
        sys_.add_force(LinearTetStrain(tets, stiffness=mu))
    else:
        sys_.add_force(HyperElasticTet(tets, mu, lam, max_iters=5,
                                       model=model))
    if floor_y is not None:
        sys_.add_force(Collision([Floor(center=(0, floor_y, 0))],
                                 n_nodes=len(verts)))
    sys_.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys_.initialize()
    return sys_


def _lat_compare(model, floor_y=None, scramble=False, atol=2e-5,
                 mu=1e4, lam=1e4):
    beam = make_beam_tets(3, 2, 2, size=0.25)
    verts, tets = beam.vertices, beam.tets
    if scramble:
        rng = np.random.default_rng(1)
        perm = rng.permutation(beam.n_vertices)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        verts, tets = verts[perm], inv[tets]
    n = len(verts)
    masses = np.full(n, 1.0 / n)
    anchors = np.flatnonzero(verts[:, 0] < 1e-9) if floor_y is None else None
    args = (verts, tets, masses, 0.04, 6, 25)
    kw = dict(model=model, mu=mu, lam=lam, floor_y=floor_y, anchors=anchors)
    if floor_y is not None:
        # floor-only scene still needs an anchor for lattice qualification
        kw["anchors"] = np.flatnonzero(verts[:, 0] < 1e-9)
    gen = _lat_system(*args, fast=False, **kw)
    fast = _lat_system(*args, fast=True, **kw)
    assert fast._lattice is not None, "lattice fast path did not engage"
    for _ in range(4):
        gen.step()
        fast.step()
    assert np.isfinite(fast.x).all()
    np.testing.assert_allclose(fast.x, gen.x, atol=atol)


def test_lattice_fast_path_via_system_nh():
    _lat_compare("nh")


def test_lattice_fast_path_via_system_nh_lam4mu():
    """lam = 4*mu (ordinary Poisson ratio): the parameter regime where
    the round-1 NH prox Hessian bug hid (mu==lam masked the missing
    +lam*inv^2 diagonal term)."""
    _lat_compare("nh", mu=2.5e3, lam=1e4)


def test_lattice_fast_path_via_system_stvk():
    _lat_compare("stvk", mu=100.0, lam=400.0)


def test_lattice_fast_path_via_system_arap():
    _lat_compare("arap", mu=1e4)


def test_lattice_fast_path_floor_collision():
    """In-kernel CollisionForce floor (plinko-like) matches the general
    path's Collision model, and the body rests above the floor."""
    _lat_compare("nh", floor_y=-0.3)


def test_lattice_fast_path_scrambled_numbering():
    """A randomly renumbered lattice engages the fast path via
    detect_lattice's canonical permutation and matches the general path
    in the CALLER's numbering."""
    _lat_compare("nh", scramble=True)
