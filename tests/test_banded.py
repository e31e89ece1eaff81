"""Banded whole-timestep layout (core/banded.py, stepped by the XLA program
of parallel/banded_spmd.ShardedBandedStepper on a one-device mesh) parity
vs the general System dia path.

The test meshes are JITTERED beam lattices: vertex positions are randomly
perturbed so detect_grid_numbering rejects them (no constant-offset
stencils exist) while the vertex numbering stays banded — i.e. genuinely
unstructured geometry exercising the windowed gather / permutation
scatter.

The layout's local step is the plane arithmetic of ops/lanes.py, which is
also the body of the Pallas NH/StVK kernel. The general-path references
run that kernel in interpret mode (the `nh_kernel` fixture) so both sides
share one prox implementation and agree to round-off."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.core.banded import SUB, place_elements
from admm_elastic_tpu.geometry import make_beam_tets
from admm_elastic_tpu.models import (
    Collision,
    ExplicitForce,
    Floor,
    HyperElasticTet,
    LinearTetStrain,
    StaticAnchor,
)
from admm_elastic_tpu.parallel.banded_spmd import ShardedBandedStepper

F64 = jnp.float64


def jittered_beam(nx=4, ny=3, nz=3, seed=0, jitter=0.08):
    mesh = make_beam_tets(nx, ny, nz, size=0.25)
    rng = np.random.RandomState(seed)
    mesh.vertices = mesh.vertices + jitter * 0.25 * rng.randn(
        *mesh.vertices.shape
    )
    return mesh


def build_system(mesh, *, fast, model="nh", mu=1e4, lam=2.5e4,
                 floor_y=None, anchor_w=1000.0, seed=None, admm=6):
    n = mesh.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=admm, verbose=0,
                        dtype=F64, lattice_fast_path=fast,
                        global_solver="dia", dense_max_nodes=0))
    verts = mesh.vertices.copy()
    if floor_y is not None:
        verts = verts + np.array([0.0, 0.6, 0.0])
    s.add_nodes(verts, np.full(n, 2.0 / n))
    if seed is not None:  # per-element materials
        rng = np.random.RandomState(seed)
        mu = mu * (0.5 + rng.rand(len(mesh.tets)))
        lam = lam * (0.5 + rng.rand(len(mesh.tets)))
    if model == "arap":
        s.add_force(LinearTetStrain(mesh.tets, mu))
    else:
        s.add_force(HyperElasticTet(mesh.tets, mu=mu, lam=lam,
                                    max_iters=4, model=model))
    s.add_force(StaticAnchor([0, 1], weight=anchor_w))
    if floor_y is not None:
        s.add_force(Collision([Floor(center=(0.0, floor_y, 0.0))],
                              n_nodes=n))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def _assert_banded(s):
    assert s._lattice is not None, "banded layout did not engage"
    assert isinstance(s._lattice, ShardedBandedStepper), type(s._lattice)
    assert s._lattice.D == 1


def test_banded_single_iteration_exact(nh_kernel):
    """One ADMM iteration is BIT-LEVEL equal to the general dia path
    (same prox code, same CG): positions, tet duals, warm starts and
    anchor duals all match to f64 round-off. Multi-iteration trajectories
    can only be compared loosely (below): the Newton backtracking ladder
    has discrete branches, so ~1e-16 accumulation-order noise in F can
    flip a step choice and grow to ~1e-10 within an iteration — the same
    reason tests/test_lattice.py compares cross-implementation
    trajectories at loose tolerance."""
    mesh = jittered_beam()
    fast = build_system(mesh, fast=True, admm=1)
    _assert_banded(fast)
    fast.step()
    with nh_kernel():
        ref = build_system(mesh, fast=False, admm=1)
        ref.step()
    np.testing.assert_allclose(fast.x, ref.x, rtol=0, atol=1e-13)
    np.testing.assert_allclose(fast.v, ref.v, rtol=0, atol=1e-12)
    # duals: map the chunk planes back to element order
    st = fast._lattice.detach()
    idx = np.asarray(mesh.tets, np.int64)
    subs, _perm = place_elements(idx)
    d = np.asarray(st.state["d"])
    nc = d.shape[0]
    subs = np.pad(subs, ((0, nc * SUB - len(subs)), (0, 0)),
                  constant_values=-1)
    E = len(idx)
    u_b = np.zeros((E, 9))
    w_b = np.zeros((E, 3))
    for c in range(nc):
        blk = subs[c * SUB : (c + 1) * SUB]
        m = blk >= 0
        for p in range(9):
            u_b[blk[m], p] = d[c, p * SUB : (p + 1) * SUB][m]
        for p in range(3):
            w_b[blk[m], p] = d[c, (9 + p) * SUB : (10 + p) * SUB][m]
    tk = [k for k in ref.state["u"] if "Hyper" in k][0]
    # canonical u[e, b, a] = F[a][b]; the layout stores plane 3a + b
    ua = np.swapaxes(np.asarray(ref.state["u"][tk]), 1, 2).reshape(E, 9)
    sig = np.asarray(ref.state["forces"][tk]["sigma"])
    np.testing.assert_allclose(u_b, ua, rtol=0, atol=1e-14)
    np.testing.assert_allclose(w_b, sig, rtol=0, atol=1e-14)


def _general(nh_kernel, mesh, steps, **kw):
    """The general dia path with the shared prox implementation."""
    with nh_kernel():
        ref = build_system(mesh, fast=False, **kw)
        for _ in range(steps):
            ref.step()
    return ref


def _layout(mesh, steps, **kw):
    fast = build_system(mesh, fast=True, **kw)
    _assert_banded(fast)
    for _ in range(steps):
        fast.step()
    return fast


@pytest.mark.parametrize("model", ["nh", "stvk", "arap"])
def test_banded_matches_general(model, nh_kernel):
    mesh = jittered_beam()
    ref = _general(nh_kernel, mesh, 5, model=model)
    fast = _layout(mesh, 5, model=model)
    np.testing.assert_allclose(fast.x, ref.x, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(fast.v, ref.v, rtol=1e-5, atol=1e-7)


def test_banded_per_element_materials(nh_kernel):
    """Per-element mu/lam."""
    mesh = jittered_beam(seed=3)
    ref = _general(nh_kernel, mesh, 5, seed=7)
    fast = _layout(mesh, 5, seed=7)
    np.testing.assert_allclose(fast.x, ref.x, rtol=1e-6, atol=1e-8)


def test_banded_floor_collision(nh_kernel):
    mesh = jittered_beam(seed=5)
    # enough steps to hit the floor
    ref = _general(nh_kernel, mesh, 8, floor_y=0.0, anchor_w=0.0)
    fast = _layout(mesh, 8, floor_y=0.0, anchor_w=0.0)
    assert fast.x[:, 1].min() > -0.25  # the floor actually acts
    np.testing.assert_allclose(fast.x, ref.x, rtol=1e-6, atol=1e-8)


def test_banded_sphere_cylinder_collision(nh_kernel):
    """plinko-class analytic shapes in the layout: a mixed Floor + Sphere +
    Cylinder CollisionForce, declaration-order projection, matches the
    general path (reference loop CollisionForce.cpp:53-70)."""
    from admm_elastic_tpu.models import Cylinder, Sphere

    mesh = jittered_beam(seed=11)
    lo = mesh.vertices.min(0)
    hi = mesh.vertices.max(0)
    mid = 0.5 * (lo + hi)
    shapes = [
        Floor(center=(0.0, float(lo[1]) - 0.45, 0.0)),
        Sphere(center=(float(mid[0]), float(lo[1]) - 0.25, float(mid[2])),
               radius=0.2),
        Cylinder(center=(float(lo[0]) + 0.1, float(lo[1]) - 0.2, 0.0),
                 radius=0.15),
    ]

    def build(fast):
        n = mesh.n_vertices
        s = System(Settings(timestep_s=0.04, admm_iters=6, verbose=0,
                            dtype=F64, lattice_fast_path=fast,
                            global_solver="dia", dense_max_nodes=0))
        s.add_nodes(mesh.vertices, np.full(n, 2.0 / n))
        s.add_force(HyperElasticTet(mesh.tets, mu=1e4, lam=2.5e4,
                                    max_iters=4, model="nh"))
        s.add_force(Collision(list(shapes), n_nodes=n))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    fast = build(True)
    _assert_banded(fast)
    with nh_kernel():
        ref = build(False)
        for _ in range(10):  # free fall onto the shapes
            ref.step()
            fast.step()
    assert fast.x[:, 1].min() > lo[1] - 0.8, "shapes must stop the fall"
    np.testing.assert_allclose(fast.x, ref.x, rtol=1e-6, atol=1e-8)


def test_banded_rollout_windows_match_steps():
    mesh = jittered_beam(seed=9)
    a = build_system(mesh, fast=True)
    b = build_system(mesh, fast=True)
    _assert_banded(a)
    for _ in range(4):
        a.step()
    b.run(4)
    np.testing.assert_allclose(np.asarray(b.x), np.asarray(a.x),
                               rtol=1e-12, atol=1e-14)


def test_banded_set_positions_roundtrip(nh_kernel):
    """x/v setters route through the 2D plane layout (bunnyexpand-style
    scramble support)."""
    mesh = jittered_beam(seed=11)
    s = build_system(mesh, fast=True)
    _assert_banded(s)
    rng = np.random.RandomState(0)
    newx = mesh.vertices + 0.01 * rng.randn(*mesh.vertices.shape)
    s.x = newx
    np.testing.assert_allclose(s.x, newx, rtol=0, atol=1e-12)
    s.step()
    with nh_kernel():
        ref = build_system(mesh, fast=False)
        ref.x = newx
        ref.step()
    np.testing.assert_allclose(s.x, ref.x, rtol=1e-6, atol=1e-8)


@pytest.mark.slow
def test_banded_in_kernel_primal_residuals(nh_kernel):
    """collect_residuals='primal' keeps the banded layout engaged and
    emits the per-iteration primal residual ||W(Dx-z)||; it
    matches the general path's instrumented values (tets + anchors +
    floor all contribute)."""
    mesh = jittered_beam(seed=17)

    def build(fast, collect):
        n = mesh.n_vertices
        s = System(Settings(timestep_s=0.04, admm_iters=6, verbose=0,
                            dtype=F64, lattice_fast_path=fast,
                            global_solver="dia", dense_max_nodes=0,
                            collect_residuals=collect))
        s.add_nodes(mesh.vertices + np.array([0.0, 0.3, 0.0]),
                    np.full(n, 2.0 / n))
        s.add_force(HyperElasticTet(mesh.tets, mu=1e4, lam=2.5e4,
                                    max_iters=4))
        s.add_force(StaticAnchor([0, 1], weight=500.0))
        s.add_force(Collision([Floor(center=(0.0, 0.0, 0.0))],
                              n_nodes=n))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    fast = build(True, "primal")
    _assert_banded(fast)
    with nh_kernel():
        ref = build(False, True)
    for k in range(6):
        with nh_kernel():
            ref.step()
        fast.step()
        rp_ref = np.asarray(ref.last_aux["primal_residual"])
        rp_fast = np.asarray(fast.last_aux["primal_residual"])
        assert rp_fast.shape == rp_ref.shape
        np.testing.assert_allclose(rp_fast, rp_ref, rtol=1e-5, atol=1e-9)
        assert rp_ref[-1] < rp_ref[0]  # ADMM converges within the step

    # run(): stacked (n_steps, iters) residuals, as the general rollout
    fast2 = build(True, "primal")
    fast2.run(4)
    rp = np.asarray(fast2.last_aux["primal_residual"])
    assert rp.shape == (4, 6) and np.isfinite(rp).all()

    # 'primal' on a non-qualifying scene falls back to the general path
    # and still collects (dual stays zeros)
    gen = build(False, "primal")
    gen.step()
    assert np.asarray(gen.last_aux["primal_residual"]).shape == (6,)


def test_place_elements_distinct_lanes():
    from admm_elastic_tpu.core.banded import MAX_OPEN

    mesh = make_beam_tets(6, 5, 4, size=0.2)
    idx0 = np.asarray(mesh.tets, np.int64)
    subs, perm = place_elements(idx0)
    idx = np.take_along_axis(idx0, perm.astype(np.int64), axis=1)
    # the relabeling is a true per-element permutation
    assert (np.sort(perm, axis=1) == np.arange(4)).all()
    seen = np.zeros(len(idx), bool)
    for row in subs:
        real = row[row >= 0]
        assert not seen[real].any()
        seen[real] = True
        for k in range(4):
            lanes = idx[real, k] % 128
            assert len(np.unique(lanes)) == len(lanes), "lane collision"
    assert seen.all()
    # packing tightness vs the lane-class load lower bound: a lane class
    # (vertex % 128) referenced L times needs >= ceil(L/4) sub-blocks
    # (4 corner slots each). The greedy must land within 15% of that
    # bound (E/128 alone is unreachable when lane loads are imbalanced,
    # as they are for any real mesh).
    big = make_beam_tets(14, 10, 8, size=0.2)
    bidx = np.asarray(big.tets, np.int64)
    bsubs, _ = place_elements(bidx)
    loads = np.bincount((bidx % 128).ravel(), minlength=128)
    lb = max(-(-int(loads.max()) // 4), -(-len(bidx) // 128))
    assert len(bsubs) <= 1.15 * lb
    # bounded displacement from sorted order (window growth bound)
    order = np.argsort(idx.min(axis=1), kind="stable")
    rank = np.empty(len(idx), np.int64)
    rank[order] = np.arange(len(idx))
    flat = subs.ravel()
    flat = flat[flat >= 0]
    for pos, e in enumerate(flat):
        assert rank[e] <= pos + MAX_OPEN * 128


def test_banded_dual_residuals_take_general_path():
    """collect_residuals=True (primal AND dual, System.cpp:64-65) is not
    covered by the banded layout: the route falls back to the general
    path, which collects both."""
    mesh = jittered_beam(seed=23)
    n = mesh.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=4, verbose=0,
                        dtype=F64, lattice_fast_path=True,
                        global_solver="dia", dense_max_nodes=0,
                        collect_residuals=True))
    s.add_nodes(mesh.vertices, np.full(n, 2.0 / n))
    s.add_force(HyperElasticTet(mesh.tets, mu=1e4, lam=2.5e4, max_iters=4))
    s.add_force(StaticAnchor([0, 1], weight=500.0))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    assert s._lattice is None
    s.step()
    for key in ("primal_residual", "dual_residual"):
        r = np.asarray(s.last_aux[key])
        assert r.shape == (4,) and np.isfinite(r).all() and (r > 0).all()
