"""Arbitrary-topology (uell) banded fast path.

The per-row-offset ELL format (core/uell.py) removes the last structure
requirement from the banded whole-timestep layout: ANY tet mesh — here a
Delaunay tetrahedralization whose A_hat has thousands of distinct
diagonals, so neither grid renumbering nor the dia form can apply — runs
the whole ADMM step as one XLA program and matches the general ELL-mode
System trajectory.

Reference parity target: the topology-agnostic global step of
/root/reference/deps/admm-elastic-sca/src/system/System.cpp:140 (LDLT has
no structure requirement; neither does this path).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest

import jax.numpy as jnp


def _delaunay_mesh(nx=7, ny=5, nz=4, jitter=0.3, seed=0, scale=0.1):
    """Quality unstructured tet mesh: Delaunay over jittered grid points,
    sliver tets dropped, orientation fixed."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    gx, gy, gz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    pts += rng.uniform(-jitter, jitter, pts.shape)
    pts *= scale
    tets = Delaunay(pts).simplices
    pp = pts[tets]
    emax = np.linalg.norm(
        pp[:, :, None, :] - pp[:, None, :, :], axis=-1
    ).max(axis=(1, 2))
    tets = tets[emax < 2.2 * scale]
    v6 = np.linalg.det(pts[tets][:, 1:] - pts[tets][:, :1])
    tets[v6 < 0] = tets[v6 < 0][:, [0, 2, 1, 3]]
    return pts, tets


def _adjacency(pts, tets):
    from scipy.sparse import coo_matrix

    n = len(pts)
    ii = np.repeat(tets, 4, axis=1).ravel()
    jj = np.tile(tets, (1, 4)).ravel()
    rng = np.random.default_rng(1)
    vv = rng.uniform(0.5, 2.0, len(ii))
    A = coo_matrix((vv, (ii, jj)), shape=(n, n)).tocsr()
    return ((A + A.T) * 0.5).tocoo()


def test_pack_uell_matvec_exact():
    """Packed slots+folds reproduce A@x to round-off, and the mesh truly
    has no dia structure."""
    from admm_elastic_tpu.core.uell import (
        dilute_positions,
        pack_uell,
        slab_order,
        uell_matvec_np,
    )

    pts, tets = _delaunay_mesh()
    A = _adjacency(pts, tets)
    A.sum_duplicates()
    assert len(np.unique(A.col - A.row)) > 48, "mesh accidentally banded"

    order = slab_order(pts)
    pos, n_pos = dilute_positions(order, 8)
    packed = pack_uell(A.row, A.col, A.data, pos, n_pos)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(packed["n_pad"])
    y = uell_matvec_np(packed, x)
    ref = A.tocsr() @ x[pos]
    err = np.abs(y[pos] - ref).max() / np.abs(ref).max()
    assert err < 1e-13, err


def test_pack_uell_hub_splitting():
    """An aggressive cap forces hub splits; folds restore exactness."""
    from admm_elastic_tpu.core.uell import (
        dilute_positions,
        pack_uell,
        slab_order,
        uell_matvec_np,
    )

    pts, tets = _delaunay_mesh(seed=3)
    A = _adjacency(pts, tets)
    A.sum_duplicates()
    order = slab_order(pts)
    pos, n_pos = dilute_positions(order, 4)
    packed = pack_uell(A.row, A.col, A.data, pos, n_pos,
                       cap_quantile=0.5)
    assert packed["n_fold_ops"] > 0, "expected fold layers"
    rng = np.random.default_rng(2)
    x = rng.standard_normal(packed["n_pad"])
    y = uell_matvec_np(packed, x)
    ref = A.tocsr() @ x[pos]
    err = np.abs(y[pos] - ref).max() / np.abs(ref).max()
    assert err < 1e-13, err


def test_pack_uell_auto_picks_cheapest():
    """The auto-tuner returns an exact packing no more expensive than the
    old fixed (512, 0.99) choice."""
    from admm_elastic_tpu.core.uell import (
        dilute_positions,
        pack_uell,
        pack_uell_auto,
        slab_order,
        uell_matvec_np,
    )

    pts, tets = _delaunay_mesh()
    A = _adjacency(pts, tets)
    A.sum_duplicates()
    packed, pos = pack_uell_auto(A.row, A.col, A.data, pts)
    fixed_pos, n_pos = dilute_positions(slab_order(pts), 8)
    fixed = pack_uell(A.row, A.col, A.data, fixed_pos, n_pos)
    cost = packed["n_slots"] + packed["n_fold_ops"]
    assert cost <= fixed["n_slots"] + fixed["n_fold_ops"]

    rng = np.random.default_rng(2)
    x = rng.standard_normal(packed["n_pad"])
    y = uell_matvec_np(packed, x)
    ref = A.tocsr() @ x[pos]
    err = np.abs(y[pos] - ref).max() / np.abs(ref).max()
    assert err < 1e-13, err


def _build_system(pts, tets, fast, floor_y=None, anchors=True,
                  model="nh", per_elem=False):
    import admm_elastic_tpu as aet
    from admm_elastic_tpu.models import (
        Collision,
        ExplicitForce,
        Floor,
        HyperElasticTet,
        StaticAnchor,
    )

    n = len(pts)
    s = aet.System(aet.Settings(
        timestep_s=0.04, admm_iters=10, dtype=jnp.float64,
        global_solver="ell", cg_fixed_iters=25,
        lattice_fast_path=fast, verbose=0,
    ))
    s.add_nodes(pts, np.full(n, 2.0 / n))
    if per_elem:
        rng = np.random.default_rng(7)
        mu = rng.uniform(5e3, 2e4, len(tets))
        lam = rng.uniform(5e3, 2e4, len(tets))
    else:
        mu = lam = 1e4
    s.add_force(HyperElasticTet(tets, mu=mu, lam=lam, max_iters=5,
                                model=model))
    if anchors:
        s.add_force(StaticAnchor(
            np.flatnonzero(pts[:, 0] < pts[:, 0].min() + 1e-3)
        ))
    if floor_y is not None:
        s.add_force(Collision([Floor(center=(0, floor_y, 0))],
                              n_nodes=n))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def _engaged_uell(s):
    from admm_elastic_tpu.parallel.banded_spmd import ShardedBandedStepper

    assert s._lattice is not None, "banded layout did not engage"
    assert isinstance(s._lattice, ShardedBandedStepper), type(s._lattice)
    assert s._lattice.base._uell is not None, "expected uell matvec mode"


@pytest.mark.parametrize("model", ["nh", "stvk"])
def test_uell_trajectory_matches_general(model):
    """Unstructured Delaunay mesh: banded layout (uell matvec)
    vs the general ELL path, 5 steps, f64."""
    pts, tets = _delaunay_mesh()
    gen = _build_system(pts, tets, fast=False, model=model)
    fast = _build_system(pts, tets, fast=True, model=model)
    _engaged_uell(fast)
    for _ in range(5):
        gen.step()
        fast.step()
    assert np.isfinite(fast.x).all()
    np.testing.assert_allclose(fast.x, gen.x, atol=5e-8)


def test_uell_floor_and_per_element_materials():
    """Floor collision + per-element mu/lam through the uell layout."""
    pts, tets = _delaunay_mesh(seed=5)
    pts[:, 1] += 0.1
    floor_y = float(pts[:, 1].min()) + 0.02
    gen = _build_system(pts, tets, fast=False, floor_y=floor_y,
                        anchors=False, per_elem=True)
    fast = _build_system(pts, tets, fast=True, floor_y=floor_y,
                         anchors=False, per_elem=True)
    _engaged_uell(fast)
    for _ in range(5):
        gen.step()
        fast.step()
    assert np.isfinite(fast.x).all()
    np.testing.assert_allclose(fast.x, gen.x, atol=5e-8)


def test_uell_packed_f32_close_to_f64():
    """f32 production representation (f32 values, 4 lane indices packed
    LOSSLESSLY per int32 word) stays within f32 round-off accumulation of
    the f64 general path. A lane-unpacking bug would produce garbage, not
    a small drift, so the tolerance binds."""
    import admm_elastic_tpu as aet  # noqa: F401

    pts, tets = _delaunay_mesh(seed=11, nx=5, ny=4, nz=3)
    ref = _build_system(pts, tets, fast=False)
    fast32 = _build_system32(pts, tets)
    _engaged_uell(fast32)
    assert fast32._lattice.base._uell_packed, "f32 build must pack planes"
    for _ in range(3):
        ref.step()
        fast32.step()
    assert np.isfinite(fast32.x).all()
    scale = np.abs(ref.x).max()
    assert np.abs(fast32.x - ref.x).max() < 2e-3 * scale


def _build_system32(pts, tets):
    import admm_elastic_tpu as aet
    from admm_elastic_tpu.models import ExplicitForce, HyperElasticTet, StaticAnchor

    n = len(pts)
    s = aet.System(aet.Settings(
        timestep_s=0.04, admm_iters=10, dtype=jnp.float32,
        global_solver="ell", cg_fixed_iters=25,
        lattice_fast_path=True, verbose=0,
    ))
    s.add_nodes(pts, np.full(n, 2.0 / n))
    s.add_force(HyperElasticTet(tets, mu=1e4, lam=1e4, max_iters=5,
                                model="nh"))
    s.add_force(StaticAnchor(
        np.flatnonzero(pts[:, 0] < pts[:, 0].min() + 1e-3)
    ))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def test_uell_run_rollout_matches_steps():
    """run(n) (windowed rollout) == n x step() for the uell layout."""
    pts, tets = _delaunay_mesh(seed=9, nx=5, ny=4, nz=3)
    a = _build_system(pts, tets, fast=True)
    b = _build_system(pts, tets, fast=True)
    _engaged_uell(a)
    for _ in range(12):
        a.step()
    b.run(12)
    np.testing.assert_allclose(a.x, b.x, rtol=0, atol=1e-12)
