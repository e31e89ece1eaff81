"""Scenario sweeps: N stiffness variants of one topology stepped as one
vmapped program (parallel/scenarios.vmap_step), vs per-scenario reference
runs through the general System path.

Matches the semantics of parallel/scenarios.batch_params sweeps (the
BASELINE '64 parallel armadillo drops' workload): sweeping 'weight'
changes both the local prox mix and the global matrix, which batch_params
re-assembles per scenario."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.geometry import make_beam_tets
from admm_elastic_tpu.models import (
    ExplicitForce,
    HyperElasticTet,
    LinearTetStrain,
    StaticAnchor,
)
from admm_elastic_tpu.parallel.scenarios import (
    batch_params,
    batch_state,
    vmap_step,
)

F64 = jnp.float64


def jittered_beam(nx=4, ny=3, nz=3, seed=0, jitter=0.08):
    mesh = make_beam_tets(nx, ny, nz, size=0.25)
    rng = np.random.RandomState(seed)
    mesh.vertices = mesh.vertices + jitter * 0.25 * rng.randn(
        *mesh.vertices.shape
    )
    return mesh


def build_system(mesh, *, solver, mu, lam, model="nh", fast=False,
                 anchor_w=1000.0, admm=6, collect=False):
    n = mesh.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=admm, verbose=0,
                        dtype=F64, lattice_fast_path=fast,
                        global_solver=solver, dense_max_nodes=0,
                        cg_fixed_iters=20, collect_residuals=collect))
    s.add_nodes(mesh.vertices, np.full(n, 2.0 / n))
    if model == "arap":
        s.add_force(LinearTetStrain(mesh.tets, mu))
    else:
        s.add_force(HyperElasticTet(mesh.tets, mu=mu, lam=lam,
                                    max_iters=4, model=model))
    s.add_force(StaticAnchor([0, 1], weight=anchor_w))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def stiffness_sweep(base_sys, mus, model="nh"):
    """Sweep dict scaling mu/lam/k/weight like bench.py's sweep64: the
    same transformation HyperElasticTet would apply if built with
    per-scenario mu (k = min(mu, lam), w = sqrt(k * vol))."""
    tf = base_sys._force_list[0]
    p = base_sys.params[tf.name]
    E = tf.n_elements
    if model == "arap":
        k0 = np.broadcast_to(np.asarray(p["k"], np.float64), (E,))
        w0 = np.broadcast_to(np.asarray(p["weight"], np.float64), (E,))
        scale = mus[:, None] / mus[0]
        return {
            (tf.name, "k"): k0[None] * scale,
            (tf.name, "weight"): w0[None] * np.sqrt(scale),
        }
    vols = (np.asarray(p["weight"], np.float64) ** 2
            / np.asarray(p["k"], np.float64))
    return {
        (tf.name, "mu"): np.repeat(mus[:, None], E, axis=1),
        (tf.name, "lam"): np.repeat(2.5 * mus[:, None], E, axis=1),
        (tf.name, "k"): np.repeat(mus[:, None], E, axis=1),
        (tf.name, "weight"): np.sqrt(mus[:, None] * vols[None]),
    }


def run_sweep(base, sweep, n_scenarios, steps, x0=None, mesh=None):
    """Step the sweep `steps` times through vmap_step. Returns the
    (S, n, 3) positions and the last step's aux."""
    jitter = (lambda x, i: x0[i]) if x0 is not None else None
    state = batch_state(base.state, n_scenarios, jitter=jitter, mesh=mesh)
    params = batch_params(base.params, sweep, n_scenarios, system=base)
    step = vmap_step(base)
    aux = None
    for _ in range(steps):
        state, aux = step(state, params)
    return np.asarray(state["x"]), aux


@pytest.mark.parametrize("solver", ["dia", "ell"])
def test_sweep_matches_per_scenario_general(solver):
    """3 stiffness scenarios through one vmapped step == 3 separate
    general-path System runs ('dia' batches the sparse-diagonal values;
    'ell' the padded-ELL values)."""
    mesh = jittered_beam()
    mus = np.array([4e3, 1e4, 3e4])
    base = build_system(mesh, solver=solver, mu=1e4, lam=2.5e4)
    assert base._solver_mode == solver
    sweep = stiffness_sweep(base, mus)
    xs, _ = run_sweep(base, sweep, len(mus), 4)

    for i, mu in enumerate(mus):
        ref = build_system(mesh, solver=solver, mu=mu, lam=2.5 * mu)
        for _ in range(4):
            ref.step()
        np.testing.assert_allclose(xs[i], ref.x, rtol=1e-6, atol=1e-8)

    # scenarios genuinely differ (the sweep actually acts)
    assert np.abs(xs[0] - xs[-1]).max() > 1e-4


def test_sweep_matches_per_scenario_banded(nh_kernel):
    """Each scenario of the sweep matches a single-scenario System on the
    banded layout (D=1). The sweep runs the general path with the Pallas
    NH kernel in interpret mode — the layout's own prox arithmetic; the
    global-matrix VALUES are assembled differently (batched bincount vs
    the System's CSR sum), a 1-ulp summation-order difference that the
    Newton backtracking ladder's discrete branches can amplify to ~1e-9
    over steps (same caveat as test_banded_single_iteration_exact)."""
    mesh = jittered_beam(seed=3)
    mus = np.array([5e3, 2e4])
    with nh_kernel():
        base = build_system(mesh, solver="dia", mu=1e4, lam=2.5e4)
        sweep = stiffness_sweep(base, mus)
        xs, _ = run_sweep(base, sweep, len(mus), 3)

    for i, mu in enumerate(mus):
        single = build_system(mesh, solver="dia", mu=mu, lam=2.5 * mu,
                              fast=True)
        assert single._lattice is not None
        single.run(3)
        np.testing.assert_allclose(xs[i], single.x, rtol=1e-6, atol=1e-8)


def test_sweep_arap_and_anchor_weights():
    """ARAP material sweep + anchor-weight sweep (poordillo-release-like:
    one scenario's anchors at weight ~0)."""
    mesh = jittered_beam(seed=5)
    mus = np.array([1e4, 1e4, 1e4])
    base = build_system(mesh, solver="dia", mu=2e4, lam=None, model="arap")
    sweep = stiffness_sweep(base, mus, model="arap")
    aname = base._force_list[1].name
    anchor_ws = np.array([1000.0, 10.0, 1e-6])
    sweep[(aname, "weight")] = anchor_ws
    xs, _ = run_sweep(base, sweep, len(mus), 4)

    for i, aw in enumerate(anchor_ws):
        ref = build_system(mesh, solver="dia", mu=2e4, lam=None,
                           model="arap", anchor_w=float(aw))
        for _ in range(4):
            ref.step()
        np.testing.assert_allclose(xs[i], ref.x, rtol=1e-6, atol=1e-8)

    # released scenario actually falls
    assert xs[2][:, 1].mean() < xs[0][:, 1].mean() - 1e-3


def test_sweep_scenario_sharded_matches_unsharded():
    """Scenario state shards over a 'data' mesh axis: 4 scenarios on 2
    virtual devices reproduce the unsharded sweep (each device runs the
    identical per-scenario program on its slice)."""
    import jax
    from jax.sharding import Mesh

    mesh = jittered_beam(seed=13, nx=3, ny=3, nz=2)
    mus = np.array([4e3, 8e3, 1.5e4, 3e4])
    base = build_system(mesh, solver="dia", mu=1e4, lam=2.5e4)
    sweep = stiffness_sweep(base, mus)
    ref_x, _ = run_sweep(base, sweep, 4, 2)

    base2 = build_system(mesh, solver="dia", mu=1e4, lam=2.5e4)
    dmesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    sh_x, _ = run_sweep(base2, sweep, 4, 2, mesh=dmesh)
    np.testing.assert_allclose(sh_x, ref_x, rtol=0, atol=1e-12)


def test_sweep_per_scenario_initial_state():
    """Per-scenario x0 (jittered drops) thread through batch_state."""
    mesh = jittered_beam(seed=7)
    mus = np.array([1e4, 1e4])
    base = build_system(mesh, solver="dia", mu=1e4, lam=2.5e4)
    sweep = stiffness_sweep(base, mus)
    rng = np.random.RandomState(0)
    x0 = np.stack([
        mesh.vertices,
        mesh.vertices + 0.02 * rng.randn(*mesh.vertices.shape),
    ])
    xs, _ = run_sweep(base, sweep, 2, 3, x0=x0)

    for i in range(2):
        ref = build_system(mesh, solver="dia", mu=1e4, lam=2.5e4)
        ref.x = x0[i]
        for _ in range(3):
            ref.step()
        np.testing.assert_allclose(xs[i], ref.x, rtol=1e-6, atol=1e-8)


def test_sweep_in_kernel_residuals():
    """Sweeps emit per-scenario residuals: each scenario's (iters,)
    primal/dual residual arrays from the vmapped step match the general
    path instrumented per scenario — sweeps can watch every scenario's
    ADMM convergence."""
    mesh = jittered_beam(seed=5)
    mus = np.array([5e3, 2e4])
    base = build_system(mesh, solver="dia", mu=1e4, lam=2.5e4, collect=True)
    sweep = stiffness_sweep(base, mus)
    _, aux = run_sweep(base, sweep, len(mus), 3)
    rp = np.asarray(aux["primal_residual"])
    rd = np.asarray(aux["dual_residual"])
    assert rp.shape == (2, base.settings.admm_iters)
    assert rd.shape == rp.shape

    for i, mu in enumerate(mus):
        ref = build_system(mesh, solver="dia", mu=mu, lam=2.5 * mu,
                           collect=True)
        for _ in range(3):
            ref.step()
        np.testing.assert_allclose(
            rp[i], np.asarray(ref.last_aux["primal_residual"]),
            rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(
            rd[i], np.asarray(ref.last_aux["dual_residual"]),
            rtol=1e-5, atol=1e-9)
