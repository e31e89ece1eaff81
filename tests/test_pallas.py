"""Local-step kernels and their XLA references.

The Pallas NH/StVK kernel (ops/pallas/nh_local.py, Triton route) runs
here in interpret mode in float64 against the XLA form of the same step
(HyperElasticTet.project); the `gpu` test compiles it for the card. The
ARAP and triangle-strain local steps are XLA only: they are checked
against NumPy SVD references, and the lane-parallel triangle body used by
the grid-cloth layout (ops/lanes.tri_body) against the model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_elastic_tpu.models.tet import HyperElasticTet, LinearTetStrain
from admm_elastic_tpu.ops.pallas import nh_local


def _deformations(E, seed, inverted=3, collapsed=0):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(E, 3, 3))
    F[: E // inverted] = F[: E // inverted] @ np.diag([1.0, 1.0, -1.0])
    if collapsed:
        F[E // inverted: E // inverted + collapsed] *= 1e-4
    return F


def _separated(F, gap=1e-2):
    svs = np.linalg.svd(F, compute_uv=False)
    return np.minimum(svs[:, 0] - svs[:, 1], svs[:, 1] - svs[:, 2]) > gap


def _kernel_vs_model(F, mu_v, lam_v, model, seed=0):
    """Unfused kernel (interpret) and the XLA project on the same inputs:
    returns (z_k, z_x, sigma_k, sigma_x, u_k, u_x) in F layout."""
    E = len(F)
    rng = np.random.default_rng(seed)
    Dx = jnp.asarray(np.swapaxes(F, 1, 2))
    u = jnp.asarray(rng.normal(size=(E, 3, 3)) * 0.05)
    sig = jnp.ones((E, 3))
    mu = jnp.full(E, mu_v)
    lam = jnp.full(E, lam_v)
    k = jnp.minimum(mu, lam)
    z_k, u_k, s_k = nh_local.nh_local_step(
        Dx, u, sig, mu, lam, k, iters=5, model=model, interpret=True)
    het = HyperElasticTet(np.zeros((E, 4), np.int32), mu_v, lam_v, 5, model)
    params = {"mu": mu, "lam": lam, "k": k, "weight": jnp.ones(E)}
    z_x, st = het.project(Dx, u, params, {"sigma": sig})
    return (np.asarray(z_k), np.asarray(z_x), np.asarray(s_k),
            np.asarray(st["sigma"]), np.asarray(u_k),
            np.asarray(u + Dx - z_x))


@pytest.mark.parametrize("model,mu,lam", [
    ("nh", 1e5, 1e5),     # the benchmark material
    ("nh", 1e4, 4e4),     # lam != mu: the +lam*inv^2 Hessian diagonal
    ("stvk", 100.0, 100.0),
])
def test_nh_kernel_matches_model(model, mu, lam):
    """Kernel vs XLA form in f64, E not a multiple of BLOCK: sigma* agrees
    everywhere; z agrees where the singular values are separated (a
    degenerate element's SVD basis is ambiguous — both answers valid).
    The two forms use different SVD algorithms (Jacobi sweeps vs the
    closed-form eigensolver) and stop Newton after 5 iterations, so a
    backtracking step can land differently at the 1e-9 level."""
    E = 2 * nh_local.BLOCK + 37
    F = _deformations(E, seed=7)
    z_k, z_x, s_k, s_x, u_k, u_x = _kernel_vs_model(F, mu, lam, model)
    sep = _separated(F)
    np.testing.assert_allclose(s_k, s_x, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(z_k[sep], z_x[sep], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(u_k[sep], u_x[sep], rtol=1e-6, atol=1e-7)
    assert np.all(s_k > 0)


def test_nh_kernel_degenerate_and_collapsed():
    """Zero and collapsed deformation gradients stay finite with a
    positive sigma* (warm-start guards, TetForce.cpp:339-347)."""
    E = nh_local.BLOCK
    F = _deformations(E, seed=1, collapsed=20)
    F[-10:] = 0.0
    z_k, _, s_k, s_x, u_k, _ = _kernel_vs_model(F, 1e5, 1e5, "nh")
    assert np.isfinite(z_k).all() and np.isfinite(u_k).all()
    assert np.all(s_k > 0)
    np.testing.assert_allclose(s_k, s_x, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("emit_z", [False, True])
def test_nh_kernel_fused_matches_unfused(emit_z):
    """The fused variant (selector apply + local step + RHS rows, one
    kernel) reproduces compute_Dx + the XLA local step + rhs_contribution
    on a real mesh; the element count is not a multiple of BLOCK.
    Tolerances as in test_nh_kernel_matches_model (two SVD algorithms)."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(5, 4, 3)  # 300 tets
    E = beam.n_tets
    assert E % nh_local.BLOCK
    f = HyperElasticTet(beam.tets, mu=1e4, lam=4e4, max_iters=5)
    params, state = f.build(beam.vertices, np.ones(beam.n_vertices), 0.04)
    params = {k: jnp.asarray(v) for k, v in params.items()}
    rng = np.random.default_rng(3)
    x = jnp.asarray(beam.vertices
                    + 0.02 * rng.normal(size=beam.vertices.shape))
    u = jnp.asarray(rng.normal(size=(E, 3, 3)) * 0.01)
    sig = jnp.asarray(state["sigma"])

    out = nh_local.nh_local_step_fused(
        x[params["indices"]], u, sig, params["coeff"], params["mu"],
        params["lam"], params["k"], params["weight"] ** 2, iters=5,
        model="nh", emit_z=emit_z, interpret=True)
    z_ref, u_ref, st = f.project_with_dual(
        f.compute_Dx(params, x), u, params, {"sigma": sig})
    np.testing.assert_allclose(out[0], z_ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out[1], u_ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out[2], st["sigma"], rtol=1e-7, atol=1e-9)
    rows = f.rhs_contribution6(params, z_ref, u_ref)
    scale = np.abs(rows).max()
    np.testing.assert_allclose(out[3].reshape(-1, 3), rows[:, :3],
                               rtol=1e-6, atol=1e-7 * scale)
    assert len(out) == (5 if emit_z else 4)
    if emit_z:
        np.testing.assert_allclose(out[4].reshape(-1, 3), rows[:, 3:],
                                   rtol=1e-6, atol=1e-7 * scale)


def test_nh_kernel_end_to_end_matches_xla(nh_kernel):
    """Full System stepping with the kernel (interpret mode) stays on the
    XLA trajectory in ell and dia modes (the fused local+RHS route) and in
    cg mode (the unfused project_with_dual route)."""
    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import ExplicitForce, StaticAnchor

    beam = make_beam_tets(3, 2, 2)

    def run(solver):
        sys = System(Settings(timestep_s=0.04, admm_iters=6, verbose=0,
                              dtype=jnp.float64, global_solver=solver,
                              cg_fixed_iters=20))
        n = beam.n_vertices
        sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        sys.add_force(HyperElasticTet(beam.tets, mu=1e4, lam=1e4,
                                      max_iters=5, model="nh"))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        for _ in range(4):
            sys.step()
        return sys.x

    for solver in ("ell", "dia", "cg"):
        a = run(solver)
        with nh_kernel():
            b = run(solver)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-9, err_msg=solver)


def test_kernel_selection_follows_platform():
    """The kernel is chosen from the platform, never by a flag: off a GPU
    the XLA form runs and no fused route is offered."""
    f = HyperElasticTet(np.zeros((1, 4), np.int32), 1.0, 1.0)
    on_gpu = jax.default_backend() == "gpu"
    assert f.uses_kernel() == on_gpu
    assert f.supports_fused_local_rhs == on_gpu


@pytest.mark.gpu
def test_nh_kernel_compiled_on_gpu(gpu):
    """The kernel as compiled for the card (no interpret mode) against the
    XLA form at full f32 precision, 10,000 elements."""
    E = 10_000
    F = _deformations(E, seed=2).astype(np.float32)
    Dx = jnp.asarray(np.swapaxes(F, 1, 2))
    u = jnp.zeros_like(Dx)
    sig = jnp.ones((E, 3), jnp.float32)
    mu = jnp.full(E, 1e5, jnp.float32)
    z_k, _, s_k = nh_local.nh_local_step(Dx, u, sig, mu, mu, mu, iters=5)
    het = HyperElasticTet(np.zeros((E, 4), np.int32), 1e5, 1e5, 5, "nh")
    params = {"mu": mu, "lam": mu, "k": mu, "weight": jnp.ones(E)}
    with jax.default_matmul_precision("highest"):
        z_x, st = jax.jit(het.project)(Dx, u, params, {"sigma": sig})
    sep = _separated(F.astype(np.float64))
    # f32 round-off through 6 Jacobi sweeps and 5 Newton steps
    np.testing.assert_allclose(np.asarray(s_k), np.asarray(st["sigma"]),
                               rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(z_k)[sep], np.asarray(z_x)[sep],
                               rtol=2e-3, atol=2e-3)


def _np_polar(F):
    U, _, Vt = np.linalg.svd(F)
    R = U @ Vt
    flip = np.linalg.det(R) < 0
    U[flip, :, 2] *= -1
    return U @ Vt


@pytest.mark.parametrize("inverted", [False, True])
def test_arap_xla_matches_numpy_polar(inverted):
    """LinearTetStrain's local step: z = (k R + w^2 F)/(w^2 + k) with R the
    closest proper rotation, against NumPy's SVD polar factor (inverted
    elements included)."""
    E = 512
    F = _deformations(E, seed=4, inverted=2 if inverted else E + 1)
    rng = np.random.default_rng(5)
    w2 = rng.uniform(0.5, 2.0, E)
    k = rng.uniform(0.5, 2.0, E)
    f = LinearTetStrain(np.zeros((E, 4), np.int32), 1.0)
    params = {"weight": jnp.asarray(np.sqrt(w2)), "k": jnp.asarray(k)}
    Dx = jnp.asarray(np.swapaxes(F, 1, 2))
    z, _ = f.project(Dx, jnp.zeros_like(Dx), params, {})
    zF = np.swapaxes(np.asarray(z), 1, 2)
    ref = ((k[:, None, None] * _np_polar(F) + w2[:, None, None] * F)
           / (w2 + k)[:, None, None])
    sep = _separated(F)
    np.testing.assert_allclose(zF[sep], ref[sep], rtol=1e-8, atol=1e-9)


def test_arap_xla_degenerate():
    f = LinearTetStrain(np.zeros((64, 4), np.int32), 1.0)
    Dx = jnp.zeros((64, 3, 3))
    params = {"weight": jnp.ones(64), "k": jnp.ones(64)}
    z, _ = f.project(Dx, Dx, params, {})
    assert np.isfinite(np.asarray(z)).all()


def _tri_inputs(E, seed):
    from admm_elastic_tpu.models.triangle import LimitedTriangleStrain

    rng = np.random.default_rng(seed)
    F = rng.normal(size=(E, 3, 2))
    F[: E // 8] *= 1e-5  # collapsed
    f = LimitedTriangleStrain(np.zeros((E, 3), np.int32), 100.0, 0.95, 1.05)
    params = {
        "weight": jnp.full(E, 2.0), "k": jnp.full(E, 3.0),
        "limit_min": jnp.full(E, 0.95), "limit_max": jnp.full(E, 1.05),
    }
    Dx = jnp.asarray(np.swapaxes(F, 1, 2))
    z, _ = f.project(Dx, jnp.zeros_like(Dx), params, {})
    return F, np.swapaxes(np.asarray(z), 1, 2)


def test_tri_xla_matches_numpy():
    """Triangle strain: in-plane rotation U V^T mixed with F, column norms
    clamped into [limit_min, limit_max] (TriangleForce.cpp:79-113)."""
    E = 512
    F, zF = _tri_inputs(E, seed=3)
    U, _, Vt = np.linalg.svd(F, full_matrices=False)
    ref = (3.0 * (U @ Vt) + 4.0 * F) / 7.0
    l = np.linalg.norm(ref, axis=1)
    safe = np.maximum(l, 1e-6)
    scale = np.where(l < 0.95, 0.95 / safe, np.where(l > 1.05, 1.05 / safe, 1))
    ref = ref * scale[:, None, :]
    svs = np.linalg.svd(F, compute_uv=False)
    sep = (svs[:, 0] - svs[:, 1]) > 1e-2
    np.testing.assert_allclose(zF[sep], ref[sep], rtol=1e-8, atol=1e-9)
    assert np.isfinite(zF).all()


def test_tri_lanes_body_matches_model():
    """ops/lanes.tri_body (the grid-cloth layout's projection on planes)
    reproduces LimitedTriangleStrain.project."""
    from admm_elastic_tpu.ops.lanes import tri_body

    E = 512
    F, zF = _tri_inputs(E, seed=6)
    planes = [jnp.asarray(F[:, a, b]) for a in range(3) for b in range(2)]
    z = tri_body(planes, 4.0, 3.0, 0.95, 1.05, True)
    zl = np.stack([np.asarray(p) for p in z], 1).reshape(E, 3, 2)
    svs = np.linalg.svd(F, compute_uv=False)
    sep = (svs[:, 0] - svs[:, 1]) > 1e-2
    np.testing.assert_allclose(zl[sep], zF[sep], rtol=1e-8, atol=1e-9)
