"""Full-precision matrix products and the XLA global solves.

On a GPU a float32 matrix product at default precision may run in TF32.
Every jitted device program pins its products to HIGHEST
(utils/precision.highest); these tests read the lowered programs. The
sparse-diagonal (dia) PCG solve, which replaced a fused kernel, is checked
against a direct sparse solve.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.geometry import make_beam_tets
from admm_elastic_tpu.models import ExplicitForce, HyperElasticTet, StaticAnchor


def _beam_system(solver, dtype=jnp.float32, **kw):
    beam = make_beam_tets(4, 3, 3, size=0.1)
    n = beam.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=3, verbose=0,
                        dtype=dtype, global_solver=solver,
                        dense_max_nodes=10_000, cg_fixed_iters=5, **kw))
    s.add_nodes(beam.vertices, np.full(n, 1.0 / n))
    s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    s.add_force(HyperElasticTet(beam.tets, 1e5, 1e5, max_iters=3))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def _dot_lines(text):
    return [ln for ln in text.splitlines() if "dot_general" in ln]


def _assert_all_highest(text):
    dots = _dot_lines(text)
    assert dots, "expected matrix products in the program"
    for ln in dots:
        prec = re.findall(r"precision = \[([A-Z_]+), ([A-Z_]+)\]", ln)
        assert prec and all(p == ("HIGHEST", "HIGHEST") for p in prec), ln


@pytest.mark.parametrize("solver,extra", [
    ("dense", {}),
    ("dia", {}),
    ("ell", {"preconditioner": "amg"}),
])
def test_step_dot_generals_are_highest(solver, extra):
    """Every dot_general of the jitted f32 System step carries HIGHEST:
    the dense inverse, the selector einsums, the SVD and Newton algebra,
    the ELL matvec and the AMG coarse solve."""
    s = _beam_system(solver, **extra)
    assert s._solver_mode == solver
    text = s._step_fn.lower(s.state, s.params).as_text()
    _assert_all_highest(text)


def test_rollout_and_sweep_dot_generals_are_highest():
    """The on-device rollout (System.run) and the vmapped scenario step
    pin their products too."""
    from admm_elastic_tpu.parallel.scenarios import (
        batch_params,
        batch_state,
        vmap_step,
    )

    s = _beam_system("dense")
    _assert_all_highest(s.make_rollout(2).lower(s.state, s.params).as_text())
    st = batch_state(s.state, 2)
    pa = batch_params(s.params, {}, 2)
    _assert_all_highest(vmap_step(s).lower(st, pa).as_text())


def test_unpinned_product_is_detected():
    """The check above is not vacuous: a product traced outside the
    precision context lowers without HIGHEST."""
    a = jnp.ones((4, 4), jnp.float32)
    text = jax.jit(lambda x: x @ x).lower(a).as_text()
    assert _dot_lines(text)
    with pytest.raises(AssertionError):
        _assert_all_highest(text)


@pytest.mark.parametrize("scramble", [False, True])
def test_dia_pcg_matches_spsolve(scramble):
    """The XLA dia solve (dia_apply + Jacobi PCG) reproduces a direct
    sparse solve of the assembled A_hat, in the canonical numbering and
    after the internal grid renumbering of a scrambled mesh."""
    import scipy.sparse.linalg as spl

    from admm_elastic_tpu.core.solver import (
        _assemble_A_hat_csr,
        dia_apply,
        pcg_solve,
    )

    beam = make_beam_tets(6, 4, 3, size=0.1)
    verts, tets = beam.vertices, beam.tets
    anchors = np.flatnonzero(verts[:, 0] < 1e-9)
    if scramble:
        rng = np.random.default_rng(0)
        perm = rng.permutation(beam.n_vertices)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        verts, tets, anchors = verts[perm], inv[tets], inv[anchors]
    n = len(verts)
    s = System(Settings(timestep_s=0.04, verbose=0, dtype=jnp.float64,
                        global_solver="dia", dense_max_nodes=0))
    s.add_nodes(verts, np.full(n, 1.0 / n))
    s.add_force(StaticAnchor(anchors))
    s.add_force(HyperElasticTet(tets, 1e5, 1e5, max_iters=3))
    assert s.initialize()
    assert s._solver_mode == "dia"
    assert (s._o2i is not None) == scramble

    cparams = {k: jax.tree_util.tree_map(np.asarray, s.params[k])
               for k in s._constraint_names}
    A = _assemble_A_hat_csr(n, s._mi, 0.04, cparams).tocsc()
    rng = np.random.default_rng(1)
    b = rng.standard_normal((n, 3))
    x_ref = np.stack([spl.spsolve(A, b[:, a]) for a in range(3)], 1)

    sv = s.params["_solver"]
    A_op = lambda y: dia_apply(y, s._dia_offsets, sv["dia_vals"])  # noqa: E731
    x, it = pcg_solve(A_op, jnp.asarray(b), jnp.zeros((n, 3)), sv["diag"],
                      1e-13, 5000)
    np.testing.assert_allclose(np.asarray(A_op(jnp.asarray(x_ref))), b,
                               rtol=1e-9, atol=1e-9)
    scale = np.abs(x_ref).max()
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=0,
                               atol=1e-9 * scale)
