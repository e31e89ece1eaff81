"""Matched-residual evidence for the SHIPPING windyflag configuration
(VERDICT r4 weak #5): the real scene (samples/scenes/cloth.xml, 30 ADMM
iterations) in f64, its benchmark CG budget vs a near-exact deep-CG
solve; prints the per-step final primal residual ratio.

    env PYTHONPATH=. JAX_PLATFORMS=cpu \
        JAX_ENABLE_X64=1 python -u tools/windyflag_match.py [steps]
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np
import jax.numpy as jnp


def build(cg_override=None):
    from bench import build_windyflag

    sysm = build_windyflag(jnp.float64)
    # route through the grid-cloth layout with the requested budget
    if cg_override is not None:
        sysm.settings.cg_fixed_iters = cg_override
    sysm.settings.collect_residuals = "primal"
    sysm.settings.lattice_fast_path = True
    sysm.initialize()
    assert sysm._lattice is not None
    return sysm


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    bench_sys = build()
    budget = bench_sys._lattice.cg_iters
    print(f"# shipping windyflag kernel budget: cg{budget}, "
          f"{bench_sys.settings.admm_iters} ADMM iters")
    exact = build(cg_override=300)

    def res(sysm):
        out = []
        for _ in range(steps):
            sysm.step()
            out.append(float(np.asarray(
                sysm.last_aux["primal_residual"])[-1]))
        return np.array(out)

    r_b = res(bench_sys)
    r_e = res(exact)
    ratio = r_b / r_e
    print(f"# exact(cg300): {r_e}")
    print(f"# bench(cg{budget}): {r_b}")
    print(f"ratios: {[round(float(q), 4) for q in ratio]}  "
          f"worst: {ratio.max():.4f}")


if __name__ == "__main__":
    main()
