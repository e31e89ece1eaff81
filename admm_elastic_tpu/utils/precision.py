"""Full-f32 matrix products for the jitted device programs.

On a GPU a float32 `dot_general` at default precision may run in TF32,
which keeps about three decimal digits. The global solves (the dense
inverse, the ELL matvec, the AMG coarse solve) and the per-element SVD and
Newton steps need full float32. Every jitted entry point traces its body
under `highest`, so each matrix product it contains is lowered with
`precision=HIGHEST`; float64 products are unaffected.
"""

from __future__ import annotations

import functools

import jax


def highest(fn):
    """Wrap fn so that tracing it pins matrix products to HIGHEST."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
