"""Element-axis sharding of constraint batches.

Layout contract: vertex arrays (x, v, masses, per-vertex scratch) are
replicated; any array whose leading dimension equals a constraint batch's
element count is sharded along the mesh's element axis. Batches are padded to
a multiple of the element-axis size by replicating their last element with
weight 0 (a valid-geometry no-op element: all local math stays finite, and
w^2 = 0 removes it from every global reduction and from the diagonal).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.precision import highest


def make_sim_mesh(devices=None, data: int = 1, elem: int | None = None) -> Mesh:
    """2D ('data','elem') mesh. elem defaults to n_devices/data."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if elem is None:
        if n % data != 0:
            raise ValueError(f"{n} devices not divisible by data={data}")
        elem = n // data
    dev = np.asarray(devices[: data * elem]).reshape(data, elem)
    return Mesh(dev, ("data", "elem"))


def _pad_leading(a, target: int, pad_mode: str):
    a = np.asarray(a)
    E = a.shape[0]
    if E == target:
        return a
    pad = target - E
    if pad_mode == "zero":
        tail = np.zeros((pad,) + a.shape[1:], a.dtype)
    else:  # replicate last element
        tail = np.broadcast_to(a[-1:], (pad,) + a.shape[1:]).copy()
    return np.concatenate([a, tail], axis=0)


def pad_batches(system, multiple: int):
    """Pad every constraint batch of an *initialized* System so each element
    count is a multiple of `multiple`. Mutates system.params/state in place
    (host-side numpy round-trip). Weight of padded elements is 0."""
    import jax.numpy as jnp

    for f in system._force_list:
        E = f.n_elements
        target = -(-E // multiple) * multiple
        if target == E:
            continue
        p = {k: np.asarray(v) for k, v in system.params[f.name].items()}
        for k, v in p.items():
            if v.ndim >= 1 and v.shape[0] == E:
                p[k] = _pad_leading(v, target, "replicate")
        p["weight"][E:] = 0.0
        system.params[f.name] = {
            k: jnp.asarray(v, system.params[f.name][k].dtype) for k, v in p.items()
        }
        st = {k: np.asarray(v) for k, v in system.state["forces"][f.name].items()}
        for k, v in st.items():
            if v.ndim >= 1 and v.shape[0] == E:
                st[k] = _pad_leading(v, target, "replicate")
        system.state["forces"][f.name] = {
            k: jnp.asarray(v, system.state["forces"][f.name][k].dtype)
            for k, v in st.items()
        }
        u = np.asarray(system.state["u"][f.name])
        system.state["u"][f.name] = jnp.asarray(
            _pad_leading(u, target, "zero"), u.dtype
        )
        f._padded_elements = target
    return system


def shard_params_and_state(system, mesh: Mesh, elem_axis: str = "elem"):
    """Place an initialized System's params/state on `mesh`: element-leading
    arrays sharded along elem_axis, everything else replicated. Pads batches
    first. Returns (params, state) (also assigned back to the system)."""
    if getattr(system, "_solver_mode", None) in ("ell", "dia"):
        raise ValueError(
            "this GSPMD helper requires global_solver='cg' or 'dense'; for "
            "ell/dia use parallel.spmd.SpmdSystem (per-shard local steps "
            "+ row-sharded CG under shard_map)"
        )
    n_shards = mesh.shape[elem_axis]
    pad_batches(system, n_shards)

    elem_counts = {
        getattr(f, "_padded_elements", f.n_elements) for f in system._force_list
    }

    def sharding_for(a):
        if hasattr(a, "ndim") and a.ndim >= 1 and a.shape[0] in elem_counts:
            return NamedSharding(mesh, P(elem_axis, *([None] * (a.ndim - 1))))
        return NamedSharding(mesh, P())

    def place(tree):
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(a, sharding_for(a)), tree
        )

    cnames = set(system._constraint_names)
    new_params = {}
    for k, v in system.params.items():
        new_params[k] = place(v) if k in cnames else jax.device_put(
            v, NamedSharding(mesh, P())
        )
    system.params = new_params

    new_state = dict(system.state)
    new_state["x"] = jax.device_put(system.state["x"], NamedSharding(mesh, P()))
    new_state["v"] = jax.device_put(system.state["v"], NamedSharding(mesh, P()))
    new_state["u"] = place(system.state["u"])
    new_state["forces"] = place(system.state["forces"])
    system.state = new_state
    system._masses_dev = jax.device_put(
        system._masses_dev, NamedSharding(mesh, P())
    )
    # rebuild the jitted step so it closes over the sharded masses
    system._step_fn = jax.jit(highest(system._make_step()),
                              donate_argnums=(0,))
    return system.params, system.state
