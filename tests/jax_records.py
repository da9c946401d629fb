"""The JAX package's side of the port's parity tests, recorded.

A parity test computes the port's side and holds it to the JAX package's
side of the same inputs.  Where the JAX side costs seconds (compilation,
mostly), the test asks for it through :func:`recorded`::

    vj_j, vk_j = recorded("omega/exact_erf", lambda: jax_pw_jk.get_jk_kpts(
        cell_j, jnp.asarray(dm), jnp.asarray(ao), kpts, omega=0.6))

A test run returns the value stored under the key in
``tests/data/jax_live_sides.npz`` and does not call the function.
``JAX_PLATFORMS=cpu python tools/jax_port_refs.py live_sides`` runs the
test files of :data:`FILES` once with the functions called (it sets
``JAX_PORT_RECORD=1``) and rewrites the file, so the inputs and the gates
stay the test's own.

A value is an array-like or a flat tuple / list of array-likes; scalars
come back as 0-d arrays (``float(x)`` and ``int(x)`` read them).
"""
import os
from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "data" / "jax_live_sides.npz"
# the test files whose JAX sides are recorded here
FILES = ("test_torch_xc.py", "test_torch_omega_trunc.py",
         "test_torch_solvers.py", "test_torch_isdf_kpoint.py",
         "test_torch_gamma_thc.py", "test_torch_scf_device.py",
         "test_torch_basis_linalg.py", "test_torch_coulomb.py",
         "test_torch_f32_regime.py", "test_torch_pw.py",
         "test_torch_bands.py", "test_torch_cderi.py",
         "test_torch_parallel.py")
RECORDING = os.environ.get("JAX_PORT_RECORD") == "1"
_new = {}
_store = None


def recorded(key, fn):
    """The JAX side ``fn()`` of a comparison, under ``key``."""
    global _store
    if RECORDING:
        if key in _new:
            raise KeyError(f"record key {key!r} used twice")
        value = fn()
        if isinstance(value, (tuple, list)):
            _new[key] = tuple(np.asarray(v) for v in value)
        else:
            _new[key] = np.asarray(value)
        return _new[key]
    if _store is None:
        _store = np.load(PATH)
    if f"{key}#n" in _store:
        return tuple(_store[f"{key}#{i}"]
                     for i in range(int(_store[f"{key}#n"])))
    if key not in _store:
        raise KeyError(f"no JAX record {key!r} in {PATH.name}: rerun "
                       "tools/jax_port_refs.py live_sides")
    return _store[key]


def save():
    """Write every value recorded in this process."""
    flat = {}
    for key, value in _new.items():
        if isinstance(value, tuple):
            flat[f"{key}#n"] = np.asarray(len(value))
            for i, v in enumerate(value):
                flat[f"{key}#{i}"] = v
        else:
            flat[key] = value
    np.savez_compressed(PATH, **flat)
    return len(_new)
