#!/usr/bin/env python3
"""Where the range-separated Coulomb kernels' exp rounds, on the CPU.

    JAX_PLATFORMS=cpu python tools/exp_ulps.py

On the He2 cell and omega of tests/test_torch_coulomb.py, at q = 0 and at
a k-point, prints the largest distance, in units in the last place of
numpy's float64 result, of torch's vectorised exp (at 1, 2 and 8 intra-op
threads: the xdist workers run 2) and of XLA's CPU exp (eager and jitted)
from numpy's exp of the same exponent -|q+G|^2 / (4 omega^2); then the
largest relative distance of each package's erf and erfc kernel
(``get_coulG`` and ``get_coulG_batched``) from numpy's kernel formed the
same way.  The test holds each package to numpy's kernel at 1e-12
relative.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

OMEGA = 0.6
HE2 = dict(a=np.diag([5.0, 5.0, 7.0]),
           atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
           basis="sto-3g", pseudo=None, mesh=np.array([15, 15, 21]),
           unit="bohr", precision=1e-12)


def ulps(a, b):
    a, b = np.asarray(a), np.asarray(b)
    ok = b != 0
    return float((np.abs(a - b)[ok] / np.spacing(np.abs(b[ok]))).max())


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max())


def kernel_np(gv, q, omega):
    """numpy's float64 erf (omega > 0) / erfc (omega < 0) kernel."""
    g = gv + q[None, :]
    a2 = np.einsum("gi,gi->g", g, g)
    ok = a2 > 1e-12
    inv = np.where(ok, 4.0 * np.pi / np.where(ok, a2, 1.0), 0.0)
    screen = np.exp(-a2 / (4.0 * omega * omega))
    if omega > 0:
        return inv * screen
    return np.where(ok, inv * (1.0 - screen), np.pi / (omega * omega))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch
    from fftisdf_tpu.lattice.cell import Cell as JaxCell
    from fftisdf_tpu.linalg import coulomb as jax_coulomb
    from fftisdf_tpu_torch.lattice.cell import Cell
    from fftisdf_tpu_torch.linalg import coulomb as t_coulomb

    cell_j, cell = JaxCell(**HE2).build(), Cell(**HE2).build()
    kpts = cell.get_kpts([1, 1, 2])
    gv = cell.get_Gv()
    for name, q in (("q = 0", np.zeros(3)), ("q = k1", kpts[1])):
        g = gv + q[None, :]
        x = -np.einsum("gi,gi->g", g, g) / (4.0 * OMEGA * OMEGA)
        ref = np.exp(x)
        line = [f"{name}: torch exp"]
        for nt in (1, 2, 8):
            torch.set_num_threads(nt)
            line.append(f"{ulps(torch.exp(torch.from_numpy(x)), ref):g} ulp "
                        f"({nt} threads)")
        line.append(f"XLA exp {ulps(jnp.exp(jnp.asarray(x)), ref):g} ulp "
                    "(eager), "
                    f"{ulps(jax.jit(jnp.exp)(jnp.asarray(x)), ref):g} ulp "
                    "(jit)")
        print(", ".join(line))
    worst = {"port": 0.0, "JAX": 0.0}
    for nt in (1, 2, 8):
        torch.set_num_threads(nt)
        for omega in (OMEGA, -OMEGA):
            for q in (np.zeros(3), kpts[1]):
                exact = kernel_np(gv, q, omega)
                out = t_coulomb.get_coulG(cell, q=q, mesh=cell.mesh,
                                          omega=omega, device="cpu")
                worst["port"] = max(worst["port"], rel(out, exact))
                ref = jax_coulomb.get_coulG(cell_j, q=q, mesh=cell.mesh,
                                            omega=omega)
                worst["JAX"] = max(worst["JAX"], rel(ref, exact))
        out = t_coulomb.get_coulG_batched(cell, torch.from_numpy(kpts),
                                          torch.from_numpy(gv), omega=OMEGA)
        ref = jax_coulomb.get_coulG_batched(cell_j, kpts, gv, omega=OMEGA)
        for i, q in enumerate(kpts):
            exact = kernel_np(gv, q, OMEGA)
            worst["port"] = max(worst["port"], rel(out[i], exact))
            worst["JAX"] = max(worst["JAX"], rel(ref[i], exact))
    print("erf/erfc kernels, largest relative distance from numpy's: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))


if __name__ == "__main__":
    main()
