#!/usr/bin/env python3
"""Record the JAX package's outputs that the port's slowest tests compare with.

    JAX_PLATFORMS=cpu python tools/jax_port_refs.py   # rewrites the file

Writes ``tests/data/jax_port_refs.json``: energies, interpolation-point
masks and meshes of the JAX package (``fftisdf_tpu``) on the CPU in float64,
each under the name of the test that reads it, with the configuration that
test uses.  The JAX package is the port's frozen reference, so its SCF runs
need not be repeated by every test run; the port's side of each test
still runs in full, as it does against the NiO example's record in
``tests/data/nio_afm_kuhf_anchor.json``.
"""
import json
import sys
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "tests" / "data" / "jax_port_refs.json"
AFM = {0: +1.0, 1: -1.0}


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(REPO))


def _diamond():
    from fftisdf_tpu.lattice import structure

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    return cell, cell.get_kpts([1, 1, 2])


def _near_dependent_he2():
    """He2 with two nearly identical s shells per atom (test_torch_scf_device
    .py::_near_dependent_cells)."""
    from fftisdf_tpu.lattice.cell import Cell, Shell

    shells = [Shell(l=0, exps=np.array([0.8, 0.3]),
                    coeffs=np.array([[0.4], [0.7]])),
              Shell(l=0, exps=np.array([0.8, 0.3]),
                    coeffs=np.array([[0.4 * (1 + 1e-7)], [0.7]]))]
    return Cell(a=np.diag([8.0, 8.0, 8.0]),
                atom=[("He", np.full(3, 4.0)),
                      ("He", np.array([4.0, 4.0, 6.5]))],
                basis={"He": shells}, pseudo=None, mesh=np.array([16] * 3),
                unit="bohr", precision=1e-12).build()


def _stretched_h2():
    from fftisdf_tpu.lattice.cell import Cell, Shell

    return Cell(a=np.diag([10.0, 10.0, 14.0]),
                atom=[("H", (5.0, 5.0, 5.0)), ("H", (5.0, 5.0, 9.0))],
                basis={"H": [Shell(l=0, exps=np.array([1.0, 0.35]),
                                   coeffs=np.eye(2))]},
                pseudo="gth-pade", mesh=np.array([24, 24, 32]), unit="bohr",
                precision=1e-12).build()


def _he2_asymmetric():
    from fftisdf_tpu.lattice.cell import Cell

    return Cell(a=np.diag([5.0, 5.0, 7.0]),
                atom=[("He", (2.1, 2.6, 2.0)), ("He", (2.7, 2.3, 4.4))],
                basis="sto-3g", pseudo=None, mesh=np.array([15, 15, 21]),
                unit="bohr", precision=1e-12).build()


def main():
    _jax()
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.scf import KRHF, KUHF

    refs = {"source": "JAX package (fftisdf_tpu) on the CPU in float64, "
                      "written by tools/jax_port_refs.py"}
    mask = lambda df: [int(i) for i in np.asarray(df.mask)]

    cell, kpts = _diamond()
    df = FFTISDF(cell, kpts, c0=10.0, m0=(15, 15, 15), verbose=0).build()
    mf = KUHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10,
              max_cycle=80, init_spin=AFM, smearing=5e-3)
    refs["test_isdf_kuhf_diamond_matches_jax"] = {
        "config": "diamond gth-szv ke 50 1x1x2, c0 10, m0 15^3, KUHF AFM "
                  "smearing 5e-3 conv_tol 1e-10",
        "e_tot": float(mf.kernel()), "converged": bool(mf.converged)}

    mf = KRHF(cell, kpts, verbose=0, conv_tol=1e-10, exxdiv="ewald")
    refs["test_exact_krhf_matches_jax"] = {
        "config": "diamond gth-szv ke 50 1x1x2, exact plane-wave KRHF, "
                  "exxdiv ewald, conv_tol 1e-10",
        "e_tot": float(mf.kernel()), "converged": bool(mf.converged)}

    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0).build()
    e_krhf = KRHF(cell, kpts, with_df=df, verbose=0,
                  conv_tol=1e-10).kernel()
    mf = KUHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10,
              smearing=5e-3)
    mf.kernel()
    refs["scf_device_diamond"] = {
        "config": "diamond gth-szv ke 50 1x1x2, c0 40, m0 9^3; KRHF "
                  "conv_tol 1e-10; KUHF smearing 5e-3 conv_tol 1e-10",
        "mask": mask(df), "e_krhf": float(e_krhf),
        "e_kuhf_smeared": float(mf.e_tot),
        "e_free_kuhf_smeared": float(mf.e_free)}

    cell = _near_dependent_he2()
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0).build()
    e = KRHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10,
             ovlp_cutoff=1e-4).kernel()
    refs["scf_device_near_dependent_he2"] = {
        "config": "He2, two near-identical s shells an atom, 1x1x2, c0 40, "
                  "m0 9^3; KRHF ovlp_cutoff 1e-4 conv_tol 1e-10",
        "mask": mask(df), "e_krhf": float(e)}

    cell = _stretched_h2()
    kpts = np.zeros((1, 3))
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 11), verbose=0).build()
    e = KUHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-9,
             init_spin=AFM, spin_bias=0.5, bias_cycles=4).kernel()
    refs["test_device_kuhf_bias_symmetry_breaking"] = {
        "config": "stretched H2, gamma, c0 40, m0 9x9x11; KUHF AFM "
                  "spin_bias 0.5 bias_cycles 4 conv_tol 1e-9",
        "mask": mask(df), "e_tot": float(e)}

    cell = _he2_asymmetric()
    kpts = cell.get_kpts([1, 1, 2])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        df = FFTISDF(cell, kpts, c0=10.0, m0="auto", m0_pool=1.0,
                     m0_floor=(2, 2, 2), verbose=0).build()
    refs["test_m0_auto_densifies_like_jax"] = {
        "config": "asymmetric He2 1x1x2, c0 10, m0 'auto', m0_pool 1, "
                  "m0_floor 2^3",
        "m0": [int(m) for m in df.m0], "nip": int(df.nip)}

    OUT.write_text("{\n" + ",\n".join(f" {json.dumps(k)}: {json.dumps(v)}"
                                      for k, v in refs.items()) + "\n}\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
