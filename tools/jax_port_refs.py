#!/usr/bin/env python3
"""Record the JAX package's outputs that the port's slowest tests compare with.

    JAX_PLATFORMS=cpu python tools/jax_port_refs.py           # every record
    JAX_PLATFORMS=cpu python tools/jax_port_refs.py bands     # one section

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


def _scf(refs):
    """The SCF runs of test_torch_isdf_kpoint.py, test_torch_pw.py,
    test_torch_scf_device.py and test_torch_f32_regime.py."""
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.scf import KRHF, KUHF

    mask = _mask

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



SECTIONS = {"scf": lambda r: _scf(r), "f32": lambda r: _f32_kuhf(r),
            "trunc": lambda r: _trunc(r), "bands": lambda r: _bands(r),
            "lsthc": lambda r: _lsthc(r), "ks": lambda r: _ks(r)}


def main():
    """Every section, or those named on the command line (the others keep
    their recorded values)."""
    _jax()
    names = sys.argv[1:] or list(SECTIONS)
    refs = {"source": "JAX package (fftisdf_tpu) on the CPU in float64, "
                      "written by tools/jax_port_refs.py"}
    if sys.argv[1:] and OUT.exists():
        refs = json.loads(OUT.read_text())
    for name in names:
        SECTIONS[name](refs)
    OUT.write_text("{\n" + ",\n".join(f" {json.dumps(k)}: {json.dumps(v)}"
                                      for k, v in refs.items()) + "\n}\n")
    print(f"wrote {OUT}")


def _mask(df):
    return [int(i) for i in np.asarray(df.mask)]


def _f32_kuhf(refs):
    """tests/test_torch_f32_regime.py::test_kuhf_f32_matches_jax."""
    import jax.numpy as jnp
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.scf import KUHF

    cell, kpts = _diamond()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        df = FFTISDF(cell, kpts, c0=20.0, m0=(9, 9, 9), verbose=0,
                     dtype=jnp.float32).build()
    mf = KUHF(cell, kpts, with_df=df, dtype=jnp.float32, verbose=0,
              conv_tol=1e-7, smearing=5e-3, max_cycle=60)
    mf.kernel()
    refs["test_kuhf_f32_matches_jax"] = {
        "config": "diamond gth-szv ke 50 1x1x2, float32 build c0 20 m0 9^3;"
                  " float32 KUHF smearing 5e-3 conv_tol 1e-7 max_cycle 60",
        "mask": _mask(df), "e_tot": float(mf.e_tot),
        "converged": bool(mf.converged),
        "ovlp_cutoff": float(mf.ovlp_cutoff)}


def h2_box(cell_cls, L, ke=80.0, R=1.4):
    """H2/STO-3G at R = 1.4 bohr centred in an L-bohr cube
    (examples/molecule_in_a_box.py)."""
    return cell_cls(a=np.eye(3) * L,
                    atom=[("H", (L / 2, L / 2, L / 2 - R / 2)),
                          ("H", (L / 2, L / 2, L / 2 + R / 2))],
                    basis="sto-3g", pseudo=None, ke_cutoff=ke, unit="bohr",
                    precision=1e-12).build()


def h2_slab(cell_cls, lz, L=8.0, ke=60.0, R=1.4):
    """The H2 monolayer of tests/test_trunc_scf.py (in-plane L, vacuum
    lz)."""
    return cell_cls(a=np.diag([L, L, lz]),
                    atom=[("H", (L / 2 - R / 2, L / 2, lz / 2)),
                          ("H", (L / 2 + R / 2, L / 2, lz / 2))],
                    basis="sto-3g", pseudo=None, ke_cutoff=ke, unit="bohr",
                    precision=1e-12).build()


def _trunc(refs):
    """SCF-level truncation: H2 in a box (0d; the defaults of
    examples/molecule_in_a_box.py, exact and ISDF) and the H2 monolayer
    (2d with exxdiv='ewald'; tests/test_trunc_scf.py)."""
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.lattice.cell import Cell
    from fftisdf_tpu.scf import KRHF

    box = {}
    for L in (9.0, 11.0, 12.5):
        cell = h2_box(Cell, L)
        kpts = cell.get_kpts([1, 1, 1])
        e_ex = KRHF(cell, kpts, trunc="0d", verbose=0).kernel()
        df = FFTISDF(cell, kpts, c0=25.0, m0=(15, 15, 15), verbose=0,
                     trunc="0d").build()
        e_is = KRHF(cell, kpts, with_df=df, verbose=0).kernel()
        box[str(L)] = {"e_exact": float(e_ex), "e_isdf": float(e_is),
                       "mask": _mask(df)}
    refs["trunc_h2_box"] = {
        "config": "H2 STO-3G R 1.4 in an L cube, ke 80, gamma, KRHF "
                  "trunc 0d: exact plane-wave, and ISDF c0 25 m0 15^3",
        **box}
    slab = {}
    for lz in (12.0, 16.0):
        cell = h2_slab(Cell, lz)
        kpts = cell.get_kpts([1, 1, 1])
        slab[str(lz)] = float(KRHF(cell, kpts, trunc="2d", exxdiv="ewald",
                                   verbose=0).kernel())
    slab["bare_16.0"] = float(KRHF(cell, kpts, verbose=0).kernel())
    refs["trunc_h2_slab"] = {
        "config": "H2 STO-3G monolayer, in-plane L 8, vacuum lz, ke 60, "
                  "gamma, exact KRHF trunc 2d exxdiv ewald (bare_16.0: "
                  "untruncated at lz 16)", **slab}


def he2_bands_cell(cell_cls, shell_cls):
    """He2 with an uncontracted 2-exponent s basis
    (tests/test_isdf_bands.py)."""
    Shell = shell_cls
    return cell_cls(a=np.diag([5.0, 5.0, 7.0]),
                    atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
                    basis={"He": [Shell(l=0, exps=np.array([1.0, 0.35]),
                                        coeffs=np.eye(2))]},
                    pseudo=None, mesh=np.array([12, 12, 16]), unit="bohr",
                    precision=1e-12).build()


def band_kpts(cell, kpts):
    b = cell.reciprocal_vectors()
    return np.array([0.17 * b[2], 0.33 * b[0] + 0.41 * b[2], kpts[1]])


def _bands(refs):
    """Band energies from converged densities: exact KRHF and ISDF KUHF
    on the He2 cell of tests/test_isdf_bands.py."""
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.lattice.cell import Cell, Shell
    from fftisdf_tpu.scf import KRHF, KUHF

    cell = he2_bands_cell(Cell, Shell)
    kpts = cell.get_kpts([1, 1, 2])
    kb = band_kpts(cell, kpts)
    mf = KRHF(cell, kpts, verbose=0, conv_tol=1e-12)
    mf.kernel()
    es, _ = mf.get_bands(kb)
    df = FFTISDF(cell, kpts, c0=10.0, m0=(7, 7, 11), verbose=0).build()
    mfu = KUHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-12)
    mfu.kernel()
    esu, _ = mfu.get_bands(kb)
    df_full = FFTISDF(cell, kpts, c0=60.0, m0=tuple(cell.mesh), verbose=0,
                      select_tol=1e-20, rcond=1e-12).build()
    refs["bands_he2"] = {
        "config": "He2 2s basis 1x1x2 mesh 12x12x16; band points 0.17 b3, "
                  "0.33 b1 + 0.41 b3, kpts[1]; exact KRHF conv_tol 1e-12; "
                  "ISDF c0 10 m0 7x7x11 KUHF conv_tol 1e-12; mask_full: "
                  "c0 60 m0 = mesh select_tol 1e-20 rcond 1e-12",
        "mask_full": _mask(df_full),
        "e_krhf": float(mf.e_tot), "bands_krhf": np.asarray(es).tolist(),
        "mask": _mask(df), "e_kuhf": float(mfu.e_tot),
        "bands_kuhf": np.asarray(esu).tolist()}


def lsthc_he2_cell(cell_cls, a=(5.0, 5.0, 7.0), mesh=(9, 9, 11)):
    """He2 STO-3G (tests/test_thc_ao2mo.py; a larger box for the Becke
    grids, whose partition cost grows with the lattice images)."""
    return cell_cls(a=np.diag(a),
                    atom=[("He", (a[0] / 2, a[1] / 2, 2.0)),
                          ("He", (a[0] / 2, a[1] / 2, 4.5))],
                    basis="sto-3g", pseudo=None, mesh=np.array(mesh),
                    unit="bohr", precision=1e-12).build()


BECKE_BOX = dict(a=(9.0, 9.0, 10.0), mesh=(11, 11, 13))


def _lsthc(refs):
    """LS-THC error reports: uniform grid (all pairs, and the reference's
    k1 = 0 row) and Becke grids (level 0)."""
    from fftisdf_tpu.isdf.thc import LSTHC
    from fftisdf_tpu.lattice.becke import AtomCenteredGrids
    from fftisdf_tpu.lattice.cell import Cell

    cell = lsthc_he2_cell(Cell)
    kpts = cell.get_kpts([1, 1, 2])
    out = {"config": "He2 STO-3G 1x1x2: uniform 5x5x7 box, mesh 9x9x11; "
                     "becke: 9x9x10 box, mesh 11x11x13, level 0; rows "
                     "(k1, k2, max err, frobenius err)"}
    for name, kw in (("uniform", {}), ("row_only", {"row_only": True})):
        out[name] = [list(map(float, r)) for r in
                     LSTHC(cell, kpts, verbose=0).build(**kw).error_report()]
    cell = lsthc_he2_cell(Cell, **BECKE_BOX)
    kpts = cell.get_kpts([1, 1, 2])
    grids = AtomCenteredGrids(cell, level=0).build()
    out["becke"] = [list(map(float, r)) for r in LSTHC(
        cell, kpts, verbose=0, grids=grids).build().error_report()]
    refs["lsthc_he2"] = out


KS_RUNS = (("krks_lda", "KRKS", "lda", None),
           ("krks_pbe", "KRKS", "pbe", None),
           ("krks_b3lyp", "KRKS", "b3lyp", None),
           ("krks_scan", "KRKS", "scan", None),
           ("krks_hse06", "KRKS", "hse06", None),
           ("kuks_lda_u", "KUKS", "lda", {0: (1, 0.2), 1: (1, 0.2)}))
NIO_U_EV = 6.2                 # U_eff on the Ni d shells (examples/nio_afm_kuhf.py)
HARTREE_EV = 27.211386
KS_ANCHOR = REPO / "tests" / "data" / "nio_afm_kuks_anchor.json"


def _ks(refs):
    """Kohn-Sham SCF energies: diamond 1x1x2 on an ISDF build (c0 40,
    m0 9^3) for each functional of tests/test_torch_ks.py, and the NiO
    anchor (examples/nio_afm_kuhf.py --xc pbe [--hubbard-u 6.2] on the
    KUHF anchor's interpolation points), which goes to its own file."""
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.lattice import structure
    from fftisdf_tpu.scf import KRKS, KUKS
    from fftisdf_tpu.scf.analysis import atom_charges_and_moments

    drivers = {"KRKS": KRKS, "KUKS": KUKS}
    cell, kpts = _diamond()
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0).build()
    out = {"config": "diamond gth-szv ke 50 1x1x2, c0 40, m0 9^3; "
                     "conv_tol 1e-10, max_cycle 80; kuks_lda_u: hubbard "
                     "{0: (1, 0.2), 1: (1, 0.2)}",
           "mask": _mask(df)}
    for key, drv, xc, hub in KS_RUNS:
        mf = drivers[drv](cell, kpts, with_df=df, xc=xc, hubbard=hub,
                          verbose=0, conv_tol=1e-10, max_cycle=80)
        out[key] = {"e_tot": float(mf.kernel()),
                    "converged": bool(mf.converged), "cycles": mf.cycles}
    refs["ks_diamond"] = out

    anchor = json.loads((REPO / "tests" / "data"
                         / "nio_afm_kuhf_anchor.json").read_text())
    cfg = anchor["config"]
    cell = structure.to_cell(*structure.nio_afm(), basis=cfg["basis"],
                             pseudo=cfg["pseudo"], ke_cutoff=cfg["ke_cutoff"],
                             exp_to_discard=cfg["exp_to_discard"])
    kpts = cell.get_kpts(cfg["kmesh"])
    df = FFTISDF(cell, kpts, c0=cfg["c0"], m0=tuple(cfg["m0"]),
                 verbose=0).build()
    assert _mask(df) == anchor["mask"], "the anchor's selection moved"
    u = NIO_U_EV / HARTREE_EV
    rec = {"source": "JAX package (fftisdf_tpu) on the CPU in float64, "
                     "written by tools/jax_port_refs.py ks: KUKS of "
                     "examples/nio_afm_kuhf.py --xc pbe [--hubbard-u 6.2] "
                     "on the KUHF anchor's interpolation points",
           "config": dict(cfg, xc="pbe", hubbard_u_ev=NIO_U_EV,
                          hubbard_u_ha=u, hubbard_l=2, hubbard_atoms=[0, 1]),
           "mask": anchor["mask"]}
    for key, hub in (("pbe", None), ("pbe_u", {0: (2, u), 1: (2, u)})):
        mf = KUKS(cell, kpts, with_df=df, xc="pbe", hubbard=hub, verbose=0,
                  conv_tol=cfg["conv_tol"], max_cycle=cfg["max_cycle"],
                  init_spin=AFM, smearing=cfg["smearing"])
        e = mf.kernel()
        _, mom = atom_charges_and_moments(cell, mf.dm, mf.s1e)
        rec[key] = {"e_tot": float(e), "converged": bool(mf.converged),
                    "cycles": mf.cycles,
                    "moments": [float(m) for m in mom]}
    KS_ANCHOR.write_text(json.dumps(rec, indent=1) + "\n")


if __name__ == "__main__":
    main()
