#!/usr/bin/env python3
"""Record the JAX package's outputs that the port's slowest tests compare with.

    JAX_PLATFORMS=cpu python tools/jax_port_refs.py           # every record
    JAX_PLATFORMS=cpu python tools/jax_port_refs.py bands     # one section
    JAX_PLATFORMS=cpu python tools/jax_port_refs.py correlated  # after many_body
    JAX_PLATFORMS=cpu python tools/jax_port_refs.py derivatives

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
    sys.path.insert(0, str(REPO / "tests"))


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
            "lsthc": lambda r: _lsthc(r), "ks": lambda r: _ks(r),
            "many_body": lambda r: _many_body(r),
            "correlated": lambda r: _correlated(r),
            "jax_sides": lambda r: _jax_sides(r),
            "derivatives": lambda r: _derivatives(r)}


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



def h2_chain(cell_cls, shell_cls, nz=1, lz=7.0):
    """The H2 chain of tests/test_mp2.py (two 2-exponent s shells per H)."""
    atoms = []
    for i in range(nz):
        atoms += [("H", (3.0, 3.0, 1.8 + lz * i)),
                  ("H", (3.0, 3.0, 3.2 + lz * i))]
    return cell_cls(
        a=np.diag([6.0, 6.0, lz * nz]), atom=atoms,
        basis={"H": [shell_cls(l=0, exps=np.array([1.2, 0.4]),
                               coeffs=np.eye(2))]},
        pseudo="gth-pade",
        mesh=np.array([14, 14, int(14 * nz * lz / 6) // 2 * 2 + 1]),
        unit="bohr", precision=1e-12).build()


def _c(a):
    """A complex array as {shape, re, im} (numpy reads it back exactly)."""
    a = np.asarray(a)
    return {"shape": list(a.shape), "re": np.real(a).ravel().tolist(),
            "im": np.imag(a).ravel().tolist()}


def _real_gauge(mf):
    """Give ``mf`` real orbitals, in place, on a mesh of time-reversal
    invariant k-points (gamma and the zone-boundary point of 1x1x2),
    where S_k and the converged F_k are real up to the grid quadrature's
    ~4e-7: the orbitals and energies become those of (Re F_k, Re S_k) and
    the density is rebuilt from them.  The JAX package's chi (A g A^T)
    equals the port's (A g A^H) for real orbitals only, so both packages
    see the same numbers on these inputs."""
    from fftisdf_tpu.scf.hf import _build_dm, _eigh_gen

    s1e = np.asarray(mf.s1e)
    assert np.abs(s1e.imag).max() < 1e-10, "not a time-reversal-invariant mesh"
    fock = np.asarray(mf.get_fock(mf.dm)[0])
    assert np.abs(fock.imag).max() < 1e-5
    flat_f = fock.reshape(-1, *fock.shape[-2:])
    nk = s1e.shape[0]
    es, cs = [], []
    for idx in range(flat_f.shape[0]):
        e, c = _eigh_gen(flat_f[idx].real, s1e[idx % nk].real,
                         cutoff=mf.ovlp_cutoff)
        es.append(e)
        cs.append(np.asarray(c, dtype=np.complex128))
    e_new = np.asarray(es).reshape(np.shape(mf.mo_energy))
    assert np.abs(e_new - np.asarray(mf.mo_energy)).max() < 1e-5
    out = np.asarray(cs).reshape(np.shape(mf.mo_coeff))
    assert np.abs(out.imag).max() == 0.0
    mf.mo_coeff, mf.mo_energy = out, e_new
    occ = np.asarray(mf.mo_occ)
    mf.dm = (np.stack([np.asarray(_build_dm(out[s], occ[s]))
                       for s in range(2)]) if out.ndim == 4
             else np.asarray(_build_dm(out, occ)))
    return mf


def _orbitals(mf):
    return {"mo_coeff": _c(mf.mo_coeff),
            "mo_energy": np.asarray(mf.mo_energy).tolist(),
            "mo_occ": np.asarray(mf.mo_occ).tolist()}


def _hvp_probes(fmesh, gv, weight):
    """HVP of the discrete Exc, jvp(grad(Exc)) as scf.tddft takes it, on
    diamond's mesh: the toy density and the zeta = +-1 tie of
    tests/test_torch_xc.py, two seeded tangents each, read as projections
    on three seeded probes."""
    import jax
    import jax.numpy as jnp
    from fftisdf_tpu.linalg.fft import fft3, ifft3
    from fftisdf_tpu.scf import xc as xc_mod

    ng = int(np.prod(fmesh))
    rng = np.random.default_rng(17)
    tangents = rng.standard_normal((2, 2, ng))
    probes = rng.standard_normal((3, 2, ng))
    gvt = jnp.asarray(gv).T
    out = {}
    for case, rho in hvp_densities(fmesh).items():
        for name in ("lda", "pbe", "b3lyp", "hse06"):
            spec = xc_mod.parse_xc(name)

            def total(r):
                sigma = None
                if spec.is_gga:
                    g = jnp.stack([ifft3(1j * gvt[i] * fft3(
                        r.astype(jnp.complex128), fmesh), fmesh).real
                        for i in range(3)], axis=1)
                    sigma = jnp.stack([jnp.sum(g[0] * g[0], axis=0),
                                       jnp.sum(g[0] * g[1], axis=0),
                                       jnp.sum(g[1] * g[1], axis=0)])
                return weight * jnp.sum(xc_mod._exc_density(r, sigma, spec))

            rows = []
            for t in tangents:
                h = np.asarray(jax.jvp(jax.grad(total), (jnp.asarray(rho),),
                                       (jnp.asarray(t),))[1])
                rows.append([float(np.sum(p * h)) for p in probes])
            out[f"{case}/{name}"] = rows
    return out


def hvp_densities(fmesh):
    """{case: rho (2, ng)}: the toy density and the zeta = +-1 tie (one
    channel empty on each half of the grid) of tests/test_torch_xc.py."""
    ng = int(np.prod(fmesh))

    def toy(seed):
        coef = np.random.default_rng(seed).standard_normal((2, 4, 4, 4))
        field = np.zeros((2,) + tuple(fmesh))
        for s in range(2):
            f = np.zeros(fmesh, dtype=complex)
            f[:4, :4, :4] = coef[s] * 0.05 * ng
            field[s] = np.real(np.fft.ifftn(f))
        return (0.3 + field - field.min()).reshape(2, ng)

    pol = toy(5)
    pol[1, : ng // 2] = 0.0
    pol[0, ng // 2:] = 0.0
    return {"toy": toy(1), "zeta=+-1": pol}


def _many_body(refs):
    """The many-body layer (scf.mp2/rpa/gw/tddft/bse) on the JAX tests'
    fixtures: the H2 chain at gamma and 1x1x2, diamond gth-szv ke 50
    1x1x2 on KRKS references, and the xc kernel's HVP.  The inputs (the
    interpolation points and the converged orbitals) are recorded beside
    the outputs, so the port's tests run the methods on the same
    orbitals."""
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.lattice.cell import Cell, Shell
    from fftisdf_tpu.scf import KRHF, KUHF
    from fftisdf_tpu.scf import bse, gw, mp2, rpa, tddft
    from fftisdf_tpu.scf.ks import KRKS, KUKS

    isdf_kw = dict(c0=60.0, m0=(11, 11, 13), verbose=0, select_tol=1e-18,
                   rcond=1e-12)
    out = {"config": "H2 chain of tests/test_mp2.py (c0 60, m0 11x11x13, "
                     "select_tol 1e-18, rcond 1e-12; KRHF conv_tol 1e-10; "
                     "nw 24): gamma and 1x1x2 (open shell: spin 2 KUHF "
                     "conv_tol 1e-9); diamond gth-szv ke 50 1x1x2 c0 40 "
                     "m0 9^3, KRKS conv_tol 1e-10; Davidson tol 1e-8; "
                     "every reference's orbitals in a real gauge"}
    cell = h2_chain(Cell, Shell)
    kpts = np.zeros((1, 3))
    df = FFTISDF(cell, kpts, **isdf_kw).build()
    mf = KRHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10)
    mf.kernel()
    ks = KRKS(cell, kpts, xc="pbe", with_df=df, verbose=0, conv_tol=1e-10)
    ks.kernel()
    _real_gauge(mf)
    _real_gauge(ks)
    sig, _, ef, _ = gw.sigma_c_iw(df, mf, nw=24)
    e_qp, info = gw.g0w0(df, mf, nw=24)
    e_qp_ks, info_ks = gw.g0w0(df, ks, nw=24)
    out["h2_gamma"] = {
        "mask": _mask(df), "krhf": _orbitals(mf), "krks_pbe": _orbitals(ks),
        "kmp2": mp2.kmp2(df, mf)[0], "drpa": rpa.drpa(df, mf, nw=24)[0],
        "sigma": _c(sig), "efermi": float(ef), "e_qp": e_qp.tolist(),
        "z": np.asarray(info["z"]).tolist(),
        "tda_s": tddft.tda(mf, df, nroots=0, dense=True)[0].tolist(),
        "tda_t": tddft.tda(mf, df, nroots=0, singlet=False,
                           dense=True)[0].tolist(),
        "tddft": tddft.tddft(mf, df, nroots=3)[0].tolist(),
        "bse": bse.bse(mf, df, nroots=0, dense=True)[0].tolist(),
        "pbe_tda_s": tddft.tda(ks, df, nroots=0, dense=True)[0].tolist(),
        "pbe_tda_t": tddft.tda(ks, df, nroots=0, singlet=False,
                               dense=True)[0].tolist(),
        "pbe_tddft": tddft.tddft(ks, df, nroots=3)[0].tolist(),
        "pbe_e_qp": e_qp_ks.tolist(),
        "pbe_correction": np.asarray(info_ks["correction"]).tolist()}

    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, **isdf_kw).build()
    mf = KRHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-10)
    mf.kernel()
    cell2 = cell.copy(spin=2).build()
    umf = KUHF(cell2, kpts, with_df=df, verbose=0, conv_tol=1e-9,
               max_cycle=80)
    umf.kernel()
    _real_gauge(mf)
    _real_gauge(umf)
    w_dav, d = tddft.tda(mf, df, q=0, nroots=3, dense=False, tol=1e-8)
    assert d["converged"]
    out["h2_k2"] = {
        "mask": _mask(df), "krhf": _orbitals(mf), "kuhf_spin2":
        _orbitals(umf), "kmp2": mp2.kmp2(df, mf)[0],
        "kump2_spin2": mp2.kump2(df, umf)[0],
        "drpa": rpa.drpa(df, mf, nw=24)[0],
        "e_qp": gw.g0w0(df, mf, nw=24)[0].tolist(),
        "tda_s_q0": tddft.tda(mf, df, q=0, nroots=0, dense=True)[0].tolist(),
        "tda_s_q1": tddft.tda(mf, df, q=1, nroots=0, dense=True)[0].tolist(),
        "tda_t_q1": tddft.tda(mf, df, q=1, nroots=0, singlet=False,
                              dense=True)[0].tolist(),
        "tda_davidson_q0": w_dav.tolist(),
        "utda_spin2": tddft.utda(umf, df, nroots=0, dense=True)[0].tolist(),
        "tddft_q1": tddft.tddft(mf, df, q=1, nroots=3)[0].tolist()}

    cell, kpts = _diamond()
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0).build()
    rec = {"mask": _mask(df)}
    for xc in ("pbe", "b3lyp", "hse06"):
        ks = KRKS(cell, kpts, xc=xc, with_df=df, verbose=0, conv_tol=1e-10)
        ks.kernel()
        _real_gauge(ks)
        rec[xc] = _orbitals(ks)
        rec[xc]["tda_s_q1"] = tddft.tda(ks, df, q=1, nroots=0,
                                        dense=True)[0].tolist()
        if xc != "pbe":
            continue
        w0, info0 = tddft.tda(ks, df, q=0, nroots=0, dense=True)
        e_qp, info = gw.g0w0(df, ks, nw=24)
        eps, d = tddft.dielectric_tda(ks, df, q=1,
                                      omegas=np.linspace(0.0, 2.0, 9))
        uks = KUKS(cell, kpts, xc=xc, with_df=df, verbose=0)
        uks.mo_coeff = np.stack([ks.mo_coeff] * 2)
        uks.mo_energy = np.stack([ks.mo_energy] * 2)
        uks.mo_occ = np.stack([ks.mo_occ] * 2) * 0.5
        uks.dm = np.stack([ks.dm] * 2) * 0.5
        rec[xc].update(
            tda_s_q0=w0.tolist(),
            tda_t_q0=tddft.tda(ks, df, q=0, nroots=0, singlet=False,
                               dense=True)[0].tolist(),
            osc=tddft.oscillator_strengths(ks, w0, np.asarray(info0["x"])
                                           ).tolist(),
            eps=_c(eps), e_qp=e_qp.tolist(), sigma=_c(info["sigma_iw"]),
            correction=np.asarray(info["correction"]).tolist(),
            bse_qp=bse.bse(ks, df, nroots=0, dense=True,
                           qp_energy=e_qp)[0].tolist(),
            utda=tddft.utda(uks, df, q=1, nroots=0,
                            dense=True)[0].tolist(),
            tddft=tddft.tddft(ks, df, q=0, nroots=4)[0].tolist())
    out["diamond"] = rec
    fmesh = tuple(int(m) for m in cell.mesh)
    out["hvp"] = {"fmesh": list(fmesh), **_hvp_probes(
        fmesh, cell.get_Gv(fmesh), float(cell.vol) / int(np.prod(fmesh)))}
    refs["many_body"] = out


def _with_orbitals(mf, rec):
    """A JAX SCF object given a recorded reference's orbitals, density and
    the energy of that density."""
    from fftisdf_tpu.scf.hf import _build_dm

    mf.mo_coeff = (np.asarray(rec["mo_coeff"]["re"])
                   + 1j * np.asarray(rec["mo_coeff"]["im"])).reshape(
                       rec["mo_coeff"]["shape"])
    mf.mo_energy = np.asarray(rec["mo_energy"])
    mf.mo_occ = np.asarray(rec["mo_occ"])
    mf.dm = (np.stack([np.asarray(_build_dm(mf.mo_coeff[s], mf.mo_occ[s]))
                       for s in range(2)]) if mf.mo_coeff.ndim == 4
             else np.asarray(_build_dm(mf.mo_coeff, mf.mo_occ)))
    _, vj, vk = mf.get_fock(mf.dm)
    mf.e_tot = float(mf.energy_elec(mf.dm, vj, vk) + mf.e_nuc)
    return mf


def _cplx(a):
    return [[float(np.real(x)), float(np.imag(x))] for x in np.ravel(a)]


def packed_inputs():
    """The seeded random inputs of tests/test_cc.py::test_packed_equations_
    match_reference: (t1, t2 packed, f blocks, U, kp3) at nk 2, o 2, v 2."""
    rng = np.random.default_rng(31)
    nk, no, nv = 2, 2, 2
    n = no + nv
    U = (rng.standard_normal((nk, nk, nk, n, n, n, n))
         + 1j * rng.standard_normal((nk, nk, nk, n, n, n, n))) * 0.1
    kp3 = np.array([[[(a + b - c) % nk for c in range(nk)]
                     for b in range(nk)] for a in range(nk)], dtype=np.int64)
    t1 = 0.1 * (rng.standard_normal((nk, no, nv))
                + 1j * rng.standard_normal((nk, no, nv)))
    t2 = np.zeros((nk, nk, nk, no, no, nv, nv), dtype=complex)
    for a in range(nk):
        for b in range(nk):
            for c in range(nk):
                t2[a, b, c] = 0.1 * (
                    rng.standard_normal((no, no, nv, nv))
                    + 1j * rng.standard_normal((no, no, nv, nv)))
    f = tuple(np.stack([rng.standard_normal(sh)
                        + 1j * rng.standard_normal(sh) for _ in range(nk)])
              for sh in ((no, no), (no, nv), (nv, no), (nv, nv)))
    return t1, t2, f, U, kp3


def solver_integrals(n=4, seed=43):
    """The random embedding problem of tests/test_dmet.py::test_ccsd_solver_
    vs_fci: complex Hermitian h1 with a sorted diagonal and (pq|rs) with
    the physical symmetries."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = h + h.conj().T
    np.fill_diagonal(h, np.sort(rng.standard_normal(n)) * 2 - 1)
    a = 0.15 * (rng.standard_normal((n,) * 4)
                + 1j * rng.standard_normal((n,) * 4))
    a = a + a.transpose(2, 3, 0, 1)
    return h, a + a.transpose(1, 0, 3, 2).conj()


DMET_CASES = (("h2_gamma", (0, 1, 2, 3), ("fci",)),
              ("h2_k2", (0, 1), ("fci", "fci_mu", "ccsd", "ccsd_mu")),
              ("h2_k2", (2, 3), ("fci",)),
              ("diamond", (0,), ("fci", "fci_mu", "ccsd", "ccsd_mu")),
              ("diamond", (0, 1, 2, 3), ("fci", "fci_mu", "ccsd",
                                         "ccsd_mu")))


def f32_density(nao, nk=2):
    """The density of tests/test_f32_regime.py (test_torch_f32_regime.py's
    ``diamond`` fixture)."""
    rng = np.random.default_rng(0)
    dm = rng.standard_normal((nk, nao, nao)) * 0.1 + np.eye(nao)[None]
    return (dm + dm.transpose(0, 2, 1)).astype(np.complex128)


OMEGA_HE2 = dict(a=np.diag([5.0, 5.0, 7.0]),
                 atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
                 basis="sto-3g", pseudo=None, mesh=np.array([15, 15, 21]),
                 unit="bohr", precision=1e-12)


def omega_density(cell, kpts, nao, seed=0):
    """test_torch_omega_trunc.py::trs_dm: a random hermitian density with
    dm[-k] = conj(dm[k])."""
    from fftisdf_tpu.lattice import kpoints as kpt_mod

    rng = np.random.default_rng(seed)
    nk = len(kpts)
    s = cell.get_scaled_kpts(kpts)
    dm = rng.standard_normal((nk, nao, nao)) \
        + 1j * rng.standard_normal((nk, nao, nao))
    dm = dm + dm.conj().transpose(0, 2, 1)
    for k in range(nk):
        km = kpt_mod.member(-s[k], s)
        if km < k:
            continue
        avg = (dm[k] + dm[km].conj()) / 2
        dm[k], dm[km] = avg, avg.conj()
    return dm


def _jax_sides(refs):
    """The JAX side of four build-parity test groups, recorded: the float32
    build of test_torch_f32_regime.py::test_f32_build_matches_jax_given_
    mask (diamond 1x1x2, c0 20, m0 7^3: its mask and J/K on the test's
    density), the screened serve of test_torch_omega_trunc.py::
    test_compressed_screened_jk (He2 1x1x2, c0 10, m0 9x9x13: its mask
    and J/K at omega = +-0.6), the builds of test_torch_solvers.py::
    test_build_with_eigh_solvers_matches_jax (diamond 1x1x2, c0 10, m0
    7^3, ridge and each eigh-family solver: mask and J/K), and the
    diamond build and exact serve of test_torch_pw.py (c0 10, m0 9^3:
    mask, Madelung constant, overlap, J/K with and without exxdiv='ewald',
    four ERI blocks; PWDF's J/K with exxdiv='ewald')."""
    import jax.numpy as jnp
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.lattice.cell import Cell
    from fftisdf_tpu.utils.device import to_device

    cell, kpts = _diamond()
    dm = f32_density(cell.nao_nr())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        df = FFTISDF(cell, kpts, c0=20.0, m0=(7, 7, 7), verbose=0,
                     dtype=jnp.float32).build()
    vj, vk = df.get_jk(to_device(dm, dtype=jnp.complex64))
    out = {"f32_build": {
        "config": "diamond gth-szv ke 50 1x1x2, float32 build c0 20 m0 7^3;"
                  " J/K on tools/jax_port_refs.py::f32_density",
        "mask": _mask(df), "nip": int(df.nip), "vj": _c(np.asarray(vj)),
        "vk": _c(np.asarray(vk))}}
    cell = Cell(**OMEGA_HE2).build()
    kpts = cell.get_kpts([1, 1, 2])
    dm = omega_density(cell, kpts, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 13), verbose=0).build()
    rec = {"config": "He2 STO-3G 1x1x2 mesh 15x15x21, c0 10 m0 9x9x13; "
                     "J/K on tools/jax_port_refs.py::omega_density",
           "mask": _mask(df)}
    for omega in (0.6, -0.6):
        vj, vk = df.get_jk(dm, omega=omega)
        rec[str(omega)] = {"vj": _c(np.asarray(vj)), "vk": _c(np.asarray(vk))}
    out["omega_he2"] = rec

    cell, kpts = _diamond()
    dm = f32_density(cell.nao_nr())
    rec = {"config": "diamond gth-szv ke 50 1x1x2, c0 10 m0 7^3, each "
                     "solver; J/K on tools/jax_port_refs.py::f32_density"}
    for solver in ("ridge", "lstsq", "pinv", "svd"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            df = FFTISDF(cell, kpts, c0=10.0, m0=(7, 7, 7), verbose=0,
                         solver=solver).build()
        vj, vk = df.get_jk(dm)
        rec[solver] = {"mask": _mask(df), "vj": _c(np.asarray(vj)),
                       "vk": _c(np.asarray(vk))}
    out["solver_builds"] = rec

    from fftisdf_tpu.scf.hf import PWDF

    cell, kpts = _diamond()
    nao = cell.nao_nr()
    dm = pw_density(cell, kpts, nao, seed=2)
    dms = np.stack([dm, pw_density(cell, kpts, nao, seed=7)])
    df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 9), verbose=0).build()
    vj, vk = df.get_jk(dms, exxdiv="ewald")
    rec = {"config": "diamond gth-szv ke 50 1x1x2, c0 10 m0 9^3; densities "
                     "tools/jax_port_refs.py::pw_density seeds 2 and 7",
           "mask": _mask(df), "madelung": float(df.madelung()),
           "ovlp": _c(np.asarray(df.get_ovlp())), "vj_ewald": _c(vj),
           "vk_ewald": _c(vk), "vk": _c(np.asarray(df.get_jk(dms)[1]))}
    for kidx in PW_ERI_KIDX:
        rec[str(list(kidx))] = _c(np.asarray(df.get_eri(kidx)))
    pair = np.stack([dm, dm.conj()])
    vj, vk = PWDF(cell, kpts).get_jk(pair, exxdiv="ewald")
    rec["pwdf_vj"], rec["pwdf_vk"] = _c(vj), _c(vk)
    out["pw_diamond"] = rec
    refs["jax_sides"] = out


PW_ERI_KIDX = ((0, 0, 0, 0), (0, 1, 1, 0), (1, 0, 0, 1), (0, 1, 0, 1))


def pw_density(cell, kpts, nao, seed):
    """test_torch_isdf_kpoint.py::trs_dm(cell, kpts, nao, seed)[0]: a
    random hermitian density with dm[-k] = conj(dm[k])."""
    from fftisdf_tpu.lattice import kpoints as kpt_mod

    rng = np.random.default_rng(seed)
    nk = len(kpts)
    s = cell.get_scaled_kpts(kpts)
    dm = rng.standard_normal((1, nk, nao, nao)) \
        + 1j * rng.standard_normal((1, nk, nao, nao))
    dm = dm + dm.conj().transpose(0, 1, 3, 2)
    for k in range(nk):
        km = kpt_mod.member(-s[k], s)
        if km < k:
            continue
        avg = (dm[:, k] + dm[:, km].conj()) / 2
        dm[:, k] = avg
        dm[:, km] = avg.conj()
    return dm[0]


# kccsd's conv_tol a fixture: diamond 1x1x2's amplitude rms stalls near
# 1e-7 in both packages (DIIS on a flat residual), so it is held where
# both converge, at the same cycle
CC_TOL = {"h2_gamma": 1e-10, "h2_k2": 1e-9, "diamond": 1e-6}


def _correlated(refs):
    """FCI, DMET and the CC layer (scf.fci, scf.dmet, scf.cc) on the
    many_body section's H2 chain inputs (its interpolation points and
    real-gauge orbitals, read from the record) and on diamond gth-szv ke 50
    1x1x2 (c0 40, m0 9^3; its KRHF orbitals recorded here in a real
    gauge), plus the seeded random inputs of the JAX tests."""
    import jax.numpy as jnp
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.lattice.cell import Cell, Shell
    from fftisdf_tpu.scf import KRHF, KUHF
    from fftisdf_tpu.scf import cc, dmet
    from fftisdf_tpu.scf.ks import KRKS

    mb = refs["many_body"]
    out = {"config": "H2 chain of tests/test_cc.py on many_body's points "
                     "and orbitals (c0 60, m0 11x11x13); diamond gth-szv ke "
                     "50 1x1x2 c0 40 m0 9^3 KRHF conv_tol 1e-10 (orbitals "
                     "in a real gauge); kccsd max_cycle 80, conv_tol 1e-9 "
                     "(h2_gamma 1e-10, diamond 1e-6); EOM conv_tol 1e-10 (Davidson tol "
                     "1e-8); dmet tol 1e-7; complex values as [re, im]"}
    cell = h2_chain(Cell, Shell)
    states = {}
    for key, kpts in (("h2_gamma", np.zeros((1, 3))),
                      ("h2_k2", cell.get_kpts([1, 1, 2]))):
        df = FFTISDF(cell, kpts, c0=60.0, m0=(11, 11, 13), verbose=0,
                     select_tol=1e-18, rcond=1e-12).build()
        assert _mask(df) == mb[key]["mask"], "the H2 selection moved"
        states[key] = (df, _with_orbitals(KRHF(cell, kpts, with_df=df,
                                               verbose=0), mb[key]["krhf"]))
    dcell, dkpts = _diamond()
    df = FFTISDF(dcell, dkpts, c0=40.0, m0=(9, 9, 9), verbose=0).build()
    assert _mask(df) == mb["diamond"]["mask"], "the diamond selection moved"
    mf = KRHF(dcell, dkpts, with_df=df, verbose=0, conv_tol=1e-10)
    mf.kernel()
    _real_gauge(mf)
    _, vj, vk = mf.get_fock(mf.dm)
    mf.e_tot = float(mf.energy_elec(mf.dm, vj, vk) + mf.e_nuc)
    states["diamond"] = (df, mf)
    out["diamond"] = {"mask": _mask(df), "krhf": _orbitals(mf)}

    for key, (df, mf) in states.items():
        rec = out.setdefault(key, {})
        rec["e_tot"] = mf.e_tot
        tol = CC_TOL[key]
        e, info = cc.kccsd(df, mf, conv_tol=tol, max_cycle=80)
        rec["kccsd"] = {"e": e, "niter": info["niter"],
                        "converged": info["converged"]}
        if key != "h2_gamma":
            e_cc, e_t, info = cc.kccsd_t(df, mf, conv_tol=tol,
                                         max_cycle=80)
            rec["kccsd_t"] = {"e_ccsd": e_cc, "e_t": e_t,
                              "imag_t": info["imag_t"]}
        if key == "diamond":
            continue
        rec["eomee"] = _cplx(cc.eomee(df, mf, conv_tol=1e-10)[0])
        for name, fn in (("eomip", cc.eomip), ("eomea", cc.eomea)):
            w, _ = fn(df, mf, conv_tol=1e-10)
            rec[name] = [_cplx(w[k]) for k in sorted(w)]
    df, mf = states["h2_gamma"]
    w, info = cc.eomee_davidson(df, mf, nroots=4, conv_tol=1e-10, tol=1e-8)
    out["h2_gamma"]["eomee_davidson"] = _cplx(w)
    ks = _with_orbitals(KRKS(cell, np.zeros((1, 3)), xc="pbe", with_df=df,
                             verbose=0), mb["h2_gamma"]["krks_pbe"])
    e, info = cc.kccsd(df, ks, conv_tol=1e-10, max_cycle=120)
    fock, vj, vk = mf.get_fock(ks.dm)
    out["h2_gamma"]["kccsd_pbe_ref"] = {
        "e": e, "reference": info["reference"],
        "e_det": float(mf.energy_elec(np.asarray(ks.dm), vj, vk) + mf.e_nuc)}

    df, mf = states["h2_k2"]
    gam, info = cc.onerdm(df, mf, conv_tol=1e-9)
    out["h2_k2"]["onerdm"] = {n: _c(np.stack([np.asarray(g) for g in blk]))
                              for n, blk in zip(("goo", "gov", "gvo", "gvv"),
                                                gam)}
    out["h2_k2"]["onerdm_trace"] = info["trace"]
    out["h2_k2"]["ao_density"] = _c(cc.ao_density(df, mf, conv_tol=1e-9)[0])
    umf = _with_orbitals(KUHF(cell.copy(spin=2).build(), df.kpts,
                              with_df=df, verbose=0),
                         mb["h2_k2"]["kuhf_spin2"])
    out["h2_k2"]["kccsd_spin2"] = cc.kccsd(df, umf, conv_tol=1e-8,
                                           max_cycle=80)[0]

    dm_recs = {}
    for key, frag, kinds in DMET_CASES:
        df, mf = states[key]
        for kind in kinds:
            solver = cc.ccsd_solver if kind.startswith("ccsd") else None
            e, info = dmet.dmet_energy(mf, df, frag_ao=list(frag),
                                       solver=solver,
                                       fit_mu=kind.endswith("_mu"))
            dm_recs[f"{key} {list(frag)} {kind}"] = {
                "e": e, "de_corr": info["de_corr"],
                "nbath": int(info["nbath"]), "nemb": int(info["nemb"]),
                "mu": float(info.get("mu", 0.0)),
                "nfrag_err": float(info.get("nfrag_err", 0.0))}
            print(key, frag, kind, e, flush=True)
    out["dmet"] = dm_recs

    t1, t2, f, U, kp3 = packed_inputs()
    nk = t1.shape[0]
    r1, r2, e = cc._equations_packed(nk, 2, 2, kp3)(
        jnp.asarray(t1),
        {(a, b, c): jnp.asarray(t2[a, b, c]) for a in range(nk)
         for b in range(nk) for c in range(nk)},
        tuple([jnp.asarray(x) for x in blk] for blk in f), jnp.asarray(U))
    out["packed"] = {"r1": _c(np.stack([np.asarray(x) for x in r1])),
                     "r2": _c(np.stack([np.asarray(r2[a, b, c])
                                        for a in range(nk)
                                        for b in range(nk)
                                        for c in range(nk)])),
                     "e": [float(np.real(e)), float(np.imag(e))]}
    h, eri = solver_integrals()
    out["ccsd_solver"] = {}
    for ne in (2, 4):
        e, g, G = cc.ccsd_solver(h, eri, ne)
        out["ccsd_solver"][str(ne)] = {"e": e, "gamma": _c(g),
                                       "Gamma": _c(G)}
    refs["correlated"] = out


def _scf_record(mf):
    """A converged SCF's density and orbitals (the inputs of W_k)."""
    return {"dm": _c(mf.dm), "mo_coeff": _c(mf.mo_coeff),
            "mo_energy": np.asarray(mf.mo_energy).tolist(),
            "mo_occ": np.asarray(mf.mo_occ).tolist(),
            "e_tot": float(mf.e_tot)}


def _derivatives(refs):
    """The derivative layer (isdf.autodiff, scf.grad/stress/optimize/
    hessian/md/phonon/elastic/eos) on the fixtures of the JAX package's
    derivative tests (tests/torch_deriv_fixtures.py): the Lagrangian value,
    forces and stress of each case at the JAX package's converged density
    and mask, the ERI gradient of test_autodiff.py, and every driver's
    result."""
    import jax
    import jax.numpy as jnp
    import torch_deriv_fixtures as fx
    from fftisdf_tpu.isdf import FFTISDF
    from fftisdf_tpu.isdf.autodiff import eri_grad_fn
    from fftisdf_tpu.lattice import kpoints as kpt_mod
    from fftisdf_tpu.lattice.cell import Cell, Shell
    from fftisdf_tpu.scf import KRHF, KUHF
    from fftisdf_tpu.scf import elastic, eos, md, phonon
    from fftisdf_tpu.scf import grad as scf_grad
    from fftisdf_tpu.scf import hessian as scf_hess
    from fftisdf_tpu.scf import optimize as scf_opt
    from fftisdf_tpu.scf import stress as scf_stress
    from fftisdf_tpu.scf.ks import KRKS, KUKS

    out = {}
    classes = {"KRHF": KRHF, "KUHF": KUHF, "KRKS": KRKS, "KUKS": KUKS}
    cell = fx.he2_strain(Cell, Shell)
    kpts = cell.get_kpts([1, 1, 2])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        df = FFTISDF(cell, kpts, verbose=0, **fx.ISDF_BUILD).build()
    out["isdf_mask"] = _mask(df)
    cases = {}
    for name, cls, kw, backend in fx.CASES:
        # the JAX package's jit caches key the xc pass on the functional:
        # a cached LDA trace met by an LDA+U case fails its static-argument
        # comparison, so each case starts from empty caches
        jax.clear_caches()
        isdf = backend == "isdf"
        mf = classes[cls](cell, kpts, with_df=df if isdf else None,
                          verbose=0, conv_tol=1e-10, **kw)
        mf.kernel()
        assert mf.converged, name
        rec = _scf_record(mf)
        g, val = scf_grad.kernel(mf, two_electron=backend,
                                 df=df if isdf else None)
        rec.update(grad=np.asarray(g).tolist(), value=float(val))
        if name not in fx.NO_STRESS:
            sigma, p, sval = scf_stress.kernel(
                mf, two_electron=backend, df=df if isdf else None)
            rec.update(sigma=np.asarray(sigma).tolist(), pressure=float(p),
                       stress_value=float(sval))
        cases[name] = rec
        print(name, val, flush=True)
    out["cases"] = cases

    # the ISDF ERI gradient of test_autodiff.py (1x1x2: self-conjugate
    # sectors; 1x1x3: a mirror pair)
    cell = fx.he2_probe(Cell, Shell)
    pos = np.asarray(cell.atom_coords())
    eri = {}
    for km in ((1, 1, 2), (1, 1, 3)):
        kp = cell.get_kpts(list(km))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dfp = FFTISDF(cell, kp, c0=12.0, m0=(7, 7, 9), verbose=0).build()
        nao = dfp.x_k.shape[2]
        rng = np.random.default_rng(0)
        probe = (rng.standard_normal((nao,) * 4)
                 + 1j * rng.standard_normal((nao,) * 4))
        k2c = kpt_mod.get_kconserv2(cell, kp)
        # momentum-conserving blocks: sector 1, and at 1x1x3 the mirror
        # sector 2 (a block that breaks momentum conservation reads the
        # fit's near-null directions, eps/rcond noise in either package)
        kidx = (0, 1, 1, 0) if km[2] == 2 else (0, 2, 2, 0)
        val, g = eri_grad_fn(cell, kp, dfp.mask, kidx, k2c, m0=dfp.m0)(
            jnp.asarray(pos), jnp.asarray(probe))
        eri["x".join(map(str, km))] = {
            "mask": _mask(dfp), "m0": [int(m) for m in dfp.m0],
            "kidx": list(kidx), "value": float(val),
            "grad": np.asarray(g).tolist()}
    out["eri_grad"] = eri

    # the drivers, on SCFs without DIIS (diis_space=1): the JAX package
    # builds W from the orbitals of its last DIIS-extrapolated Fock, which
    # at a warm start mixes in the previous geometry's Fock (an O(1e-4)
    # force error, ROADMAP section 3); without DIIS its orbitals are those
    # of the converged density, as the port's W always is
    drv = {}
    c = fx.h2(Cell, Shell, d=2.0)
    r = scf_opt.kernel(KRHF(c, c.get_kpts([1, 1, 1]), verbose=0,
                            conv_tol=1e-10, diis_space=1),
                       fmax=5e-4, max_steps=15)
    drv["opt_h2_rhf"] = {"converged": bool(r.converged),
                         "nsteps": r.nsteps, "energy": float(r.energy),
                         "positions": np.asarray(r.positions).tolist(),
                         "energies": [float(e) for _, e, _ in r.trajectory]}
    c = fx.lih(Cell, Shell, 6.8)
    r = scf_opt.relax_cell(KRHF(c, c.get_kpts([1, 1, 1]), verbose=0,
                                conv_tol=1e-10, diis_space=1),
                           smax=1e-9, max_steps=1, relax_atoms=False,
                           re_anchor=0.5)
    drv["relax_cell_lih"] = {"energies": [float(e) for e, _, _ in
                                          r.trajectory],
                             "a": np.asarray(r.cell.a).tolist()}
    c = fx.h2(Cell, Shell, d=1.30, mesh=14)
    mf = KRHF(c, c.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-11,
              diis_space=1)
    mf.kernel()
    h, g0 = scf_hess.kernel(mf, step=1.5e-3)
    wav, _ = scf_hess.frequencies(c, h)
    drv["hessian_h2"] = {"hess": np.asarray(h).tolist(),
                         "g0": np.asarray(g0).tolist(),
                         "freqs": np.asarray(wav).tolist()}
    dfh = FFTISDF(c, mf.kpts, c0=40.0, verbose=0).build()
    h_is, _ = scf_hess.kernel(mf, step=1.5e-3, two_electron="isdf", df=dfh)
    drv["hessian_h2_isdf"] = {"hess": np.asarray(h_is).tolist(),
                              "mask": _mask(dfh),
                              "m0": [int(m) for m in dfh.m0]}
    c = fx.h2(Cell, Shell, d=1.4)
    mk = lambda: KRHF(c, c.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-10,
                      diis_space=1)
    r = md.kernel(mk(), dt_fs=0.3, nsteps=3, temperature=300.0, seed=0)
    drv["md_nve"] = {"energies": r.energies.tolist(),
                     "positions": np.asarray(r.positions).tolist()}
    r = md.kernel(mk(), dt_fs=1.0, nsteps=2, temperature=600.0,
                  thermostat="langevin", friction_fs=2.0,
                  velocities0=np.zeros((2, 3)), seed=1)
    drv["md_langevin"] = {"e_kin": [rec["e_kin"] for rec in r.trajectory]}
    r = md.kernel(mk(), dt_fs=0.5, nsteps=2, temperature=300.0,
                  thermostat="csvr", tau_fs=1.0, seed=2)
    drv["md_csvr"] = {"temps": r.temperatures.tolist()}
    c = fx.lih(Cell, Shell, 6.5)
    r = md.npt_kernel(KRHF(c, c.get_kpts([1, 1, 1]), verbose=0,
                           conv_tol=1e-10, diis_space=1),
                      dt_fs=1.0, nsteps=2, pressure_gpa=0.0, taup_fs=5.0,
                      compressibility_au=1.0)
    drv["npt_lih"] = {"volumes": r.volumes.tolist(),
                      "pressures": [rec["pressure_au"]
                                    for rec in r.trajectory]}
    c = fx.he_chain(Cell, Shell)
    res = phonon.kernel(KRHF(c, c.get_kpts([1, 1, 1]), verbose=0,
                             conv_tol=1e-11, diis_space=1), (1, 1, 2),
                        step=2e-3, asr=False)
    drv["phonon_he_chain"] = {
        "fc": np.asarray(res.fc).tolist(),
        "freqs": res.frequencies(c.get_kpts([1, 1, 2])).tolist(),
        "e_sc": float(res.e_sc)}
    c = fx.he_sc(Cell, Shell)
    mf = KRHF(c, c.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-11,
              diis_space=1)
    mf.kernel()
    r = elastic.kernel(mf, step=3e-3, components=(0, 1))
    drv["elastic_he_sc"] = {"c01": np.asarray(r.c[:, :2]).tolist(),
                            "sigma0": np.asarray(r.sigma0).tolist(),
                            "e0": float(r.e0)}
    r = eos.kernel(mf, scales=np.linspace(0.97, 1.03, 5))
    drv["eos_he_sc"] = {"energies": r.energies.tolist(),
                        "pressures": r.pressures.tolist(),
                        "v0": float(r.fit["v0"]), "b0": float(r.fit["b0"]),
                        "bp": float(r.fit["bp"])}
    out["drivers"] = drv
    out["config"] = (
        "tests/torch_deriv_fixtures.py: CASES on he2_strain 1x1x2 "
        "(conv_tol 1e-10; ISDF c0 20 m0 11^3), eri_grad on he2_probe "
        "(c0 12 m0 7x7x9), and the drivers of the JAX derivative tests")
    refs["derivatives"] = out


if __name__ == "__main__":
    main()
