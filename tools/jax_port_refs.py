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
            "lsthc": lambda r: _lsthc(r), "ks": lambda r: _ks(r),
            "many_body": lambda r: _many_body(r)}


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


if __name__ == "__main__":
    main()
