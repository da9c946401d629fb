"""Phonon dispersion and elastic constants.

Frozen-phonon force constants on a supercell (``scf.phonon``: home-cell
displacements, the analytic force response on every supercell atom),
harmonic thermodynamics on a q-sample, and the Voigt elastic tensor by
central differences of the analytic stress (``scf.elastic``); ``--qha``
runs the quasi-harmonic thermal expansion of an H2 chain instead
(``scf.eos``).  The port of the JAX package's
``examples/phonon_elastic.py``, with ``--device``/``--dtype`` in place of
``--tpu``.

    python -m fftisdf_tpu_torch.examples.phonon_elastic [--nrep 2]
        [--mesh 12] [--temp 300] [--qha] [--device cpu]
"""
import argparse
import time

import numpy as np

from fftisdf_tpu_torch.examples import _common

_F = r"-?\d+\.\d+"
RESULTS = {
    "e_sc": r"^\[phonon\] supercell .* E_sc = (\S+) Ha",
    "branches": rf"^  q = \d\.\d\d \* b3 :((?: +{_F})+) +cm\^-1",
    "zpe": r"^\[thermo\] .*ZPE=(\S+) mHa",
    "f_vib": r"^\[thermo\] .*F_vib=(\S+) mHa",
    "cv": r"^\[thermo\] .*Cv/kB=(\S+)$",
    "elastic": r"^  C11 = \s*(\S+) GPa   C12 = \s*(\S+) GPa   "
               r"C44 = \s*(\S+) GPa",
    "sigma0": r"^  sigma0 diag \(GPa\):((?: +\S+)+)$",
    "qha_gammas": r"^  mode gammas \(optical\):((?: +\S+)+)$",
    "qha_v0": r"^  T=\s*\S+ K  V0=\s*(\S+) bohr",
    "qha_b0": r"^  T=.*B0=\s*(\S+) GPa",
}
# Energies to 1e-8 relative; the printed branches and thermodynamics to
# two printed units; the elastic constants, finite differences of the
# stress of warm-started strained SCFs (where the JAX package's W carries
# the previous strain's DIIS Fock, ROADMAP section 3: C11 -748.734 against
# the port's -748.570 GPa), to 1e-3 relative.
GATES = {"e_sc": (1e-8, 2e-8), "branches": (0, 0.02), "zpe": (0, 2e-3),
         "f_vib": (0, 2e-3), "cv": (0, 2e-3), "elastic": (1e-3, 0),
         "sigma0": (0, 2e-3)}


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.phonon_elastic",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--mesh", type=int, default=12,
                   help="transverse FFT mesh")
    p.add_argument("--a", type=float, default=2.2,
                   help="chain spacing, bohr")
    p.add_argument("--box", type=float, default=7.0)
    p.add_argument("--nrep", type=int, default=2,
                   help="supercell along z")
    p.add_argument("--temp", type=float, default=300.0)
    p.add_argument("--qha", action="store_true",
                   help="quasi-harmonic thermal expansion of an H2 "
                        "molecular chain (E(V) scan + Gamma phonons per "
                        "volume + F(V,T) minimization + Grueneisen)")
    _common.add_device_args(p)
    return p


def _f_vib(w_ha, t, kb, floor):
    w = w_ha[w_ha > floor]
    if t <= 0.0:
        return w.sum() / 2.0
    return (w / 2.0 + kb * t * np.log1p(-np.exp(-w / (kb * t)))).sum()


def run_qha(args, dev, dtype, out):
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRHF, eos, phonon
    from fftisdf_tpu_torch.scf.hessian import HARTREE_TO_CM1

    # GTH H2 chain with the bond tuned so p = 0 falls inside the scan
    axy, az, dz = 6.0, 4.5, 0.54
    cell = structure.to_cell(
        np.diag([axy, axy, az]),
        [("H", np.array([axy / 2, axy / 2, az / 2 - dz])),
         ("H", np.array([axy / 2, axy / 2, az / 2 + dz]))],
        basis="gth-szv", pseudo="gth-pade", ke_cutoff=30.0)
    mf = KRHF(cell, cell.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-11,
              dtype=dtype, device=dev)
    mf.kernel()
    t0 = time.time()
    res_q = eos.qha_kernel(mf, [0.0, args.temp],
                           scales=np.linspace(0.94, 1.06, 5),
                           nrep=(1, 1, 1), step=2e-3)
    out(f"[qha] 5-volume scan + Gamma phonons in {time.time()-t0:.1f} s")
    g = np.asarray(res_q["gamma"][0])
    mask = np.asarray(res_q["gamma_mask"])
    out("  mode gammas (optical): " +
        " ".join(f"{x:7.3f}" for x in g[mask[0]]))

    # this stiff toy's optical modes are frozen at room temperature, so
    # also report at kT = hbar*w_min, recomputed from the recorded spectra
    freqs, res = np.asarray(res_q["freqs_cm"]), res_q["eos"]
    kb = phonon.KB_HA
    w_ha = np.clip(freqs, 0.0, None) / HARTREE_TO_CM1
    t1 = freqs[:, mask].min() / HARTREE_TO_CM1 / kb
    # qha's central differences assume strictly increasing temperatures
    ts = sorted({0.0, float(args.temp), 0.7 * t1, t1, 1.3 * t1})
    floor = 1.0 / HARTREE_TO_CM1   # drop ASR/noise residue modes
    fv = np.array([[_f_vib(w_ha[iv], t, kb, floor) / w_ha.shape[1]
                    for iv in range(res.volumes.size)] for t in ts])
    ref = eos.qha(res.volumes, res.energies, fv, np.asarray(ts))
    for i, t in enumerate(ts):
        ag = (eos.gruneisen(res.volumes, freqs, temperature=float(t),
                            b0=ref["b0"][i], v0=ref["v0"][i])["alpha_v"]
              if t > 0 else float("nan"))
        out(f"  T={t:7.1f} K  V0={ref['v0'][i]:9.4f} bohr^3  "
            f"B0={ref['b0_gpa'][i]:8.3f} GPa  "
            f"alpha_V(FD)={ref['alpha_v'][i]:11.4e}  "
            f"alpha_V(Grueneisen)={ag:11.4e} 1/K")

    # cross-gate: at T = 700 K on the crossing-free first 4 volumes the two
    # thermal-expansion routes must agree in sign and decade
    vols4, e4, f4 = res.volumes[:4], res.energies[:4], freqs[:4]
    w4 = np.clip(f4, 0.0, None) / HARTREE_TO_CM1
    tg = np.array([560.0, 700.0, 840.0])
    fv4 = np.array([[_f_vib(w4[iv], t, kb, floor) / w4.shape[1]
                     for iv in range(vols4.size)] for t in tg])
    rg = eos.qha(vols4, e4, fv4, tg)
    a_fd = rg["alpha_v"][1]
    a_gr = eos.gruneisen(vols4, f4, temperature=700.0, b0=rg["b0"][1],
                         v0=rg["v0"][1])["alpha_v"]
    if not (a_fd > 1e-6 and a_gr > 1e-6 and 0.1 < a_gr / a_fd < 10.0):
        raise RuntimeError(f"thermal expansion routes disagree: {a_fd}, "
                           f"{a_gr}")
    out(f"  [cross-gate] T=700 K: alpha_FD={a_fd:.3e} "
        f"alpha_Grueneisen={a_gr:.3e} 1/K — sign+decade agreement OK")
    return dict(qha=res_q)


def run(args, masks=None, out=print):
    dev, dtype = _common.setup(args)
    if args.qha:
        return run_qha(args, dev, dtype, out)

    from fftisdf_tpu_torch.lattice.cell import Cell, Shell
    from fftisdf_tpu_torch.scf import KRHF, elastic, phonon

    shells = [Shell(l=0, exps=np.array([2.5, 0.7]),
                    coeffs=np.array([[0.6], [0.5]]))]
    b, az = args.box, args.a
    mz = max(6, int(round(args.mesh * az / b)) // 2 * 2)
    cell = Cell(a=np.diag([b, b, az]),
                atom=[("He", np.array([b / 2, b / 2, 0.0]))],
                basis={"He": shells}, pseudo=None,
                mesh=np.array([args.mesh, args.mesh, mz]),
                unit="bohr", precision=1e-12).build()
    mf = KRHF(cell, cell.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-11,
              dtype=dtype, device=dev)

    t0 = time.time()
    nrep = (1, 1, args.nrep)
    res = phonon.kernel(mf, nrep, step=2e-3)
    out(f"[phonon] supercell {nrep} SCF+FC in {time.time()-t0:.1f} s, "
        f"E_sc = {res.e_sc:.8f} Ha")
    qline = np.linspace(0.0, 0.5, 6)[:, None] * \
        cell.reciprocal_vectors()[2][None, :]
    w = res.frequencies(qline)
    for frac, wq in zip(np.linspace(0.0, 0.5, 6), w):
        out(f"  q = {frac:4.2f} * b3 : " +
            " ".join(f"{x:9.2f}" for x in wq) + "  cm^-1")
    try:
        th = res.thermodynamics((1, 1, 8), args.temp)
    except ValueError:
        # a free-standing chain buckles: the transverse branches are
        # imaginary; report the stable longitudinal subspace instead
        out("[thermo] transverse branches imaginary (free-standing "
            "chain buckles) - longitudinal subspace only:")
        fc_l = res.fc[:, 2:, :, :, 2:]
        th = phonon.thermodynamics(fc_l, res.masses_me, res.images,
                                   cell, (1, 1, 8), args.temp)
    out(f"[thermo] T={args.temp:.0f} K  ZPE={th['zpe']*1e3:.3f} mHa  "
        f"F_vib={th['f_vib']*1e3:.3f} mHa  Cv/kB="
        f"{th['cv']/phonon.KB_HA:.3f}")

    # elastic constants of the simple-cubic He crystal
    a0 = 4.0
    cub = Cell(a=np.diag([a0] * 3), atom=[("He", np.zeros(3))],
               basis={"He": shells}, pseudo=None,
               mesh=np.array([10, 10, 10]), unit="bohr",
               precision=1e-12).build()
    mfc = KRHF(cub, cub.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-11,
               dtype=dtype, device=dev)
    mfc.kernel()
    t0 = time.time()
    er = elastic.kernel(mfc, step=3e-3, components=(0, 3))
    out(f"[elastic] 2 Voigt components in {time.time()-t0:.1f} s")
    cg = er.c_gpa
    out(f"  C11 = {cg[0, 0]:9.3f} GPa   C12 = {cg[1, 0]:9.3f} GPa   "
        f"C44 = {cg[3, 3]:9.3f} GPa")
    out("  sigma0 diag (GPa): " +
        " ".join(f"{x*elastic.HA_PER_BOHR3_TO_GPA:8.3f}"
                 for x in np.diag(er.sigma0)))
    return dict(phonon=res, thermo=th, elastic=er)


def check(numbers):
    """Finite numbers everywhere, and the acoustic branches at q = 0 at
    zero (the acoustic sum rule); the QHA run checks its two
    thermal-expansion routes itself."""
    vals = [v for k in ("branches", "zpe", "elastic", "sigma0")
            for v in numbers.get(k, [])]
    br = numbers.get("branches", [])
    bad = [] if np.isfinite(vals).all() else ["a number is not finite"]
    if br and max(abs(x) for x in br[:3]) > 1.0:
        bad.append("acoustic branches at q = 0 off zero")
    return bad


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
