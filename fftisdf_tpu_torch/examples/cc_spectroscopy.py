"""Coupled-cluster spectroscopy on the ISDF factorization.

Runs the correlated stack on a periodic hydrogen chain: KRHF -> FFTISDF ->
CCSD -> (T) -> EOM-EE optical excitations -> k-resolved EOM-IP/EA
quasiparticle energies and the correlated fundamental gap against the
Koopmans values, and G0W0 beside them, all served from one (x_k, w_q)
state.  The port of the JAX package's ``examples/cc_spectroscopy.py``,
with ``--device``/``--dtype`` in place of ``--tpu``.

    python -m fftisdf_tpu_torch.examples.cc_spectroscopy [--nk 2]
        [--c0 60] [--device cpu]
"""
import argparse
import time

import numpy as np

from fftisdf_tpu_torch.examples import _common

_QP = r"[+-]\d+\.\d{4}"
RESULTS = {
    "e_hf": r"^KRHF      E = (\S+) Ha",
    "hf_converged": r"^KRHF .*conv=(\w+),",
    "nip": r"^ISDF build: nip=(\d+)",
    "e_ccsd": r"^CCSD      Ecorr = (\S+) Ha/cell",
    "e_t": r"^\(T\)       Ecorr = (\S+) Ha/cell",
    "e_ccsd_t": r"^CCSD\(T\)   E = (\S+) Ha/cell",
    "eom_ee": r"^EOM-EE .*lowest: \[(.*)\] Ha",
    "ip_ea": rf"^  k\d+:  IP = ({_QP}) \(Koopmans ({_QP})\)   EA = ({_QP}) "
             rf"\(Koopmans ({_QP})\)",
    "cc_gap": r"^correlated fundamental gap  IP\+EA = (\S+) Ha",
    "gw": rf"^  k\d+:  HOMO = ({_QP}) \(Z=(\S+)\)   LUMO = ({_QP}) "
          r"\(Z=(\S+)\)",
    "gw_gap": r"^G0W0 fundamental gap = (\S+) Ha",
}
# KRHF is exact (no ISDF): 1e-8 relative; the correlated numbers on the
# recorded points to 1e-6 Ha or two printed units
GATES = {"e_hf": (1e-8, 2e-8), "hf_converged": (0, 0), "nip": (0, 0),
         "e_ccsd": (0, 1e-6), "e_t": (0, 1e-6), "e_ccsd_t": (0, 1e-6),
         "eom_ee": (0, 2e-4), "ip_ea": (0, 2e-4), "cc_gap": (0, 2e-4),
         "gw": (0, 2e-2), "gw_gap": (0, 2e-4)}


def h2_chain(nk, Cell, Shell):
    """The H2 chain of the CC tests, nk cells along z."""
    cell = Cell(
        a=np.diag([6.0, 6.0, 7.0]),
        atom=[("H", (3.0, 3.0, 1.8)), ("H", (3.0, 3.0, 3.2))],
        basis={"H": [Shell(l=0, exps=np.array([1.2, 0.4]),
                           coeffs=np.eye(2))]},
        pseudo="gth-pade",
        mesh=np.array([14, 14, 15]),
        unit="bohr",
        precision=1e-12,
    ).build()
    return cell, cell.get_kpts([1, 1, nk])


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.cc_spectroscopy",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--nk", type=int, default=2, help="k-points along z")
    p.add_argument("--c0", type=float, default=60.0)
    _common.add_device_args(p)
    return p


def run(args, masks=None, out=print):
    dev, dtype = _common.setup(args)

    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice.cell import Cell, Shell
    from fftisdf_tpu_torch.scf import KRHF, cc
    from fftisdf_tpu_torch.scf.gw import g0w0

    cell, kpts = h2_chain(args.nk, Cell, Shell)

    t0 = time.perf_counter()
    mf = KRHF(cell, kpts, verbose=0, conv_tol=1e-10, dtype=dtype,
              device=dev)
    mf.kernel()
    out(f"KRHF      E = {mf.e_tot:+.8f} Ha   "
        f"(conv={mf.converged}, {time.perf_counter()-t0:.1f}s)")

    t0 = time.perf_counter()
    df = _common.build(FFTISDF(cell, kpts, c0=args.c0, m0=(11, 11, 13),
                               verbose=0, select_tol=1e-18, rcond=1e-12,
                               dtype=dtype, device=dev), masks)
    out(f"ISDF build: nip={df.nip}  ({time.perf_counter()-t0:.1f}s)")

    t0 = time.perf_counter()
    e_cc, e_t, info = cc.kccsd_t(df, mf, conv_tol=1e-9)
    out(f"CCSD      Ecorr = {e_cc:+.8f} Ha/cell "
        f"({info['niter']} cycles, {time.perf_counter()-t0:.1f}s)")
    out(f"(T)       Ecorr = {e_t:+.8f} Ha/cell")
    out(f"CCSD(T)   E = {mf.e_tot + e_cc + e_t:+.8f} Ha/cell")

    t0 = time.perf_counter()
    w_ee, _ = cc.eomee_davidson(df, mf, nroots=3, conv_tol=1e-9)
    w_ee = np.asarray(w_ee)
    out(f"EOM-EE (q=0, Davidson) lowest: "
        f"{np.array2string(w_ee.real, precision=4)} Ha "
        f"({time.perf_counter()-t0:.1f}s)")

    t0 = time.perf_counter()
    w_ip, _ = cc.eomip(df, mf, conv_tol=1e-9)
    w_ea, _ = cc.eomea(df, mf, conv_tol=1e-9)
    out(f"quasiparticles ({time.perf_counter()-t0:.1f}s):")
    homo = lumo = None
    for k in range(len(kpts)):
        ip_k = np.min(np.asarray(w_ip[k]).real)   # valence binding at k
        ea_k = np.min(np.asarray(w_ea[k]).real)   # conduction energy at k
        e_mf = np.asarray(mf.mo_energy)[k]
        out(f"  k{k}:  IP = {ip_k:+.4f} (Koopmans {-e_mf[0]:+.4f})   "
            f"EA = {ea_k:+.4f} (Koopmans {e_mf[1]:+.4f})")
        homo = ip_k if homo is None else min(homo, ip_k)
        lumo = ea_k if lumo is None else min(lumo, ea_k)
    out(f"correlated fundamental gap  IP+EA = {homo + lumo:+.4f} Ha")

    t0 = time.perf_counter()
    e_qp, gw_info = g0w0(df, mf, nw=32)
    e_qp = np.asarray(e_qp)
    out(f"G0W0 quasiparticles ({time.perf_counter()-t0:.1f}s):")
    for k in range(len(kpts)):
        z = np.asarray(gw_info["z"][k])
        out(f"  k{k}:  HOMO = {e_qp[k, 0]:+.4f} (Z={z[0]:.2f})   "
            f"LUMO = {e_qp[k, 1]:+.4f} (Z={z[1]:.2f})")
    gw_gap = e_qp[:, 1].min() - e_qp[:, 0].max()
    out(f"G0W0 fundamental gap = {gw_gap:+.4f} Ha "
        f"(EOM-CC {homo + lumo:+.4f})")
    return dict(cell=cell, kpts=kpts, df=df, mf=mf, e_ccsd=e_cc, e_t=e_t)


def check(numbers):
    """KRHF converged, the correlation energies negative, and both
    fundamental gaps positive."""
    bad = [] if all(numbers.get("hf_converged", [])) else ["hf_converged"]
    if not all(e < 0 for e in numbers.get("e_ccsd", [0.0])):
        bad.append("CCSD correlation energy not negative")
    for key in ("cc_gap", "gw_gap"):
        if not all(g > 0 for g in numbers.get(key, [0.0])):
            bad.append(f"{key} not positive")
    return bad


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
