"""Exciton dispersion of diamond from k-point TDA on the ISDF state.

Converges an ISDF-driven KRHF (or KRKS) on a k-mesh, then solves the TDA
response at every momentum-transfer sector q of the mesh: the lowest
singlet and triplet excitations against exciton momentum, velocity-gauge
oscillator strengths at q = 0 and, with ``--eels``, the macroscopic
dielectric function and the loss function at finite q.  The port of the
JAX package's ``examples/exciton_dispersion.py``, with
``--device``/``--dtype`` in place of ``--tpu``.

    python -m fftisdf_tpu_torch.examples.exciton_dispersion [--ke 50]
        [--kmesh 2 2 2] [--c0 40] [--xc pbe] [--nroots 3] [--eels]
        [--device cpu]
"""
import argparse

import numpy as np

from fftisdf_tpu_torch.examples import _common

_W = r"-?\d+\.\d{5}"
RESULTS = {
    "e_tot": r"^SCF converged=\w+  E=(\S+) Ha",
    "converged": r"^SCF converged=(\w+)",
    "q_norm": r"^ *\d+ +(\d+\.\d{6}) ",
    "roots": rf"^ *\d+ +\d+\.\d{{6}}((?: +{_W})+) *$",
    "oscillator": r"oscillator strengths: (.*)$",
    "eps0": r"eps_M\(0\) = (\S+);",
    "loss_peak": r"EELS loss peak (\S+) at w = (\S+)$",
}
# excitation energies on the recorded points, printed to 1e-5 Ha
GATES = {"e_tot": (0, 1e-6), "converged": (0, 0), "q_norm": (0, 2e-6),
         "roots": (0, 2e-5), "oscillator": (0, 2e-4), "eps0": (0, 2e-4),
         "loss_peak": (0, 2e-3)}
PRINTED_IF = {"eps0": lambda a: a.eels, "loss_peak": lambda a: a.eels}


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.exciton_dispersion",
        description=__doc__.split("\n\n")[0])
    _common.add_device_args(p)
    p.add_argument("--ke", type=float, default=50.0)
    p.add_argument("--kmesh", type=int, nargs=3, default=[2, 2, 2])
    p.add_argument("--c0", type=float, default=40.0)
    p.add_argument("--xc", default=None,
                   help="None = KRHF (CIS); else a scf.xc functional")
    p.add_argument("--nroots", type=int, default=3)
    p.add_argument("--eels", action="store_true",
                   help="print eps_M(q, omega) / loss at finite q")
    return p


def run(args, masks=None, out=print):
    dev, dtype = _common.setup(args)

    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf.ks import KRKS
    from fftisdf_tpu_torch.scf.tddft import (dielectric_tda,
                                             oscillator_strengths, tda)

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=args.ke)
    kpts = cell.get_kpts(args.kmesh)
    nk = len(kpts)

    df = _common.build(FFTISDF(cell, kpts, c0=args.c0, dtype=dtype,
                               verbose=4, device=dev), masks)
    kw = dict(with_df=df, dtype=dtype, verbose=4, device=dev)
    if args.xc:
        mf = KRKS(cell, kpts, xc=args.xc, **kw)
    else:
        mf = KRHF(cell, kpts, **kw)
    mf.kernel()
    out(f"SCF converged={mf.converged}  E={mf.e_tot:.8f} Ha")

    out(f"\n{'q':>3s} {'|q| (1/bohr)':>14s} "
        + " ".join(f"{'S' + str(n):>9s}" for n in range(args.nroots))
        + " " + " ".join(f"{'T' + str(n):>9s}"
                         for n in range(args.nroots)))
    roots, strengths, eels = [], None, {}
    for q in range(nk):
        ws, info_s = tda(mf, df, q=q, nroots=args.nroots)
        wt, _ = tda(mf, df, q=q, nroots=args.nroots, singlet=False)
        roots.append((np.asarray(ws), np.asarray(wt)))
        qn = float(np.linalg.norm(kpts[q]))
        out(f"{q:3d} {qn:14.6f} "
            + " ".join(f"{w:9.5f}" for w in ws)
            + " " + " ".join(f"{w:9.5f}" for w in wt))
        if q == 0 and info_s.get("x") is not None:
            f = strengths = oscillator_strengths(mf, ws,
                                                 np.asarray(info_s["x"]))
            out("    q=0 velocity-gauge oscillator strengths:",
                " ".join(f"{v:.4f}" for v in f))
        elif args.eels and qn > 1e-10:
            om = np.linspace(0.0, float(ws[-1]) + 0.3, 13)
            eps, d = dielectric_tda(mf, df, q=q, omegas=om)
            eels[q] = (np.asarray(eps), np.asarray(d["loss"]))
            out("    eps_M(0) = %.4f; EELS loss peak %.4f at w = %.3f"
                % (eps[0].real, d["loss"].max(),
                   om[int(np.argmax(d["loss"]))]))
    return dict(cell=cell, kpts=kpts, df=df, mf=mf, roots=roots,
                strengths=strengths, eels=eels)


def check(numbers):
    """The SCF converged and every excitation energy is positive."""
    bad = [] if all(numbers.get("converged", [])) else ["converged"]
    if not all(w > 0 for w in numbers.get("roots", [0.0])):
        bad.append("a non-positive excitation energy")
    return bad


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
