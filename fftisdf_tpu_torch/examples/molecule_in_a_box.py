"""Isolated molecules on periodic machinery: the 0D-truncated Coulomb SCF.

With the spherically truncated kernel (Spencer-Alavi), a molecule centred
in a vacuum box gets free-space physics: total energies converge
exponentially in the box size, and H2/STO-3G lands on the textbook RHF
energy (-1.1167 Ha).  Runs H2 at R = 1.4 bohr for a sweep of box sizes,
with and without truncation, through the exact plane-wave SCF and the
ISDF one.  The port of the JAX package's ``examples/molecule_in_a_box.py``,
with ``--device``/``--dtype`` in place of ``--tpu``.

    python -m fftisdf_tpu_torch.examples.molecule_in_a_box [--ke 80]
        [--boxes 9 11 12.5] [--device cpu]
"""
import argparse
import time

import numpy as np

from fftisdf_tpu_torch.examples import _common

_E = r"-?\d+\.\d{6}"
RESULTS = {
    "e_bare": rf"^ *\d+\.\d +({_E}) +{_E} +{_E} ",
    "e_trunc": rf"^ *\d+\.\d +{_E} +({_E}) +{_E} ",
    "e_isdf": rf"^ *\d+\.\d +{_E} +{_E} +({_E}) ",
}
# printed to 1e-6 Ha: the exact arms to two printed units, the ISDF arm
# (on the recorded points) to 1e-6
GATES = {"e_bare": (0, 2e-6), "e_trunc": (0, 2e-6), "e_isdf": (0, 2e-6)}
TEXTBOOK = -1.1167


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.molecule_in_a_box",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--ke", type=float, default=80.0)
    p.add_argument("--boxes", type=float, nargs="+",
                   default=[9.0, 11.0, 12.5])
    p.add_argument("--c0", type=float, default=25.0)
    _common.add_device_args(p)
    return p


def run(args, masks=None, out=print):
    dev, dtype = _common.setup(args)

    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice.cell import Cell
    from fftisdf_tpu_torch.scf.hf import KRHF

    R = 1.4
    out(f"H2 R={R} bohr, STO-3G; textbook free-space RHF = {TEXTBOOK} Ha")
    out(f"{'L':>6} {'E(bare PBC)':>14} {'E(trunc 0d)':>14} "
        f"{'E(trunc, ISDF)':>15} {'t(s)':>6}")
    rows = []
    for L in args.boxes:
        cell = Cell(a=np.eye(3) * L,
                    atom=[("H", (L / 2, L / 2, L / 2 - R / 2)),
                          ("H", (L / 2, L / 2, L / 2 + R / 2))],
                    basis="sto-3g", pseudo=None, ke_cutoff=args.ke,
                    unit="bohr", precision=1e-12).build()
        kpts = cell.get_kpts([1, 1, 1])
        kw = dict(verbose=0, dtype=dtype, device=dev)
        t0 = time.time()
        mf_bare = KRHF(cell, kpts, **kw)
        mf_bare.kernel()
        mf_tr = KRHF(cell, kpts, trunc="0d", **kw)
        mf_tr.kernel()
        df = _common.build(FFTISDF(cell, kpts, c0=args.c0, m0=(15, 15, 15),
                                   trunc="0d", **kw), masks)
        mf_isdf = KRHF(cell, kpts, with_df=df, **kw)
        mf_isdf.kernel()
        rows.append((mf_bare.e_tot, mf_tr.e_tot, mf_isdf.e_tot))
        out(f"{L:6.1f} {mf_bare.e_tot:14.6f} {mf_tr.e_tot:14.6f} "
            f"{mf_isdf.e_tot:15.6f} {time.time() - t0:6.1f}")
    out("bare-PBC energies drift with L (image coupling + background "
        "convention); truncated ones converge to the molecular value.")
    return dict(rows=rows)


def check(numbers):
    """The truncated energies approach the textbook value as the box
    grows, the largest box's within 5 mHa of it (9 bohr: 3.3 mHa; 12.5
    bohr: 0.1 mHa), and the ISDF arm lands on the exact truncated one
    (1e-4 Ha)."""
    tr, isdf = numbers.get("e_trunc", []), numbers.get("e_isdf", [])
    dev = [abs(e - TEXTBOOK) for e in tr]
    bad = []
    if not dev or dev[-1] > 5e-3 or dev != sorted(dev, reverse=True):
        bad.append("truncated H2 does not approach the textbook energy")
    if len(tr) != len(isdf) or max(
            (abs(a - b) for a, b in zip(tr, isdf)), default=0.0) > 1e-4:
        bad.append("ISDF off the exact truncated energy")
    return bad


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
