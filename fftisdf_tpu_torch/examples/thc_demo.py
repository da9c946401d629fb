"""LS-THC demo: fit THC factors against Cholesky ERIs and print the
per-k-pair error report (the reference driver's least-squares THC).

The port of the JAX package's ``examples/thc_demo.py`` (which runs on the
CPU only), with ``--device``; the fit is float64 only, as there.

    python -m fftisdf_tpu_torch.examples.thc_demo [--becke] [--kmesh 1 1 2]
        [--row-only] [--device cpu]
"""
import argparse

import numpy as np

from fftisdf_tpu_torch.examples import _common

RESULTS = {
    "becke_points": r"^Becke grid: (\d+) points",
    "nip": r"^nip = (\d+)",
    "errors": r"k1 = \d+, k2 = \d+, Max: (\S+), Mean: (\S+)",
}
# The pooled pivots sit at the 1e-16 pivot tolerance, where two
# implementations keep different roundoff-level points (the JAX package
# keeps 7 on the uniform grid, the port 6), and the fit cannot take a
# recorded mask: each run is held to the JAX tests' bounds on its own
# error report (check), and to the JAX run's report within the tightest
# of those bounds, and the grid size is compared.
GATES = {"becke_points": (0, 0), "errors": (0, 1e-7)}
PRINTED_IF = {"becke_points": lambda a: a.becke}
# the JAX tests' bounds on the largest pair error
BOUND = {"uniform": 1e-7, "becke": 5e-5, "row_only": 0.2}


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.thc_demo",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--becke", action="store_true",
                   help="fit on atom-centered Becke grids instead of the "
                        "uniform FFT grid")
    p.add_argument("--kmesh", type=int, nargs=3, default=[1, 1, 2])
    p.add_argument("--row-only", action="store_true",
                   help="reference mode: fit on the k1=0 pair row only")
    _common.add_device_args(p, dtype=False)
    return p


def run(args, masks=None, out=print):
    dev, _ = _common.setup(args)

    from fftisdf_tpu_torch.isdf.thc import LSTHC
    from fftisdf_tpu_torch.lattice.cell import Cell

    cell = Cell(
        a=np.diag([5.0, 5.0, 7.0]),
        atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
        basis="sto-3g",
        pseudo=None,
        mesh=np.array([9, 9, 11]),
        unit="bohr",
        precision=1e-12,
    ).build()
    kpts = cell.get_kpts(args.kmesh)

    grids = None
    if args.becke:
        from fftisdf_tpu_torch.lattice.becke import AtomCenteredGrids

        grids = AtomCenteredGrids(cell, level=0).build()
        out(f"Becke grid: {len(grids.weights)} points")

    thc = LSTHC(cell, kpts, verbose=3, grids=grids, device=dev)
    thc.build(row_only=args.row_only)
    out(f"nip = {len(thc.mask)}")
    # the report goes to the logger, as the JAX package's does
    report = thc.error_report()
    return dict(cell=cell, thc=thc, report=report)


def check(numbers, mode="uniform"):
    """Every pair's largest error within the JAX tests' bound of the mode
    (``uniform``, ``becke`` or ``row_only``)."""
    err = numbers.get("errors", [])[::2]
    ok = err and max(err) < BOUND[mode]
    return [] if ok else [f"THC fit error past {BOUND[mode]:g}"]


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines and
    of the error report."""
    lines = _common.Lines()
    res = run(build_parser().parse_args(argv), masks=masks, out=lines)
    text = lines.text() + "".join(
        f"\nk1 = {k1}, k2 = {k2}, Max: {e1:6.4e}, Mean: {e2:6.4e}"
        for k1, k2, e1, e2 in res["report"])
    return _common.parse(text, RESULTS)


if __name__ == "__main__":
    main()
