"""DMET quantum embedding on a periodic hydrogen chain.

Fragments the cell into single H atoms, builds each atom's SVD bath from
the k-resolved KRHF density matrix, assembles embedding ERIs through the
ISDF factorization (``isdf.ao2mo``), solves each impurity exactly
(``scf.fci``), and reports fragment correlation energies with
chemical-potential fitting against the full-lattice CCSD correlation from
the same ISDF state.  The port of the JAX package's
``examples/dmet_demo.py``, with ``--device``/``--dtype`` in place of
``--tpu``.

    python -m fftisdf_tpu_torch.examples.dmet_demo [--nk 2] [--device cpu]
"""
import argparse
import time

from fftisdf_tpu_torch.examples import _common
from fftisdf_tpu_torch.examples.cc_spectroscopy import h2_chain

RESULTS = {
    "e_hf": r"^KRHF E = (\S+) Ha/cell",
    "nip": r"^KRHF E = .*nip=(\d+)",
    "nbath": r"^fragment AOs .*nbath=(\d+)",
    "mu": r"^fragment AOs .*mu=(\S+) ",
    "de_corr": r"^fragment AOs .*dE_corr=(\S+) Ha",
    "sum_corr": r"^sum of fragment corrections: (\S+) Ha/cell",
    "e_ccsd": r"^full-lattice CCSD:\s+(\S+) Ha/cell",
    "e_dmet": r"^DMET total E = (\S+) Ha/cell",
}
# KRHF is exact: 1e-8 relative; the rest on the recorded points, printed
# to 1e-6 Ha (mu to 1e-5)
GATES = {"e_hf": (1e-8, 2e-8), "nip": (0, 0), "nbath": (0, 0),
         "mu": (0, 2e-5), "de_corr": (0, 2e-6), "sum_corr": (0, 2e-6),
         "e_ccsd": (0, 2e-6), "e_dmet": (0, 2e-6)}


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.dmet_demo",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--nk", type=int, default=2)
    _common.add_device_args(p)
    return p


def run(args, masks=None, out=print):
    dev, dtype = _common.setup(args)

    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice.cell import Cell, Shell
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf.cc import kccsd
    from fftisdf_tpu_torch.scf.dmet import dmet_energy

    cell, kpts = h2_chain(args.nk, Cell, Shell)

    t0 = time.perf_counter()
    mf = KRHF(cell, kpts, verbose=0, conv_tol=1e-10, dtype=dtype,
              device=dev)
    mf.kernel()
    df = _common.build(FFTISDF(cell, kpts, c0=60.0, m0=(11, 11, 13),
                               verbose=0, select_tol=1e-18, rcond=1e-12,
                               dtype=dtype, device=dev), masks)
    out(f"KRHF E = {mf.e_tot:+.8f} Ha/cell, ISDF nip={df.nip} "
        f"({time.perf_counter()-t0:.1f}s)")

    frags = [[0, 1], [2, 3]]            # one H atom per fragment
    total = 0.0
    for f in frags:
        t0 = time.perf_counter()
        e, info = dmet_energy(mf, df, frag_ao=f, fit_mu=True)
        out(f"fragment AOs {f}: nbath={info['nbath']} "
            f"mu={info.get('mu', 0.0):+.5f} "
            f"dE_corr={info['de_corr']:+.6f} Ha "
            f"({time.perf_counter()-t0:.1f}s)")
        total += info["de_corr"]

    t0 = time.perf_counter()
    e_cc, cinfo = kccsd(df, mf, conv_tol=1e-9, max_cycle=80)
    out(f"sum of fragment corrections: {total:+.6f} Ha/cell")
    out(f"full-lattice CCSD:           {e_cc:+.6f} Ha/cell "
        f"({time.perf_counter()-t0:.1f}s)")
    out(f"DMET total E = {mf.e_tot + total:+.8f} Ha/cell")
    return dict(cell=cell, kpts=kpts, df=df, mf=mf, e_ccsd=e_cc,
                de_corr=total)


def check(numbers):
    """Every fragment's correlation and the CCSD energy negative, and the
    DMET sum within 10% of CCSD (the demo's own comparison)."""
    dmet, ccsd = numbers.get("sum_corr", []), numbers.get("e_ccsd", [])
    bad = []
    if not all(e < 0 for e in numbers.get("de_corr", [0.0])):
        bad.append("a fragment correlation energy not negative")
    if not (dmet and ccsd and ccsd[0] < 0
            and abs(dmet[0] - ccsd[0]) <= 0.1 * abs(ccsd[0])):
        bad.append("DMET and CCSD correlation more than 10% apart")
    return bad


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
