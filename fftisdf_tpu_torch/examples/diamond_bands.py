"""Band structure of diamond along L-G-X-W-L (HF or any KS functional).

Converges an ISDF-driven KRHF/KRKS on a k-mesh, then evaluates band
energies at arbitrary k-points with ``get_bands`` (exact plane-wave J/K at
the band points from the converged mesh density).  ``--xc hse06`` is the
screened hybrid of the solid-state recipe.  The port of the JAX package's
``examples/diamond_bands.py``, with ``--device``/``--dtype`` in place of
``--tpu``.

    python -m fftisdf_tpu_torch.examples.diamond_bands [--ke 50]
        [--kmesh 2 2 2] [--npoints 8] [--c0 40] [--xc hf|lda|pbe|pbe0|hse06]
        [--device cpu]
"""
import argparse

import numpy as np

from fftisdf_tpu_torch.examples import _common

RESULTS = {
    "e_tot": r"^# converged \S+ E = (\S+) Ha",
    "converged": r"^# converged .*\(converged=(\w+)\)",
    "gap_ev": r"^# indirect gap along path: (\S+) eV",
    "bands": r"^ *\d+\.\d{4} ((?: +-?\d+\.\d{6})+) *$",
}
GATES = {"e_tot": (0, 1e-6), "converged": (0, 0), "gap_ev": (0, 2e-3),
         "bands": (0, 2e-6)}


def kpath(cell, npoints):
    """L-G-X-W-L path in the fcc Brillouin zone (scaled coordinates of the
    primitive reciprocal lattice)."""
    pts = {
        "L": np.array([0.5, 0.5, 0.5]),
        "G": np.array([0.0, 0.0, 0.0]),
        "X": np.array([0.5, 0.0, 0.5]),
        "W": np.array([0.5, 0.25, 0.75]),
    }
    legs = ["L", "G", "X", "W", "L"]
    b = cell.reciprocal_vectors()
    kpts, labels, dist = [], [], [0.0]
    for i in range(len(legs) - 1):
        p0, p1 = pts[legs[i]], pts[legs[i + 1]]
        n = npoints if i < len(legs) - 2 else npoints + 1
        for j in range(n):
            t = j / npoints
            kpts.append((1 - t) * p0 + t * p1)
    kcart = np.asarray(kpts) @ b
    for i in range(1, len(kcart)):
        dist.append(dist[-1] + np.linalg.norm(kcart[i] - kcart[i - 1]))
    for i, leg in enumerate(legs):
        labels.append((dist[min(i * npoints, len(dist) - 1)], leg))
    return kcart, np.asarray(dist), labels


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.diamond_bands",
        description=__doc__.split("\n\n")[0])
    _common.add_device_args(p)
    p.add_argument("--ke", type=float, default=50.0)
    p.add_argument("--kmesh", type=int, nargs=3, default=[2, 2, 2])
    p.add_argument("--npoints", type=int, default=8)
    p.add_argument("--c0", type=float, default=40.0)
    p.add_argument("--exxdiv", default=None, choices=[None, "ewald"])
    p.add_argument("--xc", default="hf",
                   help="hf (KRHF) or a KS functional (lda/pbe/pbe0/hse06)")
    return p


def run(args, masks=None, out=print):
    dev, dtype = _common.setup(args)

    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf.ks import KRKS

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=args.ke)
    kpts = cell.get_kpts(args.kmesh)

    df = _common.build(FFTISDF(cell, kpts, c0=args.c0, m0=(11, 11, 11),
                               verbose=3, dtype=dtype, device=dev), masks)
    kw = dict(with_df=df, verbose=3, exxdiv=args.exxdiv, dtype=dtype,
              device=dev)
    if args.xc == "hf":
        mf = KRHF(cell, kpts, **kw)
    else:
        mf = KRKS(cell, kpts, xc=args.xc, **kw)
    e = mf.kernel()
    out(f"# converged {args.xc.upper()} E = {e:.10f} Ha "
        f"(converged={mf.converged})")

    kband, dist, labels = kpath(cell, args.npoints)
    # band J/K are exact plane-wave at the band points; exxdiv='ewald' bands
    # are only defined on the mesh, so interpolate with exxdiv=None
    mf.exxdiv = None
    es, _ = mf.get_bands(kband)
    es = [np.asarray(ek) for ek in es]
    nocc = mf.nocc
    homo = max(ek[nocc - 1] for ek in es)
    lumo = min(ek[nocc] for ek in es)
    out(f"# indirect gap along path: {27.2114 * (lumo - homo):.3f} eV "
        f"(exp ~5.5; HF overestimates ~2x, PBE underestimates ~25%, "
        f"HSE06 lands near experiment)")
    out("# path labels: " + "  ".join(f"{lab}@{d:.3f}" for d, lab in labels))
    out("# dist  e_1 e_2 ... (Ha)")
    for d, ek in zip(dist, es):
        out(f"{d:8.4f} " + " ".join(f"{x:12.6f}" for x in ek[:8]))
    return dict(cell=cell, kpts=kpts, df=df, mf=mf, bands=es)


def check(numbers):
    """The SCF converged and the path's gap is open."""
    bad = [] if all(numbers.get("converged", [])) else ["converged"]
    if not all(g > 0 for g in numbers.get("gap_ev", [0.0])):
        bad.append("no gap along the path")
    return bad


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
