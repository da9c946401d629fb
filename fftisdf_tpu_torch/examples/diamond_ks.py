"""Diamond KS-DFT driver: LDA / PBE / PBE0 with ISDF-served two-electron
terms, against the exact plane-wave Hartree term.

Pure functionals need only J from (x_k, w0); hybrids (PBE0) add ISDF
exact exchange at the hybrid fraction.  The port of the JAX package's
``examples/diamond_ks.py``, with ``--device``/``--dtype`` in place of
``--tpu``; the JAX script's ``--device`` (the device-resident loop) is
``--device-loop`` here, since ``--device`` names the device.

    python -m fftisdf_tpu_torch.examples.diamond_ks [--xc lda|pbe|pbe0]
        [--ke 50] [--kmesh 1 1 2] [--c0 25] [--device-loop] [--device cpu]
"""
import argparse
import time

from fftisdf_tpu_torch.examples import _common

RESULTS = {
    "nao": r"^diamond: xc=\S+ nao=(\d+)",
    "nip": r"^-> ISDF build: nip=(\d+)",
    "e_ks": r"^-> (?:device )?KRKS/\S+\s+E = (\S+) Ha",
    "converged": r"^-> (?:device )?KRKS/.*conv=(\w+)\)",
    "e_exact": r"^-> exact-PW KRKS  E = (\S+) Ha",
    "de_atom": r"\|dE\|/atom = (\S+)$",
}
GATES = {"nao": (0, 0), "nip": (0, 0), "e_ks": (0, 1e-6),
         "converged": (0, 0), "e_exact": (1e-8, 2e-8), "de_atom": (0, 1e-6)}


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.diamond_ks",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--xc", default="pbe")
    p.add_argument("--ke", type=float, default=50.0)
    p.add_argument("--kmesh", type=int, nargs=3, default=[1, 1, 2])
    p.add_argument("--c0", type=float, default=25.0)
    _common.add_device_args(p)
    p.add_argument("--device-loop", action="store_true",
                   help="device-resident SCF loop (one fetch per cycle)")
    return p


def run(args, masks=None, out=print):
    dev, dtype = _common.setup(args)

    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf.ks import KRKS, DeviceKRKS

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=args.ke)
    kpts = cell.get_kpts(args.kmesh)
    out(f"diamond: xc={args.xc} nao={cell.nao_nr()} "
        f"nelec={cell.nelectron} mesh={cell.mesh} nk={len(kpts)}")

    t0 = time.time()
    df = _common.build(FFTISDF(cell, kpts, c0=args.c0, m0=(9, 9, 9),
                               verbose=0, dtype=dtype, device=dev), masks)
    out(f"-> ISDF build: nip={df.nip} ({time.time()-t0:.1f}s)")

    cls = DeviceKRKS if args.device_loop else KRKS
    t0 = time.time()
    mf = cls(cell, kpts, xc=args.xc, with_df=df, verbose=4, conv_tol=1e-8,
             dtype=dtype, device=dev)
    e = mf.kernel()
    out(f"-> {'device ' if args.device_loop else ''}KRKS/{args.xc}  "
        f"E = {e:.8f} Ha  ({time.time()-t0:.1f}s, conv={mf.converged})")
    res = dict(cell=cell, kpts=kpts, df=df, mf=mf)

    # exact-PW Hartree cross-check (pure functionals: J is the only
    # two-electron term, so this isolates the ISDF compression error)
    if not args.device_loop:
        t0 = time.time()
        mf0 = KRKS(cell, kpts, xc=args.xc, verbose=0, conv_tol=1e-8,
                   dtype=dtype, device=dev)
        e0 = mf0.kernel()
        out(f"-> exact-PW KRKS  E = {e0:.8f} Ha  ({time.time()-t0:.1f}s)"
            f"  |dE|/atom = {abs(e - e0)/cell.natm:.2e}")
        res["mf0"] = mf0
    return res


def check(numbers):
    """The SCF converged, and the ISDF energy within 1e-5 Ha/atom of the
    exact one where that arm ran."""
    bad = [] if all(numbers.get("converged", [])) else ["converged"]
    if not all(d <= 1e-5 for d in numbers.get("de_atom", [])):
        bad.append("|dE|/atom past 1e-5 Ha")
    return bad


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
