"""Diamond FFT-ISDF driver: build, then run KRHF on the exact plane-wave
J/K and on the ISDF J/K and compare the energies.

The port of the JAX package's ``examples/diamond_isdf.py``, with
``--device``/``--dtype`` in place of ``--tpu``.

    python -m fftisdf_tpu_torch.examples.diamond_isdf [--ke 50]
        [--kmesh 1 1 2] [--c0 25] [--device cpu]
"""
import argparse
import time

from fftisdf_tpu_torch.examples import _common

RESULTS = {
    "nao": r"^diamond: nao=(\d+)",
    "e_exact": r"^-> exact-PW KRHF  E = (\S+) Ha",
    "exact_converged": r"^-> exact-PW KRHF .*conv=(\w+)\)",
    "e_isdf": r"^-> ISDF KRHF      E = (\S+) Ha",
    "converged": r"^-> ISDF KRHF .*conv=(\w+),",
    "nip": r"^-> ISDF KRHF .*nip=(\d+)\)",
    "de_atom": r"^-> ISDF c0=\S+ dE/atom = (\S+) Ha",
}
GATES = {"nao": (0, 0), "e_exact": (1e-8, 2e-8), "exact_converged": (0, 0),
         "e_isdf": (0, 1e-6), "converged": (0, 0), "nip": (0, 0),
         "de_atom": (0, 1e-6)}


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.diamond_isdf",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--ke", type=float, default=50.0)
    p.add_argument("--kmesh", type=int, nargs=3, default=[1, 1, 2])
    p.add_argument("--c0", type=float, default=25.0)
    _common.add_device_args(p)
    return p


def run(args, masks=None, out=print):
    dev, dtype = _common.setup(args)

    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRHF

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=args.ke)
    kpts = cell.get_kpts(args.kmesh)
    out(f"diamond: nao={cell.nao_nr()} nelec={cell.nelectron} "
        f"mesh={cell.mesh} nk={len(kpts)}")

    t0 = time.time()
    mf0 = KRHF(cell, kpts, verbose=0, conv_tol=1e-9, dtype=dtype,
               device=dev)
    e0 = mf0.kernel()
    out(f"-> exact-PW KRHF  E = {e0:.8f} Ha  ({time.time()-t0:.1f}s, "
        f"conv={mf0.converged})")

    t0 = time.time()
    df = _common.build(FFTISDF(cell, kpts, c0=args.c0, m0=(9, 9, 9),
                               verbose=0, dtype=dtype, device=dev), masks)
    t_build = time.time() - t0
    mf1 = KRHF(cell, kpts, with_df=df, verbose=0, conv_tol=1e-9,
               dtype=dtype, device=dev)
    e1 = mf1.kernel()
    out(f"-> ISDF KRHF      E = {e1:.8f} Ha  (build {t_build:.1f}s, "
        f"conv={mf1.converged}, nip={df.nip})")
    out(f"-> ISDF c0={args.c0}: dE/atom = {abs(e1-e0)/cell.natm:.2e} Ha")
    return dict(cell=cell, kpts=kpts, df=df, mf=mf1, mf0=mf0)


def check(numbers):
    """Both SCFs converged, and the ISDF energy within 1e-5 Ha/atom of
    the exact one (c0 25 on this cell: ~1e-8)."""
    bad = [k for k in ("converged", "exact_converged")
           if not all(numbers.get(k, []))]
    if not all(d <= 1e-5 for d in numbers.get("de_atom", [1.0])):
        bad.append("dE/atom past 1e-5 Ha")
    return bad


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
