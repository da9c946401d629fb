"""NiO antiferromagnetic KUHF with ISDF J/K: the north-star configuration
(the reference driver's NiO AFM system; AFM needs KUHF).

The port of the JAX package's ``examples/nio_afm_kuhf.py``, flag for flag,
with ``--device``/``--dtype`` in place of ``--tpu``.  ``--production`` is
the reference driver's full configuration: gth-dzvp-molopt-sr, ke 200,
kmesh 4x4x4, c0 40, m0 15^3, the device-resident loop on the card.

Note: the Ni q18 GTH pseudo is an in-repo refit and the Ni basis columns
are pseudo-atom-derived surrogates (provenance in basis/data.py); the
ISDF-vs-exact comparison is exact regardless.

    python -m fftisdf_tpu_torch.examples.nio_afm_kuhf [--ke 50]
        [--kmesh 1 1 2] [--c0 20] [--exact] [--production] [--device cpu]
"""
import argparse
import time

import torch

from fftisdf_tpu_torch.examples import _common

RESULTS = {
    "nao": r"^NiO AFM: nao=(\d+)",
    "nip": r"^ISDF build: .*nip=(\d+)",
    "e_isdf": r"^-> ISDF KUHF E = (\S+) Ha",
    "converged": r"^-> ISDF KUHF E = .*conv=(\w+)\)",
    "moments": r"[A-Z][a-z]?:([+-]\d+\.\d+)",
    "e_exact": r"^-> exact-PW KUHF E = (\S+) Ha",
    "exact_converged": r"^-> exact-PW KUHF E = .*conv=(\w+)\)",
    "de_atom": r"^-> dE/atom = (\S+) Ha",
}
# against the JAX run of the same arguments, on its interpolation points
GATES = {"nao": (0, 0), "nip": (0, 0), "converged": (0, 0),
         "e_isdf": (0, 1e-6), "moments": (0, 2e-3),
         "e_exact": (1e-8, 2e-8), "exact_converged": (0, 0),
         "de_atom": (0, 1e-6)}
PRINTED_IF = {"e_exact": lambda a: a.exact,
              "exact_converged": lambda a: a.exact,
              "de_atom": lambda a: a.exact}


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.nio_afm_kuhf",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--ke", type=float, default=50.0)
    p.add_argument("--kmesh", type=int, nargs=3, default=[1, 1, 2])
    p.add_argument("--c0", type=float, default=20.0)
    p.add_argument("--exact", action="store_true",
                   help="also run the exact plane-wave KUHF for comparison")
    _common.add_device_args(p)
    p.add_argument("--level-shift", type=float, default=0.0)
    p.add_argument("--smearing", type=float, default=5e-3,
                   help="Fermi smearing sigma in Ha (0 = fixed occupations "
                        "+ level shift, the pre-smearing scheme)")
    p.add_argument("--basis", default="gth-szv",
                   help="e.g. gth-dzvp-molopt-sr (the reference driver's "
                        "basis)")
    p.add_argument("--production", action="store_true",
                   help="the reference driver's full configuration: 4x4x4, "
                        "gth-dzvp-molopt-sr, ke=200, c0=40, device-resident "
                        "SCF on the card")
    p.add_argument("--order", default="afm", choices=["afm", "fm", "pm"],
                   help="magnetic order of the initial guess: afm "
                        "(opposite Ni spins), fm (parallel), pm "
                        "(unpolarized)")
    p.add_argument("--xc", default=None,
                   help="run KS-DFT (KUKS) instead of KUHF: lda|pbe|pbe0")
    p.add_argument("--hubbard-u", type=float, default=0.0, metavar="EV",
                   help="DFT+U on the Ni d shells, U_eff in eV (needs "
                        "--xc; ~6.2 eV is the common NiO literature value)")
    return p


def run(args, masks=None, out=print):
    """Build and converge; returns the cell, k-points, ISDF state, SCF
    (``mf``; ``mf0`` for the exact arm) and the timings."""
    if args.production:
        args.ke, args.kmesh, args.c0 = 200.0, [4, 4, 4], 40.0
        args.basis = "gth-dzvp-molopt-sr"
    if args.smearing == 0.0 and args.level_shift == 0.0:
        args.level_shift = 0.3
    dev, dtype = _common.setup(args)

    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KUHF, DeviceKUHF
    from fftisdf_tpu_torch.scf.analysis import atom_charges_and_moments
    from fftisdf_tpu_torch.scf.ks import KUKS, DeviceKUKS

    cell = structure.to_cell(*structure.nio_afm(), basis=args.basis,
                             pseudo="gth-pade", ke_cutoff=args.ke,
                             exp_to_discard=0.1)
    kpts = cell.get_kpts(args.kmesh)
    out(f"NiO AFM: nao={cell.nao_nr()} nelec={cell.nelectron} "
        f"mesh={cell.mesh} nk={len(kpts)}")
    # magnetic order via the initial spin bias on the two Ni sites
    init_spin = {"afm": {0: +1.0, 1: -1.0},
                 "fm": {0: +1.0, 1: +1.0},
                 "pm": {}}[args.order]

    t0 = time.time()
    m0 = tuple(min(15, int(m)) for m in cell.mesh)
    df = _common.build(FFTISDF(cell, kpts, c0=args.c0, m0=m0, verbose=3,
                               dtype=dtype, device=dev), masks)
    build_s = time.time() - t0
    res = dict(cell=cell, kpts=kpts, df=df, build_s=build_s)
    if dev.type == "cuda":
        res["build_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out(f"ISDF build: {build_s:.1f}s, nip={df.nip}")

    ks_kwargs = {}
    if args.xc is not None:
        # KS-DFT: KUKS with optional DFT+U on the Ni d shells
        ks_kwargs["xc"] = args.xc
        if args.hubbard_u > 0.0:
            u_ha = args.hubbard_u / 27.211386
            ks_kwargs["hubbard"] = {0: (2, u_ha), 1: (2, u_ha)}
        host_cls, dev_cls = KUKS, DeviceKUKS
    else:
        host_cls, dev_cls = KUHF, DeviceKUHF
    cls = (dev_cls if _common.device_loop(dev, args.level_shift)
           else host_cls)
    t0 = time.time()
    mf = cls(cell, kpts, with_df=df, verbose=3,
             conv_tol=_common.conv_tol(dtype), max_cycle=80,
             init_spin=init_spin, level_shift=args.level_shift,
             smearing=args.smearing, dtype=dtype, device=dev, **ks_kwargs)
    res["setup_s"] = time.time() - t0
    t0 = time.time()
    e = mf.kernel()
    res.update(mf=mf, e_tot=e, scf_s=time.time() - t0)
    # local spin moments (Mulliken, diagonal of dm.S per atom)
    _charges, moments = atom_charges_and_moments(cell, mf.dm, mf.s1e)
    res["moments"] = moments
    out(f"-> ISDF KUHF E = {e:.8f} Ha  ({res['scf_s']:.1f}s, "
        f"conv={mf.converged})")
    out("-> atomic spin moments:",
        " ".join(f"{sym}:{m:+.3f}" for (sym, _), m in zip(cell.atom,
                                                          moments)))

    if args.exact:
        mf0 = host_cls(cell, kpts, verbose=0, conv_tol=1e-8, max_cycle=80,
                       init_spin=init_spin, level_shift=args.level_shift,
                       smearing=args.smearing, dtype=dtype, device=dev,
                       **ks_kwargs)
        e0 = mf0.kernel()
        res.update(mf0=mf0, e_exact=e0)
        out(f"-> exact-PW KUHF E = {e0:.8f} Ha (conv={mf0.converged})")
        out(f"-> dE/atom = {abs(e - e0) / cell.natm:.2e} Ha")
    return res


def check(numbers):
    """The script's own checks: every SCF converged."""
    return [k for k in ("converged", "exact_converged")
            if not all(numbers.get(k, [True]))]


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
