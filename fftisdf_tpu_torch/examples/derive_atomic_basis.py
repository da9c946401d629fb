"""Derive GTH contraction coefficients from the framework's own
pseudo-atom SCF, the offline replacement for unverifiable MOLOPT columns.

Runs the spin-polarized pseudo-atom in a box with the shared MOLOPT
exponent set uncontracted, builds per-angular-momentum radial natural
orbitals from the converged (occupied + low-virtual) states, and prints
(and with ``--register``, registers in the in-memory basis registry) the
leading radial vectors as contraction columns.  ``--radial`` derives them
from the 1D radial pseudo-atom (``basis.atom``) on the host instead.  The
port of the JAX package's ``examples/derive_atomic_basis.py``, with
``--device``/``--dtype`` in place of ``--tpu``.

    python -m fftisdf_tpu_torch.examples.derive_atomic_basis --elem H
        [--register --check] [--radial] [--device cpu]
    python -m fftisdf_tpu_torch.examples.derive_atomic_basis --elem Ni
        --ke 240
"""
import argparse

import numpy as np

from fftisdf_tpu_torch.examples import _common

# shared exponent sets (the embedded molopt-sr structure, basis/data.py)
EXPONENTS = {
    "H": [10.068468228533, 2.680222868089, 0.791501539122,
          0.239116151100, 0.082193184500],
    "Ni": [9.6538632696, 3.9744501290, 1.6213478542,
           0.6447664764, 0.2513317635, 0.0971124480],
}
# (l, n_contractions) per element: the DZVP-MOLOPT-SR shell structure
SHELLS = {"H": [(0, 2), (1, 1)], "Ni": [(0, 2), (1, 2), (2, 2)]}
# spin polarization of the atomic ground state (na - nb)
SPIN = {"H": 1, "Ni": 2}     # Ni: 3d8 4s2 -> S=1 (Hund)
# the pseudo-atom KUHF's settings
KUHF_KW = dict(verbose=0, conv_tol=1e-7, max_cycle=120, smearing=2e-3)

_COL = r"^ +\d+\.\d{9} ((?: +-?\d+\.\d{9})+)$"
RESULTS = {
    "e_unc": r"^uncontracted KUHF E = (\S+) Ha",
    "converged": r"^uncontracted KUHF .*conv=(\w+)\)",
    "columns": _COL,
    "e_con": r"^contracted \(\d+ AOs\) KUHF E = (\S+) Ha",
    "gap_mha": r"variational gap = (\S+) mHa",
    "e_radial": r"^\S+ radial pseudo-atom: conv=\w+ E=(\S+) Ha",
    "box_unc": r"^box KUHF: uncontracted \(\d+ AOs\) E = (\S+),",
    "box_con": r"^box KUHF: .*contracted \(\d+ AOs\) E = (\S+);",
}
# exact J/K everywhere (no ISDF): energies to 1e-8 relative or two printed
# units (1e-6 Ha), columns (eigenvectors of the radial density, or the
# radial fit) to 1e-6, the variational gap to 2e-3 mHa
GATES = {"e_unc": (1e-8, 2e-6), "converged": (0, 0), "columns": (0, 1e-6),
         "e_con": (1e-8, 2e-6), "gap_mha": (0, 2e-3),
         "e_radial": (1e-8, 2e-6), "box_unc": (1e-8, 2e-6),
         "box_con": (1e-8, 2e-6)}
PRINTED_IF = {"e_unc": lambda a: not a.radial,
              "converged": lambda a: not a.radial,
              "e_con": lambda a: a.check and not a.radial,
              "gap_mha": lambda a: a.check,
              "e_radial": lambda a: a.radial,
              "box_unc": lambda a: a.check and a.radial,
              "box_con": lambda a: a.check and a.radial}


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.derive_atomic_basis",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--elem", default="H", choices=sorted(EXPONENTS))
    p.add_argument("--box", type=float, default=12.0,
                   help="cube edge, Bohr")
    p.add_argument("--ke", type=float, default=None)
    _common.add_device_args(p)
    p.add_argument("--nvirt", type=int, default=3,
                   help="low-virtual states per l mixed (weight 0.05) into "
                        "the radial natural orbitals for the split columns")
    p.add_argument("--register", action="store_true",
                   help="register the derived columns over the in-repo "
                        "surrogate entries (gth-dzvp-molopt-sr)")
    p.add_argument("--check", action="store_true",
                   help="re-run the atom with the derived CONTRACTED basis "
                        "and report the variational gap vs uncontracted")
    p.add_argument("--radial", action="store_true",
                   help="derive columns from the 1D radial pseudo-atom "
                        "(basis/atom.py) instead of the 3D-box KUHF: "
                        "spherically exact, f64, no box artifacts; split "
                        "columns come from the lowest channel virtual")
    return p


def box_cell(elem, box, ke):
    """The uncontracted pseudo-atom: every (l, exponent) its own primitive
    shell, centred in a cube of edge ``box`` at ``ke`` Ha."""
    from fftisdf_tpu_torch.lattice.cell import Cell, Shell

    exps = np.asarray(EXPONENTS[elem])
    lmax = max(l for l, _ in SHELLS[elem])
    ke = ke or (60.0 if elem == "H" else 240.0)
    shells = [Shell(l=l, exps=np.array([e]), coeffs=np.array([[1.0]]))
              for l in range(lmax + 1) for e in exps]
    c = box / 2.0
    return Cell(a=np.diag([box] * 3), atom=[(elem, (c, c, c))],
                basis={elem: shells}, pseudo="gth-pade", ke_cutoff=ke,
                spin=SPIN[elem], unit="bohr").build()


def register(elem, tables):
    """Register the derived columns under gth-dzvp-molopt-sr (in memory)."""
    from fftisdf_tpu_torch.basis import data as bdata

    exps = np.asarray(EXPONENTS[elem])
    bdata.register_basis(
        "gth-dzvp-molopt-sr", elem,
        [(l, [(float(exps[i]), *[float(v) for v in tables[l][i]])
              for i in range(len(exps))]) for l, _ in SHELLS[elem]])


def _print_columns(out, exps, cols):
    for i, e in enumerate(exps):
        out("   %16.9f " % e + " ".join("%15.9f" % v for v in cols[i]))


def _kuhf(cell, kpts, dtype, dev, start):
    from fftisdf_tpu_torch.scf import KUHF

    mf = KUHF(cell, kpts, dtype=dtype, device=dev, **KUHF_KW)
    return mf, mf.kernel(dm0=None if start is None else start(mf))


def run(args, masks=None, out=print, start=None):
    """The box route, or ``--radial``'s.  ``start(mf)``, where given, is
    each box KUHF's initial density (the default is the KUHF's own)."""
    if args.radial:
        return derive_radial(args, out, start)
    dev, dtype = _common.setup(args)

    elem = args.elem
    exps = np.asarray(EXPONENTS[elem])
    lmax = max(l for l, _ in SHELLS[elem])
    cell = box_cell(elem, args.box, args.ke)
    kpts = cell.get_kpts([1, 1, 1])
    out(f"{elem} pseudo-atom: nao={cell.nao_nr()} (uncontracted), "
        f"mesh={cell.mesh}, nelec={cell.nelectron}, 2S={SPIN[elem]}")

    mf, e_unc = _kuhf(cell, kpts, dtype, dev, start)
    out(f"uncontracted KUHF E = {e_unc:.6f} Ha (conv={mf.converged})")

    # AO index map: shells registered l-major, exponent-minor; each shell
    # contributes (2l+1) functions
    ao_l = np.repeat([l for l in range(lmax + 1) for _ in exps],
                     [2 * l + 1 for l in range(lmax + 1) for _ in exps])
    # KUHF attributes carry a k axis: (2, nk=1, ...) -> drop it
    mo_c = np.asarray(mf.mo_coeff)[:, 0]
    mo_o = np.asarray(mf.mo_occ)[:, 0]
    mo_e = np.asarray(mf.mo_energy)[:, 0]
    tables = {}
    for l, ncol in SHELLS[elem]:
        cols = radial_naturals(mo_c, mo_o, mo_e, ao_l == l, len(exps),
                               2 * l + 1, nvirt=args.nvirt)[:, :ncol]
        # sign convention: the largest-|.| entry of each column positive
        cols = cols * np.where(cols[np.argmax(np.abs(cols), axis=0),
                                    np.arange(ncol)] < 0, -1.0, 1.0)
        tables[l] = cols
        out(f"l={l} derived columns (rows = exponents):")
        _print_columns(out, exps, cols)
    res = dict(cell=cell, kpts=kpts, mf=mf, e_unc=e_unc, tables=tables)

    if args.register or args.check:
        register(elem, tables)
        out(f"registered derived {elem} columns under gth-dzvp-molopt-sr")

    if args.check:
        cell2 = cell.copy(basis="gth-dzvp-molopt-sr").build()
        mf2, e_con = _kuhf(cell2, kpts, dtype, dev, start)
        out(f"contracted ({cell2.nao_nr()} AOs) KUHF E = {e_con:.6f} Ha "
            f"(conv={mf2.converged}); variational gap = "
            f"{(e_con - e_unc) * 1000:.3f} mHa")
        res.update(mf2=mf2, e_con=e_con)
    return res


def derive_radial(args, out=print, start=None):
    """Columns from the 1D radial pseudo-atom: occupied valence states give
    the leading contractions, the lowest channel virtual the split column.
    Spherically exact and float64, on the host."""
    from fftisdf_tpu_torch.basis.atom import (RadialGrid,
                                              fit_radial_gaussians,
                                              pseudo_occupations,
                                              solve_atom)
    from fftisdf_tpu_torch.basis.data import load_pseudo
    from fftisdf_tpu_torch.basis.gto import gaussian_int, gto_norm

    elem = args.elem
    exps = np.asarray(EXPONENTS[elem])
    ps = load_pseudo("gth-pade", elem)
    occ = pseudo_occupations(elem, ps)
    for l, ncol in SHELLS[elem]:
        occ.setdefault(l, [])
        occ[l] += [0.0] * max(ncol - len(occ[l]), 0)   # channel virtuals
    atom = solve_atom(elem, pseudo=ps, occ=occ,
                      grid=RadialGrid(rmax=40.0, n=1600))
    out(f"{elem} radial pseudo-atom: conv={atom.converged} "
        f"E={atom.e_tot:.6f} Ha")
    tables, resids = {}, {}
    for l, ncol in SHELLS[elem]:
        norms = gto_norm(l, exps)
        gram = (norms[:, None] * norms[None, :]
                * gaussian_int(2 * l + 2, exps[:, None] + exps[None, :]))
        cols, resid = [], []
        for i in range(ncol):
            c, r = fit_radial_gaussians(atom.u[l][i], l, exps, atom.grid)
            if r > 0.3:
                # unbound channel virtual (not Gaussian-representable):
                # the most diffuse primitive, Gram-orthogonalized against
                # the columns already taken
                c = np.zeros(len(exps))
                c[-1] = 1.0
                for prev in cols:
                    c -= prev * (prev @ gram @ c) / (prev @ gram @ prev)
                r = float("nan")
            cols.append(c)
            resid.append(r)
        cols = np.stack(cols, axis=1)
        cols = cols * np.where(cols[np.argmax(np.abs(cols), axis=0),
                                    np.arange(ncol)] < 0, -1.0, 1.0)
        tables[l], resids[l] = cols, resid
        out(f"l={l} derived columns (rows = exponents; "
            f"fit residuals {['%.1e' % r for r in resid]}):")
        _print_columns(out, exps, cols)
    res = dict(converged=atom.converged, e_tot=atom.e_tot, tables=tables,
               resid=resids)

    if args.register or args.check:
        register(elem, tables)
        out(f"registered radial-derived {elem} columns under "
            "gth-dzvp-molopt-sr")

    if args.check:
        dev, _ = _common.setup(args)
        import torch

        cell = box_cell(elem, args.box, args.ke)
        kpts = cell.get_kpts([1, 1, 1])
        mf, e_unc = _kuhf(cell, kpts, torch.float64, dev, start)
        cell2 = cell.copy(basis="gth-dzvp-molopt-sr").build()
        mf2, e_con = _kuhf(cell2, kpts, torch.float64, dev, start)
        out(f"box KUHF: uncontracted ({cell.nao_nr()} AOs) "
            f"E = {e_unc:.6f}, contracted ({cell2.nao_nr()} AOs) "
            f"E = {e_con:.6f}; variational gap = "
            f"{(e_con - e_unc) * 1000:.3f} mHa")
        res.update(mf=mf, mf2=mf2, e_unc=e_unc, e_con=e_con)
    return res


def radial_naturals(mo_coeff, mo_occ, mo_energy, sel, nexp, nm, nvirt=3,
                    wvirt=0.05):
    """Per-l radial natural orbitals: eigenvectors of the m-averaged,
    occupation-weighted radial density, plus a small low-virtual admixture
    so split-valence columns exist beyond the occupied count.  Returns
    (nexp, nexp) columns sorted by weight."""
    dens = np.zeros((nexp, nexp))
    for s in range(mo_coeff.shape[0]):
        occ = mo_occ[s]
        # low virtuals per spin: smallest-energy states with ~zero occupation
        virt = np.argsort(np.where(occ < 0.5, mo_energy[s], np.inf))[:nvirt]
        w = occ.copy()
        w[virt] = np.maximum(w[virt], wvirt)
        for p in np.nonzero(w > 1e-6)[0]:
            # within the l block AOs are (exponent major, m minor)
            r = mo_coeff[s][sel, p].reshape(nexp, nm)
            dens += w[p] * np.real(r @ r.conj().T)
    ww, vv = np.linalg.eigh(dens)
    return vv[:, np.argsort(ww)[::-1]]


def check(numbers):
    """Every KUHF converged and the contracted basis variational (its
    energy no lower than the uncontracted one by more than 1e-3 mHa)."""
    bad = [] if all(numbers.get("converged", [])) else ["converged"]
    if not all(g >= -1e-3 for g in numbers.get("gap_mha", [])):
        bad.append("the contracted basis is not variational")
    return bad


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
