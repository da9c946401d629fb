"""Structure ingestion: VASP POSCAR parsing and bulk crystal constructors.

The port's copy of the JAX package's ``fftisdf_tpu/lattice/structure.py``,
without its Materials Project download (which needs the network).  It
replaces the reference's ``cell.py`` (``ase.build.bulk``; ``cell.py:10-37``)
and its ``nio-afm.vasp`` data file: POSCAR text is parsed locally and the
common bulk lattices used by the reference's scripts (diamond, rocksalt) are
generated analytically.
"""
from __future__ import annotations

import numpy as np


def parse_poscar(text: str):
    """Parse a VASP POSCAR/CONTCAR string.

    Returns ``(lattice_angstrom (3,3), [(symbol, xyz_angstrom), ...])``.
    Supports the VASP5 symbol line, 'Direct'/'Cartesian' coordinates and the
    optional 'Selective dynamics' block.
    """
    lines = [ln.strip() for ln in text.strip().splitlines() if ln.strip()]
    scale = float(lines[1].split()[0])
    lat = np.array([[float(x) for x in lines[2 + i].split()[:3]] for i in range(3)])
    if scale < 0:  # negative scale = target volume
        vol = abs(np.linalg.det(lat))
        scale = (-scale / vol) ** (1.0 / 3.0)
    lat = lat * scale

    symbols = lines[5].split()
    counts = [int(x) for x in lines[6].split()]
    idx = 7
    if lines[idx][0].lower() == "s":  # selective dynamics
        idx += 1
    mode = lines[idx][0].lower()  # 'd'irect or 'c'artesian/'k'
    idx += 1

    species = []
    for sym, cnt in zip(symbols, counts):
        species.extend([sym] * cnt)

    atoms = []
    for i, sym in enumerate(species):
        xyz = np.array([float(x) for x in lines[idx + i].split()[:3]])
        if mode == "d":
            xyz = xyz @ lat
        else:
            xyz = xyz * scale
        atoms.append((sym, xyz))
    return lat, atoms


def read_poscar(path: str):
    with open(path) as fh:
        return parse_poscar(fh.read())


def format_poscar(lattice, atoms, comment="fftisdf_tpu") -> str:
    """Inverse of parse_poscar (Cartesian coordinates, Angstrom)."""
    syms = []
    for s, _ in atoms:
        if s not in syms:
            syms.append(s)
    counts = [sum(1 for s, _ in atoms if s == sym) for sym in syms]
    out = [comment, "1.0"]
    for row in np.asarray(lattice):
        out.append("  %.10f %.10f %.10f" % tuple(row))
    out.append(" ".join(syms))
    out.append(" ".join(str(c) for c in counts))
    out.append("Cartesian")
    for sym in syms:
        for s, xyz in atoms:
            if s == sym:
                out.append("  %.10f %.10f %.10f" % tuple(xyz))
    return "\n".join(out) + "\n"


# ------------------------------------------------------------ constructors

def bulk_diamond(symbol="C", a=3.567):
    """Primitive fcc diamond cell, two atoms. `a` is the conventional cubic
    lattice constant in Angstrom (reference: C, a=3.567; fftdf-with-k.py:175)."""
    lat = (np.ones((3, 3)) - np.eye(3)) * (a / 2.0)
    atoms = [(symbol, np.zeros(3)), (symbol, np.full(3, a / 4.0))]
    return lat, atoms


def bulk_rocksalt(sym1="Ni", sym2="O", a=4.18):
    """Primitive rocksalt cell, two atoms (reference: NiO a=4.18;
    fftisdf.py:414)."""
    lat = (np.ones((3, 3)) - np.eye(3)) * (a / 2.0)
    atoms = [(sym1, np.zeros(3)), (sym2, np.full(3, a / 2.0))]
    return lat, atoms


# The reference's NiO antiferromagnetic 4-atom cell (`nio-afm.vasp:1-12`):
# rhombohedral doubling of rocksalt along [111] so that the two Ni sites can
# carry opposite spins (AFM-II ordering).
def nio_afm(a=4.17):
    lat = np.array([
        [1.0, 0.5, 0.5],
        [0.5, 1.0, 0.5],
        [0.5, 0.5, 1.0],
    ]) * a
    frac = {
        "Ni": [(0.0, 0.0, 0.0), (0.5, 0.5, 0.5)],
        "O": [(0.25, 0.25, 0.25), (0.75, 0.75, 0.75)],
    }
    atoms = [
        (sym, np.asarray(f) @ lat) for sym in ("Ni", "O") for f in frac[sym]
    ]
    return lat, atoms


def to_cell(lattice_angstrom, atoms_angstrom, **kwargs):
    """Convenience: build a Cell from Angstrom lattice/atoms."""
    from fftisdf_tpu_torch.lattice.cell import Cell

    return Cell(
        a=np.asarray(lattice_angstrom),
        atom=[(s, np.asarray(x)) for s, x in atoms_angstrom],
        unit="angstrom",
        **kwargs,
    ).build()
