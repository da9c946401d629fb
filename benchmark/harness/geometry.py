"""Seeded inputs: the geometry of job ``k`` of a run with ``seed``.

Every atom of the configuration's published cell is displaced by a
uniform draw of at most ``displacement_bohr`` in each Cartesian
direction; the lattice stays as published.  Job ``k`` draws from
(seed, k), so one seed repeats the same work and other seeds give other
problems of the same size.  Lengths are returned in bohr, the unit both
the program and the reference are given."""
from __future__ import annotations

import numpy as np

BOHR_ANGSTROM = 0.52917721092     # Angstrom per bohr (CODATA 2010)
WARM_JOB = 2 ** 32                # the warm-up's draw: never a window job


def geometry(cfg, seed, k):
    """(lattice (3, 3) bohr, [(symbol, (3,) bohr), ...]) of job ``k``."""
    st = cfg["structure"]
    lat = np.asarray(st["lattice_angstrom"], dtype=np.float64) / BOHR_ANGSTROM
    syms = [s for s, _ in st["atoms_fractional"]]
    frac = np.asarray([f for _, f in st["atoms_fractional"]],
                      dtype=np.float64)
    rng = np.random.default_rng([int(seed) % 2 ** 64, int(k)])
    d = float(cfg["displacement_bohr"])
    xyz = frac @ lat + rng.uniform(-d, d, size=frac.shape)
    return lat, [(s, xyz[i]) for i, s in enumerate(syms)]
