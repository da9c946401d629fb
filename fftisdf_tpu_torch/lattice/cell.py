"""Crystal cell: lattice vectors, atoms, basis assignment, FFT meshes, grids.

The port's copy of the JAX package's ``fftisdf_tpu/lattice/cell.py``: the
same class, conventions and numbers, so that a cell built here from the
same arguments equals the JAX package's.  The reference delegates all of
this to PySCF's ``Cell`` (``fftisdf.py:417-430``, ``gen_uniform_grids`` at
``fftisdf.py:368``, ``get_Gv`` at ``fftisdf.py:91``); here it is native.

Conventions (documented because everything downstream depends on them):

- ``a`` holds the *row* lattice vectors in Bohr: ``a[i]`` is the i-th lattice
  vector.
- Reciprocal vectors ``b = 2*pi*inv(a).T`` (rows), so ``a @ b.T = 2*pi*I``.
- Uniform grids enumerate fractional coordinates ``(ix/mx, iy/my, iz/mz)`` in
  C order with the *last* axis fastest: flat index ``g = (ix*my + iy)*mz + iz``.
  This matches the layout expected by ``numpy.fft.fftn`` on an array reshaped
  to ``(*mesh,)`` and is the same convention as the reference's grids.
- ``Gv`` enumerates FFT frequencies (``fftfreq`` ordering, integer multiples of
  ``b``), matching the bin layout of ``fftn`` on the same reshape.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

BOHR = 0.52917721092  # Angstrom per Bohr (CODATA 2010, same value PySCF uses)


def cartesian_prod(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Cartesian product with the last array varying fastest (C order)."""
    arrays = [np.asarray(x) for x in arrays]
    grids = np.meshgrid(*arrays, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


def _smooth_size(n: int) -> int:
    """Round ``n`` up to the next 2,3,5,7-smooth integer (FFT friendly)."""
    def smooth(m):
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        return m == 1
    while not smooth(n):
        n += 1
    return n


@dataclass
class Shell:
    """One contracted shell: sum_p coeffs[p, c] * r^(l+2*rpow) exp(-exps[p] r^2) * Ylm.

    ``coeffs`` has shape (nprim, nctr): several contracted functions may share
    the same primitives (generalized contraction, as in GTH basis sets).
    Coefficients are stored *raw* (as in the basis-set tables); normalization
    is applied by the evaluator (see fftisdf_tpu_torch.basis.gto.normalized_coeffs).
    ``rpow`` adds an even radial power r^(2*rpow) — used by GTH nonlocal
    projectors p_i^l ~ r^(l+2(i-1)) e^(-r^2/2rl^2) (i = rpow+1); plain AO
    shells have rpow = 0.
    """
    l: int
    exps: np.ndarray      # (nprim,)
    coeffs: np.ndarray    # (nprim, nctr)
    rpow: int = 0
    raw: bool = False     # True: use coeffs verbatim (no re-normalization)

    @property
    def nprim(self) -> int:
        return len(self.exps)

    @property
    def nctr(self) -> int:
        return self.coeffs.shape[1]

    @property
    def nfunc(self) -> int:
        return (2 * self.l + 1) * self.nctr


@dataclass
class Cell:
    """A periodic crystal cell with a Gaussian basis.

    Parameters mirror the knobs the reference exposes through PySCF
    (``fftisdf.py:417-430``): lattice ``a``, ``atom`` list, ``basis`` /
    ``pseudo`` names, ``ke_cutoff``, ``exp_to_discard``, ``unit``.
    """
    a: np.ndarray                      # (3,3) row lattice vectors
    atom: list                         # [(symbol, (x,y,z)), ...]
    basis: str | dict = "gth-szv"
    pseudo: str | dict | None = "gth-pade"
    ke_cutoff: float | None = None     # Hartree
    mesh: np.ndarray | None = None     # FFT mesh, overrides ke_cutoff if given
    unit: str = "bohr"                 # unit of `a` and atom coords: bohr|angstrom|aa|b
    exp_to_discard: float | None = None
    precision: float = 1e-10           # lattice-sum truncation accuracy
    charge: int = 0
    spin: int = 0                      # 2S = n_alpha - n_beta per cell

    # filled by build()
    _basis: dict = field(default_factory=dict, repr=False)   # symbol -> [Shell]
    _pseudo: dict = field(default_factory=dict, repr=False)  # symbol -> GTHPseudo
    _built: bool = False

    # ------------------------------------------------------------------ build
    def build(self) -> "Cell":
        from fftisdf_tpu_torch.basis import data as basis_data

        unit = self.unit.lower()
        if unit in ("a", "aa", "ang", "angstrom"):
            scale = 1.0 / BOHR
        elif unit in ("b", "au", "bohr"):
            scale = 1.0
        else:
            raise ValueError(f"unknown unit {self.unit!r}")

        self.a = np.asarray(self.a, dtype=np.float64) * scale
        atoms = []
        for sym, xyz in self.atom:
            atoms.append((sym, np.asarray(xyz, dtype=np.float64) * scale))
        self.atom = atoms
        self.unit = "bohr"

        symbols = sorted({s for s, _ in self.atom})
        # resolve basis
        if isinstance(self.basis, str):
            self._basis = {s: basis_data.load_basis(self.basis, s) for s in symbols}
        else:
            self._basis = {
                s: (basis_data.load_basis(v, s) if isinstance(v, str) else v)
                for s, v in self.basis.items()
            }
        if self.exp_to_discard is not None:
            self._basis = {
                s: basis_data.discard_diffuse(shells, self.exp_to_discard)
                for s, shells in self._basis.items()
            }
        # resolve pseudopotential
        if self.pseudo is None:
            self._pseudo = {}
        elif isinstance(self.pseudo, str):
            self._pseudo = {s: basis_data.load_pseudo(self.pseudo, s) for s in symbols}
        else:
            self._pseudo = dict(self.pseudo)

        if self.mesh is None:
            if self.ke_cutoff is None:
                self.ke_cutoff = self._default_ke_cutoff()
            self.mesh = self.cutoff_to_mesh(self.ke_cutoff)
        self.mesh = np.asarray(self.mesh, dtype=np.int64)
        self._built = True
        return self

    def _default_ke_cutoff(self) -> float:
        """ke_cutoff so that the steepest primitive is integrated to `precision`.

        exp(-ke/(2 alpha)) ~ precision  =>  ke = 2*alpha*log(1/precision).
        """
        amax = max(
            float(sh.exps.max()) for shells in self._basis.values() for sh in shells
        )
        return 2.0 * amax * np.log(1.0 / self.precision)

    # ------------------------------------------------------------- geometry
    @property
    def vol(self) -> float:
        return abs(np.linalg.det(self.a))

    def reciprocal_vectors(self) -> np.ndarray:
        """Rows b[i] with a @ b.T = 2*pi*I."""
        return 2.0 * np.pi * np.linalg.inv(self.a).T

    @property
    def natm(self) -> int:
        return len(self.atom)

    def atom_coords(self) -> np.ndarray:
        return np.asarray([xyz for _, xyz in self.atom])

    def atom_symbols(self) -> list:
        return [s for s, _ in self.atom]

    def atom_charges(self) -> np.ndarray:
        """Effective (valence) nuclear charges: Z_ion from the pseudopotential
        if present, otherwise the full atomic number."""
        from fftisdf_tpu_torch.basis import data as basis_data
        out = []
        for sym, _ in self.atom:
            if sym in self._pseudo and self._pseudo[sym] is not None:
                out.append(self._pseudo[sym].zion)
            else:
                out.append(basis_data.ATOMIC_NUMBER[basis_data.element_symbol(sym)])
        return np.asarray(out, dtype=np.float64)

    @property
    def nelectron(self) -> int:
        n = int(round(self.atom_charges().sum())) - self.charge
        return n

    # ----------------------------------------------------------------- basis
    def shells(self):
        """Yield (atom_index, symbol, center, Shell) in AO order."""
        for ia, (sym, xyz) in enumerate(self.atom):
            for sh in self._basis[sym]:
                yield ia, sym, xyz, sh

    def nao_nr(self) -> int:
        return sum(sh.nfunc for _, _, _, sh in self.shells())

    # ------------------------------------------------------------------ mesh
    def cutoff_to_mesh(self, ke_cutoff: float) -> np.ndarray:
        """FFT mesh resolving plane waves with |G|^2/2 <= ke_cutoff.

        Along each reciprocal direction the sphere of radius
        Gmax = sqrt(2*ke) must be covered: the number of positive frequencies
        is ceil(Gmax / h_i) with h_i the distance between neighboring
        reciprocal lattice planes, h_i = 2*pi / |a_i'| where a_i' is the
        real-space height.  For any (also non-orthogonal) lattice
        h_i = |b_i . unit-normal| = 2*pi/|a_row_norms as heights|; using
        heights derived from the cell volume keeps this exact.
        """
        gmax = np.sqrt(2.0 * ke_cutoff)
        a = self.a
        # real-space plane distances d_i = vol / area of the face spanned by
        # the other two vectors; then reciprocal plane spacing is 2*pi/d_i...
        # the correct per-axis frequency step is |b_i projected on its normal|:
        b = self.reciprocal_vectors()
        # distance between reciprocal lattice planes along direction i equals
        # 2*pi / |a_i| only for orthogonal cells; in general the max integer
        # n_i with |n_i * b_i_perp| <= Gmax uses the component of b_i
        # orthogonal to the other two b's, which is 2*pi/|a_i|:
        heights = 2.0 * np.pi / np.linalg.norm(a, axis=1)
        n = np.ceil(gmax / heights).astype(int)
        mesh = 2 * n + 1
        return np.asarray([_smooth_size(int(m)) for m in mesh], dtype=np.int64)

    def gen_uniform_grids(self, mesh=None) -> np.ndarray:
        """Uniform real-space grid points (ngrid, 3), C order, last axis fastest."""
        mesh = np.asarray(self.mesh if mesh is None else mesh, dtype=np.int64)
        frac = cartesian_prod([np.arange(m) / m for m in mesh])
        return frac @ self.a

    def get_Gv(self, mesh=None) -> np.ndarray:
        """Reciprocal vectors of FFT bins (ngrid, 3) in fftn frequency order."""
        mesh = np.asarray(self.mesh if mesh is None else mesh, dtype=np.int64)
        freqs = [np.fft.fftfreq(int(m), 1.0 / int(m)) for m in mesh]
        gidx = cartesian_prod(freqs)
        return gidx @ self.reciprocal_vectors()

    # ---------------------------------------------------------------- kpoints
    def get_kpts(self, kmesh) -> np.ndarray:
        """Uniform Monkhorst-Pack k-points without wrap-around.

        Matches the reference convention ``cell.get_kpts(kmesh)`` /
        ``make_kpts(..., wrap_around=False)`` (``fftisdf.py:434``): scaled
        k-points are ``(i/n1, j/n2, k/n3)`` in C order.
        """
        kmesh = np.asarray(kmesh, dtype=np.int64)
        frac = cartesian_prod([np.arange(m) / m for m in kmesh])
        return frac @ self.reciprocal_vectors()

    def get_scaled_kpts(self, kpts) -> np.ndarray:
        return np.asarray(kpts) @ np.linalg.inv(self.reciprocal_vectors())

    # ------------------------------------------------------------------ misc
    def copy(self, **updates) -> "Cell":
        new = dataclasses.replace(self, **updates)
        new._built = False
        return new
