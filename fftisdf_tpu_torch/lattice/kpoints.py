"""k-point utilities: the image<->k phase matrix and k-mesh inference.

The port's copy of the parts of the JAX package's
``fftisdf_tpu/lattice/kpoints.py`` that the port calls.  Native
equivalents of the PySCF helpers the reference uses:
``k2gamma.get_phase`` (``fftisdf.py:28``) and ``kpts_to_kmesh``
(``fftisdf.py:317``).

Conventions:

- Translation vectors ``T_R`` enumerate integer multiples of the lattice
  vectors over the k-mesh: fractional ``(i, j, k)`` with ``0 <= i < n1`` etc.,
  C order (last index fastest) — the same enumeration order as the k-points,
  which makes ``phase`` a (scaled) 3D DFT matrix.
- ``phase[R, k] = exp(1j * k . T_R) / sqrt(nkpt)``, shape ``(nimg, nkpt)``,
  unitary.
"""
from __future__ import annotations

import numpy as np

from fftisdf_tpu_torch.lattice.cell import Cell, cartesian_prod


def translation_vectors(cell: Cell, kmesh) -> np.ndarray:
    """(nimg, 3) lattice translations of the supercell images."""
    kmesh = np.asarray(kmesh, dtype=np.int64)
    ints = cartesian_prod([np.arange(m) for m in kmesh]).astype(np.float64)
    return ints @ cell.a


def get_phase(cell: Cell, kpts: np.ndarray, kmesh) -> np.ndarray:
    """Unitary image<->kpoint DFT matrix, phase[R,k] = e^{i k.T_R}/sqrt(Nk)."""
    tv = translation_vectors(cell, kmesh)
    nkpt = len(kpts)
    return np.exp(1j * tv @ np.asarray(kpts).T) / np.sqrt(nkpt)


def kpts_to_kmesh(cell: Cell, kpts: np.ndarray) -> np.ndarray:
    """Infer the Monkhorst-Pack mesh from an explicit uniform k-point list."""
    scaled = cell.get_scaled_kpts(kpts)
    scaled = scaled - np.floor(scaled)
    kmesh = []
    for d in range(3):
        vals = np.unique(np.round(scaled[:, d], 9) % 1.0)
        kmesh.append(len(vals))
    kmesh = np.asarray(kmesh, dtype=np.int64)
    if np.prod(kmesh) != len(kpts):
        raise ValueError(
            f"k-points do not form a uniform mesh: inferred {kmesh} "
            f"but have {len(kpts)} points"
        )
    return kmesh


def member(kpt_scaled: np.ndarray, kpts_scaled: np.ndarray, tol=1e-8,
           strict=True) -> int:
    """Index of ``kpt_scaled`` in ``kpts_scaled`` modulo reciprocal vectors.

    ``strict=False`` returns -1 for a missing (or ambiguous) point instead
    of raising, so callers can branch on membership (e.g. off-mesh band
    points, shifted meshes without time-reversal partners)."""
    diff = kpts_scaled - kpt_scaled[None, :]
    diff = diff - np.rint(diff)
    hit = np.where(np.all(np.abs(diff) < tol, axis=1))[0]
    if len(hit) != 1:
        if strict:
            raise ValueError("k-point not found (or degenerate) in list")
        return -1
    return int(hit[0])


def _members(targets, kpts_scaled, tol=1e-8):
    """:func:`member` of every row of ``targets`` (..., 3) at once."""
    diff = targets[..., None, :] - kpts_scaled
    diff = diff - np.rint(diff)
    hit = np.all(np.abs(diff) < tol, axis=-1)
    if not (hit.sum(axis=-1) == 1).all():
        raise ValueError("k-point not found (or degenerate) in list")
    return np.argmax(hit, axis=-1).astype(np.int64)


def get_kconserv2(cell: Cell, kpts: np.ndarray) -> np.ndarray:
    """kconserv2[k1,k2] = index of (kpts[k2] - kpts[k1]) mod G."""
    s = cell.get_scaled_kpts(kpts)
    return _members(s[None, :, :] - s[:, None, :], s)


def get_kconserv3(cell: Cell, kpts: np.ndarray) -> np.ndarray:
    """kconserv3[k1,k2,k3] = k4 with k1 - k2 + k3 - k4 = G."""
    s = cell.get_scaled_kpts(kpts)
    return np.stack([_members(s[i] - s[:, None, :] + s[None, :, :], s)
                     for i in range(len(s))])

