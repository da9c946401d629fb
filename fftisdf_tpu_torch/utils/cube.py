"""Gaussian cube-file export of real-space fields (densities, orbitals).

The port of the JAX package's ``fftisdf_tpu/utils/cube.py``: the standard
visualization interchange format (VMD/VESTA/Avogadro), written from the
framework's own uniform FFT grid.  :func:`write_cube` and :func:`read_cube`
are numpy only and write the same text as the JAX package's for the same
cell and field.  The fields are computed on the SCF's device: the Bloch
AOs are evaluated in grid blocks sized from the device's free memory (the
full-grid AO tensor is not kept by the HF drivers, and at production it
would hold 15.9 GB), reduced there, and only the real (ngrid,) field comes
to the host.

Grid convention: the cell's C-ordered uniform mesh (last axis fastest),
which is exactly the cube format's inner-loop order, so fields reshape
without transposition.  Units are Bohr throughout (cube standard).
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.utils.device import (as_tensor, memory_blocks,
                                            real_complex)


def write_cube(path, cell, field, comment="fftisdf_tpu field",
               mesh=None):
    """Write a real scalar ``field`` (ngrid,) on the cell's uniform mesh.

    The voxel vectors are a_i / mesh_i; positive mesh counts mark Bohr
    units per the cube spec."""
    from fftisdf_tpu_torch.basis import data as basis_data

    mesh = np.asarray(mesh if mesh is not None else cell.mesh, dtype=int)
    field = np.asarray(field, dtype=float).ravel()
    ng = int(np.prod(mesh))
    if field.size != ng:
        raise ValueError(f"field has {field.size} values, mesh wants {ng}")
    a = np.asarray(cell.a, dtype=float)
    coords = cell.atom_coords()
    lines = [comment.splitlines()[0] if comment else "fftisdf_tpu",
             "scalar field on the uniform FFT mesh (Bohr)"]
    lines.append(f"{cell.natm:5d} {0.0:12.6f} {0.0:12.6f} {0.0:12.6f}")
    for i in range(3):
        v = a[i] / mesh[i]
        lines.append(f"{int(mesh[i]):5d} {v[0]:12.6f} {v[1]:12.6f} "
                     f"{v[2]:12.6f}")
    for (sym, _), xyz in zip(cell.atom, coords):
        z = int(basis_data.ATOMIC_NUMBER[basis_data.element_symbol(sym)])
        ps = cell._pseudo.get(sym) if cell._pseudo else None
        q = float(ps.zion) if ps is not None else float(z)
        lines.append(f"{z:5d} {q:12.6f} {xyz[0]:12.6f} {xyz[1]:12.6f} "
                     f"{xyz[2]:12.6f}")
    vals = field.reshape(-1)
    for i0 in range(0, ng, 6):
        lines.append(" ".join(f"{v:13.5e}" for v in vals[i0:i0 + 6]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def read_cube(path):
    """Parse a cube file back: (cell_meta dict, field (ngrid,)).

    Round-trip helper (and test oracle): returns the mesh, voxel matrix,
    atom rows, and the flat field in file order."""
    with open(path) as f:
        lines = f.read().splitlines()
    natm = int(lines[2].split()[0])
    mesh, vox = [], []
    for i in range(3):
        parts = lines[3 + i].split()
        mesh.append(int(parts[0]))
        vox.append([float(x) for x in parts[1:4]])
    atoms = []
    for i in range(natm):
        parts = lines[6 + i].split()
        atoms.append((int(parts[0]), float(parts[1]),
                      [float(x) for x in parts[2:5]]))
    field = np.array(" ".join(lines[6 + natm:]).split(), dtype=float)
    return {"mesh": np.array(mesh), "voxels": np.array(vox),
            "atoms": atoms}, field


def rho_kernel(ao, dm):
    """sum_k ao[k] dm[k] ao[k]^H on the diagonal, real, / nk: (ng,) from
    ao (nk, ng, nao) and dm (nk, nao, nao) (the JAX package's
    ``_rho_kernel``)."""
    return (torch.matmul(ao, dm) * ao.conj()).sum(dim=(0, 2)).real \
        / ao.shape[0]


def mo_kernel(ao, c):
    """ao (ng, nao) @ c (nao,): one orbital on the grid (the JAX package's
    ``_mo_kernel``)."""
    return torch.matmul(ao, c)


def _grid_blocks(mf, kpts, ntemp):
    """(evaluator, coords on the device, grid slices) for ``kpts``: a block
    holds ``ntemp`` complex (nk, ng, nao) planes within a quarter of the
    device's free memory."""
    rdt, cdt = real_complex(mf.dtype)
    cell = mf.cell
    fn = make_evaluator(cell, kpts=kpts, dtype=rdt, device=mf.device)
    coords = torch.as_tensor(cell.gen_uniform_grids(), dtype=rdt,
                             device=mf.device)
    per_point = ntemp * len(kpts) * cell.nao_nr() * cdt.itemsize
    return fn, coords, memory_blocks(len(coords), per_point, mf.device)


def density_on_grid(mf, dm=None, spin=None):
    """Real-space density (ngrid,) from a converged driver's density
    matrix on its own FFT mesh, computed on ``mf.device``.  ``spin``:
    None -> total density (or the total over both channels for
    unrestricted), 'diff' -> spin density n_a - n_b, 0/1 -> one
    channel."""
    dm = np.asarray(mf.dm if dm is None else dm)
    if dm.ndim == 4:
        if spin == "diff":
            dm = dm[0] - dm[1]
        elif spin in (0, 1):
            dm = dm[spin]
        else:
            dm = dm[0] + dm[1]
    elif spin not in (None,):
        raise ValueError("spin-resolved export needs an unrestricted dm")
    cdt = real_complex(mf.dtype)[1]
    dm_t = as_tensor(dm.astype(np.complex128), mf.device, cdt)
    # the AO block, its product with dm and the elementwise product
    fn, coords, blocks = _grid_blocks(mf, mf.kpts, 4)
    rho = torch.empty(len(coords), dtype=real_complex(mf.dtype)[0],
                      device=mf.device)
    for sl in blocks:
        rho[sl] = rho_kernel(fn(coords[sl]), dm_t)
    return rho.cpu().numpy().astype(float)


def write_density_cube(mf, path, dm=None, spin=None,
                       comment="electron density"):
    """Density (or spin density, ``spin='diff'``) -> cube file."""
    rho = density_on_grid(mf, dm=dm, spin=spin)
    return write_cube(path, mf.cell, rho, comment=comment)


_PARTS = {"real": lambda psi: psi.real, "imag": lambda psi: psi.imag,
          "abs2": lambda psi: psi.abs().square()}


def mo_on_grid(mf, k=0, n=0, spin=None, part="real"):
    """One crystal orbital's ``part`` of psi_{kn}(r) (ngrid,), computed on
    ``mf.device``: 'real' | 'imag' | 'abs2'."""
    c = mf.mo_coeff[spin] if spin in (0, 1) else mf.mo_coeff
    c_kn = np.asarray(c[k])[:, n]
    cdt = real_complex(mf.dtype)[1]
    c_t = as_tensor(c_kn.astype(np.complex128), mf.device, cdt)
    take = _PARTS[part]
    fn, coords, blocks = _grid_blocks(mf, np.asarray(mf.kpts)[k:k + 1], 2)
    field = torch.empty(len(coords), dtype=real_complex(mf.dtype)[0],
                        device=mf.device)
    for sl in blocks:
        field[sl] = take(mo_kernel(fn(coords[sl])[0], c_t))
    return field.cpu().numpy().astype(float)


def write_mo_cube(mf, path, k=0, n=0, spin=None, part="real",
                  comment=None):
    """One crystal orbital psi_{kn}(r) -> cube file.

    ``part``: 'real' | 'imag' | 'abs2'.  Bloch orbitals at k != 0 are
    complex; 'abs2' writes the gauge-invariant density of the orbital."""
    field = mo_on_grid(mf, k=k, n=n, spin=spin, part=part)
    comment = comment or f"crystal orbital k={k} n={n} ({part})"
    return write_cube(path, mf.cell, field, comment=comment)
