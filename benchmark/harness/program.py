"""The calls into the system under test, ``fftisdf_tpu_torch``, made from
a configuration file and a traffic mix.  Imports of the program happen
inside these functions, so this module loads without it."""
from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def make_cell(cfg, lattice, atoms):
    """The program's cell at a geometry in bohr, and its k-points."""
    from fftisdf_tpu_torch.lattice.cell import Cell

    cell = Cell(a=np.asarray(lattice), atom=[(s, np.asarray(x))
                                              for s, x in atoms],
                basis=cfg["basis"], pseudo=cfg["pseudo"],
                ke_cutoff=float(cfg["ke_cutoff"]),
                exp_to_discard=cfg.get("exp_to_discard"),
                unit="bohr").build()
    return cell, cell.get_kpts(cfg["kmesh"])


def make_isdf(cfg, cell, kpts, dtype, device):
    from fftisdf_tpu_torch.isdf import FFTISDF

    return FFTISDF(cell, kpts, c0=float(cfg["c0"]), m0=tuple(cfg["m0"]),
                   verbose=0, dtype=dtype, device=device)


def scf_kwargs(cfg, mix, dtype, conv_tol):
    """Keyword arguments of the SCF class: every key of the
    configuration's ``scf`` block and then of the mix's, but ``method``
    and ``driver``; a mapping keyed by whole numbers (``init_spin``) gets
    integer keys."""
    out = {}
    for block in (cfg.get("scf", {}), mix.get("scf", {})):
        for key, val in block.items():
            if key in ("method", "driver"):
                continue
            if isinstance(val, dict) and all(k.lstrip("-").isdigit()
                                             for k in val):
                val = {int(k): v for k, v in val.items()}
            out[key] = val
    out.update(conv_tol=float(conv_tol), verbose=0, dtype=dtype)
    return out


def make_scf(cfg, mix, cell, kpts, df, dtype, conv_tol, device):
    """The SCF object of the mix's SCF class (``driver``, a class of
    ``fftisdf_tpu_torch.scf``); its constructor sets up the one-electron
    integrals."""
    import fftisdf_tpu_torch.scf as scf_mod

    cls = getattr(scf_mod, mix["scf"]["driver"])
    return cls(cell, kpts, with_df=df, device=device,
               **scf_kwargs(cfg, mix, dtype, conv_tol))
