#!/usr/bin/env python3
"""Where the float32 regime's error comes from, at the production width.

    python3 tools/f32_production_check.py        # one CUDA card, ~4.5 min

NiO AFM gth-dzvp-molopt-sr ke 200, kmesh 4x4x4, c0 40, m0 15^3 (nip 2480),
the production configuration of chip_smoke.py.  Builds the float64 state
and converges DeviceKUHF on it (the reference), then builds float32 states
on the same interpolation points (the defaults rcond 1e-5 / refine 2, then
rcond 1e-6, then refine 0) and prints for each: the error of its J/K
against the float64 state's on the initial-guess and on the converged
density, and the energy of the float64 density under its J/K.  For the
default float32 state it also converges the host loop (float64 and float32
integrals) and the device loop (float64 and float32) and prints each
energy's distance to the float64 one per atom, the Ni moments, and how far
the float32 overlap and core Hamiltonian are from the float64 ones.
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fftisdf_tpu_torch.isdf import FFTISDF  # noqa: E402
from fftisdf_tpu_torch.scf import KUHF, DeviceKUHF  # noqa: E402
from fftisdf_tpu_torch.scf.analysis import (  # noqa: E402
    atom_charges_and_moments)

F32 = torch.float32
BUILD = dict(c0=40.0, m0=(15, 15, 15), verbose=0)


def main():
    cs.require_cuda()
    log = cs.log
    log(cs.phase0_environment(torch))
    cell, kpts = cs._production_cell()
    df64 = FFTISDF(cell, kpts, **BUILD).build()
    mf64 = DeviceKUHF(cell, kpts, df64, verbose=0, **cs.SCF_KW)
    mf64.kernel()
    log(f"float64: e_tot {mf64.e_tot:.10f} in {mf64.cycles} cycles")
    dms = {"guess": mf64.get_init_guess(), "converged": mf64.dm}
    ref = {k: df64.get_jk(d) for k, d in dms.items()}
    se = np.linalg.eigvalsh(mf64.s1e)
    log(f"overlap: smallest/largest eigenvalue over k "
        f"{(se[:, 0] / se[:, -1]).min():.2e}; directions below 2e-6 of the "
        f"largest: {int((se < 2e-6 * se[:, -1:]).sum())} over {len(kpts)} k")
    _, vj, vk = mf64.get_fock(mf64.dm)
    e_ref = mf64.energy_elec(mf64.dm, vj, vk)
    mask = df64.mask
    del df64
    mf64.with_df = None
    torch.cuda.empty_cache()
    for tag, kw in (("rcond 1e-5 refine 2 (defaults)", {}),
                    ("rcond 1e-6", dict(rcond=1e-6)),
                    ("refine 0", dict(refine=0))):
        df = FFTISDF(cell, kpts, dtype=F32, **BUILD, **kw).build(mask=mask)
        for name, dm in dms.items():
            errs = cs._maxerrs(*df.get_jk(dm), *ref[name])
            log(f"float32 {tag}, {name} density: " + ", ".join(
                f"{n} error {e:.3e} (scale {sc:.3f})"
                for n, (e, sc) in errs.items()))
        mf64.with_df = df
        _, vj, vk = mf64.get_fock(mf64.dm)
        de = mf64.energy_elec(mf64.dm, vj, vk) - e_ref
        log(f"float32 {tag}: energy of the float64 density under float32 "
            f"J/K {de:+.3e} Ha ({de / cell.natm:+.3e} Ha/atom)")
        mf64.with_df = None
        if not kw:
            _loops(cell, kpts, df, mf64)
        del df
        torch.cuda.empty_cache()


def _loops(cell, kpts, df, mf64):
    for name, cls, kw in (
            ("host KUHF, float64 integrals", KUHF, {}),
            ("host KUHF, float32 integrals", KUHF, dict(dtype=F32)),
            ("DeviceKUHF, float64 loop", DeviceKUHF, {}),
            ("DeviceKUHF, float32 loop", DeviceKUHF, dict(dtype=F32))):
        t0 = time.perf_counter()
        mf = cls(cell, kpts, df, verbose=0, **cs.SCF_KW_F32, **kw)
        if kw and cls is KUHF:
            cs.log(f"float32 integrals: max|S32 - S64| "
                   f"{np.abs(mf.s1e - mf64.s1e).max():.2e}, max|h32 - h64| "
                   f"{np.abs(mf.h1e - mf64.h1e).max():.2e}")
        mf.kernel()
        _, mom = atom_charges_and_moments(cell, mf.dm, mf.s1e)
        cs.log(f"{name}: e_tot {mf.e_tot:.10f} conv {mf.converged} cycles "
               f"{mf.cycles}, |dE| {abs(mf.e_tot - mf64.e_tot) / cell.natm:.3e}"
               f" Ha/atom, Ni moments {mom[0]:+.4f} {mom[1]:+.4f}, "
               f"{time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
