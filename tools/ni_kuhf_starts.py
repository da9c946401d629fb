"""Which state the Ni pseudo-atom's uncontracted KUHF (chip_smoke.py phase
13c, examples/derive_atomic_basis.py --elem Ni --ke 240) lands in, from
its plain core-Hamiltonian start and from the starts that
chip_smoke._ni_start makes, one for each d component left as the hole.

    python tools/ni_kuhf_starts.py [--repeat N]   # on a CUDA card

Prints, for the plain start, the core-Hamiltonian levels of each spin
around its highest occupied one, and for every start the converged
energy, cycles and the d populations per spin and component (xy, yz,
z^2, xz, x^2-y^2), one JSON line each, then the card's name and power
limit.  ``--repeat``: the plain start's KUHF that many times."""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from fftisdf_tpu_torch.examples import derive_atomic_basis as dab  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=1)
    a = ap.parse_args()
    import torch

    from fftisdf_tpu_torch.scf import KUHF
    from fftisdf_tpu_torch.scf.hf import _eigh_gen

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cell = dab.box_cell("Ni", 12.0, 240.0)
    kpts = cell.get_kpts([1, 1, 1])
    kw = dab.KUHF_KW
    mf = KUHF(cell, kpts, **kw)
    e, _ = _eigh_gen(mf.h1e[0], mf.s1e[0], cutoff=mf.ovlp_cutoff)
    for s, n in enumerate(mf.nocc_ab):
        print(json.dumps({"spin": s, "nocc": int(n),
                          "hcore_levels": [float(v) for v in
                                           e[max(n - 6, 0):n + 4]],
                          "homo_index": int(n - 1)}), flush=True)
    starts = [("plain", None)] * a.repeat + [
        (f"hole d{m}", m) for m in range(5)]
    for name, m in starts:
        mf = KUHF(cell, kpts, **kw)
        dm0 = None if m is None else cs._ni_start(mf, m)
        t0 = time.perf_counter()
        e_tot = mf.kernel(dm0=dm0)
        print(json.dumps({
            "start": name, "e_tot": float(e_tot),
            "converged": bool(mf.converged), "cycles": int(mf.cycles),
            "seconds": time.perf_counter() - t0,
            "d_pop": np.round(cs._d_populations(mf), 6).tolist()}),
            flush=True)
        del mf
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())


if __name__ == "__main__":
    main()
