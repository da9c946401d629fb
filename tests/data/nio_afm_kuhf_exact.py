"""Writes nio_afm_kuhf_exact.json: the JAX package's exact plane-wave KUHF
energy of the NiO anchor, the reference of chip_smoke.py phase 5b.

It runs the exact arm of ``python examples/nio_afm_kuhf.py --exact`` (the
JAX package on the CPU in f64, KUHF with ``with_df=None``, i.e. PWDF) with
the same calls, except ``max_cycle`` (200 here; the example's 80 stops
before convergence, and the file keeps that printed energy under
``example_as_written``).  About 25 minutes on 8 CPU cores.

    python tests/data/nio_afm_kuhf_exact.py
"""
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
OUT = HERE / "nio_afm_kuhf_exact.json"
MAX_CYCLE = 200


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from fftisdf_tpu.lattice import structure
    from fftisdf_tpu.scf import KUHF
    from fftisdf_tpu.scf.analysis import atom_charges_and_moments

    config = {"structure": "nio_afm", "basis": "gth-szv",
              "pseudo": "gth-pade", "ke_cutoff": 50.0,
              "exp_to_discard": 0.1, "kmesh": [1, 1, 2], "smearing": 5e-3,
              "init_spin": {"0": 1.0, "1": -1.0}, "conv_tol": 1e-8,
              "max_cycle": MAX_CYCLE, "level_shift": 0.0}
    cell = structure.to_cell(*structure.nio_afm(), basis=config["basis"],
                             pseudo=config["pseudo"],
                             ke_cutoff=config["ke_cutoff"],
                             exp_to_discard=config["exp_to_discard"])
    kpts = cell.get_kpts(config["kmesh"])
    t0 = time.time()
    mf = KUHF(cell, kpts, verbose=3, conv_tol=config["conv_tol"],
              max_cycle=MAX_CYCLE, init_spin={0: +1.0, 1: -1.0},
              level_shift=0.0, smearing=config["smearing"])
    e = mf.kernel()
    _, moments = atom_charges_and_moments(cell, mf.dm, mf.s1e)
    old = json.loads(OUT.read_text()) if OUT.exists() else {}
    out = {
        "source": ("JAX package (fftisdf_tpu) on CPU in f64: the exact "
                   "plane-wave KUHF arm of `python examples/nio_afm_kuhf.py "
                   "--exact` (KUHF with with_df=None, i.e. PWDF), the same "
                   f"calls with max_cycle {MAX_CYCLE} in place of 80, "
                   "written by tests/data/nio_afm_kuhf_exact.py"),
        "config": config,
        "e_tot": float(e),
        "converged": bool(mf.converged),
        "cycles": int(mf.cycles),
        "moments": [float(m) for m in moments],
    }
    if "example_as_written" in old:
        out["example_as_written"] = old["example_as_written"]
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"e_tot {e!r} converged {mf.converged} cycles {mf.cycles} "
          f"({time.time() - t0:.1f}s) -> {OUT}")


if __name__ == "__main__":
    main()
