#!/usr/bin/env python3
"""Where the device-resident KUHF stops against the host loop, on the
recorded points of nio_northstar's part A.

    python3 tools/device_loop_stop.py                   # one CUDA card

On NiO AFM gth-szv ke 50, kmesh 1x1x2 (the JAX record of
``examples/nio_northstar.py --skip-b --ke-a 50 --kmesh-a 1 1 2
--max-cycle 200`` in tests/data/jax_example_outputs.json) it runs the
exact plane-wave KUHF as the example does (conv_tol 1e-8, then again to
1e-10 from its density), and prints its energy against the record's.
Then, for the first three ISDF arms on the record's interpolation
points, it runs ``DeviceKUHF`` and the host ``KUHF`` at conv_tol 1e-8
and 1e-10, each from the exact arm's density (the example's start) and
from its own, and prints each energy, its cycles and its difference from
the record's arm (the JAX host loop at 1e-8 from its exact density).
"""
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main():
    import torch

    from fftisdf_tpu_torch.examples.nio_northstar import INIT_SPIN, _cell
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KUHF, DeviceKUHF

    rec = json.loads((REPO / "tests" / "data" / "jax_example_outputs.json")
                     .read_text())["examples"]["nio_northstar"]
    ref = [json.loads(line) for line in rec["stdout"].splitlines()
           if line.startswith("{")]
    dev = torch.device("cuda")
    cell = _cell("gth-szv", 50.0)
    kpts = cell.get_kpts([1, 1, 2])
    kw = dict(init_spin=INIT_SPIN, smearing=5e-3, device=dev)
    mf0 = KUHF(cell, kpts, verbose=0, conv_tol=1e-8, max_cycle=200, **kw)
    e0 = mf0.kernel()
    print("exact", e0, mf0.converged, mf0.cycles, "jax",
          ref[1]["e_exact_ha"], e0 - ref[1]["e_exact_ha"], flush=True)
    mf0b = KUHF(cell, kpts, verbose=0, conv_tol=1e-10, max_cycle=300, **kw)
    e0b = mf0b.kernel(dm0=mf0.dm)
    print("exact tol1e-10", e0b, mf0b.converged, mf0b.cycles,
          e0b - ref[1]["e_exact_ha"], flush=True)
    for i, (m, r) in enumerate(zip(rec["masks"][:3], ref[2:5])):
        df = FFTISDF(cell, kpts, c0=r["c0"], m0=tuple(m["m0"]), verbose=0,
                     device=dev).build(mask=m["mask"])
        for name, cls, tol in (("device", DeviceKUHF, 1e-8),
                               ("host", KUHF, 1e-8),
                               ("device", DeviceKUHF, 1e-10),
                               ("host", KUHF, 1e-10)):
            for start, dm in (("exact", mf0.dm), ("own", None)):
                mf = cls(cell, kpts, with_df=df, verbose=0, conv_tol=tol,
                         max_cycle=200, **kw)
                e = mf.kernel(dm0=dm)
                print(f"arm {i} {name:6s} tol {tol:g} start {start}: "
                      f"{e:.10f} conv {mf.converged} cyc {mf.cycles} "
                      f"- jax {e - r['e_isdf_ha']:+.2e}", flush=True)


if __name__ == "__main__":
    main()
