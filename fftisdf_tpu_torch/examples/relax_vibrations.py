"""Geometry relaxation and vibrational analysis.

Relaxes an H2 molecule in a periodic box with BFGS on the analytic
reverse-mode forces (``scf.optimize``), then computes harmonic
frequencies from the finite-difference-of-analytic-forces Hessian
(``scf.hessian``).  The port of the JAX package's
``examples/relax_vibrations.py``, with ``--device``/``--dtype`` in place
of ``--tpu``.

    python -m fftisdf_tpu_torch.examples.relax_vibrations [--mesh 20]
        [--d0 2.0] [--box 8.0] [--isdf] [--device cpu]
"""
import argparse
import time

import numpy as np

from fftisdf_tpu_torch.examples import _common

RESULTS = {
    "converged": r"^-> relaxation \(\w+\): converged=(\w+)",
    "steps": r"^-> relaxation .* steps=(\d+)",
    "energy": r"^-> relaxation .* E=(\S+) Ha",
    "bond": r"^-> relaxation .* bond=(\S+) bohr",
    "trajectory": r"^   step \d+: E=(\S+)  max\|F\|=(\S+)  d=(\S+)$",
    "freqs": r"^-> harmonic frequencies \(cm\^-1\): \[(.*)\]",
    "stretch": r"stretch (\S+) cm\^-1\)",
}
# The JAX package takes a warm-started force's W from the previous
# geometry's DIIS-extrapolated Fock; the port from the eigenpairs of F(D)
# of the converged density (a departure on purpose, ROADMAP section 3).
# So the trajectories part after the first step (max|F| 0.137 against
# 0.170 Ha/bohr at step 1) and meet at the minimum: the relaxed energy to
# 1e-6 Ha (fmax 5e-4 Ha/bohr leaves ~1e-7), the bond to 1e-3 bohr, the
# stretch from the finite-difference Hessian (warm-started too) to 1%.
GATES = {"converged": (0, 0), "energy": (0, 1e-6), "bond": (0, 1e-3),
         "stretch": (1e-2, 0)}


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m fftisdf_tpu_torch.examples.relax_vibrations",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--mesh", type=int, default=20)
    p.add_argument("--d0", type=float, default=2.0,
                   help="start bond (bohr)")
    p.add_argument("--box", type=float, default=8.0)
    p.add_argument("--isdf", action="store_true",
                   help="ISDF force backend (per-geometry rebuilt)")
    _common.add_device_args(p)
    return p


def run(args, masks=None, out=print):
    dev, dtype = _common.setup(args)

    from fftisdf_tpu_torch.lattice.cell import Cell, Shell
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf import hessian as scf_hess
    from fftisdf_tpu_torch.scf import optimize as scf_opt

    box = args.box
    shells = [Shell(l=0, exps=np.array([1.3, 0.25]),
                    coeffs=np.array([[0.5], [0.6]]))]
    cell = Cell(
        a=np.diag([box, box, box]),
        atom=[("H", np.array([box / 2, box / 2, box / 2 - args.d0 / 2])),
              ("H", np.array([box / 2, box / 2, box / 2 + args.d0 / 2]))],
        basis={"H": shells}, pseudo=None,
        mesh=np.array([args.mesh] * 3), unit="bohr", precision=1e-12,
    ).build()

    mf = KRHF(cell, cell.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-10,
              dtype=dtype, device=dev)
    backend = "isdf" if args.isdf else "pw"
    kw = ({"isdf_kwargs": {"c0": 40.0, "m0": (9, 9, 9)}}
          if args.isdf else {})

    t0 = time.time()
    res = scf_opt.kernel(mf, fmax=5e-4, max_steps=20, two_electron=backend,
                         **kw)
    bond = np.linalg.norm(res.positions[1] - res.positions[0])
    out(f"-> relaxation ({backend}): converged={res.converged} "
        f"steps={res.nsteps} E={res.energy:.8f} Ha bond={bond:.4f} bohr "
        f"({time.time()-t0:.1f}s)")
    for i, (pos, e, f) in enumerate(res.trajectory):
        d = np.linalg.norm(pos[1] - pos[0])
        out(f"   step {i}: E={e:.8f}  max|F|={f:.2e}  d={d:.4f}")

    t0 = time.time()
    hess, g0 = scf_hess.kernel(res.mf, step=1.5e-3)
    wav, _ = scf_hess.frequencies(res.mf.cell, hess)
    out(f"-> harmonic frequencies (cm^-1): {np.round(wav, 1)} "
        f"({time.time()-t0:.1f}s)")
    out(f"   (3 projected translations ~0; stretch "
        f"{np.abs(wav).max():.1f} cm^-1)")
    return dict(cell=cell, result=res, hess=hess, freqs=wav)


def check(numbers):
    """The relaxation converged and the stretch is a real vibration."""
    bad = [] if all(numbers.get("converged", [])) else ["converged"]
    if not all(w > 100.0 for w in numbers.get("stretch", [0.0])):
        bad.append("no stretch above 100 cm^-1")
    return bad


def main(argv=None, masks=None):
    """Parse, run and print; returns the numbers of the printed lines."""
    lines = _common.Lines()
    run(build_parser().parse_args(argv), masks=masks, out=lines)
    return _common.parse(lines.text(), RESULTS)


if __name__ == "__main__":
    main()
