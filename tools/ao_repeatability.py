#!/usr/bin/env python3
"""Run-to-run and card-against-CPU spread of the port's Bloch-AO values.

    python3 tools/ao_repeatability.py [--reps 20]       # one CUDA card

On diamond gth-szv ke 50, kmesh 1x1x2 (the cell of
tests/test_torch_gpu.py::test_k1_selection_on_cuda_matches_cpu) it
evaluates ``basis.eval.make_evaluator`` at the (9, 9, 9) selection pool
and at the cell's FFT grid ``--reps`` times on the card (a new evaluator
each time) and once on the CPU, and prints, for each point set:

- the card-card spread: the largest |difference| of any repetition from
  the first, and the number of elements that are not bitwise equal;
- the card-CPU spread: the largest |difference| and the number of
  elements past 1e-12 and past 0;
- the home-cell wrap: the number of points whose integer translation
  ``floor(coords @ inv(a))`` differs between the card and the CPU, and
  the card-CPU spread at the other points.

It then runs ``select_interpolation_points`` at that pool ``--reps``
times on the card and once on the CPU and prints the masks' agreement
and the largest |x_k(card) - x_k(CPU)|.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _wrap(torch, coords, a, device):
    c = torch.as_tensor(coords, dtype=torch.float64, device=device)
    ainv = torch.as_tensor(np.linalg.inv(a), dtype=torch.float64,
                           device=device)
    return torch.floor(c @ ainv).cpu().numpy()


def main():
    import torch

    from fftisdf_tpu_torch.basis.eval import make_evaluator
    from fftisdf_tpu_torch.isdf.kpoint import select_interpolation_points
    from fftisdf_tpu_torch.lattice import structure

    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    a = np.asarray(cell.a)
    ok = True
    for label, mesh in (("pool 9^3", (9, 9, 9)),
                        ("FFT grid", tuple(int(m) for m in cell.mesh))):
        coords = cell.gen_uniform_grids(mesh)
        cpu = make_evaluator(cell, kpts=kpts, device="cpu")(coords).numpy()
        cards = [make_evaluator(cell, kpts=kpts, device="cuda")(coords)
                 .cpu().numpy() for _ in range(args.reps)]
        cc = max(float(np.abs(c - cards[0]).max()) for c in cards)
        ncc = max(int((c != cards[0]).sum()) for c in cards)
        d = np.abs(cards[0] - cpu)
        w_card = _wrap(torch, coords, a, "cuda")
        w_cpu = _wrap(torch, coords, a, "cpu")
        moved = (w_card != w_cpu).any(axis=1)
        rest = float(d[:, ~moved].max()) if (~moved).any() else 0.0
        at = float(d[:, moved].max()) if moved.any() else 0.0
        print(f"{label}: {coords.shape[0]} points x {cpu.shape[0]} k x "
              f"{cpu.shape[2]} AOs; card-card max {cc:.3e} ({ncc} elements "
              f"not bitwise equal over {args.reps} runs); card-CPU max "
              f"{float(d.max()):.3e}, {int((d > 1e-12).sum())} elements "
              f"past 1e-12, {int((d > 0).sum())} past 0; wrap differs at "
              f"{int(moved.sum())} points (card-CPU there {at:.3e}, "
              f"elsewhere {rest:.3e})", flush=True)
        ok &= cc == 0.0
    x_c, m_c, r_c, _ = select_interpolation_points(cell, kpts, (9, 9, 9),
                                                   6.0, device="cpu")
    worst, same = 0.0, True
    for _ in range(args.reps):
        x_g, m_g, r_g, _ = select_interpolation_points(
            cell, kpts, (9, 9, 9), 6.0, device="cuda")
        same &= r_g == r_c and np.array_equal(m_g, m_c)
        worst = max(worst, float((x_g.cpu() - x_c).abs().max()))
    print(f"selection: masks and ranks equal in {args.reps} card runs: "
          f"{same}; max |x_k(card) - x_k(CPU)| {worst:.3e}", flush=True)
    ok &= same and worst <= 1e-12
    print("OK" if ok else "SPREAD")


if __name__ == "__main__":
    main()
