#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fftisdf_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure raises and the script exits non-zero:

0. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the builds, started together, of kernel K1 from
   ops/csrc/pair_gram.cu (nvcc) and of the port's native lattice engine
   from native/csrc/lattice_engine.cpp (g++), with their build times,
   K1's ptxas registers, shared memory and spills (the complex64 kernel
   must not spill), and the tensor-core instructions of each K1 kernel in
   the built library (cuobjdump -sass; the complex64 kernel must hold TF32
   HMMA);
1. K1 against its plain PyTorch version on the card, in complex64 and
   complex128, both ``square`` values: the JAX package's Pallas test
   shapes, ragged shapes, the main-path shape (64, 3375, 26), the
   production width (64, 3375, 62), a non-contiguous X, an 8-byte-aligned
   view ``x[..., 1:]`` and a conjugate view.  Every complex64 case is also
   held against the complex128 gram of the same input: the kernel's error
   may be at most 4x that of the plain complex64 version (cuBLAS in full
   FP32), or 4 x 2^-21 of the scale where that is larger (3xTF32's own
   error for a single product).  At the two large shapes (complex128 and
   complex64, ``square=False``), CUDA-event times of the kernel, the plain
   version and one PyTorch library call of the same function
   (``(xt.conj() @ xt.mT).abs().square() / nk**2`` on the (ng, K) matrix,
   made before the timing, TF32 off; for complex64 also the kernel on the
   same shape with an odd row stride, which takes the loader's 8-B copies
   in place of 16-B ones), in 5 rounds of turns, each turn's SM clock, power draw and temperature as nvidia-smi
   samples them every 20 ms; the median turn of each, with the spread, the
   flop rate of the work done (the upper triangle) and the share of the
   bound (complex64: of the 3xTF32 tensor-core bound, beside the FP32
   bound outside the tensor cores);
2. device against host: diamond gth-szv ke 50, kmesh 1x1x2, c0 10, built and
   solved by KUHF on the GPU and on the CPU (J/K to 1e-10 relative, e_tot to
   1e-9 Ha);
3. the JAX anchor: NiO AFM, the defaults of examples/nio_afm_kuhf.py, run
   by the port's entry point (fftisdf_tpu_torch.examples.nio_afm_kuhf,
   DeviceKUHF on the card) against the JAX package's energy recorded in
   tests/data/nio_afm_kuhf_anchor.json (1e-6 Ha).  The port is given the JAX
   package's interpolation points: on this symmetric cell selection meets
   exact ties that two implementations break differently.  The port's own
   selection is run as well and its energy printed beside;
4. the slice: NiO AFM gth-szv ke 100, kmesh 4x4x4, c0 40, m0 15^3, KUHF with
   the AFM bias and Fermi smearing 5e-3, max_cycle 80, conv_tol 1e-8, on the
   GPU, through the public entry points (FFTISDF.build, get_jk, KUHF.kernel)
   on their default device; K1's launch count is reset right before it and
   must be >= 1 after; nip must be 1040 and e_tot within 1e-6 Ha of the
   recorded slice energy;
5. the exact plane-wave oracle (PWDF): (a) diamond, J/K with
   exxdiv='ewald' on the GPU against the CPU (1e-10 relative); (b) the
   anchor's exact-PW KUHF on the GPU against the JAX package's exact energy
   recorded in tests/data/nio_afm_kuhf_exact.json (1e-6 Ha), with the
   ISDF-vs-exact dE/atom; (c) the slice's ISDF J/K against the port's exact
   J/K on the JAX bench's test density, vj/vk_maxerr = max|ISDF - exact|
   beside their scales max|exact| (each finite and below 1e-2), with the
   exact arm's seconds;
6. the device-resident SCF loop (DeviceKUHF): (a) on the slice's build
   against the host KUHF (3e-8 Ha), s/cycle of both; (b) the production
   configuration, NiO AFM gth-dzvp-molopt-sr ke 200, kmesh 4x4x4, c0 40,
   m0 15^3, through the default-device entry points with K1's count reset
   right before the build: K1 launched, nip 2480, DeviceKUHF converged
   with Ni moments of opposite sign, equal to the host KUHF on the same
   build (3e-8 Ha); stage times, setup, warm get_jk, cycles, s/cycle and
   peak memory.  At both shapes the device loop's parts (eigensolve,
   ADIIS, CDIIS, bisection) are timed on seeded random inputs;
7. every other way to build and serve the metric, through the
   default-device entry points: (a) the float32 regime on the slice, once
   with the default selection (float64, matrix-free, on the card) and once
   with ``select_host_f64=False``, which must launch K1 in complex64 at
   (64, 3375, 26); vj/vk_maxerr of each against phase 5c's float64 exact
   J/K (finite, below 1e-2 with the default selection and below 2e-2 with
   K1's float32 pivot order), KUHF and DeviceKUHF in float32 converged
   (conv_tol 1e-6, the float32 noise floor),
   |e_tot - the float64 slice's| per atom printed and gated; (b) the
   production configuration in float32 at full width (nip 2480): stage
   seconds, sector chunks, peak memory, warm get_jk, DeviceKUHF cycles and
   s/cycle, dE/atom against phase 6b's float64 energy, each beside phase
   6b's figure; (c) m0='auto' and ``select_keep`` on the production cell:
   the mesh chosen, the densify steps, nip and rank; (d) diamond built
   with each of lstsq | pinv | svd, J/K against the ridge build (lstsq =
   pinv to 1e-10, svd to 1e-6, each within 1e-4 of ridge, relative);
   (e) the anchor's ``get_jk(omega=w)`` for w > 0 and w < 0 against
   ``PWDF.get_jk(omega=w)`` (below 1e-2) and erf + erfc = bare on w_q
   (1e-10 relative); (f) He2 in a box, full rank, 0d and 2d truncation
   against the exact oracle with the same kernel (1e-9);
8. the rest of the ISDF layer, with K1's count reset right before: (a)
   phase 6b's host KUHF checkpointed (``save``), reloaded (``load_chk``)
   and restarted on phase 6b's build (held in host memory through phase
   7): converged in at most 2 cycles to its energy (1e-8 Ha); ``mulliken``
   on the result (populations sum to nelec to 1e-8, Ni moments +-1.9336 of
   opposite sign, equal to ``atom_charges_and_moments``); the NiO cell
   through ``format_poscar`` and ``parse_poscar``; (b) the compact cderi
   serve on phase 4's slice state (signed factors, ``k2_chunk = nk // 8``):
   vj against the ISDF serve to 1e-8, vk to 1e-8 on the time-reversal-
   symmetric part of w_q that the serve uses (the raw difference printed),
   vj/vk_maxerr against phase 5c's exact J/K, the seconds of the
   factorisation, the cderi J/K and the ISDF get_jk; (c) ``get_bands`` on
   phase 6a's converged KUHF: at 2 mesh points against the converged
   Fock's eigenvalues (1e-3 Ha: the band serve re-fits each pair where the
   SCF's serve fits the q sector, so they agree to the compression error),
   along a 9-point L-Gamma-X path (the indirect gap, seconds a point), at 2
   path points against the exact band path (1e-3 of the scale, the gate of
   tests/test_isdf_bands.py), and the exact band path at a mesh point
   against phase 5c's mesh serve (1e-10); (d) SCF-level truncation: H2 in
   0d boxes of 9, 11 and 12.5 bohr (exact, ISDF on the JAX package's
   points and on its own) and the H2 monolayer in 2d with exxdiv='ewald'
   at lz 12 and 16, each within 1e-6 Ha of the JAX package's energy in
   tests/data/jax_port_refs.json, the textbook -1.1167 Ha within 0.011,
   the monolayer's vacuum independence within 2e-4; (e) the tools on the
   card against the CPU: the full-rank Gamma-point fit on phase 2's
   diamond (pairs to 1e-10), LS-THC on He2 on the uniform and Becke grids
   (1e-7 / 5e-5), ``mo_eri`` against ``get_eri`` rotated to MOs and
   ``whiten_basis`` per sector on a full-rank He2 build;
9. Kohn-Sham DFT (``scf.ks``, ``scf.xc``, ``scf.hubbard``, ``scf.dos``)
   through the default-device entry points: (a) diamond 1x1x2 on the JAX
   package's points (c0 40, m0 9^3), KRKS-LDA/PBE/B3LYP/SCAN/HSE06 and
   KUKS-LDA+U each built and solved on the card and on the CPU (e_tot to
   1e-9 Ha, Vxc of one density to 1e-10 relative, the JAX package's
   energies of tests/data/jax_port_refs.json to 1e-8), SCAN bands at the
   mesh points on the card (5e-5 Ha), and a central difference of
   exc_and_vxc on the card for PBE and SCAN (1e-7 / 1e-6); (b) KUKS-PBE
   and KUKS-PBE+U (U_eff 6.2 eV on the Ni d shells) on the anchor, on the
   JAX package's points, within 1e-6 Ha of the JAX package's energies in
   tests/data/nio_afm_kuks_anchor.json, Ni moments beside its; (c) on phase
   4's slice build, DeviceKUKS against the host KUKS (3e-8 Ha) for PBE+U,
   PBE0 and HSE06 (one erfc-screened metric pass), SCAN and PBE on the
   host, each converged (max_cycle 150), s/cycle of both loops and the xc
   pass's ms and peak; at 2 mesh points the band path's Vxc (PBE+U, SCAN,
   PBE) and V_U (PBE+U) against the SCF's matrices there (1e-10
   relative), and KUKS-PBE bands against the converged Fock's eigenvalues
   (1e-3 Ha, the band serve's re-fit of J);
   KUKS-PBE on a float32 build within 2e-2 Ha/atom of float64; (d) on
   phase 6b's production build (whose selection launched K1),
   DeviceKUKS-PBE+U converged to an AFM state (Ni moments of opposite
   sign) and equal to the host KUKS-PBE+U (3e-8 Ha): cycles, s/cycle, time
   to the converged energy, peak memory, the xc pass's ms and bytes, the
   cycle's parts timed alone at its shapes (eigensolve, ADIIS, CDIIS,
   bisection, the J serve, +U on the card and the host loop's +U), the
   Mulliken and Loewdin moments and the Loewdin-projected DOS (the
   states below the Fermi level, by atom and spin);
10. the many-body layer (``scf.mp2``, ``rpa``, ``gw``, ``tddft``,
   ``bse``) through the default-device entry points, with K1's count
   reset right before and >= 1 after: (a) on the H2 chain of
   tests/test_mp2.py (gamma and 1x1x2) and diamond gth-szv ke 50 1x1x2,
   on the JAX package's points and orbitals, kmp2, kump2, drpa, Sigma^c
   and G0W0, CIS/TDA-PBE/B3LYP/HSE06, UTDA, Casida and BSE on the card
   and on the CPU (1e-10 relative; QP energies 1e-6 Ha, their Newton
   solve's stopping scale) and against tests/data/jax_port_refs.json
   (1e-8); the JAX tests' identities on the card (kump2 of a closed shell
   = kmp2, orbital phases move nothing, closed-shell UTDA = singlet +
   triplet, BSE with the bare W = CIS, KRKS(xc='hf') TDA = CIS, Sigma
   against the ov-space and pole oracles, the PBE kernel's HVP against a
   central difference); examples/exciton_dispersion.py at its defaults
   (diamond gth-szv ke 50 2x2x2 c0 40, every q, --eels); (b) on phase
   6a's KUHF on the slice (re-converged without smearing if its
   occupations are not integral to 1e-6), kump2 over the 262,144
   k-triples and UTDA-CIS (4 roots, Davidson, the matvec's ms); (c)
   diamond gth-dzvp ke 200 4x4x4, c0 40, m0 15^3 (nip 1040): KRHF and
   KRKS-PBE, kmp2 = kump2 (1e-10), drpa (nw 24), G0W0 of HOMO-1..LUMO+1
   (nw 40, npade 18; the QP gap above PBE's), TDA-PBE singlet and triplet
   at q 0 and 1 (4 roots, Davidson converged), oscillator strengths, BSE
   on the G0W0 energies (4 roots), each with its seconds and peak memory;
   (d) NiO production on the 2x2x2 sub-mesh (nip 2480): DeviceKUHF and
   DeviceKUKS-PBE+U (Ni moments of opposite sign; re-converged without
   smearing where the occupations are fractional), kump2 and UTDA (CIS,
   the PBE kernel) on each;
11. FCI, DMET and the CC layer (``scf.fci``, ``dmet``, ``cc``) through the
   default-device entry points, with K1's count reset right before and
   >= 1 after: (a) on the H2 chain of tests/test_cc.py (gamma and 1x1x2)
   and diamond gth-szv ke 50 1x1x2 (c0 40, m0 9^3), on the JAX package's
   points and orbitals, kccsd, kccsd_t, eomee (dense and Davidson),
   eomip/eomea, onerdm, ao_density, the CCSD of a KS reference and of the
   spin-2 KUHF, dmet_energy with the FCI and the CCSD solvers with and
   without the mu fit (on diamond with one carbon's 2s AO and with its 4
   AOs, the latter on the card alone: FCI over 4900 determinants), and
   fci_ground / ccsd_solver on a random embedding problem, on the card and
   on the CPU (1e-10 relative) and against tests/data/jax_port_refs.json
   (1e-8); the JAX tests' identities on the card (CCSD = FCI for two
   electrons, the first iterate = kmp2 / kump2, closed-shell KUHF = KRHF,
   the KS-reference invariance, the determinant-space oracle of
   tests/cc_oracle.py at random complex amplitudes for the step, (T),
   EOM-EE/IP/EA and both densities, the structured amplitude basis = the
   dense one, torch's complex autodiff conventions); (b) diamond gth-szv
   ke 50 2x2x2 c0 40 (README.md's KCCSD system): KRHF, kccsd_t (cycles
   beside README.md's 8, the first iterate = kmp2 to 1e-10),
   eomee_davidson (4 roots, converged) and dmet_energy on one carbon (an
   8-orbital embedding) with the mu fit by the FCI and the CCSD solvers,
   each with seconds and peak memory; (c) the same cell at 3x3x3 (nk 27,
   U 20.6 GB): kccsd converged, the first iterate = kmp2 to 1e-10, the U
   assembly's seconds, s/cycle, cycles and peak memory (below 80 GB).
12. the derivative layer (``isdf.autodiff``, ``scf.grad``, ``stress``,
   ``optimize``, ``hessian``, ``md``, ``phonon``, ``elastic``, ``eos``),
   with K1's count reset right before and >= 1 after: (a) the JAX tests'
   fixtures (tests/torch_deriv_fixtures.py): the forces and stress of
   every case (pw and ISDF; RHF, UHF, LDA, PBE, +U, SCAN, HSE06, exxdiv
   ewald) on the JAX package's density and mask, card against CPU (1e-10)
   and against tests/data/jax_port_refs.json (1e-8), eri_grad_fn split by
   block (the recorded momentum-conserving blocks card against CPU and
   against the JAX record at 1e-10, blocks off momentum conservation card
   against CPU at 1e-8, each reported as an open fault where it misses
   its gate; the run stops past 1e-8 and 1e-4), the port's own SCF then
   forces (1e-7 of the JAX forces), diamond gth-szv 1x1x2 KRKS-PBE+U card
   against CPU, npt_kernel on LiH against the JAX record, eos.qha_kernel
   on the H2 chain of tests/test_eos.py against the JAX record (energies
   1e-8 Ha, wavenumbers 1e-2 cm^-1, V0(T) 1e-6), and
   examples/relax_vibrations.py's system with --isdf (relaxed below
   5e-4, then its frequencies); (b) NiO AFM gth-szv ke 100 4x4x4 (nip
   1040) with the first O displaced 0.05 bohr along x, built fresh:
   DeviceKUHF and DeviceKUKS-PBE+U (smeared, then unsmeared from that
   density), the ISDF force through the sector-chunked state at a budget
   from free memory (seconds, peak, sectors a chunk, |sum F|), against
   the central difference (h 1e-3 bohr) of DeviceKUHF/KUKS energies on
   frozen-mask builds (conv_tol 1e-10) within 1e-5 Ha/bohr, under 80 GB;
   (c) diamond gth-dzvp ke 200 2x2x2 (nip 1040) KRKS-PBE: the ISDF
   stress (Lagrangian = e_tot to 1e-8, dE/d(isotropic strain) against a
   Richardson FD of frozen-mask energies at +-2e-3, +-4e-3), the pw
   stress on an exact-J KRKS, eos over 5 scales (fitted -dE/dV against
   the analytic pressures), elastic constants C11, C12, C44 (Maxwell
   symmetry); (d) diamond gth-szv ke 50 2x2x2 c0 40: the ISDF Hessian at
   Gamma (three projected translations, the optical mode triply
   degenerate to 2%), a relaxation and 10 NVE MD steps of 0.5 fs with
   an FFTISDF rebuilt every step (drift below 3e-4 Ha), and phonons on
   the 1x1x2 supercell with the acoustic sum rule.
13. the tool layer (``utils.profiling``, ``FFTISDF(profile_build=True)``,
   ``utils.cube``, ``basis.data``'s CP2K registry, ``basis.atom``), with
   K1's count reset right before and >= 1 after (a): (a) the slice built
   four times, profiled and plain in turns (mask and w_q bitwise equal
   to the first build; the stage seconds, the selection and the
   profiling overhead printed), then the production configuration built
   once profiled: its stages (factors, sweep, spectral, gram) add up to
   the metric pass within 5%; (b) a torch.profiler trace of the slice's
   build and 3 DeviceKUHF cycles: the device's busy share of the window
   and the ten device operations that took the most time, by name; (c)
   examples/derive_atomic_basis.py --elem Ni --ke 240 --check with the
   port's modules: the uncontracted Ni pseudo-atom (nao 54, mesh 90^3,
   2S = 2) by KUHF on the exact J/K in float64 on the card, started with
   the spin-down d hole in d_xy, converged and keeping that hole, its
   radial naturals registered under gth-dzvp-molopt-sr (restored
   afterwards), the contracted KUHF (same start) no lower than the
   uncontracted one by more than 1e-6 Ha, and the --radial route
   (solve_atom and fit_radial_gaussians) on the host, in a process of its
   own started before phase 12; (d) phase 6b's
   converged production KUHF: density_on_grid on the card (seconds, peak
   memory), its integral against nelec (1e-8 relative), the spin
   density's against sum_k tr((Da - Db) S)/nk (1e-8), an orbital's
   |psi|^2 against 1 (1e-8), and write_cube -> read_cube (mesh, voxels,
   atoms, the integral to 1e-4); (e) diamond gth-szv ke 50 1x1x2: profile_build's
   w_q bitwise equal to a plain card build, density_on_grid card against
   CPU (1e-12);
14. the mesh layer (``parallel``): world size 1 over NCCL against phases
   4 and 6b and phase 12b's force, and 2 gloo ranks on the card (the
   slice under a 14 GB budget, the He2 force state, kccsd);
15. the entry points, ``python -m fftisdf_tpu_torch.examples.<name>``,
   in-process through ``main(argv)`` with K1's count reset right before
   and >= 1 after: every example the earlier phases do not run (3 and 6b
   run nio_afm_kuhf at its defaults and with --production, 7b with
   --production --dtype float32, 10a exciton_dispersion --eels, 12a
   relax_vibrations --isdf, 13c derive_atomic_basis --elem Ni --ke 240
   --check), at its JAX defaults and at the arguments of the JAX
   package's recorded run where they differ
   (tests/data/jax_example_outputs.json): each held to the JAX script's
   own checks and to the record at the module's GATES on the record's
   interpolation points (nio_northstar's in the host loop, the record's),
   with its seconds, peak memory and K1 launches.

The line before the last holds the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py 0,1        # a subset of phases, for development:
                                     # prints no result lines; 8, 9, 10
                                     # and 13 run 4 and 6 first for their
                                     # state; 11, 12 and 15 need no other
                                     # phase
"""
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
ANCHOR = REPO / "tests" / "data" / "nio_afm_kuhf_anchor.json"
EXACT = REPO / "tests" / "data" / "nio_afm_kuhf_exact.json"
REFS = REPO / "tests" / "data" / "jax_port_refs.json"
KS_ANCHOR = REPO / "tests" / "data" / "nio_afm_kuks_anchor.json"
EXAMPLE_RECORD = REPO / "tests" / "data" / "jax_example_outputs.json"
K1_TOL = {"complex64": 2e-5, "complex128": 1e-12}
# the complex64 kernel's error against the complex128 gram: at most this
# many times the plain complex64 version's, or K1_C64_FLOOR of the scale
# where that is larger: 3xTF32 drops the small x small term, 2^-22 of a
# product, which the modulus doubles; at K = 1 no sum averages it
K1_C64_REF_RATIO = 4.0
K1_C64_FLOOR = 2.0**-21
K1_SHAPES = [(1, 64, 5), (3, 100, 7), (2, 300, 4), (16, 96, 40),
             (1, 1, 1), (3, 129, 7), (5, 257, 3)]
MAIN_SHAPE = (64, 3375, 26)       # NiO gth-szv, 4x4x4, m0 15^3
PROD_SHAPE = (64, 3375, 62)       # the production basis width
# H100 SXM data sheet, dense: FP64 on the tensor cores (K1 complex128),
# TF32 on the tensor cores (K1 complex64 in 3xTF32: 3 passes of the flops),
# FP32 outside them (K1 complex64's earlier SIMT route), HBM3
PEAK_FLOPS = {"fp64_tc": 67e12, "tf32_tc": 495e12, "fp32": 67e12}
ROUTE = {"complex128": ("fp64_tc", 1), "complex64": ("tf32_tc", 3)}
PEAK_BYTES = 3.35e12
AFM = {0: +1.0, 1: -1.0}
NIO_U = 6.2 / 27.211386           # U_eff 6.2 eV on the Ni d shells, in Ha
SLICE_NIP = 1040
SLICE_E_TOT = -360.3364120006     # the slice's converged energy on the H100
PROD_NIP = 2480                   # c0 40 x nao 62
DIAMOND_NIP = 1040                # diamond gth-dzvp: c0 40 x nao 26
PROD_E_TOT = -365.3099342755      # production, float64, on the H100
# |e_tot(float32) - e_tot(float64)| per atom that the float32 regime must
# hold (Ha), set from the first runs on an H100: 6.6e-3 and 7.1e-3 on the
# slice (float64 and complex64 selection), 9.7e-3 at production
F32_DE_ATOM = {"slice": 1e-2, "production": 2e-2}
SCF_KW = dict(conv_tol=1e-8, max_cycle=80, init_spin=AFM, smearing=5e-3)
# float32 J/K carry ~1e-6 Ha of noise into the energy, so a float32 SCF is
# converged to 1e-6 (the setting of examples/nio_afm_kuhf.py)
SCF_KW_F32 = dict(SCF_KW, conv_tol=1e-6)
# headroom for the hybrids and SCAN, which took 55-75 cycles on the
# anchor-sized cell
KS_KW = dict(SCF_KW, max_cycle=150)


def log(*args):
    print(*args, flush=True)


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    return torch


def phase0_environment(torch):
    from concurrent.futures import ThreadPoolExecutor

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[0] nvidia-smi: {smi}")
    log(f"[0] torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}  devices "
        f"{torch.cuda.device_count()}")
    from fftisdf_tpu_torch import native
    from fftisdf_tpu_torch.ops.pair_gram import LIBRARY

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    # one compiler process per source, all started together
    with ThreadPoolExecutor(2) as pool:
        k1 = pool.submit(timed, LIBRARY.load)
        eng = pool.submit(timed, native.load)
        _, k1_s = k1.result()
        lib, eng_s = eng.result()
    log(f"[0] K1 build {LIBRARY.build_seconds:.2f}s (load {k1_s:.2f}s) -> "
        f"{LIBRARY.path().name}")
    _k1_build_report()
    if lib is None:
        raise RuntimeError("the native lattice engine did not build")
    log(f"[0] native lattice engine build+load {eng_s:.2f}s -> "
        f"{native.LIB_PATH.name}")
    return smi


def _k1_build_report():
    """ptxas registers and spills of each K1 kernel (when this process built
    the library) and its tensor-core instructions in the built SASS; the
    complex64 kernels must not spill and must run TF32 HMMA."""
    from collections import Counter
    from fftisdf_tpu_torch.ops._build import find_nvcc
    from fftisdf_tpu_torch.ops.pair_gram import LIBRARY

    fn = None
    if not LIBRARY.ptxas_log:
        log("[0] ptxas: the library was built earlier, no log")
    for line in LIBRARY.ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        if any(w in line for w in ("registers", "spill", "Compiling")):
            log(f"[0] ptxas: {line.strip()}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn and "pair_gram_c_kernel" in fn and m.group(1, 2) != (
                "0", "0"):
            raise RuntimeError(f"the complex64 K1 kernel spills: {line}")
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(LIBRARY.path())],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts = {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = Counter()
            continue
        m = re.search(r"\b[HD]MMA\.\S+", line)
        if m and fn in counts:
            counts[fn][m.group(0)] += 1
    for fn, c in counts.items():
        log(f"[0] sass {fn}: " + (", ".join(f"{n} {op}" for op, n in
                                            sorted(c.items()))
                                  or "no tensor-core instruction"))
    c64 = [c for fn, c in counts.items() if "pair_gram_c_kernel" in fn]
    if not c64 or not all(any("TF32" in op for op in c) for c in c64):
        raise RuntimeError("the complex64 K1 kernels hold no TF32 HMMA")


def _cuda_ms(torch, fn, reps):
    """CUDA-event milliseconds per call of ``fn``, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _sampled_turns(torch, fns, rounds, reps):
    """CUDA-event ms per call of each of ``fns`` in ``rounds`` rounds of
    turns (every other round in reverse order), with the nvidia-smi samples
    (SM clock MHz, power draw W, temperature C) taken every 20 ms during
    each turn.  Returns [(name, ms, samples)]."""
    from datetime import datetime

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    spans = []
    try:
        time.sleep(0.5)             # the sampler's first lines
        names = list(fns)
        for r in range(rounds):
            for name in names if r % 2 == 0 else names[::-1]:
                t0 = datetime.now()
                ms = _cuda_ms(torch, fns[name], reps)
                spans.append((name, ms, t0, datetime.now()))
    finally:
        smi.terminate()
        try:
            text = smi.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            smi.kill()
            text = smi.communicate()[0]
    samples = []
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        try:
            samples.append((datetime.strptime(parts[0],
                                              "%Y/%m/%d %H:%M:%S.%f"),
                            *map(float, parts[1:4])))
        except (ValueError, TypeError):
            continue
    return [(name, ms, [v[1:] for v in samples if t0 <= v[0] <= t1])
            for name, ms, t0, t1 in spans]


def _describe_samples(samples):
    if not samples:
        return "no nvidia-smi sample"
    clk, pw, tc = zip(*samples)
    return (f"SM {min(clk):.0f}-{max(clk):.0f} MHz, {min(pw):.0f}-"
            f"{max(pw):.0f} W, {min(tc):.0f}-{max(tc):.0f} C, "
            f"{len(samples)} samples")


def k1_bound(shape, dname="complex128", route=None):
    """(flops, bound_ms, bound_by) of K1's work at ``shape`` in ``dname``:
    the upper triangle, 4 ng (ng + 1) K flops, times the passes of the
    route, at its peak (``route``: the one the kernel runs, FP64 tensor
    cores for complex128 and 3xTF32 on the tensor cores for complex64, or
    "fp32", FP32 outside the tensor cores), against X read once and the
    (ng, ng) result written once."""
    nk, ng, nao = shape
    kk = nk * nao
    flops = 4.0 * ng * (ng + 1) * kk
    unit, passes = ROUTE[dname] if route is None else (route, 1)
    csize = 16.0 if dname == "complex128" else 8.0
    nbytes = csize * ng * kk + 0.5 * csize * ng * ng
    t_ops = passes * flops / PEAK_FLOPS[unit]
    t_bytes = nbytes / PEAK_BYTES
    return flops, 1e3 * max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes")


def _k1_check(torch, x, label):
    from fftisdf_tpu_torch.ops.pair_gram import (pair_gram_sq,
                                                 pair_gram_sq_reference)

    dname = str(x.dtype).split(".")[-1]
    errs = []
    for square in (False, True):
        out = pair_gram_sq(x, square=square)
        ref = pair_gram_sq_reference(x, square=square)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        ok = bool(torch.isfinite(out).all()) and err <= K1_TOL[dname] * scale
        line = (f"[1] K1 {label} {dname} square={square}: max_abs_err "
                f"{err:.3e} (scale {scale:.3e}, tol {K1_TOL[dname]:.0e})")
        if dname == "complex64":
            # both complex64 results against the complex128 gram
            ref128 = pair_gram_sq_reference(x.to(torch.complex128),
                                            square=square)
            e_k = float((out.double() - ref128).abs().max())
            e_p = float((ref.double() - ref128).abs().max())
            ratio = e_k / max(e_p, K1_C64_FLOOR * scale)
            ok = ok and ratio <= K1_C64_REF_RATIO
            line += (f"; against complex128: kernel {e_k:.3e}, plain "
                     f"{e_p:.3e}, ratio {ratio:.2f} (limit "
                     f"{K1_C64_REF_RATIO:g})")
        log(line + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"K1 disagrees with its plain version at "
                               f"{label} {dname} square={square}")
        errs.append(err)
    return errs[0]


def phase1_kernel(torch):
    import numpy as np
    from fftisdf_tpu_torch.ops.pair_gram import (pair_gram_sq,
                                                 pair_gram_sq_reference)

    # the plain versions and the library call in full FP32/FP64
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)

    def sample(shape, dname="complex128"):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(dname)).cuda()

    main_err = {}
    for shape in (*K1_SHAPES, MAIN_SHAPE, PROD_SHAPE):
        for dname in ("complex64", "complex128"):
            err = _k1_check(torch, sample(shape, dname), shape)
            if shape == MAIN_SHAPE:
                main_err[dname] = err
    for dname in ("complex64", "complex128"):
        x = sample((8, 300, 11), dname)[:, 7:250]
        _k1_check(torch, x, "(8, 300, 11)[:, 7:250] (non-contiguous)")
        x = sample((8, 300, 12), dname)
        _k1_check(torch, x[..., 1:], "(8, 300, 12)[..., 1:] (offset view)")
        _k1_check(torch, x.conj(), "(8, 300, 12).conj() (conjugate view)")

    res = {}
    for dname, (key, shape) in [(d, ks) for d in ("complex128", "complex64")
                                for ks in (("main", MAIN_SHAPE),
                                           ("production", PROD_SHAPE))]:
        nk, ng, nao = shape
        x = sample(shape, dname)
        xt = x.permute(1, 0, 2).reshape(ng, nk * nao).contiguous()
        fns = {
            "kernel": lambda: pair_gram_sq(x, square=False),
            "plain": lambda: pair_gram_sq_reference(x, square=False),
            "library": lambda: (xt.conj() @ xt.mT).abs().square() / nk**2,
        }
        if dname == "complex64":
            # the same shape with an odd row stride: the loader's 8-B copies
            xp = sample((nk, ng, nao + 1), dname)[..., :nao]
            fns["kernel, 8-B copies"] = lambda: pair_gram_sq(xp,
                                                             square=False)
        times = {name: [] for name in fns}
        for name, t, samples in _sampled_turns(torch, fns, 5, 20):
            times[name].append(t)
            log(f"[1] K1 {shape} turn: {name} {t:.3f} ms; "
                f"{_describe_samples(samples)}")
        ms = {name: sorted(v)[len(v) // 2] for name, v in times.items()}
        flops, bound_ms, bound_by = k1_bound(shape, dname)
        fp32 = ""
        if dname == "complex64":
            fp32_ms = k1_bound(shape, dname, "fp32")[1]
            fp32 = (f"; {fp32_ms / ms['kernel']:.1%} of the {fp32_ms:.3f} ms "
                    "FP32 bound outside the tensor cores")
        log(f"[1] K1 {shape} {dname}: kernel {ms['kernel']:.3f} ms "
            f"({flops / (ms['kernel'] * 1e-3) / 1e12:.2f} TFLOP/s of "
            f"triangle work done, {bound_ms / ms['kernel']:.1%} of the "
            f"{bound_ms:.3f} ms bound, {bound_by}{fp32}), plain "
            f"{ms['plain']:.3f} ms, library {ms['library']:.3f} ms; each "
            "the median of 5 turns, spread: "
            + ", ".join(f"{n} {min(v):.3f}-{max(v):.3f}"
                        for n, v in times.items()))
        res[dname, key] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                               library_ms=ms["library"], bound_ms=bound_ms,
                               bound_by=bound_by)
        if dname == "complex64":
            res[dname, key].update(bound_fp32_ms=fp32_ms,
                                   ms_8b_copies=ms["kernel, 8-B copies"])
    out = {}
    for dname in ("complex128", "complex64"):
        main, prod = res[dname, "main"], res[dname, "production"]
        out[dname] = {"max_abs_err": main_err[dname], **main,
                      "production_ms": prod["ms"],
                      "production_plain_ms": prod["plain_ms"],
                      "production_library_ms": prod["library_ms"],
                      "production_bound_ms": prod["bound_ms"]}
        if dname == "complex64":
            out[dname].update(
                production_bound_fp32_ms=prod["bound_fp32_ms"],
                production_ms_8b_copies=prod["ms_8b_copies"])
    return out


def _diamond():
    from fftisdf_tpu_torch.lattice import structure

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    return cell, cell.get_kpts([1, 1, 2])


def phase2_device_vs_host(torch):
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KUHF

    cell, kpts = _diamond()
    kw = dict(verbose=0, conv_tol=1e-10, max_cycle=80, init_spin=AFM,
              smearing=5e-3)
    res = {}
    for dev in ("cuda", "cpu"):
        df = FFTISDF(cell, kpts, c0=10.0, m0=(15, 15, 15), verbose=0,
                     device=dev).build()
        mf = KUHF(cell, kpts, df, device=dev, **kw)
        e = mf.kernel()
        if not (mf.converged and np.isfinite(e)):
            raise RuntimeError(f"diamond KUHF on {dev} did not converge")
        res[dev] = (df, mf, e)
    dm = res["cpu"][1].dm
    vj_g, vk_g = (t.cpu().numpy() for t in res["cuda"][0].get_jk(dm))
    vj_c, vk_c = (t.numpy() for t in res["cpu"][0].get_jk(dm))
    rel_j = np.abs(vj_g - vj_c).max() / np.abs(vj_c).max()
    rel_k = np.abs(vk_g - vk_c).max() / np.abs(vk_c).max()
    de = abs(res["cuda"][2] - res["cpu"][2])
    same_mask = np.array_equal(res["cuda"][0].mask, res["cpu"][0].mask)
    log(f"[2] diamond: nip {res['cuda'][0].nip}, masks equal {same_mask}; "
        f"J rel {rel_j:.2e}, K rel {rel_k:.2e}; e_tot cuda "
        f"{res['cuda'][2]:.12f} cpu {res['cpu'][2]:.12f} |dE| {de:.2e}")
    if not (rel_j <= 1e-10 and rel_k <= 1e-10 and de <= 1e-9):
        raise RuntimeError("device and host disagree on diamond")


def _nio(ke, kmesh):
    from fftisdf_tpu_torch.lattice import structure

    cell = structure.to_cell(*structure.nio_afm(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=ke,
                             exp_to_discard=0.1)
    return cell, cell.get_kpts(kmesh)


def _example_out(tag):
    """``out`` for an example driver run inside a phase: its lines go to
    the log under the phase's tag."""
    return lambda *parts: log(f"{tag}   " + " ".join(map(str, parts)))


def _example_args(mod, argv):
    return mod.build_parser().parse_args(argv)


def phase3_anchor(torch):
    import numpy as np
    from fftisdf_tpu_torch.examples import nio_afm_kuhf

    anchor = json.loads(ANCHOR.read_text())
    cfg = anchor["config"]
    # the anchor is examples/nio_afm_kuhf.py at its defaults: the port's
    # entry point runs them (DeviceKUHF on the card)
    args = _example_args(nio_afm_kuhf, [])
    if ([args.ke, args.kmesh, args.c0, args.smearing]
            != [cfg["ke_cutoff"], cfg["kmesh"], cfg["c0"], cfg["smearing"]]):
        raise RuntimeError("the example's defaults are not the anchor's")
    out = {}
    for label, mask in (("jax-mask", anchor["mask"]), ("own", None)):
        res = nio_afm_kuhf.run(
            _example_args(nio_afm_kuhf, []),
            masks=None if mask is None else [{"m0": cfg["m0"],
                                              "mask": mask}],
            out=_example_out("[3]"))
        mf, e, mom = res["mf"], res["e_tot"], res["moments"]
        out[label] = (e, mf.converged, mom)
        log(f"[3] NiO ke {cfg['ke_cutoff']:g} {cfg['kmesh']} c0 {cfg['c0']:g}"
            f" ({label} selection, {type(mf).__name__}): e_tot {e:.10f} "
            f"conv {mf.converged} cycles {mf.cycles} Ni moments "
            f"{mom[0]:+.4f} {mom[1]:+.4f}")
        del res, mf
    e, conv, mom = out["jax-mask"]
    de = abs(e - anchor["e_tot"])
    dm = np.abs(np.asarray(mom[:2]) - np.asarray(anchor["moments"][:2]))
    log(f"[3] anchor E_jax {anchor['e_tot']:.10f}: |dE| {de:.2e} Ha, "
        f"|d moments| {dm.max():.2e}; own selection differs by "
        f"{out['own'][0] - anchor['e_tot']:+.2e} Ha")
    if not (conv and de <= 1e-6 and dm.max() <= 1e-3):
        raise RuntimeError("the port misses the JAX anchor")


def phase4_slice(torch, kmesh, ctx):
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq
    from fftisdf_tpu_torch.scf import KUHF
    from fftisdf_tpu_torch.scf.analysis import atom_charges_and_moments

    cell, kpts = _nio(100.0, kmesh)
    log(f"[4] NiO AFM gth-szv ke 100 kmesh {kmesh}: nao {cell.nao_nr()} "
        f"nelec {cell.nelectron} mesh {[int(m) for m in cell.mesh]} nk "
        f"{len(kpts)}")
    torch.cuda.reset_peak_memory_stats()
    pair_gram_sq.launches = 0
    # no device argument: the entry points run on the card by default
    df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=3).build()
    launches = pair_gram_sq.launches
    t = df.timings
    log(f"[4] build: nip {df.nip}, selection {t['select_s']:.3f}s, metric "
        f"pass {t['metric_s']:.3f}s (sweep {t['sweep_s']:.3f}s, solve/FFT/"
        f"gram {t['solve_s']:.3f}s), total {t['build_s']:.3f}s, "
        f"{df.nchunks} chunk(s); K1 launches {launches}")
    if launches < 1:
        raise RuntimeError("the slice's selection did not launch K1")
    if df.device.type != "cuda" or df.nip != SLICE_NIP:
        raise RuntimeError(f"the slice built on {df.device} with nip "
                           f"{df.nip}, not on cuda with {SLICE_NIP}")
    t0 = time.perf_counter()
    mf = KUHF(cell, kpts, df, verbose=3, conv_tol=1e-8, max_cycle=80,
              init_spin=AFM, smearing=5e-3)
    log(f"[4] one-electron setup {time.perf_counter() - t0:.2f}s")
    dm0 = mf.get_init_guess()
    df.get_jk(dm0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vj, vk = df.get_jk(dm0)
    torch.cuda.synchronize()
    jk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    e = mf.kernel()
    scf_s = time.perf_counter() - t0
    _, mom = atom_charges_and_moments(cell, mf.dm, mf.s1e)
    peak = torch.cuda.max_memory_allocated()
    log(f"[4] warm get_jk (2 spins) {jk_s:.4f}s; SCF {mf.cycles} cycles in "
        f"{scf_s:.2f}s ({scf_s / max(mf.cycles, 1):.3f} s/cycle); e_tot "
        f"{e:.10f} conv {mf.converged}; Ni moments {mom[0]:+.4f} "
        f"{mom[1]:+.4f}; peak memory {peak / 1e9:.2f} GB")
    log(f"[4] e_tot - recorded {SLICE_E_TOT:.10f}: {e - SLICE_E_TOT:+.2e} "
        "Ha")
    if not (mf.converged and abs(e - SLICE_E_TOT) <= 1e-6):
        raise RuntimeError("the slice's KUHF did not converge to the "
                           "recorded energy")
    if not (vj.shape == (2, len(kpts), cell.nao_nr(), cell.nao_nr())
            and bool(torch.isfinite(vk).all())):
        raise RuntimeError("J/K of the slice are malformed")
    ctx["slice"] = (cell, kpts, df)
    # phase 14 holds the sharded builds to this one
    ctx["slice_ref"] = dict(_bench_jk(torch, df), dm=mf.dm, build_s=t[
        "build_s"], peak_gb=peak / 1e9)
    return launches


def _slice(ctx):
    """(cell, kpts, FFTISDF) of the slice: phase 4's, or built here."""
    from fftisdf_tpu_torch.isdf import FFTISDF

    if "slice" not in ctx:
        cell, kpts = _nio(100.0, [4, 4, 4])
        df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=0).build()
        ctx["slice"] = (cell, kpts, df)
    return ctx["slice"]


def _bench_jk(torch, df):
    """J/K of the bench density on ``df`` (host arrays) and the seconds of
    a warm call."""
    dm = _bench_density(df.cell, df.kpts)
    df.get_jk(dm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vj, vk = df.get_jk(dm)
    torch.cuda.synchronize()
    jk_s = time.perf_counter() - t0
    return dict(vj=vj.cpu().numpy(), vk=vk.cpu().numpy(), jk_s=jk_s)


def _bench_density(cell, kpts):
    """The JAX bench's time-reversal-symmetric hermitian test density
    (bench.py, seed 0): (nk, nao, nao) complex."""
    import numpy as np
    from fftisdf_tpu_torch.lattice import kpoints as kpt_mod

    rng = np.random.default_rng(0)
    nk, nao = len(kpts), cell.nao_nr()
    s = cell.get_scaled_kpts(kpts)
    dm = rng.standard_normal((nk, nao, nao)) * 0.1 + np.eye(nao)[None]
    dm = (dm + dm.transpose(0, 2, 1)).astype(np.complex128)
    for k in range(nk):
        km = kpt_mod.member(-s[k], s)
        if km >= k:
            avg = (dm[k] + dm[km].conj()) / 2
            dm[k], dm[km] = avg, avg.conj()
    return dm


def phase5_exact(torch, ctx):
    _exact_diamond(torch)
    _exact_anchor(torch)
    _exact_slice(torch, ctx)


def _exact_diamond(torch):
    """(a) diamond: the oracle on the card against the CPU."""
    import numpy as np
    from fftisdf_tpu_torch.scf import PWDF

    cell, kpts = _diamond()
    dm = np.stack([_bench_density(cell, kpts)] * 2)
    dm[1] *= 0.5
    out = {}
    for dev in ("cuda", "cpu"):
        vj, vk = PWDF(cell, kpts, device=dev).get_jk(dm, exxdiv="ewald")
        out[dev] = (vj.cpu().numpy(), vk.cpu().numpy())
    rel = [np.abs(g - c).max() / np.abs(c).max()
           for g, c in zip(out["cuda"], out["cpu"])]
    log(f"[5] diamond PWDF (exxdiv='ewald') cuda vs cpu: J rel "
        f"{rel[0]:.2e}, K rel {rel[1]:.2e}")
    if not max(rel) <= 1e-10:
        raise RuntimeError("the exact J/K disagree between cuda and cpu")


def _exact_anchor(torch):
    """(b) the anchor's exact-PW KUHF against the JAX package's."""
    from fftisdf_tpu_torch.scf import KUHF

    exact = json.loads(EXACT.read_text())
    cfg = exact["config"]
    cell, kpts = _nio(cfg["ke_cutoff"], cfg["kmesh"])
    t0 = time.perf_counter()
    mf = KUHF(cell, kpts, verbose=0, conv_tol=cfg["conv_tol"],
              max_cycle=cfg["max_cycle"], init_spin=AFM,
              smearing=cfg["smearing"])
    e = mf.kernel()
    t_ex = time.perf_counter() - t0
    anchor = json.loads(ANCHOR.read_text())
    e_isdf = anchor["e_tot"]
    de = abs(e - exact["e_tot"])
    log(f"[5] anchor exact-PW KUHF on {mf.with_df.device}: e_tot {e:.10f} "
        f"conv {mf.converged} cycles {mf.cycles} ({t_ex:.1f}s); JAX exact "
        f"{exact['e_tot']:.10f}: |dE| {de:.2e} Ha; ISDF (c0 "
        f"{anchor['config']['c0']:g}, the JAX package's energy of phase 3) "
        f"vs exact dE/atom {abs(e_isdf - e) / cell.natm:.2e} Ha")
    if not (mf.converged and de <= 1e-6):
        raise RuntimeError("the exact KUHF misses the JAX exact energy")


def _exact_slice(torch, ctx):
    """(c) the slice: ISDF J/K against the exact J/K."""
    import numpy as np
    from fftisdf_tpu_torch.scf import PWDF

    cell, kpts, df = _slice(ctx)
    dm = _bench_density(cell, kpts)
    vj_i, vk_i = df.get_jk(dm)
    t0 = time.perf_counter()
    pw = PWDF(cell, kpts)
    torch.cuda.synchronize()
    t_ao = time.perf_counter() - t0
    t0 = time.perf_counter()
    vj_e, vk_e = pw.get_jk(dm)
    torch.cuda.synchronize()
    t_jk = time.perf_counter() - t0
    del pw
    ctx["slice_exact"] = (vj_e, vk_e)
    errs = {}
    for name, a, b in (("vj", vj_i, vj_e), ("vk", vk_i, vk_e)):
        errs[name] = (float((a - b).abs().max()), float(b.abs().max()))
    ctx["slice_f64_err"] = errs
    log(f"[5] slice exact arm: AO tensor {t_ao:.2f}s, exact J/K "
        f"{t_jk:.2f}s; " + ", ".join(
            f"{n}_maxerr {e:.3e} (scale {sc:.3f})"
            for n, (e, sc) in errs.items()))
    if not all(np.isfinite(e) and e < 1e-2 for e, _ in errs.values()):
        raise RuntimeError("the slice's ISDF J/K miss the exact J/K")


def _scf_line(tag, mf, seconds):
    per = seconds[1:] or seconds
    return (f"{tag}: e_tot {mf.e_tot:.10f} conv {mf.converged} cycles "
            f"{mf.cycles}, {sum(seconds):.2f}s ({sum(per) / len(per):.4f} "
            f"s/cycle past the first, first {seconds[0]:.3f}s)")


def _device_loop_parts(torch, mf, extra=None):
    """{part: wall milliseconds per call}, the device synchronised before
    and after 5 calls that follow one warm call, of the device loop's parts
    at the shapes of ``mf``'s run, on seeded random inputs: the batched
    eigensolve, the ADIIS descent, the CDIIS solve and one spin's
    chemical-potential bisection; then the callables of ``extra``."""
    from fftisdf_tpu_torch.scf import core

    dev = mf.with_df.device
    nk, nao = mf.h1e.shape[:2]
    m, L = mf.diis_space, 2 * nk * nao * nao
    g = torch.Generator(device=dev).manual_seed(0)

    def randc(*shape):
        return torch.complex(*(torch.randn(shape, generator=g, device=dev,
                                           dtype=torch.float64)
                               for _ in range(2)))

    fo = randc(2, nk, nao, nao)
    fo = fo + fo.mH
    hist = [randc(m, L) for _ in range(3)]
    live = torch.ones(m, dtype=torch.bool, device=dev)
    e = torch.sort(torch.randn((nk, nao), generator=g, device=dev,
                               dtype=torch.float64), dim=1)[0]
    ok = torch.ones_like(e, dtype=torch.bool)
    parts = {
        f"eigh (2, {nk}, {nao}, {nao})": lambda: torch.linalg.eigh(fo),
        "ADIIS (400 steps)": lambda: core.adiis_coeffs(hist[0], hist[1], 0,
                                                        live),
        "CDIIS solve": lambda: core.diis_extrapolate(hist[2], hist[1],
                                                     live),
        "mu bisection (90 steps, one spin)": lambda: core.smeared_occ(
            e, ok, float(nk * nao // 2), 5e-3, "fermi"),
        **(extra or {}),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / 5 * 1e3
    return out


def _parts_line(ms):
    return "; ".join(f"{name} {t:.2f} ms" for name, t in ms.items())


def phase6_device_scf(torch, ctx):
    from fftisdf_tpu_torch.scf import KUHF, DeviceKUHF
    from fftisdf_tpu_torch.scf.analysis import atom_charges_and_moments

    # (a) the slice: device loop against host loop on one build
    cell, kpts, df = _slice(ctx)
    host = KUHF(cell, kpts, df, verbose=0, **SCF_KW)
    host.kernel()
    dev = DeviceKUHF(cell, kpts, df, verbose=0, **SCF_KW)
    dev.kernel()
    de = abs(dev.e_tot - host.e_tot)
    log("[6] slice " + _scf_line("host KUHF", host, host.cycle_seconds))
    log("[6] slice " + _scf_line("DeviceKUHF", dev, dev.cycle_times)
        + f"; |dE| {de:.2e} Ha")
    log("[6] slice device-loop parts: "
        + _parts_line(_device_loop_parts(torch, dev)))
    if not (host.converged and dev.converged and de <= 3e-8):
        raise RuntimeError("DeviceKUHF and KUHF disagree on the slice")
    # phase 8 serves bands and the cderi arm from this state and density
    ctx["slice_mf"] = host
    _park(df)
    del dev
    torch.cuda.empty_cache()

    # (b) the production configuration
    cell, kpts, df, mf, fig = _production_run(torch, "[6]")
    ctx["production_f64"] = fig
    log("[6] production device-loop parts: "
        + _parts_line(_device_loop_parts(torch, mf)))
    host = KUHF(cell, kpts, df, verbose=0, **SCF_KW)
    host.kernel()
    de = abs(mf.e_tot - host.e_tot)
    log("[6] production " + _scf_line("host KUHF", host, host.cycle_seconds)
        + f"; |dE| against DeviceKUHF {de:.2e} Ha")
    if not (host.converged and de <= 3e-8):
        raise RuntimeError("DeviceKUHF and KUHF disagree on the production "
                           "configuration")
    # phase 8a restarts the host loop from its checkpoint on this build
    chk = Path(ctx["tmp"]) / "production_kuhf.npz"
    host.save(str(chk))
    _, mom = atom_charges_and_moments(cell, host.dm, host.s1e)
    ctx["production"] = dict(cell=cell, kpts=kpts, df=df, chk=chk,
                             e_tot=host.e_tot, e_dev=mf.e_tot, moments=mom)
    ctx["production_scf"] = host     # phase 13d's cubes read its density
    ctx["production_ref"] = dict(_bench_jk(torch, df), build_s=fig[
        "build_s"], peak_gb=fig["build_peak_gb"])   # phase 14a's reference
    del host, mf
    _park(df)
    torch.cuda.empty_cache()
    return fig["launches"]


def _production_cell():
    from fftisdf_tpu_torch.lattice import structure

    cell = structure.to_cell(*structure.nio_afm(),
                             basis="gth-dzvp-molopt-sr", pseudo="gth-pade",
                             ke_cutoff=200.0, exp_to_discard=0.1)
    return cell, cell.get_kpts([4, 4, 4])


def _production_run(torch, tag, dtype=None):
    """The production configuration through the port's entry point,
    ``python -m fftisdf_tpu_torch.examples.nio_afm_kuhf --production``
    (``--dtype float32`` for ``dtype``): built with K1's count reset right
    before, DeviceKUHF converged on it.  Returns (cell, kpts, df, mf,
    figures)."""
    from fftisdf_tpu_torch.examples import nio_afm_kuhf
    from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq

    argv = ["--production"] + ([] if dtype is None
                               else ["--dtype", "float32"])
    log(f"{tag} production: python -m fftisdf_tpu_torch.examples."
        f"nio_afm_kuhf {' '.join(argv)} (NiO AFM gth-dzvp-molopt-sr ke 200 "
        f"kmesh 4x4x4 c0 40 m0 15^3)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pair_gram_sq.launches = 0
    res = nio_afm_kuhf.run(_example_args(nio_afm_kuhf, argv),
                           out=_example_out(tag))
    cell, kpts, df, mf = res["cell"], res["kpts"], res["df"], res["mf"]
    fig = dict(df.timings, launches=pair_gram_sq.launches,
               nchunks=df.nchunks, build_peak_gb=res["build_peak_gb"],
               setup_s=res["setup_s"])
    log(f"{tag} production build: nip {df.nip}, selection "
        f"{fig['select_s']:.3f}s, metric pass {fig['metric_s']:.3f}s (sweep "
        f"{fig['sweep_s']:.3f}s, solve/FFT/gram {fig['solve_s']:.3f}s), "
        f"total {fig['build_s']:.3f}s, {df.nchunks} chunk(s); K1 launches "
        f"{fig['launches']}; peak {fig['build_peak_gb']:.2f} GB")
    if df.device.type != "cuda" or df.nip != PROD_NIP:
        raise RuntimeError(f"the production build: device {df.device}, nip "
                           f"{df.nip} (expected {PROD_NIP})")
    if dtype is None and fig["launches"] < 1:
        raise RuntimeError("the production selection did not launch K1")
    log(f"{tag} production one-electron setup {fig['setup_s']:.2f}s")
    mom = res["moments"]
    per = mf.cycle_times[1:] or mf.cycle_times
    fig.update(e_tot=mf.e_tot, cycles=mf.cycles,
               cycle_s=sum(per) / len(per),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{tag} production " + _scf_line(type(mf).__name__, mf,
                                         mf.cycle_times)
        + f"; Ni moments {mom[0]:+.4f} {mom[1]:+.4f}; peak memory "
        f"{fig['peak_gb']:.2f} GB")
    if not (type(mf).__name__ == "DeviceKUHF" and mf.converged
            and mom[0] * mom[1] < 0):
        raise RuntimeError("the production DeviceKUHF did not converge to "
                           "an AFM state")
    dm0 = mf.get_init_guess()
    df.get_jk(dm0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df.get_jk(dm0)
    torch.cuda.synchronize()
    fig["jk_s"] = time.perf_counter() - t0
    log(f"{tag} production warm get_jk (2 spins) {fig['jk_s']:.4f}s")
    return cell, kpts, df, mf, fig


# ------------------------------------------------------------------ phase 7
def phase7_every_way(torch, ctx):
    _f32_slice(torch, ctx)
    _f32_production(torch, ctx)
    _auto_mesh(torch)
    _solvers(torch)
    _omega(torch)
    _trunc(torch)
    return ctx["f32_launches"]


def _maxerrs(vj, vk, vj_e, vk_e):
    return {name: (float((a.to(b.dtype) - b).abs().max()),
                   float(b.abs().max()))
            for name, a, b in (("vj", vj, vj_e), ("vk", vk, vk_e))}


def _f32_slice(torch, ctx):
    """(a) the float32 regime on the slice, both selection routes."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq
    from fftisdf_tpu_torch.scf import KUHF, DeviceKUHF

    f32 = torch.float32
    cell, kpts = _nio(100.0, [4, 4, 4])
    dm = _bench_density(cell, kpts)
    vj_e, vk_e = _slice_exact_jk(ctx, cell, kpts)
    torch.cuda.empty_cache()
    if "slice_f64_err" in ctx:
        log("[7a] float64 build (phase 5c): " + ", ".join(
            f"{n}_maxerr {e:.3e}" for n, (e, _) in
            ctx["slice_f64_err"].items()))
    # vj/vk_maxerr gates: 1e-2 as for every compressed build with the
    # default selection; 2e-2 with the float32 pivot order of K1's route
    # (measured 1.19e-2 / 5.7e-3, 1.8x the float64-ordered build's)
    for label, sel, gate in (("float64 selection (default)", None, 1e-2),
                             ("K1 complex64 selection", False, 2e-2)):
        pair_gram_sq.launches = 0
        pair_gram_sq.last_launch = None
        df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), dtype=f32,
                     select_host_f64=sel, verbose=3).build()
        launches, last = pair_gram_sq.launches, pair_gram_sq.last_launch
        t = df.timings
        log(f"[7a] slice float32, {label}: nip {df.nip}, selection "
            f"{t['select_s']:.3f}s, sweep {t['sweep_s']:.3f}s, solve/FFT/"
            f"gram {t['solve_s']:.3f}s, total {t['build_s']:.3f}s, "
            f"{df.nchunks} chunk(s); K1 launches {launches} {last}")
        if df.wq.dtype != torch.complex64 or df.nip != SLICE_NIP \
                or df.device.type != "cuda":
            raise RuntimeError(f"the float32 slice built {df.wq.dtype} on "
                               f"{df.device} with nip {df.nip}")
        if sel is False:
            if launches < 1 or last != (MAIN_SHAPE, torch.complex64):
                raise RuntimeError("select_host_f64=False did not launch K1 "
                                   f"in complex64 at {MAIN_SHAPE}: {last}")
            ctx["f32_launches"] = launches
        elif launches:
            raise RuntimeError("the float64 selection route launched K1")
        vj, vk = df.get_jk(dm)
        errs = _maxerrs(vj, vk, vj_e, vk_e)
        log(f"[7a] {label}: " + ", ".join(
            f"{n}_maxerr {e:.3e} (scale {sc:.3f})"
            for n, (e, sc) in errs.items()) + " against the float64 exact "
            f"J/K (gate {gate:.0e})")
        if not all(np.isfinite(e) and e < gate for e, _ in errs.values()):
            raise RuntimeError("the float32 slice's J/K miss the exact J/K")
        for cls in (KUHF, DeviceKUHF):
            mf = cls(cell, kpts, df, dtype=f32, verbose=0, **SCF_KW_F32)
            mf.kernel()
            de = abs(mf.e_tot - SLICE_E_TOT) / cell.natm
            secs = getattr(mf, "cycle_times", None) or mf.cycle_seconds
            log(f"[7a] {label} " + _scf_line(cls.__name__, mf, secs)
                + f"; |e_tot - float64 slice| {de:.3e} Ha/atom (gate "
                f"{F32_DE_ATOM['slice']:.0e})")
            if not (mf.converged and de <= F32_DE_ATOM["slice"]):
                raise RuntimeError(f"the float32 {cls.__name__} on the slice "
                                   "did not converge to the float64 energy")
        del df, mf
        torch.cuda.empty_cache()


def _f32_production(torch, ctx):
    """(b) the production configuration in float32, beside phase 6b."""
    cell, _, df, mf, fig = _production_run(torch, "[7b]", torch.float32)
    if df.wq.dtype != torch.complex64:
        raise RuntimeError(f"the float32 production build is {df.wq.dtype}")
    ref = ctx.get("production_f64")
    e64 = ref["e_tot"] if ref else PROD_E_TOT
    de = abs(fig["e_tot"] - e64) / cell.natm
    keys = ("select_s", "sweep_s", "solve_s", "build_s", "nchunks",
            "build_peak_gb", "setup_s", "jk_s", "cycles", "cycle_s",
            "peak_gb", "e_tot")
    log("[7b] float32 | float64 (phase 6b): " + "; ".join(
        f"{k} {fig[k]:.6g} | " + (f"{ref[k]:.6g}" if ref else "not run")
        for k in keys))
    log(f"[7b] |e_tot(float32) - e_tot(float64)| {de:.3e} Ha/atom (gate "
        f"{F32_DE_ATOM['production']:.0e})")
    if not de <= F32_DE_ATOM["production"]:
        raise RuntimeError("the float32 production energy misses the "
                           "float64 one")


def _auto_mesh(torch):
    """(c) m0='auto' and select_keep on the production cell (selection
    only): the mesh chosen, the densify steps, nip and rank."""
    import math
    from fftisdf_tpu_torch.isdf.kpoint import (auto_selection_mesh,
                                               select_interpolation_points)

    cell, kpts = _production_cell()
    start = auto_selection_mesh(cell, 40.0 * cell.nao_nr())
    for dtype, keep in ((None, None), (torch.float32, 1e-9)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        x_k, mask, rank, m0 = select_interpolation_points(
            cell, kpts, "auto", 40.0, dtype=dtype, keep_tol=keep)
        torch.cuda.synchronize()
        steps, m = 0, start
        while m != m0 and steps < 3:
            m = tuple(int(math.ceil(v * 2.0 ** (1.0 / 3.0))) for v in m)
            steps += 1
        log(f"[7c] m0='auto' ({dtype or 'torch.float64'}, select_keep "
            f"{keep}): mesh {start} -> {m0} in {steps} densify step(s), nip "
            f"{x_k.shape[1]}, rank {rank}, {time.perf_counter() - t0:.2f}s")
        if m != m0 or not bool(torch.isfinite(
                torch.view_as_real(x_k)).all()) or mask.max() >= math.prod(m0):
            raise RuntimeError("m0='auto' selection is malformed")
        del x_k


def _solvers(torch):
    """(d) diamond with each eigh-family solver against the ridge build."""
    from fftisdf_tpu_torch.isdf import FFTISDF

    cell, kpts = _diamond()
    dm = _bench_density(cell, kpts)
    out = {}
    for solver in ("ridge", "lstsq", "pinv", "svd"):
        df = FFTISDF(cell, kpts, c0=10.0, m0=(15, 15, 15), solver=solver,
                     verbose=0).build(mask=out.get("mask"))
        out.setdefault("mask", df.mask)
        out[solver] = df.get_jk(dm)

    def rel(a, b):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(out[a], out[b]))

    pairs = (("pinv", "lstsq", 1e-10), ("svd", "lstsq", 1e-6),
             ("lstsq", "ridge", 1e-4), ("pinv", "ridge", 1e-4),
             ("svd", "ridge", 1e-4))
    got = [(a, b, rel(a, b), tol) for a, b, tol in pairs]
    log("[7d] diamond solvers, J/K relative: " + ", ".join(
        f"{a} vs {b} {r:.2e} (tol {tol:.0e})" for a, b, r, tol in got))
    if not all(r <= tol for _, _, r, tol in got):
        raise RuntimeError("the eigh-family solvers disagree")


def _omega(torch):
    """(e) range separation on the anchor against the exact oracle."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import PWDF

    cfg = json.loads(ANCHOR.read_text())["config"]
    cell, kpts = _nio(cfg["ke_cutoff"], cfg["kmesh"])
    dm = _bench_density(cell, kpts)
    df = FFTISDF(cell, kpts, c0=cfg["c0"], m0=tuple(cfg["m0"]),
                 verbose=0).build()
    pw = PWDF(cell, kpts)
    for omega in (0.6, -0.6):
        errs = _maxerrs(*df.get_jk(dm, omega=omega),
                        *pw.get_jk(dm, omega=omega))
        log(f"[7e] anchor omega {omega:+g}: " + ", ".join(
            f"{n}_maxerr {e:.3e} (scale {sc:.3f})"
            for n, (e, sc) in errs.items()))
        if not all(e < 1e-2 for e, _ in errs.values()):
            raise RuntimeError("the screened ISDF J/K miss the exact ones")
    # erf + erfc = bare wherever no q+G = 0 sample exists (q != 0)
    wsum = df.get_wq_omega(0.6) + df.get_wq_omega(-0.6)
    rel = float((wsum[1:] - df.wq[1:]).abs().max()
                / df.wq[1:].abs().max())
    log(f"[7e] erf + erfc - bare on w_q (q != 0): {rel:.2e} relative")
    if not rel <= 1e-10:
        raise RuntimeError("erf + erfc != bare on w_q")


def _trunc(torch):
    """(f) He2 in a box, full rank: truncated ISDF J/K against the exact
    oracle with the same kernel."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice.cell import Cell
    from fftisdf_tpu_torch.scf import PWDF

    cell = Cell(a=np.diag([7.0, 7.0, 8.0]),
                atom=[("He", (3.5, 3.5, 3.2)), ("He", (3.5, 3.5, 4.8))],
                basis="sto-3g", pseudo=None, mesh=np.array([15, 15, 17]),
                unit="bohr", precision=1e-12).build()
    import warnings

    for kind, kmesh in (("0d", [1, 1, 1]), ("2d", [2, 1, 1])):
        kpts = cell.get_kpts(kmesh)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            df = FFTISDF(cell, kpts, c0=50.0, m0=tuple(cell.mesh),
                         select_tol=1e-20, rcond=1e-13, trunc=kind,
                         verbose=0).build()
        dm = _bench_density(cell, kpts)
        errs = _maxerrs(*df.get_jk(dm), *PWDF(cell, kpts,
                                              trunc=kind).get_jk(dm))
        log(f"[7f] He2 box trunc {df.trunc}: " + ", ".join(
            f"{n}_maxerr {e:.3e}" for n, (e, _) in errs.items()))
        if not all(e < 1e-9 for e, _ in errs.values()):
            raise RuntimeError(f"the {kind}-truncated ISDF J/K miss the "
                               "exact ones")


# ------------------------------------------------------------------ phase 8
def _park(df):
    """Hold a built state in host memory while later phases need the card
    (its get_ws cache is dropped; :func:`_unpark` brings it back)."""
    df.x_k, df.wq, df._ws = df.x_k.cpu(), df.wq.cpu(), None


def _unpark(df):
    df.x_k, df.wq = df.x_k.to(df.device), df.wq.to(df.device)


def _slice_exact_jk(ctx, cell, kpts):
    """Phase 5c's exact J/K of the slice on the bench density, or computed
    here when phase 5 did not run."""
    from fftisdf_tpu_torch.scf import PWDF

    if "slice_exact" not in ctx:
        ctx["slice_exact"] = PWDF(cell, kpts).get_jk(
            _bench_density(cell, kpts))
    return ctx["slice_exact"]


def phase8_rest(torch, ctx):
    _restart_analysis(torch, ctx)
    _cderi(torch, ctx)
    _bands(torch, ctx)
    _trunc_scf(torch)
    _tools(torch)


def _restart_analysis(torch, ctx):
    """(a) phase 6b's checkpoint restarts the host KUHF on phase 6b's build;
    Mulliken analysis of the result; format_poscar -> parse_poscar."""
    import numpy as np
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KUHF
    from fftisdf_tpu_torch.scf.analysis import (ao_populations,
                                                atom_charges_and_moments,
                                                mulliken)

    prod = ctx["production"]
    cell, kpts, df = prod["cell"], prod["kpts"], prod["df"]
    _unpark(df)
    t0 = time.perf_counter()
    mf = KUHF(cell, kpts, df, verbose=0, **dict(SCF_KW, max_cycle=2))
    e = mf.kernel(dm0=mf.load_chk(prod["chk"]))
    restart_s = time.perf_counter() - t0
    de = abs(e - prod["e_tot"])
    log(f"[8a] production restart from {Path(prod['chk']).name} "
        f"({Path(prod['chk']).stat().st_size / 1e6:.1f} MB): KUHF e_tot "
        f"{e:.10f} conv {mf.converged} in {mf.cycles} cycle(s), "
        f"{restart_s:.2f}s with setup; |e_tot - phase 6b's host KUHF| "
        f"{de:.2e} Ha, against its DeviceKUHF {abs(e - prod['e_dev']):.2e}")
    if not (mf.converged and mf.cycles <= 2 and de <= 1e-8):
        raise RuntimeError("the checkpoint restart missed phase 6b's energy")
    pop = ao_populations(cell, mf.dm, mf.s1e)
    charges, moments = mulliken(mf, log=False)
    _, mom_ref = atom_charges_and_moments(cell, mf.dm, mf.s1e)
    dn = abs(pop.sum() - cell.nelectron)
    dmom = float(np.abs(moments - mom_ref).max())
    d6b = float(np.abs(moments - prod["moments"]).max())
    log(f"[8a] mulliken: populations sum {pop.sum():.10f} (nelec "
        f"{cell.nelectron}, |d| {dn:.2e}); charges " + " ".join(
            f"{q:+.4f}" for q in charges) + "; moments " + " ".join(
            f"{m:+.4f}" for m in moments) + f"; against "
        f"atom_charges_and_moments {dmom:.2e}, against phase 6b {d6b:.2e}")
    if not (dn <= 1e-8 and dmom <= 1e-12 and d6b <= 5e-4
            and moments[0] * moments[1] < 0
            and abs(abs(moments[0]) - 1.9336) <= 5e-4
            and abs(abs(moments[1]) - 1.9336) <= 5e-4):
        raise RuntimeError("the Mulliken analysis of the restart is off")
    del mf
    _park(df)                    # phase 9d serves KS from this build
    torch.cuda.empty_cache()
    lat, atoms = structure.nio_afm()
    lat2, atoms2 = structure.parse_poscar(
        structure.format_poscar(lat, atoms, comment="NiO AFM"))
    cell2 = structure.to_cell(lat2, atoms2, basis="gth-dzvp-molopt-sr",
                              pseudo="gth-pade", ke_cutoff=200.0,
                              exp_to_discard=0.1)
    dx = max(float(np.abs(cell2.a - cell.a).max()),
             float(np.abs(cell2.atom_coords() - cell.atom_coords()).max()))
    same = ([s for s, _ in cell2.atom] == [s for s, _ in cell.atom]
            and np.array_equal(cell2.mesh, cell.mesh)
            and cell2.nao_nr() == cell.nao_nr())
    log(f"[8a] format_poscar -> parse_poscar: NiO cell max |d| {dx:.2e} "
        f"bohr, symbols/mesh/nao equal {same}")
    if not (same and dx <= 1e-8):
        raise RuntimeError("format_poscar does not reproduce the NiO cell")


def _cderi(torch, ctx):
    """(b) the compact cderi serve on phase 4's slice state."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import cderi
    from fftisdf_tpu_torch.lattice import kpoints as kpt_mod

    cell, kpts, df = ctx["slice"]
    _unpark(df)
    vj_e, vk_e = _slice_exact_jk(ctx, cell, kpts)
    dm = _bench_density(cell, kpts)
    nk = len(kpts)

    def timed(fn):
        fn()                                   # warm-up: library handles
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (vj_i, vk_i), jk_s = timed(lambda: df.get_jk(dm))
    (cd, sign), cd_s = timed(lambda: cderi.wq_to_cd_signed(df.wq))
    q_of = cderi.q_index_table(cell, kpts)
    k2c = max(1, nk // 8)
    while nk % k2c:
        k2c -= 1
    (vj_c, vk_c), cjk_s = timed(lambda: cderi.get_jk_cderi(
        df.x_k, cd, q_of, dm, k2_chunk=k2c, sign=sign))
    # the ISDF serve's exchange takes the real image-space metric, i.e. the
    # time-reversal-symmetric part of w_q; the cderi arm factors w_q as it
    # is.  Its exactness is held on the symmetric part, J on w_0 as it is
    s = cell.get_scaled_kpts(kpts)
    minus = [kpt_mod.member(-v, s, strict=False) for v in s]
    w_trs = 0.5 * (df.wq + df.wq[minus].conj())
    asym = float((df.wq - w_trs).abs().max() / df.wq.abs().max())
    cd_t, sign_t = cderi.wq_to_cd_signed(w_trs)
    del w_trs
    _, vk_t = cderi.get_jk_cderi(df.x_k, cd_t, q_of, dm, k2_chunk=k2c,
                                 sign=sign_t)
    del cd_t, sign_t
    d_serve = {"vj": float((vj_c - vj_i).abs().max()),
               "vk": float((vk_c - vk_i).abs().max()),
               "vk (symmetric w_q)": float((vk_t - vk_i).abs().max())}
    errs = _maxerrs(vj_c, vk_c, vj_e, vk_e)
    log(f"[8b] slice cderi: naux {cd.shape[1]}, k2_chunk {k2c}; signed "
        f"factorisation {cd_s:.3f}s, cderi J/K {cjk_s:.3f}s, ISDF get_jk "
        f"{jk_s:.4f}s (warm, each); w_q's time-reversal asymmetry {asym:.2e}"
        " of max; against the ISDF serve: " + ", ".join(
            f"{n} {e:.2e}" for n, e in d_serve.items()) + " (gate 1e-8 on vj "
        "and the symmetric vk); " + ", ".join(
            f"{n}_maxerr {e:.3e} (scale {sc:.3f})"
            for n, (e, sc) in errs.items()) + " against the exact J/K")
    if not (d_serve["vj"] <= 1e-8 and d_serve["vk (symmetric w_q)"] <= 1e-8
            and all(np.isfinite(e) and e < 1e-2 for e, _ in errs.values())):
        raise RuntimeError("the cderi serve misses the ISDF serve or the "
                           "exact J/K")
    del cd, sign, vj_c, vk_c
    torch.cuda.empty_cache()


def _bands(torch, ctx):
    """(c) band energies from phase 6a's converged KUHF on the slice: at
    mesh points, along an L-Gamma-X path, and against the exact band
    path."""
    import numpy as np
    from fftisdf_tpu_torch.basis.eval import make_evaluator
    from fftisdf_tpu_torch.isdf.bands import _qlat_dmin2
    from fftisdf_tpu_torch.pw import jk as pw_jk
    from fftisdf_tpu_torch.scf import PWDF
    from fftisdf_tpu_torch.scf.hf import _eigh_gen

    cell, kpts, df = ctx["slice"]
    mf = ctx["slice_mf"]         # phase 10b's UMP2 and UTDA reference
    nk = len(kpts)
    # mesh points: the band serve re-fits each (band, k2) pair, the SCF's
    # serve fits the whole q sector, so they agree to the compression error
    t0 = time.perf_counter()
    es_m, _ = mf.get_bands(kpts[:2])
    mesh_s = (time.perf_counter() - t0) / 2
    fock = mf.get_fock(mf.dm)[0]
    d_fock = d_mo = 0.0
    for s in range(2):
        for k in range(2):
            e_ref, _ = _eigh_gen(fock[s, k], mf.s1e[k], cutoff=mf.ovlp_cutoff)
            d_fock = max(d_fock, float(np.abs(es_m[s][k] - e_ref).max()))
            d_mo = max(d_mo, float(np.abs(es_m[s][k]
                                          - mf.mo_energy[s, k]).max()))
    log(f"[8c] bands at 2 mesh points ({mesh_s:.2f}s a point): against the "
        f"converged Fock's eigenvalues {d_fock:.2e} Ha, against mo_energy "
        f"{d_mo:.2e} Ha (gate 1e-3: the per-pair re-fit's compression)")
    if not d_fock <= 1e-3:
        raise RuntimeError("mesh-point bands miss the converged Fock")

    # an L-Gamma-X path (the rocksalt labels; conventional cubic a)
    a = float(cell.a[0, 0])
    kl, kx = np.full(3, np.pi / a), np.array([2.0 * np.pi / a, 0.0, 0.0])
    path = np.array([kl * (1 - t) for t in np.linspace(0, 1, 5)]
                    + [kx * t for t in np.linspace(0.25, 1, 4)])
    t0 = time.perf_counter()
    es_p, _ = mf.get_bands(path)
    path_s = (time.perf_counter() - t0) / len(path)
    na, nb = mf.nocc_ab
    gaps = []
    for s, n in enumerate((na, nb)):
        homo = max(float(e[n - 1]) for e in es_p[s])
        lumo = min(float(e[n]) for e in es_p[s])
        gaps.append((homo, lumo))
    homo = max(h for h, _ in gaps)
    lumo = min(lo for _, lo in gaps)
    finite = all(np.isfinite(e).all() and (np.diff(e) >= -1e-12).all()
                 for es in es_p for e in es)
    log(f"[8c] L-Gamma-X path, {len(path)} points ({path_s:.2f}s a point, "
        f"{nk} sector metrics each): HOMO {homo:.6f} LUMO {lumo:.6f} Ha, "
        f"indirect gap {(lumo - homo) * 27.211386:.4f} eV; finite and "
        f"sorted {finite}")
    if not (finite and lumo > homo):
        raise RuntimeError("the band path is malformed")

    # two path points against the exact band path, on the SCF's density
    kb = path[[1, 6]]
    vj_i, vk_i = df.get_jk(mf.dm, kpts_band=kb)
    coords = cell.gen_uniform_grids()
    pw = PWDF(cell, kpts)
    aob = make_evaluator(cell, kpts=kb)(coords)
    thr = _qlat_dmin2(cell, df.kmesh)
    t0 = time.perf_counter()
    vj_x = torch.stack([pw_jk.get_j_kpts(cell, d, pw.ao, ao_band=aob)
                        for d in mf.dm])
    vk_x = torch.stack([pw_jk.get_k_kpts(cell, d, pw.ao, kpts, coords=coords,
                                         ao_band=aob, kpts_band=kb,
                                         g0_argmin_thresh=thr)
                        for d in mf.dm])
    torch.cuda.synchronize()
    exact_s = (time.perf_counter() - t0) / len(kb)
    tol = 1e-3 * max(1.0, float(vk_x.abs().max()))
    errs = _maxerrs(vj_i, vk_i, vj_x, vk_x)
    log(f"[8c] 2 path points, ISDF band J/K against the exact band path "
        f"({exact_s:.2f}s a point): " + ", ".join(
            f"{n} {e:.3e} (scale {sc:.3f})" for n, (e, sc) in errs.items())
        + f", gate {tol:.1e}")
    if not all(e <= tol for e, _ in errs.values()):
        raise RuntimeError("the ISDF band J/K miss the exact band path")
    # the exact band path at a mesh point is the mesh serve (phase 5c)
    vj_e, vk_e = _slice_exact_jk(ctx, cell, kpts)
    dm = _bench_density(cell, kpts)
    ao1 = pw.ao[1:2]
    vj_b = pw_jk.get_j_kpts(cell, dm, pw.ao, ao_band=ao1)
    vk_b = pw_jk.get_k_kpts(cell, dm, pw.ao, kpts, coords=coords,
                            ao_band=ao1, kpts_band=kpts[1:2],
                            g0_argmin_thresh=thr)
    rel = max(float((a[0] - b[1]).abs().max() / b[1].abs().max())
              for a, b in ((vj_b, vj_e), (vk_b, vk_e)))
    log(f"[8c] exact band path at mesh point 1 against the mesh serve: "
        f"{rel:.2e} relative (gate 1e-10)")
    if not rel <= 1e-10:
        raise RuntimeError("the exact band path misses the mesh serve")
    del pw, aob, ao1, mf
    _park(df)                    # phase 9c serves KS from this build
    torch.cuda.empty_cache()


def _h2_box(L, ke=80.0, R=1.4):
    """H2/STO-3G centred in an L-bohr cube (examples/molecule_in_a_box.py)."""
    import numpy as np
    from fftisdf_tpu_torch.lattice.cell import Cell

    return Cell(a=np.eye(3) * L, atom=[("H", (L / 2, L / 2, L / 2 - R / 2)),
                                       ("H", (L / 2, L / 2, L / 2 + R / 2))],
                basis="sto-3g", pseudo=None, ke_cutoff=ke, unit="bohr",
                precision=1e-12).build()


def _h2_slab(lz, L=8.0, ke=60.0, R=1.4):
    """The H2 monolayer of tests/test_trunc_scf.py."""
    import numpy as np
    from fftisdf_tpu_torch.lattice.cell import Cell

    return Cell(a=np.diag([L, L, lz]),
                atom=[("H", (L / 2 - R / 2, L / 2, lz / 2)),
                      ("H", (L / 2 + R / 2, L / 2, lz / 2))],
                basis="sto-3g", pseudo=None, ke_cutoff=ke, unit="bohr",
                precision=1e-12).build()


def _trunc_scf(torch):
    """(d) SCF-level truncation against the JAX package's energies."""
    import warnings
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KRHF

    refs = json.loads(REFS.read_text())
    box = refs["trunc_h2_box"]
    ok = True
    for L in (9.0, 11.0, 12.5):
        ref = box[str(L)]
        cell = _h2_box(L)
        kpts = cell.get_kpts([1, 1, 1])
        t0 = time.perf_counter()
        mf = KRHF(cell, kpts, trunc="0d", verbose=0)
        e_x = mf.kernel()
        ok &= mf.converged
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            e_i = {}
            for label, mask in (("JAX points", ref["mask"]), ("own", None)):
                df = FFTISDF(cell, kpts, c0=25.0, m0=(15, 15, 15),
                             verbose=0, trunc="0d").build(mask=mask)
                mf_i = KRHF(cell, kpts, df, verbose=0)
                e_i[label] = mf_i.kernel()
                ok &= mf_i.converged and mf_i.trunc == df.trunc
        d = (abs(e_x - ref["e_exact"]), abs(e_i["JAX points"] - ref["e_isdf"]),
             abs(e_i["own"] - e_x))
        log(f"[8d] H2 box L {L:g} (mesh {[int(m) for m in cell.mesh]}, "
            f"{time.perf_counter() - t0:.2f}s): exact {e_x:.10f} (JAX |d| "
            f"{d[0]:.2e}), ISDF on the JAX points {e_i['JAX points']:.10f} "
            f"(JAX |d| {d[1]:.2e}), own selection {e_i['own']:.10f} (|d| "
            f"exact {d[2]:.2e}); textbook -1.1167: {e_x + 1.1167:+.2e}")
        ok &= max(d[:2]) <= 1e-6 and d[2] <= 1e-6
        ok &= abs(e_x + 1.1167) < 0.011
    slab = refs["trunc_h2_slab"]
    es = {}
    for lz in (12.0, 16.0):
        cell = _h2_slab(lz)
        mf = KRHF(cell, cell.get_kpts([1, 1, 1]), trunc="2d", exxdiv="ewald",
                  verbose=0)
        es[lz] = mf.kernel()
        ok &= mf.converged and abs(es[lz] - slab[str(lz)]) <= 1e-6
        log(f"[8d] H2 monolayer lz {lz:g} trunc {mf.trunc} exxdiv ewald: "
            f"{es[lz]:.10f} (JAX |d| {abs(es[lz] - slab[str(lz)]):.2e})")
    dv = abs(es[12.0] - es[16.0])
    log(f"[8d] monolayer vacuum independence {dv:.2e} (gate 2e-4); "
        f"textbook -1.1167: {es[12.0] + 1.1167:+.2e}")
    ok &= dv < 2e-4 and abs(es[12.0] + 1.1167) < 0.011
    if not ok:
        raise RuntimeError("SCF-level truncation misses the JAX package")


def _tools(torch):
    """(e) the Gamma-point fit, LS-THC, mo_eri and whiten_basis on the card
    against the CPU run of the port."""
    import numpy as np
    from fftisdf_tpu_torch.basis.eval import eval_ao_kpts
    from fftisdf_tpu_torch.isdf import FFTISDF, ao2mo, gamma
    from fftisdf_tpu_torch.isdf.kpoint import _stripe_quartic
    from fftisdf_tpu_torch.isdf.thc import LSTHC
    from fftisdf_tpu_torch.lattice import becke
    from fftisdf_tpu_torch.lattice.cell import Cell
    from fftisdf_tpu_torch.linalg.solvers import whiten_basis

    # the Gamma-point / global fit on phase 2's diamond, at full rank
    cell, kpts = _diamond()
    coords = cell.gen_uniform_grids()
    rho, rank = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        ao = eval_ao_kpts(cell, coords, kpts, device=dev)
        xi, mask, rank[dev] = gamma.fit_gamma(ao, nip=256)
        rho[dev] = torch.stack([gamma.reconstruct_pair(xi, mask, ao[a],
                                                       ao[b]).cpu()
                                for a in range(2) for b in range(2)])
        exact = torch.stack([(ao[a].conj()[:, :, None]
                              * ao[b][:, None, :]).cpu()
                             for a in range(2) for b in range(2)])
        err = float((rho[dev] - exact).abs().max())
        log(f"[8e] diamond fit_gamma on {dev}: rank {rank[dev]} (< 256, full)"
            f", pair reconstruction {err:.2e} ({time.perf_counter() - t0:.2f}"
            "s)")
        if not (rank[dev] < 256 and err < 1e-10):
            raise RuntimeError("the Gamma-point fit is not exact at full "
                               "rank")
    d = float((rho["cuda"] - rho["cpu"]).abs().max())
    log(f"[8e] fit_gamma card vs CPU: ranks {rank['cuda']}/{rank['cpu']}, "
        f"reconstructions {d:.2e}")
    if not (rank["cuda"] == rank["cpu"] and d < 2e-10):
        raise RuntimeError("fit_gamma differs between card and CPU")

    # LS-THC on He2 (tests/test_thc_ao2mo.py), uniform and Becke grids
    def he2(a=(5.0, 5.0, 7.0), mesh=(9, 9, 11)):
        return Cell(a=np.diag(a), atom=[("He", (a[0] / 2, a[1] / 2, 2.0)),
                                        ("He", (a[0] / 2, a[1] / 2, 4.5))],
                    basis="sto-3g", pseudo=None, mesh=np.array(mesh),
                    unit="bohr", precision=1e-12).build()

    for mode, gate in (("uniform", 1e-7), ("becke", 5e-5)):
        cell = he2(**(dict(a=(7.0, 7.0, 8.0), mesh=(11, 11, 13))
                      if mode == "becke" else {}))
        kpts = cell.get_kpts([1, 1, 2])
        grids = (becke.AtomCenteredGrids(cell, level=0).build()
                 if mode == "becke" else None)
        rep = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            thc = LSTHC(cell, kpts, verbose=0, grids=grids,
                        device=dev).build()
            rep[dev] = np.array([r[2] for r in thc.error_report()])
            log(f"[8e] LS-THC {mode} on {dev}: nip {len(thc.mask)}, max "
                f"cderi error {rep[dev].max():.2e} (gate {gate:.0e}), "
                f"{time.perf_counter() - t0:.2f}s")
        if not (rep["cuda"].max() < gate and rep["cpu"].max() < gate):
            raise RuntimeError(f"LS-THC ({mode}) misses its gate")

    # mo_eri and whiten_basis on the full-rank He2 build
    cell = he2()
    kpts = cell.get_kpts([1, 1, 2])
    rng = np.random.default_rng(0)
    nao = cell.nao_nr()
    cs = [rng.standard_normal((nao, 2)) + 1j * rng.standard_normal((nao, 2))
          for _ in range(4)]
    kidx = (0, 1, 1, 0)
    out, mask = {}, None
    for dev in ("cuda", "cpu"):
        df = FFTISDF(cell, kpts, c0=50.0, m0=tuple(cell.mesh), verbose=0,
                     select_tol=1e-20, rcond=1e-13, device=dev).build(
                         mask=mask)
        mask = df.mask
        eri_mo = ao2mo.mo_eri(df, cs, kidx).cpu().numpy()
        eri_ao = df.get_eri(kidx).cpu().numpy()
        ref = np.einsum("mnkl,mi,nj,kx,ly->ijxy", eri_ao, cs[0].conj(),
                        cs[1], cs[2].conj(), cs[3])
        d_rot = float(np.abs(eri_mo - ref).max())
        phase = torch.as_tensor(df.phase, dtype=df.x_k.dtype,
                                device=df.device)
        x4 = _stripe_quartic(df.x_k, phase)
        _, scale = whiten_basis(df.x_k, x4)
        w, v = torch.linalg.eigh(x4)
        a_rot = v.mH @ x4 @ v
        off = float((a_rot - torch.diag_embed(torch.diagonal(
            a_rot, dim1=-2, dim2=-1))).abs().max() / a_rot.abs().max())
        sc = scale.cpu().numpy()
        out[dev] = (eri_mo, np.where(sc > 0, 1.0 / np.where(sc > 0, sc, 1.0),
                                     0.0))
        log(f"[8e] He2 full rank on {dev}: nip {df.nip}; mo_eri against "
            f"get_eri rotated to MOs {d_rot:.2e}; whiten_basis: {df.nkpt} "
            f"sectors, kept {int((scale > 0).sum())} directions, "
            f"off-diagonal {off:.2e} of the rotated metric")
        if not (d_rot < 1e-10 and off < 1e-12):
            raise RuntimeError("mo_eri or whiten_basis is off")
    d_eri = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    # the kept eigenvalues 1/scale, to eigh roundoff of the largest
    w_c, w_g = out["cpu"][1], out["cuda"][1]
    same_kept = np.array_equal(w_c > 0, w_g > 0)
    d_w = float(np.abs(w_g - w_c).max() / np.abs(w_c).max())
    log(f"[8e] card vs CPU: mo_eri {d_eri:.2e}, whiten_basis kept "
        f"eigenvalues {d_w:.2e} of the largest, kept directions equal "
        f"{same_kept}")
    if not (d_eri < 1e-10 and same_kept and d_w < 1e-12):
        raise RuntimeError("mo_eri or whiten_basis differs between card "
                           "and CPU")


# ------------------------------------------------------------------ phase 9
def phase9_ks(torch, ctx):
    _ks_diamond(torch)
    _ks_anchor(torch)
    _ks_slice(torch, ctx)
    _ks_production(torch, ctx)


def _toy_rho(cell, seed):
    """Smooth, strictly positive seeded spin densities on the cell's mesh
    (tests/test_ks.py's ``_toy_rho``) and a kinetic-energy density above
    the uniform gas's."""
    import numpy as np

    fmesh = tuple(int(m) for m in cell.mesh)
    ng = int(np.prod(fmesh))
    coef = np.random.default_rng(seed).standard_normal((2, 4, 4, 4)) * 0.05
    field = np.zeros((2,) + fmesh)
    for s in range(2):
        f = np.zeros(fmesh, dtype=complex)
        f[:4, :4, :4] = coef[s] * ng
        field[s] = np.real(np.fft.ifftn(f))
    rho = (0.3 + field - field.min()).reshape(2, ng)
    tau = 0.39 * (3.0 * np.pi ** 2) ** (2.0 / 3.0) * (2.0 * rho) ** (5.0 / 3.0)
    return rho, tau / 2.0 + 0.05


def _xc_fd(torch, cell):
    """exc_and_vxc on the card in float64: sum(vxc drho) w against the
    central difference of Exc along a seeded drho (and dtau for SCAN)."""
    import numpy as np
    from fftisdf_tpu_torch.scf import xc

    fmesh = tuple(int(m) for m in cell.mesh)
    w = float(cell.vol) / int(np.prod(fmesh))
    dev = torch.device("cuda")
    gv = torch.as_tensor(cell.get_Gv(fmesh), device=dev)
    rho, tau = (torch.as_tensor(a, device=dev) for a in _toy_rho(cell, 4))
    g = torch.Generator(device=dev).manual_seed(8)
    d_r, d_t = (1e-4 * torch.randn(rho.shape, generator=g, device=dev,
                                   dtype=rho.dtype) for _ in range(2))
    out = {}
    for name, gate in (("pbe", 1e-7), ("scan", 1e-6)):
        spec = xc.parse_xc(name)
        if spec.is_mgga:
            f = lambda r, t: xc.exc_and_vxc_mgga(r, t, gv, spec, fmesh, w)
            _, v, vt = f(rho, tau)
            an = float((v * d_r).sum() + (vt * d_t).sum()) * w
            fd = (float(f(rho + d_r, tau + d_t)[0])
                  - float(f(rho - d_r, tau - d_t)[0])) / 2.0
        else:
            f = lambda r: xc.exc_and_vxc(r, gv, spec, fmesh, w)
            v = f(rho)[1]
            an = float((v * d_r).sum()) * w
            fd = (float(f(rho + d_r)[0]) - float(f(rho - d_r)[0])) / 2.0
        out[name] = (abs(fd - an) / abs(fd), gate)
    return out


def _ks_diamond(torch):
    """(a) diamond: each functional built and solved on the card and on
    the CPU; the finite-difference check of exc_and_vxc on the card."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KRKS, KUKS

    cell, kpts = _diamond()
    refs = json.loads(REFS.read_text())["ks_diamond"]
    runs = (("krks_lda", KRKS, "lda", None), ("krks_pbe", KRKS, "pbe", None),
            ("krks_b3lyp", KRKS, "b3lyp", None),
            ("krks_scan", KRKS, "scan", None),
            ("krks_hse06", KRKS, "hse06", None),
            ("kuks_lda_u", KUKS, "lda", {0: (1, 0.2), 1: (1, 0.2)}))
    mfs = {}
    for dev in ("cuda", "cpu"):
        df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                     device=dev).build(mask=np.asarray(refs["mask"]))
        for key, cls, xc, hub in runs:
            mf = cls(cell, kpts, df, xc=xc, hubbard=hub, device=dev,
                     verbose=0, conv_tol=1e-10, max_cycle=80)
            mf.kernel()
            mfs[dev, key] = mf
    ok = True
    for key, cls, _, _ in runs:
        g, c = mfs["cuda", key], mfs["cpu", key]
        nspin = 2 if cls is KUKS else 1
        dm = c.dm if nspin == 2 else c.dm[None]
        v_g = g._xc_eval(g._dm_device(dm), nspin)[1]
        v_c = c._xc_eval(c._dm_device(dm), nspin)[1]
        rel = float(np.abs(v_g - v_c).max() / np.abs(v_c).max())
        de = abs(g.e_tot - c.e_tot)
        dj = abs(g.e_tot - refs[key]["e_tot"])
        log(f"[9a] diamond {key}: e_tot cuda {g.e_tot:.12f} cpu "
            f"{c.e_tot:.12f} |dE| {de:.2e} (gate 1e-9), cycles "
            f"{g.cycles}/{c.cycles}; Vxc on the CPU's density {rel:.2e} "
            f"relative (gate 1e-10); JAX package's energy {dj:.2e} off")
        ok &= (g.converged and c.converged and de <= 1e-9 and rel <= 1e-10
               and dj <= 1e-8)
    mf = mfs["cuda", "krks_scan"]
    es, _ = mf.get_bands(kpts)
    nocc = cell.nelectron // 2
    d_b = float(np.abs(np.asarray(es)[:, :nocc + 1]
                       - mf.mo_energy[:, :nocc + 1]).max())
    log(f"[9a] diamond SCAN bands at the mesh points on the card against "
        f"the SCF's eigenvalues {d_b:.2e} Ha (gate 5e-5; the build is full "
        "rank)")
    fd = _xc_fd(torch, cell)
    log("[9a] exc_and_vxc on the card, central difference against "
        "sum(vxc drho) w: " + ", ".join(f"{n} {e:.2e} (gate {gt:.0e})"
                                        for n, (e, gt) in fd.items()))
    if not (ok and d_b <= 5e-5 and all(e <= gt for e, gt in fd.values())):
        raise RuntimeError("KS on the card misses the CPU, the JAX package "
                           "or its own derivative")
    del mfs, mf, df
    torch.cuda.empty_cache()


def _nio_hubbard(u):
    """DFT+U on the Ni d shells (atoms 0 and 1), examples/nio_afm_kuhf.py's
    ``--hubbard-u``."""
    return {0: (2, u), 1: (2, u)}


def _ks_anchor(torch):
    """(b) KUKS-PBE and KUKS-PBE+U on the NiO anchor (the JAX package's
    points) against the JAX package's energies."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KUKS
    from fftisdf_tpu_torch.scf.analysis import atom_charges_and_moments

    rec = json.loads(KS_ANCHOR.read_text())
    cfg = rec["config"]
    cell, kpts = _nio(cfg["ke_cutoff"], cfg["kmesh"])
    df = FFTISDF(cell, kpts, c0=cfg["c0"], m0=tuple(cfg["m0"]),
                 verbose=0).build(mask=np.asarray(rec["mask"]))
    ok = True
    for key, hub in (("pbe", None),
                     ("pbe_u", _nio_hubbard(cfg["hubbard_u_ha"]))):
        t0 = time.perf_counter()
        mf = KUKS(cell, kpts, df, xc="pbe", hubbard=hub, verbose=0,
                  conv_tol=cfg["conv_tol"], max_cycle=cfg["max_cycle"],
                  init_spin=AFM, smearing=cfg["smearing"])
        e = mf.kernel()
        secs = time.perf_counter() - t0
        _, mom = atom_charges_and_moments(cell, mf.dm, mf.s1e)
        ref = rec[key]
        de = abs(e - ref["e_tot"])
        log(f"[9b] anchor KUKS-{key.upper().replace('_U', '+U')}: e_tot "
            f"{e:.10f} conv {mf.converged} cycles {mf.cycles} ({secs:.1f}s)"
            f"; JAX {ref['e_tot']:.10f} ({ref['cycles']} cycles): |dE| "
            f"{de:.2e} Ha (gate 1e-6); Ni moments {mom[0]:+.4f} "
            f"{mom[1]:+.4f}, JAX {ref['moments'][0]:+.4f} "
            f"{ref['moments'][1]:+.4f}")
        ok &= mf.converged and de <= 1e-6
    if not ok:
        raise RuntimeError("KUKS misses the JAX anchor")
    del df, mf
    torch.cuda.empty_cache()


def _xc_pass_figures(torch, mf, dm):
    """(milliseconds, extra peak bytes, AO tensor bytes) of one xc pass of
    ``mf``'s functional on the spin density ``dm``, warm."""
    from fftisdf_tpu_torch.scf import xc

    ao = mf._get_ao()
    args = (ao, mf._dm_device(dm), mf._gv, mf._spec, mf._fmesh,
            mf._xc_weight, len(mf.kpts), 2)
    kw = dict(coords=mf._coords, kpts=mf._kpts_arr)
    xc.xc_pass(*args, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xc.xc_pass(*args, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, torch.cuda.max_memory_allocated() - base, \
        ao.numel() * ao.element_size()


def _band_potentials(mf, nb):
    """(Vxc, V_U or None): max|band path - SCF| / max|SCF| of a KUKS's
    band-path xc and +U matrices at its first ``nb`` mesh points, where
    both are the SCF's own matrices to rounding (the band eigenvalues also
    carry the J re-fit's compression)."""
    import numpy as np

    kb = mf.kpts[:nb]
    s1e_b, _, _, _, aob = mf._band_ingredients(kb, mf.dm, with_k=False,
                                               return_ao=True)
    dm_dev = mf._dm_device(mf.dm)
    v_b = mf._band_vxc(dm_dev, aob, 2, kpts_band=kb)
    v_k = mf._xc_eval(dm_dev, 2)[1][:, :nb]
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    rel_u = None
    if mf._hub_sites is not None:
        rel_u = rel(mf._hubbard_vu_bands(mf.dm, s1e_b),
                    mf._hubbard_eu_vu(mf.dm)[1][:, :nb])
    return rel(v_b, v_k), rel_u


def _ks_slice(torch, ctx):
    """(c) the slice: DeviceKUKS against the host KUKS on phase 4's build,
    SCAN on the host, bands, float32."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KUKS, DeviceKUKS
    from fftisdf_tpu_torch.scf.hf import _eigh_gen

    cell, kpts, df = _slice(ctx)
    if df.x_k.device.type != "cuda":
        _unpark(df)
    t0 = time.perf_counter()
    df.get_ws_omega(-0.11)
    torch.cuda.synchronize()
    log(f"[9c] slice erfc-screened metric (omega -0.11, one metric pass "
        f"and its image-space form) {time.perf_counter() - t0:.3f}s")
    ok = True
    runs = (("PBE+U", "pbe", _nio_hubbard(NIO_U), True),
            ("PBE0", "pbe0", None, True), ("HSE06", "hse06", None, True),
            ("SCAN", "scan", None, False), ("PBE", "pbe", None, False))
    for label, xc_name, hub, device in runs:
        host = KUKS(cell, kpts, df, xc=xc_name, hubbard=hub, verbose=0,
                    **KS_KW)
        host.kernel()
        ms, peak, nbytes = _xc_pass_figures(torch, host, host.dm)
        line = (f"[9c] slice {label}: " + _scf_line("host KUKS", host,
                                                    host.cycle_seconds)
                + f"; xc pass {ms:.1f} ms, +{peak / 1e9:.2f} GB peak over "
                f"the {nbytes / 1e9:.2f} GB AO tensor")
        ok &= host.converged
        if label in ("PBE+U", "SCAN", "PBE"):
            r_v, r_u = _band_potentials(host, 2)
            line += (f"; at 2 mesh points band-path Vxc {r_v:.2e}"
                     + ("" if r_u is None else f", V_U {r_u:.2e}")
                     + " relative to the SCF's (gate 1e-10)")
            ok &= r_v <= 1e-10 and (r_u is None or r_u <= 1e-10)
        if device:
            dev = DeviceKUKS(cell, kpts, df, xc=xc_name, hubbard=hub,
                             verbose=0, **KS_KW)
            dev.kernel()
            de = abs(dev.e_tot - host.e_tot)
            line += ("; " + _scf_line("DeviceKUKS", dev, dev.cycle_times)
                     + f"; |dE| {de:.2e} Ha (gate 3e-8)")
            ok &= dev.converged and de <= 3e-8
            del dev
        log(line)
        if label != "PBE":
            del host
        torch.cuda.empty_cache()
    # bands at two mesh points; the band serve re-fits J pair by pair where
    # the SCF's serve fits the q sector, so they agree to the compression
    t0 = time.perf_counter()
    es, _ = host.get_bands(kpts[:2])
    band_s = (time.perf_counter() - t0) / 2
    fock = host.get_fock(host.dm)[0]
    na = host.nocc_ab[0]
    d_mo = d_fock = 0.0
    for s in range(2):
        for k in range(2):
            e_ref, _ = _eigh_gen(fock[s, k], host.s1e[k],
                                 cutoff=host.ovlp_cutoff)
            d_fock = max(d_fock, float(np.abs(es[s][k][:na + 1]
                                              - e_ref[:na + 1]).max()))
            d_mo = max(d_mo, float(np.abs(es[s][k][:na + 1]
                                          - host.mo_energy[s, k][:na + 1])
                                   .max()))
    log(f"[9c] slice KUKS-PBE bands at 2 mesh points ({band_s:.2f}s a "
        f"point): against the SCF eigenvalues {d_mo:.2e} Ha, against the "
        f"converged Fock's {d_fock:.2e} Ha (gate 1e-3: the band serve's "
        "per-pair re-fit of J against the SCF's compressed J; its Vxc is "
        "held to 1e-10 above)")
    ok &= d_fock <= 1e-3
    e64 = host.e_tot
    del host
    _park(df)                    # phase 10b serves UMP2 and UTDA from it
    df._wq_omega = {}
    torch.cuda.empty_cache()
    # float32: its own build, KUKS-PBE against the float64 energy
    df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), dtype=torch.float32,
                 verbose=0).build()
    mf = KUKS(cell, kpts, df, xc="pbe", dtype=torch.float32, verbose=0,
              **dict(SCF_KW_F32, max_cycle=150))
    mf.kernel()
    de = abs(mf.e_tot - e64) / cell.natm
    log(f"[9c] slice float32 " + _scf_line("KUKS-PBE", mf, mf.cycle_seconds)
        + f"; |e_tot - float64 KUKS-PBE| {de:.3e} Ha/atom (gate 2e-2)")
    ok &= mf.converged and de <= 2e-2
    del df, mf
    torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError("KS on the slice: a loop did not converge or the "
                           "device and host loops disagree")


def _ks_cycle_parts(torch, mf):
    """The KS cycle's own parts, beyond the loop's, as callables on
    ``mf``'s converged density: the J serve, the +U energy and potential
    on the card (the device loop's) and in numpy (the host loop's)."""
    from fftisdf_tpu_torch.isdf import jk as jk_mod
    from fftisdf_tpu_torch.scf import hubbard as hub_mod

    df = mf.with_df
    dm = mf._dm_device(mf.dm)
    dm_s = dm.to(df.x_k.dtype)
    shalf = torch.as_tensor(mf._shalf, device=dm.device, dtype=dm.dtype)
    return {
        "J serve": lambda: jk_mod.get_j_kpts(df.x_k, df.wq[0], dm_s),
        "+U on the card": lambda: hub_mod.eu_and_vu_traced(
            dm, shalf, mf._hub_sites),
        "+U, host loop (numpy)": lambda: mf._hubbard_eu_vu(mf.dm),
    }


def _ks_production(torch, ctx):
    """(d) DeviceKUKS-PBE+U at production on phase 6b's build."""
    from fftisdf_tpu_torch.scf import KUKS, DeviceKUKS, dos
    from fftisdf_tpu_torch.scf.analysis import atom_charges_and_moments

    prod = ctx.pop("production")
    cell, kpts, df = prod["cell"], prod["kpts"], prod["df"]
    if df.x_k.device.type != "cuda":
        _unpark(df)
    hub = _nio_hubbard(NIO_U)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mf = DeviceKUKS(cell, kpts, df, xc="pbe", hubbard=hub, verbose=3,
                    **KS_KW)
    setup_s = time.perf_counter() - t0
    mf.kernel()
    to_energy = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms, xc_peak, nbytes = _xc_pass_figures(torch, mf, mf.dm)
    parts = _device_loop_parts(torch, mf,
                               extra=_ks_cycle_parts(torch, mf))
    _, mom = atom_charges_and_moments(cell, mf.dm, mf.s1e)
    _, mom_l = atom_charges_and_moments(cell, mf.dm, mf.s1e,
                                        scheme="loewdin")
    per = mf.cycle_times[1:] or mf.cycle_times
    log(f"[9d] production " + _scf_line("DeviceKUKS-PBE+U", mf,
                                        mf.cycle_times)
        + f"; setup {setup_s:.2f}s (the one-electron integrals and the AO "
        f"tensor kept from them); time to the converged energy "
        f"{to_energy:.2f}s; peak "
        f"memory {peak / 1e9:.2f} GB; Ni moments Mulliken {mom[0]:+.4f} "
        f"{mom[1]:+.4f}, Loewdin {mom_l[0]:+.4f} {mom_l[1]:+.4f}")
    log(f"[9d] production xc pass (PBE, 2 spins) {ms:.1f} ms, "
        f"+{xc_peak / 1e9:.2f} GB peak; AO tensor {nbytes / 1e9:.2f} GB, "
        "read at least twice: "
        f"{2 * nbytes / (ms * 1e-3) / 1e12:.2f} TB/s for those reads; "
        f"{sum(per) / len(per):.4f} s/cycle")
    log(f"[9d] production KS cycle parts, each timed alone at the run's "
        f"shapes: xc pass {ms:.2f} ms; " + _parts_line(parts)
        + f"; a device cycle past the first {sum(per) / len(per) * 1e3:.1f}"
        " ms")
    ef = dos.fermi_level(mf)
    energies, pdos = dos.projected_dos(mf, sigma=5e-3, npts=800)
    below = dos.integrated_dos(energies, pdos, ef)        # (2, natm)
    log(f"[9d] projected DOS (Loewdin, sigma 5e-3, 800 points): Fermi level "
        f"{ef:.6f} Ha; states below it by atom, up | down: " + "; ".join(
            f"{sym} {below[0, i]:.3f} | {below[1, i]:.3f}"
            for i, (sym, _) in enumerate(cell.atom)))
    e_dev, cycles = mf.e_tot, mf.cycles
    conv = mf.converged
    del mf
    torch.cuda.empty_cache()
    host = KUKS(cell, kpts, df, xc="pbe", hubbard=hub, verbose=0, **KS_KW)
    host.kernel()
    de = abs(host.e_tot - e_dev)
    log("[9d] production " + _scf_line("host KUKS-PBE+U", host,
                                       host.cycle_seconds)
        + f"; |dE| against DeviceKUKS {de:.2e} Ha (gate 3e-8)")
    ctx["ks_production"] = dict(e_tot=e_dev, cycles=cycles, moments=mom)
    if not (conv and host.converged and mom[0] * mom[1] < 0
            and de <= 3e-8):
        raise RuntimeError("the production DeviceKUKS-PBE+U did not converge "
                           "to an AFM state equal to the host loop's")
    del host
    df.x_k = df.wq = None
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 10
MB_REL = 1e-10       # card against CPU, and the identities
MB_JAX = 1e-8        # against the JAX package's records
QP_ABS = 1e-6        # QP energies: the Newton solve stops at 1e-8 Ha steps,
                     # up to 1.2e-7 Ha from another solve of the same Sigma


def phase10_many_body(torch, ctx):
    ctx.pop("production", None)
    _mb_card_cpu(torch)
    _mb_identities(torch)
    _exciton_dispersion(torch)
    _mb_slice(torch, ctx)
    _mb_diamond(torch)
    _mb_production(torch)


def _unpack(d):
    import numpy as np

    return (np.asarray(d["re"]) + 1j * np.asarray(d["im"])).reshape(
        d["shape"])


def _with_orbitals(mf, rec):
    """``mf`` given a recorded reference's orbitals and density."""
    import numpy as np
    from fftisdf_tpu_torch.scf.hf import _build_dm

    mf.mo_coeff = _unpack(rec["mo_coeff"])
    mf.mo_energy = np.asarray(rec["mo_energy"])
    mf.mo_occ = np.asarray(rec["mo_occ"])
    mf.dm = (np.stack([_build_dm(mf.mo_coeff[s], mf.mo_occ[s])
                       for s in range(2)]) if mf.mo_coeff.ndim == 4
             else _build_dm(mf.mo_coeff, mf.mo_occ))
    return mf


def _closed_shell_u(mf):
    """A KUHF/KUKS holding a restricted reference's orbitals in both
    spin channels."""
    import numpy as np
    from fftisdf_tpu_torch.scf import KUHF, KUKS

    kw = {"xc": mf.xc} if hasattr(mf, "_spec") else {}
    u = (KUKS if kw else KUHF)(mf.cell, mf.kpts, mf.with_df, verbose=0,
                               device=mf.device, **kw)
    u.mo_coeff = np.stack([mf.mo_coeff] * 2)
    u.mo_energy = np.stack([mf.mo_energy] * 2)
    u.mo_occ = np.stack([mf.mo_occ] * 2) * 0.5
    u.dm = np.stack([mf.dm] * 2) * 0.5
    return u


def _h2_chain(spin=0):
    """The H2 chain of tests/test_mp2.py."""
    import numpy as np
    from fftisdf_tpu_torch.lattice.cell import Cell, Shell

    return Cell(a=np.diag([6.0, 6.0, 7.0]),
                atom=[("H", (3.0, 3.0, 1.8)), ("H", (3.0, 3.0, 3.2))],
                basis={"H": [Shell(l=0, exps=np.array([1.2, 0.4]),
                                   coeffs=np.eye(2))]},
                pseudo="gth-pade", mesh=np.array([14, 14, 17]), unit="bohr",
                spin=spin, precision=1e-12).build()


def _relmax(a, b):
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _mb_runs(dev, refs):
    """{name: (value, JAX record or None, JAX tolerance kind)} of every
    method on ``dev``, on the JAX package's points and orbitals: the H2
    chain at gamma and 1x1x2, diamond gth-szv ke 50 1x1x2 (KRKS)."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KRHF, KRKS, KUHF
    from fftisdf_tpu_torch.scf.bse import bse
    from fftisdf_tpu_torch.scf.gw import g0w0
    from fftisdf_tpu_torch.scf.mp2 import kmp2, kump2
    from fftisdf_tpu_torch.scf.rpa import drpa
    from fftisdf_tpu_torch.scf.tddft import tda, tddft, utda

    out = {}
    for key in ("h2_gamma", "h2_k2"):
        rec = refs[key]
        cell = _h2_chain()
        kpts = (np.zeros((1, 3)) if key == "h2_gamma"
                else cell.get_kpts([1, 1, 2]))
        df = FFTISDF(cell, kpts, c0=60.0, m0=(11, 11, 13), verbose=0,
                     select_tol=1e-18, rcond=1e-12, device=dev).build(
                         mask=np.asarray(rec["mask"]))
        mf = _with_orbitals(KRHF(cell, kpts, df, verbose=0, device=dev),
                            rec["krhf"])
        dense = lambda *a, **k: tda(*a, nroots=0, dense=True, **k)[0]
        out[f"{key} kmp2"] = (kmp2(df, mf)[0], rec["kmp2"], "e")
        out[f"{key} drpa"] = (drpa(df, mf, nw=24)[0], rec["drpa"], "e")
        e_qp, info = g0w0(df, mf, nw=24)
        out[f"{key} g0w0"] = (e_qp, rec["e_qp"], "qp")
        out[f"{key} sigma"] = (info["sigma_iw"], _unpack(rec["sigma"])
                               if "sigma" in rec else None, "e")
        if key == "h2_gamma":
            out[f"{key} cis s"] = (dense(mf, df), rec["tda_s"], "e")
            out[f"{key} cis t"] = (dense(mf, df, singlet=False),
                                   rec["tda_t"], "e")
            out[f"{key} tdhf"] = (tddft(mf, df, nroots=3)[0], rec["tddft"],
                                  "e")
            out[f"{key} bse"] = (bse(mf, df, nroots=0, dense=True)[0],
                                 rec["bse"], "e")
            ks = _with_orbitals(KRKS(cell, kpts, df, xc="pbe", verbose=0,
                                     device=dev), rec["krks_pbe"])
            out[f"{key} pbe tda s"] = (dense(ks, df), rec["pbe_tda_s"], "e")
            out[f"{key} pbe tda t"] = (dense(ks, df, singlet=False),
                                       rec["pbe_tda_t"], "e")
            out[f"{key} pbe tddft"] = (tddft(ks, df, nroots=3)[0],
                                       rec["pbe_tddft"], "e")
            out[f"{key} pbe g0w0"] = (g0w0(df, ks, nw=24)[0],
                                      rec["pbe_e_qp"], "qp")
        else:
            um = _with_orbitals(KUHF(_h2_chain(spin=2), kpts, df, verbose=0,
                                     device=dev), rec["kuhf_spin2"])
            out[f"{key} kump2 spin 2"] = (kump2(df, um)[0],
                                          rec["kump2_spin2"], "e")
            out[f"{key} utda spin 2"] = (utda(um, df, nroots=0,
                                              dense=True)[0],
                                         rec["utda_spin2"], "e")
            for q in (0, 1):
                out[f"{key} cis s q{q}"] = (dense(mf, df, q=q),
                                            rec[f"tda_s_q{q}"], "e")
            out[f"{key} cis t q1"] = (dense(mf, df, q=1, singlet=False),
                                      rec["tda_t_q1"], "e")
            out[f"{key} tdhf q1"] = (tddft(mf, df, q=1, nroots=3)[0],
                                     rec["tddft_q1"], "e")
            out[f"{key} bse q1"] = (bse(mf, df, q=1, nroots=0,
                                        dense=True)[0], None, None)
    rec = refs["diamond"]
    cell, kpts = _diamond()
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                 device=dev).build(mask=np.asarray(rec["mask"]))
    for xc in ("pbe", "b3lyp", "hse06"):
        ks = _with_orbitals(KRKS(cell, kpts, df, xc=xc, verbose=0,
                                 device=dev), rec[xc])
        out[f"diamond {xc} tda s q1"] = (
            tda(ks, df, q=1, nroots=0, dense=True)[0],
            rec[xc]["tda_s_q1"], "e")
        if xc != "pbe":
            continue
        r = rec[xc]
        out["diamond pbe tda s q0"] = (tda(ks, df, nroots=0, dense=True)[0],
                                       r["tda_s_q0"], "e")
        out["diamond pbe tda t q0"] = (tda(ks, df, nroots=0, singlet=False,
                                           dense=True)[0], r["tda_t_q0"],
                                       "e")
        out["diamond pbe casida"] = (tddft(ks, df, nroots=4)[0], r["tddft"],
                                     "e")
        out["diamond pbe utda q1"] = (utda(_closed_shell_u(ks), df, q=1,
                                           nroots=0, dense=True)[0],
                                      r["utda"], "e")
        e_qp, info = g0w0(df, ks, nw=24)
        out["diamond pbe sigma"] = (info["sigma_iw"], _unpack(r["sigma"]),
                                    "e")
        out["diamond pbe g0w0"] = (e_qp, r["e_qp"], "qp")
        out["diamond pbe bse@qp"] = (
            bse(ks, df, nroots=0, dense=True,
                qp_energy=np.asarray(r["e_qp"]))[0], r["bse_qp"], "e")
    return out


def _mb_card_cpu(torch):
    """(a) every method on the card and on the CPU: card = CPU to 1e-10
    relative, both = the JAX package's records to 1e-8 (QP energies to
    1e-6 Ha, the Newton solve's stopping scale)."""
    import numpy as np

    refs = json.loads(REFS.read_text())["many_body"]
    t0 = time.perf_counter()
    card = _mb_runs("cuda", refs)
    t_card = time.perf_counter() - t0
    cpu = _mb_runs("cpu", refs)
    worst_dev = worst_jax = 0.0
    bad = []
    for name, (g, ref, kind) in card.items():
        c = cpu[name][0]
        if kind == "qp":
            # each device's Newton solve stops at its own 1e-8 Ha step
            r_dev = float(np.abs(np.asarray(g) - np.asarray(c)).max())
            line = f"[10a] {name}: card-CPU {r_dev:.1e} Ha"
            ok = r_dev <= QP_ABS
        else:
            r_dev = _relmax(g, c)
            worst_dev = max(worst_dev, r_dev)
            line = f"[10a] {name}: card-CPU {r_dev:.1e}"
            ok = r_dev <= MB_REL
        if ref is not None:
            if kind == "qp":
                d = float(np.abs(np.asarray(g) - np.asarray(ref)).max())
                line += f", JAX {d:.1e} Ha (gate {QP_ABS:.0e})"
                ok &= d <= QP_ABS
            else:
                d = _relmax(g, ref)
                worst_jax = max(worst_jax, d)
                line += f", JAX {d:.1e}"
                ok &= d <= MB_JAX
        log(line + ("" if ok else "  FAIL"))
        if not ok:
            bad.append(name)
    log(f"[10a] {len(card)} quantities: card against CPU at most "
        f"{worst_dev:.2e} relative (gate {MB_REL:.0e}; QP energies above, "
        f"gate {QP_ABS:.0e} Ha), against the JAX "
        f"package at most {worst_jax:.2e} (gate {MB_JAX:.0e}); card pass "
        f"{t_card:.1f}s")
    if bad:
        raise RuntimeError(f"many-body card/CPU/JAX mismatch: {bad}")


def _mb_identities(torch):
    """(a) the JAX tests' identity gates, on the card."""
    import numpy as np
    from fftisdf_tpu_torch.basis.eval import make_evaluator
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.pw import get_eri_from_ao
    from fftisdf_tpu_torch.scf import KRHF, KRKS
    from fftisdf_tpu_torch.scf import xc as xc_mod
    import copy
    from fftisdf_tpu_torch.scf.bse import BSEOperator, bse
    from fftisdf_tpu_torch.scf.gw import (drpa_poles, sigma_c_from_poles,
                                          sigma_c_iw, sigma_c_ov_space)
    from fftisdf_tpu_torch.scf.mp2 import kmp2, kump2
    from fftisdf_tpu_torch.scf.rpa import drpa
    from fftisdf_tpu_torch.scf.tddft import TDAOperator, _hvp, tda, utda

    refs = json.loads(REFS.read_text())["many_body"]
    cell = _h2_chain()
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=60.0, m0=(11, 11, 13), verbose=0,
                 select_tol=1e-18, rcond=1e-12).build(
                     mask=np.asarray(refs["h2_k2"]["mask"]))
    mf = _with_orbitals(KRHF(cell, kpts, df, verbose=0), refs["h2_k2"]["krhf"])
    u = _closed_shell_u(mf)
    d_mp2 = _relmax(kump2(df, u)[0], kmp2(df, mf)[0])
    # orbital phases move nothing (chi = A g A^H, ROADMAP §3)
    ph = copy.copy(mf)
    ph.mo_coeff = mf.mo_coeff * np.exp(2j * np.pi * np.random.default_rng(
        0).random((len(kpts), 1, mf.mo_coeff.shape[2])))
    runs = [(lambda m: [drpa(df, m, nw=12)[0]]),
            (lambda m: sigma_c_iw(df, m, nw=12)[0]),
            (lambda m: bse(m, df, q=1, nroots=0, dense=True)[0])]
    d_gauge = max(_relmax(f(ph), f(mf)) for f in runs)
    d_union = d_bare = 0.0
    for q in (0, 1):
        union = np.sort(np.concatenate([
            tda(mf, df, q=q, singlet=s, nroots=0, dense=True)[0]
            for s in (True, False)]))
        d_union = max(d_union, _relmax(utda(u, df, q=q, nroots=0,
                                            dense=True)[0], union))
        a_cis = TDAOperator(mf, df, q=q).dense()
        a_bse = BSEOperator(mf, df, q=q, wqs=df.wq).dense()
        d_bare = max(d_bare, float(np.abs(a_bse - a_cis).max()))
    # gamma: KRKS(xc='hf') TDA is CIS; Sigma against its oracles
    kpts = np.zeros((1, 3))
    df = FFTISDF(cell, kpts, c0=60.0, m0=(11, 11, 13), verbose=0,
                 select_tol=1e-18, rcond=1e-12).build(
                     mask=np.asarray(refs["h2_gamma"]["mask"]))
    hf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-10)
    hf.kernel()
    ks = KRKS(cell, kpts, df, xc="hf", verbose=0, conv_tol=1e-10)
    ks.kernel()
    d_hf = float(np.abs(tda(ks, df, nroots=3, dense=True)[0]
                        - tda(hf, df, nroots=3, dense=True)[0]).max())
    mf = _with_orbitals(KRHF(cell, kpts, df, verbose=0),
                        refs["h2_gamma"]["krhf"])
    coords = cell.gen_uniform_grids()
    ao = make_evaluator(cell, kpts=kpts)(coords)[0]
    mo = ao @ torch.as_tensor(mf.mo_coeff[0], device=ao.device)
    eri = get_eri_from_ao(cell, (mo,) * 4, np.zeros(3), coords).cpu().numpy()
    mo_e = mf.mo_energy[0]
    sigma, iw, ef, _ = sigma_c_iw(df, mf, nw=24)
    sig_ref, _, _ = sigma_c_ov_space(eri, mo_e, 1, nw=24)
    om_s, resid, _ = drpa_poles(eri, mo_e, 1)
    d_ov = float(np.abs(sigma[0] - sig_ref).max())
    d_pole = float(np.abs(sig_ref.T - sigma_c_from_poles(
        om_s, resid, ef, mo_e, 1, 1j * iw)).max())
    # the PBE kernel's HVP against a central difference of exc_and_vxc
    dcell, _ = _diamond()
    fmesh = tuple(int(m) for m in dcell.mesh)
    w = float(dcell.vol) / int(np.prod(fmesh))
    dev = torch.device("cuda")
    gv = torch.as_tensor(dcell.get_Gv(fmesh), device=dev)
    rho = torch.as_tensor(_toy_rho(dcell, 4)[0], device=dev)
    t = torch.randn(rho.shape, generator=torch.Generator(
        device=dev).manual_seed(9), device=dev, dtype=rho.dtype)
    spec = xc_mod.parse_xc("pbe")
    h = _hvp(rho, t[None], gv, spec, fmesh, w)[0]
    vxc = lambda r: xc_mod.exc_and_vxc(r, gv, spec, fmesh, w)[1]
    fd = (vxc(rho + 1e-5 * t) - vxc(rho - 1e-5 * t)) / 2e-5 * w
    d_hvp = float((h - fd).abs().max() / h.abs().max())
    gates = [("kump2 closed shell = kmp2 (H2 1x1x2, relative)", d_mp2,
              1e-10),
             ("drpa, Sigma^c(iw) and BSE under random orbital phases "
              "(relative)", d_gauge, 1e-10),
             ("UTDA closed shell = singlet + triplet TDA (q 0, 1)", d_union,
              1e-10),
             ("BSE with the bare W = CIS, dense matrices (q 0, 1)", d_bare,
              1e-10),
             ("KRKS(xc='hf') TDA = CIS (gamma, converged on the card)",
              d_hf, 1e-7),
             ("Sigma^c(iw) = the ov-space oracle", d_ov, 1e-8),
             ("ov-space oracle = the dRPA pole sum", d_pole, 5e-3),
             ("PBE HVP = central difference of exc_and_vxc (relative)",
              d_hvp, 1e-6)]
    for label, d, gate in gates:
        log(f"[10a] identity on the card: {label}: {d:.2e} (gate "
            f"{gate:.0e})")
    if not all(d <= gate for _, d, gate in gates):
        raise RuntimeError("a many-body identity fails on the card")


def _exciton_dispersion(torch):
    """(a) examples/exciton_dispersion.py at its defaults (diamond gth-szv
    ke 50, 2x2x2, c0 40, KRHF CIS, 3 roots; --eels) on the card, through
    the port's entry point."""
    import numpy as np
    from fftisdf_tpu_torch.examples import exciton_dispersion

    t0 = time.perf_counter()
    res = exciton_dispersion.run(
        _example_args(exciton_dispersion, ["--eels"]),
        out=_example_out("[10a]"))
    df, mf = res["df"], res["mf"]
    ok = mf.converged
    log(f"[10a] exciton dispersion: diamond gth-szv ke 50 2x2x2 c0 40 "
        f"(m0 {df.m0}, nip {df.nip}); KRHF e_tot {mf.e_tot:.10f} conv "
        f"{mf.converged} cycles {mf.cycles}")
    for ws, wt in res["roots"]:
        ok &= bool(np.all(ws > 0) and np.all(wt > 0) and wt[0] <= ws[0])
    ok &= bool(np.all(np.asarray(res["strengths"]) >= 0))
    for eps, loss in res["eels"].values():
        ok &= bool(eps[0].real > 1.0 and np.all(loss > -1e-12))
    log(f"[10a] exciton dispersion {time.perf_counter() - t0:.1f}s; every "
        "root positive, the triplet below the singlet, oscillator "
        f"strengths >= 0, eps_M(0) > 1 and loss >= 0 at {len(res['eels'])}"
        f" finite q: {bool(ok)}")
    if not ok:
        raise RuntimeError("the exciton dispersion is unphysical")
    del res, df, mf
    torch.cuda.empty_cache()


def _integer_reference(mf, tag, **kw):
    """``mf`` if its occupations are integral to 1e-6 (the JAX package's
    TDA rule), else one of its class re-converged from its density without
    smearing (said in the log)."""
    import numpy as np

    occ = np.asarray(mf.mo_occ)
    if np.all((occ < 1e-6) | (np.abs(occ - 1.0) < 1e-6)):
        log(f"{tag} the smeared reference's occupations are integral to "
            "1e-6: used as it is")
        return mf
    frac = float(np.minimum(occ, np.abs(occ - 1.0)).max())
    t0 = time.perf_counter()
    new = type(mf)(mf.cell, mf.kpts, mf.with_df,
                   **dict(kw, smearing=0.0, verbose=0))
    new.kernel(dm0=mf.dm)
    log(f"{tag} the smeared reference has fractional occupations (max "
        f"{frac:.2e} off an integer): re-converged from its density without "
        f"smearing, {new.cycles} cycles, {time.perf_counter() - t0:.2f}s, "
        f"e_tot {new.e_tot:.10f} conv {new.converged}")
    if not new.converged:
        raise RuntimeError("the unsmeared re-convergence failed")
    return new


def _davidson_line(w, info, secs, ms=None):
    return (f"roots " + " ".join(f"{x:.6f}" for x in w)
            + f"; converged {info['converged']}, {info['iterations']} "
            f"iterations, {info['matvecs']} vectors applied, {secs:.2f}s"
            + ("" if ms is None else f"; matvec (one vector, warm) "
               f"{ms:.2f} ms"))


def _matvec_ms(torch, op):
    """Warm wall milliseconds of one matvec of one seeded vector."""
    import numpy as np

    x = np.random.default_rng(0).standard_normal(op.size) + 0j
    op.matvec(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        op.matvec(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 3 * 1e3


def _mb_slice(torch, ctx):
    """(b) the slice: kump2 over the 4x4x4 mesh and UTDA on the KUHF that
    phase 6a converged on phase 4's build."""
    from fftisdf_tpu_torch.scf.mp2 import kump2
    from fftisdf_tpu_torch.scf.tddft import utda

    cell, kpts, df = _slice(ctx)
    if df.x_k.device.type != "cuda":
        _unpark(df)
    mf = _integer_reference(ctx.pop("slice_mf"), "[10b]", **SCF_KW)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e2, info = kump2(df, mf)
    secs = time.perf_counter() - t0
    nk = len(kpts)
    log(f"[10b] slice kump2 over {nk}^3 = {nk ** 3} k-triples (nip "
        f"{df.nip}, nocc {info['nocc']}): e2 {e2:.10f} Ha (same-spin "
        f"{info['e_ss'][0]:.10f} / {info['e_ss'][1]:.10f}, opposite-spin "
        f"{info['e_os']:.10f}, imag {info['imag']:.1e}), {secs:.2f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    w, d = utda(mf, df, q=0, nroots=4, dense=False)
    secs = time.perf_counter() - t0
    ms = _matvec_ms(torch, d["op"])
    log(f"[10b] slice UTDA (CIS) q 0, size {d['op'].size}: "
        + _davidson_line(w, d, secs, ms))
    if not (e2 < 0 and abs(info["imag"]) < 1e-8 * abs(e2)
            and d["converged"] and w[0] > 0):
        raise RuntimeError("the slice's kump2 or UTDA failed")
    df.x_k = df.wq = None
    ctx.pop("slice")
    torch.cuda.empty_cache()


def _timed_peak(torch, fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() / 1e9


def _mb_diamond(torch):
    """(c) diamond at full width: gth-dzvp ke 200 4x4x4, c0 40, m0 15^3."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRHF, KRKS
    from fftisdf_tpu_torch.scf.bse import bse
    from fftisdf_tpu_torch.scf.gw import g0w0
    from fftisdf_tpu_torch.scf.mp2 import kmp2, kump2
    from fftisdf_tpu_torch.scf.rpa import drpa
    from fftisdf_tpu_torch.scf.tddft import oscillator_strengths, tda

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-dzvp",
                             pseudo="gth-pade", ke_cutoff=200.0)
    kpts = cell.get_kpts([4, 4, 4])
    torch.cuda.reset_peak_memory_stats()
    df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=0).build()
    t = df.timings
    log(f"[10c] diamond gth-dzvp ke 200 4x4x4: nao {cell.nao_nr()}, mesh "
        f"{[int(m) for m in cell.mesh]}, nip {df.nip}; build "
        f"{t['build_s']:.2f}s (selection {t['select_s']:.2f}s), peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if df.nip != DIAMOND_NIP:
        raise RuntimeError(f"diamond nip {df.nip}, not {DIAMOND_NIP}")
    kw = dict(verbose=0, conv_tol=1e-9, max_cycle=80)
    hf = KRHF(cell, kpts, df, **kw)
    t0 = time.perf_counter()
    hf.kernel()
    log("[10c] " + _scf_line("KRHF", hf, hf.cycle_seconds))
    ks = KRKS(cell, kpts, df, xc="pbe", **kw)
    ks.kernel()
    log("[10c] " + _scf_line("KRKS-PBE", ks, ks.cycle_seconds))
    if not (hf.converged and ks.converged):
        raise RuntimeError("diamond's references did not converge")
    ok = True
    (e_r, _), s_r, p_r = _timed_peak(torch, lambda: kmp2(df, hf))
    (e_u, i_u), s_u, p_u = _timed_peak(
        torch, lambda: kump2(df, _closed_shell_u(hf)))
    d = _relmax(e_u, e_r)
    log(f"[10c] kmp2 on KRHF {e_r:.10f} Ha ({s_r:.2f}s, peak {p_r:.2f} GB); "
        f"kump2 on the same closed shell {e_u:.10f} ({s_u:.2f}s, peak "
        f"{p_u:.2f} GB): relative {d:.1e} (gate 1e-10)")
    ok &= d <= 1e-10 and e_r < 0
    (e_c, _), s, p = _timed_peak(torch, lambda: drpa(df, hf, nw=24))
    log(f"[10c] drpa on KRHF (nw 24) {e_c:.10f} Ha, {s:.2f}s, peak "
        f"{p:.2f} GB")
    ok &= e_c < 0
    nocc = cell.nelectron // 2
    orbs = list(range(nocc - 2, nocc + 2))
    (e_qp, info), s, p = _timed_peak(
        torch, lambda: g0w0(df, ks, orbs=orbs, nw=40, npade=18))
    e_mf = ks.mo_energy[:, orbs]
    gap_mf = e_mf[:, 2].min() - e_mf[:, 1].max()
    gap_qp = e_qp[:, 2].min() - e_qp[:, 1].max()
    log(f"[10c] g0w0 on KRKS-PBE, HOMO-1..LUMO+1 (nw 40, npade 18): "
        f"{s:.2f}s, peak {p:.2f} GB; PBE gap {gap_mf * 27.211386:.4f} eV, "
        f"QP gap {gap_qp * 27.211386:.4f} eV (gate: above the PBE gap); Z "
        f"{info['z'].min():.3f}-{info['z'].max():.3f}")
    ok &= gap_qp > gap_mf
    rows = {}
    for q in (0, 1):
        for singlet in (True, False):
            (w, d), s, p = _timed_peak(torch, lambda: tda(
                ks, df, q=q, nroots=4, singlet=singlet, dense=False))
            rows[q, singlet] = (w, d)
            log(f"[10c] TDA-PBE q {q} {'singlet' if singlet else 'triplet'}"
                f", size {d['op'].size}: " + _davidson_line(w, d, s)
                + f", peak {p:.2f} GB")
            # the triplet's spin-flip kernel, the exact Hessian of the
            # discrete PBE Exc as in the JAX package, has large negative
            # modes where the density is low and s large (PERF.md §6):
            # its roots are reported, not gated
            ok &= bool(d["converged"] and (w[0] > 0 or not singlet))
    rho0 = rows[0, False][1]["op"].rho0
    log(f"[10c] the reference density on the grid: min {float(rho0.min()):.3e}"
        f", max {float(rho0.max()):.3e} a spin channel; negative triplet "
        f"roots: {int((rows[0, False][0] < 0).sum())} at q 0, "
        f"{int((rows[1, False][0] < 0).sum())} at q 1 of 4")
    w, d = rows[0, True]
    f = oscillator_strengths(ks, w, d["x"])
    log("[10c] oscillator strengths at q 0: " + " ".join(
        f"{v:.5f}" for v in f))
    ok &= bool(np.all(f >= 0))
    # the QP energies of the four bands computed, and for the others the
    # mean QP shift of the band edge on their side (a scissor)
    qp = np.array(ks.mo_energy, copy=True)
    shift = e_qp - e_mf
    qp[:, :nocc] += shift[:, 1].mean()
    qp[:, nocc:] += shift[:, 2].mean()
    qp[:, orbs] = e_qp
    (wb, db), s, p = _timed_peak(torch, lambda: bse(
        ks, df, q=0, nroots=4, qp_energy=qp, dense=False))
    ms = _matvec_ms(torch, db["op"])
    log(f"[10c] BSE on the G0W0 energies, q 0 singlet: "
        + _davidson_line(wb, db, s, ms) + f", peak {p:.2f} GB; TDA-PBE "
        "beside it: " + " ".join(f"{x:.6f}" for x in rows[0, True][0]))
    ok &= bool(db["converged"] and wb[0] > 0)
    if not ok:
        raise RuntimeError("a many-body method failed on diamond at full "
                           "width")
    del df, hf, ks, db, rows
    torch.cuda.empty_cache()


def _mb_production(torch):
    """(d) NiO AFM at production width on the 2x2x2 sub-mesh."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import DeviceKUHF, DeviceKUKS
    from fftisdf_tpu_torch.scf.analysis import atom_charges_and_moments
    from fftisdf_tpu_torch.scf.mp2 import kump2
    from fftisdf_tpu_torch.scf.tddft import utda

    cell, _ = _production_cell()
    kpts = cell.get_kpts([2, 2, 2])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=0).build()
    t = df.timings
    log(f"[10d] production NiO AFM gth-dzvp-molopt-sr ke 200 on the 2x2x2 "
        f"sub-mesh: nip {df.nip}; build {t['build_s']:.2f}s (selection "
        f"{t['select_s']:.2f}s, sweep {t['sweep_s']:.2f}s, solve/FFT/gram "
        f"{t['solve_s']:.2f}s), peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if df.nip != PROD_NIP:
        raise RuntimeError(f"nip {df.nip}, not {PROD_NIP}")
    ok = True
    for label, cls, kw in (
            ("DeviceKUHF", DeviceKUHF, SCF_KW),
            ("DeviceKUKS-PBE+U", DeviceKUKS,
             dict(KS_KW, xc="pbe", hubbard=_nio_hubbard(NIO_U)))):
        t0 = time.perf_counter()
        mf = cls(cell, kpts, df, verbose=0, **kw)
        mf.kernel()
        scf_s = time.perf_counter() - t0
        _, mom = atom_charges_and_moments(cell, mf.dm, mf.s1e)
        log(f"[10d] " + _scf_line(label, mf, mf.cycle_times)
            + f"; {scf_s:.2f}s with setup; Ni moments {mom[0]:+.4f} "
            f"{mom[1]:+.4f}")
        ok &= mf.converged and mom[0] * mom[1] < 0
        mf = _integer_reference(mf, "[10d]", **kw)
        (e2, info), s, p = _timed_peak(torch, lambda: kump2(df, mf))
        log(f"[10d] kump2 on {label}: e2 {e2:.10f} Ha (same-spin "
            f"{info['e_ss'][0]:.10f} / {info['e_ss'][1]:.10f}, "
            f"opposite-spin {info['e_os']:.10f}), {s:.2f}s, peak "
            f"{p:.2f} GB")
        ok &= e2 < 0
        (w, d), s, p = _timed_peak(torch, lambda: utda(
            mf, df, q=0, nroots=4, dense=False))
        ms = _matvec_ms(torch, d["op"])
        kind = "CIS" if label == "DeviceKUHF" else "the PBE kernel"
        log(f"[10d] UTDA ({kind}) q 0 on {label}, size {d['op'].size}: "
            + _davidson_line(w, d, s, ms) + f", peak {p:.2f} GB")
        ok &= bool(d["converged"] and w[0] > 0)
        del mf, d
        torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError("a many-body method failed at production width")
    del df
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 11
CC_REL = 1e-10       # card against CPU
CC_JAX = 1e-8        # against the JAX package's records
CC_README_CYCLES = 8  # README.md: KCCSD on diamond gth-szv 2x2x2


def phase11_correlated(torch, ctx):
    _cc_card_cpu(torch)
    _cc_identities(torch)
    _cc_diamond_222(torch, ctx)
    _cc_diamond_333(torch)


def _cplx_rec(pairs):
    import numpy as np

    a = np.asarray(pairs)
    return a[..., 0] + 1j * a[..., 1]


def _energy_at_density(mf):
    _, vj, vk = mf.get_fock(mf.dm)
    mf.e_tot = mf.energy_elec(mf.dm, vj, vk) + mf.e_nuc
    return mf


def _cc_states(dev):
    """{key: (df, KRHF)} of the correlated fixtures on ``dev``: the H2
    chain (gamma, 1x1x2) and diamond szv 1x1x2 on the JAX package's points
    and real-gauge orbitals."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KRHF

    refs = json.loads(REFS.read_text())
    mb, corr = refs["many_body"], refs["correlated"]
    out = {}
    for key in ("h2_gamma", "h2_k2"):
        cell = _h2_chain()
        kpts = (np.zeros((1, 3)) if key == "h2_gamma"
                else cell.get_kpts([1, 1, 2]))
        df = FFTISDF(cell, kpts, c0=60.0, m0=(11, 11, 13), verbose=0,
                     select_tol=1e-18, rcond=1e-12, device=dev).build(
                         mask=np.asarray(mb[key]["mask"]))
        out[key] = (df, _energy_at_density(_with_orbitals(
            KRHF(cell, kpts, df, verbose=0, device=dev), mb[key]["krhf"])))
    cell, kpts = _diamond()
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                 device=dev).build(mask=np.asarray(corr["diamond"]["mask"]))
    out["diamond"] = (df, _energy_at_density(_with_orbitals(
        KRHF(cell, kpts, df, verbose=0, device=dev),
        corr["diamond"]["krhf"])))
    return out


def _cc_runs(dev, refs):
    """{name: (value, JAX record or None)} of every correlated method on
    ``dev`` (the CPU skips the diamond one-carbon DMET: FCI over 4900
    determinants, the card's alone against the record)."""
    import numpy as np
    from fftisdf_tpu_torch.scf import KRKS, KUHF
    from fftisdf_tpu_torch.scf import cc
    from fftisdf_tpu_torch.scf.dmet import dmet_energy
    from fftisdf_tpu_torch.scf.fci import fci_ground

    mb = json.loads(REFS.read_text())["many_body"]
    st = _cc_states(dev)
    out = {}
    rec = refs["h2_gamma"]
    df, mf = st["h2_gamma"]
    out["h2_gamma kccsd"] = (cc.kccsd(df, mf, conv_tol=1e-10,
                                      max_cycle=80)[0], rec["kccsd"]["e"])
    out["h2_gamma eomee"] = (cc.eomee(df, mf, conv_tol=1e-10)[0],
                             _cplx_rec(rec["eomee"]))
    out["h2_gamma eomee_davidson"] = (
        cc.eomee_davidson(df, mf, nroots=4, conv_tol=1e-10, tol=1e-8)[0],
        _cplx_rec(rec["eomee_davidson"]))
    for name, fn in (("eomip", cc.eomip), ("eomea", cc.eomea)):
        out[f"h2_gamma {name}"] = (fn(df, mf, conv_tol=1e-10)[0][0],
                                   _cplx_rec(rec[name][0]))
    ks = _with_orbitals(KRKS(mf.cell, mf.kpts, df, xc="pbe", verbose=0,
                             device=dev), mb["h2_gamma"]["krks_pbe"])
    out["h2_gamma kccsd@pbe"] = (cc.kccsd(df, ks, conv_tol=1e-10,
                                          max_cycle=120)[0],
                                 rec["kccsd_pbe_ref"]["e"])
    rec = refs["h2_k2"]
    df, mf = st["h2_k2"]
    e_cc, e_t, _ = cc.kccsd_t(df, mf, conv_tol=1e-9, max_cycle=80)
    out["h2_k2 kccsd"] = (e_cc, rec["kccsd_t"]["e_ccsd"])
    out["h2_k2 (T)"] = (e_t, rec["kccsd_t"]["e_t"])
    out["h2_k2 eomee"] = (cc.eomee(df, mf, conv_tol=1e-10)[0],
                          _cplx_rec(rec["eomee"]))
    for name, fn in (("eomip", cc.eomip), ("eomea", cc.eomea)):
        w = fn(df, mf, conv_tol=1e-10)[0]
        out[f"h2_k2 {name}"] = (np.concatenate([w[0], w[1]]), np.concatenate(
            [_cplx_rec(r) for r in rec[name]]))
    gam, _ = cc.onerdm(df, mf, conv_tol=1e-9)
    # the density's blocks as one quantity, on the scale of its occupied
    # block (~1): the ov blocks alone are O(t1)
    out["h2_k2 onerdm"] = (np.concatenate([np.ravel(b) for b in gam]),
                           np.concatenate([np.ravel(_unpack(
                               rec["onerdm"][n])) for n in ("goo", "gov",
                                                            "gvo", "gvv")]))
    out["h2_k2 ao_density"] = (cc.ao_density(df, mf, conv_tol=1e-9)[0],
                               _unpack(rec["ao_density"]))
    um = _with_orbitals(KUHF(_h2_chain(spin=2), mf.kpts, df, verbose=0,
                             device=dev), mb["h2_k2"]["kuhf_spin2"])
    out["h2_k2 kccsd spin 2"] = (cc.kccsd(df, um, conv_tol=1e-8,
                                          max_cycle=80)[0],
                                 rec["kccsd_spin2"])
    rec = refs["diamond"]
    df, mf = st["diamond"]
    # diamond 1x1x2's amplitude rms stalls near 1e-7 in both packages:
    # the record is converged at 1e-6 (tools/jax_port_refs.py CC_TOL)
    e_cc, e_t, _ = cc.kccsd_t(df, mf, conv_tol=1e-6, max_cycle=80)
    out["diamond kccsd"] = (e_cc, rec["kccsd_t"]["e_ccsd"])
    out["diamond (T)"] = (e_t, rec["kccsd_t"]["e_t"])
    for key, frag, kinds in DMET_CASES:
        if dev == "cpu" and len(frag) == 4 and key == "diamond":
            continue
        df, mf = st[key]
        for kind in kinds:
            solver = cc.ccsd_solver if kind.startswith("ccsd") else None
            e, _ = dmet_energy(mf, df, frag_ao=list(frag), solver=solver,
                               fit_mu=kind.endswith("_mu"))
            out[f"{key} dmet {list(frag)} {kind}"] = (
                e, refs["dmet"][f"{key} {list(frag)} {kind}"]["e"])
    h, eri = _solver_integrals()
    for ne in (2, 4):
        e, g, gg = cc.ccsd_solver(h, eri, ne, device=dev)
        r = refs["ccsd_solver"][str(ne)]
        out[f"ccsd_solver {ne}e energy"] = (e, r["e"])
        out[f"ccsd_solver {ne}e gamma"] = (g, _unpack(r["gamma"]))
        out[f"ccsd_solver {ne}e Gamma"] = (gg, _unpack(r["Gamma"]))
        e_f, g_f, gg_f = fci_ground(h, eri, ne, device=dev)
        out[f"fci {ne}e"] = (np.concatenate([[e_f], g_f.ravel(),
                                             gg_f.ravel()]), None)
    return out


# DMET cases of tools/jax_port_refs.py: (fixture, fragment AOs, solvers)
DMET_CASES = (("h2_gamma", (0, 1, 2, 3), ("fci",)),
              ("h2_k2", (0, 1), ("fci", "fci_mu", "ccsd", "ccsd_mu")),
              ("h2_k2", (2, 3), ("fci",)),
              ("diamond", (0,), ("fci", "fci_mu", "ccsd", "ccsd_mu")),
              ("diamond", (0, 1, 2, 3), ("fci", "fci_mu", "ccsd",
                                         "ccsd_mu")))


def _solver_integrals(n=4, seed=43):
    """tools/jax_port_refs.py::solver_integrals."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = h + h.conj().T
    np.fill_diagonal(h, np.sort(rng.standard_normal(n)) * 2 - 1)
    a = 0.15 * (rng.standard_normal((n,) * 4)
                + 1j * rng.standard_normal((n,) * 4))
    a = a + a.transpose(2, 3, 0, 1)
    return h, a + a.transpose(1, 0, 3, 2).conj()


def _cc_card_cpu(torch):
    """(a) every correlated method on the card and on the CPU: card = CPU
    to 1e-10 relative, both = the JAX package's records to 1e-8."""
    refs = json.loads(REFS.read_text())["correlated"]
    t0 = time.perf_counter()
    card = _cc_runs("cuda", refs)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = _cc_runs("cpu", refs)
    t_cpu = time.perf_counter() - t0
    worst_dev = worst_jax = 0.0
    bad = []
    for name, (g, ref) in card.items():
        line = f"[11a] {name}:"
        ok = True
        if name in cpu:
            d = _relmax(g, cpu[name][0])
            worst_dev = max(worst_dev, d)
            line += f" card-CPU {d:.1e}"
            ok &= d <= CC_REL
        if ref is not None:
            d = _relmax(g, ref)
            worst_jax = max(worst_jax, d)
            line += f", JAX {d:.1e}"
            ok &= d <= CC_JAX
        log(line + ("" if ok else "  FAIL"))
        if not ok:
            bad.append(name)
    log(f"[11a] {len(card)} quantities: card against CPU at most "
        f"{worst_dev:.2e} relative (gate {CC_REL:.0e}), against the JAX "
        f"package at most {worst_jax:.2e} (gate {CC_JAX:.0e}); card pass "
        f"{t_card:.1f}s, CPU pass {t_cpu:.1f}s")
    if bad:
        raise RuntimeError(f"correlated card/CPU/JAX mismatch: {bad}")


def _cc_identities(torch):
    """(a) the JAX tests' identities on the card: CCSD = FCI for two
    electrons (the full-fragment DMET), the first iterate = kmp2 / kump2,
    closed-shell KUHF = KRHF, the KS-reference invariance, the
    determinant-space oracle at random complex amplitudes (step, (T), EOM
    and both densities), the structured basis against the dense one, and
    torch's complex autodiff conventions."""
    import numpy as np
    from fftisdf_tpu_torch.scf import KRKS
    from fftisdf_tpu_torch.scf import cc
    from fftisdf_tpu_torch.scf.dmet import dmet_energy
    from fftisdf_tpu_torch.scf.mp2 import kmp2, kump2
    sys.path.insert(0, str(REPO / "tests"))
    import cc_oracle as orc

    mb = json.loads(REFS.read_text())["many_body"]
    st = _cc_states("cuda")
    gates = []
    df, mf = st["h2_gamma"]
    e_cc, info = cc.kccsd(df, mf, conv_tol=1e-10, max_cycle=80)
    e_dmet, _ = dmet_energy(mf, df, frag_ao=[0, 1, 2, 3])
    gates.append(("CCSD = FCI, 2 electrons (H2 gamma: full-fragment DMET "
                  "= E_HF + E_CCSD, Ha)", abs(e_dmet - mf.e_tot - e_cc),
                  1e-7))
    e_u, _ = cc.kccsd(df, _closed_shell_u(mf), conv_tol=1e-10, max_cycle=80)
    gates.append(("closed-shell KUHF = KRHF (H2 gamma, Ha)", abs(e_u - e_cc),
                  1e-9))
    ks = _with_orbitals(KRKS(mf.cell, mf.kpts, df, xc="pbe", verbose=0),
                        mb["h2_gamma"]["krks_pbe"])
    e_ks, _ = cc.kccsd(df, ks, conv_tol=1e-10, max_cycle=120)
    _, vj, vk = mf.get_fock(ks.dm)
    e_det = mf.energy_elec(ks.dm, vj, vk) + mf.e_nuc
    gates.append(("KS-reference invariance, E_det(PBE) + E_corr = E_HF + "
                  "E_corr (Ha)", abs(e_det + e_ks - mf.e_tot - e_cc), 3e-6))
    for key in ("h2_k2", "diamond"):
        df, mf = st[key]
        _, info = cc.kccsd(df, mf, conv_tol=1e-6, max_cycle=1)
        gates.append((f"first iterate = kmp2 ({key}, relative)", _relmax(
            info["energies"][0], kmp2(df, mf)[0]), 1e-10))
    df, mf = st["h2_k2"]
    um = _with_orbitals(_h2_kuhf_spin2(mf, df), mb["h2_k2"]["kuhf_spin2"])
    _, info = cc.kccsd(df, um, conv_tol=1e-8, max_cycle=80)
    gates.append(("first iterate = kump2 (H2 1x1x2 spin 2, relative)",
                  _relmax(info["energies"][0], kump2(df, um)[0]), 1e-10))
    gates += _cc_oracle_gates(torch, cc, orc)
    for label, d, gate in gates:
        log(f"[11a] identity on the card: {label}: {d:.2e} (gate "
            f"{gate:.0e})")
    if not all(d <= gate for _, d, gate in gates):
        raise RuntimeError("a correlated identity fails on the card")


def _h2_kuhf_spin2(mf, df):
    from fftisdf_tpu_torch.scf import KUHF

    return KUHF(_h2_chain(spin=2), mf.kpts, df, verbose=0)


def _cc_oracle_gates(torch, cc, orc):
    """The determinant-space oracle on the card at random complex
    amplitudes and integrals (tests/test_cc.py's seeds), the structured
    basis, and the autodiff conventions."""
    import numpy as np

    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, device=dev)
    kp3 = np.zeros((1, 1, 1), dtype=np.int64)
    out = []

    def system(seed, no, nv, scale):
        rng = np.random.default_rng(seed)
        u = scale * orc._random_u(no + nv, rng)
        e = np.concatenate([-1.0 - rng.random(no), 1.0 + rng.random(nv)])
        return rng, u, e

    rng, u, e = system(7, 2, 3, 0.2)
    t1, t2 = orc._random_amps(2, 3, rng)
    r1_o, r2_o, e_o = orc.Oracle(u, e, 2).residuals(t1, t2)
    t1n, t2n, e_t = cc.make_step(1, 2, 3, kp3, e[None, :2], e[None, 2:])(
        t(t1)[None], t(t2)[None, None, None], t(u)[None, None, None])
    d1 = e[:2, None] - e[None, 2:]
    d2 = (e[:2, None, None, None] + e[None, :2, None, None]
          - e[None, None, 2:, None] - e[None, None, None, 2:])
    out.append(("CCSD step = the oracle's residuals", max(
        abs(complex(e_t) - e_o),
        np.abs(d1 * (t1n[0].cpu().numpy() - t1) - r1_o).max(),
        np.abs(d2 * (t2n[0, 0, 0].cpu().numpy() - t2) - r2_o).max()), 1e-10))
    rng, u, e = system(11, 3, 3, 0.2)
    t1, t2 = orc._random_amps(3, 3, rng)
    fn = cc.make_t3_energy(1, 3, 3, kp3, e[None, :3], e[None, 3:])
    e_t = complex(fn(t(t1)[None], t(t2)[None, None, None],
                     t(u)[None, None, None]))
    out.append(("(T) = the oracle's", abs(e_t - orc.t3_energy(
        orc.Oracle(u, e, 3), e, t1, t2)), 1e-10))
    for no, nv, seed in ((2, 3, 13), (3, 2, 37)):
        _, u, e = system(seed, no, nv, 0.1)
        eo, ev = e[None, :no], e[None, no:]
        U = t(u)[None, None, None]
        step = cc.make_step(1, no, nv, kp3, eo, ev)
        a1 = torch.zeros((1, no, nv), dtype=U.dtype, device=dev)
        a2 = cc._mp2_guess(U, no, eo, ev, kp3)
        for _ in range(400):
            n1, n2, _ = step(a1, a2, U)
            dt = max(float((n1 - a1).abs().max()),
                     float((n2 - a2).abs().max()))
            a1, a2 = n1, n2
            if dt < 1e-13:
                break
        oracle = orc.Oracle(u, e, no)
        expT, expmT, hb = orc.hbar(oracle, a1[0].cpu().numpy(),
                                   a2[0, 0, 0].cpu().numpy())
        want = orc.eom_spectra(oracle, hb)
        w = cc.eom_dense(1, no, nv, kp3, eo, ev, a1, a2, U)
        d_eom = float(np.abs(w - want["ee"]).max())
        for sector in ("ip", "ea"):
            w = cc.eom_qp(1, no, nv, kp3, eo, ev, a1.cpu().numpy(),
                          a2.cpu().numpy(), u[None, None, None], sector)[0]
            d_eom = max(d_eom, float(np.abs(w - want[sector]).max()))
        out.append((f"EOM-EE/IP/EA = the oracle's Hbar spectra ({no} "
                    f"electrons)", d_eom, 1e-9))
        gam1, lam = cc.lambda_rdm(1, no, nv, kp3, eo, ev, a1, a2, U)
        gam2 = cc.lambda_rdm2(1, no, nv, kp3, eo, ev, a1, a2, U, lam=lam,
                              gam1=gam1)[0, 0, 0]
        left = orc.left_state(oracle, hb, cc._amp_basis(1, no, nv, kp3)[1])
        g1_o, g2_o = orc.densities(oracle, expT, expmT, left)
        g1 = np.block([[gam1[0][0], gam1[1][0]], [gam1[2][0], gam1[3][0]]])
        out.append((f"1- and 2-RDM = the oracle's ({no} electrons)", max(
            float(np.abs(g1 - g1_o).max()),
            float(np.abs(gam2 - g2_o).max())), 1e-9))
    kp = np.array([[[0, 1], [1, 0]], [[1, 0], [0, 1]]])
    _, dense = cc._amp_basis(2, 2, 3, kp)
    b = cc.AmpBasis(2, 2, 3, kp, dev)
    out.append(("structured amplitude basis = the dense one",
                float(np.abs(b.dense().cpu().numpy() - dense).max()), 0.0))
    out += _autodiff_conventions(torch)
    return out


def _autodiff_conventions(torch):
    """torch's complex autodiff on the card, as the CC layer uses it:
    jvp of a holomorphic map = J x (against a central difference), a
    vmap of jvps = the stacked jvps, and reverse mode with grad_outputs 1
    = conj(df/dz)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, dtype=torch.complex128, device=dev,
                           generator=g)

    a, z, x = rnd(6, 6), rnd(6), rnd(6)
    f = lambda v: (a @ v) * v + v.exp()                  # holomorphic
    jx = torch.func.jvp(f, (z,), (x,))[1]
    h = 1e-6
    fd = (f(z + h * x) - f(z - h * x)) / (2 * h)
    eye = torch.eye(6, dtype=z.dtype, device=dev)
    jac = torch.func.vmap(lambda c: torch.func.jvp(f, (z,), (c,))[1],
                          in_dims=1, out_dims=1)(eye)
    zr = z.clone().requires_grad_(True)
    s = (f(zr) * x).sum()
    gr = torch.autograd.grad(s, zr, grad_outputs=torch.ones_like(s))[0]
    return [("jvp of a holomorphic map = central difference (relative)",
             float((jx - fd).abs().max() / fd.abs().max()), 1e-8),
            ("vmap of jvps = the Jacobian's columns",
             float((jac @ x - jx).abs().max()), 1e-12),
            ("reverse mode, grad_outputs 1 = conj(J^T x)",
             float((gr - (jac.T @ x).conj()).abs().max()), 1e-12)]


def _cc_diamond_222(torch, ctx):
    """(b) diamond gth-szv ke 50 2x2x2, c0 40 (examples/exciton_
    dispersion.py's system; README.md's KCCSD record): KRHF, CCSD(T),
    EOM-EE Davidson (4 roots), DMET on one carbon (its 4 AOs: an
    8-orbital embedding, FCI over 4900 determinants) with the mu fit, by
    the FCI and by the CCSD solver."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf import cc
    from fftisdf_tpu_torch.scf.dmet import dmet_energy
    from fftisdf_tpu_torch.scf.mp2 import kmp2

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([2, 2, 2])
    (df, s_b, p_b) = _timed_peak(torch, lambda: FFTISDF(
        cell, kpts, c0=40.0, verbose=0).build())
    mf = KRHF(cell, kpts, df, verbose=0)
    mf.kernel()
    log(f"[11b] diamond gth-szv ke 50 2x2x2 c0 40: nao {cell.nao_nr()}, m0 "
        f"{df.m0}, nip {df.nip}; build {s_b:.2f}s, peak {p_b:.2f} GB; "
        + _scf_line("KRHF", mf, mf.cycle_seconds))
    ok = mf.converged
    (r, s, p) = _timed_peak(torch, lambda: cc.kccsd_t(df, mf))
    e_cc, e_t, info = r
    e2 = kmp2(df, mf)[0]
    d = _relmax(info["energies"][0], e2)
    per = info["cycle_s"][1:] or info["cycle_s"]
    log(f"[11b] kccsd_t: e_ccsd {e_cc:.10f}, e_(T) {e_t:.10f} Ha/cell "
        f"(imag {info['imag']:.1e} / {info['imag_t']:.1e}); converged "
        f"{info['converged']} in {info['niter']} cycles (README.md: "
        f"{CC_README_CYCLES}); first iterate - kmp2 {d:.1e} relative "
        f"(gate 1e-10); integrals {info['eris_s']:.2f}s, "
        f"{sum(per) / len(per):.3f} s/cycle past the first; {s:.2f}s in "
        f"all, peak {p:.2f} GB")
    ok &= bool(info["converged"] and d <= 1e-10 and e_cc < 0 and e_t < 0)
    ctx["diamond222"] = dict(mask=df.mask, m0=df.m0, e_cc=e_cc,
                             niter=info["niter"])     # phase 14d's record
    _cycle_parts(torch, cc, info, "[11b]", t3=True)
    (r, s, p) = _timed_peak(torch, lambda: cc.eomee_davidson(df, mf,
                                                             nroots=4))
    w, info = r
    log(f"[11b] eomee_davidson, 4 roots: " + " ".join(
        f"{x.real:.6f}{x.imag:+.1e}j" for x in w)
        + f" Ha; converged {info['eom_converged']}; {s:.2f}s with its "
        f"kccsd, peak {p:.2f} GB")
    ok &= bool(info["eom_converged"] and np.all(w.real > 0))
    from fftisdf_tpu_torch.isdf.ao2mo import trans_2e
    from fftisdf_tpu_torch.scf.dmet import build_embedding

    c_lo = build_embedding(mf, [0, 1, 2, 3])[0]
    trans_2e(df, c_lo)
    (_, s, _) = _timed_peak(torch, lambda: trans_2e(df, c_lo))
    log(f"[11b] the embedding ERIs (trans_2e, {len(kpts)}^3 = "
        f"{len(kpts) ** 3} assemble_eri calls, 8 embedding orbitals): "
        f"{s * 1e3:.2f} ms warm")
    for label, solver in (("FCI", None), ("CCSD", cc.ccsd_solver)):
        (r, s, p) = _timed_peak(torch, lambda: dmet_energy(
            mf, df, frag_ao=[0, 1, 2, 3], solver=solver, fit_mu=True))
        e, info = r
        log(f"[11b] dmet, one carbon (AOs 0-3), {label} solver, mu fit: "
            f"e {e:.10f} Ha (de_corr {info['de_corr']:.10f}, nbath "
            f"{info['nbath']}, nemb {info['nemb']}, mu {info['mu']:+.6f}, "
            f"|dN_frag| {info.get('nfrag_err', 0.0):.1e}); {s:.2f}s, peak "
            f"{p:.2f} GB")
        ok &= bool(info["nemb"] == 8 and info["de_corr"] < 0
                   and info.get("nfrag_err", 0.0) < 1e-6)
    if not ok:
        raise RuntimeError("a correlated method failed on diamond 2x2x2")
    del df, mf
    torch.cuda.empty_cache()


def _cycle_parts(torch, cc, info, tag, t3=False):
    """A CCSD cycle's parts alone, warm, on kccsd's converged amplitudes:
    the step (the residual and its update) and the DIIS update on the
    card; with ``t3``, the (T) energy."""
    U, t1, t2 = info["U"], info["t1"], info["t2"]
    nk, nocc, nvir = t1.shape
    step = cc.make_step(nk, nocc, nvir, info["kp3"], info["eo"], info["ev"])

    def diis():
        d = cc.AmplitudeDIIS(8, cc._pack(t1, t2, nk))
        vec = cc._pack(t1, t2, nk)
        for _ in range(8):
            d.update(vec, vec)
        return d

    parts = [("step", lambda: step(t1, t2, U)),
             ("8 DIIS updates", diis)]
    if t3:
        fn = cc.make_t3_energy(nk, nocc, nvir, info["kp3"], info["eo"],
                               info["ev"])
        parts.append(("(T)", lambda: fn(t1, t2, U)))
    out = []
    for name, f in parts:
        f()
        _, s, p = _timed_peak(torch, f)
        out.append(f"{name} {s * 1e3:.1f} ms (peak {p:.2f} GB)")
    log(f"{tag} the cycle's parts alone (warm): " + "; ".join(out))


def _cc_diamond_333(torch):
    """(c) the same cell at 3x3x3 (nk 27; U 20.6 GB in complex128): kccsd
    with the gathered operands in memory blocks."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf import cc
    from fftisdf_tpu_torch.scf.mp2 import kmp2

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([3, 3, 3])
    (df, s_b, p_b) = _timed_peak(torch, lambda: FFTISDF(
        cell, kpts, c0=40.0, verbose=0).build())
    mf = KRHF(cell, kpts, df, verbose=0)
    mf.kernel()
    log(f"[11c] diamond gth-szv ke 50 3x3x3 c0 40: nip {df.nip}; build "
        f"{s_b:.2f}s, peak {p_b:.2f} GB; "
        + _scf_line("KRHF", mf, mf.cycle_seconds))
    (r, s, p) = _timed_peak(torch, lambda: cc.kccsd(df, mf,
                                                    return_amps=True))
    e_cc, info = r
    d = _relmax(info["energies"][0], kmp2(df, mf)[0])
    per = info["cycle_s"][1:] or info["cycle_s"]
    log(f"[11c] kccsd: e_ccsd {e_cc:.10f} Ha/cell (imag {info['imag']:.1e})"
        f"; converged {info['converged']} in {info['niter']} cycles; first "
        f"iterate - kmp2 {d:.1e} relative (gate 1e-10); U assembly "
        f"{info['eris_s']:.2f}s, {sum(per) / len(per):.3f} s/cycle past the "
        f"first (first {info['cycle_s'][0]:.2f}s); {s:.2f}s in all, peak "
        f"{p:.2f} GB (gate 80)")
    if not (mf.converged and info["converged"] and d <= 1e-10
            and e_cc < 0 and p < 80.0):
        raise RuntimeError("kccsd failed on diamond 3x3x3")
    _cycle_parts(torch, cc, info, "[11c]")
    del df, mf, info, r
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 12
DERIV_FD_TOL = 1e-5               # Ha/bohr: NiO force against its FD
NIO_DISP = 0.05                   # bohr, the first O along x
DIAMOND_OPT_CM1 = 1332.0          # experiment, for the record only


def phase12_derivatives(torch, ctx):
    _deriv_fixtures(torch)
    _deriv_nio(torch, ctx)
    _deriv_diamond_stress(torch)
    _deriv_diamond_sweeps(torch)


def _deriv_mod():
    sys.path.insert(0, str(REPO / "tests"))
    import torch_deriv_fixtures as fx

    return fx, json.loads(REFS.read_text())["derivatives"]


def _deriv_scf(rec, cell, kpts, kw):
    """The JAX package's converged SCF of a recorded case, as the
    attributes the derivative layer reads."""
    import types
    import numpy as np

    def arr(r):
        return (np.asarray(r["re"]) + 1j * np.asarray(r["im"])).reshape(
            r["shape"])

    return types.SimpleNamespace(
        cell=cell, kpts=kpts, dm=arr(rec["dm"]), mo_coeff=arr(rec["mo_coeff"]),
        mo_energy=np.asarray(rec["mo_energy"]),
        mo_occ=np.asarray(rec["mo_occ"]), e_tot=rec["e_tot"], trunc=None,
        converged=True, xc=kw.get("xc"), hubbard=kw.get("hubbard"),
        exxdiv=kw.get("exxdiv"))


def _deriv_fixtures(torch):
    """(a) the JAX tests' fixtures: card against CPU and the JAX records."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.isdf.autodiff import eri_grad_fn
    from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
    from fftisdf_tpu_torch.lattice.cell import Cell, Shell
    from fftisdf_tpu_torch.scf import KRHF, KRKS, KUHF
    from fftisdf_tpu_torch.scf import grad, md, stress

    t_a = time.perf_counter()
    fx, refs = _deriv_mod()
    cell = fx.he2_strain(Cell, Shell)
    kpts = cell.get_kpts([1, 1, 2])
    worst = {"card-cpu": 0.0, "card-jax": 0.0}
    for name, _, kw, backend in fx.CASES:
        rec = refs["cases"][name]
        mf = _deriv_scf(rec, cell, kpts, kw)
        out = {}
        for dev in ("cuda", "cpu"):
            df = None
            if backend == "isdf":
                df = FFTISDF(cell, kpts, verbose=0, device=dev,
                             **fx.ISDF_BUILD)
                df.mask = np.asarray(refs["isdf_mask"])
            fkw = dict(two_electron=backend, df=df, xc=kw.get("xc"),
                       hubbard=kw.get("hubbard"), exxdiv=kw.get("exxdiv"),
                       device=dev)
            g, val = grad.make_grad_fn(cell, kpts, **fkw)(mf)
            geps = None
            if name not in fx.NO_STRESS:
                sval, geps, _ = stress.make_cell_grad_fn(cell, kpts,
                                                         **fkw)(mf)
            out[dev] = (g, val, geps)
        g, val, geps = out["cuda"]
        gc, valc, gepsc = out["cpu"]
        d_cc = max(_relmax(g, gc), abs(val - valc) / abs(valc))
        d_cj = max(_relmax(g, np.asarray(rec["grad"])),
                   abs(val - rec["value"]) / abs(rec["value"]))
        if geps is not None:
            d_cc = max(d_cc, _relmax(geps, gepsc))
            sig = 0.5 * (geps + geps.T) / float(cell.vol)
            d_cj = max(d_cj, _relmax(sig, np.asarray(rec["sigma"])))
        worst["card-cpu"] = max(worst["card-cpu"], d_cc)
        worst["card-jax"] = max(worst["card-jax"], d_cj)
        if d_cc > 1e-10 or d_cj > 1e-8:
            raise RuntimeError(f"{name}: card-cpu {d_cc:.1e}, card-jax "
                               f"{d_cj:.1e}")
    log(f"[12a] He2 1x1x2, {len(fx.CASES)} Lagrangians (pw and ISDF; RHF, "
        "UHF, LDA, PBE, LDA+U, PBE+U, SCAN, HSE06, exxdiv ewald) on the JAX "
        f"density and mask: forces and stress card-cpu {worst['card-cpu']:.1e}"
        f" (gate 1e-10), card-JAX {worst['card-jax']:.1e} (gate 1e-8)")

    _eri_grad_blocks(fx, refs, Cell, Shell, eri_grad_fn, kpt_mod)

    # the port's own SCF, then its forces, against the JAX records
    mf = KUHF(cell, kpts, verbose=0, conv_tol=1e-11)
    mf.kernel()
    g, _ = grad.kernel(mf)
    d1 = _relmax(g, np.asarray(refs["cases"]["pw_uhf"]["grad"]))
    df = FFTISDF(cell, kpts, verbose=0, **fx.ISDF_BUILD).build(
        mask=np.asarray(refs["isdf_mask"]))
    mf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-11)
    mf.kernel()
    g, _ = grad.kernel(mf, two_electron="isdf", df=df)
    d2 = _relmax(g, np.asarray(refs["cases"]["isdf_rhf"]["grad"]))
    log(f"[12a] the port's own SCF on the card, then its forces: KUHF pw "
        f"{d1:.1e}, KRHF ISDF {d2:.1e} of max|g| from the JAX package's "
        "(gate 1e-7)")
    if max(d1, d2) > 1e-7:
        raise RuntimeError("the port's SCF forces miss the JAX package's")

    # diamond gth-szv ke 50 1x1x2, one atom displaced: KRKS-PBE+U
    cell, kpts = _diamond()
    pos = cell.atom_coords().copy()
    pos[1, 2] += 0.1
    cell = cell.copy(atom=[(s, p) for s, p in
                           zip(cell.atom_symbols(), pos)]).build()
    hub = {0: (1, 0.2)}
    df = FFTISDF(cell, kpts, c0=20.0, m0=(9, 9, 9), verbose=0).build()
    mf = KRKS(cell, kpts, df, xc="pbe", hubbard=hub, verbose=0,
              conv_tol=1e-10)
    mf.kernel()
    out = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            df = FFTISDF(cell, kpts, c0=20.0, m0=(9, 9, 9), verbose=0,
                         device=dev).build(mask=df.mask)
        for backend in ("pw", "isdf"):
            fkw = dict(two_electron=backend, xc="pbe", hubbard=hub,
                       device=dev, df=df if backend == "isdf" else None)
            g, val = grad.make_grad_fn(cell, kpts, **fkw)(mf)
            sval, geps, _ = stress.make_cell_grad_fn(cell, kpts, **fkw)(mf)
            out[dev, backend] = (g, geps, val, sval)
    d = max(max(_relmax(out["cuda", b][i], out["cpu", b][i])
                for i in (0, 1)) for b in ("pw", "isdf"))
    dv = abs(out["cuda", "isdf"][2] - mf.e_tot)
    log(f"[12a] diamond gth-szv ke 50 1x1x2 (atom 1 +0.1 bohr z) KRKS-PBE+U:"
        f" forces and stress card-cpu {d:.1e} (gate 1e-10) for pw and ISDF;"
        f" ISDF Lagrangian - e_tot {dv:.1e}; max|F| "
        f"{np.abs(out['cuda', 'isdf'][0]).max():.6f} Ha/bohr")
    if d > 1e-10 or dv > 1e-8:
        raise RuntimeError("diamond forces or stress disagree")

    # NPT (Berendsen, on the analytic stress) on the LiH of tests/test_md.py
    ref = refs["drivers"]["npt_lih"]
    c = fx.lih(Cell, Shell, 6.5)
    run = md.npt_kernel(KRHF(c, c.get_kpts([1, 1, 1]), verbose=0,
                             conv_tol=1e-10, diis_space=1),
                        dt_fs=1.0, nsteps=2, pressure_gpa=0.0, taup_fs=5.0,
                        compressibility_au=1.0)
    dv = _relmax(run.volumes, np.asarray(ref["volumes"]))
    dp = float(np.abs(np.asarray([r["pressure_au"] for r in run.trajectory])
                      - np.asarray(ref["pressures"])).max())
    log(f"[12a] npt_kernel on LiH (2 steps): volumes "
        + " ".join(f"{v:.6f}" for v in run.volumes)
        + f" bohr^3, {dv:.1e} relative from the JAX record (gate 1e-9); "
        f"pressures {dp:.1e} Ha/bohr^3 off (gate 1e-8)")
    if not (dv <= 1e-9 and dp <= 1e-8 and np.all(np.diff(run.volumes) > 0)):
        raise RuntimeError("npt_kernel misses the JAX record")

    _qha_h2_chain(refs)

    # examples/relax_vibrations.py at its defaults with --isdf, through
    # the port's entry point, against the JAX script's recorded run (each
    # geometry selects its own points, so at the relaxation's gates)
    from fftisdf_tpu_torch.examples import _common, relax_vibrations

    t0 = time.perf_counter()
    lines = _common.Lines()
    rv = relax_vibrations.run(_example_args(relax_vibrations, ["--isdf"]),
                              out=lines)
    res, wav = rv["result"], rv["freqs"]
    rec = json.loads(EXAMPLE_RECORD.read_text())["examples"][
        "relax_vibrations_isdf"]
    rows = _common.compare(
        _common.numbers(relax_vibrations, lines.text()),
        _common.numbers(relax_vibrations, rec["stdout"]),
        _common.gates(relax_vibrations, rec["args"]))
    log(f"[12a] examples/relax_vibrations.py --isdf: converged "
        f"{res.converged} in {res.nsteps} steps, max|F| "
        f"{res.trajectory[-1][2]:.2e} ({time.perf_counter() - t0:.1f}s "
        "with the frequencies); against the JAX record: " + ", ".join(
            f"{k} {e:.1e} (gate {lim:.1e})" for k, e, lim, _ in rows))
    if not (res.converged and res.trajectory[-1][2] < 5e-4
            and np.abs(wav[:3]).max() < 0.05 * np.abs(wav).max()
            and rows and all(ok for *_, ok in rows)):
        raise RuntimeError("relax_vibrations failed on the card")
    log(f"[12a] {time.perf_counter() - t_a:.1f}s")


def _eri_grad_blocks(fx, refs, Cell, Shell, eri_grad_fn, kpt_mod):
    """eri_grad_fn on He2 1x1x2 and 1x1x3, split by block.  The recorded
    momentum-conserving block of each mesh is held card against CPU and
    card against the JAX record at 1e-10; a block off momentum
    conservation (its ERI reads the fit's near-null directions, where
    roundoff is amplified by up to eps/rcond) card against CPU at 1e-8.
    A block over its gate is an open fault (ROADMAP section 3), printed
    as such with its value: the CPU alone moves the 1x1x3 conserving
    block by 3e-10 and the off-conservation blocks by 3e-6 (eps/rcond =
    2.2e-16 / 1e-10) between 1 and 4 threads.  The run stops where a
    conserving block passes 1e-8 (the gate before the split) or an
    off-conservation block 1e-4 (a wrong term, not roundoff)."""
    import numpy as np

    pc = fx.he2_probe(Cell, Shell)
    nao = pc.nao_nr()
    worst = {"conserving": 0.0, "non-conserving": 0.0}
    for km, rec in refs["eri_grad"].items():
        nz = [int(v) for v in km.split("x")]
        kp = pc.get_kpts(nz)
        k2c = kpt_mod.get_kconserv2(pc, kp)
        k3c = kpt_mod.get_kconserv3(pc, kp)
        rng = np.random.default_rng(0)
        probe = (rng.standard_normal((nao,) * 4)
                 + 1j * rng.standard_normal((nao,) * 4))
        last = len(kp) - 1
        off = (0, last, 1 if last > 1 else 0, 0)    # k4 != k3c[k1, k2, k3]
        for kidx in (tuple(rec["kidx"]), off):
            kind = ("conserving" if k3c[kidx[0], kidx[1], kidx[2]]
                    == kidx[3] else "non-conserving")
            outs = [eri_grad_fn(pc, kp, rec["mask"], kidx, k2c,
                                m0=tuple(rec["m0"]), device=dev)(
                pc.atom_coords(), probe) for dev in ("cuda", "cpu")]
            g, gc = (o[1].cpu().numpy() for o in outs)
            d = _relmax(g, gc)
            line = f"[12a] eri_grad_fn He2 {km} block {kidx} ({kind}): " \
                   f"card-cpu {d:.1e}"
            if kind == "conserving":
                d = max(d, _relmax(g, np.asarray(rec["grad"])))
                line += f", card-JAX {_relmax(g, np.asarray(rec['grad'])):.1e}"
            worst[kind] = max(worst[kind], d)
            log(line)
    def verdict(d, gate):
        return "pass" if d <= gate else "OPEN FAULT, ROADMAP section 3"

    cons, off = worst["conserving"], worst["non-conserving"]
    log(f"[12a] eri_grad_fn maxima: conserving blocks {cons:.1e} (gate "
        f"1e-10: {verdict(cons, 1e-10)}), non-conserving blocks {off:.1e} "
        f"(gate 1e-8: {verdict(off, 1e-8)})")
    if cons > 1e-8 or off > 1e-4:
        raise RuntimeError("eri_grad_fn disagrees beyond roundoff")


def _qha_h2_chain(refs):
    """eos.qha_kernel on tests/test_eos.py's H2 chain (KRHF conv_tol 1e-11,
    diis_space 1; 5 scales, Gamma phonons) on the card against the JAX
    package's record (tools/jax_port_refs.py qha): energies 1e-8 Ha,
    wavenumbers 1e-2 cm^-1, V0(T) 1e-6 relative, the same masked modes."""
    import numpy as np
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRHF, eos

    ref = json.loads(REFS.read_text())["qha"]
    axy, az, d = 6.0, 4.5, 0.54
    cell = structure.to_cell(
        np.diag([axy, axy, az]),
        [("H", np.array([axy / 2, axy / 2, az / 2 - d])),
         ("H", np.array([axy / 2, axy / 2, az / 2 + d]))],
        basis="gth-szv", pseudo="gth-pade", ke_cutoff=30.0)
    t0 = time.perf_counter()
    mf = KRHF(cell, cell.get_kpts([1, 1, 1]), verbose=0, conv_tol=1e-11,
              diis_space=1)
    mf.kernel()
    out = eos.qha_kernel(mf, [0.0, 300.0], scales=np.linspace(0.94, 1.06, 5),
                         nrep=(1, 1, 1), step=2e-3)
    secs = time.perf_counter() - t0
    de = max(abs(mf.e_tot - ref["e_tot"]),
             float(np.abs(out["eos"].energies
                          - np.asarray(ref["energies"])).max()))
    dw = float(np.abs(out["freqs_cm"] - np.asarray(ref["freqs_cm"])).max())
    dv = _relmax(out["v0"], ref["v0"])
    same = np.array_equal(out["gamma_mask"], np.asarray(ref["gamma_mask"]))
    log(f"[12a] eos.qha_kernel H2 chain on the card ({secs:.1f}s): V0(T = 0, "
        f"300 K) " + " ".join(f"{v:.4f}" for v in out["v0"])
        + f" bohr^3; against the JAX record: energies {de:.1e} Ha (gate "
        f"1e-8), wavenumbers {dw:.1e} cm^-1 (gate 1e-2), V0 {dv:.1e} "
        f"(gate 1e-6), masked modes equal {same}")
    if not (de <= 1e-8 and dw <= 1e-2 and dv <= 1e-6 and same):
        raise RuntimeError("eos.qha_kernel misses the JAX record")


def _deriv_nio(torch, ctx):
    """(b) the Pulay-complete ISDF force at full width: NiO AFM gth-szv ke
    100 4x4x4, c0 40, m0 15^3, the first O displaced along x, KUHF and
    KUKS-PBE+U, against central differences of re-converged energies."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import DeviceKUHF, DeviceKUKS
    from fftisdf_tpu_torch.scf import grad
    from fftisdf_tpu_torch.utils.device import free_memory_bytes

    base, kpts = _nio(100.0, [4, 4, 4])
    io = base.atom_symbols().index("O")
    h = 1e-3

    def displaced(dx):
        pos = base.atom_coords().copy()
        pos[io, 0] += NIO_DISP + dx
        return base.copy(atom=[(s, p) for s, p in
                               zip(base.atom_symbols(), pos)]).build()

    cell = displaced(0.0)
    torch.cuda.reset_peak_memory_stats()
    df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=0).build()
    t = df.timings
    log(f"[12b] NiO AFM gth-szv ke 100 4x4x4, O{io} +{NIO_DISP} bohr x: "
        f"nip {df.nip}, mesh {[int(m) for m in cell.mesh]}, build "
        f"{t['build_s']:.2f}s (selection {t['select_s']:.2f}s)")
    if df.nip != SLICE_NIP:
        raise RuntimeError(f"the displaced slice's nip {df.nip}")
    dfs = {s: FFTISDF(displaced(s * h), kpts, c0=40.0, m0=(15, 15, 15),
                      verbose=0).build(mask=df.mask) for s in (+1, -1)}
    kw = dict(verbose=0, conv_tol=1e-10, max_cycle=150, init_spin=AFM)
    for tag, cls, extra in (
            ("KUHF", DeviceKUHF, {}),
            ("KUKS-PBE+U", DeviceKUKS,
             dict(xc="pbe", hubbard=_nio_hubbard(NIO_U)))):
        t0 = time.perf_counter()
        smeared = cls(cell, kpts, df, **dict(kw, conv_tol=1e-8,
                                             smearing=5e-3), **extra)
        smeared.kernel()
        mf = cls(cell, kpts, df, **kw, **extra)
        mf.kernel(dm0=smeared.dm)
        del smeared
        if not mf.converged:
            raise RuntimeError(f"the displaced slice's {tag} did not "
                               "converge")
        log(f"[12b] {tag}: smeared then unsmeared from its density, "
            f"{mf.cycles} cycles, e_tot {mf.e_tot:.10f} "
            f"({time.perf_counter() - t0:.2f}s)")
        gc.collect()             # the previous sweep's closures, if cyclic
        torch.cuda.empty_cache()
        budget = 0.75 * free_memory_bytes(df.device) / 1e9
        (g, val), secs, peak = _timed_peak(torch, lambda: grad.kernel(
            mf, two_electron="isdf", df=df, max_memory_gb=budget))
        if tag == "KUHF":
            _force_parts(torch, cell, kpts, df, mf, budget, secs)
            # phase 14c holds the sharded force to this one (host arrays:
            # the Lagrangian's inputs, as make_grad_fn forms them)
            wdm, w_trace = grad.energy_weighted_dm(mf)
            ctx["nio_force"] = dict(cell=cell, kpts=kpts, mask=df.mask,
                                    m0=df.m0, solver=df.solver,
                                    rcond=df.rcond, dm=np.asarray(mf.dm),
                                    wdm=wdm, w_trace=w_trace, g=g,
                                    budget=budget, secs=secs)
        es = {}
        for s in (+1, -1):
            m = cls(dfs[s].cell, kpts, dfs[s], **kw, **extra)
            m.kernel(dm0=mf.dm)
            if not m.converged:
                raise RuntimeError(f"{tag} at {s:+d}h did not converge")
            es[s] = m.e_tot
            del m
        fd = (es[+1] - es[-1]) / (2 * h)
        err = abs(g[io, 0] - fd)
        log(f"[12b] {tag} force sweep: {secs:.2f}s, peak {peak:.2f} GB, "
            f"budget {budget:.1f} GB ({_chunk_plan(cell, kpts, df, budget)}); "
            f"L - e_tot {val - mf.e_tot:+.1e}; dE/dx(O{io}) {g[io, 0]:.8f}, "
            f"FD (h {h:g}) {fd:.8f}, |diff| {err:.1e} Ha/bohr (gate "
            f"{DERIV_FD_TOL:g}); |sum F| {np.linalg.norm(g.sum(axis=0)):.2e}"
            f", max|F| {np.abs(g).max():.6f}")
        if not (err <= DERIV_FD_TOL and peak < 80.0
                and abs(val - mf.e_tot) < 1e-7):
            raise RuntimeError(f"the slice's {tag} force misses its FD")
        del mf


def _force_parts(torch, cell, kpts, df, mf, budget, sweep_s):
    """Where the force sweep's seconds go: the chunked ISDF state alone
    and the whole Lagrangian, each forward only (no autograd), beside the
    sweep (forward and backward)."""
    from fftisdf_tpu_torch.isdf.autodiff import isdf_state_fn
    from fftisdf_tpu_torch.scf import grad

    pos = torch.as_tensor(cell.atom_coords(), device=df.device)
    state = isdf_state_fn(cell, kpts, df.mask, m0=df.m0,
                          max_memory_gb=budget)
    e_fn = grad.make_energy_fn(cell, kpts, two_electron="isdf",
                               mask=df.mask, m0=df.m0,
                               max_memory_gb=budget)
    dm, wdm, w_trace = grad.scf_tensors(mf, df.device, df.cdtype)
    with torch.no_grad():
        _, s_state, _ = _timed_peak(torch, lambda: state(pos))
        _, s_value, _ = _timed_peak(torch, lambda: e_fn(pos, dm, wdm,
                                                         w_trace))
    log(f"[12b] the sweep's parts: chunked ISDF state forward {s_state:.2f}s"
        f", the whole Lagrangian forward {s_value:.2f}s; the rest of the "
        f"sweep (the backward pass with the chunks' and blocks' "
        f"recomputation, and W's Fock) {sweep_s - s_value:.2f}s of "
        f"{sweep_s:.2f}s")


def _chunk_plan(cell, kpts, df, budget):
    """'N canonical sectors, Q a chunk, B grid rows a block' of the
    chunked state at ``budget`` GB."""
    from fftisdf_tpu_torch.isdf.autodiff import isdf_state_fn

    st = isdf_state_fn(cell, kpts, df.mask, m0=df.m0, max_memory_gb=budget)
    return f"{st.nsectors} canonical sectors, {st.qchunk} a chunk, " \
        f"{st.blk} grid rows a block"


def _deriv_diamond_stress(torch):
    """(c) stress, EOS and elastic constants at full width: diamond
    gth-dzvp ke 200 2x2x2, c0 40, m0 15^3 (nip 1040), KRKS-PBE."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRKS
    from fftisdf_tpu_torch.scf import elastic, eos, stress

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-dzvp",
                             pseudo="gth-pade", ke_cutoff=200.0)
    kpts = cell.get_kpts([2, 2, 2])
    kscaled = cell.get_scaled_kpts(kpts)
    vol = float(cell.vol)
    df, s_b, _ = _timed_peak(torch, lambda: FFTISDF(
        cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=0).build())
    if df.nip != DIAMOND_NIP:
        raise RuntimeError(f"diamond nip {df.nip}, not {DIAMOND_NIP}")
    kw = dict(xc="pbe", verbose=0, conv_tol=1e-10, max_cycle=80)
    ks = KRKS(cell, kpts, df, **kw)
    ks.kernel()
    log(f"[12c] diamond gth-dzvp ke 200 2x2x2: nao {cell.nao_nr()}, mesh "
        f"{[int(m) for m in cell.mesh]}, nip {df.nip}, build {s_b:.2f}s; "
        + _scf_line("KRKS-PBE (ISDF)", ks, ks.cycle_seconds))
    (sig, p, val), secs, peak = _timed_peak(
        torch, lambda: stress.kernel(ks, two_electron="isdf", df=df))
    # the central FD of E under isotropic strain, +-h and +-2h (Richardson,
    # O(h^4)), on the frozen fractional mask
    h = 2e-3
    es = {}
    for m in (-2, -1, 1, 2):
        sc = elastic.strained_cell(cell, m * h * np.eye(3))
        kp = kscaled @ sc.reciprocal_vectors()
        dfs = FFTISDF(sc, kp, c0=40.0, m0=(15, 15, 15),
                      verbose=0).build(mask=df.mask)
        mfs = KRKS(sc, kp, dfs, **kw)
        mfs.kernel(dm0=ks.dm)
        if not mfs.converged:
            raise RuntimeError(f"strained KRKS ({m}h) did not converge")
        es[m] = mfs.e_tot
        del dfs, mfs
    fd1 = (es[1] - es[-1]) / (2 * h)
    fd = (4.0 * fd1 - (es[2] - es[-2]) / (4 * h)) / 3.0
    an = -3.0 * vol * p
    log(f"[12c] ISDF stress: {secs:.2f}s, peak {peak:.2f} GB; L - e_tot "
        f"{val - ks.e_tot:+.1e} (gate 1e-8); P {p:.8e} Ha/bohr^3 "
        f"({p * 29421.02648438959:.4f} GPa); dE/ds analytic {an:.8f}, FD "
        f"+-{h:g} {fd1:.8f}, Richardson {fd:.8f}, |diff| "
        f"{abs(an - fd):.1e} Ha (gate 1e-5 relative + 1e-6)")
    if not (abs(val - ks.e_tot) <= 1e-8
            and abs(an - fd) <= 1e-5 * abs(fd) + 1e-6):
        raise RuntimeError("the ISDF stress misses its FD")

    pw = KRKS(cell, kpts, **kw)
    pw.kernel()
    (sig, p, val), secs, peak = _timed_peak(torch, lambda: stress.kernel(pw))
    log(f"[12c] " + _scf_line("KRKS-PBE (exact J)", pw, pw.cycle_seconds)
        + f"; pw stress {secs:.2f}s, peak {peak:.2f} GB, L - e_tot "
        f"{val - pw.e_tot:+.1e} (gate 1e-8), P {p:.8e} Ha/bohr^3")
    if abs(val - pw.e_tot) > 1e-8:
        raise RuntimeError("the pw stress Lagrangian misses e_tot")
    res, secs, _ = _timed_peak(torch, lambda: eos.kernel(pw))
    p_fit = eos.bm_pressure(res.fit["poly"], res.volumes)
    scale = np.abs(res.pressures).max()
    d = np.abs(p_fit - res.pressures).max()
    log(f"[12c] eos over 5 scales ({secs:.2f}s): V0 {res.fit['v0']:.4f} "
        f"bohr^3, B0 {res.fit['b0_gpa']:.2f} GPa, B' {res.fit['bp']:.3f}; "
        f"fitted -dE/dV - analytic P {d:.2e} of {scale:.2e} (gate 5e-3)")
    if not d <= 5e-3 * scale:
        raise RuntimeError("the EOS fit misses the analytic pressures")
    res, secs, _ = _timed_peak(torch, lambda: elastic.kernel(
        pw, components=(0, 3)))
    c = res.c_gpa
    sym = abs(res.c[0, 3] - res.c[3, 0])
    bulk = (c[0, 0] + 2.0 * c[1, 0]) / 3.0
    log(f"[12c] elastic (components 0, 3; {secs:.2f}s): C11 {c[0, 0]:.2f}, "
        f"C12 {c[1, 0]:.2f}, C44 {c[3, 3]:.2f} GPa, B = (C11 + 2 C12)/3 "
        f"{bulk:.2f} GPa (EOS B0 beside it); Maxwell |C14 - C41| "
        f"{sym:.2e} Ha/bohr^3 (gate 5e-4 |C11|)")
    if not sym <= 5e-4 * abs(res.c[0, 0]):
        raise RuntimeError("the elastic tensor breaks Maxwell symmetry")


def _deriv_diamond_sweeps(torch):
    """(d) geometry sweeps at full width: diamond gth-szv ke 50 2x2x2, c0
    40 (README.md's KCCSD cell): the Gamma Hessian on the ISDF backend,
    a relaxation and NVE MD with an FFTISDF rebuilt at every step, and
    phonons on the 1x1x2 supercell."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf import hessian, md, phonon
    from fftisdf_tpu_torch.scf import optimize as scf_opt

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([2, 2, 2])
    kw = dict(verbose=0, conv_tol=1e-10, max_cycle=80)
    df = FFTISDF(cell, kpts, c0=40.0, verbose=0).build()
    mf = KRHF(cell, kpts, df, **kw)
    mf.kernel()
    (hs, g0), secs, peak = _timed_peak(torch, lambda: hessian.kernel(
        mf, two_electron="isdf", df=df))
    wav, _ = hessian.frequencies(cell, hs)
    opt = wav[3:]
    spread = (opt.max() - opt.min()) / opt.mean()
    log(f"[12d] diamond gth-szv ke 50 2x2x2 c0 40: nip {df.nip}; ISDF "
        f"Hessian at Gamma ({secs:.2f}s, peak {peak:.2f} GB): "
        + " ".join(f"{w:.2f}" for w in wav) + " cm^-1 (three translations "
        f"projected; optical spread {spread:.2e}, gate 2e-2; experiment "
        f"{DIAMOND_OPT_CM1:g}, for the record)")
    if not (np.abs(wav[:3]).max() < 1e-3 * opt.mean() and spread < 2e-2):
        raise RuntimeError("the Gamma Hessian is not a diamond's")

    pos = cell.atom_coords().copy()
    pos[1, 0] += 0.1
    start = cell.copy(atom=[(s, p) for s, p in
                            zip(cell.atom_symbols(), pos)]).build()
    t0 = time.perf_counter()
    res = scf_opt.kernel(KRHF(start, kpts, **kw), two_electron="isdf",
                         isdf_kwargs={"c0": 40.0})
    t_opt = time.perf_counter() - t0
    log(f"[12d] relaxation from +0.1 bohr x (FFTISDF rebuilt each step): "
        f"converged {res.converged} in {res.nsteps} steps, {t_opt:.1f}s "
        f"({t_opt / max(res.nsteps, 1):.2f} s/step), E {res.energy:.10f}, "
        f"max|F| {res.trajectory[-1][2]:.2e}, d(C-C) - start "
        f"{np.linalg.norm(res.positions[1] - res.positions[0]) - np.linalg.norm(cell.atom_coords()[1] - cell.atom_coords()[0]):+.4f} bohr")
    if not (res.converged and res.trajectory[-1][2] < 5e-4):
        raise RuntimeError("the diamond relaxation did not converge")

    t0 = time.perf_counter()
    run = md.kernel(KRHF(start, kpts, **kw), dt_fs=0.5, nsteps=10,
                    two_electron="isdf", isdf_kwargs={"c0": 40.0})
    t_md = time.perf_counter() - t0
    drift = float(np.abs(run.energies - run.energies[0]).max())
    log(f"[12d] NVE MD 10 x 0.5 fs from +0.1 bohr x: {t_md:.1f}s "
        f"({t_md / 10:.2f} s/step), E_tot drift {drift:.2e} Ha (gate "
        f"3e-4), T_end {run.temperatures[-1]:.1f} K")
    if not drift < 3e-4:
        raise RuntimeError("NVE drift above the Verlet floor")

    t0 = time.perf_counter()
    ph = phonon.kernel(KRHF(cell, kpts, **kw), (1, 1, 2))
    w = ph.frequencies(cell.get_kpts([1, 1, 2]))
    log(f"[12d] phonons on the 1x1x2 supercell (pw, ASR; "
        f"{time.perf_counter() - t0:.1f}s): Gamma "
        + " ".join(f"{v:.1f}" for v in w[0]) + "; q = (0, 0, 1/2) "
        + " ".join(f"{v:.1f}" for v in w[1]) + " cm^-1")
    if not (np.abs(w[0][:3]).max() < 1e-3 and np.all(w[0][3:] > 0)):
        raise RuntimeError("the acoustic sum rule misses the Gamma modes")

# ----------------------------------------------------------------- phase 13
NI_ARGV = ["--elem", "Ni", "--ke", "240"]   # examples/derive_atomic_basis
NI_HOLE = 0                           # the spin-down d hole starts in d_xy
STAGE_SUM_TOL = 0.05                  # stages against metric_s at production
TRACE_CYCLES = 3


def phase13_tools(torch, ctx):
    _stage_attribution(torch)
    _trace(torch)
    _ni_basis(torch, ctx)
    _cubes(torch, ctx)
    _tools_card_cpu(torch)


def _stage_attribution(torch):
    """(a) profile_build on the slice (profiled and plain builds in turns,
    w_q bitwise equal) and one profiled production build."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq

    cell, kpts = _nio(100.0, [4, 4, 4])
    ref, rows = None, []
    for profiled in (True, False, True, False):
        torch.cuda.empty_cache()
        df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=0,
                     profile_build=profiled).build()
        if ref is None:
            ref = (df.mask.copy(), df.wq.cpu())
        same = (np.array_equal(df.mask, ref[0])
                and torch.equal(df.wq.cpu(), ref[1]))
        rows.append((profiled, dict(df._stage_s), df._t_select,
                     dict(df.timings)))
        t = df.timings
        log(f"[13a] slice build {'profiled' if profiled else 'plain   '}: "
            f"selection {df._t_select:.3f}s, metric {t['metric_s']:.3f}s "
            f"(sweep_s {t['sweep_s']:.3f}, solve_s {t['solve_s']:.3f}); "
            "stages " + ", ".join(
                f"{k} {v:.3f}" for k, v in df._stage_s.items())
            + f"; mask and w_q bitwise equal to the first build: {same}")
        if not same or df.nip != SLICE_NIP:
            raise RuntimeError("profile_build changed the slice's build")
        del df
    prof = [r[3]["metric_s"] for r in rows if r[0]]
    plain = [r[3]["metric_s"] for r in rows if not r[0]]
    log(f"[13a] slice metric pass, profiled | plain: "
        + " ".join(f"{v:.3f}" for v in prof) + " | "
        + " ".join(f"{v:.3f}" for v in plain) + f" s; profiling overhead "
        f"{(sum(prof) - sum(plain)) / len(prof):+.3f} s a build")
    torch.cuda.empty_cache()
    cell, kpts = _production_cell()
    torch.cuda.reset_peak_memory_stats()
    df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=0,
                 profile_build=True).build()
    st, metric = df._stage_s, df.timings["metric_s"]
    total = sum(st.values())
    log(f"[13a] production build, profiled: nip {df.nip}, selection "
        f"{df._t_select:.3f}s, metric pass {metric:.3f}s in {df.nchunks} "
        f"chunk(s), peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        "stages " + ", ".join(f"{k} {v:.3f}s ({v / metric:.1%})"
                              for k, v in st.items())
        + f"; sum {total:.3f}s = {total / metric:.2%} of the metric pass "
        f"(gate {1 - STAGE_SUM_TOL:.0%}-100%)")
    if df.nip != PROD_NIP or abs(total - metric) > STAGE_SUM_TOL * metric:
        raise RuntimeError("the production stages do not add up to the "
                           "metric pass")
    del df
    torch.cuda.empty_cache()
    log(f"[13a] K1 launches in (a)'s builds: {pair_gram_sq.launches}")
    if pair_gram_sq.launches < 1:
        raise RuntimeError("phase 13a's builds did not launch K1")


def _trace(torch):
    """(b) a torch.profiler trace of the slice's build and three
    DeviceKUHF cycles: the device's busy share of the window and the ten
    device operations that took the most time, summed by name."""
    from collections import defaultdict

    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import DeviceKUHF
    from fftisdf_tpu_torch.utils import profiling

    cell, kpts = _nio(100.0, [4, 4, 4])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiling.trace(tmp):
            with profiling.phase("build"):
                df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15),
                             verbose=0).build()
            with profiling.phase("device-kuhf"):
                mf = DeviceKUHF(cell, kpts, df, verbose=0,
                                **dict(SCF_KW, max_cycle=TRACE_CYCLES))
                mf.kernel()
            torch.cuda.synchronize()
        traced = time.perf_counter() - t0
        path = Path(tmp) / profiling.TRACE_FILE
        size = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in spans if e.get("cat") in profiling.DEVICE_CATEGORIES]
    t_lo = min(e["ts"] for e in spans)
    t_hi = max(e["ts"] + e["dur"] for e in spans)
    busy, end = 0.0, -1.0
    for e in sorted(dev, key=lambda e: e["ts"]):
        s0, s1 = e["ts"], e["ts"] + e["dur"]
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    log(f"[13b] trace of the slice build and {TRACE_CYCLES} DeviceKUHF "
        f"cycles ({traced:.1f}s traced, {size / 1e6:.1f} MB, {len(dev)} "
        f"device events): device busy {busy / 1e3:.1f} ms of a "
        f"{(t_hi - t_lo) / 1e3:.1f} ms window, {busy / (t_hi - t_lo):.1%}")
    for name, (us, n) in top:
        log(f"[13b]   {us / 1e3:9.2f} ms {n:6d}x  {name[:90]}")
    if not dev:
        raise RuntimeError("the trace holds no device work")
    del df, mf
    torch.cuda.empty_cache()


def _ni_radial():
    """examples/derive_atomic_basis.py --elem Ni --radial on the host,
    through the port's entry point (its lines unprinted): (seconds,
    converged, e_tot, {l: columns}, {l: residuals})."""
    from fftisdf_tpu_torch.examples import derive_atomic_basis

    t0 = time.perf_counter()
    res = derive_atomic_basis.derive_radial(
        _example_args(derive_atomic_basis, NI_ARGV + ["--radial"]),
        out=lambda *parts: None)
    return (time.perf_counter() - t0, res["converged"], res["e_tot"],
            res["tables"], res["resid"])


def _ni_start(mf, hole, shift=1e-6):
    """A start for the Ni pseudo-atom's KUHF that does not depend on the
    last bits of the core Hamiltonian: the KUHF's own Aufbau start
    (``get_init_guess``) with the five d components (the real harmonics'
    order xy, yz, z^2, xz, x^2-y^2) raised by 0, 1, ... 4 ``shift`` S on
    their AOs, the component ``hole`` highest and the others in their
    order.  The cubic box leaves the d levels degenerate in pairs and
    triples, so the plain start occupies an arbitrary rotation within a
    partly filled degenerate level, which the last bits of h1e choose;
    the ladder (far above that noise, far below any real splitting)
    chooses it instead: a level with one hole leaves ``hole`` empty."""
    import numpy as np

    order = [m for m in range(5) if m != hole] + [hole]
    h1e = mf.h1e
    bias, off = np.zeros_like(h1e), 0
    for _, _, _, sh in mf.cell.shells():
        if sh.l == 2:            # m-major, contracted-radial-minor
            for m in range(5):
                ix = off + m * sh.nctr + np.arange(sh.nctr)
                bias[:, ix[:, None], ix[None, :]] += (
                    shift * order.index(m) * mf.s1e[:, ix[:, None],
                                                    ix[None, :]])
        off += sh.nfunc
    try:
        mf.h1e = h1e + bias
        return mf.get_init_guess()
    finally:
        mf.h1e = h1e


def _d_populations(mf):
    """Mulliken populations of the five d components (summed over the
    radial functions and k), per spin: (2, 5)."""
    import numpy as np

    ps = np.einsum("skmn,knm->skm", np.asarray(mf.dm), mf.s1e).real.sum(1)
    out, off = np.zeros((2, 5)), 0
    for _, _, _, sh in mf.cell.shells():
        if sh.l == 2:
            out += ps[:, off:off + sh.nfunc].reshape(2, 5, sh.nctr).sum(-1)
        off += sh.nfunc
    return out / len(mf.kpts)


def _start_ni_radial():
    """Start phase 13c's --radial route (host only, independent of the
    card) in a spawned daemon process of its own with 2 BLAS threads, so
    that it runs beside phase 12: (process, the end of a pipe that
    brings back ("ok", _ni_radial()) or ("error", traceback))."""
    import multiprocessing as mp

    keys = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    mpc = mp.get_context("spawn")
    recv_end, send_end = mpc.Pipe(duplex=False)
    proc = mpc.Process(target=_ni_radial_child, args=(send_end,),
                       daemon=True)
    os.environ.update({k: "2" for k in keys})
    try:
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    send_end.close()                 # EOF here if the process dies
    return proc, recv_end


def _ni_radial_child(conn):
    try:
        conn.send(("ok", _ni_radial()))
    except BaseException:
        import traceback

        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def _ni_radial_result(ctx):
    """The radial route's result: from the process that
    :func:`_start_ni_radial` started, or computed here."""
    job = ctx.pop("ni_radial", None)
    if job is None:
        return _ni_radial(), "on the host"
    proc, conn = job
    try:
        status, value = conn.recv()
    except EOFError:
        raise RuntimeError("the radial route's process died without a "
                           "result") from None
    finally:
        conn.close()
        proc.join(timeout=30)
    if status != "ok":
        raise RuntimeError(f"the radial route failed:\n{value}")
    return value, "in its own host process, beside phase 12"


def _ni_basis(torch, ctx):
    """(c) examples/derive_atomic_basis.py --elem Ni --ke 240 --check
    through the port's entry point: the uncontracted pseudo-atom KUHF in a
    12-bohr box on the card (float64), the radial naturals registered
    under gth-dzvp-molopt-sr (restored afterwards), the contracted KUHF and
    its variational gap; then the --radial route's columns, computed on
    the host in a process of their own since phase 12 began.  Both KUHFs
    start from :func:`_ni_start` with the spin-down hole in d_xy (``run``'s
    ``start``): the core Hamiltonian's spin-down t2g level is threefold
    degenerate and holds one hole, so the plain start leaves the hole's
    orientation to the last bits of h1e, and the KUHF lands in one of
    several states up to 0.76 mHa apart (tools/ni_kuhf_starts.py; ROADMAP
    section 3)."""
    import numpy as np
    from fftisdf_tpu_torch.basis import data as bdata
    from fftisdf_tpu_torch.examples import derive_atomic_basis as dab

    saved = bdata._BASIS.get("gth-dzvp-molopt-sr", {}).get("Ni")
    t0 = time.perf_counter()
    try:
        res = dab.run(_example_args(dab, NI_ARGV + ["--check"]),
                      out=_example_out("[13c]"),
                      start=lambda mf: _ni_start(mf, NI_HOLE))
    finally:
        bdata._BASIS["gth-dzvp-molopt-sr"]["Ni"] = saved
    cell, mf, mf2 = res["cell"], res["mf"], res["mf2"]
    e_unc, e_con, tables = res["e_unc"], res["e_con"], res["tables"]
    pop = _d_populations(mf)[1]
    log(f"[13c] Ni pseudo-atom: nao {cell.nao_nr()} (uncontracted), mesh "
        f"{[int(m) for m in cell.mesh]}, nelec {cell.nelectron}, 2S "
        f"{dab.SPIN['Ni']}; uncontracted KUHF (exact J/K) E {e_unc:.8f} Ha,"
        f" conv {mf.converged} in {mf.cycles} cycles; spin-down d "
        "populations (xy yz z2 xz x2-y2) "
        + " ".join(f"{v:.4f}" for v in pop))
    if not mf.converged or cell.nao_nr() != 54:
        raise RuntimeError("the uncontracted Ni KUHF did not converge")
    if pop[NI_HOLE] > 1e-2:
        raise RuntimeError("the uncontracted Ni KUHF left the d hole it "
                           "started from")
    gap = e_con - e_unc
    log(f"[13c] contracted KUHF E {e_con:.8f} Ha, conv {mf2.converged} in "
        f"{mf2.cycles} cycles; both KUHFs {time.perf_counter() - t0:.1f}s;"
        f" variational gap {gap * 1e3:.3f} mHa (gate >= -1e-3 mHa); derived"
        " columns " + ", ".join(f"l={l} {t.shape}" for l, t in
                               tables.items()))
    if not (mf2.converged and gap >= -1e-6):
        raise RuntimeError("the contracted Ni basis is not variational")
    (secs, conv, e_rad, rtab, resid), where = _ni_radial_result(ctx)
    log(f"[13c] --radial route {where} ({secs:.1f}s): "
        f"radial pseudo-atom conv {conv}, E {e_rad:.6f} Ha; columns "
        + ", ".join(f"l={l} {rtab[l].shape} residuals "
                    + "/".join(f"{r:.1e}" for r in resid[l])
                    for l in rtab))
    if not (conv and all(np.isfinite(rtab[l]).all() for l in rtab)):
        raise RuntimeError("the radial route failed")
    del res, mf, mf2
    torch.cuda.empty_cache()


def _cubes(torch, ctx):
    """(d) cube export at production from phase 6b's converged host KUHF:
    the density, the spin density and an orbital on the card, their
    integrals, and a cube file's round trip."""
    import numpy as np
    from fftisdf_tpu_torch.utils import cube

    mf = ctx.pop("production_scf")
    cell = mf.cell
    ngrid = int(np.prod(cell.mesh))
    dv = float(cell.vol) / ngrid
    rho, secs, peak = _timed_peak(torch, lambda: cube.density_on_grid(mf))
    n_int = float(rho.sum()) * dv
    dn = abs(n_int - cell.nelectron) / cell.nelectron
    rho_d = cube.density_on_grid(mf, spin="diff")
    nk = len(mf.kpts)
    dm_d = np.asarray(mf.dm[0] - mf.dm[1])
    m_ref = float(np.einsum("kmn,knm->", dm_d, mf.s1e).real) / nk
    dm_spin = abs(float(rho_d.sum()) * dv - m_ref)
    nocc = int(np.count_nonzero(np.asarray(mf.mo_occ)[0, 0] > 0.5))
    psi2 = cube.mo_on_grid(mf, k=0, n=nocc - 1, spin=0, part="abs2")
    d_mo = abs(float(psi2.sum()) * dv - 1.0)
    log(f"[13d] production density_on_grid: {secs:.2f}s, peak "
        f"{peak:.2f} GB (mesh {[int(m) for m in cell.mesh]}, nk {nk}, nao "
        f"{cell.nao_nr()}); integral {n_int:.10f} against nelec "
        f"{cell.nelectron}: {dn:.1e} relative (gate 1e-8); spin density "
        f"integral against sum_k tr((Da - Db) S)/nk = {m_ref:+.3e}: "
        f"{dm_spin:.1e} (gate 1e-8), integral of |n_a - n_b| "
        f"{float(np.abs(rho_d).sum()) * dv:.4f}; |psi|^2 of the HOMO "
        f"(k 0, spin a, n {nocc - 1}) integrates to 1 within {d_mo:.1e} "
        "(gate 1e-8)")
    if not (dn <= 1e-8 and dm_spin <= 1e-8 and d_mo <= 1e-8
            and rho.min() > -1e-8):
        raise RuntimeError("the production density fields miss their "
                           "integrals")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = cube.write_cube(Path(tmp) / "rho.cube", cell, rho,
                               comment="NiO production density")
        meta, field = cube.read_cube(path)
        rt_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
    vox = np.asarray(cell.a) / np.asarray(cell.mesh)[:, None]
    atoms_ok = len(meta["atoms"]) == cell.natm and all(
        np.allclose(xyz, c, atol=1e-6) for (_, _, xyz), c in
        zip(meta["atoms"], cell.atom_coords()))
    d_file = abs(float(field.sum()) * abs(np.linalg.det(meta["voxels"]))
                 - n_int) / n_int
    log(f"[13d] write_cube -> read_cube ({size / 1e6:.1f} MB, {rt_s:.2f}s): "
        f"mesh equal {np.array_equal(meta['mesh'], cell.mesh)}, voxels "
        f"{np.abs(meta['voxels'] - vox).max():.1e} (gate 1e-6), atoms equal "
        f"{atoms_ok}, integral {d_file:.1e} relative of the in-memory one "
        "(gate 1e-4)")
    if not (np.array_equal(meta["mesh"], cell.mesh) and atoms_ok
            and np.abs(meta["voxels"] - vox).max() <= 1e-6
            and d_file <= 1e-4 and field.size == ngrid):
        raise RuntimeError("the cube file does not round-trip")


def _tools_card_cpu(torch):
    """(e) diamond gth-szv ke 50 1x1x2: density_on_grid and profile_build
    on the card against the CPU."""
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KUHF
    from fftisdf_tpu_torch.utils import cube

    cell, kpts = _diamond()
    kw = dict(c0=10.0, m0=(9, 9, 9), verbose=0)
    plain = FFTISDF(cell, kpts, **kw).build()
    prof = FFTISDF(cell, kpts, profile_build=True, **kw).build(
        mask=plain.mask)
    plain = FFTISDF(cell, kpts, **kw).build(mask=plain.mask)
    cpu = FFTISDF(cell, kpts, device="cpu", **kw).build(mask=plain.mask)
    same = torch.equal(prof.wq, plain.wq)
    dm = np.stack([np.eye(cell.nao_nr(), dtype=complex)] * len(kpts))
    d_jk = max(_relmax(v.cpu().numpy(), vc.numpy())
               for v, vc in zip(prof.get_jk(dm), cpu.get_jk(dm)))
    mf = KUHF(cell, kpts, cpu, verbose=0, conv_tol=1e-9, device="cpu")
    mf.kernel()
    card = KUHF(cell, kpts, cpu, verbose=0)
    card.dm, card.mo_coeff = mf.dm, mf.mo_coeff
    d_rho = max(_relmax(cube.density_on_grid(card, spin=s),
                        cube.density_on_grid(mf, spin=s))
                for s in (None, 0, 1))
    log(f"[13e] diamond 1x1x2 on the card: profile_build w_q bitwise equal "
        f"to the plain build {same}, its J/K against the CPU build's "
        f"{d_jk:.1e} (gate 1e-10); density_on_grid card-cpu {d_rho:.1e} "
        "(gate 1e-12)")
    keys = ["factors", "sweep", "spectral", "gram"]
    if not (same and d_jk <= 1e-10 and d_rho <= 1e-12
            and list(prof._stage_s) == keys):
        raise RuntimeError("the tool layer's card results miss the CPU's")



# ----------------------------------------------------------------- phase 14
MESH_RANKS = 2          # gloo ranks on the one card (NCCL refuses two)
MESH_RANK_GB = 14.0     # per-rank budget of 14b's slice build: >= 2 chunks
MESH_FORCE_REL = 1e-8   # 14c: sharded against unsharded NiO force
MESH_CC = 1e-10         # 14d: sharded kccsd against phase 11's


def _jk_gate(vj, vk, ref):
    """(max|dJ|, max|dK|, gate): the dry run's form, 1e-6 max(max|vk|, 1)
    (__graft_entry__.py)."""
    import numpy as np

    gate = 1e-6 * max(float(np.abs(ref["vk"]).max()), 1.0)
    return (float(np.abs(vj - ref["vj"]).max()),
            float(np.abs(vk - ref["vk"]).max()), gate)


def phase14_mesh(torch, ctx):
    """The mesh layer (fftisdf_tpu_torch.parallel): (a) world size 1 over
    NCCL at full width, (b) 2 gloo ranks on the card, (c) the sharded force
    state, (d) kccsd(dev_mesh=).  Returns K1's launches in (a)."""
    import torch.distributed as dist
    from fftisdf_tpu_torch.parallel.dryrun import free_port
    from fftisdf_tpu_torch.parallel.mesh import make_device_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_device_mesh(backend="nccl")
        launches = _mesh_slice(torch, ctx, mesh)
        _mesh_production(torch, ctx, mesh)
        _mesh_force(torch, ctx, mesh)
    finally:
        dist.destroy_process_group()
    _mesh_ranks(torch, ctx)
    return launches


def _mesh_slice(torch, ctx, mesh):
    """(a) the slice: build_sharded + get_jk_sharded on one NCCL rank
    against phase 4's build, and KUHF.kernel on the sharded state from
    phase 4's converged density."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq
    from fftisdf_tpu_torch.parallel import build_sharded, get_jk_sharded
    from fftisdf_tpu_torch.scf import KUHF

    ref = ctx["slice_ref"]
    cell, kpts = _nio(100.0, [4, 4, 4])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pair_gram_sq.launches = 0
    df = build_sharded(FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15),
                               verbose=0), mesh)
    launches = pair_gram_sq.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    dm = _bench_density(cell, kpts)
    get_jk_sharded(df, dm, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vj, vk = get_jk_sharded(df, dm, mesh)
    torch.cuda.synchronize()
    jk_s = time.perf_counter() - t0
    dj, dk, gate = _jk_gate(vj.cpu().numpy(), vk.cpu().numpy(), ref)
    ctx["mesh_slice_jk"] = dict(vj=vj.cpu().numpy(), vk=vk.cpu().numpy())
    build_s = df.timings["build_s"]
    log(f"[14a] slice, world size 1 over NCCL: build_sharded {build_s:.2f}s"
        f" (phase 4: {ref['build_s']:.2f}s), nip {df.nip}, "
        f"{df.nchunks} chunk(s), plan {df.plan['qchunk']} sectors a chunk, "
        f"{df.plan['planes_per_device_gb']:.2f} GB of planes; K1 launches "
        f"{launches}; peak {peak:.2f} GB (phase 4: {ref['peak_gb']:.2f} GB); "
        f"warm get_jk_sharded {jk_s * 1e3:.2f} ms (phase 4's get_jk "
        f"{ref['jk_s'] * 1e3:.2f} ms); max|dJ| {dj:.1e}, max|dK| {dk:.1e} "
        f"against phase 4 (gate {gate:.1e})")
    if launches < 1 or df.nip != SLICE_NIP or max(dj, dk) >= gate:
        raise RuntimeError("the sharded slice build misses phase 4's")
    t0 = time.perf_counter()
    mf = KUHF(cell, kpts, df, verbose=0, **SCF_KW)
    e = mf.kernel(dm0=ref["dm"])
    log(f"[14a] KUHF.kernel on the sharded state from phase 4's density: "
        f"e_tot {e:.10f} conv {mf.converged} in {mf.cycles} cycles "
        f"({time.perf_counter() - t0:.2f}s); e_tot - recorded "
        f"{e - SLICE_E_TOT:+.2e} Ha (gate 1e-6)")
    if not (mf.converged and abs(e - SLICE_E_TOT) <= 1e-6):
        raise RuntimeError("KUHF on the sharded slice missed the recorded "
                           "energy")
    del df, mf
    torch.cuda.empty_cache()
    return launches


def _mesh_production(torch, ctx, mesh):
    """(a) the production configuration: build_sharded on one NCCL rank
    against phase 6b's build."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.parallel import build_sharded

    ref = ctx["production_ref"]
    cell, kpts = _production_cell()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    df = build_sharded(FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15),
                               verbose=0), mesh)
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = _bench_jk(torch, df)
    dj, dk, gate = _jk_gate(got["vj"], got["vk"], ref)
    log(f"[14a] production, world size 1 over NCCL: build_sharded "
        f"{df.timings['build_s']:.2f}s (phase 6b: {ref['build_s']:.2f}s), "
        f"nip {df.nip}, {df.nchunks} chunk(s) of {df.plan['qchunk']} "
        f"sectors; peak {peak:.2f} GB (phase 6b: {ref['peak_gb']:.2f} GB); "
        f"warm get_jk {got['jk_s'] * 1e3:.2f} ms (phase 6b: "
        f"{ref['jk_s'] * 1e3:.2f} ms); max|dJ| {dj:.1e}, max|dK| {dk:.1e} "
        f"(gate {gate:.1e})")
    if df.nip != PROD_NIP or max(dj, dk) >= gate:
        raise RuntimeError("the sharded production build misses phase 6b's")
    del df
    torch.cuda.empty_cache()


def _mesh_force(torch, ctx, mesh):
    """(c) phase 12b's NiO slice force (KUHF, the first O displaced): the
    same Lagrangian at the same converged density, the ISDF state on the
    mesh (world size 1 over NCCL)."""
    import numpy as np
    from fftisdf_tpu_torch.scf import grad

    f = ctx.pop("nio_force")
    dev = mesh.device
    e_fn = grad.make_energy_fn(f["cell"], f["kpts"], two_electron="isdf",
                               mask=f["mask"], m0=f["m0"],
                               solver=f["solver"], rcond=f["rcond"],
                               max_memory_gb=f["budget"], dev_mesh=mesh,
                               device=dev)
    dm, wdm = (torch.as_tensor(a, dtype=torch.complex128, device=dev)
               for a in (f["dm"], f["wdm"]))
    pos = torch.as_tensor(f["cell"].atom_coords(), dtype=torch.float64,
                          device=dev).requires_grad_(True)
    torch.cuda.empty_cache()

    def sweep():
        with torch.enable_grad():
            return torch.autograd.grad(e_fn(pos, dm, wdm, f["w_trace"]),
                                       pos)[0]

    g, secs, peak = _timed_peak(torch, sweep)
    g = g.cpu().numpy()
    rel = float(np.abs(g - f["g"]).max() / np.abs(f["g"]).max())
    log(f"[14c] NiO slice force, the ISDF state on one NCCL rank: "
        f"{secs:.2f}s (phase 12b: {f['secs']:.2f}s), peak {peak:.2f} GB; "
        f"max|dF| / max|F| {rel:.1e} against phase 12b (gate "
        f"{MESH_FORCE_REL:g})")
    if not rel <= MESH_FORCE_REL:
        raise RuntimeError("the sharded force state misses phase 12b's")
    del e_fn, dm, wdm, pos
    torch.cuda.empty_cache()


def _mesh_rank(mesh, diamond):
    """One of phase 14's gloo ranks on the card: (b) the slice under a
    per-rank budget, (c) the He2 force state, (d) kccsd on diamond szv
    2x2x2 (phase 11's points)."""
    import torch
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.parallel import build_sharded
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf.cc import kccsd

    sys.path.insert(0, str(REPO / "tests"))
    import torch_parallel_cases as cases

    out = {}
    cell, kpts = _nio(100.0, [4, 4, 4])
    torch.cuda.reset_peak_memory_stats()
    df = build_sharded(FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15),
                               verbose=0, max_memory_gb=MESH_RANK_GB), mesh)
    vj, vk = df.get_jk(_bench_density(cell, kpts))
    out["slice"] = dict(vj=vj.cpu().numpy(), vk=vk.cpu().numpy(),
                        plan=df.plan, nchunks=df.nchunks,
                        timings=dict(df.timings),
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del df, vj, vk
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["force"] = cases.force_case(mesh, device=mesh.device)
    out["force"]["s"] = time.perf_counter() - t0
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([2, 2, 2])
    df = FFTISDF(cell, kpts, c0=40.0, m0=diamond["m0"],
                 verbose=0).build(mask=diamond["mask"])
    mf = KRHF(cell, kpts, df, verbose=0)
    mf.kernel()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e, info = kccsd(df, mf, dev_mesh=mesh)
    out["kccsd"] = dict(e=e, converged=bool(mf.converged
                                            and info["converged"]),
                        niter=info["niter"], s=time.perf_counter() - t0,
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def _mesh_ranks(torch, ctx):
    """(b)-(d): MESH_RANKS gloo ranks spawned on the one card."""
    import numpy as np
    from fftisdf_tpu_torch.parallel.dryrun import spawn

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn(_mesh_rank, MESH_RANKS, backend="gloo", device="cuda:0",
                args=(ctx["diamond222"],), timeout_s=900)
    log(f"[14] {MESH_RANKS} gloo ranks on the card (spawned, one process "
        f"group for b-d): {time.perf_counter() - t0:.1f}s; on one card "
        "these measure the mechanism, not NVLink")
    ok = True
    ref = ctx["mesh_slice_jk"]
    for r, out in enumerate(res):
        sl = out["slice"]
        dj, dk, gate = _jk_gate(sl["vj"], sl["vk"], ref)
        t, plan = sl["timings"], sl["plan"]
        log(f"[14b] rank {r}: slice build_sharded {t['build_s']:.2f}s, "
            f"{sl['nchunks']} chunks of {plan['qchunk']} sectors, "
            f"{plan['planes_per_device_gb']:.2f} GB of planes per device per "
            f"chunk (budget {plan['budget_gb']:.1f} GB), peak "
            f"{sl['peak_gb']:.2f} GB; all-to-all {t['a2a_bytes'] / 1e9:.3f} "
            f"GB sent in {t['a2a_s']:.2f}s; max|dJ| {dj:.1e}, max|dK| {dk:.1e} "
            f"against 14a (gate {gate:.1e})")
        ok &= sl["nchunks"] >= 2 and max(dj, dk) < gate
        f = out["force"]
        gate_g = 2e-5 * max(1.0, float(np.abs(f["g1"]).max()))
        dg = float(np.abs(f["g2"] - f["g1"]).max())
        log(f"[14c] rank {r}: He2 force state over 2 ranks: |dvalue| "
            f"{abs(f['v2'] - f['v1']):.1e} (gate 1e-10), max|dgrad| {dg:.1e}"
            f" (gate {gate_g:.1e}), {f['s']:.2f}s")
        ok &= abs(f["v2"] - f["v1"]) < 1e-10 and dg < gate_g
        c = out["kccsd"]
        de = abs(c["e"] - ctx["diamond222"]["e_cc"])
        log(f"[14d] rank {r}: kccsd(dev_mesh=) diamond szv 2x2x2: e "
            f"{c['e']:.12f}, {c['niter']} cycles (phase 11: "
            f"{ctx['diamond222']['niter']}), {c['s']:.2f}s, peak "
            f"{c['peak_gb']:.2f} GB; |e - phase 11's| {de:.1e} (gate "
            f"{MESH_CC:g})")
        ok &= c["converged"] and de <= MESH_CC
    if not ok:
        raise RuntimeError("a gate of the gloo ranks on the card failed")


# ----------------------------------------------------------------- phase 15
# (module, arguments, key of the JAX record of these arguments or None):
# every example at its JAX defaults where no earlier phase runs them
# (nio_afm_kuhf: phases 3 and 6b; exciton_dispersion --eels: 10a;
# relax_vibrations --isdf: 12a; derive_atomic_basis --elem Ni: 13c), then
# the recorded arguments where they differ from the defaults
EXAMPLES = [
    ("nio_northstar", ["--skip-b"], None),
    ("nio_northstar", ["--skip-b", "--ke-a", "50", "--kmesh-a", "1", "1",
                       "2", "--max-cycle", "200"], "nio_northstar"),
    ("diamond_isdf", [], "diamond_isdf"),
    ("diamond_ks", [], "diamond_ks"),
    ("diamond_bands", [], None),
    ("diamond_bands", ["--kmesh", "1", "1", "2", "--npoints", "2"],
     "diamond_bands"),
    ("molecule_in_a_box", [], "molecule_in_a_box"),
    ("thc_demo", [], "thc_demo"),
    ("thc_demo", ["--becke"], "thc_demo_becke"),
    ("exciton_dispersion", ["--kmesh", "1", "1", "2", "--c0", "20"],
     "exciton_dispersion"),
    ("cc_spectroscopy", [], "cc_spectroscopy"),
    ("dmet_demo", [], "dmet_demo"),
    ("relax_vibrations", [], "relax_vibrations"),
    ("lih_variable_cell", [], "lih_variable_cell"),
    ("phonon_elastic", [], "phonon_elastic"),
    ("derive_atomic_basis", ["--check"], "derive_atomic_basis"),
    ("derive_atomic_basis", ["--radial", "--check"],
     "derive_atomic_basis_radial"),
]
# records replayed in the host loop, the loop the JAX script took on the
# CPU: nio_northstar's ISDF arms start from the exact arm's density, and
# from there the device loop's stop (|ddm| < 30 sqrt(conv_tol), the JAX
# package's too) comes after 8 cycles 4.7e-6 Ha below the fixed point
# that the host loop, and the device loop from its own start or at
# conv_tol 1e-10, reach within 3e-7 Ha of the record (ROADMAP §3); its
# defaults run above keeps the device loop
HOST_LOOP_RECORDS = {"nio_northstar"}


def phase15_examples(torch, ctx):
    """The port's entry points, python -m fftisdf_tpu_torch.examples.<name>,
    run in-process through ``main(argv)`` on the card: each held to the
    JAX script's own checks (``check``) and, where the JAX package's run
    of the same arguments is recorded (tests/data/jax_example_outputs.json),
    to it at the module's GATES, on the recorded interpolation points.
    Returns K1's launches in the phase."""
    import importlib

    from fftisdf_tpu_torch.basis import data as bdata
    from fftisdf_tpu_torch.examples import _common
    from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq

    records = json.loads(EXAMPLE_RECORD.read_text())["examples"]
    pair_gram_sq.launches = 0
    failed = []
    for name, argv, key in EXAMPLES:
        mod = importlib.import_module(f"fftisdf_tpu_torch.examples.{name}")
        rec = records.get(key) if key else None
        if rec is not None and rec["args"] != argv:
            raise RuntimeError(f"{key}: recorded with {rec['args']}")
        extra = (["--out", str(Path(ctx["tmp"]) / "ns" / "nio.json")]
                 if name == "nio_northstar" else [])
        masks = [dict(m) for m in rec["masks"]] if rec else None
        saved = bdata._BASIS.get("gth-dzvp-molopt-sr", {}).get("H")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches = pair_gram_sq.launches
        device_loop = _common.device_loop
        if key in HOST_LOOP_RECORDS:
            _common.device_loop = lambda device, level_shift=0.0: False
        t0 = time.perf_counter()
        try:
            nums = mod.main(argv + extra, masks=masks)
        finally:    # --check registers derived columns, in memory
            bdata._BASIS["gth-dzvp-molopt-sr"]["H"] = saved
            _common.device_loop = device_loop
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        mode = ("becke" if "--becke" in argv else "uniform")
        bad = (mod.check(nums, mode) if name == "thc_demo"
               else mod.check(nums))
        line = (f"[15] {name} {' '.join(argv) or '(defaults)'}"
                + (" (host loop)" if key in HOST_LOOP_RECORDS else "")
                + f": {secs:.1f}s, peak {peak:.2f} GB, K1 launches "
                f"{pair_gram_sq.launches - launches}; own checks "
                + ("passed" if not bad else "FAILED " + ", ".join(bad)))
        if rec is not None:
            ref = _common.numbers(mod, rec["stdout"] + rec.get("stderr", ""))
            rows = _common.compare(nums, ref, _common.gates(mod, argv))
            worst = [r for r in rows if not r[3]]
            if not rows:
                bad.append("no gated key against the JAX record")
            line += (f"; JAX record ({len(rows)} gated keys): "
                     + ("all within" if not worst else "MISSED " + "; ".join(
                         f"{k} {e:.2e} > {lim:.1e}" for k, e, lim, _ in
                         worst)))
            if name == "thc_demo":
                bad += [f"JAX record: {b}" for b in mod.check(ref, mode)]
            bad += [r[0] for r in worst]
        log(line)
        if bad:
            failed.append(f"{name} {' '.join(argv)}: {bad}")
    launches = pair_gram_sq.launches
    log(f"[15] K1 launches in phase 15: {launches}")
    if failed:
        raise RuntimeError("examples failed: " + " | ".join(failed))
    if launches < 1:
        raise RuntimeError("phase 15's builds did not launch K1")
    return launches


def main():
    torch = require_cuda()
    sys.path.insert(0, str(REPO))
    only = None
    if len(sys.argv) > 1:
        only = {int(p) for p in sys.argv[1].split(",")}
        if only & {8, 9, 10, 13}:   # phases 8-10 and 13 read phases 4/6's
            only |= {4, 6}
        if 14 in only:              # phase 14 holds itself to 4, 6, 11, 12
            only |= {4, 6, 11, 12}
    run = lambda p: only is None or p in only
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _run(torch, run, only, t_all, {"tmp": tmp})


def _run(torch, run, only, t_all, ctx):
    from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq

    def timed(p, fn, *args):
        if not run(p):
            return None
        t0 = time.perf_counter()
        out = fn(torch, *args)
        log(f"[{p}] phase {p} {time.perf_counter() - t0:.1f}s")
        return out

    smi = phase0_environment(torch)
    k1 = timed(1, phase1_kernel) or {}
    timed(2, phase2_device_vs_host)
    timed(3, phase3_anchor)
    launches = timed(4, phase4_slice, [4, 4, 4], ctx) or 0
    timed(5, phase5_exact, ctx)
    prod_launches = timed(6, phase6_device_scf, ctx) or 0
    f32_launches = timed(7, phase7_every_way, ctx) or 0
    pair_gram_sq.launches = 0
    timed(8, phase8_rest, ctx)
    rest_launches = pair_gram_sq.launches
    if run(8) and rest_launches < 1:
        raise RuntimeError("phase 8's builds did not launch K1")
    timed(9, phase9_ks, ctx)
    if run(9) and prod_launches < 1:
        raise RuntimeError("the build that served phase 9d did not launch K1")
    pair_gram_sq.launches = 0
    timed(10, phase10_many_body, ctx)
    corr_launches = pair_gram_sq.launches
    if run(10):
        log(f"[10] K1 launches in phase 10's builds: {corr_launches}")
        if corr_launches < 1:
            raise RuntimeError("phase 10's builds did not launch K1")
    pair_gram_sq.launches = 0
    timed(11, phase11_correlated, ctx)
    cc_launches = pair_gram_sq.launches
    if run(11):
        log(f"[11] K1 launches in phase 11's builds: {cc_launches}")
        if cc_launches < 1:
            raise RuntimeError("phase 11's builds did not launch K1")
    if run(13):
        ctx["ni_radial"] = _start_ni_radial()
    pair_gram_sq.launches = 0
    timed(12, phase12_derivatives, ctx)
    deriv_launches = pair_gram_sq.launches
    if run(12):
        log(f"[12] K1 launches in phase 12's builds: {deriv_launches}")
        if deriv_launches < 1:
            raise RuntimeError("phase 12's builds did not launch K1")
    pair_gram_sq.launches = 0
    timed(13, phase13_tools, ctx)
    tool_launches = pair_gram_sq.launches
    if run(13):
        log(f"[13] K1 launches in phase 13's builds: {tool_launches}")
        if tool_launches < 1:
            raise RuntimeError("phase 13's builds did not launch K1")
    mesh_launches = timed(14, phase14_mesh, ctx) or 0
    if run(14):
        log(f"[14] K1 launches in phase 14's sharded builds (14a, NCCL "
            f"rank 0): {mesh_launches}")
    example_launches = timed(15, phase15_examples, ctx) or 0
    log(f"[*] phases {sorted(only) if only else 'all'} "
        f"{time.perf_counter() - t_all:.1f}s")
    if only is not None:
        return
    common = {"route": "cuda",
              "source": "fftisdf_tpu_torch/ops/csrc/pair_gram.cu",
              "replaces": "fftisdf_tpu/ops/pallas_gram.py:110"}
    kernels = {"kernels": [
        {"name": "pair_gram_sq", **common, "dtype": "complex128",
         "launches": launches, "production_launches": prod_launches,
         "phase8_launches": rest_launches, "ks_launches": prod_launches,
         "corr_launches": corr_launches, "cc_launches": cc_launches,
         "deriv_launches": deriv_launches, "tool_launches": tool_launches,
         "mesh_launches": mesh_launches,
         "example_launches": example_launches,
         **k1["complex128"]},
        {"name": "pair_gram_sq_f32", **common, "dtype": "complex64",
         "launches": f32_launches, **k1["complex64"]},
    ]}
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
