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
3. the JAX anchor: NiO AFM, the defaults of examples/nio_afm_kuhf.py, on the
   GPU against the JAX package's energy recorded in
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
   against the exact oracle with the same kernel (1e-9).

The line before the last holds the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py 0,1        # a subset of phases, for development:
                                     # prints no result lines
"""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
ANCHOR = REPO / "tests" / "data" / "nio_afm_kuhf_anchor.json"
EXACT = REPO / "tests" / "data" / "nio_afm_kuhf_exact.json"
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
SLICE_NIP = 1040
SLICE_E_TOT = -360.3364120006     # the slice's converged energy on the H100
PROD_NIP = 2480                   # c0 40 x nao 62
PROD_E_TOT = -365.3099342755      # production, float64, on the H100
# |e_tot(float32) - e_tot(float64)| per atom that the float32 regime must
# hold (Ha), set from the first runs on an H100: 6.6e-3 and 7.1e-3 on the
# slice (float64 and complex64 selection), 9.7e-3 at production
F32_DE_ATOM = {"slice": 1e-2, "production": 2e-2}
SCF_KW = dict(conv_tol=1e-8, max_cycle=80, init_spin=AFM, smearing=5e-3)
# float32 J/K carry ~1e-6 Ha of noise into the energy, so a float32 SCF is
# converged to 1e-6 (the setting of examples/nio_afm_kuhf.py)
SCF_KW_F32 = dict(SCF_KW, conv_tol=1e-6)


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


def phase3_anchor(torch):
    import numpy as np
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KUHF
    from fftisdf_tpu_torch.scf.analysis import atom_charges_and_moments

    anchor = json.loads(ANCHOR.read_text())
    cfg = anchor["config"]
    cell, kpts = _nio(cfg["ke_cutoff"], cfg["kmesh"])
    kw = dict(verbose=0, conv_tol=cfg["conv_tol"],
              max_cycle=cfg["max_cycle"], init_spin=AFM,
              smearing=cfg["smearing"])
    out = {}
    for label, mask in (("jax-mask", anchor["mask"]), ("own", None)):
        df = FFTISDF(cell, kpts, c0=cfg["c0"], m0=tuple(cfg["m0"]),
                     verbose=0, device="cuda").build(mask=mask)
        mf = KUHF(cell, kpts, df, device="cuda", **kw)
        e = mf.kernel()
        _, mom = atom_charges_and_moments(cell, mf.dm, mf.s1e)
        out[label] = (e, mf.converged, mom)
        log(f"[3] NiO ke {cfg['ke_cutoff']:g} {cfg['kmesh']} c0 {cfg['c0']:g}"
            f" ({label} selection): e_tot {e:.10f} conv {mf.converged} "
            f"cycles {mf.cycles} Ni moments {mom[0]:+.4f} {mom[1]:+.4f}")
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
    return launches


def _slice(ctx):
    """(cell, kpts, FFTISDF) of the slice: phase 4's, or built here."""
    from fftisdf_tpu_torch.isdf import FFTISDF

    if "slice" not in ctx:
        cell, kpts = _nio(100.0, [4, 4, 4])
        df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=0).build()
        ctx["slice"] = (cell, kpts, df)
    return ctx["slice"]


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


def _device_loop_parts(torch, mf):
    """Wall milliseconds per call, the device synchronised before and
    after 5 calls, of the device loop's parts at the shapes of ``mf``'s
    run, on seeded random inputs: the batched eigensolve, the ADIIS
    descent, the CDIIS solve and one spin's chemical-potential
    bisection."""
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
    }
    out = []
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        out.append(f"{name} {(time.perf_counter() - t0) / 5 * 1e3:.2f} ms")
    return "; ".join(out)


def phase6_device_scf(torch, ctx):
    from fftisdf_tpu_torch.scf import KUHF, DeviceKUHF

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
    log(f"[6] slice device-loop parts: {_device_loop_parts(torch, dev)}")
    if not (host.converged and dev.converged and de <= 3e-8):
        raise RuntimeError("DeviceKUHF and KUHF disagree on the slice")
    del host, dev, df
    ctx.pop("slice", None)
    torch.cuda.empty_cache()

    # (b) the production configuration
    cell, kpts, df, mf, fig = _production_run(torch, "[6]")
    ctx["production_f64"] = fig
    log(f"[6] production device-loop parts: {_device_loop_parts(torch, mf)}")
    host = KUHF(cell, kpts, df, verbose=0, **SCF_KW)
    host.kernel()
    de = abs(mf.e_tot - host.e_tot)
    log("[6] production " + _scf_line("host KUHF", host, host.cycle_seconds)
        + f"; |dE| against DeviceKUHF {de:.2e} Ha")
    if not (host.converged and de <= 3e-8):
        raise RuntimeError("DeviceKUHF and KUHF disagree on the production "
                           "configuration")
    return fig["launches"]


def _production_cell():
    from fftisdf_tpu_torch.lattice import structure

    cell = structure.to_cell(*structure.nio_afm(),
                             basis="gth-dzvp-molopt-sr", pseudo="gth-pade",
                             ke_cutoff=200.0, exp_to_discard=0.1)
    return cell, cell.get_kpts([4, 4, 4])


def _production_run(torch, tag, dtype=None):
    """Build the production configuration in ``dtype`` through the
    default-device entry points, with K1's count reset right before, and
    converge DeviceKUHF on it.  Returns (cell, kpts, df, mf, figures)."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq
    from fftisdf_tpu_torch.scf import DeviceKUHF
    from fftisdf_tpu_torch.scf.analysis import atom_charges_and_moments

    cell, kpts = _production_cell()
    log(f"{tag} production NiO AFM gth-dzvp-molopt-sr ke 200 kmesh 4x4x4 "
        f"({dtype or 'torch.float64'}): nao {cell.nao_nr()} nelec "
        f"{cell.nelectron} mesh {[int(m) for m in cell.mesh]} nk {len(kpts)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pair_gram_sq.launches = 0
    df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), dtype=dtype,
                 verbose=3).build()
    fig = dict(df.timings, launches=pair_gram_sq.launches,
               nchunks=df.nchunks,
               build_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
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
    t0 = time.perf_counter()
    mf = DeviceKUHF(cell, kpts, df, dtype=dtype, verbose=3,
                    **(SCF_KW if dtype is None else SCF_KW_F32))
    fig["setup_s"] = time.perf_counter() - t0
    log(f"{tag} production one-electron setup {fig['setup_s']:.2f}s")
    dm0 = mf.get_init_guess()
    df.get_jk(dm0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df.get_jk(dm0)
    torch.cuda.synchronize()
    fig["jk_s"] = time.perf_counter() - t0
    log(f"{tag} production warm get_jk (2 spins) {fig['jk_s']:.4f}s")
    mf.kernel()
    _, mom = atom_charges_and_moments(cell, mf.dm, mf.s1e)
    per = mf.cycle_times[1:] or mf.cycle_times
    fig.update(e_tot=mf.e_tot, cycles=mf.cycles,
               cycle_s=sum(per) / len(per),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{tag} production " + _scf_line("DeviceKUHF", mf, mf.cycle_times)
        + f"; Ni moments {mom[0]:+.4f} {mom[1]:+.4f}; peak memory "
        f"{fig['peak_gb']:.2f} GB")
    if not (mf.converged and mom[0] * mom[1] < 0):
        raise RuntimeError("the production DeviceKUHF did not converge to "
                           "an AFM state")
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
    from fftisdf_tpu_torch.scf import KUHF, DeviceKUHF, PWDF

    f32 = torch.float32
    cell, kpts = _nio(100.0, [4, 4, 4])
    dm = _bench_density(cell, kpts)
    if "slice_exact" not in ctx:
        ctx["slice_exact"] = PWDF(cell, kpts).get_jk(dm)
    vj_e, vk_e = ctx["slice_exact"]
    ctx.pop("slice", None)
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


def main():
    torch = require_cuda()
    sys.path.insert(0, str(REPO))
    only = None
    if len(sys.argv) > 1:
        only = {int(p) for p in sys.argv[1].split(",")}
    run = lambda p: only is None or p in only
    t_all = time.perf_counter()
    ctx = {}

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
