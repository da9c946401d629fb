#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fftisdf_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure raises and the script exits non-zero:

0. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of kernel K1 from ops/csrc/pair_gram.cu;
1. K1 against its plain PyTorch version on the card: the JAX package's
   Pallas test shapes in complex64 and complex128, and the main-path shape
   (64, 3375, 26) in complex128, both ``square`` values; CUDA-event times of
   the kernel and the plain version at the main-path shape;
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
   GPU, through the public entry points (FFTISDF.build, get_jk, KUHF.kernel);
   K1's launch count is reset right before it and must be >= 1 after.

The line before the last holds the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py 0,1        # a subset of phases, for development:
                                     # prints no result lines
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
ANCHOR = REPO / "tests" / "data" / "nio_afm_kuhf_anchor.json"
K1_TOL = {"complex64": 2e-5, "complex128": 1e-12}
K1_SHAPES = [(1, 64, 5), (3, 100, 7), (2, 300, 4), (16, 96, 40)]
MAIN_SHAPE = (64, 3375, 26)
AFM = {0: +1.0, 1: -1.0}


def log(*args):
    print(*args, flush=True)


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    return torch


def phase0_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[0] nvidia-smi: {smi}")
    log(f"[0] torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}  devices "
        f"{torch.cuda.device_count()}")
    from fftisdf_tpu_torch.ops.pair_gram import LIBRARY

    t0 = time.perf_counter()
    LIBRARY.load()
    log(f"[0] K1 build {LIBRARY.build_seconds:.2f}s (load "
        f"{time.perf_counter() - t0:.2f}s) -> {LIBRARY.path().name}")
    for line in LIBRARY.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[0] ptxas: {line.strip()}")
    return smi


def _cuda_ms(torch, fn, reps):
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


def phase1_kernel(torch):
    import numpy as np
    from fftisdf_tpu_torch.ops.pair_gram import (pair_gram_sq,
                                                 pair_gram_sq_reference)

    rng = np.random.default_rng(0)
    cases = [(s, d) for s in K1_SHAPES for d in ("complex64", "complex128")]
    cases += [(MAIN_SHAPE, "complex128")]
    main_err = 0.0
    for shape, dname in cases:
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        xt = torch.from_numpy(x.astype(dname)).cuda()
        for square in (False, True):
            out = pair_gram_sq(xt, square=square)
            ref = pair_gram_sq_reference(xt, square=square)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            err = float((out - ref).abs().max())
            ok = bool(torch.isfinite(out).all()) and err <= K1_TOL[dname] \
                * scale
            log(f"[1] K1 {shape} {dname} square={square}: max_abs_err "
                f"{err:.3e} (scale {scale:.3e}, tol {K1_TOL[dname]:.0e})"
                f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"K1 disagrees with its plain version at "
                                   f"{shape} {dname} square={square}")
            if shape == MAIN_SHAPE and not square:
                main_err = err
    x = rng.standard_normal(MAIN_SHAPE) + 1j * rng.standard_normal(
        MAIN_SHAPE)
    xt = torch.from_numpy(x).cuda()
    ms = _cuda_ms(torch, lambda: pair_gram_sq(xt, square=False), 20)
    plain_ms = _cuda_ms(torch, lambda: pair_gram_sq_reference(
        xt, square=False), 20)
    ng, kk = MAIN_SHAPE[1], MAIN_SHAPE[0] * MAIN_SHAPE[2]
    tflops = 8.0 * ng * ng * kk / (ms * 1e-3) / 1e12
    log(f"[1] K1 main-path shape {MAIN_SHAPE} complex128: kernel "
        f"{ms:.3f} ms ({tflops:.2f} TFLOP/s f64), plain {plain_ms:.3f} ms")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms}


def _diamond():
    from fftisdf_tpu_torch._shared import structure

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
    from fftisdf_tpu_torch._shared import structure

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


def phase4_slice(torch, kmesh):
    import numpy as np
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
    df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=3,
                 device="cuda").build()
    launches = pair_gram_sq.launches
    t = df.timings
    log(f"[4] build: nip {df.nip}, selection {t['select_s']:.3f}s, metric "
        f"pass {t['metric_s']:.3f}s (sweep {t['sweep_s']:.3f}s, solve/FFT/"
        f"gram {t['solve_s']:.3f}s), total {t['build_s']:.3f}s, "
        f"{df.nchunks} chunk(s); K1 launches {launches}")
    if launches < 1:
        raise RuntimeError("the slice's selection did not launch K1")
    t0 = time.perf_counter()
    mf = KUHF(cell, kpts, df, verbose=3, conv_tol=1e-8, max_cycle=80,
              init_spin=AFM, smearing=5e-3, device="cuda")
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
    if not (mf.converged and np.isfinite(e)):
        raise RuntimeError("the slice's KUHF did not converge")
    if not (vj.shape == (2, len(kpts), cell.nao_nr(), cell.nao_nr())
            and bool(torch.isfinite(vk).all())):
        raise RuntimeError("J/K of the slice are malformed")
    return launches


def main():
    torch = require_cuda()
    sys.path.insert(0, str(REPO))
    only = None
    if len(sys.argv) > 1:
        only = {int(p) for p in sys.argv[1].split(",")}
    run = lambda p: only is None or p in only
    t_all = time.perf_counter()
    smi = phase0_environment(torch)
    k1 = phase1_kernel(torch) if run(1) else {}
    if run(2):
        phase2_device_vs_host(torch)
    if run(3):
        phase3_anchor(torch)
    launches = phase4_slice(torch, [4, 4, 4]) if run(4) else 0
    log(f"[*] phases {sorted(only) if only else 'all'} "
        f"{time.perf_counter() - t_all:.1f}s")
    if only is not None:
        return
    kernels = {"kernels": [{
        "name": "pair_gram_sq",
        "route": "cuda",
        "source": "fftisdf_tpu_torch/ops/csrc/pair_gram.cu",
        "replaces": "fftisdf_tpu/ops/pallas_gram.py:110",
        "launches": launches,
        "max_abs_err": k1.get("max_abs_err"),
        "ms": k1.get("ms"),
        "plain_ms": k1.get("plain_ms"),
    }]}
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
