#!/usr/bin/env python3
"""Where the ERI gradient's roundoff comes from, on the CPU.

    python tools/eri_grad_noise.py all     # ~1 min: both tables as JSON

chip_smoke.py phase 12a holds ``isdf.autodiff.eri_grad_fn`` on the He2
probe cell (tests/torch_deriv_fixtures.py) at 1x1x2 and 1x1x3, on the
JAX package's recorded mask (tests/data/jax_port_refs.json), to 1e-10.
This prints, for the recorded momentum-conserving block of each mesh and
the q = 0 block (0, 0, 0, 0), the relative spread of the gradient (max
|dg| over max |g|) between 1 and 4 torch threads in the port, between a
single-threaded and the default multi-threaded XLA CPU client in the
JAX package, across the two packages and against the record; then the
spectrum of each sector's Jacobi-scaled normal matrix x4_q (what the
ridge fit factorises) against rcond 1e-10.  Each side runs in a fresh
interpreter so that its thread settings take effect."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = str(Path(__file__).resolve().parents[1])
sys.path.insert(0, REPO)
sys.path.insert(0, REPO + "/tests")
REC = json.loads(Path(REPO, "tests/data/jax_port_refs.json").read_text())[
    "derivatives"]["eri_grad"]

def probe_cell(pkg):
    import torch_deriv_fixtures as fx
    if pkg == "port":
        from fftisdf_tpu_torch.lattice.cell import Cell, Shell
    else:
        from fftisdf_tpu.lattice.cell import Cell, Shell
    return fx.he2_probe(Cell, Shell)


def grads(pkg, km):
    """{block: gradient} of the recorded block and (0, 0, 0, 0) on the
    k-mesh ``km`` ('1x1x3'), the probe from seed 0 (phase 12a's)."""
    rec = REC[km]
    nz = [int(v) for v in km.split("x")]
    if pkg == "port":
        from fftisdf_tpu_torch.isdf.autodiff import eri_grad_fn
        from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        from fftisdf_tpu.isdf.autodiff import eri_grad_fn
        from fftisdf_tpu.lattice import kpoints as kpt_mod
    pc = probe_cell(pkg)
    kp = pc.get_kpts(nz)
    k2c = kpt_mod.get_kconserv2(pc, kp)
    nao = pc.nao_nr()
    rng = np.random.default_rng(0)
    probe = (rng.standard_normal((nao,) * 4)
             + 1j * rng.standard_normal((nao,) * 4))
    out = {}
    for kidx in (tuple(rec["kidx"]), (0, 0, 0, 0)):
        if pkg == "port":
            _, g = eri_grad_fn(pc, kp, rec["mask"], kidx, k2c,
                               m0=tuple(rec["m0"]), device="cpu")(
                pc.atom_coords(), probe)
            g = g.numpy()
        else:
            _, g = eri_grad_fn(pc, kp, np.asarray(rec["mask"]), kidx, k2c,
                               m0=tuple(rec["m0"]))(
                jnp.asarray(pc.atom_coords()), jnp.asarray(probe))
            g = np.asarray(g)
        out[str(kidx)] = g.tolist()
    return out


def spectra():
    """Per mesh and sector: the Jacobi-scaled x4_q's eigenvalues against
    rcond 1e-10 (how many directions the fit cuts)."""
    import torch
    from fftisdf_tpu_torch.basis.eval import make_evaluator
    from fftisdf_tpu_torch.isdf.kpoint import _stripe_quartic
    from fftisdf_tpu_torch.lattice import kpoints as kpt_mod

    pc = probe_cell("port")
    res = {}
    for km, rec in REC.items():
        kp = pc.get_kpts([int(v) for v in km.split("x")])
        coords = pc.gen_uniform_grids(tuple(rec["m0"]))[
            np.asarray(rec["mask"])]
        x = make_evaluator(pc, kpts=kp, device="cpu")(coords).to(
            torch.complex128)
        ph = kpt_mod.get_phase(pc, kp, kpt_mod.kpts_to_kmesh(pc, kp))
        x4 = _stripe_quartic(x, torch.as_tensor(ph, dtype=torch.complex128))
        per = []
        for q in range(len(kp)):
            a = 0.5 * (x4[q] + x4[q].mH)
            d = torch.sqrt(torch.diagonal(a).real)
            w = torch.linalg.eigvalsh(a / (d[:, None] * d[None, :])).numpy()
            per.append(dict(q=q, nip=len(w), lam_max=float(w.max()),
                            lam_min=float(w.min()),
                            below_rcond=int((w < 1e-10 * w.max()).sum()),
                            below_1e8=int((w < 1e-8 * w.max()).sum())))
        res[km] = per
    return res


def _run(args, env=None):
    e = dict(os.environ)
    e.update(env or {})
    r = subprocess.run([sys.executable, __file__] + args,
                       capture_output=True, text=True, env=e)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-3000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "all"
    if mode == "port":
        import torch
        torch.set_num_threads(int(sys.argv[2]))
        print(json.dumps(grads("port", sys.argv[3])))
    elif mode == "jax":
        print(json.dumps(grads("jax", sys.argv[3])))
    elif mode == "spectra":
        print(json.dumps(spectra()))
    else:
        one = "--xla_force_host_platform_device_count=1"
        out = {}
        for km in REC:
            p1, p4 = _run(["port", "1", km]), _run(["port", "4", km])
            j1 = _run(["jax", "0", km], {
                "JAX_PLATFORMS": "cpu", "XLA_FLAGS": one
                + " --xla_cpu_multi_thread_eigen=false"
                " intra_op_parallelism_threads=1"})
            jm = _run(["jax", "0", km], {"JAX_PLATFORMS": "cpu",
                                         "XLA_FLAGS": one})
            rec = REC[km]
            for blk in p1:
                row = dict(port_1_vs_4=_rel(p4[blk], p1[blk]),
                           jax_1_vs_multi=_rel(jm[blk], j1[blk]),
                           port1_vs_jax1=_rel(p1[blk], j1[blk]),
                           port4_vs_jaxmulti=_rel(p4[blk], jm[blk]))
                if blk == str(tuple(rec["kidx"])):
                    row.update(jax1_vs_record=_rel(j1[blk], rec["grad"]),
                               jaxmulti_vs_record=_rel(jm[blk], rec["grad"]),
                               port1_vs_record=_rel(p1[blk], rec["grad"]))
                out[f"{km} {blk}"] = row
        print(json.dumps(out, indent=1))
        print(json.dumps(_run(["spectra"]), indent=1))


if __name__ == "__main__":
    main()
