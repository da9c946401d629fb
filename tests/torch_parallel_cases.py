"""The port's side of tests/test_torch_parallel.py, run on every rank of a
mesh (``fftisdf_tpu_torch.parallel.dryrun.spawn``): the cases of
tests/test_parallel.py, port-sharded against port-unsharded on the same
He2 cell.  Imports torch and the port only (the ranks are fresh
interpreters that never import JAX); returns numbers, which the test file
holds to the gates."""
import numpy as np
import torch

from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice.cell import Cell, Shell
from fftisdf_tpu_torch.parallel import (build_sharded, get_jk_sharded,
                                        make_device_mesh)
from fftisdf_tpu_torch.parallel.build import gather_wq


def he2k8():
    """tests/test_parallel.py's he2k8 cell (nk 8 on the 2x2x2 mesh)."""
    cell = Cell(a=np.diag([4.0, 4.0, 6.0]),
                atom=[("He", (2.0, 2.0, 1.5)), ("He", (2.0, 2.0, 4.0))],
                basis="sto-3g", pseudo=None, mesh=np.array([8, 8, 10]),
                unit="bohr", precision=1e-12).build()
    return cell, cell.get_kpts([2, 2, 2])


def h2_chain():
    """tests/test_parallel.py::test_sharded_kccsd_end_to_end's H2 chain."""
    cell = Cell(a=np.diag([6.0, 6.0, 7.0]),
                atom=[("H", (3.0, 3.0, 1.8)), ("H", (3.0, 3.0, 3.2))],
                basis={"H": [Shell(l=0, exps=np.array([1.2, 0.4]),
                                   coeffs=np.eye(2))]},
                pseudo="gth-pade", mesh=np.array([14, 14, 15]), unit="bohr",
                precision=1e-12).build()
    return cell, cell.get_kpts([1, 1, 2])


def _jk_diff(df1, df2, dm, **kw):
    vj1, vk1 = df1.get_jk(dm, **kw)
    vj2, vk2 = df2.get_jk(dm, **kw)
    return max(float((vj1 - vj2).abs().max()),
               float((vk1 - vk2).abs().max()))


def _np(t):
    return t.detach().cpu().resolve_conj().numpy()


def build_cases(mesh, dm8, dm3, jax_mask):
    """Build, serve, subgroup, TRS, chunking, refine, trunc and omega."""
    from fftisdf_tpu_torch.linalg.coulomb import trunc_for_cell

    cell, kpts = he2k8()
    kw = dict(m0=(5, 5, 7), verbose=0, device="cpu")
    out = {}
    df1 = FFTISDF(cell, kpts, c0=10.0, **kw).build()
    df2 = build_sharded(FFTISDF(cell, kpts, c0=10.0, **kw), mesh)
    out["build"] = _jk_diff(df1, df2, dm8)
    out["build_mask_equal"] = bool(np.array_equal(df1.mask, df2.mask))
    out["qs"] = df2.wq.qs.tolist()
    vj1, vk1 = df1.get_jk(dm8)
    vj2, vk2 = get_jk_sharded(df1, dm8, mesh)
    out["serve"] = max(float((vj1 - vj2).abs().max()),
                       float((vk1 - vk2).abs().max()))
    dfj = build_sharded(FFTISDF(cell, kpts, c0=10.0, **kw), mesh,
                        mask=jax_mask)
    out["jax_mask_jk"] = tuple(_np(v) for v in dfj.get_jk(dm8))

    # a mesh of the first rank only (the others get None)
    sub = make_device_mesh(1, backend="gloo", device="cpu")
    if sub is not None:
        d_s = build_sharded(FFTISDF(cell, kpts, c0=8.0, **kw), sub)
        d_1 = FFTISDF(cell, kpts, c0=8.0, **kw).build()
        out["subset"] = _jk_diff(d_s, d_1, dm8)

    # time-reversal halving on the 1x1x3 mesh: sectors 1 and 2 mirror
    k3 = cell.get_kpts([1, 1, 3])
    d_1 = FFTISDF(cell, k3, c0=8.0, **kw).build()
    d_t = build_sharded(FFTISDF(cell, k3, c0=8.0, **kw), mesh)
    d_n = build_sharded(FFTISDF(cell, k3, c0=8.0, use_trs=False, **kw), mesh)
    out["trs"] = _jk_diff(d_t, d_1, dm3)
    out["no_trs"] = _jk_diff(d_n, d_1, dm3)
    # the rank that solved sector 1 holds its mirror 2 as well
    out["trs_mirror_owner"] = int(d_t.wq.owner[1]) == int(d_t.wq.owner[2])

    # sector chunking: a per-rank budget that holds a few planes only
    nip = df2.nip
    plane_gb = 640 * nip * 16 / 1e9
    d_c = build_sharded(FFTISDF(cell, kpts, c0=10.0,
                                max_memory_gb=2 * 2 * plane_gb / 8, **kw),
                        mesh)
    out["chunks"] = int(d_c.nchunks)
    out["chunked_wq"] = float((gather_wq(d_c) - gather_wq(df2)).abs().max())

    # refine reaches the sector solve
    rkw = dict(c0=8.0, solver="ridge", rcond=1e-8, **kw)
    d_1 = FFTISDF(cell, kpts, refine=2, **rkw).build()
    d_2 = build_sharded(FFTISDF(cell, kpts, refine=2, **rkw), mesh)
    d_0 = build_sharded(FFTISDF(cell, kpts, refine=0, **rkw), mesh)
    out["refine"] = _jk_diff(d_2, d_1, dm8)
    out["refine0_vs_2"] = float((gather_wq(d_0) - gather_wq(d_2)).abs().max())

    # the 0D-truncated kernel and the screened kernel
    trunc = trunc_for_cell(cell, "0d")
    d_1 = FFTISDF(cell, kpts, c0=10.0, trunc=trunc, **kw).build()
    d_2 = build_sharded(FFTISDF(cell, kpts, c0=10.0, trunc=trunc, **kw),
                        mesh)
    out["trunc0d"] = _jk_diff(d_1, d_2, dm8)
    out["omega"] = _jk_diff(df1, df2, dm8, omega=0.4)
    out["backend"], out["device"] = mesh.backend, str(mesh.device)
    return out


def force_case(mesh, budget=None, device="cpu"):
    """The force state's value and gradient (tests/test_parallel.py:78):
    an ERI block of isdf_state_fn, unsharded and over the mesh, on
    ``device`` (the mesh rank's)."""
    from fftisdf_tpu_torch.isdf.autodiff import isdf_state_fn
    from fftisdf_tpu_torch.isdf.eri import assemble_eri
    from fftisdf_tpu_torch.lattice import kpoints as kpt_mod

    cell, kpts = he2k8()
    df = FFTISDF(cell, kpts, c0=10.0, m0=(5, 5, 7), verbose=0,
                 device=device).build()
    k2c = kpt_mod.get_kconserv2(cell, kpts)
    nao = df.x_k.shape[2]
    rng = np.random.default_rng(1)
    probe = torch.as_tensor(rng.standard_normal((nao,) * 4)
                            + 1j * rng.standard_normal((nao,) * 4),
                            device=df.device)
    pos0 = np.asarray([x for _, x in cell.atom])

    def value_and_grad(dev_mesh):
        state = isdf_state_fn(cell, kpts, df.mask, m0=df.m0,
                              dev_mesh=dev_mesh, max_memory_gb=budget,
                              device=df.device)
        pos = torch.as_tensor(pos0, device=df.device).requires_grad_(True)
        x_k, wq = state(pos)
        q = int(k2c[0, 1])
        val = torch.sum(probe * assemble_eri(wq[q], x_k[0], x_k[1], x_k[1],
                                             x_k[0])).real
        (g,) = torch.autograd.grad(val, pos)
        return float(val.detach()), g.cpu().numpy()

    v1, g1 = value_and_grad(None)
    v2, g2 = value_and_grad(mesh)
    return dict(v1=v1, v2=v2, g1=g1, g2=g2)


def ccsd_step_inputs():
    """tests/test_parallel.py::test_sharded_ccsd_step_matches_single's
    seeded random amplitudes, integrals and orbital energies (nk 8, 2
    occupied and 2 virtual spin orbitals; kp3[a, b, c] = a + b - c)."""
    rng = np.random.default_rng(41)
    nk, no, nv = 8, 2, 2
    n = no + nv
    u = 0.1 * (rng.standard_normal((nk,) * 3 + (n,) * 4)
               + 1j * rng.standard_normal((nk,) * 3 + (n,) * 4))
    kp3 = np.empty((nk, nk, nk), dtype=np.int64)
    for a in range(nk):
        for b in range(nk):
            for c in range(nk):
                kp3[a, b, c] = (a + b - c) % nk
    eo = -1.0 - rng.random((nk, no))
    ev = 1.0 + rng.random((nk, nv))
    t1 = 0.1 * (rng.standard_normal((nk, no, nv))
                + 1j * rng.standard_normal((nk, no, nv)))
    t2 = np.empty((nk, nk, nk, no, no, nv, nv), dtype=complex)
    for a in range(nk):
        for b in range(nk):
            for c in range(nk):
                t2[a, b, c] = 0.1 * (
                    rng.standard_normal((no, no, nv, nv))
                    + 1j * rng.standard_normal((no, no, nv, nv)))
    return nk, no, nv, kp3, eo, ev, u, t1, t2


def ccsd_step_case(mesh, slabs=False):
    """One CCSD update unsharded and over the mesh (the rank given its
    rows of U).  ``slabs``: rank 0 cuts its memory slabs to one row of the
    leading index and the others keep one slab, so the sharded slab loops
    must agree on a count."""
    from fftisdf_tpu_torch.scf import cc

    nk, no, nv, kp3, eo, ev, u, t1, t2 = ccsd_step_inputs()
    u, t1, t2 = (torch.as_tensor(a) for a in (u, t1, t2))
    if slabs and mesh.rank == 0:
        cc.memory_blocks = lambda n, per, dev: [slice(i, i + 1)
                                                for i in range(n)]
    t1a, t2a, ea = cc.make_step(nk, no, nv, kp3, eo, ev)(t1, t2, u)
    x0, x1 = mesh.owned(nk)
    t1b, t2b, eb = cc.make_step(nk, no, nv, kp3, eo, ev, mesh=mesh)(
        t1, t2, u[x0:x1])
    return dict(e=complex(eb), t1=_np(t1b), t2=_np(t2b),
                de=abs(complex(ea) - complex(eb)),
                dt1=float((t1a - t1b).abs().max()),
                dt2=float((t2a - t2b).abs().max()))


def kccsd_case(mesh):
    """kccsd(dev_mesh=) against kccsd() on the H2 chain (nk 2)."""
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf.cc import kccsd

    cell, kpts = h2_chain()
    mf = KRHF(cell, kpts, verbose=0, conv_tol=1e-10, device="cpu")
    mf.kernel()
    df = FFTISDF(cell, kpts, c0=40.0, m0=(11, 11, 13), verbose=0,
                 device="cpu").build()
    e1, i1 = kccsd(df, mf, conv_tol=1e-9, max_cycle=60)
    e2, i2 = kccsd(df, mf, conv_tol=1e-9, max_cycle=60, dev_mesh=mesh)
    return dict(converged=bool(mf.converged and i1["converged"]
                               and i2["converged"]), e1=e1, e2=e2)
