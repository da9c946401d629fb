"""Multi-rank dry run of the sharded ISDF layer, and the rank launcher.

    python -m fftisdf_tpu_torch.parallel.dryrun --nproc 2 --backend gloo \\
        --device cpu                     # two CPU ranks over gloo
    python -m fftisdf_tpu_torch.parallel.dryrun --nproc 1   # one GPU, NCCL
    python -m fftisdf_tpu_torch.parallel.dryrun --plan     # plans only

Counterpart of ``__graft_entry__.dryrun_multichip``: on ``--nproc`` ranks
(spawned here; on a multi-GPU node ``torchrun --nproc-per-node N -m
fftisdf_tpu_torch.parallel.dryrun --torchrun`` starts them instead) it
runs (1) the tiny He2 step: ``build_sharded`` and the sharded J/K serve,
finite and of the right shape; (2) the sharded reverse sweep: the
gradient of an ERI block through ``isdf_state_fn(dev_mesh=)``; (3) from 2
ranks on, the mid-size phase: diamond gth-szv ke 30 on a 2x2x4 k-mesh
(16 k-points, 12 canonical sectors, nip 160) under a per-rank budget that
forces at least 2 sector chunks, its J/K against the single-device build
to 1e-6 of max(max|vk|, 1).  ``--plan`` prints ``plan_sharded`` at the
production shapes (NiO AFM gth-dzvp-molopt-sr ke 200, 4x4x4: nk 64,
nip 2480, ngrid 250,047) for 1, 2, 4 and 8 ranks of 80 GB cards (a 72 GB
budget each), without data.

:func:`spawn` starts ranks with the ``spawn`` method (never ``fork``:
CUDA may be live in the parent), joins them over a rendezvous
(``init_method``, a free localhost TCP port by default), runs
``fn(mesh, *args)`` on each and returns the per-rank results.
"""
from __future__ import annotations

import argparse
import json
import socket
import time
import traceback
from datetime import timedelta

import numpy as np
import torch


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, nproc, fn, args, init_method, backend, device, threads,
           timeout_s, queue):
    import torch.distributed as dist

    from fftisdf_tpu_torch.parallel.mesh import make_device_mesh

    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend=backend, init_method=init_method,
                                rank=rank, world_size=nproc,
                                timeout=timedelta(seconds=timeout_s))
        mesh = make_device_mesh(backend=backend, device=device)
        queue.put((rank, "ok", fn(mesh, *args)))
    except BaseException:                         # reported to the parent
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nproc, *, backend=None, device=None, args=(),
          init_method=None, threads=None, timeout_s=1800):
    """Run ``fn(mesh, *args)`` on ``nproc`` new ranks; returns the list of
    their results by rank.  Raises (and stops every rank) when a rank
    fails or the run passes ``timeout_s`` (also each collective's
    timeout).  ``device`` and ``backend`` are :func:`make_device_mesh`'s:
    by default each rank its local GPU over NCCL; ``device='cpu'`` with
    gloo for host ranks, or ``'cuda:0'`` with gloo for several ranks on
    one card.  ``threads``: torch threads per rank."""
    from fftisdf_tpu_torch.parallel.mesh import resolve_device_backend

    dev, backend = resolve_device_backend(device, backend)
    device = str(dev)
    ctx = torch.multiprocessing.get_context("spawn")
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=_child, daemon=True, args=(
        r, nproc, fn, args, init_method, backend, device, threads,
        timeout_s, queue))
        for r in range(nproc)]
    for p in procs:
        p.start()
    out, errors, done = [None] * nproc, [], set()
    t_end = time.monotonic() + timeout_s
    try:
        while len(done) < nproc and not errors:
            if not queue.empty():
                rank, status, value = queue.get()
                done.add(rank)
                if status != "ok":
                    errors.append(f"rank {rank}:\n{value}")
                out[rank] = value
                continue
            if time.monotonic() > t_end:
                raise TimeoutError(f"ranks did not finish in {timeout_s}s")
            lost = [r for r, p in enumerate(procs)
                    if r not in done and p.exitcode is not None]
            if lost:
                time.sleep(1.0)               # a result may be in flight
                if queue.empty():
                    raise RuntimeError(f"rank(s) {lost} exited without a "
                                       "result")
            time.sleep(0.05)
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


# ---------------------------------------------------------------- the run
def he2_cell(mesh_pts=(6, 6, 8)):
    """The dry run's He2 cell (``__graft_entry__._dryrun_impl``'s)."""
    from fftisdf_tpu_torch.lattice.cell import Cell

    return Cell(a=np.diag([4.0, 4.0, 6.0]),
                atom=[("He", (2.0, 2.0, 1.5)), ("He", (2.0, 2.0, 4.0))],
                basis="sto-3g", pseudo=None, mesh=np.array(mesh_pts),
                unit="bohr").build()


def _sym_dm(nk, nao, seed):
    dm = np.random.default_rng(seed).standard_normal((nk, nao, nao))
    return dm + dm.transpose(0, 2, 1)


def run(mesh):
    """The three dry-run phases on this rank; returns their figures."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.isdf.autodiff import eri_grad_fn
    from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
    from fftisdf_tpu_torch.parallel import build_sharded, get_jk_sharded

    dev, n = mesh.device, mesh.size
    out = {"ndev": n, "device": str(dev), "backend": mesh.backend}
    cell = he2_cell()
    kmesh = {1: [1, 1, 1], 2: [1, 1, 2], 4: [1, 2, 2], 8: [2, 2, 2],
             16: [2, 2, 4], 32: [2, 4, 4]}.get(n, [2, 2, 2])
    kpts = cell.get_kpts(kmesh)
    df = FFTISDF(cell, kpts, c0=6.0, m0=(4, 4, 5), verbose=0, device=dev)
    build_sharded(df, mesh)
    nk, _, nao = df.x_k.shape
    vj, vk = get_jk_sharded(df, _sym_dm(nk, nao, 0), mesh)
    if not (vj.shape == vk.shape == (nk, nao, nao)
            and bool(torch.isfinite(torch.view_as_real(vj)).all())
            and bool(torch.isfinite(torch.view_as_real(vk)).all())):
        raise RuntimeError("the sharded He2 serve is not finite")
    out["he2_nip"] = int(df.nip)

    # the sharded reverse sweep
    k2c = kpt_mod.get_kconserv2(cell, kpts)
    probe = np.random.default_rng(0).standard_normal((nao,) * 4)
    vg = eri_grad_fn(cell, kpts, df.mask, (0, nk - 1, nk - 1, 0), k2c,
                     m0=df.m0, device=dev, dev_mesh=mesh)
    val, grad = vg(cell.atom_coords(), probe)
    if grad.shape != (2, 3) or not bool(torch.isfinite(grad).all()):
        raise RuntimeError("the sharded reverse sweep is not finite")
    out["grad_norm"] = float(grad.norm())

    if n >= 2:
        from fftisdf_tpu_torch.lattice import structure

        cell2 = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                                  pseudo="gth-pade", ke_cutoff=30.0)
        kpts2 = cell2.get_kpts([2, 2, 4])
        kw = dict(c0=20.0, m0=(9, 9, 9), verbose=0, device=dev)
        df1 = FFTISDF(cell2, kpts2, **kw).build()
        df2 = build_sharded(FFTISDF(cell2, kpts2, max_memory_gb=0.05, **kw),
                            mesh)
        if df2.nchunks < 2:
            raise RuntimeError(f"the budget left {df2.nchunks} chunk(s)")
        dm2 = _sym_dm(len(kpts2), cell2.nao_nr(), 1)
        vj1, vk1 = df1.get_jk(dm2)
        vj2, vk2 = df2.get_jk(dm2)
        scale = max(float(vk1.abs().max()), 1.0)
        dvj = float((vj1 - vj2).abs().max())
        dvk = float((vk1 - vk2).abs().max())
        out.update(mid_nip=int(df2.nip), mid_chunks=int(df2.nchunks),
                   mid_plan=df2.plan, dvj=dvj, dvk=dvk)
        if not (dvj < 1e-6 * scale and dvk < 1e-6 * scale):
            raise RuntimeError(f"mid-size J/K off: dvj {dvj:.2e} dvk "
                               f"{dvk:.2e} (gate 1e-6 x {scale:.2e})")
    out["a2a_bytes"] = int(mesh.a2a_bytes)
    return out


def production_plans(ranks=(1, 2, 4, 8), budget_gb=72.0):
    """``plan_sharded`` at the production shapes for each rank count."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.isdf.kpoint import _trs_sectors
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.parallel.build import plan_sharded

    cell = structure.to_cell(*structure.nio_afm(), basis="gth-dzvp-molopt-sr",
                             pseudo="gth-pade", ke_cutoff=200.0)
    kpts = cell.get_kpts([4, 4, 4])
    df = FFTISDF(cell, kpts, c0=40.0, m0=(15, 15, 15), verbose=0,
                 max_memory_gb=budget_gb, device="cpu")
    nsec = len(_trs_sectors(cell, kpts)[1])
    nip = int(40 * cell.nao_nr())
    return [plan_sharded(df, n, nsec, nip) for n in ranks]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--backend", default=None,
                    help="nccl (the default on CUDA) or gloo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (each rank its local GPU) or cpu")
    ap.add_argument("--plan", action="store_true",
                    help="print plan_sharded at the production shapes")
    ap.add_argument("--torchrun", action="store_true",
                    help="this process is one rank that torchrun started")
    a = ap.parse_args(argv)
    if a.plan:
        for plan in production_plans():
            print(json.dumps(plan))
        return
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("dryrun: CUDA is not available (pass --device cpu)")
    device = None if a.device == "cuda" else a.device
    if a.torchrun:
        from fftisdf_tpu_torch.parallel.mesh import make_device_mesh

        res = [run(make_device_mesh(backend=a.backend, device=device))]
    else:
        if device is None and a.nproc > torch.cuda.device_count():
            raise SystemExit(f"--nproc {a.nproc} on "
                             f"{torch.cuda.device_count()} GPU(s): NCCL "
                             "takes one rank per GPU")
        res = spawn(run, a.nproc, backend=a.backend, device=device,
                    threads=2 if device == "cpu" else None)
    for r in res:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
