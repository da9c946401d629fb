"""Sharded ISDF build and J/K serve over a mesh of ranks.

Counterpart of ``fftisdf_tpu/parallel/build.py``.  Layout:

  sweep     the grid is split over the ranks; each rank sweeps its grid
            points for every sector of a chunk (``FFTISDF._sweep_rows``,
            the single-device pass's own sweep)
  exchange  ONE all-to-all per chunk turns the (nq, ngrid_loc, nip) RHS
            into (nq_loc, ngrid, nip): each rank receives whole planes of
            its own sectors
  solve     each rank runs ``FFTISDF._solve_sector`` (fit, FFT, kernel
            split, gram: ``_sector_wq``) on its sectors, with no
            communication
  serve     J through the q = 0 metric, broadcast once by the rank that
            owns it; K through the image-space gemm serve with the image
            axis of ``ws`` split over the ranks and the partial vk
            all-reduced.  ``ws`` comes from the sector shards through a
            second exchange (to a layout of interpolation-point rows, where
            the k-axis transform is local) and a third (rows to images),
            once per metric, cached like ``FFTISDF.get_ws``.

One implementation, two drivers: the sweep, the sector solve, the memory
model (``FFTISDF._memory_plan``, per rank) and the time-reversal halving
(w_{-q} = conj(w_q); only canonical sectors are swept, exchanged and
solved, and a rank that solves q keeps its mirror too) are the
single-device pass's own.  Splits may be uneven, so no sector is padded
and every rank keeps the static per-sector ``neg_cols`` of a truncated
kernel.

The built metric is a :class:`SectorShards`: a rank holds its sectors, and
``wq[q]`` broadcasts sector q from its owner, which every rank must ask
for together (each rank runs the same program).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from fftisdf_tpu_torch.isdf import jk as jk_mod
from fftisdf_tpu_torch.isdf.kpoint import _stripe_quartic, _sync
from fftisdf_tpu_torch.parallel.mesh import split
from fftisdf_tpu_torch.utils.device import as_tensor


class SectorShards:
    """A metric w_q (nk, nip, nip) split over a mesh by momentum sector.

    ``local`` (len(qs), nip, nip) holds the sectors ``qs`` of this rank (in
    increasing q); ``owner[q]`` is the rank that holds q.  ``shards[q]``
    is sector q on every rank (broadcast from its owner; q = 0, which the
    J serve reads every call, is kept once fetched)."""

    def __init__(self, local, qs, owner, mesh):
        self.local = local
        self.qs = np.asarray(qs, dtype=np.int64)
        self.owner = np.asarray(owner, dtype=np.int64)
        self.mesh = mesh
        nip = local.shape[-1]
        self.shape = (len(self.owner), nip, nip)
        self.dtype = local.dtype
        self.device = local.device
        self._slot = {int(q): i for i, q in enumerate(self.qs)}
        self._w0 = None
        self._img = {}

    @classmethod
    def from_full(cls, wq, mesh):
        """Shards of a replicated metric: contiguous sector blocks."""
        off = split(wq.shape[0], mesh.size)
        owner = np.repeat(np.arange(mesh.size), np.diff(off))
        q0, q1 = mesh.owned(wq.shape[0])
        return cls(wq[q0:q1], np.arange(q0, q1), owner, mesh)

    def qs_of(self, r):
        return np.flatnonzero(self.owner == r)

    def __getitem__(self, q):
        q = int(q)
        if q == 0 and self._w0 is not None:
            return self._w0
        src = int(self.owner[q])
        w = (self.local[self._slot[q]] if self.mesh.rank == src
             else torch.empty(self.shape[1:], dtype=self.dtype,
                              device=self.device))
        w = self.mesh.broadcast(w, src=src)
        if q == 0:
            self._w0 = w
        return w

    def full(self):
        """The whole metric on every rank (an all-gather)."""
        counts = [len(self.qs_of(r)) for r in range(self.mesh.size)]
        flat = self.mesh.all_gather(self.local, counts)
        order = np.concatenate([self.qs_of(r)
                                for r in range(self.mesh.size)])
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        out[torch.as_tensor(order, device=self.device)] = flat
        return out

    def image_block(self, kmesh):
        """This rank's block of the image-space metric ws = Re(ifft_k w_q)
        nk (``isdf.jk.wq_to_ws``): (nimg_loc, nip, nip) real, the images
        ``mesh.owned(nk)``.  The k-axis transform needs every sector of an
        element, so the sectors go to a layout of interpolation-point rows
        first (each rank: all q of its rows), the transform runs there, and
        the result goes to the image layout.  Cached."""
        key = tuple(int(m) for m in kmesh)
        if key in self._img:
            return self._img[key]
        mesh, (nk, nip, _) = self.mesh, self.shape
        size, r = mesh.size, mesh.rank
        roff = split(nip, size)
        qs = [self.qs_of(j) for j in range(size)]
        recv = mesh.exchange(
            [self.local[:, roff[j]:roff[j + 1]] for j in range(size)],
            [(len(qs[j]), roff[r + 1] - roff[r], nip) for j in range(size)])
        rows = torch.empty((nk, roff[r + 1] - roff[r], nip), dtype=self.dtype,
                           device=self.device)
        for j in range(size):
            rows[torch.as_tensor(qs[j], device=self.device)] = recv[j]
        del recv
        ws_rows = jk_mod.wq_to_ws(rows, kmesh)        # (nimg, nip_loc, nip)
        del rows
        ioff = split(nk, size)
        recv = mesh.exchange(
            [ws_rows[ioff[j]:ioff[j + 1]] for j in range(size)],
            [(ioff[r + 1] - ioff[r], roff[j + 1] - roff[j], nip)
             for j in range(size)])
        self._img[key] = torch.cat(recv, dim=1) if size > 1 else recv[0]
        return self._img[key]


def plan_sharded(df, ndev, nsec, nip, ngrid=None):
    """Sizing plan of a sharded metric pass per rank, from the
    single-device memory model (``FFTISDF._memory_plan`` with ``ndev``):
    grid points per rank, the sweep's grid block, the sector chunk (a
    multiple of ``ndev`` where there are that many sectors), the chunk
    count, one RHS plane and the planes a rank holds through a chunk's
    exchange (its sweep share and its received planes), in GB.  The grid
    is split by points, unevenly where it must; the JAX plan's row slabs
    have no counterpart (``_sector_wq`` transforms 128-column slabs of
    one plane)."""
    ngrid = int(np.prod(df.cell.mesh)) if ngrid is None else int(ngrid)
    nao = df.cell.nao_nr()
    nk_sw = nsec if df.use_trs else df.nkpt
    qchunk, blk, budget = df._memory_plan(nsec, nk_sw, nip, nao, ngrid,
                                          ndev=ndev)
    plane_gb = ngrid * nip * df.cdtype.itemsize / 1e9
    goff = split(ngrid, ndev)
    qloc = -(-qchunk // ndev)
    planes = (qchunk * plane_gb if ndev == 1
              else (qchunk * plane_gb * int(np.diff(goff).max()) / ngrid
                    + qloc * plane_gb))
    return dict(ndev=int(ndev), nsec=int(nsec), nip=int(nip),
                ngrid=ngrid, ngrid_loc=int(np.diff(goff).max()), blk=int(blk),
                qchunk=int(qchunk), nchunks=int(-(-nsec // qchunk)),
                plane_gb=plane_gb, planes_per_device_gb=planes,
                budget_gb=budget / 1e9)


def build_wq_sharded(df, mesh, omega=0.0):
    """This rank's share of the metric pass of ``df`` (its x_k, solver,
    rcond, refine, use_trs, trunc, blksize and per-rank ``max_memory_gb``,
    all as the single-device pass reads them) for the kernel ``omega``
    selects: a :class:`SectorShards`.  ``df.timings`` gains the chunk
    clocks of the single pass (``sweep_s``, ``solve_s``) and the exchange's
    ``a2a_s`` / ``a2a_bytes`` (this rank's)."""
    dev, cdt, log = df.device, df.cdtype, df._log
    nk, nip, nao = df.x_k.shape
    size, r = mesh.size, mesh.rank
    p = df._pass_inputs(omega)
    ngrid, qsel, mirror = p.ngrid, p.qsel, p.mirror
    nsec = len(qsel)
    plan = plan_sharded(df, size, nsec, nip, ngrid)
    qchunk, blk = plan["qchunk"], plan["blk"]
    goff = split(ngrid, size)
    g0, g1 = int(goff[r]), int(goff[r + 1])
    log.info("build_sharded: nk=%d (canonical %d) nip=%d ngrid=%d ndev=%d "
             "qchunk=%d blk=%d omega=%g (planes/device %.2f GB/chunk)", nk,
             nsec, nip, ngrid, size, qchunk, blk, omega,
             plan["planes_per_device_gb"])
    a2a_s0, a2a_b0 = mesh.a2a_s, mesh.a2a_bytes
    t0 = time.perf_counter()
    stage = {"sweep_s": 0.0, "solve_s": 0.0}
    x4_k = _stripe_quartic(df.x_k, p.phase)
    solved = {}                                   # canonical position -> w
    owner = np.empty(nk, dtype=np.int64)
    nchunks = 0
    for q0 in range(0, nsec, qchunk):
        q1 = min(q0 + qchunk, nsec)
        nchunks += 1
        qoff = q0 + split(q1 - q0, size)
        for j in range(size):
            for pos in range(qoff[j], qoff[j + 1]):
                owner[qsel[pos]] = owner[mirror[qsel[pos]]] = j
        t_c = time.perf_counter()
        send = torch.empty((q1 - q0, g1 - g0, nip), dtype=cdt, device=dev)
        df._sweep_rows(p, q0, q1, g0, g1, blk, send)
        _sync(dev)
        stage["sweep_s"] += time.perf_counter() - t_c
        recv = mesh.exchange(
            [send[qoff[j] - q0:qoff[j + 1] - q0] for j in range(size)],
            [(qoff[r + 1] - qoff[r], goff[j + 1] - goff[j], nip)
             for j in range(size)])
        del send
        t_c = time.perf_counter()
        for i, pos in enumerate(range(qoff[r], qoff[r + 1])):
            y_q = (recv[0][i] if size == 1
                   else torch.cat([piece[i] for piece in recv]))
            solved[pos] = df._solve_sector(p, x4_k, pos, y_q)
            del y_q
        del recv
        _sync(dev)
        stage["solve_s"] += time.perf_counter() - t_c
    own = {}
    for pos, w in solved.items():
        q = int(qsel[pos])
        own[q] = w
        if int(mirror[q]) != q:
            own[int(mirror[q])] = w.conj().resolve_conj()
    qs = sorted(own)
    local = (torch.stack([own[q] for q in qs]) if qs else
             torch.empty((0, nip, nip), dtype=cdt, device=dev))
    del own, solved
    df.nchunks = nchunks
    df.timings.update(stage, a2a_s=mesh.a2a_s - a2a_s0,
                      a2a_bytes=mesh.a2a_bytes - a2a_b0)
    df.plan = plan
    log.info("build_sharded: %d/%d sectors solved over %d rank(s) in %d "
             "chunk(s) (%.2fs)", nsec, nk, size, nchunks,
             time.perf_counter() - t0)
    return SectorShards(local, qs, owner, mesh)


def build_sharded(df, mesh, mask=None):
    """Sharded counterpart of ``FFTISDF.build``: selection (or x_k at the
    given ``mask``) runs once, on rank 0 and on its device (through kernel
    K1 on a float64 build); its mask, m0 and x_k are broadcast, so x_k is
    the same on every rank; then the sharded metric pass.  ``df`` must live
    on the mesh's device.  Afterwards ``df.get_jk`` (and the SCF drivers
    that call it) serve through the mesh, and every rank must make the
    same calls."""
    if df.device != mesh.device:
        raise ValueError(f"df lives on {df.device}, the mesh rank on "
                         f"{mesh.device}")
    dev = df.device
    t_all = time.perf_counter()
    nk, nao = df.nkpt, df.cell.nao_nr()
    if mesh.rank == 0:
        x_k, mask, m0 = df._select(mask)
        head = torch.as_tensor([x_k.shape[1], *m0], dtype=torch.int64,
                               device=dev)
    else:
        head = torch.zeros(4, dtype=torch.int64, device=dev)
    head = mesh.broadcast(head)
    nip, m0 = int(head[0]), tuple(int(v) for v in head[1:])
    if mesh.rank != 0:
        x_k = torch.empty((nk, nip, nao), dtype=df.cdtype, device=dev)
        mask = np.zeros(nip, dtype=np.int64)
    mask = mesh.broadcast(torch.as_tensor(np.asarray(mask, dtype=np.int64),
                                          device=dev))
    df.x_k = mesh.broadcast(x_k)
    df.mask, df.m0 = mask.cpu().numpy(), m0
    _sync(dev)
    t_sel = time.perf_counter() - t_all
    df.dev_mesh = mesh
    df.timings = {}
    df._wq_omega = {}
    df._ws = None
    df.wq = build_wq_sharded(df, mesh)
    _sync(dev)
    total = time.perf_counter() - t_all
    df.timings.update(select_s=t_sel, metric_s=total - t_sel, build_s=total)
    df._log.info("build_sharded: total %.2fs", total)
    return df


def get_jk_sharded(df, dm_kpts, mesh):
    """(vj, vk) of ``dm_kpts`` (nk, nao, nao) or (nset, nk, nao, nao) on
    every rank, served over the mesh: a state built by
    :func:`build_sharded` on this mesh serves through ``df.get_jk``; a
    state built on one device (replicated on every rank) is split into
    contiguous sector shards first (cached on ``df``)."""
    if df.dev_mesh is mesh:
        return df.get_jk(dm_kpts)
    shards = getattr(df, "_serve_shards", None)
    if shards is None or shards.mesh is not mesh:
        shards = df._serve_shards = SectorShards.from_full(df.wq, mesh)
    dm = as_tensor(dm_kpts, df.device, df.cdtype)
    single = dm.ndim == 3
    if single:
        dm = dm[None]
    vj = jk_mod.get_j_kpts(df.x_k, shards[0], dm)
    vk = jk_mod.get_k_kpts_img(df.x_k, shards.image_block(df.kmesh), dm,
                               df.kmesh, mesh=mesh)
    return (vj[0], vk[0]) if single else (vj, vk)


def gather_wq(df):
    """The whole metric of a sharded ``df`` on every rank."""
    return df.wq.full() if df.dev_mesh is not None else df.wq
