"""FFT-ISDF with k-point sampling (PyTorch): selection, metric pass, serve.

Counterpart of ``fftisdf_tpu/isdf/kpoint.py`` on its f64 device path.  The
built state is ``(x_k, w_q)``: (nk, nip, nao) interpolation vectors and
(nk, nip, nip) Coulomb metrics, which determine J and K.

- Selection: pivoted Cholesky of the squared pair gram of the AOs on a
  coarse parent mesh ``m0``; the gram is kernel K1
  (:func:`fftisdf_tpu_torch.ops.pair_gram.pair_gram_sq`).
- Metric pass, in its plain form: for each chunk of time-reversal
  canonical momentum sectors the grid is swept in blocks, each block's RHS
  (:func:`_rhs_block`, the stripe trick) is stored for the chunk's sectors,
  and every sector then gets :func:`_sector_wq`: the split ridge operator,
  the FFT of ``g e^{-iqr}``, the PSD Coulomb split and the gram
  ``h h^H``.  Non-canonical sectors are conjugate mirrors.

- Serve: J/K with ``exxdiv=None`` or ``'ewald'`` (the Madelung probe-charge
  correction), and ERIs of momentum-conserving k quadruples.

Not ported yet (``NotImplementedError``): ``m0='auto'`` with densify, the
f32 regime (host-f64 selection, ``select_keep``), omega, truncated kernels
and ``kpts_band``.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.isdf import jk as jk_mod
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.linalg.coulomb import get_coulG_batched
from fftisdf_tpu_torch.linalg.fft import fft3
from fftisdf_tpu_torch.linalg.pivoted_cholesky import pivoted_cholesky
from fftisdf_tpu_torch.linalg.solvers import (finish_apply, half_apply_rows,
                                              half_factor_data,
                                              fitting_half_operator)
from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq
from fftisdf_tpu_torch.pw.poisson import eiqr
from fftisdf_tpu_torch.utils.device import (COMPLEX, REAL, as_tensor,
                                            free_memory_bytes, resolve_device)
from fftisdf_tpu_torch.utils.logging import Logger


class PoolSaturationWarning(UserWarning):
    """Interpolation-point selection is candidate-pool limited: the
    requested compression sits within 10% of the parent grid's numerical
    pair-density rank, so raising ``c0`` buys almost nothing — densify
    ``m0``."""


def _trs_mirror(cell, kpts):
    """Index of -k in the k list (mod G) per k; -1 where unpaired."""
    s = cell.get_scaled_kpts(np.asarray(kpts))
    return np.array([kpt_mod.member(-s[q], s, strict=False)
                     for q in range(len(s))])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- selection
def select_interpolation_points(cell, kpts, m0, c0, select_tol=None,
                                log=None, *, device="cuda"):
    """Pivoted-Cholesky selection of interpolation points on the parent
    mesh ``m0`` (an explicit 3-tuple).

    Returns ``(x_k (nk, nip, nao) tensor, mask (nip,) numpy, rank, m0)``:
    the gram ``x4 = (Re sum_k X_k X_k^H)^2 / nk`` of the parent-mesh AOs is
    pivoted and ``nip = min(nao c0, rank)`` pivots are kept.  Warns with
    :class:`PoolSaturationWarning` when nip is within 10% of the pool's
    numerical rank."""
    if isinstance(m0, str) or m0 is None:
        raise NotImplementedError("m0='auto' (auto-densified selection "
                                  "mesh): pass an explicit m0")
    m0 = tuple(int(v) for v in m0)
    x_k, mask, rank, saturated, ng0, nip = _select_once(
        cell, kpts, m0, c0, select_tol=select_tol, log=log,
        device=resolve_device(device))
    if saturated:
        warnings.warn(
            f"interpolation-point selection is pool-saturated: nip={nip} "
            f"vs parent-grid rank {rank} (ng0={ng0}). Accuracy is limited "
            f"by the m0={m0} candidate pool, not by c0 — increase m0 for "
            "more accuracy.", PoolSaturationWarning, stacklevel=2)
    return x_k, mask, rank, m0


def _select_once(cell, kpts, m0, c0, select_tol, log, device):
    """One selection pass at a fixed parent mesh.  Returns
    (x_k, mask, rank, saturated, ng0, nip)."""
    log = log or Logger()
    t0 = time.perf_counter()
    coords0 = cell.gen_uniform_grids(m0)
    x0 = make_evaluator(cell, kpts=kpts, device=device)(coords0)
    nk, ng0, nao = x0.shape
    # K1 gives |G|^2 / nk^2; times nk this is the JAX CPU path's
    # (Re G)^2 / nk wherever the k-mesh is closed under k -> -k (there
    # Im G = 0).  The pivot threshold is relative, so pivots are unchanged.
    x4 = pair_gram_sq(x0, square=False) * nk
    max_rank = min(int(min(c0, 1e6) * nao), ng0)
    _, piv, rank, hist = pivoted_cholesky(x4, max_rank=max_rank,
                                          tol=select_tol)
    del x4
    piv = piv.cpu().numpy()
    nip = min(int(nao * c0), rank)
    mask = piv[:nip]
    saturated = nip >= 0.9 * rank and rank < max_rank
    if log.verbose >= 3:
        err = float(hist[min(nip, len(hist) - 1)])
        log.info("select_interpolation_points: ng0=%d rank=%d nip=%d "
                 "pivot-residual=%.2e (%.2fs)", ng0, rank, nip, err,
                 time.perf_counter() - t0)
    x_k = x0[:, torch.as_tensor(mask, device=device)].contiguous()
    return x_k, mask, rank, saturated, ng0, nip


# ------------------------------------------------------------- metric pass
def _stripe_quartic(x_k, phase):
    """x4_k[q] via the stripe trick: k -> image space, elementwise square,
    back to k with ``phase.conj()``.  Equals (1/sqrt(nk)) times the normal
    matrix A^q = sum_k x2_k (.) x2_{q-k}; the RHS carries the same scale."""
    nk, nip, _ = x_k.shape
    x2_k = (x_k.conj() @ x_k.transpose(1, 2)).reshape(nk, -1)
    x4_s = torch.square((phase @ x2_k).real).to(phase.dtype)
    return (phase.conj().T @ x4_s).reshape(nk, nip, nip)


def _rhs_block(f_k, x_k, phase, phase_cols):
    """RHS of one grid block for the sectors of ``phase_cols``:
    y (nq, bg, nip).

    ``fx_k = conj(f_k) x_k^T`` per k; the stripe to image space keeps only
    its real part, which is squared; back to the sectors with
    ``phase_cols`` and no conjugate (the y sector label satisfies
    k' = -q - k; derivation in tests/test_stripe_identities.py).  With
    ``phase`` the full (nimg, nk) matrix and ``phase_cols = phase`` this is
    the JAX package's ``_rhs_block``.  On a k-mesh closed under -k the
    caller may pass the canonical half of the k axis in ``f_k``/``x_k``
    with ``phase`` restricted to those columns and weighted 2 for
    conjugate pairs: Re(p_k z_k) is the same for k and -k."""
    nk, bg, _ = f_k.shape
    nip = x_k.shape[1]
    fx_k = torch.matmul(f_k.conj(), x_k.transpose(1, 2)).reshape(nk, -1)
    y_s = phase.real @ fx_k.real
    y_s -= phase.imag @ fx_k.imag
    del fx_k
    y_s.square_()                                        # real (nimg, bg*nip)
    y = torch.complex(phase_cols.real.T @ y_s, phase_cols.imag.T @ y_s)
    return y.reshape(phase_cols.shape[1], bg, nip)


def _sector_wq(x4_q, y_q, coulG_q, eiqr_q, mesh, vol, rcond=1e-10,
               refine=0, col_block=128):
    """One momentum sector's metric w_q (nip, nip) from its normal matrix
    ``x4_q``, its RHS ``y_q`` (ngrid, nip), the Coulomb kernel and the
    e^{iqr} phases.

    w_q = S_q (B_q K_q^T B_q^H) S_q through the split ridge operator
    S_q = H^H H: g = H B_q, then by Parseval g K g^H =
    (vol/ngrid^2) Gf diag(coulG) Gf^H with Gf = FFT[g e^{-iqr}] row-wise,
    and the PSD split h = Gf sqrt(coulG vol/ngrid^2) leaves w = finish(h
    h^H).  Works in the transposed (grid-major) layout: ``y_q`` is
    overwritten (scaled by D), and the FFT runs over column slabs of
    ``col_block`` interpolation points so its workspace stays small."""
    ngrid, nip = y_q.shape
    data = half_factor_data(x4_q, rcond=rcond, refine=refine)
    gt = half_apply_rows(data, y_q)                      # (ngrid, nip) = g^T
    gt.mul_(eiqr_q.conj()[:, None])
    sq = torch.sqrt(coulG_q.abs() * (vol / float(ngrid) ** 2))
    mesh = tuple(int(m) for m in mesh)
    for c0 in range(0, nip, col_block):
        c1 = min(c0 + col_block, nip)
        slab = gt[:, c0:c1].T                            # (cb, ngrid) rows
        gt[:, c0:c1] = (fft3(slab, mesh) * sq[None, :]).T
    # h h^H = gt^T conj(gt) = conj(gt^H gt)
    m = torch.matmul(gt.mH, gt).conj().resolve_conj()
    del gt
    return finish_apply(data, m)


def _sector_wq_reference(x4_q, y_q, coulG_q, eiqr_q, mesh, vol,
                         rcond=1e-10, refine=0):
    """Row-major form of :func:`_sector_wq` through the closure operator
    (the JAX package's ``_sector_wq`` line by line); the test oracle."""
    ngrid = y_q.shape[0]
    half, finish, _ = fitting_half_operator(x4_q, rcond=rcond,
                                            refine=refine)
    g = half(y_q.T)
    gf = fft3(g * eiqr_q.conj()[None, :], mesh)
    h = gf * torch.sqrt(coulG_q.abs() * (vol / float(ngrid) ** 2))
    return finish(h @ h.mH)


def _trs_sectors(cell, kpts):
    """(mirror, qsel): each sector's -q partner and the canonical sectors
    q <= mirror(q).  A mesh without full -k pairing keeps every sector."""
    nk = len(kpts)
    mirror = _trs_mirror(cell, kpts)
    if (mirror < 0).any():
        mirror = np.arange(nk)
    qsel = np.array([q for q in range(nk) if q <= mirror[q]])
    return mirror, qsel


class FFTISDF:
    """Interpolative separable density fitting with FFT Coulomb kernels.

    Configure, :meth:`build`, then :meth:`get_jk`.  Knobs follow the JAX
    package's ``FFTISDF``:

      c0             interpolation points per AO
      m0             parent (selection) mesh, an explicit 3-tuple
      solver         'ridge' (the only ported fitting solver)
      rcond, refine  ridge regularisation and refinement steps
      select_tol     pivot threshold (None: n eps max diag)
      max_memory_gb  byte budget of the metric pass; None sizes it from
                     the device's free memory
      device         'cuda' (the default) or 'cpu'
    """

    def __init__(self, cell, kpts, c0=20.0, m0=(15, 15, 15), solver="ridge",
                 rcond=1e-10, refine=0, select_tol=None, max_memory_gb=None,
                 verbose=3, *, device="cuda"):
        if isinstance(m0, str) or m0 is None:
            raise NotImplementedError("m0='auto' (auto-densified selection "
                                      "mesh): pass an explicit m0")
        if solver != "ridge":
            raise NotImplementedError(f"solver {solver!r}: only 'ridge' is "
                                      "ported")
        self.device = resolve_device(device)
        self.cell = cell
        self.kpts = np.asarray(kpts)
        self.kmesh = np.asarray(kpt_mod.kpts_to_kmesh(cell, self.kpts))
        self.c0 = float(c0)
        self.m0 = tuple(int(v) for v in m0)
        self.solver = solver
        self.rcond = float(rcond)
        self.refine = int(refine)
        self.select_tol = select_tol
        self.max_memory_gb = max_memory_gb
        self._log = Logger(verbose)
        self.x_k = None
        self.wq = None
        self.mask = None
        self._ws = None
        self._madelung = None
        self._s1e = None
        self._kconserv2 = None
        self._kconserv3 = None
        self.timings = {}
        self.nchunks = 0

    @classmethod
    def from_numpy(cls, cell, kpts, x_k, wq, mask, m0, *, device="cuda",
                   **kw):
        """A built object from host arrays (e.g. the JAX package's state)."""
        df = cls(cell, kpts, m0=m0, device=device, **kw)
        df.x_k = as_tensor(x_k, df.device, COMPLEX)
        df.wq = as_tensor(wq, df.device, COMPLEX)
        df.mask = np.asarray(mask)
        return df

    @property
    def nkpt(self):
        return len(self.kpts)

    @property
    def nip(self):
        return None if self.x_k is None else self.x_k.shape[1]

    @property
    def phase(self):
        return kpt_mod.get_phase(self.cell, self.kpts, self.kmesh)

    def kconserv2(self):
        if self._kconserv2 is None:
            self._kconserv2 = kpt_mod.get_kconserv2(self.cell, self.kpts)
        return self._kconserv2

    def kconserv3(self):
        if self._kconserv3 is None:
            self._kconserv3 = kpt_mod.get_kconserv3(self.cell, self.kpts)
        return self._kconserv3

    # ------------------------------------------------------------------
    def build(self, mask=None):
        """Select the interpolation points, then run the metric pass.

        ``mask``: indices into the ``m0`` parent mesh of interpolation
        points chosen elsewhere (e.g. by the JAX package's selection); when
        given, selection is skipped and x_k is evaluated at those points.
        Selection on a symmetric cell meets exact ties between symmetry-
        equivalent points, which two implementations break differently, so
        a comparison of the two packages past selection needs the same
        mask."""
        dev = self.device
        t_all = time.perf_counter()
        if mask is None:
            self.x_k, self.mask, _, self.m0 = select_interpolation_points(
                self.cell, self.kpts, self.m0, self.c0,
                select_tol=self.select_tol, log=self._log, device=dev)
        else:
            self.mask = np.asarray(mask, dtype=np.int64)
            coords0 = self.cell.gen_uniform_grids(self.m0)[self.mask]
            self.x_k = make_evaluator(self.cell, kpts=self.kpts,
                                      device=dev)(coords0)
        _sync(dev)
        t_sel = time.perf_counter() - t_all
        self.timings = {}
        self.wq = self._metric_pass()
        self._ws = None
        _sync(dev)
        total = time.perf_counter() - t_all
        self.timings.update(select_s=t_sel, metric_s=total - t_sel,
                            build_s=total)
        self._log.info("build: total %.2fs", total)
        return self

    def _memory_plan(self, nsec, nk_sw, nip, nao, ngrid):
        """(qchunk, blk, budget bytes) of the metric pass.

        The port's model, in bytes (itemsize 16 for complex128):
          persistent  x_k, x4_k (nk nip^2), w_q (nsec + nk nip^2), the
                      chunk's factors, eiqr and the Coulomb kernels;
          plane       one sector's RHS y_q, ngrid nip 16; a chunk of nq
                      sectors holds nq planes through its sweep;
          sweep       per grid point of a block: the projected pairs on the
                      swept k axis (complex, plus real/imag copies), the
                      real image stripe and its products, the chunk's
                      complex RHS rows: nip (32 nk_sw + 24 nimg + 32 nq)
                      + AO values;
          solve       the g plane of one sector (the y plane it came from
                      is released right after) plus three FFT slabs of 128
                      columns and a few nip^2 temporaries.
        The budget is ``max_memory_gb`` or 90% of the free device memory
        (``torch.cuda.mem_get_info`` on CUDA).  Sweep temporaries get at
        most a quarter of it and 4 GB; the sector chunk takes what is
        left."""
        nk = self.nkpt
        if self.max_memory_gb is not None:
            budget = float(self.max_memory_gb) * 1e9
        else:
            budget = 0.9 * free_memory_bytes(self.device)
        plane = ngrid * nip * 16
        persist = ((3 * nk + nsec + 4) * nip * nip + nk * nip * nao
                   + 3 * nsec * ngrid) * 16
        solve = plane + 3 * 128 * ngrid * 16 + 6 * nip * nip * 16

        def sweep_bytes(nq, blk):
            return blk * (nip * (32 * nk_sw + 24 * nk + 32 * nq)
                          + 16 * nk_sw * nao)

        sweep_cap = min(4e9, 0.25 * budget)
        blk = int(max(64, min(ngrid, sweep_cap // max(sweep_bytes(nsec, 1),
                                                       1))))
        room = budget - persist - max(sweep_bytes(nsec, blk), solve)
        qchunk = int(max(1, min(nsec, room // plane)))
        return qchunk, blk, budget

    def _metric_pass(self):
        """RHS grid sweep + per-sector solve / FFT kernel / gram, chunked
        over canonical momentum sectors.  Returns w_q (nk, nip, nip)."""
        cell, kpts, dev, log = self.cell, self.kpts, self.device, self._log
        x_k = self.x_k
        nk, nip, nao = x_k.shape
        coords = cell.gen_uniform_grids()
        ngrid = coords.shape[0]
        mesh = tuple(int(m) for m in cell.mesh)
        vol = float(cell.vol)
        phase = torch.as_tensor(self.phase, dtype=COMPLEX, device=dev)

        # w_{-q} = conj(w_q) for real AOs: only canonical sectors are
        # solved.  The sweep's AO evaluation and projection run on the
        # canonical half of the k axis too, conjugate pairs weighted 2 in
        # the stripe phase (see _rhs_block).
        mirror, qsel = _trs_sectors(cell, kpts)
        nsec = len(qsel)
        ksel = qsel
        kw = np.where(mirror[ksel] == ksel, 1.0, 2.0)
        ksel_t = torch.as_tensor(ksel, device=dev)
        x_sw = x_k[ksel_t]
        phase_sw = phase[:, ksel_t] * torch.as_tensor(kw, dtype=REAL,
                                                      device=dev)
        fn = make_evaluator(cell, kpts=kpts[ksel], device=dev)

        qchunk, blk, budget = self._memory_plan(nsec, len(ksel), nip, nao,
                                                ngrid)
        log.info("build: nk=%d nip=%d nao=%d ngrid=%d sectors=%d "
                 "(qchunk=%d blk=%d, plane %.2f GB, budget %.1f GB)", nk,
                 nip, nao, ngrid, nsec, qchunk, blk,
                 ngrid * nip * 16 / 1e9, budget / 1e9)

        x4_k = _stripe_quartic(x_k, phase)
        qsel_t = torch.as_tensor(qsel, device=dev)
        kq = torch.as_tensor(kpts[qsel], dtype=REAL, device=dev)
        coulG = get_coulG_batched(
            cell, kq, torch.as_tensor(cell.get_Gv(mesh), dtype=REAL,
                                      device=dev))
        coords_t = torch.as_tensor(coords, dtype=REAL, device=dev)
        ph = eiqr(coords_t, kq)
        wq_sel = torch.empty((nsec, nip, nip), dtype=COMPLEX, device=dev)

        # stage times: one device sync after each chunk's sweep and solves
        t0 = time.perf_counter()
        stage = {"sweep_s": 0.0, "solve_s": 0.0}
        nchunks = 0
        for q0 in range(0, nsec, qchunk):
            q1 = min(q0 + qchunk, nsec)
            nchunks += 1
            t_c = time.perf_counter()
            phase_cols = phase[:, qsel_t[q0:q1]]
            ys = [torch.empty((ngrid, nip), dtype=COMPLEX, device=dev)
                  for _ in range(q1 - q0)]
            for g0 in range(0, ngrid, blk):
                g1 = min(g0 + blk, ngrid)
                y = _rhs_block(fn(coords_t[g0:g1]), x_sw, phase_sw,
                               phase_cols)
                for i, y_q in enumerate(ys):
                    y_q[g0:g1] = y[i]
                del y
            _sync(dev)
            stage["sweep_s"] += time.perf_counter() - t_c
            t_c = time.perf_counter()
            for i in range(q1 - q0):
                iq = q0 + i
                y_q = ys[i]
                ys[i] = None      # the solve overwrites and releases it
                wq_sel[iq] = _sector_wq(x4_k[qsel[iq]], y_q, coulG[iq],
                                        ph[iq], mesh, vol,
                                        rcond=self.rcond, refine=self.refine)
                del y_q
            _sync(dev)
            stage["solve_s"] += time.perf_counter() - t_c
        self.nchunks = nchunks
        self.timings.update(stage)
        # scatter canonical sectors and their conjugate mirrors.  w_q is
        # not symmetrised: on even FFT meshes the discrete Coulomb operator
        # carries a small skew part that the exact oracle shares.
        pos = {int(q): i for i, q in enumerate(qsel)}
        order = torch.as_tensor(
            [pos.get(q, pos.get(int(mirror[q]))) for q in range(nk)],
            device=dev)
        flip = torch.as_tensor([q not in pos for q in range(nk)],
                               device=dev)
        wq = wq_sel[order]
        wq = torch.where(flip[:, None, None], wq.conj(), wq)
        log.info("build: %d/%d sectors solved in %d chunk(s) (%.2fs)", nsec,
                 nk, nchunks, time.perf_counter() - t0)
        return wq

    # ------------------------------------------------------------------
    def get_ws(self):
        """Image-space Coulomb metric ws = Re(phase @ wq) sqrt(nk), cached:
        the density-independent state of the K serve."""
        if self._ws is None:
            self._ws = jk_mod.wq_to_ws(self.wq, self.kmesh)
        return self._ws

    def get_jk(self, dm_kpts, with_j=True, with_k=True, exxdiv=None,
               omega=None, kpts_band=None):
        """(vj, vk) tensors on the object's device for ``dm_kpts``
        (nk, nao, nao) or (nset, nk, nao, nao); ``None`` for a skipped
        part.  ``exxdiv='ewald'`` adds the Madelung probe-charge term
        to vk."""
        if omega is not None and float(omega) != 0.0:
            raise NotImplementedError("range separation (omega)")
        if exxdiv not in (None, "ewald"):
            raise NotImplementedError(f"exxdiv={exxdiv!r} not supported")
        if kpts_band is not None:
            raise NotImplementedError("kpts_band")
        if self.x_k is None:
            raise RuntimeError("call build() first")
        dm = as_tensor(dm_kpts, self.device, COMPLEX)
        single = dm.ndim == 3
        if single:
            dm = dm[None]
        vj = jk_mod.get_j_kpts(self.x_k, self.wq[0], dm) if with_j else None
        vk = (jk_mod.get_k_kpts_img(self.x_k, self.get_ws(), dm, self.kmesh)
              if with_k else None)
        if exxdiv == "ewald" and with_k:
            vk = jk_mod.add_ewald_exx(vk, self.get_ovlp(), dm,
                                      self.madelung())
        if single:
            vj = None if vj is None else vj[0]
            vk = None if vk is None else vk[0]
        return vj, vk

    def madelung(self):
        """Probe-charge Madelung constant of the BvK supercell (cached)."""
        if self._madelung is None:
            from fftisdf_tpu_torch.scf.integrals import madelung

            self._madelung = madelung(self.cell, self.kmesh)
        return self._madelung

    def get_ovlp(self):
        """Overlap S_k on the FFT-grid quadrature (cached; streamed)."""
        if self._s1e is None:
            from fftisdf_tpu_torch.scf.integrals import get_ovlp_kpts

            self._s1e = get_ovlp_kpts(self.cell, self.kpts,
                                      device=self.device)
        return self._s1e

    def get_eri(self, kidx):
        """ERI tensor (nao, nao, nao, nao) of the momentum-conserving
        quadruple ``kidx = (k1, k2, k3, k4)``."""
        from fftisdf_tpu_torch.isdf.eri import assemble_eri

        k1, k2, k3, k4 = (int(k) for k in kidx)
        if self.kconserv3()[k1, k2, k3] != k4:
            raise ValueError(f"quadruple {kidx} does not conserve momentum")
        q = int(self.kconserv2()[k1, k2])
        x = self.x_k
        return assemble_eri(self.wq[q], x[k1], x[k2], x[k3], x[k4])

    # ------------------------------------------------------------------
    def save(self, path):
        from fftisdf_tpu_torch.utils import serialization

        serialization.save_isdf_state(path, self)

    @classmethod
    def load(cls, path, cell, kpts, *, device="cuda"):
        from fftisdf_tpu_torch.utils import serialization

        return serialization.load_isdf_state(path, cell, kpts, device=device)

