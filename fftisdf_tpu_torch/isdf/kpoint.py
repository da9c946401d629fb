"""FFT-ISDF with k-point sampling (PyTorch): selection, metric pass, serve.

Counterpart of ``fftisdf_tpu/isdf/kpoint.py``.  The built state is
``(x_k, w_q)``: (nk, nip, nao) interpolation vectors and (nk, nip, nip)
Coulomb metrics, which determine J and K.

- Selection: pivoted Cholesky of the squared pair gram of the AOs on a
  coarse parent mesh ``m0`` (explicit, or ``'auto'``: derived from a cutoff
  and densified while the pool saturates).  Two routes: in the build dtype
  through kernel K1 (:func:`fftisdf_tpu_torch.ops.pair_gram.pair_gram_sq`)
  and the dense pivoted Cholesky, or in float64 through the matrix-free
  blocked factorisation, which a float32 build takes by default because
  pivot ordering degrades in float32.  Both run on the object's device.
- Metric pass, in its plain form: for each chunk of time-reversal
  canonical momentum sectors the grid is swept in blocks, each block's RHS
  (:func:`_rhs_block`, the stripe trick) is stored for the chunk's sectors,
  and every sector then gets :func:`_sector_wq`: the split fitting operator
  (ridge, or the eigh family), the FFT of ``g e^{-iqr}``, the split of the
  Coulomb kernel (bare, range-separated or truncated) and the gram
  ``h h^H``.  Non-canonical sectors are conjugate mirrors.  A state built
  over a mesh of ranks (``parallel.build``) runs the same pieces
  (:meth:`FFTISDF._pass_inputs`, ``_sweep_rows``, ``_solve_sector``,
  ``_memory_plan``) on its share, and serves through the mesh.
- Serve: J/K with ``exxdiv=None`` or ``'ewald'`` (the Madelung probe-charge
  correction, of the truncated kernel when there is one), with ``omega``
  from a screened metric over the same interpolation basis, at band
  k-points (``kpts_band``: per-pair re-fits, ``isdf.bands``), and ERIs of
  momentum-conserving k quadruples.

Everything runs in the build ``dtype``: float64 (the default on every
device) or float32 (the JAX package's accelerator default).

``NotImplementedError``, as in the JAX package: ``exxdiv`` with ``omega``,
``omega`` with ``kpts_band``, and ``exxdiv`` with ``kpts_band`` (the SCF
layer applies that correction itself, at mesh points).
"""
from __future__ import annotations

import contextlib
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.isdf import jk as jk_mod
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.linalg.coulomb import get_coulG_batched, trunc_for_cell
from fftisdf_tpu_torch.linalg.fft import fft3
from fftisdf_tpu_torch.linalg.pivoted_cholesky import (
    pivot_selection, pivoted_cholesky, pivoted_cholesky_pairgram)
from fftisdf_tpu_torch.linalg.solvers import (finish_apply, half_apply_rows,
                                              half_factor_data,
                                              fitting_half_operator)
from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq
from fftisdf_tpu_torch.pw.poisson import eiqr
from fftisdf_tpu_torch.utils.device import (as_tensor, free_memory_bytes,
                                            real_complex, resolve_device)
from fftisdf_tpu_torch.utils import profiling
from fftisdf_tpu_torch.utils.logging import Logger

# Selection in float64 inside a float32 build: the pool it accepts is
# capped by the device's free memory (:func:`select_f64_max_ng0`) and by
# this ceiling (64^3).  Past the cap selection runs in the build dtype,
# whose pivot ordering is what the float64 route exists to avoid, so the
# densify loop of m0='auto' never crosses it.
SELECT_F64_MAX_NG0 = 262144


def select_f64_max_ng0(cell, kpts, c0, use_trs=True, *, device="cuda"):
    """Largest selection pool (grid points) the float64 route accepts on
    ``device``: half of its free memory over the bytes a pool point costs,
    which are the (probe, ng0) float64 factor with one candidate block, and
    the (ng0, 2 nku nao) float64 columns held as the evaluator's complex
    values, their weighted copy and its real and imaginary planes."""
    device = resolve_device(device)
    nk = len(kpts)
    nao = cell.nao_nr()
    nku = nk
    if use_trs:
        mirror = _trs_mirror(cell, kpts)
        if not (mirror < 0).any():
            nku = sum(1 for k in range(nk) if k <= mirror[k])
    probe = int(min(c0, 1e6) * nao * 1.15) + 8
    per_point = 8 * (probe + 96) + 4 * 16 * nku * nao
    cap_mem = 0.5 * free_memory_bytes(device) / per_point
    return int(min(SELECT_F64_MAX_NG0, cap_mem))


class PoolSaturationWarning(UserWarning):
    """Interpolation-point selection is candidate-pool limited: the
    requested compression sits within 10% of the parent grid's numerical
    pair-density rank, so raising ``c0`` buys almost nothing — densify
    ``m0`` (or use ``m0='auto'``, which densifies itself)."""


_saturation_warned = set()   # one warning per (m0, nip) per process


def auto_selection_mesh(cell, nip_target, pool_factor=2.5, k0=None,
                        floor=(15, 15, 15)):
    """Cutoff-derived, basis-scaled selection (parent) mesh.

    - ``k0`` given: ``cell.cutoff_to_mesh(k0)``, no floor.
    - ``k0=None``: the smallest cutoff whose mesh carries at least
      ``pool_factor * nip_target`` candidate points, so that the pivoted
      Cholesky's pool is not the accuracy limiter, elementwise-maxed with
      ``floor`` so that small systems keep the dense default mesh.

    Deriving the mesh through ``cutoff_to_mesh`` (not a bare cube root)
    keeps the per-axis density proportional to the reciprocal lattice:
    anisotropic cells get anisotropic pools."""
    if k0 is not None:
        return tuple(int(v) for v in cell.cutoff_to_mesh(float(k0)))
    target = float(pool_factor) * float(nip_target)
    ke_hi = 1.0
    while np.prod(cell.cutoff_to_mesh(ke_hi)) < target and ke_hi < 1e6:
        ke_hi *= 2.0
    ke_lo = ke_hi / 2.0
    for _ in range(40):
        ke_mid = 0.5 * (ke_lo + ke_hi)
        if np.prod(cell.cutoff_to_mesh(ke_mid)) >= target:
            ke_hi = ke_mid
        else:
            ke_lo = ke_mid
    m = np.asarray(cell.cutoff_to_mesh(ke_hi))
    if floor is not None:
        m = np.maximum(m, np.asarray(floor))
    return tuple(int(v) for v in m)


def _is_auto(m0):
    return m0 is None or (isinstance(m0, str) and m0 == "auto")


def densify_mesh(m0):
    """The next parent mesh of a saturated 'auto' pool: each axis times
    2^(1/3), rounded up."""
    return tuple(int(np.ceil(v * 2.0 ** (1.0 / 3.0))) for v in m0)


def _trs_mirror(cell, kpts):
    """Index of -k in the k list (mod G) per k; -1 where unpaired."""
    s = cell.get_scaled_kpts(np.asarray(kpts))
    return np.array([kpt_mod.member(-s[q], s, strict=False)
                     for q in range(len(s))])


def _trs_scatter(w_sel, sel, mirror, device):
    """Full-axis tensor from its canonical entries ``w_sel`` (listed by
    ``sel``): entry q is ``w_sel`` at q's position, or the conjugate of its
    mirror's.  A canonical index with neither raises ``KeyError``."""
    pos = {int(q): i for i, q in enumerate(sel)}
    n = len(mirror)
    order = torch.as_tensor(
        [pos[q] if q in pos else pos[int(mirror[q])] for q in range(n)],
        device=device)
    flip = torch.as_tensor([q not in pos for q in range(n)], device=device)
    w = w_sel[order]
    return torch.where(flip[:, None, None], w.conj(), w)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- selection
def select_interpolation_points(cell, kpts, m0, c0, dtype=None,
                                select_tol=None, log=None, host_f64=None,
                                auto_densify=False, max_densify=2,
                                use_trs=True, keep_tol=None, *,
                                device="cuda"):
    """Pivoted-Cholesky selection of interpolation points on the parent
    mesh ``m0`` (a 3-tuple; ``'auto'`` derives it with
    :func:`auto_selection_mesh` and densifies).

    Returns ``(x_k (nk, nip, nao) tensor, mask (nip,) numpy, rank, m0)``:
    the gram ``x4 = (Re sum_k X_k X_k^H)^2 / nk`` of the parent-mesh AOs is
    pivoted and ``nip = min(nao c0, rank)`` pivots are kept.

    ``host_f64`` (the JAX package's name; here the route runs on
    ``device``): None selects in float64 when ``dtype`` is float32 and the
    pool fits :func:`select_f64_max_ng0`; True and False force the float64
    route or the build-dtype route through K1.

    ``auto_densify=True`` (the ``m0='auto'`` path): while the saturation
    detector fires (nip within 10% of the pool's numerical rank) and
    densifying still buys rank, each axis of the mesh grows by 2^(1/3)
    (pool x2), at most ``max_densify`` times, and selection runs again.
    With an explicit m0 one :class:`PoolSaturationWarning` per (m0, nip) is
    raised instead."""
    device = resolve_device(device)
    log = log or Logger()
    if _is_auto(m0):
        m0 = auto_selection_mesh(cell, c0 * cell.nao_nr())
        auto_densify = True
    m0 = tuple(int(v) for v in m0)
    f64_build = real_complex(dtype)[0] == torch.float64
    prev_rank = -1
    for attempt in range(max_densify + 1):
        x_k, mask, rank, saturated, ng0, nip = _select_once(
            cell, kpts, m0, c0, dtype=dtype, select_tol=select_tol, log=log,
            host_f64=host_f64, use_trs=use_trs, keep_tol=keep_tol,
            device=device)
        if not saturated:
            break
        if rank <= prev_rank:
            # densifying bought no rank: the physical pair-density space
            # is exhausted, not the candidate pool
            break
        prev_rank = rank
        if auto_densify and attempt < max_densify:
            m0_new = densify_mesh(m0)
            ng0_cap = select_f64_max_ng0(cell, kpts, c0, use_trs=use_trs,
                                         device=device)
            if (not f64_build and host_f64 is not True
                    and np.prod(m0_new) > ng0_cap):
                # a denser pool would move selection from float64 to the
                # build dtype, which loses more than the pool gains
                log.info(
                    "select: pool still saturated (nip=%d vs rank %d on "
                    "ng0=%d) but m0 %s -> %s would exceed the float64 "
                    "selection cap (%d points): keeping the float64-"
                    "ordered pool", nip, rank, ng0, m0, m0_new, ng0_cap)
                break
            log.info("select: pool saturated (nip=%d vs rank %d on ng0=%d):"
                     " densifying m0 %s -> %s", nip, rank, ng0, m0, m0_new)
            m0 = m0_new
            continue
        key = (m0, nip)
        if key not in _saturation_warned:
            _saturation_warned.add(key)
            warnings.warn(
                f"interpolation-point selection is pool-saturated: nip={nip} "
                f"vs parent-grid rank {rank} (ng0={ng0}). Accuracy is "
                f"limited by the m0={m0} candidate pool, not by c0 — "
                "increase m0 (or use m0='auto') for more accuracy.",
                PoolSaturationWarning, stacklevel=2)
        break
    return x_k, mask, rank, m0


def _select_once(cell, kpts, m0, c0, dtype=None, select_tol=None, log=None,
                 host_f64=None, use_trs=True, keep_tol=None, *, device):
    """One selection pass at a fixed parent mesh.  Returns
    (x_k, mask, rank, saturated, ng0, nip)."""
    log = log or Logger()
    t0 = time.perf_counter()
    rdt, cdt = real_complex(dtype)
    f64_build = rdt == torch.float64
    kpts = np.asarray(kpts)
    nk = len(kpts)
    coords0 = cell.gen_uniform_grids(m0)
    ng0 = coords0.shape[0]
    nao = cell.nao_nr()
    if host_f64 is None:
        # pivot ordering degrades in float32: the greedy Schur diagonal is
        # noise past the first few hundred pivots, and the scrambled tail
        # picks near-duplicate points that ill-condition the fit
        host_f64 = (not f64_build
                    and ng0 <= select_f64_max_ng0(cell, kpts, c0,
                                                  use_trs=use_trs,
                                                  device=device))
    max_rank = min(int(min(c0, 1e6) * nao), ng0)
    ksel = mirror = None
    if host_f64:
        # time-reversal halving (x_{-k} = conj(x_k), exact for real AOs):
        # only the canonical k half is evaluated, conjugate pairs weigh 2
        # in the gram (their real parts are equal), and the full-k x at the
        # selected points is a conjugate scatter.  use_trs=False keeps
        # every k.
        mirror = _trs_mirror(cell, kpts)
        if use_trs and not (mirror < 0).any():
            ksel = np.array([k for k in range(nk) if k <= mirror[k]])
        if ksel is None or len(ksel) == nk:
            ksel, wk = None, np.ones(nk)
        else:
            wk = np.where(mirror[ksel] == ksel, 1.0, 2.0)
        with profiling.span("isdf.select.ao"):
            x0 = make_evaluator(
                cell, kpts=kpts if ksel is None else kpts[ksel],
                dtype=torch.float64, device=device)(coords0)
        nku = x0.shape[0]
        # ~15% past the requested rank: the rank is otherwise capped at
        # max_rank and a saturated pool could not be told from a full one
        rank_cap = min(int(max_rank * 1.15) + 8, ng0)
        with profiling.span("isdf.select.pivot"):
            flat = x0.permute(1, 0, 2).reshape(ng0, nku * nao)
            flat = flat * torch.as_tensor(np.repeat(np.sqrt(wk), nao),
                                          dtype=torch.float64, device=device)
            piv, rank, hist = pivoted_cholesky_pairgram(flat, nk, rank_cap,
                                                        tol=select_tol)
            del flat
        x0 = x0.to(cdt)
    else:
        with profiling.span("isdf.select.ao"):
            x0 = make_evaluator(cell, kpts=kpts, dtype=rdt,
                                device=device)(coords0)
        # K1 gives |G|^2 / nk^2; times nk this is the JAX CPU path's
        # (Re G)^2 / nk wherever the k-mesh is closed under k -> -k (there
        # Im G = 0).  The pivot threshold is relative: same pivots.
        with profiling.span("isdf.select.k1"):
            x4 = pair_gram_sq(x0, square=False) * nk
        rank_cap = max_rank
        with profiling.span("isdf.select.pivot"):
            if f64_build:
                _, piv, rank, hist = pivoted_cholesky(x4, max_rank=max_rank,
                                                      tol=select_tol)
            else:
                # float32 rank detection is noise-limited (the Schur
                # diagonal goes non-positive long before the true rank), so
                # selection takes all max_rank greedy pivots; the ridge fit
                # damps the redundant directions
                piv, rank_fp, hist = pivot_selection(
                    x4, max_rank=max_rank,
                    tol=0.0 if select_tol is None else select_tol)
                log.debug("select: float32 fp-rank %d of %d pivots (all "
                          "are kept)", rank_fp, max_rank)
                rank = max_rank
            del x4
            piv, hist = piv.cpu().numpy(), hist.cpu().numpy()
    nip = min(int(nao * c0), rank)
    # saturation: the requested compression is within 10% of the parent
    # grid's numerical pair-density rank.  It is read before the near-null
    # trim below, which would otherwise hide it.
    saturated = nip >= 0.9 * rank and rank < rank_cap
    if keep_tol is not None:
        # near-null-pivot guard: at pair-space rank exhaustion the last
        # pivots sit at the selection tolerance, noise directions that a
        # float32 serve amplifies.  Keep the pivots whose Schur diagonal
        # exceeds keep_tol * hist[0].
        nip_keep = int(np.sum(hist > float(keep_tol)
                              * max(float(hist[0]), 0.0)))
        if nip_keep < nip:
            log.info("select: keep_tol=%.1e trims %d near-null pivots "
                     "(nip %d -> %d)", keep_tol, nip - nip_keep, nip,
                     nip_keep)
            nip = max(nip_keep, 1)
    mask = piv[:nip]
    if log.verbose >= 3:
        err = float(hist[min(nip, len(hist) - 1)])
        log.info("select_interpolation_points: ng0=%d rank=%d nip=%d "
                 "pivot-residual=%.2e (%s, %.2fs)", ng0, rank, nip, err,
                 "float64 matrix-free" if host_f64 else f"K1 {cdt}",
                 time.perf_counter() - t0)
    x_k = x0[:, torch.as_tensor(mask, device=device)].contiguous()
    if ksel is not None:
        x_k = _trs_scatter(x_k, ksel, mirror, device)
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


def _sector_wq(x4_q, y_q, coulG_q, eiqr_q, mesh, vol, solver="ridge",
               rcond=1e-10, refine=0, col_block=128, neg_cols=None):
    """One momentum sector's metric w_q (nip, nip) from its normal matrix
    ``x4_q``, its RHS ``y_q`` (ngrid, nip), the Coulomb kernel and the
    e^{iqr} phases.

    w_q = S_q (B_q K_q^T B_q^H) S_q through the split fitting operator
    S_q = H^H H: g = H B_q, then by Parseval g K g^H =
    (vol/ngrid^2) Gf diag(coulG) Gf^H with Gf = FFT[g e^{-iqr}] row-wise,
    and the split h = Gf sqrt(|coulG| vol/ngrid^2) leaves w = finish(h
    h^H).  Works in the transposed (grid-major) layout: ``y_q`` is
    overwritten (scaled by D), and the FFT runs over column slabs of
    ``col_block`` interpolation points so its workspace stays small.

    ``neg_cols``: indices of the grid columns where the kernel is negative
    (the 2D-truncated kernel's q+G = 0 sample, -2 pi rc^2).  The split
    takes |coulG|, so each such column a enters the gram as +a a^H where
    the metric wants -a a^H: 2 a a^H is taken off again.

    Spans ``isdf.solve.factor``, ``.apply``, ``.fft`` and ``.gram`` mark
    its stages (see ``FFTISDF(profile_build=)``)."""
    ngrid, nip = y_q.shape
    with profiling.span("isdf.solve.factor"):
        data = half_factor_data(x4_q, method=solver, rcond=rcond,
                                refine=refine)
    with profiling.span("isdf.solve.apply"):
        gt = half_apply_rows(data, y_q)                  # (ngrid, nip) = g^T
    with profiling.span("isdf.solve.fft"):
        gt.mul_(eiqr_q.conj()[:, None])
        sq = torch.sqrt(coulG_q.abs() * (vol / float(ngrid) ** 2))
        mesh = tuple(int(m) for m in mesh)
        for c0 in range(0, nip, col_block):
            c1 = min(c0 + col_block, nip)
            slab = gt[:, c0:c1].T                        # (cb, ngrid) rows
            gt[:, c0:c1] = (fft3(slab, mesh) * sq[None, :]).T
    with profiling.span("isdf.solve.gram"):
        # h h^H = gt^T conj(gt) = conj(gt^H gt)
        m = torch.matmul(gt.mH, gt).conj().resolve_conj()
        if neg_cols is not None and len(neg_cols):
            a = gt[neg_cols]                             # (nneg, nip)
            m -= 2.0 * (a.T @ a.conj())
        del gt
        wq = finish_apply(data, m)
    return wq


def _sector_wq_reference(x4_q, y_q, coulG_q, eiqr_q, mesh, vol,
                         solver="ridge", rcond=1e-10, refine=0):
    """Row-major form of :func:`_sector_wq` through the closure operator
    (the JAX package's ``_sector_wq`` with ``signed=True``, line by line);
    the test oracle."""
    ngrid = y_q.shape[0]
    half, finish, _ = fitting_half_operator(x4_q, method=solver, rcond=rcond,
                                            refine=refine)
    g = half(y_q.T)
    gf = fft3(g * eiqr_q.conj()[None, :], mesh)
    h = gf * torch.sqrt(coulG_q.abs() * (vol / float(ngrid) ** 2))
    return finish((h * torch.sign(coulG_q)[None, :]) @ h.mH)


# the build's spans that count the work of each of the JAX package's
# profile_build stage keys (FFTISDF docstring)
STAGE_SPANS = {"factors": ("isdf.factors", "isdf.solve.factor"),
               "sweep": ("isdf.sweep", "isdf.solve.apply"),
               "spectral": ("isdf.solve.fft",),
               "gram": ("isdf.solve.gram",)}


def stage_seconds(spans):
    """``_stage_s`` from recorded spans: device seconds by stage key."""
    return {key: sum(s["device_s"] for s in spans if s["name"] in names)
            for key, names in STAGE_SPANS.items()}


def _trs_sectors(cell, kpts, use_trs=True):
    """(mirror, qsel): each sector's -q partner and the canonical sectors
    q <= mirror(q).  A mesh without full -k pairing, or ``use_trs=False``,
    keeps every sector."""
    nk = len(kpts)
    mirror = _trs_mirror(cell, kpts)
    if (mirror < 0).any() or not use_trs:
        mirror = np.arange(nk)
    qsel = np.array([q for q in range(nk) if q <= mirror[q]])
    return mirror, qsel


class FFTISDF:
    """Interpolative separable density fitting with FFT Coulomb kernels.

    Configure, :meth:`build`, then :meth:`get_jk`.  The knobs are the JAX
    package's ``FFTISDF``'s, with the same meaning:

      c0             interpolation points per AO
      m0             parent (selection) mesh: 'auto' (the default: derived
                     from a cutoff and the basis size by
                     :func:`auto_selection_mesh`, densified at build time
                     while the pool saturates) or an explicit 3-tuple
      k0             selection cutoff in Ha: m0 = cell.cutoff_to_mesh(k0)
                     ('auto' only)
      m0_pool        'auto': candidate pool >= m0_pool * nip
      m0_floor       'auto': elementwise floor of the mesh
      solver         'ridge' (the default) | 'lstsq' | 'pinv' | 'svd'
      rcond          spectral cutoff / ridge regularisation of the fit;
                     None: 1e-10 in float64, 1e-5 in float32
      refine         refinement steps; None: 0 in float64, 2 in float32
      select_tol     pivot threshold (None: n eps max diag)
      select_keep    relative Schur-diagonal floor: pivots below
                     select_keep * hist[0] are trimmed (None keeps all)
      blksize        upper limit of the grid block of the sweep
      max_memory_gb  byte budget of the metric pass; None sizes it from
                     the device's free memory
      use_trs        exploit w_{-q} = conj(w_q) in the build and
                     x_{-k} = conj(x_k) in float64 selection; False
                     disables both
      trunc          Coulomb truncation: None | '0d' | '2d' (radius from
                     the cell) | ('0d'|'2d', rc)
      select_host_f64  None: a float32 build selects in float64 (pivot
                     ordering degrades in float32); True / False force the
                     float64 route or the build-dtype route through K1.
                     The JAX package's name: it runs that route on the
                     host, the port runs it on ``device``.
      dtype          torch.float64 (None, the default on every device) or
                     torch.float32
      validate       check the stripe-reality invariant at build time
      profile_build  per-stage attribution of the build: its spans are
                     recorded (``utils.profiling``; CUDA events on the
                     card, no extra sync) and fill ``_stage_s``
      device         'cuda' (the default) or 'cpu'

    After :meth:`build`, ``timings`` holds ``select_s``, ``metric_s``,
    ``build_s`` and the chunk-level ``sweep_s`` / ``solve_s`` (one sync
    after each chunk's sweep and after its solves, profiled or not).  The
    build's spans (recorded only while ``utils.profiling.recording`` is
    on) are ``isdf.build`` › ``isdf.select`` (› ``.ao``, ``.k1``,
    ``.pivot``), ``isdf.factors``, and per chunk ``isdf.sweep`` (›
    ``.ao``, ``.rhs``) and ``isdf.solve`` (› per sector ``.factor``,
    ``.apply``, ``.fft``, ``.gram``).  Under ``profile_build``, ``_stage_s``
    holds the JAX package's stage keys, the device seconds of the spans
    that count the work the JAX package counts under each (empty without
    it):

      factors   ``isdf.factors`` (``_stripe_quartic``, the normal
                matrices; the JAX package forms them per chunk inside its
                factor stage) and every sector's ``isdf.solve.factor``
      sweep     ``isdf.sweep`` (``_rhs_block`` over the grid blocks), and
                every sector's ``isdf.solve.apply`` (the JAX package
                half-applies inside its sweep body)
      spectral  ``isdf.solve.fft``: the e^{-iqr} phase, the FFT slabs and
                the sqrt-kernel scaling
      gram      ``isdf.solve.gram``: the ``gt^H gt`` product, the
                ``neg_cols`` term and ``finish_apply``

    ``wq`` is bitwise the same either way.
    """

    def __init__(self, cell, kpts, c0=20.0, m0="auto", k0=None, m0_pool=2.5,
                 m0_floor=(15, 15, 15), solver="ridge", rcond=None,
                 refine=None, select_tol=None, select_keep=None,
                 blksize=16384, max_memory_gb=None, use_trs=True, trunc=None,
                 select_host_f64=None, dtype=None, verbose=3, validate=False,
                 profile_build=False, *, device="cuda"):
        if solver not in ("ridge", "lstsq", "pinv", "svd"):
            raise ValueError(f"unknown solver {solver!r}")
        self.device = resolve_device(device)
        self.rdtype, self.cdtype = real_complex(dtype)
        self.dtype = self.rdtype
        f64 = self.rdtype == torch.float64
        self.cell = cell
        self.kpts = np.asarray(kpts)
        self.kmesh = np.asarray(kpt_mod.kpts_to_kmesh(cell, self.kpts))
        self.c0 = float(c0)
        self.k0, self.m0_pool, self.m0_floor = k0, m0_pool, m0_floor
        self.solver = solver
        # the cutoff must sit above the factorisation's noise floor:
        # float32 eigenvalues carry O(eps wmax) errors that a 1e-10 cutoff
        # would keep and amplify by 1/w
        self.rcond = float(rcond) if rcond is not None else (
            1e-10 if f64 else 1e-5)
        # refinement in the metric-side build is O(nip^3), free next to
        # the O(nip^2 ngrid) passes
        self.refine = int(refine) if refine is not None else (0 if f64 else 2)
        self.select_tol = select_tol
        self.select_keep = select_keep
        self.blksize = int(blksize)
        self.max_memory_gb = max_memory_gb
        self.use_trs = bool(use_trs)
        self.trunc = (trunc_for_cell(cell, trunc) if isinstance(trunc, str)
                      else trunc)
        self.select_host_f64 = select_host_f64
        self.validate = bool(validate)
        self.profile_build = bool(profile_build)
        self._log = Logger(verbose)
        self._m0_auto = _is_auto(m0)
        if self._m0_auto:
            self.m0 = auto_selection_mesh(
                cell, self.c0 * cell.nao_nr(), pool_factor=m0_pool, k0=k0,
                floor=m0_floor)
        else:
            self.m0 = tuple(int(v) for v in m0)
        self.x_k = None
        self.wq = None
        self.mask = None
        self.dev_mesh = None
        self._ws = None
        self._wq_omega = {}
        self._madelung = None
        self._s1e = None
        self._kconserv2 = None
        self._kconserv3 = None
        self.timings = {}
        self._stage_s = {}
        self.nchunks = 0

    @classmethod
    def from_numpy(cls, cell, kpts, x_k, wq, mask, m0, *, device="cuda",
                   **kw):
        """A built object from host arrays (e.g. the JAX package's state),
        in the arrays' own precision unless ``dtype`` is given."""
        if kw.get("dtype") is None:
            kw["dtype"] = (torch.float32 if np.asarray(wq).dtype
                           == np.complex64 else torch.float64)
        df = cls(cell, kpts, m0=m0, device=device, **kw)
        df.x_k = as_tensor(x_k, df.device, df.cdtype)
        df.wq = as_tensor(wq, df.device, df.cdtype)
        df.mask = np.asarray(mask)
        return df

    @property
    def nkpt(self):
        return len(self.kpts)

    @property
    def nip(self):
        return None if self.x_k is None else self.x_k.shape[1]

    @property
    def w0(self):
        return None if self.wq is None else self.wq[0]

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
        given, selection is skipped and x_k is evaluated at those points
        (in float64, then cast to the build dtype).  Selection on a
        symmetric cell meets exact ties between symmetry-equivalent points,
        which two implementations break differently, so a comparison of
        the two packages past selection needs the same mask."""
        dev = self.device
        with (profiling.recording(dev) if self.profile_build
              else contextlib.nullcontext()) as rec, \
                profiling.span("isdf.build"):
            t_all = time.perf_counter()
            self.dev_mesh = None
            with profiling.span("isdf.select"):
                self.x_k, self.mask, self.m0 = self._select(mask)
                _sync(dev)
            t_sel = time.perf_counter() - t_all
            if self.validate:
                self._validate_stripe()
            self.timings = {}
            self._wq_omega = {}
            self._ws = None
            self.wq = self._metric_pass(omega=0.0)
            _sync(dev)
            total = time.perf_counter() - t_all
        self.timings.update(select_s=t_sel, metric_s=total - t_sel,
                            build_s=total)
        self._stage_s = {} if rec is None else stage_seconds(rec.spans())
        if rec is not None:
            self._log.info("build: stage attribution %s (+ selection "
                           "%.2fs)", {k: round(v, 3) for k, v in
                                      self._stage_s.items()}, t_sel)
        self._log.info("build: total %.2fs", total)
        return self

    def _select(self, mask=None):
        """(x_k, mask, m0): selection, or x_k evaluated at a given mask (in
        float64, then cast to the build dtype)."""
        if mask is None:
            x_k, mask, _, m0 = select_interpolation_points(
                self.cell, self.kpts, self.m0, self.c0, dtype=self.rdtype,
                select_tol=self.select_tol, log=self._log,
                host_f64=self.select_host_f64, auto_densify=self._m0_auto,
                use_trs=self.use_trs, keep_tol=self.select_keep,
                device=self.device)
            return x_k, mask, m0
        mask = np.asarray(mask, dtype=np.int64)
        coords0 = self.cell.gen_uniform_grids(self.m0)[mask]
        x_k = make_evaluator(self.cell, kpts=self.kpts,
                             device=self.device)(coords0).to(self.cdtype)
        return x_k, mask, self.m0

    def _validate_stripe(self):
        """The image-space pair products of x_k must be real (they are on a
        k-mesh consistent with the lattice)."""
        x_k = self.x_k
        phase = torch.as_tensor(self.phase, dtype=self.cdtype,
                                device=self.device)
        x2_k = (x_k.conj() @ x_k.transpose(1, 2)).reshape(len(x_k), -1)
        imag_max = float((phase @ x2_k).imag.abs().max())
        tol_real = 1e-10 if self.rdtype == torch.float64 else 1e-4
        if not imag_max < tol_real * max(1.0, float(x2_k.abs().max())):
            raise AssertionError(
                f"stripe reality violated: imag {imag_max:.2e} (k-mesh "
                "inconsistent with lattice?)")
        self._log.debug("validate: x2 stripe imag max %.2e", imag_max)

    def _memory_plan(self, nsec, nk_sw, nip, nao, ngrid, ndev=1):
        """(qchunk, blk, budget bytes) of one metric pass, per rank of a
        mesh of ``ndev`` ranks (``parallel.build``; 1: the single-device
        pass).

        The model, in bytes, with r and c = 2 r the sizes of a real and a
        complex number of the build dtype:
          persistent  what the pass itself allocates and keeps: x4_k
                      (nk nip^2 c), the canonical w_q and their scatter
                      ((nsec + 2 nk) nip^2 c), a few nip^2 factors, the
                      sweep's copy of x_k, and per sector the e^{iqr}
                      phases (ngrid c) and the kernel (ngrid r);
          plane       one sector's RHS y_q, ngrid nip c; a chunk of nq
                      sectors holds nq planes through its sweep;
          sweep       per grid point of a block: the projected pairs on the
                      swept k axis (complex, plus real/imag copies), the
                      real image stripe and its products, the chunk's
                      RHS rows (complex, plus real/imag): nip r (4 nk_sw
                      + 3 nimg + 4 nq) + AO values;
          solve       the g plane of one sector (the y plane it came from
                      is released right after) plus three FFT slabs of 128
                      columns and a few nip^2 temporaries.
        The budget is ``max_memory_gb`` or 90% of the device's free memory
        when the pass starts, so whatever the object already holds (x_k,
        the bare metric and its image-space form under a screened pass) is
        outside it, and the float64 factor of a selection inside a float32
        build is released before.  Sweep temporaries get at most a quarter
        of it and 4 GB, the grid block at most ``blksize`` points; the
        sector chunk takes what is left.

        On ``ndev`` > 1 ranks the persistent metrics are x4_k and the
        rank's share of the sectors with their mirrors; a rank sweeps 1/ndev
        of the grid for every
        sector of the chunk and receives its 1/ndev of the chunk's sectors
        over the whole grid: both buffers live through the exchange, so a
        chunk sector costs 2 plane / ndev, and the chunk is a multiple of
        ``ndev`` sectors (at least ``ndev``) where there are that many."""
        nk = self.nkpt
        r = self.rdtype.itemsize
        c = 2 * r
        if self.max_memory_gb is not None:
            budget = float(self.max_memory_gb) * 1e9
        else:
            budget = 0.9 * free_memory_bytes(self.device)
        plane = ngrid * nip * c
        # a rank of a mesh keeps x4_k, its sectors and their mirrors
        nw = 3 * nk + nsec if ndev == 1 else nk + 2 * -(-nsec // ndev)
        persist = ((nw + 4) * nip * nip * c + nk * nip * nao * c
                   + nsec * ngrid * (c + r) + 3 * ngrid * r)
        solve = plane + 3 * 128 * ngrid * c + 6 * nip * nip * c

        def sweep_bytes(nq, blk):
            return blk * (nip * r * (4 * nk_sw + 3 * nk + 4 * nq)
                          + c * nk_sw * nao)

        sweep_cap = min(4e9, 0.25 * budget)
        ng_loc = -(-ngrid // ndev)
        blk = int(max(64, min(ng_loc, self.blksize,
                              sweep_cap // max(sweep_bytes(nsec, 1), 1))))
        room = budget - persist - max(sweep_bytes(nsec, blk), solve)
        if ndev == 1:
            return int(max(1, min(nsec, room // plane))), blk, budget
        qchunk = int(room // (2 * plane / ndev)) // ndev * ndev
        return int(max(1, min(nsec, max(ndev, qchunk)))), blk, budget

    def _pass_inputs(self, omega):
        """What one metric pass reads besides the RHS planes, for the kernel
        that ``omega`` and ``self.trunc`` select: the time-reversal
        canonical sectors ``qsel`` (w_{-q} = conj(w_q) for real AOs, so
        only they are solved) with their ``mirror``s, the sweep's evaluator
        ``fn`` and projection ``x_sw``/``phase_sw`` on the canonical half
        of the k axis (conjugate pairs weighted 2 in the stripe phase, see
        _rhs_block), the canonical sectors' kernels ``coulG``, their
        ``neg_cols`` and e^{iqr} phases ``ph``, and the grid.  The single
        pass (:meth:`_metric_pass`) and the sharded one
        (``parallel.build``) both start here."""
        cell, kpts, dev = self.cell, self.kpts, self.device
        rdt, cdt = self.rdtype, self.cdtype
        p = SimpleNamespace()
        coords = cell.gen_uniform_grids()
        p.ngrid = coords.shape[0]
        p.mesh = tuple(int(m) for m in cell.mesh)
        p.vol = float(cell.vol)
        p.phase = torch.as_tensor(self.phase, dtype=cdt, device=dev)
        p.mirror, p.qsel = _trs_sectors(cell, kpts, self.use_trs)
        ksel = p.qsel
        kw = np.where(p.mirror[ksel] == ksel, 1.0, 2.0)
        ksel_t = torch.as_tensor(ksel, device=dev)
        p.x_sw = self.x_k[ksel_t]
        p.phase_sw = p.phase[:, ksel_t] * torch.as_tensor(kw, dtype=rdt,
                                                          device=dev)
        p.nk_sw = len(ksel)
        p.fn = make_evaluator(cell, kpts=kpts[ksel], dtype=rdt, device=dev)
        p.qsel_t = torch.as_tensor(p.qsel, device=dev)
        kq = torch.as_tensor(kpts[p.qsel], dtype=rdt, device=dev)
        p.coulG = get_coulG_batched(
            cell, kq, torch.as_tensor(cell.get_Gv(p.mesh), dtype=rdt,
                                      device=dev),
            omega=omega, trunc=self.trunc)
        # a truncated 2D kernel carries a finite negative q+G = 0 sample,
        # whose sign the |coulG| split strips (see _sector_wq)
        p.neg_cols = [None] * len(p.qsel)
        if self.trunc is not None:
            for i in torch.nonzero((p.coulG < 0).any(dim=1))[:, 0].tolist():
                p.neg_cols[i] = torch.nonzero(p.coulG[i] < 0)[:, 0]
        p.coords_t = torch.as_tensor(coords, dtype=rdt, device=dev)
        p.ph = eiqr(p.coords_t, kq)
        return p

    def _sweep_rows(self, p, q0, q1, g0, g1, blk, out):
        """RHS rows [g0, g1) of the canonical sectors q0:q1 (positions in
        ``p.qsel``), swept in grid blocks of ``blk``, into ``out[i]`` (rows
        from 0) for each sector i of the range."""
        phase_cols = p.phase[:, p.qsel_t[q0:q1]]
        for b0 in range(g0, g1, blk):
            b1 = min(b0 + blk, g1)
            with profiling.span("isdf.sweep.ao"):
                f_k = p.fn(p.coords_t[b0:b1])
            with profiling.span("isdf.sweep.rhs"):
                y = _rhs_block(f_k, p.x_sw, p.phase_sw, phase_cols)
                del f_k
                for i, y_q in enumerate(out):
                    y_q[b0 - g0:b1 - g0] = y[i]
                del y

    def _solve_sector(self, p, x4_k, iq, y_q):
        """w_q of canonical sector ``iq`` (a position in ``p.qsel``) from its
        RHS plane ``y_q`` (ngrid, nip), which it overwrites."""
        return _sector_wq(x4_k[p.qsel[iq]], y_q, p.coulG[iq], p.ph[iq],
                          p.mesh, p.vol, solver=self.solver,
                          rcond=self.rcond, refine=self.refine,
                          neg_cols=p.neg_cols[iq])

    def _metric_pass(self, omega=0.0):
        """RHS grid sweep + per-sector solve / FFT kernel / gram, chunked
        over canonical momentum sectors, for the Coulomb kernel that
        ``omega`` and ``self.trunc`` select (0: the full kernel).  Returns
        w_q (nk, nip, nip), or on a mesh-sharded object (``dev_mesh``,
        ``parallel.build``) this rank's sectors.

        :meth:`build` runs it with the full kernel; :meth:`get_wq_omega`
        runs it again with a screened kernel over the same interpolation
        vectors (w_q is linear in the kernel: only the spectral scale
        differs)."""
        if self.dev_mesh is not None:
            from fftisdf_tpu_torch.parallel.build import build_wq_sharded

            return build_wq_sharded(self, self.dev_mesh, omega=omega)
        dev, log = self.device, self._log
        cdt = self.cdtype
        nk, nip, nao = self.x_k.shape
        p = self._pass_inputs(omega)
        ngrid, qsel = p.ngrid, p.qsel
        nsec = len(qsel)
        qchunk, blk, budget = self._memory_plan(nsec, p.nk_sw, nip, nao,
                                                ngrid)
        log.info("build: nk=%d nip=%d nao=%d ngrid=%d sectors=%d %s omega=%g"
                 " (qchunk=%d blk=%d, plane %.2f GB, budget %.1f GB)", nk,
                 nip, nao, ngrid, nsec, cdt, omega, qchunk, blk,
                 ngrid * nip * cdt.itemsize / 1e9, budget / 1e9)
        wq_sel = torch.empty((nsec, nip, nip), dtype=cdt, device=dev)

        # chunk times: one device sync after each chunk's sweep and solves
        t0 = time.perf_counter()
        with profiling.span("isdf.factors"):
            x4_k = _stripe_quartic(self.x_k, p.phase)
        stage = {"sweep_s": 0.0, "solve_s": 0.0}
        nchunks = 0
        for q0 in range(0, nsec, qchunk):
            q1 = min(q0 + qchunk, nsec)
            nchunks += 1
            t_c = time.perf_counter()
            with profiling.span("isdf.sweep"):
                ys = [torch.empty((ngrid, nip), dtype=cdt, device=dev)
                      for _ in range(q1 - q0)]
                self._sweep_rows(p, q0, q1, 0, ngrid, blk, ys)
                _sync(dev)
            stage["sweep_s"] += time.perf_counter() - t_c
            t_c = time.perf_counter()
            with profiling.span("isdf.solve"):
                for i in range(q1 - q0):
                    y_q = ys[i]
                    ys[i] = None  # the solve overwrites and releases it
                    wq_sel[q0 + i] = self._solve_sector(p, x4_k, q0 + i,
                                                        y_q)
                    del y_q
                _sync(dev)
            stage["solve_s"] += time.perf_counter() - t_c
        self.nchunks = nchunks
        self.timings.update(stage)
        # scatter canonical sectors and their conjugate mirrors.  w_q is
        # not symmetrised: on even FFT meshes the discrete Coulomb operator
        # carries a small skew part that the exact oracle shares.
        wq = (_trs_scatter(wq_sel, qsel, p.mirror, dev) if nsec < nk
              else wq_sel)
        log.info("build: %d/%d sectors solved in %d chunk(s) (%.2fs)", nsec,
                 nk, nchunks, time.perf_counter() - t0)
        return wq

    # ------------------------------------------------------------------
    def _to_ws(self, wq):
        """Image-space form of the metric ``wq``: on a mesh-sharded object
        this rank's block of the image axis (``parallel.build``)."""
        if self.dev_mesh is not None:
            return wq.image_block(self.kmesh)
        return jk_mod.wq_to_ws(wq, self.kmesh)

    def get_ws(self):
        """Image-space Coulomb metric ws = Re(phase @ wq) sqrt(nk), cached:
        the density-independent state of the K serve."""
        if self._ws is None:
            self._ws = self._to_ws(self.wq)
        return self._ws

    def get_wq_omega(self, omega):
        """Screened (range-separated) Coulomb metric over the same
        interpolation basis, cached per omega (erf for omega > 0, erfc for
        omega < 0; see ``linalg.coulomb``).  The first call for an omega
        pays one metric pass; selection and x_k are reused."""
        key = float(omega)
        if key not in self._wq_omega:
            if self.x_k is None:
                raise RuntimeError("call build() first")
            self._log.info("building screened metric (omega=%g)", key)
            self._wq_omega[key] = {"wq": self._metric_pass(omega=key),
                                   "ws": None}
        return self._wq_omega[key]["wq"]

    def get_ws_omega(self, omega):
        """Image-space form of :meth:`get_wq_omega` (cached)."""
        wq_o = self.get_wq_omega(omega)
        entry = self._wq_omega[float(omega)]
        if entry["ws"] is None:
            entry["ws"] = self._to_ws(wq_o)
        return entry["ws"]

    def get_jk(self, dm_kpts, with_j=True, with_k=True, exxdiv=None,
               omega=None, kpts_band=None):
        """(vj, vk) tensors on the object's device, in the metric's dtype,
        for ``dm_kpts`` (nk, nao, nao) or (nset, nk, nao, nao); ``None``
        for a skipped part.  ``exxdiv='ewald'`` adds the Madelung
        probe-charge term to vk; ``omega`` serves from the screened metric
        of :meth:`get_wq_omega`; ``kpts_band`` (nb, 3) serves J/K at those
        k-points from the product state (:func:`isdf.bands.get_jk_bands`),
        (nb, nao, nao) per set."""
        if omega is not None and float(omega) != 0.0:
            if exxdiv is not None:
                raise NotImplementedError(
                    "exxdiv with omega: the probe-charge Madelung constant "
                    "of a screened kernel differs from the bare one")
            if kpts_band is not None:
                raise NotImplementedError("omega with kpts_band")
            return self._get_jk_metric(
                dm_kpts, self.get_wq_omega(omega),
                self.get_ws_omega(omega) if with_k else None,
                with_j=with_j, with_k=with_k)[:2]
        if exxdiv not in (None, "ewald"):
            raise NotImplementedError(f"exxdiv={exxdiv!r} not supported")
        if kpts_band is not None:
            if exxdiv is not None:
                raise NotImplementedError(
                    "exxdiv with kpts_band: the Madelung correction needs "
                    "the density at the band point (mesh points only); the "
                    "SCF layer applies it (scf.hf)")
            from fftisdf_tpu_torch.isdf.bands import get_jk_bands

            if self.x_k is None:
                raise RuntimeError("call build() first")
            return get_jk_bands(self, dm_kpts, kpts_band, with_j=with_j,
                                with_k=with_k)
        vj, vk, dm = self._get_jk_metric(
            dm_kpts, self.wq, self.get_ws() if with_k else None,
            with_j=with_j, with_k=with_k)
        if exxdiv == "ewald" and with_k:
            single = vk.ndim == 3
            vk = jk_mod.add_ewald_exx(vk[None] if single else vk,
                                      self.get_ovlp(), dm, self.madelung())
            vk = vk[0] if single else vk
        return vj, vk

    def _get_jk_metric(self, dm_kpts, wq, ws, with_j=True, with_k=True):
        """J/K serve against an explicit metric pair (wq, ws), shared by the
        bare and the range-separated paths.  Returns (vj, vk, the density
        on the device with its set axis)."""
        if self.x_k is None:
            raise RuntimeError("call build() first")
        dm = as_tensor(dm_kpts, self.device, wq.dtype)
        single = dm.ndim == 3
        if single:
            dm = dm[None]
        vj = jk_mod.get_j_kpts(self.x_k, wq[0], dm) if with_j else None
        vk = (jk_mod.get_k_kpts_img(self.x_k, ws, dm, self.kmesh,
                                    mesh=self.dev_mesh)
              if with_k else None)
        if single:
            vj = None if vj is None else vj[0]
            vk = None if vk is None else vk[0]
        return vj, vk, dm

    def madelung(self):
        """Probe-charge Madelung constant of the BvK supercell (cached);
        with a truncated kernel the Riemann-sum-vs-integral defect of that
        kernel (``scf.integrals.madelung_trunc``, exactly 0 for 0d)."""
        if self._madelung is None:
            from fftisdf_tpu_torch.scf.integrals import (madelung,
                                                         madelung_trunc)

            self._madelung = (
                madelung_trunc(self.cell, self.kmesh, self.trunc)
                if self.trunc is not None
                else madelung(self.cell, self.kmesh))
        return self._madelung

    def get_ovlp(self):
        """Overlap S_k on the FFT-grid quadrature (cached; streamed)."""
        if self._s1e is None:
            from fftisdf_tpu_torch.scf.integrals import get_ovlp_kpts

            self._s1e = get_ovlp_kpts(self.cell, self.kpts,
                                      dtype=self.rdtype,
                                      blksize=self.blksize,
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
    def load(cls, path, cell, kpts, dtype=None, *, device="cuda"):
        from fftisdf_tpu_torch.utils import serialization

        return serialization.load_isdf_state(path, cell, kpts, dtype=dtype,
                                             device=device)
