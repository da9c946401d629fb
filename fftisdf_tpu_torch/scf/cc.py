"""k-point CCSD, CCSD(T), EOM-CCSD and the Lambda RDMs on the ISDF state.

Counterpart of ``fftisdf_tpu/scf/cc.py``: spin-orbital coupled-cluster
singles and doubles with full momentum conservation, consuming ERIs
straight from the ISDF state (x_k, w_q).

- **Spin orbitals** [occ_a, occ_b, vir_a, vir_b] per k-point, so one code
  path serves restricted (KRHF/KRKS) and unrestricted (KUHF/KUKS)
  references; the spin structure enters through delta masks on the
  integral blocks and the per-spin orbitals themselves.
- **Packed momentum blocks.**  Amplitudes are one tensor each: t1
  (nk, o, v) and t2 (nk, nk, nk, o, o, v, v) with block [ki, kj, ka] and
  kb = ki + kj - ka fixed by conservation (the JAX package's t2 dict,
  stacked: its concatenation order is the packed layout).  The integral
  blocks U[k1, k2, k3] = <p k1, q k2 || r k3, s k4> are assembled for each
  (k1, k2) row in one batched product over k3 (the JAX package assembles
  two ERI blocks per k-triple); the exchange block of (k1, k2, k3) is the
  direct block of (k1, k2, k4) with its ket indices swapped.
- **Complex-safe equations.**  Each integral factor is written in its
  vertex-natural index order (internal holes in the bra, internal
  particles in the ket, external particles in the bra, external holes in
  the ket), where the real-orbital Stanton-Gauss equations hold for Bloch
  orbitals too; the one term this changes is the T2 driving term
  <ab||ij> = conj(<ij||ab>).  ``_equations_packed`` contracts whole packed
  tensors, gathering derived k-labels through index tensors; the six
  contractions whose gathered operand is (nk^4, ...) run over memory
  blocks of its leading axis.  ``_equations`` is the per-block reference.
- **The iteration on the device.**  The amplitude vector and the DIIS
  history stay on the device; one small tensor (energy and step norms) is
  fetched a cycle.  The Pulay coefficients are the JAX package's
  (``scf.core.diis_coefficients``: normalised B, relative Tikhonov term),
  so the iterates are the same.
- **Derivatives by autodiff.**  EOM, Lambda and both RDMs come from
  derivatives of the holomorphic residual: ``torch.func.jvp`` gives J x
  (``vmap``-ed over the basis columns for the dense EOM and Lambda
  matrices, over Davidson vectors for the matrix-free EOM), and reverse
  mode gives gradients:
  ``torch.autograd.grad(f, z, grad_outputs=1)`` returns conj(df/dz), so the
  JAX package's ``jax.grad(..., holomorphic=True)`` is its conjugate.  The
  residual's one non-holomorphic term, conj(<ij||ab>), is switched off by
  ``include_drive=False`` and ``lambda_rdm2`` adds its density back.
- **The amplitude basis without a matrix.**  The independent
  (antisymmetric) amplitude components are held as :class:`AmpBasis`:
  index tensors with the +-1/2 weights of the dense basis, the same linear
  map; the Davidson EOM and its preconditioner apply it and its adjoint.
  ``_amp_basis`` keeps the dense form (with labels) for the fixture-scale
  dense paths.

Normalisation: the assembled ERIs are cell-normalised; supercell spin
orbitals are Bloch/sqrt(nk), so the supercell integrals are U/nk and the
correlation energy is divided by nk once more to be per cell.
``dev_mesh``/``mesh``: the packed tensors of nk^3 blocks (U, the W
intermediates, the T2 residual) split over a mesh of ranks by their
leading k index (:func:`_equations_packed` with ``mesh``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from fftisdf_tpu_torch.isdf.eri import pair_vectors
from fftisdf_tpu_torch.parallel.mesh import check_mesh, split
from fftisdf_tpu_torch.scf.core import diis_coefficients
from fftisdf_tpu_torch.utils.device import (as_tensor, memory_blocks,
                                            resolve_device, to_numpy)

# ----------------------------------------------------------------------
# spin-orbital setup
# ----------------------------------------------------------------------

def _spinorb_mo(mf):
    """Per-k spin-orbital coefficients (nao, nso), energies (nso,), spin
    labels, and the spin-orbital occupation count.

    Orbital order per k: [occ_alpha, occ_beta, vir_alpha, vir_beta].
    Insulating (integer, k-independent) occupations required.
    """
    mo_c = np.asarray(mf.mo_coeff)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    if mo_c.ndim == 3:                      # restricted: same spatial orbs
        mo_c = np.stack([mo_c, mo_c])
        mo_e = np.stack([mo_e, mo_e])
        mo_o = np.stack([mo_o / 2.0, mo_o / 2.0])
    nk = mo_c.shape[1]
    noccs = []
    for s in range(2):
        ns = [int(round(mo_o[s, k].sum())) for k in range(nk)]
        if any(abs(mo_o[s, k].sum() - ns[k]) > 1e-8 for k in range(nk)) \
                or len(set(ns)) != 1:
            raise NotImplementedError(
                "kccsd requires insulating (integer, k-independent) "
                "occupations; got per-k electron counts %s" % (ns,))
        noccs.append(ns[0])
    cs, es, spins = [], [], []
    for k in range(nk):
        cols, ene, sp = [], [], []
        for s in range(2):
            cols.append(mo_c[s, k][:, :noccs[s]])
            ene.append(mo_e[s, k][:noccs[s]])
            sp += [s] * noccs[s]
        for s in range(2):
            cols.append(mo_c[s, k][:, noccs[s]:])
            ene.append(mo_e[s, k][noccs[s]:])
            sp += [s] * (mo_c.shape[3] - noccs[s])
        cs.append(np.concatenate(cols, axis=1))
        es.append(np.concatenate(ene))
        spins.append(np.array(sp))
    return (np.array(cs), np.array(es), np.array(spins),
            noccs[0] + noccs[1])


def make_eris_dev(df, mf, rows=None):
    """Antisymmetrised spin-orbital integral blocks on the device of ``df``
    (``rows``: only k1 in [rows[0], rows[1]), a rank's block).

    Returns (U, eo, ev, nocc) with U[k1,k2,k3][p,q,r,s] =
    <p k1, q k2 || r k3, s k4>, k4 = k1 + k2 - k3 (physicists' notation,
    cell normalisation), and eo/ev the occupied/virtual spin-orbital
    energies per k (numpy).  Each (k1, k2) row is one batched product over
    k3: the direct blocks <pq|rs> = (p k1, r k3 | q k2, s k4), then
    U = md * <pq|rs> - mx * <pq|sr>, the exchange block being the row's
    direct block at k4 with r and s swapped."""
    cs, es, spins, nocc = _spinorb_mo(mf)
    nk = df.nkpt
    x = df.x_k
    dev, cdt = x.device, x.dtype
    nso = cs.shape[2]
    k2c, k3c = df.kconserv2(), df.kconserv3()
    xm = x @ as_tensor(cs.astype(np.complex128), dev, cdt)   # (nk, nip, nso)
    sp = torch.as_tensor(spins, device=dev)
    k3s = torch.arange(nk, device=dev)
    r0, r1 = (0, nk) if rows is None else (int(rows[0]), int(rows[1]))
    U = torch.empty((r1 - r0, nk, nk) + (nso,) * 4, dtype=cdt, device=dev)
    for k1 in range(r0, r1):
        for k2 in range(nk):
            k4s = torch.as_tensor(k3c[k1, :, k2], device=dev)
            wq = df.wq[torch.as_tensor(k2c[k1], device=dev)]  # q(k1, k3)
            t13 = pair_vectors(xm[k1][None], xm)            # (nk, nip, nso^2)
            t24 = pair_vectors(xm[k2][None], xm[k4s])
            d = (t13.mT @ (wq @ t24)).reshape(nk, nso, nso, nso, nso)
            d = d.permute(0, 1, 3, 2, 4)                     # (k3, p, q, r, s)
            md = ((sp[k1][None, :, None, None, None]
                   == sp[k3s][:, None, None, :, None])
                  & (sp[k2][None, None, :, None, None]
                     == sp[k4s][:, None, None, None, :]))
            mx = ((sp[k1][None, :, None, None, None]
                   == sp[k4s][:, None, None, None, :])
                  & (sp[k2][None, None, :, None, None]
                     == sp[k3s][:, None, None, :, None]))
            U[k1 - r0, k2] = d * md - d[k4s].transpose(-1, -2) * mx
    return U, es[:, :nocc], es[:, nocc:], nocc


def make_eris(df, mf):
    """Host-array variant of :func:`make_eris_dev`."""
    U, eo, ev, nocc = make_eris_dev(df, mf)
    return to_numpy(U), eo, ev, nocc


# ----------------------------------------------------------------------
# the CCSD residual (spin-orbital, k-blocked, complex-safe)
# ----------------------------------------------------------------------

def _blocks(f):
    """(foo, fov, fvo, fvv) as stacked (nk, ...) tensors."""
    return tuple(x if isinstance(x, torch.Tensor) else torch.stack(list(x))
                 for x in f)


def _equations(nk, nocc, nvir, kp3):
    """Build ``resid(t1, t2, f, U) -> (r1, r2, e)``: the FULL CCSD residual
    R_mu = <Phi_mu| e^-T H e^T |0> (one-body diagonal included; at a
    canonical diagonal fock R = D * (t_new - t) of make_step) plus the
    correlation energy at the input amplitudes, one momentum block at a
    time: the reference the packed form is held against.

    ``f = (foo, fov, fvo, fvv)``: per-k one-body blocks passed as
    INDEPENDENT arguments (fvo = fov^dag for a physical Hermitian fock),
    which keeps the residual holomorphic in every block.  t1 (nk, o, v),
    t2 packed (nk, nk, nk, o, o, v, v); r1 and r2 come back the same way.
    """
    o, v = slice(0, nocc), slice(nocc, nocc + nvir)
    kp3 = np.asarray(kp3)

    def kp(a, b, c):
        return int(kp3[a, b, c])

    def resid(t1, t2, f, U):
        foo, fov, fvo, fvv = _blocks(f)
        ein = torch.einsum

        def u(k1, k2, k3, s1, s2, s3, s4):
            return U[k1, k2, k3][s1, s2, s3, s4]

        # tau, tau-tilde (t1 contributions are momentum-diagonal)
        tau, tau_t = {}, {}
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    tt = t2[ki, kj, ka]
                    t1t1 = 0.0
                    if ka == ki:
                        t1t1 = t1t1 + ein("ia,jb->ijab", t1[ki], t1[kj])
                    if ka == kj:
                        t1t1 = t1t1 - ein("ib,ja->ijab", t1[ki], t1[kj])
                    tau[ki, kj, ka] = tt + t1t1
                    tau_t[ki, kj, ka] = tt + 0.5 * t1t1

        # ---- F intermediates (momentum-diagonal), full one-body ----
        f_ae, f_mi, f_me = [], [], []
        for k in range(nk):
            ae = fvv[k] - 0.5 * ein("ma,me->ae", t1[k], fov[k])
            mi = foo[k] + 0.5 * ein("ie,me->mi", t1[k], fov[k])
            me = fov[k]
            for km in range(nk):
                ae = ae + ein("mf,mafe->ae", t1[km],
                              u(km, k, km, o, v, v, v))
                mi = mi + ein("ne,mnie->mi", t1[km],
                              u(k, km, k, o, o, o, v))
                me = me + ein("nf,mnef->me", t1[km],
                              u(k, km, k, o, o, v, v))
                for kn in range(nk):
                    ae = ae - 0.5 * ein("mnaf,mnef->ae", tau_t[km, kn, k],
                                        u(km, kn, k, o, o, v, v))
                    mi = mi + 0.5 * ein("inef,mnef->mi", tau_t[k, km, kn],
                                        u(k, km, kn, o, o, v, v))
            f_ae.append(ae)
            f_mi.append(mi)
            f_me.append(me)

        # ---- T1 residual ----
        r1_out = []
        for k in range(nk):
            # driving <Phi_i^a|F|0> = f[a,i]: vertex-natural (vo block)
            r = (fvo[k].T
                 + ein("ie,ae->ia", t1[k], f_ae[k])
                 - ein("ma,mi->ia", t1[k], f_mi[k]))
            for km in range(nk):
                r = r + ein("imae,me->ia", t2[k, km, k], f_me[km])
                r = r - ein("nf,naif->ia", t1[km],
                            u(km, k, k, o, v, o, v))
                for ke in range(nk):
                    r = r - 0.5 * ein("imef,maef->ia", t2[k, km, ke],
                                      u(km, k, ke, o, v, v, v))
                for kn in range(nk):
                    ke = kp(km, kn, k)
                    r = r - 0.5 * ein("mnae,nmei->ia", t2[km, kn, k],
                                      u(kn, km, ke, o, o, v, o))
            r1_out.append(r)

        # ---- W intermediates ----
        # W_mnij, blocks [km,kn,ki] (kj fixed); raw then P_(ij)
        w_oooo_raw = {}
        for km in range(nk):
            for kn in range(nk):
                for ki in range(nk):
                    kj = kp(km, kn, ki)
                    w_oooo_raw[km, kn, ki] = ein(
                        "je,mnie->mnij", t1[kj], u(km, kn, ki, o, o, o, v))
        w_oooo = {}
        for km in range(nk):
            for kn in range(nk):
                for ki in range(nk):
                    kj = kp(km, kn, ki)
                    x = (u(km, kn, ki, o, o, o, o)
                         + w_oooo_raw[km, kn, ki]
                         - w_oooo_raw[km, kn, kj].transpose(2, 3))
                    for ke in range(nk):
                        x = x + 0.25 * ein(
                            "ijef,mnef->mnij", tau[ki, kj, ke],
                            u(km, kn, ke, o, o, v, v))
                    w_oooo[km, kn, ki] = x

        # W_abef, blocks [ka,kb,ke] (kf fixed); raw then P_(ab)
        w_vvvv_raw = {}
        for ka in range(nk):
            for kb in range(nk):
                for ke in range(nk):
                    w_vvvv_raw[ka, kb, ke] = ein(
                        "mb,amef->abef", t1[kb],
                        u(ka, kb, ke, v, o, v, v))
        w_vvvv = {}
        for ka in range(nk):
            for kb in range(nk):
                for ke in range(nk):
                    x = (u(ka, kb, ke, v, v, v, v)
                         - w_vvvv_raw[ka, kb, ke]
                         + w_vvvv_raw[kb, ka, ke].transpose(0, 1))
                    for km in range(nk):
                        x = x + 0.25 * ein(
                            "mnab,mnef->abef", tau[km, kp(ka, kb, km), ka],
                            u(km, kp(ka, kb, km), ke, o, o, v, v))
                    w_vvvv[ka, kb, ke] = x

        # W_mbej, blocks [km,kb,ke] (kj fixed)
        w_ovvo = {}
        for km in range(nk):
            for kb in range(nk):
                for ke in range(nk):
                    kj = kp(km, kb, ke)
                    x = (u(km, kb, ke, o, v, v, o)
                         + ein("jf,mbef->mbej", t1[kj],
                               u(km, kb, ke, o, v, v, v))
                         - ein("nb,mnej->mbej", t1[kb],
                               u(km, kb, ke, o, o, v, o))
                         - ein("jf,nb,mnef->mbej", t1[kj], t1[kb],
                               u(km, kb, ke, o, o, v, v)))
                    for kn in range(nk):
                        kf = kp(kj, kn, kb)
                        x = x - 0.5 * ein(
                            "jnfb,mnef->mbej", t2[kj, kn, kf],
                            u(km, kn, ke, o, o, v, v))
                    w_ovvo[km, kb, ke] = x

        # ---- T2 residual: raw pieces by permutational symmetry class ----
        f_be_t = [f_ae[k] - 0.5 * ein("mb,me->be", t1[k], f_me[k])
                  for k in range(nk)]
        f_mj_t = [f_mi[k] + 0.5 * ein("je,me->mj", t1[k], f_me[k])
                  for k in range(nk)]

        raw_ab, raw_ij, raw_ijab = {}, {}, {}
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    kb = kp(ki, kj, ka)
                    # P_(ab) class
                    x = ein("ijae,be->ijab", t2[ki, kj, ka], f_be_t[kb])
                    x = x - ein("ma,mbij->ijab", t1[ka],
                                u(ka, kb, ki, o, v, o, o))
                    raw_ab[ki, kj, ka] = x
                    # P_(ij) class
                    y = -ein("imab,mj->ijab", t2[ki, kj, ka], f_mj_t[kj])
                    y = y + ein("ie,abej->ijab", t1[ki],
                                u(ka, kb, ki, v, v, v, o))
                    raw_ij[ki, kj, ka] = y
                    # P_(ij)P_(ab) class
                    z = -ein("ie,ma,mbej->ijab", t1[ki], t1[ka],
                             u(ka, kb, ki, o, v, v, o))
                    for km in range(nk):
                        ke = kp(ki, km, ka)
                        z = z + ein("imae,mbej->ijab", t2[ki, km, ka],
                                    w_ovvo[km, kb, ke])
                    raw_ijab[ki, kj, ka] = z

        r2 = torch.empty_like(t2)
        for ki in range(nk):
            for kj in range(nk):
                for ka in range(nk):
                    kb = kp(ki, kj, ka)
                    # driving term <ab||ij> = conj(<ij||ab>): the one
                    # complex correction to the textbook equations
                    r = u(ki, kj, ka, o, o, v, v).conj()
                    r = r + (raw_ab[ki, kj, ka]
                             - raw_ab[ki, kj, kb].transpose(2, 3))
                    r = r + (raw_ij[ki, kj, ka]
                             - raw_ij[kj, ki, ka].transpose(0, 1))
                    z = raw_ijab[ki, kj, ka]
                    r = r + (z
                             - raw_ijab[kj, ki, ka].transpose(0, 1)
                             - raw_ijab[ki, kj, kb].transpose(2, 3)
                             + raw_ijab[kj, ki, kb].permute(1, 0, 3, 2))
                    for km in range(nk):
                        r = r + 0.5 * ein(
                            "mnab,mnij->ijab",
                            tau[km, kp(ki, kj, km), ka],
                            w_oooo[km, kp(ki, kj, km), ki])
                    for ke in range(nk):
                        r = r + 0.5 * ein(
                            "ijef,abef->ijab", tau[ki, kj, ke],
                            w_vvvv[ka, kb, ke])
                    r2[ki, kj, ka] = r

        # ---- energy at the INPUT amplitudes ----
        e = torch.zeros((), dtype=U.dtype, device=U.device)
        for ki in range(nk):
            e = e + ein("ia,ia->", fov[ki], t1[ki])
            for kj in range(nk):
                e = e + 0.5 * ein("ijab,ia,jb->",
                                  u(ki, kj, ki, o, o, v, v),
                                  t1[ki], t1[kj])
                for ka in range(nk):
                    e = e + 0.25 * ein("ijab,ijab->",
                                       u(ki, kj, ka, o, o, v, v),
                                       t2[ki, kj, ka])
        return torch.stack(r1_out), r2, e

    return resid


def _by_slabs(fn, n, per_item, dev):
    """``fn(sl)`` over memory blocks of the leading axis (``per_item``
    bytes a slab), concatenated."""
    outs = [fn(sl) for sl in memory_blocks(n, per_item, dev)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _sgather(t_loc, idx_fn, mesh, ranges, off):
    """``T[A, B, C, ...]`` on this rank's grid, T a packed tensor whose
    leading k axis is split over the ranks (rank j holds rows [off[j],
    off[j + 1]) as ``t_loc``), with one exchange; on one device (``mesh``
    None) the plain gather.

    ``idx_fn(lo, hi)`` gives the integer index arrays (global k labels)
    that broadcast to the grid of output rows [lo, hi); ``ranges[j]`` is
    rank j's (lo, hi) in this call, so each rank computes what every other
    asks of it."""
    dev = t_loc.device
    if mesh is None:
        return t_loc[tuple(torch.as_tensor(np.asarray(a), device=dev)
                           for a in idx_fn(*ranges[0]))]
    size, r = mesh.size, mesh.rank
    m = None
    pieces, recv_shapes, places = [], [], []
    for j in range(size):
        idx = [a.reshape(-1)
               for a in np.broadcast_arrays(*idx_fn(*ranges[j]))]
        m = len(idx)
        sel = (idx[0] >= off[r]) & (idx[0] < off[r + 1])
        key = (torch.as_tensor(idx[0][sel] - off[r], device=dev),
               *(torch.as_tensor(a[sel], device=dev) for a in idx[1:]))
        pieces.append(t_loc[key])
    tail = tuple(t_loc.shape[m:])
    mine = np.broadcast_arrays(*idx_fn(*ranges[r]))
    grid, lead = mine[0].shape, mine[0].reshape(-1)
    for j in range(size):
        pos = np.flatnonzero((lead >= off[j]) & (lead < off[j + 1]))
        places.append(torch.as_tensor(pos, device=dev))
        recv_shapes.append((len(pos),) + tail)
    recv = mesh.exchange(pieces, recv_shapes)
    out = t_loc.new_empty((lead.size,) + tail)
    for pos, got in zip(places, recv):
        out[pos] = got
    return out.reshape(grid + tail)


def _by_slabs_mesh(fn, mesh, off, per_item, dev):
    """``fn(sl, ranges)`` over slabs of this rank's rows, the same number
    of slabs on every rank (the most any rank's memory needs), so that the
    exchanges inside ``fn`` meet: ``sl`` is the slab's local rows and
    ``ranges[j]`` rank j's global rows of the same slab (on one device,
    ``mesh`` None, the slab's rows themselves)."""
    if mesh is None:
        return _by_slabs(lambda sl: fn(sl, [(sl.start, sl.stop)]),
                         int(off[1]), per_item, dev)
    size, r = mesh.size, mesh.rank
    nl = int(off[r + 1] - off[r])
    mine = torch.as_tensor([len(memory_blocks(max(nl, 1), per_item, dev))],
                           device=dev)
    n_s = int(mesh.all_gather(mine, [1] * size).max())
    cuts = [off[j] + split(int(off[j + 1] - off[j]), n_s)
            for j in range(size)]
    outs = []
    for s in range(n_s):
        ranges = [(int(c[s]), int(c[s + 1])) for c in cuts]
        lo, hi = ranges[r]
        outs.append(fn(slice(lo - off[r], hi - off[r]), ranges))
    return outs[0] if n_s == 1 else torch.cat(outs)


def _equations_packed(nk, nocc, nvir, kp3, mesh=None,
                      include_drive=True):
    """Batched-gather formulation of ``_equations``: identical math, one
    einsum over packed (nk, nk, nk, ...) tensors per term,
    ``resid(t1, t2, f, U) -> (r1, r2, e)``.  Aligned blocks contract
    directly; blocks whose k-labels are derived (via kp3) are gathered
    through index arrays.  Four contractions gather an (nk^4, o^2
    v^2)-sized operand (34.8 GB complex128 at nk 27, 16 spin orbitals):
    they run over memory blocks of the leading k axis
    (``utils.device.memory_blocks``), as do the two nk^4-gathered T2
    updates.

    ``include_drive=False`` drops the T2 driving term conj(<ij||ab>), the
    ONE conj(U) in the residual, so the returned function is holomorphic
    in U; ``lambda_rdm2`` adds the driving's density contribution
    analytically.

    ``mesh`` (``parallel.mesh.make_device_mesh``): the same function over
    a mesh of ranks.  Rank r owns rows [off[r], off[r + 1])
    (``mesh.owned(nk)``) of the leading k index of every packed tensor of
    nk^3 blocks: it is given those rows of U, and computes those rows of
    the W intermediates and of the T2 residual (``r2`` is the rank's
    rows).  t1, t2 (and tau) and the one-body blocks are whole on every
    rank.  A term whose integral or intermediate is read at a leading
    index other than the output row (a kconserv gather with a permuted
    leading label) fetches exactly those blocks with one exchange
    (:func:`_sgather`); the k-diagonal F intermediates, the T1 residual
    and the energy sum the ranks' partial sums (all-reduces).  U and the
    W intermediates take 1/ndev of the single-device memory on each rank,
    beside the exchanged blocks of one term at a time.  On one device
    (``mesh`` None) the rank owns every row, a gather is plain indexing
    and a sum over the ranks is the identity.
    """
    mesh = check_mesh(mesh)
    o, v = slice(0, nocc), slice(nocc, nocc + nvir)
    KP = np.asarray(kp3)
    size, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if nk < size:
        raise ValueError(f"{size} ranks for {nk} k-points: a rank would own "
                         "no rows")
    off = split(nk, size)
    x0, x1 = int(off[r]), int(off[r + 1])
    nl = x1 - x0
    ar = np.arange(nk)
    whole = [(int(off[j]), int(off[j + 1])) for j in range(size)]
    reduce = (lambda t: t) if mesh is None else mesh.all_reduce

    def g3(lo, hi):
        return np.arange(lo, hi)[:, None, None], ar[None, :, None], \
            ar[None, None, :]

    def g4(lo, hi):
        return (np.arange(lo, hi)[:, None, None, None],
                ar[None, :, None, None], ar[None, None, :, None],
                ar[None, None, None, :])

    def swap01(lo, hi):                       # T[y, x, z]
        X, Y, Z = g3(lo, hi)
        return Y, X, Z

    def zkx(lo, hi):                          # T[z, kp(x, y, z), x]
        X, Y, Z = g3(lo, hi)
        return Z, KP[X, Y, Z], X

    def yx_kp(lo, hi):                        # T[y, x, kp(y, x, z)]
        X, Y, Z = g3(lo, hi)
        return Y, X, KP[Y, X, Z]

    def w_kpxyw_z(lo, hi):                    # T[w, kp(x, y, w), z]
        X, Y, Z, W = g4(lo, hi)
        return W, KP[X, Y, W], Z

    def w_kpxyz_kpxwz(lo, hi):            # T[w, kp(x, y, z), kp(x, w, z)]
        X, Y, Z, W = g4(lo, hi)
        return W, KP[X, Y, Z], KP[X, W, Z]

    def z_kpxyz_w(lo, hi):                    # T[z, kp(x, y, z), w]
        X, Y, Z, W = g4(lo, hi)
        return Z, KP[X, Y, Z], W

    def sg(t_loc, idx_fn, ranges=whole):
        return _sgather(t_loc, idx_fn, mesh, ranges, off)

    def swap(t_loc):
        """T[y, x, ...] on this rank's rows (a view on one device)."""
        return t_loc.transpose(0, 1) if mesh is None else sg(t_loc, swap01)

    def rows_of_whole(t_loc):
        """This rank's rows of a k-diagonal (nk, ...) tensor, zero
        elsewhere: its share of a sum over the ranks."""
        if mesh is None:
            return t_loc
        z = t_loc.new_zeros
        return torch.cat([z((x0,) + t_loc.shape[1:]), t_loc,
                          z((nk - x1,) + t_loc.shape[1:])])

    def resid(t1, t2, f, U):
        foo, fov, fvo, fvv = _blocks(f)
        T2 = t2
        dev = U.device
        ti = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                       device=dev)
        ein = torch.einsum
        item = U.element_size()
        # bytes of one leading-axis slab of an (nk^4, o^2 v^2 or v^4)
        # gathered operand, with room for einsum's permuted copies
        slab = 4 * nk ** 3 * max(nocc, nvir) ** 2 * nvir ** 2 * item
        L = slice(x0, x1)
        X2, Y2 = ti(ar[:, None]), ti(ar[None, :])
        X2l, X2g = ti(np.arange(nl)[:, None]), ti(np.arange(x0, x1)[:, None])
        X3l = ti(np.arange(nl)[:, None, None])
        Y3, Z3 = ti(ar[None, :, None]), ti(ar[None, None, :])
        Y4 = ti(ar[None, :, None, None])
        Z4, W4 = ti(ar[None, None, :, None]), ti(ar[None, None, None, :])
        KPt = ti(KP)
        KPl = KPt[x0:x1]                          # kp(x, y, z), local x
        kj4 = KPl[:, :, :, None]

        # integral slabs: views of U
        Uoooo = U[..., o, o, o, o]
        Uooov = U[..., o, o, o, v]
        Uoovo = U[..., o, o, v, o]
        Uoovv = U[..., o, o, v, v]
        Uovov = U[..., o, v, o, v]
        Uovvo = U[..., o, v, v, o]
        Uovoo = U[..., o, v, o, o]
        Uovvv = U[..., o, v, v, v]
        Uvovv = U[..., v, o, v, v]
        Uvvvo = U[..., v, v, v, o]
        Uvvvv = U[..., v, v, v, v]

        # ---- tau (t1 parts are momentum-diagonal: scatter-add; whole on
        # every rank) ----
        t1t1 = ein("kia,ljb->klijab", t1, t1)
        t1t1x = ein("kib,lja->klijab", t1, t1)
        tadd = torch.zeros_like(T2).index_put((X2, Y2, X2), t1t1,
                                              accumulate=True)
        tadd = tadd.index_put((X2, Y2, Y2), -t1t1x, accumulate=True)
        tau = T2 + tadd
        tau_t = T2 + 0.5 * tadd
        del tadd, t1t1, t1t1x       # (the big intermediates go as soon
                                    # as they are spent: nk 27 runs near
                                    # the device's capacity)

        # ---- F intermediates (k-diagonal, shape (nk, ...)): the ranks'
        # partial sums, reduced ----
        fae = (ein("xmf,xkmafe->kae", t1[L], Uovvv[X2l, Y2, X2g])
               - 0.5 * ein("xykmnaf,xykmnef->kae", tau_t[L], Uoovv))
        fmi = rows_of_whole(
            ein("yne,kymnie->kmi", t1, Uooov[X2l, Y2, X2g])
            + 0.5 * ein("kxyinef,kxymnef->kmi", tau_t[L], Uoovv))
        fme = rows_of_whole(ein("ynf,kymnef->kme", t1, Uoovv[X2l, Y2, X2g]))
        del tau_t
        n_ae, n_mi = fae.numel(), fmi.numel()
        red = reduce(torch.cat([fae.reshape(-1), fmi.reshape(-1),
                                fme.reshape(-1)]))
        f_ae = fvv - 0.5 * ein("kma,kme->kae", t1, fov) \
            + red[:n_ae].reshape(fae.shape)
        f_mi = foo + 0.5 * ein("kie,kme->kmi", t1, fov) \
            + red[n_ae:n_ae + n_mi].reshape(fmi.shape)
        f_me = fov + red[n_ae + n_mi:].reshape(fme.shape)

        # ---- T1 residual and the energy: whole parts + partial sums ----
        r1_p = (-ein("ynf,yknaif->kia", t1[L], Uovov[X2l, Y2, Y2])
                - 0.5 * ein("kxyimef,kxymaef->kia", T2[:, L],
                            Uovvv.transpose(0, 1))
                - 0.5 * ein("xykmnae,xyknmei->kia", T2[:, L],
                            Uoovo[ti(np.arange(nl)[None, :, None]),
                                  ti(ar[:, None, None]),
                                  KPt[ti(ar[:, None, None]),
                                      ti(np.arange(x0, x1)[None, :, None]),
                                      Z3]]))
        e_p = (0.5 * ein("xyijab,xia,yjb->", Uoovv[X2l, Y2, X2g], t1[L], t1)
               + 0.25 * ein("xyzijab,xyzijab->", Uoovv, T2[L]))
        red = reduce(torch.cat([r1_p.reshape(-1), e_p.reshape(1)]))
        r1 = (fvo.transpose(1, 2)
              + ein("kie,kae->kia", t1, f_ae)
              - ein("kma,kmi->kia", t1, f_mi)
              + ein("kximae,xme->kia", T2[X2, Y2, X2], f_me)
              + red[:-1].reshape(r1_p.shape))
        e = ein("kia,kia->", fov, t1) + red[-1]

        # ---- W_mnij, rows x = km, blocks [x, y=kn, z=ki]
        # (kj = kp(x, y, z)) ----
        t1_g = t1[KPl]
        raw_o = ein("xyzje,xyzmnie->xyzmnij", t1_g, Uooov)
        w_oooo = (Uoooo + raw_o
                  - raw_o[X3l, Y3, KPl].transpose(-1, -2)
                  + _by_slabs(lambda sl: 0.25 * ein(
                      "xyzwijef,xywmnef->xyzmnij",
                      tau[Z4, kj4[sl], W4], Uoovv[sl]), nl, slab, dev))
        del raw_o

        # ---- W_abef, rows x = ka, blocks [x, y=kb, z=ke] ----
        raw_v = ein("ymb,xyzamef->xyzabef", t1, Uvovv)
        w_vvvv = (Uvvvv - raw_v + swap(raw_v).transpose(3, 4)
                  + _by_slabs_mesh(lambda sl, rg: 0.25 * ein(
                      "xywmnab,xyzwmnef->xyzabef",
                      tau[Z3, KPl[sl], X2g[sl][:, :, None]],
                      sg(Uoovv, w_kpxyw_z, rg)), mesh, off, slab, dev))
        del raw_v

        # ---- W_mbej, rows x = km, blocks [x, y=kb, z=ke]
        # (kj = kp(x, y, z)) ----
        kf_g = KPt[kj4, W4, Y4]
        w_ovvo = (Uovvo
                  + ein("xyzjf,xyzmbef->xyzmbej", t1_g, Uovvv)
                  - ein("ynb,xyzmnej->xyzmbej", t1, Uoovo)
                  - ein("xyzjf,ynb,xyzmnef->xyzmbej", t1_g, t1, Uoovv)
                  - _by_slabs(lambda sl: 0.5 * ein(
                      "xyzwjnfb,xwzmnef->xyzmbej",
                      T2[kj4[sl], W4, kf_g[sl]], Uoovv[sl]), nl, slab, dev))

        # ---- T2 residual, rows x = ki, blocks [x, y=kj, z=ka]
        # (kb = kp(x, y, z)) ----
        f_be_t = f_ae - 0.5 * ein("kmb,kme->kbe", t1, f_me)
        f_mj_t = f_mi + 0.5 * ein("kje,kme->kmj", t1, f_me)
        T2l = T2[L]
        raw_ab = (ein("xyzijae,xyzbe->xyzijab", T2l, f_be_t[KPl])
                  - ein("zma,xyzmbij->xyzijab", t1, sg(Uovoo, zkx)))
        raw_ij = (-ein("xyzimab,ymj->xyzijab", T2l, f_mj_t)
                  + ein("xie,xyzabej->xyzijab", t1[L], sg(Uvvvo, zkx)))
        raw_z = (-ein("xie,zma,xyzmbej->xyzijab", t1[L], t1,
                      sg(Uovvo, zkx))
                 + _by_slabs_mesh(lambda sl, rg: ein(
                     "xwzimae,xyzwmbej->xyzijab", T2l[sl],
                     sg(w_ovvo, w_kpxyz_kpxwz, rg)), mesh, off, slab, dev))
        del w_ovvo
        r2 = Uoovv.conj() if include_drive else torch.zeros_like(T2l)
        r2 = r2 + (raw_ab - raw_ab[X3l, Y3, KPl].transpose(-1, -2))
        del raw_ab
        r2 = r2 + (raw_ij - swap(raw_ij).transpose(3, 4))
        del raw_ij
        z_ab = raw_z[X3l, Y3, KPl]
        r2 = r2 + (raw_z
                   - swap(raw_z).transpose(3, 4)
                   - z_ab.transpose(-1, -2)
                   + sg(raw_z, yx_kp).transpose(3, 4).transpose(-1, -2))
        del raw_z, z_ab
        r2 = r2 + _by_slabs_mesh(lambda sl, rg: 0.5 * ein(
            "xyzwmnab,xywmnij->xyzijab",
            tau[W4, KPt[X2g[sl][:, :, None, None], Y4, W4], Z4],
            sg(w_oooo, zkx, rg)), mesh, off, slab, dev)
        r2 = r2 + _by_slabs_mesh(lambda sl, rg: 0.5 * ein(
            "xywijef,xyzwabef->xyzijab", tau[L][sl],
            sg(w_vvvv, z_kpxyz_w, rg)), mesh, off, slab, dev)
        return r1, r2, e

    return resid


def _hf_fock_so(df, mf):
    """Reference-determinant HF Fock (h + J - K) in the spin-orbital MO
    basis, J/K served from the ISDF state (integral-consistent with
    make_eris) at the converged density: CC on non-HF (KS) references
    takes the full one-body blocks, and only their (real) diagonal goes
    into the denominators.  Returns (f_so (nk, nso, nso) numpy, nocc_so)."""
    cs, _, spins, nocc = _spinorb_mo(mf)
    dm = np.asarray(to_numpy(mf.dm))
    dms = np.stack([dm / 2.0, dm / 2.0]) if dm.ndim == 3 else dm
    exxdiv = getattr(mf, "exxdiv", None)
    vja, vka = (to_numpy(a) for a in df.get_jk(dms[0], exxdiv=exxdiv))
    vjb, vkb = (to_numpy(a) for a in df.get_jk(dms[1], exxdiv=exxdiv))
    vj = vja + vjb
    h1e = np.asarray(to_numpy(mf.h1e))
    focks = [h1e + vj - vka, h1e + vj - vkb]
    nk, nao, nso = cs.shape
    f_so = np.zeros((nk, nso, nso), dtype=complex)
    for k in range(nk):
        for s in range(2):
            sel = np.where(spins[k] == s)[0]
            c = cs[k][:, sel]
            f_so[k][np.ix_(sel, sel)] = c.conj().T @ focks[s][k] @ c
    return f_so, nocc


def _denominators(nk, kp3, eo, ev, dev):
    """D1 (nk, o, v) = e_i - e_a and D2 (nk, nk, nk, o, o, v, v) = e_i +
    e_j - e_a - e_b of the packed blocks, on ``dev`` in float64."""
    eo_t = torch.as_tensor(np.asarray(eo, dtype=np.float64), device=dev)
    ev_t = torch.as_tensor(np.asarray(ev, dtype=np.float64), device=dev)
    kb = torch.as_tensor(np.asarray(kp3), dtype=torch.int64, device=dev)
    ar = torch.arange(nk, device=dev)
    d1 = eo_t[:, :, None] - ev_t[:, None, :]
    d2 = (eo_t[ar][:, None, None, :, None, None, None]
          + eo_t[ar][None, :, None, None, :, None, None]
          - ev_t[ar][None, None, :, None, None, :, None]
          - ev_t[kb][:, :, :, None, None, None, :])
    return d1, d2


def _canonical_fock(nk, eo, ev, dtype, dev):
    """(foo, fov, fvo, fvv) of a canonical reference: diag(eo), 0, 0,
    diag(ev)."""
    eo_t = torch.as_tensor(np.asarray(eo), device=dev).to(dtype)
    ev_t = torch.as_tensor(np.asarray(ev), device=dev).to(dtype)
    no, nv = eo_t.shape[1], ev_t.shape[1]
    return (torch.diag_embed(eo_t),
            torch.zeros((nk, no, nv), dtype=dtype, device=dev),
            torch.zeros((nk, nv, no), dtype=dtype, device=dev),
            torch.diag_embed(ev_t))


def make_step(nk, nocc, nvir, kp3, eo, ev, f_so=None, mesh=None):
    """Build the CCSD update ``step(t1, t2, U) -> (t1, t2, e)``.

    kp3[a,b,c] = index of k_a + k_b - k_c.  ``e`` is the supercell
    correlation energy at the *input* amplitudes (so the first call from
    the MP2 guess reports E_MP2).  U must already carry the supercell
    normalisation (cell ERIs / nk).  With ``f_so=None`` (canonical
    reference) the one-body blocks handed to the equations are
    diag(eo/ev); a full ``f_so`` (nk, nso, nso) enables non-canonical /
    non-HF references: its off-diagonals enter the residual while eo/ev
    (its real diagonal) stay in the denominators.  The update is t + R/D
    (Jacobi on the full residual of ``_equations_packed``).

    ``mesh``: U is this rank's rows ``mesh.owned(nk)`` of the leading k
    index (the residual over the mesh, ``_equations_packed(mesh=)``); t1
    and t2 go in and come out whole on every rank (the new t2's rows are
    all-gathered), as does e.
    """
    resid = _equations_packed(nk, nocc, nvir, kp3, mesh=mesh)
    if mesh is not None:
        off = split(nk, mesh.size)
        rows = slice(int(off[mesh.rank]), int(off[mesh.rank + 1]))
    cache = {}

    def step(t1, t2, U):
        dev, cdt = U.device, U.dtype
        if dev not in cache:
            d1, d2 = _denominators(nk, kp3, eo, ev, dev)
            if f_so is None:
                f = _canonical_fock(nk, eo, ev, cdt, dev)
            else:
                fs = as_tensor(np.asarray(f_so), dev, cdt)
                o, vs = slice(0, nocc), slice(nocc, nocc + nvir)
                f = (fs[:, o, o], fs[:, o, vs], fs[:, vs, o], fs[:, vs, vs])
            cache[dev] = (d1, d2, f)
        d1, d2, f = cache[dev]
        r1, r2, e = resid(t1, t2, f, U)
        if mesh is None:
            return t1 + r1 / d1, t2 + r2 / d2, e
        t2_loc = t2[rows] + r2 / d2[rows]
        return t1 + r1 / d1, mesh.all_gather(t2_loc, np.diff(off)), e

    return step


def _pack(t1, t2, nk):
    """Amplitudes -> one vector on their device: t1 then the packed t2
    blocks in (ki, kj, ka) order (the JAX package's host vector)."""
    return torch.cat([t1.reshape(-1), t2.reshape(-1)])



def _unpack_dev(vec, nk, nocc, nvir):
    """One amplitude vector -> (t1, packed t2) views."""
    n1 = nk * nocc * nvir
    return (vec[:n1].reshape(nk, nocc, nvir),
            vec[n1:].reshape((nk,) * 3 + (nocc, nocc, nvir, nvir)))


class AmplitudeDIIS:
    """Pulay DIIS over amplitude vectors, resident on their device.

    The last ``space`` (vector, error) rows sit in a ring buffer, and the
    error Gram matrix B is updated by one row a cycle; the coefficients are
    ``scf.core.diis_coefficients``', as every DIIS of the port takes them.  The coefficients do not depend on the order of the rows, so the
    ring gives the JAX package's host DIIS (``scf.hf.DIIS`` without
    densities) its iterates."""

    def __init__(self, space, like):
        self.space = int(space)
        n = like.numel()
        self.vecs = torch.empty((self.space, n), dtype=like.dtype,
                                device=like.device)
        self.errs = torch.empty_like(self.vecs)
        self.b = torch.zeros((self.space, self.space), dtype=like.dtype,
                             device=like.device)
        self.count = 0

    def update(self, vec, err):
        slot = self.count % self.space
        self.count += 1
        m = min(self.count, self.space)
        self.vecs[slot] = vec
        self.errs[slot] = err
        row = torch.mv(self.errs[:m], err.conj()).conj()   # <e_i, e_new>
        self.b[:m, slot] = row
        self.b[slot, :m] = row.conj()
        live = torch.ones(m, dtype=torch.bool, device=row.device)
        return diis_coefficients(self.b[:m, :m], live) @ self.vecs[:m]


def _cc_iterate(step, t1, t2, U, nk, conv_tol, max_cycle, diis_space,
                energy_test, verbose=0):
    """Jacobi steps with amplitude DIIS from (t1, t2).  Converged when the
    rms step is below ``conv_tol`` (and, with ``energy_test``, the energy
    moved less than that).  One small tensor is fetched a cycle.  Returns
    (t1, t2, converged, niter, dt_max, trace) with ``trace`` the per-cycle
    energies (per cell, at each cycle's input amplitudes) and wall
    seconds."""
    nocc, nvir = t1.shape[1], t1.shape[2]
    vec_old = _pack(t1, t2, nk)
    diis = AmplitudeDIIS(diis_space, vec_old)
    e_old = 0.0
    conv = False
    niter = 0
    dt_max = 0.0
    trace = {"energies": [], "cycle_s": []}
    t0 = time.perf_counter()
    for it in range(max_cycle):
        t1n, t2n, e_dev = step(t1, t2, U)
        vec_new = _pack(t1n, t2n, nk)
        err = vec_new - vec_old
        # rms convergence: the max-norm stalls on a few oscillating
        # near-degenerate components long after the energy and the
        # amplitude rms converged
        stats = torch.stack([e_dev.real, e_dev.imag,
                             torch.linalg.vector_norm(err).to(e_dev.real.dtype),
                             err.abs().max().to(e_dev.real.dtype)])
        vec_old = diis.update(vec_new, err)
        t1, t2 = _unpack_dev(vec_old, nk, nocc, nvir)
        e_re, e_im, nrm, dt_max = stats.tolist()
        dt = nrm / np.sqrt(err.numel())
        e = complex(e_re, e_im) / nk     # per cell
        niter = it + 1
        t1_ = time.perf_counter()
        trace["energies"].append(e.real)
        trace["cycle_s"].append(t1_ - t0)
        t0 = t1_
        if verbose:
            print(f"cycle {niter}: e_corr={e.real:.10f} rms(dt)={dt:.2e} "
                  f"max={dt_max:.2e}")
        if dt < conv_tol and (not energy_test
                              or abs(e.real - e_old) < conv_tol):
            conv = True
            break
        e_old = e.real
    return t1, t2, conv, niter, dt_max, trace


def _synced_seconds(x, t0):
    """Wall seconds since ``t0`` once the device holding ``x`` is idle."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return time.perf_counter() - t0


def _kp3(df):
    k3c = np.asarray(df.kconserv3())
    return np.ascontiguousarray(k3c.transpose(0, 2, 1)).astype(np.int64)


def _mp2_guess(U, nocc, eo, ev, kp3, mesh=None):
    """t2 = conj(<ij||ab>) / D on U's device (t1 = 0); with ``mesh`` from
    the rank's rows of U, the rows all-gathered."""
    nk = len(kp3)
    _, d2 = _denominators(nk, kp3, eo, ev, U.device)
    if mesh is None:
        return U[..., :nocc, :nocc, nocc:, nocc:].conj() / d2
    off = split(nk, mesh.size)
    t2 = (U[..., :nocc, :nocc, nocc:, nocc:].conj()
          / d2[int(off[mesh.rank]):int(off[mesh.rank + 1])])
    return mesh.all_gather(t2, np.diff(off))


def kccsd(df, mf, conv_tol=1e-7, max_cycle=60, diis_space=8, verbose=0,
          return_amps=False, reference="auto", dev_mesh=None):
    """CCSD correlation energy per cell from a converged ``mf`` on the
    ISDF factorisation ``df``, on the device of ``df``.  Returns (e_corr,
    info).

    Spin-orbital formulation: restricted and unrestricted references run
    through the same code.  ``reference``: 'canonical' assumes diagonal
    fock = mo_energy (HF); 'fock' rebuilds the reference-determinant HF
    fock from the ISDF state and runs the full-one-body equations,
    required for KS (KRKS/KUKS) references; 'auto' picks 'fock' when
    ``mf.xc`` exists and is not 'hf'.  The correlation energy is then
    relative to the HF energy *functional at the reference determinant*;
    for a 2-electron system E_det(ref) + E_corr is reference-independent
    (= FCI).  ``dev_mesh`` (``parallel.mesh.make_device_mesh``, its rank
    on ``df``'s device; ``df`` a single-device build, whole on every rank):
    each rank assembles and keeps its rows of the leading k index of U and
    runs the residual over the mesh (``_equations_packed(mesh=)``); the
    amplitudes, DIIS and the energy are whole on every rank.  Beside the JAX
    package's keys, ``info`` holds the per-cycle ``energies`` (per cell,
    at each cycle's input amplitudes: the first is the MP2 energy), their
    wall seconds ``cycle_s``, and ``eris_s``, the integral assembly's.
    """
    mesh = check_mesh(dev_mesh)
    if mesh is not None and mesh.device != df.device:
        raise ValueError(f"the mesh rank's device {mesh.device} is not "
                         f"df's {df.device}")
    if reference == "auto":
        reference = ("fock" if getattr(mf, "xc", "hf")
                     not in (None, "hf") else "canonical")
    nk = df.nkpt
    t0 = time.perf_counter()
    U, eo, ev, nocc = make_eris_dev(
        df, mf, rows=None if mesh is None else mesh.owned(nk))
    eris_s = _synced_seconds(U, t0)
    f_so = None
    if reference == "fock":
        f_so, _ = _hf_fock_so(df, mf)
        eo = np.real(np.stack([np.diag(f_so[k])[:nocc] for k in range(nk)]))
        ev = np.real(np.stack([np.diag(f_so[k])[nocc:] for k in range(nk)]))
    nvir = ev.shape[1]
    if nocc == 0 or nvir == 0:
        return 0.0, {"converged": True, "niter": 0, "imag": 0.0,
                     "nocc": nocc}
    kp3 = _kp3(df)
    step = make_step(nk, nocc, nvir, kp3, eo, ev, f_so=f_so, mesh=mesh)
    U /= nk                                   # supercell normalisation
    t1 = torch.zeros((nk, nocc, nvir), dtype=U.dtype, device=U.device)
    t2 = _mp2_guess(U, nocc, eo, ev, kp3, mesh=mesh)
    t1, t2, conv, niter, dt_max, trace = _cc_iterate(
        step, t1, t2, U, nk, conv_tol, max_cycle, diis_space, True,
        verbose)
    # energy at the final mixed amplitudes
    e = complex(step(t1, t2, U)[2].item()) / nk
    info = {"converged": conv, "niter": niter, "dt_max": dt_max,
            "imag": float(e.imag), "nocc": nocc, "reference": reference,
            "eris_s": eris_s, **trace}
    if return_amps:
        info["t1"], info["t2"], info["U"] = t1, t2, U
        info["eo"], info["ev"], info["kp3"] = eo, ev, kp3
    return float(e.real), info


# ----------------------------------------------------------------------
# EOM-EE-CCSD via the CCSD Jacobian
# ----------------------------------------------------------------------

def _residual_fn(nk, nocc, nvir, kp3, eo_, ev_, U_dev):
    """The packed CCSD residual R(t) = D (step(t) - t), its matvec
    ``matvec(tvec, x)`` = J x by ``torch.func.jvp`` (x a vector, or a
    block (ntot, nb) whose columns are applied under ``torch.func.vmap``),
    and the denominator vector (numpy)."""
    step = make_step(nk, nocc, nvir, kp3, eo_, ev_)
    d1, d2 = _denominators(nk, kp3, eo_, ev_, U_dev.device)
    dvec = _pack(d1, d2, nk)

    def residual(vec):
        t1, t2 = _unpack_dev(vec, nk, nocc, nvir)
        t1n, t2n, _ = step(t1, t2, U_dev)
        return dvec * (_pack(t1n, t2n, nk) - vec)

    def jvp(tvec, x):
        return torch.func.jvp(residual, (tvec,), (x,))[1]

    def matvec(tvec, x):
        if x.dim() == 1:
            return jvp(tvec, x)
        return torch.func.vmap(lambda c: jvp(tvec, c), in_dims=1,
                               out_dims=1)(x)

    return residual, matvec, to_numpy(dvec)


_JAC_COLUMNS = 256      # unit tangents pushed through the residual at once


def _tangent_bytes(nk, nocc, nvir, itemsize=16):
    """Bytes of one tangent's pass through the residual: its largest
    intermediates are (nk^4, o^2 v^2)- and (nk^4, v^4)-sized gathers."""
    return 16 * itemsize * (nk ** 4 * max(nocc, nvir) ** 2 * nvir ** 2
                            + nk * nocc * nvir
                            + nk ** 3 * (nocc * nvir) ** 2)


def _jacobian_cols(fn, tvec, cols, per_col):
    """J @ cols for the Jacobian J of a holomorphic ``fn`` at ``tvec``:
    forward mode along each column (``torch.func.jacfwd`` refuses complex
    inputs), ``per_col`` bytes a column, at most ``_JAC_COLUMNS`` a
    block."""
    n = cols.shape[1]
    width = min(_JAC_COLUMNS, memory_blocks(n, per_col, tvec.device)[0].stop)
    out = [torch.func.vmap(lambda c: torch.func.jvp(fn, (tvec,), (c,))[1],
                           in_dims=1, out_dims=1)(cols[:, i:i + width])
           for i in range(0, n, width)]
    return torch.cat(out, dim=1)


def _jacobian(nk, nocc, nvir, kp3, eo_, ev_, t1_conv, t2_conv, U_dev,
              cols):
    """J @ cols (numpy) for the Jacobian J = dR/dt of the packed CCSD
    residual at (t1, t2) and (ntot, m) columns ``cols``: the EOM paths
    take J on the independent amplitudes only (the JAX package forms all
    of J, then B^T J B: the same matrix, one jvp a column)."""
    residual, _, _ = _residual_fn(nk, nocc, nvir, kp3, eo_, ev_, U_dev)
    tvec = _pack(t1_conv, t2_conv, nk).to(U_dev.dtype)
    return to_numpy(_jacobian_cols(residual, tvec,
                                   as_tensor(cols, tvec.device, tvec.dtype),
                                   _tangent_bytes(nk, nocc, nvir)))


def _amp_basis(nk, nocc, nvir, kp3):
    """Orthonormal columns spanning the independent (antisymmetric)
    amplitude components, as (labels, columns): labels are
    ('s', k, i, a) / ('d', ki, i, kj, j, ka, a, kb, b).  Dense, for the
    fixture-scale paths; :class:`AmpBasis` is the same map without the
    matrix."""
    n1 = nk * nocc * nvir
    blk = nocc * nocc * nvir * nvir
    ntot = n1 + nk ** 3 * blk
    cols, labels = [], []
    for k in range(nk):
        for i in range(nocc):
            for a in range(nvir):
                col = np.zeros(ntot)
                col[(k * nocc + i) * nvir + a] = 1.0
                cols.append(col)
                labels.append(("s", k, i, a))

    def comp(k, p):
        return k * (nocc + nvir) + p

    idx2 = {}
    off = n1
    for ki in range(nk):
        for kj in range(nk):
            for ka in range(nk):
                kb = int(kp3[ki, kj, ka])
                for i in range(nocc):
                    for j in range(nocc):
                        for a in range(nvir):
                            for b in range(nvir):
                                idx2[(ki, i, kj, j, ka, a, kb, b)] = (
                                    off + ((i * nocc + j) * nvir + a)
                                    * nvir + b)
                off += blk
    for (ki, i, kj, j, ka, a, kb, b), pos in idx2.items():
        if comp(ki, i) >= comp(kj, j) or comp(ka, a) >= comp(kb, b):
            continue
        col = np.zeros(ntot)
        col[pos] = 0.5
        col[idx2[(kj, j, ki, i, ka, a, kb, b)]] = -0.5
        col[idx2[(ki, i, kj, j, kb, b, ka, a)]] = -0.5
        col[idx2[(kj, j, ki, i, kb, b, ka, a)]] = 0.5
        cols.append(col)
        labels.append(("d", ki, i, kj, j, ka, a, kb, b))
    return labels, np.stack(cols, axis=1)


def _sorted_eigvals(m):
    """Eigenvalues of a small dense matrix, sorted as np.sort_complex
    (torch's LAPACK on the host, on torch's thread pool)."""
    return np.sort_complex(to_numpy(torch.linalg.eigvals(
        torch.as_tensor(np.asarray(m)))))


class AmpBasis:
    """The independent-amplitude basis B of :func:`_amp_basis` (the same
    columns in the same order) as index tensors: a singles column is one
    unit entry, a doubles column the four entries of an antisymmetric
    (i j | a b) quadruple with weights (1/2, -1/2, -1/2, 1/2).  ``apply``
    is B c, ``adjoint`` B^T y (the weights are real); no (ntot, m) matrix
    is formed."""

    WEIGHTS = (0.5, -0.5, -0.5, 0.5)

    def __init__(self, nk, nocc, nvir, kp3, device):
        kp3 = np.asarray(kp3)
        o, v = nocc, nvir
        n1 = nk * o * v
        blk = o * o * v * v
        self.ntot = n1 + nk ** 3 * blk
        g = np.meshgrid(*([np.arange(nk)] * 3), np.arange(o), np.arange(o),
                        np.arange(v), np.arange(v), indexing="ij")
        ki, kj, ka, i, j, a, b = (x.ravel() for x in g)
        kb = kp3[ki, kj, ka]

        def pos(k1, k2, k3, p, q, r, s):
            return (n1 + ((k1 * nk + k2) * nk + k3) * blk
                    + ((p * o + q) * v + r) * v + s)

        keep = ((ki * (o + v) + i < kj * (o + v) + j)
                & (ka * (o + v) + a < kb * (o + v) + b))
        ki, kj, ka, kb, i, j, a, b = (x[keep] for x in (ki, kj, ka, kb, i, j,
                                                        a, b))
        dpos = np.stack([pos(ki, kj, ka, i, j, a, b),
                         pos(kj, ki, ka, j, i, a, b),
                         pos(ki, kj, kb, i, j, b, a),
                         pos(kj, ki, kb, j, i, b, a)], axis=1)
        self.n1 = n1
        self.shape = (self.ntot, n1 + dpos.shape[0])
        self.dpos_np = dpos
        self.dpos = torch.as_tensor(dpos, dtype=torch.int64, device=device)

    def apply(self, c):
        """B c for c (m,) or (m, nb)."""
        n1 = self.n1
        out = torch.zeros((self.ntot,) + tuple(c.shape[1:]), dtype=c.dtype,
                          device=c.device)
        out[:n1] = c[:n1]
        for j, w in enumerate(self.WEIGHTS):
            out.index_put_((self.dpos[:, j],), w * c[n1:], accumulate=True)
        return out

    def adjoint(self, y):
        """B^T y for y (ntot,) or (ntot, nb)."""
        d = sum(w * y[self.dpos[:, j]] for j, w in enumerate(self.WEIGHTS))
        return torch.cat([y[:self.n1], d])

    def diag_of(self, dvec):
        """diag(B^T diag(dvec) B) (numpy), for a numpy ``dvec``."""
        d = sum(w * w * dvec[self.dpos_np[:, j]]
                for j, w in enumerate(self.WEIGHTS))
        return np.concatenate([dvec[:self.n1], d])

    def dense(self, dtype=torch.float64):
        """B as a dense (ntot, m) tensor (fixture scale)."""
        dev = self.dpos.device
        return self.apply(torch.eye(self.shape[1], dtype=dtype, device=dev))


def eom_dense(nk, nocc, nvir, kp3, eo_, ev_, t1_conv, t2_conv, U_dev):
    """Dense EOM-EE eigenvalues from converged amplitudes (see eomee).

    The ground-state amplitude space IS the q = 0 (optical) momentum
    sector (t1 is k-diagonal and every t2 block conserves momentum), so
    the Jacobian spans exactly the zero-momentum-transfer EOM-EE block."""
    bmat = to_numpy(AmpBasis(nk, nocc, nvir, kp3, U_dev.device).dense())
    jb = _jacobian(nk, nocc, nvir, kp3, eo_, ev_, t1_conv, t2_conv, U_dev,
                   cols=bmat)
    return _sorted_eigvals(bmat.T @ jb)


def _canonical_amps(df, mf, conv_tol, max_cycle, verbose, what):
    """kccsd with amplitudes, converged, on a canonical reference."""
    e_cc, info = kccsd(df, mf, conv_tol=conv_tol, max_cycle=max_cycle,
                       verbose=verbose, return_amps=True)
    if not info["converged"]:
        raise RuntimeError("kccsd did not converge; EOM needs R = 0")
    if info.get("reference") == "fock":
        raise NotImplementedError(
            f"{what} assumes a canonical (diagonal-fock HF) reference")
    info["e_ccsd"] = e_cc
    return info


def eomee(df, mf, conv_tol=1e-8, max_cycle=80, verbose=0):
    """EOM-EE-CCSD excitation energies (zero-momentum-transfer sector).

    At converged amplitudes the CCSD residual Jacobian J = dR/dt equals
    <Phi_mu| Hbar |Phi_nu> - E 1 on the singles+doubles space, so its
    eigenvalues ARE the EOM-EE excitation energies.  J comes from forward
    mode of the holomorphic residual, projected onto the independent
    amplitudes.  Returns (omega, info): complex eigenvalues sorted by real
    part.  Dense diagonalisation, fixture scale; :func:`eomee_davidson` is
    the matrix-free path."""
    info = _canonical_amps(df, mf, conv_tol, max_cycle, verbose, "EOM")
    w = eom_dense(df.nkpt, info["nocc"], info["ev"].shape[1], info["kp3"],
                  info["eo"], info["ev"], info["t1"], info["t2"], info["U"])
    return w, info


def _orthonormal_extend(V, new, drop=1e-12):
    """Columns of ``new`` orthonormalised against the orthonormal ``V``
    and each other (two Gram-Schmidt passes); near-dependent ones
    dropped."""
    out = []
    for c in new.T:
        for _ in range(2):
            if V.shape[1]:
                c = c - V @ (V.mT.conj() @ c)
            for q in out:
                c = c - q * torch.vdot(q, c)
        nrm = float(torch.linalg.vector_norm(c))
        if nrm > drop:
            out.append(c / nrm)
    return torch.stack(out, 1) if out else new[:, :0]


def eom_davidson(matvec_amp, bmat, diag, nroots=4, tol=1e-7,
                 max_space=60, max_cycle=200):
    """Matrix-free non-Hermitian Davidson for the lowest-real-part
    eigenvalues of the EOM block M = B^T J B (B: an :class:`AmpBasis`; J
    applied only through ``matvec_amp``, which takes an (ntot, nb)
    block).

    ``diag``: approximate diagonal of M for the preconditioner (the
    excitation-energy denominators).  The subspace is the JAX package's:
    the same start (unit vectors at the lowest diagonals), corrections
    r / (diag - theta), restart from the Ritz vectors past ``max_space``;
    the basis is kept orthonormal and M V kept, so only new vectors are
    applied.  Returns (omega[nroots], converged)."""
    m = bmat.shape[1]
    nroots = min(nroots, m)
    dev = bmat.dpos.device
    diag_np = np.asarray(to_numpy(diag)).astype(complex)
    diag_t = torch.as_tensor(diag_np, device=dev)

    def apply_m(c):
        return bmat.adjoint(matvec_amp(bmat.apply(c)))

    order = np.argsort(diag_np.real)
    V = torch.zeros((m, nroots), dtype=torch.complex128, device=dev)
    V[torch.as_tensor(order[:nroots], device=dev),
      torch.arange(nroots, device=dev)] = 1.0
    MV = apply_m(V)
    conv = False
    theta = np.zeros(nroots, dtype=complex)
    for _ in range(max_cycle):
        w, y = (to_numpy(a) for a in torch.linalg.eig(
            (V.mT.conj() @ MV).cpu()))
        sel = np.argsort(w.real)[:nroots]
        theta, yv = w[sel], torch.as_tensor(y[:, sel], device=dev)
        x = V @ yv
        r = MV @ yv - x * torch.as_tensor(theta, device=dev)[None, :]
        rn = to_numpy(torch.linalg.vector_norm(r, dim=0))
        if np.all(rn < tol):
            conv = True
            break
        if V.shape[1] + nroots > max_space:
            # restart from the Ritz vectors: V = x R^-1, M V = M x R^-1
            V, rr = torch.linalg.qr(x)
            MV = torch.linalg.solve_triangular(rr, MV @ yv, upper=True,
                                               left=False)
            continue
        new = []
        for j in range(nroots):
            if rn[j] < tol:
                continue
            denom = diag_t - theta[j]
            denom = torch.where(denom.abs() < 1e-8, 1e-8, denom)
            new.append(r[:, j] / denom)
        if not new:
            conv = True
            break
        q = _orthonormal_extend(V, torch.stack(new, 1))
        if q.shape[1] == 0:
            conv = True
            break
        V = torch.cat([V, q], 1)
        MV = torch.cat([MV, apply_m(q)], 1)
    return np.sort_complex(theta), conv


def eomee_davidson(df, mf, nroots=4, conv_tol=1e-8, max_cycle=80,
                   tol=1e-6, verbose=0):
    """Iterative (matrix-free) EOM-EE-CCSD: the lowest ``nroots`` q = 0
    excitation energies by Davidson on forward-mode matvecs of the
    residual, through :class:`AmpBasis` (neither the Jacobian nor the
    basis is materialised)."""
    info = _canonical_amps(df, mf, conv_tol, max_cycle, verbose, "EOM")
    nk = df.nkpt
    nocc, nvir = info["nocc"], info["ev"].shape[1]
    U = info["U"]
    _, matvec, dhost = _residual_fn(nk, nocc, nvir, info["kp3"],
                                    info["eo"], info["ev"], U)
    tvec = _pack(info["t1"], info["t2"], nk)
    basis = AmpBasis(nk, nocc, nvir, info["kp3"], U.device)
    diag = -basis.diag_of(dhost).astype(complex)   # diag of -D in the basis
    w, conv = eom_davidson(lambda x: matvec(tvec, x.to(U.dtype)), basis,
                           diag, nroots=nroots, tol=tol)
    info["eom_converged"] = conv
    return w, info


# ----------------------------------------------------------------------
# Lambda and the unrelaxed CCSD densities
# ----------------------------------------------------------------------

def _holo_grad(out, inputs):
    """The holomorphic derivative d out / d inputs of a complex scalar:
    reverse mode returns its conjugate."""
    gs = torch.autograd.grad(out, inputs, grad_outputs=torch.ones_like(out))
    return [g.conj() for g in gs]


def lambda_rdm(nk, nocc, nvir, kp3, eo_, ev_, t1_conv, t2_conv, U_dev):
    """Lambda (adjoint) solve and the unrelaxed CCSD one-particle
    density, with no hand-derived Lambda equations:

    - stationarity of L = E(t) + lambda^T R(t) in the amplitudes is the
      linear system J^T lambda = -dE/dt, with the same residual Jacobian
      the EOM path uses, solved on the independent-amplitude basis;
    - the density is gamma_pq = dL/df_pq (reverse mode through the
      one-body blocks, independent holomorphic arguments), plus the
      reference part delta_ij: the standard *unrelaxed* CCSD density.

    Returns ((goo, gov, gvo, gvv) per-k numpy blocks, lambda_packed).
    """
    resid = _equations_packed(nk, nocc, nvir, kp3)
    cdt, dev = U_dev.dtype, U_dev.device
    f0 = _canonical_fock(nk, eo_, ev_, cdt, dev)

    def rvec_e(vec, f):
        t1_, t2_ = _unpack_dev(vec, nk, nocc, nvir)
        r1, r2, e = resid(t1_, t2_, f, U_dev)
        return _pack(r1, r2, nk), e

    tvec = _pack(t1_conv, t2_conv, nk).to(cdt).detach()
    tv = tvec.clone().requires_grad_(True)
    g = _holo_grad(rvec_e(tv, f0)[1], tv)[0]
    bmat = AmpBasis(nk, nocc, nvir, kp3, dev).dense().to(cdt)
    jb = _jacobian_cols(lambda v: rvec_e(v, f0)[0], tvec, bmat,
                        _tangent_bytes(nk, nocc, nvir))
    lam_b = torch.linalg.solve((bmat.mT @ jb).mT, -(bmat.mT @ g))
    lam = (bmat @ lam_b).detach()

    fr = [x.clone().requires_grad_(True) for x in f0]
    r, e = rvec_e(tvec, tuple(fr))
    grads = _holo_grad(e + torch.sum(lam * r), fr)   # lambda^T R, no conj
    grads = [to_numpy(x) for x in grads]
    goo = [grads[0][k] + np.eye(nocc) for k in range(nk)]
    gov = [grads[1][k] for k in range(nk)]
    gvo = [grads[2][k] for k in range(nk)]
    gvv = [grads[3][k] for k in range(nk)]
    return (goo, gov, gvo, gvv), to_numpy(lam)


def lambda_rdm2(nk, nocc, nvir, kp3, eo_, ev_, t1_conv, t2_conv, U_dev,
                lam=None, gam1=None):
    """Unrelaxed CCSD two-particle density, antisymmetrised spin-orbital
    pairing:  Gamma_as[k1,k2,k3][p,q,r,s] = <(1+Lambda) e^-T p+ q+ s r
    e^T>  (the density paired with <pq||rs> in  E2 = 1/4 sum u Gamma).

    U enters the Lagrangian linearly and holomorphically except the T2
    driving term conj(U_oovv), so Gamma = 4 dL/dU (reverse mode,
    include_drive=False) plus the driving's analytic contribution: lambda2
    mapped through conj(U[k1,k2,k3][ijab]) = U[k3,k4,k1][abij] onto the
    vvoo slots.  Returns Gamma_as as a numpy (nk,nk,nk,nso,nso,nso,nso)
    array in the Lagrangian's (supercell-normalised U) units.
    """
    if lam is None or gam1 is None:
        gam1, lam = lambda_rdm(nk, nocc, nvir, kp3, eo_, ev_, t1_conv,
                               t2_conv, U_dev)
    resid_nd = _equations_packed(nk, nocc, nvir, kp3, include_drive=False)
    cdt, dev = U_dev.dtype, U_dev.device
    n1 = nk * nocc * nvir
    f0 = _canonical_fock(nk, eo_, ev_, cdt, dev)
    lam_dev = as_tensor(lam, dev, cdt)
    t1_, t2_ = (x.detach().to(cdt) for x in (t1_conv, t2_conv))
    up = U_dev.detach().clone().requires_grad_(True)
    r1, r2, e = resid_nd(t1_, t2_, f0, up)
    g = to_numpy(_holo_grad(e + torch.sum(lam_dev * _pack(r1, r2, nk)),
                            up)[0])
    gam2 = 4.0 * g
    # analytic driving part: sum lam2[k1,k2,k3][ijab] d conj(U_oovv)
    #                      = sum lam2[k1,k2,k3][ijab] dU[k3,k4,k1][abij]
    lam2 = np.asarray(lam[n1:]).reshape((nk,) * 3 + (nocc, nocc,
                                                     nvir, nvir))
    kp3 = np.asarray(kp3)
    for k1 in range(nk):
        for k2 in range(nk):
            for k3 in range(nk):
                k4 = int(kp3[k1, k2, k3])
                gam2[k3, k4, k1, nocc:, nocc:, :nocc, :nocc] += (
                    4.0 * lam2[k1, k2, k3].transpose(2, 3, 0, 1))
    # project onto the exact operator antisymmetries (the derivative may
    # split weight unevenly over redundant slots; u carries these
    # symmetries exactly, so contractions are unchanged and the result is
    # the canonical, literal, representative).  NB: no hermitisation:
    # the unrelaxed CC density is genuinely non-Hermitian away from the
    # exactness limit.
    ar = np.arange(nk)
    X3, Y3, Z3 = ar[:, None, None], ar[None, :, None], ar[None, None, :]
    k4_b = kp3[X3, Y3, Z3]
    gam2 = 0.5 * (gam2 - gam2.transpose(1, 0, 2, 4, 3, 5, 6))
    gam2 = 0.5 * (gam2 - gam2[X3, Y3, k4_b].transpose(0, 1, 2, 3, 4,
                                                      6, 5))
    # The Lagrangian holds the fock fixed and omits E_ref, but a physical
    # du both moves the fock (by its occupied trace, paired with
    # gamma_corr) and shifts the determinant energy (paired with the
    # reference 2-RDM).  Add both in canonical (already projected) form:
    # Gamma_ref = delta delta - exchange, and the antisymmetrised
    # gamma_corr x delta_occ cross product.
    nso = nocc + nvir
    goo, gov, gvo, gvv = gam1
    gc = np.zeros((nk, nso, nso), dtype=complex)
    for k in range(nk):
        gc[k, :nocc, :nocc] = goo[k] - np.eye(nocc)   # correlation only
        gc[k, :nocc, nocc:] = gov[k]
        gc[k, nocc:, :nocc] = gvo[k]
        gc[k, nocc:, nocc:] = gvv[k]
    d_occ = np.zeros((nso, nso))
    d_occ[:nocc, :nocc] = np.eye(nocc)
    eye_o = np.eye(nocc)
    for k1 in range(nk):
        for k2 in range(nk):
            # blocks [k1, k2, k1]: delta_pr-type pairings
            blk13 = gam2[k1, k2, k1]
            blk13[:nocc, :nocc, :nocc, :nocc] += np.einsum(
                "pr,qs->pqrs", eye_o, eye_o)
            blk13 += (np.einsum("pr,qs->pqrs", gc[k1], d_occ)
                      + np.einsum("pr,qs->pqrs", d_occ, gc[k2]))
            # blocks [k1, k2, k2]: delta_ps-type (exchange) pairings
            blk14 = gam2[k1, k2, k2]
            blk14[:nocc, :nocc, :nocc, :nocc] -= np.einsum(
                "ps,qr->pqrs", eye_o, eye_o)
            blk14 -= (np.einsum("ps,qr->pqrs", gc[k1], d_occ)
                      + np.einsum("ps,qr->pqrs", d_occ, gc[k2]))
    return gam2


def ccsd_solver(h1, eri, nelec, conv_tol=1e-9, max_cycle=100,
                diis_space=8, device="cuda"):
    """Molecular-style CCSD solver with RDMs: (h1, eri, nelec) ->
    (e_elec, gamma, Gamma) in scf.fci conventions, a drop-in impurity
    solver for scf.dmet beyond exact-diagonalisation reach.

    h1 (n, n) complex Hermitian; eri chemists' (pq|rs); closed-shell
    nelec.  A small host RHF fixes the reference determinant; the
    spin-orbital CC machinery (make_step at nk = 1) runs on ``device`` in
    the canonical MO basis, and the unrelaxed CC RDMs come from
    lambda_rdm / lambda_rdm2, mapped back to the input basis (numpy).
    """
    from fftisdf_tpu_torch.scf.hf import DIIS

    dev = resolve_device(device)
    h1 = np.asarray(to_numpy(h1), dtype=complex)
    eri = np.asarray(to_numpy(eri), dtype=complex)
    n = h1.shape[0]
    nelec = int(nelec) if not isinstance(nelec, (tuple, list)) \
        else int(sum(nelec))
    assert nelec % 2 == 0, "closed-shell solver"
    no = nelec // 2
    nv = n - no

    # small dense RHF (fci gamma convention: gamma[p,q] = <p+ q>)
    gamma = np.zeros((n, n), dtype=complex)
    gamma[:no, :no] = 2.0 * np.eye(no)
    c_mo = np.eye(n, dtype=complex)
    diis = DIIS(space=8)
    for it in range(200):
        f = h1 + _vhf_chem(eri, gamma)
        err = f @ gamma.T - gamma.T @ f
        f = diis.update(f.ravel(), err.ravel()).reshape(n, n)
        w, c_mo = np.linalg.eigh(0.5 * (f + f.conj().T))
        gamma_new = 2.0 * (c_mo[:, :no] @ c_mo[:, :no].conj().T).T
        dg = float(np.max(np.abs(gamma_new - gamma)))
        gamma = gamma_new
        if dg < 1e-11:
            break
    assert dg < 1e-9, f"embedded RHF did not converge (|dD|={dg:.1e})"
    e_hf = (np.einsum("pq,pq->", h1, gamma)
            + 0.5 * np.einsum("pq,pq->", _vhf_chem(eri, gamma), gamma))

    # MO-basis integrals; spin-orbital order [occ_a, occ_b, vir_a, vir_b]
    eri_mo = np.einsum("pm,qn,rk,sl,pqrs->mnkl", c_mo.conj(), c_mo,
                       c_mo.conj(), c_mo, eri, optimize=True)
    spat = np.array([*range(no), *range(no), *range(no, n),
                     *range(no, n)])
    spin = np.array([0] * no + [1] * no + [0] * nv + [1] * nv)
    phys = eri_mo.transpose(0, 2, 1, 3)        # <pq|rs> = (pr|qs)
    d = (phys[np.ix_(spat, spat, spat, spat)]
         * ((spin[:, None, None, None] == spin[None, None, :, None])
            & (spin[None, :, None, None] == spin[None, None, None, :])))
    x = (phys.transpose(0, 1, 3, 2)[np.ix_(spat, spat, spat, spat)]
         * ((spin[:, None, None, None] == spin[None, None, None, :])
            & (spin[None, :, None, None] == spin[None, None, :, None])))
    U = (d - x)[None, None, None]
    e_so = np.concatenate([w[:no], w[:no], w[no:], w[no:]])
    # fock diag in the canonical MO basis is w
    eo = e_so[None, :2 * no]
    ev = e_so[None, 2 * no:]
    kp3 = np.zeros((1, 1, 1), dtype=np.int64)
    nocc_so, nvir_so = 2 * no, 2 * nv
    step = make_step(1, nocc_so, nvir_so, kp3, eo, ev)
    U_dev = as_tensor(U, dev, torch.complex128)
    t1 = torch.zeros((1, nocc_so, nvir_so), dtype=torch.complex128,
                     device=dev)
    t2 = _mp2_guess(U_dev, nocc_so, eo, ev, kp3)
    t1, t2, conv = _cc_iterate(step, t1, t2, U_dev, 1, conv_tol,
                               max_cycle, diis_space, False)[:3]
    assert conv, "embedded CCSD did not converge"
    e_corr = complex(step(t1, t2, U_dev)[2].item())

    gam_blocks, lam = lambda_rdm(1, nocc_so, nvir_so, kp3, eo, ev,
                                 t1, t2, U_dev)
    gam2_so = lambda_rdm2(1, nocc_so, nvir_so, kp3, eo, ev, t1, t2,
                          U_dev, lam=lam, gam1=gam_blocks)[0, 0, 0]
    goo, gov, gvo, gvv = gam_blocks
    g_so = np.block([[goo[0], gov[0]], [gvo[0], gvv[0]]])
    # spin-orbital -> spatial MO (fci conventions):
    #   gamma[m,n]      = sum_s <m_s+ n_s>
    #   Gamma[m,n,k,l]  = sum_st <m_s+ k_t+ l_t n_s> = Gamma_as[m,k,n,l]
    g_mo = np.zeros((n, n), dtype=complex)
    g2_mo = np.zeros((n,) * 4, dtype=complex)
    for s1 in range(2):
        sel1 = np.where(spin == s1)[0]
        m1 = spat[sel1]
        g_mo[np.ix_(m1, m1)] += g_so[np.ix_(sel1, sel1)]
        for s2 in range(2):
            sel2 = np.where(spin == s2)[0]
            m2 = spat[sel2]
            g2_mo[np.ix_(m1, m1, m2, m2)] += gam2_so[
                np.ix_(sel1, sel2, sel1, sel2)].transpose(0, 2, 1, 3)
    # back to the input basis: a_p+ = sum_m conj(C[p,m]) a_m+
    g_out = np.einsum("pm,mn,qn->pq", c_mo.conj(), g_mo, c_mo)
    g2_out = np.einsum("pm,qn,rk,sl,mnkl->pqrs", c_mo.conj(), c_mo,
                       c_mo.conj(), c_mo, g2_mo, optimize=True)
    # truncated CC energies on complex Hermitian integrals carry a genuine
    # (small) imaginary part unless symmetry forces reality; the density
    # reconstruction must match it exactly, and the solver returns the
    # real part
    e_elec = e_hf + e_corr
    e_check = (np.einsum("pq,pq->", h1, g_out)
               + 0.5 * np.einsum("pqrs,pqrs->", eri, g2_out))
    assert abs(e_check - e_elec) < 1e-7 * max(1.0, abs(e_elec)), \
        (e_check, e_elec)
    return float(np.real(e_elec)), g_out, g2_out


def _vhf_chem(eri, gamma):
    """Closed-shell HF potential for chemists' (pq|rs) and
    gamma[p,q] = <p+ q> (spin-summed)."""
    j = np.einsum("pqrs,rs->pq", eri, gamma)
    k = np.einsum("plrq,rl->pq", eri, gamma)
    return j - 0.5 * k


def onerdm(df, mf, conv_tol=1e-8, max_cycle=80, verbose=0):
    """Unrelaxed CCSD one-particle density matrix in the spin-orbital MO
    basis, per k-point: blocks (goo, gov, gvo, gvv) + reference part.
    Returns (gamma_blocks, info); info carries the trace (sum_k
    tr(gamma_k) = nk * nocc_so)."""
    e_cc, info = kccsd(df, mf, conv_tol=conv_tol, max_cycle=max_cycle,
                       verbose=verbose, return_amps=True)
    if not info["converged"]:
        raise RuntimeError("kccsd did not converge")
    if info.get("reference") == "fock":
        raise NotImplementedError(
            "the Lambda/RDM path assumes a canonical HF reference")
    nk = df.nkpt
    gam, lam = lambda_rdm(nk, info["nocc"], info["ev"].shape[1],
                          info["kp3"], info["eo"], info["ev"],
                          info["t1"], info["t2"], info["U"])
    goo, gov, gvo, gvv = gam
    info["e_ccsd"] = e_cc
    info["trace"] = float(sum(np.trace(goo[k]).real + np.trace(gvv[k]).real
                              for k in range(nk)))
    return gam, info


def ao_density(df, mf, conv_tol=1e-8, max_cycle=80, verbose=0):
    """Spin-resolved AO-basis CCSD one-particle density per k-point,
    shaped (2, nk, nao, nao) (numpy): plug-compatible with scf.analysis for
    correlated observables.  dm_s[k] = C_s gamma_s C_s^dag with gamma the
    unrelaxed CCSD density (onerdm) and C the spin-s columns."""
    gam, info = onerdm(df, mf, conv_tol=conv_tol, max_cycle=max_cycle,
                       verbose=verbose)
    goo, gov, gvo, gvv = gam
    cs, _, spins, nocc = _spinorb_mo(mf)
    nk = df.nkpt
    nao = cs.shape[1]
    dm = np.zeros((2, nk, nao, nao), dtype=complex)
    for k in range(nk):
        g = np.block([[goo[k], gov[k]], [gvo[k], gvv[k]]])
        for s in range(2):
            sel = spins[k] == s
            c = cs[k][:, sel]
            dm[s, k] = c @ g[np.ix_(sel, sel)] @ c.conj().T
    return dm, info


def eom_qp(nk, nocc, nvir, kp3, eo_, ev_, t1_host, t2_host, U_host,
           sector, device="cuda"):
    """k-resolved EOM-IP/EA-CCSD eigenvalues via the continuum-orbital
    trick: augment every k with one *phantom* orbital (zero integrals,
    energy 0), virtual for IP, occupied for EA.  The phantom decouples,
    so the ground amplitudes are the physical ones zero-padded, and the
    CCSD Jacobian block on amplitudes carrying exactly one phantom index
    IS the IP (1h + 2h1p) / EA (1p + 2p1h) EOM matrix.  Grouping by the
    phantom's k-point resolves the quasiparticle spectrum by momentum.

    Inputs are numpy arrays (t2 packed (nk, nk, nk, o, o, v, v)); J is
    applied on ``device`` to the one-phantom basis columns only; returns
    {k: sorted complex eigenvalues}.  Dense, fixture scale."""
    assert sector in ("ip", "ea")
    nso = nocc + nvir
    t2_host = np.asarray(t2_host)
    if sector == "ip":
        no_a, nv_a = nocc, nvir + 1
        m = np.arange(nso)                   # originals keep positions
        eo_a = eo_
        ev_a = np.concatenate([ev_, np.zeros((nk, 1))], axis=1)
        t1_a = np.concatenate([t1_host, np.zeros((nk, nocc, 1),
                                                 t1_host.dtype)], axis=2)

        def phantom(label):
            if label[0] == "s":
                _, k, i, a = label
                return (k if a == nvir else None)
            _, ki, i, kj, j, ka, a, kb, b = label
            cnt = (a == nvir) + (b == nvir)
            if cnt != 1:
                return None
            return ka if a == nvir else kb
    else:
        no_a, nv_a = nocc + 1, nvir
        m = np.concatenate([np.arange(nocc), np.arange(nocc + 1, nso + 1)])
        eo_a = np.concatenate([eo_, np.zeros((nk, 1))], axis=1)
        ev_a = ev_
        t1_a = np.concatenate([t1_host, np.zeros((nk, 1, nvir),
                                                 t1_host.dtype)], axis=1)

        def phantom(label):
            if label[0] == "s":
                _, k, i, a = label
                return (k if i == nocc else None)
            _, ki, i, kj, j, ka, a, kb, b = label
            cnt = (i == nocc) + (j == nocc)
            if cnt != 1:
                return None
            return ki if i == nocc else kj

    dev = resolve_device(device)
    nso_a = no_a + nv_a
    cdt = (torch.complex128 if U_host.dtype == np.complex128
           else torch.complex64)
    U_a = np.zeros((nk, nk, nk) + (nso_a,) * 4, dtype=U_host.dtype)
    U_a[np.ix_(range(nk), range(nk), range(nk), m, m, m, m)] = U_host
    t2_a = np.zeros((nk, nk, nk, no_a, no_a, nv_a, nv_a),
                    dtype=t1_host.dtype)
    if sector == "ip":
        t2_a[..., :nvir, :nvir] = t2_host
    else:
        t2_a[..., :nocc, :nocc, :, :] = t2_host
    labels, bmat = _amp_basis(nk, no_a, nv_a, kp3)
    sel = {k: [ii for ii, lb in enumerate(labels) if phantom(lb) == k]
           for k in range(nk)}
    order = [ii for k in range(nk) for ii in sel[k]]
    jb = _jacobian(nk, no_a, nv_a, kp3, eo_a, ev_a,
                   as_tensor(t1_a, dev, cdt), as_tensor(t2_a, dev, cdt),
                   as_tensor(U_a, dev, cdt), cols=bmat[:, order])
    out, i0 = {}, 0
    for k in range(nk):
        b = bmat[:, sel[k]]
        out[k] = _sorted_eigvals(b.T @ jb[:, i0:i0 + len(sel[k])])
        i0 += len(sel[k])
    return out


def _eom_qp_driver(df, mf, sector, conv_tol=1e-8, max_cycle=80,
                   verbose=0):
    info = _canonical_amps(df, mf, conv_tol, max_cycle, verbose, "EOM")
    w = eom_qp(df.nkpt, info["nocc"], info["ev"].shape[1], info["kp3"],
               info["eo"], info["ev"], to_numpy(info["t1"]),
               to_numpy(info["t2"]), to_numpy(info["U"]), sector,
               device=info["U"].device)
    return w, info


def eomip(df, mf, **kw):
    """k-resolved EOM-IP-CCSD: {k: eigenvalues of E(N-1) - E(N)}
    (correlated hole/valence-band energies).  See eom_qp."""
    return _eom_qp_driver(df, mf, "ip", **kw)


def eomea(df, mf, **kw):
    """k-resolved EOM-EA-CCSD: {k: eigenvalues of E(N+1) - E(N)}
    (correlated electron-attachment/conduction energies).  See eom_qp."""
    return _eom_qp_driver(df, mf, "ea", **kw)


# ----------------------------------------------------------------------
# perturbative triples: CCSD(T)
# ----------------------------------------------------------------------

def make_t3_energy(nk, nocc, nvir, kp3, eo, ev, chunk=None):
    """Build the (T) energy ``energy_t(t1, t2, U) -> e`` (supercell
    normalisation, like make_step).

      W[ijk,abc] = P(i/jk) P(a/bc) [ sum_e t2_jk^ae <bc||ei>
                                     - sum_m t2_im^bc <ma||jk> ]
      t3c = W / D3,   D3 t3d = P(i/jk) P(a/bc) t1_ia conj(<jk||bc>)
      E(T) = 1/36 sum conj(t3c + t3d) W

    Complex-safe index orders by the vertex rule of make_step.  Triple
    blocks [ki,kj,kk,ka,kb] (kc fixed by conservation) have no internal k
    sums, so the nk^5 blocks are a flat batch: the per-block gather indices
    of the nine P(i/jk)P(a/bc) label permutations are int64 tensors on the
    device, and a Python loop runs over chunks of blocks (``chunk`` blocks,
    or memory blocks of a quarter of free device memory), reducing the
    energy on the device.
    """
    kp3 = np.asarray(kp3)

    def kp(a, b, c):
        return kp3[a, b, c]

    perms = [((0, 1, 2), 1.0), ((1, 0, 2), -1.0), ((2, 1, 0), -1.0)]
    grids = np.stack(np.meshgrid(*([np.arange(nk)] * 5),
                                 indexing="ij"), axis=-1).reshape(-1, 5)
    ki, kj, kk, ka, kb = grids.T
    kc = kp(kp(ki, kj, ka), kk, kb)
    labels = np.stack([ki, kj, kk, ka, kb, kc], axis=1)
    nblk = labels.shape[0]

    tables = []
    for po, so in perms:
        for pv, sv in perms:
            lo = labels[:, [po[0], po[1], po[2]]]
            lv = labels[:, [3 + pv[0], 3 + pv[1], 3 + pv[2]]]
            pki, pkj, pkk = lo.T
            pka, pkb, pkc = lv.T
            ke = kp(pkj, pkk, pka)
            km = kp(pkb, pkc, pki)
            tables.append(dict(
                sign=so * sv,
                ax=(0,) + tuple(1 + p for p in po)
                + tuple(4 + p for p in pv),
                t2_1=np.stack([pkj, pkk, pka], 1),   # t2[kj,kk,ka]
                u_1=np.stack([pkb, pkc, ke], 1),     # <bc||ei>
                t2_2=np.stack([pki, km, pkb], 1),    # t2[ki,km,kb]
                u_2=np.stack([km, pka, pkj], 1),     # <ma||jk>
                disc=(pka == pki),
                t1_d=pki,
                u_d=np.stack([pkj, pkk, pkb], 1),    # conj(<jk||bc>)
            ))
    keys = ("t2_1", "u_1", "t2_2", "u_2", "t1_d", "u_d")
    o, v = slice(0, nocc), slice(nocc, nocc + nvir)
    cache = {}

    def energy_t(t1, t2, U):
        dev = U.device
        ein = torch.einsum
        if dev not in cache:
            cache[dev] = (
                [{k: torch.as_tensor(tab[k], device=dev) for k in keys}
                 for tab in tables],
                torch.as_tensor(labels, device=dev),
                torch.as_tensor(np.asarray(eo), dtype=torch.float64,
                                device=dev),
                torch.as_tensor(np.asarray(ev), dtype=torch.float64,
                                device=dev))
        idx, lab, eo_t, ev_t = cache[dev]
        Uvvvo, Uovoo = U[..., v, v, v, o], U[..., o, v, o, o]
        Uoovv = U[..., o, o, v, v]

        def g3(arr, ix):
            return arr[ix[:, 0], ix[:, 1], ix[:, 2]]

        if chunk is None:
            # ~12 live (block, o^3 v^3) tensors
            sls = memory_blocks(nblk, 12 * nocc ** 3 * nvir ** 3
                                * U.element_size(), dev)
        else:
            sls = [slice(i, min(nblk, i + chunk))
                   for i in range(0, nblk, chunk)]
        e = torch.zeros((), dtype=U.dtype, device=dev)
        for c in sls:
            nb = (c.stop - c.start,)
            w = torch.zeros(nb + (nocc,) * 3 + (nvir,) * 3, dtype=U.dtype,
                            device=dev)
            d = torch.zeros_like(w)
            for tab, ix in zip(tables, idx):
                x = ein("xjkae,xbcei->xijkabc", g3(t2, ix["t2_1"][c]),
                        g3(Uvvvo, ix["u_1"][c]))
                x = x - ein("ximbc,xmajk->xijkabc", g3(t2, ix["t2_2"][c]),
                            g3(Uovoo, ix["u_2"][c]))
                w.add_(x.permute(tab["ax"]), alpha=tab["sign"])
                # the disconnected term lives on the blocks with ka = ki
                # (known on the host): elsewhere it is zero
                rows = np.nonzero(tab["disc"][c])[0]
                if len(rows):
                    b = torch.as_tensor(c.start + rows, device=dev)
                    ud = g3(Uoovv, ix["u_d"][b]).conj()
                    dd = ein("xia,xjkbc->xijkabc", t1[ix["t1_d"][b]], ud)
                    d.index_add_(0, b - c.start, dd.permute(tab["ax"]),
                                 alpha=tab["sign"])
            lo, lv = eo_t[lab[c, :3]], ev_t[lab[c, 3:]]     # (b, 3, o/v)
            d3 = (lo[:, 0, :, None, None, None, None, None]
                  + lo[:, 1, None, :, None, None, None, None]
                  + lo[:, 2, None, None, :, None, None, None]
                  - lv[:, 0, None, None, None, :, None, None]
                  - lv[:, 1, None, None, None, None, :, None]
                  - lv[:, 2, None, None, None, None, None, :])
            e = e + torch.sum((w / d3 + d / d3).conj() * w) / 36.0
        return e

    return energy_t


def kccsd_t(df, mf, conv_tol=1e-7, max_cycle=60, diis_space=8, verbose=0):
    """CCSD(T) from a converged KRHF/KUHF ``mf``: runs kccsd, then the
    perturbative-triples correction.  Returns (e_ccsd, e_t, info):
    correlation energies per cell."""
    e_cc, info = kccsd(df, mf, conv_tol=conv_tol, max_cycle=max_cycle,
                       diis_space=diis_space, verbose=verbose,
                       return_amps=True)
    if info.get("reference") == "fock":
        raise NotImplementedError(
            "(T) assumes a canonical (diagonal-fock HF) reference")
    nk = df.nkpt
    nocc = info["nocc"]
    nvir = info["ev"].shape[1]
    if nocc < 3 and nk * nocc < 3:
        info["imag_t"] = 0.0
        return e_cc, 0.0, info          # fewer than 3 electrons: no triples
    fn = make_t3_energy(nk, nocc, nvir, info["kp3"], info["eo"],
                        info["ev"])
    e_t = complex(fn(info["t1"], info["t2"], info["U"]).item()) / nk
    info["imag_t"] = float(e_t.imag)
    return e_cc, float(e_t.real), info
