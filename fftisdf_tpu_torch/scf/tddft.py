"""k-point TDA and TDDFT (Casida) excitation energies on the ISDF state.

Counterpart of ``fftisdf_tpu/scf/tddft.py``: linear-response excitation
energies at any momentum transfer q (exciton dispersion across the
Brillouin zone) from KRHF (CIS/TDHF) and KRKS (TDA-DFT/TDDFT) references,
and their spin-conserving unrestricted form (UTDA) for KUHF/KUKS.

- The two-electron couplings ride the ISDF factorisation: with
  ``(i k1, j k2 | k k3, l k4) = sum_IJ w^q_IJ conj(x1_Ii) x2_Ij
  conj(x3_Jk) x4_Jl`` (``isdf.ao2mo.mo_eri``), the Coulomb coupling of the
  whole excitation space collapses to one nip-vector through w_{-q}, and
  the exchange coupling (hybrids/HF) to nk gathered nip x nip Hadamard
  products per row.
- The adiabatic xc kernel is the exact Hessian-vector product of the
  discrete Exc of ``scf.xc``, no hand-written fxc: ``fxc . t`` is the
  double backward of ``Exc`` at rho0 (``torch.autograd.grad`` of the
  autograd gradient, batched over tangents), LDA and GGA alike, the GGA
  terms through the FFT density gradient.  Complex (q != 0) transition
  densities split into two real tangents by linearity.
- Every piece applies a block of vectors at once, in chunks sized from
  the device's free memory: ``dense()`` applies unit vectors in blocks
  (the same columns the JAX package applies one by one), and
  :func:`davidson` applies only the new basis vectors of each iteration.
- Dense solves for small spaces (size <= 800), Davidson above.

Conventions: an excitation at momentum-transfer index ``q`` moves an
electron i at k_i into a at k_a with kpts[k_a] = kpts[k_i] + kpts[q]
(mod G); matrix elements between supercell-normalised configurations
carry 1/nk per assembled Bloch ERI.

Singlet TDA (closed shell, complex orbitals; chemists' notation):

    A_{(ki,ia),(kj,jb)} = delta * (e_a - e_i)
        + [2 (a i | j b) - c_hf (a b | j i)] / nk + (ia| fxc |jb)

Triplet: no Coulomb term, spin-flip kernel (f_uu - f_ud).  Full TDDFT
pairs (X at q, Y at -q) in the non-Hermitian problem
[[A_q, B], [-B*, -conj(A_{-q})]] with B_{(ia),(jb)} = [2 (a i | b j) -
c_hf (a j | b i)] / nk + the xc term.

Tensors stay on the device of the ISDF state (of ``mf`` on the grid
route); the eigensolvers are numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.linalg.coulomb import get_coulG
from fftisdf_tpu_torch.linalg.fft import fft3, ifft3
from fftisdf_tpu_torch.scf import xc as xc_mod
from fftisdf_tpu_torch.utils.device import (as_tensor, memory_blocks,
                                            real_complex, to_numpy)


# ----------------------------------------------------------------------
# setup helpers

def _ka_map(k2c, q):
    """ka_of[ki] = index of kpts[ki] + kpts[q] (mod G)."""
    nk = k2c.shape[0]
    out = np.empty(nk, dtype=np.int64)
    for ki in range(nk):
        hits = np.nonzero(k2c[ki] == q)[0]
        assert len(hits) == 1, "k-mesh not closed under the q shift"
        out[ki] = hits[0]
    return out


def _mo_setup(mf):
    """(mo_c, mo_e, nocc) with an insulating-occupation check."""
    mo_c = np.asarray(mf.mo_coeff)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    assert mo_c.ndim == 3, "restricted (KRHF/KRKS) reference required"
    assert np.all((mo_o < 1e-6) | (np.abs(mo_o - 2.0) < 1e-6)), \
        "fractional occupations (smearing): TDA needs an insulating gap"
    nocc = int(round(mo_o[0].sum() / 2))
    assert 0 < nocc < mo_c.shape[-1], "need occupied and virtual orbitals"
    return mo_c, mo_e, nocc


def _spec_of(mf):
    """(hyb, hyb_sr, omega, spec-or-None): exchange fractions (full-range
    and erfc-screened SR with its range parameter) and xc terms."""
    spec = getattr(mf, "_spec", None)
    if spec is None:                      # KRHF
        return 1.0, 0.0, 0.0, None
    if spec.is_mgga:
        raise NotImplementedError(
            "adiabatic meta-GGA kernel (tau response) not implemented")
    hyb_sr = float(getattr(spec, "hyb_sr", 0.0))
    return (spec.hyb, hyb_sr, float(getattr(spec, "omega", 0.0)),
            spec if spec.terms else None)


def _project(x, mo_c, ks, cols, dtype):
    """(nk, n, len(cols)) = x[ks[k]] @ C[ks[k]][:, cols] for every row k:
    ``x`` (nk, n, nao) the interpolation vectors or the grid AOs."""
    ks = np.asarray(ks)
    c = as_tensor(np.asarray(mo_c)[ks][:, :, cols].astype(np.complex128),
                  x.device, dtype)
    if np.array_equal(ks, np.arange(x.shape[0])):
        return x @ c
    return x[torch.as_tensor(ks, device=x.device)] @ c


# ----------------------------------------------------------------------
# matvec pieces: x is a block (m, nk, no, nv)

def _coul_piece(xo, xva, wqc, x, nk):
    """Singlet Coulomb coupling 2 (a i | j b)/nk via the metric sector of
    momentum -q: one nip-vector contraction for the whole space.

    xo (nk, nip, no): occupied-projected interpolation vectors at k_i;
    xva (nk, nip, nv): virtual-projected at k_a = k_i + q."""
    return 2.0 * _coul_read_u(_coul_piece_u(xo, xva, wqc, x, nk), xo, xva,
                              nk)


def _coul_piece_u(xo, xva, wqc, x, nk):
    """Spin-channel Coulomb coupling of ONE ket channel: the (m, nip)
    vectors wqc @ s, s_J = sum conj(xo)_Jj xva_Jb X_jb (no spin factor;
    the caller sums ket channels and reads each bra channel)."""
    y = xva[None] @ x.mT                            # (m, nk, nip, no)
    s = (xo.conj()[None] * y).sum(dim=(1, 3))       # (m, nip)
    return s @ wqc.T


def _coul_read_u(u, xo, xva, nk):
    """(1/nk) sum_I u_I conj(xva)_Ia xo_Ii: (m, nk, no, nv)."""
    return (1.0 / nk) * ((xo[None] * u[:, None, :, None]).mT
                         @ xva.conj()[None])


def _exch_piece(xo, xva, wq, qx, x, nk):
    """Exchange coupling -(a b | j i)/nk (the caller scales by c_hf).

    T_kj = sum_jb xva[kj]_Ib conj(xo[kj]_Jj) X_jb is kj-local; each row
    block ki then contracts the gathered metric sectors
    qx[ki, kj] = index of (k_j - k_i), as the JAX package does."""
    t_k = (xva[None] @ x.mT) @ xo.conj().mT[None]   # (m, nk, nip, nip)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    for ki in range(nk):
        m = (wq[qx[ki]][None] * t_k).sum(dim=1)     # (m, nip, nip)
        out[:, ki] = (xva[ki].mH @ m @ xo[ki]).mT
    return -(1.0 / nk) * out


def _hvp(rho0, tangents, gv, spec, fmesh, weight):
    """Hessian of the discrete Exc at rho0 (2, ng) applied to a batch of
    real tangents (p, 2, ng): the double backward of ``scf.xc``'s energy,
    the exact counterpart of the JAX package's jvp(grad(Exc))."""
    with torch.enable_grad():
        r = rho0.detach().requires_grad_(True)
        exc = xc_mod._exc_total(r, None, gv, spec, fmesh, weight)
        (g,) = torch.autograd.grad(exc, r, create_graph=True)
        (h,) = torch.autograd.grad(g, r, grad_outputs=tangents,
                                   is_grads_batched=True)
    return h.detach()


def _transition_density(psio, psiva, x):
    """t(r) = sum_kjb conj(psio_kj) psiva_kb X_kjb: (m, ng) complex."""
    y = psiva[None] @ x.mT                          # (m, nk, ng, no)
    return (psio.conj()[None] * y).sum(dim=(1, 3))


def _grid_read(v, psio, psiva, nk):
    """(1/nk) sum_g v_g psio_gi conj(psiva_ga): (m, nk, no, nv)."""
    return (1.0 / nk) * ((psio[None] * v[:, None, :, None]).mT
                         @ psiva.conj()[None])


def _xc_piece(psio, psiva, psio2, psiva2, rho0, gv, x, spec, fmesh,
              weight, singlet, nk):
    """Adiabatic xc-kernel coupling through the exact Hessian-vector
    product of the discrete Exc.

    t(r) is the transition density of the KET pairs (psio2, psiva2); its
    real and imaginary parts are two tangents, spin-summed for singlets
    (f_uu + f_ud) and spin-flipped for triplets (f_uu - f_ud); the BRA
    pairs (psio, psiva) then take the response potential's matrix
    elements (with the quadrature weight, which the HVP carries)."""
    sgn = 1.0 if singlet else -1.0
    t = _transition_density(psio2, psiva2, x)
    m = t.shape[0]
    parts = _tangent_parts(t)
    tan = torch.cat(parts)
    h = _hvp(rho0, torch.stack([tan, sgn * tan], dim=1), gv, spec, fmesh,
             weight)[:, 0]
    v = torch.complex(h[:m], h[m:] if len(parts) == 2
                      else torch.zeros_like(h)).to(psio.dtype)
    return _grid_read(v, psio, psiva, nk)


def _tangent_parts(t):
    """[Re t, Im t], or [Re t] alone when every imaginary part is exactly
    zero (real orbitals at q = 0): the HVP of a zero tangent is zero."""
    if bool((t.imag != 0).any()):
        return [t.real, t.imag]
    return [t.real]


def _xc_piece_u(psio_a, psiva_a, psio_b, psiva_b, rho0, gv, xa, xb, spec,
                fmesh, weight, nk):
    """Spin-resolved adiabatic kernel coupling: the (2, ng) tangents
    (t_alpha, t_beta) through one batched Hessian-vector product; returns
    the couplings read in both bra channels."""
    ta = _transition_density(psio_a, psiva_a, xa)
    tb = _transition_density(psio_b, psiva_b, xb)
    m = ta.shape[0]
    parts = _tangent_parts(torch.stack([ta, tb], dim=1))
    h = _hvp(rho0, torch.cat(parts), gv, spec, fmesh, weight)
    v = torch.complex(h[:m], h[m:] if len(parts) == 2
                      else torch.zeros_like(h)).to(psio_a.dtype)
    return (_grid_read(v[:, 0], psio_a, psiva_a, nk),
            _grid_read(v[:, 1], psio_b, psiva_b, nk))


def _coul_grid_piece(psio, psiva, coulg, eiqr, x, fmesh, nk):
    """Exact grid-route Coulomb coupling (the df-free path and oracle):
    the transition density's periodic part is Poisson-solved at q."""
    t = _transition_density(psio, psiva, x)
    v = ifft3(fft3(t * eiqr.conj(), fmesh) * coulg, fmesh) * eiqr
    return 2.0 * _grid_read(v, psio, psiva, nk)


def _grid_state(mf, mo_c, ka_of, nocc, spin=None):
    """(psio, psiva) = AO @ C on the full grid, occupied at k_i and
    virtual at k_a, from the SCF object's AO tensor."""
    ao = mf._get_ao()
    c = mo_c if spin is None else mo_c[spin]
    nk, nmo = c.shape[0], c.shape[-1]
    psio = _project(ao, c, range(nk), slice(0, nocc), ao.dtype)
    psiva = _project(ao, c, ka_of, slice(nocc, nmo), ao.dtype)
    return psio, psiva


def _ground_rho(mf, nspin):
    """The reference's (2, ng) spin densities (restricted: half in each
    channel), from its density matrix and AO tensor."""
    dm = getattr(mf, "dm", None)
    assert dm is not None, "run mf.kernel() first"
    ao = mf._get_ao()
    d = as_tensor(np.asarray(dm).astype(np.complex128), ao.device, ao.dtype)
    if nspin == 1:
        d = d[None]
    return xc_mod._spin_pair(xc_mod.get_rho(ao, d, len(mf.kpts)), nspin)


def _apply_blocks(apply, x, size, nk_shape, per_vec, device, cdt):
    """Host x, flat (size,), shaped ``nk_shape`` or a block (size, m) of
    columns, through ``apply`` on device blocks (m, size) in chunks;
    returns the same layout on the host."""
    x = np.asarray(x)
    block = x.ndim == 2 and x.shape[0] == size and x.shape != nk_shape
    cols = x.reshape(size, -1) if block else x.reshape(size, 1)
    out = np.empty(cols.shape, dtype=np.complex128)
    for sl in memory_blocks(cols.shape[1], per_vec, device):
        xd = as_tensor(np.ascontiguousarray(cols[:, sl].T).astype(
            np.complex128), device, cdt)
        out[:, sl] = to_numpy(apply(xd)).astype(np.complex128).T
    if block:
        return out
    return out[:, 0] if x.ndim == 1 else out[:, 0].reshape(x.shape)


def _dense(op):
    """Materialise A by applying unit vectors, in blocks."""
    return op.matvec(np.eye(op.size, dtype=np.complex128))


# ----------------------------------------------------------------------
# the TDA operator

class TDAOperator:
    """Matrix-free TDA response operator at momentum-transfer index q.

    ``mf``: converged KRHF or KRKS (insulating occupations).
    ``df``: built FFTISDF serving the two-electron couplings; optional
    for pure (hyb=0) functionals and plain Coulomb (the exact grid route
    is used when absent).
    """

    def __init__(self, mf, df=None, q=0, singlet=True):
        cell, kpts = mf.cell, np.asarray(mf.kpts)
        nk = len(kpts)
        self.nk, self.q, self.singlet = nk, int(q), bool(singlet)
        self.hyb, self.hyb_sr, self.omega, self.spec = _spec_of(mf)
        if df is None and (self.hyb != 0.0 or self.hyb_sr != 0.0):
            raise ValueError("exact-exchange coupling (CIS/hybrid TDA) "
                             "needs a built FFTISDF: pass df=")
        mo_c, mo_e, nocc = _mo_setup(mf)
        nmo = mo_c.shape[-1]
        self.nocc, self.nvir = nocc, nmo - nocc
        k2c = (df.kconserv2() if df is not None
               else kpt_mod.get_kconserv2(cell, kpts))
        self.ka_of = _ka_map(k2c, self.q)
        self.delta = np.stack([
            mo_e[self.ka_of[ki]][None, nocc:] - mo_e[ki][:nocc, None]
            for ki in range(nk)])                    # (nk, no, nv)
        self._isdf = df is not None
        per_vec = 0
        if self._isdf:
            self.device, cdt = df.x_k.device, df.cdtype
            self.xo = _project(df.x_k, mo_c, range(nk), slice(0, nocc), cdt)
            self.xva = _project(df.x_k, mo_c, self.ka_of,
                                slice(nocc, nmo), cdt)
            self.wq = df.wq
            # screened hybrids (HSE06): the SR exchange block uses the
            # erfc-screened metric over the same interpolation basis
            self.wq_sr = (df.get_wq_omega(-self.omega)
                          if self.hyb_sr != 0.0 else None)
            # Coulomb sector: pair (conj a at k_a, i at k_i) carries -q
            self.qc = int(k2c[self.ka_of[0], 0])
            # exchange sectors: pair (conj a at k_a, b at k_b) carries
            # k_b - k_a = k_j - k_i
            self.qx = torch.as_tensor(k2c.astype(np.int64),
                                      device=self.device)
            nip = df.nip
            if self.hyb != 0.0 or self.hyb_sr != 0.0:
                per_vec = 3 * nk * nip * nip * df.x_k.element_size()
        self._grid = (not self._isdf) or (self.spec is not None)
        if self._grid:
            if self._isdf and mf.device != self.device:
                raise ValueError(f"mf on {mf.device}, df on {self.device}")
            self.device = mf.device
            self.psio, self.psiva = _grid_state(mf, mo_c, self.ka_of, nocc)
            adt = self.psio.dtype
            rdt = real_complex(adt)[0]
            self.fmesh = tuple(int(m) for m in cell.mesh)
            ng = int(np.prod(self.fmesh))
            self.weight = float(cell.vol) / ng
            self.gv = torch.as_tensor(cell.get_Gv(self.fmesh), dtype=rdt,
                                      device=self.device)
            if self.spec is not None:
                self.rho0 = _ground_rho(mf, 1)
            if not self._isdf:
                cdt = adt
                qvec = kpts[self.q] - kpts[0]
                coords = torch.as_tensor(cell.gen_uniform_grids(self.fmesh),
                                         dtype=rdt, device=self.device)
                self.coulg = get_coulG(cell, q=qvec, mesh=self.fmesh,
                                       trunc=getattr(mf, "trunc", None),
                                       dtype=rdt, device=self.device)
                self.eiqr = torch.exp(1j * (coords @ torch.as_tensor(
                    qvec, dtype=rdt, device=self.device)))
            per_vec = max(per_vec, 4 * nk * ng * nocc * adt.itemsize)
        self._cdt = cdt
        self._per_vec = per_vec
        self._delta_dev = torch.as_tensor(self.delta,
                                          dtype=real_complex(cdt)[0],
                                          device=self.device)
        self.shape = (nk, nocc, self.nvir)
        self.size = nk * nocc * self.nvir

    # ------------------------------------------------------------------
    def apply(self, xd):
        """A applied to a device block (m, nk, no, nv)."""
        y = self._delta_dev * xd
        if self.singlet:
            if self._isdf:
                y = y + _coul_piece(self.xo, self.xva, self.wq[self.qc], xd,
                                    self.nk)
            else:
                y = y + _coul_grid_piece(self.psio, self.psiva, self.coulg,
                                         self.eiqr, xd, self.fmesh, self.nk)
        if self.hyb != 0.0:
            y = y + float(self.hyb) * _exch_piece(
                self.xo, self.xva, self.wq, self.qx, xd, self.nk)
        if self.hyb_sr != 0.0:
            y = y + float(self.hyb_sr) * _exch_piece(
                self.xo, self.xva, self.wq_sr, self.qx, xd, self.nk)
        if self.spec is not None:
            y = y + _xc_piece(self.psio, self.psiva, self.psio, self.psiva,
                              self.rho0, self.gv, xd, self.spec, self.fmesh,
                              self.weight, self.singlet, self.nk)
        return y

    def matvec(self, x):
        """A @ x for host x: flat (size,), shaped (nk, no, nv), or a block
        (size, m) of columns; returns the same layout on the host."""
        return _apply_blocks(
            lambda xd: self.apply(xd.reshape(-1, *self.shape)).reshape(
                xd.shape[0], -1),
            x, self.size, self.shape, self._per_vec, self.device, self._cdt)

    def dense(self):
        """Materialise A by unit-vector application (small spaces /
        validation; also exercises the matvec itself)."""
        return _dense(self)


# ----------------------------------------------------------------------
# unrestricted TDA (KUHF / KUKS references)

class UTDAOperator:
    """Spin-conserving TDA operator for unrestricted (KUHF/KUKS)
    references: the response method for spin-polarised systems (the
    north-star NiO AFM).  Excitation space: both spin channels
    concatenated, X = [X_a.ravel(), X_b.ravel()] with per-spin
    (nk, no_s, nv_s) blocks.

        A_{(s,ia),(s',jb)} = d_ss' d delta^s + (a_s i_s | j_s' b_s')/nk
            - d_ss' c_hf (a b | j i)/nk + (ia| f_{ss'} |jb)

    (cross-spin Coulomb, same-spin exchange, full spin-resolved kernel:
    for a closed-shell reference the spectrum is exactly the union of the
    restricted singlet and triplet TDA spectra).
    """

    def __init__(self, mf, df=None, q=0):
        cell, kpts = mf.cell, np.asarray(mf.kpts)
        nk = len(kpts)
        self.nk, self.q = nk, int(q)
        self.hyb, self.hyb_sr, self.omega, self.spec = _spec_of(mf)
        if df is None:
            raise ValueError("UTDA needs a built FFTISDF (df=)")
        mo_c = np.asarray(mf.mo_coeff)
        mo_e = np.asarray(mf.mo_energy)
        mo_o = np.asarray(mf.mo_occ)
        assert mo_c.ndim == 4, "unrestricted (KUHF/KUKS) reference required"
        assert np.all((mo_o < 1e-6) | (np.abs(mo_o - 1.0) < 1e-6)), \
            "fractional occupations (smearing): TDA needs an insulating gap"
        self.noccs = [int(round(mo_o[s][0].sum())) for s in range(2)]
        nmo = mo_c.shape[-1]
        self.nvirs = [nmo - n for n in self.noccs]
        k2c = df.kconserv2()
        self.ka_of = _ka_map(k2c, self.q)
        self.device, cdt = df.x_k.device, df.cdtype
        self._cdt = cdt
        rdt = real_complex(cdt)[0]
        self.deltas, self.xo, self.xva = [], [], []
        for s in range(2):
            no = self.noccs[s]
            self.deltas.append(np.stack([
                mo_e[s, self.ka_of[ki]][None, no:]
                - mo_e[s, ki][:no, None] for ki in range(nk)]))
            self.xo.append(_project(df.x_k, mo_c[s], range(nk),
                                    slice(0, no), cdt))
            self.xva.append(_project(df.x_k, mo_c[s], self.ka_of,
                                     slice(no, nmo), cdt))
        self._delta_dev = [torch.as_tensor(d, dtype=rdt, device=self.device)
                           for d in self.deltas]
        self.wq = df.wq
        self.wq_sr = (df.get_wq_omega(-self.omega)
                      if self.hyb_sr != 0.0 else None)
        self.qc = int(k2c[self.ka_of[0], 0])
        self.qx = torch.as_tensor(k2c.astype(np.int64), device=self.device)
        per_vec = 0
        if self.hyb != 0.0 or self.hyb_sr != 0.0:
            per_vec = 3 * nk * df.nip ** 2 * df.x_k.element_size()
        if self.spec is not None:
            if mf.device != self.device:
                raise ValueError(f"mf on {mf.device}, df on {self.device}")
            self.rho0 = _ground_rho(mf, 2)
            self.psio, self.psiva = [], []
            for s in range(2):
                po, pva = _grid_state(mf, mo_c, self.ka_of, self.noccs[s],
                                      spin=s)
                self.psio.append(po)
                self.psiva.append(pva)
            self.fmesh = tuple(int(m) for m in cell.mesh)
            ng = int(np.prod(self.fmesh))
            self.weight = float(cell.vol) / ng
            self.gv = torch.as_tensor(cell.get_Gv(self.fmesh), dtype=rdt,
                                      device=self.device)
            per_vec = max(per_vec, 4 * nk * ng * max(self.noccs)
                          * self.psio[0].element_size())
        self._per_vec = per_vec
        self.sizes = [nk * self.noccs[s] * self.nvirs[s] for s in range(2)]
        self.size = sum(self.sizes)

    def apply(self, xd):
        """A applied to a device block (m, size): both spin channels."""
        m, nk = xd.shape[0], self.nk
        xs = [xd[:, :self.sizes[0]].reshape(m, nk, self.noccs[0],
                                            self.nvirs[0]),
              xd[:, self.sizes[0]:].reshape(m, nk, self.noccs[1],
                                            self.nvirs[1])]
        outs = [self._delta_dev[s] * xs[s] for s in range(2)]
        # cross-spin Coulomb: one shared nip vector
        wqc = self.wq[self.qc]
        u = (_coul_piece_u(self.xo[0], self.xva[0], wqc, xs[0], nk)
             + _coul_piece_u(self.xo[1], self.xva[1], wqc, xs[1], nk))
        for s in range(2):
            outs[s] = outs[s] + _coul_read_u(u, self.xo[s], self.xva[s], nk)
            if self.hyb != 0.0:
                outs[s] = outs[s] + float(self.hyb) * _exch_piece(
                    self.xo[s], self.xva[s], self.wq, self.qx, xs[s], nk)
            if self.hyb_sr != 0.0:
                outs[s] = outs[s] + float(self.hyb_sr) * _exch_piece(
                    self.xo[s], self.xva[s], self.wq_sr, self.qx, xs[s], nk)
        if self.spec is not None:
            ya, yb = _xc_piece_u(self.psio[0], self.psiva[0], self.psio[1],
                                 self.psiva[1], self.rho0, self.gv, xs[0],
                                 xs[1], self.spec, self.fmesh, self.weight,
                                 nk)
            outs[0] = outs[0] + ya
            outs[1] = outs[1] + yb
        return torch.cat([o.reshape(m, -1) for o in outs], dim=1)

    def matvec(self, x):
        """A @ x for a flat x of length sum_s nk*no_s*nv_s, or a block
        (size, m) of columns."""
        return _apply_blocks(self.apply, x, self.size, (self.size,),
                             self._per_vec, self.device, self._cdt)

    def dense(self):
        return _dense(self)


def utda(mf, df, q=0, nroots=5, tol=1e-6, max_cycle=200, dense=None):
    """Lowest spin-conserving TDA excitations of an unrestricted
    reference at momentum-transfer index q."""
    op = UTDAOperator(mf, df, q=q)
    if dense is None:
        dense = op.size <= 800
    if dense:
        a = op.dense()
        w = np.sort(np.linalg.eigvals(a).real)
        herm = float(np.abs(a - a.conj().T).max())
        return (w[:nroots] if nroots else w), {
            "op": op, "nonhermiticity": herm, "dense": True}
    diag = np.concatenate([d.ravel() for d in op.deltas])
    w, x, conv, info = davidson(op.matvec, diag, op.size, nroots=nroots,
                                tol=tol, max_cycle=max_cycle)
    return w, {"op": op, "converged": conv, "x": x, "dense": False, **info}


# ----------------------------------------------------------------------
# entry points

def tda(mf, df=None, q=0, nroots=5, singlet=True, tol=1e-6,
        max_cycle=200, dense=None):
    """Lowest TDA excitation energies at momentum-transfer index q.

    Returns (omega (nroots,) real-sorted, info dict).  ``dense=True``
    forces full diagonalisation (all roots); the default densifies small
    spaces and runs Davidson above 800 pairs."""
    op = TDAOperator(mf, df, q=q, singlet=singlet)
    return _solve(op, nroots, tol, max_cycle, dense)


def _solve(op, nroots, tol, max_cycle, dense):
    """The dense or Davidson route of a Hermitian operator (TDA, BSE)."""
    if dense is None:
        dense = op.size <= 800
    if dense:
        a = op.dense()
        herm = float(np.abs(a - a.conj().T).max())
        w, x = np.linalg.eigh(0.5 * (a + a.conj().T))
        sel = slice(None, nroots) if nroots else slice(None)
        return w[sel], {"op": op, "nonhermiticity": herm, "dense": True,
                        "x": x[:, sel]}
    w, x, conv, info = davidson(op.matvec, op.delta.ravel(), op.size,
                                nroots=nroots, tol=tol, max_cycle=max_cycle)
    return w, {"op": op, "converged": conv, "x": x, "dense": False, **info}


def davidson(matvec, diag, n, nroots=4, tol=1e-6, max_space=60,
             max_cycle=200):
    """Davidson for the lowest eigenvalues of a (near-)Hermitian operator
    given by ``matvec`` on blocks (n, m) of complex columns; ``diag``
    preconditions.  Returns (omega real (nroots,), ritz vectors (n,
    nroots), converged, {'iterations', 'matvecs'}): the JAX package's
    three values and the counts.

    The JAX package re-orthonormalises the whole basis (QR) and re-applies
    the operator to all of it every iteration; here the basis stays
    orthonormal by construction (new columns are projected out of it twice
    and orthonormalised among themselves), the products A v of earlier
    columns are kept, and a restart carries the Ritz vectors' products
    along, so each iteration applies the operator to its new columns
    only.  The subspace, the correction vectors (r / (diag - theta)) and
    the convergence test are the JAX package's."""
    nroots = min(nroots, n)
    order = np.argsort(diag)
    v = np.zeros((n, nroots), dtype=complex)
    for r in range(nroots):
        v[order[r], r] = 1.0
    av = matvec(v)
    nmv = nroots
    theta = np.zeros(nroots)
    xr = v
    conv = False
    it = 0
    for it in range(1, max_cycle + 1):
        h = v.conj().T @ av
        h = 0.5 * (h + h.conj().T)
        w, y = np.linalg.eigh(h)
        theta, yv = w[:nroots], y[:, :nroots]
        xr = v @ yv
        axr = av @ yv
        r = axr - xr * theta[None, :]
        rn = np.linalg.norm(r, axis=0)
        if np.all(rn < tol):
            conv = True
            break
        if v.shape[1] + nroots > max_space:
            v, av = xr, axr
            continue
        new = []
        for j in range(nroots):
            if rn[j] < tol:
                continue
            den = diag - theta[j]
            den = np.where(np.abs(den) < 1e-8, 1e-8, den)
            new.append(r[:, j] / den)
        if not new:
            conv = True
            break
        c = np.stack(new, axis=1)
        for _ in range(2):
            c = c - v @ (v.conj().T @ c)
        c, rr = np.linalg.qr(c)
        keep = np.abs(np.diag(rr)) > 1e-12 * max(1.0, np.abs(rr).max())
        if not keep.any():
            conv = bool(np.all(rn < 10 * tol))
            break
        c = c[:, keep]
        v = np.concatenate([v, c], axis=1)
        av = np.concatenate([av, matvec(c)], axis=1)
        nmv += c.shape[1]
    return theta, xr, conv, {"iterations": it, "matvecs": nmv}


# ----------------------------------------------------------------------
# spectra: velocity-gauge transition moments (q = 0 optical limit)

def _grid_geometry(mf):
    cell = mf.cell
    ao = mf._get_ao()
    rdt = real_complex(ao.dtype)[0]
    fmesh = tuple(int(m) for m in cell.mesh)
    weight = float(cell.vol) / int(np.prod(fmesh))
    coords = torch.as_tensor(cell.gen_uniform_grids(fmesh), dtype=rdt,
                             device=ao.device)
    return ao, rdt, fmesh, weight, coords


def momentum_matrix(mf, nocc=None):
    """Momentum (velocity-gauge) matrix elements p^d_{k,ia} =
    <psi_ik| d/dr_d |psi_ak>, shape (3, nk, no, nv): the PBC-legal
    transition-dipole surrogate (the position operator is ill-defined
    under periodic boundary conditions; the velocity gauge needs only the
    band-limited FFT gradient, ``scf.xc.bloch_ao_grad``)."""
    kpts = np.asarray(mf.kpts)
    if nocc is None:
        mo_c, _, no = _mo_setup(mf)
    else:
        mo_c, no = np.asarray(mf.mo_coeff), nocc
    ao, rdt, fmesh, weight, coords = _grid_geometry(mf)
    gv = torch.as_tensor(mf.cell.get_Gv(fmesh), dtype=rdt, device=ao.device)
    kpts_d = torch.as_tensor(kpts, dtype=rdt, device=ao.device)
    co = as_tensor(np.asarray(mo_c)[:, :, :no].astype(complex), ao.device,
                   ao.dtype)
    cv = as_tensor(np.asarray(mo_c)[:, :, no:].astype(complex), ao.device,
                   ao.dtype)
    dphi = xc_mod.bloch_ao_grad(ao, kpts_d, coords, gv, fmesh)
    psio = ao @ co
    dpsiv = dphi @ cv[None]
    return weight * (psio.conj().mT[None] @ dpsiv)


def oscillator_strengths(mf, omega, xvecs, restricted=True, nocc=None):
    """Velocity-gauge oscillator strengths of q=0 TDA roots:
    f_n = 2 |<0| p |n>|^2 / (3 omega_n), <0|p|n> = sqrt(2) sum X p
    (the sqrt(2) is the closed-shell spin factor; drop it with
    restricted=False for spin-resolved vectors; supercell-normalised
    orbitals make the Bloch cell matrix elements the supercell ones with
    no extra nk factor, so sum_n f_n -> nk * nelec_cell under TRK).
    xvecs: (size, nroots) normalised TDA eigenvectors in the operator's
    flat layout."""
    p = to_numpy(momentum_matrix(mf, nocc=nocc))
    xv = np.asarray(xvecs)
    out = []
    spin = 2.0 if restricted else 1.0
    for n in range(xv.shape[1]):
        x = xv[:, n].reshape(p.shape[1:])
        m = np.einsum("dkia,kia->d", p, x) * np.sqrt(spin)
        out.append(2.0 * float(np.vdot(m, m).real) / (3.0 * omega[n]))
    return np.asarray(out)


def density_fluctuation(mf, op):
    """G = 0 Fourier components of the transition pair densities at the
    operator's momentum transfer: rho_q(k,ia) = integral conj(psi_ik)
    e^{-i q r} psi_{a,k+q}, the coupling of each excitation to a probe of
    momentum q (EELS / dielectric matrix head).  As q -> 0 this obeys
    rho_q -> -i q . p_ia / (e_a - e_i).  Returns (nk, no, nv)."""
    kpts = np.asarray(mf.kpts)
    nk = len(kpts)
    ao, rdt, _, weight, coords = _grid_geometry(mf)
    qvec = torch.as_tensor(kpts[op.q] - kpts[0], dtype=rdt, device=ao.device)
    mo_c, _, no = _mo_setup(mf)
    nmo = mo_c.shape[-1]
    phase = torch.exp(-1j * (coords @ qvec)).to(ao.dtype)
    psio = _project(ao, mo_c, range(nk), slice(0, no), ao.dtype)
    psiva = _project(ao, mo_c, op.ka_of, slice(no, nmo), ao.dtype)
    return weight * ((psio.conj() * phase[None, :, None]).mT @ psiva)


def dielectric_tda(mf, df, q, omegas, eta=0.005, nroots=0, singlet=True):
    """Macroscopic dielectric function eps_M(q, omega) and loss function
    -Im 1/eps_M from the TDA spectral representation at momentum-transfer
    index q (EELS at the mesh's finite q vectors; q = 0 has no density
    head, so pass a nonzero sector):

        eps_M = 1 - (4 pi / |q|^2 V_sc) sum_n |m_n|^2
                    [1/(w - w_n + i eta) - 1/(w + w_n + i eta)],
        m_n = sqrt(2) sum X^n_kia rho_q(k,ia),  V_sc = nk vol.

    Returns (eps (nw,) complex, detail dict)."""
    kpts = np.asarray(mf.kpts)
    qvec = kpts[int(q)] - kpts[0]
    qn = float(np.linalg.norm(qvec))
    assert qn > 1e-10, "q = 0 has no density head: use a finite-q sector"
    w, info = tda(mf, df, q=q, nroots=nroots, singlet=singlet, dense=True)
    rho = to_numpy(density_fluctuation(mf, info["op"]))
    xv = np.asarray(info["x"])
    # m_n = <0|rho_q|n> = sqrt(2) sum_kia X^n rho_q (momentum-conserving
    # head: |n> carries +q, the probe removes it)
    m2 = np.array([abs(np.sqrt(2.0) * np.sum(rho.ravel() * xv[:, n])) ** 2
                   for n in range(xv.shape[1])])
    vsc = len(kpts) * float(mf.cell.vol)
    pref = 4.0 * np.pi / (qn * qn * vsc)
    omegas = np.asarray(omegas)
    eps = np.ones(len(omegas), dtype=complex)
    for wn, mn in zip(w, m2):
        eps -= pref * mn * (1.0 / (omegas - wn + 1j * eta)
                            - 1.0 / (omegas + wn + 1j * eta))
    return eps, {"omega_n": w, "m2": m2, "loss": -np.imag(1.0 / eps)}


# ----------------------------------------------------------------------
# full TDDFT / TDHF (Casida)

def tddft(mf, df=None, q=0, nroots=5, singlet=True):
    """Full linear-response (Casida) excitation energies at momentum q:
    the non-Hermitian eigenproblem pairing excitations at q with
    de-excitations at -q,

        [[A_q, B], [-conj(B), -conj(A_{-q})]] [X; Y] = omega [X; Y],

    dense (small spaces).  Returns (positive branch sorted, info)."""
    cell, kpts = mf.cell, np.asarray(mf.kpts)
    k2c = (df.kconserv2() if df is not None
           else kpt_mod.get_kconserv2(cell, kpts))
    s_kpts = cell.get_scaled_kpts(kpts)
    qm = kpt_mod.member(-s_kpts[int(q)], s_kpts, strict=False)
    assert qm >= 0, "the -q point is not on the mesh"
    op = TDAOperator(mf, df, q=q, singlet=singlet)
    opm = TDAOperator(mf, df, q=int(qm), singlet=singlet)
    a = op.dense()
    am = opm.dense()
    b = _b_dense(mf, df, op, opm, k2c, singlet)
    m = np.block([[a, b], [-b.conj(), -am.conj()]])
    w = np.linalg.eigvals(m)
    pos = np.sort(w.real[w.real > 1e-10])
    return (pos[:nroots] if nroots else pos), {
        "a": a, "b": b, "a_minus_q": am}


def _b_dense(mf, df, op, opm, k2c, singlet):
    """B_{(ia at q),(jb at -q)} = [2 (a i | b j) - c_hf (a j | b i)]/nk
    + xc coupling of the bra pairs with the -q-sector ket pairs."""
    from fftisdf_tpu_torch.isdf.ao2mo import mo_eri

    nk, no, nv = op.shape
    mo_c = np.asarray(mf.mo_coeff)
    n = op.size
    b = np.zeros((n, n), dtype=complex)
    idx = lambda k, i, a_: (k * no + i) * nv + a_

    if singlet or op.hyb != 0.0 or op.hyb_sr != 0.0:
        assert df is not None, "Casida B couplings need df"
        for ki in range(nk):
            ka = int(op.ka_of[ki])
            cv_a = mo_c[ka][:, no:]
            co_i = mo_c[ki][:, :no]
            for kj in range(nk):
                kb = int(opm.ka_of[kj])
                cv_b = mo_c[kb][:, no:]
                co_j = mo_c[kj][:, :no]
                blk = np.zeros((no * nv, no * nv), dtype=complex)
                if singlet:
                    # (a k_a, i k_i | b k_b, j k_j) -> axes (a, i, b, j)
                    v = to_numpy(mo_eri(
                        df, (cv_a, co_i, cv_b, co_j), (ka, ki, kb, kj)))
                    blk += 2.0 * v.transpose(1, 0, 3, 2).reshape(
                        no * nv, no * nv)
                if op.hyb != 0.0:
                    # (a k_a, j k_j | b k_b, i k_i) -> axes (a, j, b, i)
                    v = to_numpy(mo_eri(
                        df, (cv_a, co_j, cv_b, co_i), (ka, kj, kb, ki)))
                    blk -= op.hyb * v.transpose(3, 0, 1, 2).reshape(
                        no * nv, no * nv)
                if op.hyb_sr != 0.0:
                    # screened-hybrid SR exchange block: the same quadruple
                    # through the erfc-screened metric
                    v = to_numpy(mo_eri(
                        df, (cv_a, co_j, cv_b, co_i), (ka, kj, kb, ki),
                        wq=op.wq_sr))
                    blk -= op.hyb_sr * v.transpose(3, 0, 1, 2).reshape(
                        no * nv, no * nv)
                r0, c0 = idx(ki, 0, 0), idx(kj, 0, 0)
                b[r0:r0 + no * nv, c0:c0 + no * nv] += blk / nk
    if op.spec is not None:
        # xc block by columns: the ket pairs (j -> b at k_j - q) as unit
        # transition densities against the bra pairs, the same HVP
        def cols(xd):
            return _xc_piece(op.psio, op.psiva, opm.psio, opm.psiva,
                             op.rho0, op.gv, xd.reshape(-1, nk, no, nv),
                             op.spec, op.fmesh, op.weight, singlet,
                             nk).reshape(xd.shape[0], -1)

        b += _apply_blocks(cols, np.eye(n, dtype=np.complex128), n, op.shape,
                           op._per_vec, op.device, op.psio.dtype)
    return b
