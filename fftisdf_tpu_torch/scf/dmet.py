"""Density-matrix embedding (DMET) on the ISDF factorisation.

Counterpart of ``fftisdf_tpu/scf/dmet.py``: one-shot DMET with an
interacting bath for k-point KRHF references, on the embedding transform
``isdf.ao2mo.trans_2e`` completes (the reference's unfinished
``fftisdf.py:230-294``).

1. Loewdin-orthogonalise per k; the supercell mean-field 1-RDM's fragment
   rows D[(0, f), (R, nu)] come from the k-resolved RDM through the
   image <-> k phase matrix.
2. Bath = right singular vectors of the fragment-environment block
   (<= n_frag vectors); embedding basis = fragment + bath, carried as
   k-resolved AO coefficients.
3. Embedding ERIs from ``trans_2e`` on the device of the ISDF state;
   embedding one-body = the projected converged Fock minus the
   embedding-internal mean field (interacting bath), so the mean-field
   density is stationary inside the embedding.
4. Impurity solver: ``scf.fci.fci_ground`` (exact diagonalisation) on the
   same device, or ``scf.cc.ccsd_solver``.
5. Energy: the correlation-energy functional with democratic fragment
   partitioning of the *difference* RDMs,

     E = E_HF + sum_f w_f [ h_emb (gamma - gamma_mf)
                            + 1/2 eri_emb (Gamma - Gamma_mf) ]

   exactly E_HF when the solver returns the mean field, and exactly E_FCI
   in the full-fragment gamma-point limit.

The embedding construction and the energy functional are small host
float64 algebra, as in the JAX package; the ERI assembly and the solver
run on the device.
"""
from __future__ import annotations

import numpy as np

from fftisdf_tpu_torch.isdf.ao2mo import trans_2e
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.utils.device import to_numpy


def _s_powers(s1e):
    """Per-k S^{1/2} and S^{-1/2}."""
    sh, smh = [], []
    for s in s1e:
        w, v = np.linalg.eigh(s)
        sh.append((v * np.sqrt(w)) @ v.conj().T)
        smh.append((v / np.sqrt(w)) @ v.conj().T)
    return np.array(sh), np.array(smh)


def build_embedding(mf, frag_ao, tol=1e-7):
    """Fragment AO indices -> k-resolved embedding coefficients.

    Returns (c_ao_lo (nk, nao, nemb), gamma_mf (fci convention
    <p+ q>), nfrag, info).  The first len(frag_ao) embedding orbitals
    ARE the (Loewdin) fragment orbitals.
    """
    cell, kpts = mf.cell, mf.kpts
    nk = len(kpts)
    dm = np.asarray(to_numpy(mf.dm))
    s1e = np.asarray(to_numpy(mf.s1e))
    nao = dm.shape[1]
    frag = np.asarray(frag_ao, dtype=int)
    nfrag = len(frag)
    sh, smh = _s_powers(s1e)
    d_oao = np.einsum("kpm,kmn,knq->kpq", sh, dm, sh)

    kmesh = kpt_mod.kpts_to_kmesh(cell, kpts)
    phase = kpt_mod.get_phase(cell, kpts, kmesh)   # (nimg, nk)
    # supercell RDM fragment rows: D[(0,f),(R,nu)]
    rows = np.einsum("k,kfv,Rk->fRv", phase[0], d_oao[:, frag, :],
                     phase.conj())
    rows = rows.reshape(nfrag, nk * nao)
    env_mask = np.ones(nk * nao, dtype=bool)
    env_mask[frag] = False                         # R=0 block leads
    b = rows[:, env_mask]
    u, sv, vh = np.linalg.svd(b, full_matrices=False)
    nbath = int(np.sum(sv > tol))
    bath_env = vh[:nbath].conj()                   # (nbath, Nenv)
    bath_sc = np.zeros((nbath, nk * nao), dtype=complex)
    bath_sc[:, env_mask] = bath_env

    # k components: v_k[nu] = sum_R phase[R,k]^* v[(R,nu)]
    bath_k = np.einsum("Rk,bRv->kvb", phase.conj(),
                       bath_sc.reshape(nbath, nk, nao))
    nemb = nfrag + nbath
    c_oao = np.zeros((nk, nao, nemb), dtype=complex)
    for i, f in enumerate(frag):
        c_oao[:, f, i] = phase[0].conj()           # 1/sqrt(nk)
    c_oao[:, :, nfrag:] = bath_k
    # orthonormality over the supercell
    ortho = np.einsum("kpi,kpj->ij", c_oao.conj(), c_oao)
    assert np.max(np.abs(ortho - np.eye(nemb))) < 1e-8

    c_ao_lo = np.einsum("kpq,kqi->kpi", smh, c_oao)
    demb = np.einsum("kpi,kpq,kqj->ij", c_oao.conj(), d_oao, c_oao)
    gamma_mf = demb.T                              # <p+ q> convention
    # DMET bath exactness: the embedded mean-field RDM is idempotent
    occs = np.linalg.eigvalsh(0.5 * (demb + demb.conj().T))
    assert np.max(np.minimum(np.abs(occs), np.abs(occs - 2.0))) < 1e-5, \
        occs
    return c_ao_lo, gamma_mf, nfrag, {"nbath": nbath, "svals": sv}


def _vhf(eri, gamma):
    """Closed-shell mean field in the <p+ q> convention."""
    j = np.einsum("pqrs,rs->pq", eri, gamma)
    k = np.einsum("plrq,rl->pq", eri, gamma)
    return j - 0.5 * k


def _gamma2_mf(gamma):
    return (np.einsum("pq,rs->pqrs", gamma, gamma)
            - 0.5 * np.einsum("ps,rq->pqrs", gamma, gamma))


def dmet_energy(mf, df, frag_ao, solver=None, tol=1e-7, fit_mu=False,
                mu_tol=1e-6, mu_maxiter=20):
    """One-shot DMET total energy per cell.

    mf: converged KRHF; df: built FFTISDF on the same (cell, kpts);
    frag_ao: AO indices of the fragment within the reference cell;
    ``solver(h1, eri, nelec, device=...) -> (e, gamma, Gamma)``, called on
    the device of ``df``: ``scf.fci.fci_ground`` by default
    (``scf.cc.ccsd_solver`` takes the same arguments).  ``fit_mu``: fit a
    global chemical potential on the fragment diagonal (secant iterations
    of the impurity solve) so the correlated fragment filling matches the
    mean-field one, the standard DMET number-conservation condition; the
    Lagrange-multiplier term is excluded from the energy functional.
    Returns (e_dmet, info).
    """
    from fftisdf_tpu_torch.scf.fci import fci_ground

    solver = solver or fci_ground
    dev = df.x_k.device
    c_ao_lo, gamma_mf, nfrag, info = build_embedding(mf, frag_ao,
                                                     tol=tol)
    nemb = c_ao_lo.shape[2]
    eri = np.asarray(to_numpy(trans_2e(df, c_ao_lo)), dtype=complex)

    fock, _, _ = mf.get_fock(mf.dm)
    f_emb = np.einsum("kpi,kpq,kqj->ij", np.conj(c_ao_lo),
                      np.asarray(to_numpy(fock)), c_ao_lo)
    h_solver = f_emb - _vhf(eri, gamma_mf)
    nelec = int(round(float(np.trace(gamma_mf).real)))

    def solve(mu):
        hmu = h_solver.copy()
        hmu[np.arange(nfrag), np.arange(nfrag)] -= mu
        return solver(hmu, eri, nelec, device=dev)

    mu = 0.0
    e_emb, gamma, Gam = solve(mu)
    if fit_mu:
        target = float(np.trace(gamma_mf[:nfrag, :nfrag]).real)

        def nf(g):
            return float(np.trace(g[:nfrag, :nfrag]).real)

        mu0, n0 = 0.0, nf(gamma)
        if abs(n0 - target) > mu_tol:
            mu1 = 0.05 if n0 < target else -0.05
            e_emb, gamma, Gam = solve(mu1)
            n1 = nf(gamma)
            for _ in range(mu_maxiter):
                if abs(n1 - target) < mu_tol or abs(n1 - n0) < 1e-12:
                    break
                mu_new = mu1 + (target - n1) * (mu1 - mu0) / (n1 - n0)
                mu0, n0 = mu1, n1
                mu1 = float(np.clip(mu_new, mu1 - 0.5, mu1 + 0.5))
                e_emb, gamma, Gam = solve(mu1)
                n1 = nf(gamma)
            mu = mu1
            info["nfrag_err"] = abs(n1 - target)
        info["mu"] = mu
    dgam = gamma - gamma_mf
    dgam2 = Gam - _gamma2_mf(gamma_mf)

    w = np.zeros(nemb)
    w[:nfrag] = 1.0
    w1 = 0.5 * (w[:, None] + w[None, :])
    w2 = 0.25 * (w[:, None, None, None] + w[None, :, None, None]
                 + w[None, None, :, None] + w[None, None, None, :])
    de = (np.einsum("pq,pq,pq->", h_solver, dgam, w1)
          + 0.5 * np.einsum("pqrs,pqrs,pqrs->", eri, dgam2, w2))
    info.update(e_hf=mf.e_tot, de_corr=float(de.real),
                de_imag=float(de.imag), nelec_emb=nelec, nemb=nemb,
                e_emb=e_emb)
    return mf.e_tot + float(de.real), info
