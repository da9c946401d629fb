"""Determinant-space oracle for coupled-cluster gates, numpy only.

The construction of tests/test_cc.py (whose module imports the JAX
package), kept here so that the PyTorch port's tests and ``chip_smoke.py``
can use it where JAX is absent: Jordan-Wigner operator matrices on the 2^n
Fock space, e^T as a finite series (T is nilpotent), and the literal CCSD
residuals <Phi_ex| e^-T H e^T |Phi_0>, (T) ingredients, Hbar and the
determinant-space Lambda.  Nothing in it assumes the equations being
tested.
"""
import numpy as np


def _jw_annihilators(n):
    """Jordan-Wigner annihilator matrices c_p on the 2^n Fock space."""
    Z = np.diag([1.0, -1.0])
    a = np.array([[0.0, 1.0], [0.0, 0.0]])   # |0><1|
    eye = np.eye(2)
    ops = []
    for p in range(n):
        m = np.array([[1.0]])
        for q in range(n):
            m = np.kron(m, Z if q < p else (a if q == p else eye))
        ops.append(m)
    return ops


class Oracle:
    """H, |0>, excitation operators, and literal CC residuals from
    (antisymmetrised integrals u, orbital energies e, nocc).  ``fock``
    overrides the diagonal: a full Hermitian one-body matrix."""

    def __init__(self, u, e, nocc, fock=None):
        n = len(e)
        self.n, self.no, self.nv = n, nocc, n - nocc
        c = _jw_annihilators(n)
        cd = [m.T for m in c]
        self.c, self.cd = c, cd
        dim = 2 ** n
        # fock f  =>  h1 = f - sum_i u[p,i,q,i]
        h1 = (np.diag(e).astype(complex) if fock is None
              else np.array(fock, dtype=complex))
        h1 -= np.einsum("piqi->pq", u[:, :nocc, :, :nocc])
        H = np.zeros((dim, dim), dtype=complex)
        for p in range(n):
            for q in range(n):
                if abs(h1[p, q]) > 0:
                    H += h1[p, q] * (cd[p] @ c[q])
        barr = np.array([[c[s] @ c[r] for r in range(n)] for s in range(n)])
        for p in range(n):
            for q in range(n):
                cpq = np.einsum("rs,srxy->xy", u[p, q], barr)
                H += 0.25 * (cd[p] @ cd[q]) @ cpq
        self.H = H
        vac = np.zeros(dim)
        vac[0] = 1.0
        psi0 = vac
        for i in range(nocc):
            psi0 = cd[i] @ psi0
        self.psi0 = psi0
        self.e_ref = np.vdot(psi0, H @ psi0)

    def t_matrix(self, t1, t2):
        no = self.no
        c, cd = self.c, self.cd
        T = np.zeros_like(self.H)
        for i in range(no):
            for a in range(self.nv):
                T += t1[i, a] * (cd[no + a] @ c[i])
        for i in range(no):
            for j in range(no):
                for a in range(self.nv):
                    for b in range(self.nv):
                        T += 0.25 * t2[i, j, a, b] * (
                            cd[no + a] @ cd[no + b] @ c[j] @ c[i])
        return T

    def _exp_apply(self, T, vec):
        out = vec.copy()
        term = vec
        for k in range(1, self.no + 3):
            term = T @ term / k
            out = out + term
            if np.max(np.abs(term)) == 0.0:
                break
        assert np.max(np.abs(T @ term)) < 1e-30   # nilpotency exhausted
        return out

    def residuals(self, t1, t2):
        """R1[i,a], R2[i,j,a,b], E_corr at the given amplitudes."""
        T = self.t_matrix(t1, t2)
        y = self._exp_apply(T, self.psi0)
        w = self._exp_apply(-T, self.H @ y)
        e_corr = np.vdot(self.psi0, self.H @ y) - self.e_ref
        no, nv = self.no, self.nv
        c, cd = self.c, self.cd
        r1 = np.zeros((no, nv), dtype=complex)
        r2 = np.zeros((no, no, nv, nv), dtype=complex)
        for i in range(no):
            for a in range(nv):
                r1[i, a] = np.vdot(cd[no + a] @ c[i] @ self.psi0, w)
        for i in range(no):
            for j in range(no):
                for a in range(nv):
                    for b in range(nv):
                        bra = (cd[no + a] @ cd[no + b]
                               @ c[j] @ c[i] @ self.psi0)
                        r2[i, j, a, b] = np.vdot(bra, w)
        return r1, r2, e_corr

    def sector_fci(self, nelec):
        """Lowest eigenvalue of H in the ``nelec``-particle sector."""
        occ = np.array([bin(s).count("1") for s in range(self.H.shape[0])])
        sec = np.where(occ == nelec)[0]
        return np.linalg.eigvalsh(self.H[np.ix_(sec, sec)])[0]


def _oracle_t3(oracle, t1, t2):
    """Literal (T) ingredients at a canonical diagonal fock: W =
    <Phi3|H T2|0>, D3 t3d = <Phi3|H T1|0>."""
    no, nv = oracle.no, oracle.nv
    c, cd = oracle.c, oracle.cd
    t2vec = oracle.H @ (oracle.t_matrix(np.zeros((no, nv)), t2)
                        @ oracle.psi0)
    t1vec = oracle.H @ (oracle.t_matrix(t1, np.zeros((no,) * 2 + (nv,) * 2))
                        @ oracle.psi0)
    w = np.zeros((no,) * 3 + (nv,) * 3, dtype=complex)
    d3t3d = np.zeros_like(w)
    for i, j, k, a, b, c_ in np.ndindex(w.shape):
        bra = (cd[no + a] @ cd[no + b] @ cd[no + c_]
               @ c[k] @ c[j] @ c[i] @ oracle.psi0)
        w[i, j, k, a, b, c_] = np.vdot(bra, t2vec)
        d3t3d[i, j, k, a, b, c_] = np.vdot(bra, t1vec)
    return w, d3t3d


def t3_energy(oracle, e, t1, t2):
    """The literal E(T) = <0|(T1+T2)^dag H T3c|0>, t3c = W / D3."""
    no, nv = oracle.no, oracle.nv
    w_o, _ = _oracle_t3(oracle, t1, t2)
    eo, ev = e[:no], e[no:]
    d3 = (eo[:, None, None, None, None, None]
          + eo[None, :, None, None, None, None]
          + eo[None, None, :, None, None, None]
          - ev[None, None, None, :, None, None]
          - ev[None, None, None, None, :, None]
          - ev[None, None, None, None, None, :])
    t3c = w_o / d3
    c, cd = oracle.c, oracle.cd
    T3 = np.zeros_like(oracle.H)
    for idx in np.ndindex(t3c.shape):
        i, j, k, a, b, c_ = idx
        T3 += t3c[idx] / 36.0 * (cd[no + a] @ cd[no + b] @ cd[no + c_]
                                 @ c[k] @ c[j] @ c[i])
    amp = oracle.t_matrix(t1, t2) @ oracle.psi0
    return np.vdot(amp, oracle.H @ (T3 @ oracle.psi0))


def _expm_nilpotent(T):
    out = np.eye(T.shape[0], dtype=complex)
    term = out
    for k in range(1, 40):
        term = term @ T / k
        out = out + term
        if np.max(np.abs(term)) == 0.0:
            break
    assert np.max(np.abs(term)) == 0.0
    return out


def hbar(oracle, t1, t2):
    """(e^T, e^-T, Hbar = e^-T H e^T) at amplitudes (o, v), (o, o, v, v)."""
    T = oracle.t_matrix(t1, t2)
    expT, expmT = _expm_nilpotent(T), _expm_nilpotent(-T)
    return expT, expmT, expmT @ oracle.H @ expT


def eom_spectra(oracle, hb):
    """Eigenvalues of Hbar - E on the singles+doubles (EE), (N-1) (IP) and
    (N+1) (EA) determinant spaces, each sorted."""
    no, nv = oracle.no, oracle.nv
    c, cd, psi0 = oracle.c, oracle.cd, oracle.psi0
    e_tot = np.vdot(psi0, hb @ psi0)
    spaces = {
        "ee": [cd[no + a] @ c[i] @ psi0 for i in range(no)
               for a in range(nv)]
        + [cd[no + a] @ cd[no + b] @ c[j] @ c[i] @ psi0 for i in range(no)
           for j in range(i + 1, no) for a in range(nv)
           for b in range(a + 1, nv)],
        "ip": [c[i] @ psi0 for i in range(no)]
        + [cd[no + a] @ c[j] @ c[i] @ psi0 for i in range(no)
           for j in range(i + 1, no) for a in range(nv)],
        "ea": [cd[no + a] @ psi0 for a in range(nv)]
        + [cd[no + a] @ cd[no + b] @ c[i] @ psi0 for a in range(nv)
           for b in range(a + 1, nv) for i in range(no)]}
    out = {}
    for name, basis in spaces.items():
        b = np.stack(basis, axis=1)
        out[name] = np.sort_complex(np.linalg.eigvals(b.conj().T @ hb @ b)
                                    - e_tot)
    return out


def left_state(oracle, hb, bmat):
    """<0|(1 + Lambda) with Lambda solved in determinant space on the
    independent-amplitude basis ``bmat`` (its columns as operators)."""
    no, nv = oracle.no, oracle.nv
    n1 = no * nv
    ops = [oracle.t_matrix(col[:n1].reshape(no, nv),
                           col[n1:].reshape(no, no, nv, nv))
           for col in bmat.T]
    psi0 = oracle.psi0
    b = np.array([np.vdot(psi0, hb @ op @ psi0) for op in ops])
    A = np.empty((len(ops), len(ops)), dtype=complex)
    for nu, opn in enumerate(ops):
        comm = hb @ opn - opn @ hb
        for mu, opm in enumerate(ops):
            A[nu, mu] = np.vdot(psi0, opm.T @ comm @ psi0)
    lam = np.linalg.solve(A, -b)
    lam_mat = sum(lam[mu] * ops[mu].T for mu in range(len(ops)))
    return (np.eye(hb.shape[0]) + lam_mat).conj().T @ psi0


def densities(oracle, expT, expmT, left):
    """Literal <(1+Lambda) e^-T p+ q e^T> and <(1+Lambda) e^-T p+ q+ s r
    e^T>."""
    n = oracle.n
    c, cd = oracle.c, oracle.cd
    base = expT @ oracle.psi0
    g1 = np.array([[np.vdot(left, expmT @ (cd[p] @ (c[q] @ base)))
                    for q in range(n)] for p in range(n)])
    g2 = np.empty((n,) * 4, dtype=complex)
    for p, q, r, s in np.ndindex(g2.shape):
        g2[p, q, r, s] = np.vdot(left, expmT @ (
            cd[p] @ (cd[q] @ (c[s] @ (c[r] @ base)))))
    return g1, g2


def _random_u(n, rng):
    """Random antisymmetrised integrals with physical symmetries:
    v[pqrs]=v[qpsr] (exchange), v[pqrs]=conj(v[rspq]) (hermitian);
    u = v - v.transpose(0,1,3,2)."""
    a = rng.standard_normal((n,) * 4) + 1j * rng.standard_normal((n,) * 4)
    a = a + a.transpose(1, 0, 3, 2)
    v = a + a.transpose(2, 3, 0, 1).conj()
    return v - v.transpose(0, 1, 3, 2)


def _random_amps(no, nv, rng):
    t1 = 0.1 * (rng.standard_normal((no, nv))
                + 1j * rng.standard_normal((no, nv)))
    r = 0.1 * (rng.standard_normal((no, no, nv, nv))
               + 1j * rng.standard_normal((no, no, nv, nv)))
    t2 = (r - r.transpose(1, 0, 2, 3)
          - r.transpose(0, 1, 3, 2) + r.transpose(1, 0, 3, 2))
    return t1, t2
