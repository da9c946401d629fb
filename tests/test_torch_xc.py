"""The port's exchange-correlation layer (``scf.xc``) against the JAX
package's (``fftisdf_tpu.scf.xc``), on the CPU in float64.

Every registry name is evaluated by both packages on the same seeded
densities on diamond's mesh (the ``_toy_rho`` densities of
tests/test_ks.py) and on the two exact ties of the clamps: zeta = +1 and
-1 (one spin channel empty on each half of the grid) and s^2 = 0 (a
uniform density, where SCAN's iso-orbital indicator also sits on its seam
alpha = 1).  exc is held to 1e-12 relative, vxc and v_tau to 1e-10 of
max|v|.  One divergence is deliberate: at s^2 = 0 the JAX package's HJS
short-range exchange (hse06, wpbexhse) has a NaN potential (the derivative
of sqrt(zeta) at zeta = 0); the port's is finite, and it is held to the
JAX package's energies by a central difference along a random
perturbation.  The grid passes over Bloch AOs (density, kinetic-energy
density, the AO matrices) are held to the JAX package's on diamond 1x1x2,
the k-blocked pass at one k-point a block.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.scf import xc as jax_xc
from jax_records import recorded
from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.scf import xc as xc_mod

NAMES = sorted(jax_xc._FUNCTIONALS)
HJS = {"hse06", "wpbexhse"}


@pytest.fixture(scope="module")
def grid():
    """(fmesh, gv (ng, 3), weight) of diamond gth-szv ke 50."""
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    fmesh = tuple(int(m) for m in cell.mesh)
    return fmesh, cell.get_Gv(fmesh), float(cell.vol) / int(np.prod(fmesh))


def _toy_rho(fmesh, seed):
    """Smooth strictly positive spin densities: a few low-G plane waves on
    a constant (tests/test_ks.py::_toy_rho)."""
    ng = int(np.prod(fmesh))
    coef = np.random.default_rng(seed).standard_normal((2, 4, 4, 4)) * 0.05
    field = np.zeros((2,) + fmesh)
    for s in range(2):
        f = np.zeros(fmesh, dtype=complex)
        f[:4, :4, :4] = coef[s] * ng
        field[s] = np.real(np.fft.ifftn(f))
    return (0.3 + field - field.min()).reshape(2, ng)


def _tau_unif(rho):
    """The uniform gas's kinetic-energy density a spin channel."""
    return 0.3 * (3.0 * np.pi ** 2) ** (2.0 / 3.0) \
        * (2.0 * rho) ** (5.0 / 3.0) / 2.0


def _densities(fmesh):
    """{case: (rho, tau)}: the toy density, the zeta = +-1 ties and the
    s^2 = 0 tie (tau at the uniform gas's, so alpha = 1 exactly)."""
    ng = int(np.prod(fmesh))
    toy = _toy_rho(fmesh, 1)
    pol = _toy_rho(fmesh, 5)
    pol[1, : ng // 2] = 0.0                     # zeta = +1
    pol[0, ng // 2:] = 0.0                      # zeta = -1
    uni = np.stack([np.full(ng, 0.21), np.full(ng, 0.13)])
    return {"toy": (toy, _tau_unif(toy) * 1.3 + 0.05),
            "zeta=+-1": (pol, _tau_unif(pol) * 1.2 + 0.01),
            "s2=0": (uni, _tau_unif(uni))}


def _jax_eval(spec, rho, tau, gv, fmesh, w, key):
    """The JAX package's (exc, vxc, v_tau or None), recorded under ``key``
    (tests/jax_records.py)."""
    out = recorded(key, lambda: _jax_live(spec, rho, tau, gv, fmesh, w))
    return float(out[0]), out[1], (out[2] if spec.is_mgga else None)


def _jax_live(spec, rho, tau, gv, fmesh, w):
    if spec.is_mgga:
        e, v, vt = jax_xc.exc_and_vxc_mgga(jnp.asarray(rho), jnp.asarray(tau),
                                           jnp.asarray(gv), spec, fmesh, w)
        return float(e), np.asarray(v), np.asarray(vt)
    e, v = jax_xc.exc_and_vxc(jnp.asarray(rho), jnp.asarray(gv), spec,
                              fmesh, w)
    return float(e), np.asarray(v), np.zeros(0)


def _port_eval(spec, rho, tau, gv, fmesh, w):
    t = torch.from_numpy
    if spec.is_mgga:
        e, v, vt = xc_mod.exc_and_vxc_mgga(t(rho), t(tau), t(gv), spec,
                                           fmesh, w)
        return float(e), v.numpy(), vt.numpy()
    e, v = xc_mod.exc_and_vxc(t(rho), t(gv), spec, fmesh, w)
    return float(e), v.numpy(), None


def _close(v, ref):
    """max|v - ref| within 1e-10 of max|ref| where ref is finite."""
    ok = np.isfinite(ref)
    scale = max(np.abs(ref[ok]).max(initial=0.0), 1e-300)
    return np.abs(v[ok] - ref[ok]).max(initial=0.0) <= 1e-10 * scale


@pytest.mark.parametrize("name", NAMES)
def test_exc_and_vxc_match_jax(grid, name):
    fmesh, gv, w = grid
    spec = jax_xc.parse_xc(name)
    port_spec = xc_mod.parse_xc(name)
    assert (port_spec.hyb, port_spec.hyb_sr, port_spec.omega,
            port_spec.terms) == (spec.hyb, spec.hyb_sr, spec.omega,
                                 spec.terms)
    assert (port_spec.is_gga, port_spec.is_mgga) == (spec.is_gga,
                                                     spec.is_mgga)
    for case, (rho, tau) in _densities(fmesh).items():
        e_j, v_j, vt_j = _jax_eval(spec, rho, tau, gv, fmesh, w,
                                   f"xc/{name}/{case}")
        e_p, v_p, vt_p = _port_eval(port_spec, rho, tau, gv, fmesh, w)
        assert abs(e_p - e_j) <= 1e-12 * max(abs(e_j), 1.0), (case, e_p, e_j)
        assert np.isfinite(v_p).all(), case
        assert _close(v_p, v_j), case
        if spec.is_mgga:
            assert np.isfinite(vt_p).all() and _close(vt_p, vt_j), case
        if name in HJS and case == "s2=0":
            # the JAX package's potential is NaN here: hold the port's to
            # the JAX package's energies by a central difference
            assert np.isnan(v_j).all()
            drho = np.random.default_rng(2).standard_normal(rho.shape) * 3e-5
            ep = _jax_eval(spec, rho + drho, tau, gv, fmesh, w,
                           f"xc/{name}/{case}/+")[0]
            em = _jax_eval(spec, rho - drho, tau, gv, fmesh, w,
                           f"xc/{name}/{case}/-")[0]
            fd = (ep - em) / 2.0
            an = float(np.sum(v_p * drho)) * w
            assert abs(fd - an) < 1e-7 * abs(fd), (fd, an)
    with pytest.raises(NotImplementedError):
        xc_mod.parse_xc("no-such-functional")


@pytest.fixture(scope="module")
def bloch():
    """Diamond 1x1x2: (AO (nk, ng, nao), kpts, coords, gv, fmesh, weight,
    seeded spin density matrices (2, nk, nao, nao), v_tau (2, ng))."""
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    fmesh = tuple(int(m) for m in cell.mesh)
    coords = cell.gen_uniform_grids(fmesh)
    ao = make_evaluator(cell, kpts=kpts, device="cpu")(coords).numpy()
    rng = np.random.default_rng(3)
    nk, nao = len(kpts), cell.nao_nr()
    d = rng.standard_normal((2, nk, nao, nao)) \
        + 1j * rng.standard_normal((2, nk, nao, nao))
    dm = (d + np.conj(np.swapaxes(d, -1, -2))) * 0.1 \
        + np.eye(nao)[None, None]
    vt = rng.standard_normal((2, ao.shape[1]))
    return (ao, kpts, coords, cell.get_Gv(fmesh), fmesh,
            float(cell.vol) / ao.shape[1], dm, vt)


def test_bloch_ao_grad_tau_vtau_match_jax(bloch):
    ao, kpts, coords, gv, fmesh, w, dm, vt = bloch
    t, j = torch.from_numpy, jnp.asarray
    nk = len(kpts)
    dphi_j = np.asarray(jax_xc.bloch_ao_grad(j(ao), j(kpts), j(coords),
                                             j(gv), fmesh))
    dphi = xc_mod.bloch_ao_grad(t(ao), t(kpts), t(coords), t(gv), fmesh)
    scale = np.abs(dphi_j).max()
    assert np.abs(dphi.numpy() - dphi_j).max() <= 1e-12 * scale
    pairs = (
        (xc_mod.get_tau(dphi, t(dm), nk),
         jax_xc.get_tau(j(dphi_j), j(dm), nk)),
        (xc_mod.vtau_matrix(dphi, t(vt), w),
         jax_xc.vtau_matrix(j(dphi_j), j(vt), w)),
        (xc_mod.get_rho(t(ao), t(dm), nk), jax_xc.get_rho(j(ao), j(dm), nk)),
        (xc_mod.vxc_matrix(t(ao), t(vt), w),
         jax_xc.vxc_matrix(j(ao), j(vt), w)),
    )
    for port, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(port.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_blocked_xc_pass_matches_jax(bloch, monkeypatch):
    """The k-blocked pass (one k-point a block) for SCAN (rho, tau and the
    v_tau matrices) on spin-resolved densities, against the JAX package's
    pieces: get_rho, get_tau, exc_and_vxc_mgga, vxc_matrix and
    vtau_matrix."""
    ao, kpts, coords, gv, fmesh, w, dm, _ = bloch
    monkeypatch.setattr(xc_mod, "free_memory_bytes", lambda dev: 1)
    t, j = torch.from_numpy, jnp.asarray
    nk = len(kpts)
    spec = jax_xc.parse_xc("scan")
    dphi_j = jax_xc.bloch_ao_grad(j(ao), j(kpts), j(coords), j(gv), fmesh)
    rho_j = jax_xc.get_rho(j(ao), j(dm), nk)
    e_j, v_j, vt_j = jax_xc.exc_and_vxc_mgga(
        rho_j, jax_xc.get_tau(dphi_j, j(dm), nk), j(gv), spec, fmesh, w)
    vxc_j = np.asarray(jax_xc.vxc_matrix(j(ao), v_j, w)
                       + jax_xc.vtau_matrix(dphi_j, vt_j, w))
    assert len(xc_mod._k_blocks(t(ao), 1)) == nk
    e, vxc, n, _, _ = xc_mod.xc_pass(t(ao), t(dm), t(gv),
                                     xc_mod.parse_xc("scan"), fmesh, w, nk,
                                     2, coords=t(coords), kpts=t(kpts))
    assert abs(float(e) - float(e_j)) <= 1e-12 * abs(float(e_j))
    n_j = float(jnp.sum(rho_j)) * w
    assert abs(float(n) - n_j) <= 1e-12 * abs(n_j)
    assert np.abs(vxc.numpy() - vxc_j).max() <= 1e-10 * np.abs(vxc_j).max()
