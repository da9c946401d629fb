"""PyTorch port against the JAX package: the Coulomb kernels.

The same q+G vectors go through ``fftisdf_tpu.linalg.coulomb`` and the
port's, on the CPU in f64: range-separated (omega > 0, omega < 0) and
truncated (0d, 2d) kernels to 1e-12 relative (the same formulas, f64
roundoff), plus the kernel identities of tests/test_omega_jk.py and
tests/test_coulomb_trunc.py on the port alone.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.lattice.cell import Cell as JaxCell
from fftisdf_tpu.linalg import coulomb as jax_coulomb
from fftisdf_tpu_torch.lattice.cell import Cell
from fftisdf_tpu_torch.linalg import coulomb as t_coulomb
from fftisdf_tpu_torch.linalg.fft import fft3
from torch_test_threads import two_torch_threads  # noqa: F401

OMEGA = 0.6
HE2 = dict(a=np.diag([5.0, 5.0, 7.0]),
           atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
           basis="sto-3g", pseudo=None, mesh=np.array([15, 15, 21]),
           unit="bohr", precision=1e-12)


@pytest.fixture(scope="module")
def he2():
    cell_j, cell = JaxCell(**HE2).build(), Cell(**HE2).build()
    return cell_j, cell, cell.get_kpts([1, 1, 2])


KERNELS = [dict(omega=OMEGA), dict(omega=-OMEGA), dict(trunc=("0d", 2.5)),
           dict(trunc=("2d", 3.5)), dict()]


def _screened_np(gk, omega):
    """numpy's float64 range-separated kernel from the q+G vectors, formed
    as both packages form it."""
    a2 = np.einsum("gi,gi->g", gk, gk)
    ok = a2 > 1e-12
    inv = np.where(ok, 4.0 * np.pi / np.where(ok, a2, 1.0), 0.0)
    screen = np.exp(-a2 / (4.0 * omega * omega))
    if omega > 0:
        return inv * screen
    return np.where(ok, inv * (1.0 - screen), np.pi / (omega * omega))


@pytest.mark.parametrize("kw", KERNELS, ids=["erf", "erfc", "0d", "2d",
                                             "bare"])
def test_coulG_matches_jax(he2, kw):
    """get_coulG at q = 0 and at a k-point, and get_coulG_batched: 1e-12.

    The range-separated kernels hold each package to numpy's float64
    kernel on the same |q+G|^2 (1e-12 relative), rather than to each
    other.  Measured on this cell: torch's exp is numpy's to 0 ulp at 1, 2
    and 8 threads, XLA's CPU exp to 1 ulp, and the kernels to 2.9e-14
    (port) and 5.7e-14 (JAX) relative; one xdist run once saw the two
    packages 3.2e-9 apart on 19 of 4725 elements, which no exp rounding
    explains, so a recurrence names the package that drifted."""
    cell_j, cell, kpts = he2
    gv = cell.get_Gv()
    omega = kw.get("omega")
    for q in (None, kpts[1]):
        ref = np.asarray(jax_coulomb.get_coulG(cell_j, q=q, mesh=cell.mesh,
                                               **kw))
        out = t_coulomb.get_coulG(cell, q=q, mesh=cell.mesh, device="cpu",
                                  **kw).numpy()
        if omega is not None:
            gk = gv if q is None else gv + q[None, :]
            exact = _screened_np(gk, omega)
            for got in (out, ref):
                np.testing.assert_allclose(got, exact, rtol=1e-12,
                                           atol=1e-12 * abs(exact).max())
            continue
        np.testing.assert_allclose(out, ref, rtol=1e-12,
                                   atol=1e-12 * abs(ref).max())
    ref = np.asarray(jax_coulomb.get_coulG_batched(cell_j, kpts, gv, **kw))
    out = t_coulomb.get_coulG_batched(cell, torch.from_numpy(kpts),
                                      torch.from_numpy(gv), **kw).numpy()
    if omega is not None:
        exact = np.stack([_screened_np(gv + q[None, :], omega)
                          for q in kpts])
        out, ref = np.stack([out, ref]), np.stack([exact, exact])
    np.testing.assert_allclose(out, ref, rtol=1e-12,
                               atol=1e-12 * abs(ref).max())
    # the host mirror of the bare and truncated kernels
    if "omega" not in kw:
        ref = jax_coulomb.coulG_np(gv, **kw)
        np.testing.assert_allclose(t_coulomb.coulG_np(gv, **kw), ref,
                                   rtol=1e-13, atol=0)


def test_coulG_float32(he2):
    """dtype=float32 gives float32 values of the float64 kernel (1e-5:
    float32 roundoff of |q+G|^2 and of the screening exponent)."""
    _, cell, kpts = he2
    for kw in KERNELS:
        ref = t_coulomb.get_coulG(cell, q=kpts[1], mesh=cell.mesh,
                                  device="cpu", **kw)
        out = t_coulomb.get_coulG(cell, q=kpts[1], mesh=cell.mesh,
                                  dtype=torch.float32, device="cpu", **kw)
        assert out.dtype == torch.float32
        assert float((out.double() - ref).abs().max()) \
            < 1e-5 * float(ref.abs().max())


def test_coulG_range_separation_identity(he2):
    """SR + LR == full everywhere except q+G=0, where SR carries the finite
    pi/omega^2 limit and full/LR drop the divergent sample."""
    _, cell, kpts = he2
    for q in (None, kpts[1]):
        full, lr, sr = (t_coulomb.get_coulG(cell, q=q, mesh=cell.mesh,
                                            omega=w, device="cpu").numpy()
                        for w in (0.0, OMEGA, -OMEGA))
        zero = full == 0.0
        if q is None:
            assert zero.sum() == 1          # exactly the G=0 sample
            assert abs(sr[zero][0] - np.pi / OMEGA**2) < 1e-12
            assert lr[zero][0] == 0.0
        assert abs((sr + lr - full)[~zero]).max() < 1e-10 * full.max()
        assert (lr <= full + 1e-15).all() and (sr >= -1e-15).all()


def test_trunc_0d_analytic_values():
    rc = 3.0
    cell = Cell(a=np.eye(3) * 8.0, atom=[("He", (4.0, 4.0, 4.0))],
                basis="sto-3g", pseudo=None, mesh=np.array([9, 9, 9]),
                unit="bohr").build()
    gv = cell.get_Gv(cell.mesh)
    v = t_coulomb.get_coulG(cell, mesh=cell.mesh, trunc=("0d", rc),
                            device="cpu").numpy()
    absg2 = np.einsum("gi,gi->g", gv, gv)
    i0 = int(np.argmin(absg2))
    assert abs(v[i0] - 2.0 * np.pi * rc * rc) < 1e-12
    g = np.sqrt(absg2)
    mask = absg2 > 1e-12
    ref = 4.0 * np.pi * (1.0 - np.cos(g[mask] * rc)) / absg2[mask]
    assert abs(v[mask] - ref).max() < 1e-10


def test_trunc_2d_branch_consistency():
    """The three 2D branches agree in their shared limits."""
    rc = 4.0
    pi4 = 4.0 * np.pi

    def v2d(gx, gy, gz):
        gk = torch.tensor([[gx, gy, gz]], dtype=torch.float64)
        return float(t_coulomb._coulG_vec(gk, 0.0, ("2d", rc))[0])

    for n in (1, 2):
        gz = np.pi * n / rc
        lim = pi4 / gz**2 * (1.0 - np.cos(gz * rc)
                             - gz * rc * np.sin(gz * rc))
        assert abs(v2d(1e-6, 0.0, gz) - lim) < 1e-8
        assert abs(v2d(0.0, 0.0, gz) - lim) < 1e-12
    gp = 0.9
    assert abs(v2d(gp, 0.0, 0.0)
               - pi4 / gp**2 * (1.0 - np.exp(-gp * rc))) < 1e-12
    for n in (1, 2):
        gz = np.pi * n / rc
        g2 = gp * gp + gz * gz
        ref = pi4 / g2 * (1.0 - (-1.0) ** n * np.exp(-gp * rc))
        assert abs(v2d(gp, 0.0, gz) - ref) < 1e-12
    assert abs(v2d(0.0, 0.0, 0.0) + 2.0 * np.pi * rc * rc) < 1e-12
    for g in ([0.3, -0.5, 0.9], [0.0, 0.0, 1.1], [0.2, 0.1, 0.0]):
        assert abs(v2d(*g) - v2d(*[-x for x in g])) < 1e-14
    # and against the JAX package at the same off-mesh points
    pts = np.array([[0.3, -0.5, 0.9], [0.0, 0.0, 1.1], [0.2, 0.1, 0.0],
                    [0.0, 0.0, 0.0], [1e-6, 0.0, np.pi / rc]])
    ref = np.asarray(jax_coulomb._coulG_vec(jnp.asarray(pts), 0.0,
                                            ("2d", rc)))
    out = t_coulomb._coulG_vec(torch.from_numpy(pts), 0.0, ("2d", rc))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_trunc_for_cell_radii_and_guards():
    kw = dict(a=np.diag([6.0, 8.0, 10.0]), atom=[("He", (3.0, 4.0, 5.0))],
              basis="sto-3g", pseudo=None, mesh=np.array([9, 9, 9]),
              unit="bohr")
    cell_j, cell = JaxCell(**kw).build(), Cell(**kw).build()
    for kind, rc in (("0d", 3.0), ("2d", 5.0)):
        got = t_coulomb.trunc_for_cell(cell, kind)
        assert got == jax_coulomb.trunc_for_cell(cell_j, kind)
        assert got[0] == kind and abs(got[1] - rc) < 1e-12
    assert t_coulomb.check_trunc(("2D", 3)) == ("2d", 3.0)
    assert t_coulomb.check_trunc(None, omega=0.3) is None
    with pytest.raises(NotImplementedError):
        t_coulomb.check_trunc(("0d", 3.0), omega=0.3)
    with pytest.raises(ValueError):
        t_coulomb.check_trunc(("1d", 3.0))
    with pytest.raises(ValueError):
        t_coulomb.trunc_for_cell(cell, "1d")


def test_trunc_0d_gaussian_hartree_free_space():
    """Grid Hartree self-energy of an isolated normalised Gaussian with the
    0D-truncated kernel matches the analytic free-space value
    1/(2 sqrt(pi) sigma) to 1e-6; the bare periodic kernel is off by the
    O(1/L) image/background term."""
    sigma, L, n = 0.6, 10.0, 25
    mesh = (n, n, n)
    cell = Cell(a=np.eye(3) * L, atom=[("He", (L / 2,) * 3)],
                basis="sto-3g", pseudo=None, mesh=np.array(mesh),
                unit="bohr").build()
    coords = cell.gen_uniform_grids()
    r2 = np.sum((coords - L / 2) ** 2, axis=1)
    rho = np.exp(-r2 / (2 * sigma * sigma))
    rho /= rho.sum() * (L**3 / n**3)
    rho_g = fft3(torch.from_numpy(rho)[None].to(torch.complex128), mesh)[0]

    def hartree(coulG):
        return 0.5 / L**3 * float(
            ((rho_g * (L**3 / n**3)).abs() ** 2 * coulG).sum())

    e_ref = 1.0 / (2.0 * math.sqrt(math.pi) * sigma)
    e_tr = hartree(t_coulomb.get_coulG(cell, mesh=mesh, trunc=("0d", L / 2),
                                       device="cpu"))
    e_bare = hartree(t_coulomb.get_coulG(cell, mesh=mesh, device="cpu"))
    assert abs(e_tr - e_ref) < 1e-6
    assert abs(e_bare - e_ref) > 1e-2
