"""Tests of the PyTorch port that need a CUDA device (``gpu`` marker).

They import no JAX, so they run on the GPU machine:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Without a card each test skips with the reason.  K1 (the selection pair
gram) is held against its plain PyTorch version at the JAX package's
Pallas test shapes, ragged shapes (ng not a multiple of the 64-row tile, K
not a multiple of the MMA depth, ng below one tile), the main-path shape
(64, 3375, 26), the production width (64, 3375, 62) and on a
non-contiguous X: 2e-5 * scale in complex64, 1e-12 * scale in complex128.
The complex64 kernel (3xTF32 on the tensor cores) is held against the
complex128 gram too, on the cases its loader and epilogue branch on: its
error at most 4x the plain complex64 version's (cuBLAS in full FP32), or
4 x 2^-21 of the scale (3xTF32's error for a single product) where that
is larger.
Two Bloch-AO evaluators on the card give the same values to the bit, and
the CPU's to 1e-12.
The exact plane-wave J/K and the device-resident SCF loop on the card are
held against the same calls on the CPU.  The float32 regime on the card:
the build-dtype selection route launches K1 in complex64, the float64
route does not, and both serve the CPU's J/K to float32 accuracy.  The
ISDF band pair loop, the compact cderi serve and a 0d-truncated SCF on the
card are held against the CPU, and so are the xc functionals and the
device-resident KS loop (PBE+U, SCAN, PBE0), every many-body method
(kmp2, kump2, drpa, Sigma^c(iw), TDA dense and Davidson, UTDA, Casida,
BSE) on the CPU's points and orbitals, and FCI, DMET and the CC layer
(CCSD(T), EOM-EE Davidson, EOM-IP, the Lambda density, the CCSD solver),
with the complex autodiff conventions the CC derivatives rest on, and the
analytic forces and stress of both two-electron backends.
"""
import numpy as np
import pytest
import torch

from fftisdf_tpu_torch.ops import pair_gram

SHAPES = [(1, 64, 5), (3, 100, 7), (2, 300, 4), (16, 96, 40),
          (1, 1, 1), (3, 129, 7), (5, 257, 3),
          (64, 3375, 26), (64, 3375, 62)]
TOL = {np.complex64: 2e-5, np.complex128: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _x(shape, dtype, device):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(dtype)).to(device)


def _check_k1(x, square, dtype):
    before = pair_gram.pair_gram_sq.launches
    out = pair_gram.pair_gram_sq(x, square=square)
    torch.cuda.synchronize()
    assert pair_gram.pair_gram_sq.launches == before + 1
    ref = pair_gram.pair_gram_sq_reference(x, square=square)
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_kernel_matches_plain(cuda, shape, square, dtype):
    _check_k1(_x(shape, dtype, cuda), square, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_k1_kernel_non_contiguous(cuda, dtype):
    """A slice along the ng axis: the complex128 kernel reads X through its
    strides."""
    x = _x((8, 300, 11), dtype, cuda)[:, 7:250]
    assert not x.is_contiguous()
    _check_k1(x, False, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["odd-nao", "ragged-ng", "offset-view",
                                  "conj-view", "square"])
def test_k1_complex64_against_complex128(cuda, case):
    """odd nao (8-B copies: a 16-B pair would cross a k-point), ng not a
    multiple of the 128-row tile (16-B copies), an 8-B-aligned view
    x[..., 1:], a conjugate view, and ``square=True``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _x((5, 257, 3) if case == "odd-nao" else (8, 300, 12),
           np.complex64, cuda)
    if case == "offset-view":
        x = x[..., 1:]
        assert x.data_ptr() % 16 == 8
    elif case == "conj-view":
        x = x.conj()
    square = case == "square"
    _check_k1(x, square, np.complex64)
    out = pair_gram.pair_gram_sq(x, square=square)
    plain = pair_gram.pair_gram_sq_reference(x, square=square)
    ref = pair_gram.pair_gram_sq_reference(x.to(torch.complex128),
                                           square=square)
    e_k = float((out.double() - ref).abs().max())
    e_p = float((plain.double() - ref).abs().max())
    assert e_k <= 4.0 * max(e_p, 2.0**-21 * float(ref.abs().max())), (
        e_k, e_p)


@pytest.mark.gpu
def test_k1_selection_on_cuda_matches_cpu(cuda):
    """Selection on the card (through K1) picks the CPU's points."""
    from fftisdf_tpu_torch.isdf.kpoint import select_interpolation_points
    from fftisdf_tpu_torch.lattice import structure

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    before = pair_gram.pair_gram_sq.launches
    x_g, m_g, r_g, _ = select_interpolation_points(cell, kpts, (9, 9, 9),
                                                   6.0, device=cuda)
    assert pair_gram.pair_gram_sq.launches == before + 1
    x_c, m_c, r_c, _ = select_interpolation_points(cell, kpts, (9, 9, 9),
                                                   6.0, device="cpu")
    assert r_g == r_c
    np.testing.assert_array_equal(m_g, m_c)
    np.testing.assert_allclose(x_g.cpu().numpy(), x_c.numpy(), atol=1e-12)


@pytest.mark.gpu
def test_ao_values_repeat_bitwise_on_cuda(cuda):
    """Two evaluators on the card give the same Bloch-AO values to the bit
    at the selection pool and the FFT grid of that cell, and those values
    are the CPU's to 1e-12: a card that computes differently from run to
    run, or a wrap decided by roundoff, shows here first."""
    from fftisdf_tpu_torch.basis.eval import make_evaluator
    from fftisdf_tpu_torch.lattice import structure

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    for mesh in ((9, 9, 9), tuple(int(m) for m in cell.mesh)):
        coords = cell.gen_uniform_grids(mesh)
        first = make_evaluator(cell, kpts=kpts, device=cuda)(coords)
        second = make_evaluator(cell, kpts=kpts, device=cuda)(coords)
        assert torch.equal(first, second)
        cpu = make_evaluator(cell, kpts=kpts, device="cpu")(coords)
        np.testing.assert_allclose(first.cpu().numpy(), cpu.numpy(),
                                   atol=1e-12, rtol=0)


def _diamond():
    from fftisdf_tpu_torch.lattice import structure

    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    return cell, cell.get_kpts([1, 1, 2])


@pytest.mark.gpu
def test_pwdf_on_cuda_matches_cpu(cuda):
    """The exact plane-wave J/K (exxdiv='ewald') on the card equal the
    CPU's to 1e-10 relative, also with the exchange sweep in row blocks."""
    from fftisdf_tpu_torch.pw import jk as pw_jk
    from fftisdf_tpu_torch.scf import PWDF

    cell, kpts = _diamond()
    rng = np.random.default_rng(1)
    nao = cell.nao_nr()
    dm = rng.standard_normal((2, 2, nao, nao)) * (1 + 0j)
    dm = dm + dm.transpose(0, 1, 3, 2)
    out = {}
    for dev in (cuda, "cpu"):
        vj, vk = PWDF(cell, kpts, device=dev).get_jk(dm, exxdiv="ewald")
        out[str(dev)] = (vj.cpu().numpy(), vk.cpu().numpy())
    for g, c in zip(out[str(cuda)], out["cpu"]):
        assert np.abs(g - c).max() <= 1e-10 * np.abs(c).max()
    pw = PWDF(cell, kpts, device=cuda)
    vk_b = pw_jk.get_k_kpts(cell, dm[0], pw.ao, kpts, max_memory_gb=0.003)
    vk_1 = pw_jk.get_k_kpts(cell, dm[0], pw.ao, kpts)
    assert float((vk_b - vk_1).abs().max()) <= 1e-12 * float(
        vk_1.abs().max())


@pytest.mark.gpu
def test_device_kuhf_on_cuda_matches_cpu(cuda):
    """DeviceKUHF (AFM bias, smearing) on the card lands on the CPU's
    energy and on the host loop's, to 3e-8 Ha."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KUHF, DeviceKUHF

    cell, kpts = _diamond()
    kw = dict(verbose=0, conv_tol=1e-10, max_cycle=60, smearing=5e-3,
              init_spin={0: +1.0, 1: -1.0})
    e = {}
    mask = None
    for dev in ("cpu", cuda):
        df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 9), verbose=0,
                     device=dev).build(mask=mask)
        mask = df.mask
        mf = DeviceKUHF(cell, kpts, df, device=dev, **kw)
        e[str(dev)] = mf.kernel()
        assert mf.converged
    e_host = KUHF(cell, kpts, df, device=cuda, **kw).kernel()
    assert abs(e[str(cuda)] - e["cpu"]) <= 3e-8
    assert abs(e[str(cuda)] - e_host) <= 3e-8


@pytest.mark.gpu
def test_f32_selection_routes_on_cuda(cuda):
    """A float32 build with ``select_host_f64=False`` launches K1 in
    complex64 and keeps all max_rank pivots; the default route selects in
    float64 on the card without K1 and picks the CPU's points.  J/K of both
    against the CPU's float32 build: 2e-3 (float32 fits of different
    roundoff, amplified by up to eps / rcond = 6e-3; measured 3.4e-4 on
    the same points, on a J of scale 0.2)."""
    from fftisdf_tpu_torch.isdf import FFTISDF

    cell, kpts = _diamond()
    nao = cell.nao_nr()
    dm = np.stack([np.eye(nao, dtype=complex)] * 2)
    kw = dict(c0=10.0, m0=(9, 9, 9), verbose=0, dtype=torch.float32)
    ref = FFTISDF(cell, kpts, device="cpu", **kw).build()
    vj_c, vk_c = ref.get_jk(dm)
    before = pair_gram.pair_gram_sq.launches
    df = FFTISDF(cell, kpts, device=cuda, **kw).build()
    assert pair_gram.pair_gram_sq.launches == before
    np.testing.assert_array_equal(df.mask, ref.mask)
    df_k1 = FFTISDF(cell, kpts, device=cuda, select_host_f64=False,
                    **kw).build()
    assert pair_gram.pair_gram_sq.launches == before + 1
    assert df_k1.nip == int(10.0 * nao)
    assert df_k1.wq.dtype == torch.complex64
    for d in (df, df_k1):
        vj, vk = d.get_jk(dm)
        assert vj.dtype == torch.complex64
        assert float((vj.cpu() - vj_c).abs().max()) < 2e-3
        assert float((vk.cpu() - vk_c).abs().max()) < 2e-3


@pytest.mark.gpu
def test_pairgram_factorisation_on_cuda_matches_cpu(cuda):
    """The matrix-free factorisation on the card gives the CPU's pivots."""
    from fftisdf_tpu_torch.linalg.pivoted_cholesky import (
        pivoted_cholesky_pairgram)

    rng = np.random.default_rng(7)
    flat = rng.standard_normal((500, 40)) + 1j * rng.standard_normal(
        (500, 40))
    piv_c, rank_c, hist_c = pivoted_cholesky_pairgram(
        torch.from_numpy(flat), 4, 200, block=29)
    piv_g, rank_g, hist_g = pivoted_cholesky_pairgram(
        torch.from_numpy(flat).to(cuda), 4, 200, block=29)
    assert rank_g == rank_c
    np.testing.assert_array_equal(piv_g, piv_c)
    np.testing.assert_allclose(hist_g, hist_c, rtol=1e-9,
                               atol=1e-12 * hist_c[0])


@pytest.mark.gpu
def test_device_f32_loop_with_dropped_directions_on_cuda(cuda):
    """The float32 device loop on the card with dropped (near-null) overlap
    directions: He2 with two nearly identical s shells per atom.  Their
    diagonal entry is scaled to the Fock norm, so cuSOLVER's backward error
    stays at the float32 floor: the float32 loop lands within 1e-4 Ha of
    the float64 loop over the same float32 provider (measured 2.3e-5; a
    fixed 1e6 entry costs ~0.06 Ha per eigenvalue in float32)."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice.cell import Cell, Shell
    from fftisdf_tpu_torch.scf import DeviceKRHF
    from fftisdf_tpu_torch.scf.device import orth_and_penalty

    shells = [Shell(l=0, exps=np.array([0.8, 0.3]),
                    coeffs=np.array([[0.4], [0.7]])),
              Shell(l=0, exps=np.array([0.8, 0.3]),
                    coeffs=np.array([[0.4 * (1 + 1e-7)], [0.7]]))]
    cell = Cell(a=np.diag([8.0, 8.0, 8.0]),
                atom=[("He", np.full(3, 4.0)),
                      ("He", np.array([4.0, 4.0, 6.5]))],
                basis={"He": shells}, pseudo=None, mesh=np.array([16] * 3),
                unit="bohr", precision=1e-12).build()
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                 dtype=torch.float32, device=cuda).build()
    kw = dict(verbose=0, conv_tol=1e-7, ovlp_cutoff=1e-4, max_cycle=60,
              device=cuda)
    mf64 = DeviceKRHF(cell, kpts, df, **kw)
    e64 = mf64.kernel()
    mf32 = DeviceKRHF(cell, kpts, df, dtype=torch.float32, **kw)
    e32 = mf32.kernel()
    assert (orth_and_penalty(mf32.s1e, 1e-4)[1] > 0).any()
    assert mf64.converged and mf32.converged
    assert abs(e32 - e64) < 1e-4


def _he2_bands(cell_cls, shell_cls):
    """The He2 cell of tests/test_isdf_bands.py."""
    return cell_cls(a=np.diag([5.0, 5.0, 7.0]),
                    atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
                    basis={"He": [shell_cls(l=0, exps=np.array([1.0, 0.35]),
                                            coeffs=np.eye(2))]},
                    pseudo=None, mesh=np.array([12, 12, 16]), unit="bohr",
                    precision=1e-12).build()


@pytest.mark.gpu
def test_band_pair_loop_on_cuda_matches_cpu(cuda):
    """The ISDF band serve (the (band, k2) pair loop) on the card equals
    the CPU's on the same interpolation points, to 1e-10 of the scale, off
    the mesh and at a mesh point, with a set axis."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice.cell import Cell, Shell

    cell = _he2_bands(Cell, Shell)
    kpts = cell.get_kpts([1, 1, 2])
    b = cell.reciprocal_vectors()
    kband = np.array([0.17 * b[2], 0.33 * b[0] + 0.41 * b[2], kpts[1]])
    rng = np.random.default_rng(2)
    nao = cell.nao_nr()
    dm = rng.standard_normal((2, 2, nao, nao)) * 0.1 + np.eye(nao)
    dm = (dm + dm.transpose(0, 1, 3, 2)).astype(complex)
    out, mask = {}, None
    for dev in ("cpu", cuda):
        df = FFTISDF(cell, kpts, c0=10.0, m0=(7, 7, 11), verbose=0,
                     device=dev).build(mask=mask)
        mask = df.mask
        out[str(dev)] = [t.cpu().numpy()
                         for t in df.get_jk(dm, kpts_band=kband)]
    for g, c in zip(out[str(cuda)], out["cpu"]):
        assert g.shape == (2, 3, nao, nao)
        assert np.abs(g - c).max() <= 1e-10 * np.abs(c).max()


@pytest.mark.gpu
def test_get_jk_cderi_on_cuda_matches_cpu(cuda):
    """The compact cderi serve (signed factors, k2 blocks) on the card
    equals the CPU's to 1e-10 of the scale, and the ISDF serve to 1e-7 of
    it (the signed factors serve the hermitised metric; on this diamond
    the difference is 1.5e-8 of the scale on the CPU)."""
    from fftisdf_tpu_torch.isdf import FFTISDF, cderi

    cell, kpts = _diamond()
    nao = cell.nao_nr()
    dm = np.stack([np.eye(nao, dtype=complex)] * 2)
    out, mask = {}, None
    for dev in ("cpu", cuda):
        df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 9), verbose=0,
                     device=dev).build(mask=mask)
        mask = df.mask
        cd, sign = cderi.wq_to_cd_signed(df.wq)
        q_of = cderi.q_index_table(cell, kpts)
        vj, vk = cderi.get_jk_cderi(df.x_k, cd, q_of, dm, k2_chunk=1,
                                    sign=sign)
        vj0, vk0 = df.get_jk(dm)
        for a, b in ((vj, vj0), (vk, vk0)):
            assert float((a - b).abs().max()) < 1e-7 * float(b.abs().max())
        out[str(dev)] = (vj.cpu().numpy(), vk.cpu().numpy())
    for g, c in zip(out[str(cuda)], out["cpu"]):
        assert np.abs(g - c).max() <= 1e-10 * np.abs(c).max()


@pytest.mark.gpu
def test_trunc_scf_on_cuda_matches_cpu(cuda):
    """SCF-level 0d truncation: H2/STO-3G in a 9-bohr box, KRHF on a
    truncated ISDF build, on the card and on the CPU on the same points, to
    1e-8 Ha."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice.cell import Cell
    from fftisdf_tpu_torch.scf import KRHF

    L, R = 9.0, 1.4
    cell = Cell(a=np.eye(3) * L,
                atom=[("H", (L / 2, L / 2, L / 2 - R / 2)),
                      ("H", (L / 2, L / 2, L / 2 + R / 2))],
                basis="sto-3g", pseudo=None, ke_cutoff=60.0, unit="bohr",
                precision=1e-12).build()
    kpts = cell.get_kpts([1, 1, 1])
    e, mask = {}, None
    for dev in ("cpu", cuda):
        df = FFTISDF(cell, kpts, c0=25.0, m0=(11, 11, 11), verbose=0,
                     trunc="0d", device=dev).build(mask=mask)
        mask = df.mask
        mf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-10, device=dev)
        assert mf.trunc == df.trunc
        e[str(dev)] = mf.kernel()
        assert mf.converged
    assert abs(e[str(cuda)] - e["cpu"]) <= 1e-8


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["lda", "pbe", "b3lyp", "hse06", "scan"])
def test_xc_on_cuda_matches_cpu(cuda, name):
    """exc_and_vxc (v_tau too for SCAN) of a seeded positive density on
    diamond's mesh, on the card against the CPU: exc to 1e-12 relative,
    the potentials to 1e-10 of their scale."""
    from fftisdf_tpu_torch.scf import xc

    cell, _ = _diamond()
    fmesh = tuple(int(m) for m in cell.mesh)
    ng = int(np.prod(fmesh))
    rng = np.random.default_rng(3)
    rho = 0.2 + 0.1 * rng.random((2, ng))
    tau = 0.5 + rng.random((2, ng))
    spec = xc.parse_xc(name)
    out = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(a, device=dev)
        gv, w = t(cell.get_Gv(fmesh)), float(cell.vol) / ng
        if spec.is_mgga:
            res = xc.exc_and_vxc_mgga(t(rho), t(tau), gv, spec, fmesh, w)
        else:
            res = xc.exc_and_vxc(t(rho), gv, spec, fmesh, w)
        out[str(dev)] = [r.cpu().numpy() for r in res]
    g, c = out[str(cuda)], out["cpu"]
    assert abs(g[0] - c[0]) <= 1e-12 * abs(c[0])
    for a, b in zip(g[1:], c[1:]):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()


@pytest.mark.gpu
@pytest.mark.parametrize("xc_name, hub", [
    ("pbe", {0: (1, 0.2), 1: (1, 0.2)}), ("scan", None), ("pbe0", None)])
def test_device_kuks_on_cuda_matches_cpu(cuda, xc_name, hub):
    """DeviceKUKS (PBE+U, SCAN, PBE0) on the card lands on the CPU's
    energy and on the card's host loop, to 3e-8 Ha, on the same points."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KUKS, DeviceKUKS

    cell, kpts = _diamond()
    kw = dict(verbose=0, conv_tol=1e-10, max_cycle=80, xc=xc_name,
              hubbard=hub)
    e, mask = {}, None
    for dev in ("cpu", cuda):
        df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                     device=dev).build(mask=mask)
        mask = df.mask
        mf = DeviceKUKS(cell, kpts, df, device=dev, **kw)
        e[str(dev)] = mf.kernel()
        assert mf.converged
    host = KUKS(cell, kpts, df, device=cuda, **kw)
    e_host = host.kernel()
    assert host.converged
    assert abs(e[str(cuda)] - e["cpu"]) <= 3e-8
    assert abs(e[str(cuda)] - e_host) <= 3e-8


@pytest.fixture(scope="module")
def many_body_states():
    """{device: (df, KRHF, KRKS-PBE)} on diamond 1x1x2: the CPU converges
    both references, and the card's SCF objects get the CPU's points and
    orbitals, so each method sees the same inputs on both devices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KRHF, KRKS

    cell, kpts = _diamond()
    out, mask, ref = {}, None, None
    for dev in ("cpu", "cuda"):
        df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                     device=dev).build(mask=mask)
        mask = df.mask
        mfs = (KRHF(cell, kpts, df, verbose=0, conv_tol=1e-10, device=dev),
               KRKS(cell, kpts, df, xc="pbe", verbose=0, conv_tol=1e-10,
                    device=dev))
        for i, mf in enumerate(mfs):
            if ref is None or dev == "cpu":
                mf.kernel()
                assert mf.converged
            else:
                for name in ("mo_coeff", "mo_energy", "mo_occ", "dm"):
                    setattr(mf, name, getattr(ref[i], name))
        if dev == "cpu":
            ref = mfs
        out[dev] = (df,) + mfs
    return out


def _unrestricted(mf):
    from fftisdf_tpu_torch.scf import KUHF, KUKS

    cls = KUKS if hasattr(mf, "_spec") else KUHF
    kw = {"xc": mf.xc} if cls is KUKS else {}
    u = cls(mf.cell, mf.kpts, mf.with_df, verbose=0, device=mf.device, **kw)
    u.mo_coeff = np.stack([mf.mo_coeff] * 2)
    u.mo_energy = np.stack([mf.mo_energy] * 2)
    u.mo_occ = np.stack([mf.mo_occ] * 2) * 0.5
    u.dm = np.stack([mf.dm] * 2) * 0.5
    return u


MANY_BODY = {
    "kmp2": lambda df, hf, ks: [many("mp2").kmp2(df, hf)[0]],
    "kump2": lambda df, hf, ks: [many("mp2").kump2(df, _unrestricted(hf))[0]],
    "drpa": lambda df, hf, ks: [many("rpa").drpa(df, hf, nw=12)[0]],
    "g0w0": lambda df, hf, ks: many("gw").sigma_c_iw(df, ks, nw=12)[0],
    "tda": lambda df, hf, ks: np.concatenate([
        many("tddft").tda(ks, df, q=1, nroots=0, dense=True)[0],
        many("tddft").tda(hf, df, q=1, nroots=0, singlet=False,
                          dense=True)[0]]),
    "davidson": lambda df, hf, ks: many("tddft").tda(
        ks, df, q=0, nroots=3, dense=False, tol=1e-9)[0],
    "utda": lambda df, hf, ks: many("tddft").utda(
        _unrestricted(ks), df, q=1, nroots=0, dense=True)[0],
    "tddft": lambda df, hf, ks: many("tddft").tddft(ks, df, q=1,
                                                    nroots=4)[0],
    "bse": lambda df, hf, ks: many("bse").bse(ks, df, q=1, nroots=0,
                                              dense=True)[0],
}


def many(name):
    import importlib

    return importlib.import_module(f"fftisdf_tpu_torch.scf.{name}")


@pytest.mark.gpu
@pytest.mark.parametrize("method", list(MANY_BODY))
def test_many_body_on_cuda_matches_cpu(cuda, many_body_states, method):
    """Each many-body method on the card against the CPU on the same
    points and orbitals (diamond 1x1x2): 1e-10 relative (the Davidson
    roots 1e-8, the solve's tol 1e-9)."""
    out = {dev: np.asarray(MANY_BODY[method](*many_body_states[dev]))
           for dev in ("cpu", "cuda")}
    g, c = out["cuda"], out["cpu"]
    tol = 1e-8 if method == "davidson" else 1e-10
    assert np.abs(g - c).max() <= tol * np.abs(c).max(), method


@pytest.fixture(scope="module")
def cc_states():
    """{device: (df, KRHF)} on the H2 chain of tests/test_cc.py at 1x1x2,
    the JAX package's points and real-gauge orbitals
    (tests/data/jax_port_refs.json) on both devices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    from pathlib import Path

    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.lattice.cell import Cell, Shell
    from fftisdf_tpu_torch.scf import KRHF
    from fftisdf_tpu_torch.scf.hf import _build_dm

    rec = json.loads((Path(__file__).resolve().parent / "data"
                      / "jax_port_refs.json").read_text())["many_body"]["h2_k2"]
    cell = Cell(a=np.diag([6.0, 6.0, 7.0]),
                atom=[("H", (3.0, 3.0, 1.8)), ("H", (3.0, 3.0, 3.2))],
                basis={"H": [Shell(l=0, exps=np.array([1.2, 0.4]),
                                   coeffs=np.eye(2))]},
                pseudo="gth-pade", mesh=np.array([14, 14, 17]), unit="bohr",
                precision=1e-12).build()
    kpts = cell.get_kpts([1, 1, 2])
    orb = rec["krhf"]
    mo = (np.asarray(orb["mo_coeff"]["re"]) + 1j * np.asarray(
        orb["mo_coeff"]["im"])).reshape(orb["mo_coeff"]["shape"])
    out = {}
    for dev in ("cpu", "cuda"):
        df = FFTISDF(cell, kpts, c0=60.0, m0=(11, 11, 13), verbose=0,
                     select_tol=1e-18, rcond=1e-12, device=dev).build(
                         mask=np.asarray(rec["mask"]))
        mf = KRHF(cell, kpts, df, verbose=0, device=dev)
        mf.mo_coeff, mf.mo_energy = mo, np.asarray(orb["mo_energy"])
        mf.mo_occ = np.asarray(orb["mo_occ"])
        mf.dm = _build_dm(mo, mf.mo_occ)
        _, vj, vk = mf.get_fock(mf.dm)
        mf.e_tot = mf.energy_elec(mf.dm, vj, vk) + mf.e_nuc
        out[dev] = (df, mf)
    return out


def _random_embedding(n=4, seed=43):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = h + h.conj().T
    a = 0.15 * (rng.standard_normal((n,) * 4)
                + 1j * rng.standard_normal((n,) * 4))
    a = a + a.transpose(2, 3, 0, 1)
    return h, a + a.transpose(1, 0, 3, 2).conj()


CORRELATED = {
    "kccsd_t": lambda df, mf, dev: list(many("cc").kccsd_t(
        df, mf, conv_tol=1e-9, max_cycle=80)[:2]),
    "eomee_davidson": lambda df, mf, dev: many("cc").eomee_davidson(
        df, mf, nroots=3, conv_tol=1e-10, tol=1e-9)[0],
    "eomip": lambda df, mf, dev: np.concatenate(list(many("cc").eomip(
        df, mf, conv_tol=1e-10)[0].values())),
    "onerdm": lambda df, mf, dev: np.concatenate([np.ravel(b) for b in
                                                  many("cc").onerdm(
        df, mf, conv_tol=1e-9)[0]]),
    "dmet_fci": lambda df, mf, dev: [many("dmet").dmet_energy(
        mf, df, frag_ao=[0, 1], fit_mu=True)[0]],
    "dmet_ccsd": lambda df, mf, dev: [many("dmet").dmet_energy(
        mf, df, frag_ao=[0, 1], solver=many("cc").ccsd_solver)[0]],
    "fci": lambda df, mf, dev: np.concatenate([
        np.ravel(x) for x in many("fci").fci_ground(
            *_random_embedding(), 4, device=dev)]),
    "ccsd_solver": lambda df, mf, dev: np.concatenate([
        np.ravel(x) for x in many("cc").ccsd_solver(
            *_random_embedding(), 4, device=dev)]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("method", list(CORRELATED))
def test_correlated_on_cuda_matches_cpu(cuda, cc_states, method):
    """FCI, DMET and the CC layer on the card against the CPU on the same
    points and orbitals (the H2 chain at 1x1x2; FCI and the CCSD solver on
    a random embedding problem): 1e-10 relative (the Davidson roots 1e-8,
    the solve's tol 1e-9)."""
    out = {dev: np.asarray(CORRELATED[method](*cc_states[dev], dev))
           for dev in ("cpu", "cuda")}
    g, c = out["cuda"], out["cpu"]
    tol = 1e-8 if method == "eomee_davidson" else 1e-10
    assert np.abs(g - c).max() <= tol * np.abs(c).max(), method


@pytest.mark.gpu
def test_complex_autodiff_conventions_on_cuda(cuda):
    """The three conventions the CC layer's derivatives rest on, on the
    card: torch.func.jvp of a holomorphic map is J x (a central
    difference), vmap of jvps over unit vectors gives J's columns, and
    reverse mode with grad_outputs 1 returns conj(J^T x), i.e. conj of
    the holomorphic gradient."""
    g = torch.Generator(device=cuda).manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, dtype=torch.complex128, device=cuda,
                           generator=g)

    a, z, x = rnd(6, 6), rnd(6), rnd(6)

    def f(v):
        return (a @ v) * v + v.exp()

    jx = torch.func.jvp(f, (z,), (x,))[1]
    fd = (f(z + 1e-6 * x) - f(z - 1e-6 * x)) / 2e-6
    assert float((jx - fd).abs().max()) <= 1e-8 * float(fd.abs().max())
    jac = torch.func.vmap(lambda c: torch.func.jvp(f, (z,), (c,))[1],
                          in_dims=1, out_dims=1)(
        torch.eye(6, dtype=z.dtype, device=cuda))
    assert float((jac @ x - jx).abs().max()) <= 1e-12
    zr = z.clone().requires_grad_(True)
    s = (f(zr) * x).sum()
    gr = torch.autograd.grad(s, zr, grad_outputs=torch.ones_like(s))[0]
    assert float((gr - (jac.T @ x).conj()).abs().max()) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["pw", "isdf"])
def test_forces_and_stress_on_cuda_match_cpu(cuda, backend):
    """Analytic forces and stress (KRKS-PBE+U on diamond 1x1x2 with one
    atom displaced, the plane-wave and the ISDF backend) on the card equal
    the CPU's on the same density and mask, to 1e-10 relative."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KRKS
    from fftisdf_tpu_torch.scf import grad, stress

    cell, kpts = _diamond()
    pos = cell.atom_coords().copy()
    pos[1, 2] += 0.1
    cell = cell.copy(atom=[(s, p) for s, p in
                           zip(cell.atom_symbols(), pos)]).build()
    df = FFTISDF(cell, kpts, c0=20.0, m0=(9, 9, 9), verbose=0,
                 device="cpu").build()
    mf = KRKS(cell, kpts, df, xc="pbe", hubbard={0: (1, 0.2)}, verbose=0,
              conv_tol=1e-10, device="cpu")
    mf.kernel()
    assert mf.converged
    out = {}
    for dev in ("cpu", cuda):
        dfd = (FFTISDF(cell, kpts, c0=20.0, m0=(9, 9, 9), verbose=0,
                       device=dev).build(mask=df.mask)
               if backend == "isdf" else None)
        kw = dict(two_electron=backend, df=dfd, xc="pbe",
                  hubbard={0: (1, 0.2)}, device=dev)
        g, val = grad.make_grad_fn(cell, kpts, **kw)(mf)
        sval, geps, _ = stress.make_cell_grad_fn(cell, kpts, **kw)(mf)
        out[str(dev)] = (g, val, geps, sval)
    (g, val, geps, sval), (gc, valc, gepsc, svalc) = \
        out[str(cuda)], out["cpu"]
    assert abs(val - mf.e_tot) < 1e-8 and abs(sval - mf.e_tot) < 1e-8
    assert abs(val - valc) <= 1e-10 * abs(valc)
    assert abs(sval - svalc) <= 1e-10 * abs(svalc)
    assert np.abs(g - gc).max() <= 1e-10 * np.abs(gc).max()
    assert np.abs(geps - gepsc).max() <= 1e-10 * np.abs(gepsc).max()


@pytest.mark.gpu
def test_profile_build_on_cuda_matches_cpu(cuda):
    """FFTISDF(profile_build=True) on the card: the JAX package's stage
    keys, w_q bitwise equal to the unprofiled card build, and its J/K
    equal to the CPU build's on the same mask (1e-10 relative; raw w_q is
    noise-limited in the fit's near-null directions)."""
    from fftisdf_tpu_torch.isdf import FFTISDF

    cell, kpts = _diamond()
    kw = dict(c0=10.0, m0=(9, 9, 9), verbose=0)
    plain = FFTISDF(cell, kpts, device=cuda, **kw).build()
    prof = FFTISDF(cell, kpts, device=cuda, profile_build=True,
                   **kw).build(mask=plain.mask)
    plain = FFTISDF(cell, kpts, device=cuda, **kw).build(mask=plain.mask)
    assert list(prof._stage_s) == ["factors", "sweep", "spectral", "gram"]
    assert torch.equal(prof.wq, plain.wq)
    assert 0 < sum(prof._stage_s.values()) <= prof.timings["metric_s"]
    cpu = FFTISDF(cell, kpts, device="cpu", **kw).build(mask=plain.mask)
    dm = np.stack([np.eye(cell.nao_nr(), dtype=complex)] * len(kpts))
    for v, vc in zip(prof.get_jk(dm), cpu.get_jk(dm)):
        d = float((v.cpu() - vc).abs().max())
        assert d <= 1e-10 * float(vc.abs().max())


@pytest.mark.gpu
def test_density_on_grid_on_cuda_matches_cpu(cuda):
    """utils.cube on the card (grid blocks from its free memory) against
    the CPU on the same KUHF density: 1e-12 relative."""
    from fftisdf_tpu_torch.isdf import FFTISDF
    from fftisdf_tpu_torch.scf import KUHF
    from fftisdf_tpu_torch.utils import cube

    cell, kpts = _diamond()
    df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 9), verbose=0,
                 device="cpu").build()
    mf = KUHF(cell, kpts, df, verbose=0, conv_tol=1e-9, device="cpu")
    mf.kernel()
    card = KUHF(cell, kpts, df, verbose=0, device=cuda)
    card.dm, card.mo_coeff = mf.dm, mf.mo_coeff
    for spin in (None, "diff", 0):
        rho = cube.density_on_grid(card, spin=spin)
        rho_c = cube.density_on_grid(mf, spin=spin)
        scale = max(np.abs(rho_c).max(), 1e-300)
        assert np.abs(rho - rho_c).max() <= 1e-12 * max(scale, 1.0)
    psi = cube.mo_on_grid(card, k=1, n=2, spin=0, part="abs2")
    psi_c = cube.mo_on_grid(mf, k=1, n=2, spin=0, part="abs2")
    assert np.abs(psi - psi_c).max() <= 1e-12 * np.abs(psi_c).max()
