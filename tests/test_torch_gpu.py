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
The exact plane-wave J/K and the device-resident SCF loop on the card are
held against the same calls on the CPU.  The float32 regime on the card:
the build-dtype selection route launches K1 in complex64, the float64
route does not, and both serve the CPU's J/K to float32 accuracy.
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
